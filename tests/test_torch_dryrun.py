"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX
package's (``repro.launch.dryrun``).

* For every arch x shape x mesh, ``skip_reason``, ``input_specs``,
  ``_micro`` and ``model_flops_estimate`` equal the reference's, and the
  parameter count equals the reference's ``eval_shape`` count.
* Two cells at published widths on a fake world of 256 ranks:
  llama3.2-3b ``decode_32k`` and jamba ``long_500k`` (batch 1, so T of
  its attention caches splits over 'data').
* At smoke widths (the dense config: 2 layers, d 64, 4 heads of 16, one KV
  head) on a (2, 2) mesh, the train, prefill and decode steps' per-device
  FLOPs against the JAX analyzer's (``analyze_hlo``) of the same steps
  compiled on 4 forced host devices. Two conventions differ, and the test
  takes them out before it compares:
  - attention: the reference's jnp flash twin computes every (query, key)
    block, 4·S·T·H·D a forward, 10 a backward, and its decode ``_sdpa``
    every cache row; the port's kernel operators count the causal
    triangle (``attention.flash_flops``). The port's kernel FLOPs and the
    reference's, derived from those block counts, are reported and taken
    out;
  - XLA rewrites the RMSNorm's sum of squares into a dot of a tensor with
    itself, which its analyzer counts; the port's sum is no matmul. Those
    self-dots are counted apart in the reference and taken out.
  What is left must be equal for prefill. For training it differs by the
  recompute the two remats do: XLA drops recomputed ops the backward does
  not need, ``torch.utils.checkpoint`` recomputes the period's forward in
  order up to the last tensor the backward needs, so the port may count
  more, at most one forward of the layers' projections a micro-batch
  (the bar). For decode DTensor chooses its own strategies op by op (it
  gathers weights over 'data' where XLA splits the rows), so the port's
  per-device count outside attention is held between a quarter and a
  half of the step's whole work (each matmul keeps one of its two
  splits), as the reference's is; a count at the global shapes, the
  whole work, fails that bar by 2x.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_config, smoke_config
from repro_torch.launch import dryrun

SRC = str(Path(__file__).resolve().parents[1] / "src")
SMOKE = dict(arch="llama3_2_3b", B=4, S=16, n_micro=2)

_JAX_TABLES = """
import json
import jax, jax.numpy as jnp, numpy as np
from repro.launch import dryrun as d
from repro.configs import ARCH_IDS, get_config
from repro.models.lm import build_model

class Stub:
    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)

def micro(cfg, mesh, batch):
    try:
        return d._micro(cfg, mesh, batch)
    except ZeroDivisionError:  # a batch smaller than the data axes (long_500k)
        return "ZeroDivisionError"

meshes = {"16x16": Stub({"data": 16, "model": 16}),
          "2x16x16": Stub({"pod": 2, "data": 16, "model": 16})}
out = {}
for arch in ARCH_IDS:
    cfg = get_config(arch)
    shapes = jax.eval_shape(build_model(cfg).init, jax.ShapeDtypeStruct((2,), jnp.uint32))
    n = float(sum(np.prod(x.shape) for x in jax.tree.leaves(shapes)))
    for shape, info in d.SHAPES.items():
        for mname, mesh in meshes.items():
            out[f"{arch}/{shape}/{mname}"] = dict(
                n_params=n, skip=d.skip_reason(cfg, shape),
                specs={k: [list(v.shape), str(v.dtype)] for k, v in d.input_specs(cfg, shape).items()},
                micro=micro(cfg, mesh, info["batch"]),
                model_flops=d.model_flops_estimate(cfg, n, info["kind"], info["batch"], info["seq"]))
print(json.dumps(out))
"""

_JAX_SMOKE = """
import json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.configs import smoke_config
from repro.distribution.sharding import (activation_rules, batch_sharding, cache_sharding,
                                         param_sharding, state_sharding)
from repro.launch import hlo_analysis as H
from repro.models.layers import activation_sharding
from repro.models.lm import build_model
from repro.optim.adamw import AdamWConfig
from repro.runtime.steps import build_prefill_step, build_serve_step, build_train_step, make_train_state

arch, B, S, n_micro = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4])
mesh = Mesh(np.asarray(jax.devices()).reshape(2, 2), ("data", "model"))
model = build_model(smoke_config(arch))
sds = jax.ShapeDtypeStruct
dot_flops = H._dot_flops

def flops(compiled):
    # (all dots, the dots of a tensor with itself: XLA's RMSNorm sums).
    H._dot_flops = dot_flops
    total = H.analyze_hlo(compiled.as_text()).flops
    H._dot_flops = lambda ins, tab: (dot_flops(ins, tab)
                                     if ins.operands[0] == ins.operands[1] else 0.0)
    self_dots = H.analyze_hlo(compiled.as_text()).flops
    H._dot_flops = dot_flops
    return [total, self_dots]

out = {}
rng = sds((2,), jnp.uint32)
with activation_sharding(activation_rules(mesh)):
    params = jax.eval_shape(model.init, rng)
    batch = {"tokens": sds((B, S), jnp.int32), "labels": sds((B, S), jnp.int32)}
    st = jax.eval_shape(lambda r: make_train_state(model, r), rng)
    sh = (state_sharding(st, mesh), batch_sharding(batch, mesh))
    out["train"] = flops(jax.jit(build_train_step(model, AdamWConfig(), n_micro=n_micro),
                                 in_shardings=sh, out_shardings=(sh[0], None),
                                 donate_argnums=(0,)).lower(st, batch).compile())
    pb = {"tokens": sds((B, S), jnp.int32)}
    sh = (param_sharding(params, mesh), batch_sharding(pb, mesh))
    out["prefill"] = flops(jax.jit(build_prefill_step(model), in_shardings=sh)
                           .lower(params, pb).compile())
    cache = jax.eval_shape(lambda: model.init_cache(B, S))
    tok = sds((B,), jnp.int32)
    sh = (param_sharding(params, mesh), cache_sharding(cache, mesh), batch_sharding(tok, mesh))
    out["decode"] = flops(jax.jit(build_serve_step(model), in_shardings=sh,
                                  out_shardings=(None, sh[1]), donate_argnums=(1,))
                          .lower(params, cache, tok).compile())
print(json.dumps(out))
"""

_PORT_SMOKE = """
import json, sys, torch
from torch.distributed.device_mesh import DeviceMesh
from repro_torch.configs import smoke_config
from repro_torch.launch.dryrun import trace_step
from repro_torch.launch.mesh import fake_world
from repro_torch.models.lm import build_model

arch, B, S, n_micro, world = (sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
                              int(sys.argv[5]))
fake_world(world)
side = int(world ** 0.5)
mesh = DeviceMesh("cpu", torch.arange(world).reshape(side, side), mesh_dim_names=("data", "model"))
model = build_model(smoke_config(arch))
out = {}
for kind in ("train", "prefill", "decode"):
    cost, peak, n = trace_step(model, kind, B, S, mesh, n_micro=n_micro)
    out[kind] = dict(flops=cost.flops, kernel_flops=sum(cost.kernel_flops.values()),
                     kernel_calls=cost.kernel_calls, coll=cost.collective_bytes, peak=peak)
print(json.dumps(out))
"""

_CELLS = """
import json
from repro_torch.launch import dryrun
rs = [dryrun.run_cell("llama3.2-3b", "decode_32k", False),
      dryrun.run_cell("jamba-v0.1-52b", "long_500k", False)]
print(json.dumps([r.to_json() for r in rs]))
"""


def _cmd(code: str, *args, jax_devices: int | None = None) -> tuple:
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=SRC, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    if jax_devices:
        env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={jax_devices}"
    return [sys.executable, "-c", code, *map(str, args)], env


@pytest.fixture(scope="module")
def runs() -> dict:
    """The subprocesses (each loads its own package and world), two at a
    time."""
    smoke = [SMOKE[k] for k in ("arch", "B", "S", "n_micro")]
    cmds = {
        "tables": _cmd(_JAX_TABLES),  # the reference's module forces 512 devices itself
        "jax_smoke": _cmd(_JAX_SMOKE, *smoke, jax_devices=4),
        "port_smoke": _cmd(_PORT_SMOKE, *smoke, 4),
        "cells": _cmd(_CELLS),
        "port_one": _cmd(_PORT_SMOKE, *smoke, 1),
    }
    out, running = {}, []

    def finish():
        name, p = running.pop(0)
        stdout, stderr = p.communicate(timeout=240)
        assert p.returncode == 0, stderr[-4000:]
        out[name] = json.loads(stdout.strip().splitlines()[-1])

    for name, (cmd, env) in cmds.items():
        if len(running) == 2:
            finish()
        running.append((name, subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                               stderr=subprocess.PIPE, text=True)))
    while running:
        finish()
    return out


class _Stub:
    """A mesh as the reference's ``_micro`` reads one: axis names and sizes."""

    def __init__(self, shape: dict):
        self.shape = shape
        self.axis_names = tuple(shape)


def test_tables_equal_the_reference(runs):
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models.lm import build_model, count_params

    meshes = {"16x16": _Stub({"data": 16, "model": 16}),
              "2x16x16": _Stub({"pod": 2, "data": 16, "model": 16})}
    ref = runs["tables"]
    assert len(ref) == len(ARCH_IDS) * len(dryrun.SHAPES) * 2 == 80
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        with FakeTensorMode():
            n = float(count_params(build_model(cfg).init(0, device="cpu")))
        for shape, info in dryrun.SHAPES.items():
            for mname, mesh in meshes.items():
                want = ref[f"{arch}/{shape}/{mname}"]
                assert n == want["n_params"], arch
                assert dryrun.skip_reason(cfg, shape) == want["skip"]
                specs = {k: [list(s), str(dt).removeprefix("torch.")]
                         for k, (s, dt) in dryrun.input_specs(cfg, shape).items()}
                assert specs == want["specs"], (arch, shape)
                try:
                    micro = dryrun._micro(cfg, mesh, info["batch"])
                except ZeroDivisionError:  # batch 1 over 16 data ranks, as the reference
                    micro = "ZeroDivisionError"
                assert micro == want["micro"], (arch, shape, mname)
                assert dryrun.model_flops_estimate(
                    cfg, n, info["kind"], info["batch"], info["seq"]) == want["model_flops"]


def test_published_width_cells_trace(runs):
    llama, jamba = runs["cells"]
    for r in (llama, jamba):
        assert r["ok"] and r["error"] is None and r["skip"] is None, r
        assert r["flops"] > 0 and r["bytes_accessed"] > 0 and r["peak_memory_per_device"] > 0
        assert set(r["terms"]) == {"compute_s", "memory_s", "collective_s", "useful_flops_ratio"}
    assert llama["n_params"] == 3_212_749_824
    # A decode step moves rows between ranks: the placed cache's scores and
    # softmax sums are all-reduced, the projections' weights gathered.
    assert llama["coll_bytes"].get("all-reduce", 0) > 0
    assert jamba["coll_bytes"].get("all-reduce", 0) > 0


def _jax_attention(kind: str) -> float:
    """The reference's attention FLOPs a device on the (2, 2) mesh (batch
    over 'data', the 4 heads, K/V repeated to them, over 'model'): its flash
    twin's every block, 4·b·S·T·h·D a forward (twice under the train step's
    remat) and 10 a backward, and its decode ``_sdpa`` over every cache
    row."""
    cfg = smoke_config(SMOKE["arch"])
    S, D, layers = SMOKE["S"], cfg.head_dim, cfg.n_layers
    h = cfg.n_heads // 2
    if kind == "train":
        b = SMOKE["B"] // SMOKE["n_micro"] // 2
        return SMOKE["n_micro"] * layers * (2 * 4 + 10) * b * S * S * h * D
    b = SMOKE["B"] // 2
    return layers * 4 * b * S * (S if kind == "prefill" else 1) * h * D


def test_smoke_flops_against_the_reference_analyzer(runs, record_property):
    port, jax_, one = runs["port_smoke"], runs["jax_smoke"], runs["port_one"]
    report = {}
    for kind in ("train", "prefill", "decode"):
        total, self_dots = jax_[kind]
        p = port[kind]
        jax_rest = total - self_dots - (_jax_attention(kind) if kind != "decode" else 0)
        port_rest = p["flops"] - p["kernel_flops"]
        report[kind] = dict(port=p["flops"], port_attention=p["kernel_flops"],
                            reference=total, reference_attention=_jax_attention(kind),
                            reference_norm_dots=self_dots, port_rest=port_rest,
                            reference_rest=jax_rest)
        assert p["coll"], kind  # a (2, 2) mesh moves data in every step
    # Prefill: what is left is the same work, op for op.
    assert report["prefill"]["port_rest"] == report["prefill"]["reference_rest"]
    # Training: the port may recompute more under its remat, up to one
    # forward of the layers' projections (q, k, v, o and the MLP's three) a
    # micro-batch on this rank, here its share of 2 · rows · d · (H·D + 2·KV·D
    # + H·D + 3·F) flops a layer.
    cfg = smoke_config(SMOKE["arch"])
    rows = SMOKE["B"] // SMOKE["n_micro"] * SMOKE["S"]
    proj = 2 * rows * cfg.d_model * (2 * cfg.n_heads * cfg.head_dim
                                     + 2 * cfg.n_kv_heads * cfg.head_dim + 3 * cfg.d_ff)
    bar = SMOKE["n_micro"] * cfg.n_layers * proj / 4  # a rank's share of the 4
    extra = report["train"]["port_rest"] - report["train"]["reference_rest"]
    assert 0 <= extra <= bar, (extra, bar)
    # Decode: outside attention, each matmul of the step keeps at least one
    # of its two splits, the rows' over 'data' or the weight's over 'model'
    # (each of size 2; DTensor gathers a weight over 'data' where XLA splits
    # the rows, and the rows where it keeps the weight split), so a rank
    # runs between a quarter and a half of the step's whole work there (the
    # one-rank trace's, which is also what a count at the global shapes
    # gives: the bar fails it by 2x), on both sides. Attention is counted
    # over every cache row on both sides: the port's split-D route a rank
    # runs b·H·T·(D/2) per product, the reference's b·(H/2)·T·D, the same.
    whole = one["decode"]["flops"] - one["decode"]["kernel_flops"]
    att = _jax_attention("decode")
    report["decode"].update(whole_rest=whole, attention_a_rank=att)
    for got in (port["decode"]["flops"], jax_["decode"][0] - jax_["decode"][1]):
        assert whole / 4 <= got - att <= whole / 2, (got - att, whole)
    record_property("smoke_flops", json.dumps(report))
    print(json.dumps(report, indent=1))
    # The one-rank trace launches the decode kernel (nothing is split);
    # the (2, 2) mesh splits D and takes the written-out route.
    assert one["decode"]["kernel_calls"] == {"decode_attention": cfg.n_layers}
    assert port["decode"]["kernel_calls"] == {}
