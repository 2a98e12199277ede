"""The port's multi-device stack over several ranks on the CPU, held
against the JAX package's sharded step.

The ranks are processes of one ``gloo`` group (a ``FileStore`` under the
test's ``tmp_path``: no port is opened), each on one thread, each started
with a time limit. They run this module's ``_job_*`` functions:

* two AdamW steps of the smoke llama3.2-3b (float32 compute, batch
  4 x 32, 2 micro-batches) on a (data 2, model 2) mesh and on (1, 4),
  from the JAX package's initial state (a checkpoint of it, which both
  packages read). Losses, grad norms and the gathered state are held at
  ``tests/test_torch_train.py``'s ``STEP_BARS["float32"]`` against the
  port's one-process step, the JAX package's one-device step and its step
  under ``state_sharding``, ``batch_sharding`` and ``activation_rules`` on
  a (2, 2) ``Mesh`` of 4 forced host devices (a subprocess with
  ``XLA_FLAGS=--xla_force_host_platform_device_count=4``, which calls the
  reference's functions and changes nothing). The same subprocess dumps
  ``NamedSharding.devices_indices_map`` for an embedding, a stacked
  ``wq``, a ``wo`` and a batch: each rank's local shard is exactly the
  slice that JAX puts on the device at the same mesh position. The train
  launcher on the (2, 2) mesh writes a checkpoint from rank 0 and resumes
  from it.
* the serving loop on a (1, 2) mesh: tokens equal, logits within 2e-5 of
  the one-process serve (float32; the model axis splits the FFN and the
  vocabulary, so partial sums are added in another order); a GQA variant
  (4 query heads over 2 KV heads, both split over model 2, so K/V are not
  repeated) holds its loss, every gradient leaf (1e-5, the float32 bar of
  ``tests/test_torch_train.py``) and a serve against one process; the
  attention wrappers refuse a DTensor.

The stage-2 split runs in this process with the card count patched to 4.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
TIMEOUT = 240  # seconds for all ranks of one job together
ARCH = "llama3_2_3b"
OPT = dict(warmup_steps=2, total_steps=10)
MESHES = {"mesh22": (2, 2), "mesh14": (1, 4)}
# Leaves whose placement is checked slice by slice against JAX's.
PLACED = {
    "embed": "[<flat index 0>]['embed']['table']",
    "wq": "[<flat index 0>]['layers'][0]['mixer']['attn']['wq']['w']",
    "wo": "[<flat index 0>]['layers'][0]['mixer']['attn']['wo']['w']",
}


# --------------------------------------------------------------------------
# Ranks
# --------------------------------------------------------------------------

def _spawn(job: str, world: int, d: Path, module: str = "test_torch_mesh",
           timeout: float = TIMEOUT) -> None:
    """Run ``module``'s ``_job_<job>(rank, world, d)`` on ``world`` gloo
    ranks and wait for all of them (killing any left at the time limit)."""
    code = (f"import sys; sys.path.insert(0, {str(ROOT / 'tests')!r}); "
            f"import test_torch_mesh as t; t._rank_main(sys.argv[1:], {module!r})")
    env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"}
    logs = [open(d / f"{job}_rank{r}.log", "w") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, "-c", code, job, str(r), str(world), str(d),
                               str(timeout)],
                              env=env, stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(world)]
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    for r, p in enumerate(procs):
        assert p.returncode == 0, (d / f"{job}_rank{r}.log").read_text()[-4000:]


def _rank_main(argv: list[str], module: str = "test_torch_mesh") -> None:
    import importlib

    import torch.distributed as dist

    import faulthandler

    job, rank, world, d = argv[0], int(argv[1]), int(argv[2]), Path(argv[3])
    # Each thread's stack into the rank's log shortly before the time limit.
    faulthandler.dump_traceback_later(max(1.0, float(argv[4]) - 10.0))
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(str(d / f"{job}.store"), world),
                            rank=rank, world_size=world)
    try:
        getattr(importlib.import_module(module), f"_job_{job}")(rank, world, d)
    finally:
        dist.destroy_process_group()


def _port_model():
    from repro_torch.configs import smoke_config
    from repro_torch.models.lm import build_model

    return build_model(smoke_config(ARCH), compute_dtype=torch.float32)


def _job_train(rank: int, world: int, d: Path) -> None:
    """Two steps on each mesh of MESHES from the checkpoint ``d/init``; the
    metrics and the gathered state go to ``d/<mesh>``, each rank's local
    shards of the PLACED leaves and the batch to ``d/<mesh>_rank<r>.npz``."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.checkpoint import ckpt
    from repro_torch.checkpoint.ckpt import flatten_with_paths
    from repro_torch.distribution import sharding as S
    from repro_torch.models.layers import activation_sharding
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.steps import build_train_step, make_train_state

    model = _port_model()
    batches = np.load(d / "batches.npz")
    step = build_train_step(model, AdamWConfig(**OPT), n_micro=2)
    for name, shape in MESHES.items():
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
        like = make_train_state(model, 1, device="cpu")
        like = S.distribute(like, S.state_sharding(like, mesh))
        state, _ = ckpt.restore(str(d / "init"), like)  # placed as ``like``
        # Copies: the steps update the parameters in place.
        local = {k: leaf.to_local().numpy().copy() for p, leaf in flatten_with_paths(state)
                 for k, q in PLACED.items() if p == q}
        metrics = []
        with activation_sharding(S.activation_rules(mesh)):
            for i in range(2):
                b = {k: torch.from_numpy(batches[f"{k}{i}"]) for k in ("tokens", "labels")}
                b = S.distribute(b, S.batch_sharding(b, mesh))
                if i == 0:
                    local["tokens"] = b["tokens"].to_local().numpy().copy()
                state, m = step(state, b)
                metrics.append({k: float(v) for k, v in m.items()})
        np.savez(d / f"{name}_rank{rank}.npz", coord=np.asarray(mesh.get_coordinate()), **local)
        full = S.gather(state)
        if rank == 0:
            ckpt.save(str(d / name), 2, full)
            (d / f"{name}.json").write_text(json.dumps(metrics))
    # The launcher on the (2, 2) mesh: a checkpoint written by rank 0 from
    # the gathered state, and a resumed run placed from it again.
    from repro_torch.launch.train import train

    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    kw = dict(arch=ARCH, global_batch=4, seq=32, n_micro=2, device="cpu", mesh=mesh,
              log=lambda *_: None)
    whole = train(steps=3, **kw)
    train(steps=2, ckpt_dir=str(d / "ck"), ckpt_every=1, **kw)
    resumed = train(steps=3, ckpt_dir=str(d / "ck"), **kw)
    if rank == 0:
        (d / "launcher.json").write_text(json.dumps(dict(
            start=resumed.start, resumed=resumed.metrics, whole=whole.metrics)))
    # A batch over ("pod", "data") on a (2, 2, 1) mesh: the tuple nests its
    # axes outer first.
    mesh = init_device_mesh("cpu", (2, 2, 1), mesh_dim_names=("pod", "data", "model"))
    b = {"tokens": torch.from_numpy(batches["tokens0"])}
    b = S.distribute(b, S.batch_sharding(b, mesh))
    np.savez(d / f"pod_rank{rank}.npz", coord=np.asarray(mesh.get_coordinate()),
             tokens=b["tokens"].to_local().numpy())


def _serve_inputs():
    rng = np.random.default_rng(3)
    return torch.from_numpy(rng.integers(0, 256, (2, 8)))


def _job_serve(rank: int, world: int, d: Path) -> None:
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.kernels import attention
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.serve import serve_model

    model = _port_model()
    mesh = make_local_mesh(model=world, device="cpu")
    res = serve_model(model, model.init(0, device="cpu"), _serve_inputs(), 6, mesh=mesh)
    # GQA with the KV heads split as the query heads are (H 4, KV 2 over
    # model 2): K/V keep their KV heads, G = 2 on every rank. The loss and
    # every gradient leaf, and a serve, against this process without a mesh.
    import dataclasses

    from repro_torch.configs import smoke_config
    from repro_torch.distribution import sharding as S
    from repro_torch.models.layers import activation_sharding
    from repro_torch.models.lm import build_model
    from repro_torch.optim.adamw import tree_leaves

    gqa = build_model(dataclasses.replace(smoke_config(ARCH), n_kv_heads=2),
                      compute_dtype=torch.float32)
    params = gqa.init(0, device="cpu")
    rng = np.random.default_rng(4)
    batch = {k: torch.from_numpy(rng.integers(0, 256, (2, 32)).astype(np.int32))
             for k in ("tokens", "labels")}
    placed = S.distribute(params, S.param_sharding(params, mesh))
    for t in tree_leaves(params) + tree_leaves(placed):
        t.requires_grad_(True)
    want = gqa.loss(params, batch)
    want.backward()
    with activation_sharding(S.activation_rules(mesh)):
        got = gqa.loss(placed, S.distribute(batch, S.batch_sharding(batch, mesh)))
        got.backward()
    errs = dict(loss=abs(float(got.full_tensor()) - float(want)), grads=max(
        float((a.grad.full_tensor() - b.grad).abs().max())
        for a, b in zip(tree_leaves(placed), tree_leaves(params))))
    plain = serve_model(gqa, params, _serve_inputs(), 6)
    sharded = serve_model(gqa, params, _serve_inputs(), 6, mesh=mesh)
    errs["tokens_equal"] = bool(torch.equal(plain.tokens, sharded.tokens))
    errs["logits"] = float((plain.prompt_logits - sharded.prompt_logits).abs().max())
    if rank == 0:
        (d / "gqa.json").write_text(json.dumps(errs))

    # A decode step writes its K/V row into a replicated cache's storage,
    # and refuses a cache placed any other way (here its KV heads split
    # over model 2) instead of writing into a gathered copy.
    from repro_torch.models import layers

    att = layers.init_attention(torch.Generator().manual_seed(0), 64, 4, 2, 16)
    x = DTensor.from_local(torch.ones((1, 1, 64)), mesh, [Replicate(), Replicate()])
    with activation_sharding(S.activation_rules(mesh)):
        rep = [DTensor.from_local(torch.zeros((1, 8, 2, 16)), mesh, [Replicate(), Replicate()])
               for _ in range(2)]
        layers.decode_attention(att, x, 3, *rep, 1e4, 4, 2, 16)
        assert all(bool(c.to_local()[:, 3].abs().sum() > 0) for c in rep)
        split = [DTensor.from_local(torch.zeros((1, 8, 1, 16)), mesh, [Replicate(), Shard(2)])
                 for _ in range(2)]
        try:
            layers.decode_attention(att, x, 3, *split, 1e4, 4, 2, 16)
        except NotImplementedError:
            pass
        else:
            raise AssertionError("decode_attention wrote into a split cache")

    # The kernel wrappers take local shards only.
    q = DTensor.from_local(torch.zeros((1, 3, 4, 16)), mesh, [Replicate(), Replicate()])
    for call in (lambda: attention.flash_attention(q, q, q),
                 lambda: attention.decode_attention(q[:, 0], q, q, 2)):
        try:
            call()
        except TypeError:
            continue
        raise AssertionError("a kernel wrapper took a DTensor")
    if rank == 0:
        np.savez(d / "serve.npz", tokens=res.tokens.numpy(),
                 prompt_logits=res.prompt_logits.numpy(), prefill_logits=res.prefill_logits.numpy())


# --------------------------------------------------------------------------
# The JAX package's sharded step on 4 forced host devices
# --------------------------------------------------------------------------

_JAX_REF = """
import dataclasses, json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.checkpoint import ckpt
from repro.configs import smoke_config
from repro.distribution.sharding import activation_rules, batch_sharding, state_sharding
from repro.models import moe as moe_mod
from repro.models.layers import activation_sharding
from repro.models.lm import build_model
from repro.optim.adamw import AdamWConfig
from repro.runtime.steps import build_train_step, make_train_state

cases, opt, placed = json.loads(sys.argv[1]), json.loads(sys.argv[2]), json.loads(sys.argv[3])
assert len(jax.devices()) == 4
mesh = Mesh(np.asarray(jax.devices()).reshape(2, 2), ("data", "model"))

def index_map(sharding, shape):
    devs = sharding.mesh.devices
    out = {}
    for dev, idx in sharding.devices_indices_map(shape).items():
        where = ",".join(str(int(i)) for i in np.argwhere(devs == dev)[0])
        out[where] = [list(s.indices(n)[:2]) for s, n in zip(idx, shape)]
    return out

# The pairs each MoE call drops, counted from the reference's own routing
# (its top_k, capacity and cumulative sum) beside its moe_ffn.
drops = []
moe_ffn = moe_mod.moe_ffn

def counted(params, x, n_experts, top_k, capacity_factor=1.25, normalize=True):
    T = x.shape[0] * x.shape[1]
    logits = (x.reshape(T, -1) @ params["router"]["w"].astype(x.dtype)).astype(jnp.float32)
    _, idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), top_k)
    cap = max(int(np.ceil(T * top_k / n_experts * capacity_factor)), top_k)
    flat = idx.reshape(-1)
    pos = jnp.take_along_axis(jnp.cumsum(jax.nn.one_hot(flat, n_experts, dtype=jnp.int32), 0) - 1,
                              flat[:, None], axis=1)
    jax.debug.callback(lambda n: drops.append(int(n)), jnp.sum(pos >= cap))
    return moe_ffn(params, x, n_experts, top_k, capacity_factor, normalize)

for d, arch, over in cases:
    cfg = dataclasses.replace(smoke_config(arch), **over)
    model = build_model(cfg, compute_dtype=jnp.float32)
    batches = np.load(d + "/batches.npz")
    keys = [k for k in ("tokens", "labels", "memory") if k + "0" in batches]
    step = jax.jit(build_train_step(model, AdamWConfig(**opt), n_micro=2))
    out = {}
    if placed:
        mesh3 = Mesh(np.asarray(jax.devices()).reshape(2, 2, 1), ("pod", "data", "model"))
        b = {"tokens": jnp.asarray(batches["tokens0"])}
        out["pod_tokens"] = index_map(batch_sharding(b, mesh3)["tokens"], b["tokens"].shape)
    for name, ctx in (("jax1", None), ("jax22", mesh)):
        state = make_train_state(model, jax.random.PRNGKey(0))
        metrics = []
        if ctx is None:
            for i in range(2):
                b = {k: jnp.asarray(batches[k + str(i)]) for k in keys}
                state, m = step(state, b)
                metrics.append({k: float(v) for k, v in m.items()})
        else:
            with activation_sharding(activation_rules(mesh)), mesh:
                st_sh = state_sharding(jax.eval_shape(lambda: state), mesh)
                state = jax.device_put(state, st_sh)
                paths = {jax.tree_util.keystr(p): s
                         for p, s in jax.tree_util.tree_flatten_with_path(st_sh)[0]}
                shapes = {jax.tree_util.keystr(p): leaf.shape
                          for p, leaf in jax.tree_util.tree_flatten_with_path(state)[0]}
                for k, path in placed.items():
                    out[k] = index_map(paths[path], shapes[path])
                for i in range(2):
                    b = {k: jnp.asarray(batches[k + str(i)]) for k in keys}
                    b = jax.device_put(b, batch_sharding(b, mesh))
                    if i == 0 and placed:
                        out["tokens"] = index_map(b["tokens"].sharding, b["tokens"].shape)
                    state, m = step(state, b)
                    metrics.append({k: float(v) for k, v in m.items()})
        ckpt.save(d + "/" + name, 2, jax.tree.map(np.asarray, state))
        with open(d + "/" + name + ".json", "w") as f:
            json.dump(metrics, f)
    if cfg.n_experts:
        # Micro-batch 0 of the first step, eagerly from the initial state.
        moe_mod.moe_ffn = counted
        drops.clear()
        b = {k: jnp.asarray(batches[k + "0"][:len(batches[k + "0"]) // 2]) for k in keys}
        jax.block_until_ready(model.forward(make_train_state(model, jax.random.PRNGKey(0)).params,
                                            b["tokens"], b.get("memory")))
        jax.effects_barrier()
        moe_mod.moe_ffn = moe_ffn
        out["dropped"] = sum(drops)
    with open(d + "/placement.json", "w") as f:
        json.dump(out, f)
"""


def _start_jax_reference(cases: list, placed: dict, opt: dict = OPT) -> subprocess.Popen:
    """The JAX package's two steps, one device and the (2, 2) mesh, for each
    ``[directory, arch, config overrides]`` of ``cases`` (its batches and
    checkpoints in that directory), in one subprocess of 4 forced host
    devices; its log is the first directory's ``jax_ref.log``."""
    env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    log = open(Path(cases[0][0]) / "jax_ref.log", "w")
    p = subprocess.Popen([sys.executable, "-c", _JAX_REF, json.dumps(cases), json.dumps(opt),
                          json.dumps(placed)], env=env, stdout=log, stderr=subprocess.STDOUT)
    log.close()
    return p


# --------------------------------------------------------------------------
# Tests
# --------------------------------------------------------------------------

def _state_arrays(d: Path):
    """``d``'s checkpoint at step 2 as the port's TrainState arrays."""
    from repro_torch.checkpoint import ckpt
    from repro_torch.interop import train_state_to_arrays
    from repro_torch.runtime.steps import make_train_state

    state, _ = ckpt.restore(str(d), make_train_state(_port_model(), 1, device="cpu"))
    return train_state_to_arrays(state)


def _max_err(a, b) -> float:
    from repro_torch.optim.adamw import tree_leaves

    return max(float(np.abs(np.asarray(x, np.float32) - np.asarray(y, np.float32)).max())
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def test_sharded_steps_match_one_process_and_the_reference_sharded_step(tmp_path):
    import jax
    import jax.numpy as jnp
    from test_torch_train import STEP_BARS

    from repro.checkpoint import ckpt as j_ckpt
    from repro.configs import smoke_config as j_smoke_config
    from repro.models.lm import build_model as j_build_model
    from repro.runtime.steps import make_train_state as j_make_train_state
    from repro_torch.checkpoint import ckpt
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.steps import build_train_step, make_train_state

    rng = np.random.default_rng(0)
    np.savez(tmp_path / "batches.npz", **{
        f"{k}{i}": rng.integers(0, 256, (4, 32)).astype(np.int32)
        for i in range(2) for k in ("tokens", "labels")})
    jm = j_build_model(j_smoke_config(ARCH), compute_dtype=jnp.float32)
    j_ckpt.save(str(tmp_path / "init"), 0,
                jax.tree.map(np.asarray, j_make_train_state(jm, jax.random.PRNGKey(0))))
    ref = _start_jax_reference([[str(tmp_path), ARCH, {}]], PLACED)
    try:
        _spawn("train", 4, tmp_path)
        # The port in one process, from the same checkpoint.
        model = _port_model()
        state, _ = ckpt.restore(str(tmp_path / "init"), make_train_state(model, 1, device="cpu"))
        step = build_train_step(model, AdamWConfig(**OPT), n_micro=2)
        batches = np.load(tmp_path / "batches.npz")
        one = []
        for i in range(2):
            state, m = step(state, {k: torch.from_numpy(batches[f"{k}{i}"])
                                    for k in ("tokens", "labels")})
            one.append({k: float(v) for k, v in m.items()})
        ckpt.save(str(tmp_path / "one"), 2, state)
        ref.wait(timeout=TIMEOUT)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert ref.returncode == 0, (tmp_path / "jax_ref.log").read_text()[-4000:]
    (tmp_path / "one.json").write_text(json.dumps(one))

    p_bar, m_bar, v_bar, _, n_bar = STEP_BARS["float32"]
    refs = {name: (json.loads((tmp_path / f"{name}.json").read_text()),
                   _state_arrays(tmp_path / name)) for name in ("one", "jax1", "jax22")}
    for name in MESHES:
        got_m = json.loads((tmp_path / f"{name}.json").read_text())
        got = _state_arrays(tmp_path / name)
        assert int(got["opt"]["step"]) == 2
        for ref_name, (want_m, want) in refs.items():
            for g, w in zip(got_m, want_m):
                np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-5, err_msg=ref_name)
                np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], rtol=n_bar,
                                           err_msg=ref_name)
                assert g["lr"] == w["lr"]
            assert _max_err(got["params"], want["params"]) <= p_bar, (name, ref_name)
            assert _max_err(got["opt"]["m"], want["opt"]["m"]) <= m_bar, (name, ref_name)
            assert _max_err(got["opt"]["v"], want["opt"]["v"]) <= v_bar, (name, ref_name)

    # The launcher under the mesh resumes from its own checkpoint.
    launcher = json.loads((tmp_path / "launcher.json").read_text())
    assert launcher["start"] == 2
    np.testing.assert_allclose(launcher["resumed"][0]["loss"], launcher["whole"][2]["loss"],
                               rtol=1e-6)

    # Each rank of the (2, 2) mesh holds the slice JAX puts on the device at
    # its mesh position (the initial state and the first batch).
    placement = json.loads((tmp_path / "placement.json").read_text())
    from repro_torch.checkpoint.ckpt import flatten_with_paths
    from repro_torch.runtime.steps import make_train_state as t_make

    init, _ = ckpt.restore(str(tmp_path / "init"), t_make(_port_model(), 1, device="cpu"))
    full = {k: leaf.numpy() for p, leaf in flatten_with_paths(init)
            for k, q in PLACED.items() if p == q}
    full["tokens"] = batches["tokens0"]
    for r in range(4):
        local = np.load(tmp_path / f"mesh22_rank{r}.npz")
        coord = ",".join(str(int(c)) for c in local["coord"])
        for k, arr in full.items():
            sl = tuple(slice(a, b) for a, b in placement[k][coord])
            np.testing.assert_array_equal(local[k], arr[sl], err_msg=f"{k} on rank {r}")
        local = np.load(tmp_path / f"pod_rank{r}.npz")
        coord = ",".join(str(int(c)) for c in local["coord"])
        sl = tuple(slice(a, b) for a, b in placement["pod_tokens"][coord])
        assert local["tokens"].shape == (1, 32)
        np.testing.assert_array_equal(local["tokens"], batches["tokens0"][sl], err_msg=f"rank {r}")


def test_sharded_serve_matches_one_process(tmp_path):
    from repro_torch.launch.serve import serve_model

    _spawn("serve", 2, tmp_path)
    model = _port_model()
    want = serve_model(model, model.init(0, device="cpu"), _serve_inputs(), 6)
    got = np.load(tmp_path / "serve.npz")
    np.testing.assert_array_equal(got["tokens"], want.tokens.numpy())
    for k in ("prompt_logits", "prefill_logits"):
        np.testing.assert_allclose(got[k], getattr(want, k).numpy(), atol=2e-5, rtol=0)
    gqa = json.loads((tmp_path / "gqa.json").read_text())
    assert gqa["loss"] <= 1e-5 and gqa["grads"] <= 1e-5, gqa
    assert gqa["tokens_equal"] and gqa["logits"] <= 2e-5, gqa


def test_stage2_split_over_four_cards_is_bit_equal(monkeypatch):
    """Stage 2's rows split over 4 chunks (the card count patched to 4 on
    the CPU) give the one-chunk FleetResult field for field, and the
    launch's rows round up to a multiple of 4 as the reference's B2 does."""
    from test_torch_vectorized import _assert_same_result, _stats

    from repro_torch.core import ProblemInstance, random_job
    from repro_torch.core import vectorized as V
    from repro_torch.obs.trace import Tracer

    rng = np.random.default_rng(4)
    insts = [ProblemInstance(job=random_job(rng, None, n_tasks=n, rho=1.0), n_racks=3,
                             n_wireless=1) for n in (5, 6, 7)]

    def run(n_dev):
        monkeypatch.setattr(V, "_seen_stage1", set())  # each run counts its buckets afresh
        monkeypatch.setattr(V, "_seen_stage2", set())
        monkeypatch.setattr(V, "_stage2_devices", lambda dev: [dev] * n_dev)
        tr = Tracer()
        res = V.schedule_fleet(insts, batch_size=33, seed=[0, 1, 2], device="cpu", tracer=tr)
        return res, {s.attrs["rows"] for s in tr.spans_named("stage2_launch")}

    one, rows1 = run(1)
    four, rows4 = run(4)
    assert rows1 == {99} and rows4 == {100}
    assert one.n_stage2_launches > 0
    for a, b in zip(four.results, one.results):
        _assert_same_result(a, b)
    np.testing.assert_array_equal(four.makespans, one.makespans)
    for f in ("n_candidates", "n_pruned", "n_evaluated", "n_stage1_launches",
              "n_stage2_launches", "n_stage1_traces", "n_stage2_traces"):
        assert getattr(four, f) == getattr(one, f), f
    assert _stats(four.strategy_stats) == _stats(one.strategy_stats)

    # The fleet-of-one evaluator pads to a multiple of the card count too.
    monkeypatch.setattr(V, "_stage2_devices", lambda dev: [dev] * 4)
    ev4 = V.make_batched_evaluator(insts[0], device="cpu")
    monkeypatch.setattr(V, "_stage2_devices", lambda dev: [dev])
    ev1 = V.make_batched_evaluator(insts[0], device="cpu")
    racks = np.random.default_rng(5).integers(0, 3, (37, 5))
    assert torch.equal(ev4(racks), ev1(racks))


def test_stage2_devices_are_this_process_cards(monkeypatch):
    """The real ``_stage2_devices`` with 4 cards patched in: an unnamed
    card splits over every card, the current one first (its tables are on
    it); a named card, or a process group of several ranks (one process a
    card), keeps stage 2 on that card; the CPU stays one device."""
    from repro_torch.core import vectorized as V

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 2)
    cuda = [torch.device("cuda", i) for i in range(4)]
    assert V._stage2_devices(torch.device("cuda")) == [cuda[2], cuda[0], cuda[1], cuda[3]]
    assert V._stage2_devices(torch.device("cuda:1")) == [cuda[1]]
    assert V._stage2_devices(torch.device("cpu")) == [torch.device("cpu")]
    monkeypatch.setattr(V.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(V.dist, "get_world_size", lambda: 4)
    assert V._stage2_devices(torch.device("cuda")) == [torch.device("cuda")]
    monkeypatch.setattr(V.dist, "get_world_size", lambda: 1)
    assert V._stage2_devices(torch.device("cuda"))[0] == cuda[2]
