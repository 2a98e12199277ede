#!/usr/bin/env python3
"""On-card smoke run of the PyTorch / CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA card:

    python3 chip_smoke.py

It builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` into
``build/``, then:

  0. prints the card's name and power limit, the torch and CUDA versions,
     the build time, the registers, spills and shared memory of each bf16
     flash instantiation, and the registers and spills of each decode,
     cpm and flash backward one (a cpm or backward spill fails the run);
  1. holds every kernel entry point against its plain PyTorch version on
     the card (tolerance 0: ``torch.equal``) at the offline main-path
     shape, the serving shape and ragged shapes, and times both with CUDA
     events (and the cpm kernels at the offline shape on the device alone,
     in a CUDA graph); the fused stage-1 kernels (``fleet_lb``,
     ``fleet_lb_masked``) take the stage-1 inputs of phase 2's fleet, and
     one stage-1 launch as the engine makes it is split into its
     host-to-device copy, launch-to-sync and copy back;
  2. solves the stress lane's 16-job production fleet offline with
     ``schedule_fleet`` at the engine defaults, with and without a
     restricted topology (wall, stage-1 and stage-2 ms a launch, peak
     device memory), and checks fleet == solo, feasibility, and card ==
     CPU on a 4-instance subset;
  3. serves the ``production_fleet`` golden stream (exact fingerprint),
     a 200-job production stream with the default fleet policy, and the
     same stream under ``topology="matching"``;
  4. profiles the offline fleet and a 20-job serve with torch.profiler
     (device time by kernel, busy share, kernel count);
  5a. holds the flash and decode attention kernels against their plain
     versions (2e-5 in float32, 4e-2 in bfloat16 elementwise, and each
     output row within 2e-5 / 1e-2 of its own norm) at llama3.2-3b's heads,
     phi3-mini's (D 96) and seamless-m4t-medium's (D 64), ragged lengths,
     the reference tests' shapes and long caches, phase 7's shapes (jamba's
     attention, seamless's encoder, self and one-token cross steps, the
     vision model's self and cross layers over 1,600 patches), and times
     kernel, plain
     version and PyTorch's ``scaled_dot_product_attention`` (the
     yardstick; the port never calls it); each row also gives its share
     of its bound and the host time of one wrapper call (through the
     kernel operators, and with each operator's CUDA implementation called
     directly, as the wrapper did before the operators), a flash row its
     TFLOP/s, and every decode row and the bf16 flash rows the device
     times alone (CUDA graphs of the calls) of kernel and SDPA;
  5b. serves llama3.2-3b at its full widths with seed-0 bf16 weights: 4
     requests of 512-token prompts through the prefill step, then the
     serve loop decodes the prompts into the KV cache and generates 32
     tokens; checks finite logits, prefill == decode at the last prompt
     position, and that both attention kernels ran; then profiles a
     prefill and a few decode steps;
  5c. decodes a few steps of B = 8 over a 32,768-token cache filled from
     the seed, beside the step's byte bound;
  5d. holds the port on the card (kernels) against the port on the CPU
     (plain versions) on the smoke configs of every family: prefill and 8
     decode steps (KL per row for the MoE configs, allclose for the rest);
  6. runs the paper's production scenario (examples/schedule_cluster.py)
     with the exact optimum as the oracle: 8 periodic jobs on 8 racks and
     2 wireless subchannels through ``schedule_fleet`` on the card, each
     job's wired-only and wireless-augmented optimum by ``solve_bnb``
     (time limit 10 s a solve, as in the example); a job that does not
     prove optimal in that time is reported as such and its checks are
     skipped. Where proved: the fleet's makespan >= optimum - 0.15, and
     augmented <= wired-only + 0.15. On tests/test_vectorized.py's
     instances (seeds 0-3) the stage-1 bound on the card is <= the
     optimum + 1e-3 and <= each candidate's stage-2 score + 1e-3, the
     engine is >= optimum - 0.15, and ``solve_bnb`` (30 s),
     ``solve_optimal`` (HiGHS, 90 s) and ``solve_bisection`` (60 s a
     feasibility problem) agree within tests/test_milp_optimal.py's
     tolerances. Then the gradient-sync planner at llama3.2-3b's widths
     (``plan_gradient_schedule`` and a degraded ``replan``, 10 s each):
     optimal <= greedy and <= serial. Last, phase 4's 20-job serve again
     under a ``Tracer``, written by ``write_chrome_trace`` and read back by
     ``load_trace``: one breakdown row per epoch and a finite, positive
     commit latency. The phase's cpm launches are counted from 0 and
     ``fleet_lb`` must have run;
  7. serves the expert, recurrent and cross-attention families at their
     published widths through ``serve_model`` (seed-0 bf16 weights, 4
     requests each, one model on the card at a time): jamba-v0.1-52b cut
     to one period of 8 layers (4 x 512 tokens, 16 generated; timed at
     its capacity factor with KL(prefill || decode) reported, then again
     without drops and gated at tests/test_models.py:103-111's KL bars),
     with the time of each layer kind and a profile of a prefill and 4
     decode steps; xlstm-350m (4 x 256, 16 generated) with its layer
     times, gated on the KL bars in bf16 (the reference's own bf16 gap
     exceeds the tolerance at these widths) and at max(0.05, 0.02 *
     n_layers) with the same weights in float32 compute;
     seamless-m4t-medium over 256 frames (4 x 256, 16 generated);
     llama-3.2-vision-11b over 1,600 patches (4 x 128, 8 generated). The
     last two are gated at prefill == decode within max(0.05, 0.02 *
     n_layers); every serve checks finite logits and the exact flash and
     decode launch counts of its layer kinds, and reports its bounds;

  8. trains llama3.2-3b: 8a holds the flash forward with its
     log-sum-exp and the three backward kernels (delta, dk and dv, dq)
     against their plain versions at the training shapes (llama3.2-3b's
     heads at B 4, S = T 1,024, causal, bf16 and float32; D 96 causal; D
     64 non-causal, the encoder's; a ragged S of 1,000; cross-attention's
     S 512 over T 1,600, 32 / 8 heads, non-causal, bf16 and float32) at the attention
     bars, checks that two calls of the dk/dv and dq kernels at the
     training shape are equal (no atomics), and times each by CUDA events
     and alone in a CUDA graph beside the plain version, SDPA's forward
     and backward and the bound, with its TFLOP/s, and the forward with
     lse beside the serving forward at the serving prefill shape; 8b
     trains llama3.2-3b at its published widths (f32 master weights from
     seed 0, bf16 compute, global batch 8 x 1,024 tokens from the port's
     pipeline in 2 micro-batches, AdamW(warmup 2, total 4), 4 steps)
     through ``launch/train.py``'s ``train`` with exact launch counts,
     reports ms a step, tokens/s, MFU, the bound and peak memory, checks
     finite losses, grad_norm > 0 and moved parameters, then profiles one
     more step; 8c holds the step with kernels against the same step with
     the plain versions on the card (the widths cut to 2 layers, 2 steps);
     8d saves, restores (torch.equal) and resumes the smoke config's
     training; 8e trains each family through ``build_train_step`` at its
     published widths (xlstm-350m and seamless-m4t-medium whole,
     llama-3.2-vision-11b cut to 5 of 40 layers and jamba-v0.1-52b to 2 of
     32, so that the float32 state fits the card; seed 0, bf16 compute, 2
     micro-batches, 3 steps on the port's pipeline) with exact launch
     counts, finite losses, grad_norm > 0 and moved parameters, reports ms
     a step, tokens/s, MFU, the bound and peak memory, profiles one more
     step, and holds vision's step at 4 layers with the kernels against
     the plain versions as 8c does;
  9. runs the multi-device stack on the card's 1 x 1 mesh (one NCCL rank;
     the machine has one card, so the mesh path is held equal to its
     one-device result): 9a builds ``make_local_mesh()``, checks that
     ``make_production_mesh()`` refuses one rank and prints llama3.2-3b's
     state leaves by placement and its parameters' specs on a (16, 16)
     mesh shape; 9b trains llama3.2-3b through ``train(mesh=...)`` at 8b's
     shape with exact launch counts, its losses and grad norms within 1e-3
     relative of 8b's and each leaf's sampled update within 8c's 0.25 of
     8b's, reports whether step 0's loss equals 8b's bit for bit, ms a
     step, tokens/s, MFU, busy share and peak memory beside 8b's, and the
     top host costs of a step by cProfile; 9c serves llama3.2-3b (4 x 64
     tokens, 16 generated) through ``serve_model(mesh=...)`` and without a
     mesh: tokens equal, the last prompt logits within max(0.05, 0.02 *
     n_layers), exact launch counts for each route, ms a decode step
     each; 9d records stage 2's card and chunk counts;
  10. runs the dry run (``repro_torch.launch.dryrun``): 10a traces
     llama3.2-3b's train_4k, prefill_32k and decode_32k cells on fake
     tensors over a fake world of 256 ranks (16 x 16), in subprocesses on
     the host's cores, each cell ``ok``, printing its per-device FLOPs,
     bytes, collective bytes by kind, peak GiB and terms; 10b counts 8b's
     training step and a 9c decode step (the cache placed by
     ``cache_sharding``) under ``analyze_ops`` on the card's 1 x 1 mesh
     with the kernels (the decode step's parameters bf16, as 9c serves),
     and the same steps on fake tensors over a fake world of one, with
     parameters of the same dtypes: FLOPs, HBM bytes, collective bytes and
     each kernel operator's calls equal; 10c serves 9c's shape with the cache placed by
     ``cache_sharding`` and with a replicated cache: tokens equal, decode
     launches equal;

and prints the kernel table and, as its last line,
``{"ok": true, "device": {...}}``. Every check raises on failure. It
exits non-zero, printing no result, when no card is available or when
``src/repro_torch`` is missing. Each main path reads its own launch
counts: the scheduler's (phases 2 and 3), the serving path's (phase 5b),
each family's serve (phase 7), the training path's (phase 8b), each
family's training step (phase 8e) and the mesh path's training and
serving (phases 9b and 9c), every count set to 0 just before and read
just after.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Published H100 SXM peaks (NVIDIA data sheet): HBM rate, float32
# outside the tensor cores and bf16 on the tensor cores; the bound of a
# kernel is the larger of bytes / HBM rate and operations / the rate of
# their type.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12

# tests/test_admission.py GOLDEN["production_fleet"].
GOLDEN_FLEET_ROWS = [
    (0, 6.1001481267803985, 217.14539798702484, 211.04524986024444, 5, 2),
    (1, 18.262137412159362, 271.7465923371507, 253.48445492499133, 2, 0),
    (2, 217.14539798702484, 348.5513576149018, 131.40595962787697, 4, 2),
    (3, 217.14539798702484, 691.8271308510732, 474.6817328640484, 1, 0),
    (4, 271.7465923371507, 395.1547551642818, 123.40816282713115, 3, 1),
]
GOLDEN_FLEET_COUNTERS = dict(
    n_epochs=6, n_served=5, n_backfilled=0, horizon=691.8271308510732
)

# The port's own kernels (csrc/*.cu), reported by name in every profile.
PORT_KERNELS = ("cpm_lanes_kernel", "cpm_fleet_kernel", "cpm_rows_kernel",
                "cpm_fleet_rows_kernel", "flash_fwd_", "decode_split_kernel",
                "decode_combine_kernel", "flash_bwd_")

SERVE_JOBS = 200
PROFILE_JOBS = 20
# Phase 6: examples/schedule_cluster.py's fleet and its B&B time limit.
SCENARIO_JOBS, SCENARIO_BNB_S = 8, 10.0
EPS_SLACK = 0.15  # tests/test_vectorized.py:43, tests/test_integration.py:96
CSRC = "src/repro_torch/kernels/csrc/"
SOURCE = {
    "combined_lb": CSRC + "cpm.cu",
    "combined_lb_masked": CSRC + "cpm.cu",
    "critical_path": CSRC + "cpm.cu",
    "fleet_lb": CSRC + "cpm.cu",
    "fleet_lb_masked": CSRC + "cpm.cu",
    "flash_attention": CSRC + "flash_attention.cu",
    "decode_attention": CSRC + "decode_attention.cu",
    "flash_attention_lse": CSRC + "flash_attention.cu",
    "flash_bwd_delta": CSRC + "flash_attention_bwd.cu",
    "flash_bwd_dkdv": CSRC + "flash_attention_bwd.cu",
    "flash_bwd_dq": CSRC + "flash_attention_bwd.cu",
}
REPLACES = {
    "combined_lb": "src/repro/kernels/cpm.py:93",
    "combined_lb_masked": "src/repro/kernels/cpm.py:101",
    "critical_path": "src/repro/kernels/cpm.py:56",
    # with the device program around it, src/repro/core/vectorized.py:455
    "fleet_lb": "src/repro/kernels/cpm.py:93",
    "fleet_lb_masked": "src/repro/kernels/cpm.py:101",
    "flash_attention": "src/repro/kernels/flash_attention.py:29",
    "decode_attention": "src/repro/kernels/decode_attention.py:27",
    # The Pallas kernel's forward with the residual lse of the custom VJP's
    # forward (src/repro/models/flash.py:92); no Pallas backward exists, the
    # backward kernels replace the custom VJP's jnp backward.
    "flash_attention_lse": "src/repro/kernels/flash_attention.py:29",
    "flash_bwd_delta": "src/repro/models/flash.py:108",
    "flash_bwd_dkdv": "src/repro/models/flash.py:108",
    "flash_bwd_dq": "src/repro/models/flash.py:108",
}

# The serving cell: llama3.2-3b at its published widths.
SERVE_ARCH = "llama3.2-3b"
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 512, 32
LONG_BATCH, LONG_CACHE, LONG_STEPS = 8, 32768, 4
# Phase 7: the expert, recurrent and cross-attention families at their
# published widths, 4 requests each. jamba-v0.1-52b is cut to one period
# of its layer pattern (8 of 32 layers: attention on layer 3, MoE on the
# odd layers); the others run whole.
J_ARCH, J_LAYERS, J_PROMPT, J_GEN = "jamba-v0.1-52b", 8, 512, 16
X_ARCH, X_PROMPT, X_GEN = "xlstm-350m", 256, 16
F_ARCH, F_PROMPT, F_GEN = "seamless-m4t-medium", 256, 16  # frames = prompt
V_ARCH, V_PROMPT, V_GEN, V_PATCHES = "llama-3.2-vision-11b", 128, 8, 1600
FAMILY_BATCH = 4
ATTN_TOL = {"torch.float32": 2e-5, "torch.bfloat16": 4e-2}
# With randn inputs the softmax averages many V rows, so a typical output
# value is 0.01-0.05 and 4e-2 alone would pass a wrong rescale. Each
# output row (D values) is therefore also held to its own norm:
# ||got - want|| / ||want|| at most this. In bf16 both sides round the
# output once (about 2**-9 each) and the kernel rounds p before P.V;
# 1e-2 is about 2.5x what that gives and about 1% of a row.
ATTN_ROW_TOL = {"torch.float32": 2e-5, "torch.bfloat16": 1e-2}
# Phase 8: the training path. llama3.2-3b at its published widths, f32
# master weights from seed 0, bf16 compute, AdamW(warmup 2, total 4), a
# global batch of 8 x 1,024 tokens from the port's pipeline in 2
# micro-batches, 4 steps (the first warms up); 8c cuts the widths' depth to
# 2 layers. Every leaf's update in 8c is held within UPDATE_REL_TOL of the
# plain versions' (||du - dv|| / ||dv||): Adam's first steps move each
# weight by about lr * sign(g), so an entry whose gradient is within the
# bf16 noise may move the other way; two bf16 implementations of the whole
# model (the port and the JAX package, smoke config, two steps) differ by
# up to 0.13 per leaf, unrelated updates by about sqrt(2).
TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO, TRAIN_STEPS = "llama3.2-3b", 8, 1024, 2, 4
TRAIN_CUT_LAYERS, TRAIN_CUT_STEPS = 2, 2
UPDATE_REL_TOL = 0.25
# 8b keeps a strided sample of each leaf's update (at most this many
# entries a leaf) for 9b to compare with.
UPDATE_SAMPLE = 1 << 20
# Phase 9: the mesh path on a 1 x 1 mesh. 9b trains at 8b's shape and is
# held to 8d's 1e-3 relative on losses and grad norms (the embedding
# gradient's index_put_ adds with atomics, so two runs are not bit-equal)
# and to 8c's UPDATE_REL_TOL on each leaf's sampled update; 9c serves
# MESH_BATCH x MESH_PROMPT tokens and MESH_GEN generated through both
# routes.
MESH_REL_TOL = 1e-3
MESH_BATCH, MESH_PROMPT, MESH_GEN = 4, 64, 16
BWD_KERNELS = ("flash_bwd_delta", "flash_bwd_dkdv", "flash_bwd_dq")
# Phase 8e: the families' training steps at their published widths, f32
# master weights from seed 0, bf16 compute, AdamW(warmup 2), 2
# micro-batches, FAMILY_TRAIN_STEPS steps (the first warms up) on the
# port's pipeline: (label, arch, layers kept (None: whole), batch, seq).
# Depth is cut only where one 80 GB card cannot hold the f32 state (16
# bytes a parameter: weights, gradients, m, v): vision keeps 5 of 40
# layers (the cross layer is layer 3), jamba 2 of 32 (SSD + MLP, SSD +
# 16-expert MoE; 4 layers would need 102 GiB of state).
FAMILY_TRAIN = (
    ("xlstm", "xlstm-350m", None, 4, 256),
    ("seamless", "seamless-m4t-medium", None, 4, 256),
    ("vision", "llama-3.2-vision-11b", 5, 4, 512),
    ("jamba", "jamba-v0.1-52b", 2, 4, 512),
)
FAMILY_TRAIN_STEPS = 3
VISION_CUT_LAYERS = 4  # 8e's kernels-against-plain arm: the fewest layers holding the cross layer
# Phase 9e / 9f: the families on the 1 x 1 mesh. 9e trains 8e's arms for
# FAMILY_MESH_STEPS steps (the first warms up) and holds them to 8e's first
# two at MESH_REL_TOL and UPDATE_REL_TOL; 9f serves jamba (J_LAYERS),
# xlstm, seamless (frames as long as the prompt) and vision (V_PATCHES)
# with MESH_BATCH x FAMILY_MESH_PROMPT tokens and FAMILY_MESH_GEN
# generated through the mesh route and the route without one.
FAMILY_MESH_STEPS = 2
FAMILY_MESH_PROMPT, FAMILY_MESH_GEN = 64, 8
# Phase 10: the dry run. 10a traces llama3.2-3b's cells on the 16 x 16
# fake world, one process a cell, all at once (a process holds one fake
# world, and none may share phase 9's NCCL group); 10b traces 8b's training
# step and a 9c decode step on the card and on a fake world of one; 10c
# serves 9c's shape with the cache placed by cache_sharding against the
# replicated one.
DRYRUN_SHAPES = ("train_4k", "prefill_32k", "decode_32k")
DRYRUN_TIMEOUT = 600
_FAKE_TRACE = """
import dataclasses, json, sys, torch
from torch.distributed.device_mesh import DeviceMesh
from repro_torch.configs import get_config
from repro_torch.launch.dryrun import trace_step
from repro_torch.launch.mesh import fake_world
from repro_torch.models.lm import build_model

arch, B, S, n_micro, Bd, T, pos = sys.argv[1], *map(int, sys.argv[2:8])
fake_world(1)
mesh = DeviceMesh("cpu", torch.arange(1).reshape(1, 1), mesh_dim_names=("data", "model"))
model = build_model(get_config(arch))
out = {}
for kind, b, s, kw in (("train", B, S, dict(n_micro=n_micro)),
                       ("decode", Bd, T, dict(pos=pos, param_dtype=torch.bfloat16))):
    cost, peak, _ = trace_step(model, kind, b, s, mesh, **kw)
    out[kind] = dict(dataclasses.asdict(cost), peak=peak)
print(json.dumps(out))
"""


def emit(tag: str, **fields) -> None:
    print(json.dumps({"phase": tag, **fields}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def row_rel_err(got, want) -> float:
    """Largest ||got - want|| / ||want|| over the rows of the last axis."""
    d = (got.float() - want.float()).norm(dim=-1)
    return float((d / want.float().norm(dim=-1).clamp_min(1e-30)).max())


def check_attention(torch, name, got, want, dtype, what) -> tuple[float, float]:
    """The reference's elementwise tolerance and the row-relative one;
    returns (max abs error, max row-relative error)."""
    tol, row_tol = ATTN_TOL[str(dtype)], ATTN_ROW_TOL[str(dtype)]
    err = float((got.float() - want.float()).abs().max())
    rel = row_rel_err(got, want)
    check(torch.allclose(got.float(), want.float(), atol=tol, rtol=tol),
          f"{name} != plain at {what}: max abs err {err}")
    check(rel <= row_tol, f"{name} != plain at {what}: row-relative err {rel} > {row_tol}")
    return err, rel


def cuda_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device ms per call over ``reps`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(torch, fn, reps: int = 20) -> float:
    """Device ms per call with no host in the way: ``reps`` calls captured
    in one CUDA graph, replayed once between two events."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up on a side stream, as capture wants
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / reps


def host_us(torch, fn, reps: int = 100) -> float:
    """Host microseconds per call (the enqueue: checks, allocation, launch)."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t) / reps * 1e6
    torch.cuda.synchronize()
    return us


def operator_host_us(torch, fn, rounds: int = 5) -> tuple[float, float]:
    """Host microseconds per attention wrapper call ``fn`` through the
    kernel operators (``repro_torch::*``: the dispatcher, then the CUDA
    implementation), and with each operator replaced by its CUDA
    implementation called directly (the wrapper as it was before the
    operators: its checks, then the ctypes launch); the medians of
    ``rounds`` alternating runs of ``host_us``."""
    import statistics
    import types

    from repro_torch.kernels import attention as A

    direct = types.SimpleNamespace(
        flash_fwd=lambda q, k, v, c: A._flash_cuda(q, k, v, c, False),
        flash_fwd_lse=lambda q, k, v, c: A._flash_cuda(q, k, v, c, True),
        flash_bwd_delta=A._delta_cuda, flash_bwd_dkdv=A._dkdv_cuda, flash_bwd_dq=A._dq_cuda,
        decode_attention=A._decode_cuda)
    ops, via, raw = A._OPS, [], []
    for _ in range(rounds):
        via.append(host_us(torch, fn))
        A._OPS = direct
        try:
            raw.append(host_us(torch, fn))
        finally:
            A._OPS = ops
    return statistics.median(via), statistics.median(raw)


def lb_inputs(np, torch, rng, B: int, n: int):
    """Ragged DAG mega-batch on the card: rows of 0..n live nodes, -inf
    no-edges, ``extra`` -inf, dominated or dominating, and a mask that is
    zero on some edges and a positive uplift on others."""
    nb = rng.integers(0, n + 1, size=B)
    live = np.arange(n)[None, :] < nb[:, None]
    upper = np.triu(np.ones((n, n), bool), 1)
    edge = (rng.random((B, n, n), dtype=np.float32) < 0.3) & upper & live[:, None, :]
    w = np.where(edge, rng.uniform(1, 10, (B, n, n)).astype(np.float32), -np.inf)
    p = np.where(live, rng.uniform(1, 100, (B, n)), 0).astype(np.float32)
    kind = rng.integers(0, 3, size=B)
    extra = np.where(
        kind == 0, -np.inf, np.where(kind == 1, rng.uniform(0, 50, B), 1e4)
    ).astype(np.float32)
    mask = np.where(
        edge & (rng.random((B, n, n), dtype=np.float32) < 0.5),
        rng.uniform(0, 20, (B, n, n)).astype(np.float32), 0,
    ).astype(np.float32)
    dev = torch.device("cuda")
    return tuple(
        torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dev)
        for a in (w, p, extra, mask)
    )


def rounds_needed(torch, ref, w, n_iters: int, mask=None) -> int:
    """Relaxation rounds these rows need, summed over the rows: a row's
    rounds up to the first that changes no bit of its dist (that one
    included, as it shows the fixed point), at most ``n_iters``. The
    kernels stop a warp's rounds there; later rounds repeat it."""
    w = w.float()
    w = torch.where(torch.isfinite(w), w, torch.full_like(w, ref.NEG_INF))
    if mask is not None:
        w = w + mask
    B = w.shape[0]
    d = torch.zeros(w.shape[:2], dtype=torch.float32, device=w.device)
    need = torch.full((B,), n_iters, dtype=torch.int64, device=w.device)
    done = torch.zeros(B, dtype=torch.bool, device=w.device)
    for k in range(n_iters):
        nd = torch.maximum(d, (d[:, :, None] + w).amax(dim=1))
        fixed = (nd.view(torch.int32) == d.view(torch.int32)).all(dim=1)
        need = torch.where(fixed & ~done, torch.full_like(need, k + 1), need)
        done |= fixed
        d = nd
    return int(need.sum())


def bound(B: int, n: int, rounds: int, kind: str) -> tuple[float, str]:
    """Least ms the card could take: each input read once, each output
    written once, over HBM rate; max/add operations (``rounds``: the
    relaxation rounds the rows need, summed) over the f32 rate."""
    tile = B * n * n * 4
    if kind == "critical_path":
        nbytes = tile + B * n * 4
        ops = 2 * rounds * n * n
    else:
        nbytes = tile + B * n * 4 + B * 4 + B * 4
        ops = 2 * rounds * n * n + B * (2 * n + 1)
        if kind == "combined_lb_masked":
            nbytes += tile
            ops += B * n * n
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fleet_bound(tensors, out_bytes: int, B: int, n: int, m: int, M: int,
                rounds: int, masked: bool) -> tuple[float, str]:
    """Least ms of one fused stage-1 launch: racks, instance ids and the
    per-instance tables read once, lb written once; operations are the
    float32 adds and maxes the bound needs: the relaxation rounds the rows
    need and the epilogue as in :func:`bound`, the per-rack loads (one add
    per task and rack, as the reference accumulates them), the work sum and
    the two or three maxes and one division of the contention bound, and
    under a topology one uplift add per edge cell, per edge and per forced
    term."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors) + out_bytes
    ops = 2 * rounds * n * n + B * (2 * n + 1 + n * M + m + 3)
    if masked:
        ops += B * 3 * m
    return _larger(nbytes, ops, F32_OPS_PER_S)


def stage1_inputs(np, torch, instances, rows: int, seed: int):
    """The engine's stage-1 inputs for ``rows`` random candidates of each
    instance (as ``_run_fleet.launch_stage1`` packs them: int32 racks and
    instance ids on the host, padded tasks on rack 0) and the fleet's
    tables on the card."""
    from repro_torch.core.vectorized import _build_lb_arrays, _fleet_dims

    dims = _fleet_dims(instances, use_wireless=True)
    tables = _build_lb_arrays(instances, dims, torch.device("cuda"))
    rng = np.random.default_rng(seed)
    B = len(instances) * rows
    rack = np.zeros((B, dims.n_pad), np.int32)
    iid = np.zeros(B, np.int32)
    for i, inst in enumerate(instances):
        n = inst.job.n_tasks
        rack[i * rows:(i + 1) * rows, :n] = rng.integers(0, inst.n_racks, (rows, n))
        iid[i * rows:(i + 1) * rows] = i
    return rack, iid, tables, dims


def cpm_ptxas(log: str) -> list[dict]:
    """Registers and spills of each function in cpm.cu's ``-Xptxas -v``
    report (mangled names)."""
    out, cur = [], None
    for line in log.splitlines():
        if "Function properties for" in line:
            cur = dict(function=line.split("Function properties for")[1].strip())
        elif cur is not None and "spill stores" in line:
            nums = [int(x) for x in re.findall(r"(\d+) bytes", line)]
            cur.update(stack_bytes=nums[0], spill_store_bytes=nums[1], spill_load_bytes=nums[2])
        elif cur is not None and "Used" in line:
            cur["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
            out.append(cur)
            cur = None
    return out


def device_rows(prof) -> list[tuple[str, float, int]]:
    """(name, device us, count) of each device-side event name (kernels,
    copies, memsets) of a finished torch.profiler run, summed straight from
    its Kineto events: ``key_averages()`` builds a Python object per event
    and takes minutes over the 10^5-10^6 kernels of a step of xlstm's time
    loop."""
    from torch.autograd import DeviceType

    sums: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0:
            us, n = sums.get(e.name(), (0.0, 0))
            sums[e.name()] = (us + e.duration_ns() / 1e3, n + 1)
    return [(name, us, n) for name, (us, n) in sums.items()]


def profile_run(label: str, fn, wall_unprofiled: float) -> dict:
    """Run ``fn`` under torch.profiler and emit device time per kernel
    name (top 8), the total, the number of device kernels, and the busy
    share of ``wall_unprofiled`` (the same work's wall time without the
    profiler); returns what it emitted. Prints "not measured" fields when
    the profiler records no device time on this machine."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t

    rows = device_rows(prof)
    total_us = sum(us for _, us, _ in rows)
    if not rows:
        fields = dict(run=label, device_time="not measured", wall_s=wall)
        emit("profile", **fields)
        return fields
    top = sorted(rows, key=lambda r: r[1], reverse=True)[:8]
    ours = [r for r in rows if any(n in r[0] for n in PORT_KERNELS)]
    fields = dict(run=label, wall_profiled_s=wall,
                  wall_unprofiled_s=wall_unprofiled, device_s=total_us / 1e6,
                  busy_share_of_unprofiled=total_us / 1e6 / wall_unprofiled,
                  device_kernels=sum(n for _, _, n in rows),
                  top=[dict(name=name[:80], device_ms=us / 1e3, count=n) for name, us, n in top],
                  port_kernels=[dict(name=name[:80], device_ms=us / 1e3, count=n)
                                for name, us, n in ours])
    emit("profile", **fields)
    return fields

def _larger(nbytes: float, ops: float, ops_rate: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def flash_bound(torch, q, k, causal: bool) -> tuple[float, str]:
    """q, k, v read once and out written once; 4 * H * D flops per
    (query, key) pair, counting only the lower triangle when causal."""
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    nbytes = q.element_size() * (2 * B * S * H * D + 2 * B * T * KV * D)
    rate = BF16_OPS_PER_S if q.dtype == torch.bfloat16 else F32_OPS_PER_S
    return _larger(nbytes, flash_flops(q, k, causal), rate)


def flash_ptxas(log: str, lib) -> list[dict]:
    """Registers, spills and dynamic shared memory of each bf16 flash
    instantiation (``flash_fwd_bf16<D>``), from nvcc's ``-Xptxas -v``
    report and the library's own size query."""
    out, cur = [], None
    for line in log.splitlines():
        if "Function properties for" in line:
            m = re.search(r"flash_fwd_bf16ILi(\d+)E", line)
            cur = dict(D=int(m.group(1))) if m else None
        elif cur is not None and "spill stores" in line:
            nums = [int(x) for x in re.findall(r"(\d+) bytes", line)]
            cur.update(stack_bytes=nums[0], spill_store_bytes=nums[1], spill_load_bytes=nums[2])
        elif cur is not None and "Used" in line:
            cur["registers_at_entry"] = int(re.search(r"Used (\d+) registers", line).group(1))
            cur["dynamic_smem_bytes"] = lib.flash_attention_smem_bytes(1, cur["D"])
            out.append(cur)
            cur = None
    return sorted(out, key=lambda r: r["D"])


def flash_bwd_ptxas(log: str, lib) -> list[dict]:
    """Registers, spills and dynamic shared memory of each backward
    instantiation (kernel, dtype, D), from nvcc's ``-Xptxas -v`` report
    and the library's own size query. A bf16 body runs setmaxnreg, so its
    count is the one at entry (168; the consumers then take 224, the
    producer 56)."""
    out, cur = [], None
    kinds = {"flash_bwd_dkdv": 1, "flash_bwd_dq": 2}
    for line in log.splitlines():
        if "Function properties for" in line:
            m = re.search(r"(flash_bwd_\w+?)(?:ILi(\d+)E|I(f|13__nv_bfloat16)E)", line)
            cur = None if m is None else dict(
                kernel=m.group(1), D=int(m.group(2) or 0),
                dtype="f32" if m.group(3) == "f" or m.group(1).endswith("_f32") else "bf16")
        elif cur is not None and "spill stores" in line:
            nums = [int(x) for x in re.findall(r"(\d+) bytes", line)]
            cur.update(stack_bytes=nums[0], spill_store_bytes=nums[1], spill_load_bytes=nums[2])
        elif cur is not None and "Used" in line:
            cur["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
            kind = next((v for k, v in kinds.items() if cur["kernel"].startswith(k)), 0)
            cur["dynamic_smem_bytes"] = (
                lib.flash_bwd_smem_bytes(kind, int(cur["dtype"] == "bf16"), cur["D"]) if kind else 0)
            out.append(cur)
            cur = None
    return sorted(out, key=lambda r: (r["kernel"], r["dtype"], r["D"]))


def flash_flops(q, k, causal: bool) -> int:
    """The flash operator's FLOP formula, ``repro_torch.kernels.attention.
    flash_flops``: 4 * H * D flops per (query, key) pair, the causal
    triangle only."""
    from repro_torch.kernels.attention import flash_flops as count

    return count(q, k, causal)


def decode_bound(torch, q, k, lens: list[int]) -> tuple[float, str]:
    """q read and out written once, and only the kv_len valid cache rows
    of K and V (a row of length <= 0 attends to all T rows)."""
    B, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    rows = sum(T if n <= 0 else min(n, T) for n in lens)
    nbytes = q.element_size() * (2 * B * H * D + 2 * rows * KV * D) + 4 * B
    rate = BF16_OPS_PER_S if q.dtype == torch.bfloat16 else F32_OPS_PER_S
    return _larger(nbytes, 4 * H * D * rows, rate)


def decode_ptxas(log: str) -> list[dict]:
    """Registers and spills of each decode instantiation (split kernel by
    dtype and group heads GM, and the combine kernel by dtype), from
    nvcc's ``-Xptxas -v`` report."""
    out, cur = [], None
    for line in log.splitlines():
        if "Function properties for" in line:
            m = re.search(r"(decode_(?:split|combine)_kernel)I(f|13__nv_bfloat16)(?:Li(\d+)E)?", line)
            cur = None if m is None else dict(
                kernel=m.group(1), dtype="bf16" if m.group(2) != "f" else "f32",
                GM=int(m.group(3)) if m.group(3) else None)
        elif cur is not None and "spill stores" in line:
            nums = [int(x) for x in re.findall(r"(\d+) bytes", line)]
            cur.update(stack_bytes=nums[0], spill_store_bytes=nums[1], spill_load_bytes=nums[2])
        elif cur is not None and "Used" in line:
            cur["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
            out.append(cur)
            cur = None
    return sorted(out, key=lambda r: (r["kernel"], r["dtype"], r["GM"] or 0))


def library_ms(torch, fn):
    """ms of one PyTorch call used as a yardstick (never by the port), or
    None with the reason when this build of PyTorch refuses it."""
    try:
        return cuda_ms(torch, fn, reps=10, warmup=2), None
    except RuntimeError as e:
        return None, str(e).splitlines()[0][:200]


def stage2_bound_ms(torch, instances, batch_size: int) -> float:
    """Least ms of one stage-2 launch by bytes: the candidate block
    (int64 [B, n_pad]) and row instance ids (int64 [B]) read once, the op
    tables of ``_build_eval_stack`` read once, the makespans (f32 [B])
    written once."""
    from repro_torch.core.simulator import build_op_tables
    from repro_torch.core.vectorized import _build_eval_stack, _fleet_dims

    tables = [build_op_tables(inst) for inst in instances]
    dims = _fleet_dims(instances, True, tables)
    stack = _build_eval_stack(instances, dims, True, torch.device("cpu"), tables)
    B = len(instances) * batch_size
    nbytes = B * dims.n_pad * 8 + B * 8 + sum(t.nbytes for t in stack) + B * 4
    return nbytes / HBM_BYTES_PER_S * 1e3


def attention_kernels(np, torch) -> dict:
    """5a. Both attention kernels against their plain versions, timed
    beside the plain version, SDPA and the bound. Returns the kernel-table
    rows, measured at the shapes the serving path gives the kernels."""
    import torch.nn.functional as F

    from repro_torch.kernels import attention, ref

    gen = torch.Generator(device="cuda").manual_seed(0)

    def rn(shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    bf16, f32 = torch.bfloat16, torch.float32
    rows, max_err = {}, {"flash_attention": 0.0, "decode_attention": 0.0}

    def record(name, label, errs, kern, plain, lib, b, flops=None, int_kern=None,
               **shape):
        err, rel = errs
        ms = cuda_ms(torch, kern)
        plain_ms = cuda_ms(torch, plain, reps=3, warmup=1)
        lib_ms, lib_err = library_ms(torch, lib)
        max_err[name] = max(max_err[name], err)
        # Share of the bound, and the host time of one wrapper call through
        # the operators and with the CUDA implementation called directly.
        via, direct = operator_host_us(torch, kern)
        extra = dict(share_of_bound=b[0] / ms, host_us_per_call=via,
                     host_us_per_call_direct=direct)
        if flops is not None:  # flash: the rate
            extra.update(tflop_s=flops / ms / 1e9)
        if int_kern is not None:  # decode with an int kv_len, as the serve step calls it
            via, direct = operator_host_us(torch, int_kern)
            extra.update(host_us_per_call_int_kv_len=via,
                         host_us_per_call_int_kv_len_direct=direct)
        if flops is None or shape["dtype"] == "torch.bfloat16":
            # The device times alone (no host between launches), SDPA's too:
            # every decode row, the bf16 flash rows.
            dev = graph_ms(torch, kern)
            extra.update(device_ms=dev, device_share_of_bound=b[0] / dev,
                         library_device_ms=None if lib_ms is None else graph_ms(torch, lib))
            if flops is not None:
                extra.update(device_tflop_s=flops / dev / 1e9)
        emit("attention", kernel=name, shape=label, max_abs_err=err,
             max_row_rel_err=rel, ms=ms,
             plain_ms=plain_ms, library_ms=lib_ms, library_error=lib_err,
             bound_ms=b[0], bound_by=b[1], **extra, **shape)
        if label.startswith("serve"):
            rows[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                              bound_ms=b[0], bound_by=b[1])

    flash = [("serve_prefill", 4, 512, 24, 8, 128, True, bf16)]
    # The other published head widths, causal bf16: phi3-mini (D 96, MHA)
    # and seamless-m4t-medium (D 64, MHA).
    flash += [(f"{arch}_S{S}", 4 if S == 512 else 1, S, H, H, D, True, bf16)
              for arch, H, D in (("phi3-mini", 32, 96), ("seamless", 16, 64))
              for S in (512, 2048)]
    for dt in (bf16, f32):
        flash += [(f"llama_S{S}", 1, S, 24, 8, 128, c, dt)
                  for S in (2048, 1000) for c in (True, False)]
        flash += [("test_kernels", *sh, dt) for sh in (
            (1, 256, 4, 4, 128, True), (2, 128, 8, 2, 64, True),
            (1, 512, 8, 8, 128, False), (1, 128, 4, 1, 128, True),
            (2, 256, 16, 4, 64, True))]
    # Phase 7's shapes: jamba's attention layer, seamless's encoder (and its
    # cross-attention, the same shape), llama-3.2-vision's self and cross
    # layers (T = its 1,600 patches), all bf16 at B = 4.
    flash = [(label, 4, S, H, KV, D, causal, bf16, T) for label, S, H, KV, D, causal, T in (
        ("jamba_prefill", J_PROMPT, 32, 8, 128, True, J_PROMPT),
        ("seamless_encoder_and_cross", F_PROMPT, 16, 16, 64, False, F_PROMPT),
        ("vision_self", V_PROMPT, 32, 8, 128, True, V_PROMPT),
        ("vision_cross", V_PROMPT, 32, 8, 128, False, V_PATCHES))] + [
        row + (row[2],) for row in flash]
    for label, B, S, H, KV, D, causal, dt, T in flash:
        q, k, v = rn((B, S, H, D), dt), rn((B, T, KV, D), dt), rn((B, T, KV, D), dt)
        got = attention.flash_attention(q, k, v, causal)
        want = ref.ref_flash_attention(q, k, v, causal)
        errs = check_attention(torch, "flash_attention", got, want, dt,
                               f"{label} {(B, S, T, H, KV, D, causal, dt)}")
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        record("flash_attention", label, errs,
               lambda: attention.flash_attention(q, k, v, causal),
               lambda: ref.ref_flash_attention(q, k, v, causal),
               lambda: F.scaled_dot_product_attention(
                   qt, kt, vt, is_causal=causal, enable_gqa=True),
               flash_bound(torch, q, k, causal), flash_flops(q, k, causal),
               B=B, S=S, T=T, H=H, KV=KV, D=D, causal=causal, dtype=str(dt))
        del q, k, v, qt, kt, vt, got, want
    torch.cuda.empty_cache()

    serve_len = SERVE_PROMPT + SERVE_GEN
    decode = [("serve_decode", 4, 24, 8, 128, serve_len + 1, [serve_len] * 4, bf16)]
    # Phase 7's shapes: the self-attention caches of jamba (G = 4) and
    # seamless (G = 1) halfway through generation, and the one-token
    # cross-attention steps over seamless's frames and vision's patches.
    decode += [
        ("jamba_decode", 4, 32, 8, 128, J_PROMPT + J_GEN + 1, [J_PROMPT + J_GEN // 2] * 4, bf16),
        ("seamless_decode", 4, 16, 16, 64, F_PROMPT + F_GEN + 1,
         [F_PROMPT + F_GEN // 2] * 4, bf16),
        ("seamless_cross_step", 4, 16, 16, 64, F_PROMPT, [F_PROMPT] * 4, bf16),
        ("vision_cross_step", 4, 32, 8, 128, V_PATCHES, [V_PATCHES] * 4, bf16),
    ]
    for dt in (bf16, f32):
        decode += [
            ("B8_T4096", 8, 24, 8, 128, 4096, [1, 4096, 2048, 100, 4095, 3000, 17, 1234], dt),
            ("B8_T32768", 8, 24, 8, 128, 32768,
             [1, 32768, 16384, 100, 32767, 30000, 17, 20000], dt),
            ("B8_T32768_full", 8, 24, 8, 128, 32768, [32768] * 8, dt),  # phase 5c's
        ]
    decode += [("test_kernels", B, H, KV, D, T, [n] * B, f32) for B, H, KV, D, T, n in (
        (2, 8, 2, 128, 1024, 700), (1, 4, 4, 64, 512, 512),
        (3, 8, 8, 128, 2048, 1), (2, 16, 2, 64, 4096, 3000))]
    for label, B, H, KV, D, T, lens, dt in decode:
        q, k, v = rn((B, H, D), dt), rn((B, T, KV, D), dt), rn((B, T, KV, D), dt)
        kl = torch.tensor(lens, dtype=torch.int32, device="cuda")
        got = attention.decode_attention(q, k, v, kl)
        want = ref.ref_decode_attention(q, k, v, kl)
        errs = check_attention(torch, "decode_attention", got, want, dt,
                               f"{label} {(B, H, KV, D, T, lens, dt)}")
        int_kern = None
        if len(set(lens)) == 1:  # one length: an int kv_len gives the same bits
            n = lens[0]
            check(torch.equal(attention.decode_attention(q, k, v, n), got),
                  f"decode_attention: int kv_len != tensor at {label}")
            int_kern = lambda: attention.decode_attention(q, k, v, n)  # noqa: E731
        q4, kt, vt = q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2)
        mask = (torch.arange(T, device="cuda")[None, :] < kl[:, None])[:, None, None, :]
        record("decode_attention", label, errs,
               lambda: attention.decode_attention(q, k, v, kl),
               lambda: ref.ref_decode_attention(q, k, v, kl),
               lambda: F.scaled_dot_product_attention(
                   q4, kt, vt, attn_mask=mask, enable_gqa=True),
               decode_bound(torch, q, k, lens), int_kern=int_kern,
               B=B, H=H, KV=KV, D=D, T=T, kv_len=lens, dtype=str(dt))
        del q, k, v, q4, kt, vt, got, want, mask
    torch.cuda.empty_cache()
    for name in rows:
        rows[name]["max_abs_err"] = max_err[name]
    return rows


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_tree_to(v, device) for v in tree)
    return tree.to(device)


def serving_phases(np, torch) -> dict:
    """5b full-width serve (the serving main path; returns its attention
    launch counts), its profile, and 5c long-cache decode."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import attention, cpm
    from repro_torch.launch.serve import serve_model
    from repro_torch.models.lm import build_model, count_params
    from repro_torch.runtime.steps import build_prefill_step, build_serve_step

    cfg = get_config(SERVE_ARCH)
    model = build_model(cfg)
    torch.cuda.synchronize()
    t = time.perf_counter()
    params = model.init(0, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    n_params = count_params(params)
    weight_bytes = 2 * n_params
    kv_row_bytes = 2 * cfg.n_layers * cfg.n_kv_heads * cfg.head_dim * 2  # K and V, bf16
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT))).cuda()

    # -- 5b. the serving main path: every count to 0 just before -----------
    for counts in (cpm.launches, attention.launches):
        for k in counts:
            counts[k] = 0
    res = serve_model(model, params, prompts, SERVE_GEN)
    launches = dict(attention.launches)
    check(res.all_finite, "full-width serve: a logit is not finite")
    tol = max(0.05, 0.02 * cfg.n_layers)  # tests/test_models.py:113
    a, b = res.prompt_logits.float(), res.prefill_logits.float()
    err = float((a - b).abs().max())
    check(torch.allclose(a, b, atol=tol, rtol=tol),
          f"prefill != decode at the last prompt position (err {err}, tol {tol})")
    for name in ("flash_attention", "decode_attention"):
        check(launches[name] > 0, f"the serving path never launched {name}")
    # Bounds: decode reads every weight and the valid cache rows once;
    # prefill does 2 flops per weight of the layers per token plus the
    # causal attention, and reads the weights once.
    layer_params = n_params - cfg.vocab_size * cfg.d_model
    mean_len = SERVE_PROMPT + 1 + SERVE_GEN / 2
    step_bound = 1e3 * (weight_bytes + SERVE_BATCH * mean_len * kv_row_bytes) / HBM_BYTES_PER_S
    n_tok = SERVE_BATCH * SERVE_PROMPT
    attn_flops = (4 * cfg.n_layers * cfg.n_heads * cfg.head_dim * SERVE_BATCH
                  * SERVE_PROMPT * (SERVE_PROMPT + 1) / 2)
    prefill_flops = (2 * layer_params * n_tok + attn_flops
                     + 2 * cfg.vocab_size * cfg.d_model * SERVE_BATCH)
    prefill_bound = _larger(weight_bytes, prefill_flops, BF16_OPS_PER_S)
    emit("serve_full_width", arch=cfg.name, params=n_params, weight_bytes=weight_bytes,
         init_s=init_s, batch=SERVE_BATCH, prompt=SERVE_PROMPT, gen=SERVE_GEN,
         prefill_s=res.prefill_s, prefill_tok_s=res.prefill_tok_s,
         prefill_bound_ms=prefill_bound[0], prefill_bound_by=prefill_bound[1],
         prompt_decode_s=res.prompt_s, prompt_decode_tok_s=res.prompt_tok_s,
         time_to_first_token_s=res.first_token_s,
         decode_tok_s=res.decode_tok_s, ms_per_decode_step=res.ms_per_step,
         decode_step_bound_ms=step_bound, peak_gib=res.peak_bytes / 2**30,
         prefill_vs_decode_max_abs_err=err, tol=tol, launches=launches,
         first_tokens=res.tokens[0, :8].tolist())
    del res

    # Where the device time goes: one prefill and 8 decode steps.
    prefill = build_prefill_step(model)
    step = build_serve_step(model)

    def run_prefill():
        return prefill(params, {"tokens": prompts})

    def run_decode():
        cache = model.init_cache(SERVE_BATCH, 9, device="cuda")
        for i in range(8):
            _, cache = step(params, cache, prompts[:, i])

    for label, fn in (("serve_prefill", run_prefill), ("serve_decode_8_steps", run_decode)):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        profile_run(label, fn, time.perf_counter() - t)

    # -- 5c. long-cache decode ----------------------------------------------
    cache = model.init_cache(LONG_BATCH, LONG_CACHE + LONG_STEPS + 1, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for layer in cache["layers"]:
        for key in ("k", "v"):
            for r in range(layer[key].shape[0]):
                rows = layer[key][r, :, :LONG_CACHE]
                rows.copy_(torch.randn(rows.shape, generator=gen, device="cuda"))
    cache["pos"] = LONG_CACHE
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, LONG_BATCH)).cuda()
    before = dict(attention.launches)
    logits, cache = step(params, cache, tok)  # first step at this shape
    finite = torch.isfinite(logits).all()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(LONG_STEPS):
        logits, cache = step(params, cache, logits[:, 0].argmax(dim=-1))
        finite &= torch.isfinite(logits).all()
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t) / LONG_STEPS
    check(bool(finite), "long-cache decode: a logit is not finite")
    mean_len = LONG_CACHE + 1 + (LONG_STEPS + 1) / 2  # kv_len of the timed steps
    cache_bytes = LONG_BATCH * mean_len * kv_row_bytes
    emit("long_cache_decode", batch=LONG_BATCH, cache_len=LONG_CACHE, steps=LONG_STEPS,
         ms_per_step=ms, bound_ms=1e3 * (weight_bytes + cache_bytes) / HBM_BYTES_PER_S,
         weight_bytes=weight_bytes, cache_bytes=cache_bytes,
         decode_tok_s=LONG_BATCH / ms * 1e3,
         decode_launches=attention.launches["decode_attention"] - before["decode_attention"])
    del cache, params, logits
    torch.cuda.empty_cache()
    return launches


def kl_rows(torch, p_logits, q_logits):
    """KL(p || q) over the vocabulary, one value a row, in float32."""
    p = torch.log_softmax(p_logits.float(), dim=-1)
    q = torch.log_softmax(q_logits.float(), dim=-1)
    return (p.exp() * (p - q)).sum(dim=-1)


def agree(torch, got, want, tol, what) -> dict:
    """The reference tests' bars between two logits tensors: allclose at
    ``tol``, or with ``tol=None`` KL(want || got) per row, max < 0.1 and
    mean < 0.02 (tests/test_models.py:103-111, for MoE configs: top-k
    routing is discontinuous, so a near-tie may route differently after a
    rounding). Returns the measured values."""
    got, want = got.float().cpu(), want.float().cpu()
    err = float((got - want).abs().max())
    if tol is None:
        kl = kl_rows(torch, want, got)
        kmax, kmean = float(kl.max()), float(kl.mean())
        check(kmax < 0.1 and kmean < 0.02,
              f"{what}: KL max {kmax} (limit 0.1), mean {kmean} (limit 0.02)")
        return dict(max_abs_err=err, kl_max=kmax, kl_mean=kmean, kl_limits=[0.1, 0.02])
    check(torch.allclose(got, want, atol=tol, rtol=tol), f"{what}: max abs err {err}, tol {tol}")
    return dict(max_abs_err=err, tol=tol)


def smoke_memory(np, torch, cfg, rng, B: int, S: int):
    """Raw frames [B, S, d] of an encoder-decoder config or patches
    [B, 16, d] of a cross-attention one (tests/test_models.py:26-31);
    None for the others."""
    if not (cfg.n_enc_layers or cfg.cross_attn_every):
        return None
    T = S if cfg.n_enc_layers else 16
    return torch.from_numpy(rng.standard_normal((B, T, cfg.d_model)).astype(np.float32))


def attention_calls(cfg) -> tuple[int, int, int]:
    """Attention kernel calls of one prefill (flash: the encoder's layers,
    one per self or cross attention, two per attn_cross layer), of one
    decode step (decode: the same layers of the decoder) and of one
    encode (flash)."""
    from repro_torch.models.config import layer_kinds

    per = {"attn": 1, "cross": 1, "attn_cross": 2}
    n = sum(per.get(mixer, 0) for mixer, _ in layer_kinds(cfg))
    return n + cfg.n_enc_layers, n, cfg.n_enc_layers


def card_equals_cpu(np, torch) -> None:
    """5d. The port on the card (kernels) against the port on the CPU (plain
    versions), same weights: prefill and 8 decode steps of the smoke
    configs of every family."""
    from repro_torch.configs import smoke_config
    from repro_torch.kernels import attention
    from repro_torch.models.lm import build_model
    from repro_torch.runtime.steps import build_prefill_step, build_serve_step

    for arch in ("llama3.2-3b", "qwen1.5-4b", X_ARCH, J_ARCH, "dbrx-132b",
                 "phi3.5-moe-42b-a6.6b", F_ARCH, V_ARCH):
        cfg = smoke_config(arch)
        model = build_model(cfg)
        cpu = model.init(0, device="cpu", dtype=torch.bfloat16)
        gpu = _tree_to(cpu, "cuda")
        rng = np.random.default_rng(1)
        prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 8)))
        mem = smoke_memory(np, torch, cfg, rng, 2, 8)
        mem_g = None if mem is None else mem.cuda()
        prefill, step = build_prefill_step(model), build_serve_step(model)
        tol = None if cfg.n_experts else max(0.05, 0.02 * cfg.n_layers)
        before = dict(attention.launches)
        pg = prefill(gpu, {"tokens": prompts.cuda(), "memory": mem_g})
        pc = prefill(cpu, {"tokens": prompts, "memory": mem})
        errs = [agree(torch, pg, pc, tol, f"{arch}: card != CPU in prefill")]
        with torch.no_grad():
            enc_c = model.encode(cpu, mem) if model.encode else mem
            enc_g = model.encode(gpu, mem_g) if model.encode else mem_g
        cg = model.init_cache(2, 9, device="cuda", memory=enc_g)
        cc = model.init_cache(2, 9, device="cpu", memory=enc_c)
        for i in range(8):
            lg, cg = step(gpu, cg, prompts[:, i].cuda())
            lc, cc = step(cpu, cc, prompts[:, i])
            errs.append(agree(torch, lg, lc, tol, f"{arch}: card != CPU at decode step {i}"))
        launched = {k: attention.launches[k] - before[k] for k in before}
        has_attention = attention_calls(cfg)[0] > 0
        check(all((launched[k] > 0) == has_attention
                  for k in ("flash_attention", "decode_attention"))
              and all(launched[k] == 0 for k in ("flash_attention_lse",) + BWD_KERNELS),
              f"{arch}: card side launched {launched}")
        worst = max(errs[1:], key=lambda e: e.get("kl_max", e["max_abs_err"]))
        emit("card_equals_cpu_model", arch=arch, prefill=errs[0], decode_worst=worst,
             kernel_launches=launched)


def family_bounds(torch, model, params, B: int, P: int, gen: int, T: int) -> dict:
    """Least times of phase 7's serve. Prefill: the weights read once, and
    the products the step computes on the tensor cores (2 flops a weight
    a token in the decoder, for the experts a weight a row of the [E, C, d]
    buffer, the K/V projections of cross layers over the T memory rows,
    the encoder over its T rows, the causal (self) or full (cross,
    encoder) attention, and the last position's unembedding); the SSD
    and mLSTM chunk products and the elementwise work are left out. A
    decode step: every weight but the encoder's and the input embedding's
    rows (all experts: the batched product runs every expert's buffer),
    the valid K/V rows (mean length over the generated steps), the memory
    once, and every recurrent state read and written once."""
    from repro_torch.models.config import layer_kinds
    from repro_torch.models.moe import capacity

    cfg = model.cfg
    d, V, H, KV, D = cfg.d_model, cfg.vocab_size, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    kinds = layer_kinds(cfg)
    n_params = sum(t.numel() for t in _leaves(params))
    enc = sum(t.numel() for t in _leaves(params.get("enc", {})))
    tables = V * d * (1 if cfg.tie_embeddings else 2)
    expert = 3 * d * cfg.d_ff * cfg.n_experts
    n_moe = sum(f == "moe" for _, f in kinds)
    layer = n_params - enc - tables - n_moe * expert
    n_self = sum(m in ("attn", "attn_cross") for m, _ in kinds)
    n_cross = sum(m in ("cross", "attn_cross") for m, _ in kinds)
    tok = B * P
    flops = 2 * layer * tok + 2 * V * d * B
    if n_moe:
        C = capacity(tok, cfg.experts_per_token, cfg.n_experts, cfg.capacity_factor)
        flops += n_moe * 2 * expert * C
    flops += n_self * 4 * H * D * B * P * (P + 1) / 2
    flops += n_cross * (4 * H * D * B * P * T + 2 * 2 * d * KV * D * B * (T - P))
    if cfg.n_enc_layers:
        flops += 2 * enc * B * T + cfg.n_enc_layers * 4 * H * D * B * T * T
    wbytes = 2 * n_params
    prefill = _larger(wbytes, flops, BF16_OPS_PER_S)
    mean_len = P + 1 + gen / 2
    cache = model.init_cache(B, 1, device="cuda")
    state_bytes = sum(  # the recurrent states: every cache leaf but K/V's
        t.numel() * t.element_size()
        for (mixer, _), mc in zip(layer_kinds(cfg), cache["layers"])
        if mixer in ("mamba", "slstm", "mlstm") for t in _leaves(mc))
    del cache
    step_bytes = (2 * (n_params - enc - (0 if cfg.tie_embeddings else V * d))
                  + n_self * 2 * B * mean_len * KV * D * 2
                  + (B * T * d * 2 if n_cross else 0) + 2 * state_bytes)
    return dict(params=n_params, weight_bytes=wbytes, prefill_bound_ms=prefill[0],
                prefill_bound_by=prefill[1], prefill_flops=flops,
                decode_step_bound_ms=step_bytes / HBM_BYTES_PER_S * 1e3,
                decode_step_bytes=step_bytes, state_bytes=state_bytes)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def layer_times(np, torch, model, params, P: int) -> None:
    """Host wall (ending in a sync) of one layer of each kind of the period,
    at the prefill shape [B, P, d] and at one decode step (position P of a
    zero cache), and the sum over the model's layers: where an eager step
    spends its time by layer kind (the SSD chunk loop, the sLSTM time loop,
    the MoE dispatch)."""
    from repro_torch.models import lm
    from repro_torch.models.config import layer_kinds, layer_period
    from repro_torch.models.layers import rope_tables

    cfg = model.cfg
    period = layer_period(cfg)
    repeats = cfg.n_layers // period
    B = FAMILY_BATCH
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn((B, P, cfg.d_model), generator=gen, device="cuda").to(torch.bfloat16)
    cos, sin = rope_tables(torch.arange(P, device="cuda"), cfg.head_dim, cfg.rope_theta)
    cos, sin = cos[None], sin[None]
    cache = model.init_cache(B, P + 2, device="cuda")

    def wall_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / reps * 1e3

    rows = []
    with torch.no_grad():
        for j, (mixer, ffn) in enumerate(layer_kinds(cfg)[:period]):
            lp = lm._take(params["layers"][j], 0)
            mc = cache["layers"][j]
            rows.append(dict(
                position=j, mixer=mixer, ffn=ffn, layers=repeats,
                prefill_mixer_ms=wall_ms(lambda: lm._apply_mixer(
                    lp["mixer"], cfg, mixer, x, cos, sin, None), 3),
                prefill_ffn_ms=wall_ms(lambda: lm._apply_ffn(lp["ffn"], cfg, ffn, x), 3),
                decode_mixer_ms=wall_ms(lambda: lm._decode_mixer(
                    lp["mixer"], cfg, mixer, x[:, :1], P, mc, 0, None), 10),
                decode_ffn_ms=wall_ms(lambda: lm._apply_ffn(lp["ffn"], cfg, ffn, x[:, :1]), 10),
            ))
    by_kind: dict = {}
    for r in rows:
        for part, kind in (("mixer", r["mixer"]), ("ffn", r["ffn"])):
            k = by_kind.setdefault(kind, dict(prefill_ms=0.0, decode_ms=0.0, layers=0))
            k["prefill_ms"] += r["layers"] * r[f"prefill_{part}_ms"]
            k["decode_ms"] += r["layers"] * r[f"decode_{part}_ms"]
            k["layers"] += r["layers"]
    emit("layer_times", arch=cfg.name, batch=B, prompt=P, rows=rows, by_kind=by_kind,
         prefill_layers_ms=sum(k["prefill_ms"] for k in by_kind.values()),
         decode_layers_ms=sum(k["decode_ms"] for k in by_kind.values()))
    del cache, x


def family_phases(np, torch) -> dict:
    """7. The expert, recurrent and cross-attention families served at
    their published widths through ``serve_model`` (4 requests each, seed-0
    bf16 weights, one model on the card at a time): jamba-v0.1-52b cut to
    one period (two arms: the config's capacity factor, timed, and no
    drops, gated), xlstm-350m, seamless-m4t-medium over frames and
    llama-3.2-vision-11b over 1,600 patches. Every count set to 0 just
    before each serve and read just after; returns the counts by arch."""
    import dataclasses as dc

    from repro_torch.configs import get_config
    from repro_torch.kernels import attention
    from repro_torch.launch.serve import serve_model
    from repro_torch.models.lm import build_model
    from repro_torch.runtime.steps import build_prefill_step, build_serve_step

    t_phase = time.perf_counter()
    counts = {}

    def serve_cell(label, cfg, model, params, prompts, gen, memory):
        for k in attention.launches:
            attention.launches[k] = 0
        res = serve_model(model, params, prompts, gen, memory=memory)
        launches = dict(attention.launches)
        check(res.all_finite, f"{label}: a logit is not finite")
        P = prompts.shape[1]
        pf, dec, enc = attention_calls(cfg)
        want = {k: 0 for k in launches}  # serving launches no training kernel
        want.update(flash_attention=2 * pf + (enc if memory is not None else 0),
                    decode_attention=dec * (P + gen - 1))
        check(launches == want, f"{label}: attention launches {launches}, expected {want}")
        return res, launches

    def load(cfg):
        model = build_model(cfg)
        torch.cuda.synchronize()
        t = time.perf_counter()
        params = model.init(0, device="cuda", dtype=torch.bfloat16)
        torch.cuda.synchronize()
        return model, params, time.perf_counter() - t

    def report(label, model, params, res, launches, init_s, T, **extra):
        cfg = model.cfg
        b = family_bounds(torch, model, params, FAMILY_BATCH, res.prompt_len, res.gen, T)
        emit("family_serve", arch=label, layers=cfg.n_layers, enc_layers=cfg.n_enc_layers,
             init_s=init_s, batch=res.batch, prompt=res.prompt_len, gen=res.gen,
             memory_rows=T, prefill_s=res.prefill_s, prefill_tok_s=res.prefill_tok_s,
             prompt_decode_s=res.prompt_s, time_to_first_token_s=res.first_token_s,
             decode_tok_s=res.decode_tok_s, ms_per_decode_step=res.ms_per_step,
             peak_gib=res.peak_bytes / 2**30, launches=launches,
             first_tokens=res.tokens[0, :8].tolist(), **b, **extra)

    def prefill_vs_decode(cfg, res, label, by_kl=False):
        tol = None if by_kl else max(0.05, 0.02 * cfg.n_layers)  # tests/test_models.py:113
        return agree(torch, res.prompt_logits, res.prefill_logits, tol,
                     f"{label}: prefill != decode at the last prompt position")

    rng_of = lambda: np.random.default_rng(0)  # noqa: E731

    # -- 7a. jamba at its published widths, one period deep ------------------
    cfg = dc.replace(get_config(J_ARCH), n_layers=J_LAYERS)
    model, params, init_s = load(cfg)
    rng = rng_of()
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, (FAMILY_BATCH, J_PROMPT))).cuda()
    res, launches = serve_cell("jamba", cfg, model, params, prompts, J_GEN, None)
    kl = kl_rows(torch, res.prefill_logits, res.prompt_logits)
    report(f"{cfg.name}[{J_LAYERS} layers]", model, params, res, launches, init_s, 0,
           capacity_factor=cfg.capacity_factor,
           prefill_vs_decode_kl=dict(max=float(kl.max()), mean=float(kl.mean()),
                                     gated=False))
    counts[J_ARCH] = launches
    del res
    layer_times(np, torch, model, params, J_PROMPT)
    prefill, step = build_prefill_step(model), build_serve_step(model)

    def run_prefill():
        return prefill(params, {"tokens": prompts})

    def run_decode():
        cache = model.init_cache(FAMILY_BATCH, 5, device="cuda")
        for i in range(4):
            _, cache = step(params, cache, prompts[:, i])

    for label, fn in (("jamba_prefill", run_prefill), ("jamba_decode_4_steps", run_decode)):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        profile_run(label, fn, time.perf_counter() - t)
    # (ii) no drops: capacity >= T at every call, same weights; gated.
    cfg2 = dc.replace(cfg, capacity_factor=cfg.n_experts / cfg.experts_per_token)
    model2 = build_model(cfg2)
    res, launches = serve_cell("jamba no-drop", cfg2, model2, params, prompts, 1, None)
    gate = prefill_vs_decode(cfg2, res, "jamba no-drop", by_kl=True)
    emit("family_no_drop", arch=cfg.name, layers=J_LAYERS, capacity_factor=cfg2.capacity_factor,
         prefill_s=res.prefill_s, prompt_decode_s=res.prompt_s, launches=launches, **gate)
    del model, model2, params, res, prefill, step
    torch.cuda.empty_cache()

    # -- 7b. xlstm-350m, whole ------------------------------------------------
    cfg = get_config(X_ARCH)
    model, params, init_s = load(cfg)
    prompts = torch.from_numpy(
        rng_of().integers(0, cfg.vocab_size, (FAMILY_BATCH, X_PROMPT))).cuda()
    res, launches = serve_cell("xlstm", cfg, model, params, prompts, X_GEN, None)
    # At its full widths the bf16 gap between the parallel (prefill) and
    # recurrent (decode) forms exceeds max(0.05, 0.02 * 24) in the JAX
    # package itself (1.25 within 48 tokens on the CPU, PERF.md §6), so the
    # bf16 serve is held to the KL bars, and the same weights in float32
    # compute (prompt decode only) to the reference's tolerance.
    gate = prefill_vs_decode(cfg, res, "xlstm", by_kl=True)
    res32, _ = serve_cell("xlstm f32 compute", cfg, build_model(cfg, torch.float32),
                          params, prompts, 1, None)
    report(cfg.name, model, params, res, launches, init_s, 0,
           prefill_vs_decode=gate,
           prefill_vs_decode_f32_compute=prefill_vs_decode(cfg, res32, "xlstm f32 compute"),
           f32_compute_prompt_decode_s=res32.prompt_s)
    counts[X_ARCH] = launches
    del res, res32
    layer_times(np, torch, model, params, X_PROMPT)
    del model, params
    torch.cuda.empty_cache()

    # -- 7c / 7d. seamless over frames, vision over patches ------------------
    for arch, P, gen, T in ((F_ARCH, F_PROMPT, F_GEN, F_PROMPT),
                            (V_ARCH, V_PROMPT, V_GEN, V_PATCHES)):
        cfg = get_config(arch)
        model, params, init_s = load(cfg)
        rng = rng_of()  # memory first, then the prompts (launch/serve.py:40-52)
        memory = torch.from_numpy(
            rng.standard_normal((FAMILY_BATCH, T, cfg.d_model)).astype(np.float32)).cuda()
        prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, (FAMILY_BATCH, P))).cuda()
        res, launches = serve_cell(arch, cfg, model, params, prompts, gen, memory)
        report(cfg.name, model, params, res, launches, init_s, T,
               prefill_vs_decode=prefill_vs_decode(cfg, res, arch))
        counts[arch] = launches
        del model, params, res, memory
        torch.cuda.empty_cache()
    emit("family_phase", seconds=time.perf_counter() - t_phase, launches=counts)
    return counts


def check_grad(torch, name, got, want, dtype, what) -> tuple[float, float]:
    """The attention bars on a gradient (or any [..., D] result): allclose
    at ATTN_TOL, and each row within ATTN_ROW_TOL of its norm floored at the
    tensor's mean row norm, since a row can be zero in exact arithmetic
    (causal query 0: p = 1 and dp = delta, so its dq is rounding noise);
    a tensor whose mean row norm is under the elementwise bar is all noise
    and held by that bar alone. Returns (max abs error, max row error)."""
    tol, row_tol = ATTN_TOL[str(dtype)], ATTN_ROW_TOL[str(dtype)]
    g, w = got.float(), want.float()
    err = float((g - w).abs().max())
    check(torch.allclose(g, w, atol=tol, rtol=tol),
          f"{name} != plain at {what}: max abs err {err}")
    norm = w.norm(dim=-1)
    mean = float(norm.mean())
    rel = 0.0
    if mean >= tol:
        rel = float(((g - w).norm(dim=-1) / norm.clamp_min(mean)).max())
        check(rel <= row_tol, f"{name} != plain at {what}: row-relative err {rel} > {row_tol}")
    return err, rel


def backward_flops(q, k, causal: bool) -> dict:
    """The flash operators' FLOP formulas, ``repro_torch.kernels.attention.
    backward_flops``: the forward with lse, each backward kernel and the
    backward pass."""
    from repro_torch.kernels.attention import backward_flops as count

    return count(q, k, causal)


def backward_bounds(torch, q, k, causal: bool) -> dict:
    """Least ms of the forward with lse, of each backward kernel and of the
    backward pass: each input read once and each output written once, the
    operations of :func:`backward_flops` on the tensor cores in bf16, the
    CUDA cores in float32 (delta always on the CUDA cores)."""
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    esz = q.element_size()
    rate = BF16_OPS_PER_S if q.dtype == torch.bfloat16 else F32_OPS_PER_S
    ops = backward_flops(q, k, causal)
    rows = B * S * H
    qo = esz * B * S * H * D   # one of q, o, do, dq
    kv = esz * B * T * KV * D  # one of k, v, dk, dv
    return {
        "flash_attention_lse": _larger(2 * qo + 2 * kv + 4 * rows, ops["flash_attention_lse"], rate),
        "flash_bwd_delta": _larger(2 * qo + 4 * rows, ops["flash_bwd_delta"], F32_OPS_PER_S),
        "flash_bwd_dkdv": _larger(2 * qo + 4 * kv + 8 * rows, ops["flash_bwd_dkdv"], rate),
        "flash_bwd_dq": _larger(3 * qo + 2 * kv + 8 * rows, ops["flash_bwd_dq"], rate),
        "backward_pass": _larger(4 * qo + 4 * kv + 4 * rows, ops["backward_pass"], rate),
    }


def training_kernels(np, torch) -> dict:
    """8a. The flash forward with lse and the three backward kernels against
    their plain versions (on the same inputs: the kernel's lse and delta
    feed both) at the training shapes, timed by CUDA events and alone in a
    CUDA graph beside the plain versions, PyTorch's SDPA forward and
    backward (the yardstick; the port never calls it) and the bounds.
    Returns the kernel-table rows of the main shape (llama3.2-3b, bf16)."""
    import torch.nn.functional as F

    from repro_torch.kernels import attention, ref

    gen = torch.Generator(device="cuda").manual_seed(8)
    bf16, f32 = torch.bfloat16, torch.float32
    names = ("flash_attention_lse",) + BWD_KERNELS
    rows, max_err = {}, {n: 0.0 for n in names}
    shapes = [  # label, B, S, T, H, KV, D, causal, dtype
        ("train", 4, TRAIN_SEQ, TRAIN_SEQ, 24, 8, 128, True, bf16),
        ("train", 4, TRAIN_SEQ, TRAIN_SEQ, 24, 8, 128, True, f32),
        ("phi3_D96", 4, TRAIN_SEQ, TRAIN_SEQ, 32, 32, 96, True, bf16),
        ("encoder_D64", 4, TRAIN_SEQ, TRAIN_SEQ, 16, 16, 64, False, bf16),
        ("ragged_S1000", 4, 1000, 1000, 24, 8, 128, True, bf16),
        # Cross-attention as llama-3.2-vision trains it: 512 tokens over
        # 1,600 patches (12.5 of dk/dv's 128-key units), G = 4, not causal.
        ("cross_T1600", 4, 512, 1600, 32, 8, 128, False, bf16),
        ("cross_T1600", 4, 512, 1600, 32, 8, 128, False, f32),
        # The calls of 8e's arms, at its micro-batch of B 2: seamless's
        # encoder and cross layers (256 rows over 256 frames, 16 heads of
        # 64, not causal) and its decoder (causal); vision's self-attention
        # (32 / 8 heads of 128, causal) and its cross layer.
        ("8e_seamless_enc", 2, 256, 256, 16, 16, 64, False, bf16),
        ("8e_seamless_dec", 2, 256, 256, 16, 16, 64, True, bf16),
        ("8e_vision_self", 2, 512, 512, 32, 8, 128, True, bf16),
        ("8e_vision_cross", 2, 512, 1600, 32, 8, 128, False, bf16),
    ]
    for label, B, S, T, H, KV, D, causal, dt in shapes:
        def rn(*shape):
            return torch.randn(shape, generator=gen, device="cuda").to(dt)

        q, k, v, do = rn(B, S, H, D), rn(B, T, KV, D), rn(B, T, KV, D), rn(B, S, H, D)
        what = f"{label} {(B, S, T, H, KV, D, causal, dt)}"
        o, lse = attention.flash_attention(q, k, v, causal, return_lse=True)
        o_ref, lse_ref = ref.ref_flash_attention(q, k, v, causal, return_lse=True)
        check(torch.equal(o, attention.flash_attention(q, k, v, causal)),
              f"the lse route changes the output at {what}")
        e_o = check_attention(torch, "flash_attention_lse", o, o_ref, dt, what)
        e_l = check_attention(torch, "flash_attention_lse (lse)", lse[..., None],
                              lse_ref[..., None], dt, what)
        delta = attention.flash_bwd_delta(o, do)
        e_d = check_grad(torch, "flash_bwd_delta", delta[..., None],
                         ref.ref_flash_bwd_delta(o, do)[..., None], dt, what)
        dk, dv = attention.flash_bwd_dkdv(q, k, v, do, lse, delta, causal)
        dk_r, dv_r = ref.ref_flash_bwd_dkdv(q, k, v, do, lse, delta, causal)
        e_k = check_grad(torch, "flash_bwd_dkdv (dk)", dk, dk_r, dt, what)
        e_v = check_grad(torch, "flash_bwd_dkdv (dv)", dv, dv_r, dt, what)
        dq = attention.flash_bwd_dq(q, k, v, do, lse, delta, causal)
        e_q = check_grad(torch, "flash_bwd_dq", dq,
                         ref.ref_flash_bwd_dq(q, k, v, do, lse, delta, causal), dt, what)
        errs = {"flash_attention_lse": (max(e_o[0], e_l[0]), max(e_o[1], e_l[1])),
                "flash_bwd_delta": e_d,
                "flash_bwd_dkdv": (max(e_k[0], e_v[0]), max(e_k[1], e_v[1])),
                "flash_bwd_dq": e_q}
        if label == "train" and dt == bf16:
            # No atomics: a second call gives the same bits.
            dk2, dv2 = attention.flash_bwd_dkdv(q, k, v, do, lse, delta, causal)
            check(torch.equal(dk, dk2) and torch.equal(dv, dv2),
                  f"flash_bwd_dkdv differs between two calls at {what}")
            check(torch.equal(dq, attention.flash_bwd_dq(q, k, v, do, lse, delta, causal)),
                  f"flash_bwd_dq differs between two calls at {what}")
            emit("train_kernel_determinism", shape=label, dkdv_equal=True, dq_equal=True)
            del dk2, dv2
        del o_ref, lse_ref, dk, dv, dk_r, dv_r, dq
        calls = {
            "flash_attention_lse": (
                lambda: attention.flash_attention(q, k, v, causal, return_lse=True),
                lambda: ref.ref_flash_attention(q, k, v, causal, return_lse=True)),
            "flash_bwd_delta": (lambda: attention.flash_bwd_delta(o, do),
                                lambda: ref.ref_flash_bwd_delta(o, do)),
            "flash_bwd_dkdv": (
                lambda: attention.flash_bwd_dkdv(q, k, v, do, lse, delta, causal),
                lambda: ref.ref_flash_bwd_dkdv(q, k, v, do, lse, delta, causal)),
            "flash_bwd_dq": (
                lambda: attention.flash_bwd_dq(q, k, v, do, lse, delta, causal),
                lambda: ref.ref_flash_bwd_dq(q, k, v, do, lse, delta, causal)),
        }
        # The yardstick: SDPA's forward (keeping what its backward needs) and
        # its backward (delta, dq, dk, dv in one call). The forward that the
        # backward differentiates runs on a side stream: autograd runs each
        # backward node on its forward's stream, and the legacy default
        # stream cannot join graph_ms's capture. A refused capture fails the
        # run: it leaves the process on the capture stream with the
        # allocator still capturing, so that no later empty_cache frees
        # anything.
        qs, ks, vs = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
        dos = do.transpose(1, 2)

        def sdpa_fwd():
            return F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal, enable_gqa=True)

        lib_fwd, lib_err = library_ms(torch, sdpa_fwd)
        lib_fwd_dev = lib_bwd = lib_bwd_dev = None
        if lib_fwd is not None:
            lib_fwd_dev = graph_ms(torch, sdpa_fwd)
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                out_s = sdpa_fwd()
            torch.cuda.current_stream().wait_stream(side)

            def sdpa_bwd():
                return torch.autograd.grad(out_s, (qs, ks, vs), dos, retain_graph=True)

            lib_bwd, lib_err = library_ms(torch, sdpa_bwd)
            lib_bwd_dev = None if lib_bwd is None else graph_ms(torch, sdpa_bwd)
        library = {"flash_attention_lse": (lib_fwd, lib_fwd_dev), "flash_bwd_delta": (None, None),
                   "flash_bwd_dkdv": (lib_bwd, lib_bwd_dev), "flash_bwd_dq": (lib_bwd, lib_bwd_dev)}
        bounds = backward_bounds(torch, q, k, causal)
        flops = backward_flops(q, k, causal)
        device_sum = 0.0
        for name, (kern, plain) in calls.items():
            ms = cuda_ms(torch, kern)
            dev = graph_ms(torch, kern)
            device_sum += dev
            plain_ms = cuda_ms(torch, plain, reps=3, warmup=1)
            b_ms, b_by = bounds[name]
            max_err[name] = max(max_err[name], errs[name][0])
            emit("train_kernel", kernel=name, shape=label, B=B, S=S, T=T, H=H, KV=KV, D=D,
                 causal=causal, dtype=str(dt), max_abs_err=errs[name][0],
                 max_row_rel_err=errs[name][1], ms=ms, device_ms=dev, plain_ms=plain_ms,
                 library_ms=library[name][0], library_device_ms=library[name][1],
                 library_error=lib_err, bound_ms=b_ms, bound_by=b_by,
                 share_of_bound=b_ms / ms, device_share_of_bound=b_ms / dev,
                 device_tflops=flops[name] / dev / 1e9,
                 host_us_per_call=host_us(torch, kern, reps=20))
            if label == "train" and dt == bf16:
                rows[name] = dict(ms=ms, device_ms=dev, plain_ms=plain_ms, library_ms=library[name][0],
                                  bound_ms=b_ms, bound_by=b_by)
        emit("train_attention_pass", shape=label, dtype=str(dt),
             forward_and_backward_device_ms=device_sum,
             sdpa_forward_and_backward_device_ms=(
                 None if lib_fwd_dev is None or lib_bwd_dev is None else lib_fwd_dev + lib_bwd_dev),
             backward_device_ms=device_sum - graph_ms(torch, calls["flash_attention_lse"][0]),
             backward_bound_ms=bounds["backward_pass"][0], backward_bound_by=bounds["backward_pass"][1])
        del q, k, v, do, o, lse, delta, qs, ks, vs, dos, calls
        torch.cuda.empty_cache()
    # The lse route beside the serving forward at the serving prefill shape
    # (llama3.2-3b: B 4, S = T 512, causal): device ms of each, one call.
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(bf16)
               for shape in ((4, 512, 24, 128), (4, 512, 8, 128), (4, 512, 8, 128)))
    emit("lse_vs_serving_forward", B=4, S=512, T=512, H=24, KV=8, D=128,
         serving_device_ms=graph_ms(torch, lambda: attention.flash_attention(q, k, v, True)),
         lse_device_ms=graph_ms(
             torch, lambda: attention.flash_attention(q, k, v, True, return_lse=True)))
    del q, k, v
    for name in rows:
        rows[name]["max_abs_err"] = max_err[name]
    return rows


@contextlib.contextmanager
def plain_attention(ops, ref):
    """Within the block, the model's flash attention runs the plain PyTorch
    versions on the card (``ops`` patched, restored on exit): 8c's arm."""
    saved = ops.flash_attention, ops.flash_attention_bwd

    def fwd(q, k, v, causal=True, block_q=128, block_kv=128, return_lse=False):
        return ref.ref_flash_attention(q, k, v, causal, return_lse=return_lse)

    ops.flash_attention, ops.flash_attention_bwd = fwd, ref.ref_flash_attention_bwd
    try:
        yield
    finally:
        ops.flash_attention, ops.flash_attention_bwd = saved


def train_bound(torch, cfg, n_params: int, n_active: int, B: int, S: int, T: int) -> dict:
    """Least ms of one train step (8b, 8e): 6 * active parameters * tokens
    at the bf16 rate, each attention call's forward and backward products
    (2 + 5 per (query, key) pair; T memory rows for cross and encoder
    calls) at the bf16 rate, and AdamW's 28 bytes a parameter (read p, g,
    m, v; write p, m, v in float32) at the HBM rate. The SSD's and the
    xLSTM's own products (chunk and time mixing) are not counted."""
    from repro_torch.models.config import layer_kinds

    q = torch.empty((B, S, cfg.n_heads, cfg.head_dim), device="meta")
    kv = lambda n: torch.empty((B, n, cfg.n_kv_heads, cfg.head_dim), device="meta")  # noqa: E731
    attn = 0
    for mixer, _ in layer_kinds(cfg):
        if mixer in ("attn", "attn_cross"):
            attn += flash_flops(q, kv(S), True)
        if mixer in ("cross", "attn_cross"):
            attn += flash_flops(q, kv(T), False)
    if cfg.n_enc_layers:
        qe = torch.empty((B, T, cfg.n_heads, cfg.head_dim), device="meta")
        attn += cfg.n_enc_layers * flash_flops(qe, kv(T), False)
    dense = 6 * n_active * B * S
    parts = dict(dense=1e3 * dense / BF16_OPS_PER_S, attention=1e3 * 3.5 * attn / BF16_OPS_PER_S,
                 adamw=1e3 * 28 * n_params / HBM_BYTES_PER_S)
    return dict(step_bound_ms=sum(parts.values()), step_bound_parts_ms=parts,
                dense_flops=dense)


def kernels_vs_plain(np, torch, cfg, batch: int, seq: int, opt_cfg, what: str) -> dict:
    """The train step with the kernels against the same step with the plain
    versions on the card (8c, and 8e's vision arm): TRAIN_CUT_STEPS steps
    from seed 0 on the port's pipeline, each arm from the same weights;
    the loss and grad_norm within ``max(0.05, 0.02 * n_layers)`` and each
    leaf's update within UPDATE_REL_TOL of the plain one's. Returns the
    fields to emit."""
    from repro_torch.kernels import attention, ops, ref
    from repro_torch.launch.train import batch_to, data_config, make_pipeline
    from repro_torch.models.lm import build_model
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.runtime.steps import build_train_step, make_train_state

    model = build_model(cfg)
    data = make_pipeline(data_config(cfg, batch, seq))
    batches = [batch_to(data.batch_for_step(i), "cuda") for i in range(TRAIN_CUT_STEPS)]
    step = build_train_step(model, opt_cfg, n_micro=TRAIN_MICRO)
    arms = {}
    for arm in ("kernels", "plain"):
        state = make_train_state(model, 0, device="cuda")
        if arm == "kernels":
            init = [t.detach().clone() for t in tree_leaves(state.params)]
        else:
            check(all(torch.equal(a, b) for a, b in zip(tree_leaves(state.params), init)),
                  f"{what}: the two arms start from different weights")
        before = dict(attention.launches)
        metrics = []
        t = time.perf_counter()
        with plain_attention(ops, ref) if arm == "plain" else contextlib.nullcontext():
            for b in batches:
                state, m = step(state, b)
                metrics.append({k: float(x) for k, x in m.items()})
        wall = time.perf_counter() - t
        launched = {k: attention.launches[k] - before[k] for k in before}
        check((launched["flash_bwd_dkdv"] > 0) == (arm == "kernels"),
              f"{what} {arm} launched {launched}")
        arms[arm] = (state.params, metrics, wall)  # m and v go: the plain arm needs the room
        del state
        gc.collect()
        torch.cuda.empty_cache()
    tol = max(0.05, 0.02 * cfg.n_layers)  # tests/test_models.py:113
    (sk, mk, wk), (sp, mp, wp) = arms.pop("kernels"), arms.pop("plain")
    for a, b in zip(mk, mp):
        for key in ("loss", "grad_norm"):
            check(abs(a[key] - b[key]) <= tol * (1 + abs(b[key])),
                  f"{what}: {key} kernels {a[key]} != plain {b[key]} (tol {tol})")
    rel = []
    for a, b, p0 in zip(tree_leaves(sk), tree_leaves(sp), init):
        du, dv = a.detach() - p0, b.detach() - p0
        rel.append(float((du - dv).norm() / dv.norm().clamp_min(1e-30)))
    check(max(rel) <= UPDATE_REL_TOL,
          f"{what}: a leaf's update differs by {max(rel)} (tol {UPDATE_REL_TOL})")
    return dict(arch=cfg.name, layers=cfg.n_layers, steps=TRAIN_CUT_STEPS, kernels=mk,
                plain=mp, tol=tol, update_rel_errs=rel, update_rel_tol=UPDATE_REL_TOL,
                kernels_wall_s=wk, plain_wall_s=wp)


def training_phases(np, torch) -> dict:
    """8b. llama3.2-3b trained at its published widths for TRAIN_STEPS
    steps through ``launch/train.py``'s ``train`` (the training main path:
    every count set to 0 just before, read just after; returned), then one
    more step profiled; 8c the train step with kernels against the same
    step with the plain versions on the card, the widths cut to
    TRAIN_CUT_LAYERS layers; 8d checkpoint restart on the smoke config."""
    import shutil

    from repro_torch.checkpoint import ckpt
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.kernels import attention
    from repro_torch.launch.train import batch_to, data_config, make_pipeline, train
    from repro_torch.models.lm import build_model
    from repro_torch.optim.adamw import AdamWConfig, tree_leaves
    from repro_torch.runtime.steps import build_train_step, make_train_state

    t_phase = time.perf_counter()
    cfg = get_config(TRAIN_ARCH)
    opt_cfg = AdamWConfig(warmup_steps=2, total_steps=TRAIN_STEPS)

    # -- 8b. the training main path: every count to 0 just before -----------
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    log = []
    for key in attention.launches:
        attention.launches[key] = 0
    res = train(TRAIN_ARCH, TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO, smoke=False,
                device="cuda", log=log.append, opt_cfg=opt_cfg)
    torch.cuda.synchronize()
    launches = dict(attention.launches)
    peak = torch.cuda.max_memory_allocated()
    L = cfg.n_layers
    want = {key: 0 for key in launches}
    want["flash_attention_lse"] = 2 * L * TRAIN_MICRO * TRAIN_STEPS  # forward + recompute
    want.update({n: L * TRAIN_MICRO * TRAIN_STEPS for n in BWD_KERNELS})
    check(launches == want, f"train launches {launches}, expected {want}")
    losses = [m["loss"] for m in res.metrics]
    gnorms = [m["grad_norm"] for m in res.metrics]
    check(len(losses) == TRAIN_STEPS and all(np.isfinite(losses)), f"train losses {losses}")
    check(all(np.isfinite(gnorms)) and min(gnorms) > 0, f"train grad norms {gnorms}")
    # Moved: each leaf against the same seed's init (the same draws on the card).
    init = build_model(cfg).init(0, device="cuda")
    moved = [float((a.detach() - b).abs().max()) for a, b in
             zip(tree_leaves(res.state.params), tree_leaves(init))]
    # What 9b compares with, kept on the host: each leaf's sampled update.
    kept = dict(losses=[m["loss"] for m in res.metrics],
                grad_norms=[m["grad_norm"] for m in res.metrics],
                updates=update_samples(torch, res.state.params, init),
                step_s=list(res.step_s), peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    del init
    check(min(moved) > 0, f"a parameter leaf did not move: {moved}")
    n_params = sum(t.numel() for t in tree_leaves(res.state.params))
    tok = TRAIN_BATCH * TRAIN_SEQ
    step_s = float(np.mean(res.step_s[1:]))  # the first step warms up
    bound = train_bound(torch, cfg, n_params, n_params, TRAIN_BATCH, TRAIN_SEQ, 0)
    emit("train_full_width", arch=cfg.name, params=n_params, layers=L, batch=TRAIN_BATCH,
         seq=TRAIN_SEQ, n_micro=TRAIN_MICRO, steps=TRAIN_STEPS, step_s=res.step_s,
         first_step_s=res.step_s[0], ms_per_step=1e3 * step_s, tokens_per_s=tok / step_s,
         mfu=bound.pop("dense_flops") / step_s / BF16_OPS_PER_S,
         share_of_bound=bound["step_bound_ms"] / (1e3 * step_s), peak_gib=peak / 2**30,
         losses=losses, grad_norms=gnorms, lrs=[m["lr"] for m in res.metrics],
         min_leaf_max_move=min(moved), launches=launches, log=log, **bound)

    # Where a step's device time goes: one more step under the profiler.
    step_fn = build_train_step(build_model(cfg), opt_cfg, n_micro=TRAIN_MICRO)
    batch = batch_to(make_pipeline(data_config(cfg, TRAIN_BATCH, TRAIN_SEQ))
                     .batch_for_step(TRAIN_STEPS), "cuda")
    state = res.state
    del res

    def one_step():
        step_fn(state, batch)

    kept["profile"] = profile_run("train_step", one_step, step_s)
    del state, batch
    torch.cuda.empty_cache()

    # -- 8c. the step with kernels against the plain versions, same card -----
    cut = dataclasses.replace(cfg, n_layers=TRAIN_CUT_LAYERS)
    emit("train_card_equals_plain", cut=f"{cfg.n_layers} -> {cut.n_layers} layers, widths as published",
         **kernels_vs_plain(np, torch, cut, TRAIN_BATCH, TRAIN_SEQ, opt_cfg, "8c"))
    torch.cuda.empty_cache()

    # -- 8d. checkpoint restart on the smoke config ----------------------------
    d = ROOT / "build" / "phase8_ckpt"
    shutil.rmtree(d, ignore_errors=True)
    kw = dict(arch=TRAIN_ARCH, global_batch=4, seq=64, n_micro=2, smoke=True, device="cuda",
              log=lambda *_: None)
    whole = train(steps=4, **kw)
    first = train(steps=3, ckpt_dir=str(d), ckpt_every=1, **kw)
    smoke = smoke_config(TRAIN_ARCH)
    like = make_train_state(build_model(smoke), 1, device="cuda")
    restored, at = ckpt.restore(str(d), like)
    saved = tree_leaves([first.state.params, first.state.opt, first.state.residual])
    back = tree_leaves([restored.params, restored.opt, restored.residual])
    check(at == 3 and len(saved) == len(back)
          and all(a.dtype == b.dtype and torch.equal(a.detach().cpu(), b.detach().cpu())
                  for a, b in zip(saved, back)), "8d: the restored state != the saved one")
    resumed = train(steps=4, ckpt_dir=str(d), **kw)
    b_res = make_pipeline(data_config(smoke, 4, 64)).batch_for_step(resumed.start)
    b_whole = make_pipeline(data_config(smoke, 4, 64)).batch_for_step(3)
    check(resumed.start == 3 and all(np.array_equal(b_res[k], b_whole[k]) for k in b_whole),
          "8d: the resumed step's batch != the uninterrupted run's")
    l_res, l_whole = resumed.metrics[0]["loss"], whole.metrics[3]["loss"]
    check(abs(l_res - l_whole) <= 1e-3 * abs(l_whole), f"8d: resumed loss {l_res} != {l_whole}")
    emit("train_checkpoint_restart", arch=smoke.name, saved_at=at, leaves=len(saved),
         restored_equal=True, resumed_at=resumed.start, resumed_loss=l_res,
         uninterrupted_loss=l_whole, loss_abs_diff=abs(l_res - l_whole))
    shutil.rmtree(d, ignore_errors=True)
    emit("train_phase", seconds=time.perf_counter() - t_phase, launches=launches)
    return launches, kept


def update_samples(torch, params, init) -> list:
    """Each leaf's update (params - init) at every k-th entry, k chosen so
    that at most UPDATE_SAMPLE entries are kept, as float32 CPU tensors (a
    DTensor leaf by its local shard: the whole leaf on a 1 x 1 mesh)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.optim.adamw import tree_leaves

    out = []
    for a, b in zip(tree_leaves(params), tree_leaves(init)):
        a = a.to_local() if isinstance(a, DTensor) else a
        k = max(1, -(-a.numel() // UPDATE_SAMPLE))
        out.append((a.detach().reshape(-1)[::k].float() - b.reshape(-1)[::k].float()).cpu())
    return out


def gc_pauses(fn) -> dict:
    """The garbage collector's passes during one call of ``fn``: their
    count by generation and their host seconds."""
    import gc

    t0, gens, total = [0.0], [0, 0, 0], [0.0]

    def cb(phase, info):
        if phase == "start":
            t0[0] = time.perf_counter()
        else:
            total[0] += time.perf_counter() - t0[0]
            gens[info["generation"]] += 1

    gc.callbacks.append(cb)
    try:
        fn()
    finally:
        gc.callbacks.remove(cb)
    return dict(collections_by_generation=gens, seconds=total[0])


def host_costs(fn, top: int = 12) -> list[dict]:
    """The ``top`` functions by their own host time over one call of
    ``fn`` under cProfile (which slows every Python call; the shares, not
    the times, are what it shows). cProfile sees this thread only: the
    backward pass runs on autograd's device thread and is not in it."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    prof.enable()
    fn()
    prof.disable()
    st = pstats.Stats(prof)
    total = sum(v[2] for v in st.stats.values())
    rows = sorted(st.stats.items(), key=lambda kv: kv[1][2], reverse=True)[:top]
    return [dict(function=f"{Path(f).name}:{line}({name})", calls=v[1], own_s=v[2],
                 own_share=v[2] / total)
            for (f, line, name), v in rows]


def mesh_serve_kernels(torch, cfg) -> dict:
    """9c's kernel shapes against the plain versions (phase 5a holds the
    serving path's, 4 x 512 + 32): the prefill's flash forward at S = T =
    MESH_PROMPT, causal, and the decode kernel over 9c's cache of
    MESH_PROMPT + MESH_GEN + 1 rows at every kv_len 1 .. T - 1, an int as
    the serve step passes it; bf16, at ATTN_TOL and ATTN_ROW_TOL. Returns
    each kernel's (max abs error, max row-relative error)."""
    H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    T = MESH_PROMPT + MESH_GEN + 1
    return attention_vs_plain(torch, [(MESH_BATCH, MESH_PROMPT, MESH_PROMPT, H, KV, D, True)],
                              [(MESH_BATCH, T, H, KV, D, range(1, T))], "9c")


def attention_vs_plain(torch, flash_shapes, decode_shapes, what: str) -> dict:
    """Both attention kernels against their plain versions (``kernels/ref.py``)
    on bf16 randn inputs, at ATTN_TOL and ATTN_ROW_TOL: flash at each
    (B, S, T, H, KV, D, causal) of ``flash_shapes``, decode at each (B, T,
    H, KV, D, kv_lens) of ``decode_shapes``, every kv_len an int as the
    serve step passes it. Returns each kernel's (max abs error, max
    row-relative error) over its shapes."""
    from repro_torch.kernels import attention, ref

    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16 = torch.bfloat16

    def rn(shape):
        return torch.randn(shape, generator=gen, device="cuda").to(bf16)

    out = {}
    errs = []
    for B, S, T, H, KV, D, causal in flash_shapes:
        q, k, v = rn((B, S, H, D)), rn((B, T, KV, D)), rn((B, T, KV, D))
        errs.append(check_attention(
            torch, "flash_attention", attention.flash_attention(q, k, v, causal),
            ref.ref_flash_attention(q, k, v, causal), bf16,
            f"{what} flash {(B, S, T, H, KV, D)} causal={causal}"))
    if errs:
        out["flash_attention"] = (max(e for e, _ in errs), max(r for _, r in errs))
    errs = []
    for B, T, H, KV, D, lens in decode_shapes:
        q, k, v = rn((B, H, D)), rn((B, T, KV, D)), rn((B, T, KV, D))
        errs += [check_attention(torch, "decode_attention", attention.decode_attention(q, k, v, n),
                                 ref.ref_decode_attention(q, k, v, n), bf16,
                                 f"{what} decode {(B, H, KV, D, T)} kv_len {n}")
                 for n in lens]
    if errs:
        out["decode_attention"] = (max(e for e, _ in errs), max(r for _, r in errs))
    return out


def mesh_phases(np, torch, kept8: dict, kept8e: dict) -> dict:
    """9. The multi-device stack on the card's 1 x 1 mesh: 9a the mesh and
    the sharding tables, 9b llama3.2-3b trained through ``train(mesh=...)``
    at 8b's shape (the mesh training path: every count set to 0 just
    before, read just after), held against 8b's losses, grad norms and
    sampled updates; 9c the full-width serve through ``serve_model(mesh=
    ...)`` against the route without a mesh (its own counts), and the
    kernels held against their plain versions at 9c's shapes; 9e and 9f
    the families trained and served on the mesh (``family_mesh_training``,
    ``family_mesh_serving``); 9d the stage-2 split's card and chunk counts.
    Returns each attention kernel's max abs error at 9c's and 9f's
    shapes."""
    import torch.distributed as dist

    from repro_torch.checkpoint.ckpt import flatten_with_paths
    from repro_torch.configs import get_config
    from repro_torch.core import vectorized
    from repro_torch.distribution.sharding import (
        activation_rules,
        batch_sharding,
        distribute,
        state_sharding,
    )
    from repro_torch.kernels import attention
    from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
    from repro_torch.launch.serve import serve_model
    from repro_torch.launch.train import batch_to, data_config, make_pipeline, train
    from repro_torch.models.layers import activation_sharding
    from repro_torch.models.lm import build_model
    from repro_torch.optim.adamw import AdamWConfig, tree_leaves
    from repro_torch.runtime.steps import build_train_step

    t_phase = time.perf_counter()
    cfg = get_config(TRAIN_ARCH)
    L = cfg.n_layers

    # -- 9a. the mesh: one rank of NCCL on the card ----------------------------
    mesh = make_local_mesh()
    check(tuple(mesh.shape) == (1, 1) and mesh.mesh_dim_names == ("data", "model")
          and mesh.device_type == "cuda", f"local mesh {mesh}")
    try:
        make_production_mesh()
        refused = None
    except RuntimeError as e:
        refused = str(e)
    check(refused is not None and refused.startswith("need 256 devices"),
          f"the production mesh was not refused with one rank: {refused}")

    # -- 9b. training under the mesh: every count to 0 just before -----------
    opt_cfg = AdamWConfig(warmup_steps=2, total_steps=TRAIN_STEPS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for key in attention.launches:
        attention.launches[key] = 0
    log = []
    res = train(TRAIN_ARCH, TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO, smoke=False,
                device="cuda", log=log.append, opt_cfg=opt_cfg, mesh=mesh)
    torch.cuda.synchronize()
    train_launches = dict(attention.launches)
    peak = torch.cuda.max_memory_allocated() / 2**30
    want = {key: 0 for key in train_launches}
    want["flash_attention_lse"] = 2 * L * TRAIN_MICRO * TRAIN_STEPS
    want.update({n: L * TRAIN_MICRO * TRAIN_STEPS for n in BWD_KERNELS})
    check(train_launches == want, f"9b launches {train_launches}, expected {want}")
    losses = [m["loss"] for m in res.metrics]
    gnorms = [m["grad_norm"] for m in res.metrics]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, kept8["losses"]))
    gnorm_rel = max(abs(a - b) / abs(b) for a, b in zip(gnorms, kept8["grad_norms"]))
    check(loss_rel <= MESH_REL_TOL, f"9b losses {losses} against 8b's {kept8['losses']}")
    check(gnorm_rel <= MESH_REL_TOL, f"9b grad norms {gnorms} against 8b's {kept8['grad_norms']}")
    init = build_model(cfg).init(0, device="cuda")
    ups = update_samples(torch, res.state.params, init)
    del init
    rel = [float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))
           for a, b in zip(ups, kept8["updates"])]
    check(max(rel) <= UPDATE_REL_TOL, f"9b updates against 8b's: {rel}")

    # 9a's tables, read off the placed state: leaves by placement on the
    # 1 x 1 mesh, and the parameters' specs on a (16, 16) mesh shape.
    by_placement: dict = {}
    for _, leaf in flatten_with_paths(res.state):
        key = str(tuple(leaf.placements)) if hasattr(leaf, "placements") else "host"
        by_placement[key] = by_placement.get(key, 0) + 1

    class Pod:  # the production mesh's axis sizes, without its 256 ranks
        shape = {"data": 16, "model": 16}
        axis_names = ("data", "model")

    specs = {p: tuple(s.spec) for p, s in flatten_with_paths(state_sharding(res.state, Pod()))
             if p.startswith("[<flat index 0>]")}
    emit("mesh_tables", arch=cfg.name, mesh=dict(zip(mesh.mesh_dim_names, mesh.shape)),
         production_refused=refused, leaves_by_placement=by_placement,
         param_specs_16x16={p: [list(a) if isinstance(a, tuple) else a for a in sp]
                            for p, sp in specs.items()})

    tok = TRAIN_BATCH * TRAIN_SEQ
    step_list = list(res.step_s)
    step_s = float(np.mean(step_list[1:]))  # the first step warms up
    step8 = float(np.mean(kept8["step_s"][1:]))
    n_params = sum(t.numel() for t in tree_leaves(res.state.params))
    bound = train_bound(torch, cfg, n_params, n_params, TRAIN_BATCH, TRAIN_SEQ, 0)
    flops = bound.pop("dense_flops")

    step_fn = build_train_step(build_model(cfg), opt_cfg, n_micro=TRAIN_MICRO)
    batch = batch_to(make_pipeline(data_config(cfg, TRAIN_BATCH, TRAIN_SEQ))
                     .batch_for_step(TRAIN_STEPS), "cuda")
    batch = distribute(batch, batch_sharding(batch, mesh))
    state = res.state
    del res

    def one_step():
        with activation_sharding(activation_rules(mesh)):
            step_fn(state, batch)
        torch.cuda.synchronize()

    prof = profile_run("train_step_mesh", one_step, step_s)
    costs = host_costs(one_step)
    gc_step = gc_pauses(one_step)
    emit("train_mesh", arch=cfg.name, mesh="1x1", batch=TRAIN_BATCH, seq=TRAIN_SEQ,
         n_micro=TRAIN_MICRO, steps=TRAIN_STEPS, step_s=step_list, step_s_8b=kept8["step_s"],
         ms_per_step=1e3 * step_s, ms_per_step_8b=1e3 * step8,
         tokens_per_s=tok / step_s, tokens_per_s_8b=tok / step8,
         mfu=flops / step_s / BF16_OPS_PER_S, mfu_8b=flops / step8 / BF16_OPS_PER_S,
         busy_share=prof.get("busy_share_of_unprofiled"),
         busy_share_8b=kept8["profile"].get("busy_share_of_unprofiled"),
         peak_gib=peak, peak_gib_8b=kept8["peak_gib"],
         losses=losses, losses_8b=kept8["losses"], grad_norms=gnorms,
         grad_norms_8b=kept8["grad_norms"], loss_max_rel=loss_rel, grad_norm_max_rel=gnorm_rel,
         step0_loss_bit_equal=losses[0] == kept8["losses"][0],
         update_rel_max=max(rel), update_rel_mean=float(np.mean(rel)),
         launches=train_launches, host_costs=costs, gc_one_step=gc_step, log=log)
    del state, batch
    gc.collect()
    torch.cuda.empty_cache()

    # -- 9c. serving under the mesh against the route without one -------------
    model = build_model(cfg)
    params = model.init(0, device="cuda", dtype=torch.bfloat16)
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (MESH_BATCH, MESH_PROMPT))).cuda()
    out, serve_launches = {}, {}
    for route, m in (("mesh", mesh), ("plain", None)):
        for k in attention.launches:
            attention.launches[k] = 0
        out[route] = serve_model(model, params, prompts, MESH_GEN, mesh=m)
        torch.cuda.synchronize()
        serve_launches[route] = dict(attention.launches)
        want = {k: 0 for k in attention.launches}
        want["flash_attention"] = 2 * L  # the prefill step's warm-up and timed call
        want["decode_attention"] = (MESH_PROMPT + MESH_GEN - 1) * L
        check(serve_launches[route] == want,
              f"9c {route} launches {serve_launches[route]}, expected {want}")
        check(out[route].all_finite, f"9c {route}: a logit is not finite")
    tol = max(0.05, 0.02 * L)
    a, b = out["mesh"].prompt_logits.float(), out["plain"].prompt_logits.float()
    err = float((a - b).abs().max())
    check(torch.equal(out["mesh"].tokens, out["plain"].tokens), "9c: the mesh route's tokens differ")
    check(err <= tol, f"9c: last prompt logits differ by {err} (tol {tol})")
    # Both routes launch the same kernels, so their agreement says nothing of
    # the kernels at 9c's shapes: hold them against the plain versions.
    kern9 = mesh_serve_kernels(torch, cfg)
    # A short serve: two prefills of 4 tokens, 4 prompt steps and 1 generated.
    step_cost = host_costs(lambda: serve_model(model, params, prompts[:, :4], 2, mesh=mesh), 8)
    emit("serve_mesh", arch=cfg.name, mesh="1x1", batch=MESH_BATCH, prompt=MESH_PROMPT,
         gen=MESH_GEN, tokens_equal=True, prompt_logits_max_abs_err=err, tol=tol,
         ms_per_decode_step=out["mesh"].ms_per_step,
         ms_per_decode_step_plain=out["plain"].ms_per_step,
         prefill_s=out["mesh"].prefill_s, prefill_s_plain=out["plain"].prefill_s,
         launches=serve_launches["mesh"], launches_plain=serve_launches["plain"],
         kernels_at_9c_shapes={n: dict(max_abs_err=e, max_row_rel_err=r)
                           for n, (e, r) in kern9.items()},
         host_costs_short_serve=step_cost)
    del params, out
    torch.cuda.empty_cache()

    # -- 9e / 9f. the expert, recurrent and cross-attention families ---------
    family_mesh_training(np, torch, mesh, kept8e)
    for n, (e, r) in family_mesh_serving(np, torch, mesh).items():
        kern9[n] = (max(kern9[n][0], e), max(kern9[n][1], r))

    # -- 9d. stage 2's split over the local cards ---------------------------
    devs = vectorized._stage2_devices(torch.device("cuda"))
    check(len(devs) == torch.cuda.device_count(), f"stage 2 splits over {devs}")
    emit("stage2_split", cards=torch.cuda.device_count(), chunks=len(devs))
    dist.destroy_process_group()
    emit("mesh_phase", seconds=time.perf_counter() - t_phase)
    return {n: e for n, (e, _) in kern9.items()}


def dry_run_phases(np, torch) -> None:
    """10. The dry run. 10a: ``python -m repro_torch.launch.dryrun`` for
    llama3.2-3b x train_4k, prefill_32k and decode_32k on the 16 x 16 fake
    world (subprocesses on the host's cores, no card), each cell ``ok``,
    its per-device counts and terms printed. 10b: 8b's training step and a
    9c decode step (the cache placed by ``cache_sharding`` at the last
    prompt position) traced under ``analyze_ops`` on the card's 1 x 1 mesh
    with the kernels (the decode step's parameters bf16), and at the same
    shapes and dtypes on fake tensors over a fake world of one: FLOPs, HBM
    bytes, collective bytes and each kernel operator's calls equal. 10c: 9c's serve (4 x 64 tokens, 16 generated) with the cache
    placed by ``cache_sharding`` against the replicated cache on the 1 x 1
    mesh: tokens ``torch.equal``, decode launches equal."""
    import os

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.distribution.sharding import (
        activation_rules,
        batch_sharding,
        cache_sharding,
        distribute,
        state_sharding,
    )
    from repro_torch.kernels import attention
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.op_analysis import analyze_ops
    from repro_torch.launch.serve import _replicated
    from repro_torch.models.layers import activation_sharding
    from repro_torch.models.lm import build_model
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.steps import build_serve_step, build_train_step, make_train_state

    t_phase = time.perf_counter()
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "CUDA_VISIBLE_DEVICES": ""}
    dec_T = MESH_PROMPT + MESH_GEN + 1
    dec_pos = MESH_PROMPT - 1
    procs = {shape: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", SERVE_ARCH, "--shape",
         shape, "--out", str(build / f"dryrun_{shape}.json")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for shape in DRYRUN_SHAPES}
    procs["fake_one"] = subprocess.Popen(
        [sys.executable, "-c", _FAKE_TRACE, TRAIN_ARCH, *map(str, (
            TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO, MESH_BATCH, dec_T, dec_pos))],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    # -- 10b. the card's counts: 8b's step and a 9c decode step ----------------
    mesh = make_local_mesh()
    cfg = get_config(TRAIN_ARCH)
    L = cfg.n_layers
    model = build_model(cfg)
    rules = activation_rules(mesh)
    gen = torch.Generator(device="cuda").manual_seed(0)
    card = {}
    with activation_sharding(rules):
        state = make_train_state(model, 0, device="cuda")
        state = distribute(state, state_sharding(state, mesh))
        batch = {k: torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ), generator=gen,
                                  device="cuda", dtype=torch.int32) for k in ("tokens", "labels")}
        batch = distribute(batch, batch_sharding(batch, mesh))
        step = build_train_step(model, AdamWConfig(), n_micro=TRAIN_MICRO)
        card["train"], _ = analyze_ops(step, state, batch)
        torch.cuda.synchronize()
        del state, batch, step
        gc.collect()
        torch.cuda.empty_cache()
        params = model.init(0, device="cuda", dtype=torch.bfloat16)
        placed_p = _replicated(params, mesh)
        cache = dict(model.init_cache(MESH_BATCH, dec_T, device="cuda"), pos=dec_pos)
        cache = distribute(cache, cache_sharding(cache, mesh))
        token = torch.randint(0, cfg.vocab_size, (MESH_BATCH,), generator=gen, device="cuda",
                              dtype=torch.int32)
        token = distribute(token, batch_sharding(token, mesh))
        card["decode"], _ = analyze_ops(build_serve_step(model), placed_p, cache, token)
        torch.cuda.synchronize()

    # -- 10c. the placed cache against the replicated one ---------------------
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (MESH_BATCH, MESH_PROMPT))).cuda()
    step = build_serve_step(model)
    served, launched = {}, {}
    for route in ("placed", "replicated"):
        for k in attention.launches:
            attention.launches[k] = 0
        with activation_sharding(rules):
            cache = model.init_cache(MESH_BATCH, dec_T, device="cuda")
            cache = (distribute(cache, cache_sharding(cache, mesh)) if route == "placed"
                     else _replicated(cache, mesh))
            fed = _replicated(prompts, mesh)
            outs = []
            t = time.perf_counter()
            for i in range(MESH_PROMPT + MESH_GEN - 1):
                logits, cache = step(placed_p, cache, fed[:, i] if i < MESH_PROMPT else outs[-1])
                if i >= MESH_PROMPT - 1:
                    outs.append(logits[:, 0].argmax(dim=-1))
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t) / (MESH_PROMPT + MESH_GEN - 1)
        served[route] = (torch.stack([o.full_tensor() for o in outs], dim=1), ms)
        launched[route] = dict(attention.launches)
    del params, placed_p, cache
    torch.cuda.empty_cache()
    check(torch.equal(served["placed"][0], served["replicated"][0]),
          "10c: the placed cache's tokens differ from the replicated cache's")
    want = {k: 0 for k in attention.launches}
    want["decode_attention"] = (MESH_PROMPT + MESH_GEN - 1) * L
    check(launched["placed"] == launched["replicated"] == want,
          f"10c launches {launched}, expected {want}")
    emit("placed_cache_serve", arch=cfg.name, mesh="1x1", batch=MESH_BATCH,
         prompt=MESH_PROMPT, gen=MESH_GEN, tokens_equal=True,
         ms_per_decode_step=served["placed"][1], ms_per_decode_step_replicated=served["replicated"][1],
         launches=launched["placed"])

    # -- 10a and 10b's fake side: wait for the processes ----------------------
    fake = None
    for name, p in procs.items():
        try:
            out, err = p.communicate(timeout=max(1.0, DRYRUN_TIMEOUT - (time.perf_counter() - t_phase)))
        except subprocess.TimeoutExpired:
            p.kill()
            out, err = p.communicate()
        check(p.returncode == 0, f"10 {name} exited {p.returncode}: {(out or '')[-2000:]} {(err or '')[-2000:]}")
        if name == "fake_one":
            fake = json.loads(out.strip().splitlines()[-1])
            continue
        cell = json.loads((build / f"dryrun_{name}.json").read_text())[0]
        check(cell["ok"] and cell["error"] is None, f"10a {name}: {cell['error']}")
        emit("dryrun_cell", arch=cell["arch"], shape=cell["shape"], mesh=cell["mesh"],
             flops_per_device=cell["flops"], bytes_per_device=cell["bytes_accessed"],
             collective_bytes=cell["coll_bytes"],
             peak_gib_per_device=cell["peak_memory_per_device"] / 2**30,
             terms=cell["terms"], model_flops=cell["model_flops"], trace_s=cell["compile_s"])
    for kind in ("train", "decode"):
        c, f = card[kind], fake[kind]
        same = (c.flops == f["flops"] and c.hbm_bytes == f["hbm_bytes"]
                and c.collective_bytes == f["collective_bytes"]
                and c.kernel_calls == f["kernel_calls"])
        emit("dryrun_vs_card", step=kind, flops_card=c.flops, flops_fake=f["flops"],
             collective_bytes_card=c.collective_bytes, collective_bytes_fake=f["collective_bytes"],
             kernel_calls_card=c.kernel_calls, kernel_calls_fake=f["kernel_calls"],
             hbm_bytes_card=c.hbm_bytes, hbm_bytes_fake=f["hbm_bytes"],
             peak_gib_fake=f["peak"] / 2**30, equal=same)
        check(same, f"10b {kind}: the card's counts differ from the fake trace's")
    dist.destroy_process_group()
    emit("dryrun_phase", seconds=time.perf_counter() - t_phase)


def family_mesh_training(np, torch, mesh, kept8e: dict) -> None:
    """9e. 8e's arms (FAMILY_TRAIN: published widths, the same seed-0 state,
    pipeline batches and AdamW) trained on DTensors over the card's 1 x 1
    mesh, the state placed by ``state_sharding``, each batch (with its
    frames or patches) by ``batch_sharding``, under the activation rules:
    FAMILY_MESH_STEPS steps, the first under cProfile (it warms up; its
    host costs are reported), every count set to 0 just before and read
    just after (exact: 8e's counts for as many steps), the losses and grad
    norms within MESH_REL_TOL of 8e's first two, each leaf's sampled update
    within UPDATE_REL_TOL of 8e's after its second step, and xlstm's
    device kernel count a step within 1% of 8e's (its time loops run on
    local tensors). One more step runs under the profiler: ms a step, busy
    share, MFU and peak memory beside 8e's."""
    from repro_torch.configs import get_config
    from repro_torch.distribution.sharding import (
        activation_rules,
        batch_sharding,
        distribute,
        state_sharding,
    )
    from repro_torch.kernels import attention
    from repro_torch.launch.train import batch_to, data_config, make_pipeline
    from repro_torch.models.config import layer_kinds
    from repro_torch.models.layers import activation_sharding
    from repro_torch.models.lm import build_model
    from repro_torch.optim.adamw import AdamWConfig, tree_leaves
    from repro_torch.runtime.steps import build_train_step, make_train_state

    t_phase = time.perf_counter()
    opt_cfg = AdamWConfig(warmup_steps=2, total_steps=FAMILY_TRAIN_STEPS)
    rules = activation_rules(mesh)
    for label, arch, layers, B, S in FAMILY_TRAIN:
        k8 = kept8e[label]
        full = get_config(arch)
        cfg = full if layers is None else dataclasses.replace(full, n_layers=layers)
        model = build_model(cfg)
        step = build_train_step(model, opt_cfg, n_micro=TRAIN_MICRO)
        dcfg = data_config(cfg, B, S)
        data = make_pipeline(dcfg)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with activation_sharding(rules):
            batches = []
            for i in range(FAMILY_MESH_STEPS + 1):
                b = batch_to(data.batch_for_step(i), "cuda")
                batches.append(distribute(b, batch_sharding(b, mesh)))
            state = make_train_state(model, 0, device="cuda")
            leaves = tree_leaves(state.params)
            n_params = sum(x.numel() for x in leaves)
            strides, samples = leaf_samples(leaves)
            check(strides == k8["strides"], f"9e {label}: leaves differ from 8e's")
            state = distribute(state, state_sharding(state, mesh))
            del leaves
            for key in attention.launches:
                attention.launches[key] = 0
            box, metrics, step_s = [state], [], []
            del state

            def run(b):
                t = time.perf_counter()
                box[0], m = step(box[0], b)
                metrics.append({k: float(v) for k, v in m.items()})  # reads the device
                step_s.append(time.perf_counter() - t)

            costs = host_costs(lambda: run(batches[0]))
            for b in batches[1:FAMILY_MESH_STEPS]:
                run(b)
            launches = dict(attention.launches)
            peak = torch.cuda.max_memory_allocated() / 2**30
            updates = sampled_updates(box[0].params, strides, samples)
            del samples
            step_mean = float(np.mean(step_s[1:]))
            prof = profile_run(f"train_{label}_mesh", lambda: step(box[0], batches[-1]), step_mean)
        want = {k: v * FAMILY_MESH_STEPS for k, v in k8["launches_per_step"].items()}
        check(launches == want, f"9e {label}: launches {launches}, expected 8e's {want}")
        losses = [m["loss"] for m in metrics]
        gnorms = [m["grad_norm"] for m in metrics]
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, k8["losses"]))
        gnorm_rel = max(abs(a - b) / abs(b) for a, b in zip(gnorms, k8["grad_norms"]))
        check(loss_rel <= MESH_REL_TOL, f"9e {label}: losses {losses} against 8e's {k8['losses']}")
        check(gnorm_rel <= MESH_REL_TOL,
              f"9e {label}: grad norms {gnorms} against 8e's {k8['grad_norms']}")
        rel = [float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))
               for a, b in zip(updates, k8["updates"])]
        check(max(rel) <= UPDATE_REL_TOL, f"9e {label}: updates against 8e's: {rel}")
        kernels, kernels8 = prof.get("device_kernels"), k8["profile"].get("device_kernels")
        if label == "xlstm":
            check(kernels is not None and kernels8 is not None
                  and abs(kernels / kernels8 - 1) <= 0.01,
                  f"9e xlstm: {kernels} device kernels a step against 8e's {kernels8}")
        n_moe = sum(ffn == "moe" for _, ffn in layer_kinds(cfg))
        n_active = (n_params - n_moe * (cfg.n_experts - cfg.experts_per_token)
                    * 3 * cfg.d_model * cfg.d_ff)
        flops = train_bound(torch, cfg, n_params, n_active, B, S, dcfg.memory_len)["dense_flops"]
        emit("family_train_mesh", arm=label, arch=cfg.name, layers=cfg.n_layers, mesh="1x1",
             batch=B, seq=S, memory_rows=dcfg.memory_len, n_micro=TRAIN_MICRO,
             steps=FAMILY_MESH_STEPS, step_s=step_s, step_s_8e=k8["step_s"],
             ms_per_step=1e3 * step_mean, ms_per_step_8e=k8["ms_per_step"],
             mfu=flops / step_mean / BF16_OPS_PER_S, mfu_8e=k8["mfu"],
             busy_share=prof.get("busy_share_of_unprofiled"),
             busy_share_8e=k8["profile"].get("busy_share_of_unprofiled"),
             device_s=prof.get("device_s"), device_s_8e=k8["profile"].get("device_s"),
             device_kernels=kernels, device_kernels_8e=kernels8,
             peak_gib=peak, peak_gib_8e=k8["peak_gib"], losses=losses, losses_8e=k8["losses"],
             grad_norms=gnorms, grad_norms_8e=k8["grad_norms"], loss_max_rel=loss_rel,
             grad_norm_max_rel=gnorm_rel, update_rel_max=max(rel),
             update_rel_mean=float(np.mean(rel)), launches=launches,
             host_costs_warmup_step=costs)
        del box, batches, model, step, updates
    gc.collect()
    torch.cuda.empty_cache()
    emit("family_train_mesh_phase", seconds=time.perf_counter() - t_phase)


def family_mesh_serving(np, torch, mesh) -> dict:
    """9f. jamba (J_LAYERS layers: attention, SSD, 16-expert MoE), xlstm,
    seamless over frames and vision over V_PATCHES patches served at their
    published widths through ``serve_model(mesh=...)`` on the card's 1 x 1
    mesh and through the route without a mesh, the same seed-0 bf16
    weights, MESH_BATCH x FAMILY_MESH_PROMPT prompt tokens and
    FAMILY_MESH_GEN generated; every count set to 0 just before each serve
    and read just after (exact, and equal on the two routes). The tokens
    are equal for seamless and vision, their last prompt logits within
    ``max(0.05, 0.02 * n_layers)``; jamba (MoE) and xlstm are held on
    phase 7's KL bars. Both kernels are held against their plain versions
    at 9f's shapes (the two routes launch the same kernels). Returns each
    kernel's (max abs error, max row-relative error)."""
    import dataclasses as dc

    from repro_torch.configs import get_config
    from repro_torch.kernels import attention
    from repro_torch.launch.serve import serve_model
    from repro_torch.models.config import layer_kinds
    from repro_torch.models.lm import build_model

    t_phase = time.perf_counter()
    B, P, gen = MESH_BATCH, FAMILY_MESH_PROMPT, FAMILY_MESH_GEN
    arms = (("jamba", dc.replace(get_config(J_ARCH), n_layers=J_LAYERS), 0),
            ("xlstm", get_config(X_ARCH), 0),
            ("seamless", get_config(F_ARCH), P),
            ("vision", get_config(V_ARCH), V_PATCHES))
    flash_shapes, decode_shapes = set(), set()
    for label, cfg, T in arms:
        model = build_model(cfg)
        params = model.init(0, device="cuda", dtype=torch.bfloat16)
        rng = np.random.default_rng(0)  # memory first, then the prompts (launch/serve.py:40-52)
        memory = None if not T else torch.from_numpy(
            rng.standard_normal((B, T, cfg.d_model)).astype(np.float32)).cuda()
        prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, P))).cuda()
        pf, dec, enc = attention_calls(cfg)
        want = {k: 0 for k in attention.launches}
        want.update(flash_attention=2 * pf + (enc if memory is not None else 0),
                    decode_attention=dec * (P + gen - 1))
        out, launches = {}, {}
        for route, m in (("mesh", mesh), ("plain", None)):
            for k in attention.launches:
                attention.launches[k] = 0
            out[route] = serve_model(model, params, prompts, gen, memory=memory, mesh=m)
            torch.cuda.synchronize()
            launches[route] = dict(attention.launches)
            check(launches[route] == want,
                  f"9f {label} {route}: launches {launches[route]}, expected {want}")
            check(out[route].all_finite, f"9f {label} {route}: a logit is not finite")
        by_kl = bool(cfg.n_experts) or label == "xlstm"
        tokens_equal = bool(torch.equal(out["mesh"].tokens, out["plain"].tokens))
        if not by_kl:
            check(tokens_equal, f"9f {label}: the mesh route's tokens differ")
        gate = agree(torch, out["mesh"].prompt_logits, out["plain"].prompt_logits,
                     None if by_kl else max(0.05, 0.02 * cfg.n_layers),
                     f"9f {label}: mesh != plain at the last prompt position")
        H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        kinds = {mixer for mixer, _ in layer_kinds(cfg)}
        if kinds & {"attn", "attn_cross"}:
            flash_shapes.add((B, P, P, H, KV, D, True))
            decode_shapes.add((B, P + gen + 1, H, KV, D, range(1, P + gen + 1)))
        if kinds & {"cross", "attn_cross"}:
            flash_shapes.add((B, P, T, H, KV, D, False))
            decode_shapes.add((B, T, H, KV, D, (T,)))
        if cfg.n_enc_layers:
            flash_shapes.add((B, T, T, H, KV, D, False))
        emit("family_serve_mesh", arm=label, arch=cfg.name, layers=cfg.n_layers,
             enc_layers=cfg.n_enc_layers, mesh="1x1", batch=B, prompt=P, gen=gen,
             memory_rows=T, tokens_equal=tokens_equal, tokens_gated=not by_kl, **gate,
             ms_per_decode_step=out["mesh"].ms_per_step,
             ms_per_decode_step_plain=out["plain"].ms_per_step,
             time_to_first_token_s=out["mesh"].first_token_s,
             time_to_first_token_s_plain=out["plain"].first_token_s,
             prefill_s=out["mesh"].prefill_s, prefill_s_plain=out["plain"].prefill_s,
             peak_gib=out["mesh"].peak_bytes / 2**30,
             peak_gib_plain=out["plain"].peak_bytes / 2**30,
             launches=launches["mesh"], launches_plain=launches["plain"])
        del model, params, out, memory
        torch.cuda.empty_cache()
    # The two routes launch the same kernels: hold them against their plain
    # versions at 9f's shapes.
    errs = attention_vs_plain(torch, sorted(flash_shapes),
                              sorted(decode_shapes, key=lambda s: s[:5]), "9f")
    emit("family_serve_mesh_kernels", flash_shapes=[list(s) for s in sorted(flash_shapes)],
         decode_shapes=[list(s[:5]) + [len(s[5])] for s in sorted(decode_shapes,
                                                                    key=lambda s: s[:5])],
         **{n: dict(max_abs_err=e, max_row_rel_err=r) for n, (e, r) in errs.items()})
    emit("family_serve_mesh_phase", seconds=time.perf_counter() - t_phase)
    return errs


def family_training(np, torch) -> dict:
    """8e. Each family's training step at its published widths (FAMILY_TRAIN)
    through ``build_train_step``: FAMILY_TRAIN_STEPS steps on the port's
    pipeline, every count set to 0 just before and read just after (exact:
    2 forwards with lse and one of each backward kernel per attention call
    a micro-batch), finite losses, grad_norm > 0, every leaf moved; ms a
    step, tokens/s, MFU (active parameters only), the bound and peak
    memory, then one more step profiled. The vision arm also runs cut to
    VISION_CUT_LAYERS layers with the kernels against the plain versions
    (cross-attention's backward through the kernels inside a step).
    Returns the counts by arm."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import attention
    from repro_torch.launch.train import batch_to, data_config, make_pipeline
    from repro_torch.models.config import layer_kinds
    from repro_torch.models.lm import build_model
    from repro_torch.optim.adamw import AdamWConfig, tree_leaves
    from repro_torch.runtime.steps import build_train_step, make_train_state

    t_phase = time.perf_counter()
    opt_cfg = AdamWConfig(warmup_steps=2, total_steps=FAMILY_TRAIN_STEPS)
    counts, kept = {}, {}
    for label, arch, layers, B, S in FAMILY_TRAIN:
        full = get_config(arch)
        cfg = full if layers is None else dataclasses.replace(full, n_layers=layers)
        model = build_model(cfg)
        step = build_train_step(model, opt_cfg, n_micro=TRAIN_MICRO)
        dcfg = data_config(cfg, B, S)
        data = make_pipeline(dcfg)
        batches = [batch_to(data.batch_for_step(i), "cuda") for i in range(FAMILY_TRAIN_STEPS + 1)]
        # The last arm's state can sit in reference cycles (autograd and
        # checkpoint frames) until the collector runs: free it before the
        # cache is emptied.
        gc.collect()
        torch.cuda.empty_cache()
        at_start = dict(allocated_gib=torch.cuda.memory_allocated() / 2**30,
                        reserved_gib=torch.cuda.memory_reserved() / 2**30)
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        state = make_train_state(model, 0, device="cuda")
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t
        leaves = tree_leaves(state.params)
        n_params = sum(x.numel() for x in leaves)
        n_moe = sum(ffn == "moe" for _, ffn in layer_kinds(cfg))
        n_active = n_params - n_moe * (cfg.n_experts - cfg.experts_per_token) * 3 * cfg.d_model * cfg.d_ff
        # Every leaf moved: a strided sample of each (at most ~1 M entries),
        # since a second copy of jamba's weights would not fit beside its state.
        strides, samples = leaf_samples(leaves)
        for key in attention.launches:
            attention.launches[key] = 0
        metrics, step_s, updates = [], [], None
        for b in batches[:FAMILY_TRAIN_STEPS]:
            t = time.perf_counter()
            state, m = step(state, b)
            metrics.append({k: float(v) for k, v in m.items()})  # reads the device
            step_s.append(time.perf_counter() - t)
            if len(metrics) == 2:  # what 9e compares with: the update after 2 steps
                updates = sampled_updates(state.params, strides, samples)
        launches = dict(attention.launches)
        peak = torch.cuda.max_memory_allocated()
        calls = attention_calls(cfg)[0] * TRAIN_MICRO * FAMILY_TRAIN_STEPS
        want = {key: 0 for key in launches}
        want["flash_attention_lse"] = 2 * calls  # forward + recompute
        want.update({n: calls for n in BWD_KERNELS})
        check(launches == want, f"8e {label}: launches {launches}, expected {want}")
        losses = [m["loss"] for m in metrics]
        gnorms = [m["grad_norm"] for m in metrics]
        check(all(np.isfinite(losses)), f"8e {label}: losses {losses}")
        check(all(np.isfinite(gnorms)) and min(gnorms) > 0, f"8e {label}: grad norms {gnorms}")
        moved = [int((x.detach().reshape(-1)[::k] != s0).sum()) for x, k, s0 in
                 zip(tree_leaves(state.params), strides, samples)]
        check(min(moved) > 0, f"8e {label}: a parameter leaf did not move: {moved}")
        del samples
        step_mean = float(np.mean(step_s[1:]))
        bound = train_bound(torch, cfg, n_params, n_active, B, S, dcfg.memory_len)
        mfu = bound.pop("dense_flops") / step_mean / BF16_OPS_PER_S
        emit("family_train", arm=label, arch=cfg.name, layers=cfg.n_layers,
             published_layers=full.n_layers, enc_layers=cfg.n_enc_layers, params=n_params,
             active_params=n_active, batch=B, seq=S, memory_rows=dcfg.memory_len,
             n_micro=TRAIN_MICRO, steps=FAMILY_TRAIN_STEPS, init_s=init_s, step_s=step_s,
             ms_per_step=1e3 * step_mean, tokens_per_s=B * S / step_mean, mfu=mfu,
             share_of_bound=bound["step_bound_ms"] / (1e3 * step_mean), peak_gib=peak / 2**30,
             state_gib=16 * n_params / 2**30, losses=losses, grad_norms=gnorms,
             lrs=[m["lr"] for m in metrics], min_leaf_sample_moved=min(moved),
             launches=launches, memory_at_start=at_start, **bound)
        counts[label] = launches

        def one_step():
            step(state, batches[-1])

        prof = profile_run(f"train_{label}", one_step, step_mean)
        kept[label] = dict(losses=losses[:2], grad_norms=gnorms[:2], updates=updates,
                           strides=strides, step_s=step_s, ms_per_step=1e3 * step_mean,
                           mfu=mfu, peak_gib=peak / 2**30, profile=prof,
                           launches_per_step={k: v // FAMILY_TRAIN_STEPS
                                              for k, v in launches.items()})
        del state, batches, leaves, model, step
        if label == "vision":
            cut = dataclasses.replace(full, n_layers=VISION_CUT_LAYERS)
            check(any(mixer == "cross" for mixer, _ in layer_kinds(cut)),
                  "8e: the vision cut holds no cross layer")
            gc.collect()
            torch.cuda.empty_cache()
            emit("family_train_equals_plain", arm=label,
                 cut=f"{full.n_layers} -> {cut.n_layers} layers, widths as published",
                 **kernels_vs_plain(np, torch, cut, B, S, opt_cfg, "8e vision"))
    emit("family_train_phase", seconds=time.perf_counter() - t_phase, launches=counts)
    return counts, kept


def leaf_samples(leaves) -> tuple[list, list]:
    """(strides, samples): every k-th entry of each leaf, k chosen so that
    at most ~2**20 entries are kept (8e's, 9e's), cloned on the device."""
    strides = [max(1, x.numel() // 2**20) for x in leaves]
    return strides, [x.detach().reshape(-1)[::k].clone() for x, k in zip(leaves, strides)]


def sampled_updates(params, strides, samples) -> list:
    """Each leaf's update against its ``samples`` at the same ``strides``,
    as float32 CPU tensors (a DTensor leaf by its local shard: the whole
    leaf on a 1 x 1 mesh)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.optim.adamw import tree_leaves

    out = []
    for x, k, s0 in zip(tree_leaves(params), strides, samples):
        x = x.to_local() if isinstance(x, DTensor) else x
        out.append((x.detach().reshape(-1)[::k].float() - s0.float()).cpu())
    return out


def production_scenario(np, torch, stream) -> None:
    """6. The paper's production scenario with the exact optimum as the
    oracle, the stage-1 bound on the card against it, the gradient-sync
    planner and the trace exporters; the phase's cpm launches counted
    from 0."""
    from repro_torch.configs import get_config
    from repro_torch.core import (
        ProblemInstance, check_feasible, random_job, schedule_fleet,
        solve_bisection, solve_bnb, solve_optimal, wired_only,
    )
    from repro_torch.core.vectorized import (
        batched_lower_bound, enumerate_assignments, make_batched_evaluator,
        vectorized_search,
    )
    from repro_torch.distribution.plan import (
        LinkSpec, backward_profile, plan_gradient_schedule, replan,
    )
    from repro_torch.kernels import cpm
    from repro_torch.obs import Tracer, prometheus_exposition, write_chrome_trace
    from repro_torch.obs.report import (
        commit_latency_total, epoch_breakdown, load_trace, render_report,
    )
    from repro_torch.online import OnlineScheduler

    for k in cpm.launches:
        cpm.launches[k] = 0
    t_phase = time.perf_counter()

    # -- the fleet on the card, each job's optima by B&B ---------------------
    insts = [
        ProblemInstance(job=random_job(np.random.default_rng(100 + j), None, rho=0.5),
                        n_racks=8, n_wireless=2)
        for j in range(SCENARIO_JOBS)
    ]
    torch.cuda.synchronize()
    t = time.perf_counter()
    fleet = schedule_fleet(insts, max_enumerate=20_000, n_samples=2048,
                           strategies="portfolio")
    torch.cuda.synchronize()
    fleet_wall = time.perf_counter() - t
    fleet_launches = dict(cpm.launches)
    check(fleet_launches["fleet_lb"] > 0, "scenario fleet launched no fleet_lb")
    n_proved, wired_sum, aug_sum = 0, 0.0, 0.0
    for j, (inst, rv) in enumerate(zip(insts, fleet.results)):
        check_feasible(inst, rv.schedule)
        wired = wired_only(inst)
        r0 = solve_bnb(wired, time_limit=SCENARIO_BNB_S)
        r2 = solve_bnb(inst, time_limit=SCENARIO_BNB_S)
        check_feasible(wired, r0.schedule)
        check_feasible(inst, r2.schedule)
        if r2.proved_optimal:
            n_proved += 1
            check(rv.makespan >= r2.makespan - EPS_SLACK,
                  f"scenario job {j}: fleet {rv.makespan} < optimum {r2.makespan} - {EPS_SLACK}")
            check(r2.makespan <= r0.makespan + EPS_SLACK,
                  f"scenario job {j}: augmented {r2.makespan} > wired-only {r0.makespan} + {EPS_SLACK}")
        wired_sum += r0.makespan
        aug_sum += r2.makespan
        emit("scenario_job", job=j, n_tasks=inst.job.n_tasks, wired_opt=r0.makespan,
             augmented_opt=r2.makespan, gain=1 - r2.makespan / r0.makespan,
             fleet_makespan=float(rv.makespan), wired_proved=r0.proved_optimal,
             augmented_proved=r2.proved_optimal, wired_wall_s=r0.wall_s,
             augmented_wall_s=r2.wall_s, fleet_pruned=rv.n_pruned,
             fleet_candidates=rv.n_candidates)
    emit("scenario", jobs=SCENARIO_JOBS, bnb_time_limit_s=SCENARIO_BNB_S,
         augmented_proved=n_proved, mean_wired_opt=wired_sum / SCENARIO_JOBS,
         mean_augmented_opt=aug_sum / SCENARIO_JOBS, gain=1 - aug_sum / wired_sum,
         fleet_mean_makespan=float(fleet.makespans.mean()), fleet_wall_s=fleet_wall,
         stage1_launches=fleet.n_stage1_launches, stage2_launches=fleet.n_stage2_launches,
         n_pruned=fleet.n_pruned, n_candidates=fleet.n_candidates,
         kernel_launches=fleet_launches)

    # -- the stage-1 bound on the card against the optimum ---------------------
    for seed in range(4):  # tests/test_vectorized.py:18's instances
        job = random_job(np.random.default_rng(seed), None, n_tasks=5, rho=1.0)
        inst = ProblemInstance(job=job, n_racks=3, n_wireless=1)
        cands = enumerate_assignments(inst.job.n_tasks, inst.n_racks)
        before = cpm.launches["fleet_lb"]
        lbs = batched_lower_bound(inst, cands, use_kernel=True)
        check(cpm.launches["fleet_lb"] > before, f"seed {seed}: the bound ran no fleet_lb")
        scores = make_batched_evaluator(inst)(cands).cpu().numpy()
        opt = solve_bnb(inst, time_limit=30)
        check(opt.proved_optimal, f"seed {seed}: B&B did not prove its optimum")
        res = vectorized_search(inst)
        milp = solve_optimal(inst, time_limit=90)
        bis = solve_bisection(inst, time_limit_per_fp=60, rel_tol=1e-4)
        check(milp.schedule is not None, f"seed {seed}: HiGHS found no schedule")
        check(float(lbs.min()) <= opt.makespan + 1e-3,
              f"seed {seed}: min bound {lbs.min()} > optimum {opt.makespan}")
        check(bool((lbs <= scores + 1e-3).all()), f"seed {seed}: a bound exceeds its score")
        check(res.makespan >= opt.makespan - EPS_SLACK,
              f"seed {seed}: engine {res.makespan} < optimum {opt.makespan} - {EPS_SLACK}")
        # tests/test_milp_optimal.py:48-51
        check(abs(opt.makespan - milp.makespan) <= EPS_SLACK,
              f"seed {seed}: B&B {opt.makespan} != HiGHS {milp.makespan}")
        check(abs(bis.makespan - milp.makespan)
              <= max(EPS_SLACK, 1e-3 * milp.makespan + 1e-4),
              f"seed {seed}: bisection {bis.makespan} != HiGHS {milp.makespan}")
        emit("bound_vs_optimum", seed=seed, candidates=len(cands),
             min_bound=float(lbs.min()), bnb=opt.makespan, highs=milp.makespan,
             bisection=bis.makespan, engine=res.makespan,
             bnb_wall_s=opt.wall_s, highs_wall_s=milp.wall_s, bisection_wall_s=bis.wall_s,
             bisection_iterations=bis.iterations)

    # -- the gradient-sync planner at a model's full width ---------------------
    cfg = get_config("llama3.2-3b")
    g_secs, g_bytes = backward_profile(cfg, tokens_per_device=4096)
    for label, plan in (
        ("healthy", plan_gradient_schedule(g_secs, g_bytes, LinkSpec())),
        ("degraded", replan(g_secs, g_bytes, LinkSpec(), compute_slowdown=1.6,
                            degraded_aux=1)),
    ):
        check(plan.t_optimal <= plan.t_greedy + 1e-9, f"planner {label}: optimal > greedy")
        check(plan.t_optimal <= plan.t_serial + 1e-9, f"planner {label}: optimal > serial")
        emit("planner", arch=cfg.name, arm=label, t_optimal=plan.t_optimal,
             t_greedy=plan.t_greedy, t_serial=plan.t_serial,
             proved_optimal=plan.proved_optimal,
             channel_of_bucket=plan.channel_of_bucket.tolist())

    # -- the trace exporters on the card's serve -------------------------------
    tr = Tracer()
    res = OnlineScheduler(8, 2, window=5.0, seed=0, tracer=tr).serve(stream)
    path = ROOT / "build" / "phase6_trace.json"
    path.parent.mkdir(exist_ok=True)
    write_chrome_trace(tr, path)
    trace = load_trace(path)
    rows = epoch_breakdown(trace)
    commit = commit_latency_total(trace)
    check(len(rows) == res.n_epochs,
          f"trace report: {len(rows)} breakdown rows for {res.n_epochs} epochs")
    check(np.isfinite(commit) and commit > 0, f"trace report: commit latency {commit}")
    report = render_report(trace, top=3)
    prom = prometheus_exposition(tr)
    emit("trace_export", jobs=len(stream), epochs=res.n_epochs, breakdown_rows=len(rows),
         commit_latency_total_s=commit, trace_bytes=path.stat().st_size,
         prometheus_bytes=len(prom), prometheus_lines=len(prom.splitlines()),
         report_head=report.splitlines()[:8])

    launches = dict(cpm.launches)
    check(launches["fleet_lb"] > 0, "phase 6 never launched fleet_lb")
    emit("scenario_phase", seconds=time.perf_counter() - t_phase, launches=launches)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch.core import check_feasible
    from repro_torch.core.instance import Topology
    from repro_torch.core.vectorized import schedule_fleet, vectorized_search
    from repro_torch.kernels import build, cpm, ref
    from repro_torch.obs import Tracer
    from repro_torch.online import OnlineScheduler, production_arrivals

    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "unknown"
    print(card, flush=True)
    emit("versions", python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0))

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 0. build: one nvcc per source, all started together --------------------
    t0 = time.perf_counter()
    build.build_all()
    ptxas = {name: [ln.strip() for ln in build.build_log(src).splitlines()
                    if "Used" in ln or "spill" in ln]
             for name, src in build.SOURCES.items()}
    emit("build", seconds=time.perf_counter() - t0, ptxas=ptxas)
    emit("flash_bf16_ptxas", instantiations=flash_ptxas(
        build.build_log(build.SOURCES["flash_attention"]), build.load("flash_attention")))
    emit("decode_ptxas", instantiations=decode_ptxas(
        build.build_log(build.SOURCES["decode_attention"])))
    cpm_fns = cpm_ptxas(build.build_log(build.SOURCES["cpm"]))
    emit("cpm_ptxas", functions=cpm_fns)
    check(len(cpm_fns) > 0, "no ptxas report for cpm.cu")
    for f in cpm_fns:
        check(f.get("spill_store_bytes", 0) == 0 and f.get("spill_load_bytes", 0) == 0,
              f"cpm.cu spills in {f['function']}")
    bwd_fns = flash_bwd_ptxas(build.build_log(build.SOURCES["flash_attention_bwd"]),
                              build.load("flash_attention_bwd"))
    emit("flash_bwd_ptxas", instantiations=bwd_fns)
    check(len(bwd_fns) > 0, "no ptxas report for flash_attention_bwd.cu")
    for f in bwd_fns:
        check(f["spill_store_bytes"] == 0 and f["spill_load_bytes"] == 0,
              f"flash_attention_bwd.cu spills in {f['kernel']}")

    # The offline fleet of phases 1 (stage-1 inputs) and 2.
    evs = production_arrivals(0, rate=1 / 60, n_jobs=16, n_racks=8, n_wireless=2)
    insts = [e.inst for e in evs]
    topo_rng = np.random.default_rng(1)
    topo_insts = [
        dataclasses.replace(
            inst,
            topology=Topology(
                reach=topo_rng.random((inst.n_racks, inst.n_wireless)) < 0.5
            ),
        )
        for inst in insts
    ]

    # -- 1. kernels against their plain versions ------------------------------
    rng = np.random.default_rng(0)
    shapes = [
        ("offline", 16 * 8192, 16, 9),
        ("serving", 8 * 512, 16, 9),
        ("ragged8", 257, 8, None),
        ("ragged12", 257, 12, None),
        ("ragged17", 257, 17, None),
        ("ragged32", 257, 32, None),
        ("ragged128", 257, 128, None),
    ]
    max_err = {k: 0.0 for k in cpm.launches}
    table = {}
    for label, B, n, n_iters in shapes:
        w, p, extra, mask = lb_inputs(np, torch, rng, B, n)
        it = ref.clamp_iters(n, n_iters)
        calls = {
            "combined_lb": (
                lambda: cpm.batched_combined_lb(w, p, extra, n_iters=it),
                lambda: ref.ref_combined_lb(w, p, extra, n_iters=it),
            ),
            "combined_lb_masked": (
                lambda: cpm.batched_combined_lb(w, p, extra, mask=mask, n_iters=it),
                lambda: ref.ref_combined_lb(w, p, extra, mask=mask, n_iters=it),
            ),
            "critical_path": (
                lambda: cpm.batched_critical_path(w, n_iters=it),
                lambda: ref.ref_critical_path(w, n_iters=it),
            ),
        }
        for name, (kern, plain) in calls.items():
            got, want = kern(), plain()
            torch.cuda.synchronize()
            err = float((got - want).abs().max().item())
            max_err[name] = max(max_err[name], err)
            check(torch.equal(got, want), f"{name} != plain at {label} (err {err})")
            ms = cuda_ms(torch, kern)
            plain_ms = cuda_ms(torch, plain, reps=5, warmup=1)
            rounds = rounds_needed(torch, ref, w, it,
                                   mask if name == "combined_lb_masked" else None)
            b_ms, b_by = bound(B, n, rounds, name)
            # The device time alone at the main-path shapes.
            dev_ms = graph_ms(torch, kern) if label in ("offline", "serving") else None
            emit("kernel", name=name, shape=label, B=B, n=n, n_iters=it,
                 mean_rounds_needed=rounds / B, ms=ms, device_ms=dev_ms,
                 plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, max_abs_err=err)
            if label == "offline":
                table[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                   bound_by=b_by)
        del w, p, extra, mask
    torch.cuda.empty_cache()

    # The fused stage-1 kernels on phase 2's fleet: offline (16 jobs x 8192
    # candidates) and serving (8 x 512) shapes, without and with a topology.
    from repro_torch.core.vectorized import _rows_to_device

    dev = torch.device("cuda")
    for label, rows, n_inst in (("offline", 8192, 16), ("serving", 512, 8)):
        for name, fleet_insts in (("fleet_lb", insts), ("fleet_lb_masked", topo_insts)):
            rack, iid, tables, dims = stage1_inputs(np, torch, fleet_insts[:n_inst], rows, 2)
            r32, i32 = _rows_to_device(rack, dev), _rows_to_device(iid, dev)
            B = rack.shape[0]
            kw = dict(M_pad=dims.M_pad, n_iters=dims.n_iters, contention=True)
            kern = lambda: cpm.fleet_combined_lb(r32, i32, *tables, **kw)  # noqa: E731
            plain = lambda: ref.ref_fleet_lb(r32, i32, *tables, **kw)  # noqa: E731
            got, want = kern(), plain()
            torch.cuda.synchronize()
            err = float((got - want).abs().max().item())
            max_err[name] = max(max_err[name], err)
            check(torch.equal(got, want), f"{name} != plain at {label} (err {err})")
            nc = dict(kw, contention=False)
            check(torch.equal(cpm.fleet_combined_lb(r32, i32, *tables, **nc),
                              ref.ref_fleet_lb(r32, i32, *tables, **nc)),
                  f"{name} != plain without contention at {label}")
            ms = cuda_ms(torch, kern)
            dev_ms = graph_ms(torch, kern)
            plain_ms = cuda_ms(torch, plain, reps=5, warmup=1)
            w_, _, _, mask_ = ref.ref_fleet_operands(r32, i32, *tables, M_pad=dims.M_pad,
                                                     contention=False)
            rounds = rounds_needed(torch, ref, w_, dims.n_iters, mask_)
            del w_, mask_
            b_ms, b_by = fleet_bound((r32, i32, *tables), 4 * B, B, dims.n_pad,
                                     dims.m_pad, dims.M_pad, rounds,
                                     name == "fleet_lb_masked")
            emit("kernel", name=name, shape=label, B=B, n=dims.n_pad, m=dims.m_pad,
                 M=dims.M_pad, n_iters=dims.n_iters, mean_rounds_needed=rounds / B,
                 ms=ms, device_ms=dev_ms,
                 plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
                 host_us_per_call=host_us(torch, kern))
            if label == "offline":
                table[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                   bound_by=b_by)
                # Where the kernel's time goes: device ms without the
                # contention terms, without rounds, and with neither (the
                # rows' build: racks, tile, edges, epilogue).
                def part(contention, n_iters):
                    return graph_ms(torch, lambda: cpm.fleet_combined_lb(
                        r32, i32, *tables, M_pad=dims.M_pad, n_iters=n_iters,
                        contention=contention))

                emit("fleet_lb_parts", kernel=name, device_ms=dev_ms,
                     no_contention_ms=part(False, dims.n_iters),
                     no_rounds_ms=part(True, 0), build_only_ms=part(False, 0))
                # One stage-1 launch as _run_fleet makes it: copy the rows
                # in, launch and sync, copy the bounds back.
                split = []
                for _ in range(5):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    rd, idd = _rows_to_device(rack, dev), _rows_to_device(iid, dev)
                    torch.cuda.synchronize()
                    t1 = time.perf_counter()
                    lb = cpm.fleet_combined_lb(rd, idd, *tables, **kw)
                    torch.cuda.synchronize()
                    t2 = time.perf_counter()
                    lb.cpu().numpy()
                    t3 = time.perf_counter()
                    split.append((t1 - t0, t2 - t1, t3 - t2))
                h2d, run, d2h = (1e3 * float(np.median(c)) for c in zip(*split))
                # Device memory one launch adds over what is allocated: the
                # kernel's output, against the plain version's [B, n, n]
                # adjacency (and mask), as the PyTorch glue formed them.
                peak = {}
                for which, fn in (("kernel", kern), ("plain", plain)):
                    torch.cuda.synchronize()
                    base = torch.cuda.memory_allocated()
                    torch.cuda.reset_peak_memory_stats()
                    fn()
                    torch.cuda.synchronize()
                    peak[which] = (torch.cuda.max_memory_allocated() - base) / 2**20
                emit("stage1_host_split", kernel=name, B=B, h2d_ms=h2d,
                     launch_to_sync_ms=run, d2h_ms=d2h, total_ms=h2d + run + d2h,
                     h2d_bytes=rack.nbytes + iid.nbytes,
                     launch_peak_mib=peak["kernel"], plain_launch_peak_mib=peak["plain"])
            del r32, i32, tables, got, want
    torch.cuda.empty_cache()

    # -- main path: every count to 0 just before, read just after -------------
    for k in cpm.launches:
        cpm.launches[k] = 0
    t_main = time.perf_counter()

    # -- 2. offline fleet -------------------------------------------------------
    def fleet_run(instances, label):
        before = dict(cpm.launches)
        tr = Tracer()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        fleet = schedule_fleet(instances, tracer=tr)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        peak = torch.cuda.max_memory_allocated()
        s1 = [s.duration for s in tr.spans_named("stage1_launch")]
        s2 = [s.duration for s in tr.spans_named("stage2_launch")]
        emit("offline_fleet", arm=label, n_instances=len(instances),
             wall_s=wall, n_candidates=fleet.n_candidates,
             candidates_per_s=fleet.n_candidates / wall,
             n_pruned=fleet.n_pruned, n_evaluated=fleet.n_evaluated,
             stage1_launches=fleet.n_stage1_launches,
             stage2_launches=fleet.n_stage2_launches,
             stage1_ms_per_launch=1e3 * float(np.mean(s1)) if s1 else None,
             stage1_ms_min_max=[1e3 * min(s1), 1e3 * max(s1)] if s1 else None,
             peak_device_mib=peak / 2**20,
             stage2_ms_per_launch=1e3 * float(np.mean(s2)) if s2 else None,
             stage2_rows=8192 * len(instances),
             stage2_bound_ms=stage2_bound_ms(torch, instances, 8192),
             kernel_launches={k: cpm.launches[k] - before[k] for k in before},
             makespans=[float(m) for m in fleet.makespans])
        for inst, res in zip(instances, fleet.results):
            check_feasible(inst, res.schedule)
        return fleet, {k: cpm.launches[k] - before[k] for k in before}, wall

    def same(a, b):
        return (a.makespan == b.makespan
                and np.array_equal(a.best_assignment, b.best_assignment)
                and a.n_candidates == b.n_candidates
                and a.n_pruned == b.n_pruned and a.n_evaluated == b.n_evaluated
                and a.refine_rounds == b.refine_rounds)

    fleet, d, fleet_wall = fleet_run(insts, "plain")
    check(d["fleet_lb"] > 0, "offline fleet launched no fleet_lb")
    for i, inst in enumerate(insts):
        check(same(vectorized_search(inst), fleet.results[i]),
              f"offline fleet != solo for instance {i}")

    tfleet, d, _ = fleet_run(topo_insts, "topology")
    check(d["fleet_lb_masked"] > 0, "topology fleet launched no masked kernel")
    for i in range(4):
        check(same(vectorized_search(topo_insts[i]), tfleet.results[i]),
              f"topology fleet != solo for instance {i}")

    for sub in (insts[:4], topo_insts[:4]):
        gpu = schedule_fleet(sub, batch_size=2048)
        cpu = schedule_fleet(sub, batch_size=2048, device="cpu")
        for a, b in zip(gpu.results, cpu.results):
            check(same(a, b), "card != CPU on the 4-instance subset")
    emit("card_equals_cpu", instances=4, batch_size=2048, arms=2)

    # -- 3. serving ---------------------------------------------------------
    golden_evs = production_arrivals(3, rate=1 / 10, n_jobs=5, n_racks=6,
                                     n_wireless=2)
    res = OnlineScheduler(
        6, 2, window=5.0, seed=3,
        solver_kwargs=dict(max_enumerate=64, n_samples=64, batch_size=256,
                           refine_rounds=1, refine_pool=64),
    ).serve(golden_evs)
    rows = [(m.job_id, m.admitted, m.completion, m.makespan,
             m.n_racks_granted, m.n_wireless_granted) for m in res.jobs]
    check(rows == GOLDEN_FLEET_ROWS, "production_fleet fingerprint differs")
    check(dict(n_epochs=res.n_epochs, n_served=res.n_served,
               n_backfilled=res.n_backfilled, horizon=res.horizon)
          == GOLDEN_FLEET_COUNTERS, "production_fleet counters differ")
    emit("serve_golden", fingerprint_equal=True, n_served=res.n_served)

    stream = production_arrivals(0, rate=1 / 60, n_jobs=SERVE_JOBS, n_racks=8,
                                 n_wireless=2)

    def serve(label, **kw):
        before = dict(cpm.launches)
        torch.cuda.synchronize()
        t = time.perf_counter()
        # serve() ends with the timeline's feasibility audit
        # (ClusterTimeline.assert_feasible), which raises on any overlap.
        out = OnlineScheduler(8, 2, window=5.0, seed=0, **kw).serve(stream)
        wall = time.perf_counter() - t
        launched = {k: cpm.launches[k] - before[k] for k in before}
        check(out.n_served == SERVE_JOBS, f"{label}: served {out.n_served}")
        check(np.isfinite(out.mean_jct), f"{label}: mean JCT not finite")
        emit("serve", arm=label, n_jobs=SERVE_JOBS, n_served=out.n_served,
             wall_s=wall, mean_jct=out.mean_jct, p99_jct=out.p99_jct,
             n_epochs=out.n_epochs, solver_wall_s=out.solver_wall,
             solver_wall_per_epoch_s=out.solver_wall / out.n_epochs,
             n_solves=out.n_solves, n_candidates=out.n_candidates,
             n_pruned=out.n_pruned, n_reconfigs=out.n_reconfigs,
             kernel_launches=launched)
        return launched

    d = serve("fleet")
    check(d["fleet_lb"] > 0, "fleet serve launched no fleet_lb")
    d = serve("matching", topology="matching",
              cluster_topology=Topology(reach=np.ones((8, 2), bool), degree=1,
                                        delta=0.5))
    check(d["fleet_lb_masked"] > 0, "matching serve launched no masked kernel")

    main_launches = dict(cpm.launches)
    emit("main_path", seconds=time.perf_counter() - t_main,
         launches=main_launches)
    for name in ("fleet_lb", "fleet_lb_masked"):
        check(main_launches[name] > 0, f"main path never launched {name}")

    # -- 4. where the device time goes (after the main-path counts) ----------
    # The offline fleet and the first PROFILE_JOBS jobs of the serving
    # stream again under torch.profiler: device time by kernel name, the
    # device's busy share of the unprofiled wall time of the same work, and
    # the kernel count. (A full 200-job serve records too many events.)
    profile_run("offline_fleet", lambda: schedule_fleet(insts), fleet_wall)
    short = stream[:PROFILE_JOBS]

    def serve_short():
        return OnlineScheduler(8, 2, window=5.0, seed=0).serve(short)

    torch.cuda.synchronize()
    t = time.perf_counter()
    serve_short()
    torch.cuda.synchronize()
    profile_run(f"serve_{PROFILE_JOBS}_jobs", serve_short, time.perf_counter() - t)

    for name in table:
        table[name].update(launches=main_launches[name], max_abs_err=max_err[name],
                           library_ms=None)

    # -- 5. the serving path: llama3.2-3b on the attention kernels ------------
    table.update(attention_kernels(np, torch))
    serve_launches = serving_phases(np, torch)
    for name in ("flash_attention", "decode_attention"):
        table[name]["launches"] = serve_launches[name]
    card_equals_cpu(np, torch)

    # -- 6. the paper's production scenario, exact optima as the oracle -------
    production_scenario(np, torch, stream[:PROFILE_JOBS])

    # -- 7. the expert, recurrent and cross-attention families ----------------
    family_phases(np, torch)

    # -- 8. the training path: llama3.2-3b trained at full width --------------
    table.update(training_kernels(np, torch))
    train_launches, kept8 = training_phases(np, torch)
    for name in ("flash_attention_lse",) + BWD_KERNELS:
        table[name]["launches"] = train_launches[name]
    _, kept8e = family_training(np, torch)

    # -- 9. the multi-device stack on the card's 1 x 1 mesh -------------------
    for name, err in mesh_phases(np, torch, kept8, kept8e).items():
        table[name]["max_abs_err"] = max(table[name]["max_abs_err"], err)
    del kept8, kept8e

    # -- 10. the dry run: fake tensors over a fake world ------------------------
    dry_run_phases(np, torch)

    kernels = [
        dict(name=name, route="cuda", source=SOURCE[name], replaces=REPLACES[name],
             **{k: table[name][k] for k in (
                 "launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
                 "bound_by", "library_ms")})
        for name in SOURCE
    ]
    emit("total", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
