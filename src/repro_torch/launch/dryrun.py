"""Multi-pod dry run: trace every (architecture x input shape) on the
production meshes and take roofline terms from the per-device op counts
(counterpart of ``repro.launch.dryrun``).

The JAX package lowers and compiles each cell on 512 forced host devices,
parses the per-partition HLO and prices it at TPU v5e rates. PyTorch has
no compile step: here each cell's step runs, eagerly, on fake tensors
(``FakeTensorMode``: shapes and dtypes, no data) over a fake world of 256
or 512 ranks (``launch.mesh.fake_world``), and
:func:`repro_torch.launch.op_analysis.analyze_ops` counts the ops rank 0
runs: the per-device FLOPs, HBM bytes and collective bytes. The kernels
are operators with fake implementations and FLOP formulas, so the trace
sees one op where the card launches one kernel. The peak memory per
device is the live local bytes of rank 0 over the same run
(``torch.distributed._tools.mem_tracker.MemTracker``): the parameters,
optimizer state or cache placed by the sharding tables, and every
activation and temporary while it lives. The training step updates its
state in place (AdamW) and the decode step writes its cache in place: the
port's counterpart of the reference's donated buffers. ``compile_s`` holds
the trace's seconds (the name is the reference's JSON field).

Nothing here runs on a card: the mesh is a ``"cpu"`` mesh, and a fake
tensor never reaches a kernel launch.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-3b --shape decode_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes --out dryrun.json
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
from typing import Any

import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs import ALIASES, ARCH_IDS, get_config
from repro_torch.distribution.sharding import (
    _axis_names,
    _mesh_shape,
    activation_rules,
    batch_sharding,
    cache_sharding,
    distribute,
    param_sharding,
    state_sharding,
)
from repro_torch.launch.mesh import fake_world, make_production_mesh
from repro_torch.launch.op_analysis import analyze_ops, in_planning, repeated
from repro_torch.models import ssm
from repro_torch.models.config import ModelConfig, layer_kinds
from repro_torch.models.layers import activation_sharding
from repro_torch.models.lm import build_model, count_params
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.steps import (
    build_prefill_step,
    build_serve_step,
    build_train_step,
    make_train_state,
)

__all__ = ["SHAPES", "LONG_OK_FAMILIES", "PEAK_FLOPS", "HBM_BW", "LINK_BW", "CellResult",
           "skip_reason", "input_specs", "model_flops_estimate", "trace_step", "run_cell",
           "main"]

# --------------------------------------------------------------------------
# Input-shape matrix (the reference's): seq_len x global_batch per shape id.
# --------------------------------------------------------------------------
SHAPES: dict[str, dict[str, Any]] = {
    "train_4k": {"kind": "train", "seq": 4096, "batch": 256},
    "prefill_32k": {"kind": "prefill", "seq": 32768, "batch": 32},
    "decode_32k": {"kind": "decode", "seq": 32768, "batch": 128},
    "long_500k": {"kind": "decode", "seq": 524288, "batch": 1},
}

# long_500k runs only for sub-quadratic-capable families (DESIGN.md §4).
LONG_OK_FAMILIES = ("ssm", "hybrid")

# Hardware constants (NVIDIA H100 SXM, per card; data sheet).
PEAK_FLOPS = 989e12   # dense bf16 on the tensor cores (chip_smoke.py's BF16_OPS_PER_S)
HBM_BW = 3.35e12      # bytes/s, HBM3
LINK_BW = 450e9       # bytes/s per direction a card, NVLink 4 (18 links x 25 GB/s)
# One rate for every collective: a 16 x 16 mesh of 8-card nodes crosses the
# network (InfiniBand, ~50 GB/s a card) on its outer axis, which one NVLink
# rate does not model.


def skip_reason(cfg: ModelConfig, shape: str) -> str | None:
    if shape == "long_500k" and cfg.family not in LONG_OK_FAMILIES:
        return f"full-attention family '{cfg.family}' is quadratic at 500k (DESIGN.md §4)"
    return None


# --------------------------------------------------------------------------
# input_specs: (shape, dtype) stand-ins for every model input.
# --------------------------------------------------------------------------

def input_specs(cfg: ModelConfig, shape_id: str) -> dict[str, tuple[tuple[int, ...], torch.dtype]]:
    info = SHAPES[shape_id]
    return _specs(cfg, info["kind"], info["batch"], info["seq"])


def _specs(cfg: ModelConfig, kind: str, B: int, S: int) -> dict:
    batch: dict[str, tuple[tuple[int, ...], torch.dtype]] = {}
    if kind in ("train",):
        batch["tokens"] = ((B, S), torch.int32)
        batch["labels"] = ((B, S), torch.int32)
    elif kind == "prefill":
        batch["tokens"] = ((B, S), torch.int32)
    if cfg.n_enc_layers or cfg.cross_attn_every:
        T = S if cfg.n_enc_layers else cfg.n_patches
        if kind != "decode":
            batch["memory"] = ((B, T, cfg.d_model), torch.float32)
    return batch


def _micro(cfg: ModelConfig, mesh, global_batch: int) -> int:
    """Microbatch count: 1 batch row per device per microbatch for big
    models, up to 4 rows for small ones."""
    shape = _mesh_shape(mesh)
    dp = 1
    for a in ("pod", "data"):
        if a in _axis_names(mesh):
            dp *= shape[a]
    rows = 1 if cfg.d_model >= 4096 else 4
    n = max(1, global_batch // (dp * rows))
    while global_batch % n or (global_batch // n) % dp:
        n -= 1
    return max(n, 1)


# --------------------------------------------------------------------------
# Roofline extraction
# --------------------------------------------------------------------------

@dataclasses.dataclass
class CellResult:
    arch: str
    shape: str
    mesh: str
    ok: bool
    skip: str | None = None
    error: str | None = None
    flops: float = 0.0
    bytes_accessed: float = 0.0
    coll_bytes: dict[str, float] = dataclasses.field(default_factory=dict)
    peak_memory_per_device: float = 0.0
    model_flops: float = 0.0
    n_params: float = 0.0
    n_active_params: float = 0.0
    compile_s: float = 0.0
    terms: dict[str, float] = dataclasses.field(default_factory=dict)

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def model_flops_estimate(cfg: ModelConfig, n_params: float, kind: str,
                         batch: int, seq: int) -> float:
    """6·N_active·D (train) or 2·N_active·D (inference)."""
    n_active = n_params
    if cfg.n_experts:
        kinds = layer_kinds(cfg)
        moe_layers = sum(1 for _, f in kinds if f == "moe")
        per_expert = 3 * cfg.d_model * cfg.d_ff
        n_active = n_params - moe_layers * (
            (cfg.n_experts - cfg.experts_per_token) * per_expert
        )
    tokens = batch * seq if kind != "decode" else batch  # one token per decode
    mult = 6.0 if kind == "train" else 2.0
    return mult * n_active * tokens


def _local_tensors(tree: Any) -> list[torch.Tensor]:
    """This rank's storage of every tensor leaf of ``tree`` (a DTensor's
    local shard)."""
    if isinstance(tree, torch.Tensor):
        return [tree.to_local() if isinstance(tree, DTensor) else tree]
    if dataclasses.is_dataclass(tree):
        tree = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    elif isinstance(tree, dict):
        tree = list(tree.values())
    elif not isinstance(tree, (tuple, list)):
        return []
    return [t for sub in tree for t in _local_tensors(sub)]


def _rank_memory():
    """A ``MemTracker`` of this rank's local tensors only: a DTensor op is
    left to DTensor (its local ops come back), and DTensor's planning (its
    shape inference on tensors of the global shapes, under a fake mode of
    its own) is not tracked; the tracker's own checks do both in later
    versions of torch only."""
    from torch.distributed._tools.mem_tracker import MemTracker

    class RankMemory(MemTracker):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            if in_planning():
                return func(*args, **(kwargs or {}))
            return super().__torch_dispatch__(func, types, args, kwargs)

    return RankMemory()


class _TracedScan(torch.autograd.Function):
    """``models.ssm._slstm_scan`` for a trace on fake tensors, which hold
    no data: every step of the time loop runs the same ops on tensors of
    the same shapes, so one step is traced and counted S times
    (``op_analysis.repeated``), forward and backward: the counts of running
    all S steps, without ~10 ms of host time a step (70 minutes for one
    xlstm-350m prefill cell). The backward counts one step's gradient with
    respect to the weights and the gate inputs S times, and with respect
    to its incoming carry S - 1 times (the first step's carry is a
    constant), as the loop's backward does: the same FLOPs; the HBM bytes
    of the gradient's shared elementwise ops are counted for both parts.
    A step's gradient of its slice of the gate inputs is a full [B, S, 4d]
    tensor (a slice's backward), and autograd sums the S of them: S - 1
    adds of that size, counted so.

    Where autograd records the loop (``record``: a training step), what
    its S steps save for the backward is one saved tensor of S times the
    bytes a step saves (those of its tensors that are not the loop's
    inputs), so that the peak memory holds it where the loop's would be
    live. The loop's backward frees it step by step; the trace frees it
    when its backward ends."""

    @staticmethod
    def forward(ctx, keys, record, gx, *ws):
        S, d = gx.shape[1], gx.shape[-1] // 4
        with repeated(S):
            carry, h = ssm._slstm_cell(dict(zip(keys, ws)), d, gx[:, 0], ssm._zero_carry(gx))
        ctx.keys = keys
        steps_saved = torch.empty((S * _step_saved_bytes(keys, gx, ws) if record else 0,),
                                  dtype=torch.uint8, device=gx.device)
        # Saved as the loop's saved tensors are: a recompute (remat) drops
        # it after the forward and makes it again for the backward.
        ctx.save_for_backward(gx, *ws, steps_saved)
        return (torch.stack([h] * S, dim=1), *carry)

    @staticmethod
    def backward(ctx, dhs, *dcarry):
        gx, *ws, _ = ctx.saved_tensors
        S, d = gx.shape[1], gx.shape[-1] // 4
        with torch.enable_grad():
            gx = gx.detach().requires_grad_()
            ws = [w.detach().requires_grad_() for w in ws]
            carry = [t.requires_grad_() for t in ssm._zero_carry(gx)]
            with repeated(0):  # the loop's backward reads saved values, recomputes nothing
                new, h = ssm._slstm_cell(dict(zip(ctx.keys, ws)), d, gx[:, 0], tuple(carry))
            outs, douts = (h, *new[:3]), (dhs[:, 0], *(torch.zeros_like(t) for t in new[:3]))
            with repeated(S):
                grads = torch.autograd.grad(outs, (gx, *ws), douts, retain_graph=True)
            # Every step but the first passes a gradient to its incoming carry,
            # and autograd sums the steps' gradients of the gate inputs, each
            # of their full size (a slice's backward), into one.
            with repeated(S - 1):
                torch.autograd.grad(outs, carry, douts, allow_unused=True)
                torch.add(grads[0], grads[0])
        return (None, None, *grads)


def _step_saved_bytes(keys, gx, ws) -> int:
    """The bytes that a step of the sLSTM's time loop adds to what the
    loop saves for its backward: two steps and one step run under autograd,
    uncounted, each from a carry that needs a gradient (as a step's after
    the first), and the storages of the tensors they save summed, but those
    of the loop's inputs (the weights, the gate inputs); the difference is
    a step's (a carry leaf that two steps save is counted once)."""
    from torch.multiprocessing.reductions import StorageWeakRef

    def saved_by(n: int) -> int:
        saved: dict = {}

        def pack(t):  # keeps no tensor: an output saved by its own op would hold its graph
            saved[StorageWeakRef(t.untyped_storage())] = t.untyped_storage().nbytes()

        with torch.enable_grad(), repeated(0), \
                torch.autograd.graph.saved_tensors_hooks(pack, lambda _: None):
            x = gx.detach().requires_grad_()
            w = [t.detach().requires_grad_() for t in ws]
            carry = tuple(t.requires_grad_() for t in ssm._zero_carry(x))
            for t in range(n):
                carry, _ = ssm._slstm_cell(dict(zip(keys, w)), x.shape[-1] // 4, x[:, t], carry)
        inputs = {StorageWeakRef(t.untyped_storage()) for t in (x, *w)}
        return sum(b for ref, b in saved.items() if ref not in inputs)

    return saved_by(2) - saved_by(1) if gx.shape[1] > 1 else saved_by(1)


def _traced_slstm_scan(wh, gx):
    keys = tuple(sorted(wh))
    record = torch.is_grad_enabled() and (
        gx.requires_grad or any(w.requires_grad for w in wh.values()))
    hs, *carry = _TracedScan.apply(keys, record, gx, *(wh[k] for k in keys))
    return hs, tuple(carry)


@contextlib.contextmanager
def traced_loops():
    """The model's time loops traced one step and counted as all of them
    (:class:`_TracedScan` in place of ``models.ssm._slstm_scan``) while this
    runs: for a trace on fake tensors only, whose values nothing reads."""
    real = ssm._slstm_scan
    ssm._slstm_scan = _traced_slstm_scan
    try:
        yield
    finally:
        ssm._slstm_scan = real


def _trace(step, held: Any, *args) -> tuple:
    """(OpCost, peak live local bytes) of ``step(*args)`` with ``held`` (the
    placed state, parameters or cache) live from the start."""
    mt = _rank_memory()
    mt.track_external(*_local_tensors(held))
    with mt, traced_loops():
        cost, _ = analyze_ops(step, *args)
    peak = sum(snap["Total"] for snap in mt.get_tracker_snapshot("peak").values())
    return cost, float(peak)


def trace_step(model, kind: str, B: int, S: int, mesh, n_micro: int | None = None,
               cast_params_bf16: bool = False, pos: int = 0,
               param_dtype: torch.dtype = torch.float32) -> tuple:
    """(OpCost, peak live local bytes, parameter count) of one ``kind``
    step ("train", "prefill" or "decode") of ``model`` at batch ``B`` and
    sequence ``S`` on ``mesh`` (a ``"cpu"`` mesh of a fake world), traced
    on fake tensors on this rank, as the reference lowers its cells
    (``dryrun.py:180-234``): train with ``n_micro`` micro-batches (the
    reference's ``_micro`` when None) and the state placed by
    ``state_sharding``; prefill with the parameters placed by
    ``param_sharding``; decode with the cache (``init_cache(B, S)``) placed
    by ``cache_sharding`` at position ``pos`` and the token by
    ``batch_sharding``. The parameters of prefill and decode are
    ``param_dtype`` (float32 as the reference's; bf16 to trace the card's
    serving step), the training state float32; the step runs under
    ``activation_sharding`` of the mesh's rules."""
    from torch._subclasses.fake_tensor import FakeTensorMode, unset_fake_temporarily

    cfg = model.cfg
    # Real host scalars (the optimizer's step counter) may meet fake tensors:
    # the fake mode then carries their values (its constant propagation), so
    # the host still reads the step, as the card's run does.
    with FakeTensorMode(allow_non_fake_inputs=True), activation_sharding(activation_rules(mesh)):
        params = model.init(0, device="cpu", dtype=param_dtype)
        n_params = float(count_params(params))
        batch = {k: torch.empty(shape, dtype=dtype)
                 for k, (shape, dtype) in _specs(cfg, kind, B, S).items()}
        batch = distribute(batch, batch_sharding(batch, mesh))
        if kind == "train":
            step = build_train_step(model, AdamWConfig(),
                                    n_micro=n_micro or _micro(cfg, mesh, B),
                                    cast_params_bf16=cast_params_bf16)
            del params
            state = make_train_state(model, 0, device="cpu")
            with unset_fake_temporarily():
                state.opt["step"] = torch.zeros((), dtype=torch.int32)
            state = distribute(state, state_sharding(state, mesh))
            cost, peak = _trace(step, state, state, batch)
        elif kind == "prefill":
            params = distribute(params, param_sharding(params, mesh))
            cost, peak = _trace(build_prefill_step(model), params, params, batch)
        else:
            memory = None
            if cfg.n_enc_layers or cfg.cross_attn_every:
                T = S if cfg.n_enc_layers else cfg.n_patches
                memory = torch.empty((B, T, cfg.d_model), dtype=torch.float32)
            cache = dict(model.init_cache(B, S, device="cpu", memory=memory), pos=pos)
            cache = distribute(cache, cache_sharding(cache, mesh))
            token = torch.empty((B,), dtype=torch.int32)
            token = distribute(token, batch_sharding(token, mesh))
            params = distribute(params, param_sharding(params, mesh))
            cost, peak = _trace(build_serve_step(model), (params, cache), params, cache, token)
    return cost, peak, n_params


def _mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def run_cell(arch: str, shape_id: str, multi_pod: bool) -> CellResult:
    """One cell, traced on rank 0 of a fake world of 256 (``16x16``) or 512
    (``2x16x16``) ranks; the world is started here if this process has
    none (a process holds one world, so :func:`main` runs the cells of
    several archs or meshes in child processes, one an (arch, mesh))."""
    cfg = get_config(arch)
    res = CellResult(arch=arch, shape=shape_id, mesh=_mesh_name(multi_pod), ok=False)
    reason = skip_reason(cfg, shape_id)
    if reason:
        res.skip = reason
        res.ok = True
        return res

    info = SHAPES[shape_id]
    B, S = info["batch"], info["seq"]
    t0 = time.perf_counter()
    fake_world(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    cost, peak, n_params = trace_step(
        build_model(cfg), info["kind"], B, S, mesh,
        n_micro=int(os.environ.get("REPRO_NMICRO", 0)) or None,
        cast_params_bf16=os.environ.get("REPRO_CAST_BF16", "0") == "1")
    res.n_params = n_params
    res.model_flops = model_flops_estimate(cfg, n_params, info["kind"], B, S)
    res.compile_s = time.perf_counter() - t0
    res.flops = cost.flops
    res.bytes_accessed = cost.hbm_bytes
    res.coll_bytes = dict(cost.collective_bytes)
    res.peak_memory_per_device = peak

    chips = 512 if multi_pod else 256
    total_coll = sum(res.coll_bytes.values())
    # Counts are per device (rank 0's local ops), so divide by per-card rates.
    res.terms = {
        "compute_s": res.flops / PEAK_FLOPS,
        "memory_s": res.bytes_accessed / HBM_BW,
        "collective_s": total_coll / LINK_BW,
        "useful_flops_ratio": (
            (res.model_flops / chips) / res.flops if res.flops else 0.0
        ),
    }
    res.ok = True
    return res


# Child processes of a run over several archs or meshes at once: each traces
# on one core and holds no data, and two cores are left to the rest.
MAX_CHILDREN = max(1, (os.cpu_count() or 3) - 2)


def _status(r: CellResult) -> str:
    status = "SKIP" if r.skip else ("OK" if r.ok else "FAIL")
    return (
        f"[{status}] {r.arch:22s} {r.shape:12s} {r.mesh:8s} "
        f"flops={r.flops:.3e} bytes={r.bytes_accessed:.3e} "
        f"coll={sum(r.coll_bytes.values()):.3e} mem/dev={r.peak_memory_per_device/2**30:.2f}GiB "
        f"compile={r.compile_s:.1f}s"
        + (f" err={r.error}" if r.error else "")
        + (f" skip={r.skip}" if r.skip else "")
    )


def _run_cells(cells: list[tuple[str, str, bool]]) -> list[CellResult]:
    results = []
    for a, s, mp in cells:
        try:
            r = run_cell(a, s, mp)
        except Exception as e:  # noqa: BLE001 — report, keep going
            r = CellResult(arch=a, shape=s, mesh=_mesh_name(mp), ok=False,
                           error=f"{type(e).__name__}: {e}")
        results.append(r)
        print(_status(r), flush=True)
    return results


def _trace_work(arch: str) -> int:
    cfg = get_config(arch)
    return cfg.n_layers * (4 if cfg.d_model >= 4096 else 1)


def _run_children(cells: list[tuple[str, str, bool]]) -> list[CellResult]:
    """``cells`` in child processes, one an (arch, mesh) (a process holds one
    fake world, of one size), at most ``MAX_CHILDREN`` at once, the longest
    first (a training cell's trace grows with the layers and the
    micro-batches, 4x as many for d_model >= 4096: ``_micro``); their
    status lines pass through as they come, the results return in the
    order of ``cells``."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    groups: dict[tuple, list] = {}
    for c in cells:
        groups.setdefault((c[0], c[2]), []).append(c)
    order = sorted(groups.values(), key=lambda g: -_trace_work(g[0][0]))
    with ProcessPoolExecutor(max_workers=MAX_CHILDREN, max_tasks_per_child=1,
                             mp_context=multiprocessing.get_context("spawn")) as pool:
        futures = [(group, pool.submit(_run_cells, group)) for group in order]
        done = {}
        for group, future in futures:
            try:
                done.update(zip(group, future.result()))
            except Exception as e:  # noqa: BLE001 — a child that died fails its cells
                done.update((c, CellResult(arch=c[0], shape=c[1], mesh=_mesh_name(c[2]),
                                           ok=False, error=f"{type(e).__name__}: {e}"))
                            for c in group)
    return [done[c] for c in cells]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None, choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", type=str, default=None)
    args = ap.parse_args()

    archs = ARCH_IDS if (args.all or args.arch is None) else [ALIASES.get(args.arch, args.arch).replace("-", "_").replace(".", "_")]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    meshes = [False, True] if (args.both_meshes or args.all) else [args.multi_pod]

    cells = [(a, s, mp) for mp in meshes for a in archs for s in shapes]
    if len(meshes) == 1 and len(archs) == 1:
        results = _run_cells(cells)
    else:
        results = _run_children(cells)
    if args.out:
        with open(args.out, "w") as f:
            json.dump([r.to_json() for r in results], f, indent=1)
    nfail = sum(1 for r in results if not r.ok)
    print(f"\n{len(results) - nfail}/{len(results)} cells passed")
    raise SystemExit(1 if nfail else 0)


if __name__ == "__main__":
    main()
