"""Three repairs of what a rank holds under a mesh, each held bit for bit
(``torch.equal``) against the route it replaces, on the CPU.

* The sLSTM time loop (``models/ssm.py::_slstm_scan``) takes its steps'
  gate inputs from one ``unbind``: its output and gradients equal a loop
  that slices ``gx[:, t]`` every step (written out here), whose backward
  summed S full-size [B, S, 4d] gradients.
* A stacked leaf's gradient (``models/lm.py::_placed_grads``): each
  repeat's slice of it is redistributed to the slice's placement as it
  arrives, before ``unbind``'s backward stacks the repeats. On a (2, 2)
  mesh the gradients equal the route with only ``accumulate_grads``'s
  leaf-level hook, every stacked leaf's gradient reaches that hook
  already placed (it arrives ``Partial`` without the repair), no
  full-size ``Partial`` slice gradient is alive by the time the next
  slice's is placed, and the rank's peak memory over the backward
  (``MemTracker``) falls.
* The MoE dispatch (``models/moe.py::_sharded_moe``): a rank scatters only
  its own experts' pairs into an [E/m, C, d] buffer and sums the pairs'
  output rows over 'model'. ``_old_sharded_moe`` below is the route it
  replaces, written out (a full [E, C, d] ``Partial`` buffer on every
  rank, the expert output gathered back to full size). On a (2, 2) mesh,
  with and without dropped pairs: the local shards of the expert FFN's
  input and output, the layer's output and aux loss, and its VJP (the
  input's and every weight's gradient, in the parameter's placement) are
  equal; the dispatch's peak local bytes are at most 1/m of the full
  buffer plus the [TK, d] rows and the slot tables ([TK, E] and [TK]
  integers), where the old dispatch's held the full buffer.

The ranks are 4 ``gloo`` processes started by ``tests/test_torch_mesh.py``'s
``_spawn``; one job runs every mesh case and writes its findings.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from test_torch_mesh import TIMEOUT, _spawn

D_MODEL, D_FF = 64, 128
MOE_CASES = {  # name: (experts, top k, capacity factor)
    "no_drop": (4, 2, 8.0),
    "drops": (4, 2, 1.0),
    "drops_k3": (8, 3, 0.5),
}
GRAD_ARCHS = ("llama3_2_3b", "seamless_m4t_medium")  # the encoder's stack too


# --------------------------------------------------------------------------
# The routes replaced, written out
# --------------------------------------------------------------------------
def _sliced_slstm_scan(wh, gx):
    """The sLSTM loop as it was: a slice ``gx[:, t]`` a step."""
    from repro_torch.models import ssm

    S, d = gx.shape[1], gx.shape[-1] // 4
    carry = ssm._zero_carry(gx)
    hs = []
    for t in range(S):
        carry, h_t = ssm._slstm_cell(wh, d, gx[:, t], carry)
        hs.append(h_t)
    return torch.stack(hs, dim=1), carry


def _old_dispatch(xf, expert_idx, n_experts, cap, offset=None):
    T, d = xf.shape
    top_k = expert_idx.shape[-1]
    flat_expert = expert_idx.reshape(T * top_k)
    onehot = F.one_hot(flat_expert, n_experts)
    pos_all = onehot.cumsum(dim=0) - 1
    if offset is not None:
        pos_all = pos_all + offset
    pos = pos_all.gather(1, flat_expert[:, None])[:, 0]
    keep = pos < cap
    pos_c = torch.where(keep, pos, torch.zeros_like(pos))
    token_of_pair = torch.arange(T * top_k, device=xf.device) // top_k
    gathered = torch.where(keep[:, None], xf[token_of_pair], torch.zeros((), dtype=xf.dtype,
                                                                         device=xf.device))
    expert_in = torch.zeros((n_experts, cap, d), dtype=xf.dtype, device=xf.device)
    expert_in.index_put_((flat_expert, pos_c), gathered, accumulate=True)
    return flat_expert, pos_c, keep, expert_in


def _old_experts(params, expert_in, dtype):
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.models.layers import shard

    wi, wg, wo = (params[k].to(dtype) for k in ("wi", "wg", "wo"))
    if isinstance(expert_in, DTensor):
        mesh = expert_in.device_mesh
        pl = [Replicate() if p.is_partial() else p for p in expert_in.placements]
        expert_in = expert_in.redistribute(mesh, pl)
        wi, wg, wo = (w.redistribute(mesh, pl) for w in (wi, wg, wo))
    h = F.silu(torch.bmm(expert_in, wg)) * torch.bmm(expert_in, wi)
    h = shard(h, "act_expert_ffn")
    return torch.bmm(h, wo)


def _old_combine(expert_out, flat_expert, pos_c, keep, gate_vals, T, d):
    top_k = gate_vals.shape[-1]
    out_pairs = expert_out[flat_expert, pos_c]
    dt = expert_out.dtype
    out_pairs = out_pairs * (gate_vals.reshape(T * top_k, 1).to(dt) * keep[:, None].to(dt))
    return out_pairs.reshape(T, top_k, d).sum(dim=1)


def _old_sharded_moe(params, x, n_experts, top_k, capacity_factor, normalize, seen):
    """The MoE dispatch under a mesh before the repair; ``seen`` receives
    the expert FFN's input and output."""
    from torch.distributed.tensor import DTensor

    from repro_torch.distribution.sharding import shard_index
    from repro_torch.models.layers import local_placements, row_placements, shard, to_local
    from repro_torch.models.moe import _route, capacity

    mesh = x.device_mesh
    B, S, d = x.shape
    T = B * S
    rows = row_placements(x)
    full, part = local_placements(rows)
    xl = to_local(x, rows)
    Bl = xl.shape[0]
    xf = xl.reshape(Bl * S, d)
    probs, gate_vals, expert_idx = _route(xf, to_local(params["router"]["w"], full, part),
                                          top_k, normalize)
    me = DTensor.from_local(probs.sum(dim=0), mesh, part, run_check=False) / T
    ce = DTensor.from_local(F.one_hot(expert_idx, n_experts).to(torch.float32).sum(dim=(0, 1)),
                            mesh, part, run_check=False) / T
    aux = n_experts * (me * ce).sum()
    cap = capacity(T, top_k, n_experts, capacity_factor)
    counts = F.one_hot(expert_idx.reshape(-1), n_experts).sum(dim=0)
    offset = None
    if any(p.is_shard(0) for p in rows):
        every = DTensor.from_local(counts[None], mesh, rows, run_check=False).full_tensor()
        offset = every[:shard_index(mesh, rows, 0)].sum(dim=0)
    flat_expert, pos_c, keep, buf = _old_dispatch(xf, expert_idx, n_experts, cap, offset)
    expert_in = shard(DTensor.from_local(buf, mesh, part, run_check=False), "act_expert")
    expert_out = _old_experts(params, expert_in, x.dtype)
    seen.append((expert_in, expert_out))
    expert_out = to_local(expert_out, full, part)
    out = _old_combine(expert_out, flat_expert, pos_c, keep, gate_vals, Bl * S, d)
    return DTensor.from_local(out.reshape(Bl, S, d), mesh, rows, run_check=False), aux


# --------------------------------------------------------------------------
# One process
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_slstm_scan_equals_the_sliced_loop(dtype):
    from repro_torch.models import ssm

    B, S, d = 2, 24, 16
    rng = np.random.default_rng(3)
    w = torch.from_numpy(rng.standard_normal((d, 4 * d)).astype(np.float32) / 4)
    gx = torch.from_numpy(rng.standard_normal((B, S, 4 * d)).astype(np.float32)).to(dtype)
    dh = torch.from_numpy(rng.standard_normal((B, S, d)).astype(np.float32)).to(dtype)
    dc = torch.from_numpy(rng.standard_normal((B, d)).astype(np.float32))
    got = []
    for scan in (ssm._slstm_scan, _sliced_slstm_scan):
        wl, gl = w.clone().requires_grad_(), gx.clone().requires_grad_()
        hs, carry = scan({"w": wl}, gl)
        torch.autograd.backward((hs, carry[0]), (dh, dc))
        got.append((hs, *carry, wl.grad, gl.grad))
    for a, b in zip(*got):
        assert torch.equal(a, b)


# --------------------------------------------------------------------------
# Ranks
# --------------------------------------------------------------------------
def _equal_local(a, b) -> bool:
    from torch.distributed.tensor import DTensor

    a, b = (t.to_local() if isinstance(t, DTensor) else t for t in (a, b))
    return a.shape == b.shape and torch.equal(a, b)


def _placed_like(g, t):
    """``g`` in ``t``'s placements (the leaf hook's reduction)."""
    return g.redistribute(t.device_mesh, t.placements)


def _moe_case(name: str, mesh) -> dict:
    """New and old routes of one MoE layer on the (2, 2) mesh, forward and
    VJP, and the new dispatch's peak local bytes."""
    from torch.distributed._tools.mem_tracker import MemTracker

    from repro_torch.distribution import sharding as S
    from repro_torch.models import moe
    from repro_torch.models.layers import activation_sharding

    E, k, cf = MOE_CASES[name]
    gen = torch.Generator().manual_seed(0)
    tree = {"ffn": {"moe": moe.init_moe(gen, D_MODEL, D_FF, E)}}
    params = S.distribute(tree, S.param_sharding(tree, mesh))["ffn"]["moe"]
    leaves = [params["router"]["w"], params["wi"], params["wg"], params["wo"]]
    for t in leaves:
        t.requires_grad_()
    rng = np.random.default_rng(1)
    B, Sq = 4, 16
    x_full = torch.from_numpy(rng.standard_normal((B, Sq, D_MODEL)).astype(np.float32))
    g_full = torch.from_numpy(rng.standard_normal((B, Sq, D_MODEL)).astype(np.float32))
    act = S.NamedSharding(mesh, S.PartitionSpec("data", None, "model"))
    x = S.distribute({"x": x_full}, {"x": act})["x"].requires_grad_()
    g_out = S.distribute({"g": g_full}, {"g": act})["g"]
    rules = S.activation_rules(mesh)

    seen, runs = [], {}
    experts = moe._experts

    def recorded(p, expert_in, dtype):
        out = experts(p, expert_in, dtype)
        seen.append((expert_in, out))
        return out

    drops = []
    dispatch = moe._dispatch

    def counted(*args, **kw):
        out = dispatch(*args, **kw)
        drops.append(int((~out[2]).sum()))
        return out

    for route in ("new", "old"):
        seen.clear()
        with activation_sharding(rules):
            if route == "new":
                moe._experts, moe._dispatch = recorded, counted
                try:
                    out, aux = moe.moe_ffn(params, x, E, k, cf)
                finally:
                    moe._experts, moe._dispatch = experts, dispatch
            else:
                out, aux = _old_sharded_moe(params, x, E, k, cf, True, seen)
            out = out.redistribute(mesh, act.placements)
            grads = torch.autograd.grad((out, aux), [x, *leaves],
                                        (g_out, torch.ones_like(aux) * 0.25))
        (e_in, e_out), = seen
        runs[route] = [e_in, e_out, out, aux.full_tensor()] + [
            _placed_like(g, t) for g, t in zip(grads, [x, *leaves])]
    names = ["expert_in", "expert_out", "out", "aux", "dx", "d_router", "d_wi", "d_wg", "d_wo"]
    res = {n: _equal_local(a, b) for n, a, b in zip(names, runs["new"], runs["old"])}
    res["expert_in_local"] = list(runs["new"][0].to_local().shape)
    res["dropped"] = drops[0]

    # The dispatch's peak local bytes, the layer run without gradients, in
    # both routes.
    peaks = {}

    def tracked(route, fn):
        def run(*args, **kw):
            mt = MemTracker()
            with mt:
                out = fn(*args, **kw)
            peaks[route] = sum(s["Total"] for s in mt.get_tracker_snapshot("peak").values())
            return out
        return run

    global _old_dispatch
    old_dispatch = _old_dispatch
    moe._dispatch, _old_dispatch = tracked("new", dispatch), tracked("old", old_dispatch)
    try:
        with activation_sharding(rules), torch.no_grad():
            moe.moe_ffn(params, x, E, k, cf)
            _old_sharded_moe(params, x, E, k, cf, True, [])
    finally:
        moe._dispatch, _old_dispatch = dispatch, old_dispatch
    T = B * Sq
    cap = moe.capacity(T, k, E, cf)
    TK = (T // mesh.size(0)) * k
    res["full_buffer"] = E * cap * D_MODEL * 4
    res["peak"], res["old_peak"] = peaks["new"], peaks["old"]
    # 1/m of the buffer, the [TK, d] rows, three [TK, E] int64 slot tables
    # and eight [TK] index vectors.
    res["bar"] = res["full_buffer"] // mesh.size(1) + TK * (D_MODEL * 4 + 3 * E * 8 + 8 * 8)
    return res


def _grad_case(arch: str, mesh) -> dict:
    """A smoke model's gradients on the (2, 2) mesh through
    ``accumulate_grads``, with the slice hooks and without them."""
    from repro_torch.checkpoint.ckpt import flatten_with_paths
    from repro_torch.configs import smoke_config
    from repro_torch.distribution import sharding as S
    from repro_torch.models import layers, lm
    from repro_torch.models.layers import activation_sharding
    from repro_torch.optim import grad as grad_mod

    cfg = smoke_config(arch)
    model = lm.build_model(cfg, compute_dtype=torch.float32)
    full = model.init(0, device="cpu")
    paths = [p for p, _ in flatten_with_paths(full)]
    rng = np.random.default_rng(0)
    mbs = []
    for _ in range(2):
        b = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 32)).astype(np.int32))
             for k in ("tokens", "labels")}
        if cfg.n_enc_layers:
            b["memory"] = torch.from_numpy(
                rng.standard_normal((4, 32, cfg.d_model)).astype(np.float32))
        mbs.append(b)
    rules = S.activation_rules(mesh)

    out = {}
    placed_grads, placed_like, backward = lm._placed_grads, grad_mod._placed_like, \
        layers._PlacedGrad.backward
    for route in ("hooked", "leaf_only"):
        arrived, partial_in, left = set(), [0], [0]

        def watched(t):
            hook, i = placed_like(t), index[id(t)]

            def h(g):
                if tuple(g.placements) != tuple(t.placements):
                    arrived.add(paths[i])
                return hook(g)
            return h

        def slice_backward(ctx, g):
            partial_in[0] += any(p.is_partial() for p in g.placements)
            got = backward(ctx, g)
            left[0] += tuple(got[0].placements) != ctx.placements
            return got

        with activation_sharding(rules):
            params = S.distribute(full, S.param_sharding(full, mesh))
            leaves = [t.requires_grad_() for _, t in flatten_with_paths(params)]
            index = {id(t): i for i, t in enumerate(leaves)}
            batches = [S.distribute(b, S.batch_sharding(b, mesh)) for b in mbs]
            grad_mod._placed_like = watched
            layers._PlacedGrad.backward = staticmethod(slice_backward)
            if route == "leaf_only":
                lm._placed_grads = lambda tree, seen: tree
            try:
                grad_mod.accumulate_grads(model.loss, params, batches)
            finally:
                lm._placed_grads, grad_mod._placed_like = placed_grads, placed_like
                layers._PlacedGrad.backward = backward
        out[route] = dict(grads=[t.grad.to_local().clone() for t in leaves],
                          unplaced=sorted(p for p in arrived if "['layers']" in p),
                          partial_in=partial_in[0], left_unplaced=left[0])
    h, o = out["hooked"], out["leaf_only"]
    return dict(
        equal=all(torch.equal(a, b) for a, b in zip(h["grads"], o["grads"])),
        n_leaves=len(h["grads"]),
        **{f"{r}_{k}": v for r in out for k, v in out[r].items() if k != "grads"})


def _job_memory(rank: int, world: int, d: Path) -> None:
    from torch.distributed.device_mesh import init_device_mesh

    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    res = {"moe": {n: _moe_case(n, mesh) for n in MOE_CASES},
           "grads": {a: _grad_case(a, mesh) for a in GRAD_ARCHS}}
    (d / f"memory_rank{rank}.json").write_text(json.dumps(res))


@pytest.fixture(scope="module")
def runs(tmp_path_factory) -> dict:
    """The 4 ranks' findings and, beside them, the fake-world trace."""
    import os
    import subprocess
    import sys

    from test_torch_mesh import SRC

    d = tmp_path_factory.mktemp("mesh_memory")
    env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"}
    fake = subprocess.Popen([sys.executable, "-c", _FAKE_TRACE], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        _spawn("memory", 4, d, module="test_torch_mesh_memory", timeout=TIMEOUT)
        stdout, stderr = fake.communicate(timeout=TIMEOUT)
    finally:
        if fake.poll() is None:
            fake.kill()
    assert fake.returncode == 0, stderr[-4000:]
    return dict(ranks=[json.loads((d / f"memory_rank{r}.json").read_text()) for r in range(4)],
                fake=json.loads(stdout.strip().splitlines()[-1]))


@pytest.fixture(scope="module")
def ranks(runs) -> list[dict]:
    return runs["ranks"]


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_dispatch_equals_the_full_buffer_route(ranks, case):
    E = MOE_CASES[case][0]
    for r in ranks:
        got = r["moe"][case]
        for name in ("expert_in", "expert_out", "out", "aux", "dx", "d_router", "d_wi", "d_wg",
                     "d_wo"):
            assert got[name], (case, name)
        assert got["expert_in_local"][0] == E // 2
    dropped = sum(r["moe"][case]["dropped"] for r in ranks)
    assert (dropped > 0) == (case != "no_drop"), dropped


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_dispatch_holds_its_own_experts_only(ranks, case):
    for r in ranks:
        got = r["moe"][case]
        assert got["peak"] <= got["bar"], (got["peak"], got["bar"])
        assert got["old_peak"] >= got["full_buffer"]
        if case == "no_drop":  # a buffer that outweighs the rows: the bar tells the routes apart
            assert got["bar"] < got["old_peak"], (got["bar"], got["old_peak"])


_FAKE_TRACE = """
import dataclasses, json, torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.device_mesh import DeviceMesh
from repro_torch.configs import smoke_config
from repro_torch.distribution import sharding as S
from repro_torch.launch.dryrun import _rank_memory
from repro_torch.launch.mesh import fake_world
from repro_torch.models import layers, lm
from repro_torch.models.layers import activation_sharding
from repro_torch.optim.grad import accumulate_grads

fake_world(4)
mesh = DeviceMesh("cpu", torch.arange(4).reshape(2, 2), mesh_dim_names=("data", "model"))
cfg = dataclasses.replace(smoke_config("llama3_2_3b"), n_layers=4, d_model=512, n_heads=8,
                          n_kv_heads=2, head_dim=64, d_ff=2048)
model = lm.build_model(cfg, compute_dtype=torch.float32)
out = {"arrived": 0}
hooked, backward = lm._placed_grads, layers._PlacedGrad.backward

def counted(ctx, g):  # the local bytes of each slice gradient as it comes
    out["arrived"] += g.to_local().numel() * g.element_size()
    return backward(ctx, g)

layers._PlacedGrad.backward = staticmethod(counted)
with FakeTensorMode(), activation_sharding(S.activation_rules(mesh)):
    params = model.init(0, device="cpu")
    params = S.distribute(params, S.param_sharding(params, mesh))
    leaves = [t.requires_grad_() for _, t in S.flatten_with_paths(params)]
    out["placed"] = sum(t.to_local().numel() * 4 for _, t in S.flatten_with_paths(params["layers"]))
    batch = {k: torch.empty((4, 32), dtype=torch.int32) for k in ("tokens", "labels")}
    batch = S.distribute(batch, S.batch_sharding(batch, mesh))
    for route in ("hooked", "leaf_only"):
        lm._placed_grads = hooked if route == "hooked" else (lambda tree, seen: tree)
        mem = _rank_memory()
        with mem:
            accumulate_grads(model.loss, params, [batch])
        out[route] = sum(s["Total"] for s in mem.get_tracker_snapshot("peak").values())
        for t in leaves:
            t.grad = None
print(json.dumps(out))
"""


def test_stacked_leaf_gradients_leave_the_peak_on_a_fake_world(runs):
    """A micro-batch's forward and backward through ``accumulate_grads``
    traced on a fake world of 4 ranks ((2, 2) mesh; the smoke llama
    widened to 4 layers of d 512, so that its stacked gradients outweigh
    its activations): with the slice hooks the rank's peak live bytes
    (``MemTracker`` over its local tensors) fall by at least half of what
    the slice gradients as they arrive (``Partial`` over 'data') exceed
    their placed shards: without the hooks all of them are alive at the
    stack, with them one repeat's at a time."""
    got = runs["fake"]
    saved = got["leaf_only"] - got["hooked"]
    assert saved >= 0.5 * (got["arrived"] - got["placed"]) > 0, got


@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_stacked_leaf_gradients_are_placed_before_the_stack(ranks, arch):
    for r in ranks:
        got = r["grads"][arch]
        assert got["equal"] and got["n_leaves"] > 0
        # Without the slice hooks the stacked leaves' gradients reach the
        # leaf hook as Partial sums; with them every one arrives placed.
        assert got["leaf_only_unplaced"] and not got["hooked_unplaced"], got
        # Each slice's gradient comes as a Partial sum and leaves its hook
        # in the slice's placements.
        assert got["hooked_partial_in"] > 0 and got["hooked_left_unplaced"] == 0
        assert got["leaf_only_partial_in"] == 0
