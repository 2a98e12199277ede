"""The expert, recurrent and cross-attention families trained under a mesh
on 4 CPU ranks, held against the JAX package's sharded step.

Each case runs two AdamW steps (float32 compute, batch 4 x 32, 2
micro-batches, the memory in the batch where the config has one) of a
smoke config on a (data 2, model 2) mesh of 4 ``gloo`` ranks, from the JAX
package's initial state (a checkpoint of it, which both packages read),
and holds the losses, grad norms and the gathered state against three
results: the port's one-process step, the JAX package's one-device step,
and its step under ``state_sharding``, ``batch_sharding`` and
``activation_rules`` on a (2, 2) ``Mesh`` of 4 forced host devices. The
machinery is ``tests/test_torch_mesh.py``'s: the ranks run this module's
``_job_families``, the JAX package runs in one subprocess
(``_JAX_REF``), and every case is computed once for the module.

Bars: ``tests/test_torch_train.py``'s ``STEP_BARS["float32"]`` (losses
within 1e-5 relative), except where ``tests/test_torch_train_families.py``
sets a family's bar (its module docstring: xlstm's parameters at
``XLSTM_PARAM_BAR``, 5e-5; jamba at ``JAMBA_LEAF_BAR``, 5% of each leaf's
largest entry), and except where the JAX package's own spread over the two
steps exceeds the bar: ``SPREAD_BARS``, the largest gap of three runs of
its one-device steps with the initial weights scaled by (1 + 1e-7 N(0, 1))
against the unscaled run (this file run as a script prints them:
``PYTHONPATH=src:tests JAX_PLATFORMS=cpu python
tests/test_torch_mesh_families.py``). xlstm's parameters move by up to
1.54e-4 there, its m by 4.2e-6, its v by 2.8e-7 and its grad norms by
5.2e-5 relative (the reference's own (2, 2)-mesh step lies 5.9e-5 from its
one-device step in the parameters, above ``XLSTM_PARAM_BAR``); vision's
parameters by 1.65e-5. jamba's second step is held against the spread of
the three references in the same run (:func:`_check_jamba`).

``moe_drops`` runs phi3.5-moe with the capacity factor lowered from the
smoke configs' 8 to 1, so that pairs are dropped: the pairs dropped in the
forward pass of the first micro-batch from the initial state are counted
on the mesh (from the port's dispatch) and in the JAX package (from its
own routing, beside its ``moe_ffn``), and must be equal and positive; the
two steps are then held at the bars above, which a pair dropped
differently would exceed.
"""

import dataclasses
import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_mesh import OPT, TIMEOUT, _max_err, _spawn, _start_jax_reference

CASES = {  # name: (arch, config overrides)
    "phi3_5_moe_42b": ("phi3_5_moe_42b", {}),
    "jamba_v0_1_52b": ("jamba_v0_1_52b", {}),
    "xlstm_350m": ("xlstm_350m", {}),
    "seamless_m4t_medium": ("seamless_m4t_medium", {}),
    "llama3_2_vision_11b": ("llama3_2_vision_11b", {}),
    "moe_drops": ("phi3_5_moe_42b", {"capacity_factor": 1.0}),
}
JOB_TIMEOUT = 3 * TIMEOUT  # every case of the module in one job
# The JAX package's own spread over the two steps where it exceeds
# STEP_BARS["float32"] (``_reference_spread``, printed by this file run as
# a script), rounded up: params, m, v absolute, grad norms relative.
SPREAD_BARS = {
    "xlstm_350m": {"params": 1.6e-4, "m": 4.3e-6, "v": 2.8e-7, "grad_norm": 5.3e-5},
    "llama3_2_vision_11b": {"params": 1.7e-5},
}
JAMBA_SPREAD_FACTOR = 2.0  # step 2 of jamba: the references' spread is itself one sample


def _cfg(name: str):
    from repro_torch.configs import smoke_config

    arch, over = CASES[name]
    return dataclasses.replace(smoke_config(arch), **over)


def _port_model(name: str):
    from repro_torch.models.lm import build_model

    return build_model(_cfg(name), compute_dtype=torch.float32)


def _batch(batches, i: int, rows: slice = slice(None)) -> dict:
    return {k: torch.from_numpy(batches[f"{k}{i}"][rows]) for k in ("tokens", "labels", "memory")
            if f"{k}{i}" in batches}


class _DropCounter:
    """Counts the pairs ``repro_torch.models.moe._dispatch`` drops while it
    is installed (a rank's own rows; ranks that repeat rows count them
    again)."""

    def __init__(self):
        from repro_torch.models import moe

        self.moe, self.dispatch, self.n = moe, moe._dispatch, 0

    def __enter__(self):
        def counted(*args, **kw):
            out = self.dispatch(*args, **kw)
            self.n += int((~out[2]).sum())
            return out

        self.moe._dispatch = counted
        return self

    def __exit__(self, *exc):
        self.moe._dispatch = self.dispatch


def _job_families(rank: int, world: int, d: Path) -> None:
    """Every case on a (2, 2) mesh: two steps from ``d/<case>/init``, the
    metrics and the gathered state to ``d/<case>/mesh22``; an MoE case also
    counts the pairs dropped in micro-batch 0's forward from the initial
    state (on the ranks of model index 0, which hold each row once)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.checkpoint import ckpt
    from repro_torch.distribution import sharding as S
    from repro_torch.models.layers import activation_sharding
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.steps import build_train_step, make_train_state

    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    for name in CASES:
        c = d / name
        model = _port_model(name)
        batches = np.load(c / "batches.npz")
        like = make_train_state(model, 1, device="cpu")
        like = S.distribute(like, S.state_sharding(like, mesh))
        state, _ = ckpt.restore(str(c / "init"), like)
        out = {}
        with activation_sharding(S.activation_rules(mesh)):
            if model.cfg.n_experts:
                mb = _batch(batches, 0, slice(0, 2))
                mb = S.distribute(mb, S.batch_sharding(mb, mesh))
                with _DropCounter() as count, torch.no_grad():
                    model.forward(state.params, mb["tokens"], mb.get("memory"))
                n = torch.tensor(count.n if mesh.get_local_rank("model") == 0 else 0)
                dist.all_reduce(n)
                out["dropped"] = int(n)
            step = build_train_step(model, AdamWConfig(**OPT), n_micro=2)
            metrics = []
            for i in range(2):
                b = _batch(batches, i)
                state, m = step(state, S.distribute(b, S.batch_sharding(b, mesh)))
                metrics.append({k: float(v) for k, v in m.items()})
        full = S.gather(state)
        if rank == 0:
            ckpt.save(str(c / "mesh22"), 2, full)
            (c / "mesh22.json").write_text(json.dumps(dict(metrics=metrics, **out)))


def _port_one_process(c: Path, name: str) -> None:
    """The port's two steps in this process from ``c/init``; the pairs
    dropped in micro-batch 0's forward for an MoE case."""
    from repro_torch.checkpoint import ckpt
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.steps import build_train_step, make_train_state

    model = _port_model(name)
    batches = np.load(c / "batches.npz")
    state, _ = ckpt.restore(str(c / "init"), make_train_state(model, 1, device="cpu"))
    out = {}
    if model.cfg.n_experts:
        mb = _batch(batches, 0, slice(0, 2))
        with _DropCounter() as count, torch.no_grad():
            model.forward(state.params, mb["tokens"], mb.get("memory"))
        out["dropped"] = count.n
    step = build_train_step(model, AdamWConfig(**OPT), n_micro=2)
    metrics = []
    for i in range(2):
        state, m = step(state, _batch(batches, i))
        metrics.append({k: float(v) for k, v in m.items()})
    ckpt.save(str(c / "one"), 2, state)
    (c / "one.json").write_text(json.dumps(dict(metrics=metrics, **out)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory) -> Path:
    """Every case's batches and initial checkpoint, then the 4 ranks, the
    JAX reference and the one-process port, all at once."""
    import jax
    import jax.numpy as jnp

    from repro.checkpoint import ckpt as j_ckpt
    from repro.configs import smoke_config as j_smoke_config
    from repro.models.lm import build_model as j_build_model
    from repro.runtime.steps import make_train_state as j_make_train_state

    d = tmp_path_factory.mktemp("families")
    for name in CASES:
        c = d / name
        c.mkdir()
        cfg = _cfg(name)
        rng = np.random.default_rng(0)
        arrays = {}
        for i in range(2):
            for k in ("tokens", "labels"):
                arrays[f"{k}{i}"] = rng.integers(0, cfg.vocab_size, (4, 32)).astype(np.int32)
            if cfg.n_enc_layers or cfg.cross_attn_every:
                T = 32 if cfg.n_enc_layers else cfg.n_patches
                arrays[f"memory{i}"] = rng.standard_normal((4, T, cfg.d_model)).astype(np.float32)
        np.savez(c / "batches.npz", **arrays)
        arch, over = CASES[name]
        jm = j_build_model(dataclasses.replace(j_smoke_config(arch), **over),
                           compute_dtype=jnp.float32)
        j_ckpt.save(str(c / "init"), 0,
                    jax.tree.map(np.asarray, j_make_train_state(jm, jax.random.PRNGKey(0))))
    ref = _start_jax_reference([[str(d / n), CASES[n][0], CASES[n][1]] for n in CASES], {})
    t0 = time.monotonic()
    try:
        _spawn("families", 4, d, module="test_torch_mesh_families", timeout=JOB_TIMEOUT)
        for name in CASES:
            _port_one_process(d / name, name)
        ref.wait(timeout=max(1.0, JOB_TIMEOUT - (time.monotonic() - t0)))
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    first = d / next(iter(CASES))
    assert ref.returncode == 0, (first / "jax_ref.log").read_text()[-4000:]
    return d


def _state_arrays(c: Path, name: str):
    """``c``'s checkpoint at step 2 as the port's TrainState arrays."""
    from repro_torch.checkpoint import ckpt
    from repro_torch.interop import train_state_to_arrays
    from repro_torch.runtime.steps import make_train_state

    state, _ = ckpt.restore(str(c), make_train_state(_port_model(name), 1, device="cpu"))
    return train_state_to_arrays(state)


def _norm_gap(got, want) -> float:
    """||got - want|| / ||want|| over all leaves of two trees together."""
    from repro_torch.optim.adamw import tree_leaves

    num = den = 0.0
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        w = np.asarray(w, np.float64)
        num += float(((np.asarray(g, np.float64) - w) ** 2).sum())
        den += float((w ** 2).sum())
    return (num / den) ** 0.5


def _jamba_parts(state, init) -> dict:
    """The parts of a jamba state after two steps that its gate reads: the
    update (params - init), m and v."""
    from repro_torch.optim.adamw import tree_leaves

    return {"update": [np.asarray(a, np.float64) - np.asarray(b, np.float64)
                       for a, b in zip(tree_leaves(state["params"]), tree_leaves(init["params"]))],
            "m": state["opt"]["m"], "v": state["opt"]["v"]}


@pytest.mark.parametrize("name", list(CASES))
def test_family_sharded_steps_match_one_process_and_the_reference_sharded_step(runs, name):
    """The (2, 2) mesh's two steps against the port's one-process steps,
    the JAX package's one-device steps and its (2, 2)-mesh steps: losses,
    grad norms and lr of each step, then params, m and v (jamba: see
    :func:`_check_jamba`); the pairs dropped, where the config routes."""
    from test_torch_train import STEP_BARS
    from test_torch_train_families import XLSTM_PARAM_BAR

    c = runs / name
    got = json.loads((c / "mesh22.json").read_text())
    got_state = _state_arrays(c / "mesh22", name)
    assert int(got_state["opt"]["step"]) == 2
    refs = {"one": json.loads((c / "one.json").read_text())["metrics"]}
    for ref in ("jax1", "jax22"):
        refs[ref] = json.loads((c / f"{ref}.json").read_text())
    states = {ref: _state_arrays(c / ref, name) for ref in refs}
    if name == "jamba_v0_1_52b":
        _check_jamba(c, name, got["metrics"], got_state, refs, states)
    else:
        p_bar, m_bar, v_bar, _, n_bar = STEP_BARS["float32"]
        if name == "xlstm_350m":
            p_bar = XLSTM_PARAM_BAR
        spread = SPREAD_BARS.get(CASES[name][0], {})
        p_bar = max(p_bar, spread.get("params", 0.0))
        m_bar = max(m_bar, spread.get("m", 0.0))
        v_bar = max(v_bar, spread.get("v", 0.0))
        n_bar = max(n_bar, spread.get("grad_norm", 0.0))
        for ref, want_m in refs.items():
            want = states[ref]
            for g, w in zip(got["metrics"], want_m):
                np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-5, err_msg=ref)
                np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], rtol=n_bar, err_msg=ref)
                assert g["lr"] == w["lr"], ref
            assert _max_err(got_state["params"], want["params"]) <= p_bar, ref
            assert _max_err(got_state["opt"]["m"], want["opt"]["m"]) <= m_bar, ref
            assert _max_err(got_state["opt"]["v"], want["opt"]["v"]) <= v_bar, ref

    if _cfg(name).n_experts:
        want = json.loads((c / "placement.json").read_text())["dropped"]
        one = json.loads((c / "one.json").read_text())["dropped"]
        assert got["dropped"] == want == one, (got["dropped"], want, one)
        if name == "moe_drops":
            assert want > 0
        else:  # the smoke configs' capacity factor of 8 drops nothing
            assert want == 0


def _check_jamba(c: Path, name: str, got_m, got_state, refs: dict, states: dict) -> None:
    """jamba's two steps. Step 1 is held as the other families' steps are,
    at ``test_torch_train_families.py``'s jamba bars (the loss at
    ``STEP_BARS``' 1e-5, the grad norm at ``JAMBA_LEAF_BAR``). Step 2 is
    not reproducible at those bars by the reference itself: Adam's first
    update moves every weight by about lr * sign(g), so an entry whose
    gradient differs in its last bits can move the other way, and jamba's
    stack amplifies that ~880x. The JAX package's one-device and (2,
    2)-mesh steps differ by 4.5% in step 2's grad norm and by 14.0% / 19.0%
    / 14.4% (the update / m / v, as a norm over the whole tree relative to
    the reference's) on the CPU. So step 2's loss is held at 1e-4, and its
    grad norm, update, m and v at the larger of ``JAMBA_LEAF_BAR`` and
    ``JAMBA_SPREAD_FACTOR`` times the largest spread between two of the
    three references in this run (``one``, ``jax1``, ``jax22``); both
    numbers are in the message."""
    from test_torch_train_families import JAMBA_LEAF_BAR

    from repro_torch.checkpoint import ckpt
    from repro_torch.interop import train_state_to_arrays
    from repro_torch.runtime.steps import make_train_state

    init, _ = ckpt.restore(str(c / "init"), make_train_state(_port_model(name), 1, device="cpu"))
    init = train_state_to_arrays(init)
    parts = {ref: _jamba_parts(st, init) for ref, st in states.items()}
    names = list(refs)
    pairs = [(a, b) for i, a in enumerate(names) for b in names[i + 1:]]

    def gn_gap(a, b):
        return abs(a[1]["grad_norm"] / b[1]["grad_norm"] - 1)

    spread = {k: max(_norm_gap(parts[a][k], parts[b][k]) for a, b in pairs) for k in parts["one"]}
    spread["grad_norm"] = max(gn_gap(refs[a], refs[b]) for a, b in pairs)
    bars = {k: max(JAMBA_LEAF_BAR, JAMBA_SPREAD_FACTOR * v) for k, v in spread.items()}
    mine = _jamba_parts(got_state, init)
    for ref, want_m in refs.items():
        for g, w in zip(got_m, want_m):
            assert g["lr"] == w["lr"], ref
        np.testing.assert_allclose(got_m[0]["loss"], want_m[0]["loss"], rtol=1e-5, err_msg=ref)
        np.testing.assert_allclose(got_m[0]["grad_norm"], want_m[0]["grad_norm"],
                                   rtol=JAMBA_LEAF_BAR, err_msg=ref)
        np.testing.assert_allclose(got_m[1]["loss"], want_m[1]["loss"], rtol=1e-4, err_msg=ref)
        gaps = {k: _norm_gap(mine[k], parts[ref][k]) for k in mine}
        gaps["grad_norm"] = gn_gap(got_m, want_m)
        for k, gap in gaps.items():
            assert gap <= bars[k], (ref, k, gap, "bar", bars[k], "spread", spread)


# --------------------------------------------------------------------------
# Each family's blocks under the mesh against the same block in one process
# --------------------------------------------------------------------------

BLOCKS = ("moe", "ssd", "mlstm", "slstm", "cross", "cross_token", "encoder")
BLOCK_BAR = 1e-4  # test_torch_train_families.py's per-block VJP bar, relative to each leaf


def _block(name: str):
    """(params, fn(params, x, memory), needs memory) of one block at smoke
    widths, drawn from a seeded generator: the MoE FFN at capacity 1 (pairs
    dropped), jamba's SSD, xlstm's mLSTM and sLSTM, a cross-attention layer
    (4 query heads over 1 KV head, 16 rows of memory), the same layer for
    one query token (its decode route, over a memory split over the
    batch) and an encoder layer."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import layers, moe, ssm
    from repro_torch.models.lm import _apply_ffn, _apply_mixer, _init_ffn, _init_mixer

    g = torch.Generator().manual_seed(0)
    jamba, xl = smoke_config("jamba_v0_1_52b"), smoke_config("xlstm_350m")
    vis = smoke_config("llama3_2_vision_11b")
    if name == "moe":
        return moe.init_moe(g, 64, 128, 4), lambda p, x, m: moe.moe_ffn(p, x, 4, 2, 1.0)[0], False
    if name == "ssd":
        return ssm.init_ssd(g, jamba), lambda p, x, m: ssm.ssd_forward(p, jamba, x)[0], False
    if name == "mlstm":
        return ssm.init_mlstm(g, xl), lambda p, x, m: ssm.mlstm_forward(p, xl, x)[0], False
    if name == "slstm":
        return ssm.init_slstm(g, xl), lambda p, x, m: ssm.slstm_forward(p, xl, x)[0], False
    if name in ("cross", "cross_token"):
        p = _init_mixer(g, vis, "cross", torch.float32)
        if name == "cross":
            return p, lambda p, x, m: _apply_mixer(p, vis, "cross", x, None, None, m), True
        # One query token over the memory: the decode route (kv_len = T).
        return p, lambda p, x, m: _apply_mixer(p, vis, "cross", x[:, :1], None, None, m), True
    cos, sin = layers.rope_tables(torch.arange(32), vis.head_dim, vis.rope_theta)
    p = {"mixer": _init_mixer(g, vis, "attn", torch.float32),
         "ffn": _init_ffn(g, vis, "mlp", torch.float32)}

    def enc(p, x, m):
        h = layers.attention(p["mixer"]["attn"], layers.rms_norm(p["mixer"]["norm"], x), cos[None],
                             sin[None], vis.n_heads, vis.n_kv_heads, vis.head_dim, causal=False)
        return _apply_ffn(p["ffn"], vis, "mlp", x + h)[0]

    return p, enc, False


def _job_blocks(rank: int, world: int, d: Path) -> None:
    """Each block of BLOCKS on a (2, 2) mesh (the input placed by
    ``act_mid``, the memory by ``batch_sharding``, the parameters by
    ``param_sharding``) against the same block in this process without a
    mesh: its output and the VJP of one seeded cotangent, each leaf's
    largest gap relative to its largest entry, to ``d/blocks.json``."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.distribution import sharding as S
    from repro_torch.models.layers import activation_sharding
    from repro_torch.optim.adamw import tree_leaves

    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    rules = S.activation_rules(mesh)
    out = {}
    for name in BLOCKS:
        params, fn, with_memory = _block(name)
        rng = np.random.default_rng(1)
        x, ct = (torch.from_numpy(rng.standard_normal((4, 32, 64)).astype(np.float32))
                 for _ in range(2))
        mem = torch.from_numpy(rng.standard_normal((4, 16, 64)).astype(np.float32))
        placed = S.distribute(params, S.param_sharding(params, mesh))
        for t in tree_leaves(params) + tree_leaves(placed) + [x, mem]:
            t.requires_grad_(True)
        want = fn(params, x, mem if with_memory else None)
        (want * ct).sum().backward()
        with activation_sharding(rules):
            xd = DTensor.from_local(x.detach(), mesh, [Replicate()] * 2).redistribute(
                mesh, rules["act_mid"].placements)
            md = S.distribute({"m": mem.detach()}, S.batch_sharding({"m": mem}, mesh))["m"]
            xd.requires_grad_(True)
            md.requires_grad_(True)
            got = fn(placed, xd, md if with_memory else None)
            (got * ct).sum().backward()
        pairs = [(got, want), (xd.grad, x.grad)] + list(zip(
            [t.grad for t in tree_leaves(placed)], [t.grad for t in tree_leaves(params)]))
        if with_memory:
            pairs.append((md.grad, mem.grad))
        out[name] = max(float((a.full_tensor() - b).abs().max() / b.abs().max())
                        for a, b in pairs)
    if rank == 0:
        (d / "blocks.json").write_text(json.dumps(out))


@pytest.fixture(scope="module")
def blocks(tmp_path_factory) -> dict:
    d = tmp_path_factory.mktemp("blocks")
    _spawn("blocks", 4, d, module="test_torch_mesh_families")
    return json.loads((d / "blocks.json").read_text())


@pytest.mark.parametrize("name", BLOCKS)
def test_block_under_the_mesh_matches_one_process(blocks, name):
    """One block's output and gradients (its input's, its parameters' and
    the memory's) on the (2, 2) mesh against the same block without a mesh,
    at BLOCK_BAR relative to each leaf's largest entry: the local shards'
    declared gradient placements, the global slots of the MoE dispatch and
    the heads' split of the scans, one at a time."""
    assert blocks[name] <= BLOCK_BAR, blocks


# --------------------------------------------------------------------------
# The measurements behind SPREAD_BARS
# --------------------------------------------------------------------------

def _reference_spread(arch: str, seeds=(1, 2, 3), eps: float = 1e-7) -> dict:
    """The JAX package's own spread over the two steps of a case: the
    largest gap, over ``seeds``, between its one-device steps from the
    initial weights and from the weights scaled by (1 + eps N(0, 1)):
    params, m, v (absolute) and the grad norms (relative)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import smoke_config
    from repro.models.lm import build_model
    from repro.optim.adamw import AdamWConfig
    from repro.runtime.steps import build_train_step, make_train_state

    cfg = smoke_config(arch)
    model = build_model(cfg, compute_dtype=jnp.float32)
    step = jax.jit(build_train_step(model, AdamWConfig(**OPT), n_micro=2))
    rng = np.random.default_rng(0)  # the fixture's batches
    batches = []
    for _ in range(2):
        b = {k: rng.integers(0, cfg.vocab_size, (4, 32)).astype(np.int32) for k in ("tokens", "labels")}
        if cfg.n_enc_layers or cfg.cross_attn_every:
            T = 32 if cfg.n_enc_layers else cfg.n_patches
            b["memory"] = rng.standard_normal((4, T, cfg.d_model)).astype(np.float32)
        batches.append(b)

    def run(seed):
        state = make_train_state(model, jax.random.PRNGKey(0))
        if seed:
            r = np.random.default_rng(seed)
            state = dataclasses.replace(state, params=jax.tree.map(lambda a: jnp.asarray(
                (np.asarray(a) * (1 + eps * r.standard_normal(a.shape))).astype(np.float32)),
                state.params))
        gns = []
        for b in batches:
            state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
            gns.append(float(m["grad_norm"]))
        return state, gns

    def gap(a, b):
        return max(float(np.abs(np.asarray(x) - np.asarray(y)).max())
                   for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)))

    base, gn0 = run(0)
    out = {"params": 0.0, "m": 0.0, "v": 0.0, "grad_norm": 0.0}
    for seed in seeds:
        st, gn = run(seed)
        out["params"] = max(out["params"], gap(st.params, base.params))
        out["m"] = max(out["m"], gap(st.opt["m"], base.opt["m"]))
        out["v"] = max(out["v"], gap(st.opt["v"], base.opt["v"]))
        out["grad_norm"] = max([out["grad_norm"]] + [abs(a / b - 1) for a, b in zip(gn, gn0)])
    return out


if __name__ == "__main__":
    for arch in ("phi3_5_moe_42b", "xlstm_350m", "seamless_m4t_medium", "llama3_2_vision_11b"):
        print(arch, _reference_spread(arch))
