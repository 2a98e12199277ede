"""The port's sharding tables against the JAX package's, leaf by leaf.

The tables are pure functions of shapes, paths and the mesh's axis sizes,
so no process group is needed: both packages are given the same
``jax.sharding.AbstractMesh`` (the port's functions take anything with a
mapping from axis name to size, as the reference's do), and the port's
trees are ``meta`` tensors shaped as the reference's ``jax.eval_shape``
trees at the published widths. ``make_production_mesh`` is checked under a
fake process group of 256 and 512 ranks, in a subprocess.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as JP

from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import get_config as j_get_config
from repro.configs import smoke_config as j_smoke_config
from repro.distribution import sharding as JS
from repro.models.lm import build_model as j_build_model
from repro.runtime.steps import make_train_state as j_make_train_state
from repro_torch.checkpoint.ckpt import flatten_with_paths
from repro_torch.configs import ARCH_IDS, smoke_config
from repro_torch.distribution import sharding as TS
from repro_torch.models.lm import build_model
from repro_torch.runtime.steps import TrainState, make_train_state

SRC = str(Path(__file__).resolve().parents[1] / "src")
MESHES = {
    "1x1": ((1, 1), ("data", "model")),
    "2x2": ((2, 2), ("data", "model")),
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
}


def _mesh(name: str) -> AbstractMesh:
    return AbstractMesh(*MESHES[name])


def _meta(tree):
    """The reference's shape tree as meta tensors (dicts and tuples kept)."""
    return jax.tree.map(lambda s: torch.empty(tuple(s.shape), device="meta"), tree)


def _specs_ref(tree) -> dict:
    return {jax.tree_util.keystr(p): tuple(s.spec)
            for p, s in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _specs_port(tree) -> dict:
    return {p: tuple(s.spec) for p, s in flatten_with_paths(tree)}


def _same_tables(port_tree, ref_tree) -> int:
    want, got = _specs_ref(ref_tree), _specs_port(port_tree)
    assert list(got) == list(want)  # the same paths in the same order
    for path in want:
        assert got[path] == want[path], path
    return len(want)


def test_specs_are_partition_specs_and_placements_nest_outer_first():
    spec = TS.PartitionSpec(("pod", "data"), None, "model")
    assert tuple(spec) == tuple(JP(("pod", "data"), None, "model"))
    mesh = _mesh("2x16x16")
    sh = TS.NamedSharding(mesh, spec)
    from torch.distributed.tensor import Replicate, Shard

    assert sh.placements == (Shard(0), Shard(0), Shard(2))
    assert TS.placements(mesh, TS.PartitionSpec(None, "data")) == (Replicate(), Shard(1), Replicate())
    with pytest.raises(ValueError):
        TS.placements(mesh, TS.PartitionSpec(("data", "pod")))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_state_and_cache_tables_match_reference(arch):
    """Every leaf's spec of ``param_sharding``, ``state_sharding`` and
    ``cache_sharding`` (B 2 and B 1 over T 4,096: the batch branch and the
    time-axis branch) at the published widths, on all four meshes."""
    assert arch in J_ARCH_IDS
    jm = j_build_model(j_get_config(arch))
    js = jax.eval_shape(lambda: j_make_train_state(jm, jax.random.PRNGKey(0)))
    tstate = TrainState(params=_meta(js.params), opt=_meta(js.opt), residual=_meta(js.residual))
    caches = {B: jax.eval_shape(lambda B=B: jm.init_cache(B, 4096)) for B in (2, 1)}
    n = 0
    for name in MESHES:
        mesh = _mesh(name)
        n += _same_tables(TS.param_sharding(tstate.params, mesh),
                          JS.param_sharding(js.params, mesh))
        n += _same_tables(TS.state_sharding(tstate, mesh), JS.state_sharding(js, mesh))
        for cache in caches.values():
            n += _same_tables(TS.cache_sharding(_meta(cache), mesh),
                              JS.cache_sharding(cache, mesh))
    assert n > 100


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_batch_tables_match_reference(mesh_name):
    mesh = _mesh(mesh_name)
    for B in (64, 8, 1):
        shapes = {"tokens": (B, 128), "labels": (B, 128), "memory": (B, 16, 64)}
        ref = {k: jax.ShapeDtypeStruct(s, jnp.int32) for k, s in shapes.items()}
        port = {k: torch.empty(s, device="meta") for k, s in shapes.items()}
        _same_tables(TS.batch_sharding(port, mesh), JS.batch_sharding(ref, mesh))


def test_fit_spec_matches_reference():
    """tests/test_sharding.py:31-40's cases, its shim included, and the
    local mesh's."""
    class FakeMesh:
        shape = {"data": 16, "model": 16}
        axis_names = ("data", "model")

    P = TS.PartitionSpec
    cases = [
        ((256206, 1024), ("model", "data")),
        ((102400, 8192), ("model", "data")),
        ((1, 4096), (("pod", "data"), None)),
        ((8, 8), ("data", "model")),
        ((32, 3, 48), ("data",)),
    ]
    for mesh in (FakeMesh(), _mesh("1x1"), _mesh("2x16x16")):
        for shape, spec in cases:
            assert tuple(TS.fit_spec(mesh, shape, P(*spec))) == \
                tuple(JS.fit_spec(mesh, shape, JP(*spec))), (shape, spec)
    assert TS.fit_spec(FakeMesh(), (256206, 1024), P("model", "data")) == P(None, "data")
    assert TS.batch_axes(_mesh("2x16x16")) == JS.batch_axes(_mesh("2x16x16")) == ("pod", "data")


@pytest.mark.parametrize("mode", ["dshard", "replicated", "boundary"])
def test_activation_rules_match_reference(mode, monkeypatch):
    monkeypatch.setenv("REPRO_ACT_MODE", mode)
    for name in MESHES:
        mesh = _mesh(name)
        want = {k: tuple(v.spec) for k, v in JS.activation_rules(mesh).items()}
        got = {k: tuple(v.spec) for k, v in TS.activation_rules(mesh).items()}
        assert got == want


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_port_smoke_trees_have_reference_paths(arch):
    """The port's own trees (parameters, train state, decode cache) are
    spelled as ``jax.tree_util.keystr`` spells the reference's, so the
    rules see the same strings."""
    jm = j_build_model(j_smoke_config(arch))
    tm = build_model(smoke_config(arch))
    js = jax.eval_shape(lambda: j_make_train_state(jm, jax.random.PRNGKey(0)))
    ts = make_train_state(tm, 0, device="cpu")
    want = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(js)[0]]
    assert [p for p, _ in flatten_with_paths(ts)] == want
    jc = jax.eval_shape(lambda: jm.init_cache(2, 32))
    tc = tm.init_cache(2, 32, device="cpu")
    want = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(jc)[0]]
    assert [p for p, _ in flatten_with_paths(tc)] == want


def test_production_mesh_under_a_fake_world():
    """(16, 16) under 256 fake ranks, (2, 16, 16) under 512, and a refusal
    (with the reference's count in the message) under 1 and 256; in a
    subprocess, so this worker's process group stays as it is."""
    code = textwrap.dedent(
        """
        import torch.distributed as dist
        from torch.testing._internal.distributed.fake_pg import FakeStore
        from repro_torch.launch.mesh import make_local_mesh, make_production_mesh

        def refused(**kw):
            try:
                make_production_mesh(device="cpu", **kw)
            except RuntimeError as e:
                return str(e)

        print(refused())  # starts a one-rank gloo group
        dist.destroy_process_group()
        dist.init_process_group("fake", store=FakeStore(), rank=5, world_size=256)
        m = make_production_mesh(device="cpu")
        print(tuple(m.shape), m.mesh_dim_names, m.get_coordinate())
        print(refused(multi_pod=True))
        dist.destroy_process_group()
        dist.init_process_group("fake", store=FakeStore(), rank=300, world_size=512)
        m = make_production_mesh(multi_pod=True, device="cpu")
        print(tuple(m.shape), m.mesh_dim_names, m.get_coordinate())
        print(tuple(make_local_mesh(model=4, device="cpu").shape))
        dist.destroy_process_group()
        """
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": SRC}, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[0].startswith("need 256 devices for the production mesh, have 1")
    assert lines[1] == "(16, 16) ('data', 'model') (0, 5)"
    assert lines[2].startswith("need 512 devices for the production mesh, have 256")
    assert lines[3] == "(2, 16, 16) ('pod', 'data', 'model') (1, 2, 12)"
    assert lines[4] == "(1, 4)"


@pytest.fixture(scope="module")
def local_mesh():
    """A (1, 1) mesh over a one-rank gloo group (an in-process store), the
    group destroyed after this module's tests if they started it."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_local_mesh

    started = not dist.is_initialized()
    yield make_local_mesh(device="cpu")
    if started:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_mesh_takes_every_arch(arch, local_mesh):
    """``check_mesh_arch`` passes every config, and on a one-rank gloo mesh
    one smoke training step (float32 compute, batch 2 x 16, the memory
    where the config has one) and a 4-token serve equal the route without
    a mesh: the loss, grad norm and the state after the step at
    ``tests/test_torch_train.py``'s ``STEP_BARS["float32"]``, the tokens
    equal."""
    import numpy as np
    from test_torch_mesh import _max_err
    from test_torch_train import STEP_BARS

    from repro_torch.interop import train_state_to_arrays
    from repro_torch.launch.mesh import check_mesh_arch
    from repro_torch.launch.serve import serve_model
    from repro_torch.models.layers import activation_sharding
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.steps import build_train_step

    cfg = smoke_config(arch)
    check_mesh_arch(cfg)
    model = build_model(cfg, compute_dtype=torch.float32)
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32))
             for k in ("tokens", "labels")}
    memory = None
    if cfg.n_enc_layers or cfg.cross_attn_every:
        T = 16 if cfg.n_enc_layers else cfg.n_patches
        memory = torch.from_numpy(rng.standard_normal((2, T, cfg.d_model)).astype(np.float32))
        batch["memory"] = memory
    step = build_train_step(model, AdamWConfig(warmup_steps=2, total_steps=10), n_micro=1)
    plain, want = step(make_train_state(model, 0, device="cpu"), batch)
    state = make_train_state(model, 0, device="cpu")
    with activation_sharding(TS.activation_rules(local_mesh)):
        state = TS.distribute(state, TS.state_sharding(state, local_mesh))
        state, got = step(state, TS.distribute(batch, TS.batch_sharding(batch, local_mesh)))
    p_bar, m_bar, v_bar, _, n_bar = STEP_BARS["float32"]
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(got["grad_norm"]), float(want["grad_norm"]), rtol=n_bar)
    a, b = train_state_to_arrays(TS.gather(state)), train_state_to_arrays(plain)
    assert _max_err(a["params"], b["params"]) <= p_bar
    assert _max_err(a["opt"]["m"], b["opt"]["m"]) <= m_bar
    assert _max_err(a["opt"]["v"], b["opt"]["v"]) <= v_bar

    params = model.init(0, device="cpu")
    prompts = batch["tokens"][:, :4].long()
    served = serve_model(model, params, prompts, 4, memory=memory, mesh=local_mesh)
    assert torch.equal(served.tokens, serve_model(model, params, prompts, 4, memory=memory).tokens)


def test_mesh_refuses_a_layer_kind_no_test_holds(monkeypatch):
    """A layer kind outside ``MESH_MIXERS`` x ``MESH_FFNS`` (here a made-up
    mixer) is refused by ``check_mesh_arch``, and by ``train`` and
    ``serve_model`` before any work."""
    from repro_torch.launch import mesh as tmesh
    from repro_torch.launch.serve import serve_model
    from repro_torch.launch.train import train

    cfg = smoke_config("llama3_2_3b")
    tmesh.check_mesh_arch(cfg)
    monkeypatch.setattr(tmesh, "layer_kinds", lambda cfg: [("attn", "mlp"), ("rwkv", "mlp")])
    with pytest.raises(NotImplementedError, match="under a mesh"):
        tmesh.check_mesh_arch(cfg)
    with pytest.raises(NotImplementedError, match="under a mesh"):
        train("llama3.2-3b", 1, 2, 8, 1, device="cpu", log=lambda *_: None, mesh=object())
    with pytest.raises(NotImplementedError, match="under a mesh"):
        serve_model(build_model(cfg), None, torch.zeros((1, 2), dtype=torch.long), 1,
                    mesh=object())
    assert "rwkv" not in tmesh.MESH_MIXERS


def test_recompute_on_another_thread_keeps_the_rules(local_mesh):
    """The activation rules are this thread's; a checkpointed function's
    recompute runs on autograd's thread for a CUDA backward.
    ``under_current_rules`` carries the caller's rules to any thread, where
    the bare function's ``shard`` hook would change nothing."""
    import threading

    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.models.layers import activation_sharding, shard, under_current_rules

    x = DTensor.from_local(torch.zeros((2, 3, 4, 8)), local_mesh, [Replicate(), Replicate()])
    got = {}
    with activation_sharding(TS.activation_rules(local_mesh)):
        for name, fn in (("bare", lambda t: shard(t, "act_heads")),
                         ("carried", under_current_rules(lambda t: shard(t, "act_heads")))):
            th = threading.Thread(target=lambda n=name, f=fn: got.__setitem__(n, f(x)))
            th.start()
            th.join(timeout=60)
            assert not th.is_alive()
    assert got["bare"].placements == (Replicate(), Replicate())
    assert got["carried"].placements == (Shard(0), Shard(2))
