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


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_mesh_takes_dense_decoders_only(arch):
    """``train`` and ``serve_model`` refuse a mesh for a family whose mesh
    route has not been held against the JAX package's sharded step (MoE,
    SSD, xLSTM, encoder, cross-attention), before any work; the dense
    decoders pass the check."""
    from repro_torch.launch.mesh import check_mesh_arch
    from repro_torch.launch.serve import serve_model
    from repro_torch.launch.train import train

    cfg = smoke_config(arch)
    if cfg.family == "dense":
        check_mesh_arch(cfg)
        return
    with pytest.raises(NotImplementedError, match="under a mesh"):
        train(arch, 1, 2, 8, 1, device="cpu", log=lambda *_: None, mesh=object())
    with pytest.raises(NotImplementedError, match="under a mesh"):
        serve_model(build_model(cfg), None, torch.zeros((1, 2), dtype=torch.long), 1,
                    mesh=object())
