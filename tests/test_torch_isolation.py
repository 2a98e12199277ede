"""The port stands alone: importing it loads neither JAX nor any module of
the JAX package, nor does a twin of its example scripts (``examples/torch_*.py``,
``tools/torch_*.py``), and an entry point called without ``device`` on a
machine without a CUDA card raises instead of running on the CPU."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

SRC = str(Path(__file__).resolve().parents[1] / "src")


def test_import_loads_neither_jax_nor_reference_package():
    code = textwrap.dedent(
        """
        import sys
        import repro_torch, repro_torch.core, repro_torch.online
        import repro_torch.kernels.ops, repro_torch.interop
        import repro_torch.models, repro_torch.models.lm, repro_torch.configs
        import repro_torch.models.moe, repro_torch.models.ssm
        import repro_torch.runtime.steps, repro_torch.launch.serve
        import repro_torch.kernels.attention, repro_torch.kernels.stage2
        import repro_torch.distribution.plan
        import repro_torch.models.flash, repro_torch.optim.adamw, repro_torch.optim.grad
        import repro_torch.data.pipeline, repro_torch.checkpoint.ckpt
        import repro_torch.launch.train, repro_torch.launch.mesh
        import repro_torch.distribution.sharding
        import repro_torch.obs.export, repro_torch.obs.report
        repro_torch.configs.get_config("llama3.2-3b")
        mesh = repro_torch.launch.mesh.make_local_mesh(device="cpu")
        repro_torch.distribution.sharding.activation_rules(mesh)
        bad = sorted(
            m for m in sys.modules
            if m == "jax" or m.startswith("jax.")
            or m == "repro" or m.startswith("repro.")
        )
        print(bad)
        """
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": SRC}, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_chip_smoke_imports_neither_jax_nor_reference_package():
    """No line of ``chip_smoke.py`` (which runs on the card machine) imports
    JAX or the JAX package: every ``import`` and ``from`` in its syntax tree
    names neither."""
    import ast

    tree = ast.parse((Path(SRC).parent / "chip_smoke.py").read_text())
    names = [alias.name for node in ast.walk(tree) if isinstance(node, ast.Import)
             for alias in node.names]
    names += [node.module or "" for node in ast.walk(tree) if isinstance(node, ast.ImportFrom)]
    assert "repro_torch.models.lm" in names  # the walk sees the script's imports
    bad = [n for n in names if n.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert bad == []


def _instance():
    from repro_torch.core import ProblemInstance, random_job

    job = random_job(np.random.default_rng(0), None, n_tasks=5, rho=1.0)
    return ProblemInstance(job=job, n_racks=3, n_wireless=1)


def test_no_quiet_cpu_fallback():
    from repro_torch.core.vectorized import (
        batched_lower_bound,
        make_batched_evaluator,
        schedule_fleet,
        vectorized_search,
    )
    from repro_torch.online import OnlineScheduler

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card: device=None runs on it")
    inst = _instance()
    with pytest.raises(RuntimeError, match="CUDA"):
        schedule_fleet([inst])
    with pytest.raises(RuntimeError, match="CUDA"):
        vectorized_search(inst)
    with pytest.raises(RuntimeError, match="CUDA"):
        batched_lower_bound(inst, np.zeros((2, 5), np.int32), use_kernel=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_batched_evaluator(inst)
    with pytest.raises(RuntimeError, match="CUDA"):
        OnlineScheduler(3, 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        schedule_fleet([inst], device="cuda")
    # Asked for by name, the CPU runs.
    res = schedule_fleet([inst], batch_size=64, device="cpu")
    assert np.isfinite(res.makespans).all()


def test_model_stack_has_no_quiet_cpu_fallback():
    from repro_torch.configs import smoke_config
    from repro_torch.interop import lm_cache_from_arrays, lm_params_from_arrays
    from repro_torch.kernels import attention
    from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
    from repro_torch.launch.serve import serve
    from repro_torch.models.lm import build_model

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card: device=None runs on it")
    model = build_model(smoke_config("llama3.2-3b"))
    with pytest.raises(RuntimeError, match="CUDA"):
        model.init(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        model.init_cache(1, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve(batch=1, prompt=2, gen=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        lm_params_from_arrays({"w": np.zeros(2, np.float32)})
    with pytest.raises(RuntimeError, match="CUDA"):
        lm_cache_from_arrays({"pos": np.int32(0), "layers": ()})
    # The meshes are the card's unless the CPU is asked for; the check comes
    # before any process group is started.
    with pytest.raises(RuntimeError, match="CUDA"):
        make_local_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        make_production_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        make_production_mesh(multi_pod=True)
    # The attention wrappers launch a kernel only for a CUDA tensor; a CPU
    # tensor, asked for by name, takes the plain version and counts nothing.
    before = dict(attention.launches)
    q = torch.zeros((1, 3, 4, 16))
    k = torch.zeros((1, 3, 2, 16))
    assert attention.flash_attention(q, k, k).shape == (1, 3, 4, 16)
    assert attention.decode_attention(q[:, 0], k, k, 2).shape == (1, 4, 16)
    assert attention.launches == before
    # Asked for by name, the CPU runs.
    params = model.init(0, device="cpu")
    assert params["embed"]["table"].device.type == "cpu"


def test_dry_run_modules_load_neither_jax_nor_reference_package():
    """The dry run and its op analyzer stand alone too: no module of JAX or
    of the JAX package is loaded by importing them (the reference's
    ``hlo_analysis.py`` imports no JAX, and the port takes nothing from it
    either)."""
    code = textwrap.dedent(
        """
        import sys
        import repro_torch.launch.op_analysis, repro_torch.launch.dryrun
        bad = sorted(
            m for m in sys.modules
            if m == "jax" or m.startswith("jax.")
            or m == "repro" or m.startswith("repro.")
        )
        print(bad)
        """
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": SRC}, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.parametrize("op", ["flash_fwd", "flash_fwd_lse", "flash_bwd_delta",
                                "flash_bwd_dkdv", "flash_bwd_dq", "decode_attention"])
def test_kernel_operators_refuse_other_devices(op):
    """Each kernel operator has a CPU, a CUDA and a fake implementation and
    nothing else: a tensor on another device (``meta``) that reaches the
    operator raises, as it does at the wrapper's check."""
    from repro_torch.kernels import attention

    q = torch.zeros((1, 3, 4, 16), device="meta")
    k = torch.zeros((1, 3, 2, 16), device="meta")
    lse = torch.zeros((1, 3, 4), device="meta")
    args = {
        "flash_fwd": (q, k, k, True),
        "flash_fwd_lse": (q, k, k, True),
        "flash_bwd_delta": (q, q),
        "flash_bwd_dkdv": (q, k, k, q, lse, lse, True),
        "flash_bwd_dq": (q, k, k, q, lse, lse, True),
        "decode_attention": (q[:, 0], k, k, None, 2),
    }[op]
    with pytest.raises((ValueError, NotImplementedError, RuntimeError)):
        getattr(torch.ops.repro_torch, op)(*args)
    with pytest.raises(ValueError, match="device"):
        attention.flash_attention(q, k, k)
    with pytest.raises(ValueError, match="device"):
        attention.decode_attention(q[:, 0], k, k, 2)


TWINS = ["examples/torch_quickstart.py", "examples/torch_schedule_cluster.py",
         "examples/torch_serve_jobs.py", "examples/torch_serve_batched.py",
         "examples/torch_train_e2e.py", "tools/torch_trace_report.py"]


def test_every_twin_is_listed():
    root = Path(SRC).parent
    found = sorted(str(p.relative_to(root)) for d in ("examples", "tools")
                   for p in (root / d).glob("torch_*.py"))
    assert found == sorted(TWINS)


@pytest.fixture(scope="module")
def twins_loaded() -> dict:
    """The modules of JAX and of the JAX package loaded after each twin's
    module body (not its ``main``) ran, the twins loaded in turn in one
    process."""
    code = textwrap.dedent(
        f"""
        import importlib.util, json, sys
        out = {{}}
        for rel in {TWINS!r}:
            spec = importlib.util.spec_from_file_location("twin", {str(Path(SRC).parent)!r} + "/" + rel)
            spec.loader.exec_module(importlib.util.module_from_spec(spec))
            out[rel] = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        print(json.dumps(out))
        """
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": SRC}, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    import json

    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("twin", TWINS)
def test_twin_loads_neither_jax_nor_reference_package(twin, twins_loaded):
    """A twin of the JAX package's example scripts names neither package in any
    import of its syntax tree, and loading it loads neither."""
    import ast

    tree = ast.parse((Path(SRC).parent / twin).read_text())
    names = [alias.name for node in ast.walk(tree) if isinstance(node, ast.Import)
             for alias in node.names]
    names += [node.module or "" for node in ast.walk(tree) if isinstance(node, ast.ImportFrom)]
    assert any(n.startswith("repro_torch") for n in names)
    assert [n for n in names if n.split(".")[0] in ("jax", "jaxlib", "repro")] == []
    assert twins_loaded[twin] == []
