"""The port stands alone: importing it loads neither JAX nor any module of
the JAX package, and an entry point called without ``device`` on a
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
        import repro_torch.kernels.attention
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
