"""The port's twins of the JAX package's example scripts (``examples/torch_*.py``,
``tools/torch_trace_report.py``), each run through its ``main`` on the
CPU at a small size and held against the JAX package's functions called
on the same inputs:

* the quickstart's bounds, heuristic and optima, exactly;
* ``torch_schedule_cluster`` at 2 jobs and 64 samples: each job's fleet
  makespan exactly, and the B&B optima of every solve that both packages
  prove (an unproved solve stops at the wall clock);
* ``torch_serve_jobs`` at 3 jobs: every policy's JCTs exactly, as
  ``tests/test_admission.py``'s ``GOLDEN`` is held;
* ``torch_serve_batched`` on the JAX package's seed-0 weights: the
  generated tokens equal, the last prompt step's logits within
  ``max(0.05, 0.02 * n_layers)`` (bf16 compute, ``tests/test_models.py``'s
  bar), the port's prefill within the same bar of its own decode;
* ``torch_train_e2e`` at 3 steps of a tiny width in float32 compute, from
  the JAX package's initial state (a checkpoint of it, which the twin
  resumes from): losses and grad norms within ``STEP_BARS["float32"]``'s
  1e-5 relative (measured 1.2e-6: the reference's float32 sum of a leaf's
  squares is itself up to 6.9e-7 off the exact one,
  ``tests/test_torch_train.py::test_global_norm_of_large_leaves``; weights
  scaled by (1 + 1e-7 N(0, 1)) move the reference's by at most 2.2e-7; the
  file run as a script prints both gaps), each learning rate equal to the reference's schedule (evaluated eagerly:
  inside the jitted step XLA rounds the warm-up's division otherwise, one
  ulp off at the third step); and a run stopped
  after 2 steps and resumed from its checkpoint equals the uninterrupted
  run bit for bit (``torch.equal``), repeating no step;
* ``torch_trace_report``: the same report dict as ``tools/trace_report.py``
  on one trace.

A twin that reaches the device raises without a card unless it is given
``--device cpu``.
"""

from __future__ import annotations

import importlib.util
import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_train import STEP_BARS

ROOT = Path(__file__).resolve().parents[1]
DEVICE_TWINS = ("torch_schedule_cluster", "torch_serve_jobs", "torch_serve_batched",
                "torch_train_e2e")
TRAIN_ARGS = ["--dim", "64", "--layers", "2", "--seq", "32", "--batch", "4",
              "--compute-dtype", "float32", "--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The twins' small CPU steps on one thread: the default thread pool
    over every core made the engine's stage 2 ten times slower here, with
    the other test workers on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load(rel: str):
    """A script as a module (``examples/`` and ``tools/`` are no
    packages)."""
    path = ROOT / rel
    spec = importlib.util.spec_from_file_location(f"_script_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_matches_reference():
    from repro.core import (
        ProblemInstance,
        g_list_schedule,
        lower_bound,
        make_onestage_mapreduce,
        solve_bnb,
        upper_bound,
        wired_only,
    )

    got = _load("examples/torch_quickstart.py").main([])
    job = make_onestage_mapreduce(np.random.default_rng(7), n_map=4, n_reduce=2, rho=1.0)
    inst = ProblemInstance(job=job, n_racks=4, n_wireless=2)
    opt0, opt2 = solve_bnb(wired_only(inst), time_limit=30), solve_bnb(inst, time_limit=30)
    assert got["t_min"] == lower_bound(inst) and got["t_max"] == upper_bound(inst)
    assert got["heuristic"] == g_list_schedule(inst, use_wireless=True).makespan
    assert got["wired_proved"] and got["wireless_proved"]
    assert opt0.proved_optimal and opt2.proved_optimal
    assert got["wired"] == opt0.makespan and got["wireless"] == opt2.makespan
    assert got["start"] == [float(t) for t in opt2.schedule.start]


def test_schedule_cluster_matches_reference():
    from repro.core import ProblemInstance, random_job, schedule_fleet, solve_bnb, wired_only

    n_jobs, samples, limit = 2, 64, 1.0
    got = _load("examples/torch_schedule_cluster.py").main(
        ["--device", "cpu", "--jobs", str(n_jobs), "--samples", str(samples),
         "--time-limit", str(limit)])
    insts = [ProblemInstance(job=random_job(np.random.default_rng(100 + j), None, rho=0.5),
                             n_racks=8, n_wireless=2) for j in range(n_jobs)]
    fleet = schedule_fleet(insts, max_enumerate=20_000, n_samples=samples,
                           strategies="portfolio")
    assert [j["fleet"] for j in got["jobs"]] == [float(m) for m in fleet.makespans]
    assert got["n_pruned"] == fleet.n_pruned and got["n_candidates"] == fleet.n_candidates
    n_proved = 0
    for inst, j in zip(insts, got["jobs"]):
        for key, want in (("wired", solve_bnb(wired_only(inst), time_limit=limit)),
                          ("augmented", solve_bnb(inst, time_limit=limit))):
            if want.proved_optimal and j[f"{key}_proved"]:
                assert j[key] == want.makespan
                n_proved += 1
    assert n_proved > 0


def test_serve_jobs_matches_reference():
    from repro.online import OnlineScheduler, production_arrivals

    twin = _load("examples/torch_serve_jobs.py")
    got = twin.main(["--device", "cpu", "--jobs", "3"])
    arrivals = production_arrivals(seed=0, rate=1 / 40, n_jobs=3, min_rack_demand=4,
                                   **twin.CLUSTER)
    service = dict(window=5.0, require_full_demand=True, preserve_order=True,
                   solver_kwargs=twin.SOLVER, seed=0)
    n, w = twin.CLUSTER["n_racks"], twin.CLUSTER["n_wireless"]
    runs = {
        "fleet": OnlineScheduler(n, w, warm_start=True, **service),
        "backfill": OnlineScheduler(n, w, warm_start=True, backfill=True, **service),
        "greedy_list": OnlineScheduler(n, w, policy="greedy_list", **service),
        "fifo_solo": OnlineScheduler(n, w, policy="fifo_solo", **service),
    }
    for name, svc in runs.items():
        res = svc.serve(arrivals)
        assert got[name]["jct"] == [j.jct for j in res.jobs], name
        assert got[name]["mean_jct"] == res.mean_jct, name
    assert got["streaming"]["mean_jct"] == got["fleet"]["mean_jct"]


def test_serve_batched_matches_reference():
    import jax
    import jax.numpy as jnp

    from repro.configs import smoke_config
    from repro.models.lm import build_model
    from repro.runtime.steps import build_serve_step
    from repro_torch.interop import lm_params_from_arrays

    cfg = smoke_config("llama3_2_3b")
    model = build_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    got = _load("examples/torch_serve_batched.py").main(
        ["--device", "cpu"],
        params=lm_params_from_arrays(jax.tree.map(np.asarray, params), device="cpu",
                                     dtype=torch.bfloat16))

    B, prompt_len, gen_len = 4, 16, 24  # examples/serve_batched.py:27
    prompts = jnp.asarray(np.random.default_rng(0).integers(0, cfg.vocab_size,
                                                            (B, prompt_len)), jnp.int32)
    assert np.array_equal(got["prompts"], np.asarray(prompts))
    cache = model.init_cache(B, prompt_len + gen_len + 1)
    step = jax.jit(build_serve_step(model))
    for t in range(prompt_len):
        logits, cache = step(params, cache, prompts[:, t])
    last = np.asarray(logits[:, 0], np.float32)
    tokens = [jnp.argmax(logits[:, 0], axis=-1).astype(jnp.int32)]
    for _ in range(gen_len - 1):
        logits, cache = step(params, cache, tokens[-1])
        tokens.append(jnp.argmax(logits[:, 0], axis=-1).astype(jnp.int32))
    tol = max(0.05, 0.02 * cfg.n_layers)
    assert np.array_equal(got["tokens"], np.asarray(jnp.stack(tokens, axis=1)))
    assert np.abs(got["last_logits"] - last).max() <= tol
    assert got["prefill_gap"] <= tol


def _jax_train(steps: int, d: Path | None, perturb: int = 0, eps: float = 1e-7) -> list[dict]:
    """``examples/train_e2e.py``'s loop at ``TRAIN_ARGS``'s width in float32
    compute for ``steps`` steps; its initial state is written to ``d`` as
    the checkpoint of label 0. With ``perturb`` (a seed) the weights are
    first scaled by (1 + eps N(0, 1)) and nothing is written: a run of the
    reference's own spread."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from repro.checkpoint import ckpt
    from repro.configs import get_config
    from repro.data.pipeline import DataConfig, make_pipeline
    from repro.models.lm import build_model
    from repro.optim.adamw import AdamWConfig
    from repro.runtime.steps import build_train_step, make_train_state

    dim, layers, seq, batch = 64, 2, 32, 4
    cfg = dataclasses.replace(get_config("llama3_2_3b"), n_layers=layers, d_model=dim,
                              n_heads=max(4, dim // 64), n_kv_heads=max(2, dim // 128),
                              head_dim=64, d_ff=dim * 4, vocab_size=4096)
    model = build_model(cfg, compute_dtype=jnp.float32)
    state = make_train_state(model, jax.random.PRNGKey(0))
    if d is not None:
        ckpt.save(str(d), 0, jax.tree.map(np.asarray, state))
    if perturb:
        r = np.random.default_rng(perturb)
        state = dataclasses.replace(state, params=jax.tree.map(lambda a: jnp.asarray(
            (np.asarray(a) * (1 + eps * r.standard_normal(a.shape))).astype(np.float32)),
            state.params))
    data = make_pipeline(DataConfig(vocab_size=cfg.vocab_size, global_batch=batch,
                                    seq_len=seq))
    opt = AdamWConfig(lr_peak=3e-3, lr_min=3e-4, warmup_steps=20, total_steps=steps)
    step = jax.jit(build_train_step(model, opt, n_micro=2))
    out = []
    for s in range(steps):
        state, m = step(state, {k: jnp.asarray(v) for k, v in data.batch_for_step(s).items()})
        out.append({k: float(v) for k, v in m.items()})
    return out


def test_train_e2e_matches_reference_and_resumes(tmp_path):
    from repro_torch.optim.adamw import tree_leaves

    twin = _load("examples/torch_train_e2e.py")
    init = tmp_path / "init"
    want = _jax_train(3, init)
    runs = {}
    for name in ("whole", "cut"):
        shutil.copytree(init, tmp_path / name)
        args = TRAIN_ARGS + ["--ckpt-dir", str(tmp_path / name), "--ckpt-every", "1"]
        if name == "whole":
            runs[name] = [twin.main(args + ["--steps", "3"])]
        else:  # stopped after 2 steps (the checkpoint of label 2), then resumed
            runs[name] = [twin.main(args + ["--steps", "2"]), twin.main(args + ["--steps", "3"])]
    whole = runs["whole"][0]
    assert whole["start"] == 0 and len(whole["metrics"]) == 3
    from repro.optim.adamw import AdamWConfig, cosine_schedule

    opt = AdamWConfig(lr_peak=3e-3, lr_min=3e-4, warmup_steps=20, total_steps=3)
    for s, (m, w) in enumerate(zip(whole["metrics"], want)):
        np.testing.assert_allclose(m["loss"], w["loss"], rtol=STEP_BARS["float32"][0])
        np.testing.assert_allclose(m["grad_norm"], w["grad_norm"], rtol=STEP_BARS["float32"][4])
        # The step reports the rate of its update, step s + 1 of the schedule.
        assert np.float32(m["lr"]) == np.float32(cosine_schedule(opt, np.int32(s + 1)))
    first, resumed = runs["cut"]
    assert resumed["start"] == 2 and len(resumed["metrics"]) == 1
    assert first["metrics"] + resumed["metrics"] == whole["metrics"]
    for a, b in zip(tree_leaves([resumed["state"].params, resumed["state"].opt]),
                    tree_leaves([whole["state"].params, whole["state"].opt])):
        assert torch.equal(a, b)


def test_trace_report_matches_reference(tmp_path):
    from repro_torch.obs import Tracer, write_chrome_trace
    from repro_torch.online import OnlineScheduler, production_arrivals

    tr = Tracer()
    OnlineScheduler(6, 2, window=5.0, seed=0, tracer=tr, device="cpu",
                    solver_kwargs=dict(max_enumerate=64, n_samples=64, batch_size=256)).serve(
        production_arrivals(seed=0, rate=1 / 40, n_jobs=4, min_rack_demand=4, n_racks=6,
                            n_wireless=2))
    trace = tmp_path / "trace.json"
    write_chrome_trace(tr, trace)
    got = _load("tools/torch_trace_report.py").main([str(trace), "--top", "3", "--job", "1"])
    out = tmp_path / "report.json"
    assert _load("tools/trace_report.py").main(
        [str(trace), "--top", "3", "--job", "1", "--json", str(out)]) == 0
    assert got["audit"]["events"] and got["slow_jobs"] and got["epochs"]
    assert json.loads(json.dumps(got, sort_keys=True)) == json.loads(out.read_text())


@pytest.mark.parametrize("twin", DEVICE_TWINS)
def test_twin_without_a_card_raises(twin):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card: the twin runs on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        _load(f"examples/{twin}.py").main([])


def _grad_norm_gaps(tmp: Path, seeds=(1, 2, 3)) -> dict:
    """The train_e2e twin's grad norms against the reference's at
    ``TRAIN_ARGS``'s width, 3 steps: the port's gap and the reference's own
    spread (its runs from the weights scaled by (1 + 1e-7 N(0, 1)) against
    its run from the weights), each the largest relative gap over the
    steps."""
    want = _jax_train(3, tmp / "init")
    shutil.copytree(tmp / "init", tmp / "run")
    got = _load("examples/torch_train_e2e.py").main(
        TRAIN_ARGS + ["--ckpt-dir", str(tmp / "run"), "--steps", "3"])

    def gap(a, b):
        return max(abs(x["grad_norm"] - y["grad_norm"]) / abs(y["grad_norm"])
                   for x, y in zip(a, b))

    return {"port": gap(got["metrics"], want),
            "reference_spread": max(gap(_jax_train(3, None, seed), want) for seed in seeds)}


if __name__ == "__main__":
    import tempfile

    torch.set_num_threads(1)
    with tempfile.TemporaryDirectory() as d:
        print(_grad_norm_gaps(Path(d)))
