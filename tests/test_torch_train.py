"""Port training slice against the JAX package: the chunked loss and its
full gradient tree, the training step (AdamW, micro-batches, bf16
gradient compression, bf16 parameter casts) with the state carried across
by ``interop``, the contract of ``tests/test_models.py:47-68`` on every
smoke config, and the train launcher's checkpoint resume, on the same
numpy-made inputs.

Tolerances, each from what the two frameworks compute differently:

* loss and gradients, float32 compute: 1e-4 (the model tests' float32
  bar); both run the same algorithm and differ in the order of float32
  sums (measured: 2.6e-7 at most).
* loss and gradients, bf16 compute: the model tests' bar
  ``max(0.05, 0.02 * n_layers)`` (``tests/test_models.py:113``): the two
  frameworks round to bf16 at slightly different places (measured: 3.5e-3
  at most).
* two training steps, float32 compute: AdamW divides each moment by the
  root of the second, so a gradient entry near zero turns a float32
  difference into a visible one in that entry's update (at most lr per
  step). Params within 1e-5 (3% of one step's largest update, lr 3e-4),
  m within 1e-6, v within 1e-8, loss and grad_norm within 1e-5 relative;
  measured 2.5e-6, 2.4e-8, 9.6e-10. With bf16 gradients (compression, or
  the bf16 parameter cast whose gradients reach the masters through bf16)
  a gradient entry can round to the neighbouring bf16 number in one
  framework: params within 1e-3, m within 1e-4, v within 1e-5, the
  residual within 1e-3 (one bf16 step of a gradient entry up to 0.25),
  grad_norm within 1e-3 relative; measured 1.5e-4, 5.3e-5, 3.7e-6,
  1.2e-4, 1e-4. In bf16 compute the two steps' parameters differ by about
  an update, so step parity is held in float32 compute.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke_config
from repro.models.lm import build_model as j_build_model
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.runtime.steps import build_train_step as j_build_train_step
from repro.runtime.steps import make_train_state as j_make_train_state
from repro_torch.configs import ARCH_IDS, smoke_config
from repro_torch.interop import (
    lm_params_from_arrays,
    train_state_from_arrays,
    train_state_to_arrays,
)
from repro_torch.kernels import attention
from repro_torch.launch import train as ttrain
from repro_torch.models.lm import build_model
from repro_torch.optim.adamw import AdamWConfig, tree_leaves
from repro_torch.runtime.steps import build_train_step, make_train_state

DENSE = ["llama3_2_3b", "qwen1_5_4b", "phi3_mini_3_8b", "deepseek_67b"]
CPU = "cpu"


def _batch(cfg, B=2, S=32, seed=0):
    """tests/test_models.py:_batch as numpy arrays."""
    rng = np.random.default_rng(seed)
    batch = {
        "tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
        "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
    }
    if cfg.n_enc_layers or cfg.cross_attn_every:
        T = S if cfg.n_enc_layers else 16
        batch["memory"] = rng.standard_normal((B, T, cfg.d_model)).astype(np.float32)
    return batch


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _max_err(a, b) -> float:
    return max(
        float(np.abs(np.asarray(x, np.float32) - np.asarray(y, np.float32)).max())
        for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b))
    )


@pytest.mark.parametrize("arch", DENSE)
@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_loss_and_gradients_match_reference(arch, compute):
    """``loss`` and ``torch.autograd`` of it against ``model.loss`` and
    ``jax.grad`` of the JAX package, same weights, every leaf, with a mask
    over the labels."""
    jdt, tdt = (jnp.float32, torch.float32) if compute == "float32" else (jnp.bfloat16, torch.bfloat16)
    cfg = j_smoke_config(arch)
    tol = 1e-4 if compute == "float32" else max(0.05, 0.02 * cfg.n_layers)
    jm = j_build_model(cfg, compute_dtype=jdt)
    tm = build_model(smoke_config(arch), compute_dtype=tdt)
    pj = jm.init(jax.random.PRNGKey(0))
    batch = _batch(cfg)
    batch["mask"] = (np.random.default_rng(5).random((2, 32)) < 0.8).astype(np.float32)
    lj, gj = jax.value_and_grad(jm.loss)(pj, _j(batch))
    pt = lm_params_from_arrays(jax.tree.map(np.asarray, pj), device=CPU)
    for leaf in tree_leaves(pt):
        leaf.requires_grad_(True)
    lt = tm.loss(pt, _t(batch))
    assert lt.shape == () and lt.dtype == torch.float32
    lt.backward()
    np.testing.assert_allclose(float(lt.detach()), float(lj), atol=tol, rtol=tol)
    got = [leaf.grad.numpy() for leaf in tree_leaves(pt)]
    want = jax.tree.leaves(gj)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w, np.float32), atol=tol, rtol=tol)


STEP_BARS = {  # params, m, v, residual, grad_norm (relative); see the module docstring
    "float32": (1e-5, 1e-6, 1e-8, None, 1e-5),
    "bf16_grads": (1e-3, 1e-4, 1e-5, 1e-3, 1e-3),
}


@pytest.mark.parametrize("n_micro,compress,cast", [
    (1, False, False), (2, False, False), (2, True, False), (2, False, True), (1, True, True),
])
def test_train_step_matches_reference(n_micro, compress, cast):
    """Two ``build_train_step`` steps from the JAX package's initial state
    (carried over by ``train_state_from_arrays``): params, m, v, step,
    residual and the metrics against the reference's, read back by
    ``train_state_to_arrays``; float32 compute."""
    arch = "llama3_2_3b"
    cfg = j_smoke_config(arch)
    jm = j_build_model(cfg, compute_dtype=jnp.float32)
    tm = build_model(smoke_config(arch), compute_dtype=torch.float32)
    js = j_make_train_state(jm, jax.random.PRNGKey(0), compress=compress)
    ts = train_state_from_arrays(jax.tree.map(np.asarray, js), device=CPU)
    assert int(ts.opt["step"]) == 0 and (ts.residual is None) == (not compress)
    opt = dict(warmup_steps=2, total_steps=10)
    kw = dict(n_micro=n_micro, compress_grads=compress, cast_params_bf16=cast)
    jstep = jax.jit(j_build_train_step(jm, JAdamWConfig(**opt), **kw))
    tstep = build_train_step(tm, AdamWConfig(**opt), **kw)
    p_bar, m_bar, v_bar, r_bar, n_bar = STEP_BARS["bf16_grads" if compress or cast else "float32"]
    rng = np.random.default_rng(0)
    for _ in range(2):
        b = {k: rng.integers(0, cfg.vocab_size, (4, 32)).astype(np.int32) for k in ("tokens", "labels")}
        js, jmet = jstep(js, _j(b))
        ts, tmet = tstep(ts, _t(b))
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(tmet["grad_norm"]), float(jmet["grad_norm"]), rtol=n_bar)
        assert float(tmet["lr"]) == float(jmet["lr"])
    out = train_state_to_arrays(ts)
    assert int(out["opt"]["step"]) == int(js.opt["step"]) == 2
    assert _max_err(out["params"], js.params) <= p_bar
    assert _max_err(out["opt"]["m"], js.opt["m"]) <= m_bar
    assert _max_err(out["opt"]["v"], js.opt["v"]) <= v_bar
    if compress:
        assert _max_err(out["residual"], js.residual) <= r_bar
    # The step frees the gradients it made.
    assert all(leaf.grad is None for leaf in tree_leaves(ts.params))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_train_step_contract(arch):
    """tests/test_models.py:47-68 on the port: one step with two
    micro-batches gives a finite loss and grad_norm, grad_norm > 0, and
    parameters that move; the CPU route launches no kernel."""
    cfg = smoke_config(arch)
    model = build_model(cfg)
    state = make_train_state(model, 0, device=CPU)
    before = [t.detach().clone() for t in tree_leaves(state.params)]
    launched = dict(attention.launches)
    step = build_train_step(model, AdamWConfig(warmup_steps=2), n_micro=2)
    state, metrics = step(state, _t(_batch(cfg)))
    assert attention.launches == launched
    assert np.isfinite(float(metrics["loss"]))
    assert np.isfinite(float(metrics["grad_norm"])) and float(metrics["grad_norm"]) > 0.0
    moved = max(float((a - b).abs().max()) for a, b in zip(tree_leaves(state.params), before))
    assert moved > 0.0


def test_train_launcher_resumes_from_its_checkpoint(tmp_path, capsys):
    """``launch/train.py --device cpu --smoke``: 3 steps with a checkpoint
    after every step, then a run to step 4 resumes at step 3 (the steps
    done) and ends in the state of an uninterrupted 4-step run, bit for
    bit; the resumed step's batch is the uninterrupted run's step 3."""
    d = str(tmp_path / "ck")
    args = ["--device", "cpu", "--global-batch", "4", "--seq", "16", "--ckpt-dir", d,
            "--ckpt-every", "1"]
    first = ttrain.main(args + ["--steps", "3"])
    assert first.start == 0 and len(first.metrics) == 3
    resumed = ttrain.main(args + ["--steps", "4"])
    out = capsys.readouterr().out
    assert "resumed at step 3" in out and "reduction plan:" in out
    assert resumed.start == 3 and len(resumed.metrics) == 1
    whole = ttrain.main(["--device", "cpu", "--global-batch", "4", "--seq", "16", "--steps", "4"])
    assert resumed.metrics[0] == whole.metrics[3]
    for a, b in zip(tree_leaves(dataclasses.asdict(resumed.state)),
                    tree_leaves(dataclasses.asdict(whole.state))):
        assert torch.equal(a, b)
    cfg = smoke_config("llama3.2-3b")
    data = ttrain.make_pipeline(ttrain.data_config(cfg, 4, 16))
    assert np.array_equal(data.batch_for_step(3)["tokens"],
                          ttrain.make_pipeline(ttrain.data_config(cfg, 4, 16)).batch_for_step(3)["tokens"])


def test_train_flags():
    args = ttrain.parse_args([])
    assert args.smoke and args.device is None and args.n_micro == 2 and args.steps == 100
    assert not ttrain.parse_args(["--no-smoke"]).smoke


def test_training_entry_points_have_no_quiet_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card: device=None runs on it")
    model = build_model(smoke_config("llama3.2-3b"))
    with pytest.raises(RuntimeError, match="CUDA"):
        make_train_state(model, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrain.train(steps=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_state_from_arrays({"params": {}, "opt": {"m": {}, "v": {}, "step": 0},
                                 "residual": None})
