"""The port's recurrent mixers (``repro_torch.models.ssm``: SSD, mLSTM,
sLSTM) against the JAX package's ``repro.models.ssm`` on the same
numpy-made inputs and JAX-drawn weights (carried across by
``lm_params_from_arrays``): the whole-sequence forms, their final states,
and S decode steps from the zero state.

Tolerances: 1e-5 in float32 for the pieces (the same algorithm; the
frameworks' f32 sums run in different orders), 1e-4 for a whole mixer and
for the states (``tests/test_torch_models.py``'s whole-model float32 bar: the order differences
pass through exp, cumulative sums, the chunk products and a norm, and a
decode state accumulates S steps); 4e-2 in bfloat16 (``tests/test_kernels.py:37``'s
bar for one layer). The bf16 cases exercise the two rounding traps of
the reference: ``jax.nn.gelu`` is the tanh approximation (the exact erf
form differs by up to 1.5e-4 a value, and far more after the
projections), and ``k / np.sqrt(P)`` is float32 in JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke_config
from repro.models import ssm as jssm
from repro_torch.configs import smoke_config
from repro_torch.interop import lm_params_from_arrays, lm_tree_to_arrays
from repro_torch.models import ssm as tssm

CPU = "cpu"
DTYPES = [(jnp.float32, 1e-5), (jnp.bfloat16, 4e-2)]
MIXER_DTYPES = [(jnp.float32, 1e-4), (jnp.bfloat16, 4e-2)]


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def _pair(a: np.ndarray, dtype):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    aj = jnp.asarray(a, dtype)
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    return aj, torch.from_numpy(np.array(aj.astype(jnp.float32))).to(tdt)


def _to_torch(tree):
    return lm_params_from_arrays(jax.tree.map(np.asarray, tree), device=CPU)


def _tree_close(got, want, tol):
    lt = jax.tree_util.tree_leaves(lm_tree_to_arrays(got))
    lj = jax.tree_util.tree_leaves(jax.tree.map(np.asarray, want))
    assert len(lt) == len(lj)
    for a, b in zip(lt, lj):
        assert a.shape == b.shape
        _close(a, b, tol)


# --------------------------------------------------------------------------
# SSD pieces
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_causal_conv_and_segsum_match_reference(dtype, tol):
    rng = np.random.default_rng(0)
    xj, xt = _pair(rng.standard_normal((2, 9, 12)), dtype)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    b = rng.standard_normal(12).astype(np.float32)
    got = tssm._causal_conv(xt, torch.from_numpy(w), torch.from_numpy(b))
    assert got.dtype == xt.dtype
    _close(got, jssm._causal_conv(xj, jnp.asarray(w), jnp.asarray(b)), tol)

    a = -rng.uniform(0, 2, (2, 3, 7)).astype(np.float32)
    sj, st = jssm._segsum(jnp.asarray(a)), tssm._segsum(torch.from_numpy(a))
    np.testing.assert_array_equal(np.isneginf(_np(st)), np.isneginf(np.asarray(sj)))
    finite = np.isfinite(np.asarray(sj))
    np.testing.assert_allclose(_np(st)[finite], np.asarray(sj)[finite], atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("S,chunk,with_state", [(24, 8, False), (24, 8, True), (16, 32, True)])
def test_ssd_scan_matches_reference(dtype, tol, S, chunk, with_state):
    """Several chunks (the inter-chunk loop), one chunk shorter than
    ``chunk``, with and without an initial state."""
    rng = np.random.default_rng(S + chunk)
    B, H, P, N = 2, 3, 8, 5
    xj, xt = _pair(rng.standard_normal((B, S, H, P)), dtype)
    a = -rng.uniform(0.01, 0.5, (B, S, H)).astype(np.float32)
    Bj, Bt = _pair(rng.standard_normal((B, S, N)), dtype)
    Cj, Ct = _pair(rng.standard_normal((B, S, N)), dtype)
    s0 = rng.standard_normal((B, H, P, N)).astype(np.float32) if with_state else None
    yj, fj = jssm.ssd_scan(xj, jnp.asarray(a), Bj, Cj, chunk,
                           None if s0 is None else jnp.asarray(s0))
    yt, ft = tssm.ssd_scan(xt, torch.from_numpy(a), Bt, Ct, chunk,
                           None if s0 is None else torch.from_numpy(s0))
    assert yt.dtype == xt.dtype and ft.dtype == torch.float32
    _close(yt, yj, tol)
    _close(ft, fj, max(tol, 1e-4))


def test_ssd_scan_rejects_a_ragged_length():
    x = torch.zeros(1, 10, 2, 4)
    with pytest.raises(ValueError, match="divisible"):
        tssm.ssd_scan(x, torch.zeros(1, 10, 2), torch.zeros(1, 10, 3), torch.zeros(1, 10, 3), 4)


# --------------------------------------------------------------------------
# Whole mixers: forward, final state, S decode steps
# --------------------------------------------------------------------------

MIXERS = {
    "ssd": ("jamba_v0_1_52b", "init_ssd", "ssd_forward", "ssd_init_state", "ssd_decode_step"),
    "mlstm": ("xlstm_350m", "init_mlstm", "mlstm_forward", "mlstm_init_state",
              "mlstm_decode_step"),
    "slstm": ("xlstm_350m", "init_slstm", "slstm_forward", "slstm_init_state",
              "slstm_decode_step"),
}


@pytest.mark.parametrize("dtype,tol", MIXER_DTYPES)
@pytest.mark.parametrize("mixer", list(MIXERS))
def test_mixer_forward_and_decode_match_reference(mixer, dtype, tol):
    """The whole-sequence form (output and final state) and S decode steps
    from the zero state (each step's output and the last state), against
    the JAX package. The SSD runs two chunks."""
    arch, init, fwd, init_state, dec = MIXERS[mixer]
    cfg = smoke_config(arch)
    jcfg = j_smoke_config(arch)
    pj = getattr(jssm, init)(jax.random.PRNGKey(3), jcfg)
    pt = _to_torch(pj)
    B, S = 2, 2 * cfg.ssm_chunk if mixer == "ssd" else 12
    uj, ut = _pair(np.random.default_rng(4).standard_normal((B, S, cfg.d_model)), dtype)

    yj, sj = getattr(jssm, fwd)(pj, jcfg, uj)
    with torch.no_grad():
        yt, st = getattr(tssm, fwd)(pt, cfg, ut)
    assert yt.dtype == ut.dtype
    _close(yt, yj, tol)
    _tree_close(st, sj, max(tol, 1e-4))

    step_j = jax.jit(lambda p, u, s: getattr(jssm, dec)(p, jcfg, u, s))
    sj = getattr(jssm, init_state)(jcfg, B)
    st = getattr(tssm, init_state)(cfg, B, CPU)
    _tree_close(st, sj, 0)
    for t in range(S):
        oj, sj = step_j(pj, uj[:, t:t + 1], sj)
        with torch.no_grad():
            ot, st = getattr(tssm, dec)(pt, cfg, ut[:, t:t + 1], st)
        assert ot.dtype == ut.dtype
        _close(ot, oj, tol)
    _tree_close(st, sj, max(tol, 1e-4))
    # The state keeps the reference's leaf types: f32, with the SSD conv
    # buffer and the sLSTM h in bf16.
    assert [str(t.dtype).removeprefix("torch.") for t in jax.tree_util.tree_leaves(st)] == [
        str(a.dtype) for a in jax.tree_util.tree_leaves(sj)]
