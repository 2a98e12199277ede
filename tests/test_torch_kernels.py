"""Port kernels: the plain PyTorch versions of the cpm kernels against the
JAX package's Pallas kernels (interpret mode) and its NumPy oracles.

Every tolerance is 0. The bound is adds and maxes in a fixed association,
so the float32 twin equals the Pallas kernel bit for bit on any inputs.
The NumPy oracles compute in float64; against them the inputs are
integer-valued, where every float32 sum is exact and the two agree
exactly too. The CUDA kernel itself is held against the same twins on
the card (``chip_smoke.py`` and the ``cuda``-marked test below).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import cpm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref


def _dag_weights(rng, B, n, integer=False):
    w = np.full((B, n, n), -np.inf)
    for b in range(B):
        for _ in range(3 * n):
            u, v = sorted(rng.choice(n, 2, replace=False))
            x = float(rng.integers(1, 10)) if integer else rng.uniform(1, 10)
            w[b, u, v] = max(w[b, u, v], x)
    return w


def _ragged_lb_megabatch(rng, B, n, integer=False):
    """The reference tests' ragged mega-batch: each row a different-size DAG
    padded to n, some rows all-padding, ``extra`` disabled on some rows."""
    w = np.full((B, n, n), -np.inf)
    p = np.zeros((B, n), np.float32)
    extra = np.full(B, -np.inf, np.float32)
    draw = (lambda lo, hi, size=None: rng.integers(lo, hi, size=size).astype(np.float32)) \
        if integer else (lambda lo, hi, size=None: rng.uniform(lo, hi, size=size))
    for b in range(B):
        nb = int(rng.integers(0, n + 1))  # 0 = all-padding row
        p[b, :nb] = draw(1, 100, size=nb)
        for _ in range(3 * nb):
            if nb >= 2:
                u, v = sorted(rng.choice(nb, 2, replace=False))
                w[b, u, v] = max(w[b, u, v], float(draw(1, 10)))
        if rng.uniform() < 0.7 and nb:
            extra[b] = draw(0, 300)
    return w, p, extra


def _mask(rng, w, integer=False):
    mask = np.zeros(w.shape, np.float32)
    sel = np.isfinite(w) & (rng.uniform(size=w.shape) < 0.5)
    k = int(sel.sum())
    mask[sel] = rng.integers(0, 20, size=k) if integer else rng.uniform(0, 20, size=k)
    return mask


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def _pallas_lb(w, p, extra, mask=None, block_b=8, n_iters=None):
    return np.asarray(
        jops.batched_combined_lb(
            jnp.asarray(w, jnp.float32), jnp.asarray(p), jnp.asarray(extra),
            mask=None if mask is None else jnp.asarray(mask),
            block_b=block_b, n_iters=n_iters,
        )
    )


@pytest.mark.parametrize("B,n", [(8, 8), (16, 12), (32, 16)])
def test_critical_path_matches_pallas_and_oracle(B, n):
    rng = np.random.default_rng(n)
    w = _dag_weights(rng, B, n)
    want = np.asarray(jops.batched_critical_path(jnp.asarray(w, jnp.float32)))
    got = tops.batched_critical_path(_t(w)).numpy()
    np.testing.assert_array_equal(got, want)
    wi = _dag_weights(rng, B, n, integer=True)
    got_i = tops.batched_critical_path(_t(wi)).numpy()
    np.testing.assert_array_equal(got_i, jref.ref_critical_path(wi))


@pytest.mark.parametrize("n_iters", [0, 1, 3])
def test_critical_path_truncated_rounds_match_pallas(n_iters):
    """Rounds below the DAG's depth: Jacobi semantics, each round reads only
    the previous round's dist."""
    rng = np.random.default_rng(5)
    w = _dag_weights(rng, 16, 12)
    want = np.asarray(
        jops.batched_critical_path(jnp.asarray(w, jnp.float32), n_iters=n_iters)
    )
    got = tops.batched_critical_path(_t(w), n_iters=n_iters).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("B,n,block_b", [(13, 8, 8), (32, 12, 8), (257, 16, 64)])
def test_combined_lb_ragged_matches_pallas_and_oracle(B, n, block_b):
    rng = np.random.default_rng(B * n)
    w, p, extra = _ragged_lb_megabatch(rng, B, n)
    got = tops.batched_combined_lb(_t(w), _t(p), _t(extra), block_b=block_b).numpy()
    np.testing.assert_array_equal(got, _pallas_lb(w, p, extra, block_b=block_b))
    empty = (p.sum(axis=1) == 0) & ~np.isfinite(extra)
    assert (got[empty] == 0.0).all()
    wi, pi, ei = _ragged_lb_megabatch(rng, B, n, integer=True)
    got_i = tops.batched_combined_lb(_t(wi), _t(pi), _t(ei)).numpy()
    np.testing.assert_array_equal(got_i, jref.ref_combined_lb(wi, pi, ei))


def test_combined_lb_extra_term_dominates():
    rng = np.random.default_rng(7)
    B, n = 16, 8
    w, p, _ = _ragged_lb_megabatch(rng, B, n)
    cpm_only = tops.batched_combined_lb(
        _t(w), _t(p), _t(np.full(B, -np.inf))
    ).numpy()
    extra = cpm_only + rng.uniform(1, 50, size=B).astype(np.float32)
    got = tops.batched_combined_lb(_t(w), _t(p), _t(extra)).numpy()
    np.testing.assert_array_equal(got, extra)
    np.testing.assert_array_equal(got, _pallas_lb(w, p, extra))
    lo = cpm_only - np.float32(1.0)
    got_lo = tops.batched_combined_lb(_t(w), _t(p), _t(lo[:, None])).numpy()
    np.testing.assert_array_equal(got_lo, cpm_only)


@pytest.mark.parametrize("B,n,block_b", [(13, 8, 8), (32, 12, 8), (257, 16, 64)])
def test_combined_lb_mask_matches_pallas_and_oracle(B, n, block_b):
    rng = np.random.default_rng(B * n + 1)
    w, p, extra = _ragged_lb_megabatch(rng, B, n)
    mask = _mask(rng, w)
    got = tops.batched_combined_lb(
        _t(w), _t(p), _t(extra), mask=_t(mask), block_b=block_b
    ).numpy()
    np.testing.assert_array_equal(
        got, _pallas_lb(w, p, extra, mask=mask, block_b=block_b)
    )
    base = tops.batched_combined_lb(_t(w), _t(p), _t(extra)).numpy()
    assert (got >= base).all()
    wi, pi, ei = _ragged_lb_megabatch(rng, B, n, integer=True)
    mi = _mask(rng, wi, integer=True)
    got_i = tops.batched_combined_lb(_t(wi), _t(pi), _t(ei), mask=_t(mi)).numpy()
    np.testing.assert_array_equal(got_i, jref.ref_combined_lb(wi, pi, ei, mask=mi))


def test_combined_lb_zero_mask_is_identity():
    rng = np.random.default_rng(11)
    B, n = 24, 10
    w, p, extra = _ragged_lb_megabatch(rng, B, n)
    base = tops.batched_combined_lb(_t(w), _t(p), _t(extra)).numpy()
    zero = tops.batched_combined_lb(
        _t(w), _t(p), _t(extra), mask=torch.zeros((B, n, n))
    ).numpy()
    np.testing.assert_array_equal(base, zero)
    np.testing.assert_array_equal(base, _pallas_lb(w, p, extra))


def test_cpu_tensor_takes_plain_version_without_launching():
    rng = np.random.default_rng(3)
    w, p, extra = _ragged_lb_megabatch(rng, 9, 8)
    before = dict(cpm.launches)
    got = cpm.batched_combined_lb(_t(w), _t(p), _t(extra), mask=_t(_mask(rng, w)))
    cpm.batched_critical_path(_t(w))
    assert cpm.launches == before
    assert got.device.type == "cpu" and got.dtype == torch.float32


@pytest.mark.parametrize(
    "bad",
    ["w_dtype", "w_shape", "p_shape", "extra_shape", "mask_shape", "noncontig", "n_too_big"],
)
def test_wrapper_rejects_bad_inputs(bad):
    B, n = 4, 8
    w = torch.full((B, n, n), float("-inf"))
    p = torch.zeros((B, n))
    extra = torch.zeros(B)
    mask = None
    err = ValueError
    if bad == "w_dtype":
        w, err = w.double(), TypeError
    elif bad == "w_shape":
        w = torch.zeros((B, n, n + 1))
    elif bad == "p_shape":
        p = torch.zeros((B, n + 1))
    elif bad == "extra_shape":
        extra = torch.zeros(B + 1)
    elif bad == "mask_shape":
        mask = torch.zeros((B, n, n - 1))
    elif bad == "noncontig":
        w = torch.full((B, n, 2 * n), float("-inf"))[:, :, ::2]
    elif bad == "n_too_big":
        n = cpm.MAX_N + 1
        w, p = torch.full((1, n, n), float("-inf")), torch.zeros((1, n))
        extra = torch.zeros(1)
    with pytest.raises(err):
        cpm.batched_combined_lb(w, p, extra, mask=mask)


@pytest.mark.cuda
def test_cuda_kernels_equal_plain_versions_on_card():
    """On a card: every entry point equals its plain version exactly."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the CPU route is covered above)")
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    for B, n in [(257, 8), (257, 12), (257, 128), (1024, 16)]:
        w, p, extra = _ragged_lb_megabatch(rng, B, n)
        mask = _mask(rng, w)
        tw, tp, te, tm = (_t(a).to(dev) for a in (w, p, extra, mask))
        before = dict(cpm.launches)
        assert torch.equal(
            cpm.batched_combined_lb(tw, tp, te), tref.ref_combined_lb(tw, tp, te)
        )
        assert torch.equal(
            cpm.batched_combined_lb(tw, tp, te, mask=tm),
            tref.ref_combined_lb(tw, tp, te, mask=tm),
        )
        assert torch.equal(cpm.batched_critical_path(tw), tref.ref_critical_path(tw))
        dense = ("combined_lb", "combined_lb_masked", "critical_path")
        assert all(cpm.launches[k] == before[k] + (k in dense) for k in before)


@pytest.mark.cuda
def test_cuda_dense_kernels_sweep_on_card():
    """On a card: the [B, n, n] kernels equal their plain versions over n
    (lane groups of 2, 4 and 16 lanes with vector and scalar loads, the
    shared-tile body above 32), rounds 0, 1 and the depth, and ``extra`` at
    -inf, dominated and dominating; B = 257 is no multiple of any block's
    rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the CPU route is covered above)")
    rng = np.random.default_rng(1)
    dev = torch.device("cuda")
    B = 257
    for n in (1, 5, 8, 16, 17, 32, 33, 64, 128):
        w, p, _ = _ragged_lb_megabatch(rng, B, n)
        kind = rng.integers(0, 3, size=B)
        extra = np.where(kind == 0, -np.inf, np.where(kind == 1, 0.5, 1e4))
        mask = _mask(rng, w)
        tw, tp, te, tm = (_t(a).to(dev) for a in (w, p, extra, mask))
        for it in sorted({0, 1, n - 1}):
            assert torch.equal(
                cpm.batched_combined_lb(tw, tp, te, n_iters=it),
                tref.ref_combined_lb(tw, tp, te, n_iters=it),
            ), (n, it)
            assert torch.equal(
                cpm.batched_combined_lb(tw, tp, te, mask=tm, n_iters=it),
                tref.ref_combined_lb(tw, tp, te, mask=tm, n_iters=it),
            ), (n, it)
            assert torch.equal(
                cpm.batched_critical_path(tw, n_iters=it),
                tref.ref_critical_path(tw, n_iters=it),
            ), (n, it)
    torch.cuda.synchronize()
