"""Port flash attention's backward pass: the plain log-sum-exp and backward
(``kernels/ref.py``) and the port's ``torch.autograd.Function``
(``models/flash.py``) against the JAX package's custom VJP
(``repro.models.flash``: ``_flash_fwd_inner`` and ``jax.grad`` through
``flash_attention``), on the same numpy-made inputs.

Tolerances: 5e-5 in float32, the reference's own bar for its flash
gradients (``tests/test_kernels.py:224``): both sides run the same
algorithm and differ only in the order of float32 sums. In bfloat16,
4e-2 elementwise against the JAX package's bfloat16 result
(``tests/test_kernels.py:37``), and each row of D values against its
float32 result on the same bf16-valued inputs (the exact answer the two
approximate): an output row within 1e-2 of its norm (the forward's bar
in ``chip_smoke.py``), a gradient row within 2e-2. The backward rounds
twice (p to bf16 for dv, ds for dq and dk) and ds sums to zero over each
row, so its rows cancel: on these inputs the port's gradient rows are up
to 1.6e-2 off, the reference's own bfloat16 rows (whose einsums also
round s and dp to bfloat16) up to 2.5e-2. A gradient row can be zero in exact arithmetic
(causal query 0: p = 1 and dp = delta, so ds = 0 and dq[0] is rounding
noise of summands of the usual size), so a row's norm is floored at the
mean row norm of its tensor, the size of the terms whose rounding the
row carries. The JAX
model repeats K and V to H heads before flash attention
(``src/repro/models/layers.py:250-259``); the port folds the G query
heads instead, so both layouts are held against it. The CUDA kernels are
held against the plain versions on the card (the ``cuda`` test below and
``chip_smoke.py`` phase 8a).
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.flash import _flash_fwd_inner
from repro.models.flash import flash_attention as j_flash
from repro_torch.kernels import attention, ref
from repro_torch.kernels import ops as tops
from repro_torch.models.flash import flash_attention as port_flash

F32_TOL = 5e-5
BF16_TOL, BF16_ROW_TOL, BF16_GRAD_ROW_TOL = 4e-2, 1e-2, 2e-2


def _inputs(seed, B, S, T, H, KV, D, dtype):
    """q, k, v, do as JAX arrays and torch tensors of the same values."""
    rng = np.random.default_rng(seed)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    out = []
    for shape in ((B, S, H, D), (B, T, KV, D), (B, T, KV, D), (B, S, H, D)):
        j = jnp.asarray(rng.standard_normal(shape), jdt)
        out.append((j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt)))
    return out


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _row_err(got: np.ndarray, want: np.ndarray) -> float:
    """Largest ||got - want|| / ||want|| over rows of D values, each row's
    norm floored at the mean row norm."""
    norm = np.linalg.norm(want, axis=-1)
    return float((np.linalg.norm(got - want, axis=-1) / np.maximum(norm, max(norm.mean(), 1e-30))).max())


def _close(got, want, dtype, exact=None, row_tol=BF16_GRAD_ROW_TOL):
    """float32: 5e-5. bfloat16: 4e-2 against the reference's bf16 ``want``
    and, given the reference's float32 ``exact``, each row within
    ``row_tol`` of it."""
    g, w = _np(got), _np(want)
    if dtype == "float32":
        np.testing.assert_allclose(g, w, atol=F32_TOL, rtol=F32_TOL)
        return
    np.testing.assert_allclose(g, w, atol=BF16_TOL, rtol=BF16_TOL)
    if exact is not None:
        assert _row_err(g, _np(exact)) <= row_tol, _row_err(g, _np(exact))


def _port_grads(qt, kt, vt, dot, causal):
    q, k, v = (t.clone().requires_grad_() for t in (qt, kt, vt))
    o = port_flash(q, k, v, causal)
    o.backward(dot)
    return o, q.grad, k.grad, v.grad


@pytest.mark.parametrize("B,S,H,KV,D,bk", [
    (2, 32, 8, 2, 16, 16), (1, 64, 6, 2, 32, 32), (1, 48, 4, 1, 16, 16), (2, 32, 4, 4, 96, 32),
])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_lse_matches_reference_forward(B, S, H, KV, D, bk, causal):
    """lse [B, S, H]: the natural log-sum-exp of the scaled scores, as
    ``_flash_fwd_inner`` returns it (float32 inputs, 5e-5)."""
    (qj, qt), (kj, kt), (vj, vt), _ = _inputs(S + D, B, S, S, H, KV, D, "float32")
    o, lse = tops.flash_attention(qt, kt, vt, causal, return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (B, S, H)
    oj, lsej = _flash_fwd_inner(qj, kj, vj, causal, bk)
    _close(o, oj, "float32")
    _close(lse, lsej, "float32")
    assert torch.equal(o, tops.flash_attention(qt, kt, vt, causal))


@pytest.mark.parametrize("B,S,T,H,KV,D,bk,causal", [
    (2, 32, 32, 8, 2, 16, 16, True),    # G = 4
    (2, 32, 32, 8, 2, 16, 16, False),
    (1, 64, 64, 6, 2, 32, 32, True),    # G = 3, as llama3.2-3b
    (1, 48, 48, 4, 1, 16, 16, True),    # MQA
    (2, 32, 32, 4, 4, 32, 16, False),   # MHA
    (1, 16, 48, 4, 2, 16, 16, False),   # T != S (cross-attention)
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_grad_matches_jax_grad(B, S, T, H, KV, D, bk, causal, dtype):
    """The port's autograd against ``jax.grad`` of the reference flash on the
    same K and V (GQA, no repeat)."""
    (qj, qt), (kj, kt), (vj, vt), (doj, dot) = _inputs(B + S + T + H + D, B, S, T, H, KV, D, dtype)

    def f(q, k, v):
        return jnp.sum(j_flash(q, k, v, causal, bk).astype(jnp.float32) * doj.astype(jnp.float32))

    f32 = [x.astype(jnp.float32) for x in (qj, kj, vj)]
    want = jax.grad(f, argnums=(0, 1, 2))(qj, kj, vj)
    exact = jax.grad(f, argnums=(0, 1, 2))(*f32)
    before = dict(attention.launches)
    o, *got = _port_grads(qt, kt, vt, dot, causal)
    assert attention.launches == before  # the CPU route launches nothing
    _close(o, j_flash(qj, kj, vj, causal, bk), dtype, j_flash(*f32, causal, bk), BF16_ROW_TOL)
    for g, w, e, t in zip(got, want, exact, (qt, kt, vt)):
        assert g.dtype == t.dtype and g.shape == t.shape
        _close(g, w, dtype, e)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_grad_matches_jax_model_layout(causal, dtype):
    """The JAX model repeats K and V to H heads before flash attention; the
    gradient reaching the unrepeated K and V through that repeat equals
    the port's folded-head gradient."""
    B, S, H, KV, D = 2, 32, 6, 2, 16
    G = H // KV
    (qj, qt), (kj, kt), (vj, vt), (doj, dot) = _inputs(11, B, S, S, H, KV, D, dtype)

    def f(q, k, v):
        o = j_flash(q, jnp.repeat(k, G, axis=2), jnp.repeat(v, G, axis=2), causal, 16)
        return jnp.sum(o.astype(jnp.float32) * doj.astype(jnp.float32))

    want = jax.grad(f, argnums=(0, 1, 2))(qj, kj, vj)
    exact = jax.grad(f, argnums=(0, 1, 2))(*(x.astype(jnp.float32) for x in (qj, kj, vj)))
    _, *got = _port_grads(qt, kt, vt, dot, causal)
    for g, w, e in zip(got, want, exact):
        _close(g, w, dtype, e)


@pytest.mark.parametrize("S,T,causal", [(37, 37, True), (37, 37, False), (5, 41, False), (1, 1, True)])
def test_port_grad_matches_autograd_through_plain_forward(S, T, causal):
    """A gradcheck of the backward formulas: in float32 the port's backward
    equals autograd through ``ref_flash_attention``'s softmax within float32
    rounding (1e-5), at ragged lengths no block divides."""
    torch.manual_seed(S + T)
    q = torch.randn(2, S, 6, 16, requires_grad=True)
    k = torch.randn(2, T, 2, 16, requires_grad=True)
    v = torch.randn(2, T, 2, 16, requires_grad=True)
    do = torch.randn(2, S, 6, 16)
    got = torch.autograd.grad(port_flash(q, k, v, causal), (q, k, v), do)
    want = torch.autograd.grad(ref.ref_flash_attention(q, k, v, causal), (q, k, v), do)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)


def test_backward_takes_a_strided_output_gradient():
    """autograd may hand the backward a non-contiguous or expanded gradient;
    the Function makes it contiguous before the wrapper's layout check."""
    torch.manual_seed(0)
    q = torch.randn(1, 8, 4, 16, requires_grad=True)
    k = torch.randn(1, 8, 2, 16, requires_grad=True)
    o = port_flash(q, k, k, True)
    o.sum().backward()  # an expanded ones tensor
    dense = torch.autograd.grad(port_flash(q, k, k, True), (q, k), torch.ones(1, 8, 4, 16))
    assert torch.allclose(q.grad, dense[0]) and torch.allclose(k.grad, dense[1])
    q.grad = None
    o = port_flash(q, k, k, True)
    (o.transpose(1, 2).contiguous() * 2).sum().backward()
    assert torch.allclose(q.grad, 2 * dense[0])


def test_backward_wrapper_rejects_bad_inputs():
    q = torch.zeros((1, 8, 4, 16))
    k = torch.zeros((1, 8, 2, 16))
    lse = torch.zeros((1, 8, 4))
    with pytest.raises(ValueError):
        tops.flash_attention_bwd(q, k, k, q, lse[:, :4], q)
    with pytest.raises(ValueError):
        tops.flash_attention_bwd(q, k, k, q, lse.double(), q)
    with pytest.raises(ValueError):
        tops.flash_attention_bwd(q, k, k, q[:, :4], lse, q)
    with pytest.raises(TypeError):
        tops.flash_attention_bwd(q, k, k, q, lse, q.bfloat16())


@pytest.mark.cuda
def test_cuda_backward_kernels_match_plain_versions_on_card():
    """On a card: the forward's lse and the three backward kernels against
    their plain versions, swept over D = 16, 48, 64, 96, 128, G = 1, 3, 4,
    8, S = 1, 65, 1000 (rows and key tiles ending mid-tile, folded rows of
    one query crossing a tile), causal or not, a T other than S without
    the causal mask, in float32 (2e-5) and bfloat16 (4e-2 elementwise and
    1e-2 of each row's norm, floored at the mean row norm, where that
    mean reaches the elementwise bar), on q, k, v as strided views of one fused
    tensor; the forward's output is the same with and without lse. The
    bf16 bodies' edges: S shorter than one row tile (64 // G positions),
    S * G ending mid-tile for G = 3 and 8 at D = 128, fewer units than SMs
    (B = KV = 1, S = 65) and many more (B = KV = 8, S = 512), a
    non-causal T = 300 ending mid key tile, G = 96 (a row tile takes 48 of
    the 96 heads); and every result is the same from call to call (no
    atomics)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the CPU route is covered above)")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    bars = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (4e-2, 1e-2)}

    def close(got, want, dtype, what):
        tol, row_tol = bars[dtype]
        torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol, msg=what)
        # Each row within row_tol of its norm, floored at the tensor's mean
        # row norm (a row that is zero in exact arithmetic holds noise). A
        # tensor whose mean row norm is under the elementwise bar is all
        # noise (S = T = 1, causal: ds = 0, so dq = dk = 0) and is held by
        # that bar alone.
        norm = want.float().norm(dim=-1)
        mean = float(norm.mean())
        if mean >= tol:
            d = (got.float() - want.float()).norm(dim=-1)
            rel = float((d / norm.clamp_min(mean)).max())
            assert rel <= row_tol, (what, rel)

    # (B, KV, D, G, S, T, causal)
    cases = [(2, 2, D, G, S, S, causal) for D, G, S, causal in itertools.product(
        (16, 48, 64, 96, 128), (1, 3, 4, 8), (1, 65, 1000), (True, False))]
    cases += [(2, 2, D, G, 65, 200, False) for D in (64, 128) for G in (1, 3)]
    cases += [(2, 2, 128, G, S, S, causal) for G, S in ((1, 5), (3, 10), (8, 3), (3, 100), (8, 100))
              for causal in (True, False)]
    cases += [(1, 1, 128, 3, 65, 65, causal) for causal in (True, False)]
    cases += [(8, 8, 128, 3, 512, 512, True)]
    cases += [(2, 2, D, G, 65, 300, False) for D in (64, 128) for G in (1, 3, 8)]
    cases += [(1, 1, 16, 96, 33, 33, causal) for causal in (True, False)]  # G > 64
    for dtype in (torch.float32, torch.bfloat16):
        for B, KV, D, G, S, T, causal in cases:
            H = G * KV
            what = f"B={B} KV={KV} D={D} G={G} S={S} T={T} causal={causal} {dtype}"
            q = torch.randn(B, S, H + 2 * KV, D, generator=gen, device="cuda").to(dtype)[:, :, :H]
            kv = torch.randn(B, T, 2 * KV, D, generator=gen, device="cuda").to(dtype)
            k, v = kv[:, :, :KV], kv[:, :, KV:]
            do = torch.randn(B, S, H, D, generator=gen, device="cuda").to(dtype)
            o, lse = tops.flash_attention(q, k, v, causal, return_lse=True)
            o_ref, lse_ref = ref.ref_flash_attention(q, k, v, causal, return_lse=True)
            assert torch.equal(o, tops.flash_attention(q, k, v, causal)), what
            close(o, o_ref, dtype, what)
            close(lse[..., None], lse_ref[..., None], dtype, "lse " + what)
            before = dict(attention.launches)
            got = tops.flash_attention_bwd(q, k, v, o, lse, do, causal)
            for name in ("flash_bwd_delta", "flash_bwd_dkdv", "flash_bwd_dq"):
                assert attention.launches[name] == before[name] + 1
            want = ref.ref_flash_attention_bwd(q, k, v, o, lse, do, causal)
            again = tops.flash_attention_bwd(q, k, v, o, lse, do, causal)
            for name, g, w, a in zip(("dq", "dk", "dv"), got, want, again):
                assert g.dtype == w.dtype and g.shape == w.shape
                close(g, w, dtype, f"{name} {what}")
                assert torch.equal(g, a), f"{name} differs between two calls at {what}"
