"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX
package's ``moe_ffn`` on the same numpy-made inputs and JAX-drawn weights,
with and without capacity drops.

Tolerances: 1e-5 in float32 (the same algorithm; the frameworks' f32
products sum in different orders) and 4e-2 in bfloat16
(``tests/test_kernels.py:37``'s bf16 bar for one layer), for the output
and the aux loss. Which pairs are dropped is exact: a tie or a slot
assigned differently would zero a different token's output, far outside
either bar.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro_torch.interop import lm_params_from_arrays
from repro_torch.models import moe as tmoe

CPU = "cpu"
D, FF, E = 32, 48, 4


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _params(seed: int, zero_router: bool = False):
    pj = jmoe.init_moe(jax.random.PRNGKey(seed), D, FF, E)
    if zero_router:
        pj = dict(pj, router={"w": jnp.zeros_like(pj["router"]["w"])})
    return pj, lm_params_from_arrays(jax.tree.map(np.asarray, pj), device=CPU)


def _x(seed: int, dtype, B=2, S=12):
    x = np.random.default_rng(seed).standard_normal((B, S, D)).astype(np.float32)
    xj = jnp.asarray(x, dtype)
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    return xj, torch.from_numpy(np.array(xj.astype(jnp.float32))).to(tdt)


@pytest.mark.parametrize("dtype,tol", [(jnp.float32, 1e-5), (jnp.bfloat16, 4e-2)])
@pytest.mark.parametrize(
    "top_k,cf,normalize",
    [(2, 8.0, True), (2, 1.0, True), (2, 0.5, True), (1, 1.0, True), (2, 1.0, False),
     (3, 0.5, False)],
)
def test_moe_ffn_matches_reference(dtype, tol, top_k, cf, normalize):
    """Outputs and aux: no drops (cf 8), drops (cf 1.0, 0.5), unnormalized
    gates."""
    pj, pt = _params(top_k * 10 + int(cf * 2))
    xj, xt = _x(int(cf * 4) + top_k, dtype)
    yj, aj = jmoe.moe_ffn(pj, xj, E, top_k, capacity_factor=cf, normalize=normalize)
    with torch.no_grad():
        yt, at = tmoe.moe_ffn(pt, xt, E, top_k, capacity_factor=cf, normalize=normalize)
    assert yt.dtype == xt.dtype and yt.shape == xt.shape
    assert at.dtype == torch.float32 and at.dim() == 0
    np.testing.assert_allclose(_np(yt), _np(yj), atol=tol, rtol=tol)
    np.testing.assert_allclose(float(at), float(aj), atol=tol, rtol=tol)
    # The same tokens lost every pair (an all-zero output row).
    np.testing.assert_array_equal(
        (_np(yt) == 0).all(axis=-1), (_np(yj) == 0).all(axis=-1)
    )


@pytest.mark.parametrize("top_k,cf", [(2, 1.0), (2, 0.5), (3, 1.0)])
def test_all_ties_route_to_the_lowest_experts_and_drop_as_jax(top_k, cf):
    """A zero router gives every expert the same probability: the port
    routes every token to experts 0..k-1 (``jax.lax.top_k``'s tie order)
    and drops the pairs past each expert's capacity in token order, the
    pairs JAX drops."""
    pj, pt = _params(7, zero_router=True)
    xj, xt = _x(8, jnp.float32, B=2, S=10)
    T = 20
    probs = torch.full((T, E), 1.0 / E)
    _, idx = tmoe.route_top_k(probs, top_k)
    assert torch.equal(idx, torch.arange(top_k).expand(T, top_k))
    _, jidx = jax.lax.top_k(jnp.full((T, E), 1.0 / E), top_k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))

    yj, aj = jmoe.moe_ffn(pj, xj, E, top_k, capacity_factor=cf)
    with torch.no_grad():
        yt, at = tmoe.moe_ffn(pt, xt, E, top_k, capacity_factor=cf)
    cap = tmoe.capacity(T, top_k, E, cf)
    assert cap == max(int(np.ceil(T * top_k / E * cf)), top_k)
    # Each of experts 0..k-1 takes one pair of every token: tokens past the
    # capacity lose all their pairs, the others keep all.
    kept = np.arange(T) < cap
    for y in (yj, yt):
        rows = _np(y).reshape(T, D)
        np.testing.assert_array_equal((rows != 0).any(axis=-1), kept)
    np.testing.assert_allclose(_np(yt), _np(yj), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(float(at), float(aj), atol=1e-6, rtol=1e-6)


def test_capacity_is_the_reference_formula():
    for T, k, e, cf in [(4, 2, 16, 1.25), (2048, 2, 16, 1.25), (7, 4, 16, 8.0),
                        (3, 2, 4, 1.0), (100, 2, 16, 0.01)]:
        assert tmoe.capacity(T, k, e, cf) == max(int(np.ceil(T * k / e * cf)), k)
    assert tmoe.capacity(4, 2, 16, 1.25) == 2  # the jamba decode step (B = 4)
