"""The MoE dispatch's two routes (``repro_torch.models.moe._dispatch``):
the plain twin of the JAX package's (``kernels/ref.py``:
``ref_moe_dispatch``, the CPU route) and the hand-written CUDA kernels of
``kernels/csrc/moe_dispatch.cu`` behind the ``repro_torch::moe_dispatch``
operator (the CUDA route).

On the CPU: the plain dispatch reads a pair's row in place from the token
rows exactly as from a copy a pair (``_pair_rows``); the operator's CPU
implementation and its autograd formula give the plain route's values and
gradients; the fake implementation's shapes; the route and its counter.

On a card (``cuda``): the kernels against the plain route, with
``torch.equal`` on every output, over token counts, top-k, experts,
capacity factors, both types, a row width with a tail, ties, one expert
for every pair, the mesh form (an offset and a part of the experts), both
source shapes and strided rows; the gradients; the counter. The JAX
package is compared in ``tests/test_torch_moe.py``.
"""

import itertools

import pytest
import torch

from repro_torch.kernels import moe_dispatch as kmd
from repro_torch.kernels import ref
from repro_torch.models import moe as tmoe
from repro_torch.obs.trace import Tracer, installed

OPS = torch.ops.repro_torch


def _route(gen, T: int, k: int, E: int, device="cpu", ties: bool = False):
    """The router's expert ids [T, k] (a strided view of its sort, as in
    ``moe_ffn``) of random probabilities, or of all-equal ones."""
    probs = torch.rand((T, E), generator=gen).to(device)
    if ties:
        probs = torch.full((T, E), 1.0 / E, device=device)
    return tmoe.route_top_k(probs, k)[1]


def _offset(gen, E: int, cap: int, device="cpu"):
    """Pairs of earlier rows held elsewhere, as the mesh route's offsets:
    some experts' already past the capacity."""
    return torch.randint(0, cap + 2, (E,), generator=gen).to(device)


def _equal(got, want, what: str) -> None:
    names = ("experts", "slots", "keep", "buffer", "mine")
    for name, g, w in zip(names, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, (name, what)
        assert torch.equal(g, w), (name, what)


# --------------------------------------------------------------------------
# The CPU route
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,k,E,cf,mesh", [
    (7, 2, 4, 1.0, False), (24, 2, 4, 0.5, False), (24, 3, 4, 1.25, False),
    (16, 1, 4, 8.0, False), (24, 2, 4, 1.0, True), (20, 3, 8, 0.5, True),
])
def test_plain_dispatch_of_token_rows_equals_pair_rows(dtype, T, k, E, cf, mesh):
    """``ref_moe_dispatch`` on the token rows [T, d] gives what it gives on
    ``_pair_rows``' copy [TK, d] (the route before it read rows in place),
    in the one-device and the mesh form."""
    gen = torch.Generator().manual_seed(T * 10 + k)
    d = 12
    x = torch.randn((T, d), generator=gen).to(dtype)
    idx = _route(gen, T, k, E)
    cap = tmoe.capacity(T, k, E, cf)
    args = (E, cap)
    if mesh:
        args += (_offset(gen, E, cap), E // 2, E // 2)
    _equal(ref.ref_moe_dispatch(x, idx, *args),
           ref.ref_moe_dispatch(tmoe._pair_rows(x, k), idx, *args), f"{T} {k} {E} {cf}")


@pytest.mark.parametrize("k,rows_per_pair", [(1, False), (2, False), (2, True), (3, False)])
def test_operator_on_cpu_gives_the_plain_values_and_gradients(k, rows_per_pair):
    """The operator's CPU implementation and its autograd formula
    (``moe_dispatch_grad``): the plain route's outputs, and its gradient of
    the source rows, equal for k <= 2 (a token's k products summed in the
    same order), within float32 rounding for k = 3."""
    gen = torch.Generator().manual_seed(5 + k)
    T, E, d, cf = 18, 4, 10, 0.75
    idx = _route(gen, T, k, E)
    cap = tmoe.capacity(T, k, E, cf)
    x = torch.randn((T, d), generator=gen)
    src = tmoe._pair_rows(x, k) if rows_per_pair else x
    w = torch.randn((E, cap, d), generator=gen)
    a = src.clone().requires_grad_()
    b = src.clone().requires_grad_()
    got = OPS.moe_dispatch(a, idx, None, E, cap, 0, E)
    want = ref.ref_moe_dispatch(b, idx, E, cap)
    _equal(got, want, f"k={k}")
    (got[3] * w).sum().backward()
    (want[3] * w).sum().backward()
    if k <= 2:
        assert torch.equal(a.grad, b.grad)
    else:
        torch.testing.assert_close(a.grad, b.grad, atol=1e-5, rtol=1e-5)
    assert not any(t.requires_grad for i, t in enumerate(got) if i != 3)


def test_operator_fake_shapes():
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        x = torch.empty((6, 8), dtype=torch.bfloat16)
        idx = torch.zeros((6, 2), dtype=torch.int64)
        experts, slots, keep, buf, mine = OPS.moe_dispatch(x, idx, None, 4, 5, 2, 2)
        grad = OPS.moe_dispatch_grad(buf, experts, slots, mine, 6)
    assert [t.dtype for t in (experts, slots, keep, buf, mine)] == [
        torch.int64, torch.int64, torch.bool, torch.bfloat16, torch.bool]
    assert [tuple(t.shape) for t in (experts, slots, keep, buf, mine)] == [
        (12,), (12,), (12,), (2, 5, 8), (12,)]
    assert tuple(grad.shape) == (6, 8) and grad.dtype == torch.bfloat16


def test_cpu_tensors_keep_the_plain_route_and_count_no_kernel_dispatch():
    """A CPU tensor takes the plain route; ``moe.kernel_dispatches`` stays
    absent while ``moe.pairs`` counts."""
    x = torch.randn((8, 16))
    gen = torch.Generator().manual_seed(0)
    params = tmoe.init_moe(gen, 16, 24, 4)
    before = dict(kmd.launches)
    tr = Tracer()
    with torch.no_grad(), installed(tr):
        tmoe.moe_ffn(params, x.reshape(2, 4, 16), 4, 2)
    assert tmoe.KERNEL_DISPATCHES not in tr.counters
    assert tr.counter(tmoe.PAIRS) == 16
    assert kmd.launches == before


def test_kernel_route_bounds():
    """The rank launch's blocks, and the wrapper's checks: it refuses what
    the kernels do not take (a type other than float32 or bfloat16, more
    than ``MAX_EXPERTS`` experts) instead of giving way to the plain
    route."""
    assert kmd._rank_blocks(16_384, 132) == 132
    assert kmd._rank_blocks(128, 132) == 4
    assert kmd._rank_blocks(1, 132) == 1
    x = torch.randn((6, 8))
    idx = torch.zeros((6, 2), dtype=torch.int64)
    with pytest.raises(ValueError):
        kmd.moe_dispatch(x[:5], idx, 4, 3)  # 5 rows do not divide 12 pairs
    with pytest.raises(ValueError):
        kmd.moe_dispatch(x, idx, 4, 3, first=3, n_local=2)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        kmd.moe_dispatch(x.half(), idx, 4, 3)
    with pytest.raises(ValueError, match=f"at most {kmd.MAX_EXPERTS} experts"):
        kmd.moe_dispatch(x, idx, kmd.MAX_EXPERTS + 1, 3)
    _equal(kmd.moe_dispatch(x, idx, 4, 3), ref.ref_moe_dispatch(x, idx, 4, 3), "wrapper")


@pytest.mark.parametrize("dtype,E", [(torch.float16, 4), (torch.float32, 300)])
def test_cpu_dispatch_of_what_the_kernels_refuse_stays_plain(dtype, E):
    """The device alone picks the route: a CPU tensor of a type or an expert
    count the kernels refuse still takes the plain route and launches
    nothing."""
    gen = torch.Generator().manual_seed(E)
    T, k, d = 10, 2, 8
    x = torch.randn((T, d), generator=gen).to(dtype)
    idx = torch.randint(0, E, (T, k), generator=gen)
    cap = tmoe.capacity(T, k, E, 1.0)
    before = dict(kmd.launches)
    _equal(tmoe._dispatch(x, idx, E, cap), ref.ref_moe_dispatch(x, idx, E, cap), str(dtype))
    assert kmd.launches == before


# --------------------------------------------------------------------------
# The CUDA route, on a card
# --------------------------------------------------------------------------
def _cuda_cases():
    """(T, k, E, cf, dtype, d, form): the sweep, then the edges."""
    for T, k, E, cf, dtype in itertools.product(
            (1, 7, 64, 8192), (1, 2, 3), (4, 16), (0.5, 1.0, 1.25, 8.0),
            (torch.float32, torch.bfloat16)):
        yield T, k, E, cf, dtype, 64, "random"
    for dtype, d in itertools.product((torch.float32, torch.bfloat16), (33, 7, 4100)):
        yield 64, 2, 16, 1.0, dtype, d, "random"  # a row width with a tail
    for T, k, cf in ((20, 2, 1.0), (20, 2, 0.5), (20, 3, 1.0), (8192, 2, 1.25)):
        yield T, k, 4, cf, torch.float32, 64, "ties"
    for T, k, cf in ((20, 1, 1.0), (300, 2, 1.25), (8192, 2, 0.5)):
        yield T, k, 16, cf, torch.bfloat16, 64, "one expert"
    for T, k, E, cf in ((7, 2, 4, 1.0), (64, 2, 16, 1.25), (8192, 2, 16, 0.5), (300, 3, 8, 8.0)):
        for dtype in (torch.float32, torch.bfloat16):
            yield T, k, E, cf, dtype, 64, "mesh"
    yield 8192, 2, 16, 1.25, torch.bfloat16, 4096, "random"  # the prefill cell's layer


@pytest.mark.cuda
def test_cuda_dispatch_equals_the_plain_route_on_card():
    """Every output of the kernels ``torch.equal`` to the plain route's on
    the card, for token rows [T, d], for pair rows [TK, d], and for token
    rows that are a strided view; the same again on a second call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the CPU route is covered above)")
    gen = torch.Generator().manual_seed(0)
    for T, k, E, cf, dtype, d, form in _cuda_cases():
        what = f"T={T} k={k} E={E} cf={cf} {dtype} d={d} {form}"
        idx = _route(gen, T, k, E, "cuda", ties=form == "ties")
        if form == "one expert":
            idx = torch.full((T, k), E - 1, dtype=torch.int64, device="cuda")
        cap = tmoe.capacity(T, k, E, cf)
        args = (E, cap)
        if form == "mesh":
            args += (_offset(gen, E, cap, "cuda"), E // 4, E // 2)
        wide = torch.randn((T, d + 5), generator=gen).to("cuda", dtype)
        x = wide[:, :d].contiguous()
        for src in (x, tmoe._pair_rows(x, k), wide[:, :d]):
            want = ref.ref_moe_dispatch(src, idx, *args)
            got = kmd.moe_dispatch(src, idx, *args)
            _equal(got, want, f"{what} rows={src.shape[0]} stride={src.stride(0)}")
            _equal(kmd.moe_dispatch(src, idx, *args), got, f"again {what}")
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_dispatch_gradient_and_counter_on_card():
    """The kernel backward's gradient of the source rows: ``torch.equal``
    to the plain route's for k <= 2, within the MoE parity bars (1e-5
    float32, 4e-2 bfloat16) for k = 3 and for dbrx's routing (k 4 of 16
    experts); for token and pair rows and the mesh form. ``moe.kernel_dispatches`` reads one a layer (forward only), and
    ``moe_ffn`` gives the plain route's output and gradients."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the CPU route is covered above)")
    gen = torch.Generator().manual_seed(1)
    bars = {torch.float32: 1e-5, torch.bfloat16: 4e-2}
    for (T, k, E, cf, mesh), dtype in itertools.product(
            [(64, 1, 4, 1.0, False), (64, 2, 16, 1.25, False), (300, 2, 4, 0.5, True),
             (8192, 2, 16, 1.25, False), (64, 3, 4, 1.0, False), (300, 3, 8, 0.5, True),
             (512, 4, 16, 1.25, False), (8192, 4, 16, 1.0, False)],
            (torch.float32, torch.bfloat16)):
        d = 96
        idx = _route(gen, T, k, E, "cuda")
        cap = tmoe.capacity(T, k, E, cf)
        args = (E, cap) + ((_offset(gen, E, cap, "cuda"), E // 2, E // 2) if mesh else ())
        n_local = E // 2 if mesh else E
        x = torch.randn((T, d), generator=gen).to("cuda", dtype)
        w = torch.randn((n_local, cap, d), generator=gen).to("cuda", dtype)
        for src in (x, tmoe._pair_rows(x, k)):
            a = src.clone().requires_grad_()
            b = src.clone().requires_grad_()
            before = dict(kmd.launches)
            (kmd.moe_dispatch(a, idx, *args)[3] * w).sum().backward()
            (ref.ref_moe_dispatch(b, idx, *args)[3] * w).sum().backward()
            assert kmd.launches["moe_dispatch_grad"] == before["moe_dispatch_grad"] + 1
            what = f"T={T} k={k} E={E} {dtype} rows={src.shape[0]} mesh={mesh}"
            if k <= 2:
                assert torch.equal(a.grad, b.grad), what
            else:
                torch.testing.assert_close(a.grad.float(), b.grad.float(), atol=bars[dtype],
                                           rtol=bars[dtype], msg=what)

    params = tmoe.init_moe(torch.Generator().manual_seed(2), 64, 96, 16)
    params = {n: ({"w": p["w"].cuda()} if n == "router" else p.cuda()) for n, p in params.items()}
    x = torch.randn((4, 32, 64), generator=gen).cuda().requires_grad_()
    tr = Tracer()
    with installed(tr):
        out, aux = tmoe.moe_ffn(params, x, 16, 2, 1.0)
        out.sum().backward()
        with torch.no_grad():
            for _ in range(2):
                tmoe.moe_ffn(params, x, 16, 2, 1.0)
    assert tr.counter(tmoe.KERNEL_DISPATCHES) == 3
    dispatch = tmoe._dispatch
    tmoe._dispatch = lambda src, *a, **kw: ref.ref_moe_dispatch(src, *a, **kw)
    try:
        y = x.detach().clone().requires_grad_()
        want, _ = tmoe.moe_ffn(params, y, 16, 2, 1.0)
        want.sum().backward()
    finally:
        tmoe._dispatch = dispatch
    assert torch.equal(out, want)
    assert torch.equal(x.grad, y.grad)
    torch.cuda.synchronize()
