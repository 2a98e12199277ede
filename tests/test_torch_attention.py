"""Port attention: the plain PyTorch versions of the flash and decode
kernels against the JAX package's Pallas kernels (interpret mode, as
``tests/test_kernels.py`` runs them), its jnp oracles and the
``models/flash.py`` twin, on the same numpy-made inputs.

Tolerances are the reference's own (``tests/test_kernels.py:37``): 2e-5
in float32 and 4e-2 in bfloat16, because the online softmax reorders the
sums. The CUDA kernels are held against the same plain versions on the
card (``chip_smoke.py`` and the ``cuda``-marked test below).
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.ref import ref_decode_attention as jref_decode
from repro.kernels.ref import ref_flash_attention as jref_flash
from repro.models.flash import flash_attention as jnp_flash
from repro_torch.kernels import attention, ref
from repro_torch.kernels import ops as tops
from repro_torch.models.flash import flash_attention as port_flash

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 4e-2)}


def _pair(rng, shape, dtype):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    jdt, tdt, _ = DTYPES[dtype]
    j = jnp.asarray(rng.standard_normal(shape), jdt)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt)
    return j, t


def _close(got: torch.Tensor, want, tol: float) -> None:
    np.testing.assert_allclose(
        got.to(torch.float32).numpy(), np.asarray(want, np.float32),
        atol=tol, rtol=tol,
    )


@pytest.mark.parametrize(
    "B,S,H,KV,D,bq,bk,causal",
    [
        (2, 32, 8, 2, 16, 16, 16, True),
        (1, 64, 8, 8, 32, 32, 64, False),
        (1, 32, 4, 1, 32, 16, 32, True),   # MQA
        (2, 64, 6, 2, 16, 32, 16, True),   # G = 3, as llama3.2-3b
        (1, 32, 2, 2, 96, 16, 16, True),   # D = 96 (phi3-mini), G = 1
        (1, 32, 8, 2, 96, 16, 32, False),  # D = 96, G = 4
    ],
)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_matches_pallas_and_oracle(B, S, H, KV, D, bq, bk, causal, dtype):
    rng = np.random.default_rng(B * 1000 + S + H + KV + D)
    (qj, qt), (kj, kt), (vj, vt) = (
        _pair(rng, shape, dtype) for shape in ((B, S, H, D), (B, S, KV, D), (B, S, KV, D))
    )
    tol = DTYPES[dtype][2]
    before = dict(attention.launches)
    got = tops.flash_attention(qt, kt, vt, causal, bq, bk)
    assert got.dtype == qt.dtype and got.shape == (B, S, H, D)
    _close(got, jops.flash_attention(qj, kj, vj, causal, bq, bk).astype(jnp.float32), tol)
    _close(got, jref_flash(qj, kj, vj, causal).astype(jnp.float32), tol)
    assert attention.launches == before  # the CPU route launches nothing


@pytest.mark.parametrize("S,causal", [(37, True), (37, False), (1, True)])
def test_flash_plain_ragged_length(S, causal):
    """Any S: the port has no block divisibility rule (the oracle has none
    either; the Pallas kernel needs S % block == 0)."""
    rng = np.random.default_rng(S)
    (qj, qt), (kj, kt), (vj, vt) = (
        _pair(rng, shape, "float32") for shape in ((2, S, 6, 16), (2, S, 2, 16), (2, S, 2, 16))
    )
    _close(tops.flash_attention(qt, kt, vt, causal), jref_flash(qj, kj, vj, causal), 2e-5)


def test_flash_plain_matches_jnp_flash_twin():
    """Against ``models/flash.py``'s blockwise scan (``test_kernels.py:43``)."""
    rng = np.random.default_rng(7)
    (qj, qt), (kj, kt), (vj, vt) = (
        _pair(rng, shape, "float32") for shape in ((2, 64, 8, 16), (2, 64, 4, 16), (2, 64, 4, 16))
    )
    want = jnp_flash(qj, kj, vj, True, 16)
    _close(port_flash(qt, kt, vt, True), want, 2e-5)


def test_port_flash_is_forward_only():
    q = torch.zeros((1, 4, 2, 16), requires_grad=True)
    k = torch.zeros((1, 4, 2, 16))
    with pytest.raises(NotImplementedError, match="training slice"):
        port_flash(q, k, k)
    with torch.no_grad():
        assert port_flash(q, k, k).shape == (1, 4, 2, 16)


@pytest.mark.parametrize(
    "B,H,KV,D,T,kv_len",
    [
        (2, 8, 2, 32, 64, 40),
        (1, 4, 4, 16, 32, 32),
        (3, 8, 8, 32, 128, 1),
        (4, 6, 2, 16, 64, [1, 17, 64, 100]),  # per-row, one past T
        (2, 4, 1, 16, 32, [0, 32]),           # an empty row: uniform over T
    ],
)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_plain_matches_pallas_and_oracle(B, H, KV, D, T, kv_len, dtype):
    rng = np.random.default_rng(B * 100 + H + T)
    (qj, qt), (kj, kt), (vj, vt) = (
        _pair(rng, shape, dtype) for shape in ((B, H, D), (B, T, KV, D), (B, T, KV, D))
    )
    tol = DTYPES[dtype][2]
    lens_j = jnp.asarray(kv_len, jnp.int32)
    lens_t = torch.tensor(kv_len, dtype=torch.int32)
    before = dict(attention.launches)
    got = tops.decode_attention(qt, kt, vt, lens_t)
    assert got.dtype == qt.dtype and got.shape == (B, H, D)
    block = min(32, T)
    _close(got, jops.decode_attention(qj, kj, vj, lens_j, block).astype(jnp.float32), tol)
    _close(got, jref_decode(qj, kj, vj, lens_j).astype(jnp.float32), tol)
    # An int and a 0-d tensor broadcast like the JAX wrapper's [] kv_len.
    if isinstance(kv_len, int):
        assert torch.equal(tops.decode_attention(qt, kt, vt, kv_len), got)
        assert torch.equal(tops.decode_attention(qt, kt, vt, torch.tensor(kv_len)), got)
    assert attention.launches == before


@pytest.mark.parametrize("n_sm", [1, 8, 132])
@pytest.mark.parametrize("T", [1, 63, 64, 545, 4096, 32768])
def test_decode_split_plan(n_sm, T):
    """S >= 1; no split under DECODE_MIN_SPLIT_ROWS rows of T unless S = 1;
    within DECODE_WAVES full waves of blocks and less than one (b, kv) pair
    short of them until T caps S; and the block count grows with B * KV:
    once B * KV alone fills the waves, S = 1 and one more (b, kv) pair is
    one more block."""
    rows = attention.DECODE_MIN_SPLIT_ROWS
    target = attention.DECODE_WAVES * attention.DECODE_BLOCKS_PER_SM * n_sm
    prev = 0
    for bkv in range(1, 2 * target + 2):
        S = attention.decode_splits(bkv, 1, T, n_sm)
        assert S >= 1
        assert S == 1 or T // S >= rows
        assert S == attention.decode_splits(1, bkv, T, n_sm)
        blocks = S * bkv
        if S < T // rows and bkv <= target:  # not capped: the waves asked for
            assert target - bkv < blocks <= target
        assert blocks >= min(target - bkv + 1, bkv * max(1, T // rows))
        if bkv >= target:
            assert S == 1
            assert bkv == target or blocks == prev + 1
        prev = blocks


@pytest.mark.parametrize(
    "B,H,KV,D,T,kv_len,n_splits",
    [
        (2, 8, 2, 32, 64, 40, 3),
        (3, 6, 2, 16, 100, [1, 2, 0], 4),              # n_b < S: empty splits
        (4, 6, 2, 16, 64, [1, 17, 64, 100], 5),        # ragged, one past T
        (2, 4, 1, 16, 32, [0, 32], 2),                 # an empty row: uniform
        (2, 24, 8, 128, 96, [95, 3], 7),               # llama3.2-3b heads
        (1, 8, 8, 32, 128, 1, 1),                      # one split
    ],
)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_split_model_matches_pallas_and_oracle(B, H, KV, D, T, kv_len, n_splits, dtype):
    """The plain model of the kernel's split and combine against the JAX
    oracle and the Pallas kernel (interpret mode), as the test above."""
    rng = np.random.default_rng(B * 31 + H + T + n_splits)
    (qj, qt), (kj, kt), (vj, vt) = (
        _pair(rng, shape, dtype) for shape in ((B, H, D), (B, T, KV, D), (B, T, KV, D))
    )
    tol = DTYPES[dtype][2]
    lens_j = jnp.asarray(kv_len, jnp.int32)
    got = ref.ref_decode_attention_split(qt, kt, vt, torch.tensor(kv_len), n_splits)
    assert got.dtype == qt.dtype and got.shape == (B, H, D)
    block = 32 if T % 32 == 0 else T
    _close(got, jops.decode_attention(qj, kj, vj, lens_j, block).astype(jnp.float32), tol)
    _close(got, jref_decode(qj, kj, vj, lens_j).astype(jnp.float32), tol)
    if isinstance(kv_len, int):
        assert torch.equal(ref.ref_decode_attention_split(qt, kt, vt, kv_len, n_splits), got)


def test_wrappers_reject_bad_inputs():
    q = torch.zeros((1, 8, 4, 16))
    k = torch.zeros((1, 8, 3, 16))
    with pytest.raises(ValueError):
        tops.flash_attention(q, k, k)  # H % KV != 0
    with pytest.raises(TypeError):
        tops.flash_attention(q, q.to(torch.bfloat16), q)
    with pytest.raises(ValueError):
        tops.decode_attention(q[:, 0], q, q, torch.ones(3, dtype=torch.int32))
    with pytest.raises(ValueError):
        tops.flash_attention(q.to("meta"), q.to("meta"), q.to("meta"))


def test_library_path_is_keyed_on_the_source(tmp_path):
    """A kernel library is named by a hash of its source, so an edited
    source builds a new library under ``build/`` and an unchanged one finds
    the old (nothing is built here)."""
    from repro_torch.kernels import build

    a, b, a2 = (tmp_path / name for name in ("a.cu", "b.cu", "a2.cu"))
    a.write_text("__global__ void f() {}\n")
    b.write_text("__global__ void f() { }\n")
    a2.write_text(a.read_text())
    pa, pb = build._library_path(a), build._library_path(b)
    assert pa != pb
    assert pa.parent == pb.parent == build.BUILD_DIR
    assert build._library_path(a2).name.split("_")[-1] == pa.name.split("_")[-1]
    assert build._library_path(build.SOURCES["flash_attention"]).name.startswith(
        "libflash_attention_")


@pytest.mark.cuda
def test_cuda_attention_kernels_match_plain_versions_on_card():
    """On a card: both kernels against their plain versions at the stated
    tolerances (elementwise and per output row), with ragged S and T, GQA
    and MQA, per-row lengths. The decode kernel is swept over D = 16, 64,
    96, 128, G = 1, 3, 4, 8, row lengths 0, 1, S - 1, mid-split, T - 1, T
    and T + 5, a T that ends mid-tile and one with empty splits, on K and V
    as strided views of one fused cache, and an int kv_len against the
    equal tensor (torch.equal). The bf16 flash kernel is also swept over the
    edges of its tiles: every TMA box width and swizzle (D = 16, 48, 96,
    128), G = 1, 3, 4, 8, and S = T ending mid-tile, with folded rows that
    cross the 64-row warpgroup boundary inside one query, causal or not,
    on q, k and v as strided views of one fused tensor."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the CPU route is covered above)")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)

    def close(got, want, tol, row_tol):
        torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
        # Each output row within row_tol of its own norm: randn inputs give
        # outputs of 0.01-0.05, about the size of the elementwise bf16 bar.
        d = (got.float() - want.float()).norm(dim=-1)
        assert float((d / want.float().norm(dim=-1)).max()) <= row_tol

    for dtype, tol, row_tol in ((torch.float32, 2e-5, 2e-5), (torch.bfloat16, 4e-2, 1e-2)):
        def rn(*shape):
            return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

        for B, S, H, KV, D, causal in [
            (1, 256, 4, 4, 128, True), (2, 100, 24, 8, 128, True),
            (1, 77, 4, 1, 64, False), (2, 33, 6, 2, 16, True),
        ]:
            q, k, v = rn(B, S, H, D), rn(B, S, KV, D), rn(B, S, KV, D)
            before = attention.launches["flash_attention"]
            got = tops.flash_attention(q, k, v, causal)
            assert attention.launches["flash_attention"] == before + 1
            close(got, ref.ref_flash_attention(q, k, v, causal), tol, row_tol)
        for B, H, KV, D, T, lens in [
            (4, 24, 8, 128, 545, [544, 1, 300, 129]), (2, 16, 2, 64, 4096, [3000, 0]),
            (2, 4, 1, 16, 40, [17, 40]),
        ]:
            q, k, v = rn(B, H, D), rn(B, T, KV, D), rn(B, T, KV, D)
            kl = torch.tensor(lens, dtype=torch.int32, device="cuda")
            got = tops.decode_attention(q, k, v, kl)
            close(got, ref.ref_decode_attention(q, k, v, kl), tol, row_tol)

        # Decode sweep: every row length that ends a split or a tile
        # differently, on K and V as strided views of one fused cache. T =
        # 1000 is no multiple of a tile's rows (32 in bf16, 16 in f32 at D =
        # 128); T = 130 gives two splits, so length 1 leaves one empty.
        n_sm = torch.cuda.get_device_properties(0).multi_processor_count
        for D, G, T in itertools.product((16, 64, 96, 128), (1, 3, 4, 8), (1000, 130)):
            B, KV = 7, 2
            H = G * KV
            S = attention.decode_splits(B, KV, T, n_sm)
            lens = [0, 1, max(S - 1, 1), T // S + T // (2 * S), T - 1, T, T + 5]
            q = rn(B, H, D)
            kv = rn(B, T, 2 * KV, D)  # views with the head stride of a fused cache
            k, v = kv[:, :, :KV], kv[:, :, KV:]
            kl = torch.tensor(lens, dtype=torch.int32, device="cuda")
            before = attention.launches["decode_attention"]
            got = tops.decode_attention(q, k, v, kl)
            assert attention.launches["decode_attention"] == before + 1
            close(got, ref.ref_decode_attention(q, k, v, kl), tol, row_tol)
            for n in (0, 1, T - 1, T + 5):  # an int by value == the equal tensor
                full = torch.full((B,), n, dtype=torch.int32, device="cuda")
                assert torch.equal(tops.decode_attention(q, k, v, n),
                                   tops.decode_attention(q, k, v, full))

    def rn16(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16)

    for D, G, S, causal in itertools.product(
        (16, 48, 96, 128), (1, 3, 4, 8), (1, 65, 129, 1000), (True, False)
    ):
        B, KV = 2, 2
        H = G * KV
        qkv = rn16(B, S, H + 2 * KV, D)  # views with the head stride of a fused qkv
        q, k, v = qkv[:, :, :H], qkv[:, :, H:H + KV], qkv[:, :, H + KV:]
        got = tops.flash_attention(q, k, v, causal)
        close(got, ref.ref_flash_attention(q, k, v, causal), 4e-2, 1e-2)
