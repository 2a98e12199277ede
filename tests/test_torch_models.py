"""Port model stack (serving path) against the JAX package: configs,
layers, ``forward`` / ``prefill`` / ``decode_step`` of the smoke dense
models, the serving steps and the serve launcher, on the same numpy-made
inputs, with the JAX weights carried across by ``lm_params_from_arrays``.

Tolerances: in float32 compute the port and the JAX package run the same
algorithm and agree within 1e-4 (the bf16 KV cache rounds the same values
in both). In bf16 compute the two frameworks round at slightly different
places, so the bar is ``tests/test_models.py:113``'s
``max(0.05, 0.02 * n_layers)``, and 4e-2 (``tests/test_kernels.py:37``)
for a single layer.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import get_config as j_get_config
from repro.configs import smoke_config as j_smoke_config
from repro.models import layers as jl
from repro.models.lm import build_model as j_build_model
from repro.models.lm import count_params as j_count_params
from repro_torch.configs import ARCH_IDS, ALIASES, get_config, smoke_config
from repro_torch.interop import lm_cache_from_arrays, lm_params_from_arrays, lm_tree_to_arrays
from repro_torch.kernels import attention as tattn
from repro_torch.launch import serve as tserve
from repro_torch.models import layers as tl
from repro_torch.models.lm import build_model, count_params
from repro_torch.runtime.steps import build_prefill_step, build_serve_step

CPU = "cpu"


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def test_config_registry_matches_reference():
    assert ARCH_IDS == J_ARCH_IDS
    for name in ARCH_IDS + list(ALIASES):
        assert dataclasses.asdict(get_config(name)) == dataclasses.asdict(j_get_config(name))
        assert dataclasses.asdict(smoke_config(name)) == dataclasses.asdict(j_smoke_config(name))


# --------------------------------------------------------------------------
# Layers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,tol", [(jnp.float32, 1e-5), (jnp.bfloat16, 4e-2)])
def test_norm_rope_mlp_match_reference(dtype, tol):
    rng = np.random.default_rng(0)
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 16).astype(np.float32)
    xj = jnp.asarray(x, dtype)
    xt = _t(np.asarray(xj.astype(jnp.float32)), tdt)
    _close(tl.rms_norm({"scale": _t(scale)}, xt), jl.rms_norm({"scale": jnp.asarray(scale)}, xj), tol)

    pos = np.arange(5)
    cj, sj = jl.rope_tables(jnp.asarray(pos), 16, 500000.0)
    ct, st = tl.rope_tables(torch.arange(5), 16, 500000.0)
    _close(ct, cj, 1e-6)
    _close(st, sj, 1e-6)
    _close(tl.apply_rope(xt, ct[None], st[None]), jl.apply_rope(xj, cj[None], sj[None]), tol)

    mlp = {k: {"w": (rng.standard_normal((16, 32) if k != "wo" else (32, 16)) * 0.25)
                .astype(np.float32)} for k in ("wi", "wg", "wo")}
    h = x[:, :, 0]
    _close(
        tl.mlp_swiglu(jax.tree.map(_t, mlp), _t(np.asarray(jnp.asarray(h, dtype).astype(jnp.float32)), tdt)),
        jl.mlp_swiglu(jax.tree.map(jnp.asarray, mlp), jnp.asarray(h, dtype)),
        tol,
    )


def _attn_params(rng, d, H, KV, hd, bias):
    p = jl.init_attention(jax.random.PRNGKey(int(rng.integers(1 << 30))), d, H, KV, hd, qkv_bias=bias)
    if bias:  # non-zero biases, so the bias path is exercised
        p = {k: dict(v, b=jnp.asarray(rng.standard_normal(v["w"].shape[1]) * 0.1, jnp.float32))
             if "b" in v else v for k, v in p.items()}
    return p, lm_params_from_arrays(jax.tree.map(np.asarray, p), device=CPU)


@pytest.mark.parametrize("S", [1, 7])
@pytest.mark.parametrize("dtype,tol", [(jnp.float32, 1e-5), (jnp.bfloat16, 4e-2)])
def test_attention_layer_matches_reference(S, dtype, tol):
    rng = np.random.default_rng(S)
    d, H, KV, hd = 32, 6, 2, 16
    pj, pt = _attn_params(rng, d, H, KV, hd, bias=True)
    x = jnp.asarray(rng.standard_normal((2, S, d)), dtype)
    cj, sj = jl.rope_tables(jnp.arange(S), hd, 10000.0)
    ct, st = tl.rope_tables(torch.arange(S), hd, 10000.0)
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    want = jl.attention(pj, x, cj[None], sj[None], H, KV, hd)
    got = tl.attention(pt, _t(np.asarray(x.astype(jnp.float32)), tdt), ct[None], st[None], H, KV, hd)
    _close(got, want, tol)


@pytest.mark.parametrize("dtype,tol", [(jnp.float32, 1e-5), (jnp.bfloat16, 4e-2)])
def test_decode_attention_layer_matches_reference(dtype, tol):
    rng = np.random.default_rng(3)
    d, H, KV, hd, B, T, pos = 32, 6, 2, 16, 2, 12, 5
    pj, pt = _attn_params(rng, d, H, KV, hd, bias=False)
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    x = jnp.asarray(rng.standard_normal((B, 1, d)), dtype)
    ck = jnp.asarray(rng.standard_normal((B, T, KV, hd)), jnp.bfloat16)
    cv = jnp.asarray(rng.standard_normal((B, T, KV, hd)), jnp.bfloat16)
    out_j, kj, vj = jl.decode_attention(pj, x, jnp.int32(pos), ck, cv, 10000.0, H, KV, hd)
    ckt = _t(np.asarray(ck.astype(jnp.float32)), torch.bfloat16)
    cvt = _t(np.asarray(cv.astype(jnp.float32)), torch.bfloat16)
    out_t, kt, vt = tl.decode_attention(
        pt, _t(np.asarray(x.astype(jnp.float32)), tdt), pos, ckt, cvt, 10000.0, H, KV, hd
    )
    _close(out_t, out_j, tol)
    _close(kt, kj, 0)  # the same new row, rounded to bf16 in place
    _close(vt, vj, 0)


# --------------------------------------------------------------------------
# Whole models
# --------------------------------------------------------------------------

def _models(arch, jdtype):
    cfg = j_smoke_config(arch)
    jm = j_build_model(cfg, compute_dtype=jdtype)
    tm = build_model(smoke_config(arch), torch.float32 if jdtype == jnp.float32 else torch.bfloat16)
    return cfg, jm, tm


@pytest.mark.parametrize("arch", ["llama3_2_3b", "qwen1_5_4b"])
@pytest.mark.parametrize("jdtype", [jnp.float32, jnp.bfloat16])
def test_forward_prefill_decode_match_reference(arch, jdtype):
    """forward, prefill and 16 decode steps of the smoke model, JAX weights
    carried across, against the JAX package."""
    cfg, jm, tm = _models(arch, jdtype)
    tol = 1e-4 if jdtype == jnp.float32 else max(0.05, 0.02 * cfg.n_layers)
    pj = jm.init(jax.random.PRNGKey(0))
    pt = lm_params_from_arrays(jax.tree.map(np.asarray, pj), device=CPU)
    assert count_params(pt) == j_count_params(pj)
    B, S = 2, 16
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S))
    tj, tt = jnp.asarray(tokens, jnp.int32), torch.from_numpy(tokens)

    with torch.no_grad():
        lj, _ = jm.forward(pj, tj)
        lt, _ = tm.forward(pt, tt)
        _close(lt, lj, tol)
        _close(tm.prefill(pt, tt), jm.prefill(pj, tj), tol)

        cj = jm.init_cache(B, 24)
        ct = lm_cache_from_arrays(jax.tree.map(np.asarray, cj), device=CPU)
        step = jax.jit(jm.decode_step)
        for s in range(S):
            dj, cj = step(pj, cj, tj[:, s])
            dt, ct = tm.decode_step(pt, ct, tt[:, s])
            _close(dt, dj, tol)
        assert ct["pos"] == int(cj["pos"]) == S
        if jdtype == jnp.float32:
            # The same f32 rows went into the bf16 caches. The two
            # frameworks' f32 products sum in different orders, so a value
            # may round to the neighbouring bf16 number (one step: rtol
            # 2**-7), and a value that cancels to near 0 keeps f32 noise.
            for a, b in zip(lm_tree_to_arrays(ct["layers"]), jax.tree.map(np.asarray, cj["layers"])):
                for key in ("k", "v"):
                    np.testing.assert_allclose(_np(a[key]), _np(b[key]), rtol=2**-7, atol=1e-6)


@pytest.mark.parametrize("arch", ["llama3_2_3b", "phi3_mini_3_8b"])
def test_port_decode_matches_its_forward(arch):
    """Decode-vs-forward consistency of the port alone (bf16 compute, the
    port's own weights), ``tests/test_models.py:113``'s tolerance."""
    cfg = smoke_config(arch)
    m = build_model(cfg)
    params = m.init(0, device=CPU)
    tokens = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 12)))
    with torch.no_grad():
        full, aux = m.forward(params, tokens)
        assert float(aux) == 0.0
        cache = m.init_cache(2, 16, device=CPU)
        dec = []
        for s in range(tokens.shape[1]):
            lg, cache = m.decode_step(params, cache, tokens[:, s])
            dec.append(lg[:, 0])
    tol = max(0.05, 0.02 * cfg.n_layers)
    _close(torch.stack(dec, dim=1), full, tol)


def test_param_tree_matches_reference_structure():
    """init gives the JAX package's tree: same keys, shapes, leaf order."""
    for arch in ("llama3_2_3b", "qwen1_5_4b"):
        cfg = smoke_config(arch)
        pt = build_model(cfg).init(0, device=CPU)
        pj = jax.eval_shape(j_build_model(j_smoke_config(arch)).init, jax.random.PRNGKey(0))
        lt, tt = jax.tree_util.tree_flatten(lm_tree_to_arrays(pt))
        lj, tj = jax.tree_util.tree_flatten(pj)
        assert tt == tj
        assert [a.shape for a in lt] == [a.shape for a in lj]
        again = build_model(cfg).init(0, device=CPU)
        assert all(np.array_equal(a, b) for a, b in zip(
            jax.tree_util.tree_leaves(lm_tree_to_arrays(pt)),
            jax.tree_util.tree_leaves(lm_tree_to_arrays(again)),
        ))


def test_interop_round_trip_and_bf16_bits():
    cfg = j_smoke_config("llama3_2_3b")
    pj = j_build_model(cfg).init(jax.random.PRNGKey(0))
    arrays = jax.tree.map(np.asarray, pj)
    back = lm_tree_to_arrays(lm_params_from_arrays(arrays, device=CPU))
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(arrays)):
        assert np.array_equal(a, b)
    bf = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)), arrays)
    tb = lm_params_from_arrays(bf, device=CPU)
    leaf = tb["layers"][0]["mixer"]["attn"]["wq"]["w"]
    assert leaf.dtype == torch.bfloat16
    assert np.array_equal(leaf.float().numpy(), bf["layers"][0]["mixer"]["attn"]["wq"]["w"].astype(np.float32))
    assert lm_params_from_arrays(arrays, device=CPU, dtype=torch.bfloat16)["norm"]["scale"].dtype == torch.bfloat16


def test_unported_kinds_raise_not_implemented():
    """All ten architectures build, and nothing of them is left unported:
    the training loss, which raised NotImplementedError before the
    training slice, returns a finite float32 scalar for every arch (its
    parity with the JAX package is tests/test_torch_train.py's)."""
    rng = np.random.default_rng(0)
    for arch in ARCH_IDS:
        cfg = smoke_config(arch)
        m = build_model(cfg)
        assert m.cfg == cfg
        assert (m.encode is not None) == bool(cfg.n_enc_layers)
        batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 8)))
                 for k in ("tokens", "labels")}
        if cfg.n_enc_layers or cfg.cross_attn_every:
            T = 8 if cfg.n_enc_layers else 16
            batch["memory"] = torch.from_numpy(
                rng.standard_normal((2, T, cfg.d_model)).astype(np.float32))
        with torch.no_grad():
            loss = m.loss(m.init(0, device=CPU), batch)
        assert loss.shape == () and loss.dtype == torch.float32
        assert bool(torch.isfinite(loss))


# --------------------------------------------------------------------------
# Serving steps and launcher
# --------------------------------------------------------------------------

def test_serving_steps_equal_model_functions():
    """The steps are the model's functions, and bf16 weights held from
    load time give exactly the per-use casts of fp32 weights."""
    cfg = smoke_config("qwen1_5_4b")
    m = build_model(cfg)
    params = m.init(1, device=CPU)
    bf = m.init(1, device=CPU, dtype=torch.bfloat16)
    assert bf["layers"][0]["mixer"]["attn"]["wq"]["b"].dtype == torch.bfloat16
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 6)))
    with torch.no_grad():
        want = m.prefill(params, tokens)
        w_dec, _ = m.decode_step(params, m.init_cache(2, 8, device=CPU), tokens[:, 0])
    assert torch.equal(build_prefill_step(m)(bf, {"tokens": tokens}), want)
    got, cache = build_serve_step(m)(bf, m.init_cache(2, 8, device=CPU), tokens[:, 0])
    assert torch.equal(got, w_dec) and cache["pos"] == 1


def test_serve_flags():
    args = tserve.parse_args([])
    assert args.smoke and args.device is None and args.arch == "llama3.2-3b"
    assert not tserve.parse_args(["--no-smoke"]).smoke  # the full widths can be asked for


def test_serve_launcher_on_cpu():
    before = dict(tattn.launches)
    res = tserve.main(["--device", "cpu", "--batch", "2", "--prompt", "6", "--gen", "3"])
    cfg = smoke_config("llama3.2-3b")
    assert res.tokens.shape == (2, 3) and res.all_finite
    assert res.prefill_logits.shape == (2, 1, cfg.vocab_size)
    tol = max(0.05, 0.02 * cfg.n_layers)
    _close(res.prompt_logits, res.prefill_logits, tol)
    assert tattn.launches == before  # the CPU route launches no kernel
