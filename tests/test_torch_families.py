"""The port's expert, recurrent and cross-attention families against the
JAX package: the smoke configs of xlstm-350m, jamba, dbrx, phi3.5-moe,
seamless-m4t-medium and llama-3.2-vision-11b through ``forward`` (logits
and aux), ``prefill``, ``encode`` and 16 decode steps, on JAX weights
carried across by ``lm_params_from_arrays`` and JAX caches (with their
memory and recurrent states) carried across by ``lm_cache_from_arrays``.

Tolerances: 1e-4 in float32 compute (the whole-model bar of
``tests/test_torch_models.py``: the same
algorithm, the frameworks' f32 sums in different orders). In bf16 the
two frameworks round at different places, so the bar is
``tests/test_models.py:113``'s ``max(0.05, 0.02 * n_layers)``; for the
MoE configs, whose top-k routing is discontinuous (a near-tie may route
differently after a rounding), the distributions are compared instead:
``tests/test_models.py:103-111``'s KL(reference || port) per position,
max < 0.1 and mean < 0.02.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke_config
from repro.models.lm import build_model as j_build_model
from repro.models.lm import count_params as j_count_params
from repro_torch.configs import ARCH_IDS, smoke_config
from repro_torch.interop import lm_cache_from_arrays, lm_params_from_arrays, lm_tree_to_arrays
from repro_torch.kernels import attention as tattn
from repro_torch.kernels import ref
from repro_torch.launch import serve as tserve
from repro_torch.models import layers as tl
from repro_torch.models.lm import active_param_fraction, build_model, count_params

CPU = "cpu"
FAMILIES = ["xlstm_350m", "jamba_v0_1_52b", "dbrx_132b", "phi3_5_moe_42b",
            "seamless_m4t_medium", "llama3_2_vision_11b"]


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _kl(p_logits, q_logits) -> np.ndarray:
    p = torch.log_softmax(torch.from_numpy(np.array(_np(p_logits))), dim=-1)
    q = torch.log_softmax(torch.from_numpy(np.array(_np(q_logits))), dim=-1)
    return (p.exp() * (p - q)).sum(dim=-1).numpy()


def _agree(cfg, got, want, tol, what):
    if cfg.n_experts and tol > 1e-3:  # bf16 MoE: the distributions
        kl = _kl(want, got)
        assert float(kl.max()) < 0.1, f"{what}: max KL {float(kl.max()):.4f}"
        assert float(kl.mean()) < 0.02, f"{what}: mean KL {float(kl.mean()):.4f}"
    else:
        np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol, err_msg=what)


def _memory(cfg, rng, B, S):
    """Raw frames [B, S, d] (encoder-decoder) or patches [B, 16, d] (VLM),
    as ``tests/test_models.py:26-31`` draws them; None otherwise."""
    if cfg.n_enc_layers or cfg.cross_attn_every:
        T = S if cfg.n_enc_layers else 16
        return rng.standard_normal((B, T, cfg.d_model)).astype(np.float32)
    return None


@pytest.mark.parametrize("arch", FAMILIES)
@pytest.mark.parametrize("jdtype", [jnp.float32, jnp.bfloat16])
def test_family_matches_reference(arch, jdtype):
    """forward (logits, aux), prefill, encode and 16 decode steps of the
    smoke model, JAX weights and cache carried across. In bf16 the port
    decodes on its own cache; in f32 every step starts from the
    reference's cache (the mixers' states are held to the reference in
    ``tests/test_torch_ssm.py``)."""
    cfg = j_smoke_config(arch)
    tdt = torch.float32 if jdtype == jnp.float32 else torch.bfloat16
    jm, tm = j_build_model(cfg, compute_dtype=jdtype), build_model(smoke_config(arch), tdt)
    tol = 1e-4 if jdtype == jnp.float32 else max(0.05, 0.02 * cfg.n_layers)
    pj = jm.init(jax.random.PRNGKey(0))
    pt = lm_params_from_arrays(jax.tree.map(np.asarray, pj), device=CPU)
    assert count_params(pt) == j_count_params(pj)
    B, S = 2, 16
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, (B, S))
    mem = _memory(cfg, rng, B, S)
    tj, tt = jnp.asarray(tokens, jnp.int32), torch.from_numpy(tokens)
    mj = None if mem is None else jnp.asarray(mem)
    mt = None if mem is None else torch.from_numpy(mem)

    with torch.no_grad():
        lj, aj = jm.forward(pj, tj, memory=mj)
        lt, at = tm.forward(pt, tt, memory=mt)
        _agree(cfg, lt, lj, tol, "forward")
        np.testing.assert_allclose(float(at), float(aj), atol=tol, rtol=tol)
        assert (float(at) > 0) == bool(cfg.n_experts)
        _agree(cfg, tm.prefill(pt, tt, memory=mt), jm.prefill(pj, tj, memory=mj), tol, "prefill")
        enc_j = mj
        if cfg.n_enc_layers:
            enc_j = jm.encode(pj, mj)
            enc_t = tm.encode(pt, mt)
            assert enc_t.dtype == tdt
            np.testing.assert_allclose(_np(enc_t), _np(enc_j), atol=tol, rtol=tol)
        else:
            assert tm.encode is None

        cj = jm.init_cache(B, 24, memory=enc_j)
        ct = lm_cache_from_arrays(jax.tree.map(np.asarray, cj), device=CPU)
        step = jax.jit(jm.decode_step)
        for s in range(S):
            if jdtype == jnp.float32:
                # Each step from the reference's cache: the bf16 leaves (K/V
                # rows, the SSD conv buffer, the sLSTM h) hold f32 values
                # whose sums ran in different orders, so one may round to
                # the neighbouring bf16 number, and a flip carried into
                # later steps moves the logits by ~1e-4.
                ct = lm_cache_from_arrays(jax.tree.map(np.asarray, cj), device=CPU)
            dj, cj = step(pj, cj, tj[:, s])
            dt, ct = tm.decode_step(pt, ct, tt[:, s])
            _agree(cfg, dt, dj, tol, f"decode step {s}")
        assert ct["pos"] == int(cj["pos"]) == S


@pytest.mark.parametrize("arch", FAMILIES)
def test_cache_interop_keeps_structure_and_types(arch):
    """A JAX cache with memory and recurrent states crosses to the port and
    back leaf for leaf: the same tree (the sLSTM state a tuple, a cross
    layer's empty dict), the same values and leaf types, and the same
    structure as the port's own ``init_cache``."""
    cfg = j_smoke_config(arch)
    jm, tm = j_build_model(cfg), build_model(smoke_config(arch))
    mem = _memory(cfg, np.random.default_rng(0), 2, 8)
    cj = jm.init_cache(2, 12, memory=None if mem is None else jnp.asarray(mem, jnp.bfloat16))
    # Non-zero leaves, so that a value lost on the way shows.
    cj = dict(cj, layers=jax.tree.map(
        lambda a: (a + 0.5).astype(a.dtype), cj["layers"]))
    arrays = jax.tree.map(np.asarray, cj)
    ct = lm_cache_from_arrays(arrays, device=CPU)
    for a, b in zip(jax.tree_util.tree_leaves(ct["layers"]),
                    jax.tree_util.tree_leaves(cj["layers"])):
        assert str(a.dtype).removeprefix("torch.") == str(b.dtype)
    back = lm_tree_to_arrays(ct)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(arrays)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(arrays)):
        np.testing.assert_array_equal(a, np.asarray(b, np.float32) if b.dtype.name == "bfloat16" else b)
    own = tm.init_cache(2, 12, device=CPU, memory=ct["memory"])
    assert (jax.tree_util.tree_structure(lm_tree_to_arrays(own))
            == jax.tree_util.tree_structure(back))


@pytest.mark.parametrize("arch", FAMILIES)
def test_port_decode_matches_its_forward(arch):
    """Decode-vs-forward consistency of the port alone (bf16 compute, the
    port's own weights, the encoded memory in the cache),
    ``tests/test_models.py:103-118``'s bars."""
    cfg = smoke_config(arch)
    m = build_model(cfg)
    params = m.init(0, device=CPU)
    rng = np.random.default_rng(2)
    B, S = 2, 16
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)))
    mem = _memory(cfg, rng, B, S)
    mem = None if mem is None else torch.from_numpy(mem)
    with torch.no_grad():
        full, aux = m.forward(params, tokens, memory=mem)
        assert (float(aux) > 0) == bool(cfg.n_experts)
        enc = m.encode(params, mem) if m.encode is not None else mem
        cache = m.init_cache(B, S + 1, device=CPU, memory=enc)
        dec = []
        for s in range(S):
            lg, cache = m.decode_step(params, cache, tokens[:, s])
            dec.append(lg[:, 0])
    _agree(cfg, torch.stack(dec, dim=1), full, max(0.05, 0.02 * cfg.n_layers), "decode")


def test_param_trees_match_reference_structure():
    """init gives the JAX package's tree for every family: same keys,
    shapes and leaf order; the deterministic leaves (norm scales, SSD
    A_log / D / dt_bias / conv_b) equal the reference's."""
    for arch in ARCH_IDS:
        cfg = smoke_config(arch)
        pt = lm_tree_to_arrays(build_model(cfg).init(0, device=CPU))
        pj = j_build_model(j_smoke_config(arch)).init(jax.random.PRNGKey(0))
        lt, st = jax.tree_util.tree_flatten_with_path(pt)
        lj, sj = jax.tree_util.tree_flatten_with_path(pj)
        assert st == sj, arch
        for (path, a), (_, b) in zip(lt, lj):
            assert a.shape == b.shape, (arch, path)
            name = jax.tree_util.keystr(path)
            if any(k in name for k in ("scale", "A_log", "'D'", "dt_bias", "conv_b")):
                np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, err_msg=name)


def test_active_param_fraction_matches_reference():
    from repro.configs import get_config as j_get_config
    from repro.models.lm import active_param_fraction as j_fraction
    from repro_torch.configs import get_config

    for arch in ARCH_IDS:
        assert active_param_fraction(get_config(arch)) == j_fraction(j_get_config(arch))


def test_cross_attention_layer_matches_reference():
    """``attention(kv_input=...)`` against the JAX layer: K/V from the
    memory, no RoPE, no causal mask; S > 1 through the flash route and the
    one-token step through the decode route (kv_len = T), in f32 and bf16
    (``tests/test_kernels.py:37``'s 2e-5 / 4e-2 for one layer)."""
    from repro.models import layers as jl

    rng = np.random.default_rng(5)
    d, H, KV, hd, B, T = 32, 6, 2, 16, 2, 11
    pj = jl.init_attention(jax.random.PRNGKey(1), d, H, KV, hd)
    pt = lm_params_from_arrays(jax.tree.map(np.asarray, pj), device=CPU)
    for jdt, tdt, tol in ((jnp.float32, torch.float32, 2e-5), (jnp.bfloat16, torch.bfloat16, 4e-2)):
        mem = jnp.asarray(rng.standard_normal((B, T, d)), jdt)
        mt = torch.from_numpy(np.array(mem.astype(jnp.float32))).to(tdt)
        for S in (1, 7):
            x = jnp.asarray(rng.standard_normal((B, S, d)), jdt)
            xt = torch.from_numpy(np.array(x.astype(jnp.float32))).to(tdt)
            want = jl.attention(pj, x, None, None, H, KV, hd, causal=False,
                                kv_input=mem, use_rope=False)
            got = tl.attention(pt, xt, None, None, H, KV, hd, causal=False,
                               kv_input=mt, use_rope=False)
            np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def test_serve_launcher_serves_memory_models_on_cpu():
    """The CPU serve launcher on an encoder-decoder and a VLM smoke
    config: frames / patches drawn before the prompts, prefill with the raw
    memory, decode over the encoded one; prefill == decode at the last
    prompt position; no kernel launched."""
    before = dict(tattn.launches)
    for arch, gen in (("seamless-m4t-medium", 3), ("llama-3.2-vision-11b", 2)):
        res = tserve.main(["--arch", arch, "--device", "cpu", "--batch", "2",
                           "--prompt", "6", "--gen", str(gen)])
        cfg = smoke_config(arch)
        assert res.tokens.shape == (2, gen) and res.all_finite
        assert res.prefill_logits.shape == (2, 1, cfg.vocab_size)
        tol = max(0.05, 0.02 * cfg.n_layers)
        np.testing.assert_allclose(_np(res.prompt_logits), _np(res.prefill_logits),
                                   atol=tol, rtol=tol)
    assert tattn.launches == before


@pytest.mark.cuda
def test_cuda_families_match_cpu_on_card():
    """On a card: the memory models' attention shapes on the kernels
    against the plain versions (flash with T != S, not causal; decode with
    one query row over a projected memory, kv_len = T), and every new smoke
    family's prefill and 4 decode steps, card against CPU, same weights."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the CPU route is covered above)")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    for B, S, T, H, KV, D in ((2, 37, 1600, 8, 2, 128), (2, 256, 256, 16, 16, 64),
                              (1, 129, 300, 4, 1, 64)):
        q = torch.randn(B, S, H, D, generator=gen, device="cuda").bfloat16()
        k = torch.randn(B, T, KV, D, generator=gen, device="cuda").bfloat16()
        v = torch.randn(B, T, KV, D, generator=gen, device="cuda").bfloat16()
        torch.testing.assert_close(tattn.flash_attention(q, k, v, False).float(),
                                   ref.ref_flash_attention(q, k, v, False).float(),
                                   atol=4e-2, rtol=4e-2)
        torch.testing.assert_close(tattn.decode_attention(q[:, 0], k, v, T).float(),
                                   ref.ref_decode_attention(q[:, 0], k, v, T).float(),
                                   atol=4e-2, rtol=4e-2)
    for arch in FAMILIES:
        cfg = smoke_config(arch)
        m = build_model(cfg)
        cpu = m.init(0, device=CPU, dtype=torch.bfloat16)
        gpu = jax.tree.map(lambda t: t.cuda(), cpu)
        rng = np.random.default_rng(3)
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 8)))
        mem = _memory(cfg, rng, 2, 8)
        mem = None if mem is None else torch.from_numpy(mem)
        tol = max(0.05, 0.02 * cfg.n_layers)
        with torch.no_grad():
            pg = m.prefill(gpu, tokens.cuda(), None if mem is None else mem.cuda())
            _agree(cfg, pg.cpu(), m.prefill(cpu, tokens, mem), tol, f"{arch} prefill")
            enc_c = m.encode(cpu, mem) if m.encode else mem
            enc_g = m.encode(gpu, mem.cuda()) if m.encode else (None if mem is None else mem.cuda())
            cc = m.init_cache(2, 5, device=CPU, memory=enc_c)
            cg = m.init_cache(2, 5, device="cuda", memory=enc_g)
            for i in range(4):
                lc, cc = m.decode_step(cpu, cc, tokens[:, i])
                lg, cg = m.decode_step(gpu, cg, tokens[:, i].cuda())
                _agree(cfg, lg.cpu(), lc, tol, f"{arch} decode step {i}")
