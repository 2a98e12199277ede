"""Serving the expert, recurrent and cross-attention families under a mesh
on 2 CPU ranks, held against one process and against the JAX package's
decode steps.

The ranks are ``tests/test_torch_mesh.py``'s (``_spawn``: ``gloo`` over a
``FileStore``); they run this module's ``_job_serve`` once for the module:

* each family's smoke config (float32 compute, weights from seed 0, 2
  prompts of 8 tokens, 6 generated, the memory where the config has one)
  served through ``serve_model(mesh=...)`` on a (1, 2) mesh, against the
  same serve in one process: tokens equal; the last prompt position's and
  the prefill step's logits within 2e-5 (``tests/test_torch_mesh.py``'s
  serving bar: the model axis splits the FFN, the heads and the
  vocabulary, so partial sums are added in another order), and for the
  MoE configs (dbrx, phi3.5-moe, jamba) per-position KL within
  ``tests/test_models.py:103-111``'s bars (max < 0.1, mean < 0.02), since
  a near tie in the router may flip a choice;
* one SSD and one sLSTM decode step through the route that serving takes
  under a mesh (``lm._recurrent_decode``: the SSD's on each rank's rows
  and heads, the sLSTM's on its rows; the input placed by ``act_mid``),
  with the state in a replicated cache (the serving launcher's, the
  parameters replicated) and with it placed by ``cache_sharding`` (the
  SSD state split over its heads and the conv buffer over its channels on
  'model', the parameters placed by ``param_sharding``: the dry run's
  decode), on the (1, 2) mesh, each against the JAX package's decode step
  from the same state, drawn from a seed: the output and every float32
  state leaf within 1e-4
  (``tests/test_torch_ssm.py``'s mixer bar), the bf16 leaves (the SSD conv
  buffer, the sLSTM h) within one bf16 step of the reference's (the f32
  values before the rounding differ in the frameworks' sum orders).
"""

import itertools
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_mesh import TIMEOUT, _spawn

FAMILIES = ["dbrx_132b", "phi3_5_moe_42b", "jamba_v0_1_52b", "xlstm_350m",
            "seamless_m4t_medium", "llama3_2_vision_11b"]
GEN = 6
DECODE = {  # mixer: (arch, lm mixer kind)
    "ssd": ("jamba_v0_1_52b", "mamba"),
    "slstm": ("xlstm_350m", "slstm"),
}
ROUTES = ("replicated", "placed")  # the decode state's placement


def _served(arch: str):
    """(model, params, prompts, memory) of ``arch``'s smoke serve."""
    from repro_torch.configs import smoke_config
    from repro_torch.models.lm import build_model

    cfg = smoke_config(arch)
    model = build_model(cfg, compute_dtype=torch.float32)
    rng = np.random.default_rng(3)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 8)))
    memory = None
    if cfg.n_enc_layers or cfg.cross_attn_every:
        T = 8 if cfg.n_enc_layers else cfg.n_patches
        memory = torch.from_numpy(rng.standard_normal((2, T, cfg.d_model)).astype(np.float32))
    return model, model.init(0, device="cpu"), prompts, memory


def _job_serve(rank: int, world: int, d: Path) -> None:
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.configs import smoke_config
    from repro_torch.distribution import sharding as S
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.serve import _replicated, serve_model
    from repro_torch.models import lm
    from repro_torch.models.layers import activation_sharding

    mesh = make_local_mesh(model=world, device="cpu")
    for arch in FAMILIES:
        model, params, prompts, memory = _served(arch)
        res = serve_model(model, params, prompts, GEN, memory=memory, mesh=mesh)
        if rank == 0:
            np.savez(d / f"{arch}.npz", tokens=res.tokens.numpy(),
                     prompt_logits=res.prompt_logits.numpy(),
                     prefill_logits=res.prefill_logits.numpy())
    rules = S.activation_rules(mesh)
    for (mixer, (arch, kind)), route in itertools.product(DECODE.items(), ROUTES):
        inp = torch.load(d / f"{mixer}_in.pt")
        stacked = lm._stack([inp["state"]])  # one repeat
        with activation_sharding(rules), torch.no_grad():
            if route == "replicated":
                p, cache = _replicated((inp["params"], stacked), mesh)
            else:
                p = S.distribute(inp["params"], S.param_sharding(inp["params"], mesh))
                cache = S.distribute(stacked, S.cache_sharding(stacked, mesh))
            u = DTensor.from_local(inp["u"], mesh, [Replicate()] * 2).redistribute(
                mesh, rules["act_mid"].placements)
            y = lm._recurrent_decode(kind, p, smoke_config(arch), u, cache, 0)
        placements = [repr(t.placements) for t in lm._leaves(cache)]
        y, state = y.full_tensor(), lm._take(S.gather(cache), 0)  # collectives: every rank
        if rank == 0:
            torch.save({"y": y, "state": state, "placements": placements},
                       d / f"{mixer}_{route}_out.pt")


def _decode_inputs(mixer: str):
    """The JAX package's parameters of ``mixer``, a state drawn from seed 5
    (bf16 leaves rounded first, ``n`` of the sLSTM positive) and an input
    [2, 1, d]; returns (jax params, jax state, jax u, the same as the port's
    tensors)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import smoke_config as j_smoke_config
    from repro.models import ssm as jssm
    from repro_torch.interop import lm_params_from_arrays

    arch, _ = DECODE[mixer]
    jcfg = j_smoke_config(arch)
    rng = np.random.default_rng(5)
    init = jssm.init_ssd if mixer == "ssd" else jssm.init_slstm
    pj = init(jax.random.PRNGKey(3), jcfg)
    zero = (jssm.ssd_init_state if mixer == "ssd" else jssm.slstm_init_state)(jcfg, 2)

    def draw(a):
        x = rng.standard_normal(a.shape).astype(np.float32)
        return jnp.asarray(x, a.dtype)

    sj = jax.tree.map(draw, zero)
    if mixer == "slstm":  # (c, n, m, h): a normaliser n >= 1, a finite stabiliser m
        c, n, m, h = sj
        sj = (c, jnp.abs(n) + 1.0, m, h)
    uj = jnp.asarray(rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32))
    to_t = lambda a: torch.from_numpy(np.array(a.astype(jnp.float32))).to(  # noqa: E731
        torch.bfloat16 if a.dtype == jnp.bfloat16 else torch.float32)
    st = jax.tree.map(to_t, sj)
    st = tuple(st) if isinstance(st, (tuple, list)) else st
    port = {"params": lm_params_from_arrays(jax.tree.map(np.asarray, pj), device="cpu"),
            "state": st, "u": to_t(uj)}
    return pj, sj, uj, port


@pytest.fixture(scope="module")
def served(tmp_path_factory) -> Path:
    d = tmp_path_factory.mktemp("serve")
    for mixer in DECODE:
        torch.save(_decode_inputs(mixer)[3], d / f"{mixer}_in.pt")
    _spawn("serve", 2, d, module="test_torch_mesh_families_serve", timeout=2 * TIMEOUT)
    return d


def _kl(p_logits: np.ndarray, q_logits: np.ndarray) -> np.ndarray:
    p = torch.log_softmax(torch.from_numpy(p_logits).double(), dim=-1)
    q = torch.log_softmax(torch.from_numpy(q_logits).double(), dim=-1)
    return (p.exp() * (p - q)).sum(dim=-1).numpy()


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_serves_the_same_tokens_under_a_mesh(served, arch):
    from repro_torch.launch.serve import serve_model

    model, params, prompts, memory = _served(arch)
    want = serve_model(model, params, prompts, GEN, memory=memory)
    got = np.load(served / f"{arch}.npz")
    np.testing.assert_array_equal(got["tokens"], want.tokens.numpy())
    for k in ("prompt_logits", "prefill_logits"):
        w = getattr(want, k).numpy()
        if model.cfg.n_experts:
            kl = _kl(w, got[k])
            assert float(kl.max()) < 0.1 and float(kl.mean()) < 0.02, (k, kl)
        else:
            np.testing.assert_allclose(got[k], w, atol=2e-5, rtol=0, err_msg=k)


def _check_decode(served: Path, mixer: str, route: str) -> None:
    import jax

    from repro.configs import smoke_config as j_smoke_config
    from repro.models import ssm as jssm

    pj, sj, uj, _ = _decode_inputs(mixer)
    jcfg = j_smoke_config(DECODE[mixer][0])
    step = jssm.ssd_decode_step if mixer == "ssd" else jssm.slstm_decode_step
    yj, sj = step(pj, jcfg, uj, sj)
    out = torch.load(served / f"{mixer}_{route}_out.pt")
    np.testing.assert_allclose(out["y"].numpy(), np.asarray(yj), atol=1e-4, rtol=1e-4)
    got = jax.tree_util.tree_leaves(out["state"])
    want = jax.tree_util.tree_leaves(sj)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype)
        gf, wf = g.float().numpy(), np.asarray(w.astype(np.float32))
        if g.dtype == torch.bfloat16:
            step_of = np.abs(wf) * 2.0 ** -7 + 1e-30  # one bf16 step (8 significant bits)
            assert np.all(np.abs(gf - wf) <= step_of), float(np.abs(gf - wf).max())
        else:
            np.testing.assert_allclose(gf, wf, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("mixer", list(DECODE))
def test_recurrent_decode_step_under_a_mesh_matches_reference(served, mixer):
    _check_decode(served, mixer, "replicated")


@pytest.mark.parametrize("mixer", list(DECODE))
def test_recurrent_decode_step_with_a_placed_state_matches_reference(served, mixer):
    out = torch.load(served / f"{mixer}_placed_out.pt")
    if mixer == "ssd":
        # cache_sharding splits the SSD state over its heads and the conv
        # buffer over its channels on 'model' (mesh dim 1): the per-head route.
        assert sorted(out["placements"]) == ["(Shard(dim=1), Shard(dim=2))",
                                             "(Shard(dim=1), Shard(dim=3))"], out["placements"]
    _check_decode(served, mixer, "placed")
