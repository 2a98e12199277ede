"""Decode with the cache placed by ``cache_sharding`` on 4 CPU ranks.

The ranks are ``tests/test_torch_mesh.py``'s (``_spawn``: ``gloo`` over a
``FileStore``) on a (2, 2) mesh over ("data", "model"). For the dense
smoke config, jamba (attention, SSD and MoE layers) and xlstm (mLSTM and
sLSTM), in float32 compute with the JAX package's weights from
``PRNGKey(0)``, each rank decodes with the cache placed by
``cache_sharding`` (K/V batch over 'data' and D over 'model'; with batch
1, T over 'data'; the SSD ``ssm`` over its heads and ``conv`` over its
channels; the xLSTM states over the batch) and with a replicated cache
(the serving launcher's):

* greedy tokens from the same prompts: equal on the two routes;
* the logits of a fixed token sequence, fed a step at a time: within
  2e-5 of the replicated route's (``tests/test_torch_mesh.py``'s serving
  bar) and within 1e-4 of the JAX package's serve step run with its cache
  placed by its own ``cache_sharding`` on a (2, 2) mesh of forced host
  devices (the whole-model float32 bar of ``tests/test_torch_models.py``);
  for the MoE config, per-position KL within ``tests/test_models.py``'s
  bars (max < 0.1, mean < 0.02), as ``tests/test_torch_mesh_families_serve.py``
  holds it, since a near tie in the router may flip a choice;
* the cache after the steps, gathered (but jamba's, below): its float32 leaves within 1e-4 of
  the replicated route's (``tests/test_torch_mesh_families_serve.py``'s bar
  for a decode state), its bf16 leaves within one bf16 step (the
  float32 values before the rounding differ in their sum orders), as
  ``tests/test_torch_mesh_families_serve.py`` holds the decode states;
* jamba's cached mixers one layer at a time (its whole stack amplifies a
  sum-order difference ~880x, PERF.md §7, so its cache after the steps is
  held by the logits' KL): the SSD and the attention layer of its period,
  each stepped once through ``lm._decode_mixer`` from a state drawn from a
  seed (K/V rows up to ``MIXER_POS``) with the cache placed by
  ``cache_sharding``, at batch 2 and at batch 1 (T over 'data'), against
  the same step in one process: the output and every float32 state leaf
  within 1e-4 (``tests/test_torch_mesh_families_serve.py``'s decode-step
  bar), the bf16 leaves within one bf16 step;
* on the card, the route that splits the head dimension or the rows has
  no kernel and raises ``NotImplementedError`` (checked here by
  monkeypatching the device test).
"""

from __future__ import annotations

import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_mesh import SRC, TIMEOUT, _spawn

CASES = {  # name: (arch, batch)
    "dense_b2": ("llama3_2_3b", 2),
    "dense_b1": ("llama3_2_3b", 1),
    "jamba_b2": ("jamba_v0_1_52b", 2),
    "xlstm_b2": ("xlstm_350m", 2),
}
MAX_LEN = 8
FEED = 6  # tokens fed one step at a time (the greedy runs: PROMPT, then their argmax)
PROMPT = 4
JAMBA = "jamba_v0_1_52b"
MIXERS = {"ssd": "mamba", "attn": "attn"}  # jamba's cached mixer kinds
MIXER_POS = 5  # the attention step's position: rows 0-4 drawn, row 5 written

_JAX_REF = """
import json, pickle, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.configs import smoke_config
from repro.distribution.sharding import activation_rules, batch_sharding, cache_sharding, param_sharding
from repro.models.layers import activation_sharding
from repro.models.lm import build_model
from repro.runtime.steps import build_serve_step

d, cases, max_len = sys.argv[1], json.loads(sys.argv[2]), int(sys.argv[3])
assert len(jax.devices()) == 4
mesh = Mesh(np.asarray(jax.devices()).reshape(2, 2), ("data", "model"))
for name, (arch, B) in cases.items():
    model = build_model(smoke_config(arch), compute_dtype=jnp.float32)
    params = model.init(jax.random.PRNGKey(0))
    with open(f"{d}/{arch}_params.pkl", "wb") as f:
        pickle.dump(jax.tree.map(np.asarray, params), f)
    feed = np.load(f"{d}/{name}_feed.npy")
    with activation_sharding(activation_rules(mesh)), mesh:
        cache = model.init_cache(B, max_len)
        c_sh = cache_sharding(jax.eval_shape(lambda: cache), mesh)
        p_sh = param_sharding(jax.eval_shape(lambda: params), mesh)
        tok = jnp.asarray(feed[:, 0])
        t_sh = batch_sharding(jax.eval_shape(lambda: tok), mesh)
        step = jax.jit(build_serve_step(model), in_shardings=(p_sh, c_sh, t_sh),
                       out_shardings=(None, c_sh), donate_argnums=(1,))
        p, cache = jax.device_put(params, p_sh), jax.device_put(cache, c_sh)
        logits = []
        for t in range(feed.shape[1]):
            lg, cache = step(p, cache, jax.device_put(jnp.asarray(feed[:, t]), t_sh))
            logits.append(np.asarray(lg[:, 0]))
    np.save(f"{d}/{name}_jax_logits.npy", np.stack(logits, 1))
"""


def _model(arch: str):
    from repro_torch.configs import smoke_config
    from repro_torch.models.lm import build_model

    return build_model(smoke_config(arch), compute_dtype=torch.float32)


def _job_cache(rank: int, world: int, d: Path) -> None:
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.distribution import sharding as S
    from repro_torch.interop import lm_params_from_arrays
    from repro_torch.launch.serve import _replicated
    from repro_torch.models import layers
    from repro_torch.models.layers import activation_sharding

    mesh = DeviceMesh("cpu", torch.arange(world).reshape(2, 2), mesh_dim_names=("data", "model"))
    rules = S.activation_rules(mesh)
    out = {}

    def decode(model, params, cache, tokens, greedy: bool):
        """Logits [B, n, V] of feeding ``tokens`` [B, n] (greedy: only the
        first, then each step's argmax) and the tokens fed."""
        logits, fed = [], []
        tok = tokens[:, 0]
        for t in range(tokens.shape[1]):
            fed.append(tok)
            tok_d = S.distribute(tok, S.batch_sharding(tok, mesh))
            lg, cache = model.decode_step(params, cache, tok_d)
            lg = lg.full_tensor()[:, 0]
            logits.append(lg)
            if t + 1 < tokens.shape[1]:
                tok = lg.argmax(-1).to(tokens.dtype) if greedy and t + 1 >= PROMPT \
                    else tokens[:, t + 1]
        return torch.stack(logits, 1), torch.stack(fed, 1), cache

    for name, (arch, B) in CASES.items():
        model = _model(arch)
        with open(d / f"{arch}_params.pkl", "rb") as f:
            params = lm_params_from_arrays(pickle.load(f), device="cpu")
        feed = torch.from_numpy(np.load(d / f"{name}_feed.npy"))
        with activation_sharding(rules), torch.no_grad():
            placed_p = S.distribute(params, S.param_sharding(params, mesh))
            for route in ("placed", "replicated"):
                runs = {}
                for greedy in (False, True):
                    cache = model.init_cache(B, MAX_LEN, device="cpu")
                    if route == "placed":
                        cache = S.distribute(cache, S.cache_sharding(cache, mesh))
                        if not greedy:
                            out[f"{name}_placements"] = {
                                f"{j}.{k}": [repr(p) for p in v.placements]
                                for j, lay in enumerate(cache["layers"])
                                for k, v in (lay.items() if isinstance(lay, dict)
                                             else enumerate(lay))}
                    else:
                        cache = _replicated(cache, mesh)
                    runs[greedy] = decode(model, placed_p, cache, feed, greedy)
                logits, _, cache = runs[False]
                _, tokens, _ = runs[True]
                if rank == 0:
                    torch.save({"logits": logits, "tokens": tokens,
                                "cache": S.gather(cache)["layers"]},
                               d / f"{name}_{route}.pt")
                else:
                    S.gather(cache)

    for name, B in ((f"{m}_b{b}", b) for m in MIXERS for b in (2, 1)):
        inp = torch.load(d / f"mixer_{name}.pt")
        with activation_sharding(rules), torch.no_grad():
            lp = S.distribute(inp["params"], S.param_sharding(inp["params"], mesh))
            mc = S.distribute(inp["cache"], S.cache_sharding(inp["cache"], mesh))
            x = DTensor.from_local(inp["x"], mesh, [Replicate()] * 2).redistribute(
                mesh, rules["act_hidden"].placements)
            y = _mixer_step(inp["mixer"], lp, x, mc)
        placements = {k: repr(v.placements) for k, v in mc.items()}
        y, mc = y.full_tensor(), S.gather(mc)  # collectives: every rank
        if rank == 0:
            torch.save({"y": y, "cache": mc, "placements": placements},
                       d / f"mixer_{name}_out.pt")

    # The split-D route has no kernel: a CUDA cache raises there.
    att = layers.init_attention(torch.Generator().manual_seed(0), 64, 4, 2, 16)
    x = DTensor.from_local(torch.ones((2, 1, 64)), mesh, [Replicate(), Replicate()])
    cache = S.distribute({"k": torch.zeros((2, 8, 2, 16)), "v": torch.zeros((2, 8, 2, 16))},
                         {k: S.NamedSharding(mesh, S.PartitionSpec("data", None, None, "model"))
                          for k in ("k", "v")})
    real = layers._on_card
    layers._on_card = lambda t: True
    try:
        with activation_sharding(rules), torch.no_grad():
            layers.decode_attention(att, x, 3, cache["k"], cache["v"], 1e4, 4, 2, 16)
    except NotImplementedError as e:
        out["cuda_split_raises"] = str(e)
    finally:
        layers._on_card = real
    if rank == 0:
        (d / "job.json").write_text(json.dumps(out))


def _mixer_step(mixer: str, lp, x, mc):
    """One token through jamba's period layer of kind ``mixer`` (its mixer
    parameters ``lp``), repeat 0 of the stacked cache ``mc`` written in
    place."""
    from repro_torch.models import lm

    return lm._decode_mixer(lp, _model(JAMBA).cfg, MIXERS[mixer], x, MIXER_POS, mc, 0, None)


def _mixer_inputs(params, mixer: str, B: int, seed: int) -> dict:
    """jamba's first ``mixer`` layer's parameters (repeat 0), its stacked
    cache (every leaf drawn from ``seed``, rounded to its dtype; K/V rows
    from ``MIXER_POS`` on zero) and an input [B, 1, d]."""
    from repro_torch.models import lm
    from repro_torch.models.config import layer_kinds

    cfg = _model(JAMBA).cfg
    j = [m for m, _ in layer_kinds(cfg)].index(MIXERS[mixer])
    cache = lm._mixer_cache(cfg, MIXERS[mixer], B, MAX_LEN, 1, torch.device("cpu"))
    gen = torch.Generator().manual_seed(seed)
    for k, v in cache.items():
        v.copy_(torch.randn(v.shape, generator=gen))
        if k in ("k", "v"):
            v[:, :, MIXER_POS:] = 0
    return {"mixer": mixer, "params": lm._take(params["layers"][j], 0)["mixer"],
            "cache": cache, "x": torch.randn((B, 1, cfg.d_model), generator=gen)}


@pytest.fixture(scope="module")
def ran(tmp_path_factory) -> Path:
    d = tmp_path_factory.mktemp("cache")
    rng = np.random.default_rng(7)
    for name, (arch, B) in CASES.items():
        np.save(d / f"{name}_feed.npy", rng.integers(0, 256, (B, FEED)).astype(np.int64))
    env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    cases = {k: list(v) for k, v in CASES.items()}
    jax_ref = subprocess.run([sys.executable, "-c", _JAX_REF, str(d), json.dumps(cases),
                              str(MAX_LEN)], env=env, capture_output=True, text=True,
                             timeout=TIMEOUT)
    assert jax_ref.returncode == 0, jax_ref.stderr[-4000:]
    params = _jamba_params(d)
    for i, (mixer, B) in enumerate((m, b) for m in MIXERS for b in (2, 1)):
        torch.save(_mixer_inputs(params, mixer, B, seed=i), d / f"mixer_{mixer}_b{B}.pt")
    _spawn("cache", 4, d, module="test_torch_mesh_cache")
    return d


def _jamba_params(d: Path):
    from repro_torch.interop import lm_params_from_arrays

    with open(d / f"{JAMBA}_params.pkl", "rb") as f:
        return lm_params_from_arrays(pickle.load(f), device="cpu")


def _kl(p_logits: torch.Tensor, q_logits: torch.Tensor) -> torch.Tensor:
    p = torch.log_softmax(p_logits.double(), dim=-1)
    q = torch.log_softmax(q_logits.double(), dim=-1)
    return (p.exp() * (p - q)).sum(dim=-1)


def _close(got: torch.Tensor, want: torch.Tensor, moe: bool, atol: float, what: str) -> None:
    if moe:
        kl = _kl(want, got)
        assert float(kl.max()) < 0.1 and float(kl.mean()) < 0.02, (what, kl)
    else:
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=atol, rtol=0, err_msg=what)


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


def _close_leaf(a: torch.Tensor, b: torch.Tensor) -> None:
    assert a.dtype == b.dtype and a.shape == b.shape
    af, bf = a.float().numpy(), b.float().numpy()
    if a.dtype == torch.bfloat16:
        # One bf16 step (8 significant bits): the float32 values before
        # the rounding differ in their sum orders.
        assert np.all(np.abs(af - bf) <= np.abs(bf) * 2.0 ** -7 + 1e-30)
    else:
        np.testing.assert_allclose(af, bf, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("case", list(CASES))
def test_placed_cache_decodes_as_the_replicated_one_and_the_reference(ran, case):
    arch, B = CASES[case]
    moe = bool(_model(arch).cfg.n_experts)
    placed = torch.load(ran / f"{case}_placed.pt")
    rep = torch.load(ran / f"{case}_replicated.pt")
    assert torch.equal(placed["tokens"], rep["tokens"])
    _close(placed["logits"], rep["logits"], moe, 2e-5, "placed vs replicated")
    # jamba's smoke stack amplifies a sum-order difference ~880x (its SSD
    # layers; PERF.md §7, in both packages): its replicated route is 6e-4
    # from the JAX package's logits, so its state is held by the logits' KL.
    for a, b in zip(_leaves(placed["cache"]), [] if moe else _leaves(rep["cache"])):
        _close_leaf(a, b)
    jax_logits = torch.from_numpy(np.load(ran / f"{case}_jax_logits.npy"))
    _close(placed["logits"], jax_logits, moe, 1e-4, "placed vs the JAX package")


def test_the_cache_is_split_as_cache_sharding_says(ran):
    job = json.loads((ran / "job.json").read_text())
    # Batch 2: K/V batch over 'data' (mesh dim 0), D over 'model' (mesh dim 1).
    kv = job["dense_b2_placements"]["0.k"]
    assert kv == ["Shard(dim=1)", "Shard(dim=4)"], kv
    # Batch 1: T over 'data' instead.
    kv = job["dense_b1_placements"]["0.k"]
    assert kv == ["Shard(dim=2)", "Shard(dim=4)"], kv
    # The SSD state over its heads and the conv buffer over its channels.
    jamba = job["jamba_b2_placements"]
    assert ["Shard(dim=1)", "Shard(dim=2)"] in jamba.values()
    assert ["Shard(dim=1)", "Shard(dim=3)"] in jamba.values()
    # The table's mLSTM rule takes a C of 4 dims; stacked over the repeats it
    # has 5 and takes the batch split only, in both packages: every xlstm
    # state leaf is split over the batch alone.
    assert all(v == ["Shard(dim=1)", "Replicate()"] for v in job["xlstm_b2_placements"].values())
    assert "head dimension" in job["cuda_split_raises"]


@pytest.mark.parametrize("case", [f"{m}_b{b}" for m in MIXERS for b in (2, 1)])
def test_jamba_mixer_steps_with_a_placed_cache_match_one_process(ran, case):
    mixer, B = case.split("_b")[0], int(case.split("_b")[1])
    inp = torch.load(ran / f"mixer_{case}.pt")
    out = torch.load(ran / f"mixer_{case}_out.pt")
    with torch.no_grad():
        y = _mixer_step(mixer, inp["params"], inp["x"], inp["cache"])
    # The cache is split as cache_sharding says: the SSD state over its
    # heads and the conv buffer over its channels on 'model' (mesh dim 1),
    # K/V's D on 'model' and the batch, or with batch 1 T, on 'data'.
    split = {"ssd": {"ssm": "Shard(dim=2)", "conv": "Shard(dim=3)"},
             "attn": {"k": "Shard(dim=4)", "v": "Shard(dim=4)"}}[mixer]
    rows = "Shard(dim=1)" if B == 2 else ("Shard(dim=2)" if mixer == "attn" else "Replicate()")
    assert out["placements"] == {k: f"({rows}, {v})" for k, v in split.items()}, out["placements"]
    np.testing.assert_allclose(out["y"].numpy(), y.numpy(), atol=1e-4, rtol=1e-4)
    for k in inp["cache"]:
        _close_leaf(out["cache"][k], inp["cache"][k])
