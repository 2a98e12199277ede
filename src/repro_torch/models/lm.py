"""Model builder for every architecture family (counterpart of
``repro.models.lm``).

``build_model(cfg)`` returns a :class:`Model` with the training and
serving functions:

  init(seed, device=None, dtype=fp32)              -> params
  encode(params, frames)                           -> memory (enc-dec only)
  hidden(params, tokens, memory=None)              -> (final hidden [B, S, d], aux)
  forward(params, tokens, memory=None)             -> (logits [B, S, V], aux)
  loss(params, batch)                              -> scalar training loss
  prefill(params, tokens, memory=None)             -> last-position logits [B, 1, V]
  init_cache(batch, max_len, device, memory=None)  -> cache (decode state)
  decode_step(params, cache, token)                -> (logits [B, 1, V], cache)

Mixers: attn (causal self), attn_cross (self + cross), cross (cross-only),
mamba (SSD), slstm, mlstm. FFNs: mlp (SwiGLU), moe, none. ``memory`` is
the raw frames of an encoder-decoder model (``forward`` and ``prefill``
encode them) or the patches of a cross-attention model; the decode cache
holds the encoded memory.

The parameter tree is the JAX package's: nested dicts, with the layers of
each position of the layer-kind period stacked along a leading repeat
axis, so that weights carry across leaf by leaf
(:func:`repro_torch.interop.lm_params_from_arrays`). The JAX package's
layer scan is a Python loop over the repeats here, with the whole period
applied inside each repeat (the layer order of ``lm.py:463-476``).

With gradients on, the JAX package's ``jax.checkpoint``s become
``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``: one per
period in ``hidden`` (``lm.py:362``), one per encoder layer (``:306``)
and one per chunk of the loss (``:410``), so the backward pass keeps one
period's input per repeat and recomputes the rest; values are the same
with and without. ``hidden`` and ``encode`` take the repeats of every
stacked leaf once per call with ``torch.unbind``, whose backward stacks
their gradients once (selecting a repeat with ``tree[i]`` would add a
zero tensor of the whole stacked shape per repeat in the backward pass).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.distribution.sharding import shard_index
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm
from repro_torch.models.config import ModelConfig, layer_kinds, layer_period
from repro_torch.models.layers import (
    _replicated_local,
    attention,
    decode_attention,
    embed,
    init_attention,
    init_embedding,
    init_mlp,
    init_rms_norm,
    mlp_swiglu,
    rms_norm,
    rope_tables,
    shard,
    under_current_rules,
    unembed,
)

Params = Any

__all__ = ["Model", "build_model", "count_params", "active_param_fraction", "AUX_COEF"]

AUX_COEF = 0.01  # weight of the MoE load-balance loss (lm.py:48)


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable
    forward: Callable
    init_cache: Callable
    decode_step: Callable
    loss: Callable
    hidden: Callable
    prefill: Callable
    encode: Callable | None = None  # enc-dec only: frames -> memory


def _take(tree: Any, i: int) -> Any:
    """Repeat ``i`` of a stacked parameter or cache tree (views, no copy)."""
    if isinstance(tree, dict):
        return {k: _take(v, i) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_take(v, i) for v in tree)
    return tree[i]


def _unstack(tree: Any, n: int) -> list:
    """The ``n`` repeats of a stacked parameter tree, each leaf split once
    with ``torch.unbind`` (views; one backward node per leaf)."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    if isinstance(tree, tuple):
        parts = [_unstack(v, n) for v in tree]
        return [tuple(p[i] for p in parts) for i in range(n)]
    return list(torch.unbind(tree, dim=0))


def _remat(fn: Callable, *args):
    """``fn(*args)``, recomputed in the backward pass when gradients are on
    (the JAX package's ``jax.checkpoint``); the same values either way.
    The recompute runs under the forward's activation rules, as
    ``jax.checkpoint``'s runs under the forward's sharding constraints."""
    if torch.is_grad_enabled():
        return checkpoint(under_current_rules(fn), *args, use_reentrant=False)
    return fn(*args)


def _stack(trees: list) -> Any:
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    if isinstance(trees[0], tuple):
        return tuple(_stack(list(ts)) for ts in zip(*trees))
    return torch.stack(trees, dim=0)


def _store(stacked: Any, i: int, tree: Any) -> None:
    """Write ``tree`` into repeat ``i`` of a stacked cache tree, in place."""
    if isinstance(stacked, dict):
        for k in stacked:
            _store(stacked[k], i, tree[k])
    elif isinstance(stacked, tuple):
        for s, t in zip(stacked, tree):
            _store(s, i, t)
    else:
        stacked[i].copy_(tree)


def _gold_logit(lg: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``lg[..., labels]``: each position's logit of its label.

    Under a mesh ``lg`` is a DTensor split over the vocabulary by
    ``act_logits``. DTensor has a strategy for this gather (a masked
    partial sum), but the reduction of that partial fails on a gather's
    [B, c, 1] index (``MaskPartial`` masks rows of a 1-D embedding index),
    so the same masked partial is written out here: each rank gathers the
    labels that fall in its slice of the vocabulary, zeros the rest, and
    the partial values are summed over the vocabulary's mesh dims. No
    logits are gathered."""
    if not isinstance(lg, DTensor):
        return torch.gather(lg, -1, labels[..., None].long())[..., 0]
    mesh, pl = lg.device_mesh, lg.placements
    rows = [p if p.is_shard(0) else Replicate() for p in pl]  # the batch split, kept
    local = lg.to_local()
    n_local = local.shape[-1]
    lab = labels.redistribute(mesh, rows).to_local().long()
    lab = lab - shard_index(mesh, pl, lg.ndim - 1) * n_local
    hit = (lab >= 0) & (lab < n_local)
    g = torch.gather(local, -1, torch.where(hit, lab, 0)[..., None])[..., 0] * hit
    partial = [Partial() if p.is_shard(lg.ndim - 1) else r for p, r in zip(pl, rows)]
    return DTensor.from_local(g, mesh, partial, run_check=False).redistribute(mesh, rows)


# Recurrent mixers: parameter key, zero decode state, one decode step.
_RECURRENT = {
    "mamba": ("ssd", ssm.ssd_init_state, ssm.ssd_decode_step),
    "slstm": ("cell", ssm.slstm_init_state, ssm.slstm_decode_step),
    "mlstm": ("cell", ssm.mlstm_init_state, ssm.mlstm_decode_step),
}


# --------------------------------------------------------------------------
# Per-kind layer init
# --------------------------------------------------------------------------

def _init_mixer(gen: torch.Generator, cfg: ModelConfig, mixer: str, dtype) -> Params:
    norm = init_rms_norm(cfg.d_model, gen.device, dtype)
    if mixer in ("attn", "cross", "attn_cross"):
        p = {
            "norm": norm,
            "attn": init_attention(
                gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                qkv_bias=cfg.qkv_bias, dtype=dtype,
            ),
        }
        if mixer == "attn_cross":
            p["xnorm"] = init_rms_norm(cfg.d_model, gen.device, dtype)
            p["xattn"] = init_attention(
                gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, dtype=dtype
            )
        return p
    if mixer == "mamba":
        return {"norm": norm, "ssd": ssm.init_ssd(gen, cfg, dtype)}
    if mixer == "slstm":
        return {"norm": norm, "cell": ssm.init_slstm(gen, cfg, dtype)}
    if mixer == "mlstm":
        return {"norm": norm, "cell": ssm.init_mlstm(gen, cfg, dtype)}
    raise ValueError(mixer)


def _init_ffn(gen: torch.Generator, cfg: ModelConfig, ffn: str, dtype) -> Params:
    if ffn == "none":
        return {}
    norm = init_rms_norm(cfg.d_model, gen.device, dtype)
    if ffn == "mlp":
        return {"norm": norm, "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, dtype)}
    if ffn == "moe":
        return {
            "norm": norm,
            "moe": moe_mod.init_moe(gen, cfg.d_model, cfg.d_ff, cfg.n_experts, dtype),
        }
    raise ValueError(ffn)


# --------------------------------------------------------------------------
# Layer application: whole sequence, and one token against the cache
# --------------------------------------------------------------------------

def _apply_mixer(lp, cfg: ModelConfig, mixer: str, x, cos, sin, memory):
    h = rms_norm(lp["norm"], x, cfg.norm_eps)
    heads = (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
    if mixer == "attn":
        return x + attention(lp["attn"], h, cos, sin, *heads)
    if mixer == "cross":
        return x + attention(
            lp["attn"], h, cos, sin, *heads, causal=False, kv_input=memory, use_rope=False
        )
    if mixer == "attn_cross":
        x = x + attention(lp["attn"], h, cos, sin, *heads)
        h2 = rms_norm(lp["xnorm"], x, cfg.norm_eps)
        return x + attention(
            lp["xattn"], h2, cos, sin, *heads, causal=False, kv_input=memory, use_rope=False
        )
    if mixer == "mamba":
        y, _ = ssm.ssd_forward(lp["ssd"], cfg, h)
    elif mixer == "slstm":
        y, _ = ssm.slstm_forward(lp["cell"], cfg, h)
    elif mixer == "mlstm":
        y, _ = ssm.mlstm_forward(lp["cell"], cfg, h)
    else:
        raise ValueError(mixer)
    return x + y


def _apply_ffn(lp, cfg: ModelConfig, ffn: str, x):
    """(x after the FFN, the MoE aux loss or None)."""
    if ffn == "none":
        return x, None
    h = rms_norm(lp["norm"], x, cfg.norm_eps)
    if ffn == "mlp":
        return x + mlp_swiglu(lp["mlp"], h), None
    y, aux = moe_mod.moe_ffn(
        lp["moe"], h, cfg.n_experts, cfg.experts_per_token,
        capacity_factor=cfg.capacity_factor, normalize=cfg.router_normalize,
    )
    return x + y, aux


def _mixer_cache(cfg: ModelConfig, mixer: str, batch: int, max_len: int,
                 repeats: int, dev: torch.device):
    """Zero decode state of one period position, stacked over the repeats
    (``lm.py:184-204``); cross layers keep none (the memory is shared)."""
    if mixer in ("attn", "attn_cross"):
        shape = (repeats, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
        return {
            "k": torch.zeros(shape, dtype=torch.bfloat16, device=dev),
            "v": torch.zeros(shape, dtype=torch.bfloat16, device=dev),
        }
    if mixer == "cross":
        return {}
    init_state = _RECURRENT[mixer][1]
    return _stack([init_state(cfg, batch, dev) for _ in range(repeats)])


def _decode_mixer(lp, cfg: ModelConfig, mixer: str, x, pos: int, mc, rep: int, memory):
    """One token through one mixer; K/V rows and recurrent states are
    written into repeat ``rep`` of the stacked cache ``mc`` in place."""
    h = rms_norm(lp["norm"], x, cfg.norm_eps)
    heads = (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
    if mixer in ("attn", "attn_cross"):
        out, _, _ = decode_attention(
            lp["attn"], h, pos, mc["k"][rep], mc["v"][rep], cfg.rope_theta, *heads
        )
        x = x + out
        if mixer == "attn_cross":
            h2 = rms_norm(lp["xnorm"], x, cfg.norm_eps)
            x = x + attention(
                lp["xattn"], h2, None, None, *heads, causal=False, kv_input=memory,
                use_rope=False,
            )
        return x
    if mixer == "cross":
        return x + attention(
            lp["attn"], h, None, None, *heads, causal=False, kv_input=memory, use_rope=False
        )
    if mixer not in _RECURRENT:
        raise ValueError(mixer)
    return x + _recurrent_decode(mixer, lp[_RECURRENT[mixer][0]], cfg, h, mc, rep)


def _recurrent_decode(mixer: str, p, cfg: ModelConfig, h, mc, rep: int):
    """One token through the recurrent ``mixer``'s cell ``p`` (the mixer's
    output before the residual); its state, repeat ``rep`` of the stacked
    cache ``mc``, is written back in place. Under a mesh the SSD step runs
    on each rank's rows and heads (``ssm._sharded_ssd_step``), the xLSTM
    steps on each rank's rows (:func:`_mesh_decode`)."""
    step = _RECURRENT[mixer][2]
    if isinstance(h, DTensor) and mixer != "mamba":
        return _mesh_decode(step, p, cfg, h, mc, rep)
    y, state = step(p, cfg, h, _take(mc, rep))
    _store(mc, rep, state)
    return y


def _map(fn: Callable, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree: Any) -> list:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, tuple):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


def _store_own(placed: Any, full: Any) -> None:
    """Write each rank's own shard of ``full`` (leaves holding this rank's
    rows, whole in their other dims) into the DTensor leaves of ``placed``,
    leaf by leaf in place, matched by key."""
    if isinstance(placed, dict):
        for k in placed:
            _store_own(placed[k], full[k])
    elif isinstance(placed, tuple):
        for a, b in zip(placed, full):
            _store_own(a, b)
    else:
        own = placed.to_local()
        mesh = placed.device_mesh
        for d in range(1, placed.ndim):
            if any(p.is_shard(d) for p in placed.placements):
                n = own.shape[d]
                full = full.narrow(d, shard_index(mesh, placed.placements, d) * n, n)
        own.copy_(full)


def _mesh_decode(step: Callable, p, cfg: ModelConfig, h: DTensor, mc, rep: int) -> DTensor:
    """One xLSTM decode step (mLSTM or sLSTM) under a mesh, on each rank's
    own rows (the SSD's runs on its rows and heads:
    ``ssm._sharded_ssd_step``).

    The state's leaves (repeat ``rep`` of the stacked cache ``mc``) are
    DTensors, replicated (the serving launcher's cache) or placed by
    ``cache_sharding``, which splits these states over the batch only (its
    mLSTM rule takes a ``C`` of 4 dims; stacked over the repeats ``C`` has
    5, in both packages). The sLSTM's recurrent product and the mLSTM's
    gated norm mix all heads, so the step is not taken head by head: each
    rank keeps its rows, gathers any other split of a leaf (an all-gather
    over the mesh dims that split it), steps its rows on plain tensors
    with the parameters gathered, writes its own shard of every new leaf
    back into the leaf's storage in place, and returns the output split
    over the batch as the state is. With a replicated state the rows are
    the whole batch and nothing is gathered: each rank steps its full
    copy. The same result either way.

    On DTensor ops the step's projections come out as ``Partial`` sums
    over 'model', and DTensor casts a ``Partial`` leaf by leaf (torch 2.13's
    ``_to_copy`` strategy keeps it ``Partial``), so a bf16 leaf would take
    each rank's partial sum rounded to bf16: the step runs on plain
    tensors for that reason too."""
    mesh = h.device_mesh
    state = _take(mc, rep)
    leaves = _leaves(state)
    rows = [p if p.is_shard(0) else Replicate() for p in leaves[0].placements]
    if any([p if p.is_shard(0) else Replicate() for p in t.placements] != rows for t in leaves):
        raise NotImplementedError("the decode state's leaves split the batch differently")
    local = _map(lambda t: t.redistribute(mesh, rows).to_local(), state)
    y, new = step(_map(_replicated_local, p), cfg, h.redistribute(mesh, rows).to_local(), local)
    _store_own(state, new)
    return DTensor.from_local(y, mesh, rows, run_check=False)


# --------------------------------------------------------------------------
# Model assembly
# --------------------------------------------------------------------------

def build_model(cfg: ModelConfig, compute_dtype=torch.bfloat16) -> Model:
    kinds = layer_kinds(cfg)
    period = layer_period(cfg)
    repeats = cfg.n_layers // period
    pkinds = kinds[:period]
    eps = cfg.norm_eps

    # ---------------- init ----------------
    def init(seed: int, device=None, dtype=torch.float32) -> Params:
        """Random weights at the config's widths from a
        ``torch.Generator`` seeded with ``seed`` on the target device
        (the draws differ between devices and from ``jax.random``; to
        compare devices, init on one and move the tree). ``dtype`` casts
        each fp32 draw as it is made, the same values as an fp32 init
        cast once."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        params: dict[str, Any] = {
            "embed": init_embedding(gen, cfg.vocab_size, cfg.d_model, dtype),
            "norm": init_rms_norm(cfg.d_model, dev, dtype),
        }
        if not cfg.tie_embeddings:
            params["out"] = init_embedding(gen, cfg.vocab_size, cfg.d_model, dtype)
        stacks = []
        for mixer, ffn in pkinds:
            per_repeat = [
                {"mixer": _init_mixer(gen, cfg, mixer, dtype),
                 "ffn": _init_ffn(gen, cfg, ffn, dtype)}
                for _ in range(repeats)
            ]
            stacks.append(_stack(per_repeat))
            del per_repeat
        params["layers"] = tuple(stacks)
        if cfg.n_enc_layers:
            enc = [
                {"mixer": _init_mixer(gen, cfg, "attn", dtype),
                 "ffn": _init_ffn(gen, cfg, "mlp", dtype)}
                for _ in range(cfg.n_enc_layers)
            ]
            params["enc"] = {"layers": _stack(enc),
                             "norm": init_rms_norm(cfg.d_model, dev, dtype)}
        return params

    def _rope(S: int, device):
        cos, sin = rope_tables(torch.arange(S, device=device), cfg.head_dim, cfg.rope_theta)
        return cos[None], sin[None]

    # ---------------- encoder (enc-dec only) ----------------
    def encode(params: Params, memory_in: torch.Tensor) -> torch.Tensor:
        """Non-causal encoder over stub frame embeddings [B, S, d]."""
        x = memory_in.to(compute_dtype)
        cos, sin = _rope(x.shape[1], x.device)
        enc = params["enc"]

        def layer(x, lp):
            h = rms_norm(lp["mixer"]["norm"], x, eps)
            x = x + attention(
                lp["mixer"]["attn"], h, cos, sin, cfg.n_heads, cfg.n_kv_heads,
                cfg.head_dim, causal=False,
            )
            h2 = rms_norm(lp["ffn"]["norm"], x, eps)
            return shard(x + mlp_swiglu(lp["ffn"]["mlp"], h2), "act_hidden")

        for lp in _unstack(enc["layers"], cfg.n_enc_layers):
            x = _remat(layer, x, lp)
        return rms_norm(enc["norm"], x, eps)

    # ---------------- hidden trunk ----------------
    def hidden(
        params: Params,
        tokens: torch.Tensor,                # [B, S]
        memory: torch.Tensor | None = None,  # [B, T, d] frames / patches
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Final hidden states [B, S, d] and the accumulated aux loss."""
        x = embed(params["embed"], tokens, compute_dtype)
        x = shard(x, "act_hidden")
        cos, sin = _rope(x.shape[1], x.device)
        mem = None
        if cfg.n_enc_layers:
            if memory is None:
                raise ValueError(f"{cfg.name} is an encoder-decoder model: pass the frames")
            mem = encode(params, memory)
        elif memory is not None:
            mem = memory.to(compute_dtype)

        def period_fn(x, lps):
            # The activation-sharding mode (act_in / act_mid / act_out) is
            # set by distribution.sharding, as in the JAX package.
            x = shard(x, "act_in")
            period_aux = None  # the period's sum, then the total (lm.py:355, :367)
            for lp, (mixer, ffn) in zip(lps, pkinds):
                x = _apply_mixer(lp["mixer"], cfg, mixer, x, cos, sin, mem)
                x = shard(x, "act_mid")
                x, a = _apply_ffn(lp["ffn"], cfg, ffn, x)
                x = shard(x, "act_mid")
                if a is not None:
                    period_aux = a if period_aux is None else period_aux + a
            # The carry saved by remat across the repeats.
            return shard(x, "act_out"), period_aux

        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        stacks = [_unstack(stacked, repeats) for stacked in params["layers"]]
        for rep in range(repeats):
            x, period_aux = _remat(period_fn, x, [st[rep] for st in stacks])
            if period_aux is not None:
                aux = aux + period_aux
        return rms_norm(params["norm"], x, eps), aux

    def out_table(params: Params) -> Params:
        return params["embed"] if cfg.tie_embeddings else params["out"]

    # ---------------- forward (logits; small-model / test path) ----------
    def forward(params: Params, tokens: torch.Tensor, memory: torch.Tensor | None = None):
        x, aux = hidden(params, tokens, memory)
        return shard(unembed(out_table(params), x), "act_logits"), aux

    # ---------------- loss (vocab-safe chunked cross-entropy) -------------
    def loss(params: Params, batch: dict[str, torch.Tensor]) -> torch.Tensor:
        """Mean next-token cross-entropy over ``batch["labels"]`` (weighted
        by the optional ``batch["mask"]``) plus ``AUX_COEF`` times the MoE
        aux loss, as ``lm.py:390-426`` of the JAX package: the positions
        are taken in chunks of the largest of 512, 256, ... 1 that divides
        S, each chunk's float32 logits made (and, with gradients on,
        remade in the backward pass) on their own, so that no [B, S, V]
        logits tensor is ever held."""
        x, aux = hidden(params, batch["tokens"], memory=batch.get("memory"))
        labels = batch["labels"]
        mask = batch.get("mask")
        tbl = out_table(params)["table"]
        B, S, _ = x.shape
        chunk = next(c for c in (512, 256, 128, 64, 32, 16, 8, 4, 2, 1) if S % c == 0)

        def chunk_ce(xc, lc, mc):
            lg = (xc @ tbl.to(xc.dtype).T).to(torch.float32)
            lg = shard(lg, "act_logits")
            logz = torch.logsumexp(lg, dim=-1)
            gold = _gold_logit(lg, lc)
            return torch.sum((logz - gold) * mc), torch.sum(mc)

        tot = torch.zeros((), dtype=torch.float32, device=x.device)
        cnt = torch.zeros((), dtype=torch.float32, device=x.device)
        for c0 in range(0, S, chunk):
            sl = slice(c0, c0 + chunk)
            mc = (mask[:, sl].to(torch.float32) if mask is not None
                  else torch.ones((B, chunk), dtype=torch.float32, device=x.device))
            s_c, n_c = _remat(chunk_ce, x[:, sl], labels[:, sl], mc)
            tot, cnt = tot + s_c, cnt + n_c
        return tot / torch.clamp(cnt, min=1.0) + AUX_COEF * aux

    # ---------------- prefill (serving: last-position logits) -------------
    def prefill(params: Params, tokens: torch.Tensor, memory: torch.Tensor | None = None):
        x, _ = hidden(params, tokens, memory)
        return unembed(out_table(params), x[:, -1:, :])

    # ---------------- decode ----------------
    def init_cache(batch: int, max_len: int, device=None,
                   memory: torch.Tensor | None = None) -> dict[str, Any]:
        """Zero decode state per period position, stacked over the repeats
        (bf16 K/V caches [repeats, batch, max_len, KV, D], recurrent
        states), position 0, and ``memory``: the encoded frames or the
        patches that cross-attention reads."""
        dev = resolve_device(device)
        layers = tuple(
            _mixer_cache(cfg, mixer, batch, max_len, repeats, dev) for mixer, _ in pkinds
        )
        return {"pos": 0, "layers": layers, "memory": memory}

    def decode_step(
        params: Params, cache: dict[str, Any], token: torch.Tensor  # [B]
    ) -> tuple[torch.Tensor, dict[str, Any]]:
        """One token per row at position ``cache["pos"]``. K/V rows and
        recurrent states are written into the cache's tensors in place; the
        returned cache shares them and holds ``pos + 1``."""
        x = embed(params["embed"], token[:, None], compute_dtype)  # [B, 1, d]
        pos = int(cache["pos"])
        mem = cache.get("memory")
        if mem is not None:
            mem = mem.to(compute_dtype)
        for rep in range(repeats):
            for j, (mixer, ffn) in enumerate(pkinds):
                lp = _take(params["layers"][j], rep)
                x = _decode_mixer(lp["mixer"], cfg, mixer, x, pos, cache["layers"][j], rep, mem)
                x, _ = _apply_ffn(lp["ffn"], cfg, ffn, x)
        x = rms_norm(params["norm"], x, eps)
        logits = unembed(out_table(params), x)
        return logits, {"pos": pos + 1, "layers": cache["layers"],
                        "memory": cache.get("memory")}

    return Model(
        cfg=cfg,
        init=init,
        forward=forward,
        init_cache=init_cache,
        decode_step=decode_step,
        loss=loss,
        hidden=hidden,
        prefill=prefill,
        encode=encode if cfg.n_enc_layers else None,
    )


# --------------------------------------------------------------------------
# Parameter accounting
# --------------------------------------------------------------------------

def count_params(params: Params) -> int:
    if isinstance(params, dict):
        return sum(count_params(v) for v in params.values())
    if isinstance(params, (tuple, list)):
        return sum(count_params(v) for v in params)
    return params.numel()


def active_param_fraction(cfg: ModelConfig) -> float:
    """Fraction of FFN params active per token (MoE top-k / E); 1.0 dense."""
    if not cfg.n_experts:
        return 1.0
    kinds = layer_kinds(cfg)
    moe_layers = sum(1 for _, f in kinds if f == "moe")
    mlp_layers = sum(1 for _, f in kinds if f == "mlp")
    per_expert = 3 * cfg.d_model * cfg.d_ff
    moe_total = moe_layers * cfg.n_experts * per_expert
    moe_active = moe_layers * cfg.experts_per_token * per_expert
    rest = mlp_layers * per_expert  # dense MLP layers
    return (moe_active + rest) / max(moe_total + rest, 1)
