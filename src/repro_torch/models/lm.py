"""Model builder for the dense family (counterpart of ``repro.models.lm``).

``build_model(cfg)`` returns a :class:`Model` with the serving functions:

  init(seed, device=None, dtype=fp32) -> params
  hidden(params, tokens)              -> (final hidden [B, S, d], aux)
  forward(params, tokens)             -> (logits [B, S, V], aux)
  prefill(params, tokens)             -> last-position logits [B, 1, V]
  init_cache(batch, max_len, device)  -> cache (decode state)
  decode_step(params, cache, token)   -> (logits [B, 1, V], cache)

The parameter tree is the JAX package's: nested dicts, with the layers of
each position of the layer-kind period stacked along a leading repeat
axis, so that weights carry across leaf by leaf
(:func:`repro_torch.interop.lm_params_from_arrays`). The JAX package's
layer scan is a Python loop over the repeats here, with the whole period
applied inside each repeat (the layer order of ``lm.py:463-476``).

This slice covers the ``attn`` mixer and the ``mlp`` FFN: llama3.2-3b,
qwen1.5-4b, phi3-mini and deepseek-67b. Other layer kinds, encoders and
the training loss belong to later slices (ROADMAP Queue 1 item 8) and
raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig, layer_kinds, layer_period
from repro_torch.models.layers import (
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
    unembed,
)

Params = Any

__all__ = ["Model", "build_model", "count_params"]

# Layer kinds of later slices -> the ROADMAP Queue 1 item 8 part that ports them.
_LATER = {
    "moe": "models/moe.py",
    "mamba": "models/ssm.py",
    "slstm": "models/ssm.py",
    "mlstm": "models/ssm.py",
    "cross": "cross-attention and the encoder",
    "attn_cross": "cross-attention and the encoder",
    "none": "models/ssm.py",  # xLSTM blocks carry no separate FFN
}


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable
    forward: Callable
    init_cache: Callable
    decode_step: Callable
    hidden: Callable
    prefill: Callable


def _take(tree: Any, i: int) -> Any:
    """Repeat ``i`` of a stacked parameter or cache tree (views, no copy)."""
    if isinstance(tree, dict):
        return {k: _take(v, i) for k, v in tree.items()}
    return tree[i]


def _stack(trees: list) -> Any:
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees, dim=0)


def build_model(cfg: ModelConfig, compute_dtype=torch.bfloat16) -> Model:
    kinds = layer_kinds(cfg)
    later = {_LATER[m] for m, _ in kinds if m != "attn"}
    later |= {_LATER[f] for _, f in kinds if f != "mlp"}
    if cfg.n_enc_layers:
        later.add(_LATER["cross"])
    if later:
        raise NotImplementedError(
            f"{cfg.name}: the port serves the dense family (attn + mlp) so "
            f"far; {', '.join(sorted(later))} belong to a later slice "
            "(ROADMAP Queue 1 item 8)"
        )
    period = layer_period(cfg)
    repeats = cfg.n_layers // period
    n_pos = period  # every position is (attn, mlp)
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
        for _ in range(n_pos):
            per_repeat = [
                {
                    "mixer": {
                        "norm": init_rms_norm(cfg.d_model, dev, dtype),
                        "attn": init_attention(
                            gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                            cfg.head_dim, qkv_bias=cfg.qkv_bias, dtype=dtype,
                        ),
                    },
                    "ffn": {
                        "norm": init_rms_norm(cfg.d_model, dev, dtype),
                        "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, dtype),
                    },
                }
                for _ in range(repeats)
            ]
            stacks.append(_stack(per_repeat))
            del per_repeat
        params["layers"] = tuple(stacks)
        return params

    def _ffn(lp: Params, x: torch.Tensor) -> torch.Tensor:
        return x + mlp_swiglu(lp["mlp"], rms_norm(lp["norm"], x, eps))

    # ---------------- hidden trunk ----------------
    def hidden(params: Params, tokens: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Final hidden states [B, S, d] and the aux loss (0 for dense)."""
        x = embed(params["embed"], tokens, compute_dtype)
        S = x.shape[1]
        cos, sin = rope_tables(
            torch.arange(S, device=x.device), cfg.head_dim, cfg.rope_theta
        )
        cos, sin = cos[None], sin[None]
        for rep in range(repeats):
            for j in range(n_pos):
                lp = _take(params["layers"][j], rep)
                h = rms_norm(lp["mixer"]["norm"], x, eps)
                x = x + attention(
                    lp["mixer"]["attn"], h, cos, sin, cfg.n_heads,
                    cfg.n_kv_heads, cfg.head_dim,
                )
                x = _ffn(lp["ffn"], x)
        x = rms_norm(params["norm"], x, eps)
        return x, torch.zeros((), dtype=torch.float32, device=x.device)

    def out_table(params: Params) -> Params:
        return params["embed"] if cfg.tie_embeddings else params["out"]

    # ---------------- forward (logits; small-model / test path) ----------
    def forward(params: Params, tokens: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        x, aux = hidden(params, tokens)
        return unembed(out_table(params), x), aux

    # ---------------- prefill (serving: last-position logits) -------------
    def prefill(params: Params, tokens: torch.Tensor) -> torch.Tensor:
        x, _ = hidden(params, tokens)
        return unembed(out_table(params), x[:, -1:, :])

    # ---------------- decode ----------------
    def init_cache(batch: int, max_len: int, device=None) -> dict[str, Any]:
        """Zero bf16 K/V caches [repeats, batch, max_len, KV, D] per period
        position (``lm.py:188``) and position 0."""
        dev = resolve_device(device)
        shape = (repeats, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
        layers = tuple(
            {
                "k": torch.zeros(shape, dtype=torch.bfloat16, device=dev),
                "v": torch.zeros(shape, dtype=torch.bfloat16, device=dev),
            }
            for _ in range(n_pos)
        )
        return {"pos": 0, "layers": layers, "memory": None}

    def decode_step(
        params: Params, cache: dict[str, Any], token: torch.Tensor  # [B]
    ) -> tuple[torch.Tensor, dict[str, Any]]:
        """One token per row at position ``cache["pos"]``. The K/V rows are
        written into the cache's tensors in place; the returned cache
        shares them and holds ``pos + 1``."""
        x = embed(params["embed"], token[:, None], compute_dtype)  # [B, 1, d]
        pos = int(cache["pos"])
        for rep in range(repeats):
            for j in range(n_pos):
                lp = _take(params["layers"][j], rep)
                mc = cache["layers"][j]
                h = rms_norm(lp["mixer"]["norm"], x, eps)
                out, _, _ = decode_attention(
                    lp["mixer"]["attn"], h, pos, mc["k"][rep], mc["v"][rep],
                    cfg.rope_theta, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                )
                x = _ffn(lp["ffn"], x + out)
        x = rms_norm(params["norm"], x, eps)
        logits = unembed(out_table(params), x)
        return logits, {"pos": pos + 1, "layers": cache["layers"], "memory": None}

    return Model(
        cfg=cfg,
        init=init,
        forward=forward,
        init_cache=init_cache,
        decode_step=decode_step,
        hidden=hidden,
        prefill=prefill,
    )


def count_params(params: Params) -> int:
    if isinstance(params, dict):
        return sum(count_params(v) for v in params.values())
    if isinstance(params, (tuple, list)):
        return sum(count_params(v) for v in params)
    return params.numel()
