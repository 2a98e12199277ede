# Copied from src/repro/configs/__init__.py; imports retargeted to repro_torch,
# PORT_ARCH_IDS added.
"""Assigned-architecture registry: one module per architecture.

Every module defines CONFIG (the full, paper-exact configuration) and the
registry provides reduced smoke variants that preserve the layer-kind
structure (same family, same period pattern) at toy dimensions.
"""

from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.config import ModelConfig

ARCH_IDS = [
    "deepseek_67b",
    "qwen1_5_4b",
    "llama3_2_3b",
    "phi3_mini_3_8b",
    "xlstm_350m",
    "seamless_m4t_medium",
    "jamba_v0_1_52b",
    "llama3_2_vision_11b",
    "dbrx_132b",
    "phi3_5_moe_42b",
]

# Configurations of the port's own, with no JAX counterpart (ARCH_IDS
# lists the JAX package's).
PORT_ARCH_IDS = ["ai21_jamba2_mini"]

# Aliases matching the assignment spelling.
ALIASES = {
    "deepseek-67b": "deepseek_67b",
    "qwen1.5-4b": "qwen1_5_4b",
    "llama3.2-3b": "llama3_2_3b",
    "phi3-mini-3.8b": "phi3_mini_3_8b",
    "xlstm-350m": "xlstm_350m",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "llama-3.2-vision-11b": "llama3_2_vision_11b",
    "dbrx-132b": "dbrx_132b",
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe_42b",
}


def get_config(name: str) -> ModelConfig:
    name = ALIASES.get(name, name).replace("-", "_").replace(".", "_")
    if name not in ARCH_IDS + PORT_ARCH_IDS:
        raise KeyError(f"unknown architecture {name!r}; known: {ARCH_IDS + PORT_ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    return mod.CONFIG


def smoke_config(name: str) -> ModelConfig:
    """Reduced config preserving the family structure at toy scale."""
    cfg = get_config(name)
    period = max(1, _period(cfg))
    ratio = max(1, cfg.n_heads // max(cfg.n_kv_heads, 1))
    n_heads = 4
    n_kv = max(1, n_heads // min(ratio, n_heads))
    return dataclasses.replace(
        cfg,
        n_layers=2 * period,
        d_model=64,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=256,
        n_experts=4 if cfg.n_experts else 0,
        experts_per_token=min(cfg.experts_per_token, 2) if cfg.n_experts else 0,
        # Generous capacity so smoke tests exercise the no-drop regime
        # (capacity drops make decode/forward legitimately diverge; capacity
        # behaviour has its own dedicated test).
        capacity_factor=8.0,
        n_enc_layers=2 if cfg.n_enc_layers else 0,
        n_patches=16 if cfg.cross_attn_every else cfg.n_patches,
        ssm_heads=4,
        ssm_state_dim=16,
        ssm_chunk=16,
        ssm_dt_rank=0,
        max_seq_len=128,
    )


def _period(cfg: ModelConfig) -> int:
    from repro_torch.models.config import layer_period

    return layer_period(cfg)
