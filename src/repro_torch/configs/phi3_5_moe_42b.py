# Copied from src/repro/configs/phi3_5_moe_42b.py; imports retargeted to repro_torch.
"""Phi-3.5-MoE-42B (6.6B active) — 16 experts top-2
[hf:microsoft/Phi-3.5-MoE-instruct; hf].

32 layers, d_model 4096, 32 heads GQA kv=8, expert d_ff 6400, vocab 32064,
MoE on every layer.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6400,
    vocab_size=32064,
    n_experts=16,
    experts_per_token=2,
    rope_theta=10000.0,
)
