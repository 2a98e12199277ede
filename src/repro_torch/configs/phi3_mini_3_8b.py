# Copied from src/repro/configs/phi3_mini_3_8b.py; imports retargeted to repro_torch.
"""Phi-3-mini-3.8B — dense LM, RoPE + SwiGLU + GQA(32/32) [arXiv:2404.14219].

32 layers, d_model 3072, 32 heads kv=32, d_ff 8192, vocab 32064.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32064,
    rope_theta=10000.0,
)
