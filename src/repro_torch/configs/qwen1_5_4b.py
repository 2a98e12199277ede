# Copied from src/repro/configs/qwen1_5_4b.py; imports retargeted to repro_torch.
"""Qwen1.5-4B — dense LM with QKV bias [hf:Qwen/Qwen1.5 family; hf].

40 layers, d_model 2560, 20 heads (MHA expressed as GQA kv=20), d_ff 6912,
vocab 151936. Qwen attention projections carry bias terms.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b",
    family="dense",
    n_layers=40,
    d_model=2560,
    n_heads=20,
    n_kv_heads=20,
    d_ff=6912,
    vocab_size=151936,
    qkv_bias=True,
    rope_theta=1000000.0,
)
