# Copied from src/repro/configs/seamless_m4t_medium.py; imports retargeted to repro_torch.
"""SeamlessM4T-medium text backbone — encoder-decoder [arXiv:2308.11596; hf].

12 encoder + 12 decoder layers, d_model 1024, 16 heads kv=16, d_ff 4096,
vocab 256206. The audio frontend (speech encoder frame features) is a STUB:
input_specs() provides precomputed [B, S, d_model] frame embeddings.
Hardware adaptation (DESIGN.md): relative/conformer position handling is
replaced by RoPE on the TPU-native backbone.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    n_layers=12,          # decoder depth
    n_enc_layers=12,      # encoder depth
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,
    rope_theta=10000.0,
    tie_embeddings=True,
)
