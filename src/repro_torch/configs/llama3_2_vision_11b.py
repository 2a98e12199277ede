# Copied from src/repro/configs/llama3_2_vision_11b.py; imports retargeted to repro_torch.
"""Llama-3.2-Vision-11B text backbone — cross-attention VLM
[hf:meta-llama/Llama-3.2-11B-Vision; unverified].

40 layers, d_model 4096, 32 heads GQA kv=8, d_ff 14336, vocab 128256.
Cross-attention to vision patch embeddings every 5th layer (offset 3).
The vision tower is a STUB: input_specs() provides [B, n_patches, d_model]
precomputed patch embeddings.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    rope_theta=500000.0,
    cross_attn_every=5,
    cross_attn_offset=3,
    n_patches=1600,
)
