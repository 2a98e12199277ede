# Copied from src/repro/configs/llama3_2_3b.py; imports retargeted to repro_torch.
"""Llama-3.2-3B — small llama3 [hf:meta-llama/Llama-3.2 family; unverified].

28 layers, d_model 3072, 24 heads GQA kv=8, d_ff 8192, vocab 128256.
Llama-3.2 ties input/output embeddings.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-3b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=128256,
    rope_theta=500000.0,
    tie_embeddings=True,
)
