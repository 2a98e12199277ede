# Copied from src/repro/configs/jamba_v0_1_52b.py; imports retargeted to repro_torch, a
# note on the published architecture added to the docstring.
"""Jamba-v0.1-52B — hybrid Mamba+attention 7:1 with MoE [arXiv:2403.19887; hf].

32 layers, d_model 4096, attention every 8th layer (offset 3 -> layers
3,11,19,27 are attention; kv=8 GQA), Mamba elsewhere; MoE (16 experts,
top-2) on every other layer, dense MLP d_ff 14336 otherwise. vocab 65536.
Hardware adaptation (DESIGN.md): Mamba-1 selective scan is realized as
Mamba-2-style SSD chunked scan (MXU-friendly matmul formulation).
Mamba state + 4 attention layers => long_500k decode RUNS.

A stand-in that mirrors the JAX package: the published architecture
(Mamba-1 with a decay per channel and state, dt / B / C norms, attention
at offset 4 without RoPE, top-2 gates not renormalised) is
``repro_torch.configs.ai21_jamba2_mini``.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    n_experts=16,
    experts_per_token=2,
    moe_every=2,
    moe_offset=1,
    attn_every=8,
    attn_offset=3,
    ssm_expand=2,
    ssm_state_dim=16,
    ssm_heads=64,
    ssm_chunk=256,
    rope_theta=10000.0,
    max_seq_len=524288,
)
