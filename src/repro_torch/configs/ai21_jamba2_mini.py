"""AI21-Jamba2-Mini — the Jamba block of Jamba 1.5 / 1.6 / 1.7 Mini (52B
total, 12B active) [hf:ai21labs/AI21-Jamba2-Mini, config.json].

32 layers, d_model 4096, in blocks of 8: attention where i % 8 == 4 (32
query and 8 KV heads of 128, no positional encoding), Mamba-1 on the other
7 (d_state 16, dt rank 256, expand 2 so d_inner 8192, a 4-tap conv with
bias, no projection bias, RMSNorms on dt, B and C); the FFN a MoE of 16
experts of 14336, top-2 with the softmax values kept (not renormalised),
on odd layers and a SwiGLU MLP of 14336 on even ones. vocab 65536, RMSNorm
eps 1e-6, embeddings not tied. A configuration of the port's own: the JAX
package has no Mamba-1 (its ``jamba_v0_1_52b`` runs a Mamba-2-style SSD).
The benchmark runs 16 of the 32 layers (``bench/configs/jamba2-mini-l16.json``).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="ai21-jamba2-mini",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    norm_eps=1e-6,
    rope=False,
    n_experts=16,
    experts_per_token=2,
    moe_every=2,
    moe_offset=1,
    router_normalize=False,
    attn_every=8,
    attn_offset=4,
    ssm_kind="mamba1",
    ssm_dt_rank=256,
    ssm_expand=2,
    ssm_state_dim=16,
    ssm_conv_dim=4,
    max_seq_len=262144,
)
