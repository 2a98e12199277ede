# Copied from src/repro/configs/dbrx_132b.py; imports retargeted to repro_torch.
"""DBRX-132B — fine-grained MoE, 16 experts top-4 [hf:databricks/dbrx-base].

40 layers, d_model 6144, 48 heads GQA kv=8, expert d_ff 10752, vocab 100352,
MoE on every layer.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10752,
    vocab_size=100352,
    n_experts=16,
    experts_per_token=4,
    rope_theta=500000.0,
)
