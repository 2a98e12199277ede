# Copied from src/repro/configs/deepseek_67b.py; imports retargeted to repro_torch.
"""DeepSeek-67B — dense llama-architecture LM [arXiv:2401.02954; hf].

95 layers, d_model 8192, 64 heads with GQA kv=8, d_ff 22016, vocab 102400.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b",
    family="dense",
    n_layers=95,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab_size=102400,
    rope_theta=10000.0,
)
