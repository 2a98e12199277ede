# Copied from src/repro/configs/xlstm_350m.py; imports retargeted to repro_torch.
"""xLSTM-350M — sLSTM + mLSTM blocks [arXiv:2405.04517; unverified].

24 layers, d_model 1024, 4 heads, vocab 50304, no separate FFN (the xLSTM
blocks integrate up/down projections). Alternating sLSTM / mLSTM stacking.
Recurrent O(1) state => long_500k decode RUNS for this arch.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    xlstm_slstm_every=2,
    tie_embeddings=True,
    max_seq_len=524288,
)
