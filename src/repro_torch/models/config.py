# Copied from src/repro/models/config.py and extended: ``ssm_kind``,
# ``ssm_dt_rank`` and ``rope``, the port's own (their defaults give the
# reference's configurations unchanged).
"""Unified model configuration covering all assigned architecture families.

A model is a stack of (mixer, ffn) layer kinds:
  mixer ∈ {attn, attn_cross, cross, mamba, mamba1, slstm, mlstm}
  ffn   ∈ {mlp, moe, none}
plus an optional non-causal encoder stack (audio/enc-dec) and stubbed
modality frontends (audio frames / vision patches arrive as precomputed
embeddings via input_specs — see launch.dryrun).

The layer-kind sequence is derived from the family fields below and then
grouped into its smallest repeating period so the runtime can scan over
stacked parameter periods (keeps HLO size independent of depth).
"""

from __future__ import annotations

import dataclasses

__all__ = ["ModelConfig", "layer_kinds", "layer_period"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 500000.0
    rope: bool = True  # False: no positional encoding in self-attention (Jamba)
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    moe_every: int = 1  # apply MoE FFN on layers where (i % moe_every == moe_offset)
    moe_offset: int = 0
    capacity_factor: float = 1.25
    router_normalize: bool = True

    # Hybrid (jamba): attention on layers where (i % attn_every == attn_offset),
    # mamba elsewhere. attn_every == 0 -> all layers attention.
    attn_every: int = 0
    attn_offset: int = 0

    # SSM: "ssd" (Mamba-2 style, one decay a head) or "mamba1" (Mamba-1's
    # selective scan, a decay a (channel, state), with Jamba's dt/B/C norms).
    ssm_kind: str = "ssd"
    ssm_dt_rank: int = 0  # mamba1's dt projection rank; 0 -> ceil(d_model / 16)
    ssm_expand: int = 2
    ssm_state_dim: int = 64
    ssm_conv_dim: int = 4
    ssm_heads: int = 8  # SSD heads (scalar-decay-per-head)
    ssm_chunk: int = 256

    # xLSTM: alternate sLSTM / mLSTM with this period (0 = not xlstm)
    xlstm_slstm_every: int = 0

    # Encoder-decoder (audio): non-causal encoder depth; 0 = decoder-only.
    n_enc_layers: int = 0

    # VLM: cross-attention layers every k-th layer (0 = none)
    cross_attn_every: int = 0
    cross_attn_offset: int = 0
    n_patches: int = 1600  # stub vision frontend sequence length

    # serving
    max_seq_len: int = 32768

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        assert self.n_heads % max(self.n_kv_heads, 1) == 0
        if self.ssm_kind not in ("ssd", "mamba1"):
            raise ValueError(f"ssm_kind must be 'ssd' or 'mamba1', got {self.ssm_kind!r}")

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def dt_rank(self) -> int:
        """Mamba-1's dt projection rank (``ssm_dt_rank``, or Mamba's
        default ``ceil(d_model / 16)`` when it is 0)."""
        return self.ssm_dt_rank or -(-self.d_model // 16)

    @property
    def ssm_head_dim(self) -> int:
        return self.d_inner // self.ssm_heads


def layer_kinds(cfg: ModelConfig) -> list[tuple[str, str]]:
    """Per-layer (mixer, ffn) kinds for the DECODER stack."""
    kinds: list[tuple[str, str]] = []
    for i in range(cfg.n_layers):
        # Mixer selection.
        if cfg.xlstm_slstm_every:
            mixer = "slstm" if i % cfg.xlstm_slstm_every == 0 else "mlstm"
        elif cfg.attn_every:
            # getattr: the JAX package's config (no ssm_kind) is read here too.
            ssm = "mamba1" if getattr(cfg, "ssm_kind", "ssd") == "mamba1" else "mamba"
            mixer = "attn" if i % cfg.attn_every == cfg.attn_offset else ssm
        elif cfg.cross_attn_every and i % cfg.cross_attn_every == cfg.cross_attn_offset:
            mixer = "cross"  # cross-attention-only block (Mllama style)
        elif cfg.n_enc_layers:
            mixer = "attn_cross"  # every decoder layer self- AND cross-attends
        else:
            mixer = "attn"
        # FFN selection.
        if cfg.xlstm_slstm_every:
            ffn = "none"  # xLSTM blocks integrate their projections
        elif cfg.n_experts and i % cfg.moe_every == cfg.moe_offset:
            ffn = "moe"
        else:
            ffn = "mlp"
        kinds.append((mixer, ffn))
    return kinds


def layer_period(cfg: ModelConfig) -> int:
    """Smallest period p with kinds[i] == kinds[i % p] and p | n_layers."""
    kinds = layer_kinds(cfg)
    n = len(kinds)
    for p in range(1, n + 1):
        if n % p:
            continue
        if all(kinds[i] == kinds[i % p] for i in range(n)):
            return p
    return n
