"""Architecture configuration for the PyTorch port.

A copy of ``repro.configs.base`` cut down to what the RoBERTa-style encoder
reads (the port imports nothing from the JAX package).  Field names and
defaults are the reference's, so a config means the same thing in both.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple


@dataclass(frozen=True)
class BlockCfg:
    """One block of the layer pattern (mixer + FFN)."""

    mixer: str = "attn"
    ffn: str = "glu"


@dataclass(frozen=True)
class RopeCfg:
    theta: float = 10_000.0
    kind: str = "default"  # "default" | "none" (learned absolute positions)


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str
    source: str

    num_layers: int = 0
    d_model: int = 0
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0  # 0 => d_model // num_heads
    d_ff: int = 0
    vocab_size: int = 0
    max_seq_len: int = 131_072

    pattern: Tuple[BlockCfg, ...] = (BlockCfg(),)
    rope: RopeCfg = field(default_factory=RopeCfg)

    norm: str = "rmsnorm"  # "rmsnorm" | "layernorm"
    norm_eps: float = 1e-5
    act: str = "silu"  # "silu" | "gelu"
    tie_embeddings: bool = False

    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
