"""Architecture configuration for the PyTorch port.

A copy of ``repro.configs.base`` cut down to what the port's models read:
the RoBERTa-style encoder and the decoder LM of the serving path (attention
and RWKV6 mixers; GLU, MLP and RWKV channel-mix FFNs).  The port imports
nothing from the JAX package.  Field names and defaults are the
reference's, so a config means the same thing in both.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class BlockCfg:
    """One block of the layer pattern (mixer + FFN)."""

    mixer: str = "attn"  # "attn" | "rwkv" ("mamba" is not ported)
    # Sliding-window size for local attention; None => full (causal) attention.
    window: Optional[int] = None
    ffn: str = "glu"  # "glu" | "mlp" | "rwkv_cm" ("moe" is not ported)
    # Per-layer RoPE theta override (gemma3: 10k local / 1M global); None =>
    # ArchConfig.rope.theta.
    rope_theta: Optional[float] = None


@dataclass(frozen=True)
class SSMCfg:
    """RWKV6 hyper-parameters (the reference's Mamba fields are not ported)."""

    head_dim: int = 64
    decay_lora: int = 64  # low-rank size of the data-dependent decay MLP


@dataclass(frozen=True)
class RopeCfg:
    theta: float = 10_000.0
    kind: str = "default"  # "default" | "none" (learned absolute positions)
    # Linear position scaling factor.
    scaling: float = 1.0


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

    # Per-layer pattern, applied cyclically: layer i uses
    # pattern[i % len(pattern)].
    pattern: Tuple[BlockCfg, ...] = (BlockCfg(),)
    ssm: SSMCfg = field(default_factory=SSMCfg)
    rope: RopeCfg = field(default_factory=RopeCfg)

    norm: str = "rmsnorm"  # "rmsnorm" | "layernorm"
    norm_eps: float = 1e-5
    act: str = "silu"  # "silu" | "gelu" | "relu"
    tie_embeddings: bool = False
    logit_softcap: float = 0.0
    # Scale token embeddings by sqrt(d_model) (gemma family).
    scale_embed: bool = False
    is_encoder_decoder: bool = False

    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    optimizer: str = "adamw"  # adamw | adafactor | sgd
    # Rematerialise each period in the reference's training scan; the
    # port's train step keeps every activation and carries the field unread.
    remat: bool = True

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def blocks(self) -> Tuple[BlockCfg, ...]:
        """Full per-layer block list (pattern applied cyclically)."""
        p = self.pattern
        return tuple(p[i % len(p)] for i in range(self.num_layers))

    @property
    def period(self) -> int:
        return len(self.pattern)

    def param_count(self) -> int:
        """Analytic total parameter count (embeddings included), the
        reference's formula for the mixers and FFNs the port runs."""
        if self.is_encoder_decoder:
            raise NotImplementedError("encoder-decoder archs (whisper) are not ported yet "
                                      "(ROADMAP.md lists what is left)")
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.head_dim
        n_q = self.num_heads * hd
        n_kv = self.num_kv_heads * hd
        total = v * d  # embed
        if not self.tie_embeddings:
            total += v * d
        for b in self.blocks:
            if b.mixer == "attn":
                total += d * n_q + 2 * d * n_kv + n_q * d
            elif b.mixer == "rwkv":
                # r,k,v,g,o projections + low-rank decay/mix
                total += 5 * d * d + 2 * self.ssm.decay_lora * d * 6
            else:
                raise NotImplementedError(f"mixer {b.mixer!r} is not ported yet")
            if b.ffn == "glu":
                total += 3 * d * f
            elif b.ffn == "mlp":
                total += 2 * d * f
            elif b.ffn == "rwkv_cm":
                total += 2 * d * f + d * d
            else:
                raise NotImplementedError(f"ffn {b.ffn!r} is not ported yet")
            total += 2 * d  # two norms
        return total + d  # final norm

    def active_param_count(self) -> int:
        """Parameters touched per token.  Only MoE archs touch fewer than
        all of them, and the port has none yet, so this is
        ``param_count()``."""
        return self.param_count()
