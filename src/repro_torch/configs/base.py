"""Architecture configuration for the PyTorch port.

A copy of ``repro.configs.base``: every reference arch is described by an
:class:`ArchConfig`, and the decoder stack is driven by the per-layer
``BlockCfg`` pattern.  The port imports nothing from the JAX package.
Field names, defaults and the parameter-count formulas are the
reference's, so a config means the same thing in both.  The port's models
run every mixer (attention, Mamba, RWKV6), FFN (GLU, MLP, MoE, RWKV
channel-mix), RoPE kind and the encoder-decoder stack described here.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class BlockCfg:
    """One block of the layer pattern (mixer + FFN)."""

    mixer: str = "attn"  # "attn" | "mamba" | "rwkv"
    # Sliding-window size for local attention; None => full (causal) attention.
    window: Optional[int] = None
    # FFN flavour: "glu" (SwiGLU/GeGLU), "mlp" (plain 2-layer), "moe",
    # "rwkv_cm" (RWKV channel mix).
    ffn: str = "glu"
    # Per-layer RoPE theta override (gemma3: 10k local / 1M global); None =>
    # ArchConfig.rope.theta.
    rope_theta: Optional[float] = None


@dataclass(frozen=True)
class MoECfg:
    num_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    # Weight of the auxiliary load-balance loss (Switch/GShard style).
    aux_loss_weight: float = 0.01
    # Routing implementation: "gshard" (one-hot dispatch einsum, default) or
    # "dense" (all experts on all tokens; only for tiny smoke configs).
    routing: str = "gshard"


@dataclass(frozen=True)
class SSMCfg:
    """State-space / RWKV hyper-parameters."""

    # Mamba
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 => ceil(d_model / 16)
    # RWKV6
    head_dim: int = 64
    decay_lora: int = 64  # low-rank size of the data-dependent decay MLP


@dataclass(frozen=True)
class RopeCfg:
    theta: float = 10_000.0
    kind: str = "default"  # "default" | "mrope" | "none"
    # M-RoPE (Qwen2-VL): head_dim is split into (t, h, w) sections.
    mrope_sections: Tuple[int, ...] = ()
    # Linear position scaling factor.
    scaling: float = 1.0


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | vlm | ssm | audio | hybrid | encoder
    source: str  # citation / model card

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

    moe: MoECfg = field(default_factory=MoECfg)
    ssm: SSMCfg = field(default_factory=SSMCfg)
    rope: RopeCfg = field(default_factory=RopeCfg)

    norm: str = "rmsnorm"  # "rmsnorm" | "layernorm"
    norm_eps: float = 1e-5
    act: str = "silu"  # "silu" | "gelu" | "relu"
    tie_embeddings: bool = False
    logit_softcap: float = 0.0
    # Scale token embeddings by sqrt(d_model) (gemma family).
    scale_embed: bool = False

    # --- encoder / encoder-decoder extras -------------------------------
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    encoder_seq: int = 0  # fixed encoder context (whisper: 1500)
    # Number of stub modality-embedding tokens prepended for vlm/audio.
    num_frontend_tokens: int = 0

    # --- numerics / distribution policy ---------------------------------
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    optimizer: str = "adamw"  # adamw | adafactor | sgd
    # Rematerialise each period in the reference's training scan; the
    # port's train step keeps every activation and carries the field unread.
    remat: bool = True
    # Microbatches of the reference's train step (0 => from the shape
    # table) and its FSDP sharding: read by the reference's launchers and
    # mesh, carried unread by the port (one device; ROADMAP.md A6).
    microbatches: int = 0
    fsdp: bool = False

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.ssm.dt_rank == 0 and self.d_model:
            object.__setattr__(
                self, "ssm", dataclasses.replace(self.ssm, dt_rank=max(1, -(-self.d_model // 16)))
            )

    @property
    def blocks(self) -> Tuple[BlockCfg, ...]:
        """Full per-layer block list (pattern applied cyclically)."""
        p = self.pattern
        return tuple(p[i % len(p)] for i in range(self.num_layers))

    @property
    def period(self) -> int:
        return len(self.pattern)

    @property
    def is_subquadratic(self) -> bool:
        """True if every layer is windowed attention or an SSM mixer."""
        return all(b.mixer != "attn" or b.window is not None for b in self.pattern)

    @property
    def has_decoder(self) -> bool:
        return True  # every reference arch has a decode path (whisper is enc-dec)

    def param_count(self) -> int:
        """Analytic total parameter count (embeddings included): the
        reference's formula for every mixer, FFN and the encoder-decoder
        term."""
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
            elif b.mixer == "mamba":
                di = self.ssm.expand * d
                dtr = self.ssm.dt_rank
                total += d * 2 * di + di * self.ssm.d_conv
                total += di * (dtr + 2 * self.ssm.d_state) + dtr * di
                total += di * self.ssm.d_state + di  # A_log, D
                total += di * d
            elif b.mixer == "rwkv":
                # r,k,v,g,o projections + low-rank decay/mix
                total += 5 * d * d + 2 * self.ssm.decay_lora * d * 6
            if b.ffn == "glu":
                total += 3 * d * f
            elif b.ffn == "mlp":
                total += 2 * d * f
            elif b.ffn == "moe":
                total += self.moe.num_experts * 3 * d * f + d * self.moe.num_experts
            elif b.ffn == "rwkv_cm":
                total += 2 * d * f + d * d
            total += 2 * d  # two norms
        total += d  # final norm
        if self.is_encoder_decoder:
            # encoder blocks + decoder cross-attention, rough analytic count
            total += self.encoder_layers * (4 * d * d + 2 * d * f + 2 * d)
            total += self.num_layers * (4 * d * d + 2 * d)
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only top-k experts)."""
        if self.moe.num_experts == 0:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        dense_total = self.param_count()
        n_moe_layers = sum(1 for b in self.blocks if b.ffn == "moe")
        inactive = (self.moe.num_experts - self.moe.experts_per_token) * 3 * d * f
        return dense_total - n_moe_layers * inactive


@dataclass(frozen=True)
class InputShape:
    """One entry of the reference's input-shape table."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"
