"""Mixtral-8x7B — 8-expert top-2 MoE with 4096-token sliding-window
attention (per the assignment spec).  [arXiv:2401.04088]  Same values as
``repro.configs.mixtral_8x7b``."""
from .base import ArchConfig, BlockCfg, MoECfg, RopeCfg

CONFIG = ArchConfig(
    name="mixtral-8x7b",
    family="moe",
    source="arXiv:2401.04088",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    max_seq_len=131072,
    pattern=(BlockCfg(mixer="attn", window=4096, ffn="moe"),),
    moe=MoECfg(num_experts=8, experts_per_token=2),
    rope=RopeCfg(theta=1_000_000.0),
    norm="rmsnorm",
    act="silu",
    optimizer="adamw",
    fsdp=True,
)
