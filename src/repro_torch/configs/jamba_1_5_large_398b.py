"""Jamba-1.5-Large — 398B hybrid: 1:7 attention:Mamba interleave, MoE (16
experts top-2) on every other layer.  [arXiv:2403.19887]  Same values as
``repro.configs.jamba_1_5_large_398b``."""
from .base import ArchConfig, BlockCfg, MoECfg, RopeCfg, SSMCfg

# Period of 8: attention at position 4 (Jamba places attn mid-period),
# Mamba elsewhere; MoE every other layer.
_PATTERN = tuple(
    BlockCfg(
        mixer="attn" if i == 4 else "mamba",
        ffn="moe" if i % 2 == 1 else "glu",
    )
    for i in range(8)
)

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    source="arXiv:2403.19887",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    max_seq_len=262144,
    pattern=_PATTERN,
    moe=MoECfg(num_experts=16, experts_per_token=2),
    ssm=SSMCfg(d_state=16, d_conv=4, expand=2),
    rope=RopeCfg(kind="none"),  # Jamba uses no positional encoding
    norm="rmsnorm",
    act="silu",
    optimizer="adafactor",
    fsdp=True,
)
