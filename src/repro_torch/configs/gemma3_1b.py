"""Gemma 3 1B — 5:1 local:global attention interleave, 512-token sliding
window on local layers, dual RoPE theta (10k local / 1M global), 262k vocab.
[hf:google/gemma-3-1b-pt]  Same values as ``repro.configs.gemma3_1b``."""
from .base import ArchConfig, BlockCfg, RopeCfg

_LOCAL = BlockCfg(mixer="attn", window=512, ffn="glu", rope_theta=10_000.0)
_GLOBAL = BlockCfg(mixer="attn", window=None, ffn="glu", rope_theta=1_000_000.0)

CONFIG = ArchConfig(
    name="gemma3-1b",
    family="dense",
    source="hf:google/gemma-3-1b-pt",
    num_layers=26,
    d_model=1152,
    num_heads=4,
    num_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab_size=262144,
    max_seq_len=131072,
    pattern=(_LOCAL, _LOCAL, _LOCAL, _LOCAL, _LOCAL, _GLOBAL),
    rope=RopeCfg(theta=1_000_000.0),
    norm="rmsnorm",
    act="gelu",
    tie_embeddings=True,
    scale_embed=True,
    optimizer="adamw",
)
