"""Mistral-Nemo-Base-2407 — 12B dense decoder, 128k context.
[hf:mistralai/Mistral-Nemo-Base-2407]  Same values as
``repro.configs.mistral_nemo_12b``."""
from .base import ArchConfig, BlockCfg, RopeCfg

CONFIG = ArchConfig(
    name="mistral-nemo-12b",
    family="dense",
    source="hf:mistralai/Mistral-Nemo-Base-2407",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,  # explicit in the model card (not d_model/heads)
    d_ff=14336,
    vocab_size=131072,
    max_seq_len=131072,
    pattern=(BlockCfg(mixer="attn", window=None, ffn="glu"),),
    rope=RopeCfg(theta=1_000_000.0),
    norm="rmsnorm",
    act="silu",
    optimizer="adamw",
    fsdp=True,
)
