"""RoBERTa-base — the paper's own architecture (§4.2) — and the tiny variant
the CPU tests train.  Same values as ``repro.configs.roberta_base``."""
import dataclasses

from .base import ArchConfig, BlockCfg, RopeCfg

CONFIG = ArchConfig(
    name="roberta-base",
    family="encoder",
    source="hf:roberta-base (Liu et al., 2019)",
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    d_ff=3072,
    vocab_size=50265,
    max_seq_len=512,
    pattern=(BlockCfg(mixer="attn", ffn="mlp"),),
    rope=RopeCfg(kind="none"),  # learned absolute positions
    norm="layernorm",
    act="gelu",
    tie_embeddings=True,
    optimizer="adamw",
)

TINY = dataclasses.replace(
    CONFIG,
    name="roberta-tiny",
    num_layers=2,
    d_model=128,
    num_heads=4,
    num_kv_heads=4,
    head_dim=32,
    d_ff=256,
    vocab_size=512,
    max_seq_len=64,
    param_dtype="float32",
    compute_dtype="float32",
    remat=False,
)
