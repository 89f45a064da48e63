"""IBM Granite 20B (code) — llama-arch dense decoder with MQA (kv=1).
[arXiv:2405.04324]  Same values as
``repro.configs.granite_20b``."""
from .base import ArchConfig, BlockCfg, RopeCfg

CONFIG = ArchConfig(
    name="granite-20b",
    family="dense",
    source="arXiv:2405.04324",
    num_layers=52,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,
    d_ff=24576,
    vocab_size=49152,
    max_seq_len=8192,
    pattern=(BlockCfg(mixer="attn", ffn="mlp"),),
    rope=RopeCfg(theta=10_000.0),
    norm="layernorm",
    act="gelu",
    optimizer="adamw",
    fsdp=True,
)
