"""RWKV6 "Finch" 7B — attention-free, data-dependent decay time-mix +
channel-mix FFN.  [arXiv:2404.05892]  Same values as
``repro.configs.rwkv6_7b``."""
from .base import ArchConfig, BlockCfg, RopeCfg, SSMCfg

CONFIG = ArchConfig(
    name="rwkv6-7b",
    family="ssm",
    source="arXiv:2404.05892",
    num_layers=32,
    d_model=4096,
    num_heads=0,
    num_kv_heads=0,
    head_dim=64,  # rwkv head size
    d_ff=14336,
    vocab_size=65536,
    max_seq_len=1048576,
    pattern=(BlockCfg(mixer="rwkv", ffn="rwkv_cm"),),
    ssm=SSMCfg(head_dim=64, decay_lora=64),
    rope=RopeCfg(kind="none"),
    norm="layernorm",
    act="relu",
    optimizer="adamw",
    fsdp=True,
)
