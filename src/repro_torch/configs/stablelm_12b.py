"""StableLM-2 12B — dense decoder, LayerNorm, GQA kv=8.
[hf:stabilityai/stablelm-2-1_6b (12B variant of the family)]  Same values as
``repro.configs.stablelm_12b``."""
from .base import ArchConfig, BlockCfg, RopeCfg

CONFIG = ArchConfig(
    name="stablelm-12b",
    family="dense",
    source="hf:stabilityai/stablelm-2-12b",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    d_ff=13824,
    vocab_size=100352,
    max_seq_len=4096,
    pattern=(BlockCfg(mixer="attn", ffn="glu"),),
    rope=RopeCfg(theta=10_000.0),
    norm="layernorm",
    act="silu",
    optimizer="adamw",
    fsdp=True,
)
