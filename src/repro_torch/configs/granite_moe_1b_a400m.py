"""IBM Granite 3.0 1B-A400M — fine-grained MoE, 32 experts top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base]  Same values as
``repro.configs.granite_moe_1b_a400m``."""
from .base import ArchConfig, BlockCfg, MoECfg, RopeCfg

CONFIG = ArchConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    d_ff=512,  # per-expert FFN width (fine-grained experts)
    vocab_size=49155,
    max_seq_len=32768,
    pattern=(BlockCfg(mixer="attn", ffn="moe"),),
    moe=MoECfg(num_experts=32, experts_per_token=8),
    rope=RopeCfg(theta=10_000.0),
    norm="rmsnorm",
    act="silu",
    tie_embeddings=True,
    optimizer="adamw",
)
