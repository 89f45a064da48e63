"""Qwen2-VL-72B language backbone — M-RoPE, dynamic-resolution vision.
[arXiv:2409.12191]  Vision encoder (ViT) is the stub frontend: input_specs
supplies patch embeddings; M-RoPE position ids carry the (t, h, w) streams.  Same values as
``repro.configs.qwen2_vl_72b``."""
from .base import ArchConfig, BlockCfg, RopeCfg

CONFIG = ArchConfig(
    name="qwen2-vl-72b",
    family="vlm",
    source="arXiv:2409.12191",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=29568,
    vocab_size=152064,
    max_seq_len=32768,
    pattern=(BlockCfg(mixer="attn", ffn="glu"),),
    rope=RopeCfg(theta=1_000_000.0, kind="mrope", mrope_sections=(16, 24, 24)),
    norm="rmsnorm",
    act="silu",
    num_frontend_tokens=256,  # stub ViT patch embeddings
    optimizer="adafactor",
    fsdp=True,
)
