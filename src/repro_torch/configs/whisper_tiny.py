"""Whisper-tiny — encoder-decoder ASR backbone; mel+conv frontend is the
stub (input_specs supplies 1500 frame embeddings).  [arXiv:2212.04356]  Same values as
``repro.configs.whisper_tiny``."""
from .base import ArchConfig, BlockCfg, RopeCfg

CONFIG = ArchConfig(
    name="whisper-tiny",
    family="audio",
    source="arXiv:2212.04356",
    num_layers=4,        # decoder layers
    encoder_layers=4,
    encoder_seq=1500,    # 30s of audio after conv frontend
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    max_seq_len=32768,   # assignment decode shapes exceed the real 448 cap
    pattern=(BlockCfg(mixer="attn", ffn="mlp"),),
    rope=RopeCfg(kind="none"),  # learned absolute positions
    norm="layernorm",
    act="gelu",
    is_encoder_decoder=True,
    num_frontend_tokens=1500,
    tie_embeddings=True,
    optimizer="adamw",
)
