"""Architecture registry: ``--arch <id>`` resolution + reduced smoke
variants (port of ``repro.configs.registry``).  Every reference arch
resolves, and the port runs every one of them."""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict

from .base import ArchConfig

ARCH_IDS = (
    "mistral-nemo-12b",
    "granite-moe-1b-a400m",
    "qwen2-vl-72b",
    "gemma3-1b",
    "stablelm-12b",
    "granite-20b",
    "mixtral-8x7b",
    "rwkv6-7b",
    "whisper-tiny",
    "jamba-1.5-large-398b",
    # the paper's own architecture (RoBERTa-base encoder)
    "roberta-base",
)

_MODULES = {i: "repro_torch.configs." + i.replace("-", "_").replace(".", "_") for i in ARCH_IDS}


def get_config(arch_id: str) -> ArchConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    return importlib.import_module(_MODULES[arch_id]).CONFIG


def all_configs() -> Dict[str, ArchConfig]:
    return {a: get_config(a) for a in ARCH_IDS}


def reduce_config(cfg: ArchConfig, *, d_model: int = 128, vocab: int = 512) -> ArchConfig:
    """Smoke-test variant: ≤`period` layers (so every block type in the
    pattern is exercised), d_model ≤ 512, ≤4 experts, tiny vocab, f32."""
    period = len(cfg.pattern)
    num_layers = 2 if period == 1 else min(period, 8)
    heads = max(2, min(4, cfg.num_heads))
    kv = 1 if cfg.num_kv_heads == 1 else min(2, heads)
    head_dim = d_model // heads
    moe = cfg.moe
    pattern = cfg.pattern[:num_layers] if period > 1 else cfg.pattern
    if moe.num_experts:
        ne = min(4, moe.num_experts)
        kt = min(2, moe.experts_per_token)
        # no-drop capacity (= T) so decode exactly matches prefill in tests
        moe = dataclasses.replace(
            moe, num_experts=ne, experts_per_token=kt, capacity_factor=float(ne) / kt
        )
    ssm = dataclasses.replace(cfg.ssm, head_dim=min(32, cfg.ssm.head_dim), d_state=8, decay_lora=8,
                              dt_rank=8)
    rope = cfg.rope
    if rope.kind == "mrope":
        half = head_dim // 2
        t = half // 4
        rope = dataclasses.replace(rope, mrope_sections=(t, (half - t) // 2,
                                                         half - t - (half - t) // 2))
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        num_layers=num_layers,
        d_model=d_model,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=head_dim,
        d_ff=max(4 * d_model // 2, 64) if cfg.d_ff else 0,
        vocab_size=vocab,
        max_seq_len=256,
        pattern=pattern,
        moe=moe,
        ssm=ssm,
        rope=rope,
        encoder_layers=min(cfg.encoder_layers, 2),
        encoder_seq=min(cfg.encoder_seq, 16) if cfg.encoder_seq else 0,
        num_frontend_tokens=min(cfg.num_frontend_tokens, 4),
        param_dtype="float32",
        compute_dtype="float32",
        remat=False,
        fsdp=False,
        microbatches=0,
        optimizer="adamw",
    )
