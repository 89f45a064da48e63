"""Architecture registry: ``--arch <id>`` resolution + reduced smoke
variants, limited to the archs the port runs (port of
``repro.configs.registry``)."""
from __future__ import annotations

import dataclasses
import importlib

from .base import ArchConfig

ARCH_IDS = (
    "gemma3-1b",
    "rwkv6-7b",
    # the paper's own architecture (RoBERTa-base encoder)
    "roberta-base",
)

_MODULES = {i: "repro_torch.configs." + i.replace("-", "_").replace(".", "_") for i in ARCH_IDS}


def get_config(arch_id: str) -> ArchConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"arch {arch_id!r} is not ported (the port runs {ARCH_IDS}); "
                       "ROADMAP.md lists the archs still to port")
    return importlib.import_module(_MODULES[arch_id]).CONFIG


def reduce_config(cfg: ArchConfig, *, d_model: int = 128, vocab: int = 512) -> ArchConfig:
    """Smoke-test variant: ≤`period` layers (so every block type in the
    pattern is exercised), d_model ≤ 512, tiny vocab, f32.  The
    reference's rules, minus those for the archs the port does not run
    (experts, M-RoPE sections, encoder-decoder lengths)."""
    period = len(cfg.pattern)
    num_layers = 2 if period == 1 else min(period, 8)
    heads = max(2, min(4, cfg.num_heads))
    kv = 1 if cfg.num_kv_heads == 1 else min(2, heads)
    head_dim = d_model // heads
    pattern = cfg.pattern[:num_layers] if period > 1 else cfg.pattern
    ssm = dataclasses.replace(cfg.ssm, head_dim=min(32, cfg.ssm.head_dim), decay_lora=8)
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
        ssm=ssm,
        param_dtype="float32",
        compute_dtype="float32",
        remat=False,
        optimizer="adamw",
    )
