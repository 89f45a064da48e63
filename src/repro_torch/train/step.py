"""Prefill and serve steps for the decoder LM (the inference part of
``repro.train.step``; its train and eval steps are not ported yet)."""
from __future__ import annotations

from typing import Callable

from repro_torch.configs.base import ArchConfig
from repro_torch.models.transformer import forward_lm


def _decoder_only(cfg: ArchConfig) -> None:
    if cfg.is_encoder_decoder:
        raise NotImplementedError("encoder-decoder archs (whisper) are not ported yet "
                                  "(ROADMAP.md lists what is left)")


def make_prefill_step(cfg: ArchConfig) -> Callable:
    """Forward pass of the full prompt, no cache: ``(params, batch) ->
    last-position logits [B, V]`` (the next-token distribution)."""
    _decoder_only(cfg)

    def prefill_step(params, batch):
        logits, _, _ = forward_lm(cfg, params, batch["tokens"], positions=batch.get("positions"),
                                  extra_embeds=batch.get("extra_embeds"))
        return logits[:, -1]

    return prefill_step


def make_serve_step(cfg: ArchConfig) -> Callable:
    """One decode step against a KV/state cache: ``(params, cache, tokens
    [B, 1], cache_index) -> (logits [B, V], cache)``; the cache is updated
    in place and returned."""
    _decoder_only(cfg)

    def serve_step(params, cache, tokens, cache_index):
        logits, _, cache = forward_lm(cfg, params, tokens, cache=cache, cache_index=cache_index)
        return logits[:, -1], cache

    return serve_step
