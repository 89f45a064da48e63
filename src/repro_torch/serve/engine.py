"""Minimal batched serving engine (port of ``repro.serve.engine``): prefill
the prompt into a KV/state cache, then greedy-decode one token per step via
``serve_step``.  The cache lives on the parameters' device and is updated
in place; the host sees only the token ids."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.transformer import forward_lm, init_cache
from repro_torch.train.step import make_serve_step
from repro_torch.utils.pytree import tree_device


@dataclass
class GenerationResult:
    tokens: np.ndarray        # [B, prompt + generated]
    prompt_len: int
    steps: int


class Engine:
    """Greedy batched generation for the decoder-LM families."""

    def __init__(self, cfg: ArchConfig, params, *, max_len: int = 256):
        if cfg.is_encoder_decoder:
            raise ValueError("Engine drives decoder-only archs; use whisper_decode directly")
        self.cfg = cfg
        self.params = params
        self.max_len = max_len
        self._serve = make_serve_step(cfg)

    def _prefill(self, params, tokens, cache):
        logits, _, cache = forward_lm(self.cfg, params, tokens, cache=cache, cache_index=0)
        return logits[:, -1], cache

    @torch.inference_mode()
    def generate(self, prompts: np.ndarray, *, max_new_tokens: int = 16,
                 params=None) -> GenerationResult:
        """prompts: [B, P] int (fixed-length, packed by the caller).

        ``params=`` serves this one request against a different (same-
        shaped) parameter tree; the engine's default tree stays."""
        params = self.params if params is None else params
        prompts = np.asarray(prompts)
        B, P = prompts.shape
        if P + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt_len={P} + max_new_tokens={max_new_tokens} exceeds "
                f"max_len={self.max_len}; re-build the Engine with a larger "
                "max_len or shorten the request")
        dev = tree_device(params)
        cache = init_cache(self.cfg, B, self.max_len, device=dev)
        tokens = torch.as_tensor(prompts, dtype=torch.long, device=dev)
        logits, cache = self._prefill(params, tokens, cache)
        out = [torch.argmax(logits, dim=-1)]
        for t in range(1, max_new_tokens):
            logits, cache = self._serve(params, cache, out[-1][:, None], P + t - 1)
            out.append(torch.argmax(logits, dim=-1))
        gen = torch.stack(out, dim=1).cpu().numpy().astype(prompts.dtype)
        return GenerationResult(tokens=np.concatenate([prompts, gen], axis=1), prompt_len=P,
                                steps=max_new_tokens)
