"""Minimal batched serving engine (port of ``repro.serve.engine``): prefill
the prompt into a KV/state cache, then greedy-decode one token per step via
``serve_step``.  The cache lives on the parameters' device and is updated
in place; the host sees only the token ids.

Params placed by ``launch.sharding.device_put`` on a grid of several slots
serve partitioned (``train.step.make_serve_step``'s placed branch): the
engine places the prompt by ``batch_shardings`` and the cache by
``cache_shardings`` on the params' grid, and takes the argmax of the
logits gathered on slot 0's device.  ``data_axis`` and ``model_axis`` name
the grid as the params' ``params_shardings`` did (a batch axis may be a
tuple of names, such as the ``dp`` strategy's ``("data", "model")``, the
model axis None; by default both are read from the mesh,
``models.partitioned.make_grid``).  A batch that the grid's batch axes do
not divide (one request, B = 1) is served context-parallel: the prompt's
sequence and the cache's are split over the batch axes
(``models.partitioned``)."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import FROM_MESH
from repro_torch.models.partitioned import make_grid
from repro_torch.models.transformer import init_cache
from repro_torch.train.step import is_placed, make_serve_step
from repro_torch.utils.pytree import tree_device, tree_leaves


@dataclass
class GenerationResult:
    tokens: np.ndarray        # [B, prompt + generated]
    prompt_len: int
    steps: int


class Engine:
    """Greedy batched generation for the decoder-LM families."""

    def __init__(self, cfg: ArchConfig, params, *, max_len: int = 256, data_axis=FROM_MESH,
                 model_axis=FROM_MESH):
        if cfg.is_encoder_decoder:
            raise ValueError("Engine drives decoder-only archs; use whisper_decode directly")
        self.cfg = cfg
        self.params = params
        self.max_len = max_len
        self.axes = dict(data_axis=data_axis, model_axis=model_axis)
        self._serve = make_serve_step(cfg, **self.axes)

    def _prefill(self, params, tokens, cache):
        return self._serve(params, cache, tokens, 0)

    def _start(self, params, prompts: np.ndarray):
        """(prompt tokens, a zeroed cache), where ``params`` live: on their
        device, or placed on their grid."""
        B = prompts.shape[0]
        if not is_placed(params):
            dev = tree_device(params)
            return (torch.as_tensor(prompts, dtype=torch.long, device=dev),
                    init_cache(self.cfg, B, self.max_len, device=dev))
        mesh = tree_leaves(params)[0].layout.mesh
        grid = make_grid(mesh, **self.axes)
        dp, mp = grid.dp, grid.model
        cache = init_cache(self.cfg, B, self.max_len, device=mesh.devices.flat[0])
        cache = SH.device_put(cache, SH.cache_shardings(mesh, cache, self.cfg, data_axis=dp,
                                                        model_axis=mp))
        tokens = {"tokens": torch.as_tensor(prompts, dtype=torch.long)}
        return SH.device_put(tokens, SH.batch_shardings(mesh, tokens, data_axis=dp,
                                                        model_axis=mp))["tokens"], cache

    @torch.inference_mode()
    def generate(self, prompts: np.ndarray, *, max_new_tokens: int = 16,
                 params=None) -> GenerationResult:
        """prompts: [B, P] int (fixed-length, packed by the caller).

        ``params=`` serves this one request against a different (same-
        shaped) parameter tree, placed or not; the engine's default tree
        stays."""
        params = self.params if params is None else params
        prompts = np.asarray(prompts)
        B, P = prompts.shape
        if P + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt_len={P} + max_new_tokens={max_new_tokens} exceeds "
                f"max_len={self.max_len}; re-build the Engine with a larger "
                "max_len or shorten the request")
        tokens, cache = self._start(params, prompts)
        logits, cache = self._prefill(params, tokens, cache)
        out = [torch.argmax(logits, dim=-1)]
        for t in range(1, max_new_tokens):
            logits, cache = self._serve(params, cache, out[-1][:, None], P + t - 1)
            out.append(torch.argmax(logits, dim=-1))
        gen = torch.stack(out, dim=1).cpu().numpy().astype(prompts.dtype)
        return GenerationResult(tokens=np.concatenate([prompts, gen], axis=1), prompt_len=P,
                                steps=max_new_tokens)
