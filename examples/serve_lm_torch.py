"""Batched serving demo on the PyTorch port (``src/repro_torch``): reduced
gemma3 (5:1 local:global attention) behind the KV-cache engine — prefill
once, then one-token decode steps; the twin of ``serve_lm.py``.

  PYTHONPATH=src python examples/serve_lm_torch.py [--device cpu]

``--device`` defaults to ``cuda``: the model runs on the card (through the
``flash_attention`` kernel) and the script raises without one unless
``--device cpu``.  Weights come from a seeded torch generator and prompts
from a seeded numpy generator, so they are not the reference's draws.
"""
import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch.configs import get_config, reduce_config  # noqa: E402
from repro_torch.models.transformer import init_lm  # noqa: E402
from repro_torch.serve.engine import Engine  # noqa: E402
from repro_torch.utils.device import resolve_device  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = reduce_config(get_config("gemma3-1b"))
    print(f"serving {cfg.name}: {cfg.num_layers} layers "
          f"({sum(1 for b in cfg.blocks if b.window)} local / "
          f"{sum(1 for b in cfg.blocks if not b.window)} global), d={cfg.d_model}")
    params = init_lm(cfg, torch.Generator(device=device).manual_seed(0), device=device)
    eng = Engine(cfg, params, max_len=64)

    prompts = np.random.default_rng(1).integers(3, cfg.vocab_size, (4, 12)).astype(np.int32)
    t0 = time.time()
    res = eng.generate(prompts, max_new_tokens=16)
    dt = time.time() - t0
    print(f"generated {res.tokens.shape[0]}x{res.steps} tokens in {dt:.2f}s "
          f"({res.tokens.shape[0]*res.steps/dt:.1f} tok/s on {device})")
    for i, row in enumerate(res.tokens):
        print(f"  req{i}: prompt={row[:res.prompt_len].tolist()} -> "
              f"gen={row[res.prompt_len:].tolist()}")


if __name__ == "__main__":
    main()
