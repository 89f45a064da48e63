"""Deterministic batching: shuffled epochs of fixed-size numpy batches (a
copy of ``repro.data.pipeline.batches`` and ``num_steps``; batches stay on
the host and the model moves them to its device).  The reference's
``shard_batch`` places a batch on a device mesh and waits for the
model-side mesh (ROADMAP.md A6)."""
from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np


def batches(
    x: np.ndarray,
    y: Optional[np.ndarray],
    batch_size: int,
    *,
    rng: Optional[np.random.Generator] = None,
    epochs: int = 1,
    drop_remainder: bool = True,
) -> Iterator[Dict[str, np.ndarray]]:
    n = len(x)
    for _ in range(epochs):
        idx = np.arange(n)
        if rng is not None:
            rng.shuffle(idx)
        stop = (n // batch_size) * batch_size if drop_remainder else n
        for i in range(0, stop, batch_size):
            sel = idx[i : i + batch_size]
            out = {"tokens": x[sel]}
            if y is not None:
                out["labels"] = y[sel]
            yield out


def num_steps(n: int, batch_size: int, epochs: int) -> int:
    """Optimizer steps in ``epochs`` passes over ``n`` examples, the last
    partial batch of each dropped."""
    return (n // batch_size) * epochs
