"""Deterministic batching: shuffled epochs of fixed-size numpy batches (a
copy of ``repro.data.pipeline.batches`` and ``num_steps``; batches stay on
the host and the model moves them to its device), and ``shard_batch``,
which places a host batch on a device mesh."""
from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.launch.sharding import NamedSharding


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


def shard_batch(batch: Dict[str, np.ndarray], sharding: NamedSharding) -> Dict[str, object]:
    """Place a host batch on a mesh with one ``NamedSharding``
    (``launch.sharding.NamedSharding.place``): a leading dim over the
    contributor axes splits into the list of its slabs, one a contributor
    slot; the rows split over ``replica`` (or ``data``) into blocks on a
    slot's sub-grid of several devices (a ``utils.placed.Placed`` leaf the
    partitioned train step reads a replica's rows from); a batch the spec
    does not split goes whole to its slot's device."""
    return {k: sharding.place(torch.as_tensor(v)) for k, v in batch.items()}
