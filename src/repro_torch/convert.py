"""Carry parameter trees between numpy and the port.

The JAX package hands bf16 leaves as numpy arrays of ``ml_dtypes.bfloat16``,
which ``torch.from_numpy`` refuses; they cross as their uint16 bit pattern
(``.view(np.uint16)`` -> ``torch.from_numpy`` -> ``.view(torch.bfloat16)``),
so no value is rounded on the way.  ``to_numpy`` goes back the same way:
numpy has no bfloat16 of its own, so a bf16 leaf comes back as its uint16
bit pattern, which the caller views as ``ml_dtypes.bfloat16``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.utils.device import resolve_device
from repro_torch.utils.pytree import tree_map


def from_numpy(arr, device="cuda") -> torch.Tensor:
    arr = np.array(arr)  # a copy: the tensor never aliases the caller's buffer
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16).to(resolve_device(device))
    return torch.from_numpy(arr).to(resolve_device(device))


def from_jax_params(tree, device="cuda"):
    """Nested dict of numpy-convertible leaves -> nested dict of tensors."""
    device = resolve_device(device)
    return tree_map(lambda a: from_numpy(a, device), tree)


def to_numpy(tree):
    """Nested dict of tensors -> nested dict of numpy arrays (bf16 leaves
    as uint16 bit patterns)."""
    def one(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.uint16).numpy().copy()
        return t.numpy().copy()

    return tree_map(one, tree)
