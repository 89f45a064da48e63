"""Public fuse entry points (port of the single-device part of
``repro.kernels.ops``).  The kernel is chosen by the tensors' device inside
``cold_fuse``: CUDA runs the hand-written kernel, the CPU its plain
version."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.cold_fuse import cold_fuse
from repro_torch.utils.flat import FlatSpec, StagedBuffer


def fuse_flat(base, contribs, weights, alpha: float = 1.0,
              *, donate: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused repository update over flat rows: returns ``(fused [N],
    sq_diff [K])`` from one read of the staged ``[K, N]`` operand (a tensor
    or a ``StagedBuffer``).  ``donate=True`` says the caller gives the
    staged buffer up: nothing here keeps a reference to it after the launch
    (the output is a fresh tensor; no storage is aliased yet)."""
    del donate  # the launch holds the only reference this function takes
    if isinstance(contribs, StagedBuffer):
        contribs = contribs.data
    return cold_fuse(base, contribs, weights, alpha)


def fuse_pytrees(base_tree, contrib_trees, weights=None, alpha: float = 1.0,
                 *, spec: Optional[FlatSpec] = None, donate: bool = False):
    """Fuse whole trees in ONE launch: flatten each into a row, stack to
    ``[K, N]``, fuse.  Returns ``(fused_tree, sq_diff [K])``."""
    if spec is None:
        spec = FlatSpec.from_tree(base_tree)
    base_flat = spec.flatten(base_tree)
    K = len(contrib_trees)
    if weights is None:
        w = torch.ones((K,), dtype=torch.float32, device=base_flat.device)
    else:
        w = torch.as_tensor(weights, dtype=torch.float32, device=base_flat.device)
    stage = torch.stack([spec.flatten(t) for t in contrib_trees])
    fused, sq = fuse_flat(base_flat, stage, w, alpha, donate=donate)
    return spec.unflatten(fused), sq
