"""FlatSpec — the contiguous flat-row parameter layout (port of
``repro.utils.flat``).

The Repository's screen + fuse streams whole checkpoints, so a model is
staged as ONE contiguous ``[N]`` row and K contributions stack into one
``[K, N]`` operand that a single kernel launch fuses.  ``FlatSpec`` fixes
that layout:

* leaves in the order the JAX package flattens a dict tree (keys sorted at
  every level, so ``layer10`` comes before ``layer2``), paths ``/``-joined;
* one storage dtype for the row: bfloat16 if every leaf is bfloat16, else
  float32.

``to_json`` equals the JAX package's byte for byte, so a row means the same
thing in both packages.  ``unflatten`` returns views into the row wherever a
leaf already has the storage dtype: callers that update a published tree in
place write into the row itself, so they must clone first.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import Any, Dict, Sequence, Tuple

import numpy as np
import torch

from repro_torch.utils.pytree import tree_from_paths, tree_leaves_with_path

# the reference's 1-D tile (8 sublanes x 128 lanes on the TPU); the row
# sketch of the service-loop slice buckets rows by it
LANE = 1024


def dtype_name(dtype: torch.dtype) -> str:
    """``torch.bfloat16`` -> ``"bfloat16"`` (numpy's names, as JAX writes them)."""
    return str(dtype).removeprefix("torch.")


def dtype_of(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype name {name!r}")
    return dt


@dataclass(frozen=True)
class LeafSpec:
    path: str
    shape: Tuple[int, ...]
    dtype: str          # canonical dtype name, e.g. "float32", "bfloat16"
    offset: int         # element offset into the flat buffer
    size: int           # number of elements

    def slice_of(self, buf: torch.Tensor) -> torch.Tensor:
        return buf[self.offset : self.offset + self.size].view(self.shape)


@dataclass(frozen=True)
class FlatSpec:
    """Static description of a tree's flat layout (hashable)."""

    leaves: Tuple[LeafSpec, ...]
    size: int                    # total elements
    dtype: str                   # storage dtype of the flat buffer

    @classmethod
    def from_tree(cls, tree) -> "FlatSpec":
        specs = []
        off = 0
        for path, leaf in tree_leaves_with_path(tree):
            n = leaf.numel()
            specs.append(LeafSpec(path, tuple(leaf.shape), dtype_name(leaf.dtype), off, n))
            off += n
        all_bf16 = all(s.dtype == "bfloat16" for s in specs)
        return cls(tuple(specs), off, "bfloat16" if (specs and all_bf16) else "float32")

    def flatten(self, tree) -> torch.Tensor:
        """Tree -> contiguous ``[size]`` row in the storage dtype, on the
        leaves' device (a new tensor: the tree is never aliased)."""
        flat = tree_leaves_with_path(tree)
        if len(flat) != len(self.leaves):
            raise ValueError(
                f"tree has {len(flat)} leaves, spec expects {len(self.leaves)}")
        dt = dtype_of(self.dtype)
        parts = []
        for spec, (path, leaf) in zip(self.leaves, flat):
            if path != spec.path:
                raise ValueError(f"leaf path {path!r} != spec path {spec.path!r}")
            if tuple(leaf.shape) != spec.shape:
                raise ValueError(
                    f"leaf {spec.path}: shape {tuple(leaf.shape)} != spec {spec.shape}")
            parts.append(leaf.detach().reshape(-1).to(dt))
        if not parts:
            return torch.zeros((0,), dtype=dt)
        return torch.cat(parts)

    def unflatten(self, buf: torch.Tensor) -> Dict[str, Any]:
        """``[size]`` row -> nested dict with the original shapes/dtypes.
        Leaves of the storage dtype are views into ``buf``."""
        if tuple(buf.shape) != (self.size,):
            raise ValueError(f"buffer shape {tuple(buf.shape)} != ({self.size},)")
        return tree_from_paths(
            (s.path, s.slice_of(buf).to(dtype_of(s.dtype))) for s in self.leaves)

    def to_json(self) -> Dict[str, Any]:
        return {
            "dtype": self.dtype,
            "size": self.size,
            "leaves": [
                {"path": s.path, "shape": list(s.shape), "dtype": s.dtype,
                 "offset": s.offset, "size": s.size}
                for s in self.leaves
            ],
        }

    @classmethod
    def from_json(cls, meta: Dict[str, Any]) -> "FlatSpec":
        """Rebuild a spec from its JSON form.  Leaves are re-ordered the way
        the rebuilt nested dict flattens (sorted keys), as the JAX package
        does; the recorded offsets keep every leaf on its slice."""
        nested = tree_from_paths(
            (s["path"], LeafSpec(s["path"], tuple(s["shape"]), s["dtype"],
                                 s["offset"], s["size"]))
            for s in meta["leaves"])
        leaves = tuple(leaf for _, leaf in tree_leaves_with_path(nested))
        return cls(leaves, int(meta["size"]), meta["dtype"])


def row_checksum(buf) -> str:
    """CRC32 (hex) over a flat row's raw bytes; bf16 rows are read as their
    uint16 bit pattern, as the JAX package does."""
    if isinstance(buf, torch.Tensor):
        t = buf.detach().cpu().contiguous()
        arr = t.view(torch.uint16).numpy() if t.dtype == torch.bfloat16 else t.numpy()
    else:
        arr = np.asarray(buf)
        if arr.dtype.name == "bfloat16":
            arr = arr.view(np.uint16)
    return f"{zlib.crc32(np.ascontiguousarray(arr)) & 0xFFFFFFFF:08x}"


@dataclass(frozen=True)
class StagedBuffer:
    """Explicit handle to one stacked ``[K, N]`` cohort operand."""

    data: torch.Tensor

    @property
    def k(self) -> int:
        return self.data.shape[0]

    @classmethod
    def from_rows(cls, rows: Sequence[torch.Tensor]) -> "StagedBuffer":
        if not rows:
            raise ValueError("cannot stage an empty cohort")
        return cls(torch.stack(list(rows)))
