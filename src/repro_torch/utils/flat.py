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

The service loop adds the novelty screen's host half (``row_sketch_host``,
``CohortSketch``), the similarity router over a base family
(``FamilyRouter``, ``RouteDecision``), the delta codec of compressed submissions
(``DeltaPayload``, ``delta_encode``/``decode``/``entries``/``checksum``,
``sketch_apply_delta``; host numpy, byte-identical to the JAX package's)
and the double-buffered staging primitives (``StagingSide``,
``BufferPair``).

The mesh slice adds ``ShardedFlatSpec``, the block-cyclic layout of a row
over S shards (the same geometry and JSON as the JAX package's), and the
per-shard codec (``delta_encode_sharded``/``delta_decode_sharded``).
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.utils.pytree import tree_from_paths, tree_leaves_with_path

# the reference's 1-D tile (8 sublanes x 128 lanes on the TPU); the row
# sketch buckets rows by it and delta-codec blocks are multiples of it
LANE = 1024

# buckets per row-sketch statistic: a sketch is a few hundred bytes of
# JSON, yet distinct finetunes land distinct bucket profiles
SKETCH_BUCKETS = 32

# elements per block of the block-cyclic shard layout (64 tiles); clamped
# down for rows too small to give every shard one whole block
DEFAULT_SHARD_BLOCK = 64 * 1024


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
    """Explicit handle to one stacked cohort operand: a ``[K, N]`` tensor
    (one device), or, on a mesh, a tuple of S contiguous ``[K, shard_len]``
    tensors, shard ``s`` on its own device (``sharded`` True).  A
    ``[K, S, shard_len]`` tensor, the JAX package's sharded layout, is
    accepted too and split by shard where it is fused."""

    data: Any

    @property
    def sharded(self) -> bool:
        return isinstance(self.data, (tuple, list)) or self.data.dim() == 3

    @property
    def k(self) -> int:
        first = self.data[0] if isinstance(self.data, (tuple, list)) else self.data
        return first.shape[0]

    @classmethod
    def from_rows(cls, rows: Sequence[Any]) -> "StagedBuffer":
        """Stack K staged rows: ``[N]`` tensors, or per-shard row lists
        (stacked shard by shard, each on its own device)."""
        if not rows:
            raise ValueError("cannot stage an empty cohort")
        if isinstance(rows[0], (tuple, list)):
            return cls(tuple(torch.stack([r[s] for r in rows])
                             for s in range(len(rows[0]))))
        return cls(torch.stack(list(rows)))


def host_f32(buf, what: str = "row") -> np.ndarray:
    """A flat row (torch tensor on any device, or numpy) as a contiguous
    1-D host float32 array.  bf16 widens exactly, so the result equals the
    JAX package's ``astype(np.float32)`` of the same bits."""
    if isinstance(buf, torch.Tensor):
        arr = buf.detach().to("cpu", torch.float32).numpy()
    else:
        arr = np.asarray(buf)
    arr = np.ascontiguousarray(arr, np.float32)
    if arr.ndim != 1:
        raise ValueError(f"{what} must be 1-D, got shape {arr.shape}")
    return arr


# ---------------------------------------------------------------------------
# CohortSketch — the novelty admission screen's recency window
# ---------------------------------------------------------------------------


def row_sketch_host(row, n_buckets: int = SKETCH_BUCKETS) -> np.ndarray:
    """Host (numpy) twin of ``kernels.row_sketch``: the ``[2, n_buckets]``
    tile-bucketed sums and sums of squares of one flat row.  The same numpy
    arithmetic as the JAX package's, so the two agree bit for bit; the
    submit path stamps it into the rider while the row is on the host."""
    x = host_f32(row)
    t_full = x.shape[0] // LANE
    main = x[: t_full * LANE].reshape(t_full, LANE)
    ts = main.sum(axis=1)
    tq = np.einsum("ij,ij->i", main, main)
    tail = x[t_full * LANE:]
    if tail.size:  # the final partial tile (zero padding adds nothing)
        ts = np.append(ts, tail.sum())
        tq = np.append(tq, np.dot(tail, tail))
    pad = (-ts.shape[0]) % n_buckets
    if pad:
        ts = np.append(ts, np.zeros(pad, np.float32))
        tq = np.append(tq, np.zeros(pad, np.float32))
    # bucket of tile t is t % n_buckets: fold the tile axis over the buckets
    return np.stack([ts.reshape(-1, n_buckets).sum(axis=0),
                     tq.reshape(-1, n_buckets).sum(axis=0)])


class CohortSketch:
    """Recency window of admitted-row sketches plus the current base's
    sketch: the host half of the novelty admission screen (port of
    ``repro.utils.flat.CohortSketch``; the JSON form is the same).

    Both sketch statistics give lower bounds on the distance between two
    rows (Cauchy–Schwarz per bucket over the projections, the reverse
    triangle inequality over the blockwise norms).  The screen compares the
    larger bound relative to each row's distance from the base: an exact
    replay scores 0 at any model scale.  ``add`` is idempotent per id and
    trims to the newest ``window`` entries; the self-match skip needs both
    the id and the recorded queue file to agree."""

    EPS = 1e-12
    BASE_HISTORY = 8

    def __init__(self, size: int, n_buckets: int = SKETCH_BUCKETS,
                 window: int = 32):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.size = int(size)
        self.n_buckets = int(n_buckets)
        self.window = int(window)
        self.base: Optional[np.ndarray] = None
        self.base_iteration: Optional[int] = None
        self.bases: Dict[int, np.ndarray] = {}
        # (id, originating queue file, sketch, delta projections), oldest first
        self.entries: List[Tuple[str, Optional[str], np.ndarray,
                                 Optional[np.ndarray]]] = []

    def __len__(self) -> int:
        return len(self.entries)

    @property
    def seg_elems(self) -> int:
        """Upper bound on elements per bucket (the Cauchy–Schwarz L)."""
        tiles = -(-max(self.size, 1) // LANE)
        return -(-tiles // self.n_buckets) * LANE

    def _check(self, sketch) -> np.ndarray:
        arr = np.asarray(sketch, np.float64)
        if arr.shape != (2, self.n_buckets):
            raise ValueError(f"sketch shape {arr.shape} != (2, {self.n_buckets})")
        return arr

    def _lb(self, a: np.ndarray, b: np.ndarray) -> float:
        dp2 = float(np.sum((a[0] - b[0]) ** 2)) / self.seg_elems
        dn2 = float(np.sum((np.sqrt(np.maximum(a[1], 0.0))
                            - np.sqrt(np.maximum(b[1], 0.0))) ** 2))
        return float(np.sqrt(max(dp2, dn2)))

    def distance(self, a, b) -> float:
        """Mutual lower-bound distance over the larger base-relative one
        (row norms when no base sketch is set): 0 for exact duplicates."""
        a, b = self._check(a), self._check(b)
        d = self._lb(a, b)
        if self.base is not None:
            scale = max(self._lb(a, self.base), self._lb(b, self.base))
        else:
            scale = max(float(np.sqrt(max(np.sum(a[1]), 0.0))),
                        float(np.sqrt(max(np.sum(b[1]), 0.0))))
        if scale <= self.EPS:
            return 0.0 if d <= self.EPS else float("inf")
        return d / scale

    def set_base(self, sketch, iteration: Optional[int] = None) -> None:
        self.base = self._check(sketch)
        if iteration is not None:
            self.base_iteration = int(iteration)
            self.bases[int(iteration)] = self.base
            for it in sorted(self.bases)[: -self.BASE_HISTORY]:
                del self.bases[it]

    def base_at(self, iteration: Optional[int] = None) -> Optional[np.ndarray]:
        if iteration is not None and int(iteration) in self.bases:
            return self.bases[int(iteration)]
        return self.base

    def add(self, sub_id: str, sketch, *, file: Optional[str] = None,
            delta: Optional[Any] = None) -> None:
        arr = self._check(sketch)
        d = None if delta is None else np.asarray(delta, np.float64)
        self.entries = [e for e in self.entries if e[0] != sub_id]
        self.entries.append((str(sub_id), file, arr, d))
        del self.entries[: -self.window]

    def discard(self, sub_id: str) -> None:
        self.entries = [e for e in self.entries if e[0] != sub_id]

    def nearest(self, sketch, *, skip_id: Optional[str] = None,
                skip_file: Optional[str] = None) -> Optional[Tuple[str, float]]:
        best: Optional[Tuple[str, float]] = None
        for sub_id, file, s, _d in self.entries:
            if (skip_id is not None and sub_id == skip_id
                    and file is not None and file == skip_file):
                continue
            d = self.distance(sketch, s)
            if best is None or d < best[1]:
                best = (sub_id, d)
        return best

    def match(self, sketch, threshold: float, *, skip_id: Optional[str] = None,
              skip_file: Optional[str] = None) -> Optional[Tuple[str, float]]:
        """The (id, distance) of a windowed entry within ``threshold``, or
        None when the row is novel."""
        hit = self.nearest(sketch, skip_id=skip_id, skip_file=skip_file)
        if hit is not None and hit[1] <= threshold:
            return hit
        return None

    def to_json(self) -> Dict[str, Any]:
        return {
            "version": 1,
            "size": self.size,
            "n_buckets": self.n_buckets,
            "window": self.window,
            "base": None if self.base is None else self.base.tolist(),
            "base_iteration": self.base_iteration,
            "bases": {str(it): s.tolist() for it, s in self.bases.items()},
            "entries": [{"id": i, "file": f, "sketch": s.tolist(),
                         "delta": None if d is None else d.tolist()}
                        for i, f, s, d in self.entries],
        }

    @classmethod
    def from_json(cls, meta: Dict[str, Any]) -> "CohortSketch":
        sk = cls(int(meta["size"]), int(meta["n_buckets"]), int(meta["window"]))
        for it, s in meta.get("bases", {}).items():
            sk.bases[int(it)] = sk._check(s)
        if meta.get("base") is not None:
            sk.set_base(meta["base"], iteration=meta.get("base_iteration"))
        for e in meta.get("entries", []):
            sk.add(e["id"], e["sketch"], file=e.get("file"), delta=e.get("delta"))
        return sk


# ---------------------------------------------------------------------------
# FamilyRouter — sketch-distance routing over a family of bases
# ---------------------------------------------------------------------------


@dataclass
class RouteDecision:
    """Outcome of routing one submission against the base family.
    ``family`` is the member to fuse into (None when ``spawn``);
    ``distance`` the winning relative distance (None for a bootstrap
    fallback); ``scores`` every scored member's distance; ``delta`` the
    rider's base-relative projection delta, the evidence the routed
    member's sketch window records."""

    family: Optional[str]
    spawn: bool
    distance: Optional[float]
    scores: Dict[str, float]
    delta: Optional[np.ndarray]
    reason: str


class FamilyRouter:
    """Route submissions to their nearest family member by sketch distance
    (port of ``repro.utils.flat.FamilyRouter``: the same float64 numpy
    arithmetic, so decisions and distances agree bit for bit).

    The unit of comparison is the delta projection ``rider[0] − base[0]``,
    the sketch of the contributor's finetune delta.  A rider scores against
    member ``m`` the minimum of ``lb(rider, base_m) / ‖δ‖`` and, over
    ``m``'s windowed deltas ``δ_e``, ``lb_p(δ − δ_e) / max(‖δ‖, ‖δ_e‖)``:
    colinear same-stream deltas of magnitudes ``m1 ≤ m2`` score
    ``1 − m1/m2``.  Rules: no delta evidence anywhere, or a rider on its
    declared base → the declared member; nearest ≤ ``split_threshold`` →
    the argmin (ties prefer the declared member); otherwise spawn below
    ``max_bases``, else the argmin anyway."""

    def __init__(self, *, split_threshold: float = 0.8, max_bases: int = 4):
        if split_threshold <= 0:
            raise ValueError(f"split_threshold must be > 0, got {split_threshold}")
        self.split_threshold = float(split_threshold)
        self.max_bases = int(max_bases)

    @staticmethod
    def _delta_norm(delta: np.ndarray, seg_elems: int) -> float:
        return float(np.sqrt(np.sum(np.asarray(delta, np.float64) ** 2) / seg_elems))

    def route(self, sketch, sketches: Dict[str, CohortSketch], *, declared: str = "main",
              base_iteration: Optional[int] = None) -> RouteDecision:
        """Score ``sketch`` against every member's ``CohortSketch`` (base
        sketch plus windowed delta evidence) and decide; ``declared`` and
        ``base_iteration`` name the vintage the rider finetuned from."""
        if declared not in sketches:
            raise KeyError(f"unknown declared family {declared!r}")
        ref = sketches[declared]
        arr = ref._check(sketch)
        b0 = ref.base_at(base_iteration)
        if b0 is None:
            return RouteDecision(declared, False, None, {}, None,
                                 "declared member holds no base sketch yet")
        delta = arr[0] - np.asarray(b0, np.float64)[0]
        dn = self._delta_norm(delta, ref.seg_elems)
        if dn <= CohortSketch.EPS:
            return RouteDecision(declared, False, 0.0, {}, delta,
                                 "rider sits on its declared base")
        if not any(e[3] is not None for sk in sketches.values() for e in sk.entries):
            return RouteDecision(declared, False, None, {}, delta,
                                 "bootstrap: no routing evidence yet")
        scores: Dict[str, float] = {}
        for name, sk in sketches.items():
            terms: List[float] = []
            if sk.base is not None:
                terms.append(ref._lb(arr, np.asarray(sk.base, np.float64)) / dn)
            for e in sk.entries:
                de = e[3]
                if de is None:
                    continue
                den = max(dn, self._delta_norm(de, ref.seg_elems), CohortSketch.EPS)
                terms.append(float(np.sqrt(np.sum((delta - de) ** 2) / ref.seg_elems)) / den)
            if terms:
                scores[name] = min(terms)
        nearest = min(scores, key=lambda n: (scores[n], n != declared, n))
        best = scores[nearest]
        if best > self.split_threshold and len(sketches) < self.max_bases:
            return RouteDecision(None, True, best, scores, delta,
                                 f"nearest member {nearest} at {best:.3f} > "
                                 f"split_threshold {self.split_threshold:g}")
        if best > self.split_threshold:
            reason = (f"at max_bases={self.max_bases}: routed to nearest "
                      f"{nearest} despite {best:.3f} > split_threshold")
        else:
            reason = f"nearest member {nearest} at {best:.3f}"
        return RouteDecision(nearest, False, best, scores, delta, reason)


# ---------------------------------------------------------------------------
# ShardedFlatSpec — block-cyclic layout of a flat row over S shards
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShardedFlatSpec:
    """Block-cyclic layout of a flat ``[N]`` row over ``n_shards`` shards
    (port of ``repro.utils.flat.ShardedFlatSpec``; the same geometry and
    JSON).

    The zero-padded row is a ``(G, S, B)`` grid of blocks of ``B``
    elements: block ``j`` lives on shard ``j % S`` at slot ``j // S``.  A
    shard's slice is the ``G·B = shard_len`` elements of its blocks in slot
    order, so every shard holds the same count and whole LANE tiles.
    Padding is zero in the base and in every contribution: it adds nothing
    to a fused element or to ``sq_diff``, so per-shard partials sum without
    a mask."""

    size: int      # N, unpadded
    n_shards: int  # S
    block: int     # B, a multiple of LANE

    @classmethod
    def for_size(cls, size: int, n_shards: int,
                 block: Optional[int] = None) -> "ShardedFlatSpec":
        """The layout of an ``[N]`` row over ``n_shards`` shards: ``block``
        defaults to ``DEFAULT_SHARD_BLOCK``, clamped (LANE-aligned) to one
        round of the cycle when the row is smaller than S blocks."""
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        if block is None:
            per_shard = -(-max(size, 1) // n_shards)
            aligned = -(-per_shard // LANE) * LANE
            block = min(DEFAULT_SHARD_BLOCK, aligned)
        if block % LANE:
            raise ValueError(f"block {block} is not a multiple of LANE={LANE}")
        return cls(size, n_shards, block)

    @classmethod
    def from_spec(cls, spec: FlatSpec, n_shards: int,
                  block: Optional[int] = None) -> "ShardedFlatSpec":
        return cls.for_size(spec.size, n_shards, block)

    @property
    def n_super(self) -> int:
        """G, the rounds of the block cycle."""
        return -(-max(self.size, 1) // (self.n_shards * self.block))

    @property
    def padded_size(self) -> int:
        return self.n_super * self.n_shards * self.block

    @property
    def shard_len(self) -> int:
        return self.n_super * self.block

    def shard_of(self, i: int) -> Tuple[int, int]:
        """(shard, offset within the shard) of flat element ``i``."""
        if not (0 <= i < self.size):
            raise ValueError(f"element {i} out of range [0, {self.size})")
        j, r = divmod(i, self.block)
        return j % self.n_shards, (j // self.n_shards) * self.block + r

    def global_of(self, shard: int, offsets) -> np.ndarray:
        """Flat indices of ``offsets`` within shard ``shard`` (vectorized
        inverse of ``shard_of``); padding offsets map past ``size``."""
        off = np.asarray(offsets, np.int64)
        slot, r = np.divmod(off, self.block)
        return (slot * self.n_shards + int(shard)) * self.block + r

    def shard(self, buf: torch.Tensor) -> torch.Tensor:
        """``[..., N]`` -> ``[..., S, shard_len]``, zero-padded."""
        if buf.shape[-1] != self.size:
            raise ValueError(f"buffer last dim {buf.shape[-1]} != size {self.size}")
        lead = tuple(buf.shape[:-1])
        pad = self.padded_size - self.size
        if pad:
            buf = torch.cat([buf, buf.new_zeros(lead + (pad,))], dim=-1)
        grid = buf.reshape(lead + (self.n_super, self.n_shards, self.block))
        return grid.transpose(-3, -2).reshape(lead + (self.n_shards, self.shard_len))

    def unshard(self, arr: torch.Tensor) -> torch.Tensor:
        """``[..., S, shard_len]`` -> ``[..., N]`` (padding dropped)."""
        want = (self.n_shards, self.shard_len)
        if tuple(arr.shape[-2:]) != want:
            raise ValueError(f"sharded shape {tuple(arr.shape[-2:])} != {want}")
        lead = tuple(arr.shape[:-2])
        grid = arr.reshape(lead + (self.n_shards, self.n_super, self.block))
        flat = grid.transpose(-3, -2).reshape(lead + (self.padded_size,))
        return flat[..., : self.size]

    def shard_slices(self, row) -> List[Any]:
        """An ``[N]`` host row (numpy, or a tensor) -> its S contiguous
        ``[shard_len]`` slices, of the same kind: the per-shard file layout.
        Slice ``s`` is what ``shard(row)[s]`` holds."""
        if tuple(row.shape) != (self.size,):
            raise ValueError(f"row shape {tuple(row.shape)} != ({self.size},)")
        if isinstance(row, torch.Tensor):
            return [s.contiguous() for s in self.shard(row).unbind(0)]
        row = np.asarray(row)
        pad = self.padded_size - self.size
        if pad:
            row = np.concatenate([row, np.zeros((pad,), row.dtype)])
        grid = row.reshape(self.n_super, self.n_shards, self.block)
        return [np.ascontiguousarray(grid[:, s, :].reshape(self.shard_len))
                for s in range(self.n_shards)]

    def unshard_slices(self, slices: Sequence[Any]) -> Any:
        """S ``[shard_len]`` slices (numpy, or tensors on one device) -> the
        ``[N]`` row, of the same kind."""
        if len(slices) != self.n_shards:
            raise ValueError(f"{len(slices)} slices != n_shards {self.n_shards}")
        if isinstance(slices[0], torch.Tensor):
            return self.unshard(torch.stack(list(slices)))
        grid = np.stack([np.asarray(s).reshape(self.n_super, self.block)
                         for s in slices], axis=1)
        return grid.reshape(self.padded_size)[: self.size]

    def to_json(self) -> Dict[str, Any]:
        return {"size": self.size, "n_shards": self.n_shards, "block": self.block}

    @classmethod
    def from_json(cls, meta: Dict[str, Any]) -> "ShardedFlatSpec":
        return cls(int(meta["size"]), int(meta["n_shards"]), int(meta["block"]))


# ---------------------------------------------------------------------------
# Delta codec — top-k sparse / int8 compressed contributions
# ---------------------------------------------------------------------------

# int16 within-block offsets: a block may not exceed the int16 range
MAX_DELTA_BLOCK = 32768


@dataclass(frozen=True)
class DeltaPayload:
    """One compressed contribution delta (the JAX package's format): the row
    of ``size`` elements in ``n_blocks`` blocks of ``block`` elements, each
    keeping exactly ``k_per_block`` entries.

    * ``indices`` — ``[nb, kb]`` int16 offsets within each block;
    * ``values``  — ``[nb, kb]`` int8 quantized deltas (±127 clip);
    * ``scales``  — ``[nb]`` f32, ``max|selected delta| / 127`` per block.

    Reconstruction is ``values·scales`` scattered at the offsets; unused
    slots hold ``(0, 0)`` and decode to ``+0``."""

    indices: np.ndarray   # [nb, kb] int16
    values: np.ndarray    # [nb, kb] int8
    scales: np.ndarray    # [nb] float32
    size: int             # decoded element count
    block: int            # elements per codec block (LANE-aligned)

    def __post_init__(self):
        if self.size < 1:
            raise ValueError(f"size must be >= 1, got {self.size}")
        if self.block % LANE or not (0 < self.block <= MAX_DELTA_BLOCK):
            raise ValueError(
                f"block {self.block} must be a LANE multiple in (0, {MAX_DELTA_BLOCK}]")
        nb = -(-self.size // self.block)
        idx, val, scl = self.indices, self.values, self.scales
        if idx.dtype != np.int16 or val.dtype != np.int8 or scl.dtype != np.float32:
            raise ValueError(f"payload dtypes ({idx.dtype}, {val.dtype}, {scl.dtype}) != "
                             "(int16, int8, float32)")
        if idx.ndim != 2 or idx.shape[0] != nb or idx.shape != val.shape \
                or scl.shape != (nb,):
            raise ValueError(
                f"payload shapes idx{idx.shape} val{val.shape} scl{scl.shape} "
                f"inconsistent with size={self.size} block={self.block}")
        if idx.shape[1] > self.block:
            raise ValueError(f"k_per_block {idx.shape[1]} > block {self.block}")
        if idx.size and (idx.min() < 0 or int(idx.max()) >= self.block):
            raise ValueError("payload indices out of block range")

    @property
    def n_blocks(self) -> int:
        return self.indices.shape[0]

    @property
    def k_per_block(self) -> int:
        return self.indices.shape[1]

    @property
    def nbytes(self) -> int:
        """Encoded payload bytes (the queue-bandwidth figure of merit)."""
        return self.indices.nbytes + self.values.nbytes + self.scales.nbytes


def delta_encode(row, base, *, k_per_block: int, block: int = LANE) -> DeltaPayload:
    """Encode ``row − base`` as a per-block top-k / int8 ``DeltaPayload``,
    byte for byte as the JAX package does: a stable top-k by |Δ|, f32
    scales ``max/127`` and ``rint``.  Non-finite deltas raise."""
    row, base = host_f32(row, "row"), host_f32(base, "base")
    if row.shape != base.shape:
        raise ValueError(f"row shape {row.shape} != base shape {base.shape}")
    size = row.shape[0]
    if size < 1:
        raise ValueError("cannot encode an empty row")
    d = row - base
    if not np.isfinite(d).all():
        raise ValueError("delta contains non-finite values")
    nb = -(-size // block)
    kb = int(k_per_block)
    if not (0 <= kb <= block):
        raise ValueError(f"k_per_block {kb} not in [0, {block}]")
    pad = nb * block - size
    if pad:
        d = np.concatenate([d, np.zeros((pad,), np.float32)])
    d = d.reshape(nb, block)
    if kb == 0:
        return DeltaPayload(np.zeros((nb, 0), np.int16), np.zeros((nb, 0), np.int8),
                            np.zeros((nb,), np.float32), size, block)
    order = np.argsort(-np.abs(d), axis=1, kind="stable")[:, :kb]
    sel = np.take_along_axis(d, order, axis=1)            # [nb, kb]
    scales = (np.max(np.abs(sel), axis=1) / 127.0).astype(np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        q = np.where(scales[:, None] > 0.0, sel / scales[:, None], 0.0)
    values = np.clip(np.rint(q), -127, 127).astype(np.int8)
    return DeltaPayload(order.astype(np.int16), values, scales, size, block)


def delta_decode(payload: DeltaPayload, base=None) -> np.ndarray:
    """The dense f32 delta (or ``base + delta``); duplicate offsets add up."""
    nb, kb = payload.indices.shape
    dense = np.zeros((nb * payload.block,), np.float32)
    if kb:
        flat_idx = (np.arange(nb, dtype=np.int64)[:, None] * payload.block
                    + payload.indices.astype(np.int64))
        dv = payload.values.astype(np.float32) * payload.scales[:, None]
        np.add.at(dense, flat_idx.reshape(-1), dv.reshape(-1))
    dense = dense[: payload.size]
    if base is None:
        return dense
    base = host_f32(base, "base")
    if base.shape != dense.shape:
        raise ValueError(f"base shape {base.shape} != ({payload.size},)")
    return base + dense


def delta_entries(payload: DeltaPayload) -> Tuple[np.ndarray, np.ndarray]:
    """(flat indices, dequantized values) of a payload's non-zero entries
    inside the row: the sparse view the sketch correction reads."""
    nb, kb = payload.indices.shape
    if kb == 0:
        return np.zeros((0,), np.int64), np.zeros((0,), np.float32)
    gi = (np.arange(nb, dtype=np.int64)[:, None] * payload.block
          + payload.indices.astype(np.int64)).reshape(-1)
    dv = (payload.values.astype(np.float32) * payload.scales[:, None]).reshape(-1)
    keep = (gi < payload.size) & (dv != 0.0)
    return gi[keep], dv[keep]


def delta_encode_sharded(row, base, sspec: ShardedFlatSpec, *, k_per_block: int,
                         block: int = LANE) -> List[DeltaPayload]:
    """Encode each shard's slice of ``row`` against the same slice of
    ``base``: S payloads of ``shard_len`` elements.  ``sspec.block`` must
    be a multiple of the codec block, so no codec block straddles shards."""
    if sspec.block % block:
        raise ValueError(f"shard block {sspec.block} not a multiple of codec block {block}")
    row_s = sspec.shard_slices(host_f32(row, "row"))
    base_s = sspec.shard_slices(host_f32(base, "base"))
    return [delta_encode(r, b, k_per_block=k_per_block, block=block)
            for r, b in zip(row_s, base_s)]


def delta_decode_sharded(payloads: Sequence[DeltaPayload], sspec: ShardedFlatSpec,
                         base=None) -> np.ndarray:
    """S per-shard payloads -> the dense ``[N]`` delta (or ``base + delta``)."""
    if len(payloads) != sspec.n_shards:
        raise ValueError(f"{len(payloads)} payloads != n_shards {sspec.n_shards}")
    delta = sspec.unshard_slices([delta_decode(p) for p in payloads])
    if base is None:
        return delta
    return host_f32(base, "base") + delta


def delta_checksum(payloads) -> str:
    """CRC32 (hex) over the encoded payload bytes in canonical order
    (geometry, then indices/values/scales per payload)."""
    if isinstance(payloads, DeltaPayload):
        payloads = [payloads]
    crc = 0
    for p in payloads:
        crc = zlib.crc32(f"{p.size}:{p.block}:{p.k_per_block};".encode(), crc)
        crc = zlib.crc32(np.ascontiguousarray(p.indices), crc)
        crc = zlib.crc32(np.ascontiguousarray(p.values), crc)
        crc = zlib.crc32(np.ascontiguousarray(p.scales), crc)
    return f"{crc & 0xFFFFFFFF:08x}"


def sketch_apply_delta(base_sketch, indices, dvals, base_at,
                       n_buckets: int = SKETCH_BUCKETS) -> np.ndarray:
    """Sketch of ``base + delta`` from the base's sketch and the sparse
    delta: sums gain ``Σ dv`` per bucket, sums of squares
    ``Σ dv·(dv + 2·base[i])``.  ``base_at`` is the base gathered at
    ``indices``, the only base values the correction needs."""
    sk = np.array(base_sketch, np.float64, copy=True)
    if sk.shape != (2, n_buckets):
        raise ValueError(f"base sketch shape {sk.shape} != (2, {n_buckets})")
    b = (np.asarray(indices, np.int64) // LANE) % n_buckets
    dv = np.asarray(dvals, np.float64)
    ba = np.asarray(base_at, np.float64)
    sk[0] += np.bincount(b, weights=dv, minlength=n_buckets)
    sk[1] += np.bincount(b, weights=dv * (dv + 2.0 * ba), minlength=n_buckets)
    return sk


# ---------------------------------------------------------------------------
# StagingSide / BufferPair — the double-buffered staging primitives
# ---------------------------------------------------------------------------


class StagingSide:
    """One side of the double buffer: staged rows (tensors, trees on the
    per-leaf engine, or spill-file paths), their Fishers and weights and,
    with spill, their manifest entries."""

    __slots__ = ("rows", "fishers", "weights", "manifest")

    def __init__(self):
        self.rows: List[Any] = []
        self.fishers: List[Any] = []
        self.weights: List[Any] = []
        self.manifest: List[Dict[str, Any]] = []

    def __len__(self) -> int:
        return len(self.rows)


class BufferPair:
    """Front/back staging pair: uploads append to the front; ``swap()``
    moves the front cohort to the back (the in-flight fuse's operand);
    ``retire_back()`` drops it once published.  A second ``swap()`` before
    ``retire_back()`` raises."""

    def __init__(self):
        self.front = StagingSide()
        self.back: Optional[StagingSide] = None

    def swap(self) -> StagingSide:
        if self.back is not None:
            raise RuntimeError("back buffer still in flight — finalize the "
                               "pending fuse before swapping again")
        self.back = self.front
        self.front = StagingSide()
        return self.back

    def retire_back(self) -> None:
        self.back = None

    def manifest_entries(self) -> List[Dict[str, Any]]:
        """Every staged-but-unfused manifest entry, back (in flight) first:
        exactly the rows a crash right now would have to recover."""
        back = self.back
        entries = list(back.manifest) if back is not None else []
        return entries + list(self.front.manifest)
