"""row_sketch — the novelty screen's fingerprint of one flat row.

For a row ``x [N]`` (bf16 or f32): LANE = 1024-element tile ``t`` adds its
sum to ``out[0, t % n_buckets]`` and its sum of squares to
``out[1, t % n_buckets]``; the last partial tile counts as zero-padded.
Returns ``[2, n_buckets]`` float32 (``repro.kernels.ref.row_sketch``).

``row_sketch`` dispatches on the row's device: a CUDA tensor goes through
the hand-written kernel ``csrc/row_sketch.cu`` (which replaces the Pallas
kernel built by ``repro/kernels/cold_fuse.py:_make_sketch_kernel``), a CPU
tensor through ``row_sketch_plain``.  No fallback: a failed build or launch
raises.  ``row_sketch.launches`` counts kernel launches.

``row_sketch_shard`` is one shard's partial of the sketch of a row laid out
block-cyclically (``utils.flat.ShardedFlatSpec``; blocks of ``block``
elements over ``n_shards`` shards): the slice's tile ``t`` is the row's tile
``g = ((t // tpb)·n_shards + shard)·tpb + t % tpb``, ``tpb = block / LANE``,
and feeds bucket ``g % n_buckets`` (``repro.kernels.ref.row_sketch_shard``).
A CUDA slice launches the entry ``row_sketch_shard_launch`` of the same
source, a CPU slice takes ``row_sketch_shard_plain``;
``row_sketch_shard.launches`` counts its launches.  (Where ``tpb`` is a
multiple of ``n_buckets``, ``g`` and ``t`` share a bucket and
``row_sketch`` of the slice is the partial: ``ops.row_sketch_sharded``
takes that path.)
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import COUNT_LOCK, launch_on
from repro_torch.utils.flat import LANE

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
BLOCKS_PER_SM = 8


def row_sketch_plain(row: torch.Tensor, n_buckets: int = 32) -> torch.Tensor:
    """Plain PyTorch version: per-tile sums in f32, folded over the buckets."""
    x = row.float()
    pad = (-x.shape[0]) % LANE
    if pad:
        x = torch.cat([x, x.new_zeros(pad)])
    tiles = x.view(-1, LANE)
    ts, tq = tiles.sum(dim=1), (tiles * tiles).sum(dim=1)
    out = torch.zeros((2, n_buckets), dtype=torch.float32, device=row.device)
    bucket = torch.arange(ts.shape[0], device=row.device) % n_buckets
    out[0].index_add_(0, bucket, ts)
    out[1].index_add_(0, bucket, tq)
    return out


def row_sketch_shard_plain(slab: torch.Tensor, shard_index: int, n_shards: int, block: int,
                           n_buckets: int = 32) -> torch.Tensor:
    """Plain PyTorch version of one shard's partial: per-tile f32 sums, each
    added to the bucket of its row tile."""
    x = slab.float()
    if x.shape[0] % LANE:
        raise ValueError(f"a shard slice is whole tiles; got {x.shape[0]} elements")
    tiles = x.view(-1, LANE)
    ts, tq = tiles.sum(dim=1), (tiles * tiles).sum(dim=1)
    tpb = block // LANE
    t = torch.arange(ts.shape[0], device=slab.device)
    g = ((t // tpb) * n_shards + shard_index) * tpb + t % tpb
    out = torch.zeros((2, n_buckets), dtype=torch.float32, device=slab.device)
    out[0].index_add_(0, g % n_buckets, ts)
    out[1].index_add_(0, g % n_buckets, tq)
    return out


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("row_sketch")
    p = ctypes.c_void_p
    ll = ctypes.c_longlong
    lib.row_sketch_launch.argtypes = [p, ll, ctypes.c_int, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_int, p, p, p]
    lib.row_sketch_launch.restype = ctypes.c_int
    lib.row_sketch_shard_launch.argtypes = [p, ll, ctypes.c_int, ctypes.c_int, ll, ll, ll,
                                            ctypes.c_int, ctypes.c_int, p, p, p]
    lib.row_sketch_shard_launch.restype = ctypes.c_int
    lib.row_sketch_error_string.argtypes = [ctypes.c_int]
    lib.row_sketch_error_string.restype = ctypes.c_char_p
    return lib


def grid_for(n_buckets: int, sms: int) -> int:
    """Blocks for one launch: a multiple of ``n_buckets`` (block g sums only
    tiles of bucket g % n_buckets) near ``BLOCKS_PER_SM`` per SM."""
    return n_buckets * max(1, -(-(sms * BLOCKS_PER_SM) // n_buckets))


def _launch(row: torch.Tensor, n_buckets: int) -> torch.Tensor:
    if not row.is_contiguous():
        raise ValueError("row_sketch kernel takes a contiguous row")
    lib = _lib()
    dev = row.device
    grid = grid_for(n_buckets, torch.cuda.get_device_properties(dev).multi_processor_count)
    partial = torch.empty((2 * grid,), dtype=torch.float64, device=dev)
    out = torch.empty((2, n_buckets), dtype=torch.float32, device=dev)
    err = launch_on(row, lib.row_sketch_launch, row.data_ptr(), row.shape[0],
                    _DTYPE_CODE[row.dtype], int(row.data_ptr() % 16 == 0), n_buckets,
                    grid, partial.data_ptr(), out.data_ptr())
    if err != 0:
        raise RuntimeError(f"row_sketch launch failed: CUDA error {err} "
                           f"({lib.row_sketch_error_string(err).decode()})")
    with COUNT_LOCK:
        row_sketch.launches += 1
    return out


def row_sketch(row: torch.Tensor, n_buckets: int = 32) -> torch.Tensor:
    """``[2, n_buckets]`` f32 sketch of a ``[N]`` bf16/f32 row.  A CUDA row
    launches the kernel; a CPU row takes ``row_sketch_plain``."""
    if row.dim() != 1:
        raise ValueError(f"row_sketch takes a [N] row; got {tuple(row.shape)}")
    if row.dtype not in _DTYPE_CODE:
        raise TypeError(f"row_sketch takes a bf16 or f32 row; got {row.dtype}")
    if int(n_buckets) < 1:
        raise ValueError(f"n_buckets must be >= 1; got {n_buckets}")
    if row.device.type == "cpu":
        return row_sketch_plain(row, int(n_buckets))
    if row.device.type != "cuda":
        raise ValueError(f"row_sketch runs on the CPU or a CUDA card; got {row.device}")
    return _launch(row, int(n_buckets))


row_sketch.launches = 0


def _launch_shard(slab: torch.Tensor, shard_index: int, n_shards: int, block: int,
                  n_buckets: int) -> torch.Tensor:
    if not slab.is_contiguous():
        raise ValueError("row_sketch_shard kernel takes a contiguous slice")
    lib = _lib()
    dev = slab.device
    n_tiles = slab.shape[0] // LANE
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    grid = max(1, min(n_tiles, sms * BLOCKS_PER_SM))
    stats = torch.empty((2 * max(n_tiles, 1),), dtype=torch.float64, device=dev)
    out = torch.empty((2, n_buckets), dtype=torch.float32, device=dev)
    err = launch_on(slab, lib.row_sketch_shard_launch, slab.data_ptr(), slab.shape[0],
                    _DTYPE_CODE[slab.dtype], int(slab.data_ptr() % 16 == 0), int(shard_index),
                    int(n_shards), block // LANE, n_buckets, grid, stats.data_ptr(),
                    out.data_ptr())
    if err != 0:
        raise RuntimeError(f"row_sketch_shard launch failed: CUDA error {err} "
                           f"({lib.row_sketch_error_string(err).decode()})")
    with COUNT_LOCK:
        row_sketch_shard.launches += 1
    return out


def row_sketch_shard(slab: torch.Tensor, shard_index: int, n_shards: int, block: int,
                     n_buckets: int = 32) -> torch.Tensor:
    """``[2, n_buckets]`` f32 partial of shard ``shard_index``'s
    ``[shard_len]`` slice (bf16/f32, whole tiles).  A CUDA slice launches
    the kernel; a CPU slice takes ``row_sketch_shard_plain``."""
    if slab.dim() != 1 or slab.shape[0] % LANE:
        raise ValueError(f"row_sketch_shard takes a [shard_len] slice of whole tiles; got "
                         f"{tuple(slab.shape)}")
    if slab.dtype not in _DTYPE_CODE:
        raise TypeError(f"row_sketch_shard takes a bf16 or f32 slice; got {slab.dtype}")
    if block % LANE or block < LANE:
        raise ValueError(f"block {block} is not a positive multiple of {LANE}")
    if not (0 <= int(shard_index) < int(n_shards)) or int(n_buckets) < 1:
        raise ValueError(f"shard {shard_index} of {n_shards}, n_buckets {n_buckets}")
    if slab.device.type == "cpu":
        return row_sketch_shard_plain(slab, int(shard_index), int(n_shards), int(block),
                                      int(n_buckets))
    if slab.device.type != "cuda":
        raise ValueError(f"row_sketch_shard runs on the CPU or a CUDA card; got {slab.device}")
    return _launch_shard(slab, int(shard_index), int(n_shards), int(block), int(n_buckets))


row_sketch_shard.launches = 0
