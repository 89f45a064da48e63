"""decode_accum — decode + weighted accumulate of a delta-compressed cohort.

For C compressed contributions stacked as offsets ``[C, nb, kb]`` int16,
values ``[C, nb, kb]`` int8, scales ``[C, nb]`` f32 and weights ``[C]``::

    Δ_c      = float(value)·scale scattered to b·block + offset
    acc[size] = Σ_c w_c·Δ_c        (rows of weight exactly 0 left out by a select)
    sq[C]     = ‖Δ_c‖²             (from the raw values, every entry)

Duplicate offsets add up; ``acc`` is cut to ``size``.  This is the ops-level
``repro.kernels.ops.decode_accum`` (dequantise, then
``repro.kernels.ref.decode_accum``).

``decode_accum`` dispatches on the tensors' device: CUDA tensors go through
the hand-written kernel ``csrc/decode_accum.cu`` (which replaces the Pallas
kernel ``repro/kernels/cold_fuse.py:_decode_kernel`` and reads the codec
arrays as stored, so the dequantised ``[C, nb, kb]`` f32 array never
exists), CPU tensors through ``decode_accum_plain``, meta tensors (a dry
run) to empty outputs.  No fallback: a failed build or launch raises.
``decode_accum.launches`` counts kernel launches; ``cost`` is one call's
work, which the card's and the meta branch add to an active
``utils.op_counts.OpCounter``.

The kernel is one launch of about one wave of persistent blocks:
``partition`` splits the nb codec blocks into one contiguous range per
block, ``layout`` picks how many entries a lane loads at once and how many
codec blocks a warp adds at once, and the blocks' partial sums of squares
meet in a small scratch kept per card and stream.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import COUNT_LOCK, launch_on
from repro_torch.utils import op_counts as _oc
from repro_torch.utils.flat import LANE, MAX_DELTA_BLOCK


def decode_accum_plain(indices: torch.Tensor, values: torch.Tensor, scales: torch.Tensor,
                       weights: torch.Tensor, *, size: int,
                       block: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: dequantise, then scatter-add with ``index_add_``."""
    C, nb, kb = indices.shape
    dev = indices.device
    dv = values.float() * scales.float()[..., None]
    w = weights.to(device=dev, dtype=torch.float32)
    acc = torch.zeros((nb * block,), dtype=torch.float32, device=dev)
    if C and kb:
        gi = (torch.arange(nb, device=dev)[None, :, None] * block + indices.long())
        wdv = torch.where((w == 0.0)[:, None, None], 0.0, dv) * w[:, None, None]
        acc.index_add_(0, gi.reshape(-1), wdv.reshape(-1))
    sq = torch.sum(dv * dv, dim=(1, 2))
    return acc[:size].clone(), sq


def cost(indices: torch.Tensor, values: torch.Tensor, scales: torch.Tensor,
         weights: torch.Tensor, *, size: int, block: int) -> Tuple[int, int]:
    """``(flops, bytes)`` of one call: 4·C·nb·kb operations (per entry
    dequantise, square-add (2), weight and add), at f32's peak; the payloads
    (offsets, values, scales) and the f32 weights read once, the f32
    accumulator and ``sq`` written once."""
    C, nb, kb = indices.shape
    payload = C * nb * kb * (indices.element_size() + values.element_size())
    return 4 * C * nb * kb, payload + C * nb * 4 + C * 4 + int(size) * 4 + C * 4


def layout(kb: int, idx_ptr: int, val_ptr: int) -> Tuple[int, int]:
    """``(vec, groups)``: the kernel's lanes load ``vec`` consecutive entries
    at once, and a warp adds ``groups`` codec blocks at once, 32/groups
    lanes to a row.  A row of 64 entries (the service's codec) goes to 16
    lanes of 4 (8-byte loads of offsets, 4 of values); any other kb, or a
    payload off those byte boundaries, one entry a lane (the last round
    masked)."""
    if kb == 64 and idx_ptr % 8 == 0 and val_ptr % 4 == 0:
        return 4, 2
    return 1, 1


def partition(nb: int, slots: int) -> Tuple[int, int]:
    """``(grid, per)``: block g takes the contiguous codec blocks
    ``[g·per, min(nb, (g+1)·per))``, about one wave of ``slots`` resident
    blocks; every codec block falls to exactly one block."""
    per = -(-nb // max(1, slots))
    return -(-nb // per), per


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("decode_accum")
    p = ctypes.c_void_p
    i = ctypes.c_int
    lib.decode_accum_plan.argtypes = [i, i, i, i, ctypes.POINTER(i), ctypes.POINTER(i)]
    lib.decode_accum_plan.restype = i
    lib.decode_accum_launch.argtypes = [p, p, p, p, p, p, p, p, ctypes.c_longlong,
                                        i, i, i, i, i, i, i, i, i, p]
    lib.decode_accum_launch.restype = i
    lib.decode_accum_error_string.argtypes = [i]
    lib.decode_accum_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"decode_accum {what} failed: CUDA error {err} "
                           f"({_lib().decode_accum_error_string(err).decode()})")


@functools.lru_cache(maxsize=None)
def _plan(index: int, vec: int, groups: int, block: int, C: int) -> Tuple[int, int]:
    """``(warps per block, resident blocks on the card)`` from the occupancy
    query: once per card, layout and size class, which is also when the C
    side sets the kernel's shared-memory attributes."""
    warps, per_sm = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(index):
        _raise_on(_lib().decode_accum_plan(vec, groups, block, C, ctypes.byref(warps),
                                           ctypes.byref(per_sm)), "plan")
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return warps.value, per_sm.value * sms


# (card index, raw stream) -> [the last-block ticket, int32, which every
# launch leaves at 0; then the blocks' sq partials, f64, one tensor for
# each size the stream has needed].  A stream's launches run one after
# another, so they share them; launches on two streams never do.  A larger
# cohort appends a partials tensor at least twice as large and keeps the
# old ones, which a CUDA graph captured on the stream may still point at.
# A graph keeps its capture stream's scratch, so two graphs captured on one
# stream must not replay at the same time (as with PyTorch's own
# per-stream workspaces).
_SCRATCH: Dict[Tuple[int, int], List[torch.Tensor]] = {}


def _scratch(dev: torch.device, stream: int, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    held = _SCRATCH.get((dev.index, stream))
    if held is None:  # zeroed on the stream itself, before its first launch
        held = _SCRATCH[dev.index, stream] = [torch.zeros((1,), dtype=torch.int32, device=dev)]
    if len(held) == 1 or held[-1].numel() < n:
        held.append(torch.empty((max(n, 2 * held[-1].numel()),), dtype=torch.float64,
                                device=dev))
    return held[-1], held[0]


def _check(indices, values, scales, weights, size, block):
    if indices.dim() != 3 or tuple(values.shape) != tuple(indices.shape):
        raise ValueError(f"decode_accum wants offsets and values [C, nb, kb]; got "
                         f"{tuple(indices.shape)} and {tuple(values.shape)}")
    C, nb, _ = indices.shape
    if tuple(scales.shape) != (C, nb) or tuple(weights.shape) != (C,):
        raise ValueError(f"decode_accum wants scales [C, nb] and weights [C]; got "
                         f"{tuple(scales.shape)} and {tuple(weights.shape)} for C={C}, nb={nb}")
    if block % LANE or not 0 < block <= MAX_DELTA_BLOCK:
        raise ValueError(f"block {block} must be a multiple of {LANE} in (0, {MAX_DELTA_BLOCK}]")
    if size < 1 or nb != -(-size // block):
        raise ValueError(f"nb={nb} codec blocks of {block} do not cover size={size}")


def _launch(indices, values, scales, weights, size, block):
    C, nb, kb = indices.shape
    if (indices.dtype, values.dtype, scales.dtype) != (torch.int16, torch.int8, torch.float32):
        raise TypeError(f"decode_accum kernel takes int16 offsets, int8 values and f32 "
                        f"scales; got {indices.dtype}, {values.dtype}, {scales.dtype}")
    if not all(t.is_contiguous() for t in (indices, values, scales)):
        raise ValueError("decode_accum kernel takes contiguous payload arrays")
    dev = indices.device
    w = weights.to(device=dev, dtype=torch.float32).contiguous()
    vec, groups = layout(kb, indices.data_ptr(), values.data_ptr())
    warps, slots = _plan(dev.index, vec, groups, block, C)
    grid, per = partition(nb, slots)
    part, ticket = _scratch(dev, torch._C._cuda_getCurrentRawStream(dev.index), grid * C)
    acc = torch.empty((size,), dtype=torch.float32, device=dev)
    sq = torch.empty((C,), dtype=torch.float32, device=dev)
    _raise_on(launch_on(indices, _lib().decode_accum_launch, indices.data_ptr(),
                        values.data_ptr(), scales.data_ptr(), w.data_ptr(), acc.data_ptr(),
                        sq.data_ptr(), part.data_ptr(), ticket.data_ptr(), size, nb, kb, C,
                        block, vec, groups, warps, grid, per), "launch")
    with COUNT_LOCK:
        decode_accum.launches += 1
    if _oc.ACTIVE is not None:
        _oc.add("decode_accum", "decode_accum",
                *cost(indices, values, scales, weights, size=size, block=block))
    return acc, sq


def decode_accum(indices: torch.Tensor, values: torch.Tensor, scales: torch.Tensor,
                 weights: torch.Tensor, *, size: int,
                 block: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(acc [size] f32, sq [C] f32)``.  C = 0 or kb = 0 gives
    zeros without a launch; otherwise CUDA tensors launch the kernel, CPU
    tensors take ``decode_accum_plain`` and meta tensors get empty outputs."""
    size, block = int(size), int(block)
    _check(indices, values, scales, weights, size, block)
    C, _, kb = indices.shape
    devices = {t.device for t in (indices, values, scales)}
    if len(devices) != 1:
        raise ValueError(f"decode_accum wants its payload arrays on one device; got {devices}")
    dev = indices.device
    if C == 0 or kb == 0:
        return (torch.zeros((size,), dtype=torch.float32, device=dev),
                torch.zeros((C,), dtype=torch.float32, device=dev))
    if dev.type == "cpu":
        return decode_accum_plain(indices, values, scales, weights, size=size, block=block)
    if dev.type == "meta":
        _oc.add("decode_accum", "decode_accum",
                *cost(indices, values, scales, weights, size=size, block=block))
        return (torch.empty((size,), dtype=torch.float32, device=dev),
                torch.empty((C,), dtype=torch.float32, device=dev))
    if dev.type != "cuda":
        raise ValueError(f"decode_accum runs on the CPU, a CUDA card or the meta device; "
                         f"got {dev}")
    return _launch(indices, values, scales, weights, size, block)


decode_accum.launches = 0
