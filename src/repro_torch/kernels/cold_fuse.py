"""cold_fuse — the Repository's single-pass screen + fuse.

For ``base [N]``, ``contribs [K, N]``, weights ``w [K]`` and a scalar α:

    fused    = base + α·(Σ_k (w_k/Σw)·θ_k − base)      (cast to base dtype)
    sq_diff  = ‖θ_k − base‖²  for every k              (float32)

Zero-weight rows are masked out of the sum by a select (a NaN row of weight
0 adds nothing), while ``sq_diff`` comes from the raw values.  Math is f32.

``cold_fuse`` dispatches on the tensors' device: a CUDA tensor goes through
the hand-written kernel ``csrc/cold_fuse.cu`` (which replaces the Pallas
kernel ``repro/kernels/cold_fuse.py:_kernel``), a CPU tensor through
``cold_fuse_plain``, the same arithmetic in plain PyTorch.  There is no
fallback from one to the other: a failed build or launch raises.
``cold_fuse.launches`` counts kernel launches (CPU calls do not count).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import COUNT_LOCK, launch_on

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
BLOCKS_PER_SM = 4


def cold_fuse_plain(base: torch.Tensor, contribs: torch.Tensor, weights: torch.Tensor,
                    alpha: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version (``repro.kernels.ref.cold_fuse`` in torch)."""
    w = weights.float()
    wn = w / torch.sum(w)
    cf = contribs.float()
    bf = base.float()
    masked = torch.where((w == 0.0)[:, None], 0.0, cf)
    avg = torch.einsum("k,kn->n", wn, masked)
    fused = (bf + alpha * (avg - bf)).to(base.dtype)
    sq = torch.sum(torch.square(cf - bf[None, :]), dim=1)
    return fused, sq


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("cold_fuse")
    p = ctypes.c_void_p
    lib.cold_fuse_launch.argtypes = [p, p, p, ctypes.c_float, p, p, p,
                                     ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_int, p]
    lib.cold_fuse_launch.restype = ctypes.c_int
    lib.cold_fuse_max_k.restype = ctypes.c_int
    lib.cold_fuse_threads.restype = ctypes.c_int
    lib.cold_fuse_error_string.argtypes = [ctypes.c_int]
    lib.cold_fuse_error_string.restype = ctypes.c_char_p
    return lib


def _check(base, contribs, weights):
    if base.dim() != 1 or contribs.dim() != 2 or contribs.shape[1] != base.shape[0]:
        raise ValueError(f"cold_fuse wants base [N] and contribs [K, N]; got "
                         f"{tuple(base.shape)} and {tuple(contribs.shape)}")
    if contribs.shape[0] < 1 or tuple(weights.shape) != (contribs.shape[0],):
        raise ValueError(f"cold_fuse wants weights [K] with K >= 1; got "
                         f"{tuple(weights.shape)} for K={contribs.shape[0]}")
    if base.dtype != contribs.dtype or base.dtype not in _DTYPE_CODE:
        raise TypeError(f"cold_fuse takes bf16 or f32 base/contribs of one dtype; got "
                        f"{base.dtype} and {contribs.dtype}")
    if not weights.is_floating_point():
        raise TypeError(f"cold_fuse weights must be floating; got {weights.dtype}")


def _launch(base, contribs, weights, alpha):
    K, N = contribs.shape
    if not (base.is_contiguous() and contribs.is_contiguous()):
        raise ValueError("cold_fuse kernel takes contiguous base and contribs")
    lib = _lib()
    if K > lib.cold_fuse_max_k():
        raise ValueError(f"cold_fuse kernel takes at most {lib.cold_fuse_max_k()} "
                         f"contributions per launch; got K={K}")
    dev = base.device
    w = weights.to(device=dev, dtype=torch.float32).contiguous()
    fused = torch.empty_like(base)
    sq = torch.empty((K,), dtype=torch.float32, device=dev)
    width = 16 // base.element_size()
    vec = (N % width == 0 and all(t.data_ptr() % 16 == 0 for t in (base, contribs, fused)))
    chunks = N // width if vec else N
    threads = lib.cold_fuse_threads()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n_blocks = max(1, min(-(-chunks // threads), sms * BLOCKS_PER_SM))
    scratch = torch.empty((n_blocks, K), dtype=torch.float32, device=dev)
    err = launch_on(base, lib.cold_fuse_launch, base.data_ptr(), contribs.data_ptr(),
                    w.data_ptr(), float(alpha), fused.data_ptr(), sq.data_ptr(),
                    scratch.data_ptr(), N, K, n_blocks, _DTYPE_CODE[base.dtype], int(vec))
    if err != 0:
        raise RuntimeError(f"cold_fuse launch failed: CUDA error {err} "
                           f"({lib.cold_fuse_error_string(err).decode()})")
    with COUNT_LOCK:
        cold_fuse.launches += 1
    return fused, sq


def cold_fuse(base: torch.Tensor, contribs: torch.Tensor, weights: torch.Tensor,
              alpha: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(fused [N], sq_diff [K])``.  CUDA tensors launch the kernel
    (K ≤ 64 per launch); CPU tensors take ``cold_fuse_plain``."""
    _check(base, contribs, weights)
    devices = {base.device.type, contribs.device.type}
    if devices == {"cpu"}:
        return cold_fuse_plain(base, contribs, weights, alpha)
    if devices != {"cuda"} or base.device != contribs.device:
        raise ValueError(f"cold_fuse wants base and contribs on one device; got "
                         f"{base.device} and {contribs.device}")
    return _launch(base, contribs, weights, alpha)


cold_fuse.launches = 0
