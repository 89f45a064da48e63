"""flash_attention — causal / sliding-window attention with GQA.

For q ``[B, Sq, Hq, hd]`` and k, v ``[B, Sk, Hkv, hd]`` (query head ``h``
reads kv head ``h // (Hq // Hkv)``), in f32::

    s[i, j] = (q_i · hd^-0.5) · k_j        keys j visible from position q_offset + i
    o_i     = Σ_j softmax_j(s[i, :]) v_j   (0 for a row that sees no key)

A key ``j`` is visible when ``j <= q_offset + i`` (causal) and
``j > q_offset + i - window`` (when a window is given).  The output has q's
dtype.  This is ``repro.kernels.ref.flash_attention`` and the function of
the Pallas kernel ``repro/kernels/flash_attention.py:_kernel``, which the
hand-written ``csrc/flash_attention.cu`` replaces.  On the card it is
bounded by its f32 CUDA-core products (the tensor cores would bound it);
the source's note gives the numbers and the design.

``flash_attention`` dispatches on the tensors' device: CUDA tensors launch
the kernel, CPU tensors take ``flash_attention_plain``.  No fallback: a
failed build or launch raises.  The kernel has no backward, so an input
that requires grad is refused.  ``flash_attention.launches`` counts kernel
launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (32, 64, 128, 256)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True, window: Optional[int] = None,
                          q_offset: int = 0) -> torch.Tensor:
    """Plain PyTorch version: the whole ``[B, Hq, Sq, Sk]`` score matrix in
    f32, masked softmax, fully masked rows set to 0."""
    B, Sq, Hq, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    rep = Hq // Hkv
    qf = q.float() * hd ** -0.5
    kf = torch.repeat_interleave(k.float(), rep, dim=2)
    vf = torch.repeat_interleave(v.float(), rep, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    q_pos = q_offset + torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.nan_to_num(torch.softmax(scores, dim=-1), nan=0.0)
    return torch.einsum("bhqk,bkhd->bqhd", probs, vf).to(q.dtype)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_launch.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, i,
                                           ctypes.c_float, i, p]
    lib.flash_attention_launch.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def _check(q, k, v, window):
    if q.dim() != 4 or k.dim() != 4 or tuple(k.shape) != tuple(v.shape):
        raise ValueError(f"flash_attention wants q [B, Sq, Hq, hd] and k, v [B, Sk, Hkv, hd]; "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, _, Hq, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd or k.shape[2] < 1 or Hq % k.shape[2]:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not fit q {tuple(q.shape)} "
                         "(same B and hd, Hq a multiple of Hkv)")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None; got {window}")
    if any(t.requires_grad for t in (q, k, v)):
        raise ValueError("flash_attention has no backward: its inputs must not require grad")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError(f"flash_attention wants q, k, v on one device; got "
                         f"{q.device}, {k.device}, {v.device}")


def _launch(q, k, v, causal, window, q_offset):
    B, Sq, Hq, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head_dim in {HEAD_DIMS}; got {hd}")
    if q.dtype not in (torch.bfloat16, torch.float32) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention kernel takes q, k, v all bf16 or all f32; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("flash_attention kernel takes contiguous q, k, v")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention kernel takes q, k, v starting on 16-byte boundaries")
    out = torch.empty_like(q)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq, Sk, Hq, Hkv, hd,
            int(causal), 0 if window is None else int(window), int(q_offset), hd ** -0.5,
            int(q.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err} "
                           f"({lib.flash_attention_error_string(err).decode()})")
    flash_attention.launches += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                    window: Optional[int] = None, q_offset: int = 0) -> torch.Tensor:
    """Returns ``o [B, Sq, Hq, hd]`` in q's dtype.  An empty q gives an
    empty output without a launch; otherwise CUDA tensors launch the kernel
    and CPU tensors take ``flash_attention_plain``."""
    _check(q, k, v, window)
    dev = q.device
    if q.numel() == 0:
        return torch.empty_like(q)
    if dev.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window, q_offset=q_offset)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention runs on the CPU or a CUDA card; got {dev}")
    return _launch(q, k, v, causal, window, q_offset)


flash_attention.launches = 0
