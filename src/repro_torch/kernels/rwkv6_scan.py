"""rwkv6_scan — the RWKV6 recurrence with data-dependent decay.

Per batch and head, with the state ``S [hd, hd]`` (f32, from ``s0``) and
``w_t = exp(logw_t)``::

    y_t = r_t · (diag(u) k_t v_tᵀ + S_t)
    S_{t+1} = diag(w_t) S_t + k_t v_tᵀ

for r, k, v, logw ``[B, T, H, hd]``, u ``[H, hd]`` f32 and s0
``[B, H, hd, hd]`` f32; returns ``(y [B, T, H, hd] in r's dtype, s_final
[B, H, hd, hd] f32)``.  This is ``repro.kernels.ref.rwkv6_scan`` (which
takes ``w`` itself) and the function of the Pallas kernel
``repro/kernels/rwkv6_scan.py:_kernel``, which the hand-written
``csrc/rwkv6_scan.cu`` replaces.  The Pallas kernel's chunked form holds
only for ``logw >= -4``; the CUDA kernel runs the recurrence step by step,
exact for any ``logw <= 0``, so the model (which never clamps) can call it
directly.  On the card it is bounded by bytes but limited by the
step-to-step latency; the source's note gives the numbers and the design.

``rwkv6_scan`` dispatches on the tensors' device: CUDA tensors launch the
kernel, CPU tensors take ``rwkv6_scan_plain``.  No fallback: a failed build
or launch raises.  The kernel has no backward, so an input that requires
grad is refused.  ``rwkv6_scan.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (32, 64)


def rwkv6_scan_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, logw: torch.Tensor,
                     u: torch.Tensor, s0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: a Python loop over the steps, in f32."""
    T = r.shape[1]
    rf, kf, vf, wf = (t.float() for t in (r, k, v, logw))
    wf = torch.exp(wf)
    uf = u.float()[None, :, :, None]
    S = s0.float().clone()
    ys = []
    for t in range(T):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]  # [B, H, hd, hd]
        ys.append(torch.einsum("bhi,bhij->bhj", rf[:, t], uf * kv + S))
        S = wf[:, t, :, :, None] * S + kv
    return torch.stack(ys, dim=1).to(r.dtype), S


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("rwkv6_scan")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.rwkv6_scan_launch.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, p]
    lib.rwkv6_scan_launch.restype = ctypes.c_int
    lib.rwkv6_scan_error_string.argtypes = [ctypes.c_int]
    lib.rwkv6_scan_error_string.restype = ctypes.c_char_p
    return lib


def _check(r, k, v, logw, u, s0):
    if r.dim() != 4 or any(tuple(t.shape) != tuple(r.shape) for t in (k, v, logw)):
        raise ValueError(f"rwkv6_scan wants r, k, v, logw of one shape [B, T, H, hd]; got "
                         f"{[tuple(t.shape) for t in (r, k, v, logw)]}")
    B, _, H, hd = r.shape
    if tuple(u.shape) != (H, hd) or tuple(s0.shape) != (B, H, hd, hd):
        raise ValueError(f"rwkv6_scan wants u [H, hd] and s0 [B, H, hd, hd] for "
                         f"{tuple(r.shape)}; got {tuple(u.shape)} and {tuple(s0.shape)}")
    if any(t.requires_grad for t in (r, k, v, logw, u, s0)):
        raise ValueError("rwkv6_scan has no backward: its inputs must not require grad")
    devices = {t.device for t in (r, k, v, logw, u, s0)}
    if len(devices) != 1:
        raise ValueError(f"rwkv6_scan wants its inputs on one device; got {devices}")


def _launch(r, k, v, logw, u, s0):
    B, T, H, hd = r.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"rwkv6_scan kernel takes head_dim in {HEAD_DIMS}; got {hd}")
    if r.dtype not in (torch.bfloat16, torch.float32) or any(
            t.dtype != r.dtype for t in (k, v, logw)):
        raise TypeError(f"rwkv6_scan kernel takes r, k, v, logw all bf16 or all f32; got "
                        f"{[t.dtype for t in (r, k, v, logw)]}")
    if u.dtype != torch.float32 or s0.dtype != torch.float32:
        raise TypeError(f"rwkv6_scan kernel takes f32 u and s0; got {u.dtype}, {s0.dtype}")
    if not all(t.is_contiguous() for t in (r, k, v, logw, u, s0)):
        raise ValueError("rwkv6_scan kernel takes contiguous inputs")
    y = torch.empty_like(r)
    s_final = torch.empty_like(s0)
    lib = _lib()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = lib.rwkv6_scan_launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(), u.data_ptr(),
            s0.data_ptr(), y.data_ptr(), s_final.data_ptr(), B, T, H, hd,
            int(r.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"rwkv6_scan launch failed: CUDA error {err} "
                           f"({lib.rwkv6_scan_error_string(err).decode()})")
    rwkv6_scan.launches += 1
    return y, s_final


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, logw: torch.Tensor,
               u: torch.Tensor, s0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(y, s_final)``.  T = 0 gives an empty ``y`` and a copy of
    ``s0`` without a launch; otherwise CUDA tensors launch the kernel and
    CPU tensors take ``rwkv6_scan_plain``."""
    _check(r, k, v, logw, u, s0)
    dev = r.device
    if r.numel() == 0:
        return torch.empty_like(r), s0.float().clone()
    if dev.type == "cpu":
        return rwkv6_scan_plain(r, k, v, logw, u, s0)
    if dev.type != "cuda":
        raise ValueError(f"rwkv6_scan runs on the CPU or a CUDA card; got {dev}")
    return _launch(r, k, v, logw, u, s0)


rwkv6_scan.launches = 0
