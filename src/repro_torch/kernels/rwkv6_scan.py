"""rwkv6_scan — the RWKV6 recurrence with data-dependent decay.

Per batch and head, with the state ``S [hd, hd]`` (f32, from ``s0``) and
``w_t = exp(logw_t)``::

    y_t = r_t · (diag(u) k_t v_tᵀ + S_t)
    S_{t+1} = diag(w_t) S_t + k_t v_tᵀ

for r, k, v, logw ``[B, T, H, hd]``, u ``[H, hd]`` f32 and s0
``[B, H, hd, hd]`` f32; returns ``(y [B, T, H, hd] in r's dtype, s_final
[B, H, hd, hd] f32)``.  This is ``repro.kernels.ref.rwkv6_scan`` (which
takes ``w`` itself) and the function of the Pallas kernel
``repro/kernels/rwkv6_scan.py:_kernel``.  The Pallas kernel's chunked form
holds only for ``logw >= -4``; the CUDA kernels run the recurrence step by
step, exact for any ``logw <= 0``, so the model (which never clamps) can
call them directly.

On a CUDA card it runs one of two hand-written kernels; the route is a pure
function of T (``route``):

* ``scan`` — T > 1 (prefill): ``csrc/rwkv6_scan.cu``.  Each thread holds a
  4 x 4 tile of a head's state; the row groups' partial sums of y meet in
  shared memory, and the next chunk of inputs is loaded while the current
  one runs.  Bounded by its FP32 instructions and bytes about equally at
  rwkv6-7b's prefill shape.
* ``step`` — T = 1 (a decode step): ``csrc/rwkv6_step.cu``, shaped for the
  bandwidth of reading and writing the state.

Both hoist the bonus term: ``y_t[j] = v_t[j] · Σ_i r_t[i] u[i] k_t[i] +
Σ_i r_t[i] S[i][j]``.

``rwkv6_scan`` dispatches on the tensors' device: CUDA tensors launch a
kernel, CPU tensors take ``rwkv6_scan_plain``, meta tensors (a dry run) get
empty outputs.  No fallback: a failed build or launch raises.  The kernels
have no backward, so an input that requires grad is refused.
``rwkv6_scan.launches`` counts launches and ``rwkv6_scan.launches_by_route``
counts them by route.  ``cost`` is one call's work, which the card's and the
meta branch add to an active ``utils.op_counts.OpCounter`` under the route.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import COUNT_LOCK, launch_on
from repro_torch.utils import op_counts as _oc

HEAD_DIMS = (32, 64)
ROUTES = ("scan", "step")


def route(T: int) -> str:
    """The kernel a CUDA call with T steps takes."""
    return "step" if T == 1 else "scan"


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


def cost(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, logw: torch.Tensor,
         u: torch.Tensor, s0: torch.Tensor) -> Tuple[int, int]:
    """``(flops, bytes)`` of one call: 5·B·T·H·hd² operations (per state
    element and step: y's product-add (2), k·v, the decay's multiply-add
    (2)), at f32's peak; r, k, v, logw read and y written once, u read, the
    f32 state read and written once."""
    B, T, H, hd = r.shape
    nbytes = 5 * r.numel() * r.element_size() + u.numel() * 4 + 2 * s0.numel() * 4
    return 5 * B * T * H * hd * hd, nbytes


@functools.lru_cache(maxsize=None)
def _lib(source: str) -> ctypes.CDLL:
    """The library of ``csrc/<source>.cu`` (``rwkv6_scan`` or ``rwkv6_step``)
    with its C entry point typed."""
    lib = _build.load(source)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = getattr(lib, f"{source}_launch")
    fn.argtypes = {"rwkv6_scan": [p] * 8 + [i] * 5 + [p],
                   "rwkv6_step": [p] * 8 + [i] * 4 + [p]}[source]
    fn.restype = ctypes.c_int
    err = getattr(lib, f"{source}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return lib


def _check(r, k, v, logw, u, s0):
    # plain comparisons: the decode path calls this once per layer and step
    rs = r.shape
    if len(rs) != 4 or k.shape != rs or v.shape != rs or logw.shape != rs:
        raise ValueError(f"rwkv6_scan wants r, k, v, logw of one shape [B, T, H, hd]; got "
                         f"{[tuple(t.shape) for t in (r, k, v, logw)]}")
    B, _, H, hd = rs
    if u.shape != (H, hd) or s0.shape != (B, H, hd, hd):
        raise ValueError(f"rwkv6_scan wants u [H, hd] and s0 [B, H, hd, hd] for "
                         f"{tuple(rs)}; got {tuple(u.shape)} and {tuple(s0.shape)}")
    if (r.requires_grad or k.requires_grad or v.requires_grad or logw.requires_grad
            or u.requires_grad or s0.requires_grad):
        raise ValueError("rwkv6_scan has no backward: its inputs must not require grad")
    dev = r.device
    if (k.device != dev or v.device != dev or logw.device != dev or u.device != dev
            or s0.device != dev):
        raise ValueError(f"rwkv6_scan wants its inputs on one device; got "
                         f"{[str(t.device) for t in (r, k, v, logw, u, s0)]}")


def _check_kernel(r, k, v, logw, u, s0):
    """What the kernels take beyond ``_check`` (the meta branch holds a
    dry run's calls to it too)."""
    hd = r.shape[3]
    if hd not in HEAD_DIMS:
        raise ValueError(f"rwkv6_scan kernel takes head_dim in {HEAD_DIMS}; got {hd}")
    dt = r.dtype
    if (dt not in (torch.bfloat16, torch.float32) or k.dtype != dt or v.dtype != dt
            or logw.dtype != dt):
        raise TypeError(f"rwkv6_scan kernel takes r, k, v, logw all bf16 or all f32; got "
                        f"{[t.dtype for t in (r, k, v, logw)]}")
    if u.dtype != torch.float32 or s0.dtype != torch.float32:
        raise TypeError(f"rwkv6_scan kernel takes f32 u and s0; got {u.dtype}, {s0.dtype}")
    if not (r.is_contiguous() and k.is_contiguous() and v.is_contiguous()
            and logw.is_contiguous() and u.is_contiguous() and s0.is_contiguous()):
        raise ValueError("rwkv6_scan kernel takes contiguous inputs")


def _launch(r, k, v, logw, u, s0, which=None):
    """Launch the kernel of ``which`` (default ``route(T)``)."""
    B, T, H, hd = r.shape
    _check_kernel(r, k, v, logw, u, s0)
    ptrs = (r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(), u.data_ptr(),
            s0.data_ptr())
    if (ptrs[0] | ptrs[1] | ptrs[2] | ptrs[3] | ptrs[4] | ptrs[5]) % 16:
        raise ValueError("rwkv6_scan kernel takes inputs starting on 16-byte boundaries")
    which = which or route(T)
    if which == "step" and T != 1:
        raise ValueError(f"rwkv6_scan's step route takes T = 1; got T = {T}")
    y = torch.empty_like(r)
    s_final = torch.empty_like(s0)
    bf16 = int(r.dtype == torch.bfloat16)
    if which == "step":
        source = "rwkv6_step"
        lib = _lib(source)
        err = launch_on(r, lib.rwkv6_step_launch, *ptrs, y.data_ptr(),
                        s_final.data_ptr(), B, H, hd, bf16)
    elif which == "scan":
        source = "rwkv6_scan"
        lib = _lib(source)
        err = launch_on(r, lib.rwkv6_scan_launch, *ptrs, y.data_ptr(),
                        s_final.data_ptr(), B, T, H, hd, bf16)
    else:
        raise ValueError(f"rwkv6_scan routes are {ROUTES}; got {which!r}")
    if err != 0:
        msg = getattr(lib, f"{source}_error_string")(err).decode()
        raise RuntimeError(f"rwkv6_scan {which} launch failed: CUDA error {err} ({msg})")
    with COUNT_LOCK:
        rwkv6_scan.launches += 1
        rwkv6_scan.launches_by_route[which] += 1
    if _oc.ACTIVE is not None:
        _oc.add("rwkv6_scan", which, *cost(r, k, v, logw, u, s0))
    return y, s_final


def reset_launches() -> None:
    """Set ``launches`` and every per-route count to 0."""
    rwkv6_scan.launches = 0
    rwkv6_scan.launches_by_route = dict.fromkeys(ROUTES, 0)


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, logw: torch.Tensor,
               u: torch.Tensor, s0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(y, s_final)``.  T = 0 gives an empty ``y`` and a copy of
    ``s0`` without a launch; otherwise CUDA tensors launch a kernel, CPU
    tensors take ``rwkv6_scan_plain`` and meta tensors get empty outputs."""
    _check(r, k, v, logw, u, s0)
    dev = r.device
    if r.numel() == 0:
        return torch.empty_like(r), s0.float().clone()
    if dev.type == "cpu":
        return rwkv6_scan_plain(r, k, v, logw, u, s0)
    if dev.type == "meta":
        _check_kernel(r, k, v, logw, u, s0)
        _oc.add("rwkv6_scan", route(r.shape[1]), *cost(r, k, v, logw, u, s0))
        return torch.empty_like(r), torch.empty_like(s0, dtype=torch.float32)
    if dev.type != "cuda":
        raise ValueError(f"rwkv6_scan runs on the CPU, a CUDA card or the meta device; "
                         f"got {dev}")
    return _launch(r, k, v, logw, u, s0)


reset_launches()
