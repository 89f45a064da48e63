"""flash_attention — causal / sliding-window attention with GQA.

For q ``[B, Sq, Hq, hd]`` and k, v ``[B, Sk, Hkv, hd]`` (query head ``h``
reads kv head ``h // (Hq // Hkv)``), in f32::

    s[i, j] = (q_i · hd^-0.5) · k_j        keys j visible from position q_offset + i
    o_i     = Σ_j softmax_j(s[i, :]) v_j   (0 for a row that sees no key)

A key ``j`` is visible when ``j <= q_offset + i`` (causal) and
``j > q_offset + i - window`` (when a window is given).  The output has q's
dtype.  This is ``repro.kernels.ref.flash_attention`` and the function of
the Pallas kernel ``repro/kernels/flash_attention.py:_kernel``.

On a CUDA card it runs one of three hand-written kernels.  The route is a
pure function of dtype and shapes (``route``):

* ``decode`` — at most ``DECODE_ROWS`` query rows per kv head
  (``Sq * Hq / Hkv``), bf16 or f32: ``csrc/flash_decode.cu``.  Bound by the
  bytes of the visible cache, and at decode sizes by launch latency: the
  key range is split over about two blocks per SM (``decode_plan``), each
  block holding every query head of its kv head, and a second small kernel
  merges the splits by log-sum-exp (counted as ``decode_combine``).
* ``prefill_tc`` — bf16 with more rows: ``csrc/flash_prefill.cu``.  Bound
  by the tensor cores' products: wgmma tiles with bf16 Q, K, V in shared
  memory, K/V tiles in a two-stage cp.async ring, P split into two bf16
  parts so that P V keeps f32-like precision.
* ``prefill_fma`` — f32 with more rows: ``csrc/flash_attention.cu``, f32
  FMA loops on the CUDA cores (bound by shared-memory loads).  A TF32
  product would give up the f32 parity that the port's tests hold.

``flash_attention`` dispatches on the tensors' device: CUDA tensors launch
a kernel, CPU tensors take ``flash_attention_plain``, meta tensors (a dry
run) get an empty output.  No fallback: a failed build or launch raises.
The kernels have no backward, so an input that requires grad is refused.
``flash_attention.launches`` counts wrapper calls that launched;
``flash_attention.launches_by_route`` counts them by route, and the decode
route's combine kernel on its own.  ``cost`` is one call's work (the
visible keys only), which the card's and the meta branch add to an active
``utils.op_counts.OpCounter`` under the route (the decode route's whole
cost on ``decode``, its combine as a call of no cost).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import COUNT_LOCK, launch_on
from repro_torch.utils import op_counts as _oc

HEAD_DIMS = (32, 64, 128, 160, 256)   # 160: stablelm-12b (5120 / 32 heads)
ROUTES = ("decode", "prefill_tc", "prefill_fma")
# the decode route takes at most this many query rows per kv head (Sq * Hq / Hkv):
# they share one block, each lane holding every row's share of q in registers
DECODE_ROWS = 8
# the decode route's split plan: about two blocks per SM of an H100 (132 SMs),
# at least one per SM at gemma3-1b's decode shape, and no split shorter than
# DECODE_MIN_CHUNK keys except the last of a range
DECODE_MIN_BLOCKS = 132
DECODE_TARGET_BLOCKS = 2 * DECODE_MIN_BLOCKS
DECODE_MIN_CHUNK = 8
LOG2E = 1.4426950408889634


def route(dtype: torch.dtype, Sq: int, Hq: int, Hkv: int) -> str:
    """The kernel a CUDA call takes, from dtype and shapes alone."""
    if Sq * (Hq // Hkv) <= DECODE_ROWS:
        return "decode"
    return "prefill_tc" if dtype == torch.bfloat16 else "prefill_fma"


class DecodePlan(NamedTuple):
    """Split s covers keys ``[k_lo + s * chunk, min(k_lo + (s + 1) * chunk,
    k_hi))``; ``[k_lo, k_hi)`` holds every key a query row can see."""
    k_lo: int
    k_hi: int
    chunk: int
    n_splits: int


@functools.lru_cache(maxsize=4096)   # decode calls it once per layer and step
def decode_plan(B: int, Sq: int, Sk: int, Hkv: int, *, causal: bool = True,
                window: Optional[int] = None, q_offset: int = 0) -> DecodePlan:
    """Cut the visible key range into splits, so that the decode grid
    ``(n_splits, Hkv, B)`` has about ``DECODE_TARGET_BLOCKS`` blocks.  An
    empty range still gets one (empty) split, whose rows write 0."""
    lo = max(0, q_offset - window + 1) if window is not None else 0
    hi = min(Sk, q_offset + Sq) if causal else Sk
    n = hi - lo
    if n <= 0:
        return DecodePlan(0, 0, 1, 1)
    per = -(-DECODE_TARGET_BLOCKS // (B * Hkv))
    chunk = max(DECODE_MIN_CHUNK, -(-n // per))
    return DecodePlan(lo, hi, chunk, -(-n // chunk))


def visible(Sq: int, Sk: int, causal: bool, window: Optional[int],
            q_offset: int) -> Tuple[int, int]:
    """``(entries, keys)``: the score entries the masks leave visible, summed
    over the query rows, and the keys some query row sees (the K and V rows
    a call must read)."""
    qp = np.arange(Sq, dtype=np.int64) + q_offset
    hi = np.minimum(qp + 1, Sk) if causal else np.full(Sq, Sk, dtype=np.int64)
    lo = np.maximum(qp - window + 1, 0) if window is not None else np.zeros(Sq, dtype=np.int64)
    entries = int(np.clip(hi - lo, 0, None).sum())
    k_lo = max(0, q_offset - window + 1) if window is not None else 0
    k_hi = min(Sk, q_offset + Sq) if causal else Sk
    return entries, max(0, k_hi - k_lo)


def cost(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
         window: Optional[int] = None, q_offset: int = 0) -> Tuple[int, int]:
    """``(flops, bytes)`` of one call over the visible keys only: 4·hd
    operations a visible score entry and query head (q·k and p·v), at the
    peak of q's dtype (bf16 on the tensor cores); q read and o written once,
    each visible K and V row read once."""
    B, Sq, Hq, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    entries, keys = visible(Sq, Sk, causal, window, q_offset)
    nbytes = 2 * q.numel() * q.element_size() + 2 * B * Hkv * hd * k.element_size() * keys
    return 4 * hd * B * Hq * entries, nbytes


def _count(q, k, v, causal, window, q_offset, which) -> None:
    _oc.add("flash_attention", which, *cost(q, k, v, causal=causal, window=window,
                                            q_offset=q_offset))
    if which == "decode":
        _oc.add("flash_attention", "decode_combine", 0, 0)


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
def _lib(source: str) -> ctypes.CDLL:
    """The library of ``csrc/<source>.cu`` with its C entry point typed:
    ``flash_attention`` (the f32 FMA kernel), ``flash_prefill`` or
    ``flash_decode``."""
    lib = _build.load(source)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = {"flash_attention": "flash_attention_launch", "flash_prefill": "flash_prefill_launch",
          "flash_decode": "flash_decode_launch"}[source]
    getattr(lib, fn).argtypes = {
        "flash_attention": [p, p, p, p, i, i, i, i, i, i, i, i, i, f, p],
        "flash_prefill": [p, p, p, p, i, i, i, i, i, i, i, i, i, f, p],
        "flash_decode": [p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, f, i, i, i, i, i, p],
    }[source]
    getattr(lib, fn).restype = ctypes.c_int
    err = getattr(lib, f"{source}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return lib


def _check(q, k, v, window):
    # plain comparisons: the serving path calls this once per layer and step
    qs, ks = q.shape, k.shape
    if len(qs) != 4 or len(ks) != 4 or ks != v.shape:
        raise ValueError(f"flash_attention wants q [B, Sq, Hq, hd] and k, v [B, Sk, Hkv, hd]; "
                         f"got {tuple(qs)}, {tuple(ks)}, {tuple(v.shape)}")
    if ks[0] != qs[0] or ks[3] != qs[3] or ks[2] < 1 or qs[2] % ks[2]:
        raise ValueError(f"flash_attention: k/v {tuple(ks)} do not fit q {tuple(qs)} "
                         "(same B and hd, Hq a multiple of Hkv)")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None; got {window}")
    if q.requires_grad or k.requires_grad or v.requires_grad:
        raise ValueError("flash_attention has no backward: its inputs must not require grad")
    dev = q.device
    if k.device != dev or v.device != dev:
        raise ValueError(f"flash_attention wants q, k, v on one device; got "
                         f"{dev}, {k.device}, {v.device}")


def _check_kernel(q, k, v):
    """What the kernels take beyond ``_check`` (the meta branch holds a
    dry run's calls to it too)."""
    hd = q.shape[3]
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head_dim in {HEAD_DIMS}; got {hd}")
    if q.dtype not in (torch.bfloat16, torch.float32) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention kernel takes q, k, v all bf16 or all f32; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention kernel takes contiguous q, k, v")


def _launch(q, k, v, causal, window, q_offset):
    B, Sq, Hq, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    _check_kernel(q, k, v)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr())
    if (ptrs[0] | ptrs[1] | ptrs[2]) % 16:
        raise ValueError("flash_attention kernel takes q, k, v starting on 16-byte boundaries")
    out = torch.empty_like(q)
    which = route(q.dtype, Sq, Hq, Hkv)
    win = 0 if window is None else int(window)
    if which == "decode":
        plan = decode_plan(B, Sq, Sk, Hkv, causal=causal, window=window, q_offset=q_offset)
        # f32 partials of every (batch, kv head, split, row): (m, l), then acc [hd]
        n = B * Hkv * plan.n_splits * Sq * (Hq // Hkv)
        part = torch.empty(n * (2 + hd), dtype=torch.float32, device=q.device)
        source = "flash_decode"
        lib = _lib(source)
        err = launch_on(
            q, lib.flash_decode_launch, *ptrs, part.data_ptr(), part.data_ptr() + 8 * n,
            out.data_ptr(), B, Sq, Sk, Hq, Hkv, hd, int(causal), win, int(q_offset),
            hd ** -0.5 * LOG2E, plan.k_lo, plan.k_hi, plan.chunk, plan.n_splits,
            int(q.dtype == torch.bfloat16))
    elif which == "prefill_tc":
        source = "flash_prefill"
        lib = _lib(source)
        err = launch_on(q, lib.flash_prefill_launch, *ptrs, out.data_ptr(), B, Sq, Sk, Hq,
                        Hkv, hd, int(causal), win, int(q_offset), hd ** -0.5 * LOG2E)
    else:
        source = "flash_attention"
        lib = _lib(source)
        err = launch_on(q, lib.flash_attention_launch, *ptrs, out.data_ptr(), B, Sq, Sk,
                        Hq, Hkv, hd, int(causal), win, int(q_offset), hd ** -0.5)
    if err != 0:
        msg = getattr(lib, f"{source}_error_string")(err).decode()
        raise RuntimeError(f"flash_attention {which} launch failed: CUDA error {err} ({msg})")
    with COUNT_LOCK:
        flash_attention.launches += 1
        flash_attention.launches_by_route[which] += 1
        if which == "decode":
            flash_attention.launches_by_route["decode_combine"] += 1
    if _oc.ACTIVE is not None:
        _count(q, k, v, causal, window, q_offset, which)
    return out


def reset_launches() -> None:
    """Set ``launches`` and every per-route count to 0."""
    flash_attention.launches = 0
    flash_attention.launches_by_route = dict.fromkeys(ROUTES + ("decode_combine",), 0)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                    window: Optional[int] = None, q_offset: int = 0) -> torch.Tensor:
    """Returns ``o [B, Sq, Hq, hd]`` in q's dtype.  An empty q gives an
    empty output without a launch; otherwise CUDA tensors launch the kernel,
    CPU tensors take ``flash_attention_plain`` and meta tensors get an empty
    output."""
    _check(q, k, v, window)
    dev = q.device
    if q.numel() == 0:
        return torch.empty_like(q)
    if dev.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window, q_offset=q_offset)
    if dev.type == "meta":
        _check_kernel(q, k, v)
        if _oc.ACTIVE is not None:
            _count(q, k, v, causal, window, q_offset, route(q.dtype, q.shape[1], q.shape[2],
                                                            k.shape[2]))
        return torch.empty_like(q)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention runs on the CPU, a CUDA card or the meta "
                         f"device; got {dev}")
    return _launch(q, k, v, causal, window, q_offset)


reset_launches()
