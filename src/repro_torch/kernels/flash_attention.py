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

**Context-parallel decode** (a cache whose sequence is split into blocks
over several slots, ``models.partitioned``) takes two more entries of
``csrc/flash_decode.cu``: ``flash_attention_partials`` runs the decode
route's split kernel over one block (``q_offset`` relative to the block's
first key) and returns its f32 partials unmerged, ``[B, Hkv, n_splits,
Sq * Hq / Hkv, 2 + hd]``, each row ``(m, l, acc)`` with ``m`` the largest
visible score in log2 units (times ``hd^-0.5 * log2(e)``), ``l`` the sum
of ``exp2(score - m)`` and ``acc`` the same weights' sum of v;
``merge_partials`` runs the combine kernel over the partials of every
block, concatenated along the split axis, and gives ``o``.  A block with no
visible key contributes one empty split, ``m = -1e30`` and ``l = acc = 0``,
whose weight in the merge is 0; a row that sees no key on any block gets 0.
They are counted as ``decode_partial`` and ``decode_merge``.

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
# every count ``launches_by_route`` keeps: the three routes, the decode
# route's combine kernel, and the context-parallel decode's two entries
COUNTED = ROUTES + ("decode_combine", "decode_partial", "decode_merge")
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
EMPTY_M = -1e30   # m of a partial row that sees no key (the kernels' kNegInit)


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
    """The library of ``csrc/<source>.cu`` with its C entry points typed:
    ``flash_attention`` (the f32 FMA kernel), ``flash_prefill`` or
    ``flash_decode`` (and its partials and merge entries)."""
    lib = _build.load(source)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    types = {
        "flash_attention": {"flash_attention_launch": [p, p, p, p, i, i, i, i, i, i, i, i, i, f,
                                                       p]},
        "flash_prefill": {"flash_prefill_launch": [p, p, p, p, i, i, i, i, i, i, i, i, i, f, p]},
        "flash_decode": {
            "flash_decode_launch": [p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, f, i, i, i, i,
                                    i, p],
            "flash_decode_partials_launch": [p, p, p, p, i, i, i, i, i, i, i, i, i, f, i, i, i,
                                             i, i, p],
            "flash_decode_merge_launch": [p, p, i, i, i, i, i, i, i, p]},
    }[source]
    for fn, argtypes in types.items():
        getattr(lib, fn).argtypes = argtypes
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
    flash_attention.launches_by_route = dict.fromkeys(COUNTED, 0)


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



# -- context-parallel decode: partials over one block of the keys, and their merge --------


def partials_cost(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                  window: Optional[int] = None, q_offset: int = 0) -> Tuple[int, int]:
    """``(flops, bytes)`` of ``flash_attention_partials``: the decode
    route's operations over the block's visible keys; q and each visible K
    and V row read once, the partials written once."""
    B, Sq, Hq, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    entries, keys = visible(Sq, Sk, causal, window, q_offset)
    plan = decode_plan(B, Sq, Sk, Hkv, causal=causal, window=window, q_offset=q_offset)
    out = 4 * B * Hkv * plan.n_splits * Sq * (Hq // Hkv) * (2 + hd)
    nbytes = q.numel() * q.element_size() + out + 2 * B * Hkv * hd * k.element_size() * keys
    return 4 * hd * B * Hq * entries, nbytes


def merge_cost(part: torch.Tensor, sq: int, dtype: torch.dtype) -> Tuple[int, int]:
    """``(flops, bytes)`` of ``merge_partials``: 2 operations an element of
    each split's ``acc`` (its weight times it, added), the partials read
    once and o written once."""
    B, Hkv, N, rows, w = part.shape
    out = B * Hkv * rows * (w - 2) * (torch.finfo(dtype).bits // 8)
    return 2 * B * Hkv * N * rows * (w - 2), part.numel() * 4 + out


def flash_attention_partials_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                                   causal: bool = True, window: Optional[int] = None,
                                   q_offset: int = 0) -> torch.Tensor:
    """Plain PyTorch version of ``flash_attention_partials``, in f32, split
    by the same ``decode_plan`` as the kernel: row ``i * rep + j`` of kv
    head ``h`` is query position ``i``'s head ``h * rep + j``."""
    B, Sq, Hq, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    rep = Hq // Hkv
    rows = Sq * rep
    plan = decode_plan(B, Sq, Sk, Hkv, causal=causal, window=window, q_offset=q_offset)
    n, dev = plan.n_splits * plan.chunk, q.device
    idx = plan.k_lo + torch.arange(n, device=dev)
    live = idx < plan.k_hi
    at = idx.clamp(0, max(Sk - 1, 0))
    kk = k.float()[:, at] if Sk else q.new_zeros((B, n, Hkv, hd), dtype=torch.float32)
    vv = v.float()[:, at] if Sk else torch.zeros_like(kk)
    qr = q.float().reshape(B, Sq, Hkv, rep, hd).permute(0, 2, 1, 3, 4).reshape(B, Hkv, rows, hd)
    s = torch.einsum("bhrd,bnhd->bhrn", qr, kk) * (hd ** -0.5 * LOG2E)
    pos = q_offset + torch.arange(rows, device=dev) // rep
    vis = live[None, :].expand(rows, n)
    if causal:
        vis = vis & (idx[None, :] <= pos[:, None])
    if window is not None:
        vis = vis & (idx[None, :] > pos[:, None] - window)
    s = s.masked_fill(~vis, float("-inf")).reshape(B, Hkv, rows, plan.n_splits, plan.chunk)
    m = s.amax(-1)
    m = torch.where(torch.isinf(m), torch.full_like(m, EMPTY_M), m)
    p = torch.exp2(s - m[..., None])                              # 0 where not visible
    l = p.sum(-1)
    acc = torch.einsum("bhrsc,bschd->bhrsd", p,
                       vv.reshape(B, plan.n_splits, plan.chunk, Hkv, hd))
    part = torch.cat([m[..., None], l[..., None], acc], dim=-1)   # [B, Hkv, rows, ns, 2 + hd]
    return part.transpose(2, 3).contiguous()


def merge_partials_plain(part: torch.Tensor, sq: int, dtype: torch.dtype) -> torch.Tensor:
    """Plain PyTorch version of ``merge_partials``: the log-sum-exp merge
    of the splits in f32, 0 where every split's l is 0."""
    B, Hkv, N, rows, w = part.shape
    m, l, acc = part[..., 0], part[..., 1], part[..., 2:]
    wgt = torch.exp2(m - m.amax(2, keepdim=True))
    L = (wgt * l).sum(2)
    A = (wgt[..., None] * acc).sum(2)
    o = torch.where(L[..., None] > 0, A / torch.where(L > 0, L, 1.0)[..., None], 0.0)
    o = o.reshape(B, Hkv, sq, rows // sq, w - 2).permute(0, 2, 1, 3, 4)
    return o.reshape(B, sq, Hkv * (rows // sq), w - 2).to(dtype)


def _count_cp(which: str, flops: int, nbytes: int) -> None:
    with COUNT_LOCK:
        flash_attention.launches += 1
        flash_attention.launches_by_route[which] += 1
    if _oc.ACTIVE is not None:
        _oc.add("flash_attention", which, flops, nbytes)


def _raise_on(err: int, lib, which: str) -> None:
    if err != 0:
        msg = lib.flash_decode_error_string(err).decode()
        raise RuntimeError(f"flash_attention {which} launch failed: CUDA error {err} ({msg})")


def flash_attention_partials(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                             causal: bool = True, window: Optional[int] = None,
                             q_offset: int = 0) -> torch.Tensor:
    """The decode route's f32 partials over the keys ``k``, ``v`` (one
    block of a cache; ``q_offset`` is q's position relative to the block's
    first key, negative where the block lies wholly after it): ``[B, Hkv,
    n_splits, Sq * Hq / Hkv, 2 + hd]`` (the module docstring).  At most
    ``DECODE_ROWS`` rows a kv head.  CUDA tensors launch the split kernel
    (counted ``decode_partial``), CPU tensors take
    ``flash_attention_partials_plain``, meta tensors get an empty output
    of the kernel's shape."""
    _check(q, k, v, window)
    B, Sq, Hq, hd = q.shape
    Hkv = k.shape[2]
    rows = Sq * (Hq // Hkv)
    if rows > DECODE_ROWS:
        raise ValueError(f"flash_attention_partials takes at most {DECODE_ROWS} query rows a kv "
                         f"head; got {Sq} x {Hq // Hkv}")
    dev = q.device
    if dev.type == "cpu":
        return flash_attention_partials_plain(q, k, v, causal=causal, window=window,
                                              q_offset=q_offset)
    _check_kernel(q, k, v)
    plan = decode_plan(B, Sq, k.shape[1], Hkv, causal=causal, window=window, q_offset=q_offset)
    part = torch.empty((B, Hkv, plan.n_splits, rows, 2 + hd), dtype=torch.float32, device=dev)
    if dev.type == "meta":
        if _oc.ACTIVE is not None:
            _oc.add("flash_attention", "decode_partial",
                    *partials_cost(q, k, v, causal=causal, window=window, q_offset=q_offset))
        return part
    if dev.type != "cuda":
        raise ValueError(f"flash_attention_partials runs on the CPU, a CUDA card or the meta "
                         f"device; got {dev}")
    if (q.data_ptr() | k.data_ptr() | v.data_ptr()) % 16:
        raise ValueError("flash_attention kernel takes q, k, v starting on 16-byte boundaries")
    lib = _lib("flash_decode")
    err = launch_on(q, lib.flash_decode_partials_launch, q.data_ptr(), k.data_ptr(),
                    v.data_ptr(), part.data_ptr(), B, Sq, k.shape[1], Hq, Hkv, hd, int(causal),
                    0 if window is None else int(window), int(q_offset), hd ** -0.5 * LOG2E,
                    plan.k_lo, plan.k_hi, plan.chunk, plan.n_splits,
                    int(q.dtype == torch.bfloat16))
    _raise_on(err, lib, "decode_partial")
    _count_cp("decode_partial", *partials_cost(q, k, v, causal=causal, window=window,
                                               q_offset=q_offset))
    return part


def merge_partials(part: torch.Tensor, sq: int, dtype: torch.dtype) -> torch.Tensor:
    """o ``[B, sq, Hq, hd]`` in ``dtype`` (bf16 or f32) from the partials
    ``[B, Hkv, N, rows, 2 + hd]`` of N splits (several blocks'
    ``flash_attention_partials`` concatenated along dim 2), Hq = Hkv *
    rows / sq.  CUDA tensors launch the combine kernel (counted
    ``decode_merge``), CPU tensors take ``merge_partials_plain``, meta
    tensors get an empty output."""
    if part.dim() != 5 or part.dtype != torch.float32 or part.shape[3] % sq:
        raise ValueError(f"merge_partials wants f32 partials [B, Hkv, N, rows, 2 + hd] with rows "
                         f"a multiple of sq = {sq}; got {part.dtype} {tuple(part.shape)}")
    B, Hkv, N, rows, w = part.shape
    dev = part.device
    if dev.type == "cpu":
        return merge_partials_plain(part, sq, dtype)
    if w - 2 not in HEAD_DIMS or dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"merge_partials kernel takes head_dim in {HEAD_DIMS} and a bf16 or f32 "
                         f"output; got {w - 2}, {dtype}")
    o = torch.empty((B, sq, Hkv * (rows // sq), w - 2), dtype=dtype, device=dev)
    if dev.type == "meta":
        if _oc.ACTIVE is not None:
            _oc.add("flash_attention", "decode_merge", *merge_cost(part, sq, dtype))
        return o
    if dev.type != "cuda":
        raise ValueError(f"merge_partials runs on the CPU, a CUDA card or the meta device; "
                         f"got {dev}")
    part = part.contiguous()
    lib = _lib("flash_decode")
    err = launch_on(part, lib.flash_decode_merge_launch, part.data_ptr(), o.data_ptr(), B, sq,
                    Hkv * (rows // sq), Hkv, w - 2, N, int(dtype == torch.bfloat16))
    _raise_on(err, lib, "decode_merge")
    _count_cp("decode_merge", *merge_cost(part, sq, dtype))
    return o


reset_launches()
