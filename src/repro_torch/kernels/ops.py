"""Public kernel entry points (port of the single-device part of
``repro.kernels.ops``).  The kernel is chosen by the tensors' device inside
each wrapper (``cold_fuse``, ``decode_accum``, ``row_sketch``,
``flash_attention``, ``rwkv6_scan``): CUDA runs the hand-written kernel,
the CPU its plain version."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.cold_fuse import cold_fuse
from repro_torch.kernels.decode_accum import decode_accum
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.row_sketch import row_sketch as _row_sketch
from repro_torch.kernels.rwkv6_scan import rwkv6_scan
from repro_torch.utils.flat import SKETCH_BUCKETS, FlatSpec, StagedBuffer

RWKV_LOGW_FLOOR = -4.0  # the TPU kernel's contract (see repro.kernels.rwkv6_scan)


def fuse_flat(base, contribs, weights, alpha: float = 1.0,
              *, donate: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused repository update over flat rows: returns ``(fused [N],
    sq_diff [K])`` from one read of the staged ``[K, N]`` operand (a tensor
    or a ``StagedBuffer``).  ``donate=True`` says the caller gives the
    staged buffer up: nothing here keeps a reference to it after the launch
    (the output is a fresh tensor; no storage is aliased yet)."""
    del donate  # the launch holds the only reference this function takes
    if isinstance(contribs, StagedBuffer):
        contribs = contribs.data
    return cold_fuse(base, contribs, weights, alpha)


def fuse_pytrees(base_tree, contrib_trees, weights=None, alpha: float = 1.0,
                 *, spec: Optional[FlatSpec] = None, donate: bool = False):
    """Fuse whole trees in ONE launch: flatten each into a row, stack to
    ``[K, N]``, fuse.  Returns ``(fused_tree, sq_diff [K])``."""
    if spec is None:
        spec = FlatSpec.from_tree(base_tree)
    base_flat = spec.flatten(base_tree)
    K = len(contrib_trees)
    if weights is None:
        w = torch.ones((K,), dtype=torch.float32, device=base_flat.device)
    else:
        w = torch.as_tensor(weights, dtype=torch.float32, device=base_flat.device)
    stage = torch.stack([spec.flatten(t) for t in contrib_trees])
    fused, sq = fuse_flat(base_flat, stage, w, alpha, donate=donate)
    return spec.unflatten(fused), sq


# ---------------------------------------------------------------------------
# compressed fuse — screen + fuse directly over delta-compressed
# contributions.  A compressed contribution is θ_c = base + Δ_c, so
#
#     fused = base + α·[(Σ_d w_d θ_d + (Σ_c w_c)·base + Σ_c w_c Δ_c)/Σw − base]
#
# and the only dense quantity the compressed side needs is the one
# accumulator Σ_c w_c Δ_c, never one [N] row per contributor; the screen
# statistic ‖Δ_c‖² comes straight from the payload.  ``decode_accum``
# produces both in one pass.
# ---------------------------------------------------------------------------


def _compressed_combine(base, acc, comp_weights, sq_comp, dense, dense_weights, alpha):
    """Finish the compressed fuse from the decoded accumulator: one
    normalisation over dense + compressed weights, zero-weight rows masked
    on the dense side, sq ordered (dense..., compressed...).  Plain PyTorch,
    as in the JAX package; writes nothing into ``base`` (the published row
    is the next fuse's base)."""
    bf = base.float()
    wd = dense_weights.float()
    wc = comp_weights.float()
    w_tot = torch.sum(wd) + torch.sum(wc)
    df = dense.float()
    masked = torch.where((wd == 0.0)[:, None], 0.0, df)
    num = torch.einsum("k,kn->n", wd, masked) + torch.sum(wc) * bf + acc
    fused = (bf + alpha * (num / w_tot - bf)).to(base.dtype)
    sq_dense = torch.sum(torch.square(df - bf[None, :]), dim=1)
    return fused, torch.cat([sq_dense, sq_comp])


def fuse_flat_compressed(base: torch.Tensor, indices, values, scales, comp_weights,
                         alpha: float = 1.0, *, block: int, dense=None,
                         dense_weights=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused repository update consuming compressed contributions directly:
    returns ``(fused [N], sq_diff [K+C])``, dense contributions first.  With
    exact payloads this equals ``fuse_flat(base, stack(dense + decoded), w)``."""
    N = int(base.shape[0])
    dev = base.device
    wc = torch.as_tensor(comp_weights, dtype=torch.float32).to(dev)
    acc, sq_comp = decode_accum(indices, values, scales, wc, size=N, block=block)
    if dense is None:
        dense = torch.zeros((0, N), dtype=base.dtype, device=dev)
        dense_weights = torch.zeros((0,), dtype=torch.float32, device=dev)
    if isinstance(dense, StagedBuffer):
        dense = dense.data
    wd = torch.as_tensor(dense_weights, dtype=torch.float32).to(dev)
    return _compressed_combine(base, acc, wc, sq_comp, dense, wd, float(alpha))


def row_sketch(row: torch.Tensor, n_buckets: int = SKETCH_BUCKETS) -> torch.Tensor:
    """Content sketch of one flat ``[N]`` row: ``[2, n_buckets]`` f32 of
    tile-bucketed sums and sums of squares, in one read of the row.  The
    host logic that screens with it is ``utils.flat.CohortSketch``."""
    return _row_sketch(row, n_buckets)


def attention(q, k, v, *, causal: bool = True, window: Optional[int] = None, q_offset: int = 0,
              block_q: int = 128, block_k: int = 128) -> torch.Tensor:
    """Blocked attention (GQA, causal, sliding window).  ``block_q`` and
    ``block_k`` are the TPU kernel's tile sizes, kept for the reference's
    signature; the CUDA kernels pick their own tiles, by route
    (``flash_attention.route``)."""
    del block_q, block_k
    return flash_attention(q, k, v, causal=causal, window=window, q_offset=q_offset)


def rwkv6_mix(r, k, v, logw, u, s0, *, chunk: int = 16) -> Tuple[torch.Tensor, torch.Tensor]:
    """RWKV6 recurrence with ``logw`` clamped to ``[RWKV_LOGW_FLOOR, 0]``,
    as the reference's wrapper clamps it to its chunked kernel's contract.
    ``chunk`` is that kernel's chunk length, kept for the signature; the
    CUDA kernel is sequential and needs no chunking."""
    del chunk
    return rwkv6_scan(r, k, v, torch.clamp(logw, RWKV_LOGW_FLOOR, 0.0), u, s0)
