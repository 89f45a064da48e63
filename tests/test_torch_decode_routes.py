"""The partition and summation order of the port's ``decode_accum`` CUDA
kernel, modelled in plain PyTorch on the CPU.

``kernel_model`` repeats what ``csrc/decode_accum.cu`` adds in what order:
the grid of ``partition(nb, slots)``, each block's contiguous range of
codec blocks dealt to its warps in steps of G (``layout``'s codec blocks a
warp adds at once); in a codec block's slice the rows added in the order
c = 0..C-1 (weight exactly 0 left out) and a row's slots in order, repeated
offsets too; a row's sum of squares as scale²
times the exact integer sum of its values², added per warp, group and
contributor in step order, in double; a block's warps and groups in order,
and the blocks' partials over the grid by 32 lanes in stride, then a
butterfly.  The model is held
against the JAX package's ``repro.kernels.ref.decode_accum`` and the port's
``decode_accum_plain`` on the same numpy payloads.

Tolerances, as on the card (``tests/test_torch_decode_sketch_cuda.py``):
``acc`` |Δ| ≤ 1e-6·max|acc| (the model adds in the kernel's order, but the
kernel may contract a multiply and add into an FMA, and the references add
a row's repeated offsets in an order ``index_add_`` does not promise);
``sq`` relative 1e-5, NaN where the reference is NaN (the reference sums
f32 squares of rounded products; the kernel exact integers times scale²).

    python tests/test_torch_decode_routes.py   # prints the model's max diffs
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import decode_accum as tda


def _butterfly(x):
    """x [..., 32] summed over its last axis as lanes do with ``v +=
    __shfl_xor_sync(v, m)`` for m = 16, 8, 4, 2, 1; lane 0's sum."""
    for m in (16, 8, 4, 2, 1):
        x = x + x[..., torch.arange(32) ^ m]
    return x[..., 0]


def _seq_sum(x):
    """x [..., n] f64 summed left to right (0 for n = 0)."""
    if x.shape[-1] == 0:
        return torch.zeros(x.shape[:-1], dtype=torch.float64)
    return torch.cumsum(x, dim=-1)[..., -1]


def kernel_model(idx, val, scl, w, *, size, block, slots, warps):
    """(acc [size] f32, sq [C] f32) in the kernel's order of sums."""
    C, nb, kb = idx.shape
    grid, per = tda.partition(nb, slots)
    d = val.float() * scl[..., None]                                    # [C, nb, kb]

    acc = torch.zeros(nb * block)
    pos = torch.arange(nb) * block
    off = idx.long()
    for c in range(C):  # every element takes its adds row by row, slot by slot
        if w[c] != 0:
            x = w[c] * d[c]
            for j in range(kb):  # one slot: one position in each codec block
                keep = (off[c, :, j] >= 0) & (off[c, :, j] < block)
                at = pos[keep] + off[c, keep, j]
                acc[at] = acc[at] + x[keep, j]

    # a row's squares: scale² times the exact integer sum of its values²
    vsq = (val.long() ** 2).sum(-1).double()                           # [C, nb]
    row = scl.double() ** 2 * vsq

    G = tda.layout(kb, 0, 0)[1]
    blocks = torch.zeros(grid, C, dtype=torch.float64)
    for g in range(grid):
        b0, b1 = g * per, min(nb, (g + 1) * per)
        t = torch.zeros(C, dtype=torch.float64)
        for v in range(warps):  # warp v's steps: G codec blocks from b0 + (v + k·warps)·G
            for grp in range(G):  # group grp takes the step's codec block grp
                t = t + _seq_sum(row[:, b0 + v * G + grp:b1:warps * G])
        blocks[g] = t
    tail = torch.zeros(C, 32, dtype=torch.float64)
    for g in range(grid):  # the last block: lane g % 32 adds block g
        tail[:, g % 32] += blocks[g]
    return acc[:size], _butterfly(tail).float()


def _payloads(C, N, block, kb, seed, nan_row=None, pad_slots=0, high_offsets=False):
    rng = np.random.default_rng(seed)
    nb = -(-N // block)
    idx = rng.integers(0, block, size=(C, nb, kb)).astype(np.int16)
    if kb >= 2:
        idx[:, :, 1] = idx[:, :, 0]          # duplicate offsets add up
    val = rng.integers(-127, 128, size=(C, nb, kb)).astype(np.int8)
    if pad_slots:
        idx[:, :, -pad_slots:] = 0           # padding slots (0, 0) add zero
        val[:, :, -pad_slots:] = 0
    if high_offsets:                         # the last codec block's tail past size
        idx[:, -1, :] = rng.integers(block - 64, block, size=(C, kb))
    scl = (rng.random((C, nb)) * 1e-2).astype(np.float32)
    w = (rng.random(C) + 0.5).astype(np.float32)
    if nan_row is not None:
        scl[nan_row] = np.nan
        w[nan_row] = 0.0
    return idx, val, scl, w


CASES = {
    # name: (C, N, block, kb, payload options, slots, warps)
    "service_shape_small": (4, 40_000, 1024, 64, {}, 7, 8),
    "nan_row_weight_0": (5, 30_001, 1024, 64, {"nan_row": 4}, 3, 8),
    "padding_slots": (3, 20_000, 1024, 64, {"pad_slots": 9}, 2, 4),
    "past_size": (2, 9_000, 1024, 64, {"high_offsets": True}, 5, 3),
    "c1": (1, 50_000, 1024, 64, {}, 4, 8),
    "c64": (64, 6_000, 1024, 64, {"nan_row": 17}, 2, 8),
    "kb1": (3, 12_345, 1024, 1, {}, 4, 8),
    "kb2048": (2, 9_000, 2048, 2048, {}, 3, 2),
    "kb100_masked": (3, 11_000, 1024, 100, {"nan_row": 0}, 50, 8),
    "kb128": (5, 30_000, 1024, 128, {"nan_row": 1}, 3, 3),
    "kb512_rounds": (2, 20_000, 1024, 512, {}, 2, 5),
    "block32768": (3, 70_001, 32768, 100, {}, 1, 1),
}


@pytest.mark.parametrize("name", list(CASES))
def test_kernel_model_matches_reference(name):
    C, N, block, kb, opts, slots, warps = CASES[name]
    idx, val, scl, w = _payloads(C, N, block, kb, seed=C * N + kb, **opts)
    dv = val.astype(np.float32) * scl[..., None]
    want_acc, want_sq = (np.asarray(x) for x in jref.decode_accum(
        jnp.asarray(idx, jnp.int32), jnp.asarray(dv), jnp.asarray(w), size=N, block=block))
    t = [torch.from_numpy(a) for a in (idx, val, scl, w)]
    acc, sq = kernel_model(*t, size=N, block=block, slots=slots, warps=warps)
    plain_acc, plain_sq = tda.decode_accum_plain(*t, size=N, block=block)
    assert acc.shape == (N,) and sq.shape == (C,)
    assert bool(torch.isfinite(acc).all())
    for ref_acc, ref_sq in ((want_acc, want_sq), (plain_acc.numpy(), plain_sq.numpy())):
        scale = max(float(np.abs(ref_acc).max()), 1e-30)
        assert float(np.abs(acc.numpy() - ref_acc).max()) <= 1e-6 * scale
        nan = np.isnan(ref_sq)
        np.testing.assert_array_equal(np.isnan(sq.numpy()), nan)
        np.testing.assert_allclose(sq.numpy()[~nan], ref_sq[~nan], rtol=1e-5, atol=0)


@pytest.mark.parametrize("nb", [1, 7, 1000, 121_065])
@pytest.mark.parametrize("slots", [1, 5, 924, 5000])
def test_partition_covers_every_codec_block_once(nb, slots):
    grid, per = tda.partition(nb, slots)
    assert 1 <= grid <= max(1, min(nb, slots))
    seen = torch.zeros(nb, dtype=torch.int64)
    for g in range(grid):
        b0, b1 = g * per, min(nb, (g + 1) * per)
        assert b1 > b0  # no block of the grid is idle
        seen[b0:b1] += 1
    assert bool((seen == 1).all())


@pytest.mark.parametrize("kb,idx_ptr,val_ptr,want", [
    (64, 0, 0, (4, 2)), (64, 8, 4, (4, 2)), (64, 16, 0, (4, 2)), (64, 4, 4, (1, 1)),
    (64, 8, 2, (1, 1)), (256, 0, 0, (1, 1)), (2048, 256, 8, (1, 1)), (512, 16, 8, (1, 1)),
    (256, 8, 0, (1, 1)), (256, 0, 4, (1, 1)), (128, 0, 0, (1, 1)), (384, 0, 0, (1, 1)),
    (100, 0, 0, (1, 1)), (32, 0, 0, (1, 1)), (1, 0, 0, (1, 1)), (65, 0, 0, (1, 1)),
])
def test_layout(kb, idx_ptr, val_ptr, want):
    assert tda.layout(kb, idx_ptr, val_ptr) == want


if __name__ == "__main__":
    for name, (C, N, block, kb, opts, slots, warps) in CASES.items():
        idx, val, scl, w = (torch.from_numpy(a) for a in
                            _payloads(C, N, block, kb, seed=C * N + kb, **opts))
        acc, sq = kernel_model(idx, val, scl, w, size=N, block=block, slots=slots, warps=warps)
        pa, ps = tda.decode_accum_plain(idx, val, scl, w, size=N, block=block)
        ok = ~torch.isnan(ps)
        print(f"{name}: acc max|d| {(acc - pa).abs().max().item():.3g} "
              f"(max|acc| {pa.abs().max().item():.3g}), sq max rel "
              f"{((sq - ps).abs() / ps.abs())[ok].max().item():.3g}")
