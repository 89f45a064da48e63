"""The sharded ops on an 8-shard mesh of the card (every shard on the cards
there are, round-robin) against their plain versions on an 8-shard CPU
mesh, and the ``row_sketch_shard`` kernel against ``row_sketch_shard_plain``.
Imports neither JAX nor the JAX package:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_mesh_cuda.py

Each test skips without a card (the kernels have no CPU mode).
Tolerances: the sharded fused row equals the unsharded ``cold_fuse``
kernel's bit for bit (the fuse is elementwise); against the plain version
atol 1e-5 in f32 and 1 bf16 ulp; ``sq_diff`` rtol 1e-5; sketches within
1e-5 of each bucket's sum of |x| (or x²)."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import cold_fuse as tcf
from repro_torch.kernels import decode_accum as tda
from repro_torch.kernels import ops
from repro_torch.kernels import row_sketch as trs
from repro_torch.launch import mesh as tmesh
from repro_torch.utils import flat as tflat


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _ulp(x):
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126))) - 7)


@pytest.mark.cuda
@pytest.mark.parametrize("N,dtype", [(200_000, torch.float32), (1_300_001, torch.bfloat16)])
def test_fuse_flat_sharded_on_the_card(N, dtype):
    dev = _card()
    rng = np.random.default_rng(N)
    base = torch.from_numpy(rng.normal(size=N).astype(np.float32)).to(dtype)
    stage = (base.float()[None] + 0.01 * torch.from_numpy(
        rng.normal(size=(4, N)).astype(np.float32))).to(dtype)
    stage[1] = float("nan")
    w = torch.tensor([1.0, 0.0, 2.0, 0.5])
    ss = tflat.ShardedFlatSpec.for_size(N, 8)
    gpu, cpu = (tmesh.make_mesh((8,), ("model",), device=d) for d in ("cuda", "cpu"))
    for alpha in (1.0, 0.3):
        before = tcf.cold_fuse.launches
        tmesh.reset_collectives()
        fg, sqg = ops.fuse_flat_sharded(ss.shard_slices(base.to(dev)), ss.shard(stage.to(dev)),
                                        w, alpha, mesh=gpu, axes="model")
        assert tcf.cold_fuse.launches - before == 8
        assert tmesh.collectives == {"all_reduce": 1, "all_gather": 0, "reduce_scatter": 0}
        fc, sqc = ops.fuse_flat_sharded(ss.shard_slices(base), ss.shard(stage), w, alpha,
                                        mesh=cpu, axes="model")
        whole, sqw = tcf.cold_fuse(base.to(dev), stage.to(dev), w.to(dev), alpha)
        got = ss.unshard(torch.stack([f.cpu() for f in fg]))
        assert torch.equal(got, whole.cpu())  # elementwise: the same bits
        want = ss.unshard(torch.stack(fc)).float().numpy()
        if dtype == torch.bfloat16:
            assert np.all(np.abs(got.float().numpy() - want) <= _ulp(want))
        else:
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
        np.testing.assert_allclose(sqg.cpu().numpy(), sqc.numpy(), rtol=1e-5)
        np.testing.assert_allclose(sqg.cpu().numpy(), sqw.cpu().numpy(), rtol=1e-5)


@pytest.mark.cuda
def test_fuse_flat_compressed_sharded_on_the_card():
    dev = _card()
    N = 1_000_000
    rng = np.random.default_rng(1)
    base = rng.normal(size=N).astype(np.float32)
    ss = tflat.ShardedFlatSpec.for_size(N, 8)
    rows = [base + 0.01 * rng.normal(size=N).astype(np.float32) for _ in range(3)]
    pays = [tflat.delta_encode_sharded(r, base, ss, k_per_block=32) for r in rows]
    stack = {f: torch.from_numpy(np.stack([[getattr(p, f) for p in pl] for pl in pays]))
             for f in ("indices", "values", "scales")}
    wc = torch.tensor([1.0, 2.0, 0.5])
    dense = ss.shard(torch.from_numpy(np.stack(rows[:2])))
    gpu, cpu = (tmesh.make_mesh((8,), ("model",), device=d) for d in ("cuda", "cpu"))
    for kw in ({}, dict(dense=dense, dense_weights=torch.tensor([1.0, 3.0]))):
        before = tda.decode_accum.launches
        tmesh.reset_collectives()
        fg, sqg = ops.fuse_flat_compressed_sharded(
            ss.shard_slices(torch.from_numpy(base).to(dev)), stack["indices"], stack["values"],
            stack["scales"], wc, 0.5, mesh=gpu, axes="model", block=1024, **kw)
        assert tda.decode_accum.launches - before == 8
        assert tmesh.collectives == {"all_reduce": 1, "all_gather": 0, "reduce_scatter": 0}
        fc, sqc = ops.fuse_flat_compressed_sharded(
            ss.shard_slices(torch.from_numpy(base)), stack["indices"], stack["values"],
            stack["scales"], wc, 0.5, mesh=cpu, axes="model", block=1024, **kw)
        np.testing.assert_allclose(torch.stack([f.cpu() for f in fg]).numpy(),
                                   torch.stack(fc).numpy(), rtol=0, atol=1e-5)
        np.testing.assert_allclose(sqg.cpu().numpy(), sqc.numpy(), rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("N,n_shards,block,dtype", [
    (200_000, 8, None, torch.float32), (200_000, 8, None, torch.bfloat16),
    (5_000_000, 8, 3 * 1024, torch.float32), (30_000, 3, None, torch.bfloat16)])
def test_row_sketch_shard_kernel_matches_its_plain_version(N, n_shards, block, dtype):
    dev = _card()
    ss = tflat.ShardedFlatSpec.for_size(N, n_shards, block)
    x = torch.from_numpy(np.random.default_rng(N).normal(size=N).astype(np.float32)).to(dtype)
    for s, sl in enumerate(ss.shard_slices(x)):
        before = trs.row_sketch_shard.launches
        got = trs.row_sketch_shard(sl.to(dev), s, n_shards, ss.block).cpu().numpy()
        assert trs.row_sketch_shard.launches - before == 1
        want = trs.row_sketch_shard_plain(sl, s, n_shards, ss.block).numpy()
        t = sl.float().view(-1, 1024)
        mag = np.array([[t.abs().sum().item()], [(t * t).sum().item()]])
        assert np.all(np.abs(got - want) <= 1e-5 * mag)
    mesh = tmesh.make_mesh((n_shards,), ("model",), device="cuda")
    whole = trs.row_sketch(x.to(dev)).cpu().numpy()
    shard = ops.row_sketch_sharded(ss.shard_slices(x.to(dev)), mesh=mesh, axes="model",
                                   block=ss.block).cpu().numpy()
    t = torch.cat([x.float(), torch.zeros((-N) % 1024)]).view(-1, 1024)
    b = torch.arange(t.shape[0]) % 32
    mag = np.stack([torch.zeros(32).index_add_(0, b, t.abs().sum(1)).numpy(),
                    torch.zeros(32).index_add_(0, b, (t * t).sum(1)).numpy()])
    assert np.all(np.abs(shard - whole) <= 1e-5 * mag)
