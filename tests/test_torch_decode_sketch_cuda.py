"""The ``decode_accum`` and ``row_sketch`` CUDA kernels against their plain
PyTorch versions, on the card.  Imports neither JAX nor the JAX package:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_decode_sketch_cuda.py

Each test skips without a card (the kernels have no CPU mode).
Tolerances: ``acc`` |Δ| ≤ 1e-6·max|acc_plain| (the contributors are summed
in the same order, but FMA contraction and the order of duplicate offsets
may move the last bit); ``sq`` relative 1e-5, NaN where the plain version
is NaN; sketch sums |Δ| ≤ 1e-5 · that bucket's Σ|x| (f32 sums in another
order), sums of squares relative 1e-5."""
import numpy as np
import pytest
import torch

from repro_torch.core.repository import Repository
from repro_torch.kernels import decode_accum as tda
from repro_torch.kernels import row_sketch as trs
from repro_torch.utils.flat import LANE


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _payloads(C, N, block, kb, seed, nan_row=None):
    rng = np.random.default_rng(seed)
    nb = -(-N // block)
    idx = rng.integers(0, block, size=(C, nb, kb)).astype(np.int16)
    if kb >= 2:
        idx[:, :, 1] = idx[:, :, 0]  # duplicates add up
    val = rng.integers(-127, 128, size=(C, nb, kb)).astype(np.int8)
    scl = (rng.random((C, nb)) * 1e-2).astype(np.float32)
    w = (rng.random(C) + 0.5).astype(np.float32)
    if nan_row is not None:
        scl[nan_row] = np.nan
        w[nan_row] = 0.0
    return [torch.from_numpy(a) for a in (idx, val, scl, w)]


def assert_decode_close(got, want):
    (acc, sq), (acc_p, sq_p) = got, want
    assert torch.isfinite(acc).all()
    scale = acc_p.abs().max().item()
    assert (acc - acc_p).abs().max().item() <= 1e-6 * max(scale, 1e-30)
    nan, nan_p = torch.isnan(sq), torch.isnan(sq_p)
    assert torch.equal(nan, nan_p)
    rel = ((sq - sq_p).abs() / sq_p.abs().clamp_min(1e-30))[~nan_p]
    assert rel.numel() == 0 or rel.max().item() <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("C,N,block,kb,nan_row", [
    (4, 1_000_000, 1024, 64, None),
    (5, 1_000_003, 1024, 64, 4),       # ragged size, a NaN row of weight 0
    (3, 200_001, 32768, 100, 1),       # the largest block: 128 KB of shared memory
    (1, 70_000, 2048, 2048, None),     # C = 1, every slot
])
def test_decode_accum_matches_plain_on_card(C, N, block, kb, nan_row):
    dev = _card()
    args = [t.to(dev) for t in _payloads(C, N, block, kb, seed=N, nan_row=nan_row)]
    before = tda.decode_accum.launches
    got = tda.decode_accum(*args, size=N, block=block)
    torch.cuda.synchronize()
    assert tda.decode_accum.launches == before + 1
    assert got[0].is_cuda and got[0].shape == (N,) and got[1].shape == (C,)
    assert_decode_close(got, tda.decode_accum_plain(*args, size=N, block=block))


@pytest.mark.cuda
def test_decode_accum_empty_slots_launch_nothing():
    dev = _card()
    args = [t.to(dev) for t in _payloads(3, 5000, 1024, 0, seed=1)]
    before = tda.decode_accum.launches
    acc, sq = tda.decode_accum(*args, size=5000, block=1024)
    assert tda.decode_accum.launches == before
    assert acc.is_cuda and not acc.any() and not sq.any()


@pytest.mark.cuda
def test_cuda_tensors_never_take_the_plain_path(monkeypatch):
    dev = _card()

    def boom(*a, **k):
        raise AssertionError("the plain version ran on a CUDA tensor")

    monkeypatch.setattr(tda, "decode_accum_plain", boom)
    monkeypatch.setattr(trs, "row_sketch_plain", boom)
    args = [t.to(dev) for t in _payloads(2, 5000, 1024, 8, seed=2)]
    tda.decode_accum(*args, size=5000, block=1024)
    trs.row_sketch(torch.ones(5000, device=dev), 7)
    with pytest.raises(TypeError, match="int16"):
        tda.decode_accum(args[0].int(), *args[1:], size=5000, block=1024)


def assert_sketch_close(got, want, x):
    pad = (-x.shape[0]) % LANE
    tiles = torch.cat([x.float().abs(), x.new_zeros(pad, dtype=torch.float32)]).view(-1, LANE)
    nb = got.shape[1]
    abs_sum = torch.zeros(nb, device=x.device).index_add_(
        0, torch.arange(tiles.shape[0], device=x.device) % nb, tiles.sum(1))
    assert ((got[0] - want[0]).abs() <= 1e-5 * abs_sum + 1e-30).all()
    rel = (got[1] - want[1]).abs() / want[1].abs().clamp_min(1e-30)
    assert rel.max().item() <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,n_buckets", [(100, 32), (1024, 1), (1_000_003, 7),
                                         (4_000_000, 32), (70_001, 1000)])
def test_row_sketch_matches_plain_on_card(dtype, N, n_buckets):
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(N)
    x = (torch.randn(N, generator=gen, device=dev) + 0.1).to(dtype)
    before = trs.row_sketch.launches
    got = trs.row_sketch(x, n_buckets)
    torch.cuda.synchronize()
    assert trs.row_sketch.launches == before + 1
    assert got.shape == (2, n_buckets) and got.dtype == torch.float32
    assert_sketch_close(got, trs.row_sketch_plain(x, n_buckets), x)
    # an unaligned view takes the scalar path and gives the same answer
    y = torch.cat([x.new_zeros(1), x])[1:]
    assert_sketch_close(trs.row_sketch(y, n_buckets), trs.row_sketch_plain(y, n_buckets), y)


@pytest.mark.cuda
def test_repository_sketch_and_compressed_fuse_on_card(tmp_path):
    """The service's Repository on the card agrees with the same on the CPU."""
    from repro_torch.serve.cold_service import AdmissionPolicy, ColdService, ContributorClient
    from repro_torch.utils.flat import FlatSpec
    dev = _card()
    rng = np.random.default_rng(0)
    base = {"a": torch.from_numpy(rng.normal(size=(300, 70)).astype(np.float32))}
    spec = FlatSpec.from_tree(base)
    b0 = spec.flatten(base)
    rows = [b0 + torch.from_numpy(0.01 * rng.normal(size=b0.shape).astype(np.float32))
            for _ in range(3)]
    out = []
    for device in ("cpu", dev):
        root = str(tmp_path / str(device))
        repo = Repository({"a": base["a"].to(device)}, root=root, spill=True)
        svc = ColdService(repo, policy=AdmissionPolicy(min_cohort=3, novelty_threshold=0.01))
        for i, r in enumerate(rows):
            # every slot kept: the compressed rows' norms match the dense
            # row's, so the screen admits all three
            ContributorClient(root, f"c{i}").submit(row=r, spec=spec, base_iteration=0,
                                                    compress=i > 0, base=b0, sketch=i != 1,
                                                    k_per_block=LANE)
        for _ in range(3):
            svc.run_once()
        assert repo.iteration == 1 and repo.history[0].n_accepted == 3
        out.append(repo.flat_base_host())
    assert (out[0] - out[1]).abs().max().item() <= 1e-5
