"""The ``cold_fuse`` CUDA kernel against its plain PyTorch version, on the
card.  Imports neither JAX nor the JAX package, so it also runs where only
PyTorch is installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cold_fuse_cuda.py

Each test skips without a card (the kernel has no CPU mode).  Tolerances:
fused to 2e-5 in f32 and to 1 bf16 ulp in bf16 (the kernel sums the K rows
in another order than the plain version, so the f32 result may round the
other way), sq_diff to rtol 1e-3 (partial sums over up to 1M terms in
another order).
"""
import numpy as np
import pytest
import torch

from repro_torch.core.repository import Repository
from repro_torch.kernels import cold_fuse as tcf
from repro_torch.utils.flat import FlatSpec
from repro_torch.utils.pytree import tree_map


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(K, N, dtype, nan_row=None, seed=4):
    rng = np.random.default_rng(seed)
    base = torch.from_numpy(rng.normal(size=(N,)).astype(np.float32))
    contribs = torch.from_numpy(rng.normal(size=(K, N)).astype(np.float32))
    w = torch.from_numpy((rng.uniform(size=(K,)) + 0.05).astype(np.float32))
    if nan_row is not None:
        contribs[nan_row] = float("nan")
        w[nan_row] = 0.0
    return base.to(dtype), contribs.to(dtype), w


def _assert_fused_close(got, want):
    g, w = got.float().cpu(), want.float().cpu()
    assert torch.isfinite(g).all()
    err = (g - w).abs()
    if got.dtype == torch.float32:
        assert err.max().item() <= 2e-5
    else:
        ulp = torch.exp2(torch.floor(torch.log2(torch.maximum(g.abs(), w.abs())
                                                .clamp_min(2.0 ** -126))) - 7)
        assert bool((err <= ulp).all()), err.max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K,N", [(1, 1), (5, 1 << 20), (3, 1_000_003), (64, 70_001), (9, 4096)])
def test_kernel_matches_plain_on_card(dtype, K, N):
    dev = _card()
    base, contribs, w = (t.to(dev) for t in _inputs(K, N, dtype, nan_row=1 if K > 2 else None))
    before = tcf.cold_fuse.launches
    f_k, sq_k = tcf.cold_fuse(base, contribs, w, 0.3)
    torch.cuda.synchronize()
    assert tcf.cold_fuse.launches == before + 1
    assert f_k.dtype == dtype and f_k.is_cuda and sq_k.dtype == torch.float32
    f_p, sq_p = tcf.cold_fuse_plain(base, contribs, w, 0.3)
    _assert_fused_close(f_k, f_p)
    np.testing.assert_allclose(sq_k.cpu().numpy(), sq_p.cpu().numpy(), rtol=1e-3)


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take():
    dev = _card()
    base, contribs, w = (t.to(dev) for t in _inputs(65, 256, torch.float32))
    with pytest.raises(ValueError, match="at most 64"):
        tcf.cold_fuse(base, contribs, w)
    with pytest.raises(ValueError, match="contiguous"):
        tcf.cold_fuse(base, contribs[:3].t().contiguous().t(), w[:3])
    with pytest.raises(ValueError, match="one device"):
        tcf.cold_fuse(base.cpu(), contribs[:3], w[:3])


@pytest.mark.cuda
def test_repository_on_card_matches_cpu():
    dev = _card()
    rng = np.random.default_rng(0)
    body = {"a": torch.from_numpy(rng.normal(size=(300, 7)).astype(np.float32)),
            "b": {"c": torch.from_numpy(rng.normal(size=(33,)).astype(np.float32))}}
    ups = [tree_map(lambda v: v + 0.01 * torch.randn_like(v), body) for _ in range(3)]
    ups.append(tree_map(lambda v: torch.full_like(v, float("nan")), body))
    rows = []
    for device in ("cpu", dev):
        repo = Repository(tree_map(lambda v: v.to(device), body))
        for u in ups:
            repo.upload(tree_map(lambda v: v.to(device), u))
        rec = repo.fuse_pending()
        assert (rec.n_accepted, rec.n_contributions) == (3, 4)
        pub = repo.download()
        rows.append(FlatSpec.from_tree(pub).flatten(pub).cpu())
    assert (rows[0] - rows[1]).abs().max().item() <= 1e-5
