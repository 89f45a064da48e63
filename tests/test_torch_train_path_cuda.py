"""The training path and the per-leaf fuses on the card against the same
calls on the CPU (whose results ``test_torch_train_path`` and
``test_torch_screen_fusion`` hold against the JAX package).  Imports
neither JAX nor the JAX package:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_train_path_cuda.py

Each test skips without a card.  Tolerances: ``fisher_weighted`` and
``ties`` to 1e-6 in f32 and 1 bf16 ulp in bf16 (the same operations in the
same order; ``ties``' threshold is a selection, exact on both); each Fisher
leaf to 1e-4 × its max |F| (the card's f32 matmuls sum in another order);
the first pretraining loss to rtol 1e-5 (no update has run yet).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import TINY
from repro_torch.core import Repository, fusion
from repro_torch.data.synthetic import SyntheticSuite
from repro_torch.models import encoder as E
from repro_torch.train import compute_fisher, train_multitask
from repro_torch.train.pretrain import _pretrain_from
from repro_torch.utils.pytree import tree_leaves, tree_leaves_with_path, tree_map

SEQ = 24
CFG = dataclasses.replace(TINY, d_model=64, num_heads=2, num_kv_heads=2, head_dim=32,
                          d_ff=128, vocab_size=256, max_seq_len=SEQ + 8)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _suite():
    return SyntheticSuite(vocab_size=256, num_tasks=16, seed=0, noise=0.15)


def _body(seed=0, dtype=torch.float32):
    body = E.init_encoder_body(CFG, torch.Generator().manual_seed(seed), device="cpu")
    return tree_map(lambda x: x.to(dtype), body)


def _on(tree, device):
    return tree_map(lambda x: x.to(device), tree)


def _cohort(dtype, n=3):
    base = _body(0, dtype)
    gen = torch.Generator().manual_seed(1)
    models = [tree_map(lambda x: (x.float() + 0.01 * torch.randn(x.shape, generator=gen)
                                  ).to(dtype), base) for _ in range(n)]
    return base, models


def _assert_close(got, want, dtype):
    for (k, g), (_, w) in zip(tree_leaves_with_path(got), tree_leaves_with_path(want)):
        g, w = g.cpu().float(), w.float()
        if dtype == torch.bfloat16:
            ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(2.0 ** -126))) - 7)
            assert bool(((g - w).abs() <= ulp).all()), k
        else:
            assert (g - w).abs().max().item() <= 1e-6, k


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_per_leaf_fuses_card_match_cpu(dtype):
    dev = _card()
    base, models = _cohort(dtype)
    gen = torch.Generator().manual_seed(2)
    fishers = [tree_map(lambda x: torch.rand(x.shape, generator=gen), base) for _ in models]
    for density in (0.2, 1.0):
        _assert_close(fusion.ties(_on(base, dev), [_on(m, dev) for m in models],
                                  density=density, lam=0.5),
                      fusion.ties(base, models, density=density, lam=0.5), dtype)
    _assert_close(fusion.fisher_weighted([_on(m, dev) for m in models],
                                         [_on(f, dev) for f in fishers]),
                  fusion.fisher_weighted(models, fishers), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["fisher", "ties"])
def test_per_leaf_repository_card_matches_cpu(op):
    dev = _card()
    base, models = _cohort(torch.bfloat16, n=4)
    gen = torch.Generator().manual_seed(3)
    fishers = [tree_map(lambda x: torch.rand(x.shape, generator=gen), base) for _ in models]
    models.append(tree_map(lambda x: torch.full_like(x, float("nan")), base))
    fishers.append(fishers[0])
    bases = []
    for d in ("cpu", dev):
        repo = Repository(_on(base, d), fusion_op=op)
        for m, f in zip(models, fishers):
            repo.upload(_on(m, d), _on(f, d))
        rec = repo.fuse_pending()
        assert (rec.n_accepted, rec.n_contributions, repo.use_flat) == (4, 5, False)
        bases.append(repo.download())
    _assert_close(bases[1], bases[0], torch.bfloat16)


@pytest.mark.cuda
def test_compute_fisher_card_matches_cpu():
    dev = _card()
    suite = _suite()
    d = suite.dataset(0, 40, 8, SEQ)
    body = _body(1)
    head = E.init_cls_head(CFG, torch.Generator().manual_seed(5), 4, device="cpu")
    kw = dict(batches_n=8, batch_size=8, seed=3)  # 5 batches exist
    want = compute_fisher(CFG, body, head, d["x_train"], d["y_train"], device="cpu", **kw)
    got = compute_fisher(CFG, _on(body, dev), _on(head, dev), d["x_train"], d["y_train"],
                         device=dev, **kw)
    for (k, g), (_, w) in zip(tree_leaves_with_path(got), tree_leaves_with_path(want)):
        assert g.device.type == dev.type and g.dtype == torch.float32, k
        tol = 1e-4 * w.abs().max().item()
        assert (g.cpu() - w).abs().max().item() <= tol, k


@pytest.mark.cuda
def test_pretrain_and_multitask_run_on_the_card():
    dev = _card()
    suite = _suite()
    body = _body(2)
    kw = dict(steps=3, batch_size=16, seq_len=SEQ, lr=2e-3, seed=0)
    cpu_body, cpu_m = _pretrain_from(CFG, suite, body, **kw)
    card_body, card_m = _pretrain_from(CFG, suite, _on(body, dev), **kw)
    np.testing.assert_allclose(card_m["loss"][0], cpu_m["loss"][0], rtol=1e-5)
    assert np.isfinite(card_m["loss"]).all()
    assert all(x.device.type == dev.type and bool(torch.isfinite(x).all())
               for x in tree_leaves(card_body))
    data = []
    for tid in (0, 1):
        dd = suite.dataset(tid, 32, 8, SEQ)
        data.append((tid, dd["x_train"], dd["y_train"], suite.tasks[tid].num_classes))
    mt_body, heads = train_multitask(CFG, card_body, data, steps=4, batch_size=8, device=dev)
    assert sorted(heads) == [0, 1]
    for tree in [mt_body, *heads.values()]:
        assert all(x.device.type == dev.type and bool(torch.isfinite(x).all())
                   for x in tree_leaves(tree))
