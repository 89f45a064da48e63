"""The lifecycle's device paths on the card against the CPU: the probes'
readout gather on a CUDA row, ``contribute_async``'s ``cold_fuse`` pass,
``rollback`` from disk onto the card, and a gated daemon over
``spill_workers=2``.  Imports neither JAX nor the JAX package:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_lifecycle_cuda.py

Each test skips without a card.  Tolerances: probe scores 1e-6 (the same
gathered values; the loss on the host), bases 2e-5 (f32 fuses that sum in
another order on the card); decisions and counters equal.
"""
import os

import numpy as np
import pytest
import torch

from repro_torch.core.repository import Repository
from repro_torch.kernels.cold_fuse import cold_fuse
from repro_torch.serve.cold_service import AdmissionPolicy, ColdService, ContributorClient
from repro_torch.serve.probes import ProbeSuite, RegressionGate
from repro_torch.utils.flat import FlatSpec
from repro_torch.utils.pytree import tree_map

pytestmark = pytest.mark.cuda


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _tree(seed, shift=0.0):
    rng = np.random.default_rng(seed)
    return {"a": torch.from_numpy(rng.normal(size=(64, 33)).astype(np.float32) + shift),
            "b": torch.from_numpy(rng.normal(size=(1000,)).astype(np.float32) + shift)}


def test_probe_gather_on_the_card_matches_the_host():
    dev = _card()
    row = torch.from_numpy(np.random.default_rng(0).normal(size=5000).astype(np.float32))
    probes = ProbeSuite(5000, seed=0)
    host, card = probes.score(row), probes.score(row.to(dev))
    np.testing.assert_allclose([card[k] for k in host], list(host.values()), rtol=0, atol=1e-6)
    bf = row.to(torch.bfloat16)
    assert probes.score(bf.to(dev)) == probes.score(bf)


def test_contribute_async_and_rollback_on_the_card(tmp_path):
    dev = _card()
    out = {}
    for name, where in (("cpu", "cpu"), ("card", dev)):
        on = lambda t: tree_map(lambda x: x.to(where), t)
        repo = Repository(on(_tree(0)), root=str(tmp_path / name), screen=True)
        launches = cold_fuse.launches
        rec = repo.contribute_async(on(_tree(1, 0.1)))
        repo.contribute_async(on(_tree(2, 0.2)), alpha=0.25)
        if name == "card":
            assert cold_fuse.launches == launches + 2
        row1 = repo.flat_base_host()
        repo.rollback(1)
        assert repo.flat_base().device.type == torch.device(where).type
        out[name] = (rec.op, repo.iteration, row1, repo.flat_base_host())
    assert out["cpu"][:2] == out["card"][:2] == ("async-damped(1.000)", 1)
    torch.testing.assert_close(out["card"][3], out["cpu"][3], rtol=0, atol=2e-5)


def test_gated_daemon_with_spill_workers_on_the_card(tmp_path):
    dev = _card()
    results = {}
    for name, where in (("cpu", "cpu"), ("card", dev)):
        root = str(tmp_path / name)
        base = _tree(0)
        repo = Repository(tree_map(lambda x: x.to(where), base), root=root, spill=True,
                          spill_workers=2)
        spec = FlatSpec.from_tree(base)
        svc = ColdService(repo, policy=AdmissionPolicy(min_cohort=3, compact_keep_bases=2),
                          gate=RegressionGate(ProbeSuite(spec.size, seed=0)))
        rng = np.random.default_rng(3)
        states = []
        for rnd, scale in enumerate((0.01, 10.0, 0.01)):
            b = repo.flat_base_host()
            client = ContributorClient(root, f"r{rnd}")
            for _ in range(3):
                noise = torch.from_numpy(rng.normal(size=spec.size).astype(np.float32))
                client.submit(row=b + scale * noise, spec=spec, base_iteration=repo.iteration)
            for _ in range(20):
                st = svc.run_once()
                if st["staged"] == 0 and st["queue_depth"] == 0 and not st["inflight"]:
                    break
            states.append((st["iteration"], st["quarantined_total"], st["rollbacks_total"],
                           st["last_gate"]["ok"]))
        svc.close()
        results[name] = (states, sorted(os.listdir(os.path.join(root, "quarantine"))),
                         repo.flat_base_host())
    assert results["card"][:2] == results["cpu"][:2]
    assert results["card"][0] == [(1, 0, 0, True), (1, 3, 1, False), (2, 3, 1, True)]
    torch.testing.assert_close(results["card"][2], results["cpu"][2], rtol=0, atol=2e-5)
