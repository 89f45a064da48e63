"""The routed service on the card against the CPU: a small family (two task
streams of two rows each split into two members, a round at home with one
compressed row per member, a stale cross-family compressed row, and a
cross-fuse) gives the CPU's routes and bases, every member lives on the
card, and its fuses move the kernels' launch counters.  Imports neither JAX
nor the JAX package:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_routing_cuda.py

Skips without a card.  Dyadic step sizes keep the f32 fuses and the base
sketches exact on both devices, so routes and distances must agree to 1e-9
and bases to 1e-6; decisions and counters equal."""
import os

import numpy as np
import pytest
import torch

from repro_torch.core.repository import RepositoryFamily
from repro_torch.kernels.cold_fuse import cold_fuse
from repro_torch.kernels.decode_accum import decode_accum
from repro_torch.kernels.row_sketch import row_sketch
from repro_torch.serve.cold_service import AdmissionPolicy, ColdService, ContributorClient

pytestmark = pytest.mark.cuda

W, B, LANE = 2048, 17, 1024


def _pat(t):
    w = torch.ones(W)
    for j in range(W // LANE):
        if (j + t) % 2:
            w[j * LANE:(j + 1) * LANE] = -1.0
    return {"w": w, "b": torch.ones(B)}


def _drain(svc):
    for _ in range(200):
        st = svc.run_once()
        if st["queue_depth"] == 0 and st["staged"] == 0 and not st["inflight"]:
            return st
    raise AssertionError(st)


def _run(root, device):
    fam = RepositoryFamily.create({"w": torch.zeros(W), "b": torch.zeros(B)}, root=root,
                                  device=device, spill=True, screen=False)
    svc = ColdService(family=fam, policy=AdmissionPolicy(min_cohort=2, max_bases=3,
                                                         cross_fuse_every=4))
    for t in range(2):
        for c in range(2):
            ContributorClient(root, f"t{t}c{c}").submit(
                {k: (c + 1) * 0.125 * v for k, v in _pat(t).items()}, weight=1.0,
                base_iteration=0)
    _drain(svc)
    client = ContributorClient(root)
    homes = {t: client.route_of(f"t{t}c0-000000")["family"] for t in (0, 1)}
    for t in range(2):
        base = client.download_base(family=homes[t], device="cpu")
        for c in range(2):
            ContributorClient(root, f"t{t}c{c}").submit(
                {k: base[k] + (c + 1) * 0.25 * _pat(t)[k] for k in base}, weight=1.0,
                base_iteration=1, family=homes[t], compress=c == 1, base=base,
                k_per_block=LANE)
    main = client.download_base(family="main", device="cpu")
    ContributorClient(root, "forger").submit(
        {k: main[k] + 0.375 * _pat(1)[k] for k in main}, weight=1.0, base_iteration=1,
        family="main", compress=True, base=main, k_per_block=LANE)
    st = _drain(svc)
    svc.close()
    bases = {n: m.flat_base_host().numpy() for n, m in fam.members.items()}
    devices = {n: m.flat_base().device.type for n, m in fam.members.items()}
    return st, bases, devices


def test_routed_family_on_the_card_matches_the_cpu(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    st_c, bases_c, _ = _run(str(tmp_path / "cpu"), "cpu")
    before = {k: fn.launches for k, fn in (("cold_fuse", cold_fuse),
                                          ("decode_accum", decode_accum),
                                          ("row_sketch", row_sketch))}
    st_g, bases_g, devices = _run(str(tmp_path / "card"), "cuda")
    moved = {k: fn.launches - before[k] for k, fn in (("cold_fuse", cold_fuse),
                                                     ("decode_accum", decode_accum),
                                                     ("row_sketch", row_sketch))}
    assert devices == {"main": "cuda", "f1": "cuda"}
    # round 0: one dense cohort per member; round 1: a mixed cohort per
    # member (decode_accum); the cross-fuse: one cold_fuse per member;
    # row_sketch: each member's first base sketch and every publish
    assert moved == {"cold_fuse": 4, "decode_accum": 2, "row_sketch": 8}, moved
    ring = lambda st: [(r["id"], r["family"], r["spawned"], r["reason"])  # noqa: E731
                       for r in st["routes"]]
    assert ring(st_g) == ring(st_c)
    for a, b in zip(st_g["routes"], st_c["routes"]):
        assert (a["distance"] is None) == (b["distance"] is None)
        if b["distance"] is not None:
            assert abs(a["distance"] - b["distance"]) <= 1e-9, (a, b)
    for key in ("families_spawned_total", "cross_fuses_total", "rejected_total",
                "fused_queue_submissions"):
        assert st_g[key] == st_c[key], key
    assert st_g["cross_fuses_total"] == 1 and st_g["rejected_total"] == 1
    assert {n: f["iteration"] for n, f in st_g["families"].items()} == {"main": 3, "f1": 3}
    for n in bases_c:
        np.testing.assert_allclose(bases_g[n], bases_c[n], rtol=0, atol=1e-6)
