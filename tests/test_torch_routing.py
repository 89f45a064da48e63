"""Similarity routing over a base family in the port, against the JAX
package's: ``FamilyRouter`` decisions on the same sketches, ``RepositoryFamily``
create/spawn/cross_fuse on the same f32 trees, family roots crossing between
the packages, one routed queue drained by both packages' daemons, and the
port twins of ``tests/test_routing.py``.

Tolerances: router scores and distances at rtol 1e-12 (both are float64
numpy on the same sketches); member bases within 1e-6 of the reference's
and of the closed form (f32 fuses that sum in another order); routes-ring
distances within 1e-9.  Decisions, reasons and counters must be equal."""
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.checkpoint import io as jio
from repro.core.repository import Repository as JRepository
from repro.core.repository import RepositoryFamily as JFamily
from repro.serve import cold_service as jcs
from repro.utils import flat as jflat
from repro_torch.checkpoint import io as tio
from repro_torch.core import FAMILY_DIR, family_member_root
from repro_torch.core.repository import Repository as TRepository
from repro_torch.core.repository import RepositoryFamily as TFamily
from repro_torch.serve import cold_service as tcs
from repro_torch.serve.probes import ProbeSuite, RegressionGate
from repro_torch.utils import flat as tflat
from repro_torch.utils.flat import LANE, FlatSpec, delta_encode

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, B = 2048, 17  # the reference tests' tree: two full LANE tiles on w


def _pat(t, mod=2):
    """Task t's direction (``tests/test_routing.py``): constant per LANE
    tile, so the sketch's bucket sums keep it."""
    w = np.ones((W,), np.float32)
    for j in range(W // LANE):
        if (j + t) % mod == (0 if mod == 3 else 1):
            w[j * LANE:(j + 1) * LANE] = -1.0
    return {"w": w, "b": np.ones((B,), np.float32)}


def _zeros():
    return {"w": np.zeros((W,), np.float32), "b": np.zeros((B,), np.float32)}


def _t(tree):
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in tree.items()}


def _fam(root, **kw):
    kw.setdefault("screen", False)
    kw.setdefault("spill", True)
    return TFamily.create(_t(_zeros()), root=str(root), device="cpu", **kw)


def _svc(root, **pol):
    pol.setdefault("min_cohort", 2)
    pol.setdefault("max_bases", 3)
    return tcs.ColdService(family=_fam(root), policy=tcs.AdmissionPolicy(**pol))


def _drain(svc, max_cycles=200):
    for _ in range(max_cycles):
        st = svc.run_once()
        if st["queue_depth"] == 0 and st["staged"] == 0 and not st["inflight"]:
            return st
    raise AssertionError(f"service did not drain in {max_cycles} cycles: {st}")


def _member_base(root, name, iteration):
    bb = tio.load(os.path.join(family_member_root(str(root), name),
                               f"base_iter{iteration:04d}.npz"))
    return {k: v.numpy() for k, v in bb.items()}


def _match_members(root, st, tasks, want_w, *, mod=2):
    """Which member's base is the closed-form fuse of task t's stream (names
    follow arrival order, so no test assumes main is task 0)."""
    matched = {}
    for t in range(tasks):
        want = {k: want_w * v for k, v in _pat(t, mod=mod).items()}
        hits = [n for n, f in st["families"].items()
                if all(np.allclose(_member_base(root, n, f["iteration"])[k], want[k],
                                   rtol=0, atol=1e-6) for k in want)]
        assert len(hits) == 1, (t, hits, sorted(st["families"]))
        matched[t] = hits[0]
    assert len(set(matched.values())) == tasks, matched
    return matched


def _submit_round(root, t, c, r, home="main", base=None):
    delta = (c + 1) * 0.1 * (r + 1)
    pat = _pat(t)
    if base is None:
        base = _zeros()
    fin = {k: np.asarray(base[k]) + delta * pat[k] for k in pat}
    return tcs.ContributorClient(root, name=f"t{t}c{c}").submit(
        _t(fin), weight=1.0, base_iteration=r, family=home)


# ---------------------------------------------------------------------------
# FamilyRouter: the reference's decisions and scores
# ---------------------------------------------------------------------------


def _sketch_json(rng, size, *, deltas=True, entries=3):
    base = np.stack([rng.normal(size=32), np.abs(rng.normal(size=32)) * 50 + 1])
    ents = []
    for i in range(entries):
        d = rng.normal(size=32)
        sk = base.copy()
        sk[0] += d
        ents.append({"id": f"e{i}", "file": f"e{i}.npz", "sketch": sk.tolist(),
                     "delta": d.tolist() if deltas else None})
    return {"size": size, "n_buckets": 32, "window": 8, "base": base.tolist(),
            "base_iteration": 3, "bases": {"2": (base * 0.9).tolist(), "3": base.tolist()},
            "entries": ents}


def _route_both(meta, query, **kw):
    split = kw.pop("split_threshold", 0.8)
    max_bases = kw.pop("max_bases", 4)
    out = []
    for flat in (jflat, tflat):
        sketches = {n: flat.CohortSketch.from_json(m) for n, m in meta.items()}
        router = flat.FamilyRouter(split_threshold=split, max_bases=max_bases)
        out.append(router.route(query, sketches, **kw))
    return out


def _same_decision(j, t):
    assert (t.family, t.spawn, t.reason) == (j.family, j.spawn, j.reason)
    if j.distance is None:
        assert t.distance is None
    else:
        np.testing.assert_allclose(t.distance, j.distance, rtol=1e-12, atol=0)
    assert sorted(t.scores) == sorted(j.scores)
    for n in j.scores:
        np.testing.assert_allclose(t.scores[n], j.scores[n], rtol=1e-12, atol=0)
    if j.delta is None:
        assert t.delta is None
    else:
        np.testing.assert_allclose(t.delta, j.delta, rtol=1e-12, atol=0)


@pytest.mark.parametrize("case", ["near", "far", "far_at_cap", "vintage", "bootstrap",
                                  "on_base", "no_base", "tie"])
@pytest.mark.parametrize("seed", range(3))
def test_router_matches_reference_on_seeded_sketches(case, seed):
    rng = np.random.default_rng(seed)
    size = 100_000
    meta = {n: _sketch_json(rng, size, deltas=case != "bootstrap") for n in ("main", "f1")}
    base = np.asarray(meta["main"]["base"])
    kw = {"declared": "main"}
    if case == "near":
        query = np.asarray(meta["f1"]["entries"][1]["sketch"]) + 1e-3
        query[0] += np.asarray(meta["main"]["base"])[0] - np.asarray(meta["f1"]["base"])[0]
    elif case in ("far", "far_at_cap"):
        query = base.copy()
        query[0] += 40.0 * rng.normal(size=32)
        kw["max_bases"] = 2 if case == "far_at_cap" else 4
        kw["split_threshold"] = 0.5
    elif case == "vintage":
        query = np.asarray(meta["main"]["bases"]["2"]).copy()
        query[0] += np.asarray(meta["main"]["entries"][0]["delta"])
        kw["base_iteration"] = 2
    elif case == "bootstrap":
        query = base + rng.normal(size=(2, 32))
    elif case == "on_base":
        query = base.copy()
    elif case == "no_base":
        meta["f1"]["base"], meta["f1"]["bases"] = None, {}
        query = base + rng.normal(size=(2, 32))
        kw["declared"] = "f1"
    else:  # two members with the same evidence: the declared one wins
        meta["f1"] = json.loads(json.dumps(meta["main"]))
        query = np.asarray(meta["main"]["entries"][0]["sketch"]) + 1e-3
        kw["declared"] = "f1"
    j, t = _route_both(meta, query, **kw)
    _same_decision(j, t)
    want = {"far": (None, True), "far_at_cap": ("main", False), "bootstrap": ("main", False),
            "on_base": ("main", False), "no_base": ("f1", False), "tie": ("f1", False)}
    if case in want:
        assert (t.family, t.spawn) == want[case], t


def test_router_matches_reference_on_pattern_rows():
    """Sketches of ``_pat`` rows (via ``row_sketch_host`` in each package):
    the same decisions, and two tasks' deltas exactly opposite."""
    spec = FlatSpec.from_tree(_t(_zeros()))
    rows = {(t, c): spec.flatten(_t({k: (c + 1) * 0.1 * v for k, v in _pat(t).items()}))
            for t in range(2) for c in range(2)}
    sks = {}
    for name, flat in (("j", jflat), ("t", tflat)):
        sk = {"main": flat.CohortSketch(spec.size), "f1": flat.CohortSketch(spec.size)}
        zero = flat.row_sketch_host(np.zeros(spec.size, np.float32))
        for s in sk.values():
            s.set_base(zero, iteration=0)
        s0 = flat.row_sketch_host(rows[(0, 0)].numpy())
        sk["main"].add("a", s0, delta=s0[0] - zero[0])
        sks[name] = sk
    np.testing.assert_array_equal(tflat.row_sketch_host(rows[(1, 1)].numpy()),
                                  jflat.row_sketch_host(rows[(1, 1)].numpy()))
    for key, row in rows.items():
        q = tflat.row_sketch_host(row.numpy())
        for max_bases in (2, 3):
            j = jflat.FamilyRouter(max_bases=max_bases).route(q, sks["j"], declared="main",
                                                              base_iteration=0)
            t = tflat.FamilyRouter(max_bases=max_bases).route(q, sks["t"], declared="main",
                                                              base_iteration=0)
            _same_decision(j, t)
            if key[0] == 1 and max_bases == 3:
                assert t.spawn and t.distance >= 1.0, t
            if key[0] == 0:
                assert t.family == "main" and t.distance < 0.6, t


def test_router_rejects_bad_arguments():
    with pytest.raises(ValueError, match="split_threshold"):
        tflat.FamilyRouter(split_threshold=0.0)
    with pytest.raises(KeyError, match="unknown declared family"):
        tflat.FamilyRouter().route(np.zeros((2, 32)), {"main": tflat.CohortSketch(10)},
                                   declared="nope")


# ---------------------------------------------------------------------------
# RepositoryFamily: parity, closed form, files
# ---------------------------------------------------------------------------


def _families(tmp_path):
    """The same family in both packages: main fused toward task 0, f1
    spawned from main's iteration-0 base and fused toward task 1, f2
    spawned from main's current base and fused toward task 0 at 3x."""
    out = {}
    for name, make, tree in (("j", JFamily.create, lambda x: x),
                             ("t", lambda b, **kw: TFamily.create(b, device="cpu", **kw), _t)):
        fam = make(tree(_zeros()), root=str(tmp_path / name), screen=False, spill=True)
        for member, t, s in (("main", 0, 0.2), (None, 1, 0.4), (None, 0, 0.6)):
            if member is None:  # f1 from main's iteration 0, f2 from its current base
                member = fam.spawn(seed_iteration=0 if t == 1 else None)
            fam.members[member].upload(tree({k: s * v for k, v in _pat(t).items()}))
            fam.members[member].fuse_pending()
        out[name] = fam
    return out


def _flat_np(repo):
    return np.asarray(repo.flat_base_host(), np.float32).copy() if isinstance(
        repo, JRepository) else repo.flat_base_host().float().numpy()


@pytest.mark.parametrize("alpha", [1.0, 0.5])
def test_family_matches_reference_and_closed_form(tmp_path, alpha):
    fams = _families(tmp_path)
    spec = FlatSpec.from_tree(_t(_zeros()))
    pre = {n: spec.flatten(_t({k: s * v for k, v in _pat(t).items()})).numpy()
           for n, t, s in (("main", 0, 0.2), ("f1", 1, 0.4), ("f2", 0, 0.6))}
    for n in ("main", "f1", "f2"):
        np.testing.assert_allclose(_flat_np(fams["t"].members[n]), pre[n], rtol=0, atol=1e-6)
    recs = {k: f.cross_fuse(alpha=alpha) for k, f in fams.items()}
    assert sorted(recs["t"]) == sorted(recs["j"]) == ["f1", "f2", "main"]
    mean = np.mean([pre[n] for n in pre], axis=0)
    for n in ("main", "f1", "f2"):
        rt, rj = recs["t"][n], recs["j"][n]
        assert (rt.op, rt.n_contributions, rt.n_accepted) == (rj.op, rj.n_contributions,
                                                              rj.n_accepted)
        assert rt.op == f"cross_fuse(alpha={alpha:g})" and rt.n_contributions == 2
        got = _flat_np(fams["t"].members[n])
        np.testing.assert_allclose(got, _flat_np(fams["j"].members[n]), rtol=0, atol=1e-6)
        # closed form: halfway (alpha 0.5) or all the way (1.0) to the mean
        np.testing.assert_allclose(got, pre[n] + alpha * (mean - pre[n]), rtol=0, atol=1e-6)
        assert fams["t"].members[n].iteration == 2
    man = {k: tio.load_json(os.path.join(str(tmp_path / k), "repository.json"))["families"]
           for k in ("j", "t")}
    assert sorted(man["t"]) == sorted(man["j"]) == ["f1", "f2", "main"]
    for n in man["j"]:
        assert sorted(man["t"][n]) == sorted(man["j"][n])
        for key in ("root", "seeded_from", "seed_iteration"):
            assert man["t"][n].get(key) == man["j"][n].get(key), (n, key)
    assert man["t"]["f1"]["seed_iteration"] == 0 and man["t"]["f2"]["seed_iteration"] == 1
    assert man["t"]["f1"]["root"] == f"{FAMILY_DIR}/f1"


def test_cross_fuse_never_writes_the_snapshots_or_the_operand(tmp_path):
    """cross_fuse is simultaneous: no member's publish writes into a
    pre-cross base a later member's operand reads; ``fuse_pending(buffer=)``
    never writes into the caller's operand; the overrides need buffer=."""
    fam = _fam(tmp_path / "F")
    fam.spawn()
    fam.spawn()
    for s, n in ((0.2, "main"), (0.5, "f1"), (-0.3, "f2")):
        fam.members[n].upload(_t({k: s * v for k, v in _pat(0).items()}))
        fam.members[n].fuse_pending()
    pre = {n: fam.members[n].flat_base() for n in fam.members}
    copies = {n: b.clone() for n, b in pre.items()}
    fam.cross_fuse()
    for n in pre:
        torch.testing.assert_close(pre[n], copies[n], rtol=0, atol=0)
    mean = torch.stack(list(copies.values())).mean(0)
    for m in fam.members.values():
        torch.testing.assert_close(m.flat_base(), mean, rtol=0, atol=1e-6)
    main = fam.members["main"]
    operand = torch.stack([copies["f1"], copies["f2"]])
    held = operand.clone()
    pf = main.fuse_pending(buffer=operand, wait=False, alpha=0.25, screen=False, op="probe")
    assert main.inflight and not pf.done
    rec = main.flush()
    assert rec.op == "probe" and main.iteration == 3
    torch.testing.assert_close(operand, held, rtol=0, atol=0)
    with pytest.raises(ValueError, match="require buffer="):
        main.fuse_pending(alpha=0.5)
    with pytest.raises(ValueError, match="does not match the flat layout"):
        main.fuse_pending(buffer=torch.zeros((1, 7)))


def test_spawned_member_lands_on_the_family_device(tmp_path):
    """A spawned member takes ``member_kw``'s device (the seed npz loads to
    the CPU by default); without a card, create without device= raises."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TFamily.create(_t(_zeros()), root=str(tmp_path / "X"))
    fam = _fam(tmp_path / "F")
    assert fam.member_kw["device"] == torch.device("cpu")
    name = fam.spawn()
    assert fam.members[name].device == fam.members["main"].device == torch.device("cpu")
    reopened = TFamily.open(str(tmp_path / "F"), device="cpu")
    assert reopened.members[name].device == torch.device("cpu")


def test_spawn_adopts_a_persisted_member_and_survives_compaction(tmp_path):
    """A member persisted by a spawn that crashed before its manifest entry
    is adopted by the next spawn of that name; a vintage compacted away
    seeds from the source's current base."""
    fam = _fam(tmp_path / "F")
    main = fam.members["main"]
    for s in (0.1, 0.2):
        main.upload(_t({k: s * v for k, v in _pat(0).items()}))
        main.fuse_pending()
    main.compact(keep_bases=1)
    assert not os.path.exists(os.path.join(str(tmp_path / "F"), "base_iter0000.npz"))
    name = fam.spawn(seed_iteration=0)
    assert fam._meta[name]["seed_iteration"] == 2
    np.testing.assert_array_equal(_flat_np(fam.members[name]), _flat_np(main))
    # a member directory without a manifest entry (the post_family_spawn window)
    TRepository(_t({k: 0.7 * v for k, v in _pat(1).items()}),
                root=family_member_root(str(tmp_path / "F"), "f2"), spill=True)
    assert fam.spawn() == "f2"
    np.testing.assert_allclose(_member_base(tmp_path / "F", "f2", 0)["w"], 0.7 * _pat(1)["w"])
    assert sorted(TFamily.open(str(tmp_path / "F"), device="cpu").members) == ["f1", "f2",
                                                                              "main"]


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_family_root_crosses_packages(tmp_path, writer):
    """A family root written by either package opens in the other, members
    and bases intact; a single-base root migrates in place in both."""
    root = str(tmp_path / "F")
    if writer == "reference":
        fam = JFamily.create(_zeros(), root=root, screen=False, spill=True)
        tree = lambda x: x  # noqa: E731
    else:
        fam = _fam(root)
        tree = _t
    name = fam.spawn()
    fam.members[name].upload(tree({k: 0.3 * v for k, v in _pat(1).items()}))
    fam.members[name].fuse_pending()
    other = (TFamily.open(root, device="cpu", spill=True) if writer == "reference"
             else JFamily.open(root, spill=True))
    assert sorted(other.members) == ["f1", "main"]
    assert other.members["f1"].iteration == 1 and other.members["main"].iteration == 0
    np.testing.assert_allclose(_flat_np(other.members["f1"]), _flat_np(fam.members["f1"]),
                               rtol=0, atol=1e-6)
    assert other.members["f1"].family_name == "f1"
    other.spawn()  # the other package extends the same manifest
    again = (JFamily.open(root, spill=True) if writer == "reference"
             else TFamily.open(root, device="cpu", spill=True))
    assert sorted(again.members) == ["f1", "f2", "main"]
    # single-base roots migrate in place
    single = str(tmp_path / "S")
    if writer == "reference":
        JRepository(_zeros(), root=single, spill=True, screen=False)
        mig = TFamily.open(single, device="cpu", spill=True)
    else:
        TRepository(_t(_zeros()), root=single, spill=True, screen=False)
        mig = JFamily.open(single, spill=True)
    assert list(mig.members) == ["main"] and mig.members["main"].root == single
    assert tio.load_json(os.path.join(single, "repository.json"))["families"] == {
        "main": {"root": "."}}


# ---------------------------------------------------------------------------
# one routed queue, two daemons
# ---------------------------------------------------------------------------


def _copy_queue(src_root, dst_root):
    src, dst = os.path.join(src_root, "queue"), os.path.join(dst_root, "queue")
    for fn in os.listdir(src):
        if fn.endswith(".npz") and not os.path.exists(os.path.join(dst, fn)):
            shutil.copy(os.path.join(src, fn), os.path.join(dst, fn))


def _jdrain(svc):
    for _ in range(200):
        st = svc.run_once()
        if st["queue_depth"] == 0 and st["staged"] == 0 and not st["inflight"]:
            return st
    raise AssertionError(st)


def _routed_view(st):
    fams = {n: (f["iteration"], f["fuses"], f["fused_contributions"])
            for n, f in st["families"].items()}
    keys = ("iteration", "fused_queue_submissions", "rejected_total", "fuses",
            "fused_contributions", "families_spawned_total", "cross_fuses_total")
    return {"families": fams, **{k: st[k] for k in keys},
            "rejects": [r["file"] for r in st["recent_rejects"]]}


def _same_routes(rt, rj):
    assert [(r["id"], r["family"], r["spawned"], r["reason"]) for r in rt] == [
        (r["id"], r["family"], r["spawned"], r["reason"]) for r in rj]
    for a, b in zip(rt, rj):
        if b["distance"] is None:
            assert a["distance"] is None
        else:
            assert abs(a["distance"] - b["distance"]) <= 1e-9, (a, b)


def test_one_routed_queue_drained_by_both_packages(tmp_path):
    """Dyadic step sizes (1/8, 1/4, ...) keep both packages' f32 fuses and
    base sketches exact, so the routes ring's distances agree to 1e-9."""
    A, Bp = str(tmp_path / "A"), str(tmp_path / "B")
    JFamily.create(_zeros(), root=A, screen=False, spill=True)
    shutil.copytree(A, Bp)
    pol = dict(min_cohort=2, max_bases=3, cross_fuse_every=4)
    jsvc = jcs.ColdService(family=JFamily.open(A, spill=True),
                           policy=jcs.AdmissionPolicy(**pol))
    tsvc = tcs.ColdService(family=TFamily.open(Bp, device="cpu", spill=True),
                           policy=tcs.AdmissionPolicy(**pol))
    spec = jflat.FlatSpec.from_tree(_zeros())
    # round 0: two streams declared against main
    for t in range(2):
        for c in range(2):
            fin = {k: (c + 1) * 0.125 * v for k, v in _pat(t).items()}
            jcs.ContributorClient(A, f"t{t}c{c}").submit(fin, weight=1.0, base_iteration=0)
    _copy_queue(A, Bp)
    sj, st = _jdrain(jsvc), _drain(tsvc)
    assert _routed_view(st) == _routed_view(sj)
    _same_routes(st["routes"], sj["routes"])
    homes = {t: tcs.ContributorClient(Bp).route_of(f"t{t}c0-000000")["family"] for t in (0, 1)}
    assert homes[0] != homes[1]
    # round 1: each stream at home, one row compressed; a cross-family
    # compressed row declared against main is rejected stale
    for t in range(2):
        home = homes[t]
        base = {k: np.asarray(v) for k, v in jio.load(os.path.join(
            family_member_root(A, home), "base_iter0001.npz"), as_jax=False).items()}
        for c in range(2):
            fin = {k: base[k] + (c + 1) * 0.25 * _pat(t)[k] for k in base}
            jcs.ContributorClient(A, f"t{t}c{c}").submit(
                fin, weight=1.0, base_iteration=1, family=home, compress=c == 1, base=base,
                k_per_block=LANE)
    other = homes[1] if homes[0] == "main" else homes[0]
    task = 1 if homes[0] == "main" else 0
    main_base = {k: np.asarray(v) for k, v in jio.load(
        os.path.join(A, "base_iter0001.npz"), as_jax=False).items()}
    fin = {k: main_base[k] + 0.375 * _pat(task)[k] for k in main_base}
    jcs.ContributorClient(A, "forger").submit(fin, weight=1.0, base_iteration=1, family="main",
                                              compress=True, base=main_base,
                                              k_per_block=LANE)
    assert other != "main"
    _copy_queue(A, Bp)
    sj, st = _jdrain(jsvc), _drain(tsvc)
    assert _routed_view(st) == _routed_view(sj)
    _same_routes(st["routes"], sj["routes"])
    assert st["cross_fuses_total"] == 1
    assert [r["file"] for r in st["recent_rejects"]] == ["forger-000000.npz"]
    assert st["recent_rejects"][0]["reason"].startswith("stale: delta encoded against family")
    for n, f in st["families"].items():
        assert f["iteration"] == 3
        np.testing.assert_allclose(
            _flat_np(tsvc._lanes[n].repo), _flat_np(jsvc._lanes[n].repo), rtol=0, atol=1e-6)
    qj = jio.load_json(os.path.join(A, "queue", "queue_manifest.json"))
    qt = tio.load_json(os.path.join(Bp, "queue", "queue_manifest.json"))
    for k in ("fused_total", "rejected_total", "families_spawned_total", "cross_fuses_total",
              "cross_counter"):
        assert qt[k] == qj[k], k
    for svc in (jsvc, tsvc):
        svc.close()


# ---------------------------------------------------------------------------
# port twins of the reference's routing tests
# ---------------------------------------------------------------------------


def test_two_streams_separate_closed_form(tmp_path):
    root = str(tmp_path / "repo")
    svc = _svc(root)
    for t in range(2):
        for c in range(2):
            _submit_round(root, t, c, 0)
    st = _drain(svc)
    assert sorted(st["families"]) == ["f1", "main"]
    assert st["families_spawned_total"] == 1
    for f in st["families"].values():
        assert f["iteration"] == 1 and f["fused_contributions"] == 2
    matched = _match_members(root, st, 2, 0.15)
    for t in range(2):
        home = matched[t]
        base = _member_base(root, home, 1)
        for c in range(2):
            _submit_round(root, t, c, 1, home=home, base=base)
    st = _drain(svc)
    assert sorted(st["families"]) == ["f1", "main"]
    for f in st["families"].values():
        assert f["iteration"] == 2 and f["fused_contributions"] == 4
    assert _match_members(root, st, 2, 0.45) == matched
    svc.close()


def test_routes_ring_and_route_of(tmp_path):
    root = str(tmp_path / "repo")
    svc = _svc(root)
    subs = [_submit_round(root, t, c, 0) for t in range(2) for c in range(2)]
    st = _drain(svc)
    routes = {r["id"]: r for r in st["routes"]}
    assert set(routes) == set(subs)
    assert "bootstrap" in routes[subs[0]]["reason"]
    assert sum(1 for r in routes.values() if r["spawned"]) == 1
    client = tcs.ContributorClient(root)
    for sub in subs:
        r = client.route_of(sub)
        assert r is not None and r["family"] in st["families"]
    assert client.route_of("nobody-000000") is None
    assert routes[subs[0]]["family"] == routes[subs[1]]["family"]
    assert routes[subs[2]]["family"] == routes[subs[3]]["family"]
    assert routes[subs[0]]["family"] != routes[subs[2]]["family"]
    # the client's family view: iterations, waits and downloads by member
    home = routes[subs[2]]["family"]
    assert client.family_iteration(home) == 1 and client.family_iteration("f9") == 0
    assert client.wait_for_family(home, 1, timeout=1.0)["families"][home]["iteration"] == 1
    with pytest.raises(TimeoutError, match="family 'f9'"):
        client.wait_for_family("f9", 1, timeout=0.05)
    got = client.download_base(family=home, device="cpu")
    np.testing.assert_allclose(got["w"].numpy(), 0.15 * _pat(1)["w"], rtol=0, atol=1e-6)
    svc.close()


def test_spawn_cap_routes_to_nearest(tmp_path):
    root = str(tmp_path / "repo")
    svc = _svc(root, min_cohort=1, max_bases=2)
    for t in range(3):
        for c in range(2):
            _submit_round(root, t, c, 0)
    st = _drain(svc)
    assert len(st["families"]) == 2
    assert st["families_spawned_total"] == 1
    assert sum(f["fused_contributions"] for f in st["families"].values()) == 6
    assert st["rejected_total"] == 0
    svc.close()


def test_unknown_declared_family_is_malformed(tmp_path):
    root = str(tmp_path / "repo")
    svc = _svc(root, min_cohort=1)
    tcs.ContributorClient(root, name="c0").submit(
        _t({k: 0.1 * v for k, v in _pat(0).items()}), base_iteration=0, family="nope")
    st = _drain(svc)
    assert st["rejected_total"] == 1
    assert "unknown family" in st["recent_rejects"][0]["reason"]
    assert st["fused_contributions"] == 0
    svc.close()


def _two_member_family(root, svc):
    for t in range(2):
        for c in range(2):
            _submit_round(root, t, c, 0)
    st = _drain(svc)
    assert len(st["families"]) == 2
    return _match_members(root, st, 2, 0.15)


def test_compressed_cross_family_route_is_stale_reject(tmp_path):
    root = str(tmp_path / "repo")
    svc = _svc(root)
    matched = _two_member_family(root, svc)
    a = matched[0]
    base_a = _member_base(root, a, 1)
    fin = {k: base_a[k] + 0.3 * _pat(1)[k] for k in base_a}
    sub = tcs.ContributorClient(root, name="forger").submit(
        _t(fin), weight=1.0, base_iteration=svc._lanes[a].repo.iteration, compress=True,
        base=_t(base_a), family=a)
    st = _drain(svc)
    rej = [r for r in st["recent_rejects"] if r["file"] == sub + ".npz"]
    assert len(rej) == 1, st["recent_rejects"]
    assert "stale" in rej[0]["reason"] and a in rej[0]["reason"]
    for f in st["families"].values():
        assert f["iteration"] == 1 and f["fused_contributions"] == 2
    svc.close()


def test_compressed_spawn_decision_is_stale_reject(tmp_path):
    root = str(tmp_path / "repo")
    svc = _svc(root, min_cohort=1)
    _submit_round(root, 0, 0, 0)
    st = _drain(svc)
    assert st["families_spawned_total"] == 0
    base = _member_base(root, "main", 1)
    fin = {k: base[k] + 0.3 * _pat(1)[k] for k in base}
    sub = tcs.ContributorClient(root, name="forger").submit(
        _t(fin), weight=1.0, base_iteration=1, compress=True, base=_t(base), family="main")
    st = _drain(svc)
    rej = [r for r in st["recent_rejects"] if r["file"] == sub + ".npz"]
    assert len(rej) == 1 and "stale" in rej[0]["reason"]
    assert rej[0]["reason"].endswith("pinned to its declared member's base")
    assert st["families_spawned_total"] == 0
    assert len(st["families"]) == 1
    svc.close()


def test_ingest_spilled_cross_family_backstop(tmp_path):
    root = str(tmp_path / "repo")
    fam = _fam(root)
    fam.spawn(name="f1")
    main = fam.members["main"]
    spec = FlatSpec.from_tree(_t(_zeros()))
    base = np.zeros((spec.size,), np.float32)
    row = 0.1 * spec.flatten(_t(_pat(0))).numpy()
    pay = delta_encode(row, base, k_per_block=LANE)
    path = os.path.join(root, tcs.QUEUE_DIR, "forged.npz")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tio.save_flat_delta(path, pay, spec, extra={
        "id": "x-000000", "base_iteration": 0, "family": "f1"})
    with pytest.raises(ValueError, match="stale.*family 'f1'"):
        main.ingest_spilled(path, weight=1.0)
    assert main.n_staged == 0
    moved = os.path.join(family_member_root(root, "f1"), tcs.QUEUE_DIR, "forged.npz")
    tio.move_atomic(path, moved)
    fam.members["f1"].ingest_spilled(moved, weight=1.0)
    manifest = tio.load_json(os.path.join(family_member_root(root, "f1"),
                                          "staging_manifest.json"))
    assert manifest["entries"][0]["family"] == "f1"


def test_gate_trip_quarantines_only_one_member(tmp_path):
    root = str(tmp_path / "repo")
    fam = _fam(root)
    size = FlatSpec.from_tree(_t(_zeros())).size
    svc = tcs.ColdService(family=fam, policy=tcs.AdmissionPolicy(min_cohort=2, max_bases=2),
                          gate=RegressionGate(ProbeSuite(size, seed=0), tolerance=0.5))
    matched = _two_member_family(root, svc)
    victim, bystander = matched[0], matched[1]
    pre_victim = _member_base(root, victim, 1)
    pre_bystander = _member_base(root, bystander, 1)
    for j in range(2):
        fin = {k: pre_victim[k] + (40.0 + j) * _pat(0)[k] for k in pre_victim}
        tcs.ContributorClient(root, name=f"bad{j}").submit(
            _t(fin), weight=1.0, base_iteration=1, family=victim)
    st = _drain(svc)
    assert st["rollbacks_total"] == 1
    assert st["quarantined_total"] == 2
    vf, bf = st["families"][victim], st["families"][bystander]
    assert vf["iteration"] == 1 and vf["last_gate"]["regressed"]
    np.testing.assert_allclose(_member_base(root, victim, 1)["w"], pre_victim["w"], atol=1e-6)
    assert bf["iteration"] == 1 and bf["fused_contributions"] == 2
    assert bf["last_gate"] is None or not bf["last_gate"]["regressed"]
    np.testing.assert_allclose(_member_base(root, bystander, 1)["w"], pre_bystander["w"],
                               atol=1e-6)
    # per-member gate state files
    for n in (victim, bystander):
        gs = tio.load_json(os.path.join(family_member_root(root, n), "gate_state.json"))
        assert gs["iteration"] == 1
    svc.close()


def test_cross_fuse_every_blends_members_closed_form(tmp_path):
    root = str(tmp_path / "repo")
    svc = _svc(root, cross_fuse_every=2)
    for t in range(2):
        for c in range(2):
            _submit_round(root, t, c, 0)
    st = _drain(svc)
    assert st["cross_fuses_total"] == 1
    assert len(st["families"]) == 2
    pre = {n: _member_base(root, n, 1) for n in st["families"]}
    for t in range(2):
        want = {k: 0.15 * v for k, v in _pat(t).items()}
        assert sum(all(np.allclose(pre[n][k], want[k], atol=1e-6) for k in want)
                   for n in pre) == 1
    mean = {k: np.mean([bb[k] for bb in pre.values()], axis=0) for k in ("w", "b")}
    for n, f in st["families"].items():
        assert f["iteration"] == 2
        got = _member_base(root, n, 2)
        for k in mean:
            np.testing.assert_allclose(got[k], mean[k], atol=1e-6)
    qman = tio.load_json(os.path.join(root, "queue", "queue_manifest.json"))
    assert qman["cross_fuses_total"] == 1 and qman["cross_counter"] == 0
    events = [r["event"] for r in tio.read_jsonl(os.path.join(root, "metrics.jsonl"))]
    assert events.count("family_spawn") == 1 and events.count("cross_fuse") == 1
    svc.close()


@pytest.mark.parametrize("seed", range(6))
def test_mixed_task_interleavings_never_cross_contaminate(tmp_path, seed):
    rng = np.random.default_rng(seed)
    root = str(tmp_path / "repo")
    svc = _svc(root, min_cohort=2, max_bases=3)
    subs = [(t, c) for t in range(3) for c in range(2)]
    rng.shuffle(subs)
    for t, c in subs:
        fin = {k: (c + 1) * 0.1 * v for k, v in _pat(t, mod=3).items()}
        tcs.ContributorClient(root, name=f"t{t}c{c}").submit(
            _t(fin), weight=1.0, base_iteration=0, family="main")
        for _ in range(int(rng.integers(0, 3))):
            svc.run_once()
    st = _drain(svc)
    assert len(st["families"]) == 3
    assert st["families_spawned_total"] == 2
    for f in st["families"].values():
        assert f["iteration"] == 1 and f["fused_contributions"] == 2
    _match_members(root, st, 3, 0.15, mod=3)
    svc.close()


def test_single_base_layout_migrates_in_place(tmp_path):
    root = str(tmp_path / "repo")
    TRepository(_t(_zeros()), root=root, spill=True, screen=False)
    fam = TFamily.open(root, device="cpu", spill=True)
    assert list(fam.members) == ["main"]
    assert fam.members["main"].root == root
    svc = tcs.ColdService(family=fam, policy=tcs.AdmissionPolicy(min_cohort=1, max_bases=2))
    _submit_round(root, 0, 0, 0)
    st = _drain(svc)
    assert st["families"]["main"]["iteration"] == 1
    svc.close()


def test_launcher_routes_a_tiny_root_to_quiescence(tmp_path):
    """``--max-bases 3 --cross-fuse-every 2`` on the CPU: two streams split
    into two members, the family cross-fuses once, every member stops at
    the mean of the two closed forms."""
    root = str(tmp_path / "R")
    tio.save(str(tmp_path / "base.npz"), _t(_zeros()))
    for t in range(2):
        for c in range(2):
            _submit_round(root, t, c, 0)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.serve_repository", "--device", "cpu",
           "--root", root, "--init-npz", str(tmp_path / "base.npz"), "--no-screen",
           "--min-cohort", "2", "--max-bases", "3", "--cross-fuse-every", "2",
           "--max-iterations", "2", "--poll", "0.01"]
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "[cold-service] family: f1@it2, main@it2 (1 spawned, 1 cross-fuses)" in proc.stdout
    fam = TFamily.open(root, device="cpu")
    mean = np.mean([0.15 * _pat(t)["w"] for t in range(2)], axis=0)
    for m in fam.members.values():
        np.testing.assert_allclose(m.download()["w"].numpy(), mean, rtol=0, atol=1e-6)
