"""The port's Repository lifecycle and regression gate against the JAX
package's: ``contribute_async`` on both engines, ``rollback`` from memory and
from disk, ``compact``, publish listeners, ``spill_workers``, the probes
(``ProbeSuite``, ``MultitaskEvals``) and one queue drained by each package's
gated daemon, with roots crossing between them.

Inputs are numpy-seeded f32 rows and trees.  Off the TPU the reference takes
the per-leaf engine unless told otherwise, so its flat engine runs with
``use_flat=True`` explicitly.  Tolerances: bases 1e-6 for one async merge
and 1e-5 after a cohort fuse (the two fuses sum the same rows in another
order), probe scores 1e-6 (the same numpy readout; the loss in torch vs
XLA), ``MultitaskEvals`` 1e-5 (an encoder forward).  Decisions, counters,
error texts and file names must be equal."""
import dataclasses
import json
import os
import shutil
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.roberta_base import TINY as JTINY
from repro.core.repository import Repository as JRepository
from repro.models import encoder as JE
from repro.serve import cold_service as jcs
from repro.serve import probes as jprobes
from repro.utils import flat as jflat
from repro_torch import convert
from repro_torch.checkpoint import io as tio
from repro_torch.configs import TINY
from repro_torch.core.repository import Repository as TRepository
from repro_torch.serve import cold_service as tcs
from repro_torch.serve import probes as tprobes
from repro_torch.utils import flat as tflat

SHAPES = {"a": (48, 33), "b": {"c": (2000,)}}
N = 48 * 33 + 2000


def _tree(seed=0, scale=1.0, like=None):
    rng = np.random.default_rng(seed)

    def make(s, base):
        if isinstance(s, dict):
            return {k: make(v, None if base is None else base[k]) for k, v in s.items()}
        x = (scale * rng.normal(size=s)).astype(np.float32)
        return x if base is None else (base + x).astype(np.float32)
    return make(SHAPES, like)


def _jtree(tree):
    return {k: _jtree(v) if isinstance(v, dict) else jnp.asarray(v) for k, v in tree.items()}


def _ttree(tree):
    return {k: _ttree(v) if isinstance(v, dict) else torch.from_numpy(np.array(v))
            for k, v in tree.items()}


def _jrow(jrepo):
    return np.array(jrepo.flat_base_host(), np.float32)


def _trow(trepo):
    return trepo.flat_base_host().float().numpy()


def _pair(base, **kw):
    """The same repository in both packages (the reference's flat engine
    named explicitly when the port's default is flat)."""
    jkw = dict(kw)
    if "root" in kw:
        jkw["root"] = kw["root"] + "-ref"
    if kw.get("use_flat", True) and kw.get("fusion_op", "average") in ("average", "damped"):
        jkw.setdefault("use_flat", True)
    return JRepository(_jtree(base), **jkw), TRepository(_ttree(base), **kw)


# -- contribute_async ----------------------------------------------------------


@pytest.mark.parametrize("use_flat", [True, False], ids=["flat", "per_leaf"])
def test_contribute_async_matches_reference(use_flat):
    base = _tree(0)
    j, t = _pair(base, use_flat=use_flat)
    assert t.use_flat == j.use_flat == use_flat
    for seed, alpha in ((1, None), (2, None), (3, 0.25)):
        m = _tree(seed, 0.1, like=base)
        rj, rt = j.contribute_async(_jtree(m), alpha=alpha), t.contribute_async(_ttree(m), alpha=alpha)
        assert rt.op == rj.op and (rt.n_contributions, rt.n_accepted) == (1, 1)
        np.testing.assert_allclose(_trow(t), _jrow(j), rtol=0, atol=1e-6)
    assert t.iteration == j.iteration == 3
    assert [r.op for r in t.history] == [r.op for r in j.history] == [
        "async-damped(1.000)", "async-damped(0.500)", "async-damped(0.250)"]
    before = t.flat_base_host().clone()
    nan = {"a": np.full(SHAPES["a"], np.nan, np.float32), "b": {"c": np.zeros(2000, np.float32)}}
    with pytest.raises(RuntimeError, match="async contribution rejected") as et:
        t.contribute_async(_ttree(nan))
    with pytest.raises(RuntimeError, match="async contribution rejected") as ej:
        j.contribute_async(_jtree(nan))
    assert str(et.value) == str(ej.value)
    assert t.iteration == 3 and len(t.history) == 3
    assert torch.equal(t.flat_base_host(), before)


def test_contribute_async_flat_is_one_cold_fuse_pass(monkeypatch):
    from repro_torch.kernels import ops
    calls = []
    real = ops.fuse_flat
    monkeypatch.setattr(ops, "fuse_flat", lambda *a, **kw: calls.append(a[1].shape) or real(*a, **kw))
    base = _tree(0)
    t = TRepository(_ttree(base))
    t.contribute_async(_ttree(_tree(1, 0.1, like=base)), alpha=0.5)
    assert calls == [torch.Size([1, N])]


# -- rollback ----------------------------------------------------------------


def _fuse_cohort(j, t, seed, k=2):
    base = _tree(100 + seed)
    for i in range(k):
        m = _tree(seed * 10 + i, 0.05, like=base)
        j.upload(_jtree(m))
        t.upload(_ttree(m))
    return j.fuse_pending(), t.fuse_pending()


@pytest.mark.parametrize("keep_staged", [False, True], ids=["drop_staged", "keep_staged"])
@pytest.mark.parametrize("source", ["memory", "disk"])
def test_rollback_matches_reference(tmp_path, source, keep_staged):
    root = str(tmp_path / "R")
    kw = (dict(keep_history=True, screen=False) if source == "memory"
          else dict(root=root, spill=True, screen=False))
    j, t = _pair(_tree(0), **kw)
    for seed in (1, 2, 3):
        _fuse_cohort(j, t, seed)
    staged = _tree(50, 0.05, like=_tree(0))
    j.upload(_jtree(staged))
    t.upload(_ttree(staged))
    seen = {"j": [], "t": []}
    j.add_publish_listener(lambda it, b, f: seen["j"].append(it))
    t.add_publish_listener(lambda it, b, f: seen["t"].append((it, f is not None)))
    j.rollback(1, keep_staged=keep_staged)
    t.rollback(1, keep_staged=keep_staged)
    assert t.iteration == j.iteration == 1 and len(t.history) == len(j.history) == 1
    assert t.n_staged == j.n_staged == (1 if keep_staged else 0)
    assert seen["j"] == [1] and seen["t"] == [(1, True)]
    np.testing.assert_allclose(_trow(t), _jrow(j), rtol=0, atol=1e-5)
    if source == "disk":
        # the rolled-back root reopens alike in both packages
        ent = lambda r: tio.load_json(os.path.join(r, "staging_manifest.json"))["entries"]
        assert [(e["file"], e["staged_at"]) for e in ent(root)] == [
            (e["file"], e["staged_at"]) for e in ent(root + "-ref")]
        assert all(e["staged_at"] == 1 for e in ent(root))
        t = TRepository.open(root, device="cpu")
        j = JRepository.open(root + "-ref", use_flat=True)
        assert t.iteration == j.iteration == 1 and t.n_staged == j.n_staged
    if t.n_staged:
        rj, rt = j.fuse_pending(), t.fuse_pending()
    else:
        rj, rt = _fuse_cohort(j, t, 4)
    assert (rt.iteration, rt.n_accepted) == (rj.iteration, rj.n_accepted) == (1, rj.n_accepted)
    np.testing.assert_allclose(_trow(t), _jrow(j), rtol=0, atol=1e-5)


def test_rollback_restores_the_exact_row(tmp_path):
    t = TRepository(_ttree(_tree(0)), root=str(tmp_path / "R"), screen=False)
    j = JRepository(_jtree(_tree(0)), root=str(tmp_path / "J"), screen=False, use_flat=True)
    _fuse_cohort(j, t, 1)
    row1 = t.flat_base_host().clone()
    _fuse_cohort(j, t, 2)
    t.rollback(1)
    assert torch.equal(t.flat_base_host(), row1)
    # a row persisted by the reference restores in the port, bit for bit
    j.rollback(1)
    jrow1 = _jrow(j)
    shutil.copy(os.path.join(str(tmp_path / "J"), "base_iter0001.npz"),
                os.path.join(str(tmp_path / "R"), "base_iter0001.npz"))
    _fuse_cohort(j, t, 3)
    t.rollback(1)
    np.testing.assert_array_equal(_trow(t), jrow1)


def _errors(pkg, tmp_path):
    """The reference's rollback validations, run in one package; returns
    (type, text) per case and whether state stayed untouched."""
    Repo, tree = (JRepository, _jtree) if pkg == "j" else (TRepository, _ttree)
    root = str(tmp_path / pkg)
    repo = Repo(tree(_tree(0)), root=root, screen=False)
    repo.upload(tree(_tree(1)))
    repo.fuse_pending()
    out = []

    def attempt(fn):
        try:
            fn()
        except (ValueError, RuntimeError) as err:
            out.append((type(err).__name__, str(err)))

    row = np.array(repo.flat_base_host(), np.float32) if pkg == "j" else _trow(repo)
    attempt(lambda: repo.rollback(5))
    attempt(lambda: repo.rollback(-1))
    os.remove(os.path.join(root, "base_iter0000.npz"))
    attempt(lambda: repo.rollback(0))
    # a base file of another layout cannot be a rollback target
    small = {"a": np.zeros((2, 2), np.float32)}
    if pkg == "j":
        from repro.checkpoint import io as jio
        jio.save(os.path.join(root, "base_iter0000.npz"), _jtree(small))
    else:
        tio.save(os.path.join(root, "base_iter0000.npz"), _ttree(small))
    attempt(lambda: repo.rollback(0))
    mem = Repo(tree(_tree(0)), screen=False)
    mem.upload(tree(_tree(1)))
    mem.fuse_pending()
    attempt(lambda: mem.rollback(0))
    after = np.array(repo.flat_base_host(), np.float32) if pkg == "j" else _trow(repo)
    return out, repo.iteration == 1 and np.array_equal(row, after)


def test_rollback_validations_match_reference(tmp_path):
    got, untouched = _errors("t", tmp_path)
    want, _ = _errors("j", tmp_path)
    assert untouched
    assert [k for k, _ in got] == ["ValueError"] * 4 + ["RuntimeError"]
    assert got == want
    assert "keep_bases" in got[2][1] and "mismatched" in got[3][1]


def test_compressed_row_of_the_rolled_back_vintage_is_rejected(tmp_path):
    """A delta declared against the rolled-back-away iteration is stale,
    never decoded against the restored base (the reference's
    test_compressed_rejected_after_gate_rollback)."""
    root = str(tmp_path / "R")
    m = lambda v: {"w": torch.full((64,), float(v)), "b": torch.full((5,), float(v))}
    repo = TRepository(m(0), root=root, spill=True, screen=False)
    gate = tprobes.RegressionGate(tprobes.ProbeSuite(69, seed=0), tolerance=0.5)
    svc = tcs.ColdService(repo, policy=tcs.AdmissionPolicy(min_cohort=2), gate=gate)
    client = tcs.ContributorClient(root, name="c")
    for v in (0.1, 0.3):
        client.submit(m(v), base_iteration=0)
    _drain(svc)
    good = repo.flat_base_host().clone()
    rng = np.random.default_rng(7)
    bad = tcs.ContributorClient(root, name="bad")
    for _ in range(2):
        bad.submit({"w": torch.from_numpy((0.2 + rng.normal(0, 10.0, 64)).astype(np.float32)),
                    "b": torch.from_numpy((0.2 + rng.normal(0, 10.0, 5)).astype(np.float32))},
                   base_iteration=1)
    st = _drain(svc)
    assert st["rollbacks_total"] == 1 and st["iteration"] == 1
    client.submit(m(9.0), base_iteration=2, compress=True, base=m(0.0), k_per_block=128)
    st = _drain(svc)
    assert st["iteration"] == 1 and st["recent_rejects"][-1]["reason"].startswith(
        "stale: delta encoded against base iteration 2")
    assert torch.equal(repo.flat_base_host(), good)


# -- compact -----------------------------------------------------------------


def _compact_run(root, pkg):
    Repo, tree = (JRepository, _jtree) if pkg == "j" else (TRepository, _ttree)
    kw = {"use_flat": True} if pkg == "j" else {}
    repo = Repo(tree(_tree(0)), root=root, spill=True, screen=False, **kw)
    for it in range(4):
        repo.upload(tree(_tree(it + 1)))
        repo.fuse_pending()
    repo.upload(tree(_tree(9)))  # staged, manifest-referenced
    os.makedirs(os.path.join(root, "queue"))
    os.makedirs(os.path.join(root, "quarantine"))
    for d in ("queue", "quarantine"):
        with open(os.path.join(root, d, "iter0000_contrib000.npz"), "wb") as f:
            f.write(b"not ours")
    return repo.compact(keep_bases=2)


def test_compact_leaves_the_same_files_as_the_reference(tmp_path):
    A, B = str(tmp_path / "A"), str(tmp_path / "B")
    got, want = _compact_run(B, "t"), _compact_run(A, "j")
    assert got == want == {"bases_removed": 3, "rows_removed": 4}
    files = lambda r: sorted(os.path.relpath(os.path.join(d, f), r)
                             for d, _, fs in os.walk(r) for f in fs)
    assert files(B) == files(A)
    assert "iter0004_contrib000.npz" in files(B)  # the staged row stays
    assert [f for f in files(B) if f.startswith("base_iter")] == [
        "base_iter0003.npz", "base_iter0004.npz"]
    again = TRepository.open(B, device="cpu")
    assert again.iteration == 4 and again.n_staged == 1
    again.fuse_pending()
    np.testing.assert_allclose(_trow(again), tflat.FlatSpec.from_tree(_ttree(_tree(9))).flatten(
        _ttree(_tree(9))).numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("survive_removes", [0, 1, 3])
def test_compact_crash_midway_still_reopens(tmp_path, monkeypatch, survive_removes):
    root = str(tmp_path / "R")
    repo = TRepository(_ttree(_tree(0)), root=root, spill=True, screen=False)
    for it in range(3):
        repo.upload(_ttree(_tree(it + 1)))
        repo.fuse_pending()
    repo.upload(_ttree(_tree(7)))
    real_remove, calls = os.remove, []

    def flaky_remove(path):
        if len(calls) >= survive_removes:
            raise RuntimeError("injected crash mid-compact")
        calls.append(path)
        real_remove(path)

    monkeypatch.setattr(os, "remove", flaky_remove)
    with pytest.raises(RuntimeError, match="mid-compact"):
        repo.compact(keep_bases=1)
    monkeypatch.setattr(os, "remove", real_remove)
    for again in (TRepository.open(root, device="cpu"), JRepository.open(root, use_flat=True)):
        assert again.iteration == 3 and again.n_staged == 1
    again = TRepository.open(root, device="cpu")
    again.fuse_pending()
    want = tflat.FlatSpec.from_tree(_ttree(_tree(7))).flatten(_ttree(_tree(7))).numpy()
    np.testing.assert_allclose(_trow(again), want, rtol=0, atol=1e-6)
    again.compact(keep_bases=1)
    assert sorted(f for f in os.listdir(root) if f.startswith("base_iter")) == ["base_iter0004.npz"]


def test_compact_validations_match_reference(tmp_path):
    texts = []
    for Repo, tree in ((JRepository, _jtree), (TRepository, _ttree)):
        out = []
        for fn in (lambda: Repo(tree(_tree(0))).compact(),
                   lambda: Repo(tree(_tree(0)), root=str(tmp_path / Repo.__module__)).compact(
                       keep_bases=0)):
            with pytest.raises(ValueError) as err:
                fn()
            out.append(str(err.value))
        texts.append(out)
    assert texts[0] == texts[1]
    assert "on-disk root" in texts[1][0] and "keep_bases" in texts[1][1]


# -- publish listeners -----------------------------------------------------------


def test_publish_listeners_see_the_same_iterations(tmp_path):
    """Across a flat publish, a per-leaf publish, contribute_async and
    rollback, both packages call their listeners with the same iterations
    and the published base; the port's ``flat`` is never None."""
    base = _tree(0)
    out = {}
    for pkg, Repo, tree in (("j", JRepository, _jtree), ("t", TRepository, _ttree)):
        seen = []
        for use_flat in (True, False):
            repo = Repo(tree(base), use_flat=use_flat, keep_history=True, screen=False,
                        root=str(tmp_path / f"{pkg}{use_flat}"))
            spec = (jflat if pkg == "j" else tflat).FlatSpec.from_tree(tree(base))

            def listen(it, b, flat, repo=repo, spec=spec, use_flat=use_flat):
                row = np.asarray(spec.flatten(b), np.float32)
                assert np.array_equal(row, np.asarray(repo.flat_base_host(), np.float32))
                if pkg == "t":
                    assert flat is not None and torch.equal(flat, repo.flat_base())
                seen.append((use_flat, it))

            repo.add_publish_listener(listen)
            repo.upload(tree(_tree(1, 0.1, like=base)))
            repo.fuse_pending()                                    # -> 1
            repo.contribute_async(tree(_tree(2, 0.1, like=base)))  # -> 2
            repo.rollback(1)                                       # -> 1
            repo.upload(tree(_tree(3, 0.1, like=base)))
            repo.fuse_pending()                                    # -> 2
        out[pkg] = seen
    assert out["t"] == out["j"] == [(f, it) for f in (True, False) for it in (1, 2, 1, 2)]


def test_publish_order_is_persist_seam_manifest_sketch_listeners(tmp_path, monkeypatch):
    """_after_publish and the per-leaf publish follow the reference's order:
    the base persist, the ``repo.post_publish_pre_manifest`` seam, the
    manifest rewrite, the base sketch, then the listeners."""
    from repro_torch.core import repository as trepo_mod
    events = []
    real_save, real_json = tio.save, tio.save_json_atomic
    monkeypatch.setattr(tio, "save", lambda p, tree: (
        events.append(("persist", os.path.basename(p))), real_save(p, tree)))

    def json_spy(p, obj, **kw):
        name = os.path.basename(p)
        if name in ("staging_manifest.json", "cohort_sketch.json"):
            events.append(("manifest" if name.startswith("staging") else "sketch", name))
        return real_json(p, obj, **kw)

    monkeypatch.setattr(tio, "save_json_atomic", json_spy)
    monkeypatch.setattr(trepo_mod.faults, "crash_point",
                        lambda name: events.append(("seam", name)))
    for use_flat, kw in ((True, dict(spill=True)), (False, {})):
        root = str(tmp_path / f"R{use_flat}")
        repo = TRepository(_ttree(_tree(0)), root=root, use_flat=use_flat, screen=False, **kw)
        if use_flat:
            repo.enable_cohort_sketch()
        else:
            tio.save_json_atomic(os.path.join(root, "staging_manifest.json"),
                                 {"version": 1, "entries": []})
        repo.add_publish_listener(lambda it, b, f: events.append(("listener", it)))
        repo.upload(_ttree(_tree(1)))
        del events[:]
        repo.fuse_pending()
        kinds = [k for k, _ in events]
        # the flat engine's in-flight mark rewrites the manifest first
        assert kinds == ["manifest"] * use_flat + ["persist", "seam", "manifest"] + [
            "sketch"] * use_flat + ["listener"], (use_flat, events)


# -- spill_workers -----------------------------------------------------------------


def _rows(n, seed=0):
    base = _tree(0)
    return base, [_tree(seed * 100 + i, 0.1, like=base) for i in range(n)]


def _flat(tree):
    return tflat.FlatSpec.from_tree(_ttree(tree)).flatten(_ttree(tree)).double().numpy()


def test_spill_workers_fuse_the_expected_base(tmp_path):
    root = str(tmp_path / "R")
    base, rows = _rows(3)
    weights = [1.0, 2.0, 3.0]
    repo = TRepository(_ttree(base), root=root, spill=True, spill_workers=2, screen=False)
    for r, w in zip(rows, weights):
        repo.upload(_ttree(r), weight=w)
    rec = repo.fuse_pending()
    repo.flush()
    want = sum(w * _flat(r) for r, w in zip(rows, weights)) / sum(weights)
    assert rec.n_accepted == 3
    np.testing.assert_allclose(_trow(repo), want, rtol=0, atol=1e-6)
    assert tio.load_json(os.path.join(root, "staging_manifest.json"))["entries"] == []
    for again in (TRepository.open(root, device="cpu"), JRepository.open(root, use_flat=True)):
        assert again.iteration == 1
        np.testing.assert_allclose(np.asarray(again.flat_base_host(), np.float32), want,
                                   rtol=0, atol=1e-6)


def test_fuse_waits_for_each_spilled_row_before_reading_it(tmp_path, monkeypatch):
    """A slow row write: the fuse opens no spilled file before its write
    landed (the reference's _stage_cohort peeks at the file first)."""
    root = str(tmp_path / "R")
    base, rows = _rows(3, seed=1)
    real_save, real_peek = tio.save_flat, tio.is_flat_compressed
    log, lock = [], threading.Lock()

    def slow_save(path, buf, spec, **kw):
        time.sleep(0.2)
        real_save(path, buf, spec, **kw)
        with lock:
            log.append(("written", os.path.basename(path)))

    def peek(path):
        with lock:
            log.append(("read", os.path.basename(path)))
        return real_peek(path)

    monkeypatch.setattr(tio, "save_flat", slow_save)
    monkeypatch.setattr(tio, "is_flat_compressed", peek)
    repo = TRepository(_ttree(base), root=root, spill=True, spill_workers=3, screen=False)
    for r in rows:
        repo.upload(_ttree(r))
    assert not any(k == "written" for k, _ in log)  # the uploads did not wait
    repo.fuse_pending()
    for name in {n for k, n in log if k == "read"}:
        assert log.index(("written", name)) < log.index(("read", name)), log
    want = sum(_flat(r) for r in rows) / 3
    np.testing.assert_allclose(_trow(repo), want, rtol=0, atol=1e-6)


def test_failing_row_write_raises_at_flush(tmp_path, monkeypatch):
    root = str(tmp_path / "R")
    base, rows = _rows(2, seed=2)
    real_save = tio.save_flat

    def failing(path, buf, spec, **kw):
        if path.endswith("contrib001.npz"):
            raise OSError("disk full")
        real_save(path, buf, spec, **kw)

    monkeypatch.setattr(tio, "save_flat", failing)
    repo = TRepository(_ttree(base), root=root, spill=True, spill_workers=2, screen=False)
    for r in rows:
        repo.upload(_ttree(r))  # returns: the write runs on the executor
    with pytest.raises(OSError, match="disk full"):
        repo.flush()
    assert [e["file"] for e in tio.load_json(
        os.path.join(root, "staging_manifest.json"))["entries"]] == ["iter0000_contrib000.npz"]
    repo.flush()  # the error was raised once; the pool is drained


def test_spill_workers_stress(tmp_path):
    """More writer threads than cores, a short switch interval, uploads
    racing wait=False fuses: the published base is the closed form, and
    the manifest on disk lists exactly the rows still staged."""
    root = str(tmp_path / "R")
    base = {"w": np.zeros(257, np.float32)}
    repo = TRepository(_ttree(base), root=root, spill=True, spill_workers=3 * (os.cpu_count() or 2),
                       screen=False)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        t0 = time.monotonic()
        for cohort in range(4):
            for i in range(6):
                repo.upload({"w": torch.full((257,), float(cohort * 10 + i))})
            repo.fuse_pending(wait=False)
        for i in range(3):
            repo.upload({"w": torch.full((257,), 100.0 + i)})
        repo.flush()
        assert time.monotonic() - t0 < 60
    finally:
        sys.setswitchinterval(old)
    assert repo.iteration == 4 and repo.n_staged == 3
    np.testing.assert_allclose(_trow(repo), np.full(257, 30 + 2.5, np.float32), atol=1e-6)
    entries = tio.load_json(os.path.join(root, "staging_manifest.json"))["entries"]
    assert sorted(e["file"] for e in entries) == sorted(repo.staged_spill_files())
    assert len(entries) == 3 and all(e["staged_at"] == 4 for e in entries)
    again = TRepository.open(root, device="cpu")
    assert again.iteration == 4 and again.n_staged == 3
    again.fuse_pending()
    np.testing.assert_allclose(_trow(again), np.full(257, 101.0, np.float32), atol=1e-6)


# -- the probes --------------------------------------------------------------------


def test_probe_suite_scores_match_reference():
    row = np.random.default_rng(5).normal(size=N).astype(np.float32)
    tree = tflat.FlatSpec.from_tree(_ttree(_tree(0))).unflatten(torch.from_numpy(row))
    for kw in (dict(seed=0), dict(seed=3, n_tasks=6, n_examples=20, seq_len=12)):
        jp, tp = jprobes.ProbeSuite(N, **kw), tprobes.ProbeSuite(N, **kw)
        want = jp.score(row)
        for base in (torch.from_numpy(row), row, tree, torch.from_numpy(row).to(torch.float64)):
            got = tp.score(base)
            assert got.keys() == want.keys()
            np.testing.assert_allclose([got[k] for k in want], list(want.values()),
                                       rtol=0, atol=1e-6)
        assert tp.accuracies(row) == pytest.approx(jp.accuracies(row), abs=1e-6)
    base_scores = jp.score(row)
    worse = {k: v + (0.6 if i == 0 else 0.1) for i, (k, v) in enumerate(base_scores.items())}
    worse["extra"] = 9.0  # missing from the baseline: skipped
    for kw in ({}, dict(tolerance=0.7), dict(max_regressed=1)):
        rj, rt = jp.compare(base_scores, worse, **kw), tp.compare(base_scores, worse, **kw)
        assert (rt.ok, rt.regressed, rt.worst) == (rj.ok, rj.regressed, rj.worst)
        assert rt.to_json() == rj.to_json()
    with pytest.raises(ValueError, match="flat size"):
        tp.score(row[:-1])


JCFG = dataclasses.replace(JTINY, d_model=64, num_heads=2, num_kv_heads=2, head_dim=32,
                           d_ff=128, vocab_size=256, max_seq_len=32, num_layers=2)
TCFG = dataclasses.replace(TINY, d_model=64, num_heads=2, num_kv_heads=2, head_dim=32,
                           d_ff=128, vocab_size=256, max_seq_len=32, num_layers=2)


def test_multitask_evals_match_reference():
    body = JE.init_encoder_body(JCFG, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    datasets = [(tid, rng.integers(0, 256, size=(8, 16)).astype(np.int32),
                 rng.integers(0, n, size=(8,)).astype(np.int32), n)
                for tid, n in ((0, 3), (5, 2))]
    jev = jprobes.MultitaskEvals(JCFG, body, datasets, seed=1)
    heads = {tid: convert.from_jax_params(jax.tree.map(np.asarray, h), "cpu")
             for tid, h in jev.heads.items()}
    tbody = convert.from_jax_params(jax.tree.map(np.asarray, body), "cpu")
    tev = tprobes.MultitaskEvals(TCFG, tbody, datasets, seed=1, heads=heads, device="cpu")
    assert tev.size == jev.size and tev.task_names == jev.task_names == ["task00", "task05"]
    jrow = np.array(jflat.FlatSpec.from_tree(body).flatten(body), np.float32)
    jrow2 = (jrow + 0.05 * rng.normal(size=jrow.shape)).astype(np.float32)
    for row in (jrow, jrow2):
        want = jev.score(row)
        for base in (torch.from_numpy(row), row):
            got = tev.score(base)
            np.testing.assert_allclose([got[k] for k in want], list(want.values()),
                                       rtol=0, atol=1e-5)
        assert tev.accuracies(row) == pytest.approx(jev.accuracies(row), abs=1e-6)
    # the gate's real-task mode: a ProbeSuite over the evals
    jp = jprobes.ProbeSuite(jev.size, suite=jev)
    tp = tprobes.ProbeSuite(tev.size, suite=tev)
    got, want = tp.score(torch.from_numpy(jrow2)), jp.score(jrow2)
    np.testing.assert_allclose([got[k] for k in want], list(want.values()), rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="MultitaskEvals scores"):
        tprobes.ProbeSuite(tev.size + 1, suite=tev)
    # default heads: train_multitask's seeding, drawn by torch
    dflt = tprobes.MultitaskEvals(TCFG, tbody, datasets, seed=1, device="cpu")
    assert all(np.isfinite(v) for v in dflt.score(jrow).values())


# -- the gated daemon, both packages ---------------------------------------------------


def _drain(svc, max_cycles=50):
    for _ in range(max_cycles):
        st = svc.run_once()
        if st["queue_depth"] == 0 and st["staged"] == 0 and not st["inflight"]:
            return st
    raise AssertionError(f"service did not drain in {max_cycles} cycles: {st}")


def _submit(root, pkg, name, rows, spec, base_iteration):
    Client = jcs.ContributorClient if pkg == "j" else tcs.ContributorClient
    client = Client(root, name)
    for r in rows:
        client.submit(row=r if pkg == "j" else torch.from_numpy(r), spec=spec,
                      base_iteration=base_iteration)


def _gate_view(st):
    keys = ("iteration", "fused_queue_submissions", "rejected_total", "quarantined_total",
            "rollbacks_total", "fuses", "fused_contributions", "gate")
    out = {k: st[k] for k in keys}
    out["last_gate"] = None if st["last_gate"] is None else (
        st["last_gate"]["ok"], st["last_gate"]["regressed"])
    return out


def _gated(pkg, root):
    if pkg == "j":
        repo = JRepository.open(root, use_flat=True)
        gate = jprobes.RegressionGate(jprobes.ProbeSuite(N, seed=0))
        return jcs.ColdService(repo, policy=jcs.AdmissionPolicy(min_cohort=3,
                                                                compact_keep_bases=2), gate=gate)
    repo = TRepository.open(root, device="cpu")
    gate = tprobes.RegressionGate(tprobes.ProbeSuite(N, seed=0))
    return tcs.ColdService(repo, policy=tcs.AdmissionPolicy(min_cohort=3, compact_keep_bases=2),
                           gate=gate)


def _cohorts():
    """The base row, and cohorts of 3 around a row: honest (noise 0.01) or
    harmful (noise 10: the §9 screen admits it, since the norms agree)."""
    b0 = tflat.FlatSpec.from_tree(_ttree(_tree(0))).flatten(_ttree(_tree(0))).numpy()
    rng = np.random.default_rng(11)

    def cohort(b, scale):
        return [(b + scale * rng.normal(size=N)).astype(np.float32) for _ in range(3)]
    return b0, lambda b: cohort(b, 0.01), lambda b: cohort(b, 10.0)


def test_gated_daemons_agree_on_one_queue(tmp_path):
    A, B = str(tmp_path / "A"), str(tmp_path / "B")
    JRepository(_jtree(_tree(0)), root=A, spill=True, use_flat=True)
    shutil.copytree(A, B)
    svcs = {"j": _gated("j", A), "t": _gated("t", B)}
    spec = jflat.FlatSpec.from_tree(_jtree(_tree(0)))
    b0, honest, harmful = _cohorts()
    rows1 = honest(b0)
    views = []
    for pkg, root in (("j", A), ("t", B)):
        _submit(root, pkg, "h", rows1, spec, 0)
    views.append({p: _gate_view(_drain(s)) for p, s in svcs.items()})
    b1 = _jrow(svcs["j"].repo)
    harm = harmful(b1)
    for pkg, root in (("j", A), ("t", B)):
        _submit(root, pkg, "bad", harm, spec, 1)
    views.append({p: _gate_view(_drain(s)) for p, s in svcs.items()})
    rows3 = honest(b1)
    for pkg, root in (("j", A), ("t", B)):
        _submit(root, pkg, "g", rows3, spec, 1)
    views.append({p: _gate_view(_drain(s)) for p, s in svcs.items()})
    for v in views:
        assert v["t"] == v["j"]
    assert views[0]["t"]["last_gate"][0] and not views[1]["t"]["last_gate"][0]
    assert (views[1]["t"]["quarantined_total"], views[1]["t"]["rollbacks_total"]) == (3, 1)
    assert views[2]["t"]["iteration"] == 2 and views[2]["t"]["last_gate"][0]
    np.testing.assert_allclose(_trow(svcs["t"].repo), _jrow(svcs["j"].repo), rtol=0, atol=1e-5)
    gj, gt = (tio.load_json(os.path.join(r, "gate_state.json")) for r in (A, B))
    assert gt["iteration"] == gj["iteration"] == 2
    np.testing.assert_allclose([gt["scores"][k] for k in gj["scores"]], list(gj["scores"].values()),
                               rtol=0, atol=1e-5)
    assert sorted(os.listdir(os.path.join(A, "quarantine"))) == sorted(
        os.listdir(os.path.join(B, "quarantine"))) == [f"bad-00000{i}.npz" for i in range(3)]
    for root in (A, B):
        assert sorted(f for f in os.listdir(root) if f.startswith("base_iter")) == [
            "base_iter0001.npz", "base_iter0002.npz"]
    events = [r["event"] for r in tio.read_jsonl(os.path.join(B, "metrics.jsonl"))]
    assert "quarantine" in events and "rollback" in events


class _Died(Exception):
    pass


@pytest.mark.parametrize("first", ["j", "t"])
def test_root_left_mid_gate_finishes_in_the_other_package(tmp_path, monkeypatch, first):
    """A daemon dies after a harmful publish, before its verdict: the other
    package's daemon replays the verdict on start, quarantines the cohort
    and rolls back, then serves on."""
    root = str(tmp_path / "R")
    (JRepository if first == "j" else TRepository)(
        (_jtree if first == "j" else _ttree)(_tree(0)), root=root, spill=True,
        **({"use_flat": True} if first == "j" else {}))
    spec = jflat.FlatSpec.from_tree(_jtree(_tree(0)))
    b0, honest, harmful = _cohorts()
    svc = _gated(first, root)
    _submit(root, first, "h", honest(b0), spec, 0)
    _drain(svc)
    b1 = _jrow(svc.repo) if first == "j" else _trow(svc.repo)
    _submit(root, first, "bad", harmful(b1), spec, 1)

    def die(name):
        if name == "service.post_publish":
            raise _Died(name)

    monkeypatch.setattr((jcs if first == "j" else tcs).faults, "crash_point", die)
    with pytest.raises(_Died):
        _drain(svc)
    monkeypatch.undo()
    assert svc.repo.iteration == 2
    assert tio.load_json(os.path.join(root, "gate_state.json"))["iteration"] == 1
    other = _gated("t" if first == "j" else "j", root)
    st = other.status()
    assert (st["iteration"], st["quarantined_total"], st["rollbacks_total"]) == (1, 3, 1)
    assert sorted(os.listdir(os.path.join(root, "quarantine"))) == [
        f"bad-00000{i}.npz" for i in range(3)]
    row = _trow(other.repo) if first == "j" else _jrow(other.repo)
    np.testing.assert_allclose(row, b1, rtol=0, atol=0)
    # and it goes on: an honest cohort publishes through the gate
    _submit(root, "t" if first == "j" else "j", "g", honest(b1), spec, 1)
    st = _drain(other)
    assert st["iteration"] == 2 and st["last_gate"]["ok"]
    assert json.load(open(os.path.join(root, "gate_state.json")))["iteration"] == 2
