"""The port's contributor service loop against the JAX package's: one queue
(dense rows, compressed rows, a replay, a stale row, a malformed rider and a
runaway compressed row) drained by ``repro.serve.cold_service.ColdService``
in one root and by the port's in a copy of it; roots written by either
package reopened by the other with staged rows; the durability seams; the
launcher.

Tolerances: published bases within 1e-5 (f32; the two fuses sum the same
rows in another order).  Decisions, reasons and counters must be equal."""
import os
import shutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.repository import Repository as JRepository
from repro.serve import cold_service as jcs
from repro.utils import flat as jflat
from repro_torch.checkpoint import io as tio
from repro_torch.core.repository import Repository as TRepository
from repro_torch.core.repository import RepositoryFamily as TRepositoryFamily
from repro_torch.launch.mesh import make_mesh
from repro_torch.serve import cold_service as tcs
from repro_torch.serve.probes import ProbeSuite, RegressionGate
from repro_torch.utils import flat as tflat

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = {"a": (64, 33), "b": {"c": (3000,)}}


def _base(seed=0):
    rng = np.random.default_rng(seed)

    def make(s):
        return ({k: make(v) for k, v in s.items()} if isinstance(s, dict)
                else rng.normal(size=s).astype(np.float32))
    return make(SHAPES)


def _jtree(tree):
    return {k: _jtree(v) if isinstance(v, dict) else jnp.asarray(v) for k, v in tree.items()}


def _ttree(tree):
    return {k: _ttree(v) if isinstance(v, dict) else torch.from_numpy(np.array(v))
            for k, v in tree.items()}


def _jrow(jrepo):
    return np.array(jrepo.flat_base_host(), np.float32)  # a writable copy


def _trow(trepo):
    return trepo.flat_base_host().float().numpy()


def _copy_new_queue_files(src_root, dst_root):
    src, dst = os.path.join(src_root, "queue"), os.path.join(dst_root, "queue")
    os.makedirs(dst, exist_ok=True)
    for fn in os.listdir(src):
        if fn.endswith(".npz") and not os.path.exists(os.path.join(dst, fn)):
            shutil.copy(os.path.join(src, fn), os.path.join(dst, fn))


def _drain(svc, target):
    for _ in range(8):
        st = svc.run_once()
        if st["iteration"] >= target and not st["inflight"] and st["queue_depth"] == 0:
            return st
    raise AssertionError(f"no publish of iteration {target}: {st}")


def _view(st):
    keys = ("iteration", "fused_queue_submissions", "rejected_total",
            "novelty_rejected_total", "fuses", "fused_contributions", "recent_rejects")
    out = {k: st[k] for k in keys}
    out["accepted"] = (st["last_fuse"]["n_accepted"], st["last_fuse"]["n_contributions"])
    return out


def test_same_queue_drained_by_both_packages(tmp_path):
    A, B = str(tmp_path / "A"), str(tmp_path / "B")
    base0 = _base()
    JRepository(_jtree(base0), root=A, spill=True)
    shutil.copytree(A, B)
    jrepo = JRepository.open(A)
    trepo = TRepository.open(B, device="cpu")  # a root the reference wrote
    assert trepo.spill and trepo.iteration == 0
    kw = dict(min_cohort=4, novelty_threshold=0.01, max_staleness=0)
    jsvc = jcs.ColdService(jrepo, policy=jcs.AdmissionPolicy(**kw))
    tsvc = tcs.ColdService(trepo, policy=tcs.AdmissionPolicy(**kw))
    spec = tflat.FlatSpec.from_tree(_ttree(base0))
    jspec = jflat.FlatSpec.from_tree(_jtree(base0))
    rng = np.random.default_rng(1)

    def noisy(row, scale):
        return (row + scale * rng.normal(size=row.shape)).astype(np.float32)

    # cohort 1: written by both packages' clients into A's queue
    b0 = _jrow(jrepo)
    jcs.ContributorClient(A, "d1").submit(row=noisy(b0, 0.01), spec=jspec, base_iteration=0)
    tcs.ContributorClient(A, "d2").submit(row=torch.from_numpy(noisy(b0, 0.01)), spec=spec,
                                          base_iteration=0, sketch=False)
    k1 = tcs.ContributorClient(A, "k1").submit(
        row=torch.from_numpy(noisy(b0, 0.01)), spec=spec, base_iteration=0, compress=True,
        base=torch.from_numpy(b0), checksum=True)
    jcs.ContributorClient(A, "k2").submit(row=noisy(b0, 0.01), spec=jspec, base_iteration=0,
                                          compress=True, base=b0)
    shutil.copy(os.path.join(A, "queue", k1 + ".npz"), os.path.join(A, "queue", "r9-000000.npz"))
    _copy_new_queue_files(A, B)
    sj, st = _drain(jsvc, 1), _drain(tsvc, 1)
    assert _view(st) == _view(sj)
    assert _view(st)["accepted"] == (4, 4)
    assert [r["file"] for r in st["recent_rejects"]] == ["r9-000000.npz"]
    np.testing.assert_allclose(_trow(trepo), _jrow(jrepo), rtol=0, atol=1e-5)

    # cohort 2: three honest compressed rows, a runaway, a stale and a malformed row
    b1 = _jrow(jrepo)
    for name in ("h1", "h2", "h3"):
        tcs.ContributorClient(A, name).submit(
            row=torch.from_numpy(noisy(b1, 0.01)), spec=spec, base_iteration=1,
            compress=True, base=torch.from_numpy(b1))
    jcs.ContributorClient(A, "h4").submit(row=noisy(b1, 1.0), spec=jspec, base_iteration=1,
                                          compress=True, base=b1)
    tcs.ContributorClient(A, "s1").submit(row=torch.from_numpy(noisy(b0, 0.01)), spec=spec,
                                          base_iteration=0)
    tcs.ContributorClient(A, "w1").submit(row=torch.from_numpy(noisy(b1, 0.01)), spec=spec,
                                          base_iteration=1, weight=float("nan"))
    _copy_new_queue_files(A, B)
    sj, st = _drain(jsvc, 2), _drain(tsvc, 2)
    assert _view(st) == _view(sj)
    assert _view(st)["accepted"] == (3, 4)
    reasons = {r["file"]: r["reason"] for r in st["recent_rejects"]}
    assert reasons["s1-000000.npz"].startswith("stale:")
    assert reasons["w1-000000.npz"].startswith("malformed rider:")
    assert st["fused_queue_submissions"] == 8 and st["rejected_total"] == 3
    np.testing.assert_allclose(_trow(trepo), _jrow(jrepo), rtol=0, atol=1e-5)
    for svc in (jsvc, tsvc):
        svc.close()
    # the queue is empty on both sides and the metrics series parses
    for root in (A, B):
        assert [f for f in os.listdir(os.path.join(root, "queue")) if f.endswith(".npz")] == []
        assert len(tio.read_jsonl(os.path.join(root, "metrics.jsonl"))) >= 2


def _stage_three(root, pkg):
    """A root written by ``pkg`` holding two spilled uploads and one
    ingested compressed queue file, all staged and unfused."""
    base = _base()
    rng = np.random.default_rng(4)
    if pkg == "reference":
        repo = JRepository(_jtree(base), root=root, spill=True)
        tree, spec, client = _jtree, jflat.FlatSpec.from_tree(_jtree(base)), jcs.ContributorClient
        b0 = np.asarray(repo.flat_base_host(), np.float32)
        row = (b0 + 0.01 * rng.normal(size=b0.shape)).astype(np.float32)
    else:
        repo = TRepository(_ttree(base), root=root, spill=True)
        tree, spec, client = _ttree, tflat.FlatSpec.from_tree(_ttree(base)), tcs.ContributorClient
        b0 = repo.flat_base_host()
        row = b0 + torch.from_numpy((0.01 * rng.normal(size=b0.shape)).astype(np.float32))
    for scale in (0.01, 0.02):
        repo.upload(tree(_shifted(base, scale)), weight=1.0)
    sub = client(root, "k").submit(row=row, spec=spec, base_iteration=0, compress=True,
                                   base=b0, sketch=False)
    repo.ingest_spilled(os.path.join(root, "queue", sub + ".npz"))


def _shifted(tree, c):
    return {k: _shifted(v, c) if isinstance(v, dict) else v + np.float32(c)
            for k, v in tree.items()}


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_staged_root_opens_in_the_other_package(tmp_path, writer):
    root = str(tmp_path / "R")
    _stage_three(root, writer)
    other = TRepository.open(root, device="cpu") if writer == "reference" else JRepository.open(root)
    assert other.n_staged == 3 and other.spill
    twin_root = str(tmp_path / "twin")
    shutil.copytree(root, twin_root)
    twin = (JRepository.open(twin_root) if writer == "reference"
            else TRepository.open(twin_root, device="cpu"))
    rec_o, rec_t = other.fuse_pending(), twin.fuse_pending()
    assert (rec_o.n_accepted, rec_o.n_contributions) == (rec_t.n_accepted, rec_t.n_contributions)
    rows = [np.asarray(r.flat_base_host(), np.float32) if isinstance(r, JRepository)
            else r.flat_base_host().numpy() for r in (other, twin)]
    np.testing.assert_allclose(rows[0], rows[1], rtol=0, atol=1e-5)
    assert tio.load_json(os.path.join(root, "repository.json"))["iteration"] == 1
    assert tio.load_json(os.path.join(root, "staging_manifest.json"))["entries"] == []


def test_async_dispatch_overlaps_the_next_cohort(tmp_path):
    base = _ttree(_base())
    repo = TRepository(base, root=str(tmp_path / "R"), spill=True)
    rng = np.random.default_rng(0)

    def up():
        repo.upload({k: (v + 0.01 * torch.from_numpy(rng.normal(size=v.shape).astype(np.float32))
                         if not isinstance(v, dict) else
                         {kk: vv + 0.01 for kk, vv in v.items()}) for k, v in base.items()})

    up(), up()
    pf = repo.fuse_pending(wait=False)
    assert repo.inflight and not pf.done and repo.iteration == 0
    up()  # stages into the front while the back is in flight
    assert repo.n_staged == 1
    assert repo.staged_spill_files() == {"iter0000_contrib000.npz", "iter0000_contrib001.npz",
                                         "iter0001_contrib000.npz"}
    rec = repo.flush()
    assert pf.done and rec is pf.record and repo.iteration == 1 and not repo.inflight
    assert repo.flush() is None
    reopened = TRepository.open(str(tmp_path / "R"), device="cpu")
    assert reopened.iteration == 1 and reopened.n_staged == 1


_CHILD = r"""
import sys
from repro_torch.core.repository import Repository
from repro_torch.serve.cold_service import AdmissionPolicy, ColdService
svc = ColdService(Repository.open(sys.argv[1], device="cpu"),
                  policy=AdmissionPolicy(min_cohort=2))
for _ in range(6):
    svc.run_once()
svc.close()
"""


@pytest.mark.parametrize("seam", ["service.post_ingest", "service.post_dispatch",
                                  "repo.post_publish_pre_manifest", "service.mid_gc"])
def test_killed_daemon_converges_to_the_uninterrupted_base(tmp_path, seam):
    roots = {}
    for name in ("crash", "clean"):
        root = str(tmp_path / name)
        TRepository(_ttree(_base()), root=root, spill=True)
        roots[name] = root
    rng = np.random.default_rng(3)
    spec = tflat.FlatSpec.from_tree(_ttree(_base()))
    b0 = TRepository.open(roots["clean"], device="cpu").flat_base_host()
    rows = [b0 + torch.from_numpy(0.01 * rng.normal(size=b0.shape).astype(np.float32))
            for _ in range(2)]
    for root in roots.values():
        for i, r in enumerate(rows):
            tcs.ContributorClient(root, f"c{i}").submit(row=r, spec=spec, base_iteration=0)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), REPRO_CRASH_POINT=seam)
    proc = subprocess.run([sys.executable, "-c", _CHILD, roots["crash"]], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 17 and f"CRASH_POINT {seam}" in proc.stderr, proc.stderr
    env.pop("REPRO_CRASH_POINT")
    for root in roots.values():
        proc = subprocess.run([sys.executable, "-c", _CHILD, root], env=env,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr
    repos = {n: TRepository.open(r, device="cpu") for n, r in roots.items()}
    assert repos["crash"].iteration == repos["clean"].iteration == 1
    assert [h.n_contributions for h in repos["crash"].history] == [2]
    np.testing.assert_array_equal(_trow(repos["crash"]), _trow(repos["clean"]))
    qman = tio.load_json(os.path.join(roots["crash"], "queue", "queue_manifest.json"))
    assert qman["fused_total"] == 2 and qman["entries"] == []


def test_launcher_drains_a_queue_on_the_cpu(tmp_path):
    root = str(tmp_path / "R")
    base = _ttree(_base())
    tio.save(str(tmp_path / "base.npz"), base)
    spec = tflat.FlatSpec.from_tree(base)
    b0 = spec.flatten(base)
    for i in range(2):
        tcs.ContributorClient(root, f"c{i}").submit(row=b0 + 0.01 * (i + 1), spec=spec,
                                                    base_iteration=0)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.serve_repository", "--device", "cpu",
           "--root", root, "--init-npz", str(tmp_path / "base.npz"), "--min-cohort", "2",
           "--max-iterations", "1", "--poll", "0.01"]
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "stopped at iteration 1: 1 fuses, 2 contributions fused" in proc.stdout
    want = (b0.float() + 0.015).numpy()
    got = TRepository.open(root, device="cpu").flat_base_host().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # --mesh places its shards on --device, the card by default: with no
    # card the launcher refuses the mesh before it opens the root
    if not torch.cuda.is_available():
        refused = subprocess.run(cmd[:3] + ["--root", root, "--mesh", "2"], env=env,
                                 capture_output=True, text=True, timeout=120)
        assert refused.returncode != 0 and "no CUDA device" in refused.stderr


def test_launcher_runs_gated_compacting_with_spill_workers(tmp_path):
    """The daemon with --gate --compact-keep 2 --spill-workers 2: two honest
    cohorts publish through the gate, and compaction leaves two bases."""
    root = str(tmp_path / "R")
    base = _ttree(_base())
    tio.save(str(tmp_path / "base.npz"), base)
    spec = tflat.FlatSpec.from_tree(base)
    b0 = spec.flatten(base)
    rows = [b0 + 0.01 * (i + 1) for i in range(4)]
    for i in range(2):
        tcs.ContributorClient(root, f"c{i}").submit(row=rows[i], spec=spec, base_iteration=0)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.serve_repository", "--device", "cpu",
           "--root", root, "--min-cohort", "2", "--max-iterations", "1", "--poll", "0.01",
           "--gate", "--compact-keep", "2", "--spill-workers", "2"]
    proc = subprocess.run(cmd + ["--init-npz", str(tmp_path / "base.npz")], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    for i in (2, 3):
        tcs.ContributorClient(root, f"c{i}").submit(row=rows[i], spec=spec, base_iteration=1)
    cmd[cmd.index("--max-iterations") + 1] = "2"
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "stopped at iteration 2: 2 fuses, 4 contributions fused" in proc.stdout
    assert "0 quarantined, 0 rollbacks" in proc.stdout
    assert sorted(f for f in os.listdir(root) if f.startswith("base_iter")) == [
        "base_iter0001.npz", "base_iter0002.npz"]
    assert tio.load_json(os.path.join(root, "gate_state.json"))["iteration"] == 2
    got = TRepository.open(root, device="cpu").flat_base_host().numpy()
    want = (b0 + 0.035).numpy()  # the mean of rows 2 and 3
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_unported_paths_raise(tmp_path):
    """mesh= constructs the sharded engine now (its parity is in
    tests/test_torch_mesh_repo.py) and raises only where the reference
    does: on the per-leaf engine and for axes the mesh lacks.  spill=False
    is still refused; family= and max_bases > 1 construct a routed
    service (their parity is in tests/test_torch_routing.py)."""
    base = _ttree(_base())
    mesh = make_mesh((2,), ("model",), device="cpu")
    assert TRepository(base, mesh=mesh).mesh is mesh
    with pytest.raises(ValueError, match="mesh= requires the flat engine"):
        TRepository(base, mesh=mesh, fusion_op="fisher")
    with pytest.raises(ValueError, match=r"mesh_axes \['data'\] not in mesh"):
        TRepository(base, mesh=mesh, mesh_axes="data")
    repo = TRepository(base, root=str(tmp_path / "R"), spill=True)
    with pytest.raises(ValueError, match="exactly one of repo= .* or family="):
        tcs.ColdService(repo, family=object())
    fam = TRepositoryFamily.create(base, root=str(tmp_path / "F"), device="cpu", spill=True)
    svc = tcs.ColdService(family=fam, policy=tcs.AdmissionPolicy(max_bases=2,
                                                                 cross_fuse_every=2))
    st = svc.status()
    assert st["routing"] and list(st["families"]) == ["main"] and st["routes"] == []
    assert st["families_spawned_total"] == 0 and st["cross_fuses_total"] == 0
    single = tcs.ColdService(repo, policy=tcs.AdmissionPolicy(max_bases=2))
    assert not single.status()["routing"]
    with pytest.raises(ValueError, match="spill=True"):
        tcs.ColdService(TRepository(base, root=str(tmp_path / "R2")))


def test_lifecycle_paths_run_where_they_raised(tmp_path):
    """What the port refused before the lifecycle slice now runs:
    spill_workers, rollback, compact, contribute_async, publish listeners,
    gate= and compact_keep_bases (their parity is in
    tests/test_torch_lifecycle.py)."""
    base = _ttree(_base())
    repo = TRepository(base, root=str(tmp_path / "R"), spill=True, spill_workers=2)
    seen = []
    repo.add_publish_listener(lambda it, tree, flat: seen.append(it))
    rec = repo.contribute_async(_ttree(_shifted(_base(), 0.5)))
    assert rec.op == "async-damped(1.000)" and repo.iteration == 1
    repo.rollback(0)
    torch.testing.assert_close(repo.flat_base_host(), tflat.FlatSpec.from_tree(base).flatten(base),
                               rtol=0, atol=0)
    assert repo.compact() == {"bases_removed": 0, "rows_removed": 0}
    assert seen == [1, 0]
    gate = RegressionGate(ProbeSuite(repo.flat_base().numel(), seed=0))
    svc = tcs.ColdService(repo, policy=tcs.AdmissionPolicy(compact_keep_bases=2), gate=gate)
    st = svc.status()
    assert st["gate"] and st["last_gate"] is None and st["rollbacks_total"] == 0
    assert tio.load_json(os.path.join(str(tmp_path / "R"), "gate_state.json"))["iteration"] == 0


def test_admission_rejects_bad_compressed_rows_and_checksums(tmp_path):
    root = str(tmp_path / "R")
    repo = TRepository(_ttree(_base()), root=root, spill=True)
    svc = tcs.ColdService(repo, policy=tcs.AdmissionPolicy(min_cohort=99,
                                                            verify_checksums=True))
    spec = tflat.FlatSpec.from_tree(_ttree(_base()))
    b0 = repo.flat_base_host()
    row = b0 + 0.01
    cl = tcs.ContributorClient(root, "x")
    cl.submit(row=row, spec=spec, base_iteration=3, compress=True, base=b0)       # stale
    bad = cl.submit(row=row, spec=spec, base_iteration=0, compress=True, base=b0)
    (p,), meta = tio.load_flat_delta(os.path.join(root, "queue", bad + ".npz"))
    p.scales[0] = np.nan
    tio.save_flat_delta(os.path.join(root, "queue", bad + ".npz"), p, spec, extra=meta["extra"])
    cl.submit(row=row, spec=spec, base_iteration=0, checksum=True)                 # good
    liar = cl.submit(row=row, spec=spec, base_iteration=0, checksum=True)
    extra = tio.flat_row_meta(os.path.join(root, "queue", liar + ".npz"))["extra"]
    tio.save_flat(os.path.join(root, "queue", liar + ".npz"), row + 1.0, spec, extra=extra)
    with open(os.path.join(root, "queue", "torn-000000.npz"), "wb") as f:
        f.write(b"not a zip")
    st = svc.run_once()
    reasons = [r["reason"] for r in st["recent_rejects"]]
    assert st["staged"] == 1 and st["rejected_total"] == 4
    assert reasons[0].startswith("unreadable")  # torn-000000 sorts first
    assert reasons[1].startswith("stale: delta encoded against base iteration 3")
    assert reasons[2] == "malformed rider: non-finite quantization scale in delta payload"
    assert reasons[3] == "checksum mismatch"


def test_client_polls_and_downloads_the_published_base(tmp_path):
    root = str(tmp_path / "R")
    repo = TRepository(_ttree(_base()), root=root, spill=True)
    svc = tcs.ColdService(repo, policy=tcs.AdmissionPolicy(min_cohort=2))
    spec = tflat.FlatSpec.from_tree(_ttree(_base()))
    b0 = repo.flat_base_host()
    cl = tcs.ContributorClient(root, "p")
    assert cl.iteration() == 0
    with pytest.raises(TimeoutError, match="iteration 1"):
        cl.wait_for_iteration(1, timeout=0.05)
    for c in (0.01, 0.03):
        cl.submit(row=b0 + c, spec=spec, base_iteration=0)
    _drain(svc, 1)
    assert cl.wait_for_iteration(1, timeout=5.0)["iteration"] == 1 and cl.iteration() == 1
    got = spec.flatten(cl.download_base(device="cpu"))
    torch.testing.assert_close(got, repo.flat_base_host(), rtol=0, atol=0)
    torch.testing.assert_close(got, b0 + 0.02, rtol=0, atol=1e-6)
    # move_atomic: the file is seen at exactly one of the two paths
    src = os.path.join(root, "base_iter0000.npz")
    dst = os.path.join(root, "archive", "base_iter0000.npz")
    tio.move_atomic(src, dst)
    assert not os.path.exists(src) and tio.load(dst)["a"].shape == (64, 33)
