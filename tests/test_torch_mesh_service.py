"""The port's daemon on an 8-shard CPU mesh (``launch.serve_repository
--mesh 8 --device cpu``) drains a queue the JAX package's
``ContributorClient`` wrote — whole-row and per-shard (``sspec=``) dense
rows, whole-row and per-shard compressed deltas, a byte-identical replay,
a runaway — to the decisions, counters and rows of the port's unsharded
daemon over a copy of the same queue, through two cohorts with
``--verify-checksums`` and the novelty screen.  The port's own client
writes per-shard files the reference reads.

Tolerances: decisions, reasons and counters are equal; the published rows
within atol 1e-6 (f32: each daemon decodes the payloads of its own layout
in ``decode_accum`` and those of the other on the host, so the two fuses
add the same terms in another order)."""
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import io as jio
from repro.serve import cold_service as jcs
from repro.utils import flat as jflat
from repro_torch.core.repository import Repository as TRepository
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import serve_repository as tlaunch
from repro_torch.serve import cold_service as tcs

SHAPES = {"a": (64, 33), "b": {"c": (3000,)}}


def _base(seed=0):
    rng = np.random.default_rng(seed)

    def make(s):
        return ({k: make(v) for k, v in s.items()} if isinstance(s, dict)
                else rng.normal(size=s).astype(np.float32))
    return make(SHAPES)


def _ttree(tree):
    return {k: _ttree(v) if isinstance(v, dict) else torch.from_numpy(np.array(v))
            for k, v in tree.items()}


def _daemon(root, *mesh):
    args = tlaunch.parse_args(["--root", root, "--device", "cpu", "--min-cohort", "5",
                               "--novelty-threshold", "0.01", "--verify-checksums", *mesh])
    return tlaunch.build_service(args)


def _drain(svc, target):
    for _ in range(8):
        st = svc.run_once()
        if st["iteration"] >= target and not st["inflight"] and st["queue_depth"] == 0:
            return st
    raise AssertionError(f"no publish of iteration {target}: {st}")


def _view(st):
    keys = ("iteration", "fused_queue_submissions", "rejected_total", "novelty_rejected_total",
            "fuses", "fused_contributions", "recent_rejects")
    out = {k: st[k] for k in keys}
    out["recent_rejects"] = [(r["file"], r["reason"]) for r in st["recent_rejects"]]
    out["accepted"] = (st["last_fuse"]["n_accepted"], st["last_fuse"]["n_contributions"])
    return out


def _copy_new(src_root, dst_root):
    src, dst = os.path.join(src_root, "queue"), os.path.join(dst_root, "queue")
    os.makedirs(dst, exist_ok=True)
    for fn in sorted(os.listdir(src)):
        if fn.endswith(".npz") and not os.path.exists(os.path.join(dst, fn)):
            shutil.copy(os.path.join(src, fn), os.path.join(dst, fn))


def test_mesh_daemon_drains_a_reference_queue_like_the_unsharded_one(tmp_path):
    A, B = str(tmp_path / "A"), str(tmp_path / "B")
    base0 = _base()
    TRepository(_ttree(base0), root=A, spill=True)
    shutil.copytree(A, B)
    mesh_svc, flat_svc = _daemon(A, "--mesh", "8"), _daemon(B)
    repo = mesh_svc.repo
    assert repo.mesh is not None and repo._sspec.n_shards == 8 and flat_svc.repo.mesh is None
    jspec = jflat.FlatSpec.from_tree({k: jnp.asarray(v) if not isinstance(v, dict) else
                                      {kk: jnp.asarray(vv) for kk, vv in v.items()}
                                      for k, v in base0.items()})
    jss = jflat.ShardedFlatSpec.from_spec(jspec, 8)
    assert jss.to_json() == repo._sspec.to_json()
    rng = np.random.default_rng(1)

    def noisy(row, scale=0.01):
        return (row + scale * rng.normal(size=row.shape)).astype(np.float32)

    for it in (1, 2):
        b0 = repo.flat_base_host().numpy()
        c = lambda name: jcs.ContributorClient(A, f"{name}{it}")  # noqa: E731
        c("d").submit(row=noisy(b0), spec=jspec, base_iteration=it - 1, checksum=True)
        c("s").submit(row=noisy(b0), spec=jspec, sspec=jss, base_iteration=it - 1,
                      checksum=True)
        c("k").submit(row=noisy(b0), spec=jspec, base_iteration=it - 1, compress=True,
                      base=b0, checksum=True)
        ks = c("q").submit(row=noisy(b0), spec=jspec, sspec=jss, base_iteration=it - 1,
                           compress=True, base=b0, checksum=True)
        # the port's own client writes the per-shard form the reference reads
        p = tcs.ContributorClient(A, f"p{it}").submit(
            row=torch.from_numpy(noisy(b0)), spec=repo._spec, sspec=repo._sspec,
            base_iteration=it - 1, checksum=True)
        with jio.FlatShardReader(os.path.join(A, "queue", p + ".npz")) as r:
            assert r.sspec.to_json() == jss.to_json()
        shutil.copy(os.path.join(A, "queue", ks + ".npz"),
                    os.path.join(A, "queue", f"r{it}-000000.npz"))  # a replay
        c("x").submit(row=noisy(b0, 100.0), spec=jspec, sspec=jss, base_iteration=it - 1,
                      checksum=True)  # a runaway the MAD screen drops
        _copy_new(A, B)
        tmesh.reset_collectives()
        sm = _drain(mesh_svc, it)
        counts = dict(tmesh.collectives)
        sf = _drain(flat_svc, it)
        assert _view(sm) == _view(sf)
        assert _view(sm)["accepted"] == (5, 6)
        assert [f for f, _ in _view(sm)["recent_rejects"]][-1] == f"r{it}-000000.npz"
        # the fuse and its screen's re-pass, a per-shard sketch per admitted
        # per-shard file and the base's sketch: all-reduces; one gather, at publish
        assert counts["all_gather"] == 1 and counts["all_reduce"] >= 2
        np.testing.assert_allclose(repo.flat_base_host().numpy(),
                                   flat_svc.repo.flat_base_host().numpy(), rtol=0, atol=1e-6)
    for svc in (mesh_svc, flat_svc):
        svc.close()
    # the published root opens in the reference
    from repro.core.repository import Repository as JRepository
    np.testing.assert_array_equal(np.asarray(JRepository.open(A).flat_base_host(), np.float32),
                                  repo.flat_base_host().numpy())


def test_mesh_daemon_recovers_a_crashed_root_under_no_mesh(tmp_path):
    """Per-shard submissions staged by the mesh daemon, then the daemon
    dies: the root reopens under no mesh and under 4 shards, and both
    publish the base the mesh daemon would have."""
    A = str(tmp_path / "A")
    base0 = _base(3)
    TRepository(_ttree(base0), root=A, spill=True)
    svc = _daemon(A, "--mesh", "8")
    repo = svc.repo
    b0 = repo.flat_base_host()
    rng = np.random.default_rng(5)
    for i in range(3):
        tcs.ContributorClient(A, f"c{i}").submit(
            row=b0 + torch.from_numpy((0.01 * rng.normal(size=b0.shape)).astype(np.float32)),
            spec=repo._spec, sspec=repo._sspec, base_iteration=0)
    svc.run_once()  # admits (stages) all three, below --min-cohort: no fuse
    assert repo.n_staged == 3 and repo.iteration == 0
    want = None
    for name, mesh in (("same", ["--mesh", "8"]), ("four", ["--mesh", "4"]), ("none", [])):
        root = str(tmp_path / name)
        shutil.copytree(A, root)
        args = tlaunch.parse_args(["--root", root, "--device", "cpu", "--min-cohort", "3",
                                   *mesh])
        other = tlaunch.build_service(args)
        assert other.repo.n_staged == 3
        st = _drain(other, 1)
        assert st["fused_contributions"] == 3
        got = other.repo.flat_base_host().numpy()
        if want is None:
            want = got
        np.testing.assert_array_equal(got, want)
        other.close()
    svc.close()


@pytest.mark.parametrize("bad", ["--mesh -1"])
def test_launcher_refuses_a_negative_mesh(bad):
    with pytest.raises(SystemExit):
        tlaunch.parse_args(["--root", "R", *bad.split()])
