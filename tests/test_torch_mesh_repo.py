"""``Repository(mesh=)`` on an 8-shard CPU mesh against the JAX package's
unsharded ``Repository``: the reference documents that a sharded repository
publishes what the single-device one does (docs/sharding.md, "The
one-all-reduce screen+fuse contract"), and its own sharded repository
cannot be read back in this jax (ROADMAP §C).  Cohorts with a NaN row and a
runaway, per-shard spill files read by the reference's ``FlatShardReader``,
reopening under the same mesh, a 4-shard mesh and none, the cohort sketch,
``contribute_async``, ``rollback``, ``compact`` and ``fuse_pending(buffer=)``
with the reference's ``[K, S, shard_len]`` layout.

Tolerances: bases atol 1e-5 in f32 (the per-shard fuse sums the same rows
in another order), 1 bf16 ulp in bf16; ``diff_norms`` rtol 1e-4; sketches
within 1e-5 of each bucket's sum of |x| (or x²).  Equalities between two
port repositories that fuse the same bits are exact."""
import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import io as jio
from repro.configs.roberta_base import TINY as JTINY
from repro.core import Repository as JRepository
from repro.models import encoder as JE
from repro_torch import convert
from repro_torch.checkpoint import io as tio
from repro_torch.core import Repository as TRepository
from repro_torch.launch import mesh as tmesh
from repro_torch.utils.flat import StagedBuffer
from repro_torch.utils.pytree import tree_leaves_with_path

SHAPE = dict(d_model=32, num_heads=2, num_kv_heads=2, head_dim=16, d_ff=64,
             vocab_size=128, max_seq_len=16)


def _mesh(n=8):
    return tmesh.make_mesh((n,), ("model",), device="cpu")


def _body(dtype="float32", seed=0):
    cfg = dataclasses.replace(JTINY, **SHAPE, param_dtype=dtype, compute_dtype=dtype)
    return JE.init_encoder_body(cfg, jax.random.PRNGKey(seed))


def _t(tree):
    return convert.from_jax_params(jax.tree.map(np.asarray, tree), "cpu")


def _rows_close(t_row, j_row, bf16=False, atol=1e-5):
    got = np.asarray(t_row, np.float32)
    want = np.asarray(j_row, np.float32)
    if bf16:
        ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126))) - 7)
        assert np.all(np.abs(got - want) <= ulp)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def _trow(repo):
    return repo.flat_base_host().float().numpy()


def _jrow(repo):
    return np.asarray(repo.flat_base_host(), np.float32)


def _cohort(jbody, rng, n=3, adversarial=False, dtype="float32"):
    np_dt = jnp.bfloat16 if dtype == "bfloat16" else np.float32
    base = jax.tree.map(lambda x: np.asarray(x, np.float32), jbody)
    out = [jax.tree.map(lambda x: (x + 0.01 * rng.normal(size=x.shape)).astype(np_dt), base)
           for _ in range(n)]
    if adversarial:
        out.append(jax.tree.map(lambda x: np.full(x.shape, np.nan, np_dt), base))
        out.append(jax.tree.map(lambda x: (x + 100.0 * rng.normal(size=x.shape)).astype(np_dt),
                                base))
    return out


def _upload(jrepo, trepo, cohort, weights=None):
    for i, u in enumerate(cohort):
        w = None if weights is None else weights[i]
        jrepo.upload(jax.tree.map(jnp.asarray, u), weight=w)
        trepo.upload(convert.from_jax_params(u, "cpu"), weight=w)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mesh_repository_publishes_the_unsharded_base(dtype):
    jbody = _body(dtype)
    jrepo = JRepository(jbody)
    trepo = TRepository(_t(jbody), mesh=_mesh())
    assert trepo.use_flat and trepo._sspec.n_shards == 8 and trepo.mesh_axes == ("model",)
    rng = np.random.default_rng(1)
    for it, adversarial in ((1, False), (2, True)):
        _upload(jrepo, trepo, _cohort(jbody, rng, adversarial=adversarial, dtype=dtype),
                weights=[1.0, 2.0, 3.0] + ([1.0, 1.0] if adversarial else []))
        tmesh.reset_collectives()
        jrec, trec = jrepo.fuse_pending(), trepo.fuse_pending()
        assert (trec.n_accepted, trec.n_contributions) == (jrec.n_accepted, jrec.n_contributions)
        assert trec.n_accepted == 3
        # the screen's second pass is a second fuse: a second all-reduce
        assert tmesh.collectives == {"all_reduce": 2 if adversarial else 1, "all_gather": 1}
        np.testing.assert_allclose(trec.diff_norms, jrec.diff_norms, rtol=1e-4)
        _rows_close(_trow(trepo), _jrow(jrepo), bf16=dtype == "bfloat16")
        assert trepo.iteration == jrepo.iteration == it
    # the published tree is a view of the gathered row, on the mesh's first device
    got = dict(tree_leaves_with_path(trepo.download()))
    flat = trepo.flat_base()
    assert all(v.device == torch.device("cpu") for v in got.values())
    assert trepo.device == tmesh.make_mesh((1,), ("m",), device="cpu").devices.flat[0]
    assert sum(v.numel() for v in got.values()) == flat.numel()


def test_mesh_spill_files_and_reopen_under_8_4_and_no_shards(tmp_path):
    jbody = _body()
    A = str(tmp_path / "A")
    JRepository(jbody, root=A, spill=True)  # a root the reference wrote
    trepo = TRepository.open(A, device="cpu", mesh=_mesh())
    assert trepo.spill and trepo.mesh is not None
    rng = np.random.default_rng(2)
    cohort = _cohort(jbody, rng, adversarial=True)
    for u in cohort:
        trepo.upload(convert.from_jax_params(u, "cpu"))
    # every staged row is a per-shard file the reference reads back
    manifest = tio.load_json(os.path.join(A, "staging_manifest.json"))
    assert len(manifest["entries"]) == 5
    for e, u in zip(manifest["entries"], cohort):
        assert e["sharded"] and e["shard_spec"] == trepo._sspec.to_json()
        path = os.path.join(A, e["file"])
        assert jio.is_flat_sharded(path)
        with jio.FlatShardReader(path) as r:
            want = np.concatenate([np.asarray(v, np.float32).reshape(-1)
                                   for _, v in tree_leaves_with_path(_t(u))])
            np.testing.assert_array_equal(np.asarray(r.full_row(), np.float32), want)
    # the crash: the staged cohort recovers under 8 shards, 4 and none, and
    # in the reference, into the same next base
    bases = {}
    for name, kw in (("8", dict(mesh=_mesh())), ("4", dict(mesh=_mesh(4))), ("none", {})):
        root = str(tmp_path / f"R{name}")
        shutil.copytree(A, root)
        repo = TRepository.open(root, device="cpu", **kw)
        assert repo.n_staged == 5
        tmesh.reset_collectives()
        rec = repo.fuse_pending()
        assert rec.n_accepted == 3
        if name == "4":  # 8-shard files put back together on the host, each once
            assert tmesh.collectives["all_gather"] == 5 + 1
        bases[name] = _trow(repo)
    jroot = str(tmp_path / "J")
    shutil.copytree(A, jroot)
    jrepo = JRepository.open(jroot)
    assert jrepo.fuse_pending().n_accepted == 3
    np.testing.assert_array_equal(bases["8"], bases["4"])
    np.testing.assert_array_equal(bases["8"], bases["none"])
    _rows_close(bases["8"], _jrow(jrepo))
    # and a root the mesh repository published opens in the reference
    np.testing.assert_array_equal(_jrow(JRepository.open(str(tmp_path / "R8"))), bases["8"])


def test_mesh_cohort_sketch_and_sharded_queue_files(tmp_path):
    jbody = _body(seed=3)
    A = str(tmp_path / "A")
    JRepository(jbody, root=A, spill=True)
    jrepo = JRepository.open(A)
    trepo = TRepository.open(A, device="cpu", mesh=_mesh())
    tmesh.reset_collectives()
    tsk = trepo.enable_cohort_sketch()
    assert tmesh.collectives == {"all_reduce": 1, "all_gather": 0}
    jsk = jrepo.enable_cohort_sketch()
    row = _trow(trepo)
    pad = (-row.shape[0]) % 1024
    tiles = np.concatenate([row, np.zeros(pad, np.float32)]).reshape(-1, 1024)
    b = np.arange(tiles.shape[0]) % 32
    mag = np.stack([np.bincount(b, np.abs(tiles).sum(1), 32),
                    np.bincount(b, (tiles * tiles).sum(1), 32)])
    assert np.all(np.abs(tsk.base - jsk.base) <= 1e-5 * mag)
    # a per-shard queue file of the mesh's layout sketches shard by shard
    # (one all-reduce, no gather); a whole-row file as one row
    spec = trepo._spec
    up = _t(_cohort(jbody, np.random.default_rng(4), n=1)[0])
    flat = spec.flatten(up)
    sharded, whole = str(tmp_path / "A" / "s.npz"), str(tmp_path / "A" / "w.npz")
    tio.save_flat_shards(sharded, trepo._sspec.shard_slices(flat), spec, trepo._sspec)
    tio.save_flat(whole, flat, spec)
    tmesh.reset_collectives()
    s1 = trepo.sketch_row_file(sharded)
    assert tmesh.collectives == {"all_reduce": 1, "all_gather": 0}
    s2 = trepo.sketch_row_file(whole)
    assert np.all(np.abs(s1 - s2) <= 1e-5 * mag)
    assert np.all(np.abs(s1 - jrepo.sketch_row_file(sharded)) <= 1e-5 * mag)
    # both ingest by reference and fuse to the row they hold
    trepo.ingest_spilled(sharded)
    trepo.ingest_spilled(whole)
    assert [e["sharded"] for e in tio.load_json(os.path.join(A, "staging_manifest.json"))[
        "entries"]] == [True, False]
    trepo.fuse_pending()
    _rows_close(_trow(trepo), flat.numpy())


def test_mesh_lifecycle_matches_the_reference(tmp_path):
    jbody = _body(seed=5)
    J, T = str(tmp_path / "J"), str(tmp_path / "T")
    jrepo = JRepository(jbody, root=J, keep_history=True)
    trepo = TRepository(_t(jbody), root=T, keep_history=True, mesh=_mesh())
    rng = np.random.default_rng(6)
    _upload(jrepo, trepo, _cohort(jbody, rng))
    jrepo.fuse_pending()
    trepo.fuse_pending()
    one = _cohort(jbody, rng, n=1)[0]
    jrec = jrepo.contribute_async(jax.tree.map(jnp.asarray, one))
    tmesh.reset_collectives()
    trec = trepo.contribute_async(convert.from_jax_params(one, "cpu"))
    assert tmesh.collectives == {"all_reduce": 1, "all_gather": 1}
    assert trec.op == jrec.op and trepo.iteration == jrepo.iteration == 2
    _rows_close(_trow(trepo), _jrow(jrepo))
    # fuse_pending(buffer=) with the reference's [K, S, L] layout
    rows = [trepo._spec.flatten(convert.from_jax_params(u, "cpu"))
            for u in _cohort(jbody, rng, n=2)]
    jrepo.fuse_pending(buffer=jnp.stack([jnp.asarray(r.numpy()) for r in rows]), alpha=0.5,
                       screen=False, op="x")
    trepo.fuse_pending(buffer=trepo._sspec.shard(torch.stack(rows)), alpha=0.5, screen=False,
                       op="x")
    _rows_close(_trow(trepo), _jrow(jrepo))
    with pytest.raises(ValueError, match="sharded layout"):
        trepo.fuse_pending(buffer=torch.stack(rows))
    # the same operand as S per-shard stacks gives the same bits
    shards = StagedBuffer.from_rows([trepo._stage_row(r) for r in rows])
    before = _trow(trepo)
    trepo.rollback(2)
    trepo.fuse_pending(buffer=shards, alpha=0.5, screen=False, op="x")
    np.testing.assert_array_equal(_trow(trepo), before)
    # rollback to a base on disk and from memory, then compact
    jrepo.rollback(1)
    trepo.rollback(1)
    _rows_close(_trow(trepo), _jrow(jrepo))
    assert trepo._base_shards is not None and len(trepo._base_shards) == 8
    _upload(jrepo, trepo, _cohort(jbody, rng))
    jrepo.fuse_pending()
    trepo.fuse_pending()
    _rows_close(_trow(trepo), _jrow(jrepo))
    assert trepo.compact(keep_bases=1) == jrepo.compact(keep_bases=1)
    assert sorted(os.listdir(T)) == sorted(os.listdir(J))
