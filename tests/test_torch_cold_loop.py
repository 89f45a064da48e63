"""The port's ColD Fusion loop against the JAX package's: Repository screen +
fuse on the same cohort (NaN and runaway uploads included), a 1-iteration
``run_cold_fusion`` from the same θ₀, heads and data, the no-aliasing
contract of ``download()``, and the package's import boundary.

Tolerances: published base atol 1e-5 in f32 when both sides fuse the same
rows (summation order only), 1 bf16 ulp in bf16; atol 1e-4 after a loop
iteration, whose finetune steps carry the encoder's ~1e-6 differences
through Adam (see test_torch_encoder)."""
import ast
import dataclasses
import glob
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.roberta_base import TINY as JTINY
from repro.core import Contributor as JContributor
from repro.core import Repository as JRepository
from repro.core import run_cold_fusion as j_run_cold_fusion
from repro.core import validation as jval
from repro.data import pipeline as jpipe
from repro.data import synthetic as jsyn
from repro.models import encoder as JE
from repro_torch import convert
from repro_torch.configs import TINY
from repro_torch.core import Contributor as TContributor
from repro_torch.core import Repository as TRepository
from repro_torch.core import run_cold_fusion as t_run_cold_fusion
from repro_torch.core import validation as tval
from repro_torch.data import pipeline as tpipe
from repro_torch.data import synthetic as tsyn
from repro_torch.models import encoder as TE
from repro_torch.utils.pytree import tree_leaves_with_path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = dict(d_model=32, num_heads=2, num_kv_heads=2, head_dim=16, d_ff=64,
             vocab_size=128, max_seq_len=16)
SEQ = 12


def _cfgs(dtype="float32"):
    kw = dict(SHAPE, param_dtype=dtype, compute_dtype=dtype)
    return dataclasses.replace(JTINY, **kw), dataclasses.replace(TINY, **kw)


def _t(tree):
    return convert.from_jax_params(jax.tree.map(np.asarray, tree), "cpu")


def _leaves_f32(tree) -> dict:
    return {k: v.float().numpy() for k, v in tree_leaves_with_path(tree)}


def _assert_base_close(t_tree, j_tree, *, atol=None, bf16=False):
    got, want = _leaves_f32(t_tree), _leaves_f32(_t(j_tree))
    assert got.keys() == want.keys()
    for k in got:
        if bf16:
            ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want[k]), 2.0 ** -126))) - 7)
            assert np.all(np.abs(got[k] - want[k]) <= ulp), k
        else:
            np.testing.assert_allclose(got[k], want[k], atol=atol, rtol=0, err_msg=k)


def _cohort(jbody, dtype, rng):
    """3 honest uploads (θ₀ + small noise), one NaN, one runaway (+100·N(0,1)),
    as numpy trees both packages read."""
    np_dt = jnp.bfloat16 if dtype == "bfloat16" else np.float32
    base = jax.tree.map(lambda x: np.asarray(x, np.float32), jbody)
    honest = [jax.tree.map(lambda x: (x + 0.01 * rng.normal(size=x.shape)).astype(np_dt), base)
              for _ in range(3)]
    nan = jax.tree.map(lambda x: np.full(x.shape, np.nan, np_dt), base)
    runaway = jax.tree.map(lambda x: (x + 100.0 * rng.normal(size=x.shape)).astype(np_dt), base)
    return honest + [nan, runaway]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("op,kw", [("average", {}), ("damped", {"alpha": 0.5}),
                                   ("task_arithmetic", {"lam": 0.3})])
def test_repository_same_cohort_same_base(dtype, op, kw):
    jcfg, _ = _cfgs(dtype)
    jbody = JE.init_encoder_body(jcfg, jax.random.PRNGKey(0))
    uploads = _cohort(jbody, dtype, np.random.default_rng(1))
    jrepo = JRepository(jbody, fusion_op=op, fusion_kwargs=kw)
    trepo = TRepository(_t(jbody), fusion_op=op, fusion_kwargs=kw)
    for u in uploads:
        jrepo.upload(jax.tree.map(jnp.asarray, u))
        trepo.upload(convert.from_jax_params(u, "cpu"))
    jrec, trec = jrepo.fuse_pending(), trepo.fuse_pending()
    assert (trec.n_accepted, trec.n_contributions) == (jrec.n_accepted, jrec.n_contributions) == (3, 5)
    jrep, trep = jval.screen_norms(jrec.diff_norms), tval.screen_norms(trec.diff_norms)
    assert trep.rejected == jrep.rejected == [3, 4]
    np.testing.assert_allclose(trec.diff_norms, jrec.diff_norms, rtol=1e-4)
    _assert_base_close(trepo.download(), jrepo.download(), atol=1e-5, bf16=dtype == "bfloat16")
    assert trepo.iteration == jrepo.iteration == 1


def test_repository_upload_weights_and_history():
    jcfg, _ = _cfgs()
    jbody = JE.init_encoder_body(jcfg, jax.random.PRNGKey(2))
    uploads = _cohort(jbody, "float32", np.random.default_rng(3))[:3]
    jrepo = JRepository(jbody, keep_history=True)
    trepo = TRepository(_t(jbody), keep_history=True)
    for u, w in zip(uploads, (1.0, 2.0, 5.0)):
        jrepo.upload(jax.tree.map(jnp.asarray, u), weight=w)
        trepo.upload(convert.from_jax_params(u, "cpu"), weight=w)
    jrepo.fuse_pending()
    trepo.fuse_pending()
    assert trepo.flush() is None
    _assert_base_close(trepo.download(), jrepo.download(), atol=1e-5)
    _assert_base_close(trepo.snapshot(0), jrepo.snapshot(0), atol=0)
    with pytest.raises(RuntimeError, match="no contributions"):
        trepo.fuse_pending()


def test_repository_all_rejected_keeps_the_cohort_staged():
    jcfg, _ = _cfgs()
    jbody = JE.init_encoder_body(jcfg, jax.random.PRNGKey(0))
    for op in ("fisher", "ties", "average"):  # the engine each operator takes
        assert TRepository(_t(jbody), fusion_op=op).use_flat is JRepository(
            jbody, fusion_op=op).use_flat is (op == "average")
    bad = jax.tree.map(lambda x: np.full(x.shape, np.inf, np.float32), jbody)
    good = _cohort(jbody, "float32", np.random.default_rng(4))[0]
    jrepo, trepo = JRepository(jbody), TRepository(_t(jbody))
    for repo, conv in ((jrepo, lambda t: jax.tree.map(jnp.asarray, t)),
                       (trepo, lambda t: convert.from_jax_params(t, "cpu"))):
        repo.upload(conv(bad))
        with pytest.raises(RuntimeError, match="all contributions rejected"):
            repo.fuse_pending()
        assert repo.iteration == 0
        repo.upload(conv(good))  # the failed cohort is retried with it
    _assert_base_close(trepo.download(), jbody, atol=0)
    jrec, trec = jrepo.fuse_pending(), trepo.fuse_pending()
    assert (trec.n_accepted, trec.n_contributions) == (jrec.n_accepted, jrec.n_contributions) == (1, 2)
    _assert_base_close(trepo.download(), jrepo.download(), atol=1e-5)


def _fishers(uploads, rng):
    """A positive Fisher per upload (numpy f32 trees both packages read)."""
    return [jax.tree.map(lambda x: rng.gamma(0.5, size=x.shape).astype(np.float32), u)
            for u in uploads]


PER_LEAF = [("average", {}, {"use_flat": False}), ("fisher", {}, {}),
            ("ties", {"density": 0.2}, {}), ("ties", {"density": 1.0, "lam": 0.5}, {})]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("op,kw,engine", PER_LEAF)
def test_per_leaf_repository_same_cohort_same_base(dtype, op, kw, engine):
    """The per-leaf engine screens the trees (NaN and runaway rejected) and
    fuses the accepted ones with each package's ``fusion.fuse``."""
    jcfg, _ = _cfgs(dtype)
    jbody = JE.init_encoder_body(jcfg, jax.random.PRNGKey(0))
    uploads = _cohort(jbody, dtype, np.random.default_rng(1))
    fishers = _fishers(uploads, np.random.default_rng(2))
    jrepo = JRepository(jbody, fusion_op=op, fusion_kwargs=kw, keep_history=True, **engine)
    trepo = TRepository(_t(jbody), fusion_op=op, fusion_kwargs=kw, keep_history=True, **engine)
    assert trepo.use_flat is jrepo.use_flat is False
    for u, f in zip(uploads, fishers):
        jrepo.upload(jax.tree.map(jnp.asarray, u), jax.tree.map(jnp.asarray, f))
        trepo.upload(convert.from_jax_params(u, "cpu"), convert.from_jax_params(f, "cpu"))
    jrec, trec = jrepo.fuse_pending(), trepo.fuse_pending()
    assert (trec.n_accepted, trec.n_contributions, trec.op) == (
        jrec.n_accepted, jrec.n_contributions, jrec.op) == (3, 5, op)
    np.testing.assert_allclose(trec.diff_norms[:3], jrec.diff_norms[:3], rtol=1e-4)
    _assert_base_close(trepo.download(), jrepo.download(), atol=1e-5, bf16=dtype == "bfloat16")
    _assert_base_close(trepo.snapshot(0), jbody, atol=0)
    assert trepo.iteration == jrepo.iteration == 1 and trepo.n_staged == 0


def test_upload_takes_the_reference_positional_order():
    """``upload(params, fisher, weight)`` in both packages: a Fisher second,
    a weight third, on both engines."""
    jcfg, _ = _cfgs()
    jbody = JE.init_encoder_body(jcfg, jax.random.PRNGKey(2))
    uploads = _cohort(jbody, "float32", np.random.default_rng(3))[:3]
    fishers = _fishers(uploads, np.random.default_rng(4))
    for op in ("fisher", "average"):
        jrepo, trepo = JRepository(jbody, fusion_op=op), TRepository(_t(jbody), fusion_op=op)
        for u, f, w in zip(uploads, fishers, (1.0, 2.0, 5.0)):
            jrepo.upload(jax.tree.map(jnp.asarray, u), jax.tree.map(jnp.asarray, f), w)
            trepo.upload(convert.from_jax_params(u, "cpu"), convert.from_jax_params(f, "cpu"), w)
        jrepo.fuse_pending()
        trepo.fuse_pending()
        _assert_base_close(trepo.download(), jrepo.download(), atol=1e-5)
    # the weights were taken as weights: not the plain average
    plain = TRepository(_t(jbody))
    for u in uploads:
        plain.upload(convert.from_jax_params(u, "cpu"))
    plain.fuse_pending()
    assert not torch.equal(plain._base_flat, trepo._base_flat)


def test_per_leaf_engine_refusals_match_reference(tmp_path):
    jcfg, _ = _cfgs()
    jbody = JE.init_encoder_body(jcfg, jax.random.PRNGKey(0))
    for Repo, body in ((JRepository, jbody), (TRepository, _t(jbody))):
        with pytest.raises(ValueError, match="flat engine does not cover fusion_op='ties'"):
            Repo(body, fusion_op="ties", use_flat=True)
        with pytest.raises(ValueError, match="spill=True requires the flat engine"):
            Repo(body, fusion_op="ties", root=str(tmp_path / Repo.__module__), spill=True)
    # a missing Fisher raises at the fuse, and the cohort stays staged
    good = _cohort(jbody, "float32", np.random.default_rng(4))[:2]
    fisher = _fishers(good, np.random.default_rng(5))[0]
    jrepo = JRepository(jbody, fusion_op="fisher")
    trepo = TRepository(_t(jbody), fusion_op="fisher")
    jrepo.upload(jax.tree.map(jnp.asarray, good[0]), jax.tree.map(jnp.asarray, fisher))
    jrepo.upload(jax.tree.map(jnp.asarray, good[1]))
    trepo.upload(convert.from_jax_params(good[0], "cpu"), convert.from_jax_params(fisher, "cpu"))
    trepo.upload(convert.from_jax_params(good[1], "cpu"))
    for repo in (jrepo, trepo):
        with pytest.raises(RuntimeError, match=r"requires upload\(\.\.\., fisher=\.\.\.\)"):
            repo.fuse_pending()
        assert repo.iteration == 0 and repo.n_staged == 2
    with pytest.raises(ValueError, match="cohort sketch requires the flat engine"):
        trepo.enable_cohort_sketch()


def test_ties_root_opens_across_packages(tmp_path):
    """A ``ties`` root written by either package opens in the other at the
    same base, op, kwargs and history, and fuses on."""
    jcfg, _ = _cfgs()
    jbody = JE.init_encoder_body(jcfg, jax.random.PRNGKey(0))
    cohorts = [_cohort(jbody, "float32", np.random.default_rng(s))[:3] for s in (6, 7)]
    kw = dict(fusion_op="ties", fusion_kwargs={"density": 0.3})
    jroot, troot = str(tmp_path / "jax"), str(tmp_path / "torch")
    jrepo, trepo = JRepository(jbody, root=jroot, **kw), TRepository(_t(jbody), root=troot, **kw)
    for u in cohorts[0]:
        jrepo.upload(jax.tree.map(jnp.asarray, u))
        trepo.upload(convert.from_jax_params(u, "cpu"))
    jrepo.fuse_pending()
    trepo.fuse_pending()
    t_of_j = TRepository.open(jroot, device="cpu")
    j_of_t = JRepository.open(troot)
    for opened, writer in ((t_of_j, jrepo), (j_of_t, trepo)):
        assert (opened.fusion_op, opened.fusion_kwargs, opened.iteration, opened.use_flat) == (
            "ties", {"density": 0.3}, 1, False)
        assert [r.n_accepted for r in opened.history] == [r.n_accepted for r in writer.history]
    _assert_base_close(t_of_j.download(), jrepo.download(), atol=0)
    _assert_base_close(trepo.download(), j_of_t.download(), atol=0)
    for u in cohorts[1]:
        t_of_j.upload(convert.from_jax_params(u, "cpu"))
        j_of_t.upload(jax.tree.map(jnp.asarray, u))
    t_of_j.fuse_pending()
    j_of_t.fuse_pending()
    # and back again: each package reopens what the other just published
    _assert_base_close(TRepository.open(troot, device="cpu").download(), j_of_t.download(),
                       atol=0)
    _assert_base_close(t_of_j.download(), JRepository.open(jroot).download(), atol=0)
    _assert_base_close(t_of_j.download(), j_of_t.download(), atol=1e-5)


def _suites():
    return (jsyn.SyntheticSuite(vocab_size=SHAPE["vocab_size"], num_tasks=6, seed=0),
            tsyn.SyntheticSuite(vocab_size=SHAPE["vocab_size"], num_tasks=6, seed=0))


def test_synthetic_data_bit_identical():
    js, ts = _suites()
    np.testing.assert_array_equal(ts.phi, js.phi)
    assert [dataclasses.astuple(t) for t in ts.tasks] == [dataclasses.astuple(t) for t in js.tasks]
    for tid in range(6):
        jd, td = js.dataset(tid, 20, 10, SEQ, split_seed=1), ts.dataset(tid, 20, 10, SEQ, split_seed=1)
        for k in jd:
            np.testing.assert_array_equal(td[k], jd[k])
    np.testing.assert_array_equal(ts.lm_stream(5, SEQ), js.lm_stream(5, SEQ))
    toks = js.lm_stream(4, SEQ)
    for a, b in zip(tsyn.mask_for_mlm(toks, np.random.default_rng(0)),
                    jsyn.mask_for_mlm(toks, np.random.default_rng(0))):
        np.testing.assert_array_equal(a, b)
    x, y = np.arange(30).reshape(10, 3), np.arange(10)
    for drop in (True, False):
        tb = list(tpipe.batches(x, y, 4, rng=np.random.default_rng(2), epochs=2, drop_remainder=drop))
        jb = list(jpipe.batches(x, y, 4, rng=np.random.default_rng(2), epochs=2, drop_remainder=drop))
        assert len(tb) == len(jb)
        for a, b in zip(tb, jb):
            np.testing.assert_array_equal(a["tokens"], b["tokens"])
            np.testing.assert_array_equal(a["labels"], b["labels"])


def _contributors(js, ts, jcfg, tcfg):
    jc, tc = [], []
    for tid in range(3):
        d = js.dataset(tid, 32, 8, SEQ)
        n = js.tasks[tid].num_classes
        kw = dict(steps=3, batch_size=8, lr=2e-3, seed=tid)
        jc.append(JContributor(jcfg, tid, n, d["x_train"], d["y_train"], **kw))
        td = ts.dataset(tid, 32, 8, SEQ)
        tc.append(TContributor(tcfg, tid, ts.tasks[tid].num_classes,
                               td["x_train"], td["y_train"], **kw))
        # heads cannot be drawn alike (jax.random vs torch): carry the JAX head
        tc[-1]._head = _t(jc[-1]._ensure_head())
    return jc, tc


def test_one_iteration_run_cold_fusion_matches_reference():
    jcfg, tcfg = _cfgs()
    js, ts = _suites()
    jbody = JE.init_encoder_body(jcfg, jax.random.PRNGKey(0))
    jc, tc = _contributors(js, ts, jcfg, tcfg)
    jrepo, trepo = JRepository(jbody), TRepository(_t(jbody))
    j_run_cold_fusion(jcfg, jrepo, jc, iterations=1)
    t_run_cold_fusion(tcfg, trepo, tc, iterations=1)
    assert trepo.history[0].n_accepted == jrepo.history[0].n_accepted == 3
    _assert_base_close(trepo.download(), jrepo.download(), atol=1e-4)
    for a, b in zip(tc, jc):
        _assert_base_close(a._head, b._head, atol=1e-4)


def test_download_is_not_written_by_contributors():
    _, tcfg = _cfgs()
    _, ts = _suites()
    repo = TRepository(TE.init_encoder_body(tcfg, torch.Generator().manual_seed(0), device="cpu"))
    base = repo.download()
    before = {k: v.clone() for k, v in tree_leaves_with_path(base)}
    row_before = repo._base_flat.clone()
    d = ts.dataset(0, 32, 8, SEQ)
    c = TContributor(tcfg, 0, ts.tasks[0].num_classes, d["x_train"], d["y_train"],
                     steps=3, batch_size=8, lr=2e-3)
    body = c.contribute(base)
    assert any(not torch.equal(body[k], base[k]) for k in ("embed", "pos"))
    for k, v in tree_leaves_with_path(repo.download()):
        assert torch.equal(v, before[k]), k
    assert torch.equal(repo._base_flat, row_before)
    repo.upload(body)
    repo.upload(c.contribute(base))
    repo.fuse_pending()
    for k, v in tree_leaves_with_path(base):  # the old published tree survives the fuse
        assert torch.equal(v, before[k]), k


def _imported_modules(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_repro():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    files += glob.glob(os.path.join(ROOT, "examples", "*_torch.py"))
    assert len(files) >= 7
    for dirpath, _, names in os.walk(os.path.join(ROOT, "src", "repro_torch")):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    for mod in ("core/distributed.py", "launch/sharding.py", "kernels/ops.py",
                "data/pipeline.py", "train/step.py"):  # the model-side mesh among them
        assert os.path.join(ROOT, "src", "repro_torch", mod) in files
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro", "ml_dtypes"), (path, mod)


def test_default_device_is_the_card():
    gen = torch.Generator().manual_seed(0)
    if torch.cuda.is_available():
        assert TE.init_encoder_body(TINY, gen)["embed"].is_cuda
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TE.init_encoder_body(TINY, gen)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TE.init_cls_head(TINY, gen, 3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.from_jax_params({"x": np.zeros(3, np.float32)})


def test_chip_smoke_refuses_to_run_without_the_card_or_the_repo(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: chip_smoke.py would run for real")
    env = dict(os.environ, PYTHONPATH="")
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                          capture_output=True, text=True, env=env, cwd=ROOT, timeout=120)
    assert proc.returncode != 0 and '"ok"' not in proc.stdout
    alone = tmp_path / "chip_smoke.py"
    alone.write_text(open(os.path.join(ROOT, "chip_smoke.py"), encoding="utf-8").read())
    proc = subprocess.run([sys.executable, str(alone)], capture_output=True, text=True,
                          env=env, cwd=tmp_path, timeout=120)
    assert proc.returncode != 0 and '"ok"' not in proc.stdout
