"""The port's training path against the JAX package's: ``constant_lr``,
``pretrain_mlm``, ``train_multitask``, ``compute_fisher``,
``Contributor(with_fisher, reset_head_each_iter)``, one ``run_cold_fusion``
iteration into a ``fusion_op="fisher"`` Repository, and the example twin.

Encoder of ``examples/cold_fusion_multitask.py`` (d 64, 2 heads of 32, d_ff
128, vocab 256, sequences of 24) in f32.  Initial bodies and heads cannot be
drawn alike (``jax.random`` vs torch), so the reference's are carried
across and the port's private training functions take them.  Tolerances:
losses rtol 1e-5, trained weights atol 1e-4 (a few Adam steps carry the
encoder's ~1e-6 gradient differences, see test_torch_encoder), each Fisher
leaf within 1e-4 × its max |F|."""
import dataclasses
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
from repro.data.synthetic import SyntheticSuite as JSuite
from repro.models import encoder as JE
from repro.optim.optimizers import constant_lr as j_constant_lr
from repro.train.finetune import compute_fisher as j_compute_fisher
from repro.train.multitask import train_multitask as j_train_multitask
from repro.train.pretrain import pretrain_mlm as j_pretrain_mlm
from repro_torch import convert
from repro_torch.configs import TINY
from repro_torch.core import Contributor as TContributor
from repro_torch.core import Repository as TRepository
from repro_torch.core import run_cold_fusion as t_run_cold_fusion
from repro_torch.data.synthetic import SyntheticSuite as TSuite
from repro_torch.models import encoder as TE
from repro_torch.optim.optimizers import constant_lr as t_constant_lr
from repro_torch.train import compute_fisher, pretrain_mlm, train_multitask
from repro_torch.train.multitask import _train_multitask
from repro_torch.train.pretrain import _pretrain_from
from repro_torch.utils.pytree import tree_leaves_with_path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQ = 24
SHAPE = dict(d_model=64, num_heads=2, num_kv_heads=2, head_dim=32, d_ff=128,
             vocab_size=256, max_seq_len=SEQ + 8)
JCFG, TCFG = dataclasses.replace(JTINY, **SHAPE), dataclasses.replace(TINY, **SHAPE)
# tasks of one head width (5 classes): the reference compiles one step for them
SAME_WIDTH = (1, 3, 7)


def _t(tree):
    return convert.from_jax_params(jax.tree.map(np.asarray, tree), "cpu")


def _suites():
    kw = dict(vocab_size=256, num_tasks=16, seed=0, noise=0.15)
    return JSuite(**kw), TSuite(**kw)


def _assert_close(t_tree, j_tree, atol=1e-4):
    got, want = dict(tree_leaves_with_path(t_tree)), dict(tree_leaves_with_path(_t(j_tree)))
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=atol, rtol=0,
                                   err_msg=k)


def _assert_fisher_close(t_tree, j_tree):
    got, want = dict(tree_leaves_with_path(t_tree)), dict(tree_leaves_with_path(_t(j_tree)))
    assert got.keys() == want.keys()
    for k in got:
        w = want[k].numpy()
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0,
                                   atol=1e-4 * float(np.abs(w).max()), err_msg=k)


def _body(seed=0):
    return JE.init_encoder_body(JCFG, jax.random.PRNGKey(seed))


def _head(seed, n):
    return JE.init_cls_head(JCFG, jax.random.PRNGKey(seed), n)


@pytest.mark.parametrize("lr", [5e-4, 2e-3])
def test_constant_lr(lr):
    t, j = t_constant_lr(lr), j_constant_lr(lr)
    for step in (0, 1, 7, 1000):
        assert np.float32(t(step)) == np.asarray(j(jnp.asarray(step, jnp.int32)))


def test_pretrain_mlm_matches_reference():
    js, ts = _suites()
    jbody, jm = j_pretrain_mlm(JCFG, js, steps=4, seq_len=SEQ)
    tbody, tm = _pretrain_from(TCFG, ts, _t(_body(0)), steps=4, batch_size=64, seq_len=SEQ,
                               lr=2e-3, seed=0)
    np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=1e-5)
    _assert_close(tbody, jbody)
    # the entry point draws its own body on the device asked for
    body, m = pretrain_mlm(TCFG, ts, steps=2, batch_size=8, seq_len=SEQ, device="cpu")
    assert body["embed"].device.type == "cpu" and np.isfinite(m["loss"]).all()


def _datasets(suite, tids=(0, 1, 2), n=48):
    out = []
    for tid in tids:
        d = suite.dataset(tid, n, 8, SEQ)
        out.append((tid, d["x_train"], d["y_train"], suite.tasks[tid].num_classes))
    return out


def test_train_multitask_matches_reference():
    # on tasks (1, 3, 7) a rare token's one gradient sits near Adam's eps and
    # one embed element drifts 1.3e-4 over 5 steps (ROADMAP.md §C.8)
    js, ts = _suites()
    seed, jbody = 3, _body(1)
    jdata, tdata = _datasets(js), _datasets(ts)
    jb, jh = j_train_multitask(JCFG, jbody, jdata, steps=6, batch_size=8, seed=seed)
    heads = {tid: _t(_head(seed * 997 + tid, n)) for tid, _, _, n in jdata}
    tb, th = _train_multitask(TCFG, _t(jbody), heads, tdata, steps=6, batch_size=8, lr=5e-4,
                              seed=seed, device="cpu")
    _assert_close(tb, jb)
    assert th.keys() == jh.keys()
    for tid in th:
        _assert_close(th[tid], jh[tid])
    # the entry point draws the heads itself, on the device asked for
    b, h = train_multitask(TCFG, tb, tdata, steps=1, batch_size=4, device="cpu")
    assert sorted(h) == [0, 1, 2] and b["embed"].device.type == "cpu"


@pytest.mark.parametrize("n_rows", [64, 20])  # 8 batches of 8 (4 used); only 2 of 4
def test_compute_fisher_matches_reference(n_rows):
    js, ts = _suites()
    jbody, jhead = _body(2), _head(5, js.tasks[0].num_classes)
    d = js.dataset(0, n_rows, 8, SEQ)
    jf = j_compute_fisher(JCFG, jbody, jhead, d["x_train"], d["y_train"], batches_n=4,
                          batch_size=8, seed=7)
    tbody = _t(jbody)
    before = {k: v.clone() for k, v in tree_leaves_with_path(tbody)}
    tf = compute_fisher(TCFG, tbody, _t(jhead), d["x_train"], d["y_train"], batches_n=4,
                        batch_size=8, seed=7, device="cpu")
    _assert_fisher_close(tf, jf)
    for k, v in tree_leaves_with_path(tbody):
        assert torch.equal(v, before[k]) and not v.requires_grad, k


def _fake_head(monkeypatch):
    """Make the port draw the reference's head for the integer its
    generator was seeded with, so the head's seed arithmetic is tested too."""
    def init_cls_head(cfg, gen, num_classes, *, device="cuda"):
        return {k: v.to(device) for k, v in
                _t(JE.init_cls_head(JCFG, jax.random.PRNGKey(gen.initial_seed()),
                                    num_classes)).items()}
    monkeypatch.setattr(TE, "init_cls_head", init_cls_head)


@pytest.mark.parametrize("reset", [False, True])
def test_contributor_with_fisher_matches_reference(monkeypatch, reset):
    _fake_head(monkeypatch)
    js, ts = _suites()
    jbody = _body(0)
    d = js.dataset(2, 32, 8, SEQ)
    # the Contributor's default lr 5e-4: at 2e-3 Adam's first step turns a
    # 1.3e-9 vs 1.8e-9 gradient into a 1.8e-4 weight difference (ROADMAP.md §C.8)
    kw = dict(steps=3, batch_size=8, seed=4, with_fisher=True, reset_head_each_iter=reset)
    n = js.tasks[2].num_classes
    jc = JContributor(JCFG, 2, n, d["x_train"], d["y_train"], **kw)
    tc = TContributor(TCFG, 2, n, d["x_train"], d["y_train"], **kw)
    jb, tb = jbody, _t(jbody)
    for it in range(2):
        jb, tb = jc.contribute(jb), tc.contribute(tb)
        _assert_close(tb, jb)
        _assert_close(tc._head, jc._head)
        _assert_fisher_close(tc.last_fisher, jc.last_fisher)
    assert tc._iter == jc._iter == 2


def test_run_cold_fusion_fisher_matches_reference(monkeypatch):
    _fake_head(monkeypatch)
    js, ts = _suites()
    jbody = _body(0)
    jc, tc = [], []
    for tid in SAME_WIDTH:
        d = js.dataset(tid, 32, 8, SEQ)
        n = js.tasks[tid].num_classes
        kw = dict(steps=3, batch_size=8, seed=tid, with_fisher=True)
        jc.append(JContributor(JCFG, tid, n, d["x_train"], d["y_train"], **kw))
        tc.append(TContributor(TCFG, tid, n, d["x_train"], d["y_train"], **kw))
    jrepo = JRepository(jbody, fusion_op="fisher")
    trepo = TRepository(_t(jbody), fusion_op="fisher")
    assert trepo.use_flat is jrepo.use_flat is False
    j_run_cold_fusion(JCFG, jrepo, jc, iterations=1)
    t_run_cold_fusion(TCFG, trepo, tc, iterations=1)
    assert trepo.history[0].n_accepted == jrepo.history[0].n_accepted == 3
    assert trepo.history[0].op == "fisher"
    _assert_close(trepo.download(), jrepo.download())


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the entry points would run on it")
    _, ts = _suites()
    tbody = TE.init_encoder_body(TCFG, torch.Generator().manual_seed(0), device="cpu")
    head = TE.init_cls_head(TCFG, torch.Generator().manual_seed(1), 3, device="cpu")
    x, y = np.zeros((8, SEQ), np.int32), np.zeros(8, np.int32)
    for call in (lambda: pretrain_mlm(TCFG, ts, steps=1),
                 lambda: train_multitask(TCFG, tbody, [(0, x, y, 3)], steps=1),
                 lambda: compute_fisher(TCFG, tbody, head, x, y)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_example_twin_rejects_both_attacks():
    path = os.path.join(ROOT, "examples", "cold_fusion_multitask_torch.py")
    # one torch thread, as tests/test_torch_examples.py runs the twins: with a
    # thread a core the twin's small ops took 50 s to over 300 s on a loaded
    # 8-core host, against 7 s on one thread
    env = dict(os.environ, PYTHONPATH="", OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, path, "--dry-run", "--device", "cpu"],
                          capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "fused 3/5 contributions (rejected 2 anomalous uploads)" in proc.stdout
    assert "fused 3/3 contributions (op=average)" in proc.stdout
