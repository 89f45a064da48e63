"""The port's §9 screen and fusion operators against the JAX package's.

The screen is host arithmetic on the same floats, so decisions must be
identical.  ``average``, ``damped`` and ``task_arithmetic`` go through each
package's flat fuse: atol 2e-6 in f32 (a different summation order over
K ≤ 4 rows of unit-scale values).  ``fisher_weighted`` and ``ties`` are per
leaf in both packages, with the same order of operations: atol 1e-6 in f32,
1 ulp in bf16."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.roberta_base import TINY as JTINY
from repro.core import fusion as jfusion
from repro.core import validation as jval
from repro.models import encoder as JE
from repro_torch import convert
from repro_torch.core import fusion as tfusion
from repro_torch.core import validation as tval
from repro_torch.utils.pytree import tree_leaves_with_path

NAN, INF = float("nan"), float("inf")

CRAFTED = [
    [1.0, 1.1, 0.9, 1.05],                 # clean cohort
    [1.0, 1.1, NAN, 0.95, 40.0],           # NaN + MAD outlier
    [1.0, INF, 1.2, 1.1],                  # inf
    [0.0, 1.0, 1.1, 0.9],                  # zero diff
    [1.0, 50.0],                           # cohort < 3: no MAD rule
    [1.0, NAN, 50.0],                      # only 2 finite: no MAD rule
    [NAN, INF],                            # all rejected
    [2.0, 2.0, 2.0, 2.0, 2.2, 2.6],        # MAD floor at 5% of the median
]


@pytest.mark.parametrize("norms", CRAFTED)
@pytest.mark.parametrize("kw", [{}, {"mad_threshold": 2.0}, {"max_norm": 1.08},
                                {"allow_zero": True}])
def test_screen_norms_matches_jax(norms, kw):
    got = tval.screen_norms(norms, **kw)
    want = jval.screen_norms(norms, **kw)
    assert got.accepted == want.accepted
    assert got.rejected == want.rejected
    assert got.reasons == want.reasons
    np.testing.assert_array_equal(np.asarray(got.diff_norms), np.asarray(want.diff_norms))


def test_norms_from_sq_matches_jax():
    sq = np.asarray([4.0, 0.0, np.nan, 1e30, 2.25], np.float32)
    got = tval.norms_from_sq(torch.from_numpy(sq))
    want = jval.norms_from_sq(jnp.asarray(sq))
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _bodies(n=4):
    cfg = dataclasses.replace(JTINY, d_model=32, num_heads=2, num_kv_heads=2, head_dim=16,
                              d_ff=64, vocab_size=64, max_seq_len=16)
    jb = [JE.init_encoder_body(cfg, jax.random.PRNGKey(i)) for i in range(n)]
    tb = [convert.from_jax_params(jax.tree.map(np.asarray, b), "cpu") for b in jb]
    return jb, tb


def _assert_trees_close(t, j, atol=2e-6):
    jl = dict(tree_leaves_with_path(convert.from_jax_params(jax.tree.map(np.asarray, j), "cpu")))
    tl = dict(tree_leaves_with_path(t))
    assert tl.keys() == jl.keys()
    for k in tl:
        np.testing.assert_allclose(tl[k].numpy(), jl[k].numpy(), atol=atol, rtol=0, err_msg=k)


@pytest.mark.parametrize("weights", [None, [1.0, 3.0, 0.5]])
def test_average_matches_jax(weights):
    jb, tb = _bodies()
    _assert_trees_close(tfusion.average(tb[1:], weights), jfusion.average(jb[1:], weights))


@pytest.mark.parametrize("alpha", [1.0, 0.3])
def test_damped_matches_jax(alpha):
    jb, tb = _bodies()
    _assert_trees_close(tfusion.damped(tb[0], tb[1:], alpha),
                        jfusion.damped(jb[0], jb[1:], alpha))


@pytest.mark.parametrize("lam", [1.0, 0.25])
def test_task_arithmetic_matches_jax(lam):
    jb, tb = _bodies()
    _assert_trees_close(tfusion.task_arithmetic(tb[0], tb[1:], lam),
                        jfusion.task_arithmetic(jb[0], jb[1:], lam), atol=1e-5)


def test_fuse_dispatch_and_errors():
    jb, tb = _bodies(3)
    _assert_trees_close(tfusion.fuse("damped", tb[0], tb[1:], alpha=0.5),
                        jfusion.fuse("damped", jb[0], jb[1:], alpha=0.5))
    _assert_trees_close(tfusion.fuse("ties", tb[0], tb[1:], density=0.5),
                        jfusion.fuse("ties", jb[0], jb[1:], density=0.5), atol=1e-6)
    jf, tf = _fishers(jb[1:], np.random.default_rng(0))
    _assert_trees_close(tfusion.fuse("fisher", tb[0], tb[1:], fishers=tf, eps=1e-6),
                        jfusion.fuse("fisher", jb[0], jb[1:], fishers=jf, eps=1e-6), atol=1e-6)
    with pytest.raises(KeyError) as got:
        tfusion.fuse("nope", tb[0], tb[1:])
    with pytest.raises(KeyError) as want:
        jfusion.fuse("nope", jb[0], jb[1:])
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError):
        tfusion.average([])
    with pytest.raises(ValueError):
        tfusion.average(tb, weights=[1.0])


def test_screen_contributions_matches_jax():
    jb, tb = _bodies(5)
    jmodels = list(jb[1:]) + [jax.tree.map(lambda x: jnp.full_like(x, jnp.nan), jb[0])]
    tmodels = list(tb[1:]) + [convert.from_jax_params(jax.tree.map(np.asarray, jmodels[-1]),
                                                      "cpu")]
    got = tval.screen_contributions(tb[0], tmodels)
    want = jval.screen_contributions(jb[0], jmodels)
    assert (got.accepted, got.rejected, got.reasons) == (want.accepted, want.rejected, want.reasons)
    np.testing.assert_allclose(got.diff_norms[:4], want.diff_norms[:4], rtol=1e-5)
    assert tval.diff_norm(tb[0], tb[1]) == pytest.approx(jval.diff_norm(jb[0], jb[1]), rel=1e-5)


def _fishers(jmodels, rng):
    """Positive Fishers as numpy trees (JAX side) and tensors (port side),
    with a block of exact zeros that every contributor shares (0 / eps)."""
    def one(x):
        f = rng.gamma(0.5, size=x.shape).astype(np.float32)
        f.reshape(-1)[:3] = 0.0
        return f
    jf = [jax.tree.map(one, m) for m in jmodels]
    return jf, [convert.from_jax_params(f, "cpu") for f in jf]


def _crafted(n=3, seed=0):
    """A base and ``n`` models on a 0.25 grid (numpy trees): every delta is
    exact, many magnitudes tie at the trim threshold and opposite deltas
    cancel exactly (sign 0)."""
    rng = np.random.default_rng(seed)
    jb, _ = _bodies(1)
    base = jax.tree.map(lambda x: (rng.integers(-8, 9, size=x.shape) * 0.5).astype(np.float32),
                        jb[0])
    models = [jax.tree.map(
        lambda b: b + (rng.integers(-4, 5, size=b.shape) * 0.25).astype(np.float32), base)
        for _ in range(n)]
    return base, models


def _cohort(kind, dtype=np.float32):
    """(JAX trees, port trees) of base + models, ``kind`` crafted or random."""
    if kind == "crafted":
        base, models = _crafted()
    else:
        jb, _ = _bodies(4)
        base, *models = [jax.tree.map(np.asarray, b) for b in jb]
    trees = [jax.tree.map(lambda x: np.asarray(x).astype(dtype), t) for t in [base] + models]
    return ([jax.tree.map(jnp.asarray, t) for t in trees],
            [convert.from_jax_params(t, "cpu") for t in trees])


def _assert_within_bf16_ulp(t, j):
    jl = dict(tree_leaves_with_path(convert.from_jax_params(jax.tree.map(np.asarray, j), "cpu")))
    tl = dict(tree_leaves_with_path(t))
    assert tl.keys() == jl.keys()
    for k in tl:
        assert tl[k].dtype == torch.bfloat16, k
        got, want = tl[k].float().numpy(), jl[k].float().numpy()
        ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126))) - 7)
        assert np.all(np.abs(got - want) <= ulp), k


@pytest.mark.parametrize("kind", ["crafted", "random"])
def test_fisher_weighted_matches_jax(kind):
    (_, *jm), (_, *tm) = _cohort(kind)
    jf, tf = _fishers(jm, np.random.default_rng(1))
    _assert_trees_close(tfusion.fisher_weighted(tm, tf), jfusion.fisher_weighted(jm, jf),
                        atol=1e-6)
    with pytest.raises(ValueError, match="one fisher per model"):
        tfusion.fisher_weighted(tm, tf[:1])


@pytest.mark.parametrize("kind", ["crafted", "random"])
@pytest.mark.parametrize("density", [0.2, 1.0])
@pytest.mark.parametrize("lam", [1.0, 0.5])
def test_ties_matches_jax(kind, density, lam):
    (jb, *jm), (tb, *tm) = _cohort(kind)
    _assert_trees_close(tfusion.ties(tb, tm, density=density, lam=lam),
                        jfusion.ties(jb, jm, density=density, lam=lam), atol=1e-6)


def test_ties_keeps_equal_magnitudes_and_drops_sign_conflicts():
    """density 0.5 keeps 3 of 6 per model; model 3 keeps 4 (three tie at 2);
    coordinate 5 cancels exactly (3 − 3), so its sign is 0 and nothing
    survives there; the counts divide coordinates 0, 1 and 3 by 2."""
    rows = [[3, -3, 1, 2, 0.5, 1], [-1, 3, 1, 2, -0.5, 3], [2, 2, 1, -2, 0.5, -3]]
    want = np.asarray([2.5, 2.5, 0.0, 2.0, 0.0, 0.0], np.float32)
    base = {"w": np.zeros(6, np.float32)}
    models = [{"w": np.asarray(r, np.float32)} for r in rows]
    got_t = tfusion.ties(convert.from_jax_params(base, "cpu"),
                         [convert.from_jax_params(m, "cpu") for m in models], density=0.5)
    got_j = jfusion.ties(jax.tree.map(jnp.asarray, base),
                         [jax.tree.map(jnp.asarray, m) for m in models], density=0.5)
    np.testing.assert_array_equal(got_t["w"].numpy(), want)
    np.testing.assert_array_equal(np.asarray(got_j["w"]), want)
    kept = [int(torch.count_nonzero(tfusion.ties_trim(torch.tensor(r, dtype=torch.float32), 0.5)))
            for r in rows]
    assert kept == [3, 3, 4]


def test_fisher_weighted_bf16_within_one_ulp():
    (_, *jm), (_, *tm) = _cohort("random", jnp.bfloat16)
    jf, tf = _fishers(jm, np.random.default_rng(2))
    _assert_within_bf16_ulp(tfusion.fisher_weighted(tm, tf), jfusion.fisher_weighted(jm, jf))


@pytest.mark.parametrize("density", [0.2, 1.0])
def test_ties_bf16_within_one_ulp(density):
    (jb, *jm), (tb, *tm) = _cohort("random", jnp.bfloat16)
    _assert_within_bf16_ulp(tfusion.ties(tb, tm, density=density, lam=0.5),
                            jfusion.ties(jb, jm, density=density, lam=0.5))
