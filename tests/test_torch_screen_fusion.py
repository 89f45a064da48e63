"""The port's §9 screen and fusion operators against the JAX package's.

The screen is host arithmetic on the same floats, so decisions must be
identical.  Fusion goes through each package's flat fuse: atol 2e-6 in f32
(a different summation order over K ≤ 4 rows of unit-scale values)."""
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
    with pytest.raises(KeyError):
        tfusion.fuse("ties", tb[0], tb[1:])
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
