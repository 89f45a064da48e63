"""The port's ``cold_fuse`` against the JAX package's: the plain PyTorch
version (what a CPU tensor runs) against the Pallas body in interpret mode
and against ``repro.kernels.ref.cold_fuse``, plus the fuse entry points.

Tolerances: fused to atol 2e-5 in f32 (a different summation order over K
rows) and to 1 bf16 ulp in bf16 (the f32 result may round the other way
after a different summation order); sq_diff to rtol 1e-4 (a sum over N
terms in another order).

The CUDA kernel itself is held against the plain version on the card by
``test_torch_cold_fuse_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.cold_fuse import cold_fuse as pallas_cold_fuse
from repro_torch import convert
from repro_torch.kernels import cold_fuse as tcf
from repro_torch.kernels import ops as tops
from repro_torch.utils import flat as tflat

DTYPES = {"float32": (np.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(K, N, dtype, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(N,)).astype(np.float32).astype(DTYPES[dtype][0])
    contribs = rng.normal(size=(K, N)).astype(np.float32).astype(DTYPES[dtype][0])
    w = (rng.uniform(size=(K,)) + 0.05).astype(np.float32)
    return base, contribs, w


def _torch(*arrays):
    return [convert.from_numpy(a, "cpu") for a in arrays]


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    ax = np.maximum(np.abs(x), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(ax)) - 7).astype(np.float32)


def assert_fused_close(got, want, dtype):
    got, want = _f32(got), _f32(want)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    else:
        err = np.abs(got - want)
        assert np.all(err <= _bf16_ulp(np.maximum(np.abs(got), np.abs(want)))), err.max()


@pytest.mark.parametrize("K,N", [(2, 128), (4, 1000), (8, 70_000), (16, 4096)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("alpha", [1.0, 0.3])
def test_plain_matches_pallas_and_ref(K, N, dtype, alpha):
    base, contribs, w = _inputs(K, N, dtype)
    f_t, sq_t = tcf.cold_fuse(*_torch(base, contribs, w), alpha)
    assert f_t.dtype == DTYPES[dtype][1] and sq_t.dtype == torch.float32
    f_p, sq_p = pallas_cold_fuse(jnp.asarray(base), jnp.asarray(contribs), jnp.asarray(w),
                                 alpha, block=4096, interpret=True)
    f_r, sq_r = jref.cold_fuse(jnp.asarray(base), jnp.asarray(contribs), jnp.asarray(w), alpha)
    for f_j, sq_j in ((f_p, sq_p), (f_r, sq_r)):
        assert_fused_close(f_t, f_j, dtype)
        np.testing.assert_allclose(sq_t.numpy(), np.asarray(sq_j), rtol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N", [4099, 1 << 14])
def test_zero_weight_nan_row_is_masked(dtype, N):
    # ragged N (4099) and an aligned one; row 2 is NaN with weight 0
    base, contribs, w = _inputs(4, N, dtype, seed=1)
    contribs[2] = np.nan
    w[2] = 0.0
    f_t, sq_t = tcf.cold_fuse(*_torch(base, contribs, w), 0.7)
    f_p, sq_p = pallas_cold_fuse(jnp.asarray(base), jnp.asarray(contribs), jnp.asarray(w),
                                 0.7, block=4096, interpret=True)
    assert np.isfinite(_f32(f_t)).all()
    assert_fused_close(f_t, f_p, dtype)
    assert np.isnan(sq_t[2].item()) and np.isnan(float(sq_p[2]))
    keep = [0, 1, 3]
    np.testing.assert_allclose(sq_t.numpy()[keep], np.asarray(sq_p)[keep], rtol=1e-4)


def test_zero_weight_sum_gives_nan_like_reference():
    # all weights 0: w/Σw is NaN and the reference's average is NaN too
    base, contribs, w = _inputs(3, 64, "float32")
    w[:] = 0.0
    f_t, _ = tcf.cold_fuse(*_torch(base, contribs, w))
    f_r, _ = jref.cold_fuse(jnp.asarray(base), jnp.asarray(contribs), jnp.asarray(w))
    assert np.isnan(f_t.numpy()).all() and np.isnan(np.asarray(f_r)).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fuse_flat_matches_jax_ops(dtype):
    base, contribs, w = _inputs(5, 3000, dtype, seed=2)
    tb, tc, tw = _torch(base, contribs, w)
    f_t, sq_t = tops.fuse_flat(tb, tflat.StagedBuffer(tc), tw, 0.5, donate=True)
    f_j, sq_j = jops.fuse_flat(jnp.asarray(base), jnp.asarray(contribs), jnp.asarray(w), 0.5)
    assert_fused_close(f_t, f_j, dtype)
    np.testing.assert_allclose(sq_t.numpy(), np.asarray(sq_j), rtol=1e-4)


def _trees(dtype, K=3):
    rng = np.random.default_rng(3)
    np_dt = DTYPES[dtype][0]

    def tree():
        return {"b": {"w": rng.normal(size=(7, 5)).astype(np.float32).astype(np_dt)},
                "a": rng.normal(size=(11,)).astype(np.float32).astype(np_dt)}

    return tree(), [tree() for _ in range(K)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("weights", [None, [1.0, 2.0, 0.5]])
def test_fuse_pytrees_matches_jax_ops(dtype, weights):
    base, contribs = _trees(dtype)
    j = lambda t: jax.tree.map(jnp.asarray, t)
    t = lambda tr: convert.from_jax_params(tr, "cpu")
    got, sq_t = tops.fuse_pytrees(t(base), [t(c) for c in contribs], weights, 0.8)
    want, sq_j = jops.fuse_pytrees(j(base), [j(c) for c in contribs], weights, 0.8)
    assert_fused_close(got["a"], want["a"], dtype)
    assert_fused_close(got["b"]["w"], want["b"]["w"], dtype)
    assert got["b"]["w"].dtype == DTYPES[dtype][1]
    np.testing.assert_allclose(sq_t.numpy(), np.asarray(sq_j), rtol=1e-4)


def test_cpu_calls_take_the_plain_version_and_count_nothing():
    base, contribs, w = _inputs(3, 256, "float32")
    before = tcf.cold_fuse.launches
    f1, s1 = tcf.cold_fuse(*_torch(base, contribs, w), 0.3)
    f2, s2 = tcf.cold_fuse_plain(*_torch(base, contribs, w), 0.3)
    assert torch.equal(f1, f2) and torch.equal(s1, s2)
    assert tcf.cold_fuse.launches == before


def test_wrapper_rejects_bad_operands():
    base, contribs, w = _torch(*_inputs(3, 64, "float32"))
    with pytest.raises(ValueError):
        tcf.cold_fuse(base, contribs[:, :10], w)
    with pytest.raises(ValueError):
        tcf.cold_fuse(base, contribs, w[:2])
    with pytest.raises(TypeError):
        tcf.cold_fuse(base.to(torch.bfloat16), contribs, w)
    with pytest.raises(TypeError):
        tcf.cold_fuse(base.double(), contribs.double(), w)
