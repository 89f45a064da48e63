"""The port's Mamba mixer (``models/mamba.py``) and a jamba tree against the
JAX package on the CPU: reduced jamba-1.5-large-398b (d 128, d_inner 256,
d_state 8, dt_rank 8) in f32, the reference's parameters carried across
bit for bit, inputs from numpy seeds.

Tolerances (f32): outputs, states and gradients within 1e-4 absolute and
relative (the same arithmetic in another summation order).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduce_config as jreduce_config
from repro.models import mamba as JM
from repro.models import transformer as JT
from repro.utils.flat import FlatSpec as JFlatSpec
from repro_torch import convert
from repro_torch.configs import get_config, reduce_config
from repro_torch.models import mamba as TM
from repro_torch.models import transformer as TT
from repro_torch.utils.flat import FlatSpec as TFlatSpec
from repro_torch.utils.pytree import tree_leaves_with_path

TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "jamba-1.5-large-398b"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfgs():
    return jreduce_config(jget_config(ARCH)), reduce_config(get_config(ARCH))


@functools.lru_cache(maxsize=None)
def _mamba_params():
    jcfg, _ = _cfgs()
    jp = jax.tree.map(np.asarray, JM.init_mamba(jcfg, jax.random.PRNGKey(1), jnp.float32))
    # a spread of step sizes and a nonzero conv bias, so every term moves
    rng = np.random.default_rng(0)
    jp["dt_bias"] = rng.uniform(-3.0, 0.5, jp["dt_bias"].shape).astype(np.float32)
    jp["conv_b"] = (0.1 * rng.standard_normal(jp["conv_b"].shape)).astype(np.float32)
    return jp, convert.from_jax_params(jp, "cpu")


def _x(cfg, B, S, seed):
    return np.random.default_rng(seed).standard_normal((B, S, cfg.d_model)).astype(np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               **(tol or TOL))


def _state_close(tstate, jstate):
    assert sorted(tstate) == sorted(jstate) == ["conv", "h"]
    assert tstate["h"].dtype == torch.float32
    for key in tstate:
        _close(tstate[key], jstate[key])


def test_init_mamba_has_the_reference_leaves_shapes_and_dtypes():
    jcfg, tcfg = (dataclasses.replace(c, param_dtype="bfloat16") for c in _cfgs())
    jp = JM.init_mamba(jcfg, jax.random.PRNGKey(0), jnp.bfloat16)
    tp = TM.init_mamba(tcfg, torch.Generator().manual_seed(0), torch.bfloat16, "cpu")
    assert sorted(tp) == sorted(jp)
    for k in tp:
        assert tuple(tp[k].shape) == jp[k].shape, k
        assert str(tp[k].dtype)[6:] == str(jp[k].dtype), k
    assert tp["A_log"].dtype == tp["D"].dtype == torch.float32
    # log(1..d_state): XLA's and PyTorch's log may differ in the last bit
    np.testing.assert_allclose(tp["A_log"].numpy(), np.asarray(jp["A_log"]), rtol=1e-6, atol=0)
    assert TM.d_inner(tcfg) == JM.d_inner(jcfg) == 256
    st = TM.init_mamba_state(tcfg, 3, torch.bfloat16, "cpu")
    js = JM.init_mamba_state(jcfg, 3, jnp.bfloat16)
    assert {k: (tuple(v.shape), str(v.dtype)[6:]) for k, v in st.items()} == \
        {k: (v.shape, str(v.dtype)) for k, v in js.items()}


def test_mamba_fwd_full_sequence():
    jcfg, tcfg = _cfgs()
    jp, tp = _mamba_params()
    x = _x(tcfg, 2, 12, seed=1)
    jy, js = JM.mamba_fwd(jcfg, jp, jnp.asarray(x), return_state=True)
    ty, ts = TM.mamba_fwd(tcfg, tp, torch.from_numpy(x), return_state=True)
    _close(ty, jy)
    _state_close(ts, js)
    assert TM.mamba_fwd(tcfg, tp, torch.from_numpy(x))[1] is None


def test_mamba_fwd_split_sequence_carries_the_state():
    """7 positions, then 5 resumed from the state: each half against the
    reference's, and the two halves against one forward over all 12."""
    jcfg, tcfg = _cfgs()
    jp, tp = _mamba_params()
    x = _x(tcfg, 2, 12, seed=2)
    jstate = JM.init_mamba_state(jcfg, 2, jnp.float32)
    tstate = TM.init_mamba_state(tcfg, 2, torch.float32, "cpu")
    outs = []
    for lo, hi in ((0, 7), (7, 12)):
        jy, jstate = JM.mamba_fwd(jcfg, jp, jnp.asarray(x[:, lo:hi]), state=jstate,
                                  return_state=True)
        ty, tstate = TM.mamba_fwd(tcfg, tp, torch.from_numpy(x[:, lo:hi]), state=tstate,
                                  return_state=True)
        _close(ty, jy)
        _state_close(tstate, jstate)
        outs.append(ty)
    whole, _ = TM.mamba_fwd(tcfg, tp, torch.from_numpy(x))
    _close(torch.cat(outs, 1), whole.numpy())


def test_mamba_decode_one_position_at_a_time():
    jcfg, tcfg = _cfgs()
    jp, tp = _mamba_params()
    x = _x(tcfg, 3, 6, seed=3)
    jstate = JM.init_mamba_state(jcfg, 3, jnp.float32)
    tstate = TM.init_mamba_state(tcfg, 3, torch.float32, "cpu")
    for t in range(6):
        jy, jstate = JM.mamba_fwd(jcfg, jp, jnp.asarray(x[:, t:t + 1]), state=jstate,
                                  return_state=True)
        ty, tstate = TM.mamba_fwd(tcfg, tp, torch.from_numpy(x[:, t:t + 1]), state=tstate,
                                  return_state=True)
        assert ty.shape == (3, 1, tcfg.d_model)
        _close(ty, jy)
        _state_close(tstate, jstate)


def test_mamba_gradient_matches_jax_grad():
    """d/d(params, x) of sum(y * w) for a seeded w, against ``jax.grad``."""
    jcfg, tcfg = _cfgs()
    jp, tp = _mamba_params()
    x = _x(tcfg, 2, 9, seed=4)
    w = np.random.default_rng(5).standard_normal((2, 9, tcfg.d_model)).astype(np.float32)

    def jloss(p, xx):
        return jnp.sum(JM.mamba_fwd(jcfg, p, xx)[0] * w)

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jax.tree.map(jnp.asarray, jp), jnp.asarray(x))
    live = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    (TM.mamba_fwd(tcfg, live, tx)[0] * torch.from_numpy(w)).sum().backward()
    _close(tx.grad, jgx)
    for k in live:
        scale = max(1.0, float(np.abs(np.asarray(jg[k])).max()))
        _close(live[k].grad, jg[k], rtol=1e-4, atol=1e-4 * scale)


def test_jamba_tree_flat_spec_and_f32_storage_equal_the_reference():
    """A bf16 jamba tree holds two f32 leaves per Mamba layer (A_log, D), so
    FlatSpec stores its row in f32, in both packages."""
    jcfg, tcfg = (dataclasses.replace(c, param_dtype="bfloat16") for c in _cfgs())
    jspec = JFlatSpec.from_tree(JT.init_lm(jcfg, jax.random.PRNGKey(0)))
    tparams = TT.init_lm(tcfg, torch.Generator().manual_seed(0), device="cpu")
    tspec = TFlatSpec.from_tree(tparams)
    assert tspec.to_json() == jspec.to_json()
    assert tspec.dtype == jspec.dtype == "float32"
    dtypes = {str(x.dtype)[6:] for _, x in tree_leaves_with_path(tparams)}
    assert dtypes == {"bfloat16", "float32"}
    row = tspec.flatten(tparams)
    assert row.dtype == torch.float32
    back = dict(tree_leaves_with_path(tspec.unflatten(row)))
    for key, leaf in tree_leaves_with_path(tparams):
        assert back[key].dtype == leaf.dtype and torch.equal(back[key], leaf), key
