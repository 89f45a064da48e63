"""The port's MoE FFN (``repro_torch.models.moe``) against the reference
``repro.models.moe`` on the CPU: the same numpy inputs and the reference's
parameters carried across bit for bit.

Tolerances: f32 outputs within 1e-5 absolute (the same products summed in
another order) and ``aux`` within 1e-6 relative; bf16 outputs within
atol 2^-6, rtol 2^-7 (both round the experts' products to bf16, in another
order); gradients of ``sum(out) + aux`` within 1e-5 absolute.  Routing
decisions must be identical: the inputs are drawn so that no top-k choice
sits within float rounding of a tie, except the zero router, whose ties
both packages break by the lower expert index.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ArchConfig as JArchConfig
from repro.configs.base import BlockCfg as JBlockCfg
from repro.configs.base import MoECfg as JMoECfg
from repro.models import moe as JMOE
from repro_torch import convert
from repro_torch.configs.base import ArchConfig, BlockCfg, MoECfg
from repro_torch.models import moe as TMOE

TOL_BF16 = dict(atol=2 ** -6, rtol=2 ** -7)


def _cfgs(routing="gshard", cap=2.0, E=4, k=2, dtype="float32"):
    """The reference's unit-test config (D 32, F 64) in both packages."""
    kw = dict(name="t", family="moe", source="t", num_layers=1, d_model=32, num_heads=2,
              num_kv_heads=2, d_ff=64, vocab_size=64, param_dtype=dtype, compute_dtype=dtype)
    moe = dict(num_experts=E, experts_per_token=k, capacity_factor=cap, routing=routing)
    return (JArchConfig(pattern=(JBlockCfg(ffn="moe"),), moe=JMoECfg(**moe), **kw),
            ArchConfig(pattern=(BlockCfg(ffn="moe"),), moe=MoECfg(**moe), **kw))


def _params(jcfg, dtype, seed=0):
    jp = jax.tree.map(np.asarray, JMOE.init_moe(jcfg, jax.random.PRNGKey(seed), dtype))
    return jp, convert.from_jax_params(jp, "cpu")


def _x(B, S, D, seed, dtype=jnp.float32):
    x = np.random.default_rng(seed).standard_normal((B, S, D)).astype(np.float32)
    return np.asarray(jnp.asarray(x, dtype))


def _t(x):
    return convert.from_numpy(np.asarray(x), "cpu")


def _np(t):
    return t.detach().float().numpy()


CASES = [("gshard", 2.0), ("gshard", 0.25), ("sort", 2.0), ("sort", 0.25), ("dense", 1.25)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("routing,cap", CASES)
def test_moe_fwd_matches_reference(routing, cap, dtype):
    jcfg, tcfg = _cfgs(routing, cap, dtype=dtype)
    jdt = jnp.dtype(dtype)
    jp, tp = _params(jcfg, jdt)
    x = _x(2, 16, 32, seed=1, dtype=jdt)
    jy, jaux = JMOE.moe_fwd(jcfg, jp, jnp.asarray(x))
    ty, taux = TMOE.moe_fwd(tcfg, tp, _t(x))
    assert ty.dtype == (torch.float32 if dtype == "float32" else torch.bfloat16)
    assert taux.dtype == torch.float32 and taux.shape == ()
    tol = dict(atol=1e-5, rtol=0) if dtype == "float32" else TOL_BF16
    np.testing.assert_allclose(_np(ty), np.asarray(jy, np.float32), **tol)
    assert float(taux) == pytest.approx(float(jaux), rel=1e-6)
    if cap == 0.25:  # tokens dropped: the output differs from the no-drop run
        _, tfull = _cfgs(routing, 2.0, dtype=dtype)
        assert (ty.float() - TMOE.moe_fwd(tfull, tp, _t(x))[0].float()).abs().max() > 1e-3


@pytest.mark.parametrize("cap", [2.0, 0.25])
def test_sort_lever_is_read_as_the_reference_reads_it(monkeypatch, cap):
    """``REPRO_OPT_MOE_SORT`` routes gshard layers through the sort path
    in both packages (the module flag, patched in both)."""
    jcfg, tcfg = _cfgs("gshard", cap)
    jp, tp = _params(jcfg, jnp.float32)
    x = _x(2, 16, 32, seed=2)
    monkeypatch.setattr(JMOE, "OPT_MOE_SORT", True)
    monkeypatch.setattr(TMOE, "OPT_MOE_SORT", True)
    jy, jaux = JMOE.moe_fwd(jcfg, jp, jnp.asarray(x))
    ty, taux = TMOE.moe_fwd(tcfg, tp, _t(x))
    np.testing.assert_allclose(_np(ty), np.asarray(jy), atol=1e-5, rtol=0)
    assert float(taux) == pytest.approx(float(jaux), rel=1e-6)
    monkeypatch.setattr(TMOE, "OPT_MOE_SORT", False)
    gshard, _ = TMOE.moe_fwd(tcfg, tp, _t(x))
    np.testing.assert_allclose(_np(gshard), _np(ty), atol=1e-5, rtol=0)


@pytest.mark.parametrize("E,k", [(4, 2), (32, 8)])
def test_zero_router_breaks_ties_like_lax_top_k(E, k):
    """Every probability ties: both packages take experts 0..k-1 for every
    token, so f_e is one-hot on expert 0 and aux = E * (1 / E) = 1."""
    jcfg, tcfg = _cfgs("gshard", cap=float(E) / k, E=E, k=k)
    jp, tp = _params(jcfg, jnp.float32)
    jp = dict(jp, router=np.zeros_like(jp["router"]))
    tp = dict(tp, router=torch.zeros_like(tp["router"]))
    x = _x(1, 64, 32, seed=5)
    _, jidx, _ = JMOE._router(jcfg, jp, jnp.asarray(x[0]))
    _, tidx, tw = TMOE._router(tcfg, tp, _t(x[0]))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(tidx.numpy(), np.broadcast_to(np.arange(k), (64, k)))
    np.testing.assert_array_equal(tw.numpy(), np.full((64, k), 1.0 / k, np.float32))
    jy, jaux = JMOE.moe_fwd(jcfg, jp, jnp.asarray(x))
    ty, taux = TMOE.moe_fwd(tcfg, tp, _t(x))
    assert float(taux) == float(jaux) == 1.0
    np.testing.assert_allclose(_np(ty), np.asarray(jy), atol=1e-5, rtol=0)


@pytest.mark.parametrize("routing,cap", CASES)
def test_moe_gradients_match_jax_grad(routing, cap):
    """d(sum(out) + aux) / d(every MoE leaf) and / dx against ``jax.grad``:
    the router's gradient flows through the top-k weights and p_e."""
    jcfg, tcfg = _cfgs(routing, cap)
    jp, tp = _params(jcfg, jnp.float32, seed=3)
    x = _x(2, 16, 32, seed=4)

    def jloss(p, xx):
        y, aux = JMOE.moe_fwd(jcfg, p, xx)
        return jnp.sum(y) + aux

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jax.tree.map(jnp.asarray, jp), jnp.asarray(x))
    live = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    xt = _t(x).requires_grad_(True)
    y, aux = TMOE.moe_fwd(tcfg, live, xt)
    (y.sum() + aux).backward()
    assert sorted(live) == sorted(jg) == ["router", "w_down", "w_gate", "w_up"]
    for name in live:
        np.testing.assert_allclose(live[name].grad.numpy(), np.asarray(jg[name]), atol=1e-5,
                                   rtol=0, err_msg=name)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), atol=1e-5, rtol=0)
    assert live["router"].grad.abs().max() > 0


def test_init_moe_leaves_and_shapes_are_the_reference():
    jcfg, tcfg = _cfgs(E=4)
    jp = JMOE.init_moe(jcfg, jax.random.PRNGKey(0), jnp.float32)
    tp = TMOE.init_moe(tcfg, torch.Generator().manual_seed(0), torch.float32, "cpu")
    assert {k: tuple(v.shape) for k, v in tp.items()} == {k: v.shape for k, v in jp.items()}
    assert {k: v.dtype for k, v in tp.items()} == dict.fromkeys(jp, torch.float32)
    # each expert is its own draw, at the reference's scale 1 / sqrt(d_in)
    w = tp["w_gate"]
    assert not torch.equal(w[0], w[1])
    assert abs(float(w.std()) - 32 ** -0.5) < 0.02


def test_capacity_is_the_reference_rule():
    """capacity = max(int(cf * T * K / E), K): granite-moe-1b-a400m's prefill
    (4 x 1024 tokens, top-8 of 32, cf 1.25) gets 1280 slots, a decode step
    of 4 tokens 8, and the reduced configs (cf = E / k) T."""
    cf, E, K = 1.25, 32, 8
    assert max(int(cf * 4096 * K / E), K) == 1280
    assert max(int(cf * 4 * K / E), K) == 8
    _, tcfg = _cfgs("gshard", cap=2.0)
    T = 32
    assert max(int(tcfg.moe.capacity_factor * T * 2 / 4), 2) == T
    # the dispatch tensor is [T, E, capacity]: full at the no-drop capacity
    x = _x(2, 16, 32, seed=6)
    _, tp = _params(_cfgs()[0], jnp.float32)
    probs, idx, _ = TMOE._router(tcfg, tp, _t(x).reshape(T, 32))
    pos = TMOE._slots(idx, 4)
    assert int(pos.max()) < T and int(pos.min()) == -1
    counts = torch.bincount(idx.reshape(-1), minlength=4)
    assert [int(pos[..., e].max()) + 1 for e in range(4)] == counts.tolist()


def test_bf16_routing_probabilities_are_f32():
    jcfg, tcfg = _cfgs(dtype="bfloat16")
    _, tp = _params(jcfg, jnp.bfloat16)
    probs, idx, w = TMOE._router(tcfg, tp, _t(_x(1, 8, 32, seed=7, dtype=jnp.bfloat16))[0])
    assert probs.dtype == w.dtype == torch.float32 and idx.dtype == torch.int64
    assert torch.allclose(w.sum(-1), torch.ones(8))
    cfg = dataclasses.replace(tcfg, moe=dataclasses.replace(tcfg.moe, experts_per_token=1))
    _, _, w1 = TMOE._router(cfg, tp, _t(_x(1, 8, 32, seed=7, dtype=jnp.bfloat16))[0])
    assert torch.equal(w1, torch.ones(8, 1))
