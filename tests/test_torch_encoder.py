"""The port's encoder training path against the JAX package's, with the JAX
params carried across: forward (classify, mlm_logits), loss, gradients,
one clipped AdamW step and four finetune steps.

Everything runs in f32 on the CPU.  Tolerance atol 1e-5 for one pass (XLA
and PyTorch sum matmuls in different orders: ~1e-6 at these widths), and
1e-4 after four finetune steps, where those differences pass through
Adam's normalisation step after step.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.roberta_base import TINY as JTINY
from repro.models import encoder as JE
from repro.models import layers as JL
from repro.optim import optimizers as JO
from repro.train import finetune as JFT
from repro.train import losses as JLOSS
from repro_torch import convert
from repro_torch.configs import TINY
from repro_torch.models import encoder as TE
from repro_torch.models import layers as TL
from repro_torch.optim import optimizers as TO
from repro_torch.train import finetune as TFT
from repro_torch.train import losses as TLOSS
from repro_torch.utils.pytree import tree_leaves_with_path, tree_map

SHAPE = dict(d_model=64, num_heads=2, num_kv_heads=2, head_dim=32, d_ff=128,
             vocab_size=256, max_seq_len=32)
JCFG = dataclasses.replace(JTINY, **SHAPE)
TCFG = dataclasses.replace(TINY, **SHAPE)
B, S, C = 8, 16, 3


def _t(tree):
    return convert.from_jax_params(jax.tree.map(np.asarray, tree), "cpu")


def _assert_close(t_tree, j_tree, atol):
    if isinstance(t_tree, dict):
        tl, jl = dict(tree_leaves_with_path(t_tree)), dict(tree_leaves_with_path(_t(j_tree)))
    else:
        tl, jl = {"": t_tree}, {"": convert.from_numpy(np.asarray(j_tree), "cpu")}
    assert tl.keys() == jl.keys()
    for k in tl:
        np.testing.assert_allclose(tl[k].detach().float().numpy(), jl[k].float().numpy(),
                                   atol=atol, rtol=0, err_msg=k)


@pytest.fixture(scope="module")
def setup():
    body = JE.init_encoder_body(JCFG, jax.random.PRNGKey(0))
    head = JE.init_cls_head(JCFG, jax.random.PRNGKey(1), C)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, SHAPE["vocab_size"], size=(B, S)).astype(np.int32)
    labels = rng.integers(0, C, size=(B,)).astype(np.int32)
    return body, head, tokens, labels


def test_gelu_is_tanh_approximation():
    x = np.linspace(-6, 6, 101).astype(np.float32)
    got = TL.activation("gelu")(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax.nn.gelu(x)), atol=1e-6)
    exact = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(got - exact).max() > 1e-4  # the two really differ


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_f32_biased_variance(dtype):
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(4, 64)) * 3 + 1).astype(np.float32).astype(
        jnp.bfloat16 if dtype == "bfloat16" else np.float32)
    p = {"scale": rng.normal(size=(64,)).astype(np.float32),
         "bias": rng.normal(size=(64,)).astype(np.float32)}
    got = TL.norm_fwd(TCFG, _t(p), convert.from_numpy(x, "cpu"))
    want = JL.norm_fwd(JCFG, jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    assert got.dtype == convert.from_numpy(x, "cpu").dtype
    tol = 1e-5 if dtype == "float32" else 1e-2
    _assert_close(got, want, tol)


def test_attention_matches_reference(setup):
    body = setup[0]
    rng = np.random.default_rng(2)
    x = rng.normal(size=(B, S, SHAPE["d_model"])).astype(np.float32)
    p = body["layers"]["layer0"]["attn"]
    got, cache = TL.attention_fwd(TCFG, _t(p), torch.from_numpy(x), causal=False)
    assert cache is None
    want, _ = JL.attention_fwd(JCFG, p, jnp.asarray(x), angles=None, causal=False)
    _assert_close(got, want, 1e-5)


def test_classify_and_mlm_logits(setup):
    body, head, tokens, _ = setup
    tok = torch.from_numpy(tokens).long()
    _assert_close(TE.classify(TCFG, _t(body), _t(head), tok),
                  JE.classify(JCFG, body, head, jnp.asarray(tokens)), 1e-5)
    _assert_close(TE.mlm_logits(TCFG, _t(body), tok),
                  JE.mlm_logits(JCFG, body, jnp.asarray(tokens)), 1e-5)


def test_cls_loss_and_accuracy(setup):
    _, _, _, labels = setup
    logits = np.random.default_rng(3).normal(size=(B, C)).astype(np.float32)
    tl, jl = torch.from_numpy(logits), jnp.asarray(logits)
    lab = torch.from_numpy(labels).long()
    assert float(TLOSS.cls_loss(tl, lab)) == pytest.approx(
        float(JLOSS.cls_loss(jl, jnp.asarray(labels))), abs=1e-6)
    assert float(TLOSS.accuracy(tl, lab)) == float(JLOSS.accuracy(jl, jnp.asarray(labels)))
    mask = (np.arange(B) % 2).astype(np.float32)
    assert float(TLOSS.softmax_xent(tl, lab, torch.from_numpy(mask))) == pytest.approx(
        float(JLOSS.softmax_xent(jl, jnp.asarray(labels), jnp.asarray(mask))), abs=1e-6)


def _jax_loss(trainable, tokens, labels):
    logits = JE.classify(JCFG, trainable["body"], trainable["head"], tokens)
    return JLOSS.cls_loss(logits, labels)


def _torch_grads(trainable, tokens, labels):
    leaves = [p for _, p in tree_leaves_with_path(trainable)]
    for p in leaves:
        p.requires_grad_(True)
    loss = TLOSS.cls_loss(TE.classify(TCFG, trainable["body"], trainable["head"], tokens),
                          labels)
    grads = torch.autograd.grad(loss, leaves)
    paths = [k for k, _ in tree_leaves_with_path(trainable)]
    return loss, dict(zip(paths, grads))


def test_gradients(setup):
    body, head, tokens, labels = setup
    jtr = {"body": body, "head": head}
    jloss, jgrads = jax.value_and_grad(_jax_loss)(jtr, jnp.asarray(tokens), jnp.asarray(labels))
    tloss, tgrads = _torch_grads(_t(jtr), torch.from_numpy(tokens).long(),
                                 torch.from_numpy(labels).long())
    assert tloss.item() == pytest.approx(float(jloss), abs=1e-5)
    jflat = dict(tree_leaves_with_path(_t(jgrads)))
    assert tgrads.keys() == jflat.keys()
    for k in tgrads:
        np.testing.assert_allclose(tgrads[k].numpy(), jflat[k].numpy(), atol=1e-5, err_msg=k)


def test_one_clipped_adamw_step(setup):
    body, head, tokens, labels = setup
    jtr = {"body": body, "head": head}
    jgrads = jax.grad(_jax_loss)(jtr, jnp.asarray(tokens), jnp.asarray(labels))
    jopt = JO.adamw(JO.linear_decay_lr(5e-4, 0.01))
    jg, jnorm = JO.clip_by_global_norm(jgrads, 1.0)
    jupd, _ = jopt.update(jg, jopt.init(jtr), jtr)
    jnew = jax.tree.map(jnp.add, jtr, jupd)

    # the port's step gets the reference's gradients: Adam's first step
    # divides g by |g| + 1e-8, which turns the ~1e-9 gradient differences
    # test_gradients allows into ~2.5e-5 on elements with |g| near 1e-7
    ttr = _t(jtr)
    topt = TO.adamw(TO.linear_decay_lr(5e-4, 0.01))
    tg, tnorm = TO.clip_by_global_norm(_t(jgrads), 1.0)
    assert float(jnorm) > 1.0  # the clip really scales
    assert float(tnorm) == pytest.approx(float(jnorm), rel=1e-5)
    with torch.no_grad():
        tupd, state = topt.update(tg, topt.init(ttr), ttr)
        tnew = tree_map(torch.add, ttr, tupd)
    assert state["step"] == 1
    _assert_close(tnew, jnew, 1e-5)


def test_schedules_match_reference():
    jl, tl = JO.linear_decay_lr(5e-4, 0.1, 1e-5), TO.linear_decay_lr(5e-4, 0.1, 1e-5)
    jw, tw = JO.warmup_cosine_lr(1e-3, 5, 50), TO.warmup_cosine_lr(1e-3, 5, 50)
    for step in (0, 1, 4, 5, 9, 30, 50, 80):
        assert tl(step) == pytest.approx(float(jl(jnp.asarray(step, jnp.int32))), rel=1e-6)
        assert tw(step) == pytest.approx(float(jw(jnp.asarray(step, jnp.int32))), rel=1e-6)


@pytest.mark.parametrize("frozen", [False, True])
def test_finetune_four_steps(setup, frozen):
    body, head, _, _ = setup
    rng = np.random.default_rng(5)
    x = rng.integers(0, SHAPE["vocab_size"], size=(40, S)).astype(np.int32)
    y = rng.integers(0, C, size=(40,)).astype(np.int32)
    kw = dict(steps=4, batch_size=8, lr=5e-4, frozen_body=frozen, seed=3)
    jb, jh, jm = JFT.finetune(JCFG, body, head, x, y, **kw)
    tb_in = _t(body)
    snapshot = {k: v.clone() for k, v in tree_leaves_with_path(tb_in)}
    tb, th, tm = TFT.finetune(TCFG, tb_in, _t(head), x, y, **kw)
    _assert_close(tb, jb, 1e-4)
    _assert_close(th, jh, 1e-4)
    np.testing.assert_allclose(tm["loss"], jm["loss"], atol=1e-4)
    # the caller's body is never written
    for k, v in tree_leaves_with_path(tb_in):
        assert torch.equal(v, snapshot[k]), k
    assert TFT.evaluate(TCFG, tb, th, x, y) == JFT.evaluate(JCFG, jb, jh, x, y)
