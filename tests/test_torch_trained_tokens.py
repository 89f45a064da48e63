"""Greedy tokens of both packages' ``Engine`` on trained weights (the token
check on random weights is weak: they amplify last-bit differences).

A reduced gemma3-1b (window 8 over 8 layers) and a reduced rwkv6-7b, f32,
are trained with the reference's ``make_train_step`` (AdamW, the launcher's
warmup-cosine schedule at lr 3e-3) for 150 steps of 8 x 64 tokens of the
launcher's synthetic stream, until the loss has clearly fallen; then the
trained params are carried across and both engines generate 4 x 32 tokens
from prompts of that stream.  A token may differ only where the reference
decides it by a margin (top-1 minus top-2 logit, teacher-forced on the
reference's tokens) below 1e-4, and only from the first such position of
its row on; the count of such tokens and the smallest margin are printed
(``pytest -s``).  Teacher-forced logits agree within 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.synthetic import SyntheticSuite
from repro.models import transformer as JT
from repro.optim import optimizers as JO
from repro.serve.engine import Engine as JEngine
from repro.train import step as JS
from repro_torch import convert
from repro_torch.models import transformer as TT
from repro_torch.serve.engine import Engine as TEngine
from test_torch_lm import _cfgs  # reduced gemma3 with a window of 8 over 8 layers

STEPS, BATCH, SEQ, LR = 150, 8, 64, 3e-3
PROMPT, NEW = 16, 32
MARGIN = 1e-4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch intra-op thread: the suite runs several workers on a few
    cores, and torch's BLAS threads spin-wait, so a many-threaded test can
    stall the other workers' tests."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("arch", ["gemma3-1b", "rwkv6-7b"])
def test_trained_model_tokens_match_reference(arch):
    jcfg, tcfg = _cfgs(arch)
    stream = SyntheticSuite(vocab_size=512, num_tasks=8, seed=0).lm_stream(
        STEPS * BATCH + 4, SEQ, seed=0)
    opt = JO.make_optimizer(jcfg.optimizer, JO.warmup_cosine_lr(LR, 20, STEPS))
    state = JS.make_train_state(JT.init_lm(jcfg, jax.random.PRNGKey(0)), opt)
    step = jax.jit(JS.make_train_step(jcfg, opt))
    losses = []
    for i in range(STEPS):
        state, m = step(state, {"tokens": jnp.asarray(stream[i * BATCH:(i + 1) * BATCH])})
        losses.append(float(m["loss"]))
    assert np.mean(losses[-10:]) < np.mean(losses[:10]) - 0.4, losses

    jp = jax.tree.map(np.asarray, state["params"])
    prompts = stream[STEPS * BATCH:, :PROMPT]
    jres = JEngine(jcfg, state["params"], max_len=PROMPT + NEW).generate(
        prompts, max_new_tokens=NEW)
    tp = convert.from_jax_params(jp, "cpu")
    tres = TEngine(tcfg, tp, max_len=PROMPT + NEW).generate(prompts, max_new_tokens=NEW)

    # the reference's logits before each generated token, on its own tokens
    jl = np.asarray(JT.forward_lm(jcfg, state["params"], jnp.asarray(jres.tokens))[0])
    jl = jl[:, PROMPT - 1:-1]
    top2 = np.sort(jl, axis=-1)[..., -2:]
    margin = top2[..., 1] - top2[..., 0]
    close = margin < MARGIN
    gen_j, gen_t = jres.tokens[:, PROMPT:], tres.tokens[:, PROMPT:]
    for row in range(len(prompts)):
        diff = np.flatnonzero(gen_j[row] != gen_t[row])
        if diff.size:
            assert close[row, :diff[0] + 1].any(), (row, diff[0], margin[row, diff[0]])
    tl = TT.forward_lm(tcfg, tp, torch.from_numpy(jres.tokens).long())[0]
    logit_diff = float(np.abs(tl.numpy()[:, PROMPT - 1:-1] - jl).max())
    assert logit_diff < 1e-4
    print(f"\n[trained] {arch}: loss {np.mean(losses[:10]):.3f} -> {np.mean(losses[-10:]):.3f}; "
          f"{int(close.sum())} of {close.size} tokens decided by a margin below {MARGIN}, "
          f"smallest margin {margin.min():.2e}; tokens equal: "
          f"{int((gen_j == gen_t).sum())} of {gen_j.size}; max |logit diff| {logit_diff:.2e}")
