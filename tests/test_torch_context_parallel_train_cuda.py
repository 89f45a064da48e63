"""The partitioned train step at a batch the batch axis does not divide (the
sequence split over ``data``) on the card against the same steps on the
CPU (whose results ``tests/test_torch_context_parallel_train.py`` holds
against the JAX package's partitioned jit), one reduced case per mixer:
gemma3-1b (attention) at B = 1 in both layouts, rwkv6-7b (the RWKV state
chained over the chunks) and jamba (Mamba, attention and MoE), f32 with
``fsdp=True`` on (data 2, model 2); the eval step on placed params at
B = 1, on the kernels (gemma3-1b in both layouts, with a mask across the
chunk edge, and granite-moe, at d 128); and qwen2-vl's vision prefill with
M-RoPE ``positions`` and ``extra_embeds`` at B = 1, then greedy decode, on
the kernels (at d 128: head_dim 32, the least they take).  On one card
every slot is ``cuda:0``.  Imports neither JAX nor the JAX package:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_context_parallel_train_cuda.py

Each test skips without a card.  Tolerances (f32, TF32 off): the loss and
grad_norm of two steps and the new params within rtol 1e-5 / atol 1e-5;
the collectives equal the CPU's; the eval loss within rtol 1e-5, with
flash_attention launched on the card; the greedy tokens equal and the logits
within rtol/atol 1e-5 (the card's kernels against the CPU's plain
versions)."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduce_config
from repro_torch.kernels import flash_attention as FA
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding as tsh
from repro_torch.models import transformer as TT
from repro_torch.optim import constant_lr, make_optimizer
from repro_torch.serve.engine import Engine
from repro_torch.train import make_eval_step, make_train_state, make_train_step
from repro_torch.train import step as TS
from repro_torch.utils.pytree import tree_leaves, tree_leaves_with_path

P, N, NEW = 8, 6, 8
# case -> (arch, sequence length)
TRAIN = {"gemma_chunks": ("gemma3-1b", 16), "gemma_whole": ("gemma3-1b", 15),
         "rwkv": ("rwkv6-7b", 16), "jamba": ("jamba-1.5-large-398b", 16)}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the partitioned steps place their blocks there")
    torch.backends.cuda.matmul.allow_tf32 = False


def _cfg(arch):
    cfg = dataclasses.replace(reduce_config(get_config(arch), d_model=64), fsdp=True)
    if arch == "jamba-1.5-large-398b":
        return cfg
    return dataclasses.replace(cfg, num_layers=2, pattern=cfg.pattern[:2])


def _train(device, case):
    arch, S = TRAIN[case]
    cfg = _cfg(arch)
    opt = make_optimizer("sgd", constant_lr(0.05), momentum=0.9)
    mesh = tmesh.make_mesh((2, 2), ("data", "model"), device=device)
    params = TT.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    state = make_train_state(params, opt)
    psh = tsh.params_shardings(mesh, params, cfg)
    state = tsh.device_put(state, {"params": psh,
                                   "opt": tsh.opt_state_shardings(mesh, state["opt"], psh)})
    batch = {"tokens": np.random.default_rng(32).integers(3, cfg.vocab_size, (1, S))}
    step = make_train_step(cfg, opt)
    tmesh.reset_collectives()
    for _ in range(2):
        state, m = step(state, batch)
    return ({k: float(v) for k, v in m.items()}, tsh.gather(state["params"], "cpu"),
            dict(tmesh.collectives))


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(TRAIN))
def test_context_parallel_train_steps_on_the_card_match_the_cpu(case):
    _card()
    g_m, g_tree, g_counts = _train("cuda", case)
    c_m, c_tree, c_counts = _train("cpu", case)
    for k in ("loss", "grad_norm", "aux"):
        np.testing.assert_allclose(g_m[k], c_m[k], rtol=1e-5, atol=1e-7, err_msg=k)
    for (name, g), c in zip(tree_leaves_with_path(g_tree), tree_leaves(c_tree)):
        np.testing.assert_allclose(g.numpy(), c.numpy(), rtol=1e-5, atol=1e-5, err_msg=name)
    assert g_counts == c_counts


# case -> (arch, sequence length, masked)
EVAL = {"gemma_chunks_masked": ("gemma3-1b", 16, True), "gemma_whole": ("gemma3-1b", 15, False),
        "granite_moe_chunks": ("granite-moe-1b-a400m", 16, False)}


def _eval(device, case):
    arch, S, masked = EVAL[case]
    cfg = reduce_config(get_config(arch), d_model=128)   # head_dim 32
    mesh = tmesh.make_mesh((2, 2), ("data", "model"), device=device)
    params = TT.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    placed = tsh.device_put(params, tsh.params_shardings(mesh, params, cfg))
    batch = {"tokens": np.random.default_rng(34).integers(3, cfg.vocab_size, (1, S))}
    if masked:  # zero a span across the edge of the two chunks
        batch["mask"] = np.ones((1, S), np.float32)
        batch["mask"][:, S // 2 - 3:S // 2 + 2] = 0.0
    tmesh.reset_collectives()
    FA.reset_launches()
    loss = float(make_eval_step(cfg)(placed, batch))
    return loss, dict(tmesh.collectives), FA.flash_attention.launches


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(EVAL))
def test_context_parallel_eval_step_on_the_card_matches_the_cpu(case):
    _card()
    g_loss, g_counts, g_launched = _eval("cuda", case)
    c_loss, c_counts, c_launched = _eval("cpu", case)
    np.testing.assert_allclose(g_loss, c_loss, rtol=1e-5)
    assert g_counts == c_counts
    assert g_launched > 0 and c_launched == 0


def _vision_serve(device):
    cfg = reduce_config(get_config("qwen2-vl-72b"), d_model=128)   # head_dim 32
    mesh = tmesh.make_mesh((2, 2), ("data", "model"), device=device)
    params = TT.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    placed = tsh.device_put(params, tsh.params_shardings(mesh, params, cfg))
    rng = np.random.default_rng(33)
    prompt = rng.integers(3, cfg.vocab_size, (1, P))
    pos = np.zeros((3, 1, P), np.int64)
    pos[1, 0, :N], pos[2, 0, :N] = np.arange(N) // 3, np.arange(N) % 3
    pos[:, 0, N:] = 4 + np.arange(P - N)
    extra = torch.from_numpy((0.02 * rng.standard_normal((1, N, cfg.d_model))).astype(np.float32))
    eng = Engine(cfg, placed, max_len=P + NEW)
    step = TS.make_serve_step(cfg)
    with torch.inference_mode():
        toks, cache = eng._start(placed, prompt)
        lg = TS._partitioned_last_logits(cfg, placed, toks, cache, 0, positions=pos,
                                         extra_embeds=extra)
        out, logits = [torch.argmax(lg, -1)], [lg.cpu()]
        for t in range(1, NEW):
            lg, cache = step(placed, cache, out[-1][:, None], P + t - 1)
            out.append(torch.argmax(lg, -1))
            logits.append(lg.cpu())
    return torch.stack(out, 1).cpu().numpy(), torch.stack(logits, 1)


@pytest.mark.cuda
def test_vision_serving_at_batch_1_on_the_card_matches_the_cpu():
    _card()
    g_toks, g_logits = _vision_serve("cuda")
    c_toks, c_logits = _vision_serve("cpu")
    np.testing.assert_array_equal(g_toks, c_toks)
    np.testing.assert_allclose(g_logits.numpy(), c_logits.numpy(), rtol=1e-5, atol=1e-5)
