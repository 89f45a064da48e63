"""The partitioned Mamba mixer (jamba), the RWKV train step and adafactor
over placed leaves on the card against the same runs on the CPU (whose
results ``tests/test_torch_partitioned_ssm.py`` holds against the JAX
package's partitioned jit), and ``flash_attention`` at the per-slot shape
of ``chip_smoke.py``'s phase 21 against its plain version.  The models are
that file's reduced cuts in f32 with ``fsdp=True``: jamba-1.5-large-398b
served on (2, 2) and (1, 4) and trained with adafactor on (2, 2) at two
microbatches, rwkv6-7b trained with SGD on (2, 2).  On one card every slot
is ``cuda:0``.  Imports neither JAX nor the JAX package:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_partitioned_ssm_cuda.py

Each test skips without a card.  Tolerances (f32, TF32 off): the greedy
tokens equal; the last-position logits after the prefill and each decode
step, the loss and grad_norm of a step and its new params (and adafactor's
statistics) within rtol 1e-5 / atol 1e-5; the collectives equal the
CPU's.  The per-slot kernel calls in bf16 within 1 bf16 ulp + 2e-5 x
max(1, max|plain|)."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduce_config
from repro_torch.kernels import flash_attention as tfa
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding as tsh
from repro_torch.models import transformer as TT
from repro_torch.optim import constant_lr, make_optimizer
from repro_torch.serve.engine import Engine
from repro_torch.train import make_train_state, make_train_step
from repro_torch.train import step as TS
from repro_torch.utils.pytree import tree_leaves, tree_leaves_with_path

B, P, NEW, S = 4, 6, 7, 16
JAMBA = "jamba-1.5-large-398b"
TRAIN = {JAMBA: ("adafactor", 1e-3, 2), "rwkv6-7b": ("sgd", 0.05, 1)}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the partitioned steps place their blocks there")
    torch.backends.cuda.matmul.allow_tf32 = False


def _cfg(arch):
    return dataclasses.replace(reduce_config(get_config(arch)), fsdp=True)


def _serve(device, grid):
    """(tokens, logits a step, collectives, the cache read whole) of a
    partitioned prefill and NEW - 1 greedy decode steps of reduced jamba."""
    cfg = _cfg(JAMBA)
    mesh = tmesh.make_mesh(grid, ("data", "model"), device=device)
    params = TT.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    placed = tsh.device_put(params, tsh.params_shardings(mesh, params, cfg))
    prompts = np.random.default_rng(30).integers(3, cfg.vocab_size, (B, P))
    eng = Engine(cfg, placed, max_len=P + NEW)
    step = TS.make_serve_step(cfg)
    tmesh.reset_collectives()
    with torch.inference_mode():
        toks, cache = eng._start(placed, prompts)
        lg, cache = step(placed, cache, toks, 0)
        out, logits = [torch.argmax(lg, -1)], [lg.cpu()]
        for t in range(1, NEW):
            lg, cache = step(placed, cache, out[-1][:, None], P + t - 1)
            out.append(torch.argmax(lg, -1))
            logits.append(lg.cpu())
    return (torch.stack(out, 1).cpu().numpy(), torch.stack(logits, 1),
            dict(tmesh.collectives), tsh.gather(cache, "cpu"))


@pytest.mark.cuda
@pytest.mark.parametrize("grid", [(2, 2), (1, 4)])
def test_partitioned_jamba_serving_on_the_card_matches_the_cpu(grid):
    _card()
    g_toks, g_logits, g_counts, g_cache = _serve("cuda", grid)
    c_toks, c_logits, c_counts, c_cache = _serve("cpu", grid)
    np.testing.assert_array_equal(g_toks, c_toks)
    np.testing.assert_allclose(g_logits.numpy(), c_logits.numpy(), rtol=1e-5, atol=1e-5)
    for (name, g), c in zip(tree_leaves_with_path(g_cache), tree_leaves(c_cache)):
        np.testing.assert_allclose(g.float().numpy(), c.float().numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=name)
    assert g_counts == c_counts


def _train(device, arch):
    opt_name, lr, microbatches = TRAIN[arch]
    cfg = _cfg(arch)
    opt = make_optimizer(opt_name, constant_lr(lr))
    mesh = tmesh.make_mesh((2, 2), ("replica", "model"), device=device)
    params = TT.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    state = make_train_state(params, opt)
    psh = tsh.params_shardings(mesh, params, cfg, data_axis="replica", model_axis="model")
    state = tsh.device_put(state, {"params": psh,
                                   "opt": tsh.opt_state_shardings(mesh, state["opt"], psh)})
    batch = {"tokens": np.random.default_rng(31).integers(3, cfg.vocab_size, (B, S))}
    step = make_train_step(cfg, opt, microbatches=microbatches)
    tmesh.reset_collectives()
    for _ in range(2):
        state, m = step(state, batch)
    kept = {"params": state["params"]}
    if opt_name == "adafactor":
        kept["v"] = state["opt"]["v"]
    return ({k: float(v) for k, v in m.items()}, tsh.gather(kept, "cpu"),
            dict(tmesh.collectives))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", sorted(TRAIN))
def test_partitioned_train_steps_on_the_card_match_the_cpu(arch):
    """Two steps: jamba with adafactor at two microbatches, rwkv6 with SGD."""
    _card()
    g_m, g_tree, g_counts = _train("cuda", arch)
    c_m, c_tree, c_counts = _train("cpu", arch)
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(g_m[k], c_m[k], rtol=1e-5, atol=1e-7, err_msg=k)
    for (name, g), c in zip(tree_leaves_with_path(g_tree), tree_leaves(c_tree)):
        np.testing.assert_allclose(g.numpy(), c.numpy(), rtol=1e-5, atol=1e-5, err_msg=name)
    assert g_counts == c_counts


def _bf16_close(got, want):
    g, w = got.float(), want.float()
    ulp = torch.finfo(torch.bfloat16).eps * torch.maximum(g.abs(), w.abs())
    assert bool(((g - w).abs() <= ulp + 2e-5 * max(1.0, w.abs().max().item())).all())


@pytest.mark.cuda
def test_flash_attention_at_jambas_per_slot_shape():
    """jamba's slot on model 2: 32 query heads on 4 KV heads of 128, no rope
    and no window, B = 2; bf16 prefill on ``prefill_tc`` and a decode step
    on ``decode`` against ``flash_attention_plain``."""
    _card()
    Hq, Hkv, hd, Sq, Sk = 32, 4, 128, 256, 272
    g = torch.Generator(device="cuda").manual_seed(21)
    q, k, v = (torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
               for shape in ((2, Sq, Hq, hd), (2, Sk, Hkv, hd), (2, Sk, Hkv, hd)))
    for qq, off, route in ((q, 0, "prefill_tc"), (q[:, :1].contiguous(), Sk - 1, "decode")):
        assert tfa.route(torch.bfloat16, qq.shape[1], Hq, Hkv) == route
        got = tfa.flash_attention(qq, k, v, q_offset=off)
        _bf16_close(got, tfa.flash_attention_plain(qq, k, v, q_offset=off))
