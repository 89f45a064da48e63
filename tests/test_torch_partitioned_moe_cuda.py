"""The partitioned MoE FFN and M-RoPE on the card against the same runs on
the CPU (whose results ``tests/test_torch_partitioned_moe.py`` holds
against the JAX package's partitioned jit), and ``flash_attention`` at the
per-slot shapes of ``chip_smoke.py``'s phase 20 against its plain version.
The models are that file's reduced cuts in f32 (mixtral with 4 heads of
32, which the kernels take): mixtral-8x7b with ``fsdp=True`` and capacity
factor 1.25 (pairs drop) on (2, 2),
granite-moe-1b-a400m on (1, 4) and qwen2-vl-72b with ``fsdp=True`` on
(2, 2), its vision prompt's ``positions`` and ``extra_embeds``.  On one
card every slot is ``cuda:0``.  Imports neither JAX nor the JAX package:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_partitioned_moe_cuda.py

Each test skips without a card.  Tolerances (f32, TF32 off): the greedy
tokens equal; the last-position logits after the prefill and each decode
step, the loss, grad_norm and aux of an SGD step and its new params within
rtol 1e-5 / atol 1e-5; the collectives equal the CPU's.  The per-slot
kernel calls in bf16 within 1 bf16 ulp + 2e-5 x max(1, max|plain|)."""
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
MODELS = {"mixtral-8x7b": (True, (2, 2)), "granite-moe-1b-a400m": (False, (1, 4)),
          "qwen2-vl-72b": (True, (2, 2))}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the partitioned steps place their blocks there")
    torch.backends.cuda.matmul.allow_tf32 = False


def _cfg(arch):
    """That file's cuts, but mixtral keeps reduce_config's 4 heads of 32:
    the kernels take head_dim 32 and up, and (2, 2) splits 4 heads."""
    cfg = reduce_config(get_config(arch))
    if arch == "mixtral-8x7b":
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=1.25))
    return dataclasses.replace(cfg, fsdp=MODELS[arch][0])


def _vision(rng, cfg, rows, n_patches, n_text):
    pos = np.zeros((3, rows, n_patches + n_text), np.int64)
    for b in range(rows):
        pos[0, b, :n_patches] = b
        pos[1, b, :n_patches] = np.arange(n_patches) // 2
        pos[2, b, :n_patches] = np.arange(n_patches) % 2
        pos[:, b, n_patches:] = 2 + 2 * b + np.arange(n_text)
    extra = (0.02 * rng.standard_normal((rows, n_patches, cfg.d_model))).astype(np.float32)
    return pos, extra


def _serve(device, arch):
    """(tokens, logits a step, collectives) of a partitioned prefill and
    NEW - 1 greedy decode steps; qwen2-vl's prompt is a vision prompt."""
    cfg = _cfg(arch)
    mesh = tmesh.make_mesh(MODELS[arch][1], ("data", "model"), device=device)
    params = TT.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    placed = tsh.device_put(params, tsh.params_shardings(mesh, params, cfg))
    rng = np.random.default_rng(29)
    prompts = rng.integers(3, cfg.vocab_size, (B, P))
    kw = {}
    if cfg.rope.kind == "mrope":
        kw["positions"], kw["extra_embeds"] = _vision(rng, cfg, B, 4, P - 4)
    eng = Engine(cfg, placed, max_len=P + NEW)
    step = TS.make_serve_step(cfg)
    tmesh.reset_collectives()
    with torch.inference_mode():
        toks, cache = eng._start(placed, prompts)
        lg = TS._partitioned_last_logits(cfg, placed, toks, cache, 0, **kw)
        out, logits = [torch.argmax(lg, -1)], [lg.cpu()]
        for t in range(1, NEW):
            lg, cache = step(placed, cache, out[-1][:, None], P + t - 1)
            out.append(torch.argmax(lg, -1))
            logits.append(lg.cpu())
    return (torch.stack(out, 1).cpu().numpy(), torch.stack(logits, 1),
            dict(tmesh.collectives))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", sorted(MODELS))
def test_partitioned_serving_on_the_card_matches_the_cpu(arch):
    _card()
    g_toks, g_logits, g_counts = _serve("cuda", arch)
    c_toks, c_logits, c_counts = _serve("cpu", arch)
    np.testing.assert_array_equal(g_toks, c_toks)
    np.testing.assert_allclose(g_logits.numpy(), c_logits.numpy(), rtol=1e-5, atol=1e-5)
    assert g_counts == c_counts


def _train(device, arch):
    cfg = _cfg(arch)
    opt = make_optimizer("sgd", constant_lr(0.05), momentum=0.9)
    mesh = tmesh.make_mesh(MODELS[arch][1], ("replica", "model"), device=device)
    params = TT.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    state = make_train_state(params, opt)
    psh = tsh.params_shardings(mesh, params, cfg, data_axis="replica", model_axis="model")
    state = tsh.device_put(state, {"params": psh,
                                   "opt": tsh.opt_state_shardings(mesh, state["opt"], psh)})
    rng = np.random.default_rng(30)
    batch = {"tokens": rng.integers(3, cfg.vocab_size, (B, S))}
    if cfg.rope.kind == "mrope":
        batch["positions"], batch["extra_embeds"] = _vision(rng, cfg, B, 4, S - 4)
    tmesh.reset_collectives()
    state, m = make_train_step(cfg, opt, microbatches=2)(state, batch)
    return ({k: float(v) for k, v in m.items()}, tsh.gather(state["params"], "cpu"),
            dict(tmesh.collectives))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", sorted(MODELS))
def test_partitioned_train_step_on_the_card_matches_the_cpu(arch):
    _card()
    g_m, g_params, g_counts = _train("cuda", arch)
    c_m, c_params, c_counts = _train("cpu", arch)
    for k in ("loss", "aux", "grad_norm"):
        np.testing.assert_allclose(g_m[k], c_m[k], rtol=1e-5, atol=1e-7, err_msg=k)
    for (name, g), c in zip(tree_leaves_with_path(g_params), tree_leaves(c_params)):
        np.testing.assert_allclose(g.numpy(), c.numpy(), rtol=1e-5, atol=1e-5, err_msg=name)
    assert g_counts == c_counts


def _bf16_close(got, want):
    g, w = got.float(), want.float()
    ulp = torch.finfo(torch.bfloat16).eps * torch.maximum(g.abs(), w.abs())
    assert bool(((g - w).abs() <= ulp + 2e-5 * max(1.0, w.abs().max().item())).all())


@pytest.mark.cuda
@pytest.mark.parametrize("Hq, Hkv, hd, Sq, Sk, window", [
    (8, 4, 64, 1024, 1056, None),    # granite-moe-1b-a400m's slot on model 2
    (16, 4, 128, 256, 272, 4096),    # mixtral-8x7b's slot
    (32, 4, 128, 512, 529, None),    # qwen2-vl-72b's slot
])
def test_flash_attention_at_the_per_slot_shapes(Hq, Hkv, hd, Sq, Sk, window):
    """bf16 prefill on ``prefill_tc`` and a decode step on ``decode``, B = 2,
    against ``flash_attention_plain``."""
    _card()
    g = torch.Generator(device="cuda").manual_seed(20)
    q, k, v = (torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
               for shape in ((2, Sq, Hq, hd), (2, Sk, Hkv, hd), (2, Sk, Hkv, hd)))
    for qq, off, route in ((q, 0, "prefill_tc"), (q[:, :1].contiguous(), Sk - 1, "decode")):
        assert tfa.route(torch.bfloat16, qq.shape[1], Hq, Hkv) == route
        got = tfa.flash_attention(qq, k, v, window=window, q_offset=off)
        _bf16_close(got, tfa.flash_attention_plain(qq, k, v, window=window, q_offset=off))
