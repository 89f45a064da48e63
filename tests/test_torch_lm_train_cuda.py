"""The LM train and eval steps on the card against the same calls on the
CPU (whose results ``test_torch_lm_train`` holds against the JAX package),
and the kernel wrappers' refusal of tensors that require grad.  Imports
neither JAX nor the JAX package:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_lm_train_cuda.py

Each test skips without a card.  Tolerances (f32, TF32 off; the card's
matmuls and reductions sum in another order): loss and grad_norm, params
after 2 SGD steps and the eval loss within ``TOL[arch]``, relative (and
absolute for params): 1e-5 for gemma3, 1e-4 for rwkv6.  rwkv6's per-head
group norm divides each head's output by sqrt(var + 64e-5), and at random
init some heads' outputs have a std near 7e-4 while others reach 50, so an
f32 rounding of the large values is divided by about 0.025 (on an NVIDIA
H100 80GB HBM3 the second step's grad_norm was 37.0585 against the CPU's
37.0594, 2.5e-5 apart).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduce_config
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.rwkv6_scan import rwkv6_scan
from repro_torch.models.transformer import init_lm
from repro_torch.optim import make_optimizer, warmup_cosine_lr
from repro_torch.train import make_eval_step, make_train_state, make_train_step
from repro_torch.utils.pytree import tree_leaves_with_path, tree_map


TOL = {"gemma3-1b": 1e-5, "rwkv6-7b": 1e-4}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _cfg(arch):
    cfg = reduce_config(get_config(arch))
    if arch == "gemma3-1b":
        pattern = tuple(dataclasses.replace(b, window=8) if b.window else b for b in cfg.pattern)
        cfg = dataclasses.replace(cfg, num_layers=8, pattern=pattern)
    return cfg


@pytest.mark.cuda
@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", ["gemma3-1b", "rwkv6-7b"])
def test_train_step_on_the_card_matches_the_cpu(arch, microbatches):
    dev = _card()
    cfg = _cfg(arch)
    params = init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    opt = make_optimizer("sgd", warmup_cosine_lr(0.05, warmup=1, total=2), momentum=0.9)
    step = make_train_step(cfg, opt, microbatches=microbatches)
    states = {d: make_train_state(tree_map(lambda x, d=d: x.to(d), params), opt)
              for d in ("cpu", dev)}
    rng = np.random.default_rng(1)
    for _ in range(2):
        toks = rng.integers(3, cfg.vocab_size, (4, 16)).astype(np.int32)
        metrics = {}
        for d in states:
            states[d], metrics[d] = step(states[d], {"tokens": toks})
        for k in ("loss", "grad_norm"):
            assert float(metrics[dev][k]) == pytest.approx(float(metrics["cpu"][k]),
                                                           rel=TOL[arch])
    card = dict(tree_leaves_with_path(states[dev]["params"]))
    for key, want in tree_leaves_with_path(states["cpu"]["params"]):
        assert card[key].is_cuda
        torch.testing.assert_close(card[key].cpu(), want, rtol=TOL[arch], atol=TOL[arch],
                                   msg=key)
    batch = {"tokens": rng.integers(3, cfg.vocab_size, (4, 16)).astype(np.int32)}
    ev = make_eval_step(cfg)
    assert float(ev(states[dev]["params"], batch)) == pytest.approx(
        float(ev(states["cpu"]["params"], batch)), rel=TOL[arch])


@pytest.mark.cuda
def test_kernel_wrappers_refuse_tensors_that_require_grad():
    dev = _card()
    q = torch.randn(1, 8, 2, 32, device=dev, requires_grad=True)
    kv = torch.randn(1, 8, 1, 32, device=dev)
    with pytest.raises(ValueError, match="flash_attention has no backward"):
        flash_attention(q, kv, kv, causal=True)
    r, k, v, logw = (torch.randn(1, 4, 2, 32, device=dev) for _ in range(4))
    u = torch.randn(2, 32, device=dev, requires_grad=True)
    with pytest.raises(ValueError, match="rwkv6_scan has no backward"):
        rwkv6_scan(r, k, v, -logw.abs(), u, torch.zeros(1, 2, 32, 32, device=dev))
