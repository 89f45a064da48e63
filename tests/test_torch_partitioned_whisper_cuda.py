"""The encoder-decoder (whisper) partitioned on the card against the same
steps on the CPU (whose results ``tests/test_torch_partitioned_whisper.py``
holds against the JAX package's partitioned jit).  Reduced whisper-tiny in
f32 at d 128 (4 heads of 32 on 2 KV heads, 2 + 2 layers, 16 frames, vocab
512) on a (data 2, model 2) grid; on one card every slot is ``cuda:0``.
Imports neither JAX nor the JAX package:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_partitioned_whisper_cuda.py

Each test skips without a card.  Tolerances (f32, TF32 off): one SGD train
step's loss and grad_norm within rtol 1e-5, its params within rtol / atol
1e-5 (the train step runs ``_sdpa`` on both); the greedy tokens equal and
the last-position logits of the prompt and each decode step within rtol /
atol 1e-5 (the kernels sum in another order than the plain versions); each
slot launches the kernel once an encoder layer and twice a decoder layer
and step, on the route its own heads take; the collectives equal the
CPU's."""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduce_config
from repro_torch.kernels import flash_attention as tfa
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding as tsh
from repro_torch.models import whisper as TW
from repro_torch.optim import constant_lr, make_optimizer
from repro_torch.train.step import make_serve_step, make_train_state, make_train_step
from repro_torch.utils.placed import Placed
from repro_torch.utils.pytree import tree_leaves_with_path

B, S, P, NEW = 4, 8, 4, 8
MAX_LEN = P + NEW
CFG = reduce_config(get_config("whisper-tiny"))


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the partitioned steps place their blocks there")
    torch.backends.cuda.matmul.allow_tf32 = False


def _inputs():
    rng = np.random.default_rng(33)
    return (rng.integers(3, CFG.vocab_size, (B, S)),
            rng.standard_normal((B, CFG.encoder_seq, CFG.d_model)).astype(np.float32),
            rng.integers(3, CFG.vocab_size, (B, P)))


def _placed(device):
    mesh = tmesh.make_mesh((2, 2), ("data", "model"), device=device)
    params = TW.init_whisper(CFG, torch.Generator().manual_seed(0), device="cpu")
    return mesh, params, tsh.params_shardings(mesh, params, CFG)


def _train(device):
    mesh, params, psh = _placed(device)
    toks, frames, _ = _inputs()
    opt = make_optimizer("sgd", constant_lr(0.05), momentum=0.9)
    state = make_train_state(params, opt)
    state = tsh.device_put(state, {"params": psh,
                                   "opt": tsh.opt_state_shardings(mesh, state["opt"], psh)})
    assert state["params"]["dec"]["embed"].device.type == torch.device(device).type
    tmesh.reset_collectives()
    state, m = make_train_step(CFG, opt)(state, {"tokens": toks, "frames": frames})
    counts = dict(tmesh.collectives)
    params = {k: v.cpu() for k, v in tree_leaves_with_path(tsh.gather(state["params"]))}
    return float(m["loss"]), float(m["grad_norm"]), params, counts


def _serve(device):
    mesh, params, psh = _placed(device)
    placed = tsh.device_put(params, psh)
    _, frames, prompts = _inputs()
    dev = torch.device(device)
    frames = torch.from_numpy(frames).to(dev)
    tfa.reset_launches()
    tmesh.reset_collectives()
    cache = TW.init_whisper_cache(CFG, B, MAX_LEN, device=device)
    cache = tsh.device_put(cache, tsh.cache_shardings(mesh, cache, CFG))
    cache = TW.prime_cross_cache(CFG, placed, cache, TW.whisper_encode(CFG, placed, frames))
    assert isinstance(cache["layer0"]["xk"], Placed)
    step = make_serve_step(CFG)
    with torch.inference_mode():
        lg, cache = step(placed, cache, torch.as_tensor(prompts, device=dev), 0)
        logits, toks = [lg.cpu()], [torch.argmax(lg, -1)]
        for t in range(1, NEW):
            lg, cache = step(placed, cache, toks[-1][:, None], P + t - 1)
            logits.append(lg.cpu())
            toks.append(torch.argmax(lg, -1))
    routes = dict(tfa.flash_attention.launches_by_route)
    return (torch.stack(toks, 1).cpu().numpy(), torch.stack(logits, 1), routes,
            dict(tmesh.collectives))


@pytest.mark.cuda
def test_partitioned_whisper_train_step_on_the_card_equals_the_cpu():
    _card()
    loss, gnorm, params, counts = _train("cuda")
    loss_c, gnorm_c, params_c, counts_c = _train("cpu")
    np.testing.assert_allclose(loss, loss_c, rtol=1e-5)
    np.testing.assert_allclose(gnorm, gnorm_c, rtol=1e-5)
    for k, v in params_c.items():
        np.testing.assert_allclose(params[k].numpy(), v.numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    assert counts == counts_c


@pytest.mark.cuda
def test_partitioned_whisper_serve_on_the_card_equals_the_cpu():
    _card()
    toks, logits, routes, counts = _serve("cuda")
    toks_c, logits_c, _, counts_c = _serve("cpu")
    np.testing.assert_array_equal(toks, toks_c)
    np.testing.assert_allclose(logits.numpy(), logits_c.numpy(), rtol=1e-5, atol=1e-5)
    assert counts == counts_c
    want = dict.fromkeys(tfa.COUNTED, 0)
    slots, hq = 4, CFG.num_heads // 2
    want[tfa.route(torch.float32, CFG.encoder_seq, hq, hq)] += slots * CFG.encoder_layers
    for sq in [P] + [1] * (NEW - 1):
        want[tfa.route(torch.float32, sq, hq, hq)] += slots * 2 * CFG.num_layers
    want["decode_combine"] = want["decode"]
    assert routes == want
