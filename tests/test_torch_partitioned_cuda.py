"""The partitioned train step on the card against the same step on the CPU
(whose results ``tests/test_torch_partitioned.py`` holds against the JAX
package's partitioned jit), on the same placed state with SGD: reduced
gemma3-1b on a (replica 2, model 2) grid (its one KV head gathered over
``model``) and reduced mistral-nemo-12b with ``fsdp=True`` (FSDP over
``replica``), microbatches 1 and 2.  On one card every slot is ``cuda:0``;
on several the slots spread over them (``launch.mesh.make_mesh``).
Imports neither JAX nor the JAX package:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_partitioned_cuda.py

Each test skips without a card.  Tolerances (f32, TF32 off; the card sums
in another order): loss and grad_norm within 1e-5 relative, params after
2 SGD steps within rtol 1e-5 / atol 1e-5, as
``tests/test_torch_lm_train_cuda.py`` holds a gemma3 step; the collective
counts equal."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduce_config
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding as tsh
from repro_torch.models.transformer import init_lm
from repro_torch.optim import constant_lr, make_optimizer
from repro_torch.train import make_train_state, make_train_step
from repro_torch.utils.placed import Placed
from repro_torch.utils.pytree import tree_leaves_with_path


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the partitioned step places its blocks there")
    torch.backends.cuda.matmul.allow_tf32 = False


def _run(device, arch, fsdp, microbatches):
    cfg = reduce_config(get_config(arch), d_model=64)
    cfg = dataclasses.replace(cfg, num_layers=2, pattern=cfg.pattern[:2], fsdp=fsdp)
    opt = make_optimizer("sgd", constant_lr(0.05), momentum=0.9)
    mesh = tmesh.make_mesh((2, 2), ("replica", "model"), device=device)
    state = make_train_state(init_lm(cfg, torch.Generator().manual_seed(0), device="cpu"), opt)
    psh = tsh.params_shardings(mesh, state["params"], cfg, data_axis="replica",
                               model_axis="model")
    state = tsh.device_put(state, {"params": psh,
                                   "opt": tsh.opt_state_shardings(mesh, state["opt"], psh)})
    assert isinstance(state["params"]["embed"], Placed)
    assert state["params"]["embed"].device.type == torch.device(device).type
    toks = np.random.default_rng(7).integers(3, cfg.vocab_size, (2, 4, 16))
    step = make_train_step(cfg, opt, microbatches=microbatches, grad_shardings=psh)
    metrics, counts = [], []
    for i in range(2):
        tmesh.reset_collectives()
        state, m = step(state, {"tokens": toks[i]})
        counts.append(dict(tmesh.collectives))
        metrics.append({k: float(v) for k, v in m.items()})
    params = {k: v.cpu() for k, v in tree_leaves_with_path(tsh.gather(state["params"]))}
    return params, metrics, counts


@pytest.mark.cuda
@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch, fsdp", [("gemma3-1b", False), ("mistral-nemo-12b", True)])
def test_partitioned_step_on_the_card_matches_the_cpu(arch, fsdp, microbatches):
    _card()
    g_params, g_metrics, g_counts = _run("cuda", arch, fsdp, microbatches)
    c_params, c_metrics, c_counts = _run("cpu", arch, fsdp, microbatches)
    assert g_counts == c_counts and g_counts[0]["all_reduce"] > 0
    for g, c in zip(g_metrics, c_metrics):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(g[k], c[k], rtol=1e-5, err_msg=k)
    for k, v in c_params.items():
        np.testing.assert_allclose(g_params[k].numpy(), v.numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=k)
