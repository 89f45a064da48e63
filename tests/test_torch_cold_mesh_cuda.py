"""The model-side ColD mesh on the card at reduced width (gemma3-1b cut to
2 layers of d 64, f32) against the same calls on the CPU: the cold step
(SGD with momentum, C = 2 slabs placed whole on a (2, 1, 1) mesh of the
cards there are, where on two or more cards the two slabs sit on two
cards, and partitioned over each slab's slots of a (2, 2, 2) mesh) and
both fuse paths, with the collective counts.  Imports neither JAX nor the JAX
package:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cold_mesh_cuda.py

Each test skips without a card.  Tolerances: the card's slabs and fuses
against the CPU's within rtol 1e-5 / atol 1e-5 after 2 SGD steps (TF32
off), as ``tests/test_torch_lm_train_cuda.py`` holds a gemma3 step; SGD,
since AdamW's first update g / (|g| + eps) amplifies a last-bit gradient
difference near eps (ROADMAP.md §C; phase 16 of ``chip_smoke.py`` holds
the AdamW cold step on the card against the plain step bit for bit).  On
the card the flat fuse equals the per-leaf fuse bit for bit at C = 2."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduce_config
from repro_torch.core import distributed as D
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding as tsh
from repro_torch.models import transformer as TT
from repro_torch.optim import constant_lr, make_optimizer
from repro_torch.train import make_train_state
from repro_torch.utils.pytree import tree_leaves_with_path


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the model-side mesh places slabs on it")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _on_cpu(placed):
    """A placed tree's slabs, each on its own card, stacked on the CPU."""
    return {k: torch.stack([x.cpu() for x in v])
            for k, v in tree_leaves_with_path(tsh.gather(placed))}


def _run(device, shape=(2, 1, 1)):
    """Two cold steps (SGD with momentum), then a flat and a per-leaf fuse
    at alpha 1 and 0.5, on a cold mesh of ``device``; collectives counted
    per call."""
    cfg = reduce_config(get_config("gemma3-1b"), d_model=64)
    cfg = dataclasses.replace(cfg, num_layers=2, pattern=cfg.pattern[:2])
    opt = make_optimizer("sgd", constant_lr(0.05), momentum=0.9)
    mesh = tmesh.make_cold_mesh(contributors=shape[0], replicas=shape[1], model=shape[2],
                                device=device)
    params = TT.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    state = D.stack_for_contributors(make_train_state(params, opt), 2)
    toks = np.random.default_rng(3).integers(3, cfg.vocab_size, (2, 2, 4, 16))
    state_sh, batch_sh = D.cold_shardings(mesh, cfg, state, {"tokens": toks[0]})
    state = tsh.device_put(state, state_sh)
    step = D.make_cold_train_step(cfg, opt)
    tmesh.reset_collectives()
    for i in range(2):
        state, _ = step(state, tsh.device_put({"tokens": toks[i]}, batch_sh))
    counts = {"steps": dict(tmesh.collectives)}
    fused = {}
    for flat in (True, False):
        for alpha in (1.0, 0.5):
            tmesh.reset_collectives()
            f = D.make_fuse_step(cfg, mesh, D.ColdSchedule(alpha=alpha), flat=flat)(
                state["params"])
            counts[(flat, alpha)] = dict(tmesh.collectives)
            fused[(flat, alpha)] = _on_cpu(f)
    slabs = _on_cpu(state["params"])
    return slabs, fused, counts


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 1, 1), (2, 2, 2)])
def test_cold_step_and_fuses_on_the_card_match_the_cpu(shape):
    """Slabs whole on (2, 1, 1): no collective in the steps; partitioned on
    (2, 2, 2): the same counts on the card as on the CPU, the flat fuse
    gathering each slab to its home first."""
    _card()
    g_slabs, g_fused, g_counts = _run("cuda", shape)
    c_slabs, c_fused, c_counts = _run("cpu", shape)
    assert g_counts == c_counts
    partitioned = shape != (2, 1, 1)
    if not partitioned:
        assert g_counts["steps"] == {"all_reduce": 0, "all_gather": 0, "reduce_scatter": 0}
    for alpha in (1.0, 0.5):
        assert g_counts[(True, alpha)] == {"all_reduce": 1, "all_gather": 4 if partitioned else 2,
                                           "reduce_scatter": 0}
        assert g_counts[(False, alpha)]["all_reduce"] == len(g_slabs)
    for k in c_slabs:
        np.testing.assert_allclose(g_slabs[k].numpy(), c_slabs[k].numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    for key, tree in g_fused.items():
        for k, v in tree.items():
            np.testing.assert_allclose(v.numpy(), c_fused[key][k].numpy(), rtol=1e-5, atol=1e-5,
                                       err_msg=f"{key} {k}")
            assert torch.equal(v, g_fused[(not key[0], key[1])][k]), (key, k)
    assert (g_slabs["embed"][0] - g_slabs["embed"][1]).abs().max() > 0
    assert torch.equal(g_fused[(True, 1.0)]["embed"][0], g_fused[(True, 1.0)]["embed"][1])


@pytest.mark.cuda
def test_slabs_live_on_their_contributor_slots():
    _card()
    cards = torch.cuda.device_count()
    mesh = tmesh.make_cold_mesh(contributors=2, replicas=1, model=1, device="cuda")
    sh = tsh.NamedSharding(mesh, tsh.P("contrib", None))
    placed = sh.place(torch.arange(8.0).reshape(2, 4))
    # whole slabs: contributor slot c is flat slot c
    assert [p.device for p in placed] == [torch.device("cuda", c % cards) for c in range(2)]
    assert (placed[0].device != placed[1].device) == (cards > 1)
    # partitioned: slab c's blocks on its 4 slots, flat slots 4 c .. 4 c + 3
    mesh = tmesh.make_cold_mesh(contributors=2, replicas=2, model=2, device="cuda")
    sh = tsh.NamedSharding(mesh, tsh.P("contrib", None, "model"))
    placed = sh.place(torch.arange(16.0).reshape(2, 2, 4))
    for c, p in enumerate(placed):
        assert [b.device for b in p.slot_blocks()] == [torch.device("cuda", (4 * c + i) % cards)
                                                       for i in range(4)]
    whole = tsh.NamedSharding(mesh, tsh.P()).place(torch.zeros(2))
    assert whole.device == torch.device("cuda", 0)
