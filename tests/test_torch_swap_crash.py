"""The hot-swap worker's kill-at-seam matrix against the port.

``tests/test_hot_swap.py``'s scenario with the port's ``Repository``,
``ColdService`` and ``ServingWorker`` on the CPU (reduced gemma3-1b, f32):
iteration 0 is served, one finetune is fused into iteration 1, and a fresh
worker is killed (``os._exit`` at the armed ``faults.crash_point``) at each
of the three ``SWAP_SEAMS`` while it adopts iteration 1.  Its state file
must still name iteration 0 (atomic writes, nothing persisted for a swap it
never completed), and a restarted worker must serve the published base:
tokens equal to an ``Engine`` on the npz that ``repository.json`` names,
the fusion exactly once.  The uninterrupted run is the control.
"""
import os
import shutil

import pytest

from _faults import SWAP_SEAMS, run_child
from repro_torch.checkpoint import io as ckpt
from repro_torch.serve.cold_service import SERVING_STATE_FILE

_SCENARIO = r'''
import os, sys
sys.path.insert(0, "src")
import numpy as np, torch
from repro_torch.checkpoint import io as ckpt
from repro_torch.configs import get_config, reduce_config
from repro_torch.core.repository import Repository
from repro_torch.models.transformer import init_lm
from repro_torch.serve.cold_service import AdmissionPolicy, ColdService, ContributorClient
from repro_torch.serve.engine import Engine
from repro_torch.serve.hot_swap import ServingWorker
from repro_torch.utils.pytree import tree_map

root, phase = sys.argv[1], sys.argv[2]
CFG = reduce_config(get_config("gemma3-1b"))
PROMPT = np.arange(2, 6, dtype=np.int64)[None, :]

if phase == "prep":
    # iteration 0 exists, a worker served it (serving_state at 0), and one
    # finetune sits durably in the queue
    params = init_lm(CFG, torch.Generator().manual_seed(0), device="cpu")
    repo = Repository(params, root=root, spill=True, screen=False)
    w = ServingWorker(CFG, root, device="cpu", max_len=16)
    w.poll_once()
    r = w.generate(PROMPT, max_new_tokens=4)
    assert r.iteration == 0, r.iteration
    ft = tree_map(lambda x: x + 0.01, params)
    ContributorClient(root, name="c0").submit(ft, base_iteration=0)
    print("PREP ok")

elif phase == "fuse":
    repo = Repository.open(root, device="cpu", spill=True)
    svc = ColdService(repo, policy=AdmissionPolicy(min_cohort=1))
    for _ in range(200):
        stt = svc.run_once()
        if (stt["iteration"] >= 1 and stt["queue_depth"] == 0 and stt["staged"] == 0
                and not stt["inflight"]):
            break
    svc.close()
    assert repo.iteration == 1, repo.iteration
    print("FUSED it=1")

elif phase == "swap":
    # armed through REPRO_CRASH_POINT: dies at one of the three swap seams
    w = ServingWorker(CFG, root, device="cpu", max_len=16)
    w.poll_once()
    print("SWAP survived")

elif phase == "verify":
    w = ServingWorker(CFG, root, device="cpu", max_len=16)
    w.poll_once()
    r = w.generate(PROMPT, max_new_tokens=4)
    meta = ckpt.load_json(os.path.join(root, "repository.json"))
    it = int(meta["iteration"])
    base = ckpt.load(os.path.join(root, "base_iter%04d.npz" % it), device="cpu")
    oracle = Engine(CFG, base, max_len=16).generate(PROMPT, max_new_tokens=4)
    assert r.iteration == it, (r.iteration, it)
    assert np.array_equal(r.tokens, oracle.tokens), "half-swapped base served"
    stt = ckpt.load_json(os.path.join(root, "serving_state.json"))
    assert stt["iteration"] == it, stt
    repo = Repository.open(root, device="cpu", spill=True)
    assert repo.iteration == it, repo.iteration
    assert len(repo.history) == it, "fusion replayed or lost"
    qdir = os.path.join(root, "queue")
    qfiles = [f for f in os.listdir(qdir) if f.endswith(".npz")] if os.path.isdir(qdir) else []
    print("DONE it=%d fused=%d qfiles=%d" % (it, len(repo.history), len(qfiles)))
'''


@pytest.fixture(scope="module")
def _prepped_root(tmp_path_factory):
    """Iteration 1 published, the worker's state at iteration 0, the queue
    collected; the swap phases never change the root, so one prep serves
    every seam (each test clones it)."""
    root = str(tmp_path_factory.mktemp("torch_swap_crash") / "repo")
    run_child(_SCENARIO, [root, "prep"])
    run_child(_SCENARIO, [root, "fuse"])
    return root


def _clone(src, tmp_path):
    dst = str(tmp_path / "repo")
    shutil.copytree(src, dst)
    return dst


@pytest.mark.slow
@pytest.mark.parametrize("point", SWAP_SEAMS)
def test_swap_crash_matrix(tmp_path, _prepped_root, point):
    root = _clone(_prepped_root, tmp_path)
    before = ckpt.load_json(os.path.join(root, SERVING_STATE_FILE))
    assert before["iteration"] == 0
    run_child(_SCENARIO, [root, "swap"], crash_at=point)
    after = ckpt.load_json(os.path.join(root, SERVING_STATE_FILE))
    assert after["iteration"] == 0, "crashed worker persisted state for a swap it never completed"
    out = run_child(_SCENARIO, [root, "verify"])
    assert "DONE it=1 fused=1 qfiles=0" in out.stdout


@pytest.mark.slow
def test_swap_uninterrupted_reference(tmp_path, _prepped_root):
    root = _clone(_prepped_root, tmp_path)
    out = run_child(_SCENARIO, [root, "swap"])
    assert "SWAP survived" in out.stdout
    after = ckpt.load_json(os.path.join(root, SERVING_STATE_FILE))
    assert after["iteration"] == 1
    out = run_child(_SCENARIO, [root, "verify"])
    assert "DONE it=1 fused=1 qfiles=0" in out.stdout
