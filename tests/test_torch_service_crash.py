"""The rest of the reference's single-base kill-at-seam matrix against the
port's daemon (``tests/test_cold_service.py``), after the lane refactor
rewrote every single-base path:

* the plain scenario's ``service.post_publish`` (its other four seams are in
  ``tests/test_torch_service.py``);
* the novelty scenario (three rows and a planted replay, the screen armed)
  at ``service.post_sketch`` and the five ``CRASH_POINTS``, and uninterrupted;
* a rider id unlike its file name, killed at ``service.post_ingest``: one
  entry re-marked, fused once;
* a contributor killed at ``client.mid_submit`` and then retried;
* the compressed scenario (two dense and two compressed rows) at the five
  ``CRASH_POINTS``, and uninterrupted.

Each run prints the reference scenario's ``DONE`` line, which must equal the
reference's expected values."""
import os
import shutil

import numpy as np
import pytest
import torch

from _faults import run_child
from repro_torch.checkpoint import io as tio
from repro_torch.core.repository import Repository
from repro_torch.serve.cold_service import QUEUE_DIR, ContributorClient
from repro_torch.utils.flat import FlatSpec
from test_cold_service import CRASH_POINTS, _NOVELTY_DONE, _assert_compressed_done

# the serve phase of every scenario: its policy, and its DONE line with the
# reference's fields
_SERVE = r'''
import os, sys
sys.path.insert(0, "src")
from repro_torch.checkpoint import io as ckpt
from repro_torch.core.repository import Repository
from repro_torch.serve.cold_service import AdmissionPolicy, ColdService

root, scenario = sys.argv[1], sys.argv[2]
policy = {"plain": dict(min_cohort=3),
          "novelty": dict(min_cohort=3, novelty_threshold=0.02, sketch_window=8),
          "odd_id": dict(min_cohort=1),
          "compressed": dict(min_cohort=4)}[scenario]
repo = Repository.open(root, device="cpu", spill=True)
svc = ColdService(repo, policy=AdmissionPolicy(**policy))
for _ in range(200):
    st = svc.run_once()
    if (st["iteration"] >= 1 and not st["inflight"] and st["staged"] == 0
            and st["queue_depth"] == 0):
        break
else:
    print("NO_CONVERGENCE", st, flush=True)
    sys.exit(3)
st = svc.close()
w = float(repo.download()["w"][0])
n_q = len([f for f in os.listdir(svc.queue_dir) if f.endswith(".npz")])
extra = ""
if scenario == "novelty":
    extra = f"rej={st['rejected_total']} nov={st['novelty_rejected_total']} "
if scenario == "odd_id":
    qman = ckpt.load_json(os.path.join(root, "queue", "queue_manifest.json"))
    extra = f"entries={len(qman['entries'])} "
print(f"DONE it={st['iteration']} fused={st['fused_contributions']} w={w:.6f} "
      f"{extra}qfiles={n_q}", flush=True)
'''

_CLIENT = r'''
import sys
sys.path.insert(0, "src")
import torch
from repro_torch.serve.cold_service import ContributorClient
root = sys.argv[1]
sid = ContributorClient(root, name="late").submit(
    {"w": torch.full((96,), 9.0), "b": torch.full((7,), 9.0)}, weight=1.0, seq=0)
print("RETRY", sid, flush=True)
'''


def _m(v):
    return {"w": torch.full((96,), float(v)), "b": torch.full((7,), float(v))}


def _prep(root, scenario):
    """The reference scenarios' prep phases, written by the port."""
    Repository(_m(0.0), root=root, spill=True, screen=False)
    client = ContributorClient(root, name="c")
    if scenario in ("plain", "novelty"):
        for v, w in ((1.0, 2.0), (3.0, 1.0), (5.0, 1.0)):
            client.submit(_m(v), weight=w, base_iteration=0)
        if scenario == "novelty":  # the planted replay of c-000001
            ContributorClient(root, name="d").submit(_m(3.0), weight=1.0, base_iteration=0)
    elif scenario == "odd_id":
        spec = FlatSpec.from_tree(_m(0.0))
        tio.save_flat(os.path.join(root, "queue", "stem-000000.npz"), spec.flatten(_m(4.0)),
                      spec, extra={"id": "rider-id-x", "weight": 1.0})
    else:
        client.submit(_m(1.0), weight=2.0, base_iteration=0)
        client.submit(_m(3.0), weight=1.0, base_iteration=0)
        for v, w in ((5.0, 1.0), (7.0, 2.0)):
            client.submit(_m(v), weight=w, base_iteration=0, compress=True, base=_m(0.0),
                          k_per_block=128)


@pytest.fixture(scope="module")
def prepped(tmp_path_factory):
    roots = {}
    for scenario in ("plain", "novelty", "odd_id", "compressed"):
        roots[scenario] = str(tmp_path_factory.mktemp(scenario) / "repo")
        _prep(roots[scenario], scenario)
    return roots


def _copy(prepped, scenario, tmp_path):
    root = str(tmp_path / "repo")
    shutil.copytree(prepped[scenario], root)
    return root


def _serve(root, scenario, crash_at=None):
    res = run_child(_SERVE, [root, scenario], crash_at=crash_at)
    if crash_at is not None:
        return None
    line = [ln for ln in res.stdout.splitlines() if ln.startswith("DONE")][-1]
    return dict(kv.split("=") for kv in line.split()[1:])


@pytest.mark.slow
def test_plain_exactly_once_across_post_publish(tmp_path, prepped):
    root = _copy(prepped, "plain", tmp_path)
    _serve(root, "plain", crash_at="service.post_publish")
    done = _serve(root, "plain")
    assert done["it"] == "1" and done["fused"] == "3" and done["qfiles"] == "0", done
    assert abs(float(done["w"]) - 2.5) < 1e-5, done


@pytest.mark.slow
@pytest.mark.parametrize("point", ["service.post_sketch"] + CRASH_POINTS)
def test_novelty_screen_exactly_once_across_crash_points(tmp_path, prepped, point):
    root = _copy(prepped, "novelty", tmp_path)
    _serve(root, "novelty", crash_at=point)
    assert _serve(root, "novelty") == _NOVELTY_DONE, point


@pytest.mark.slow
def test_novelty_uninterrupted_run(tmp_path, prepped):
    root = _copy(prepped, "novelty", tmp_path)
    assert _serve(root, "novelty") == _NOVELTY_DONE


@pytest.mark.slow
def test_odd_rider_id_remark_across_post_ingest_crash(tmp_path, prepped):
    root = _copy(prepped, "odd_id", tmp_path)
    _serve(root, "odd_id", crash_at="service.post_ingest")
    assert _serve(root, "odd_id") == {"it": "1", "fused": "1", "w": "4.000000",
                                      "entries": "0", "qfiles": "0"}


@pytest.mark.slow
def test_client_killed_mid_submit_then_retry(tmp_path, prepped):
    root = _copy(prepped, "plain", tmp_path)
    qdir = os.path.join(root, QUEUE_DIR)
    run_child(_CLIENT, [root], crash_at="client.mid_submit")
    assert not any(f.startswith("late-") for f in os.listdir(qdir) if f.endswith(".npz"))
    run_child(_CLIENT, [root])
    assert [f for f in os.listdir(qdir) if f.startswith("late-")] == ["late-000000.npz"]
    done = _serve(root, "plain")
    # 3 prepped rows and the retried one fuse in one cohort: (2·1+3+5+9)/5
    assert done["fused"] == "4" and abs(float(done["w"]) - 3.8) < 1e-5, done


@pytest.mark.slow
@pytest.mark.parametrize("point", CRASH_POINTS)
def test_compressed_exactly_once_across_crash_points(tmp_path, prepped, point):
    root = _copy(prepped, "compressed", tmp_path)
    _serve(root, "compressed", crash_at=point)
    _assert_compressed_done(_serve(root, "compressed"))


@pytest.mark.slow
def test_compressed_uninterrupted_run(tmp_path, prepped):
    root = _copy(prepped, "compressed", tmp_path)
    done = _serve(root, "compressed")
    _assert_compressed_done(done)
    assert np.isclose(float(done["w"]), 4.0, rtol=0, atol=1e-5)
