"""The regression gate's kill-at-seam matrix against the port's daemon.

The reference's gate scenario (``tests/test_cold_service.py``,
``_GATE_SCENARIO``): a benign cohort of 3 publishes and sets the baseline,
then a harmful cohort of 3 (large noise of like norms, admitted by the §9
screen) is served with the gate armed.  The port's daemon is killed at each
of the 7 windows of ``GATE_CRASH_POINTS`` (``os._exit`` at the armed
``faults.crash_point``) and restarted; it must converge to the reference's
expected end state, the same as the uninterrupted run: iteration 1, the
benign base (w = 0.3), the 3 harmful rows quarantined exactly once, one
rollback."""
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import io as tio
from repro_torch.core.repository import Repository
from repro_torch.serve.cold_service import AdmissionPolicy, ColdService, ContributorClient
from repro_torch.serve.probes import ProbeSuite, RegressionGate

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the reference's list and expected DONE values (tests/test_cold_service.py)
GATE_CRASH_POINTS = [
    "service.post_ingest",
    "service.post_dispatch",
    "repo.post_publish_pre_manifest",
    "service.post_publish",
    "service.post_probe",
    "service.post_quarantine",
    "repo.mid_rollback",
]
_GATE_DONE = {"it": "1", "fused": "3", "w": "0.300000", "qfiles": "0",
              "quar": "3", "quarc": "3", "rb": "1"}

_SERVE = r'''
import os, sys
from repro_torch.core.repository import Repository
from repro_torch.serve.cold_service import AdmissionPolicy, ColdService
from repro_torch.serve.probes import ProbeSuite, RegressionGate

root = sys.argv[1]
repo = Repository.open(root, device="cpu", spill=True)
svc = ColdService(repo, policy=AdmissionPolicy(min_cohort=3),
                  gate=RegressionGate(ProbeSuite(103, seed=0), tolerance=0.5))
for _ in range(200):
    st = svc.run_once()
    if (st["rollbacks_total"] >= 1 and st["iteration"] == 1 and not st["inflight"]
            and st["staged"] == 0 and st["queue_depth"] == 0):
        break
else:
    print("NO_CONVERGENCE", st, flush=True)
    sys.exit(3)
st = svc.close()
w = repo.download()["w"]
n_q = len([f for f in os.listdir(svc.queue_dir) if f.endswith(".npz")])
n_quar = (len([f for f in os.listdir(svc.quarantine_dir) if f.endswith(".npz")])
          if os.path.isdir(svc.quarantine_dir) else 0)
print(f"DONE it={st['iteration']} fused={st['fused_contributions']} w={float(w[0]):.6f} "
      f"qfiles={n_q} quar={n_quar} quarc={st['quarantined_total']} "
      f"rb={st['rollbacks_total']}", flush=True)
'''


def _m(v):
    return {"w": torch.full((96,), float(v)), "b": torch.full((7,), float(v))}


@pytest.fixture(scope="module")
def planted(tmp_path_factory):
    """prep + serve_clean + plant of the reference's scenario, once: the
    root holds the benign publish and the 3 harmful submissions."""
    root = str(tmp_path_factory.mktemp("gate") / "repo")
    Repository(_m(0.0), root=root, spill=True, screen=False)
    client = ContributorClient(root, name="c")
    for v in (0.1, 0.3, 0.5):
        client.submit(_m(v), weight=1.0, base_iteration=0)
    svc = ColdService(Repository.open(root, device="cpu", spill=True),
                      policy=AdmissionPolicy(min_cohort=3),
                      gate=RegressionGate(ProbeSuite(103, seed=0), tolerance=0.5))
    for _ in range(50):
        st = svc.run_once()
        if st["iteration"] >= 1 and not st["inflight"] and st["staged"] == 0:
            break
    svc.close()
    assert st["iteration"] == 1 and st["last_gate"]["ok"]
    bad = ContributorClient(root, name="bad")
    rng = np.random.default_rng(99)
    for _ in range(3):
        bad.submit({"w": torch.from_numpy((0.3 + rng.normal(0, 10.0, 96)).astype(np.float32)),
                    "b": torch.from_numpy((0.3 + rng.normal(0, 10.0, 7)).astype(np.float32))},
                   weight=1.0, base_iteration=1)
    return root


def _serve(root, crash_at=None):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("REPRO_CRASH_POINT", None)
    if crash_at is not None:
        env["REPRO_CRASH_POINT"] = crash_at
    proc = subprocess.run([sys.executable, "-c", _SERVE, root], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    if crash_at is not None:
        assert proc.returncode == 17 and f"CRASH_POINT {crash_at}" in proc.stderr, proc.stderr
        return None
    assert proc.returncode == 0, proc.stdout + proc.stderr
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("DONE ")][-1]
    return dict(kv.split("=", 1) for kv in line.split()[1:])


@pytest.mark.slow
@pytest.mark.parametrize("point", GATE_CRASH_POINTS)
def test_gate_exactly_once_across_crash_points(tmp_path, planted, point):
    root = str(tmp_path / "repo")
    shutil.copytree(planted, root)
    _serve(root, crash_at=point)
    assert _serve(root) == _GATE_DONE, point
    # the series parses end to end; a kill in the repo.mid_rollback window
    # loses that one rollback record (the verdict is not replayed to log it)
    recs = tio.read_jsonl(os.path.join(root, "metrics.jsonl"), warn=False)
    events = [r["event"] for r in recs]
    assert "quarantine" in events, events
    if point != "repo.mid_rollback":
        assert "rollback" in events, events
    assert recs[-1]["rollbacks_total"] == 1, recs[-1]
    assert tio.load_json(os.path.join(root, "gate_state.json"))["iteration"] == 1


@pytest.mark.slow
def test_gate_uninterrupted_run(tmp_path, planted):
    root = str(tmp_path / "repo")
    shutil.copytree(planted, root)
    assert _serve(root) == _GATE_DONE
    assert sorted(os.listdir(os.path.join(root, "quarantine"))) == [
        f"bad-00000{i}.npz" for i in range(3)]
