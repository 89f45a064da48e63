"""The reference's routed kill-at-seam matrices against the port's daemon.

``tests/test_routing.py``'s two scenarios, with the port's
``RepositoryFamily``/``ColdService(family=)`` on the CPU: the daemon is killed
(``os._exit`` at the armed ``faults.crash_point``) at each seam, restarted,
and must print the reference's ``_ROUTE_DONE`` / ``_ROUTE_GATE_DONE`` line,
the same as the uninterrupted run.

* the routing matrix (``ROUTE_CRASH_POINTS``, 8 seams): two task streams
  declared against ``main`` split into two members, each the closed form of
  its own stream, every row fused once, queues empty;
* the gate matrix (``ROUTE_GATE_POINTS``, 4 seams): a harmful cohort routed
  to one member trips that member's gate alone: one rollback, the two rows
  quarantined, the bystander member untouched."""
import os
import shutil

import numpy as np
import pytest
import torch

from _faults import run_child
from repro_torch.core.repository import RepositoryFamily, family_member_root
from repro_torch.checkpoint import io as tio
from repro_torch.serve.cold_service import AdmissionPolicy, ColdService, ContributorClient
from repro_torch.serve.probes import ProbeSuite, RegressionGate
from test_routing import ROUTE_CRASH_POINTS, ROUTE_GATE_POINTS, _ROUTE_DONE, _ROUTE_GATE_DONE

W, B, LANE = 2048, 17, 1024

_COMMON = r'''
import os, sys
sys.path.insert(0, "src")
import numpy as np
from repro_torch.checkpoint import io as ckpt
from repro_torch.core.repository import RepositoryFamily, family_member_root
from repro_torch.serve.cold_service import AdmissionPolicy, ColdService
from repro_torch.serve.probes import ProbeSuite, RegressionGate

root = sys.argv[1]
W, B, LANE = 2048, 17, 1024

def pat(t):
    w = np.ones((W,), np.float32)
    for j in range(W // LANE):
        if (j + t) % 2:
            w[j*LANE:(j+1)*LANE] = -1.0
    return {"w": w, "b": np.ones((B,), np.float32)}

def member_base(n, it):
    bb = ckpt.load(os.path.join(family_member_root(root, n), f"base_iter{it:04d}.npz"))
    return {k: v.numpy() for k, v in bb.items()}

def serve(stop, gate=None, max_bases=3):
    fam = RepositoryFamily.open(root, device="cpu", spill=True)
    svc = ColdService(family=fam, policy=AdmissionPolicy(min_cohort=2, max_bases=max_bases),
                      gate=gate)
    for _ in range(300):
        st = svc.run_once()
        if stop(st):
            break
    else:
        print("NO_CONVERGENCE", st, flush=True)
        sys.exit(3)
    return svc, svc.close()
'''

_ROUTE_SERVE = _COMMON + r'''
svc, st = serve(lambda st: st["queue_depth"] == 0 and st["staged"] == 0
                and not st["inflight"] and len(st.get("families") or {}) == 2
                and all(f["iteration"] >= 1 for f in st["families"].values()))
fams = st["families"]
match = []
for t in range(2):
    want = {k: 0.15 * v for k, v in pat(t).items()}
    hits = [n for n, f in fams.items()
            if all(np.allclose(member_base(n, f["iteration"])[k], want[k], atol=1e-5)
                   for k in want)]
    match.append(len(hits))
fused = sorted(f["fused_contributions"] for f in fams.values())
its = sorted(f["iteration"] for f in fams.values())
n_q = sum(len([f for f in os.listdir(l.queue_dir) if f.endswith(".npz")])
          for l in svc._lanes.values())
print(f"DONE members={len(fams)} match={match[0]}{match[1]} "
      f"fused={fused[0]}{fused[1]} its={its[0]}{its[1]} qfiles={n_q}", flush=True)
'''

_GATE_SERVE = _COMMON + r'''
def victim_name(fams):
    for n in fams:
        if np.allclose(member_base(n, 1)["w"], 0.15 * pat(0)["w"], atol=1e-5):
            return n
    raise AssertionError("no member matches task 0")

gate = RegressionGate(ProbeSuite(W + B, seed=0), tolerance=0.5)
svc, st = serve(lambda st: st["rollbacks_total"] >= 1 and not st["inflight"]
                and st["staged"] == 0 and st["queue_depth"] == 0, gate=gate, max_bases=2)
fams = st["families"]
victim = victim_name(list(fams))
bystander = [n for n in fams if n != victim][0]
v_ok = (fams[victim]["iteration"] == 1
        and np.allclose(member_base(victim, 1)["w"], 0.15 * pat(0)["w"], atol=1e-5))
b_ok = (fams[bystander]["iteration"] == 1 and fams[bystander]["fused_contributions"] == 2
        and np.allclose(member_base(bystander, 1)["w"], 0.15 * pat(1)["w"], atol=1e-5))
qdir = os.path.join(root, "quarantine")
n_quar = len([f for f in os.listdir(qdir) if f.endswith(".npz")]) if os.path.isdir(qdir) else 0
print(f"DONE members={len(fams)} rb={st['rollbacks_total']} quarc={st['quarantined_total']} "
      f"quar={n_quar} victim_ok={v_ok} bystander_ok={b_ok}", flush=True)
'''


def _pat(t):
    w = np.ones((W,), np.float32)
    for j in range(W // LANE):
        if (j + t) % 2:
            w[j * LANE:(j + 1) * LANE] = -1.0
    return {"w": torch.from_numpy(w), "b": torch.ones(B)}


def _prep(root):
    """The scenarios' prep phase: a family at zeros and two streams of two
    rows each, declared against main."""
    RepositoryFamily.create({"w": torch.zeros(W), "b": torch.zeros(B)}, root=root,
                            device="cpu", spill=True, screen=False)
    for t in range(2):
        for c in range(2):
            ContributorClient(root, name=f"t{t}c{c}").submit(
                {k: (c + 1) * 0.1 * v for k, v in _pat(t).items()}, weight=1.0,
                base_iteration=0, family="main")


def _done(res):
    line = [ln for ln in res.stdout.splitlines() if ln.startswith("DONE")][-1]
    return dict(kv.split("=") for kv in line.split()[1:])


@pytest.fixture(scope="module")
def prepped(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("route") / "repo")
    _prep(root)
    return root


@pytest.fixture(scope="module")
def planted(tmp_path_factory):
    """prep + serve_clean + plant of the reference's gate scenario, once:
    two members at their closed forms and two harmful rows (40x and 41x
    task 0's direction) declared against task 0's member."""
    root = str(tmp_path_factory.mktemp("route_gate") / "repo")
    _prep(root)
    svc = ColdService(family=RepositoryFamily.open(root, device="cpu", spill=True),
                      policy=AdmissionPolicy(min_cohort=2, max_bases=2),
                      gate=RegressionGate(ProbeSuite(W + B, seed=0), tolerance=0.5))
    for _ in range(50):
        st = svc.run_once()
        if (len(st["families"]) == 2 and all(f["iteration"] >= 1
                                              for f in st["families"].values())
                and not st["inflight"] and st["staged"] == 0 and st["queue_depth"] == 0):
            break
    svc.close()
    victim = next(n for n in st["families"]
                  if np.allclose(tio.load(os.path.join(family_member_root(root, n),
                                                       "base_iter0001.npz"))["w"].numpy(),
                                 0.15 * _pat(0)["w"].numpy(), atol=1e-5))
    vb = tio.load(os.path.join(family_member_root(root, victim), "base_iter0001.npz"))
    for j in range(2):
        ContributorClient(root, name=f"bad{j}").submit(
            {k: vb[k] + (40.0 + j) * _pat(0)[k] for k in vb}, weight=1.0, base_iteration=1,
            family=victim)
    return root


@pytest.mark.slow
@pytest.mark.parametrize("point", ROUTE_CRASH_POINTS)
def test_routing_exactly_once_across_crash_points(tmp_path, prepped, point):
    root = str(tmp_path / "repo")
    shutil.copytree(prepped, root)
    run_child(_ROUTE_SERVE, [root], crash_at=point)
    assert _done(run_child(_ROUTE_SERVE, [root])) == _ROUTE_DONE, point


@pytest.mark.slow
def test_routing_uninterrupted_run(tmp_path, prepped):
    root = str(tmp_path / "repo")
    shutil.copytree(prepped, root)
    assert _done(run_child(_ROUTE_SERVE, [root])) == _ROUTE_DONE


@pytest.mark.slow
@pytest.mark.parametrize("point", ROUTE_GATE_POINTS)
def test_gate_isolation_across_crash_points(tmp_path, planted, point):
    root = str(tmp_path / "repo")
    shutil.copytree(planted, root)
    run_child(_GATE_SERVE, [root], crash_at=point)
    assert _done(run_child(_GATE_SERVE, [root])) == _ROUTE_GATE_DONE, point


@pytest.mark.slow
def test_gate_isolation_uninterrupted_run(tmp_path, planted):
    root = str(tmp_path / "repo")
    shutil.copytree(planted, root)
    assert _done(run_child(_GATE_SERVE, [root])) == _ROUTE_GATE_DONE
