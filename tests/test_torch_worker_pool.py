"""The port's serving scale-out (``repro_torch.serve.router`` and
``worker_pool``) against the JAX package, on the CPU.

* the twins of ``tests/test_worker_pool.py``'s router units, each run over
  both packages' ``Router`` with the same programmable endpoints
  (least-loaded round robin, drain on swap, dead marks and the exactly-once
  re-route, stale health, shed failover, saturation), and one scripted
  sequence that must make the same picks, re-routes and dead marks in both;
* the two-worker version-pinning property suite and the status block over
  the worker-state namespace, on the port's workers;
* cross-process pools of port children: adoption over the socket protocol,
  ``kill -9`` of a member re-routed exactly once, a member killed at a swap
  seam, batched coalescing, and a real reduced gemma3-1b engine whose
  served tokens equal the parent's ``Engine`` on the published npz;
* the launcher's ``--serve-arch`` (one in-process worker) and
  ``--serve-workers 1 --serve-batch`` (a pool) on the CPU.
"""
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import types

import numpy as np
import pytest
import torch

from _faults import REPO_ROOT, wait_until
from _hypothesis_compat import given, settings, st
from repro.serve import cold_service as jcs
from repro.serve import router as jrouter
from repro.serve import scheduler as jsched
from repro_torch.checkpoint import io as tckpt
from repro_torch.configs import get_config, reduce_config
from repro_torch.core.repository import Repository
from repro_torch.models.transformer import init_lm
from repro_torch.serve import cold_service as tcs
from repro_torch.serve import router as trouter
from repro_torch.serve import scheduler as tsched
from repro_torch.serve.cold_service import AdmissionPolicy, ColdService, ContributorClient
from repro_torch.serve.engine import Engine
from repro_torch.serve.hot_swap import ServingWorker
from repro_torch.serve.router import LocalEndpoint, Router
from repro_torch.serve.worker_pool import SocketEndpoint, WorkerPool
from repro_torch.utils import faults
from repro_torch.utils.pytree import tree_map

PROMPT = np.zeros((2,), np.int32)   # one [T] row (routers take rows)
PKGS = {
    "jax": types.SimpleNamespace(Router=jrouter.Router, EndpointDied=jrouter.EndpointDied,
                                 RequestRejected=jsched.RequestRejected),
    "torch": types.SimpleNamespace(Router=trouter.Router, EndpointDied=trouter.EndpointDied,
                                   RequestRejected=tsched.RequestRejected),
}


@pytest.fixture(params=sorted(PKGS))
def rt(request):
    return PKGS[request.param]


def _m(v, n=64):
    return {"w": torch.full((n,), float(v)), "b": torch.full((5,), float(v))}


def _repo(root, **kw):
    kw.setdefault("screen", False)
    return Repository(_m(0), root=str(root), spill=True, **kw)


def _publish(repo, v) -> int:
    repo.upload(_m(v))
    repo.fuse_pending()
    repo.flush()
    return repo.iteration


class _ValueEngine:
    """Generation returns the served tree's scalar w: a token mismatch is a
    version tear."""

    def __init__(self, cfg, params, max_len):
        self.params = params

    def generate(self, prompts, *, max_new_tokens=16, params=None):
        p = self.params if params is None else params
        val = float(p["w"].reshape(-1)[0])
        toks = np.full((prompts.shape[0], prompts.shape[1] + max_new_tokens), val, np.float32)
        return types.SimpleNamespace(tokens=toks, prompt_len=int(prompts.shape[1]),
                                     steps=int(max_new_tokens))


def _fake(cfg, params, max_len):
    return _ValueEngine(cfg, params, max_len)


# ---------------------------------------------------------------------------
# router policy units, both packages
# ---------------------------------------------------------------------------


class _Ep:
    """Programmable endpoint: health and failure modes set per test."""

    def __init__(self, eid, value=1.0):
        self.id = eid
        self.value = float(value)
        self.swapping = False
        self.alive = True          # health() returns None when False
        self.stale = False         # health older than HEALTH_STALE_S
        self.fail_next = None      # an exception raised once
        self.calls = 0

    def health(self):
        if not self.alive:
            return None
        age = 99.0 if self.stale else 0.0
        return {"iteration": 0, "swapping": self.swapping, "updated_at": time.time() - age}

    def generate(self, prompt, *, max_new_tokens, deadline_s=None):
        self.calls += 1
        if self.fail_next is not None:
            err, self.fail_next = self.fail_next, None
            raise err
        return {"tokens": np.full(len(prompt) + max_new_tokens, self.value), "iteration": 0,
                "steps": max_new_tokens, "batch_size": 1, "latency_s": 0.001}


def test_router_spreads_equal_load_round_robin(rt):
    a, b = _Ep("a"), _Ep("b")
    r = rt.Router([a, b])
    for _ in range(6):
        r.route(PROMPT)
    st_ = r.stats()
    assert st_["per_worker"]["a"] > 0 and st_["per_worker"]["b"] > 0
    assert st_["routed_total"] == 6 and st_["failed_total"] == 0


def test_router_drains_swapping_worker(rt):
    a, b = _Ep("a"), _Ep("b")
    a.swapping = True
    r = rt.Router([a, b])
    for _ in range(4):
        assert r.route(PROMPT).worker_id == "b"
    a.swapping = False
    for _ in range(4):
        r.route(PROMPT)
    assert r.stats()["per_worker"]["a"] >= 1, "drained worker never re-joined"


def test_router_serves_even_when_all_swapping(rt):
    a, b = _Ep("a"), _Ep("b")
    a.swapping = b.swapping = True
    r = rt.Router([a, b])
    assert r.route(PROMPT).worker_id in ("a", "b")
    assert r.stats()["failed_total"] == 0


def test_router_reroutes_died_endpoint_exactly_once(rt):
    a, b = _Ep("a"), _Ep("b")
    a.fail_next = rt.EndpointDied("killed mid-request")
    r = rt.Router([a, b], max_reroutes=1)
    results = [r.route(PROMPT) for _ in range(4)]
    st_ = r.stats()
    assert st_["failed_total"] == 0
    assert st_["reroutes_total"] == 1
    assert sum(x.rerouted for x in results) == 1
    assert a.calls >= 2
    assert "a" not in st_["dead"]


def test_router_skips_endpoint_with_no_health_then_readmits(rt):
    a, b = _Ep("a"), _Ep("b")
    a.alive = False
    r = rt.Router([a, b])
    for _ in range(3):
        assert r.route(PROMPT).worker_id == "b"
    assert "a" in r.stats()["dead"]
    a.alive = True
    for _ in range(4):
        r.route(PROMPT)
    st_ = r.stats()
    assert st_["per_worker"]["a"] >= 1 and "a" not in st_["dead"]


def test_router_treats_stale_health_as_dead(rt):
    a, b = _Ep("a"), _Ep("b")
    a.stale = True
    r = rt.Router([a, b])
    for _ in range(3):
        assert r.route(PROMPT).worker_id == "b"
    assert r.stats()["failed_total"] == 0


def test_router_fails_over_a_shed_without_dead_marking(rt):
    a, b = _Ep("a"), _Ep("b")
    a.fail_next = rt.RequestRejected("queue_full")
    r = rt.Router([a, b], max_reroutes=1)
    results = [r.route(PROMPT) for _ in range(4)]
    st_ = r.stats()
    assert st_["failed_total"] == 0 and st_["shed_total"] == 0
    assert "a" not in st_["dead"]
    assert sum(x.rerouted for x in results) == 1


def test_router_surfaces_pool_saturation(rt):
    a, b = _Ep("a"), _Ep("b")
    a.fail_next = rt.RequestRejected("queue_full")
    b.fail_next = rt.RequestRejected("queue_full")
    r = rt.Router([a, b], max_reroutes=1)
    with pytest.raises(rt.RequestRejected):
        r.route(PROMPT)
    st_ = r.stats()
    assert st_["failed_total"] == 1 and st_["shed_total"] == 1


def test_router_raises_when_no_live_endpoint(rt):
    a = _Ep("a")
    a.alive = False
    r = rt.Router([a])
    with pytest.raises(rt.EndpointDied):
        r.route(PROMPT)
    assert r.stats()["failed_total"] == 1
    with pytest.raises(ValueError):
        rt.Router([])


def _router_script(pkg):
    """A fixed sequence of endpoint states and faults; every decision the
    router makes is recorded."""
    eps = {n: _Ep(n, v) for n, v in (("a", 1.0), ("b", 2.0), ("c", 3.0))}
    r = pkg.Router(list(eps.values()), max_reroutes=1)
    log = []

    def go(n=1):
        for _ in range(n):
            try:
                x = r.route(PROMPT, max_new_tokens=2)
                log.append((x.worker_id, x.rerouted, float(x.tokens[-1])))
            except (pkg.EndpointDied, pkg.RequestRejected) as err:
                log.append(("raised", type(err).__name__))
            log.append(tuple(r.stats()["dead"]))

    go(4)
    eps["b"].swapping = True
    go(3)
    eps["a"].fail_next = pkg.EndpointDied("reset")
    eps["c"].fail_next = pkg.RequestRejected("queue_full")
    go(3)
    eps["b"].swapping = False
    eps["c"].stale = True
    go(3)
    eps["a"].alive = False
    eps["b"].fail_next = pkg.EndpointDied("reset")
    go(2)
    eps["c"].stale = False
    eps["a"].alive = True
    go(4)
    eps["a"].fail_next = pkg.EndpointDied("reset")
    go(3)
    for e in eps.values():
        e.fail_next = pkg.RequestRejected("queue_full")
    go(1)
    st_ = r.stats()
    return log, {k: v for k, v in st_.items() if k != "inflight"}, st_["inflight"]


def test_same_script_same_router_decisions():
    jlog, jst, jin = _router_script(PKGS["jax"])
    tlog, tst, tin = _router_script(PKGS["torch"])
    assert tlog == jlog and tst == jst and tin == jin
    assert tst["reroutes_total"] == 1 and tst["failed_total"] == 3 and tst["shed_total"] == 1
    assert ("raised", "EndpointDied") in tlog and ("raised", "RequestRejected") in tlog


def test_worker_id_rejects_path_characters():
    for fn in (tcs.serving_state_filename, jcs.serving_state_filename):
        assert fn(None) == "serving_state.json"
        assert fn("w3") == "serving_state-w3.json"
        for bad in ("a/b", "a\\b", "a.b", ""):
            with pytest.raises(ValueError):
                fn(bad)
    assert tcs.SERVING_STATE_FILE == jcs.SERVING_STATE_FILE


# ---------------------------------------------------------------------------
# two port workers behind a router, in process
# ---------------------------------------------------------------------------


@settings(max_examples=10)
@given(st.data())
def test_pool_interleavings_serve_only_pinned_published_weights(data):
    ops = data.draw(st.lists(st.sampled_from(["publish", "rollback", "poll0", "poll1",
                                              "route", "route", "route"]),
                             min_size=6, max_size=18))
    root = tempfile.mkdtemp(prefix="torch_pool_prop_")
    try:
        repo = _repo(root)
        repo.flush()
        workers = [ServingWorker(None, root, device="cpu", engine_factory=_fake,
                                 worker_id=f"w{i}", name=f"w{i}") for i in range(2)]
        for w in workers:
            assert w.poll_once()
        router = Router([LocalEndpoint(w) for w in workers])
        live = {0: 0.0}
        adopted = {w.worker_id: (0, 0.0) for w in workers}
        next_v = 1.0
        for op in ops:
            if op == "publish":
                it = _publish(repo, next_v)
                live[it] = next_v
                next_v += 1.0
            elif op == "rollback":
                if repo.iteration == 0:
                    continue
                target = data.draw(st.integers(0, repo.iteration - 1))
                repo.rollback(target)
                live = {k: v for k, v in live.items() if k <= target}
            elif op in ("poll0", "poll1"):
                w = workers[int(op[-1])]
                if w.poll_once():
                    adopted[w.worker_id] = (w.current_iteration, live[w.current_iteration])
            else:
                r = router.route(PROMPT, max_new_tokens=2)
                it, val = adopted[r.worker_id]
                assert r.iteration == it
                assert float(r.tokens[-1]) == val
        assert router.stats()["failed_total"] == 0
    finally:
        shutil.rmtree(root, ignore_errors=True)


def test_status_aggregates_worker_state_namespace(tmp_path):
    repo = _repo(tmp_path)
    _publish(repo, 4.0)
    workers = [ServingWorker(None, str(tmp_path), device="cpu", engine_factory=_fake,
                             worker_id=f"w{i}", name=f"w{i}") for i in range(2)]
    for w in workers:
        assert w.poll_once() and w.current_iteration == 1
        w.generate(PROMPT[None, :], max_new_tokens=2)
        w._persist_state()
    assert os.path.exists(os.path.join(str(tmp_path), "serving_state-w0.json"))
    svc = ColdService(repo, policy=AdmissionPolicy())
    serving = svc.status()["serving"]
    svc.close()
    assert serving["n_workers"] == 2
    assert set(serving["workers"]) == {"w0", "w1"}
    assert serving["iteration"] == 1
    assert serving["requests_total"] == 2
    assert serving["swaps_total"] == 2
    assert serving["versions_served"] == [1]
    assert serving["swapping"] is False


def test_status_iteration_none_when_workers_diverge(tmp_path):
    repo = _repo(tmp_path)
    workers = [ServingWorker(None, str(tmp_path), device="cpu", engine_factory=_fake,
                             worker_id=f"w{i}", name=f"w{i}") for i in range(2)]
    assert workers[0].poll_once() and workers[1].poll_once()
    _publish(repo, 4.0)
    assert workers[0].poll_once()
    for w in workers:
        w._persist_state()
    svc = ColdService(repo, policy=AdmissionPolicy())
    serving = svc.status()["serving"]
    svc.close()
    assert serving["iteration"] is None, "mid-divergence must not pick one"
    assert serving["versions_served"] == [0, 1]


def test_batched_worker_records_scheduler_stats(tmp_path):
    """``batch_requests=True``: concurrent single-row requests coalesce and
    the scheduler's counters ride in the serving state."""
    repo = _repo(tmp_path)
    w = ServingWorker(None, str(tmp_path), repo=repo, engine_factory=_fake,
                      batch_requests=True, max_batch=4, batch_wait_s=0.05)
    w.poll_once()
    out = []
    threads = [threading.Thread(target=lambda: out.append(w.generate(PROMPT[None, :],
                                                                     max_new_tokens=2)))
               for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30.0)
    assert len(out) == 4 and all(r.iteration == 0 for r in out)
    state = w.stop()
    assert state["scheduler"]["completed"] == 4
    assert state["requests_batched"] == sum(r.batch_size > 1 for r in out)
    assert any(r.batch_size > 1 for r in out), "nothing coalesced"


# ---------------------------------------------------------------------------
# cross-process pools of port children
# ---------------------------------------------------------------------------


@pytest.mark.slow
def test_pool_cross_process_adoption_and_kill9(tmp_path):
    root = str(tmp_path)
    repo = _repo(root)
    repo.flush()
    pool = WorkerPool(root, 2, engine="value", device="cpu", poll=0.01).start()
    try:
        pool.wait_ready(iteration=0)
        router = pool.router()
        r = router.route(PROMPT, max_new_tokens=2)
        assert r.iteration == 0 and float(r.tokens[-1]) == 0.0
        it = _publish(repo, 5.0)
        pool.wait_ready(iteration=it)
        for _ in range(4):
            r = router.route(PROMPT, max_new_tokens=2)
            assert r.iteration == 1 and float(r.tokens[-1]) == 5.0
        assert {s["iteration"] for s in pool.states().values()} == {1}
        pool.kill("w0")
        results = [router.route(PROMPT, max_new_tokens=2) for _ in range(6)]
        assert all(float(r.tokens[-1]) == 5.0 for r in results)
        assert all(r.worker_id == "w1" for r in results)
        st_ = router.stats()
        assert st_["failed_total"] == 0
        # w0's state file stays fresh for HEALTH_STALE_S, so the router may
        # try it again; every such request moves to w1 once and none fails
        assert st_["reroutes_total"] == sum(r.rerouted for r in results) >= 1
    finally:
        codes = pool.stop()
    assert codes["w0"] == -9 and codes["w1"] == 0


@pytest.mark.slow
def test_pool_worker_killed_at_swap_seam_router_converges(tmp_path):
    root = str(tmp_path)
    repo = _repo(root)
    repo.flush()
    pool = WorkerPool(root, 2, engine="value", device="cpu", poll=0.01,
                      child_env={"w1": {faults.ENV: "worker.post_transfer_pre_flip"}})
    pool.start()
    try:
        wait_until(lambda: "w1" not in pool.alive(), desc="armed crash point firing mid-swap")
        assert pool._procs["w1"].returncode == faults.EXIT_CODE
        pool.wait_ready(iteration=0)
        router = pool.router()
        results = [router.route(PROMPT, max_new_tokens=2) for _ in range(8)]
        assert all(float(r.tokens[-1]) == 0.0 for r in results)
        assert all(r.worker_id == "w0" for r in results)
        assert router.stats()["failed_total"] == 0
        h = pool.endpoints[1].health()
        assert h is not None and h["iteration"] is None
        it = _publish(repo, 3.0)
        pool.wait_ready(iteration=it)
        r = router.route(PROMPT, max_new_tokens=2)
        assert r.iteration == it and float(r.tokens[-1]) == 3.0
        assert router.stats()["failed_total"] == 0
    finally:
        pool.stop()


@pytest.mark.slow
def test_pool_batched_worker_coalesces_cross_process(tmp_path):
    root = str(tmp_path)
    repo = _repo(root)
    repo.flush()
    pool = WorkerPool(root, 1, engine="value", device="cpu", poll=0.01, batch=True,
                      batch_wait_s=0.05).start()
    try:
        pool.wait_ready(iteration=0)
        router = pool.router()
        results, errors = [], []

        def client():
            try:
                results.append(router.route(PROMPT, max_new_tokens=2))
            except Exception as err:  # noqa: BLE001
                errors.append(err)

        threads = [threading.Thread(target=client) for _ in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30.0)
        assert not errors and len(results) == 6
        assert all(float(r.tokens[-1]) == 0.0 for r in results)
        assert any(r.batch_size > 1 for r in results), "nothing coalesced"
    finally:
        codes = pool.stop()
    assert codes == {"w0": 0}


LM_CFG = reduce_config(get_config("gemma3-1b"))
LM_PROMPT = np.arange(3, 11, dtype=np.int64)


def _oracle(root, it, new=4):
    base = tckpt.load(os.path.join(root, f"base_iter{it:04d}.npz"), device="cpu")
    return Engine(LM_CFG, base, max_len=32).generate(LM_PROMPT[None], max_new_tokens=new).tokens[0]


@pytest.mark.slow
def test_pool_real_engine_children_serve_the_published_npz(tmp_path):
    """Two children with the real reduced gemma3-1b engine, batched, on the
    CPU: they converge on each publish, serve exactly the parent's
    ``Engine`` tokens on the published npz, and a ``kill -9`` of one is
    re-routed once onto the other."""
    root = str(tmp_path)
    params = init_lm(LM_CFG, torch.Generator().manual_seed(0), device="cpu")
    repo = Repository(params, root=root, spill=True, screen=False)
    pool = WorkerPool(root, 2, arch="gemma3-1b", device="cpu", max_len=32, poll=0.01,
                      batch=True, warm=(len(LM_PROMPT), 4)).start(timeout=120.0)
    try:
        pool.wait_ready(iteration=0, timeout=120.0)
        router = pool.router()
        want0 = _oracle(root, 0)
        for _ in range(2):
            r = router.route(LM_PROMPT, max_new_tokens=4)
            assert r.iteration == 0 and r.batch_size == 1
            np.testing.assert_array_equal(r.tokens, want0)
        repo.upload(tree_map(lambda x: x + 0.05 * torch.randn_like(x), params))
        repo.fuse_pending()
        repo.flush()
        pool.wait_ready(iteration=1, timeout=60.0)
        want1 = _oracle(root, 1)
        assert not np.array_equal(want0, want1)
        pool.kill("w0")
        results = [router.route(LM_PROMPT, max_new_tokens=4) for _ in range(4)]
        for r in results:
            assert r.iteration == 1 and r.worker_id == "w1"
            np.testing.assert_array_equal(r.tokens, want1)
        st_ = router.stats()
        assert st_["failed_total"] == 0
        assert st_["reroutes_total"] == sum(r.rerouted for r in results) >= 1
    finally:
        codes = pool.stop()
    assert codes["w0"] == -9 and codes["w1"] == 0


# ---------------------------------------------------------------------------
# the launcher's --serve-* flags on the CPU
# ---------------------------------------------------------------------------


def _launcher(root, init_npz, *flags):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO_ROOT, "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.serve_repository", "--device", "cpu",
           "--root", root, "--init-npz", init_npz, "--min-cohort", "1", "--poll", "0.01",
           "--serve-arch", "gemma3-1b", "--serve-max-len", "32", *flags]
    return subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


@pytest.mark.slow
def test_launcher_serves_in_process_on_the_cpu(tmp_path):
    root, npz = str(tmp_path / "R"), str(tmp_path / "base.npz")
    params = init_lm(LM_CFG, torch.Generator().manual_seed(0), device="cpu")
    tckpt.save(npz, params)
    ContributorClient(root, "c0").submit(tree_map(lambda x: x + 0.05, params), base_iteration=0)
    proc = _launcher(root, npz, "--idle-timeout", "2")
    out, err = proc.communicate(timeout=120)
    assert proc.returncode == 0, err
    assert "hot-swap worker serving gemma3-1b on cpu" in out
    assert "worker stopped at iteration 1:" in out
    assert tckpt.load_json(os.path.join(root, "serving_state.json"))["iteration"] == 1
    assert tckpt.load_json(os.path.join(root, "service_status.json"))["serving"]["iteration"] == 1


@pytest.mark.slow
def test_launcher_serves_from_a_pool_on_the_cpu(tmp_path):
    root, npz = str(tmp_path / "R"), str(tmp_path / "base.npz")
    params = init_lm(LM_CFG, torch.Generator().manual_seed(0), device="cpu")
    tckpt.save(npz, params)
    proc = _launcher(root, npz, "--serve-workers", "1", "--serve-batch",
                     "--serve-queue-depth", "8", "--idle-timeout", "120")
    try:
        ep = SocketEndpoint(root, "w0")
        wait_until(lambda: (ep.health() or {}).get("port") is not None
                   and ep.health().get("iteration") is not None,
                   timeout=120.0, desc="the pool child registered and adopted iteration 0")
        assert ep.health()["scheduler"]["queue_depth"] == 8
        r = ep.generate(LM_PROMPT, max_new_tokens=4)
        assert r["iteration"] == 0
        np.testing.assert_array_equal(r["tokens"], _oracle(root, 0))
        ContributorClient(root, "c0").submit(tree_map(lambda x: x + 0.05, params),
                                             base_iteration=0)
        wait_until(lambda: ep.generate(LM_PROMPT, max_new_tokens=4)["iteration"] == 1,
                   timeout=120.0, interval=0.05, desc="the pool serving iteration 1")
        np.testing.assert_array_equal(ep.generate(LM_PROMPT, max_new_tokens=4)["tokens"],
                                      _oracle(root, 1))
    finally:
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=60)
    assert proc.returncode == 0, err
    assert "1 pool workers serving gemma3-1b on cpu" in out
    assert "pool stopped (exit={'w0': 0}): w0@it1" in out
