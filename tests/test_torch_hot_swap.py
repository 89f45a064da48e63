"""The port's fuse-to-serve path (``repro_torch.serve.base_follower`` and
``hot_swap``) against the JAX package, on the CPU.

* the twins of ``tests/test_hot_swap.py``'s swap units on the port's
  ``ServingWorker`` and ``Repository`` (residency before the flip, pinning
  across forward and rollback swaps, cross-process polling and the status
  block, the watch thread under traffic, the interleaving property suite),
  with the closed-form value engine;
* parity: a reduced gemma3-1b in f32, the JAX parameters carried across bit
  for bit, runs one scripted sequence (publish, a request held across the
  next publish, rollback) through both packages' workers, which must serve
  the same iterations with equal tokens, equal ``serve_state()`` counters
  and equal swap records (times and pid aside);
* file interchange: each package's worker follows a root the other
  package's daemon wrote, and each daemon's ``status()["serving"]`` reads
  the other package's worker state;
* both packages' ``_serving_state()`` give the same block over the same
  ``serving_state-*.json`` files.
"""
import json
import os
import shutil
import tempfile
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _faults import wait_until
from _hypothesis_compat import given, settings, st
from repro.checkpoint import io as jckpt
from repro.configs import get_config as jget_config
from repro.configs import reduce_config as jreduce_config
from repro.core.repository import Repository as JRepository
from repro.models import transformer as JT
from repro.serve import cold_service as jcs
from repro.serve.engine import Engine as JEngine
from repro.serve.hot_swap import ServingWorker as JServingWorker
from repro_torch import convert
from repro_torch.checkpoint import io as tckpt
from repro_torch.configs import get_config, reduce_config
from repro_torch.core.repository import Repository, family_member_root
from repro_torch.serve import base_follower
from repro_torch.serve import cold_service as tcs
from repro_torch.serve.engine import Engine as TEngine
from repro_torch.serve.hot_swap import ServingWorker

PROMPTS = np.zeros((1, 2), np.int32)


def _m(v, n=64):
    return {"w": torch.full((n,), float(v)), "b": torch.full((5,), float(v))}


def _repo(root, **kw):
    kw.setdefault("screen", False)
    return Repository(_m(0), root=str(root), spill=True, **kw)


def _publish(repo, v) -> int:
    """One single-row average fuse: the published base becomes _m(v)."""
    repo.upload(_m(v))
    repo.fuse_pending()
    repo.flush()
    return repo.iteration


class _ValueEngine:
    """Fake engine: 'generation' returns the served tree's scalar w, so a
    token mismatch is a version tear.  An optional gate blocks mid-request
    to model an in-flight generate."""

    def __init__(self, cfg, params, max_len):
        self.params = params
        self.max_len = max_len
        self.gate = None

    def generate(self, prompts, *, max_new_tokens=16, params=None):
        p = self.params if params is None else params
        if self.gate is not None:
            self.gate["started"].set()
            assert self.gate["release"].wait(10.0), "gate never released"
        val = float(p["w"][0])
        toks = np.full((prompts.shape[0], prompts.shape[1] + max_new_tokens), val, np.float32)
        return types.SimpleNamespace(tokens=toks, prompt_len=int(prompts.shape[1]),
                                     steps=int(max_new_tokens))


def _fake(cfg, params, max_len):
    return _ValueEngine(cfg, params, max_len)


def _served_value(worker, **kw):
    return float(worker.generate(PROMPTS, **kw).tokens[0, -1])


# ---------------------------------------------------------------------------
# swap units (twins of tests/test_hot_swap.py)
# ---------------------------------------------------------------------------


def test_pointer_flips_only_after_residency(tmp_path, monkeypatch):
    repo = _repo(tmp_path)
    w = ServingWorker(None, str(tmp_path), repo=repo, engine_factory=_fake)
    assert w.poll_once() and w.current_iteration == 0
    at_barrier = []
    real = base_follower._make_resident
    monkeypatch.setattr(base_follower, "_make_resident",
                        lambda tree: (at_barrier.append(w.current_iteration), real(tree))[1])
    _publish(repo, 7.0)
    assert w.poll_once()
    assert at_barrier == [0], "barrier ran after (or without) the flip"
    assert w.current_iteration == 1 and _served_value(w) == 7.0


def test_in_process_adoption_is_by_reference(tmp_path):
    """In-process the served leaves are views of the published flat row: no
    copy, and a publish installs a fresh row instead of writing the old."""
    repo = _repo(tmp_path)
    w = ServingWorker(None, str(tmp_path), repo=repo, engine_factory=_fake)
    w.poll_once()
    row0 = repo.flat_base()
    ptr0 = row0.untyped_storage().data_ptr()
    assert all(x.untyped_storage().data_ptr() == ptr0 for x in w.current().params.values())
    held = w.current()
    _publish(repo, 3.0)
    w.poll_once()
    assert repo.flat_base().untyped_storage().data_ptr() != ptr0
    assert float(held.params["w"][0]) == 0.0 and torch.equal(row0, torch.zeros_like(row0))


def test_generate_pinned_to_start_version_across_swap(tmp_path):
    repo = _repo(tmp_path)
    w = ServingWorker(None, str(tmp_path), repo=repo, engine_factory=_fake)
    w.poll_once()
    gate = {"started": threading.Event(), "release": threading.Event()}
    w._engine.gate = gate
    out = {}

    def request():
        out["res"] = w.generate(PROMPTS, max_new_tokens=3)

    t = threading.Thread(target=request)
    t.start()
    assert gate["started"].wait(10.0)
    w._engine.gate = None
    _publish(repo, 9.0)
    assert w.poll_once() and w.current_iteration == 1
    gate["release"].set()
    t.join(timeout=10.0)
    assert not t.is_alive()
    res = out["res"]
    assert res.iteration == 0, "request re-labelled across the swap"
    assert float(res.tokens[0, -1]) == 0.0, "request decoded the new base"
    assert w.requests_pinned_across_swaps == 1
    assert _served_value(w) == 9.0


def test_rollback_moves_pointer_backwards(tmp_path):
    repo = _repo(tmp_path)
    w = ServingWorker(None, str(tmp_path), repo=repo, engine_factory=_fake)
    w.poll_once()
    _publish(repo, 3.0)
    _publish(repo, 5.0)
    assert w.poll_once() and w.current_iteration == 2
    assert _served_value(w) == 5.0
    repo.rollback(1)
    assert w.poll_once(), "rollback publish was not observed"
    assert w.current_iteration == 1
    assert _served_value(w) == 3.0
    assert w.last_swap == {"from_iteration": 2, "to_iteration": 1,
                           "swap_latency_s": w.last_swap["swap_latency_s"]}
    assert w.live_swaps == 2 and w.versions_served == {0, 1, 2}


def test_generate_before_first_swap_raises(tmp_path):
    w = ServingWorker(None, str(tmp_path), device="cpu", engine_factory=_fake)
    with pytest.raises(RuntimeError, match="no base resident"):
        w.generate(PROMPTS)


def test_device_defaults_to_the_card(tmp_path):
    """Cross-process the worker loads onto the card unless asked for the
    CPU; in-process it serves the repository's tensors where they live."""
    repo = _repo(tmp_path)
    assert ServingWorker(None, str(tmp_path), repo=repo, engine_factory=_fake).device.type == "cpu"
    with pytest.raises(ValueError, match="in-process"):
        ServingWorker(None, str(tmp_path), repo=repo, device="cuda", engine_factory=_fake)
    with pytest.raises(ValueError, match="family="):
        ServingWorker(None, str(tmp_path), repo=repo, family="f1", engine_factory=_fake)
    if torch.cuda.is_available():
        assert ServingWorker(None, str(tmp_path), engine_factory=_fake).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingWorker(None, str(tmp_path), engine_factory=_fake)


def test_cross_process_worker_and_status_embedding(tmp_path):
    repo = _repo(tmp_path)
    _publish(repo, 4.0)
    w = ServingWorker(None, str(tmp_path), device="cpu", engine_factory=_fake)
    assert w.poll_once() and w.current_iteration == 1
    assert _served_value(w) == 4.0
    assert not w.poll_once(), "no new publish, no swap"
    _publish(repo, 6.0)
    assert w.poll_once() and w.current_iteration == 2
    assert _served_value(w) == 6.0

    state = tckpt.load_json(os.path.join(str(tmp_path), tcs.SERVING_STATE_FILE))
    assert state["iteration"] == 2
    assert state["versions_served"] == [1, 2]
    assert state["swaps_total"] == 2 and state["live_swaps"] == 1
    assert state["last_swap"]["swap_latency_s"] > 0.0

    svc = tcs.ColdService(repo, policy=tcs.AdmissionPolicy())
    st = svc.status()
    assert st["serving"]["iteration"] == 2
    assert st["serving"]["versions_served"] == [1, 2]
    assert tckpt.load_json(os.path.join(str(tmp_path), tcs.STATUS_FILE))["serving"]["iteration"] == 2
    svc.close()

    records = tckpt.read_jsonl(os.path.join(str(tmp_path), tcs.METRICS_FILE))
    swaps = [r for r in records if r.get("event") == "swap"]
    assert [s["to_iteration"] for s in swaps] == [1, 2]
    assert all(s["swap_latency_s"] > 0 and "requests_pinned_across_swaps" in s for s in swaps)


def test_family_member_is_followed_cross_process(tmp_path):
    """``family=`` resolves the member's root, a whole repository layout."""
    member = Repository(_m(0), root=family_member_root(str(tmp_path), "f1"), spill=True,
                        screen=False)
    _publish(member, 2.0)
    w = ServingWorker(None, str(tmp_path), family="f1", device="cpu", engine_factory=_fake)
    assert w.root == family_member_root(str(tmp_path), "f1") and w.family == "f1"
    assert w.poll_once() and w.current_iteration == 1 and _served_value(w) == 2.0
    assert w.serve_state()["family"] == "f1"


def test_watch_error_is_recorded_and_serving_continues(tmp_path):
    repo = _repo(tmp_path)
    _publish(repo, 4.0)
    w = ServingWorker(None, str(tmp_path), device="cpu", engine_factory=_fake)
    w.poll_once()
    _publish(repo, 6.0)
    os.remove(os.path.join(str(tmp_path), "base_iter0002.npz"))  # gone before the follower loads it
    w.start(interval=0.001)
    try:
        wait_until(lambda: w.watch_error is not None, desc="the failed swap recorded")
        assert _served_value(w) == 4.0 and w.current_iteration == 1
    finally:
        w.stop()
    assert "FileNotFoundError" in w.watch_error


def test_watch_thread_swaps_under_concurrent_traffic(tmp_path):
    repo = _repo(tmp_path)
    w = ServingWorker(None, str(tmp_path), repo=repo, engine_factory=_fake)
    w.poll_once()
    w.start(interval=0.001)
    expected = {0: 0.0}
    stop = threading.Event()
    seen, errors = [], []

    def client():
        while not stop.is_set():
            try:
                r = w.generate(PROMPTS, max_new_tokens=2)
                seen.append((r.iteration, float(r.tokens[0, -1])))
            except Exception as err:  # noqa: BLE001
                errors.append(err)

    threads = [threading.Thread(target=client) for _ in range(3)]
    for t in threads:
        t.start()
    try:
        for k in range(1, 5):
            expected[_publish(repo, 10.0 * k)] = 10.0 * k
            wait_until(lambda k=k: w.current_iteration == k, desc=f"adoption of iteration {k}")
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=10.0)
        w.stop()
    assert not errors
    assert w.live_swaps >= 3
    assert seen, "no traffic flowed"
    torn = [(it, v) for it, v in seen if expected[it] != v]
    assert not torn, f"version-torn responses: {torn[:5]}"
    assert w.watch_error is None


def _is_subsequence(sub, seq):
    it = iter(seq)
    return all(x in it for x in sub)


@settings(max_examples=12)
@given(st.data())
def test_interleaving_serves_only_published_versions(data):
    ops = data.draw(st.lists(st.sampled_from(["publish", "poll", "generate", "rollback"]),
                             min_size=4, max_size=14))
    root = tempfile.mkdtemp(prefix="torch_hot_swap_prop_")
    try:
        repo = _repo(root)
        w = ServingWorker(None, root, repo=repo, engine_factory=_fake)
        w.poll_once()
        published_seq = [0]
        live = {0: 0.0}
        served_seq = [0]
        swap_value = live[0]
        next_v = 1.0
        for op in ops:
            if op == "publish":
                it = _publish(repo, next_v)
                live[it] = next_v
                published_seq.append(it)
                next_v += 1.0
            elif op == "rollback":
                if repo.iteration == 0:
                    continue
                target = data.draw(st.integers(0, repo.iteration - 1))
                repo.rollback(target)
                live = {k: v for k, v in live.items() if k <= target}
                published_seq.append(target)
            elif op == "poll":
                if w.poll_once():
                    served_seq.append(w.current_iteration)
                    swap_value = live[w.current_iteration]
            else:
                r = w.generate(PROMPTS, max_new_tokens=2)
                assert r.iteration == w.current_iteration
                assert float(r.tokens[0, -1]) == swap_value
        assert _is_subsequence(served_seq, published_seq)
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------------------
# parity with the JAX package: reduced gemma3-1b, f32
# ---------------------------------------------------------------------------

LM_PROMPT = np.arange(3, 11, dtype=np.int32)[None, :]
LM_NEW, LM_MAX_LEN = 6, 16


@pytest.fixture(scope="module")
def lm():
    """(JAX config, port config, JAX params as numpy, the two published
    perturbations), built once."""
    jcfg = jreduce_config(jget_config("gemma3-1b"))
    tcfg = reduce_config(get_config("gemma3-1b"))
    jp = jax.tree.map(np.asarray, JT.init_lm(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(7)
    steps = [jax.tree.map(lambda a, s=s: (a + s * rng.standard_normal(a.shape)).astype(a.dtype),
                          jp) for s in (0.05, 0.1)]
    return jcfg, tcfg, jp, steps


class _Held:
    """Engine factory wrapping a package's real Engine; ``hold`` set, the
    next generate signals ``started`` and waits for ``release``."""

    def __init__(self, engine_cls):
        self.engine_cls, self.engine, self.hold = engine_cls, None, None

    def __call__(self, cfg, params, max_len):
        self.engine = self.engine_cls(cfg, params, max_len=max_len)
        return self

    def generate(self, prompts, **kw):
        hold, self.hold = self.hold, None
        if hold is not None:
            hold["started"].set()
            assert hold["release"].wait(60.0), "held request never released"
        return self.engine.generate(prompts, **kw)


def _scripted(pkg, root, lm):
    """publish, a request held across the next publish, a request, rollback,
    a request: the served (iteration, tokens), the final serve_state and
    the swap records."""
    jcfg, tcfg, jp, steps = lm
    if pkg == "jax":
        to_tree = lambda t: jax.tree.map(jnp.asarray, t)  # noqa: E731
        repo = JRepository(to_tree(jp), root=root, spill=True, screen=False)
        held = _Held(JEngine)
        w = JServingWorker(jcfg, root, repo=repo, max_len=LM_MAX_LEN, engine_factory=held)
        read_jsonl = jckpt.read_jsonl
    else:
        to_tree = lambda t: convert.from_jax_params(t, "cpu")  # noqa: E731
        repo = Repository(to_tree(jp), root=root, spill=True, screen=False)
        held = _Held(TEngine)
        w = ServingWorker(tcfg, root, repo=repo, max_len=LM_MAX_LEN, engine_factory=held)
        read_jsonl = tckpt.read_jsonl

    def publish(tree):
        repo.upload(to_tree(tree))
        repo.fuse_pending()
        repo.flush()

    served = []

    def request():
        r = w.generate(LM_PROMPT, max_new_tokens=LM_NEW)
        served.append((r.iteration, np.asarray(r.tokens).astype(np.int64)))

    assert w.poll_once()
    request()                                   # iteration 0
    publish(steps[0])
    assert w.poll_once()
    hold = {"started": threading.Event(), "release": threading.Event()}
    held.hold = hold
    t = threading.Thread(target=request)
    t.start()
    assert hold["started"].wait(60.0)
    publish(steps[1])
    assert w.poll_once() and w.current_iteration == 2
    hold["release"].set()
    t.join(timeout=60.0)
    assert not t.is_alive()
    request()                                   # iteration 2
    repo.rollback(1)
    assert w.poll_once() and w.current_iteration == 1
    request()                                   # iteration 1 again
    state = w.serve_state()
    records = [r for r in read_jsonl(os.path.join(root, "metrics.jsonl"))
               if r.get("event") == "swap"]
    return served, state, records


_TIMES = ("updated_at", "pid", "last_swap_latency_s")


def test_scripted_sequence_matches_reference(tmp_path, lm):
    got = {pkg: _scripted(pkg, str(tmp_path / pkg), lm) for pkg in ("jax", "torch")}
    (jserved, jstate, jrec), (tserved, tstate, trec) = got["jax"], got["torch"]
    assert [it for it, _ in jserved] == [it for it, _ in tserved] == [0, 1, 2, 1]
    for (_, jt), (_, tt) in zip(jserved, tserved):
        np.testing.assert_array_equal(tt, jt)
    # the held request served iteration 1's weights, not iteration 2's
    assert not np.array_equal(tserved[1][1], tserved[2][1])
    np.testing.assert_array_equal(tserved[1][1], tserved[3][1])
    strip = lambda s: {k: (v if k != "last_swap" else  # noqa: E731
                           {a: b for a, b in v.items() if a != "swap_latency_s"})
                       for k, v in s.items() if k not in _TIMES}
    assert strip(tstate) == strip(jstate)
    assert tstate["requests_pinned_across_swaps"] == 1 and tstate["live_swaps"] == 3
    assert tstate["versions_served"] == [0, 1, 2]
    drop = lambda r: {k: v for k, v in r.items() if k not in ("t", "swap_latency_s")}  # noqa: E731
    assert [drop(r) for r in trec] == [drop(r) for r in jrec]
    assert [r["to_iteration"] for r in trec] == [0, 1, 2, 1]


def _drain(svc, target):
    for _ in range(200):
        st = svc.run_once()
        if (st["iteration"] >= target and st["queue_depth"] == 0 and st["staged"] == 0
                and not st["inflight"]):
            return svc.close()
    raise AssertionError(f"daemon never published iteration {target}: {st}")


def test_port_worker_follows_a_reference_daemon(tmp_path, lm):
    """The JAX package's daemon fuses one queued submission; the port's
    worker adopts the published npz and serves the reference Engine's
    tokens on it, and the reference daemon's status embeds its state."""
    jcfg, tcfg, jp, steps = lm
    root = str(tmp_path)
    jrepo = JRepository(jax.tree.map(jnp.asarray, jp), root=root, spill=True, screen=False)
    jcs.ContributorClient(root, "c0").submit(jax.tree.map(jnp.asarray, steps[0]),
                                             base_iteration=0)
    _drain(jcs.ColdService(jrepo, policy=jcs.AdmissionPolicy(min_cohort=1)), 1)
    w = ServingWorker(tcfg, root, device="cpu", max_len=LM_MAX_LEN)
    assert w.poll_once() and w.current_iteration == 1
    got = w.generate(LM_PROMPT, max_new_tokens=LM_NEW)
    base = jckpt.load(os.path.join(root, "base_iter0001.npz"))
    want = JEngine(jcfg, base, max_len=LM_MAX_LEN).generate(LM_PROMPT, max_new_tokens=LM_NEW)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    jw = JServingWorker(jcfg, root, max_len=LM_MAX_LEN, worker_id="ref", name="ref")
    assert jw.poll_once()
    np.testing.assert_array_equal(jw.generate(LM_PROMPT, max_new_tokens=LM_NEW).tokens,
                                  got.tokens)
    svc = jcs.ColdService(JRepository.open(root, spill=True), policy=jcs.AdmissionPolicy())
    serving = svc.status()["serving"]
    svc.close()
    assert serving["n_workers"] == 2 and serving["iteration"] == 1
    assert set(serving["workers"]) == {"ref", "worker"}


def test_reference_worker_follows_a_port_daemon(tmp_path, lm):
    jcfg, tcfg, jp, steps = lm
    root = str(tmp_path)
    trepo = Repository(convert.from_jax_params(jp, "cpu"), root=root, spill=True, screen=False)
    tcs.ContributorClient(root, "c0").submit(convert.from_jax_params(steps[0], "cpu"),
                                             base_iteration=0)
    _drain(tcs.ColdService(trepo, policy=tcs.AdmissionPolicy(min_cohort=1)), 1)
    jw = JServingWorker(jcfg, root, max_len=LM_MAX_LEN)
    assert jw.poll_once() and jw.current_iteration == 1
    got = jw.generate(LM_PROMPT, max_new_tokens=LM_NEW)
    base = tckpt.load(os.path.join(root, "base_iter0001.npz"))
    want = TEngine(tcfg, base, max_len=LM_MAX_LEN).generate(LM_PROMPT, max_new_tokens=LM_NEW)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    svc = tcs.ColdService(Repository.open(root, device="cpu", spill=True),
                          policy=tcs.AdmissionPolicy())
    serving = svc.status()["serving"]
    svc.close()
    assert serving["iteration"] == 1 and serving["versions_served"] == [1]


# ---------------------------------------------------------------------------
# the status block over the same state files, both packages
# ---------------------------------------------------------------------------


def _state(worker, iteration, served, **kw):
    st = {"worker": worker, "worker_id": worker, "iteration": iteration, "swapping": False,
          "swaps_total": len(served), "live_swaps": len(served) - 1,
          "versions_served": served, "requests_total": 3, "requests_pinned_across_swaps": 1,
          "requests_batched": 2, "inflight": 0, "updated_at": 1.5e9}
    st.update(kw)
    return st


@pytest.mark.parametrize("case", ["none", "solo", "pool", "diverged", "torn"])
def test_serving_state_block_matches_reference(tmp_path, case):
    files = {
        "none": {},
        "solo": {"serving_state.json": _state("worker", 2, [1, 2])},
        "pool": {"serving_state-w0.json": _state("w0", 1, [0, 1]),
                 "serving_state-w1.json": _state("w1", 1, [1], swapping=True, inflight=2)},
        "diverged": {"serving_state-w0.json": _state("w0", 1, [0, 1]),
                     "serving_state-w1.json": _state("w1", 0, [0]),
                     "serving_state.json": _state("solo", 1, [1])},
        "torn": {"serving_state-w0.json": _state("w0", 3, [3]),
                 "serving_state-w1.json": "{not json"},
    }[case]
    blocks = {}
    for pkg in ("jax", "torch"):
        root = str(tmp_path / pkg)
        if pkg == "jax":
            svc = jcs.ColdService(JRepository({"w": jnp.zeros(8)}, root=root, spill=True),
                                  policy=jcs.AdmissionPolicy())
        else:
            svc = tcs.ColdService(Repository({"w": torch.zeros(8)}, root=root, spill=True),
                                  policy=tcs.AdmissionPolicy())
        for fn, body in files.items():
            with open(os.path.join(root, fn), "w") as f:
                f.write(body if isinstance(body, str) else json.dumps(body))
        blocks[pkg] = svc.status()["serving"]
        svc.close()
    assert blocks["torch"] == blocks["jax"]
    if case == "diverged":
        assert blocks["torch"]["iteration"] is None and blocks["torch"]["n_workers"] == 3
    if case == "torn":
        assert set(blocks["torch"]["workers"]) == {"w0"}
