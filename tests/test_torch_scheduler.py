"""The port's ``BatchScheduler`` against the JAX package's, on the CPU.

The twins of ``tests/test_scheduler.py``, each run over both packages'
schedulers (host-only code in both: numpy and threads): coalescing with
bucket padding, one pinned version per batch, bounded-queue shedding,
deadlines, FIFO-head fairness, executor-error isolation and drain-on-stop.
One scripted sequence then runs through both with the same deterministic
executor and must form the same batches, rejections and stats.
"""
import threading
import time
import types

import numpy as np
import pytest

from repro.serve import scheduler as jsched
from repro_torch.serve import scheduler as tsched

PKGS = {"jax": jsched, "torch": tsched}
V = object()   # a pinned BaseVersion stand-in (identity is what matters)


@pytest.fixture(params=sorted(PKGS))
def sched_mod(request):
    return PKGS[request.param]


class _Exec:
    """Records every executed batch; output rows echo the prompt's first
    token, so a row-slicing bug hands one request another's tokens.  An
    optional gate blocks mid-call to model an in-flight batch."""

    def __init__(self):
        self.calls = []
        self.gate = None

    def __call__(self, prompts, max_new_tokens, version):
        if self.gate is not None:
            self.gate["started"].set()
            assert self.gate["release"].wait(10.0), "gate never released"
        self.calls.append((np.array(prompts), max_new_tokens, version))
        toks = np.concatenate([prompts, np.repeat(prompts[:, :1], max_new_tokens, axis=1)],
                              axis=1)
        return types.SimpleNamespace(tokens=toks, steps=max_new_tokens)


def _sched(mod, ex, **kw):
    kw.setdefault("max_wait_s", 0.05)
    return mod.BatchScheduler(ex, **kw)


def _row(val, t=4):
    return np.full((t,), val, np.int32)


def test_batch_bucket_quantization(sched_mod):
    bb = sched_mod.batch_bucket
    assert [bb(n) for n in (1, 2, 3, 4, 5, 8)] == [1, 2, 4, 4, 8, 8]
    assert bb(9) == 9
    assert bb(3, (2, 16)) == 16
    assert tsched.BATCH_BUCKETS == jsched.BATCH_BUCKETS


def test_coalesces_compatible_requests_with_bucket_padding(sched_mod):
    ex = _Exec()
    s = _sched(sched_mod, ex)
    tickets = [s.submit(_row(i), max_new_tokens=3, version=V) for i in range(3)]
    s.start()
    results = [t.result(timeout=10.0) for t in tickets]
    s.stop()
    assert len(ex.calls) == 1, "compatible requests did not share a call"
    prompts, _, version = ex.calls[0]
    assert prompts.shape == (4, 4) and version is V
    assert np.array_equal(prompts[3], prompts[2])
    for i, r in enumerate(results):
        assert int(r.tokens[-1]) == i, "request got a neighbour's row"
        assert r.batch_size == 4 and r.coalesced == 3 and r.steps == 3
        assert r.queued_s >= 0.0
    st = s.stats()
    assert st["batches"] == 1 and st["completed"] == 3 and st["coalesced_requests"] == 3


def test_never_coalesces_across_pinned_versions(sched_mod):
    ex = _Exec()
    s = _sched(sched_mod, ex)
    v1, v2 = object(), object()
    t1 = s.submit(_row(1), max_new_tokens=2, version=v1)
    t2 = s.submit(_row(2), max_new_tokens=2, version=v2)
    s.start()
    r1, r2 = t1.result(10.0), t2.result(10.0)
    s.stop()
    assert len(ex.calls) == 2
    assert r1.coalesced == 1 and r2.coalesced == 1
    assert ex.calls[0][2] is v1 and ex.calls[1][2] is v2


def test_fifo_head_fairness_mixed_shapes(sched_mod):
    ex = _Exec()
    s = _sched(sched_mod, ex)
    odd = s.submit(_row(9, t=7), max_new_tokens=2, version=V)
    pop = [s.submit(_row(i), max_new_tokens=2, version=V) for i in range(3)]
    s.start()
    odd.result(10.0)
    for t in pop:
        t.result(10.0)
    s.stop()
    assert [c[0].shape for c in ex.calls] == [(1, 7), (4, 4)]


def test_mismatched_max_new_tokens_never_coalesce(sched_mod):
    ex = _Exec()
    s = _sched(sched_mod, ex)
    t1 = s.submit(_row(1), max_new_tokens=2, version=V)
    t2 = s.submit(_row(2), max_new_tokens=5, version=V)
    s.start()
    assert t1.result(10.0).steps == 2
    assert t2.result(10.0).steps == 5
    s.stop()
    assert len(ex.calls) == 2


def test_bounded_queue_sheds_explicitly(sched_mod):
    ex = _Exec()
    s = _sched(sched_mod, ex, queue_depth=2)
    t1 = s.submit(_row(0), max_new_tokens=1, version=V)
    t2 = s.submit(_row(1), max_new_tokens=1, version=V)
    with pytest.raises(sched_mod.RequestRejected, match="queue_full") as ei:
        s.submit(_row(2), max_new_tokens=1, version=V)
    assert ei.value.reason == "queue_full"
    assert s.stats()["rejected_queue_full"] == 1
    s.start()
    s.stop()
    assert t1.result(1.0) and t2.result(1.0)
    assert s.stats()["completed"] == 2


def test_deadline_expires_before_execution(sched_mod):
    ex = _Exec()
    s = _sched(sched_mod, ex)
    t = s.submit(_row(0), max_new_tokens=1, version=V, deadline_s=0.01)
    time.sleep(0.05)
    s.start()
    with pytest.raises(sched_mod.RequestRejected, match="deadline") as ei:
        t.result(10.0)
    assert ei.value.reason == "deadline"
    s.stop()
    assert s.stats()["rejected_deadline"] == 1
    assert not ex.calls, "an expired request anchored a batch"


def test_executor_error_fails_batch_not_loop(sched_mod):
    calls = []

    def ex(prompts, max_new_tokens, version):
        calls.append(prompts.shape)
        if len(calls) == 1:
            raise RuntimeError("boom")
        return types.SimpleNamespace(tokens=np.concatenate([prompts, prompts[:, :1]], axis=1),
                                     steps=1)

    s = sched_mod.BatchScheduler(ex, max_wait_s=0.01)
    s.start()
    t1 = s.submit(_row(0), max_new_tokens=1, version=V)
    with pytest.raises(RuntimeError, match="boom"):
        t1.result(10.0)
    t2 = s.submit(_row(1), max_new_tokens=1, version=V)
    assert t2.result(10.0).steps == 1
    s.stop()


def test_stop_drains_queue_then_sheds_new_submits(sched_mod):
    ex = _Exec()
    s = _sched(sched_mod, ex)
    tickets = [s.submit(_row(i), max_new_tokens=1, version=V) for i in range(5)]
    s.start()
    s.stop()
    for i, t in enumerate(tickets):
        assert int(t.result(1.0).tokens[-1]) == i
    with pytest.raises(sched_mod.RequestRejected, match="stopped"):
        s.submit(_row(0), max_new_tokens=1, version=V)
    assert s.stats()["completed"] == 5


def test_coalesces_late_arrivals_under_concurrent_load(sched_mod):
    ex = _Exec()
    ex.gate = {"started": threading.Event(), "release": threading.Event()}
    s = _sched(sched_mod, ex, max_wait_s=0.02)
    first = s.submit(_row(0), max_new_tokens=1, version=V)
    s.start()
    assert ex.gate["started"].wait(10.0)
    late = [s.submit(_row(i), max_new_tokens=1, version=V) for i in (1, 2)]
    ex.gate["release"].set()
    assert int(first.result(10.0).tokens[-1]) == 0
    results = [t.result(10.0) for t in late]
    s.stop()
    assert ex.calls[1][0].shape == (2, 4)
    assert all(r.coalesced == 2 for r in results)
    assert [int(r.tokens[-1]) for r in results] == [1, 2]


def _scripted(mod):
    """One submission script, queued before the loop starts so the batches
    are deterministic: shapes, lengths, pins, a full queue and an expired
    deadline.  Returns (executed batches, per-request outcome, stats)."""
    ex = _Exec()
    s = mod.BatchScheduler(ex, queue_depth=12, max_batch=4, max_wait_s=0.0)
    v1, v2 = object(), object()
    plan = ([(_row(i), 2, v1, None) for i in range(6)]           # 4 + 2 (bucket 2)
            + [(_row(10 + i, t=6), 2, v1, None) for i in range(3)]  # another T: 3 -> 4
            + [(_row(20), 3, v1, None), (_row(21), 2, v2, None)]    # other n, other pin
            + [(_row(30), 2, v1, 0.0)]                              # expires at once
            + [(_row(40), 2, v1, None)])                            # over the depth
    outcomes, tickets = [], []
    for prompt, n, ver, dl in plan:
        try:
            tickets.append(s.submit(prompt, max_new_tokens=n, version=ver, deadline_s=dl))
        except mod.RequestRejected as err:
            tickets.append(None)
            outcomes.append(("submit", err.reason))
    s.start()
    for t in tickets:
        if t is None:
            continue
        try:
            r = t.result(10.0)
            outcomes.append(("ok", int(r.tokens[-1]), r.batch_size, r.coalesced, r.steps))
        except mod.RequestRejected as err:
            outcomes.append(("rejected", err.reason))
    s.stop()
    names = {id(v1): "v1", id(v2): "v2"}
    batches = [(p.tolist(), n, names[id(v)]) for p, n, v in ex.calls]
    st = s.stats()
    return batches, outcomes, st


def test_same_script_same_batches_rejections_and_stats():
    jb, jo, js = _scripted(jsched)
    tb, to, ts = _scripted(tsched)
    assert tb == jb and to == jo and ts == js
    assert [len(b[0]) for b in tb] == [4, 2, 4, 1, 1]
    assert ("submit", "queue_full") in to and ("rejected", "deadline") in to
    assert ts["rejected_queue_full"] == 1 and ts["rejected_deadline"] == 1
