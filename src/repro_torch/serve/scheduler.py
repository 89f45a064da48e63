"""BatchScheduler: a bounded request queue that coalesces compatible
requests (port of ``repro.serve.scheduler``; host-only: numpy and threads).

One engine call has a large fixed cost (Python dispatch, one kernel launch
per layer and step) that barely grows with the batch at serving sizes, so
under concurrent load N single-row ``generate`` calls leave most of the
throughput unused.  The scheduler sits in front of a batched
``Engine.generate`` and coalesces waiting requests into one ``[B, T]`` call:

* **compatibility** — two requests share a batch only with the same prompt
  length ``T`` (a causal LM's prompt cannot be padded), the same
  ``max_new_tokens`` (one decode loop per call) and the same pinned
  ``BaseVersion`` object (pinning is per request; a batch across a swap
  would tear).  ``B`` is padded up to a small bucket set by repeating the
  last row, and the outputs are sliced back out, so the engine sees a few
  batch shapes only.
* **bounded queue, explicit shedding** — at ``queue_depth`` waiting requests
  ``submit`` fails fast with ``RequestRejected("queue_full")``; a request
  whose ``deadline_s`` passes before it starts fails with
  ``RequestRejected("deadline")``.
* **fairness** — every batch is built around the oldest waiting request,
  and only requests compatible with it may join (within ``max_wait_s`` of
  extra coalescing delay), so no request shape can starve another.

The executor runs on the scheduler's own thread:
``execute(prompts[B, T], max_new_tokens, version)`` returns an object with
``.tokens [B, T+new]`` and ``.steps`` (the ``Engine`` result's shape).
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

__all__ = ["BATCH_BUCKETS", "BatchScheduler", "RequestRejected", "SchedResult", "Ticket",
           "batch_bucket"]

BATCH_BUCKETS = (1, 2, 4, 8)


class RequestRejected(RuntimeError):
    """A request the scheduler refused to execute; ``reason`` is one of
    ``queue_full``, ``deadline`` and ``stopped``."""

    def __init__(self, reason: str, detail: str = ""):
        self.reason = str(reason)
        super().__init__(f"request rejected: {reason}" + (f" ({detail})" if detail else ""))


def batch_bucket(n: int, buckets: Tuple[int, ...] = BATCH_BUCKETS) -> int:
    """The executed batch size for ``n`` coalesced requests: the smallest
    bucket >= n, or ``n`` itself beyond the largest bucket."""
    for b in buckets:
        if b >= n:
            return b
    return n


@dataclass
class SchedResult:
    """One request's slice of a batched engine call."""

    tokens: np.ndarray          # [T + steps]: this request's row
    steps: int
    batch_size: int             # the executed (bucketed) B
    coalesced: int              # real requests that shared the call
    queued_s: float             # submit -> execution start


@dataclass
class _Request:
    prompt: np.ndarray
    max_new_tokens: int
    version: Any
    deadline: Optional[float]   # absolute monotonic, None = never
    submitted: float
    done: threading.Event = field(default_factory=threading.Event)
    result: Optional[SchedResult] = None
    error: Optional[BaseException] = None

    def key(self) -> Tuple[int, int, int]:
        # the same pin is the same BaseVersion object: a re-adopted
        # iteration after a rollback is a different resident tree
        return (int(self.prompt.shape[0]), self.max_new_tokens, id(self.version))


class Ticket:
    """The caller's handle on a submitted request."""

    def __init__(self, req: _Request):
        self._req = req

    def result(self, timeout: Optional[float] = None) -> SchedResult:
        """Block until the request executed; raises the executor's error or
        ``RequestRejected`` as is."""
        if not self._req.done.wait(timeout):
            raise TimeoutError("scheduler request still pending")
        if self._req.error is not None:
            raise self._req.error
        return self._req.result


class BatchScheduler:
    """Bounded FIFO queue and coalescing loop in front of a batched engine.
    ``submit`` is thread-safe and never blocks; one scheduler thread forms
    and executes the batches.  ``stats()`` is what the worker embeds in its
    serving state."""

    def __init__(self, execute: Callable[[np.ndarray, int, Any], Any], *,
                 queue_depth: int = 64, max_batch: int = 8,
                 buckets: Tuple[int, ...] = BATCH_BUCKETS,
                 max_wait_s: float = 0.002, name: str = "sched"):
        if queue_depth < 1 or max_batch < 1:
            raise ValueError("queue_depth and max_batch must be >= 1")
        self._execute = execute
        self.queue_depth = int(queue_depth)
        self.max_batch = int(max_batch)
        self.buckets = tuple(sorted(int(b) for b in buckets))
        self.max_wait_s = float(max_wait_s)
        self.name = str(name)
        self._queue: deque[_Request] = deque()
        self._cond = threading.Condition()
        self._thread: Optional[threading.Thread] = None
        self._stopping = False
        # counters, under _cond
        self._submitted = 0
        self._completed = 0
        self._rejected_queue_full = 0
        self._rejected_deadline = 0
        self._batches = 0
        self._coalesced_requests = 0   # requests served in a batch of > 1
        self._max_queue_seen = 0

    # -- caller side -----------------------------------------------------
    def submit(self, prompt: np.ndarray, *, max_new_tokens: int, version: Any,
               deadline_s: Optional[float] = None) -> Ticket:
        """Enqueue one single-row request (``prompt`` is ``[T]``); rejects
        with ``queue_full`` at the depth bound."""
        prompt = np.asarray(prompt)
        if prompt.ndim != 1:
            raise ValueError(f"submit takes one [T] prompt row, got shape {prompt.shape}")
        now = time.monotonic()
        req = _Request(prompt=prompt, max_new_tokens=int(max_new_tokens), version=version,
                       deadline=None if deadline_s is None else now + float(deadline_s),
                       submitted=now)
        with self._cond:
            if self._stopping:
                raise RequestRejected("stopped", self.name)
            if len(self._queue) >= self.queue_depth:
                self._rejected_queue_full += 1
                raise RequestRejected("queue_full", f"{len(self._queue)}/{self.queue_depth}")
            self._submitted += 1
            self._queue.append(req)
            self._max_queue_seen = max(self._max_queue_seen, len(self._queue))
            self._cond.notify()
        return Ticket(req)

    # -- scheduler side --------------------------------------------------
    def _reject(self, req: _Request, reason: str) -> None:
        req.error = RequestRejected(reason)
        req.done.set()

    def _take_batch(self) -> Optional[List[_Request]]:
        """Pop the FIFO head and coalesce compatible followers (waiting up to
        ``max_wait_s`` for more), shedding expired requests."""
        with self._cond:
            while True:
                now = time.monotonic()
                # an expired head must not anchor (and delay) a batch
                alive = deque()
                for r in self._queue:
                    if r.deadline is not None and r.deadline <= now:
                        self._rejected_deadline += 1
                        self._reject(r, "deadline")
                    else:
                        alive.append(r)
                self._queue = alive
                if self._queue:
                    break
                if self._stopping:
                    return None
                self._cond.wait(0.05)
            head = self._queue.popleft()
            batch = [head]
            key = head.key()
            # one pass now, then bounded waits for late compatible arrivals;
            # FIFO order among the compatible is kept
            coalesce_until = time.monotonic() + self.max_wait_s
            while len(batch) < self.max_batch:
                rest = deque()
                for r in self._queue:
                    if len(batch) < self.max_batch and r.key() == key:
                        batch.append(r)
                    else:
                        rest.append(r)
                self._queue = rest
                remaining = coalesce_until - time.monotonic()
                if len(batch) >= self.max_batch or remaining <= 0:
                    break
                self._cond.wait(remaining)
            return batch

    def _run_batch(self, batch: List[_Request]) -> None:
        n = len(batch)
        bucket = batch_bucket(n, self.buckets)
        prompts = np.stack([r.prompt for r in batch])
        if bucket > n:
            # the padding rows repeat the last one; their outputs are dropped
            prompts = np.concatenate([prompts, np.repeat(prompts[-1:], bucket - n, axis=0)])
        started = time.monotonic()
        try:
            res = self._execute(prompts, batch[0].max_new_tokens, batch[0].version)
        except BaseException as err:  # noqa: BLE001 - fail the batch, not the loop
            for r in batch:
                r.error = err
                r.done.set()
            return
        tokens = np.asarray(res.tokens)
        for i, r in enumerate(batch):
            r.result = SchedResult(tokens=tokens[i], steps=int(res.steps), batch_size=bucket,
                                   coalesced=n, queued_s=started - r.submitted)
            r.done.set()
        with self._cond:
            self._batches += 1
            self._completed += n
            if n > 1:
                self._coalesced_requests += n

    def _loop(self) -> None:
        while True:
            batch = self._take_batch()
            if batch is None:
                return
            self._run_batch(batch)

    # -- lifecycle / observability --------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            raise RuntimeError("scheduler already started")
        self._stopping = False
        self._thread = threading.Thread(target=self._loop, name=f"sched-{self.name}",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        """Drain: queued requests still execute, new submits are shed."""
        with self._cond:
            self._stopping = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=30.0)
            self._thread = None

    def stats(self) -> Dict[str, Any]:
        with self._cond:
            return {
                "queue": len(self._queue),
                "queue_depth": self.queue_depth,
                "max_batch": self.max_batch,
                "buckets": list(self.buckets),
                "submitted": self._submitted,
                "completed": self._completed,
                "rejected_queue_full": self._rejected_queue_full,
                "rejected_deadline": self._rejected_deadline,
                "batches": self._batches,
                "coalesced_requests": self._coalesced_requests,
                "max_queue_seen": self._max_queue_seen,
            }
