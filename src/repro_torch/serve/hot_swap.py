"""The fuse-to-serve path: serve the repository's latest published base and
hot-swap on every publish (port of ``repro.serve.hot_swap``).

The paper's synergistic loop (§1) pays off when users generate against each
newly published base.  ``ServingWorker`` composes the serve layer's parts:

* a ``BaseFollower`` (``serve/base_follower.py``) watches the published
  iteration and does the residency barrier and the atomic flip, forward
  publishes and rollbacks alike;
* an optional ``BatchScheduler`` (``serve/scheduler.py``) coalesces
  compatible single-row requests into shared ``[B, T]`` batches
  (``batch_requests=True``);
* the worker owns the ``Engine``, runs each request against its pinned
  ``BaseVersion`` and publishes its serving state.

**Version-pinned requests**: ``generate`` captures the follower's current
``BaseVersion`` once and decodes every step against it, so a request in
flight across a swap, or a rollback, finishes on the base it started on.

Observability: the state file is written atomically, ``serving_state.json``
for the solo worker or ``serving_state-<id>.json`` with ``worker_id=`` (one
per pool member; the daemon's ``status()["serving"]`` aggregates them), and
each swap appends an ``event="swap"`` record to ``metrics.jsonl``.  Once
``start()``ed the worker also rewrites its state every 0.25 s, so a router's
health check sees a fresh ``updated_at`` between swaps.

Crash discipline: the follower's swap path carries the seams
``worker.pre_transfer``, ``worker.post_transfer_pre_flip`` and
``worker.post_flip``; a restarted worker re-reads ``repository.json`` and
can only load a published base.
"""
from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from repro_torch.checkpoint import io as ckpt
from repro_torch.serve.base_follower import BaseFollower, BaseVersion
from repro_torch.serve.cold_service import METRICS_FILE, serving_state_filename
from repro_torch.serve.engine import Engine

__all__ = ["BaseVersion", "ServedGeneration", "ServingWorker"]


@dataclass
class ServedGeneration:
    """An engine result stamped with the base version that served it (the
    pinned one, not necessarily the newest) and the executed batch size
    (> 1 when the scheduler coalesced the request with others)."""

    tokens: np.ndarray
    prompt_len: int
    steps: int
    iteration: int
    latency_s: float
    batch_size: int = 1


def _default_engine_factory(cfg, params, max_len: int) -> Engine:
    return Engine(cfg, params, max_len=max_len)


class ServingWorker:
    """Serve the latest published base, hot-swapping on every publish and
    rollback, with version-pinned in-flight requests.

    In-process (``repo=``) the worker adopts each published tree by
    reference; cross-process (``root`` only, or ``family=`` a member under a
    family root) it loads each published npz onto ``device`` (default the
    card; raises without one).  ``engine_factory(cfg, params, max_len)``
    builds the engine once, inside the follower's ``on_resident`` hook, so
    no reader sees a version the engine cannot serve; later versions are
    served through ``generate(params=)``, so the engine keeps its first
    version's tree for its whole life, as the reference's does.

    ``worker_id=`` names the state file ``serving_state-<id>.json``.
    ``batch_requests=True`` routes single-row ``generate`` calls through a
    ``BatchScheduler`` (queue of ``queue_depth``, batches up to
    ``max_batch``, coalesced within ``batch_wait_s``); multi-row calls go to
    the engine directly.
    """

    def __init__(self, cfg, root: Optional[str], *, repo=None, family: Optional[str] = None,
                 device=None, max_len: int = 256, name: str = "worker",
                 engine_factory: Optional[Callable[..., Any]] = None,
                 worker_id: Optional[str] = None, batch_requests: bool = False,
                 queue_depth: int = 64, max_batch: int = 8, batch_wait_s: float = 0.002):
        self.cfg = cfg
        self.max_len = int(max_len)
        self.name = str(name)
        self.worker_id = None if worker_id is None else str(worker_id)
        self._engine_factory = engine_factory or _default_engine_factory
        self._engine: Optional[Any] = None
        self._stats_lock = threading.Lock()
        self.requests_total = 0
        self.requests_pinned_across_swaps = 0
        self.requests_batched = 0      # served as part of a coalesced batch
        self._inflight = 0             # the router's load signal
        self._follower = BaseFollower(
            root, repo=repo, family=family, device=device, name=self.name,
            on_swap_begin=self._on_swap_begin, on_resident=self._on_resident,
            on_swap=self._on_swap)
        self.root = self._follower.root
        self.family = self._follower.family
        self.device = self._follower.device
        self._scheduler = None
        if batch_requests:
            from repro_torch.serve.scheduler import BatchScheduler
            self._scheduler = BatchScheduler(
                self._execute_batch, queue_depth=queue_depth, max_batch=max_batch,
                max_wait_s=batch_wait_s, name=self.name)
            self._scheduler.start()
        self._last_persist = 0.0
        # merged into serve_state() last: a host process (the pool child)
        # advertises its port and id to state-file readers
        self.extra_state: Dict[str, Any] = {}

    # -- follower hooks --------------------------------------------------
    def _on_swap_begin(self, iteration: int) -> None:
        # persist the `swapping` flag so a router polling the file drains us
        self._persist_state()

    def _on_resident(self, version: BaseVersion) -> None:
        if self._engine is None:
            self._engine = self._engine_factory(self.cfg, version.params, self.max_len)

    def _on_swap(self, record: Dict[str, Any], version: BaseVersion,
                 prev: Optional[BaseVersion]) -> None:
        self._persist_state()
        with self._stats_lock:
            requests_total = self.requests_total
            pinned = self.requests_pinned_across_swaps
        # a plain append: the daemon is the series' single rotator
        ckpt.append_jsonl(os.path.join(self.root, METRICS_FILE), {
            "t": time.time(), "event": "swap", "worker": self.name,
            **record,
            "versions_served": len(self._follower.versions_served),
            "requests_total": requests_total,
            "requests_pinned_across_swaps": pinned,
        })

    # -- follower delegation ---------------------------------------------
    def attach(self, repo) -> None:
        self._follower.attach(repo)

    def poll_once(self) -> bool:
        return self._follower.poll_once()

    def current(self) -> Optional[BaseVersion]:
        return self._follower.current()

    @property
    def current_iteration(self) -> Optional[int]:
        return self._follower.current_iteration

    @property
    def swapping(self) -> bool:
        return self._follower.swapping

    @property
    def swaps_total(self) -> int:
        return self._follower.swaps_total

    @property
    def live_swaps(self) -> int:
        return self._follower.live_swaps

    @property
    def versions_served(self):
        return self._follower.versions_served

    @property
    def last_swap(self) -> Optional[Dict[str, Any]]:
        return self._follower.last_swap

    @property
    def last_swap_latency_s(self) -> Optional[float]:
        return self._follower.last_swap_latency_s

    @property
    def watch_error(self) -> Optional[str]:
        return self._follower.watch_error

    @property
    def _swap_log(self) -> List[int]:
        return self._follower._swap_log

    # -- serving --------------------------------------------------------
    def _execute_batch(self, prompts: np.ndarray, max_new_tokens: int, version: BaseVersion):
        """The scheduler's executor: one batched engine call against the
        batch's pinned version."""
        return self._engine.generate(prompts, max_new_tokens=max_new_tokens,
                                     params=version.params)

    def generate(self, prompts: np.ndarray, *, max_new_tokens: int = 16,
                 deadline_s: Optional[float] = None) -> ServedGeneration:
        """Version-pinned generation: the base version is captured once here
        and every decode step runs against it.  With batching on, a
        single-row prompt goes through the scheduler, which coalesces it
        only with requests pinned to the same version; ``deadline_s`` (wall
        seconds from now) applies there, and a request that cannot start in
        time fails with ``RequestRejected("deadline")``."""
        version = self._follower.current()
        if version is None:
            raise RuntimeError("ServingWorker has no base resident yet — call poll_once() "
                               "(or start()) after the repository published")
        t0 = time.perf_counter()
        with self._stats_lock:
            self._inflight += 1
        try:
            batched = (self._scheduler is not None and prompts.ndim == 2
                       and prompts.shape[0] == 1)
            if batched:
                ticket = self._scheduler.submit(prompts[0], max_new_tokens=max_new_tokens,
                                                version=version, deadline_s=deadline_s)
                out = ticket.result()
                tokens = out.tokens[None, :]
                steps, prompt_len = out.steps, int(prompts.shape[1])
                batch_size = out.batch_size
            else:
                res = self._engine.generate(prompts, max_new_tokens=max_new_tokens,
                                            params=version.params)
                tokens, steps = res.tokens, res.steps
                prompt_len, batch_size = res.prompt_len, 1
        finally:
            with self._stats_lock:
                self._inflight -= 1
        dt = time.perf_counter() - t0
        with self._stats_lock:
            self.requests_total += 1
            if batched and batch_size > 1:
                self.requests_batched += 1
            if self._follower.current() is not version:
                self.requests_pinned_across_swaps += 1
        return ServedGeneration(tokens=tokens, prompt_len=prompt_len, steps=steps,
                                iteration=version.iteration, latency_s=dt,
                                batch_size=batch_size)

    # -- observability --------------------------------------------------
    def serve_state(self) -> Dict[str, Any]:
        """The serving-state payload (the reference's keys)."""
        st = self._follower.swap_stats()
        with self._stats_lock:
            st.update({
                "worker": self.name,
                "worker_id": self.worker_id,
                "family": self.family,
                "requests_total": self.requests_total,
                "requests_pinned_across_swaps": self.requests_pinned_across_swaps,
                "requests_batched": self.requests_batched,
                "inflight": self._inflight,
                "pid": os.getpid(),
                "updated_at": time.time(),
            })
        if self._scheduler is not None:
            st["scheduler"] = self._scheduler.stats()
        st.update(self.extra_state)
        return st

    @property
    def state_path(self) -> str:
        return os.path.join(self.root, serving_state_filename(self.worker_id))

    def _persist_state(self) -> None:
        ckpt.save_json_atomic(self.state_path, self.serve_state())
        self._last_persist = time.monotonic()

    def _tick(self) -> None:
        # the heartbeat between swaps: a router tells an idle worker from a
        # dead one by the state file's updated_at
        if time.monotonic() - self._last_persist >= 0.25:
            self._persist_state()

    # -- watch thread ---------------------------------------------------
    def start(self, *, interval: float = 0.05) -> None:
        """Run the follower's watch loop on a daemon thread until ``stop``;
        a swap error is recorded and the current version keeps serving."""
        self._follower.start(interval=interval, on_tick=self._tick)

    def stop(self) -> Dict[str, Any]:
        """Stop the watch thread and the scheduler, and persist a final
        serving state."""
        self._follower.stop()
        if self._scheduler is not None:
            self._scheduler.stop()
        self._persist_state()
        return self.serve_state()
