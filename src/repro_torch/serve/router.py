"""Least-loaded router over a pool of serving workers (port of
``repro.serve.router``).

The router is the one entry point in front of N ``ServingWorker``s.  It
speaks to them through a small endpoint interface (``id``, ``health()``,
``generate(prompt, max_new_tokens=, deadline_s=)``): ``LocalEndpoint`` wraps
an in-process worker, ``serve.worker_pool.SocketEndpoint`` a pool child.
Its policies:

* **least-loaded dispatch** — the router counts its own in-flight requests
  per endpoint (it is the single dispatcher, so the count is exact) and
  picks the live endpoint with the fewest, rotating among equals;
* **drain on swap** — an endpoint whose health says ``swapping`` carries a
  large load penalty (drained, not excluded: if every worker is swapping,
  requests still go somewhere);
* **stale health is dead** — a health snapshot older than
  ``HEALTH_STALE_S`` marks the endpoint dead until it heartbeats again;
* **exactly-once re-route** — a request whose worker died in flight
  (``EndpointDied``: refused, reset, closed) is re-dispatched to another
  live endpoint at most ``max_reroutes`` times, and the endpoint is marked
  dead until its health recovers.  A ``queue_full`` shed fails over under
  the same budget without marking the worker dead; a second shed means the
  pool is saturated, and the caller sees it.

Version pinning is per worker and routing does not change it: a response
carries the iteration its worker pinned, and one request never spans two
workers.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.serve.scheduler import RequestRejected

__all__ = ["EndpointDied", "LocalEndpoint", "RoutedResult", "Router"]

# a swapping worker counts as this many extra in-flight requests
SWAP_DRAIN_PENALTY = 1_000
# older health than this is stale (workers heartbeat every ~0.25 s)
HEALTH_STALE_S = 5.0


class EndpointDied(RuntimeError):
    """The worker behind the endpoint is gone (connection refused, reset or
    closed mid-request), as opposed to ``RequestRejected``: alive and
    shedding."""


class RoutedResult:
    """One routed generation: the worker's response plus routing facts."""

    __slots__ = ("tokens", "iteration", "steps", "batch_size", "latency_s", "worker_id",
                 "rerouted")

    def __init__(self, *, tokens: np.ndarray, iteration: int, steps: int, batch_size: int,
                 latency_s: float, worker_id: str, rerouted: bool):
        self.tokens = tokens
        self.iteration = int(iteration)
        self.steps = int(steps)
        self.batch_size = int(batch_size)
        self.latency_s = float(latency_s)
        self.worker_id = str(worker_id)
        self.rerouted = bool(rerouted)


class LocalEndpoint:
    """An in-process ``ServingWorker`` as a routable endpoint."""

    def __init__(self, worker, endpoint_id: Optional[str] = None):
        self.worker = worker
        self.id = str(endpoint_id or worker.worker_id or worker.name)

    def health(self) -> Optional[Dict[str, Any]]:
        return self.worker.serve_state()

    def generate(self, prompt: np.ndarray, *, max_new_tokens: int,
                 deadline_s: Optional[float] = None) -> Dict[str, Any]:
        res = self.worker.generate(np.asarray(prompt)[None, :], max_new_tokens=max_new_tokens,
                                   deadline_s=deadline_s)
        return {"tokens": np.asarray(res.tokens)[0], "iteration": res.iteration,
                "steps": res.steps, "batch_size": res.batch_size, "latency_s": res.latency_s}


class Router:
    """Dispatch requests across endpoints and survive worker death.
    ``route`` is thread-safe; an endpoint marked dead is re-admitted by the
    next ``route`` that finds its health fresh again."""

    def __init__(self, endpoints: List[Any], *, max_reroutes: int = 1):
        if not endpoints:
            raise ValueError("router needs at least one endpoint")
        self.endpoints = list(endpoints)
        self.max_reroutes = int(max_reroutes)
        self._lock = threading.Lock()
        self._rr = 0   # rotating tie-break: equal loads go round robin
        self._inflight: Dict[str, int] = {e.id: 0 for e in self.endpoints}
        self._dead: Dict[str, bool] = {e.id: False for e in self.endpoints}
        self.routed_total = 0
        self.reroutes_total = 0
        self.failed_total = 0
        self.shed_total = 0            # queue_full surfaced to the caller
        self.per_worker: Dict[str, int] = {e.id: 0 for e in self.endpoints}

    # -- health / selection ---------------------------------------------
    def _probe(self, ep) -> Optional[Dict[str, Any]]:
        try:
            h = ep.health()
        except Exception:  # noqa: BLE001 - unreadable health is a dead endpoint
            return None
        if h is None:
            return None
        updated = h.get("updated_at")
        if updated is not None and time.time() - float(updated) > HEALTH_STALE_S:
            return None
        return h

    def _pick(self, exclude: set) -> Optional[Any]:
        """The least-loaded live endpoint (swapping ones penalised), or None
        when every candidate is dead or excluded."""
        best, best_load = None, None
        with self._lock:
            inflight = dict(self._inflight)
            dead = dict(self._dead)
            self._rr += 1
            offset = self._rr
        n = len(self.endpoints)
        for ep in (self.endpoints[(offset + i) % n] for i in range(n)):
            if ep.id in exclude:
                continue
            h = self._probe(ep)
            if h is None:
                with self._lock:
                    self._dead[ep.id] = True
                continue
            if dead.get(ep.id):
                # fresh health from a dead endpoint: a restarted worker
                with self._lock:
                    self._dead[ep.id] = False
            load = inflight.get(ep.id, 0)
            if h.get("swapping"):
                load += SWAP_DRAIN_PENALTY
            if best_load is None or load < best_load:
                best, best_load = ep, load
        return best

    # -- dispatch --------------------------------------------------------
    def route(self, prompt: np.ndarray, *, max_new_tokens: int = 16,
              deadline_s: Optional[float] = None) -> RoutedResult:
        """Dispatch one single-row request; re-route at most ``max_reroutes``
        times on worker death or shed."""
        prompt = np.asarray(prompt)
        tried: set = set()
        attempts = 0
        last_err: Optional[BaseException] = None
        while attempts <= self.max_reroutes:
            ep = self._pick(tried)
            if ep is None:
                break
            tried.add(ep.id)
            with self._lock:
                self._inflight[ep.id] = self._inflight.get(ep.id, 0) + 1
            try:
                out = ep.generate(prompt, max_new_tokens=max_new_tokens, deadline_s=deadline_s)
            except (EndpointDied, RequestRejected) as err:
                last_err = err
                if isinstance(err, EndpointDied):
                    with self._lock:
                        self._dead[ep.id] = True
                attempts += 1
                continue
            finally:
                with self._lock:
                    self._inflight[ep.id] -= 1
            with self._lock:
                self.routed_total += 1
                self.per_worker[ep.id] = self.per_worker.get(ep.id, 0) + 1
                if attempts > 0:
                    self.reroutes_total += 1
            return RoutedResult(tokens=np.asarray(out["tokens"]), iteration=out["iteration"],
                                steps=out["steps"], batch_size=out.get("batch_size", 1),
                                latency_s=out.get("latency_s", 0.0), worker_id=ep.id,
                                rerouted=attempts > 0)
        with self._lock:
            self.failed_total += 1
            if isinstance(last_err, RequestRejected):
                self.shed_total += 1
        if last_err is not None:
            raise last_err
        raise EndpointDied("no live endpoint to route to")

    # -- observability ---------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "endpoints": [e.id for e in self.endpoints],
                "dead": sorted(k for k, v in self._dead.items() if v),
                "inflight": dict(self._inflight),
                "routed_total": self.routed_total,
                "reroutes_total": self.reroutes_total,
                "failed_total": self.failed_total,
                "shed_total": self.shed_total,
                "per_worker": dict(self.per_worker),
            }
