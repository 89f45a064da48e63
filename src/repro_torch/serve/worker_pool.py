"""WorkerPool: N ServingWorker processes behind socket endpoints (port of
``repro.serve.worker_pool``).

Each pool member is its own process running a ``ServingWorker``: its own
follower (polling ``repository.json`` cross-process), its own engine on its
``--device``, its own ``serving_state-<id>.json``, fronted by a
newline-delimited JSON protocol on a loopback port.  The parent
``WorkerPool`` spawns the children (``python -m
repro_torch.serve.worker_pool`` is the child's entry point), finds each
child's port in its state file and hands out ``SocketEndpoint``s for a
``serve.router.Router``.

Isolation is the point: a worker killed with ``kill -9`` takes down one
process; its state file goes stale, the router marks it dead on the
transport error and re-routes the failed request once, and the other
workers keep serving.  Since a base npz is durable before
``repository.json`` names it, a restarted worker only adopts published
bases.

Protocol (one JSON object per line, request and response)::

    {"op": "generate", "prompt": [..], "max_new_tokens": 4}
      -> {"ok": true, "tokens": [..], "iteration": 3, "steps": 4,
          "batch_size": 2, "latency_s": 0.01}
      -> {"ok": false, "rejected": "queue_full"}     (worker shedding)
      -> {"ok": false, "error": "..."}               (worker error)
    {"op": "ping"}  -> {"ok": true, "iteration": 3}

The child's ``--engine value`` is a closed-form fake engine (its tokens are
the served tree's scalar ``w``, so a token mismatch is a version tear);
``--engine real`` (the default) builds the ``Engine`` from
``reduce_config(get_config(--arch))``.
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import socket
import socketserver
import subprocess
import sys
import threading
import time
import types
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.checkpoint import io as ckpt
from repro_torch.serve.cold_service import serving_state_filename
from repro_torch.serve.router import EndpointDied, Router
from repro_torch.serve.scheduler import RequestRejected

__all__ = ["SocketEndpoint", "WorkerPool"]

_CONNECT_TIMEOUT_S = 5.0


class SocketEndpoint:
    """A pool child as a routable endpoint: health from its state file,
    generation over the loopback socket.  A transport failure (refused,
    reset, closed, timed out) raises ``EndpointDied``; an alive worker's
    shed raises ``RequestRejected``."""

    def __init__(self, root: str, worker_id: str, *, request_timeout_s: float = 120.0):
        self.root = root
        self.id = str(worker_id)
        self.request_timeout_s = float(request_timeout_s)
        self._port: Optional[int] = None

    def health(self) -> Optional[Dict[str, Any]]:
        try:
            return ckpt.load_json(os.path.join(self.root, serving_state_filename(self.id)))
        except (FileNotFoundError, ValueError):
            return None

    def _resolve_port(self) -> int:
        # re-read on every miss: a restarted worker registers a new port
        # through the same state file
        h = self.health()
        if not h or not h.get("port"):
            raise EndpointDied(f"{self.id}: no registered port")
        self._port = int(h["port"])
        return self._port

    def _call(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        port = self._port or self._resolve_port()
        try:
            with socket.create_connection(("127.0.0.1", port),
                                          timeout=_CONNECT_TIMEOUT_S) as sk:
                sk.settimeout(self.request_timeout_s)
                sk.sendall((json.dumps(payload) + "\n").encode())
                buf = b""
                while not buf.endswith(b"\n"):
                    chunk = sk.recv(65536)
                    if not chunk:
                        raise EndpointDied(f"{self.id}: connection closed mid-request")
                    buf += chunk
        except OSError as err:  # socket.timeout is an OSError
            self._port = None   # a stale port: re-resolve next time
            raise EndpointDied(f"{self.id}: {err}") from err
        return json.loads(buf.decode())

    def ping(self) -> Dict[str, Any]:
        return self._call({"op": "ping"})

    def generate(self, prompt: np.ndarray, *, max_new_tokens: int,
                 deadline_s: Optional[float] = None) -> Dict[str, Any]:
        out = self._call({"op": "generate", "prompt": np.asarray(prompt).tolist(),
                          "max_new_tokens": int(max_new_tokens), "deadline_s": deadline_s})
        if not out.get("ok"):
            if out.get("rejected"):
                raise RequestRejected(out["rejected"], self.id)
            raise EndpointDied(f"{self.id}: {out.get('error')}")
        out["tokens"] = np.asarray(out["tokens"])
        return out


class WorkerPool:
    """Spawn and manage N serving-worker processes under one root.

    Every child serves on ``device`` (default the card).  ``env`` applies to
    every child and ``child_env`` maps a worker id to extra environment for
    that child alone (a test arms ``REPRO_CRASH_POINT`` on one member so it
    dies at an exact swap seam while its peers serve)."""

    def __init__(self, root: str, n_workers: int, *, arch: Optional[str] = None,
                 engine: str = "real", device: str = "cuda", max_len: int = 64,
                 poll: float = 0.02, batch: bool = False, queue_depth: int = 64,
                 max_batch: int = 8, batch_wait_s: float = 0.002,
                 family: Optional[str] = None, warm: Optional[tuple] = None,
                 env: Optional[Dict[str, str]] = None,
                 child_env: Optional[Dict[str, Dict[str, str]]] = None):
        if engine == "real" and not arch:
            raise ValueError("engine='real' needs an arch name")
        self.root = str(root)
        self.worker_ids = [f"w{i}" for i in range(int(n_workers))]
        self.arch, self.engine, self.device = arch, engine, str(device)
        self.max_len, self.poll = int(max_len), float(poll)
        self.batch = bool(batch)
        self.queue_depth, self.max_batch = int(queue_depth), int(max_batch)
        self.batch_wait_s = float(batch_wait_s)
        self.family = family
        # (prompt_len, max_new_tokens) each child runs across the batch
        # buckets before it registers, so its first clients do not pay for
        # the first calls
        self.warm = warm
        self.env = dict(env or {})
        self.child_env = dict(child_env or {})
        self._procs: Dict[str, subprocess.Popen] = {}
        self._logs: Dict[str, Any] = {}
        self.endpoints: List[SocketEndpoint] = []

    def _spawn(self, wid: str) -> subprocess.Popen:
        import repro_torch
        src = os.path.dirname(os.path.dirname(os.path.abspath(repro_torch.__file__)))
        env = dict(os.environ)
        env["PYTHONPATH"] = src + (os.pathsep + env["PYTHONPATH"]
                                   if env.get("PYTHONPATH") else "")
        env.update(self.env)
        env.update(self.child_env.get(wid, {}))
        cmd = [sys.executable, "-m", "repro_torch.serve.worker_pool",
               "--root", self.root, "--worker-id", wid, "--engine", self.engine,
               "--device", self.device, "--max-len", str(self.max_len),
               "--poll", str(self.poll), "--queue-depth", str(self.queue_depth),
               "--max-batch", str(self.max_batch), "--batch-wait", str(self.batch_wait_s)]
        if self.arch:
            cmd += ["--arch", self.arch]
        if self.warm:
            cmd += ["--warm", f"{self.warm[0]},{self.warm[1]}"]
        if self.batch:
            cmd += ["--batch"]
        if self.family:
            cmd += ["--family", self.family]
        log = open(os.path.join(self.root, f"worker-{wid}.log"), "ab")
        self._logs[wid] = log
        return subprocess.Popen(cmd, env=env, stdout=log, stderr=subprocess.STDOUT)

    def start(self, *, timeout: float = 60.0) -> "WorkerPool":
        """Spawn every child and wait until each registered its port."""
        for wid in self.worker_ids:
            self._procs[wid] = self._spawn(wid)
        self.endpoints = [SocketEndpoint(self.root, wid) for wid in self.worker_ids]
        deadline = time.monotonic() + timeout
        for ep in self.endpoints:
            while True:
                h = ep.health()
                if h and h.get("port"):
                    break
                proc = self._procs[ep.id]
                if proc.poll() is not None:
                    raise RuntimeError(f"pool child {ep.id} exited with {proc.returncode} "
                                       f"before registering (see worker-{ep.id}.log)")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"pool child {ep.id} never registered a port")
                time.sleep(0.02)
        return self

    def wait_ready(self, *, iteration: Optional[int] = None, timeout: float = 60.0) -> None:
        """Block until every live worker adopted a base (``iteration``, if
        given).  Workers that already died are skipped: surviving them is
        the router's job."""
        deadline = time.monotonic() + timeout
        for ep in self.endpoints:
            while True:
                proc = self._procs.get(ep.id)
                if proc is not None and proc.poll() is not None:
                    break
                h = ep.health()
                it = None if h is None else h.get("iteration")
                if it is not None and (iteration is None or it == iteration):
                    break
                if time.monotonic() > deadline:
                    raise TimeoutError(f"worker {ep.id} never adopted "
                                       f"{'a base' if iteration is None else iteration}")
                time.sleep(0.02)

    def router(self, **kw) -> Router:
        return Router(self.endpoints, **kw)

    def kill(self, wid: str) -> None:
        """``kill -9`` one member (the fault the router must survive)."""
        self._procs[wid].kill()
        self._procs[wid].wait()

    def alive(self) -> List[str]:
        return [wid for wid, p in self._procs.items() if p.poll() is None]

    def stop(self, *, timeout: float = 30.0) -> Dict[str, int]:
        """SIGTERM every live child (it persists a final state) and reap;
        returns the exit codes."""
        codes: Dict[str, int] = {}
        for proc in self._procs.values():
            if proc.poll() is None:
                proc.terminate()
        for wid, proc in self._procs.items():
            try:
                codes[wid] = proc.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                proc.kill()
                codes[wid] = proc.wait()
        for log in self._logs.values():
            log.close()
        self._logs.clear()
        return codes

    def states(self) -> Dict[str, Optional[Dict[str, Any]]]:
        return {ep.id: ep.health() for ep in self.endpoints}


# ---------------------------------------------------------------------------
# child entry point
# ---------------------------------------------------------------------------


class _ValueEngine:
    """Closed-form fake engine: the tokens are the served tree's scalar
    ``w``, for any batch shape, so the scheduler path runs too."""

    def __init__(self, cfg, params, max_len):
        self.params = params

    def generate(self, prompts, *, max_new_tokens=16, params=None):
        p = self.params if params is None else params
        val = float(p["w"].reshape(-1)[0])
        toks = np.full((prompts.shape[0], prompts.shape[1] + max_new_tokens), val, np.float32)
        return types.SimpleNamespace(tokens=toks, prompt_len=int(prompts.shape[1]),
                                     steps=int(max_new_tokens))


def _child_main(argv=None) -> int:
    p = argparse.ArgumentParser(description="serving-pool worker process (PyTorch port)")
    p.add_argument("--root", required=True)
    p.add_argument("--worker-id", required=True)
    p.add_argument("--arch", default=None)
    p.add_argument("--engine", choices=("real", "value"), default="real")
    p.add_argument("--device", default="cuda", help="where the worker serves (cuda, cpu)")
    p.add_argument("--family", default=None)
    p.add_argument("--max-len", type=int, default=64)
    p.add_argument("--poll", type=float, default=0.02)
    p.add_argument("--batch", action="store_true")
    p.add_argument("--queue-depth", type=int, default=64)
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--batch-wait", type=float, default=0.002)
    p.add_argument("--warm", default=None, metavar="T,N",
                   help="run generate for prompt_len T / max_new N across the batch buckets "
                        "before serving (the first adoption blocks until then)")
    args = p.parse_args(argv)

    from repro_torch.serve.hot_swap import ServingWorker
    if args.engine == "value":
        cfg, factory = None, _ValueEngine
    else:
        from repro_torch.configs import get_config, reduce_config
        cfg, factory = reduce_config(get_config(args.arch)), None
    worker = ServingWorker(
        cfg, args.root, family=args.family, device=args.device, max_len=args.max_len,
        name=args.worker_id, worker_id=args.worker_id, engine_factory=factory,
        batch_requests=args.batch, queue_depth=args.queue_depth, max_batch=args.max_batch,
        batch_wait_s=args.batch_wait)

    if args.warm:
        # adopt the first published base and run the bucketed generate
        # shapes now; the parent's start() waits on the port, registered
        # after this
        from repro_torch.serve.scheduler import BATCH_BUCKETS
        warm_t, warm_n = (int(x) for x in args.warm.split(","))
        deadline = time.monotonic() + 120.0
        while worker.current_iteration is None:
            if worker.poll_once():
                break
            if time.monotonic() > deadline:
                break   # nothing published yet: serve cold
            time.sleep(0.05)
        if worker._engine is not None:
            dummy = np.full((1, warm_t), 2, np.int64)
            shapes = [b for b in BATCH_BUCKETS if b <= args.max_batch] if args.batch else [1]
            for b in shapes:
                worker._engine.generate(np.repeat(dummy, b, axis=0), max_new_tokens=warm_n)

    class Handler(socketserver.StreamRequestHandler):
        def handle(self):
            for line in self.rfile:
                try:
                    out = self._dispatch(json.loads(line.decode()))
                except Exception as err:  # noqa: BLE001 - report, don't die
                    out = {"ok": False, "error": f"{type(err).__name__}: {err}"}
                self.wfile.write((json.dumps(out) + "\n").encode())
                self.wfile.flush()

        def _dispatch(self, req):
            if req.get("op") == "ping":
                return {"ok": True, "iteration": worker.current_iteration}
            if req.get("op") != "generate":
                return {"ok": False, "error": f"unknown op {req.get('op')}"}
            prompt = np.asarray(req["prompt"])[None, :]
            try:
                res = worker.generate(prompt, max_new_tokens=int(req["max_new_tokens"]),
                                      deadline_s=req.get("deadline_s"))
            except RequestRejected as err:
                return {"ok": False, "rejected": err.reason}
            return {"ok": True, "tokens": np.asarray(res.tokens)[0].tolist(),
                    "iteration": res.iteration, "steps": res.steps,
                    "batch_size": res.batch_size, "latency_s": res.latency_s}

    class Server(socketserver.ThreadingTCPServer):
        daemon_threads = True
        allow_reuse_address = True

    srv = Server(("127.0.0.1", 0), Handler)
    port = srv.server_address[1]
    worker.extra_state["port"] = port
    worker.extra_state["worker_id"] = args.worker_id
    # register the port before the watch thread starts: the parent blocks
    # on this state file
    worker._persist_state()
    worker.start(interval=args.poll)

    def _term(signum, frame):
        threading.Thread(target=srv.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _term)
    signal.signal(signal.SIGINT, _term)
    print(f"[pool-worker] {args.worker_id} serving on 127.0.0.1:{port} (engine={args.engine}, "
          f"device={worker.device}, batch={args.batch})", flush=True)
    try:
        srv.serve_forever(poll_interval=0.1)
    finally:
        srv.server_close()
        st = worker.stop()
        print(f"[pool-worker] {args.worker_id} stopped at iteration {st['iteration']}: "
              f"{st['requests_total']} requests, {st['swaps_total']} swaps", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(_child_main())
