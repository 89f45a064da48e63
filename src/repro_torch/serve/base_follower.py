"""BaseFollower: follow a repository's published base with atomic hot-swaps
(port of ``repro.serve.base_follower``).

* **two watch modes, one swap path** — in-process (``repo=``) the follower
  subscribes through ``Repository.add_publish_listener`` and receives the
  ``(iteration, base, flat)`` snapshot the publisher announces after its
  iteration bump, and adopts that tree by reference (views into the
  published flat row, no copy); cross-process (``root``) it polls
  ``repository.json``, which is written atomically after the base npz it
  names, and loads ``base_iterNNNN.npz`` onto the follower's device.
  ``family=`` resolves a named family member's root, a whole repository
  layout, and the rest is unchanged.
* **double-buffered residency** — the next base is materialised and made
  resident (``_make_resident``: the card of its CUDA leaves synchronised, so
  the daemon's fuse kernel and the load's copies have finished) while
  readers keep using the current version; only then does the pointer flip,
  one Python reference assignment.
* **version-pinned handles** — ``current()`` returns the ``BaseVersion`` the
  pointer names now; a consumer that captures it works against those exact
  weights across any number of forward or backward (rollback) swaps.  A
  publish installs a fresh row and never writes into the old one, so a
  pinned tree stays valid for as long as it is held.

Crash discipline: the swap path carries the three ``utils.faults`` seams
``worker.pre_transfer``, ``worker.post_transfer_pre_flip`` and
``worker.post_flip``.  The follower holds no durable state the repository
does not own, so a crashed follower can only re-adopt a published base.

Hooks (all optional): ``on_swap_begin(target_iteration)`` on entering a live
swap (the worker marks itself ``swapping`` so a router drains it);
``on_resident(version)`` once the new tree is resident, before the flip (the
worker builds its engine there); ``on_swap(record, version, prev)`` after
the flip (the worker persists its state and appends the swap record).
"""
from __future__ import annotations

import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

import torch

from repro_torch.checkpoint import io as ckpt
from repro_torch.core.repository import family_member_root
from repro_torch.utils import faults
from repro_torch.utils.device import resolve_device
from repro_torch.utils.pytree import tree_leaves


def _make_resident(tree) -> None:
    """The residency barrier (module level, so tests can spy on it running
    before the flip): synchronise every card the tree's CUDA leaves live on.
    On the CPU there is nothing to wait for."""
    for dev in {x.device for x in tree_leaves(tree)
                if isinstance(x, torch.Tensor) and x.is_cuda}:
        torch.cuda.synchronize(dev)


class BaseVersion:
    """One published base resident on the device: what the pointer flips
    between and what a request pins at ``generate`` entry."""

    __slots__ = ("iteration", "params")

    def __init__(self, iteration: int, params: Any):
        self.iteration = int(iteration)
        self.params = params


def _default_loader(root: str, iteration: int, device):
    """Cross-process materialisation: the published npz (durable before
    ``repository.json`` named it) loaded onto ``device``."""
    return ckpt.load(os.path.join(root, f"base_iter{iteration:04d}.npz"), device=device)


class BaseFollower:
    """Follow a repository's published base with atomic hot-swaps.

    ``poll_once()`` looks for a *different* published iteration (a rollback
    moves the pointer backwards: the target test is ``!=``, never ``>``) and
    swaps onto it.  ``loader(root, iteration)`` overrides cross-process
    materialisation (tests pass cheap fakes).  ``device`` is where a
    cross-process follower loads each base (default the card; raises
    without one); an in-process follower serves the repository's own
    tensors, so ``device`` must be None or the repository's device type.
    """

    def __init__(self, root: Optional[str] = None, *, repo=None,
                 family: Optional[str] = None, device=None,
                 loader: Optional[Callable[[str, int], Any]] = None,
                 on_swap_begin: Optional[Callable[[int], None]] = None,
                 on_resident: Optional[Callable[[BaseVersion], None]] = None,
                 on_swap: Optional[Callable[..., None]] = None,
                 name: str = "follower"):
        if root is None and repo is None:
            raise ValueError("BaseFollower needs a repository root, an attached Repository, "
                             "or both")
        if family is not None and repo is not None:
            raise ValueError(
                "family= selects a member under a family root in cross-process watch mode; "
                "when attaching in-process, pass that member's Repository directly as repo=")
        if repo is not None:
            if device is not None and torch.device(device).type != repo.device.type:
                raise ValueError(f"an in-process follower serves the repository's tensors on "
                                 f"{repo.device}; got device={device!r}")
            self.device = repo.device
        else:
            self.device = resolve_device("cuda" if device is None else device)
        self.family = None if family is None else str(family)
        if self.family is not None:
            root = family_member_root(root, self.family)
        self.root = root if root is not None else repo.root
        self.name = str(name)
        self._loader = loader or (lambda r, it: _default_loader(r, it, self.device))
        self._on_swap_begin = on_swap_begin
        self._on_resident = on_resident
        self._on_swap = on_swap
        self._current: Optional[BaseVersion] = None
        self._announce: Optional[Tuple[int, Any, Any]] = None
        self._repo = None
        self._swap_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self.swapping = False          # inside a live swap (the drain signal)
        self.swaps_total = 0           # pointer flips, initial adoption included
        self.live_swaps = 0            # flips while already serving a base
        self.versions_served: Set[int] = set()
        self.last_swap_latency_s: Optional[float] = None
        self.last_swap: Optional[Dict[str, Any]] = None
        self._swap_log: List[int] = []  # flip order
        self._thread: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()
        self.watch_error: Optional[str] = None
        if repo is not None:
            self.attach(repo)

    # -- watch sources --------------------------------------------------
    def attach(self, repo) -> None:
        """Subscribe to an in-process Repository's publishes, and take a
        snapshot of what it serves now."""
        self._repo = repo
        repo.add_publish_listener(self._on_publish)
        self._announce = (repo.iteration, repo._base, repo._base_flat)

    def _on_publish(self, iteration: int, base, flat) -> None:
        # the publisher's thread only stores (one tuple assignment); the
        # follower's thread does the barrier and the flip
        self._announce = (iteration, base, flat)

    def _target(self) -> Optional[Tuple[int, Any]]:
        """The published version to swap to, or None when current."""
        cur = self._current
        if self._repo is not None:
            ann = self._announce
            if ann is None:
                return None
            it, base, _flat = ann
            if cur is not None and cur.iteration == int(it):
                return None
            return int(it), base
        try:
            meta = ckpt.load_json(os.path.join(self.root, "repository.json"))
        except FileNotFoundError:
            return None
        it = int(meta["iteration"])
        if cur is not None and cur.iteration == it:
            return None
        return it, None

    # -- the swap -------------------------------------------------------
    def poll_once(self) -> bool:
        """Swap onto a different published base if there is one.  Returns
        True when a swap happened."""
        with self._swap_lock:
            target = self._target()
            if target is None:
                return False
            self._swap_to(*target)
            return True

    def _swap_to(self, iteration: int, base) -> None:
        t0 = time.perf_counter()
        live = self._current is not None
        try:
            if live:
                # a live swap is drainable; the initial adoption skips the
                # hook (nothing to drain, and a begin-persist would overwrite
                # a crashed worker's state with an empty one)
                self.swapping = True
                if self._on_swap_begin is not None:
                    self._on_swap_begin(iteration)
            faults.crash_point("worker.pre_transfer")
            if base is None:
                base = self._loader(self.root, iteration)
            # in-flight readers keep decoding against the current version
            # until the new tree is resident
            _make_resident(base)
            version = BaseVersion(iteration, base)
            if self._on_resident is not None:
                self._on_resident(version)
            faults.crash_point("worker.post_transfer_pre_flip")
            prev = self._current
            self._current = version   # the atomic flip
        finally:
            self.swapping = False
        faults.crash_point("worker.post_flip")
        dt = time.perf_counter() - t0
        with self._stats_lock:
            self.swaps_total += 1
            if prev is not None:
                self.live_swaps += 1
            self.versions_served.add(iteration)
            self.last_swap_latency_s = dt
            self.last_swap = {
                "from_iteration": None if prev is None else prev.iteration,
                "to_iteration": iteration,
                "swap_latency_s": dt,
            }
            self._swap_log.append(iteration)
        if self._on_swap is not None:
            self._on_swap(dict(self.last_swap), version, prev)

    # -- handles --------------------------------------------------------
    def current(self) -> Optional[BaseVersion]:
        """The version-pinned handle: capture once, decode every step
        against it."""
        return self._current

    @property
    def current_iteration(self) -> Optional[int]:
        cur = self._current
        return None if cur is None else cur.iteration

    def swap_stats(self) -> Dict[str, Any]:
        """The follower's part of the serving state."""
        with self._stats_lock:
            return {
                "iteration": self.current_iteration,
                "swapping": self.swapping,
                "swaps_total": self.swaps_total,
                "live_swaps": self.live_swaps,
                "versions_served": sorted(self.versions_served),
                "last_swap": None if self.last_swap is None else dict(self.last_swap),
                "last_swap_latency_s": self.last_swap_latency_s,
                "watch_error": self.watch_error,
            }

    # -- watch thread ---------------------------------------------------
    def start(self, *, interval: float = 0.05,
              on_tick: Optional[Callable[[], None]] = None) -> None:
        """Run the watch loop on a daemon thread until ``stop``.  A swap
        error is recorded in ``watch_error`` and the current version keeps
        serving.  ``on_tick`` runs after each poll (the worker's state
        heartbeat)."""
        if self._thread is not None:
            raise RuntimeError("follower already started")
        self._stop_evt.clear()

        def loop():
            while not self._stop_evt.is_set():
                try:
                    self.poll_once()
                except Exception as err:  # noqa: BLE001 - keep serving
                    self.watch_error = f"{type(err).__name__}: {err}"
                if on_tick is not None:
                    try:
                        on_tick()
                    except Exception as err:  # noqa: BLE001
                        self.watch_error = f"{type(err).__name__}: {err}"
                self._stop_evt.wait(interval)

        self._thread = threading.Thread(target=loop, name=f"follow-{self.name}", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        if self._thread is not None:
            self._stop_evt.set()
            self._thread.join(timeout=30.0)
            self._thread = None
