"""The contributor service loop: a queue-driven fusion daemon (port of the
single-base part of ``repro.serve.cold_service``).

* **ContributorClient** — submits finetuned models as atomically written
  flat rows (dense, or delta-compressed with ``compress=True``) into the
  durable on-disk contribution queue ``<root>/queue/``, and polls the
  published iteration through the status file.  The queue directory is the
  only surface contributors and the daemon share.
* **ColdService** — the polling daemon that owns the Repository: it admits
  queue arrivals under an ``AdmissionPolicy`` (rider, staleness,
  compressed-vintage, checksum and novelty screens at the queue boundary),
  stages them by reference (``Repository.ingest_spilled``), dispatches
  ``fuse_pending(wait=False)`` so the card fuses while the queue drains,
  garbage-collects consumed submissions and publishes a status file and a
  ``metrics.jsonl`` series.

Exactly once across crashes, as in the reference: a submission exists only
once its npz lands by ``os.replace``; a row enters the staging manifest
before the queue manifest marks it admitted (a crash between the two is
healed by re-marking); the Repository's ``staged_at``/``fusing`` marks decide
whether a dispatched cohort was published; a consumed file is deleted
before its queue entry is dropped.  The ``faults.crash_point`` seams carry
the reference's names.  Every file (queue npz, queue manifest, status,
metrics) is the reference's format, so either package's daemon can drain a
queue the other's clients wrote.

The forgetting regression gate: with ``gate=`` (a
``repro_torch.serve.probes.RegressionGate``) every fuse runs synchronously
and each publish is probed against the durable baseline of the last
known-good base (``gate_state.json``).  A clean publish moves the baseline;
a tripped gate moves the consumed cohort's queue files into
``<root>/quarantine/`` (counted, never re-fused) and rolls the repository
back to the baseline iteration, the next cohort's staged rows kept.
Quarantine strictly precedes the rollback, so a daemon killed anywhere in
probe → quarantine → rollback replays the verdict on restart.
``AdmissionPolicy(compact_keep_bases=M)`` compacts the root after each
publish while no fuse is in flight (at least 2 under a gate, so the
baseline's base stays on disk).

Similarity routing: with ``family=`` (a ``RepositoryFamily``) every fresh
submission is scored against each member's base sketch and windowed delta
evidence (``utils.flat.FamilyRouter``), moved atomically into its member's
queue namespace (``<root>/families/<name>/queue/``; the move is the durable
decision) and fused there.  A submission near no member spawns one (up to
``AdmissionPolicy.max_bases``; at the cap it routes to the nearest), a
compressed one is rejected as stale unless it routes to the member it
declared, and every ``cross_fuse_every`` member publishes a quiescent family
is cross-fused toward its mean.  Each member is a ``_Lane`` with its own
cohort clock, gate baseline, quarantine verdicts and compaction; the
single-base service is exactly one ``main`` lane.

Serving state: a hot-swap worker (``serve/hot_swap.ServingWorker``) owns its
own state file, ``serving_state.json`` when solo or ``serving_state-<id>.json``
as a pool member, and ``status()["serving"]`` embeds them read-only (one
file passes through, several become an aggregate).
"""
from __future__ import annotations

import math
import os
import random
import time
import warnings
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.checkpoint import io as ckpt
from repro_torch.core.repository import Repository, RepositoryFamily, family_member_root
from repro_torch.serve.probes import ProbeReport, RegressionGate
from repro_torch.utils import faults
from repro_torch.utils.device import resolve_device
from repro_torch.utils.flat import (LANE, FamilyRouter, FlatSpec, ShardedFlatSpec,
                                    delta_checksum, delta_encode, delta_encode_sharded,
                                    row_checksum, row_sketch_host)

QUEUE_DIR = "queue"
QUEUE_MANIFEST = "queue_manifest.json"
STATUS_FILE = "service_status.json"
QUARANTINE_DIR = "quarantine"
GATE_STATE_FILE = "gate_state.json"
METRICS_FILE = "metrics.jsonl"
# the daemon rotates the active metrics file to metrics.jsonl.1 at this size
METRICS_ROTATE_BYTES = 4 * 1024 * 1024
# owned by the ServingWorker, not the daemon: two processes rewriting one
# file would clobber each other, so each worker persists its own and
# status() embeds them read-only
SERVING_STATE_FILE = "serving_state.json"
ERROR_RING = 16  # recent_errors entries kept (and persisted)
ROUTE_RING = 64  # recent routing decisions in the status endpoint


def serving_state_filename(worker_id: Optional[str] = None) -> str:
    """The serving-state file of one worker: ``serving_state.json`` for the
    solo worker, ``serving_state-<id>.json`` for a pool member, so N workers
    under one root never clobber each other."""
    if worker_id is None:
        return SERVING_STATE_FILE
    wid = str(worker_id)
    if not wid or any(c in wid for c in "/\\."):
        raise ValueError(f"invalid worker_id for state file: {worker_id!r}")
    return f"serving_state-{wid}.json"


def _queue_dir(root: str) -> str:
    return os.path.join(root, QUEUE_DIR)


# ---------------------------------------------------------------------------
# contributor side
# ---------------------------------------------------------------------------


class ContributorClient:
    """A contributor's handle on the service: submit rows, poll the base.
    ``name`` must be unique among running contributors: the submission file
    is ``<name>-<seq>.npz``, which makes a retry of the same ``seq``
    replace the same file instead of enqueueing twice."""

    def __init__(self, root: str, name: Optional[str] = None):
        self.root = root
        self.name = name if name is not None else f"c{os.getpid()}"
        self._seq = 0
        self._spec: Optional[FlatSpec] = None

    def submit(self, params=None, *, row=None, spec: Optional[FlatSpec] = None,
               sspec: Optional[ShardedFlatSpec] = None, weight: Optional[float] = None,
               base_iteration: Optional[int] = None, seq: Optional[int] = None,
               checksum: bool = False, sketch: Optional[bool] = None,
               compress: bool = False, base=None, family: Optional[str] = None,
               k_per_block: int = 64, codec_block: int = LANE) -> str:
        """Enqueue one contribution; returns its submission id once it is
        durably in the queue.

        Pass a ``params`` tree (flattened here, on its device) or a flat
        ``row`` with its ``spec``.  With ``sspec`` the row is written as its
        per-shard block-cyclic slices (``save_flat_shards``), the layout a
        mesh repository stages shard by shard.  ``base_iteration`` is the
        iteration of the base it was finetuned from (the staleness screen).
        ``checksum=True`` stamps a CRC (of the row, or of the encoded
        payload bytes when compressed).  ``sketch`` stamps the row's content
        sketch into the rider (default: iff the service's status says the
        novelty screen is armed, or no status exists yet).
        ``compress=True`` enqueues ``row − base`` as per-block top-
        ``k_per_block`` int8 values with f32 scales (``delta_encode``, per
        shard under ``sspec``); it needs ``base`` (the pulled base tree or
        row) and
        ``base_iteration``, since the service admits a delta only against
        its exact declared vintage."""
        if row is None:
            if params is None:
                raise ValueError("submit needs params= or row=")
            spec = spec or self._spec or FlatSpec.from_tree(params)
            row = spec.flatten(params)
        elif spec is None:
            raise ValueError("row= requires spec=")
        self._spec = spec
        if seq is None:
            seq = self._seq
        self._seq = max(self._seq, seq) + 1
        sub_id = f"{self.name}-{seq:06d}"
        path = os.path.join(_queue_dir(self.root), sub_id + ".npz")
        os.makedirs(_queue_dir(self.root), exist_ok=True)
        host_row = row.detach().cpu() if hasattr(row, "detach") else np.asarray(row)
        payload = None
        if compress:
            if base is None:
                raise ValueError("compress=True needs base= — the pulled base this "
                                 "contribution was finetuned from")
            if base_iteration is None:
                raise ValueError("compress=True needs base_iteration= — the service admits "
                                 "a compressed delta only against its declared base vintage")
            base_row = base if getattr(base, "ndim", None) == 1 else spec.flatten(base)
            if sspec is not None:
                payload = delta_encode_sharded(host_row, base_row, sspec,
                                               k_per_block=k_per_block, block=codec_block)
            else:
                payload = delta_encode(host_row, base_row, k_per_block=k_per_block,
                                       block=codec_block)
        extra = {
            "id": sub_id,
            "contributor": self.name,
            "weight": None if weight is None else float(weight),
            "base_iteration": base_iteration,
            "submitted_at": time.time(),
        }
        if family is not None:
            extra["family"] = str(family)
        if compress:
            extra["codec"] = {"k_per_block": int(k_per_block), "block": int(codec_block)}
        if sketch is None:
            st = self.status()
            sketch = st is None or bool(st.get("novelty_screen")) or bool(st.get("routing"))
        if sketch:
            extra["sketch"] = row_sketch_host(host_row).tolist()
        if checksum:
            extra["checksum"] = delta_checksum(payload) if compress else row_checksum(host_row)
        # nothing durable yet: a death here enqueues nothing
        faults.crash_point("client.mid_submit")
        if compress:
            ckpt.save_flat_delta(path, payload, spec, sspec=sspec, extra=extra)
        elif sspec is not None:
            ckpt.save_flat_shards(path, sspec.shard_slices(host_row), spec, sspec,
                                  extra=extra)
        else:
            ckpt.save_flat(path, host_row, spec, extra=extra)
        return sub_id

    def status(self) -> Optional[Dict[str, Any]]:
        """The service's last published status, or None before the first
        cycle (never torn: the file is written atomically)."""
        try:
            return ckpt.load_json(os.path.join(self.root, STATUS_FILE))
        except FileNotFoundError:
            return None

    def iteration(self) -> int:
        """The latest published base iteration (0 before any fuse)."""
        st = self.status()
        if st is not None:
            return int(st["iteration"])
        try:
            return int(ckpt.load_json(os.path.join(self.root, "repository.json"))["iteration"])
        except FileNotFoundError:
            return 0

    def wait_for_iteration(self, target: int, *, timeout: float = 60.0,
                           interval: float = 0.02, max_interval: float = 1.0) -> Dict[str, Any]:
        """Bounded poll until the published iteration reaches ``target``
        (exponential backoff with full jitter, capped at ``max_interval``);
        raises TimeoutError at the deadline."""
        deadline = time.monotonic() + timeout
        delay = interval
        while True:
            st = self.status()
            if st is not None and int(st["iteration"]) >= target:
                return st
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError(f"iteration {target} not published within {timeout}s "
                                   f"(last status: {st})")
            time.sleep(min(remaining, random.uniform(delay / 2, delay)))
            delay = min(delay * 2, max_interval)

    def download_base(self, family: Optional[str] = None, device="cuda"):
        """Pull the latest published base tree (Fig. 1, step 1) of the named
        family member (the main base by default) onto ``device`` (the card
        unless the caller asks for the CPU).  The base npz is durable before
        repository.json names it, so the load never races a publish into a
        missing file."""
        device = resolve_device(device)
        root = self.root if family is None else family_member_root(self.root, family)
        meta = ckpt.load_json(os.path.join(root, "repository.json"))
        it = int(meta["iteration"])
        return ckpt.load(os.path.join(root, f"base_iter{it:04d}.npz"), device=device)

    def family_iteration(self, family: str) -> int:
        """The named member's published iteration (0 before any fuse, and
        0 while the member does not exist yet: a member is born at 0)."""
        fams = (self.status() or {}).get("families") or {}
        if family in fams:
            return int(fams[family]["iteration"])
        try:
            meta = ckpt.load_json(os.path.join(family_member_root(self.root, family),
                                               "repository.json"))
            return int(meta["iteration"])
        except FileNotFoundError:
            return 0

    def wait_for_family(self, family: str, target: int, *, timeout: float = 60.0,
                        interval: float = 0.02, max_interval: float = 1.0) -> Dict[str, Any]:
        """Bounded poll until the named member's published iteration reaches
        ``target``, with ``wait_for_iteration``'s jittered backoff."""
        deadline = time.monotonic() + timeout
        delay = interval
        while True:
            st = self.status()
            if self.family_iteration(family) >= target:
                return st or {}
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError(f"family {family!r} iteration {target} not published "
                                   f"within {timeout}s (last status: {st})")
            time.sleep(min(remaining, random.uniform(delay / 2, delay)))
            delay = min(delay * 2, max_interval)

    def route_of(self, sub_id: str) -> Optional[Dict[str, Any]]:
        """The routing record of one submission from the status endpoint's
        routes ring (None before it is routed or once it aged out)."""
        for rec in (self.status() or {}).get("routes") or []:
            if rec.get("id") == sub_id:
                return rec
        return None


# ---------------------------------------------------------------------------
# service side
# ---------------------------------------------------------------------------


@dataclass
class AdmissionPolicy:
    """Cohort formation and screening at the queue boundary (the reference's
    fields).

    * ``min_cohort`` — dispatch once this many rows are staged;
    * ``max_wait_s`` — ...or once the oldest staged row waited this long;
    * ``max_cohort`` — stage at most this many rows per cohort;
    * ``max_staleness`` — reject a dense row whose ``base_iteration`` lags
      by more (compressed rows are pinned to the exact current vintage);
    * ``verify_checksums`` — re-read each row and verify its CRC;
    * ``novelty_threshold`` — reject a row whose sketch lies within this
      relative distance of one of the last ``sketch_window`` admissions
      (None disables the screen);
    * ``compact_keep_bases`` — compact the root after each publish, keeping
      this many bases (None: never);
    * ``max_bases``, ``split_threshold``, ``cross_fuse_every`` — the
      router's knobs, live only over a ``RepositoryFamily``: a submission
      further than ``split_threshold`` from every member spawns one (up to
      ``max_bases``), and every ``cross_fuse_every`` member publishes the
      family cross-fuses toward its mean (0: never)."""

    min_cohort: int = 1
    max_wait_s: float = 0.0
    max_cohort: int = 64
    max_staleness: Optional[int] = None
    verify_checksums: bool = False
    novelty_threshold: Optional[float] = None
    sketch_window: int = 32
    compact_keep_bases: Optional[int] = None
    max_bases: int = 1
    split_threshold: float = 0.8
    cross_fuse_every: int = 0


@dataclass
class _Lane:
    """One family member's service state: its Repository, queue namespace,
    cohort clock and gate baseline.  A single-base service is exactly one
    ``main`` lane, so the lane machinery is the single-base path itself."""

    name: str
    repo: Repository
    queue_dir: str
    gate_path: str
    cohort_since: Optional[float] = None
    # the size of a cohort whose fuse just failed (not retried until new
    # rows arrive)
    failed_cohort_size: Optional[int] = None
    gate_baseline: Optional[Dict[str, float]] = None
    gate_iteration: Optional[int] = None
    last_gate: Optional[Dict[str, Any]] = None


class ColdService:
    """The polling fusion daemon over a spill-enabled Repository (``repo=``,
    one ``main`` lane) or a ``RepositoryFamily`` (``family=``, one lane per
    member, similarity routing armed).  Single owner: one service per root.
    ``gate=`` arms the forgetting regression gate, per member."""

    def __init__(self, repo: Optional[Repository] = None, *,
                 family: Optional[RepositoryFamily] = None,
                 policy: Optional[AdmissionPolicy] = None,
                 gate: Optional[RegressionGate] = None):
        if (repo is None) == (family is None):
            raise ValueError("ColdService takes exactly one of repo= (single base) or family= "
                             "(similarity-routed RepositoryFamily)")
        if family is not None:
            # spawned members inherit the queue-ingest spill contract
            family.member_kw.setdefault("spill", True)
            repo = family.members["main"]
        if not repo.root:
            raise ValueError("ColdService requires an on-disk repository")
        self.repo = repo
        self.family = family
        self._routing = family is not None
        self.policy = policy or AdmissionPolicy()
        p = self.policy
        self.gate = gate
        self.queue_dir = _queue_dir(repo.root)
        self.quarantine_dir = os.path.join(repo.root, QUARANTINE_DIR)
        self._router = (FamilyRouter(split_threshold=p.split_threshold, max_bases=p.max_bases)
                        if self._routing else None)
        members = family.members if family is not None else {"main": repo}
        self._lanes: Dict[str, _Lane] = {name: self._make_lane(name, member)
                                         for name, member in members.items()}
        self._main = self._lanes["main"]
        self._qman_path = os.path.join(self.queue_dir, QUEUE_MANIFEST)
        self._status_path = os.path.join(repo.root, STATUS_FILE)
        self._metrics_path = os.path.join(repo.root, METRICS_FILE)
        self._entries: Dict[str, Dict[str, Any]] = {}
        self._rejects: List[Dict[str, str]] = []
        self._fused_ids = 0          # queue submissions retired as fused
        self._rejected = 0
        self._novelty_rejected = 0   # subset of _rejected: near-duplicates
        self._quarantined = 0        # queue submissions banished by the gate
        self._rollbacks = 0          # gate trips that backed out a publish
        self._spawned = 0            # family members minted by the router
        self._cross_fuses = 0        # cross-fuse rounds taken
        self._cross_counter = 0      # member publishes since the last one
        self._routes: List[Dict[str, Any]] = []
        self._last_pub = "main"      # lane of the most recent publish
        self._recent_errors: List[Dict[str, Any]] = []
        self._last_error: Optional[str] = None
        self._last_gate: Optional[Dict[str, Any]] = None
        self._cycle = 0
        self._metrics_mark: Optional[tuple] = None
        self._stop = False
        torn = ckpt.repair_jsonl_tail(self._metrics_path)
        if torn:
            warnings.warn(f"metrics.jsonl: truncated a torn {torn}-byte tail left by a "
                          "crashed daemon")
        if gate is not None and p.compact_keep_bases is not None and p.compact_keep_bases < 2:
            warnings.warn("regression gate needs the baseline base retained on disk — "
                          "raising compact_keep_bases to 2")
            p.compact_keep_bases = 2
        self._load_queue_manifest()
        if gate is not None:
            # before _recover(): a publish whose verdict a crash swallowed is
            # replayed first, or _recover would retire (as fused) the very
            # cohort the replayed verdict must quarantine
            for lane in list(self._lanes.values()):
                self._init_gate(lane)
        self._recover()
        if p.novelty_threshold is not None or self._routing:
            # adopt (or create) each persisted window before the first
            # admission; the router needs every member's sketch even with
            # the novelty screen off (base sketches and deltas are its
            # evidence)
            for lane in self._lanes.values():
                lane.repo.enable_cohort_sketch(window=p.sketch_window)
        # contributors read the policy (whether to stamp sketches) from here
        ckpt.save_json_atomic(self._status_path, self.status())
        for lane in self._lanes.values():
            if lane.repo.n_staged:
                # recovered rows start the cohort clock too
                lane.cohort_since = time.time()

    def _make_lane(self, name: str, member: Repository) -> _Lane:
        if not member.root:
            raise ValueError("ColdService requires an on-disk repository")
        if not member.spill:
            raise ValueError("ColdService requires Repository(spill=True) — queue ingest "
                             f"rides the crash-recoverable staging manifest (member {name!r})")
        lane = _Lane(name=name, repo=member, queue_dir=os.path.join(member.root, QUEUE_DIR),
                     gate_path=os.path.join(member.root, GATE_STATE_FILE))
        os.makedirs(lane.queue_dir, exist_ok=True)
        return lane

    # -- queue manifest -------------------------------------------------
    def _load_queue_manifest(self) -> None:
        try:
            data = ckpt.load_json(self._qman_path)
        except FileNotFoundError:
            return
        self._entries = {e["id"]: e for e in data.get("entries", [])}
        self._fused_ids = int(data.get("fused_total", 0))
        self._rejected = int(data.get("rejected_total", 0))
        self._novelty_rejected = int(data.get("novelty_rejected_total", 0))
        self._quarantined = int(data.get("quarantined_total", 0))
        self._rollbacks = int(data.get("rollbacks_total", 0))
        self._spawned = int(data.get("families_spawned_total", 0))
        self._cross_fuses = int(data.get("cross_fuses_total", 0))
        self._cross_counter = int(data.get("cross_counter", 0))
        self._recent_errors = list(data.get("recent_errors", []))[-ERROR_RING:]

    def _write_queue_manifest(self) -> None:
        ckpt.save_json_atomic(self._qman_path, {
            "version": 1,
            "fused_total": self._fused_ids,
            "rejected_total": self._rejected,
            "novelty_rejected_total": self._novelty_rejected,
            "quarantined_total": self._quarantined,
            "rollbacks_total": self._rollbacks,
            "families_spawned_total": self._spawned,
            "cross_fuses_total": self._cross_fuses,
            "cross_counter": self._cross_counter,
            "recent_errors": list(self._recent_errors),
            "entries": list(self._entries.values()),
        })

    @staticmethod
    def _family_of(e: Dict[str, Any]) -> str:
        """An entry's member: ``main`` for entries without a ``family`` key
        (written by a single-base daemon)."""
        return e.get("family") or "main"

    def _entry_lane(self, e: Dict[str, Any]) -> _Lane:
        return self._lanes.get(self._family_of(e)) or self._main

    def _retire_consumed(self, *, seam: bool) -> None:
        """Drop queue entries whose rows left their member's staging manifest
        (their cohort's publish is durable): file deleted before the entry."""
        staged = {n: lane.repo.staged_spill_files() for n, lane in self._lanes.items()}
        changed = False
        for sub_id, e in list(self._entries.items()):
            lane = self._entry_lane(e)
            if f"{QUEUE_DIR}/{e['file']}" in staged[lane.name]:
                continue
            path = os.path.join(lane.queue_dir, e["file"])
            if os.path.exists(path):
                os.remove(path)
            if seam:
                faults.crash_point("service.mid_gc")
            del self._entries[sub_id]
            self._fused_ids += 1
            changed = True
        if changed:
            self._write_queue_manifest()

    def _recover(self) -> None:
        """An admitted entry no longer in its member's staging manifest was
        consumed by a publish that landed (or skipped by recovery as
        consumed)."""
        self._retire_consumed(seam=False)

    def _gc_consumed(self) -> None:
        self._retire_consumed(seam=True)

    # -- the forgetting regression gate ---------------------------------
    def _init_gate(self, lane: _Lane) -> None:
        """Adopt, replay or establish a member's durable gate baseline:
        state at the member's iteration is adopted; state behind it means a
        publish landed whose verdict a crash swallowed, so the current base
        is probed and the verdict applied now (the probes are
        deterministic, so it is the verdict that was lost); no state, or
        state ahead of the member, re-baselines on the current base."""
        state = None
        try:
            state = ckpt.load_json(lane.gate_path)
        except FileNotFoundError:
            pass
        if state is not None:
            try:
                it = int(state["iteration"])
                scores = {k: float(v) for k, v in state["scores"].items()}
            except (KeyError, TypeError, ValueError, AttributeError):
                warnings.warn("gate_state.json unreadable — re-baselining on the current base")
                state = None
        repo = lane.repo
        if state is not None and it == repo.iteration:
            lane.gate_baseline, lane.gate_iteration = scores, it
            return
        if state is not None and it < repo.iteration:
            lane.gate_baseline, lane.gate_iteration = scores, it
            self._apply_gate_verdict(self.gate.check(scores, repo.flat_base()), lane)
            return
        if state is not None:
            warnings.warn(f"gate_state.json names iteration {it} but the repository is at "
                          f"{repo.iteration} — re-baselining")
        self._rebaseline_gate(lane)

    def _rebaseline_gate(self, lane: _Lane) -> None:
        """Score the member's current base as its new known-good baseline
        and persist it atomically."""
        lane.gate_baseline = self.gate.probes.score(lane.repo.flat_base())
        lane.gate_iteration = lane.repo.iteration
        ckpt.save_json_atomic(lane.gate_path, {
            "version": 1, "iteration": lane.gate_iteration, "scores": lane.gate_baseline})

    def _apply_gate_verdict(self, report: ProbeReport, lane: _Lane) -> Dict[str, Any]:
        """Act on the probe comparison of the member's just-published base.
        Clean: the baseline advances (durably).  Tripped: the member's
        consumed cohort is quarantined, then the member rolls back to its
        baseline iteration with the staged next cohort kept; the other
        members are untouched.  While the bad base is current its iteration
        is ahead of ``gate_state.json``, which is what makes a restarted
        daemon replay this verdict.  Returns the gate event for the metrics
        series."""
        faults.crash_point("service.post_probe")
        lane.last_gate = self._last_gate = report.to_json()
        repo = lane.repo
        if report.ok:
            self._rebaseline_gate(lane)
            return {"event": "probe", "ok": True, "family": lane.name,
                    "iteration": repo.iteration, "probe": self._last_gate}
        bad_iteration = repo.iteration
        moved = self._quarantine_consumed(lane)
        self._emit_metrics({
            "event": "quarantine", "iteration": bad_iteration, "family": lane.name,
            "quarantined": moved, "quarantined_total": self._quarantined,
            "regressed": report.regressed, "worst_delta": report.worst,
        })
        faults.crash_point("service.post_quarantine")
        repo.rollback(lane.gate_iteration, keep_staged=True)
        lane.failed_cohort_size = None  # the staged cohort is unrelated
        self._emit_metrics({
            "event": "rollback", "from_iteration": bad_iteration, "family": lane.name,
            "to_iteration": lane.gate_iteration, "rollbacks_total": self._rollbacks,
            "probe": self._last_gate,
        })
        return {"event": "rollback", "ok": False, "family": lane.name,
                "from_iteration": bad_iteration, "to_iteration": lane.gate_iteration,
                "quarantined": moved, "probe": self._last_gate}

    def _quarantine_consumed(self, lane: _Lane) -> int:
        """Move the member's consumed cohort's queue files into
        ``<root>/quarantine/`` (``os.replace``, file before entry, as GC
        orders it: a crash leaves an orphan entry the replayed verdict
        finishes, never an orphan queue file that could fuse again).  Only
        this member's entries are candidates.  The counters ride the same
        queue manifest write as the entry drops, so they stay exact across a
        crash; one trip is one rollback."""
        staged = lane.repo.staged_spill_files()
        moved = 0
        for sub_id, e in list(self._entries.items()):
            if self._family_of(e) != lane.name:
                continue  # another member's cohort
            if f"{QUEUE_DIR}/{e['file']}" in staged:
                continue  # the next cohort, still staged
            src = os.path.join(lane.queue_dir, e["file"])
            if os.path.exists(src):
                os.makedirs(self.quarantine_dir, exist_ok=True)
                os.replace(src, os.path.join(self.quarantine_dir, e["file"]))
            del self._entries[sub_id]
            self._quarantined += 1
            moved += 1
        if moved:
            self._rollbacks += 1
            self._write_queue_manifest()
        return moved

    # -- admission ------------------------------------------------------
    def _scan_new(self) -> List[Tuple[str, Optional[_Lane]]]:
        """Queue files not yet tracked, in submission order, as ``(file,
        lane)``; in-flight atomic writes (``*.tmp-*``) are invisible.  Fresh
        submissions land in the top-level queue and scan unrouted (lane
        None).  A file already in another member's queue namespace but not
        in the queue manifest was moved there by a routing decision that a
        crash interrupted: it scans forced to that lane, so the restart
        finishes its admission without routing it again."""
        known = {(self._family_of(e), e["file"]) for e in self._entries.values()}

        def fresh(lane_name, qdir):
            return [fn for fn in sorted(os.listdir(qdir))
                    if fn.endswith(".npz") and ".tmp-" not in fn
                    and (lane_name, fn) not in known]

        out: List[Tuple[str, Optional[_Lane]]] = [
            (fn, None) for fn in fresh("main", self.queue_dir)]
        for name, lane in self._lanes.items():
            if name != "main":
                out.extend((fn, lane) for fn in fresh(name, lane.queue_dir))
        return out

    def _reject(self, fn: str, reason: str, *, novelty: bool = False,
                lane: Optional[_Lane] = None) -> None:
        self._rejected += 1
        if novelty:
            self._novelty_rejected += 1
        self._rejects = (self._rejects + [{"file": fn, "reason": reason}])[-8:]
        path = os.path.join((lane or self._main).queue_dir, fn)
        if os.path.exists(path):
            os.remove(path)

    @staticmethod
    def _rider_error(extra: Dict[str, Any]) -> Optional[str]:
        """A garbage rider field is a per-file rejection reason, never an
        exception that stalls the admit pass."""
        sub_id = extra.get("id")
        if sub_id is not None and not isinstance(sub_id, str):
            return f"malformed rider: id={sub_id!r} is not a string"
        base_it = extra.get("base_iteration")
        if base_it is not None:
            try:
                int(base_it)
            except (TypeError, ValueError):
                return f"malformed rider: base_iteration={base_it!r} is not an integer"
        weight = extra.get("weight")
        if weight is not None:
            try:
                w = float(weight)
            except (TypeError, ValueError):
                return f"malformed rider: weight={weight!r} is not a number"
            if not math.isfinite(w):
                # a NaN/inf weight would poison w/Σw and publish a non-finite base
                return f"malformed rider: weight={weight!r} is not finite"
        return None

    def _checksum_ok(self, path: str, meta: Dict[str, Any],
                     want: str) -> Tuple[bool, Optional[np.ndarray]]:
        """(CRC matches, the host row it read).  Compressed submissions are
        checked against the encoded payload bytes; their row is None."""
        if meta.get("compressed"):
            payloads, _ = ckpt.load_flat_delta(path)
            return delta_checksum(payloads) == want, None
        if meta["sharded"]:
            with ckpt.FlatShardReader(path) as r:
                row = r.full_row()
        else:
            row, _ = ckpt.load_flat(path)
        return row_checksum(row) == want, row

    def _compressed_screen(self, extra: Dict[str, Any], path: str,
                           lane: _Lane) -> Optional[str]:
        """None (admit), ``"defer"`` (leave queued) or a rejection reason
        for a compressed submission in ``lane``: its vintage must be the
        member's current iteration exactly, it waits while a fuse is in
        flight (the publish is about to move the base it decodes against),
        and its scales must be finite."""
        repo = lane.repo
        bi = extra.get("base_iteration")
        if bi is None:
            return ("malformed rider: compressed submission without base_iteration — a "
                    "delta is only decodable against its declared base")
        bi = int(bi)
        if repo.inflight:
            return "defer"
        if bi != repo.iteration:
            return (f"stale: delta encoded against base iteration {bi}, current "
                    f"{repo.iteration} — a compressed submission must match the current "
                    "vintage exactly")
        try:
            payloads, _ = ckpt.load_flat_delta(path)
        except Exception as err:  # torn / garbage payload entries
            return f"unreadable ({type(err).__name__}: {err})"
        for p in payloads:
            if not np.isfinite(p.scales).all():
                return "malformed rider: non-finite quantization scale in delta payload"
        return None

    def _staleness(self, extra: Dict[str, Any], lane: _Lane) -> Optional[str]:
        lim = self.policy.max_staleness
        base_it = extra.get("base_iteration")
        if lim is None or base_it is None:
            return None
        lag = lane.repo.iteration - int(base_it)
        if lag > lim:
            return (f"stale: finetuned from iteration {int(base_it)}, current "
                    f"{lane.repo.iteration} (max_staleness={lim})")
        return None

    def _obtain_sketch(self, fn: str, path: str, meta: Dict[str, Any], *, lane: _Lane,
                       at: Optional[_Lane] = None,
                       row=None) -> Tuple[Optional[np.ndarray], bool]:
        """(sketch, rejected): the rider's sketch when present and trusted,
        else from the row the checksum pass read, else from the file in one
        read (``Repository.sketch_row_file`` of ``lane``'s member, the
        kernel on the card).  An unreadable file is rejected from ``at``'s
        queue namespace (the lane whose directory holds it)."""
        sk = lane.repo.cohort_sketch
        sketch = None
        rider = (meta.get("extra") or {}).get("sketch")
        if rider is not None and not self.policy.verify_checksums:
            try:
                arr = np.asarray(rider, np.float64)
                if arr.shape == (2, sk.n_buckets) and np.isfinite(arr).all():
                    sketch = arr
            except (TypeError, ValueError):
                sketch = None  # malformed rider sketch: compute from the file
        if sketch is None and row is not None:
            sketch = row_sketch_host(row, sk.n_buckets)
        if sketch is None:
            try:
                sketch = lane.repo.sketch_row_file(path, meta=meta)
            except Exception as err:  # torn / vanished since the peek
                self._reject(fn, f"unreadable ({type(err).__name__}: {err})", lane=at or lane)
                return None, True
        return sketch, False

    def _novelty_check(self, fn: str, path: str, meta: Dict[str, Any], sub_id: str,
                       threshold: Optional[float], *, lane: _Lane, row=None,
                       sketch: Optional[np.ndarray] = None,
                       delta: Optional[np.ndarray] = None) -> bool:
        """Reject the file (True) if its sketch lies within ``threshold`` of
        one of the member's windowed admissions; otherwise make its sketch
        (and its routing ``delta``) durable before the row stages.
        ``threshold=None`` (routing with the screen off) only records."""
        sk = lane.repo.cohort_sketch
        if sketch is None:
            sketch, rejected = self._obtain_sketch(fn, path, meta, lane=lane, row=row)
            if rejected:
                return True
        if threshold is not None:
            # the self-match exemption needs the id AND the file: only this
            # queue file's own pre-crash entry is skipped
            hit = sk.match(sketch, threshold, skip_id=sub_id, skip_file=fn)
            if hit is not None:
                self._reject(fn, f"near-duplicate of {hit[0]} (sketch distance {hit[1]:.4f} "
                                 f"<= novelty_threshold {threshold:g})", novelty=True,
                             lane=lane)
                return True
        sk.add(sub_id, sketch, file=fn, delta=delta)
        lane.repo.save_cohort_sketch()
        faults.crash_point("service.post_sketch")
        return False

    def _admit(self) -> Dict[str, int]:
        """Stage new queue arrivals into their member, up to its cohort
        budget; unreadable, malformed, mismatched, stale and near-duplicate
        files are rejected here and never reach the fuse.  Under routing a
        fresh submission is first routed and moved into its member's queue
        namespace (``_route_admit``), and every later screen runs against
        that member.  A file already staged by a pre-crash admit whose
        queue-manifest write was lost is re-marked, outside the budget,
        keyed by (member, file).  Returns ``{"admitted": n, "queue_depth":
        left queued}``."""
        new = self._scan_new()
        if not new:
            return {"admitted": 0, "queue_depth": 0}
        staged = {n: lane.repo.staged_spill_files() for n, lane in self._lanes.items()}
        threshold = self.policy.novelty_threshold
        admitted = leftover = 0
        rejected0 = self._rejected
        for fn, forced in new:
            lane = forced if forced is not None else self._main
            path = os.path.join(lane.queue_dir, fn)
            sub_id = fn[: -len(".npz")]
            if f"{QUEUE_DIR}/{fn}" in staged[lane.name]:
                # re-mark only; bookkeeping from the entry already tracking it
                prev = next((s for s, e in self._entries.items()
                             if e["file"] == fn and self._family_of(e) == lane.name), None)
                extra: Dict[str, Any] = {}
                if prev is not None:
                    sub_id = prev
                    extra = {k: self._entries[prev].get(k) for k in ("weight", "contributor")}
                weight = extra.get("weight")
            else:
                # a routed file's budget is checked before its move
                if ((forced is not None or not self._routing)
                        and self.policy.max_cohort - lane.repo.n_staged <= 0):
                    leftover += 1
                    continue
                try:
                    meta = ckpt.flat_row_meta(path)
                except Exception as err:  # torn / garbage enqueue
                    self._reject(fn, f"unreadable ({type(err).__name__}: {err})", lane=lane)
                    continue
                extra = meta.get("extra") or {}
                rider_err = self._rider_error(extra)
                if rider_err is not None:
                    self._reject(fn, rider_err, lane=lane)
                    continue
                sub_id = extra.get("id") or sub_id
                sketch = delta = None
                if self._routing:
                    if forced is None:
                        routed = self._route_admit(fn, path, meta, extra, sub_id)
                        if routed is None:
                            continue
                        if routed == "defer":
                            leftover += 1
                            continue
                        lane, path, sketch, delta = routed
                    else:
                        sketch, bad = self._obtain_sketch(fn, path, meta, lane=lane)
                        if bad:
                            continue
                        delta = self._delta_of(sketch, extra)
                if meta.get("compressed"):
                    verdict = self._compressed_screen(extra, path, lane)
                    if verdict == "defer":
                        leftover += 1
                        continue
                    if verdict is not None:
                        self._reject(fn, verdict, lane=lane)
                        continue
                else:
                    stale = self._staleness(extra, lane)
                    if stale is not None:
                        self._reject(fn, stale, lane=lane)
                        continue
                row = None
                if self.policy.verify_checksums and extra.get("checksum"):
                    try:
                        ok, row = self._checksum_ok(path, meta, extra["checksum"])
                    except Exception as err:  # torn between the peek and the read
                        self._reject(fn, f"unreadable ({type(err).__name__}: {err})",
                                     lane=lane)
                        continue
                    if not ok:
                        self._reject(fn, "checksum mismatch", lane=lane)
                        continue
                if (threshold is not None or self._routing) and self._novelty_check(
                        fn, path, meta, sub_id, threshold, lane=lane, row=row,
                        sketch=sketch, delta=delta):
                    continue
                w = extra.get("weight")
                weight = None if w is None else float(w)
                try:
                    lane.repo.ingest_spilled(path, weight=weight, meta=meta)
                except ValueError as err:  # FlatSpec mismatch
                    if threshold is not None or self._routing:
                        # a row that never staged must not stay in the window
                        lane.repo.cohort_sketch.discard(sub_id)
                        lane.repo.save_cohort_sketch()
                    self._reject(fn, str(err), lane=lane)
                    continue
                faults.crash_point("service.post_ingest")
            for other in [s for s, e in self._entries.items()
                          if e["file"] == fn and s != sub_id
                          and self._family_of(e) == lane.name]:
                del self._entries[other]
            entry = {
                "id": sub_id, "file": fn, "state": "admitted",
                "weight": weight,
                "contributor": extra.get("contributor"),
                "admitted_at": time.time(),
                "staged_iteration": lane.repo.iteration,
            }
            if self._routing:
                entry["family"] = lane.name
            self._entries[sub_id] = entry
            admitted += 1
            lane.failed_cohort_size = None  # new blood: retry a stuck cohort
            if lane.cohort_since is None:
                lane.cohort_since = time.time()
        if admitted or self._rejected != rejected0:
            self._write_queue_manifest()
        return {"admitted": admitted, "queue_depth": leftover}

    # -- routing --------------------------------------------------------
    def _route_admit(self, fn: str, path: str, meta: Dict[str, Any], extra: Dict[str, Any],
                     sub_id: str):
        """Route one fresh top-level submission.  Returns None (rejected),
        ``"defer"`` (left queued) or ``(lane, path, sketch, delta)`` with
        ``path`` the file's place in the routed member's queue namespace.
        The atomic move there is the durable decision: a crash after it
        (the ``service.post_route`` seam) is finished by ``_scan_new``'s
        forced-lane pass without routing again."""
        declared = str(extra.get("family") or "main")
        dl = self._lanes.get(declared)
        if dl is None:
            self._reject(fn, f"malformed rider: unknown family {declared!r}")
            return None
        bi = extra.get("base_iteration")
        bi = None if bi is None else int(bi)
        sketch, bad = self._obtain_sketch(fn, path, meta, lane=dl, at=self._main)
        if bad:
            return None
        decision = self._router.route(
            sketch, {n: lane.repo.cohort_sketch for n, lane in self._lanes.items()},
            declared=declared, base_iteration=bi)
        spawned = False
        if decision.spawn:
            if meta.get("compressed"):
                # never mint a member for a submission that cannot fuse there
                self._reject(fn, self._family_pin_reason(declared, None))
                return None
            lane = self._unclaimed_lane()
            if lane is None:
                lane = self._spawn_lane(declared, bi)
                spawned = True
        else:
            lane = self._lanes[decision.family]
            if meta.get("compressed") and lane.name != declared:
                self._reject(fn, self._family_pin_reason(declared, lane.name))
                return None
        if self.policy.max_cohort - lane.repo.n_staged <= 0:
            return "defer"
        if lane.name != "main":
            dst = os.path.join(lane.queue_dir, fn)
            ckpt.move_atomic(path, dst)
            path = dst
        faults.crash_point("service.post_route")
        self._routes = (self._routes + [{
            "id": sub_id, "family": lane.name, "distance": decision.distance,
            "spawned": spawned, "reason": decision.reason}])[-ROUTE_RING:]
        return lane, path, sketch, decision.delta

    @staticmethod
    def _family_pin_reason(declared: str, routed: Optional[str]) -> str:
        dst = "a new family member" if routed is None else f"member {routed!r}"
        return (f"stale: delta encoded against family {declared!r} but routed to {dst} — "
                "a compressed submission is pinned to its declared member's base")

    def _unclaimed_lane(self) -> Optional[_Lane]:
        """A spawned member without any evidence: its spawning submission
        crashed away (or failed ingest) before leaving a trace, so the next
        spawn-worthy submission claims it instead of minting another."""
        for name in sorted(self._lanes):
            lane = self._lanes[name]
            if (name != "main" and not lane.repo.history and not lane.repo.n_staged
                    and not lane.repo.inflight and lane.repo.cohort_sketch is not None
                    and not lane.repo.cohort_sketch.entries):
                return lane
        return None

    def _spawn_lane(self, declared: str, seed_iteration: Optional[int]) -> _Lane:
        """Mint a member seeded from the declared member's base vintage,
        wire its lane (sketch window, gate baseline) and persist the spawn
        counter."""
        name = self.family.spawn(seed_family=declared, seed_iteration=seed_iteration)
        member = self.family.members[name]
        lane = self._make_lane(name, member)
        self._lanes[name] = lane
        member.enable_cohort_sketch(window=self.policy.sketch_window)
        if self.gate is not None:
            self._rebaseline_gate(lane)
        self._spawned += 1
        self._write_queue_manifest()
        self._emit_metrics({
            "event": "family_spawn", "family": name, "seeded_from": declared,
            "families": len(self._lanes), "families_spawned_total": self._spawned,
        })
        return lane

    def _delta_of(self, sketch, extra: Dict[str, Any]) -> Optional[np.ndarray]:
        """A forced-lane file's routing delta (its projections minus its
        declared vintage's), for the routed member's evidence window: the
        post-route crash path skips the router, which would supply it."""
        dl = self._lanes.get(str(extra.get("family") or "main"))
        if dl is None or dl.repo.cohort_sketch is None:
            return None
        bi = extra.get("base_iteration")
        b0 = dl.repo.cohort_sketch.base_at(None if bi is None else int(bi))
        if b0 is None:
            return None
        return np.asarray(sketch, np.float64)[0] - np.asarray(b0, np.float64)[0]

    # -- fuse policy ----------------------------------------------------
    def _should_fuse(self, lane: _Lane) -> bool:
        n = lane.repo.n_staged
        if n == 0 or lane.failed_cohort_size == n:
            return False
        if n >= self.policy.min_cohort:
            return True
        return (self.policy.max_wait_s > 0 and lane.cohort_since is not None
                and time.time() - lane.cohort_since >= self.policy.max_wait_s)

    def _note_error(self, err: Exception, lane: _Lane) -> None:
        self._last_error = f"{type(err).__name__}: {err}"
        lane.failed_cohort_size = lane.repo.n_staged
        self._recent_errors = (self._recent_errors + [
            {"t": time.time(), "error": self._last_error}])[-ERROR_RING:]
        self._write_queue_manifest()

    # -- the poll cycle -------------------------------------------------
    def run_once(self) -> Dict[str, Any]:
        """One cycle: admit (and route) arrivals; in every lane dispatch
        (or finalize) per the cohort policy and gate the publish when armed;
        GC consumed submissions, compact on policy, cross-fuse a quiescent
        family on schedule, publish status, append metrics.  Returns the
        status it published."""
        self._cycle += 1
        adm = self._admit()
        gate_event = None
        published = []
        for lane in list(self._lanes.values()):
            repo = lane.repo
            it_before = repo.iteration
            if self._should_fuse(lane):
                try:
                    if self.gate is not None:
                        # gated: synchronous, so no second cohort dispatches
                        # against a base the gate may roll back
                        repo.fuse_pending(wait=True)
                    else:
                        # finalizes any in-flight fuse, then launches the
                        # staged cohort: the card fuses while the next
                        # cycles drain
                        repo.fuse_pending(wait=False)
                    lane.cohort_since = None
                    self._last_error = None
                    faults.crash_point("service.post_dispatch")
                except RuntimeError as err:  # e.g. all rows rejected
                    self._note_error(err, lane)
            elif repo.inflight:
                # queue drained: publish the in-flight fuse now
                try:
                    repo.flush()
                    self._last_error = None
                except RuntimeError as err:
                    self._note_error(err, lane)
            if repo.iteration != it_before:
                published.append(lane)
                self._last_pub = lane.name
                self._cross_counter += 1
                faults.crash_point("service.post_publish")
                if self.gate is not None:
                    gate_event = self._apply_gate_verdict(
                        self.gate.check(lane.gate_baseline, repo.flat_base()), lane)
        if published:
            self._gc_consumed()
            for lane in published:
                if self.policy.compact_keep_bases is not None and not lane.repo.inflight:
                    # only while quiescent: compact's flush would otherwise
                    # finalize the fuse just dispatched; a deferred
                    # compaction runs on the cycle that publishes it
                    lane.repo.compact(keep_bases=self.policy.compact_keep_bases)
        if (self._routing and self.policy.cross_fuse_every > 0
                and self._cross_counter >= self.policy.cross_fuse_every
                and len(self._lanes) >= 2
                and not any(lane.repo.inflight or lane.repo.n_staged
                            for lane in self._lanes.values())):
            self._cross_fuse()
        st = self.status(admitted=adm["admitted"], queue_depth=adm["queue_depth"])
        ckpt.save_json_atomic(self._status_path, st)
        self._emit_cycle_metrics(st, gate_event)
        return st

    def _cross_fuse(self) -> None:
        """One cross-fuse round (``RepositoryFamily.cross_fuse``) and its
        bookkeeping: the counters persist (so a restarted daemon neither
        skips nor repeats the round), every member's gate re-baselines on
        its moved base, and the event lands in the metrics series."""
        self.family.cross_fuse()
        self._cross_fuses += 1
        self._cross_counter = 0
        self._write_queue_manifest()
        if self.gate is not None:
            for lane in self._lanes.values():
                self._rebaseline_gate(lane)
        self._emit_metrics({
            "event": "cross_fuse",
            "families": {n: lane.repo.iteration for n, lane in self._lanes.items()},
            "cross_fuses_total": self._cross_fuses,
        })

    # -- metrics time series --------------------------------------------
    def _emit_metrics(self, record: Dict[str, Any]) -> None:
        """One record onto the append-only ``metrics.jsonl`` (the daemon is
        the series' single rotator)."""
        ckpt.append_jsonl(self._metrics_path, {"t": time.time(), **record},
                          rotate_bytes=METRICS_ROTATE_BYTES)

    def _emit_cycle_metrics(self, st: Dict[str, Any],
                            gate_event: Optional[Dict[str, Any]] = None) -> None:
        """The per-cycle record, for every cycle that changed anything (a
        gate event included) plus the first; idle polls are skipped."""
        mark = (st["iteration"], st["staged"], st["admitted"],
                st["fused_queue_submissions"], st["rejected_total"],
                st["quarantined_total"], st["rollbacks_total"], st["last_error"])
        if mark == self._metrics_mark and gate_event is None:
            return
        self._metrics_mark = mark
        last = st["last_fuse"]
        self._emit_metrics({
            "event": "cycle",
            "cycle": self._cycle,
            "iteration": st["iteration"],
            "queue_depth": st["queue_depth"],
            "staged": st["staged"],
            "inflight": st["inflight"],
            "admitted_this_cycle": st["admitted_this_cycle"],
            "cohort": None if last is None else last["n_contributions"],
            "fuse_latency_s": st["fuse_latency_s"],
            "fused_queue_submissions": st["fused_queue_submissions"],
            "rejected_total": st["rejected_total"],
            "novelty_rejected_total": st["novelty_rejected_total"],
            "quarantined_total": st["quarantined_total"],
            "rollbacks_total": st["rollbacks_total"],
            "probe": None if gate_event is None else gate_event.get("probe"),
            "last_error": st["last_error"],
        })

    def serve_forever(self, *, poll_interval: float = 0.02,
                      max_iterations: Optional[int] = None,
                      idle_timeout: Optional[float] = None,
                      max_poll_interval: Optional[float] = None) -> Dict[str, Any]:
        """Run poll cycles until ``request_stop()``, until every member's
        published iteration reaches ``max_iterations`` (once quiescent), or
        until ``idle_timeout`` seconds pass without progress.  No-progress
        sleeps back off with jitter up to ``max_poll_interval`` (default the
        larger of ``poll_interval`` and 0.25 s); an in-flight fuse pins the
        sleep at ``poll_interval``.  Returns the final status."""
        cap = (max(poll_interval, 0.25) if max_poll_interval is None
               else max(poll_interval, max_poll_interval))
        delay = poll_interval
        last_progress = time.monotonic()
        last_its = {n: lane.repo.iteration for n, lane in self._lanes.items()}
        while not self._stop:
            st = self.run_once()
            its = {n: lane.repo.iteration for n, lane in self._lanes.items()}
            progress = st["admitted_this_cycle"] or its != last_its
            last_its = its
            if progress:
                last_progress = time.monotonic()
                delay = poll_interval
            idle = st["queue_depth"] == 0 and st["staged"] == 0 and not st["inflight"]
            if max_iterations is not None and idle and min(its.values()) >= max_iterations:
                break
            if (idle_timeout is not None and st["queue_depth"] == 0 and not st["inflight"]
                    and time.monotonic() - last_progress >= idle_timeout):
                break
            if not progress:
                if st["inflight"]:
                    time.sleep(poll_interval)
                else:
                    time.sleep(random.uniform(delay / 2, delay))
                    delay = min(delay * 2, cap)
        return self.close()

    def request_stop(self) -> None:
        self._stop = True

    def close(self) -> Dict[str, Any]:
        """Quiesce: finalize every member's in-flight fuse, GC, publish a
        final status with ``running=False``.  Staged rows stay in the
        durable manifests."""
        self._stop = True
        for lane in list(self._lanes.values()):
            try:
                lane.repo.flush()
            except RuntimeError as err:
                self._note_error(err, lane)
        self._gc_consumed()
        st = self.status()
        st["running"] = False
        ckpt.save_json_atomic(self._status_path, st)
        return st

    # -- status endpoint ------------------------------------------------
    def status(self, *, admitted: int = 0, queue_depth: Optional[int] = None) -> Dict[str, Any]:
        """The fields contributors and operators poll, persisted atomically
        to ``<root>/service_status.json`` every cycle (the reference's
        keys, ``serving`` from the workers' state files).  ``staged``, ``inflight``, ``fuses``
        and ``fused_contributions`` cover the whole family, ``iteration``
        is main's; under routing ``families`` holds each member's view,
        with the ``routes`` ring and the spawn and cross-fuse totals."""
        lanes = self._lanes.values()
        lh = (self._lanes.get(self._last_pub) or self._main).repo.history
        last = lh[-1] if lh else None
        st = {
            "iteration": self.repo.iteration,
            "queue_depth": len(self._scan_new()) if queue_depth is None else queue_depth,
            "staged": sum(lane.repo.n_staged for lane in lanes),
            "inflight": any(lane.repo.inflight for lane in lanes),
            "admitted": len(self._entries),
            "admitted_this_cycle": admitted,
            "fuses": sum(len(lane.repo.history) for lane in lanes),
            "fused_contributions": sum(r.n_contributions for lane in lanes
                                       for r in lane.repo.history),
            "fused_queue_submissions": self._fused_ids,
            "rejected_total": self._rejected,
            "novelty_rejected_total": self._novelty_rejected,
            "novelty_screen": self.policy.novelty_threshold is not None,
            "sketch_entries": (None if self.repo.cohort_sketch is None
                               else len(self.repo.cohort_sketch)),
            "recent_rejects": list(self._rejects),
            "gate": self.gate is not None,
            "quarantined_total": self._quarantined,
            "rollbacks_total": self._rollbacks,
            "last_gate": self._last_gate,
            "routing": self._routing,
            "fuse_latency_s": last.wall_time if last else None,
            "last_fuse": None if last is None else {
                "iteration": last.iteration,
                "n_contributions": last.n_contributions,
                "n_accepted": last.n_accepted,
                "op": last.op,
                "wall_time": last.wall_time,
            },
            "last_error": self._last_error,
            "recent_errors": list(self._recent_errors),
            "serving": self._serving_state(),
            "pid": os.getpid(),
            "running": not self._stop,
            "updated_at": time.time(),
        }
        if self._routing:
            st["families"] = {
                name: {
                    "iteration": lane.repo.iteration,
                    "staged": lane.repo.n_staged,
                    "inflight": lane.repo.inflight,
                    "fuses": len(lane.repo.history),
                    "fused_contributions": sum(r.n_contributions for r in lane.repo.history),
                    "gate_iteration": lane.gate_iteration,
                    "last_gate": lane.last_gate,
                } for name, lane in self._lanes.items()}
            st["routes"] = list(self._routes)
            st["families_spawned_total"] = self._spawned
            st["cross_fuses_total"] = self._cross_fuses
        return st

    def _serving_state(self) -> Optional[Dict[str, Any]]:
        """The hot-swap workers' state files, embedded read-only (None when
        no worker ever served this root).  A solo ``serving_state.json``
        passes through unchanged.  With pool files (``serving_state-<id>.json``)
        the block is an aggregate: the per-worker map, summed request, swap
        and inflight counters, ``iteration`` only when every worker agrees
        (None mid-divergence) and the union of ``versions_served``."""
        root = self.repo.root
        workers: Dict[str, Dict[str, Any]] = {}
        try:
            names = sorted(os.listdir(root))
        except FileNotFoundError:
            names = []
        for fn in names:
            if fn.startswith("serving_state-") and fn.endswith(".json"):
                try:
                    workers[fn[len("serving_state-"):-len(".json")]] = \
                        ckpt.load_json(os.path.join(root, fn))
                except (FileNotFoundError, ValueError):
                    continue  # mid-replace or torn: skip, not fatal
        solo = None
        try:
            solo = ckpt.load_json(os.path.join(root, SERVING_STATE_FILE))
        except (FileNotFoundError, ValueError):
            pass
        if not workers:
            return solo
        if solo is not None:
            workers.setdefault(solo.get("worker", "solo"), solo)
        iters = {w.get("iteration") for w in workers.values()}
        agg: Dict[str, Any] = {
            "workers": workers,
            "n_workers": len(workers),
            "iteration": iters.pop() if len(iters) == 1 else None,
            "swapping": any(w.get("swapping") for w in workers.values()),
        }
        for key in ("swaps_total", "live_swaps", "requests_total",
                    "requests_pinned_across_swaps", "requests_batched", "inflight"):
            agg[key] = sum(int(w.get(key) or 0) for w in workers.values())
        agg["versions_served"] = sorted({v for w in workers.values()
                                         for v in (w.get("versions_served") or [])})
        return agg
