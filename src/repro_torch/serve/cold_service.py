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

Not ported yet (each raises): ``family=`` (similarity routing,
``max_bases > 1``, ``cross_fuse_every``), ``gate=`` (the regression gate),
``compact_keep_bases``, per-shard submissions (``sspec=``) and the
serving-state files (``status()["serving"]`` is None).
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
from repro_torch.core.repository import Repository
from repro_torch.utils import faults
from repro_torch.utils.device import resolve_device
from repro_torch.utils.flat import (LANE, FlatSpec, delta_checksum, delta_encode,
                                    row_checksum, row_sketch_host)

QUEUE_DIR = "queue"
QUEUE_MANIFEST = "queue_manifest.json"
STATUS_FILE = "service_status.json"
METRICS_FILE = "metrics.jsonl"
# the daemon rotates the active metrics file to metrics.jsonl.1 at this size
METRICS_ROTATE_BYTES = 4 * 1024 * 1024
ERROR_RING = 16  # recent_errors entries kept (and persisted)


def _queue_dir(root: str) -> str:
    return os.path.join(root, QUEUE_DIR)


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet")


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
               sspec=None, weight: Optional[float] = None,
               base_iteration: Optional[int] = None, seq: Optional[int] = None,
               checksum: bool = False, sketch: Optional[bool] = None,
               compress: bool = False, base=None, family: Optional[str] = None,
               k_per_block: int = 64, codec_block: int = LANE) -> str:
        """Enqueue one contribution; returns its submission id once it is
        durably in the queue.

        Pass a ``params`` tree (flattened here, on its device) or a flat
        ``row`` with its ``spec``.  ``base_iteration`` is the iteration of
        the base it was finetuned from (the staleness screen).
        ``checksum=True`` stamps a CRC (of the row, or of the encoded
        payload bytes when compressed).  ``sketch`` stamps the row's content
        sketch into the rider (default: iff the service's status says the
        novelty screen is armed, or no status exists yet).
        ``compress=True`` enqueues ``row − base`` as per-block top-
        ``k_per_block`` int8 values with f32 scales (``delta_encode``);
        it needs ``base`` (the pulled base tree or row) and
        ``base_iteration``, since the service admits a delta only against
        its exact declared vintage."""
        if sspec is not None:
            raise _not_ported("submit(sspec=) (per-shard submissions)")
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
            ckpt.save_flat_delta(path, payload, spec, extra=extra)
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

    def download_base(self, device="cuda"):
        """Pull the latest published base tree (Fig. 1, step 1) onto
        ``device`` (the card unless the caller asks for the CPU).  The base
        npz is durable before repository.json names it, so the load never
        races a publish into a missing file."""
        device = resolve_device(device)
        meta = ckpt.load_json(os.path.join(self.root, "repository.json"))
        it = int(meta["iteration"])
        return ckpt.load(os.path.join(self.root, f"base_iter{it:04d}.npz"), device=device)


# ---------------------------------------------------------------------------
# service side
# ---------------------------------------------------------------------------


@dataclass
class AdmissionPolicy:
    """Cohort formation and screening at the queue boundary (the reference's
    fields; the routing and compaction knobs are not ported yet).

    * ``min_cohort`` — dispatch once this many rows are staged;
    * ``max_wait_s`` — ...or once the oldest staged row waited this long;
    * ``max_cohort`` — stage at most this many rows per cohort;
    * ``max_staleness`` — reject a dense row whose ``base_iteration`` lags
      by more (compressed rows are pinned to the exact current vintage);
    * ``verify_checksums`` — re-read each row and verify its CRC;
    * ``novelty_threshold`` — reject a row whose sketch lies within this
      relative distance of one of the last ``sketch_window`` admissions
      (None disables the screen)."""

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


class ColdService:
    """The polling fusion daemon over a spill-enabled Repository.  Single
    owner: one service per repository root."""

    def __init__(self, repo: Optional[Repository] = None, *, family=None,
                 policy: Optional[AdmissionPolicy] = None, gate=None):
        if family is not None:
            raise _not_ported("ColdService(family=) (similarity routing)")
        if gate is not None:
            raise _not_ported("ColdService(gate=) (the regression gate)")
        if repo is None:
            raise ValueError("ColdService needs repo=")
        if not repo.root:
            raise ValueError("ColdService requires an on-disk repository")
        if not repo.spill:
            raise ValueError("ColdService requires Repository(spill=True) — queue ingest "
                             "rides the crash-recoverable staging manifest")
        self.policy = policy or AdmissionPolicy()
        p = self.policy
        if p.compact_keep_bases is not None:
            raise _not_ported("AdmissionPolicy(compact_keep_bases=)")
        if p.max_bases > 1 or p.cross_fuse_every:
            raise _not_ported("AdmissionPolicy(max_bases>1, cross_fuse_every) (routing)")
        self.repo = repo
        self.queue_dir = _queue_dir(repo.root)
        os.makedirs(self.queue_dir, exist_ok=True)
        # the cohort clock, and the size of a cohort whose fuse just failed
        # (not retried until new rows arrive); the reference keeps these per
        # family member, the single-base service has one
        self._cohort_since: Optional[float] = None
        self._failed_cohort_size: Optional[int] = None
        self._qman_path = os.path.join(self.queue_dir, QUEUE_MANIFEST)
        self._status_path = os.path.join(repo.root, STATUS_FILE)
        self._metrics_path = os.path.join(repo.root, METRICS_FILE)
        self._entries: Dict[str, Dict[str, Any]] = {}
        self._rejects: List[Dict[str, str]] = []
        self._fused_ids = 0          # queue submissions retired as fused
        self._rejected = 0
        self._novelty_rejected = 0   # subset of _rejected: near-duplicates
        # counters of the reference's unported features, carried verbatim
        # through the queue manifest so a root keeps them across packages
        self._carried: Dict[str, int] = {}
        self._recent_errors: List[Dict[str, Any]] = []
        self._last_error: Optional[str] = None
        self._cycle = 0
        self._metrics_mark: Optional[tuple] = None
        self._stop = False
        torn = ckpt.repair_jsonl_tail(self._metrics_path)
        if torn:
            warnings.warn(f"metrics.jsonl: truncated a torn {torn}-byte tail left by a "
                          "crashed daemon")
        self._load_queue_manifest()
        self._recover()
        if p.novelty_threshold is not None:
            # adopt (or create) the persisted window before the first admission
            repo.enable_cohort_sketch(window=p.sketch_window)
        # contributors read the policy (whether to stamp sketches) from here
        ckpt.save_json_atomic(self._status_path, self.status())
        if repo.n_staged:
            # recovered rows start the cohort clock too
            self._cohort_since = time.time()

    # -- queue manifest -------------------------------------------------
    _CARRIED = ("quarantined_total", "rollbacks_total", "families_spawned_total",
                "cross_fuses_total", "cross_counter")

    def _load_queue_manifest(self) -> None:
        try:
            data = ckpt.load_json(self._qman_path)
        except FileNotFoundError:
            return
        self._entries = {e["id"]: e for e in data.get("entries", [])}
        if any((e.get("family") or "main") != "main" for e in self._entries.values()):
            raise _not_ported("serving a queue with family-routed entries (routing)")
        self._fused_ids = int(data.get("fused_total", 0))
        self._rejected = int(data.get("rejected_total", 0))
        self._novelty_rejected = int(data.get("novelty_rejected_total", 0))
        self._carried = {k: int(data.get(k, 0)) for k in self._CARRIED}
        self._recent_errors = list(data.get("recent_errors", []))[-ERROR_RING:]

    def _write_queue_manifest(self) -> None:
        ckpt.save_json_atomic(self._qman_path, {
            "version": 1,
            "fused_total": self._fused_ids,
            "rejected_total": self._rejected,
            "novelty_rejected_total": self._novelty_rejected,
            **{k: self._carried.get(k, 0) for k in self._CARRIED},
            "recent_errors": list(self._recent_errors),
            "entries": list(self._entries.values()),
        })

    def _retire_consumed(self, *, seam: bool) -> None:
        """Drop queue entries whose rows left the staging manifest (their
        cohort's publish is durable): file deleted before the entry."""
        staged = self.repo.staged_spill_files()
        changed = False
        for sub_id, e in list(self._entries.items()):
            if f"{QUEUE_DIR}/{e['file']}" in staged:
                continue
            path = os.path.join(self.queue_dir, e["file"])
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
        """An admitted entry no longer in the staging manifest was consumed
        by a publish that landed (or skipped by recovery as consumed)."""
        self._retire_consumed(seam=False)

    def _gc_consumed(self) -> None:
        self._retire_consumed(seam=True)

    # -- admission ------------------------------------------------------
    def _scan_new(self) -> List[str]:
        """Queue files not yet tracked, in submission order; in-flight
        atomic writes (``*.tmp-*``) are invisible."""
        known = {e["file"] for e in self._entries.values()}
        return [fn for fn in sorted(os.listdir(self.queue_dir))
                if fn.endswith(".npz") and ".tmp-" not in fn and fn not in known]

    def _reject(self, fn: str, reason: str, *, novelty: bool = False) -> None:
        self._rejected += 1
        if novelty:
            self._novelty_rejected += 1
        self._rejects = (self._rejects + [{"file": fn, "reason": reason}])[-8:]
        path = os.path.join(self.queue_dir, fn)
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
            raise ValueError("sharded rows are not ported yet (multi-device slice)")
        row, _ = ckpt.load_flat(path)
        return row_checksum(row) == want, row

    def _compressed_screen(self, extra: Dict[str, Any], path: str) -> Optional[str]:
        """None (admit), ``"defer"`` (leave queued) or a rejection reason
        for a compressed submission: its vintage must be the current
        iteration exactly, it waits while a fuse is in flight (the publish
        is about to move the base it decodes against), and its scales must
        be finite."""
        repo = self.repo
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
        except Exception as err:  # torn / garbage / sharded payload entries
            return f"unreadable ({type(err).__name__}: {err})"
        for p in payloads:
            if not np.isfinite(p.scales).all():
                return "malformed rider: non-finite quantization scale in delta payload"
        return None

    def _staleness(self, extra: Dict[str, Any]) -> Optional[str]:
        lim = self.policy.max_staleness
        base_it = extra.get("base_iteration")
        if lim is None or base_it is None:
            return None
        lag = self.repo.iteration - int(base_it)
        if lag > lim:
            return (f"stale: finetuned from iteration {int(base_it)}, current "
                    f"{self.repo.iteration} (max_staleness={lim})")
        return None

    def _obtain_sketch(self, fn: str, path: str, meta: Dict[str, Any],
                       row=None) -> Tuple[Optional[np.ndarray], bool]:
        """(sketch, rejected): the rider's sketch when present and trusted,
        else from the row the checksum pass read, else from the file in one
        read (``Repository.sketch_row_file``, the kernel on the card)."""
        sk = self.repo.cohort_sketch
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
                sketch = self.repo.sketch_row_file(path, meta=meta)
            except Exception as err:  # torn / vanished / sharded since the peek
                self._reject(fn, f"unreadable ({type(err).__name__}: {err})")
                return None, True
        return sketch, False

    def _novelty_check(self, fn: str, path: str, meta: Dict[str, Any], sub_id: str,
                       threshold: float, row=None) -> bool:
        """Reject the file (True) if its sketch lies within ``threshold`` of
        a windowed admission; otherwise make its sketch durable before the
        row stages."""
        sk = self.repo.cohort_sketch
        sketch, rejected = self._obtain_sketch(fn, path, meta, row=row)
        if rejected:
            return True
        # the self-match exemption needs the id AND the file: only this queue
        # file's own pre-crash entry is skipped
        hit = sk.match(sketch, threshold, skip_id=sub_id, skip_file=fn)
        if hit is not None:
            self._reject(fn, f"near-duplicate of {hit[0]} (sketch distance {hit[1]:.4f} "
                             f"<= novelty_threshold {threshold:g})", novelty=True)
            return True
        sk.add(sub_id, sketch, file=fn)
        self.repo.save_cohort_sketch()
        faults.crash_point("service.post_sketch")
        return False

    def _admit(self) -> Dict[str, int]:
        """Stage new queue arrivals up to the cohort budget; unreadable,
        malformed, mismatched, stale and near-duplicate files are rejected
        here and never reach the fuse.  A file already staged by a pre-crash
        admit whose queue-manifest write was lost is re-marked, outside the
        budget.  Returns ``{"admitted": n, "queue_depth": left queued}``."""
        new = self._scan_new()
        if not new:
            return {"admitted": 0, "queue_depth": 0}
        staged = self.repo.staged_spill_files()
        threshold = self.policy.novelty_threshold
        admitted = leftover = 0
        rejected0 = self._rejected
        for fn in new:
            path = os.path.join(self.queue_dir, fn)
            sub_id = fn[: -len(".npz")]
            if f"{QUEUE_DIR}/{fn}" in staged:
                # re-mark only; bookkeeping from the entry already tracking it
                prev = next((s for s, e in self._entries.items() if e["file"] == fn), None)
                extra: Dict[str, Any] = {}
                if prev is not None:
                    sub_id = prev
                    extra = {k: self._entries[prev].get(k) for k in ("weight", "contributor")}
                weight = extra.get("weight")
            else:
                if self.policy.max_cohort - self.repo.n_staged <= 0:
                    leftover += 1
                    continue
                try:
                    meta = ckpt.flat_row_meta(path)
                except Exception as err:  # torn / garbage enqueue
                    self._reject(fn, f"unreadable ({type(err).__name__}: {err})")
                    continue
                extra = meta.get("extra") or {}
                rider_err = self._rider_error(extra)
                if rider_err is not None:
                    self._reject(fn, rider_err)
                    continue
                sub_id = extra.get("id") or sub_id
                if meta.get("compressed"):
                    verdict = self._compressed_screen(extra, path)
                    if verdict == "defer":
                        leftover += 1
                        continue
                    if verdict is not None:
                        self._reject(fn, verdict)
                        continue
                else:
                    stale = self._staleness(extra)
                    if stale is not None:
                        self._reject(fn, stale)
                        continue
                row = None
                if self.policy.verify_checksums and extra.get("checksum"):
                    try:
                        ok, row = self._checksum_ok(path, meta, extra["checksum"])
                    except Exception as err:  # torn between the peek and the read
                        self._reject(fn, f"unreadable ({type(err).__name__}: {err})")
                        continue
                    if not ok:
                        self._reject(fn, "checksum mismatch")
                        continue
                if threshold is not None and self._novelty_check(
                        fn, path, meta, sub_id, threshold, row=row):
                    continue
                w = extra.get("weight")
                weight = None if w is None else float(w)
                try:
                    self.repo.ingest_spilled(path, weight=weight, meta=meta)
                except ValueError as err:  # FlatSpec mismatch, sharded file
                    if threshold is not None:
                        # a row that never staged must not stay in the window
                        self.repo.cohort_sketch.discard(sub_id)
                        self.repo.save_cohort_sketch()
                    self._reject(fn, str(err))
                    continue
                faults.crash_point("service.post_ingest")
            for other in [s for s, e in self._entries.items()
                          if e["file"] == fn and s != sub_id]:
                del self._entries[other]
            self._entries[sub_id] = {
                "id": sub_id, "file": fn, "state": "admitted",
                "weight": weight,
                "contributor": extra.get("contributor"),
                "admitted_at": time.time(),
                "staged_iteration": self.repo.iteration,
            }
            admitted += 1
            self._failed_cohort_size = None  # new blood: retry a stuck cohort
            if self._cohort_since is None:
                self._cohort_since = time.time()
        if admitted or self._rejected != rejected0:
            self._write_queue_manifest()
        return {"admitted": admitted, "queue_depth": leftover}

    # -- fuse policy ----------------------------------------------------
    def _should_fuse(self) -> bool:
        n = self.repo.n_staged
        if n == 0 or self._failed_cohort_size == n:
            return False
        if n >= self.policy.min_cohort:
            return True
        return (self.policy.max_wait_s > 0 and self._cohort_since is not None
                and time.time() - self._cohort_since >= self.policy.max_wait_s)

    def _note_error(self, err: Exception) -> None:
        self._last_error = f"{type(err).__name__}: {err}"
        self._failed_cohort_size = self.repo.n_staged
        self._recent_errors = (self._recent_errors + [
            {"t": time.time(), "error": self._last_error}])[-ERROR_RING:]
        self._write_queue_manifest()

    # -- the poll cycle -------------------------------------------------
    def run_once(self) -> Dict[str, Any]:
        """One cycle: admit arrivals, dispatch (or finalize) per the cohort
        policy, GC consumed submissions, publish status, append metrics.
        Returns the status it published."""
        self._cycle += 1
        adm = self._admit()
        repo = self.repo
        it_before = repo.iteration
        if self._should_fuse():
            try:
                # finalizes any in-flight fuse, then launches the staged
                # cohort: the card fuses while the next cycles drain the queue
                repo.fuse_pending(wait=False)
                self._cohort_since = None
                self._last_error = None
                faults.crash_point("service.post_dispatch")
            except RuntimeError as err:  # e.g. all rows rejected
                self._note_error(err)
        elif repo.inflight:
            # queue drained: publish the in-flight fuse now
            try:
                repo.flush()
                self._last_error = None
            except RuntimeError as err:
                self._note_error(err)
        if repo.iteration != it_before:
            faults.crash_point("service.post_publish")
            self._gc_consumed()
        st = self.status(admitted=adm["admitted"], queue_depth=adm["queue_depth"])
        ckpt.save_json_atomic(self._status_path, st)
        self._emit_cycle_metrics(st)
        return st

    # -- metrics time series --------------------------------------------
    def _emit_metrics(self, record: Dict[str, Any]) -> None:
        """One record onto the append-only ``metrics.jsonl`` (the daemon is
        the series' single rotator)."""
        ckpt.append_jsonl(self._metrics_path, {"t": time.time(), **record},
                          rotate_bytes=METRICS_ROTATE_BYTES)

    def _emit_cycle_metrics(self, st: Dict[str, Any]) -> None:
        """The per-cycle record, for every cycle that changed anything plus
        the first; idle polls are skipped."""
        mark = (st["iteration"], st["staged"], st["admitted"],
                st["fused_queue_submissions"], st["rejected_total"],
                st["quarantined_total"], st["rollbacks_total"], st["last_error"])
        if mark == self._metrics_mark:
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
            "probe": None,
            "last_error": st["last_error"],
        })

    def serve_forever(self, *, poll_interval: float = 0.02,
                      max_iterations: Optional[int] = None,
                      idle_timeout: Optional[float] = None,
                      max_poll_interval: Optional[float] = None) -> Dict[str, Any]:
        """Run poll cycles until ``request_stop()``, until the published
        iteration reaches ``max_iterations`` (once quiescent), or until
        ``idle_timeout`` seconds pass without progress.  No-progress sleeps
        back off with jitter up to ``max_poll_interval`` (default the larger
        of ``poll_interval`` and 0.25 s); an in-flight fuse pins the sleep
        at ``poll_interval``.  Returns the final status."""
        cap = (max(poll_interval, 0.25) if max_poll_interval is None
               else max(poll_interval, max_poll_interval))
        delay = poll_interval
        last_progress = time.monotonic()
        last_it = self.repo.iteration
        while not self._stop:
            st = self.run_once()
            progress = st["admitted_this_cycle"] or self.repo.iteration != last_it
            last_it = self.repo.iteration
            if progress:
                last_progress = time.monotonic()
                delay = poll_interval
            idle = st["queue_depth"] == 0 and st["staged"] == 0 and not st["inflight"]
            if max_iterations is not None and idle and last_it >= max_iterations:
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
        """Quiesce: finalize any in-flight fuse, GC, publish a final status
        with ``running=False``.  Staged rows stay in the durable manifest."""
        self._stop = True
        try:
            self.repo.flush()
        except RuntimeError as err:
            self._note_error(err)
        self._gc_consumed()
        st = self.status()
        st["running"] = False
        ckpt.save_json_atomic(self._status_path, st)
        return st

    # -- status endpoint ------------------------------------------------
    def status(self, *, admitted: int = 0, queue_depth: Optional[int] = None) -> Dict[str, Any]:
        """The fields contributors and operators poll, persisted atomically
        to ``<root>/service_status.json`` every cycle (the reference's
        keys; the unported features report their idle values)."""
        repo = self.repo
        last = repo.history[-1] if repo.history else None
        return {
            "iteration": repo.iteration,
            "queue_depth": len(self._scan_new()) if queue_depth is None else queue_depth,
            "staged": repo.n_staged,
            "inflight": repo.inflight,
            "admitted": len(self._entries),
            "admitted_this_cycle": admitted,
            "fuses": len(repo.history),
            "fused_contributions": sum(r.n_contributions for r in repo.history),
            "fused_queue_submissions": self._fused_ids,
            "rejected_total": self._rejected,
            "novelty_rejected_total": self._novelty_rejected,
            "novelty_screen": self.policy.novelty_threshold is not None,
            "sketch_entries": (None if repo.cohort_sketch is None
                               else len(repo.cohort_sketch)),
            "recent_rejects": list(self._rejects),
            "gate": False,
            "quarantined_total": self._carried.get("quarantined_total", 0),
            "rollbacks_total": self._carried.get("rollbacks_total", 0),
            "last_gate": None,
            "routing": False,
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
            "serving": None,
            "pid": os.getpid(),
            "running": not self._stop,
            "updated_at": time.time(),
        }
