"""The central Repository (paper Fig. 1): a versioned base-model store that
accepts contributions, screens them (§9), fuses them (§3) and publishes the
next base.  Port of the single-device engines of ``repro.core.repository``:

* the **flat engine** (``average``, ``damped``, ``task_arithmetic``; the
  default for them) — described below;
* the **per-leaf engine** (``fisher``, ``ties``, or ``use_flat=False``) —
  ``upload`` stages the tree as given (with its Fisher), and
  ``fuse_pending`` screens the trees (``screen_contributions``) and fuses
  the accepted ones with ``core.fusion.fuse``, synchronously.  It keeps
  the flat engine's ``download()`` contract, history, snapshots and files,
  but cannot spill and keeps no cohort sketch.

On the flat engine ``upload`` folds each contribution into a flat ``[N]``
staging row at once (the tree is released).  ``fuse_pending`` stacks the
cohort to ``[K, N]`` and screens + fuses it in ONE streaming pass:
``cold_fuse`` emits the fused row and each contributor's ``sq_diff``; the §9
MAD screen runs on those norms, and rejected contributors get weight 0 in a
second pass over the already-staged buffer (the kernel masks zero-weight
rows by a select, so a NaN row adds nothing).  A cohort that holds
delta-compressed queue submissions fuses through ``decode_accum`` instead
(``MixedStage``): their payloads are decoded inside the fuse, never into one
dense row each.

Staging is double-buffered: uploads fill the front side while
``fuse_pending(wait=False)`` runs on the back.  A CUDA launch is already
asynchronous, so the dispatch returns at once; finalize (``flush``, the
next ``fuse_pending``, ``download``) is the only place that waits, on the
``[K]`` ``sq_diff`` copy to the host.

With ``root=`` the repository persists every published base
(``base_iterNNNN.npz`` + ``repository.json``); with ``spill=True`` staged
rows live in the root, listed in ``staging_manifest.json``, and
``Repository.open`` recovers the staged-but-unfused ones after a crash.
``ingest_spilled`` stages a queue file by reference.  The novelty screen's
``CohortSketch`` (``enable_cohort_sketch``) tracks the base's sketch at every
publish.  Every file is the JAX package's format, so a root written by
either package opens in the other.

``spill_workers=N`` moves the row and publish writes onto a thread pool.
The host copy of each row and each base is taken on the calling thread
before the write is queued, so no worker reads a device tensor; a fuse waits
on each spilled row's own write before it opens the file, and ``flush()``
(and ``rollback``, ``compact``, ``contribute_async``) drains the pool and
raises the first write error again.

The lifecycle (paper §8): ``contribute_async`` merges one model at once
(damped, ``α = 1/(1+iteration)``); ``rollback`` restores an earlier base
from the in-memory snapshots or from its retained ``base_iterNNNN.npz``;
``compact`` deletes superseded bases and unreferenced archived rows;
``add_publish_listener`` subscribes to every base movement.

``fuse_pending(buffer=)`` fuses an explicit ``[K, N]`` operand the caller
owns (never written to), with ``alpha=``/``screen=``/``op=`` overrides.
``RepositoryFamily`` keeps named members under one root (``main`` is the
root itself, the others ``families/<name>/``): ``spawn`` seeds a member
from another's base, ``cross_fuse`` moves every member toward the mean of
the pre-cross bases through that explicit-operand fuse.

The published base (``download()``) is a tree of views into the fused row,
which is also the ``base`` operand of the next fuse: callers must not update
it in place (``train.finetune`` clones what it trains).

``mesh=`` (a ``launch.mesh.Mesh``) with optional ``mesh_axes=`` (default
every axis) distributes the flat engine over one process's devices, as the
reference's ``Repository(mesh=)`` does under JAX's single-controller mesh.
The base and every staged row are laid out block-cyclically
(``ShardedFlatSpec``) as S ``[shard_len]`` slices, slice ``s`` on its
shard's device (``launch.sharding.flat_row_sharding``); a staged cohort is
one contiguous ``[K, shard_len]`` stack per shard, so no device holds more
than ``K · shard_len`` staged elements.  A fuse runs ``cold_fuse`` (or
``decode_accum`` for the compressed rows) on every shard and completes the
``sq_diff`` partials with one all-reduce; the sketch does the same with
``row_sketch``.  The published row is gathered to ``[N]`` on the mesh's
first device (``self.device``), where ``download()``, ``flat_base()``, the
publish listeners and the files read it.  With ``spill=True`` each row is
spilled as its per-shard slices (``save_flat_shards``) and reloads shard by
shard; a root reopened under another mesh, or none, reassembles the row on
the host.  A mesh needs the flat engine, as in the reference.
"""
from __future__ import annotations

import json
import os
import re
import threading
import time
import warnings
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch.checkpoint import io as ckpt
from repro_torch.core import fusion
from repro_torch.core.validation import (ScreenReport, norms_from_sq, screen_contributions,
                                         screen_norms)
from repro_torch.kernels import ops
from repro_torch.launch import mesh as M
from repro_torch.launch import sharding as SH
from repro_torch.utils import faults
from repro_torch.utils.device import resolve_device
from repro_torch.utils.flat import (SKETCH_BUCKETS, BufferPair, CohortSketch, FlatSpec,
                                    ShardedFlatSpec, StagedBuffer, StagingSide, delta_decode,
                                    delta_decode_sharded, delta_entries, sketch_apply_delta)
from repro_torch.utils.pytree import tree_device, tree_map

# operators the flat engine covers; the others (fisher, ties) fuse per leaf
FLAT_OPS = ("average", "damped", "task_arithmetic")

MANIFEST = "staging_manifest.json"
SKETCH_FILE = "cohort_sketch.json"

# on-disk artifact names in the root (``compact`` walks these)
_BASE_RE = re.compile(r"^base_iter(\d{4,})\.npz$")
_ROW_RE = re.compile(r"^iter\d{4,}_contrib\d{3,}\.npz$")


@dataclass
class FusionRecord:
    iteration: int
    n_contributions: int
    n_accepted: int
    op: str
    diff_norms: List[float]
    wall_time: float


@dataclass
class PendingFusion:
    """An in-flight fuse: launched on the device, not yet screened or
    published.  ``record`` is set once the publish happened."""

    stage: Optional[Any]          # StagedBuffer or MixedStage, kept for a re-pass
    fused: Any                    # [N], or S per-shard slices on a mesh
    sq: torch.Tensor
    weights: torch.Tensor
    k: int
    t0: float
    record: Optional[FusionRecord] = None
    # overrides of fuse_pending(buffer=, alpha=, screen=, op=); None defers
    # to the repository's configuration
    alpha: Optional[float] = None
    use_screen: Optional[bool] = None
    op: Optional[str] = None

    @property
    def done(self) -> bool:
        return self.record is not None


@dataclass
class MixedStage:
    """Fuse operand of a cohort that mixes dense rows (cohort positions
    ``dense_pos``) with compressed submissions (``comp_pos``), which ride
    as their stacked codec arrays and are decoded inside the fuse.  On a
    mesh each codec array is a list of S per-shard stacks, one a device."""

    dense: Optional[StagedBuffer]
    indices: Any            # [C, nb, kb] int16 (S of them on a mesh)
    values: Any             # [C, nb, kb] int8
    scales: Any             # [C, nb] f32
    block: int
    dense_pos: np.ndarray
    comp_pos: np.ndarray

    @property
    def k(self) -> int:
        return len(self.dense_pos) + len(self.comp_pos)


def _json_default(o):
    if isinstance(o, (np.ndarray, np.generic)):
        return np.asarray(o).tolist()
    if isinstance(o, torch.Tensor):
        return o.tolist()
    return str(o)


def _sync(t) -> None:
    """Wait for the work writing ``t`` (a tensor, or per-shard slices)."""
    for x in (t if isinstance(t, (list, tuple)) else [t]):
        if x.is_cuda:
            torch.cuda.current_stream(x.device).synchronize()


class Repository:
    def __init__(
        self,
        base_params,
        *,
        fusion_op: str = "average",
        fusion_kwargs: Optional[Dict[str, Any]] = None,
        screen: bool = True,
        mad_threshold: float = 5.0,
        root: Optional[str] = None,
        keep_history: bool = False,
        use_flat: Optional[bool] = None,
        spill: bool = False,
        spill_workers: int = 0,
        mesh: Optional[Any] = None,
        mesh_axes: Optional[Any] = None,
    ):
        if use_flat is None:
            use_flat = fusion_op in FLAT_OPS
        elif use_flat and fusion_op not in FLAT_OPS:
            raise ValueError(f"flat engine does not cover fusion_op={fusion_op!r}")
        if mesh is not None and not use_flat:
            raise ValueError("mesh= requires the flat engine "
                             f"(fusion_op={fusion_op!r}, use_flat={use_flat})")
        self.mesh = mesh
        if mesh is not None:
            axes = SH.norm_axes(mesh.axis_names if mesh_axes is None else mesh_axes)
            missing = [a for a in axes if a not in mesh.axis_names]
            if missing:
                raise ValueError(f"mesh_axes {missing} not in mesh {mesh.axis_names}")
            self.mesh_axes = axes
            self._n_shards = SH.axes_extent(mesh, axes)
        else:
            self.mesh_axes = ()
            self._n_shards = 1
        if spill and not root:
            raise ValueError("spill=True requires an on-disk root")
        if spill and not use_flat:
            raise ValueError("spill=True requires the flat engine "
                             f"(fusion_op={fusion_op!r}, use_flat={use_flat})")
        self.use_flat = use_flat
        self.fusion_op = fusion_op
        self.fusion_kwargs = dict(fusion_kwargs or {})
        self.screen = screen
        self.mad_threshold = mad_threshold
        self.keep_history = keep_history
        self.root = root
        self.spill = spill
        self.iteration = 0
        self.history: List[FusionRecord] = []
        self._snapshots: List[Any] = []
        self._spec = FlatSpec.from_tree(base_params)
        self._sspec = (ShardedFlatSpec.from_spec(self._spec, self._n_shards)
                       if mesh is not None else None)
        # on a mesh the base's per-shard slices (the fuse operand) beside
        # its [N] row on the mesh's first device; None otherwise
        self._base_shards: Optional[List[torch.Tensor]] = None
        row = self._spec.flatten(base_params)
        if mesh is not None:
            row = row.to(SH.flat_row_sharding(mesh, self.mesh_axes)[0])
        self._install_row(row)
        self._buffers = BufferPair()
        self._inflight: Optional[PendingFusion] = None
        self._persisted_iteration = -1
        # the spill executor (spill_workers > 0): row and publish writes
        # leave the upload path; _row_futures lets a fuse wait on exactly
        # the rows it reads
        self._spill_pool = (ThreadPoolExecutor(max_workers=spill_workers,
                                               thread_name_prefix="repo-spill")
                            if spill and spill_workers > 0 else None)
        self._spill_futures: List[Future] = []
        self._row_futures: Dict[str, Future] = {}
        # guards the staging sides' manifests (workers append to them) and
        # the manifest file; the publish lock orders base + repository.json
        self._manifest_lock = threading.Lock()
        self._publish_lock = threading.Lock()
        # fn(iteration, base, flat) after every base movement
        self._publish_listeners: List[Any] = []
        # the novelty screen's state; None until enable_cohort_sketch
        self.cohort_sketch: Optional[CohortSketch] = None
        # opaque repository.json keys (a family manifest) carried verbatim
        self.extra_meta: Dict[str, Any] = {}
        # the member name under a RepositoryFamily (None outside one)
        self.family_name: Optional[str] = None
        if root:
            os.makedirs(root, exist_ok=True)
            self._persist_base()

    @property
    def device(self) -> torch.device:
        """Where the published ``[N]`` row lives (the mesh's first device)."""
        return self._base_flat.device

    # -- the mesh layout ---------------------------------------------------
    def _stage_row(self, row: torch.Tensor) -> List[torch.Tensor]:
        """An ``[N]`` row -> its block-cyclic slices, each on its shard's
        device."""
        return SH.place_shards(self._sspec.shard_slices(row), self.mesh, self.mesh_axes)

    def _restage(self, row: torch.Tensor):
        """A loaded ``[N]`` row in the repository's staged form."""
        return self._stage_row(row) if self.mesh is not None else row

    def _install_row(self, row: torch.Tensor) -> None:
        """Make ``row`` (``[N]``, on ``self.device``) the base: its tree of
        views and, on a mesh, its per-shard slices."""
        self._base_flat = row
        self._base = self._spec.unflatten(row)
        if self.mesh is not None:
            self._base_shards = self._stage_row(row)

    def _staged_base(self):
        """The base in the fuse's operand form."""
        return self._base_shards if self.mesh is not None else self._base_flat

    # -- staging introspection (service loop) --------------------------
    @property
    def n_staged(self) -> int:
        """Rows staged in the front buffer (not yet part of any fuse)."""
        return len(self._buffers.front.rows)

    @property
    def inflight(self) -> bool:
        """True while a dispatched fuse awaits finalize/publish."""
        return self._inflight is not None

    def staged_spill_files(self) -> set:
        """Root-relative names of every manifest-tracked staged row, front
        and in flight: exactly what a crash right now would recover."""
        with self._manifest_lock:
            return {e["file"] for e in self._buffers.manifest_entries()}

    def _staging_iteration(self) -> int:
        """The iteration newly staged rows fuse into (one ahead while a fuse
        is in flight)."""
        return self.iteration + (1 if self._inflight is not None else 0)

    def _contrib_path(self, idx: int) -> str:
        return os.path.join(self.root,
                            f"iter{self._staging_iteration():04d}_contrib{idx:03d}.npz")

    # -- spill manifest --------------------------------------------------
    def _manifest_path(self) -> str:
        return os.path.join(self.root, MANIFEST)

    def _write_manifest(self) -> None:
        """Persist the staged-but-unfused rows (back + front); the caller
        holds the manifest lock.  Called with the row file already on disk,
        so a crash in between loses at most the newest row, never records a
        row that does not exist."""
        ckpt.save_json_atomic(self._manifest_path(), {
            "version": 1, "entries": self._buffers.manifest_entries()})

    def _spill_row(self, row: torch.Tensor, idx: int, weight) -> str:
        """Write one staged row to the root, then append it to the manifest:
        at once, or on the spill executor with ``spill_workers > 0``."""
        path = self._contrib_path(idx)
        side = self._buffers.front
        spec = self._spec
        entry = {
            "file": os.path.basename(path),
            "idx": idx,
            # the publish this row fuses into; see _recover_staged
            "staged_at": self._staging_iteration(),
            "weight": None if weight is None else float(weight),
            "dtype": spec.dtype,
            "size": spec.size,
            "sharded": self.mesh is not None,
        }
        sspec = self._sspec
        if sspec is not None:
            entry["shard_spec"] = sspec.to_json()
        host = row.detach().cpu()  # on this thread: no worker reads a device tensor

        def write():
            if sspec is not None:
                ckpt.save_flat_shards(path, sspec.shard_slices(host), spec, sspec)
            else:
                ckpt.save_flat(path, host, spec)
            with self._manifest_lock:
                side.manifest.append(entry)
                self._write_manifest()

        if self._spill_pool is None:
            write()
        else:
            fut = self._spill_pool.submit(write)
            self._spill_futures.append(fut)
            self._row_futures[path] = fut
        return path

    def _await_row(self, p) -> None:
        """Wait for (and surface the error of) the spill write of staged
        entry ``p``; a no-op for rows written synchronously."""
        fut = self._row_futures.pop(p, None) if isinstance(p, str) else None
        if fut is not None:
            fut.result()

    def _drain_spill(self) -> None:
        """Wait for every queued row and publish write; raise the first
        failure again, so a lost row is never fused over in silence."""
        futures, self._spill_futures = self._spill_futures, []
        self._row_futures.clear()
        first = None
        for f in futures:
            try:
                f.result()
            except Exception as err:  # every write settles before the raise
                first = first if first is not None else err
        if first is not None:
            raise first

    # -- contributor-facing API -----------------------------------------
    def download(self):
        """Contributor pulls the current base model (Fig. 1, step 1): a
        tree of views into the published flat row, read-only by contract.
        Finalizes an in-flight fuse first."""
        self._finalize_inflight()
        return self._base

    def upload(self, params, fisher=None, weight: Optional[float] = None) -> int:
        """Contributor pushes a finetuned body (Fig. 1, step 3), optionally
        with its diagonal Fisher (for ``fusion_op="fisher"``) and a
        contribution weight.  Returns the ticket id.  The flat engine folds
        the tree into a staging row at once; with ``spill=True`` the row
        goes to the root (atomic write + manifest append) and only its path
        stays in memory.  The per-leaf engine stages the tree and its Fisher
        as given (not copied: callers must not update them in place)."""
        if tree_device(params) != self.device:
            raise ValueError(f"upload on {tree_device(params)}; the repository lives on "
                             f"{self.device}")
        side = self._buffers.front
        idx = len(side.rows)
        if not self.use_flat:
            side.rows.append(params)
            if self.root:
                ckpt.save(self._contrib_path(idx), params)
        elif self.spill:
            side.rows.append(self._spill_row(self._spec.flatten(params), idx, weight))
        else:
            row = self._spec.flatten(params)
            if self.root:  # the archived row stays the portable [N] form
                ckpt.save_flat(self._contrib_path(idx), row, self._spec)
            side.rows.append(self._restage(row))
        side.fishers.append(fisher)
        side.weights.append(weight)
        return idx

    def ingest_spilled(self, path: str, *, weight: Optional[float] = None,
                       meta: Optional[Dict[str, Any]] = None) -> int:
        """Stage an on-disk flat row (a queue submission) by reference: its
        root-relative path enters the staging manifest atomically, with the
        same exactly-once recovery as a spilled ``upload``.  The recorded
        FlatSpec must match the base; torn or mismatched files raise
        ``ValueError`` without touching the manifest.  A per-shard file of
        any layout stages (its layout is checked where it loads)."""
        if not self.spill:
            raise ValueError("ingest_spilled requires spill=True — the staging "
                             "manifest is what makes queue ingest crash-safe")
        path = os.path.abspath(path)
        rel = os.path.relpath(path, os.path.abspath(self.root))
        if rel.startswith(".."):
            raise ValueError(f"ingested rows must live under root= ({path} is outside "
                             f"{self.root})")
        if meta is None:
            meta = ckpt.flat_row_meta(path)
        if meta["dtype"] != self._spec.dtype or int(meta["size"]) != self._spec.size:
            raise ValueError(
                f"row {os.path.basename(path)} has FlatSpec(dtype={meta['dtype']}, "
                f"N={meta['size']}) but the repository base is (dtype={self._spec.dtype}, "
                f"N={self._spec.size}) — refusing to ingest a mismatched row")
        side = self._buffers.front
        idx = len(side.rows)
        entry = {
            "file": rel.replace(os.sep, "/"),
            "idx": idx,
            "staged_at": self._staging_iteration(),
            "weight": None if weight is None else float(weight),
            "dtype": self._spec.dtype,
            "size": self._spec.size,
            "sharded": bool(meta["sharded"]),
        }
        if meta.get("shard_spec"):
            entry["shard_spec"] = meta["shard_spec"]
        if meta.get("compressed"):
            # decoded only at dispatch, against the vintage declared here
            entry["compressed"] = True
            entry["codec"] = meta.get("delta_spec")
            extra = meta.get("extra") or {}
            bi = extra.get("base_iteration")
            if bi is not None:
                entry["base_iteration"] = int(bi)
            # the family-vintage backstop: a delta decodes only against the
            # member it was encoded from, for direct callers too
            if self.family_name is not None:
                declared = str(extra.get("family") or "main")
                if declared != self.family_name:
                    raise ValueError(
                        f"stale: delta encoded against family {declared!r}, but this member "
                        f"is {self.family_name!r} — refusing to decode against the wrong base")
                entry["family"] = declared
        side.rows.append(path)
        side.fishers.append(None)
        side.weights.append(weight)
        with self._manifest_lock:
            side.manifest.append(entry)
            self._write_manifest()
        return idx

    # -- novelty admission sketch ----------------------------------------
    def _sketch_path(self) -> str:
        return os.path.join(self.root, SKETCH_FILE)

    def _n_buckets(self) -> int:
        return self.cohort_sketch.n_buckets if self.cohort_sketch is not None else SKETCH_BUCKETS

    def enable_cohort_sketch(self, *, window: int = 32,
                             n_buckets: int = SKETCH_BUCKETS) -> CohortSketch:
        """Create (or adopt the recovered) ``CohortSketch`` the novelty
        screen queries, sketch the current base and persist the state.
        Requires the flat engine."""
        if not self.use_flat:
            raise ValueError("cohort sketch requires the flat engine — the row sketch is "
                             "a statistic over flat [N] rows")
        sk = self.cohort_sketch
        if sk is not None and (sk.size != self._spec.size or sk.n_buckets != n_buckets):
            warnings.warn(
                f"cohort sketch (size={sk.size}, n_buckets={sk.n_buckets}) does not match "
                f"the requested layout (size={self._spec.size}, n_buckets={n_buckets}) — "
                "rebuilding; the screen history restarts empty")
            sk = None
        if sk is None:
            sk = CohortSketch(self._spec.size, n_buckets, window)
        else:
            sk.window = int(window)
            del sk.entries[: -sk.window]
        self.cohort_sketch = sk
        self._refresh_base_sketch()
        return sk

    def save_cohort_sketch(self) -> None:
        """Persist the cohort sketch atomically (no-op without a root or
        before ``enable_cohort_sketch``)."""
        if self.cohort_sketch is not None and self.root:
            ckpt.save_json_atomic(self._sketch_path(), self.cohort_sketch.to_json(),
                                  indent=None)

    def _sketch_of_staged(self, row) -> np.ndarray:
        """Sketch a staged row to host f32: an ``[N]`` row in one
        ``row_sketch``, per-shard slices shard by shard with one
        all-reduce (the kernels on the card)."""
        if isinstance(row, (list, tuple)):
            out = ops.row_sketch_sharded(row, mesh=self.mesh, axes=self.mesh_axes,
                                         block=self._sspec.block, n_buckets=self._n_buckets())
        else:
            out = ops.row_sketch(row, self._n_buckets())
        return out.cpu().numpy()

    def _refresh_base_sketch(self) -> None:
        """Recompute the base's sketch (the screen's distance normalizer)
        and persist it; runs at every publish.  Advisory state: a lost write
        costs one stale-scale decision, never a double fuse.  No-op on the
        per-leaf engine (a recovered sketch stays as it was)."""
        if self.cohort_sketch is None or not self.use_flat:
            return
        self.cohort_sketch.set_base(self._sketch_of_staged(self._staged_base()),
                                    iteration=self.iteration)
        self.save_cohort_sketch()

    def sketch_row_file(self, path: str, *, meta: Optional[Dict[str, Any]] = None
                        ) -> np.ndarray:
        """Content sketch of an on-disk flat row (a queue submission) in one
        read: a per-shard file of the mesh's layout shard by shard with one
        all-reduce (its ``[N]`` row never forms), anything else as an
        ``[N]`` row on the repository's device.  Raises on torn or
        unreadable files; callers reject like any other unreadable file."""
        if meta is None:
            meta = ckpt.flat_row_meta(path)
        if meta.get("compressed"):
            return self.sketch_delta_file(path)
        if meta.get("sharded"):
            return self._sketch_of_staged(self._load_staged_row(path))
        row, _ = ckpt.load_flat(path)
        return self._sketch_of_staged(row.to(self.device))

    def sketch_delta_file(self, path: str, *,
                          meta: Optional[Dict[str, Any]] = None) -> np.ndarray:
        """Content sketch of a compressed submission without its dense row:
        the base's sketch corrected bucket-wise from the sparse delta
        (``sketch_apply_delta``), reading base values only at the delta's
        own positions."""
        del meta  # the payload load re-reads the header regardless
        payloads, dmeta = ckpt.load_flat_delta(path)
        if self.cohort_sketch is not None and self.cohort_sketch.base is not None:
            base_sk = np.asarray(self.cohort_sketch.base, np.float64)
        else:
            base_sk = self._sketch_of_staged(self._staged_base()).astype(np.float64)
        if dmeta["delta_spec"].get("sharded"):
            ss = ShardedFlatSpec.from_json(dmeta["shard_spec"])
            gis, dvs = [], []
            for s, p in enumerate(payloads):
                li, d = delta_entries(p)
                g = ss.global_of(s, li)
                keep = g < self._spec.size  # drop the block grid's padding
                gis.append(g[keep])
                dvs.append(d[keep])
            gi, dv = np.concatenate(gis), np.concatenate(dvs)
        else:
            gi, dv = delta_entries(payloads[0])
        at = torch.from_numpy(gi).to(self.device)
        base_at = self._base_flat[at].float().cpu().numpy()
        sk = sketch_apply_delta(base_sk, gi, dv, base_at, n_buckets=self._n_buckets())
        return np.asarray(sk, np.float32)

    def flat_base_host(self) -> torch.Tensor:
        """The current (published) base as a host ``[N]`` row in its
        storage dtype."""
        return self._base_flat.cpu()

    def flat_base(self) -> torch.Tensor:
        """The current (published) base as its ``[N]`` row on the
        repository's device; read-only by contract, like ``download()``."""
        return self._base_flat

    # -- publish subscription ----------------------------------------------
    def add_publish_listener(self, fn) -> None:
        """Register ``fn(iteration, base, flat)`` to run after every base
        movement: a cohort publish (either engine), ``contribute_async`` and
        ``rollback`` (where ``iteration`` moves backwards).  It runs on the
        thread that published, after the iteration bump, with the published
        tree and its flat row.  The port always keeps the flat row, so
        ``flat`` is never None (the reference passes None after a rollback).
        Listeners must be cheap and must not raise."""
        self._publish_listeners.append(fn)

    def _notify_publish(self) -> None:
        for fn in list(self._publish_listeners):
            fn(self.iteration, self._base, self._base_flat)

    # -- the lifecycle (paper §8) ----------------------------------------------
    def contribute_async(self, params, *, alpha: Optional[float] = None) -> FusionRecord:
        """Merge ONE finetuned model into the base at once, without a
        cohort: θ ← θ + α·(θ_c − θ), α = 1/(1 + iteration) unless given.
        The flat engine makes one ``cold_fuse`` pass over a ``[1, N]``
        stage, which yields the merged row and the screen's norm; a rejected
        contribution raises and leaves every bit of state as it was."""
        self.flush()  # quiesce: this publish must not race queued writes
        if tree_device(params) != self.device:
            raise ValueError(f"contribution on {tree_device(params)}; the repository lives "
                             f"on {self.device}")
        a = alpha if alpha is not None else 1.0 / (1.0 + self.iteration)
        t0 = time.time()
        if self.use_flat:
            row = self._spec.flatten(params)
            stage = ([r[None] for r in self._stage_row(row)] if self.mesh is not None
                     else row[None])
            fused, sq = self._fuse_flat(
                stage, torch.ones((1,), dtype=torch.float32, device=self.device), a)
            if self.screen:
                report = screen_norms(norms_from_sq(sq), mad_threshold=self.mad_threshold)
                if not report.accepted:
                    raise RuntimeError(f"async contribution rejected: {report.reasons}")
            _sync(fused)
        else:
            if self.screen:
                report = screen_contributions(self._base, [params],
                                              mad_threshold=self.mad_threshold)
                if not report.accepted:
                    raise RuntimeError(f"async contribution rejected: {report.reasons}")
            fused = self._spec.flatten(fusion.damped(self._base, [params], alpha=a))
        rec = FusionRecord(iteration=self.iteration, n_contributions=1, n_accepted=1,
                           op=f"async-damped({a:.3f})", diff_norms=[],
                           wall_time=time.time() - t0)
        self.history.append(rec)
        self._publish(fused)
        self.iteration += 1
        self._refresh_front_staging()
        if self.root:
            self._persist_base()
            if self.spill or os.path.exists(self._manifest_path()):
                with self._manifest_lock:
                    self._write_manifest()
        self._refresh_base_sketch()
        self._notify_publish()
        return rec

    def rollback(self, to_iteration: int, *, keep_staged: bool = False) -> None:
        """Back out harmful publishes (paper §8): restore the base of
        ``to_iteration`` from the in-memory ``keep_history`` snapshot, else
        from its retained ``base_iterNNNN.npz``; missing both raises with
        no state touched.  ``keep_staged=True`` keeps the staged front
        cohort (re-stamped to the rolled-back staging iteration), otherwise
        it is dropped.  On disk, the ``repository.json`` rewrite is the
        commit point; the ``repo.mid_rollback`` seam follows it."""
        self.flush()  # quiesce: queued manifest and publish writes settle
        if not (0 <= to_iteration <= self.iteration):
            raise ValueError(f"cannot roll back to iteration {to_iteration} from "
                             f"{self.iteration}")
        if self.keep_history and to_iteration < len(self._snapshots):
            base = self._snapshots[to_iteration]
        elif self.root is not None:
            path = os.path.join(self.root, f"base_iter{to_iteration:04d}.npz")
            if not os.path.exists(path):
                raise ValueError(
                    f"no snapshot for iteration {to_iteration}: not in memory "
                    f"(keep_history={self.keep_history}) and {os.path.basename(path)} is "
                    "not on disk — was it compacted away? (compact keep_bases must cover "
                    "the rollback depth)")
            base = ckpt.load(path, device=self.device)
            rspec = FlatSpec.from_tree(base)
            if rspec.dtype != self._spec.dtype or rspec.size != self._spec.size:
                raise ValueError(
                    f"{os.path.basename(path)} loads as FlatSpec(dtype={rspec.dtype}, "
                    f"N={rspec.size}) but the repository base is (dtype={self._spec.dtype}, "
                    f"N={self._spec.size}) — refusing to roll back onto a mismatched base")
        elif not self.keep_history:
            raise RuntimeError("rollback requires keep_history=True or an on-disk root")
        else:
            raise ValueError(f"no snapshot for iteration {to_iteration}")
        self._install_row(self._spec.flatten(base))
        self._snapshots = self._snapshots[:to_iteration]
        self.history = self.history[:to_iteration]
        self.iteration = to_iteration
        # the publish guard follows the regression, or later (smaller-
        # iteration) publishes would be skipped as stale
        self._persisted_iteration = min(self._persisted_iteration, to_iteration)
        if keep_staged:
            self._refresh_front_staging()
        else:
            with self._manifest_lock:
                self._buffers = BufferPair()
        if self.root:
            self._persist_base()  # the commit point
            faults.crash_point("repo.mid_rollback")
            if self.spill:
                with self._manifest_lock:
                    self._write_manifest()
        self._refresh_base_sketch()
        self._notify_publish()

    def compact(self, *, keep_bases: int = 2) -> Dict[str, int]:
        """Reclaim the root: delete ``base_iterNNNN.npz`` beyond the newest
        ``keep_bases`` (the persisted current base is always kept) and the
        archived ``iterNNNN_contribMMM.npz`` rows no manifest entry
        references.  Only unreferenced files are deleted, so a crash at any
        point leaves a root that opens.  ``queue/`` and ``quarantine/`` are
        never touched.  Quiesces first; returns the deletion counts."""
        if not self.root:
            raise ValueError("compact requires an on-disk root")
        if keep_bases < 1:
            raise ValueError(f"keep_bases must be >= 1, got {keep_bases}")
        self.flush()
        with self._manifest_lock:
            referenced = {os.path.normpath(e["file"])
                          for e in self._buffers.manifest_entries()}
        bases, rows = [], []
        for name in os.listdir(self.root):
            m = _BASE_RE.match(name)
            if m:
                bases.append((int(m.group(1)), name))
            elif _ROW_RE.match(name) and os.path.normpath(name) not in referenced:
                rows.append(name)
        keep = {it for it, _ in sorted(bases)[-keep_bases:]}
        keep.add(self._persisted_iteration)  # open() loads exactly this one
        n_bases = 0
        for it, name in bases:
            if it not in keep:
                os.remove(os.path.join(self.root, name))
                n_bases += 1
        for name in rows:
            os.remove(os.path.join(self.root, name))
        return {"bases_removed": n_bases, "rows_removed": len(rows)}

    # -- fuse -----------------------------------------------------------
    def fuse_pending(self, buffer=None, *, wait: bool = True, alpha: Optional[float] = None,
                     screen: Optional[bool] = None, op: Optional[str] = None
                     ) -> Union[FusionRecord, PendingFusion]:
        """Screen + fuse the staged cohort into the new base (Fig. 1,
        step 4).  Finalizes any in-flight fuse, swaps the front staging
        buffer to the back and launches the fuse.  ``wait=False`` returns a
        ``PendingFusion`` at once; ``flush()`` (or the next
        ``fuse_pending``/``download``) screens and publishes it.  On the
        per-leaf engine ``wait`` is ignored (the fuse is synchronous).

        ``buffer=`` fuses an explicit ``[K, N]`` operand instead (a
        ``StagedBuffer`` or a tensor of the base's dtype and device; on a
        mesh S per-shard ``[K, shard_len]`` stacks or a ``[K, S,
        shard_len]`` tensor, split by shard), leaving the staging buffers
        alone; ``alpha=`` overrides the step size,
        ``screen=`` the §9 screen and ``op=`` the record's label (the
        family cross-fuse uses all three).  The overrides need
        ``buffer=``."""
        self._finalize_inflight()
        if buffer is not None:
            return self._fuse_buffer(buffer, wait=wait, alpha=alpha, screen=screen, op=op)
        if alpha is not None or screen is not None or op is not None:
            raise ValueError("alpha=/screen=/op= overrides require buffer=")
        if not self._buffers.front.rows:
            raise RuntimeError("no contributions to fuse")
        t0 = time.time()
        with self._manifest_lock:  # workers append to both sides' manifests
            back = self._buffers.swap()
        if not self.use_flat:
            self._mark_back_fusing()
            try:
                rec = self._fuse_pending_pytree(t0, back)
            except Exception:
                self._restore_back()
                raise
            self._retire_back()
            self._after_publish(rec)
            return rec
        try:
            pf = self._dispatch_flat(back, t0)
        except Exception:
            self._restore_back()
            raise
        self._inflight = pf
        if wait:
            return self._finalize_inflight()
        return pf

    def _fuse_buffer(self, buffer, *, wait: bool, alpha: Optional[float],
                     screen: Optional[bool], op: Optional[str]
                     ) -> Union[FusionRecord, PendingFusion]:
        """Fuse an explicit operand (``fuse_pending(buffer=...)``).  The
        operand belongs to the caller: the kernel reads it and writes only
        a fresh output row."""
        if not self.use_flat:
            raise ValueError("fuse_pending(buffer=...) requires the flat engine")
        if not isinstance(buffer, StagedBuffer):
            buffer = StagedBuffer(buffer if isinstance(buffer, (list, tuple))
                                  else torch.as_tensor(buffer))
        data = buffer.data
        if self.mesh is not None:
            S, L = self._sspec.n_shards, self._sspec.shard_len
            shapes = ([tuple(d.shape[1:]) for d in data] if isinstance(data, (list, tuple))
                      else [tuple(data.shape[1:])])
            if shapes not in ([(S, L)], [(L,)] * S):
                raise ValueError(f"staged buffer shapes {shapes} do not match the sharded "
                                 f"layout [K, {S}, {L}] (or {S} x [K, {L}])")
            buffer = StagedBuffer(tuple(SH.place_shards(data, self.mesh, self.mesh_axes, 1)))
        elif data.dim() != 2 or data.shape[1] != self._spec.size:
            raise ValueError(f"staged buffer shape {tuple(data.shape)} does not match the "
                             f"flat layout [K, {self._spec.size}]")
        t0 = time.time()
        K = buffer.k
        w = self._cohort_weights(K, [])
        use_screen = self.screen if screen is None else bool(screen)
        a = self._flat_alpha(K) if alpha is None else float(alpha)
        fused, sq = self._fuse_flat(buffer, w, a)
        pf = PendingFusion(stage=buffer if use_screen else None, fused=fused, sq=sq,
                           weights=w, k=K, t0=t0,
                           alpha=None if alpha is None else float(alpha),
                           use_screen=None if screen is None else use_screen, op=op)
        if not wait:
            self._inflight = pf
            return pf
        rec = self._finalize_flat(pf)
        self._after_publish(rec)
        return rec

    def flush(self) -> Optional[FusionRecord]:
        """Quiesce: finalize the in-flight fuse, if any, and drain every
        queued spill and publish write (raising the first write error).
        Returns the finalized record (None when nothing was in flight)."""
        rec = self._finalize_inflight()
        self._drain_spill()
        return rec

    def snapshot(self, iteration: int):
        """The base published before fuse ``iteration`` (``keep_history``)."""
        return self._snapshots[iteration]

    def _finalize_inflight(self) -> Optional[FusionRecord]:
        pf, self._inflight = self._inflight, None
        if pf is None:
            return None
        try:
            rec = self._finalize_flat(pf)
        except Exception:
            # not published: the cohort returns to the front, to be retried
            self._restore_back()
            raise
        self._retire_back()
        self._after_publish(rec)
        return rec

    def _retire_back(self) -> None:
        """Drop the consumed back cohort.  Its manifest entries are rewritten
        away only after the new base is durable (``_after_publish``)."""
        with self._manifest_lock:
            self._buffers.retire_back()

    def _load_staged_row(self, p):
        """A staged entry in the staged form (an ``[N]`` row on the
        repository's device, or per-shard slices on a mesh): in-memory rows
        pass through, spilled ones load from disk.  A per-shard file of the
        mesh's layout loads shard by shard onto the shards' devices; any
        other layout is put back together on the host (counted as an
        all-gather) and restaged.  A compressed file outside a fuse decodes
        against the current base."""
        if not isinstance(p, str):
            return p
        self._await_row(p)
        meta = ckpt.flat_row_meta(p)
        if meta.get("compressed"):
            payloads, meta = ckpt.load_flat_delta(p)
            return self._restage(self._decode_compressed_dense(payloads, meta))
        if meta.get("sharded"):
            with ckpt.FlatShardReader(p) as r:
                if self.mesh is not None and r.sspec == self._sspec:
                    return SH.stage_row_from_shards(self.mesh, self.mesh_axes,
                                                    r.sspec.n_shards, r.sspec.shard_len,
                                                    r.shard)
                row = r.full_row()
            M.count_collective("all_gather")
            return self._restage(row.to(self.device))
        row, _ = ckpt.load_flat(p)
        return self._restage(row.to(self.device))

    def _dispatch_flat(self, back: StagingSide, t0: float) -> PendingFusion:
        """Launch pass 1 (fused + sq_diff in one read of the stage) without
        waiting for it."""
        K = len(back.rows)
        stage = self._stage_cohort(back)
        w = self._cohort_weights(K, back.weights)
        fused, sq = self._fuse_flat(stage, w, self._flat_alpha(K))
        self._mark_back_fusing()
        return PendingFusion(stage=stage if self.screen else None,
                             fused=fused, sq=sq, weights=w, k=K, t0=t0)

    def _stage_cohort(self, back: StagingSide):
        """All-dense cohorts stack into a ``StagedBuffer``; any compressed
        submission among the rows makes a ``MixedStage``.  Every spilled
        row's write is waited on before any of its files is opened."""
        for p in back.rows:
            self._await_row(p)
        if any(isinstance(p, str) and ckpt.is_flat_compressed(p) for p in back.rows):
            return self._stage_mixed(back)
        return StagedBuffer.from_rows([self._load_staged_row(p) for p in back.rows])

    def _stage_mixed(self, back: StagingSide):
        """Split the back cohort into dense rows and compressed payload
        stacks.  A compressed row rides sparse only when its declared
        vintage is the current iteration and its codec geometry matches the
        cohort's; otherwise it decodes dense against the right base."""
        entries = {e.get("file"): e for e in back.manifest}
        root = os.path.abspath(self.root) if self.root else None
        dense_rows: List[Any] = []
        dense_pos: List[int] = []
        payload_sets: List[list] = []
        comp_pos: List[int] = []
        geom = None
        for i, p in enumerate(back.rows):
            if not (isinstance(p, str) and ckpt.is_flat_compressed(p)):
                dense_rows.append(self._load_staged_row(p))
                dense_pos.append(i)
                continue
            payloads, meta = ckpt.load_flat_delta(p)
            rel = os.path.relpath(p, root).replace(os.sep, "/") if root else None
            declared = entries.get(rel, {}).get(
                "base_iteration", (meta.get("extra") or {}).get("base_iteration"))
            if declared is not None and int(declared) != self.iteration:
                dense_rows.append(self._restage(
                    self._decode_vs_declared(payloads, meta, int(declared))))
                dense_pos.append(i)
                continue
            # sparse only in the repository's own layout: per-shard payloads
            # of the mesh's layout on a mesh, whole-row payloads off one
            sharded = bool(meta["delta_spec"].get("sharded"))
            if self.mesh is not None:
                fast = (sharded and meta.get("shard_spec") is not None
                        and ShardedFlatSpec.from_json(meta["shard_spec"]) == self._sspec)
            else:
                fast = not sharded
            p0 = payloads[0]
            this = (len(payloads), p0.block, p0.k_per_block, p0.n_blocks)
            if fast and geom is None:
                geom = this
            elif this != geom:
                fast = False
            if fast:
                payload_sets.append(payloads)
                comp_pos.append(i)
            else:
                dense_rows.append(self._restage(self._decode_compressed_dense(payloads, meta)))
                dense_pos.append(i)
        if not comp_pos:
            return StagedBuffer.from_rows(dense_rows)

        def stack(field: str, s: int, dev) -> torch.Tensor:
            return torch.from_numpy(np.stack([getattr(pl[s], field)
                                              for pl in payload_sets])).to(dev)

        if self.mesh is not None:
            devices = SH.flat_row_sharding(self.mesh, self.mesh_axes)
            idx, val, scl = ([stack(f, s, d) for s, d in enumerate(devices)]
                             for f in ("indices", "values", "scales"))
        else:
            idx, val, scl = (stack(f, 0, self.device) for f in ("indices", "values", "scales"))
        return MixedStage(
            dense=StagedBuffer.from_rows(dense_rows) if dense_rows else None,
            indices=idx, values=val, scales=scl, block=geom[1],
            dense_pos=np.asarray(dense_pos, np.int64),
            comp_pos=np.asarray(comp_pos, np.int64))

    def _decode_compressed_dense(self, payloads, meta, *, base=None) -> torch.Tensor:
        """Host decode of a compressed submission (whole-row or per-shard
        payloads) to a dense ``[N]`` row on the repository's device (the
        fallbacks only): Δ scattered dense, plus ``base`` (default: the
        current base), in the storage dtype."""
        if base is None:
            base = self._base_flat
        if meta.get("sharded") and meta.get("shard_spec"):
            ss = ShardedFlatSpec.from_json(meta["shard_spec"])
            host = delta_decode_sharded(payloads, ss, base)
        else:
            host = delta_decode(payloads[0], base)
        return torch.from_numpy(host).to(device=self.device, dtype=self._base_flat.dtype)

    def _decode_vs_declared(self, payloads, meta, declared: int) -> torch.Tensor:
        """Decode against the base the rider declared, from its retained
        ``base_iterNNNN.npz``: a delta is never decoded against a base it
        was not computed from."""
        path = (os.path.join(self.root, f"base_iter{declared:04d}.npz")
                if self.root else None)
        if path is None or not os.path.exists(path):
            raise ValueError(
                f"compressed row declares base_iteration={declared} but the repository is "
                f"at iteration {self.iteration} and base_iter{declared:04d}.npz is not on "
                "disk — cannot decode")
        return self._decode_compressed_dense(payloads, meta,
                                             base=self._spec.flatten(ckpt.load(path)))

    def _fuse_flat(self, stage, weights: torch.Tensor, alpha: float):
        if isinstance(stage, MixedStage):
            return self._fuse_mixed(stage, weights, alpha)
        if self.mesh is not None:
            return ops.fuse_flat_sharded(self._base_shards, stage, weights, alpha,
                                         mesh=self.mesh, axes=self.mesh_axes)
        return ops.fuse_flat(self._base_flat, stage, weights, alpha)

    def _fuse_mixed(self, ms: MixedStage, weights: torch.Tensor, alpha: float):
        """Screen + fuse a mixed cohort; the sq statistics come back in
        cohort order, as from a dense fuse."""
        dpos = torch.from_numpy(ms.dense_pos).to(weights.device)
        cpos = torch.from_numpy(ms.comp_pos).to(weights.device)
        dense = ms.dense if len(ms.dense_pos) else None
        wd = weights[dpos] if len(ms.dense_pos) else None
        if self.mesh is not None:
            fused, sq_split = ops.fuse_flat_compressed_sharded(
                self._base_shards, ms.indices, ms.values, ms.scales, weights[cpos], alpha,
                mesh=self.mesh, axes=self.mesh_axes, block=ms.block, dense=dense,
                dense_weights=wd)
        else:
            fused, sq_split = ops.fuse_flat_compressed(
                self._base_flat, ms.indices, ms.values, ms.scales, weights[cpos], alpha,
                block=ms.block, dense=dense, dense_weights=wd)
        sq = torch.zeros((ms.k,), dtype=torch.float32, device=sq_split.device)
        sq[torch.cat([dpos, cpos])] = sq_split
        return fused, sq

    def _finalize_flat(self, pf: PendingFusion) -> FusionRecord:
        """The host half of the screen + fuse: pull sq_diff (the only wait),
        apply the §9 rule, re-pass with zeroed weights on rejections, and
        publish."""
        fused = pf.fused
        report: Optional[ScreenReport] = None
        n_accepted = pf.k
        use_screen = self.screen if pf.use_screen is None else pf.use_screen
        if use_screen:
            report = screen_norms(norms_from_sq(pf.sq), mad_threshold=self.mad_threshold)
            n_accepted = len(report.accepted)
            if not report.accepted:
                raise RuntimeError(f"all contributions rejected: {report.reasons}")
            if report.rejected:
                w2 = pf.weights.clone()
                w2[report.rejected] = 0.0
                alpha = self._flat_alpha(n_accepted) if pf.alpha is None else pf.alpha
                fused, _ = self._fuse_flat(pf.stage, w2, alpha)
        _sync(fused)
        rec = FusionRecord(
            iteration=self.iteration,
            n_contributions=pf.k,
            n_accepted=n_accepted,
            op=pf.op or self.fusion_op,
            diff_norms=report.diff_norms if report else [],
            wall_time=time.time() - pf.t0,
        )
        self._publish(fused)
        pf.record = rec
        return rec

    def _publish(self, fused) -> None:
        """Install a fused row as the base (the old one goes to the
        snapshots with ``keep_history``).  On a mesh the fused slices stay
        the base's shards and are gathered once into its ``[N]`` row."""
        if self.keep_history:
            self._snapshots.append(self._base)
        if self.mesh is not None:
            self._base_shards = list(fused)
            fused = self._sspec.unshard(M.all_gather(fused, self.mesh))
        self._base_flat = fused
        self._base = self._spec.unflatten(fused)

    def _fuse_pending_pytree(self, t0: float, back: StagingSide) -> FusionRecord:
        """The per-leaf engine: screen the staged trees, keep the accepted
        models, Fishers and weights, fuse them with ``core.fusion``."""
        models, fishers, weights = back.rows, back.fishers, back.weights
        report: Optional[ScreenReport] = None
        if self.screen:
            report = screen_contributions(self._base, models, mad_threshold=self.mad_threshold)
            models = [models[i] for i in report.accepted]
            fishers = [fishers[i] for i in report.accepted]
            weights = [weights[i] for i in report.accepted]
            if not models:
                raise RuntimeError(f"all contributions rejected: {report.reasons}")
        kw = dict(self.fusion_kwargs)
        if self.fusion_op == "fisher":
            if any(f is None for f in fishers):
                raise RuntimeError("fusion_op='fisher' requires upload(..., fisher=...)")
            kw["fishers"] = fishers
        elif (self.fusion_op in ("average", "damped") and "weights" not in kw
              and weights and all(w is not None for w in weights)):
            kw["weights"] = weights
        new_base = fusion.fuse(self.fusion_op, self._base, models, **kw)
        rec = FusionRecord(
            iteration=self.iteration,
            n_contributions=len(back.rows),
            n_accepted=len(models),
            op=self.fusion_op,
            diff_norms=report.diff_norms if report else [],
            wall_time=time.time() - t0,
        )
        self._publish(self._spec.flatten(new_base))
        return rec

    def _mark_back_fusing(self) -> None:
        """Stamp the back cohort's manifest entries as in flight and persist
        the mark: recovery may skip an entry as consumed only if it carries
        the mark AND the recorded iteration moved past its ``staged_at``."""
        back = self._buffers.back
        if back is None or not back.manifest:
            return
        with self._manifest_lock:
            for e in back.manifest:
                e["fusing"] = True
            if self.root and (self.spill or os.path.exists(self._manifest_path())):
                self._write_manifest()

    def _restore_back(self) -> None:
        """Un-swap after a failed fuse: the back cohort returns to the head
        of the front buffer, its in-flight marks dropped."""
        with self._manifest_lock:
            back = self._buffers.back
            if back is None:
                return
            for e in back.manifest:
                e.pop("fusing", None)
            front = self._buffers.front
            back.rows.extend(front.rows)
            back.fishers.extend(front.fishers)
            back.weights.extend(front.weights)
            back.manifest.extend(front.manifest)
            self._buffers.front = back
            self._buffers.back = None

    def _refresh_front_staging(self) -> None:
        """Front rows survive publishes they took no part in: re-stamp them
        to the next staging iteration."""
        for e in self._buffers.front.manifest:
            e["staged_at"] = self._staging_iteration()

    def _after_publish(self, rec: FusionRecord) -> None:
        """After a cohort publish (either engine), in the reference's order:
        persist the base, the seam, rewrite the manifest, refresh the base
        sketch, notify the listeners.  With the spill executor the first
        three run as one queued task on host copies taken here."""
        self.history.append(rec)
        self.iteration += 1
        self._refresh_front_staging()
        if self.root and self._spill_pool is not None:
            it, meta = self.iteration, self._render_meta()
            base = self._spec.unflatten(self._base_flat.cpu())

            def task():
                self._persist_base(it, base, meta)
                faults.crash_point("repo.post_publish_pre_manifest")
                with self._manifest_lock:
                    self._write_manifest()

            self._spill_futures.append(self._spill_pool.submit(task))
        elif self.root:
            self._persist_base()
            faults.crash_point("repo.post_publish_pre_manifest")
            if self.spill or os.path.exists(self._manifest_path()):
                with self._manifest_lock:
                    self._write_manifest()
        # after the durability-critical writes: the sketch is advisory
        self._refresh_base_sketch()
        self._notify_publish()

    def _cohort_weights(self, K: int, staged) -> torch.Tensor:
        """Per-contributor weights (average/damped)."""
        kw = self.fusion_kwargs
        if self.fusion_op in ("average", "damped"):
            if "weights" in kw:
                w = list(kw["weights"])
                if len(w) != K:
                    raise ValueError(f"len(fusion_kwargs['weights'])={len(w)} != K={K}")
                return torch.tensor(w, dtype=torch.float32, device=self.device)
            if staged and all(x is not None for x in staged):
                return torch.tensor(list(staged), dtype=torch.float32, device=self.device)
        return torch.ones((K,), dtype=torch.float32, device=self.device)

    def _flat_alpha(self, n_effective: int) -> float:
        """The kernel's damping coefficient for the configured operator."""
        if self.fusion_op == "damped":
            return float(self.fusion_kwargs.get("alpha", 1.0))
        if self.fusion_op == "task_arithmetic":
            # θ + λ·Σ(θ_c − θ) == θ + (λ·K)·(mean − θ)
            return float(self.fusion_kwargs.get("lam", 1.0)) * n_effective
        return 1.0

    # -- persistence -------------------------------------------------------
    def _persist_base(self, iteration: Optional[int] = None, base=None,
                      meta: Optional[Dict[str, Any]] = None) -> None:
        """Write the current (or a captured) base and repository.json,
        atomically, the base npz before the JSON names it.  Serialised under
        the publish lock with a monotonic guard: an older publish task that
        runs late never lands after a newer one."""
        it = self.iteration if iteration is None else iteration
        base = self._base if base is None else base
        meta = self._render_meta() if meta is None else meta
        with self._publish_lock:
            if it < self._persisted_iteration:
                return
            ckpt.save(os.path.join(self.root, f"base_iter{it:04d}.npz"), base)
            ckpt.save_json_atomic(os.path.join(self.root, "repository.json"),
                                  {**meta, **self.extra_meta}, default=_json_default)
            self._persisted_iteration = it

    def _render_meta(self) -> Dict[str, Any]:
        meta = {
            "iteration": self.iteration,
            "fusion_op": self.fusion_op,
            "fusion_kwargs": self.fusion_kwargs,
            "screen": self.screen,
            "mad_threshold": self.mad_threshold,
            "spill": self.spill,
            "flat_spec": {"dtype": self._spec.dtype, "size": self._spec.size},
            "history": [
                {"iteration": r.iteration, "n_contributions": r.n_contributions,
                 "n_accepted": r.n_accepted, "op": r.op,
                 "diff_norms": [float(n) for n in r.diff_norms], "wall_time": r.wall_time}
                for r in self.history
            ],
        }
        meta.update(self.extra_meta)
        return meta

    # -- crash recovery ------------------------------------------------------
    def _recover_staged(self, manifest: Dict[str, Any]) -> int:
        """Re-stage the staged-but-unfused rows a crash left behind: entries
        marked in flight whose ``staged_at`` is behind the repository were
        consumed by a publish that landed (skipped); missing or unreadable
        rows are skipped with a warning; a compressed row of another vintage
        is skipped; a FlatSpec mismatch raises.  Per-shard files recover
        under any mesh, or none (``_load_staged_row`` restages them).  The
        per-leaf engine stages each recovered row as a tree."""
        spec = self._spec
        side = self._buffers.front
        recovered = 0
        for e in manifest.get("entries", []):
            if e.get("fusing") and int(e.get("staged_at", self.iteration)) < self.iteration:
                continue
            if (e.get("compressed") and e.get("base_iteration") is not None
                    and int(e["base_iteration"]) != self.iteration):
                warnings.warn(
                    f"spill recovery: skipping compressed row {e['file']} — encoded against "
                    f"base iteration {e['base_iteration']} but the repository reopened at "
                    f"{self.iteration}")
                continue
            path = os.path.join(self.root, e["file"])
            try:
                meta = ckpt.flat_row_meta(path)
            except Exception as err:  # missing / truncated / not an npz
                warnings.warn(f"spill recovery: skipping unreadable staged row {e['file']} "
                              f"({type(err).__name__}: {err})")
                continue
            if meta["dtype"] != spec.dtype or int(meta["size"]) != spec.size:
                raise ValueError(
                    f"staged row {e['file']} was spilled with FlatSpec(dtype={meta['dtype']}, "
                    f"N={meta['size']}) but the repository base is (dtype={spec.dtype}, "
                    f"N={spec.size}) — refusing to recover mismatched rows")
            if self.spill:
                side.rows.append(path)
            elif self.use_flat:
                side.rows.append(self._load_staged_row(path))
            else:
                side.rows.append(spec.unflatten(self._load_staged_row(path)))
            fresh = {k: v for k, v in e.items() if k != "fusing"}
            fresh["staged_at"] = self._staging_iteration()
            side.manifest.append(fresh)
            side.fishers.append(None)
            side.weights.append(e.get("weight"))
            recovered += 1
        if self.root:
            with self._manifest_lock:
                self._write_manifest()
        return recovered

    @classmethod
    def open(cls, root: str, *, device="cuda", **kw) -> "Repository":
        """Re-open an on-disk repository (written by either package) at its
        latest base, on ``device``, restoring the fusion configuration,
        screen settings and history from ``repository.json`` (keyword
        arguments win), the staged-but-unfused rows from the staging
        manifest and the novelty screen's sketch."""
        dev = resolve_device(device)
        with open(os.path.join(root, "repository.json")) as f:
            meta = json.load(f)
        it = meta["iteration"]
        base = ckpt.load(os.path.join(root, f"base_iter{it:04d}.npz"), device=dev)
        spec = FlatSpec.from_tree(base)
        recorded = meta.get("flat_spec")
        if recorded and (recorded["dtype"] != spec.dtype or int(recorded["size"]) != spec.size):
            raise ValueError(
                f"repository.json records FlatSpec(dtype={recorded['dtype']}, "
                f"N={recorded['size']}) but base_iter{it:04d}.npz loads as "
                f"(dtype={spec.dtype}, N={spec.size}) — refusing to apply the stored "
                "fusion_kwargs/screen settings to it")
        kw.setdefault("fusion_op", meta.get("fusion_op", "average"))
        if meta.get("fusion_kwargs"):
            kw.setdefault("fusion_kwargs", meta["fusion_kwargs"])
        kw.setdefault("screen", meta.get("screen", True))
        kw.setdefault("mad_threshold", meta.get("mad_threshold", 5.0))
        spill = bool(kw.pop("spill", meta.get("spill", False)))
        spill_workers = int(kw.pop("spill_workers", 0))
        # root=None so __init__ does not re-persist; root/spill set below
        repo = cls(base, root=None, **kw)
        repo.iteration = it
        repo.root = root
        if spill and not repo.use_flat:
            warnings.warn("spill=True requested but the repository reopened on the per-leaf "
                          "engine — staged rows will NOT be spilled or crash-recoverable "
                          "until reopened on the flat engine")
        repo.spill = spill and repo.use_flat
        if repo.spill and spill_workers > 0:
            repo._spill_pool = ThreadPoolExecutor(max_workers=spill_workers,
                                                  thread_name_prefix="repo-spill")
        repo._persisted_iteration = it
        if "families" in meta:
            repo.extra_meta["families"] = meta["families"]
        repo.history = [
            FusionRecord(iteration=r["iteration"], n_contributions=r["n_contributions"],
                         n_accepted=r["n_accepted"], op=r["op"],
                         diff_norms=[float(n) for n in r.get("diff_norms", [])],
                         wall_time=float(r.get("wall_time", 0.0)))
            for r in meta.get("history", [])
        ]
        manifest_path = os.path.join(root, MANIFEST)
        if os.path.exists(manifest_path):
            repo._recover_staged(ckpt.load_json(manifest_path))
        sketch_path = os.path.join(root, SKETCH_FILE)
        if os.path.exists(sketch_path):
            try:
                sk = CohortSketch.from_json(ckpt.load_json(sketch_path))
            except (OSError, ValueError, KeyError, TypeError) as err:
                warnings.warn(f"cohort sketch unreadable ({type(err).__name__}: {err}) — "
                              "the novelty screen history restarts empty")
            else:
                if sk.size == spec.size:
                    repo.cohort_sketch = sk
                else:
                    warnings.warn(f"cohort sketch was built for N={sk.size} rows but the "
                                  f"base is N={spec.size} — ignoring it")
        return repo


# ---------------------------------------------------------------------------
# RepositoryFamily — named bases under one root
# ---------------------------------------------------------------------------

FAMILY_DIR = "families"


def family_member_root(root: str, name: str) -> str:
    """Filesystem root of a family member: ``main`` IS the top-level root
    (a single-base repository and a one-member family share one layout);
    every other member owns a whole repository layout (queue, staging
    manifest, sketch, gate state, bases) under ``<root>/families/<name>/``."""
    return root if name == "main" else os.path.join(root, FAMILY_DIR, name)


class RepositoryFamily:
    """A named family of Repository members sharing one on-disk root (port
    of ``repro.core.repository.RepositoryFamily``; the same files).

    The family manifest is the ``"families"`` key of the top-level
    ``repository.json`` (main's meta): member name → ``{root, seeded_from,
    seed_iteration, created_at}``.  ``open`` on a single-base root migrates
    it in place by writing ``{"main": {"root": "."}}``; no file moves.

    Every member lives on the family's device (``member_kw["device"]``),
    spawned ones included.  ``spawn`` persists the member's directory
    before its manifest entry: a crash between the two (the
    ``repo.post_family_spawn`` seam) leaves a directory the next spawn of
    the same name adopts.  ``cross_fuse`` fuses every member toward the
    OTHER members' pre-cross bases with step ``alpha·(M−1)/M``, so at
    ``alpha=1`` each lands on the mean of all pre-cross bases."""

    def __init__(self, main: Repository, *, member_kw: Optional[Dict[str, Any]] = None):
        if not main.root:
            raise ValueError("RepositoryFamily requires an on-disk root")
        self.root = main.root
        self.member_kw = dict(member_kw or {})
        self.member_kw.setdefault("device", main.device)
        main.family_name = "main"
        self.members: Dict[str, Repository] = {"main": main}
        self._meta: Dict[str, Dict[str, Any]] = {"main": {"root": "."}}

    @classmethod
    def create(cls, base_params, *, root: str, device="cuda", **kw) -> "RepositoryFamily":
        """Initialise a NEW family on ``device``: a main member at ``root``
        (``base_params`` moved there) plus the manifest.  ``kw`` goes to
        the Repository constructor and is remembered for spawned members."""
        dev = resolve_device(device)
        main = Repository(tree_map(lambda x: x.to(dev), base_params), root=root, **kw)
        fam = cls(main, member_kw=dict(kw, device=dev))
        fam._write_family_manifest()
        return fam

    @classmethod
    def open(cls, root: str, *, device="cuda", **kw) -> "RepositoryFamily":
        """Open an on-disk family written by either package (or migrate a
        single-base root in place) on ``device``.  ``kw`` goes to every
        member's ``Repository.open`` and is remembered for spawns."""
        dev = resolve_device(device)
        main = Repository.open(root, device=dev, **kw)
        fam = cls(main, member_kw=dict(kw, device=dev))
        meta = main.extra_meta.get("families")
        if meta is None:
            fam._write_family_manifest()
            return fam
        fam._meta = {str(n): dict(e) for n, e in meta.items()}
        fam._meta.setdefault("main", {"root": "."})
        for name in sorted(fam._meta):
            if name == "main":
                continue
            member = Repository.open(os.path.join(root, fam._meta[name]["root"]),
                                     **fam.member_kw)
            member.family_name = name
            fam.members[name] = member
        fam._install_manifest()
        return fam

    def __len__(self) -> int:
        return len(self.members)

    def member_root(self, name: str) -> str:
        return family_member_root(self.root, name)

    def _install_manifest(self) -> None:
        """Give main's ``extra_meta`` a copy of the manifest that is never
        mutated afterwards: a publish task on a spill worker renders and
        writes it while the family may be spawning."""
        self.members["main"].extra_meta["families"] = {
            n: dict(e) for n, e in self._meta.items()}

    def _write_family_manifest(self) -> None:
        """Persist the manifest into the top-level repository.json under
        main's publish lock, where every publish writes the same file.
        Only the ``families`` key of the file on disk changes, so the
        recorded iteration never names a base still queued for writing;
        ``_persist_base`` re-merges the live ``extra_meta``, so an older
        publish never clobbers a newer manifest."""
        main = self.members["main"]
        path = os.path.join(self.root, "repository.json")
        with main._publish_lock:
            self._install_manifest()
            meta = ckpt.load_json(path)
            meta["families"] = main.extra_meta["families"]
            ckpt.save_json_atomic(path, meta, default=_json_default)

    def spawn(self, *, seed_family: str = "main", seed_iteration: Optional[int] = None,
              name: Optional[str] = None) -> str:
        """Create (or crash-adopt) a member seeded from ``seed_family``'s
        base at ``seed_iteration`` (its current base when None, or when that
        vintage's npz is gone).  Names are deterministic (``f1``, ``f2``,
        … smallest free), so a spawn replayed after a crash lands on the
        same member.  The member lives on the family's device."""
        src = self.members[seed_family]
        if name is None:
            k = 1
            while f"f{k}" in self._meta or f"f{k}" in self.members:
                k += 1
            name = f"f{k}"
        if name in self.members:
            raise ValueError(f"family member {name!r} already exists")
        mroot = self.member_root(name)
        it = src.iteration if seed_iteration is None else int(seed_iteration)
        if os.path.exists(os.path.join(mroot, "repository.json")):
            # persisted by a spawn that crashed before its manifest entry
            member = Repository.open(mroot, **self.member_kw)
        else:
            seed_path = os.path.join(src.root, f"base_iter{it:04d}.npz")
            if not os.path.exists(seed_path):
                # the declared vintage was compacted away (or is not yet
                # durable): seed from the source's current base
                src.flush()
                it = src.iteration
                src._persist_base()
                seed_path = os.path.join(src.root, f"base_iter{it:04d}.npz")
            kw = dict(fusion_op=src.fusion_op, fusion_kwargs=src.fusion_kwargs,
                      screen=src.screen, mad_threshold=src.mad_threshold)
            kw.update(self.member_kw)
            dev = kw.pop("device")
            member = Repository(ckpt.load(seed_path, device=dev), root=mroot, **kw)
        member.family_name = name
        self.members[name] = member
        faults.crash_point("repo.post_family_spawn")
        self._meta[name] = {
            "root": f"{FAMILY_DIR}/{name}",
            "seeded_from": seed_family,
            "seed_iteration": it,
            "created_at": time.time(),
        }
        self._write_family_manifest()
        return name

    def cross_fuse(self, *, alpha: float = 1.0) -> Dict[str, FusionRecord]:
        """Fuse every member toward the mean of the OTHER members' bases
        (``fuse_pending(buffer=)``, the §9 screen off, step
        ``alpha·(M−1)/M``).  Every pre-cross base is taken before the first
        member moves, and each member's operand is a fresh stack of them,
        so the update is simultaneous: at ``alpha=1`` every member lands on
        the mean of all pre-cross bases.  Each publish runs the whole
        pipeline (record, iteration, persist, sketch, listeners).  A family
        of one returns ``{}``."""
        names = sorted(self.members)
        if len(names) < 2:
            return {}
        for n in names:
            self.members[n].flush()
        # a publish installs a fresh row and never writes into the old one
        bases = {n: self.members[n]._staged_base() for n in names}
        ak = float(alpha) * (len(names) - 1) / len(names)
        recs: Dict[str, FusionRecord] = {}
        for n in names:
            stage = StagedBuffer.from_rows([bases[o] for o in names if o != n])
            recs[n] = self.members[n].fuse_pending(
                buffer=stage, wait=True, alpha=ak, screen=False,
                op=f"cross_fuse(alpha={alpha:g})")
        return recs
