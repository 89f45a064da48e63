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

The published base (``download()``) is a tree of views into the fused row,
which is also the ``base`` operand of the next fuse: callers must not update
it in place (``train.finetune`` clones what it trains).

Not ported yet (each raises where the reference takes it): ``mesh=``,
``spill_workers>0``, ``rollback``, ``compact``, ``contribute_async``,
publish listeners, ``RepositoryFamily`` and sharded files.
"""
from __future__ import annotations

import json
import os
import time
import warnings
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch.checkpoint import io as ckpt
from repro_torch.core import fusion
from repro_torch.core.validation import (ScreenReport, norms_from_sq, screen_contributions,
                                         screen_norms)
from repro_torch.kernels import ops
from repro_torch.utils import faults
from repro_torch.utils.device import resolve_device
from repro_torch.utils.flat import (SKETCH_BUCKETS, BufferPair, CohortSketch, FlatSpec,
                                    StagedBuffer, StagingSide, delta_decode, delta_entries,
                                    sketch_apply_delta)
from repro_torch.utils.pytree import tree_device

# operators the flat engine covers; the others (fisher, ties) fuse per leaf
FLAT_OPS = ("average", "damped", "task_arithmetic")

MANIFEST = "staging_manifest.json"
SKETCH_FILE = "cohort_sketch.json"


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet")


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
    fused: torch.Tensor
    sq: torch.Tensor
    weights: torch.Tensor
    k: int
    t0: float
    record: Optional[FusionRecord] = None

    @property
    def done(self) -> bool:
        return self.record is not None


@dataclass
class MixedStage:
    """Fuse operand of a cohort that mixes dense rows (cohort positions
    ``dense_pos``) with compressed submissions (``comp_pos``), which ride
    as their stacked codec arrays and are decoded inside the fuse."""

    dense: Optional[StagedBuffer]
    indices: torch.Tensor   # [C, nb, kb] int16
    values: torch.Tensor    # [C, nb, kb] int8
    scales: torch.Tensor    # [C, nb] f32
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


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.current_stream(t.device).synchronize()


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
        if mesh is not None or mesh_axes is not None:
            raise _not_ported("Repository(mesh=) (the multi-device slice)")
        if spill_workers:
            raise _not_ported("Repository(spill_workers>0)")
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
        self._base_flat = self._spec.flatten(base_params)
        self._base = self._spec.unflatten(self._base_flat)
        self._buffers = BufferPair()
        self._inflight: Optional[PendingFusion] = None
        self._persisted_iteration = -1
        # the novelty screen's state; None until enable_cohort_sketch
        self.cohort_sketch: Optional[CohortSketch] = None
        # opaque repository.json keys (a family manifest) carried verbatim
        self.extra_meta: Dict[str, Any] = {}
        if root:
            os.makedirs(root, exist_ok=True)
            self._persist_base()

    @property
    def device(self) -> torch.device:
        return self._base_flat.device

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
        """Persist the staged-but-unfused rows (back + front).  Called with
        the row file already on disk, so a crash in between loses at most
        the newest row, never records a row that does not exist."""
        ckpt.save_json_atomic(self._manifest_path(), {
            "version": 1, "entries": self._buffers.manifest_entries()})

    def _spill_row(self, row: torch.Tensor, idx: int, weight) -> str:
        path = self._contrib_path(idx)
        ckpt.save_flat(path, row, self._spec)
        self._buffers.front.manifest.append({
            "file": os.path.basename(path),
            "idx": idx,
            # the publish this row fuses into; see _recover_staged
            "staged_at": self._staging_iteration(),
            "weight": None if weight is None else float(weight),
            "dtype": self._spec.dtype,
            "size": self._spec.size,
            "sharded": False,
        })
        self._write_manifest()
        return path

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
            if self.root:
                ckpt.save_flat(self._contrib_path(idx), row, self._spec)
            side.rows.append(row)
        side.fishers.append(fisher)
        side.weights.append(weight)
        return idx

    def ingest_spilled(self, path: str, *, weight: Optional[float] = None,
                       meta: Optional[Dict[str, Any]] = None) -> int:
        """Stage an on-disk flat row (a queue submission) by reference: its
        root-relative path enters the staging manifest atomically, with the
        same exactly-once recovery as a spilled ``upload``.  The recorded
        FlatSpec must match the base; torn, mismatched or sharded files
        raise ``ValueError`` without touching the manifest."""
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
        if meta.get("sharded") or (meta.get("delta_spec") or {}).get("sharded"):
            raise ValueError(f"row {os.path.basename(path)} is sharded: sharded layouts "
                             "are not ported yet (multi-device slice)")
        side = self._buffers.front
        idx = len(side.rows)
        entry = {
            "file": rel.replace(os.sep, "/"),
            "idx": idx,
            "staged_at": self._staging_iteration(),
            "weight": None if weight is None else float(weight),
            "dtype": self._spec.dtype,
            "size": self._spec.size,
            "sharded": False,
        }
        if meta.get("compressed"):
            # decoded only at dispatch, against the vintage declared here
            entry["compressed"] = True
            entry["codec"] = meta.get("delta_spec")
            bi = (meta.get("extra") or {}).get("base_iteration")
            if bi is not None:
                entry["base_iteration"] = int(bi)
        side.rows.append(path)
        side.fishers.append(None)
        side.weights.append(weight)
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

    def _sketch_of_staged(self, row: torch.Tensor) -> np.ndarray:
        """Sketch a staged ``[N]`` row (the kernel on the card) to host f32."""
        return ops.row_sketch(row, self._n_buckets()).cpu().numpy()

    def _refresh_base_sketch(self) -> None:
        """Recompute the base's sketch (the screen's distance normalizer)
        and persist it; runs at every publish.  Advisory state: a lost write
        costs one stale-scale decision, never a double fuse.  No-op on the
        per-leaf engine (a recovered sketch stays as it was)."""
        if self.cohort_sketch is None or not self.use_flat:
            return
        self.cohort_sketch.set_base(self._sketch_of_staged(self._base_flat),
                                    iteration=self.iteration)
        self.save_cohort_sketch()

    def sketch_row_file(self, path: str, *, meta: Optional[Dict[str, Any]] = None
                        ) -> np.ndarray:
        """Content sketch of an on-disk flat row (a queue submission) in one
        read, on the repository's device.  Raises on torn, unreadable or
        sharded files; callers reject like any other unreadable file."""
        if meta is None:
            meta = ckpt.flat_row_meta(path)
        if meta.get("compressed"):
            return self.sketch_delta_file(path)
        if meta.get("sharded"):
            raise ValueError(f"{os.path.basename(path)} is sharded: sharded layouts are "
                             "not ported yet (multi-device slice)")
        row, _ = ckpt.load_flat(path)
        return self._sketch_of_staged(row.to(self.device))

    def sketch_delta_file(self, path: str, *,
                          meta: Optional[Dict[str, Any]] = None) -> np.ndarray:
        """Content sketch of a compressed submission without its dense row:
        the base's sketch corrected bucket-wise from the sparse delta
        (``sketch_apply_delta``), reading base values only at the delta's
        own positions."""
        del meta  # the payload load re-reads the header regardless
        payloads, _ = ckpt.load_flat_delta(path)
        if self.cohort_sketch is not None and self.cohort_sketch.base is not None:
            base_sk = np.asarray(self.cohort_sketch.base, np.float64)
        else:
            base_sk = self._sketch_of_staged(self._base_flat).astype(np.float64)
        gi, dv = delta_entries(payloads[0])
        at = torch.from_numpy(gi).to(self.device)
        base_at = self._base_flat[at].float().cpu().numpy()
        sk = sketch_apply_delta(base_sk, gi, dv, base_at, n_buckets=self._n_buckets())
        return np.asarray(sk, np.float32)

    def flat_base_host(self) -> torch.Tensor:
        """The current (published) base as a host ``[N]`` row in its
        storage dtype."""
        return self._base_flat.cpu()

    # -- not ported yet ----------------------------------------------------
    def rollback(self, to_iteration: int, *, keep_staged: bool = False):
        raise _not_ported("Repository.rollback")

    def compact(self, *, keep_bases: int = 2):
        raise _not_ported("Repository.compact")

    def contribute_async(self, params, *, alpha: Optional[float] = None):
        raise _not_ported("Repository.contribute_async")

    def add_publish_listener(self, fn) -> None:
        raise _not_ported("Repository.add_publish_listener")

    # -- fuse -----------------------------------------------------------
    def fuse_pending(self, buffer=None, *, wait: bool = True
                     ) -> Union[FusionRecord, PendingFusion]:
        """Screen + fuse the staged cohort into the new base (Fig. 1,
        step 4).  Finalizes any in-flight fuse, swaps the front staging
        buffer to the back and launches the fuse.  ``wait=False`` returns a
        ``PendingFusion`` at once; ``flush()`` (or the next
        ``fuse_pending``/``download``) screens and publishes it.  On the
        per-leaf engine ``wait`` is ignored (the fuse is synchronous)."""
        if buffer is not None:
            raise _not_ported("fuse_pending(buffer=)")
        self._finalize_inflight()
        if not self._buffers.front.rows:
            raise RuntimeError("no contributions to fuse")
        t0 = time.time()
        back = self._buffers.swap()
        if not self.use_flat:
            self._mark_back_fusing()
            try:
                rec = self._fuse_pending_pytree(t0, back)
            except Exception:
                self._restore_back()
                raise
            self._buffers.retire_back()
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

    def flush(self) -> Optional[FusionRecord]:
        """Quiesce: finalize the in-flight fuse, if any.  Returns its record
        (None when nothing was in flight)."""
        return self._finalize_inflight()

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
        self._buffers.retire_back()
        self._after_publish(rec)
        return rec

    def _load_staged_row(self, p) -> torch.Tensor:
        """A staged entry as an ``[N]`` row on the repository's device:
        in-memory rows pass through, spilled ones load from disk (a
        compressed file outside a fuse decodes against the current base)."""
        if isinstance(p, torch.Tensor):
            return p
        meta = ckpt.flat_row_meta(p)
        if meta.get("compressed"):
            payloads, _ = ckpt.load_flat_delta(p)
            return self._decode_compressed_dense(payloads[0])
        if meta.get("sharded"):
            raise ValueError(f"{os.path.basename(p)} is sharded: sharded layouts are not "
                             "ported yet (multi-device slice)")
        row, _ = ckpt.load_flat(p)
        return row.to(self.device)

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
        submission among the rows makes a ``MixedStage``."""
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
        dense_rows: List[torch.Tensor] = []
        dense_pos: List[int] = []
        payloads = []
        comp_pos: List[int] = []
        geom = None
        for i, p in enumerate(back.rows):
            if not (isinstance(p, str) and ckpt.is_flat_compressed(p)):
                dense_rows.append(self._load_staged_row(p))
                dense_pos.append(i)
                continue
            (pl,), meta = ckpt.load_flat_delta(p)
            rel = os.path.relpath(p, root).replace(os.sep, "/") if root else None
            declared = entries.get(rel, {}).get(
                "base_iteration", (meta.get("extra") or {}).get("base_iteration"))
            if declared is not None and int(declared) != self.iteration:
                dense_rows.append(self._decode_vs_declared(pl, int(declared)))
                dense_pos.append(i)
                continue
            this = (pl.block, pl.k_per_block, pl.n_blocks)
            if geom is None:
                geom = this
            if this == geom:
                payloads.append(pl)
                comp_pos.append(i)
            else:
                dense_rows.append(self._decode_compressed_dense(pl))
                dense_pos.append(i)
        if not comp_pos:
            return StagedBuffer.from_rows(dense_rows)
        dev = self.device
        return MixedStage(
            dense=StagedBuffer.from_rows(dense_rows) if dense_rows else None,
            indices=torch.from_numpy(np.stack([q.indices for q in payloads])).to(dev),
            values=torch.from_numpy(np.stack([q.values for q in payloads])).to(dev),
            scales=torch.from_numpy(np.stack([q.scales for q in payloads])).to(dev),
            block=geom[0],
            dense_pos=np.asarray(dense_pos, np.int64),
            comp_pos=np.asarray(comp_pos, np.int64))

    def _decode_compressed_dense(self, payload, *, base=None) -> torch.Tensor:
        """Host decode of a compressed submission to a dense row on the
        device (the fallbacks only): Δ scattered dense, plus ``base``
        (default: the current base), in the storage dtype."""
        if base is None:
            base = self._base_flat
        row = torch.from_numpy(delta_decode(payload, base))
        return row.to(device=self.device, dtype=self._base_flat.dtype)

    def _decode_vs_declared(self, payload, declared: int) -> torch.Tensor:
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
        return self._decode_compressed_dense(payload, base=self._spec.flatten(ckpt.load(path)))

    def _fuse_flat(self, stage, weights: torch.Tensor, alpha: float):
        if isinstance(stage, MixedStage):
            return self._fuse_mixed(stage, weights, alpha)
        return ops.fuse_flat(self._base_flat, stage, weights, alpha)

    def _fuse_mixed(self, ms: MixedStage, weights: torch.Tensor, alpha: float):
        """Screen + fuse a mixed cohort; the sq statistics come back in
        cohort order, as from a dense fuse."""
        dpos = torch.from_numpy(ms.dense_pos).to(weights.device)
        cpos = torch.from_numpy(ms.comp_pos).to(weights.device)
        dense = ms.dense if len(ms.dense_pos) else None
        wd = weights[dpos] if len(ms.dense_pos) else None
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
        if self.screen:
            report = screen_norms(norms_from_sq(pf.sq), mad_threshold=self.mad_threshold)
            n_accepted = len(report.accepted)
            if not report.accepted:
                raise RuntimeError(f"all contributions rejected: {report.reasons}")
            if report.rejected:
                w2 = pf.weights.clone()
                w2[report.rejected] = 0.0
                fused, _ = self._fuse_flat(pf.stage, w2, self._flat_alpha(n_accepted))
        _sync(fused)
        rec = FusionRecord(
            iteration=self.iteration,
            n_contributions=pf.k,
            n_accepted=n_accepted,
            op=self.fusion_op,
            diff_norms=report.diff_norms if report else [],
            wall_time=time.time() - pf.t0,
        )
        self._publish(fused)
        pf.record = rec
        return rec

    def _publish(self, fused: torch.Tensor) -> None:
        """Install a fused ``[N]`` row as the base (the old one goes to the
        snapshots with ``keep_history``)."""
        if self.keep_history:
            self._snapshots.append(self._base)
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
        for e in back.manifest:
            e["fusing"] = True
        if self.root and (self.spill or os.path.exists(self._manifest_path())):
            self._write_manifest()

    def _restore_back(self) -> None:
        """Un-swap after a failed fuse: the back cohort returns to the head
        of the front buffer, its in-flight marks dropped."""
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
        self.history.append(rec)
        self.iteration += 1
        self._refresh_front_staging()
        if self.root:
            self._persist_base()
            faults.crash_point("repo.post_publish_pre_manifest")
            if self.spill or os.path.exists(self._manifest_path()):
                self._write_manifest()
        # after the durability-critical writes: the sketch is advisory
        self._refresh_base_sketch()

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
    def _persist_base(self) -> None:
        """Write the current base and repository.json (atomically; the base
        npz lands before the JSON names it)."""
        it = self.iteration
        if it < self._persisted_iteration:
            return
        ckpt.save(os.path.join(self.root, f"base_iter{it:04d}.npz"), self._base)
        ckpt.save_json_atomic(os.path.join(self.root, "repository.json"),
                              self._render_meta(), default=_json_default)
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
        is skipped; a FlatSpec mismatch or a sharded row raises.  The
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
            if meta.get("sharded"):
                raise ValueError(f"staged row {e['file']} is sharded: sharded layouts are "
                                 "not ported yet (multi-device slice)")
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
        # root=None so __init__ does not re-persist; root/spill set below
        repo = cls(base, root=None, **kw)
        repo.iteration = it
        repo.root = root
        if spill and not repo.use_flat:
            warnings.warn("spill=True requested but the repository reopened on the per-leaf "
                          "engine — staged rows will NOT be spilled or crash-recoverable "
                          "until reopened on the flat engine")
        repo.spill = spill and repo.use_flat
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
