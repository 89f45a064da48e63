"""Checkpoint files (port of ``repro.checkpoint.io``).

Every file here reads the same in both packages: the queue and the
repository root are the interchange contract between contributors, the
daemon and either package.  npz has no bfloat16, so bf16 is stored as its
uint16 bit pattern; the port gets there through ``torch.int16`` views and
back through ``Tensor.view(torch.bfloat16)``, never through ``ml_dtypes``.

Formats, all written atomically (a ``.tmp-<pid>`` sibling, then
``os.replace``), so a writer killed mid-write never leaves a torn file:

* **tree** (``save``/``load``) — one npz entry per leaf, keys ``::``-joined
  in sorted-key order, bf16 leaves suffixed ``__bf16__``;
* **flat** (``save_flat``/``load_flat``) — one contiguous row plus its
  ``FlatSpec`` JSON, with an optional free-form JSON rider (``extra``);
* **flat shards** (``save_flat_shards``/``FlatShardReader``) — one row as
  its S block-cyclic slices (``ShardedFlatSpec.shard_slices``), one entry a
  shard, plus both specs: a mesh repository reloads it shard by shard;
* **flat delta** (``save_flat_delta``/``load_flat_delta``) — a compressed
  contribution: the ``DeltaPayload`` arrays (stacked over the shards for a
  per-shard file) plus the same spec entries.

``save_json_atomic`` and the append-only JSONL helpers carry the same crash
discipline to the manifests and the metrics series.
"""
from __future__ import annotations

import json
import os
import threading
import warnings
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.utils.flat import DeltaPayload, FlatSpec, ShardedFlatSpec
from repro_torch.utils.pytree import tree_from_paths, tree_leaves_with_path

_SEP = "::"
_BF16 = "__bf16__"  # npz has no bfloat16: stored as uint16 bit pattern
_FLAT_BUF = "__flat_buffer__"
_FLAT_SPEC = "__flat_spec__"
_FLAT_SSPEC = "__flat_shard_spec__"
_FLAT_EXTRA = "__flat_extra__"  # free-form JSON rider (queue submissions)
_SHARD_FMT = "__flat_shard_{:04d}__"  # one entry per shard of a sharded row
_DELTA_SPEC = "__delta_spec__"      # codec geometry (compressed submissions)
_DELTA_IDX = "__delta_indices__"    # int16 [nb, kb]
_DELTA_VAL = "__delta_values__"     # int8  [nb, kb]
_DELTA_SCL = "__delta_scales__"     # f32   [nb]


def _host_array(x) -> Tuple[np.ndarray, bool]:
    """(numpy array, was bf16) for a tensor on any device or a numpy array;
    bf16 comes back as its uint16 bit pattern."""
    if isinstance(x, torch.Tensor):
        t = x.detach().to("cpu").contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), True
        return t.numpy(), False
    return np.asarray(x), False


def _bf16_tensor(bits: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(bits).view(np.int16)).view(torch.bfloat16)


def _atomic_savez(path: str, arrays: Dict[str, np.ndarray]) -> None:
    path = os.path.abspath(path)
    if not path.endswith(".npz"):  # np.savez semantics: ".npz" is appended
        path += ".npz"
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp-{os.getpid()}-{threading.get_ident()}"  # spill workers are threads
    try:
        np.savez(tmp, **arrays)
        if not tmp.endswith(".npz") and os.path.exists(tmp + ".npz"):
            tmp += ".npz"
        os.replace(tmp, path)
    except BaseException:
        for cand in (tmp, tmp + ".npz"):
            if os.path.exists(cand):
                os.remove(cand)
        raise


# -- tree format ------------------------------------------------------------


def save(path: str, tree) -> None:
    arrays = {}
    for p, leaf in tree_leaves_with_path(tree):
        arr, bf16 = _host_array(leaf)
        arrays[p.replace("/", _SEP) + (_BF16 if bf16 else "")] = arr
    _atomic_savez(path, arrays)


def load(path: str, device="cpu"):
    """A tree of tensors on ``device`` (bf16 leaves restored from bits)."""
    items = []
    with np.load(path) as data:
        for key in data.files:
            val = data[key]
            if key.endswith(_BF16):
                key, t = key[: -len(_BF16)], _bf16_tensor(val)
            else:
                t = torch.from_numpy(val)
            items.append((key.replace(_SEP, "/"), t.to(device)))
    return tree_from_paths(items)


# -- flat format ------------------------------------------------------------


def _json_entry(obj: Dict[str, Any]) -> np.ndarray:
    return np.frombuffer(json.dumps(obj).encode(), dtype=np.uint8)


def _read_json_entry(data, key: str) -> Dict[str, Any]:
    return json.loads(bytes(data[key]).decode())


def save_flat(path: str, buf, spec: FlatSpec, *,
              extra: Optional[Dict[str, Any]] = None) -> None:
    """Persist a flat row and its layout spec in one npz; ``extra`` rides
    along as a JSON entry (the queue's submission rider)."""
    arr, _ = _host_array(buf)
    arrays = {_FLAT_BUF: arr, _FLAT_SPEC: _json_entry(spec.to_json())}
    if extra is not None:
        arrays[_FLAT_EXTRA] = _json_entry(extra)
    _atomic_savez(path, arrays)


def load_flat(path: str) -> Tuple[torch.Tensor, FlatSpec]:
    """(host row, spec) written by ``save_flat`` in either package."""
    with np.load(path) as data:
        if _FLAT_BUF not in data.files:
            raise ValueError(f"{path} is not a flat checkpoint")
        spec = FlatSpec.from_json(_read_json_entry(data, _FLAT_SPEC))
        buf = data[_FLAT_BUF]
    row = _bf16_tensor(buf) if spec.dtype == "bfloat16" else torch.from_numpy(buf)
    return row, spec


def is_flat(path: str) -> bool:
    with np.load(path) as data:
        return _FLAT_BUF in data.files


def is_flat_sharded(path: str) -> bool:
    with np.load(path) as data:
        return _FLAT_SSPEC in data.files


def is_flat_compressed(path: str) -> bool:
    with np.load(path) as data:
        return _DELTA_SPEC in data.files


def save_flat_shards(path: str, slices: Sequence[Any], spec: FlatSpec,
                     sspec: ShardedFlatSpec, *, extra: Optional[Dict[str, Any]] = None) -> None:
    """Persist one flat row as its S block-cyclic slices, one npz entry a
    shard, plus both layout specs (and the optional rider)."""
    if len(slices) != sspec.n_shards:
        raise ValueError(f"{len(slices)} slices != n_shards {sspec.n_shards}")
    arrays = {_FLAT_SPEC: _json_entry(spec.to_json()),
              _FLAT_SSPEC: _json_entry(sspec.to_json())}
    if extra is not None:
        arrays[_FLAT_EXTRA] = _json_entry(extra)
    for i, part in enumerate(slices):
        arrays[_SHARD_FMT.format(i)], _ = _host_array(part)
    _atomic_savez(path, arrays)


class FlatShardReader:
    """Lazy per-shard reader of a ``save_flat_shards`` file (written by
    either package): ``shard(i)`` reads that shard's entry alone, so the
    sharded reload never holds the whole ``[N]`` row on the host.  bf16
    entries are stored as uint16 bits and come back as bf16 tensors.  Use
    it as a context manager (the zip file stays open between reads)."""

    def __init__(self, path: str):
        self.path = path
        self._data = np.load(path)
        if _FLAT_SSPEC not in self._data.files:
            self._data.close()
            raise ValueError(f"{path} is not a sharded flat checkpoint")
        self.spec = FlatSpec.from_json(_read_json_entry(self._data, _FLAT_SPEC))
        self.sspec = ShardedFlatSpec.from_json(_read_json_entry(self._data, _FLAT_SSPEC))

    def shard(self, i: int) -> torch.Tensor:
        """Shard ``i``'s ``[shard_len]`` slice, on the host."""
        buf = self._data[_SHARD_FMT.format(i)]
        return _bf16_tensor(buf) if self.spec.dtype == "bfloat16" else torch.from_numpy(buf)

    def full_row(self) -> torch.Tensor:
        """The ``[N]`` row put back together on the host (where the file's
        layout does not match the mesh it is staged on)."""
        return self.sspec.unshard_slices([self.shard(i) for i in range(self.sspec.n_shards)])

    def close(self) -> None:
        self._data.close()

    def __enter__(self) -> "FlatShardReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def flat_row_meta(path: str) -> Dict[str, Any]:
    """Peek a flat file's layout without reading its buffers: the
    ``FlatSpec`` JSON plus ``sharded`` (and ``shard_spec``), ``compressed``
    (and ``delta_spec``) and the rider under ``extra``."""
    with np.load(path) as data:
        if _FLAT_SPEC not in data.files:
            raise ValueError(f"{path} is not a flat checkpoint")
        meta = _read_json_entry(data, _FLAT_SPEC)
        meta["sharded"] = _FLAT_SSPEC in data.files
        if meta["sharded"]:
            meta["shard_spec"] = _read_json_entry(data, _FLAT_SSPEC)
        meta["compressed"] = _DELTA_SPEC in data.files
        if meta["compressed"]:
            meta["delta_spec"] = _read_json_entry(data, _DELTA_SPEC)
        if _FLAT_EXTRA in data.files:
            meta["extra"] = _read_json_entry(data, _FLAT_EXTRA)
    return meta


# -- delta-compressed flat format --------------------------------------------


def save_flat_delta(path: str, payloads, spec: FlatSpec, *,
                    sspec: Optional[ShardedFlatSpec] = None,
                    extra: Optional[Dict[str, Any]] = None) -> None:
    """Persist a compressed contribution: one whole-row ``DeltaPayload``,
    or S per-shard payloads with their ``sspec``, stacked along a leading
    axis (one entry per array, not per shard)."""
    if isinstance(payloads, DeltaPayload):
        if sspec is not None:
            raise ValueError("whole-row payload with a shard spec")
        plist = [payloads]
    else:
        plist = list(payloads)
        if sspec is None:
            raise ValueError("a payload list requires its ShardedFlatSpec")
        if len(plist) != sspec.n_shards:
            raise ValueError(f"{len(plist)} payloads != n_shards {sspec.n_shards}")
    p0 = plist[0]
    for p in plist:
        if (p.size, p.block, p.indices.shape) != (p0.size, p0.block, p0.indices.shape):
            raise ValueError("per-shard payload geometries differ")
    dspec = {"version": 1, "size": p0.size, "block": p0.block,
             "k_per_block": p0.k_per_block, "sharded": sspec is not None}
    arrays = {
        _FLAT_SPEC: _json_entry(spec.to_json()),
        _DELTA_SPEC: _json_entry(dspec),
        _DELTA_IDX: np.stack([p.indices for p in plist]),
        _DELTA_VAL: np.stack([p.values for p in plist]),
        _DELTA_SCL: np.stack([p.scales for p in plist]),
    }
    if sspec is None:
        for k in (_DELTA_IDX, _DELTA_VAL, _DELTA_SCL):
            arrays[k] = arrays[k][0]
    else:
        arrays[_FLAT_SSPEC] = _json_entry(sspec.to_json())
    if extra is not None:
        arrays[_FLAT_EXTRA] = _json_entry(extra)
    _atomic_savez(path, arrays)


def load_flat_delta(path: str) -> Tuple[List[DeltaPayload], Dict[str, Any]]:
    """(payloads, meta) of a ``save_flat_delta`` file: one payload for a
    whole-row file, S for a per-shard one.  A geometry mismatch or a torn
    entry raises."""
    meta = flat_row_meta(path)
    if not meta.get("compressed"):
        raise ValueError(f"{path} is not a compressed flat checkpoint")
    dspec = meta["delta_spec"]
    size, block, kb = int(dspec["size"]), int(dspec["block"]), int(dspec["k_per_block"])
    sharded = bool(dspec.get("sharded"))
    with np.load(path) as data:
        for k in (_DELTA_IDX, _DELTA_VAL, _DELTA_SCL):
            if k not in data.files:
                raise ValueError(f"{path}: missing delta entry {k}")
        idx, val, scl = data[_DELTA_IDX], data[_DELTA_VAL], data[_DELTA_SCL]
    if not sharded:
        idx, val, scl = idx[None], val[None], scl[None]
    n = idx.shape[0]
    if sharded:
        ss = ShardedFlatSpec.from_json(meta["shard_spec"])
        if n != ss.n_shards:
            raise ValueError(f"{path}: {n} payloads != n_shards {ss.n_shards}")
        if size != ss.shard_len:
            raise ValueError(f"{path}: payload size {size} != shard_len {ss.shard_len}")
    if val.shape[0] != n or scl.shape[0] != n:
        raise ValueError(f"{path}: delta entry leading dims disagree")
    payloads = []
    for i in range(n):
        p = DeltaPayload(idx[i], val[i], scl[i], size, block)
        if p.k_per_block != kb:
            raise ValueError(f"{path}: k_per_block {p.k_per_block} != declared {kb}")
        payloads.append(p)
    return payloads, meta


# -- atomic JSON and moves ---------------------------------------------------


def save_json_atomic(path: str, obj: Any, *, default=None,
                     indent: Optional[int] = 2) -> None:
    """Write JSON with the tmp + ``os.replace`` discipline; ``indent=None``
    writes compact single-line JSON (machine state rewritten often)."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp-{os.getpid()}-{threading.get_ident()}"
    try:
        with open(tmp, "w") as f:
            json.dump(obj, f, indent=indent, default=default)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise


def load_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def move_atomic(src: str, dst: str) -> None:
    """``os.replace`` into a directory created first: an observer sees the
    file at exactly one of the two paths."""
    dst = os.path.abspath(dst)
    os.makedirs(os.path.dirname(dst), exist_ok=True)
    os.replace(src, dst)


# -- append-only JSONL (the service's metrics series) -------------------------
#
# Strictly append-only, one JSON object per line: the only damage a killed
# O_APPEND writer can leave is a torn FINAL line, which readers skip.


def append_jsonl(path: str, obj: Any, *, default=None,
                 rotate_bytes: Optional[int] = None) -> None:
    """Append one record as a single ``\\n``-terminated line (built before
    the file is touched).  ``rotate_bytes`` first rotates a file at or past
    that size to ``<path>.1``; a series must have a single rotator."""
    line = json.dumps(obj, default=default)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    if rotate_bytes is not None:
        rotate_jsonl(path, rotate_bytes)
    with open(path, "a") as f:
        f.write(line + "\n")


def rotate_jsonl(path: str, max_bytes: int) -> bool:
    """Rotate ``path`` to ``path.1`` if it holds >= ``max_bytes`` bytes (one
    rotation slot).  Returns True if rotated."""
    try:
        size = os.path.getsize(path)
    except OSError:
        return False
    if size < max_bytes:
        return False
    os.replace(path, path + ".1")
    return True


def read_jsonl(path: str, *, warn: bool = True, include_rotated: bool = False) -> list:
    """The records in order.  A torn final line is skipped (with a warning);
    a malformed line anywhere else raises ``ValueError``; a missing file is
    an empty series."""
    if include_rotated:
        return read_jsonl(path + ".1", warn=warn) + read_jsonl(path, warn=warn)
    out = []
    try:
        with open(path) as f:
            lines = f.readlines()
    except FileNotFoundError:
        return out
    for i, line in enumerate(lines):
        stripped = line.strip()
        if not stripped:
            continue
        try:
            rec = json.loads(stripped)
        except json.JSONDecodeError as err:
            if i == len(lines) - 1:
                if warn:
                    warnings.warn(f"{path}: skipping torn final line "
                                  f"({len(stripped)} bytes): {err}")
                break
            raise ValueError(f"{path}: malformed record at line {i + 1} (not the "
                             f"torn tail a crash can leave): {err}") from err
        out.append(rec)
    return out


def repair_jsonl_tail(path: str) -> int:
    """Truncate a torn final line so the next append starts on a record
    boundary.  Returns the bytes truncated (0 when intact or missing)."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except FileNotFoundError:
        return 0
    keep = len(data)
    while keep > 0:
        if data[:keep].endswith(b"\n"):
            # the final terminated line must parse too, or it is torn
            last = data[:keep].rstrip(b"\n").rsplit(b"\n", 1)[-1]
            try:
                if last.strip():
                    json.loads(last.decode())
                break
            except (json.JSONDecodeError, UnicodeDecodeError):
                keep = len(data[:keep].rstrip(b"\n").rsplit(b"\n", 1)[0])
                if keep:
                    keep += 1  # keep the preceding line's newline
                continue
        keep -= 1
    torn = len(data) - keep
    if torn:
        with open(path, "r+b") as f:
            f.truncate(keep)
    return torn
