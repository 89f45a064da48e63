"""Parity of the port's service-loop building blocks with the JAX package's:
the delta codec (byte-identical payloads and checksums), the row sketch and
``CohortSketch``, the npz formats read across packages, and the plain
versions of the ``decode_accum`` and ``row_sketch`` kernels against
``repro.kernels.ref``.

Tolerances: codec, sketch-host and file comparisons are exact (same numpy
arithmetic, same bits).  ``row_sketch_plain`` rtol 1e-5 (its f32 tile sums
fold over buckets in another order than the reference's one-hot product).
``decode_accum_plain`` and ``fuse_flat_compressed`` atol 1e-6 (f32 sums of
the same products, in another order)."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import io as jio
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.utils import flat as jflat
from repro_torch.checkpoint import io as tio
from repro_torch.kernels import decode_accum as tda
from repro_torch.kernels import ops as tops
from repro_torch.kernels import row_sketch as trs
from repro_torch.utils import flat as tflat


def _bf16_pair(x: np.ndarray):
    """The same bf16 values as a numpy (ml_dtypes) array and a torch tensor."""
    j = np.asarray(jnp.asarray(x, jnp.bfloat16))
    t = torch.from_numpy(j.view(np.int16).copy()).view(torch.bfloat16)
    return j, t


def _rows(N, dtype, seed=0, zero_blocks=(), block=1024):
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(N,)).astype(np.float32)
    row = base + (0.01 * rng.normal(size=(N,))).astype(np.float32)
    for b in zero_blocks:  # blocks where the row equals the base exactly
        row[b * block:(b + 1) * block] = base[b * block:(b + 1) * block]
    if dtype == "float32":
        return (row, base), (torch.from_numpy(row), torch.from_numpy(base))
    (jr, tr), (jb, tb) = _bf16_pair(row), _bf16_pair(base)
    return (jr, jb), (tr, tb)


def _payload_bytes(p):
    return (p.indices.tobytes(), p.values.tobytes(), p.scales.tobytes(), p.size, p.block)


# -- the codec ---------------------------------------------------------------

CODEC_CASES = [  # (N, block, k_per_block, zero blocks)
    (5000, 1024, 64, (1,)),       # ragged last block, one all-zero block
    (4096, 1024, 0, ()),          # k_per_block 0
    (3000, 2048, 2048, (0,)),     # keep every slot of a block
    (70001, 4096, 7, (3, 17)),
    (100, 1024, 16, ()),          # shorter than one block
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N,block,kb,zeros", CODEC_CASES)
def test_delta_encode_is_byte_identical(dtype, N, block, kb, zeros):
    (jr, jb), (tr, tb) = _rows(N, dtype, seed=N, zero_blocks=zeros, block=block)
    jp = jflat.delta_encode(jr, jb, k_per_block=kb, block=block)
    tp = tflat.delta_encode(tr, tb, k_per_block=kb, block=block)
    assert _payload_bytes(tp) == _payload_bytes(jp)
    assert tflat.delta_checksum(tp) == jflat.delta_checksum(jp)
    assert tp.nbytes == jp.nbytes
    np.testing.assert_array_equal(tflat.delta_decode(tp, tb), jflat.delta_decode(jp, jb))
    for got, want in zip(tflat.delta_entries(tp), jflat.delta_entries(jp)):
        np.testing.assert_array_equal(got, want)


def test_delta_codec_error_bound():
    """Kept entries err by at most scale/2; dropped entries by their own
    magnitude, which is at most the smallest kept magnitude in their block.
    Magnitudes lie in [2**-10, 1], a range f32 holds exactly at its ends."""
    rng = np.random.default_rng(7)
    N, block, kb = 10_000, 1024, 100
    lo = 2.0 ** -10
    mag = lo + (1.0 - lo) * rng.random(N)
    d = (np.sign(rng.normal(size=N)) * mag).astype(np.float32)
    base = rng.normal(size=N).astype(np.float32)
    row = base + d
    delta = row - base  # the delta as f32 sees it
    p = tflat.delta_encode(torch.from_numpy(row), torch.from_numpy(base), k_per_block=kb,
                           block=block)
    dec = tflat.delta_decode(p)
    for b in range(p.n_blocks):
        lo_i, hi_i = b * block, min((b + 1) * block, N)
        kept = np.zeros(hi_i - lo_i, bool)
        kept[p.indices[b][p.indices[b] < hi_i - lo_i]] = True
        err = np.abs(dec[lo_i:hi_i] - delta[lo_i:hi_i]).astype(np.float64)
        limit_kept = 0.5 * float(p.scales[b]) * (1 + 2.0 ** -20)
        assert (err[kept] <= limit_kept).all()
        smallest_kept = np.abs(delta[lo_i:hi_i][kept]).min()
        assert (err[~kept] <= smallest_kept).all()
        assert (np.abs(delta[lo_i:hi_i][~kept]) <= smallest_kept).all()


def test_delta_payload_refuses_bad_geometry():
    ok = dict(indices=np.zeros((2, 4), np.int16), values=np.zeros((2, 4), np.int8),
              scales=np.zeros((2,), np.float32), size=2000, block=1024)
    tflat.DeltaPayload(**ok)
    for bad, match in [(dict(block=1000), "LANE multiple"),
                       (dict(indices=np.full((2, 4), 1024, np.int16)), "out of block range"),
                       (dict(values=np.zeros((2, 4), np.int16)), "dtypes"),
                       (dict(size=3000), "inconsistent")]:
        with pytest.raises(ValueError, match=match):
            tflat.DeltaPayload(**{**ok, **bad})


# -- the sketch --------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N,n_buckets", [(100, 32), (1024, 1), (5000, 7), (70_001, 32)])
def test_row_sketch_host_is_bit_equal(dtype, N, n_buckets):
    (jr, _), (tr, _) = _rows(N, dtype, seed=3)
    np.testing.assert_array_equal(tflat.row_sketch_host(tr, n_buckets),
                                  jflat.row_sketch_host(jr, n_buckets))


def test_cohort_sketch_matches_reference():
    rng = np.random.default_rng(5)
    N, nb = 40_000, 32
    base = rng.normal(size=N).astype(np.float32)
    rows = [base + (s * rng.normal(size=N)).astype(np.float32) for s in (0.01, 0.01, 0.3)]
    rows.append(rows[0].copy())  # a replay
    sks = [jflat.row_sketch_host(r, nb) for r in rows]
    jsk, tsk = jflat.CohortSketch(N, nb, window=3), tflat.CohortSketch(N, nb, window=3)
    for sk in (jsk, tsk):
        sk.set_base(jflat.row_sketch_host(base, nb), iteration=4)
        for i, s in enumerate(sks[:3]):
            sk.add(f"r{i}", s, file=f"r{i}.npz")
    for a in sks:
        for b in sks:
            assert tsk.distance(a, b) == jsk.distance(a, b)
    assert tsk.match(sks[3], 0.01) == jsk.match(sks[3], 0.01) == ("r0", 0.0)
    assert tsk.match(sks[3], 0.01, skip_id="r0", skip_file="r0.npz") == \
        jsk.match(sks[3], 0.01, skip_id="r0", skip_file="r0.npz")
    assert tsk.to_json() == jsk.to_json()
    back = tflat.CohortSketch.from_json(jsk.to_json())
    assert back.to_json() == jsk.to_json()
    assert jflat.CohortSketch.from_json(tsk.to_json()).to_json() == tsk.to_json()


def test_sketch_apply_delta_matches_reference():
    rng = np.random.default_rng(9)
    N = 9000
    base = rng.normal(size=N).astype(np.float32)
    row = base + (0.05 * rng.normal(size=N)).astype(np.float32)
    p = tflat.delta_encode(torch.from_numpy(row), torch.from_numpy(base), k_per_block=50)
    gi, dv = tflat.delta_entries(p)
    bsk = tflat.row_sketch_host(base)
    got = tflat.sketch_apply_delta(bsk, gi, dv, base[gi])
    np.testing.assert_array_equal(got, jflat.sketch_apply_delta(bsk, gi, dv, base[gi]))
    # the corrected sketch is the sketch of the decoded row, up to rounding
    np.testing.assert_allclose(got, tflat.row_sketch_host(tflat.delta_decode(p, base)),
                               rtol=1e-5, atol=1e-3)


# -- files across packages ----------------------------------------------------


def _tree(dtype, seed=0):
    rng = np.random.default_rng(seed)
    leaves = {"layer10/w": (3, 4), "layer2/w": (5,), "embed": (7, 2)}
    j, t = {}, {}
    for path, shape in leaves.items():
        x = rng.normal(size=shape).astype(np.float32)
        if dtype == "bfloat16":
            jx, tx = _bf16_pair(x)
        else:
            jx, tx = x, torch.from_numpy(x)
        node_j, node_t = j, t
        *parents, leaf = path.split("/")
        for p_ in parents:
            node_j, node_t = node_j.setdefault(p_, {}), node_t.setdefault(p_, {})
        node_j[leaf], node_t[leaf] = jx, tx
    return j, t


def _bits(x):
    a = x.view(torch.int16).numpy() if isinstance(x, torch.Tensor) and \
        x.dtype == torch.bfloat16 else np.asarray(x)
    return a.view(np.uint16) if a.dtype.name in ("bfloat16", "int16") else a


def _flat_leaves(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        p = f"{prefix}/{k}" if prefix else k
        out.update(_flat_leaves(v, p) if isinstance(v, dict) else {p: v})
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tree_npz_reads_across_packages(tmp_path, dtype):
    jt, tt = _tree(dtype)
    jio.save(str(tmp_path / "j.npz"), jt)
    tio.save(str(tmp_path / "t.npz"), tt)
    for path in ("j.npz", "t.npz"):
        got_t = _flat_leaves(tio.load(str(tmp_path / path)))
        got_j = _flat_leaves(jio.load(str(tmp_path / path), as_jax=False))
        assert sorted(got_t) == sorted(got_j) == sorted(_flat_leaves(tt))
        for k, v in _flat_leaves(tt).items():
            np.testing.assert_array_equal(_bits(got_t[k]), _bits(v))
            np.testing.assert_array_equal(_bits(got_j[k]), _bits(v))
            assert got_t[k].dtype == v.dtype


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flat_and_delta_files_read_across_packages(tmp_path, dtype):
    jt, tt = _tree(dtype, seed=1)
    jspec, tspec = jflat.FlatSpec.from_tree(jt), tflat.FlatSpec.from_tree(tt)
    jrow, trow = np.asarray(jspec.flatten(jt)), tspec.flatten(tt)
    extra = {"id": "x-000001", "weight": 2.0, "base_iteration": 3}
    jio.save_flat(str(tmp_path / "j.npz"), jrow, jspec, extra=extra)
    tio.save_flat(str(tmp_path / "t.npz"), trow, tspec, extra=extra)
    for path in ("j.npz", "t.npz"):
        p = str(tmp_path / path)
        assert tio.flat_row_meta(p) == jio.flat_row_meta(p)
        trow2, tspec2 = tio.load_flat(p)
        jrow2, jspec2 = jio.load_flat(p, as_jax=False)
        assert tspec2.to_json() == jspec2.to_json() == tspec.to_json()
        np.testing.assert_array_equal(_bits(trow2), _bits(trow))
        np.testing.assert_array_equal(_bits(jrow2), _bits(trow))
        assert tio.is_flat(p) and not tio.is_flat_compressed(p)
    # compressed submissions
    rng = np.random.default_rng(2)
    tnew = trow.float() + torch.from_numpy(0.01 * rng.normal(size=trow.shape[0]).astype(np.float32))
    tp = tflat.delta_encode(tnew, trow, k_per_block=3)
    jp = jflat.delta_encode(tnew.numpy(), jrow, k_per_block=3)
    jio.save_flat_delta(str(tmp_path / "jd.npz"), jp, jspec, extra=extra)
    tio.save_flat_delta(str(tmp_path / "td.npz"), tp, tspec, extra=extra)
    for path in ("jd.npz", "td.npz"):
        p = str(tmp_path / path)
        assert tio.flat_row_meta(p) == jio.flat_row_meta(p)
        assert tio.is_flat_compressed(p) and jio.is_flat_compressed(p)
        (tq,), tmeta = tio.load_flat_delta(p)
        (jq,), _ = jio.load_flat_delta(p)
        assert _payload_bytes(tq) == _payload_bytes(jq) == _payload_bytes(jp)
        assert tmeta["extra"] == extra


def test_sharded_files_are_reported_and_refused(tmp_path):
    """Per-shard files the reference writes are reported as it reports them
    and now read in the port (the full parity is in tests/test_torch_mesh.py);
    what is still refused is a malformed one: a per-shard delta file whose
    payload count is not its shard count, and a whole-row file opened as
    per-shard."""
    spec = jflat.FlatSpec.from_tree({"w": jnp.zeros((3000,), jnp.float32)})
    sspec = jflat.ShardedFlatSpec.from_spec(spec, 2, block=1024)
    row = np.arange(3000, dtype=np.float32)
    path = str(tmp_path / "s.npz")
    jio.save_flat_shards(path, sspec.shard_slices(row), spec, sspec)
    meta = tio.flat_row_meta(path)
    assert meta["sharded"] and meta == jio.flat_row_meta(path)
    assert tio.is_flat_sharded(path)
    with tio.FlatShardReader(path) as r:
        np.testing.assert_array_equal(r.full_row().numpy(), row)
    dpath = str(tmp_path / "sd.npz")
    payloads = jflat.delta_encode_sharded(row + 1, row, sspec, k_per_block=4)
    jio.save_flat_delta(dpath, payloads, spec, sspec=sspec)
    got, _ = tio.load_flat_delta(dpath)
    assert [_payload_bytes(p) for p in got] == [_payload_bytes(p) for p in payloads]
    bad = str(tmp_path / "bad.npz")
    three = jflat.ShardedFlatSpec.from_spec(spec, 3, block=1024)
    jio.save_flat_delta(bad, payloads, spec, sspec=sspec)
    with np.load(bad) as data:  # the same payloads under a 3-shard spec
        arrays = dict(data)
    arrays["__flat_shard_spec__"] = np.frombuffer(
        json.dumps(three.to_json()).encode(), dtype=np.uint8)
    np.savez(bad, **arrays)
    with pytest.raises(ValueError, match="payloads != n_shards 3"):
        tio.load_flat_delta(bad)
    whole = str(tmp_path / "w.npz")
    tio.save_flat(whole, torch.from_numpy(row), tflat.FlatSpec.from_tree(
        {"w": torch.zeros(3000)}))
    with pytest.raises(ValueError, match="not a sharded flat checkpoint"):
        tio.FlatShardReader(whole)


def test_jsonl_series_tolerates_a_torn_tail(tmp_path):
    path = str(tmp_path / "m.jsonl")
    for i in range(3):
        tio.append_jsonl(path, {"i": i})
    with open(path, "a") as f:
        f.write('{"i": 3, "tor')
    assert [r["i"] for r in jio.read_jsonl(path, warn=False)] == [0, 1, 2]
    assert tio.repair_jsonl_tail(path) == len('{"i": 3, "tor')
    tio.append_jsonl(path, {"i": 4}, rotate_bytes=10)
    assert [r["i"] for r in tio.read_jsonl(path, include_rotated=True)] == [0, 1, 2, 4]
    assert [r["i"] for r in jio.read_jsonl(path, include_rotated=True)] == [0, 1, 2, 4]


# -- the kernels' plain versions ---------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N,n_buckets", [(100, 32), (1024, 32), (5000, 7), (70_001, 32),
                                         (200_000, 3)])
def test_row_sketch_plain_matches_reference(dtype, N, n_buckets):
    (jr, _), (tr, _) = _rows(N, dtype, seed=11)
    want = np.asarray(jref.row_sketch(jnp.asarray(jr), n_buckets))
    before = trs.row_sketch.launches
    got = tops.row_sketch(tr, n_buckets)
    assert trs.row_sketch.launches == before  # the CPU takes the plain version
    assert got.shape == (2, n_buckets) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got.numpy(), trs.row_sketch_plain(tr, n_buckets).numpy())


def _payloads(C, N, block, kb, seed, nan_row=None, dup=True):
    rng = np.random.default_rng(seed)
    nb = -(-N // block)
    idx = rng.integers(0, block, size=(C, nb, kb)).astype(np.int16)
    if dup and kb >= 2:
        idx[:, :, 1] = idx[:, :, 0]  # duplicate offsets add up
    val = rng.integers(-127, 128, size=(C, nb, kb)).astype(np.int8)
    scl = (rng.random((C, nb)) * 1e-2).astype(np.float32)
    w = (rng.random(C) + 0.5).astype(np.float32)
    if nan_row is not None:
        scl[nan_row] = np.nan
        w[nan_row] = 0.0
    return idx, val, scl, w


@pytest.mark.parametrize("C,N,block,kb,nan_row", [
    (4, 10_000, 1024, 64, None),
    (5, 10_000, 1024, 64, 2),      # a NaN-scale row of weight 0
    (1, 3000, 2048, 2048, None),   # every slot, one contributor
    (3, 70_001, 32768, 17, 0),     # the largest codec block, ragged size
])
def test_decode_accum_plain_matches_reference(C, N, block, kb, nan_row):
    idx, val, scl, w = _payloads(C, N, block, kb, seed=C * N, nan_row=nan_row)
    dv = val.astype(np.float32) * scl[..., None]
    want_acc, want_sq = jref.decode_accum(jnp.asarray(idx, jnp.int32), jnp.asarray(dv),
                                          jnp.asarray(w), size=N, block=block)
    before = tda.decode_accum.launches
    acc, sq = tops.decode_accum(torch.from_numpy(idx), torch.from_numpy(val),
                                torch.from_numpy(scl), torch.from_numpy(w), size=N, block=block)
    assert tda.decode_accum.launches == before
    assert acc.shape == (N,) and sq.shape == (C,)
    assert bool(torch.isfinite(acc).all())
    np.testing.assert_allclose(acc.numpy(), np.asarray(want_acc), rtol=0, atol=1e-6)
    np.testing.assert_allclose(sq.numpy(), np.asarray(want_sq), rtol=1e-6)
    if nan_row is not None:
        assert np.isnan(sq[nan_row].item()) and np.isnan(np.asarray(want_sq)[nan_row])


def test_decode_accum_empty_cohort_or_slots_give_zeros():
    for C, kb in ((0, 8), (3, 0)):
        idx, val, scl, w = _payloads(max(C, 1), 5000, 1024, kb, seed=1)
        idx, val, scl, w = idx[:C], val[:C], scl[:C], w[:C]
        acc, sq = tops.decode_accum(torch.from_numpy(idx), torch.from_numpy(val),
                                    torch.from_numpy(scl), torch.from_numpy(w),
                                    size=5000, block=1024)
        jacc, jsq = jops.decode_accum(idx, val, scl, w, size=5000, block=1024)
        assert acc.shape == (5000,) and sq.shape == (C,)
        assert not acc.any() and not sq.any()
        np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))


def test_decode_accum_refuses_what_it_does_not_take():
    idx, val, scl, w = _payloads(2, 5000, 1024, 8, seed=2)
    args = [torch.from_numpy(a) for a in (idx, val, scl, w)]
    with pytest.raises(ValueError, match="do not cover"):
        tops.decode_accum(*args, size=9000, block=1024)
    with pytest.raises(ValueError, match="multiple of 1024"):
        tops.decode_accum(*args, size=5000, block=1000)
    with pytest.raises(ValueError, match="scales"):
        tops.decode_accum(*args[:2], args[2][:, :2], args[3], size=5000, block=1024)


@pytest.mark.parametrize("n_dense", [0, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fuse_flat_compressed_matches_reference(n_dense, dtype):
    N, block, C = 9000, 1024, 3
    rng = np.random.default_rng(n_dense)
    (jb, _), (tb, _) = _rows(N, dtype, seed=21)
    idx, val, scl, w = _payloads(C, N, block, 32, seed=22, nan_row=1)
    dense = (np.asarray(jb, np.float32)[None]
             + 0.01 * rng.normal(size=(n_dense, N))).astype(np.float32)
    wd = (rng.random(n_dense) + 0.5).astype(np.float32)
    if dtype == "float32":
        jd, td = dense, torch.from_numpy(dense)
    else:
        jd, td = _bf16_pair(dense)
    kw = dict(dense=jd, dense_weights=wd) if n_dense else {}
    jf, jsq = jops.fuse_flat_compressed(jnp.asarray(jb), idx, val, scl, w, 0.7, block=block,
                                        **kw)
    tkw = dict(dense=td, dense_weights=torch.from_numpy(wd)) if n_dense else {}
    tf, tsq = tops.fuse_flat_compressed(tb, torch.from_numpy(idx), torch.from_numpy(val),
                                        torch.from_numpy(scl), torch.from_numpy(w), 0.7,
                                        block=block, **tkw)
    base_before = tb.clone()
    assert tf.dtype == tb.dtype and tsq.shape == (n_dense + C,)
    assert torch.equal(tb, base_before)  # the base is never written
    got, want = tf.float().numpy(), np.asarray(jf).astype(np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    else:  # 1 bf16 ulp: the f32 sums may round the other way
        ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126))) - 7)
        assert (np.abs(got - want) <= ulp).all()
    np.testing.assert_allclose(tsq.numpy(), np.asarray(jsq), rtol=1e-5)
