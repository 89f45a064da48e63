"""The port's mesh layer against the JAX package's: ``ShardedFlatSpec``
geometry and rearrangements, the per-shard files and payloads read both
ways, the mesh and placement helpers, ``host_tuning``, and the three
sharded ops on an 8-shard CPU mesh against the reference's ``shard_map``
ops on 8 forced CPU devices (one subprocess for every case, read back with
``np.asarray``: the reference's ``ShardedFlatSpec.unshard`` of a sharded
``jax.Array`` raises in this jax, see ROADMAP §C).

Tolerances: geometry, files, payload bytes and checksums are exact.  Fused
rows atol 1e-5 in f32 (the per-shard fuse and the reference's sum the same
rows in another order), 1 bf16 ulp in bf16; ``sq_diff`` rtol 1e-4 (f32
partial sums in another order), NaN where the reference is NaN; sketches
within 1e-5 of each bucket's sum of |x| (sums) or of x² (sums of squares),
the bucket assignment being exact."""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import io as jio
from repro.kernels import ref as jref
from repro.launch import host_tuning as jht
from repro.launch import mesh as jmesh
from repro.utils import flat as jflat
from repro_torch.checkpoint import io as tio
from repro_torch.kernels import ops as tops
from repro_torch.kernels import row_sketch as trs
from repro_torch.launch import host_tuning as tht
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding as tsh
from repro_torch.utils import flat as tflat

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S = 8
N_BIG = 600_000     # the default 64 Ki block: G = 2, shard_len 131,072
N_SMALL = 200_000   # a clamped block of 25,600 (25 tiles, not a multiple of 32)


def _bf16_ulp(x):
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126))) - 7)


# -- ShardedFlatSpec ------------------------------------------------------------


@pytest.mark.parametrize("size", [1, 1023, 1024, 200_000, 3_000_001])
@pytest.mark.parametrize("n_shards", [1, 3, 8])
@pytest.mark.parametrize("block", [None, tflat.DEFAULT_SHARD_BLOCK], ids=["clamped", "default"])
def test_sharded_flat_spec_matches_the_reference(size, n_shards, block):
    t = tflat.ShardedFlatSpec.for_size(size, n_shards, block)
    j = jflat.ShardedFlatSpec.for_size(size, n_shards, block)
    assert (t.size, t.n_shards, t.block) == (j.size, j.n_shards, j.block)
    assert (t.n_super, t.padded_size, t.shard_len) == (j.n_super, j.padded_size, j.shard_len)
    assert t.to_json() == j.to_json() and tflat.ShardedFlatSpec.from_json(j.to_json()) == t
    rng = np.random.default_rng(size + n_shards)
    for i in {0, size - 1, *rng.integers(0, size, 16).tolist()}:
        assert t.shard_of(int(i)) == j.shard_of(int(i))
    off = rng.integers(0, t.shard_len, 64)
    for s in range(n_shards):
        np.testing.assert_array_equal(t.global_of(s, off), j.global_of(s, off))
    row = rng.normal(size=size).astype(np.float32)
    ts, js = t.shard_slices(row), j.shard_slices(row)
    assert len(ts) == len(js) == n_shards
    for a, b in zip(ts, js):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(t.unshard_slices(js), j.unshard_slices(js))
    tt = t.shard_slices(torch.from_numpy(row))  # the tensor form, slice for slice
    for a, b in zip(tt, js):
        np.testing.assert_array_equal(a.numpy(), b)
    if size <= 200_000:  # the reference's jnp rearrangement on one device
        np.testing.assert_array_equal(t.shard(torch.from_numpy(row)).numpy(),
                                      np.asarray(j.shard(jnp.asarray(row))))
        np.testing.assert_array_equal(t.unshard(t.shard(torch.from_numpy(row))).numpy(), row)
    with pytest.raises(ValueError):
        t.shard_of(size)


def test_sharded_flat_spec_refuses_what_the_reference_refuses():
    for bad in (dict(size=10, n_shards=0), dict(size=10, n_shards=2, block=1000)):
        with pytest.raises(ValueError):
            jflat.ShardedFlatSpec.for_size(**bad)
        with pytest.raises(ValueError):
            tflat.ShardedFlatSpec.for_size(**bad)
    sb = tflat.StagedBuffer.from_rows([[torch.zeros(4), torch.ones(4)]] * 3)
    assert sb.sharded and sb.k == 3 and [tuple(d.shape) for d in sb.data] == [(3, 4)] * 2
    assert not tflat.StagedBuffer.from_rows([torch.zeros(4)]).sharded
    assert tflat.StagedBuffer(torch.zeros(3, 2, 4)).sharded


# -- files both ways -------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_shard_files_read_both_ways(tmp_path, dtype):
    N = 5000
    rng = np.random.default_rng(3)
    row32 = rng.normal(size=N).astype(np.float32)
    jrow = row32.astype(jnp.bfloat16) if dtype == "bfloat16" else row32
    trow = torch.from_numpy(row32).to(getattr(torch, dtype))
    jspec = jflat.FlatSpec.from_tree({"w": jnp.asarray(jrow)})
    tspec = tflat.FlatSpec.from_tree({"w": trow})
    assert tspec.to_json() == jspec.to_json()
    jss, tss = jflat.ShardedFlatSpec.from_spec(jspec, 3), tflat.ShardedFlatSpec.from_spec(tspec, 3)
    extra = {"id": "c0-000000", "weight": 2.0}
    jp, tp = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jio.save_flat_shards(jp, jss.shard_slices(jrow), jspec, jss, extra=extra)
    tio.save_flat_shards(tp, tss.shard_slices(trow), tspec, tss, extra=extra)
    for p in (jp, tp):
        assert tio.flat_row_meta(p) == jio.flat_row_meta(p)
        assert tio.is_flat_sharded(p) and jio.is_flat_sharded(p)
        with tio.FlatShardReader(p) as tr, jio.FlatShardReader(p) as jr:
            assert tr.sspec.to_json() == jr.sspec.to_json() == tss.to_json()
            assert tr.spec.to_json() == jspec.to_json()
            for s in range(3):
                assert tr.shard(s).dtype == trow.dtype
                np.testing.assert_array_equal(tr.shard(s).float().numpy(),
                                              np.asarray(jr.shard(s), np.float32))
            np.testing.assert_array_equal(tr.full_row().float().numpy(), row32 if
                                          dtype == "float32" else
                                          np.asarray(jrow, np.float32))
            np.testing.assert_array_equal(np.asarray(jr.full_row(), np.float32),
                                          tr.full_row().float().numpy())
    with np.load(jp) as a, np.load(tp) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])


def test_sharded_payloads_and_checksums_match(tmp_path):
    N = 70_001
    rng = np.random.default_rng(5)
    base = rng.normal(size=N).astype(np.float32)
    row = base + 0.01 * rng.normal(size=N).astype(np.float32)
    jss = jflat.ShardedFlatSpec.for_size(N, 4)
    tss = tflat.ShardedFlatSpec.for_size(N, 4)
    jps = jflat.delta_encode_sharded(row, base, jss, k_per_block=16)
    tps = tflat.delta_encode_sharded(torch.from_numpy(row), torch.from_numpy(base), tss,
                                     k_per_block=16)
    for a, b in zip(tps, jps):
        for f in ("indices", "values", "scales"):
            assert getattr(a, f).tobytes() == getattr(b, f).tobytes()
        assert (a.size, a.block) == (b.size, b.block)
    assert tflat.delta_checksum(tps) == jflat.delta_checksum(jps)
    np.testing.assert_array_equal(tflat.delta_decode_sharded(tps, tss, base),
                                  jflat.delta_decode_sharded(jps, jss, base))
    jspec = jflat.FlatSpec.from_tree({"w": jnp.zeros((N,), jnp.float32)})
    tspec = tflat.FlatSpec.from_tree({"w": torch.zeros(N)})
    jp, tp = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jio.save_flat_delta(jp, jps, jspec, sspec=jss, extra={"id": "x"})
    tio.save_flat_delta(tp, tps, tspec, sspec=tss, extra={"id": "x"})
    for p in (jp, tp):
        assert tio.flat_row_meta(p) == jio.flat_row_meta(p)
        got, meta = tio.load_flat_delta(p)
        want, _ = jio.load_flat_delta(p)
        assert meta["delta_spec"]["sharded"] and len(got) == 4
        assert tflat.delta_checksum(got) == jflat.delta_checksum(want)
    with np.load(jp) as a, np.load(tp) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
    with pytest.raises(ValueError, match="whole-row payload with a shard spec"):
        tio.save_flat_delta(tp, tps[0], tspec, sspec=tss)
    with pytest.raises(ValueError, match="requires its ShardedFlatSpec"):
        tio.save_flat_delta(tp, tps, tspec)


# -- meshes and placement ----------------------------------------------------------


def test_mesh_and_placement():
    m = tmesh.make_mesh((2, 4), ("replica", "model"), device="cpu")
    assert m.axis_names == ("replica", "model") and dict(m.shape) == {"replica": 2, "model": 4}
    assert m.devices.size == 8 and all(d == torch.device("cpu") for d in m.devices.flat)
    assert tsh.norm_axes("model") == ("model",) and tsh.axes_extent(m, ("replica", "model")) == 8
    assert tsh.axes_extent(m, "model") == 4 and len(tsh.flat_row_sharding(m, "model")) == 4
    # the placement follows the reference's shard numbering: first axis most significant
    tagged = tmesh.Mesh(np.arange(8, dtype=object).reshape(2, 4), ("replica", "model"))
    assert tsh.flat_row_sharding(tagged, ("replica", "model")) == tuple(range(8))
    assert tsh.flat_row_sharding(tagged, ("model", "replica")) == (0, 4, 1, 5, 2, 6, 3, 7)
    assert tsh.flat_row_sharding(tagged, "model") == (0, 1, 2, 3)
    assert tsh.flat_row_sharding(tagged, "replica") == (0, 4)
    for kw in (dict(), dict(multi_pod=True)):
        pm = tmesh.make_production_mesh(device="cpu", **kw)
        assert tuple(pm.devices.shape) == ((2, 16, 16) if kw else (16, 16))
    cm = tmesh.make_cold_mesh(contributors=2, replicas=2, model=2, device="cpu")
    assert cm.axis_names == ("contrib", "replica", "model")
    assert tmesh.data_axes(cm) == jmesh.data_axes(cm) == ("contrib", "replica")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmesh.make_mesh((8,), ("model",))
    parts = tsh.stage_row_from_shards(m, "model", 4, 3, lambda i: torch.full((3,), float(i)))
    assert [p.tolist() for p in parts] == [[float(i)] * 3 for i in range(4)]
    tmesh.reset_collectives()
    assert tmesh.all_reduce_sum(parts, m).tolist() == [6.0] * 3
    assert tuple(tmesh.all_gather(parts, m).shape) == (4, 3)
    assert tmesh.collectives == {"all_reduce": 1, "all_gather": 1, "reduce_scatter": 0}


# -- host tuning --------------------------------------------------------------------


def test_host_tuning_matches_the_reference(tmp_path, monkeypatch):
    assert tht.TCMALLOC_CANDIDATES == jht.TCMALLOC_CANDIDATES
    assert tht.LARGE_ALLOC_THRESHOLD == jht.LARGE_ALLOC_THRESHOLD
    fake = tmp_path / "libtcmalloc.so.4"
    monkeypatch.delenv("TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD", raising=False)  # restored after
    for cands in ((str(tmp_path / "missing.so"),), (str(tmp_path / "missing.so"), str(fake))):
        monkeypatch.setattr(tht, "TCMALLOC_CANDIDATES", cands)
        monkeypatch.setattr(jht, "TCMALLOC_CANDIDATES", cands)
        for present in (False, True):
            if present:
                fake.write_bytes(b"")
            elif fake.exists():
                fake.unlink()
            monkeypatch.setenv("LD_PRELOAD", "/lib/other.so")
            assert tht.tcmalloc_path() == jht.tcmalloc_path()
            assert tht.host_tuning_env() == jht.host_tuning_env()
            calls = {}
            for mod in (tht, jht):
                monkeypatch.setattr(mod.os, "execve",
                                    lambda exe, argv, env, m=mod: calls.__setitem__(
                                        m.__name__, (argv, dict(env))))
                for env_on in ("0", "1"):
                    monkeypatch.setenv("REPRO_HOST_TUNING", env_on)
                    monkeypatch.delenv("REPRO_HOST_TUNING_APPLIED", raising=False)
                    monkeypatch.setenv("LD_PRELOAD", "/lib/other.so")
                    mod.maybe_reexec()
                    mod.maybe_reexec()  # the marker: never a second re-exec
            assert calls.get(tht.__name__) == calls.get(jht.__name__)
            assert (tht.__name__ in calls) == (present and str(fake) in cands)
    assert tht.enabled({"REPRO_HOST_TUNING": "1"}) and not tht.enabled({})
    with pytest.raises(SystemExit):
        tht._main(["--device-count", "8"])


def test_host_tuning_cli_names_the_mesh():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), REPRO_HOST_TUNING="1")
    cmd = [sys.executable, "-m", "repro_torch.launch.host_tuning"]
    bad = subprocess.run(cmd + ["--device-count", "8"], env=env, capture_output=True,
                         text=True, timeout=60)
    assert bad.returncode == 2 and "--mesh" in bad.stderr
    ok = subprocess.run(cmd + ["--force"], env=env, capture_output=True, text=True, timeout=60)
    assert ok.returncode == 0
    assert all(line.startswith("export ") for line in ok.stdout.splitlines())


# -- the sharded ops against the reference's shard_map ops ---------------------------

_REF_SCRIPT = r"""
import sys
import numpy as np
import jax, jax.numpy as jnp
from repro.kernels import ops
from repro.launch.sharding import flat_row_sharding, flat_stage_sharding
from repro.utils.flat import ShardedFlatSpec
src, dst = sys.argv[1], sys.argv[2]
mesh = jax.make_mesh((8,), ("model",))
ax = ("model",)
inp = dict(np.load(src))
out = {}
def row(a, ss):
    return jax.device_put(ss.shard(jnp.asarray(a)), flat_row_sharding(mesh, ax))
def stage(a, ss):
    return jax.device_put(ss.shard(jnp.asarray(a)), flat_stage_sharding(mesh, ax))
for case in sorted({k.split("/")[0] for k in inp}):
    g = {k.split("/", 1)[1]: v for k, v in inp.items() if k.startswith(case + "/")}
    kind = str(g["kind"])
    N = int(g["N"])
    ss = ShardedFlatSpec.for_size(N, 8)
    dt = jnp.bfloat16 if str(g["dtype"]) == "bfloat16" else jnp.float32
    base = jnp.asarray(g["base"]).astype(dt)
    if kind == "fuse":
        f, sq = ops.fuse_flat_sharded(row(base, ss), stage(jnp.asarray(g["stage"]).astype(dt), ss),
                                      jnp.asarray(g["w"]), float(g["alpha"]), mesh=mesh, axes=ax)
    elif kind == "comp":
        kw = {}
        if "dense" in g:
            kw = dict(dense=stage(jnp.asarray(g["dense"]).astype(dt), ss),
                      dense_weights=jnp.asarray(g["wd"]))
        f, sq = ops.fuse_flat_compressed_sharded(
            row(base, ss), g["idx"], g["val"], g["scl"], jnp.asarray(g["wc"]), float(g["alpha"]),
            mesh=mesh, axes=ax, block=int(g["block"]), **kw)
    else:
        out[case + "/sketch"] = np.asarray(ops.row_sketch_sharded(
            row(base, ss), mesh=mesh, axes=ax, block=ss.block, n_buckets=32))
        continue
    out[case + "/fused"] = np.asarray(f.astype(jnp.float32))
    out[case + "/sq"] = np.asarray(sq)
np.savez(dst, **out)
"""


def _cases():
    rng = np.random.default_rng(7)
    cases = {}

    def noisy(base, k, scale=0.01):
        return (base[None] + scale * rng.normal(size=(k, base.shape[0]))).astype(np.float32)

    for name, N, dtype, alpha in (("fuse_a", N_SMALL, "float32", 1.0),
                                  ("fuse_b", N_SMALL, "float32", 0.3),
                                  ("fuse_c", N_BIG, "bfloat16", 1.0)):
        base = rng.normal(size=N).astype(np.float32)
        stage = noisy(base, 4)
        stage[2] = np.nan  # weight 0: masked out of the fuse, NaN in its sq
        cases[name] = dict(kind="fuse", N=N, dtype=dtype, alpha=alpha, base=base, stage=stage,
                           w=np.array([1.0, 2.0, 0.0, 0.5], np.float32))
    for name, dense in (("comp_a", False), ("comp_b", True)):
        N = N_BIG
        base = rng.normal(size=N).astype(np.float32)
        ss = jflat.ShardedFlatSpec.for_size(N, S)
        pays = [jflat.delta_encode_sharded(r, base, ss, k_per_block=16) for r in noisy(base, 3)]
        c = dict(kind="comp", N=N, dtype="float32", alpha=0.5, base=base, block=1024,
                 idx=np.stack([[p.indices for p in pl] for pl in pays]),
                 val=np.stack([[p.values for p in pl] for pl in pays]),
                 scl=np.stack([[p.scales for p in pl] for pl in pays]),
                 wc=np.array([1.0, 0.0, 2.0], np.float32))
        if dense:
            c.update(dense=noisy(base, 2), wd=np.array([1.5, 1.0], np.float32))
        cases[name] = c
    for name, N, dtype in (("sketch_a", N_BIG, "float32"), ("sketch_b", N_SMALL, "bfloat16")):
        cases[name] = dict(kind="sketch", N=N, dtype=dtype,
                           base=rng.normal(size=N).astype(np.float32))
    return cases


@pytest.fixture(scope="module")
def reference_ops(tmp_path_factory):
    """Every case through the reference's sharded ops, in one subprocess on
    8 forced CPU devices (jax starts once)."""
    d = tmp_path_factory.mktemp("ref_ops")
    cases = _cases()
    np.savez(d / "in.npz", **{f"{c}/{k}": np.asarray(v) for c, g in cases.items()
                              for k, v in g.items()})
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    proc = subprocess.run([sys.executable, "-c", _REF_SCRIPT, str(d / "in.npz"),
                           str(d / "out.npz")], env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(d / "out.npz") as out:
        return cases, dict(out)


def _t(a, dtype):
    return torch.from_numpy(np.asarray(a, np.float32)).to(getattr(torch, dtype))


@pytest.mark.parametrize("case", ["fuse_a", "fuse_b", "fuse_c", "comp_a", "comp_b"])
def test_sharded_fuse_matches_the_reference(reference_ops, case):
    cases, out = reference_ops
    g = cases[case]
    N, dt = g["N"], g["dtype"]
    mesh = tmesh.make_mesh((S,), ("model",), device="cpu")
    ss = tflat.ShardedFlatSpec.for_size(N, S)
    base = ss.shard_slices(_t(g["base"], dt))
    tmesh.reset_collectives()
    if g["kind"] == "fuse":
        stage = ss.shard(_t(g["stage"], dt))  # the reference's [K, S, L] layout
        fused, sq = tops.fuse_flat_sharded(base, stage, torch.from_numpy(g["w"]), g["alpha"],
                                           mesh=mesh, axes=("model",))
    else:
        kw = {}
        if "dense" in g:
            kw = dict(dense=ss.shard(_t(g["dense"], dt)), dense_weights=torch.from_numpy(g["wd"]))
        fused, sq = tops.fuse_flat_compressed_sharded(
            base, torch.from_numpy(g["idx"]), torch.from_numpy(g["val"]),
            torch.from_numpy(g["scl"]), torch.from_numpy(g["wc"]), g["alpha"], mesh=mesh,
            axes="model", block=g["block"], **kw)
    assert tmesh.collectives == {"all_reduce": 1, "all_gather": 0, "reduce_scatter": 0}
    assert len(fused) == S and all(f.shape == (ss.shard_len,) for f in fused)
    got = torch.stack(fused).float().numpy()
    want = out[case + "/fused"]
    if dt == "bfloat16":
        assert np.all(np.abs(got - want) <= _bf16_ulp(want))
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(sq.numpy(), out[case + "/sq"], rtol=1e-4)


@pytest.mark.parametrize("case", ["sketch_a", "sketch_b"])
def test_sharded_sketch_matches_the_reference(reference_ops, case):
    cases, out = reference_ops
    g = cases[case]
    mesh = tmesh.make_mesh((S,), ("model",), device="cpu")
    ss = tflat.ShardedFlatSpec.for_size(g["N"], S)
    x = _t(g["base"], g["dtype"])
    tmesh.reset_collectives()
    got = tops.row_sketch_sharded(ss.shard_slices(x), mesh=mesh, axes=("model",),
                                  block=ss.block).numpy()
    assert tmesh.collectives == {"all_reduce": 1, "all_gather": 0, "reduce_scatter": 0}
    want = out[case + "/sketch"]
    xf = x.float().numpy()
    pad = (-xf.shape[0]) % 1024
    tiles = np.concatenate([xf, np.zeros(pad, np.float32)]).reshape(-1, 1024)
    bucket = np.arange(tiles.shape[0]) % 32
    mag = np.stack([np.bincount(bucket, np.abs(tiles).sum(1), 32),
                    np.bincount(bucket, (tiles * tiles).sum(1), 32)])
    assert np.all(np.abs(got - want) <= 1e-5 * mag)
    whole = tops.row_sketch(x).numpy()  # the unsharded sketch of the same row
    assert np.all(np.abs(got - whole) <= 1e-5 * mag)


@pytest.mark.parametrize("N,n_shards,block", [(200_000, 8, None), (30_000, 3, None),
                                              (600_000, 8, None), (50_000, 2, 4096)])
def test_row_sketch_shard_plain_matches_the_reference(N, n_shards, block):
    ss = tflat.ShardedFlatSpec.for_size(N, n_shards, block)
    x = np.random.default_rng(N).normal(size=N).astype(np.float32)
    for s, sl in enumerate(ss.shard_slices(x)):
        want = np.asarray(jref.row_sketch_shard(jnp.asarray(sl), s, n_shards, ss.block, 32))
        before = trs.row_sketch_shard.launches
        got = trs.row_sketch_shard(torch.from_numpy(sl), s, n_shards, ss.block, 32).numpy()
        assert trs.row_sketch_shard.launches == before  # the CPU takes the plain version
        tiles = sl.reshape(-1, 1024)
        mag = np.stack([np.abs(tiles).sum(), (tiles * tiles).sum()])[:, None]
        assert np.all(np.abs(got - want) <= 1e-5 * mag)
