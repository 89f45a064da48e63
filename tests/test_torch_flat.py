"""Parity of the port's flat layout (``repro_torch.utils.flat``) with the JAX
package's: the same JSON spec, bit-equal rows, the same checksum.  Exact
comparisons throughout — flattening only moves and casts values."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.roberta_base import TINY as JTINY
from repro.models import encoder as JE
from repro.utils import flat as jflat
from repro_torch import convert
from repro_torch.configs import TINY
from repro_torch.configs import base as tbase
from repro_torch.utils import flat as tflat
from repro_torch.utils.pytree import tree_leaves_with_path

# 12 narrow layers: "layer10" must sort before "layer2" in both packages
DEEP = dict(num_layers=12, d_model=16, num_heads=2, num_kv_heads=2, head_dim=8,
            d_ff=32, vocab_size=40, max_seq_len=8)


def _jax_body(dtype: str):
    cfg = dataclasses.replace(JTINY, param_dtype=dtype, compute_dtype=dtype, **DEEP)
    return JE.init_encoder_body(cfg, jax.random.PRNGKey(0))


def _pair(dtype: str):
    jb = _jax_body(dtype)
    tb = convert.from_jax_params(jax.tree.map(np.asarray, jb), "cpu")
    return jb, tb


def _bits(x) -> np.ndarray:
    """Raw bit patterns (``convert.to_numpy`` already gives bf16 as uint16)."""
    a = np.asarray(x)
    if a.dtype.name in ("bfloat16", "uint16"):
        return a.view(np.uint16)
    return a.view(np.uint32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_to_json_matches_jax(dtype):
    jb, tb = _pair(dtype)
    want = jflat.FlatSpec.from_tree(jb).to_json()
    got = tflat.FlatSpec.from_tree(tb).to_json()
    assert got == want
    paths = [leaf["path"] for leaf in got["leaves"]]
    assert paths.index("layers/layer10/attn/wk") < paths.index("layers/layer2/attn/wk")
    assert got["dtype"] == dtype


def test_to_json_mixed_dtypes_store_float32():
    tree = {"a": np.ones((3,), np.float32), "b": np.ones((2, 2), jnp.bfloat16),
            "c": {"z": np.zeros((), np.float32)}}
    want = jflat.FlatSpec.from_tree(jax.tree.map(jnp.asarray, tree)).to_json()
    got = tflat.FlatSpec.from_tree(convert.from_jax_params(tree, "cpu")).to_json()
    assert got == want and got["dtype"] == "float32"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flatten_bit_equal(dtype):
    jb, tb = _pair(dtype)
    jrow = jflat.FlatSpec.from_tree(jb).flatten(jb)
    trow = tflat.FlatSpec.from_tree(tb).flatten(tb)
    np.testing.assert_array_equal(_bits(convert.to_numpy({"r": trow})["r"]), _bits(jrow))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_unflatten_roundtrip(dtype):
    _, tb = _pair(dtype)
    spec = tflat.FlatSpec.from_tree(tb)
    back = spec.unflatten(spec.flatten(tb))
    assert tflat.FlatSpec.from_tree(back) == spec
    for (pa, a), (pb, b) in zip(tree_leaves_with_path(tb),
                                tree_leaves_with_path(back)):
        assert pa == pb and a.dtype == b.dtype
        assert torch.equal(a, b)


def test_unflatten_leaves_are_views_of_the_row():
    _, tb = _pair("float32")
    spec = tflat.FlatSpec.from_tree(tb)
    row = spec.flatten(tb)
    tree = spec.unflatten(row)
    assert tree["embed"].data_ptr() == row.data_ptr()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_from_json_roundtrip_matches_jax(dtype):
    jb, tb = _pair(dtype)
    meta = jflat.FlatSpec.from_tree(jb).to_json()
    jspec = jflat.FlatSpec.from_json(meta)
    tspec = tflat.FlatSpec.from_json(meta)
    assert tspec.to_json() == jspec.to_json()
    assert tspec == tflat.FlatSpec.from_tree(tb)


def test_from_json_nonsorted_order_keeps_offsets():
    # leaves listed out of sorted order: both packages re-sort by key and
    # keep every leaf on its recorded slice
    meta = {"dtype": "float32", "size": 5, "leaves": [
        {"path": "b", "shape": [2], "dtype": "float32", "offset": 0, "size": 2},
        {"path": "a", "shape": [3], "dtype": "float32", "offset": 2, "size": 3}]}
    assert tflat.FlatSpec.from_json(meta).to_json() == jflat.FlatSpec.from_json(meta).to_json()
    tree = tflat.FlatSpec.from_json(meta).unflatten(torch.arange(5.0))
    assert tree["b"].tolist() == [0.0, 1.0] and tree["a"].tolist() == [2.0, 3.0, 4.0]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_row_checksum_matches_jax(dtype):
    jb, tb = _pair(dtype)
    jrow = jflat.FlatSpec.from_tree(jb).flatten(jb)
    trow = tflat.FlatSpec.from_tree(tb).flatten(tb)
    assert tflat.row_checksum(trow) == jflat.row_checksum(jrow)
    # numpy input (as a queue file hands it) checksums the same way
    assert tflat.row_checksum(np.asarray(jrow)) == jflat.row_checksum(jrow)


def test_flatten_rejects_wrong_tree():
    _, tb = _pair("float32")
    spec = tflat.FlatSpec.from_tree(tb)
    bad = dict(tb, embed=torch.zeros(3))
    with pytest.raises(ValueError, match="shape"):
        spec.flatten(bad)
    with pytest.raises(ValueError, match="leaves"):
        spec.flatten({"embed": tb["embed"]})


def test_staged_buffer_handle():
    rows = [torch.full((4,), float(i)) for i in range(3)]
    sb = tflat.StagedBuffer.from_rows(rows)
    assert sb.k == 3 and tuple(sb.data.shape) == (3, 4)
    with pytest.raises(ValueError):
        tflat.StagedBuffer.from_rows([])


def test_config_fields_match_jax():
    for name in ("CONFIG", "TINY"):
        from repro.configs import roberta_base as jrb
        from repro_torch.configs import roberta_base as trb
        jc, tc = getattr(jrb, name), getattr(trb, name)
        for f in dataclasses.fields(tbase.ArchConfig):
            if f.name in ("pattern", "rope", "ssm", "moe"):  # each package's own classes
                continue
            assert getattr(tc, f.name) == getattr(jc, f.name), (name, f.name)
        assert [dataclasses.astuple(b) for b in tc.pattern] == \
            [(b.mixer, b.window, b.ffn, b.rope_theta) for b in jc.pattern]
        assert (tc.rope.kind, tc.rope.theta, tc.rope.scaling) == \
            (jc.rope.kind, jc.rope.theta, jc.rope.scaling)
        assert (tc.ssm.head_dim, tc.ssm.decay_lora) == (jc.ssm.head_dim, jc.ssm.decay_lora)
        assert dataclasses.asdict(tc.ssm) == dataclasses.asdict(jc.ssm)
        assert dataclasses.asdict(tc.moe) == dataclasses.asdict(jc.moe)
    assert TINY.param_dtype == "float32"


def test_convert_roundtrip_bf16_bits():
    a = (np.arange(12, dtype=np.float32) / 7).astype(jnp.bfloat16).reshape(3, 4)
    t = convert.from_jax_params({"x": a}, "cpu")["x"]
    assert t.dtype == torch.bfloat16
    back = convert.to_numpy({"x": t})["x"]
    np.testing.assert_array_equal(back, a.view(np.uint16))
