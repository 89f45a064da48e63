"""Context-parallel serving: a batch that the batch axis does not divide
(batch 1 or 3 over 2 or 4 data slots) served on placed params, against the
JAX package's partitioned jit, on the CPU.

(a) The decode partials and their merge (``flash_attention_partials`` and
``merge_partials``, plain versions on the CPU) with the key range cut into
2 and 4 blocks, each block's ``q_offset`` from ``layers.cache_block``,
against ``flash_attention_plain`` and ``repro.kernels.ref.flash_attention``
on the same numpy-seeded inputs: GQA, MQA, a window, a ring before and
after the wrap, a block with no visible key, and a row that sees no key at
all.  f32, rtol/atol 1e-6.

(b) The reference runs ``jax.jit(make_prefill_step(cfg), in_shardings=
(params_sh, batch_sh))``, its Engine's prefill under ``in_shardings=
(params_sh, batch_sh["tokens"], cache_sh), out_shardings=(None,
cache_sh)`` and ``make_serve_step`` under ``in_shardings=(params_sh,
cache_sh, decode_sh, rep)`` greedily for 8 tokens, where ``decode_sh`` is
``batch_shardings`` of the decode step's [B, 1] tokens (replicated: one
position does not split over the data axis), on ``jax.make_mesh(shape,
("data", "model"))`` with Auto axes, in two subprocesses side by side on 8
forced CPU devices with the ring cache on.  Cases (d 128, f32): gemma3-1b
cut to 3 layers (local window 8, global, local) at B = 1, P = 6 (the
prompt in two chunks) and P = 5 (the prompt whole on every slot),
``max_len`` 14, on (2, 2); rwkv6-7b at 2 layers with FSDP, B = 1, P = 8,
``max_len`` 16, on (4, 2) (its recurrence chained over 4 chunks);
mistral-nemo-12b at 2 layers with FSDP, B = 3, P = 6, ``max_len`` 14, on
(2, 2); jamba's reduced config with FSDP (Mamba, attention, MoE), B = 1,
P = 6, on (2, 2).

Tolerances (f32, those of ``tests/test_torch_partitioned_serve.py``, the
cache's scaled to its leaf):
last-position logits within rtol/atol 1e-5 after the prefill and after each
teacher-forced decode step; every cache block of the reference's shape and
within rtol 1e-5 and atol 1e-5 x max(1, the block's largest |value|) of its
``addressable_shards`` after the prefill and after the last step (the
rwkv6 case's last state block differs by 1.09e-5 at one element of a block
whose largest value is 18.6, 5.9e-7 of it: the per-position projections of
a 2-position chunk round their f32 sums otherwise than those of the
8-position prompt, and that serve test puts the unpartitioned path's own
noise at up to 1.3e-6 of a leaf's largest value); the 8 greedy tokens
equal; the collectives a step equal to ``cp_collectives``, the formula
PERF.md states."""
import dataclasses
import inspect
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.configs import get_config, reduce_config
from repro_torch.kernels import flash_attention as tfa
from repro_torch.launch import dryrun as tdry
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding as tsh
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.models.partitioned import seq_layout
from repro_torch.serve.engine import Engine
from repro_torch.train.step import make_prefill_step, make_serve_step
from repro_torch.utils.placed import Layout, Placed
from repro_torch.utils.pytree import tree_from_paths, tree_leaves_with_path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEW, WINDOW = 8, 8
# case -> (arch, batch, prompt, max_len, mesh shape)
CASES = {"gemma_b1_2x2": ("gemma3-1b", 1, 6, 14, (2, 2)),
         "gemma_b1_p5_2x2": ("gemma3-1b", 1, 5, 14, (2, 2)),
         "rwkv_b1_4x2": ("rwkv6-7b", 1, 8, 16, (4, 2)),
         "mistral_b3_2x2": ("mistral-nemo-12b", 3, 6, 14, (2, 2)),
         "jamba_b1_2x2": ("jamba-1.5-large-398b", 1, 6, 14, (2, 2))}
# the reference's cases in two processes run side by side
JOBS = (["gemma_b1_2x2", "gemma_b1_p5_2x2", "mistral_b3_2x2"], ["rwkv_b1_4x2", "jamba_b1_2x2"])
LOGIT_RTOL = LOGIT_ATOL = 1e-5
CACHE_RTOL = CACHE_ATOL = 1e-5
PART_RTOL = PART_ATOL = 1e-6


def cfg_of(arch):
    """The cut both packages serve (the reference script runs this source)."""
    cfg = reduce_config(get_config(arch), d_model=128)
    if arch == "gemma3-1b":  # local, global, local: a stacked period and a tail layer
        local = dataclasses.replace(cfg.pattern[0], window=WINDOW)
        return dataclasses.replace(cfg, num_layers=3, pattern=(local, cfg.pattern[-1]))
    if arch == "jamba-1.5-large-398b":  # its reduced depth: Mamba, attention and MoE layers
        return dataclasses.replace(cfg, fsdp=True)
    return dataclasses.replace(cfg, num_layers=2, fsdp=True)


# -- (a) the partials and their merge -----------------------------------------------------

# name -> (B, Hq, Hkv, hd, Sk, window, position, ring)
PART_CASES = {"gqa": (2, 8, 2, 32, 24, None, 21, False),
              "mqa": (1, 4, 1, 64, 16, None, 15, False),
              "window": (2, 4, 2, 32, 32, 5, 29, False),
              "ring_filling": (1, 4, 1, 32, 16, None, 6, True),
              "ring_wrapped": (1, 4, 1, 32, 16, None, 37, True),
              "empty_block": (1, 8, 2, 32, 32, None, 3, False)}


@pytest.mark.parametrize("blocks", [2, 4])
@pytest.mark.parametrize("name", sorted(PART_CASES))
def test_partials_merge_to_the_oracles(name, blocks):
    """A one-token step against a cache cut into ``blocks`` blocks: each
    block's partials at the ``q_offset`` and window ``cache_block`` gives,
    concatenated and merged, equal ``flash_attention_plain`` and the JAX
    oracle over the whole cache (a ring at its reconstructed offset); a
    block that holds no visible key is one empty split."""
    B, Hq, Hkv, hd, Sk, window, pos, ring = PART_CASES[name]
    rng = np.random.default_rng(sorted(PART_CASES).index(name) * 10 + blocks)
    q = rng.standard_normal((B, 1, Hq, hd)).astype(np.float32)
    k = rng.standard_normal((B, Sk, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, Sk, Hkv, hd)).astype(np.float32)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    layer_window = Sk if ring else window   # a ring is a cache of exactly `window` slots
    if ring:
        kw = dict(causal=True, window=None, q_offset=min(pos, Sk - 1))
    else:
        kw = dict(causal=True, window=window, q_offset=pos)
    want = tfa.flash_attention_plain(tq, tk, tv, **kw).numpy()
    oracle = np.asarray(jref.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                             **kw))
    blk = Sk // blocks
    parts, empty = [], 0
    for r in range(blocks):
        write, q_off, win = TL.cache_block(Sk, pos, layer_window, r, blocks)
        owner = (pos % Sk if ring else pos) // blk
        assert (write is not None) == (r == owner)
        p = tfa.flash_attention_partials(tq, tk[:, r * blk:(r + 1) * blk].contiguous(),
                                         tv[:, r * blk:(r + 1) * blk].contiguous(),
                                         causal=True, window=win, q_offset=q_off)
        plan = tfa.decode_plan(B, 1, blk, Hkv, window=win, q_offset=q_off)
        assert p.shape == (B, Hkv, plan.n_splits, Hq // Hkv, 2 + hd)
        if plan.k_hi == plan.k_lo:   # no visible key: one split of weight 0
            empty += 1
            assert p.shape[2] == 1 and (p[..., 0] == tfa.EMPTY_M).all()
            assert not p[..., 1:].any()
        parts.append(p)
    if name == "empty_block":
        assert empty == blocks - 1
    got = tfa.merge_partials(torch.cat(parts, 2), 1, tq.dtype).numpy()
    np.testing.assert_allclose(got, want, rtol=PART_RTOL, atol=PART_ATOL)
    np.testing.assert_allclose(got, oracle, rtol=PART_RTOL, atol=PART_ATOL)


def test_a_row_that_sees_no_key_merges_to_zero():
    """Every block empty (a query before the cache's first key): the merge
    writes 0, as ``flash_attention`` does for such a row, and no NaN."""
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(s, generator=g) for s in ((1, 1, 4, 32), (1, 8, 2, 32),
                                                     (1, 8, 2, 32)))
    parts = [tfa.flash_attention_partials(q, k[:, 4 * r:4 * r + 4].contiguous(),
                                          v[:, 4 * r:4 * r + 4].contiguous(), q_offset=-1 - 4 * r)
             for r in range(2)]
    got = tfa.merge_partials(torch.cat(parts, 2), 1, torch.float32)
    assert torch.equal(got, torch.zeros_like(q))
    assert torch.equal(tfa.flash_attention_plain(q, k, v, q_offset=-1), torch.zeros_like(q))


def test_partials_refuse_more_rows_than_the_decode_route():
    q = torch.zeros((1, 3, 6, 32))
    k = torch.zeros((1, 8, 2, 32))
    with pytest.raises(ValueError, match="at most 8 query rows"):
        tfa.flash_attention_partials(q, k, k)


def test_query_groups_past_the_decode_rows_merge_in_head_order():
    """More query rows a kv head than the decode route takes (MQA with 24
    heads): ``models.partitioned._partials`` calls the partials once a
    group of 8 and lays the groups out as kv heads, so that the merge of
    two blocks writes every head in its place."""
    from repro_torch.models.partitioned import _partials
    g = torch.Generator().manual_seed(5)
    q = torch.randn((1, 1, 24, 32), generator=g)
    k, v = (torch.randn((1, 16, 1, 32), generator=g) for _ in range(2))
    parts = [_partials(q, k[:, 8 * r:8 * r + 8].contiguous(), v[:, 8 * r:8 * r + 8].contiguous(),
                       causal=True, window=None, q_offset=12 - 8 * r) for r in range(2)]
    assert parts[0].shape[1] == 3 and parts[0].shape[3] == 8
    got = tfa.merge_partials(torch.cat(parts, 2), 1, torch.float32)
    np.testing.assert_allclose(got.numpy(), tfa.flash_attention_plain(q, k, v, q_offset=12).numpy(),
                               rtol=PART_RTOL, atol=PART_ATOL)


def test_chunk_queues_keep_the_whole_batchs_pairs():
    """The MoE capacity queue over sequence chunks: at a capacity that
    drops pairs, B = 3 rows cut into 2 and 3 chunks, each chunk's plan
    with ``_chunk_queues``' offsets keeps exactly the pairs the whole
    batch's plan keeps (the reference's cumsum over the global order)."""
    from repro_torch.models import moe as TM
    from repro_torch.models.partitioned import _chunk_queues, _Slab
    cfg = reduce_config(get_config("granite-moe-1b-a400m"))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=0.5))
    E, K = cfg.moe.num_experts, cfg.moe.experts_per_token
    B, S = 3, 12
    g = torch.Generator().manual_seed(7)
    probs = torch.softmax(torch.randn((B * S, E), generator=g), -1)
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    whole = TM.plan(cfg, probs, idx[:, :K], w[:, :K])
    assert not bool(whole.keep.all())   # the capacity drops pairs
    for R in (2, 3):
        mesh = tmesh.make_mesh((R, 1), ("data", "model"), device="cpu")
        sl = _Slab(cfg, mesh, {}, {}, "chunks")
        c = S // R
        rows = [torch.arange(B)[:, None] * S + r * c + torch.arange(c)[None] for r in range(R)]
        sel = [(probs[i.reshape(-1)], idx[i.reshape(-1), :K], w[i.reshape(-1), :K]) for i in rows]
        ahead = _chunk_queues(sl, [s[1] for s in sel], B, E)
        for r in range(R):
            pl = TM.plan(cfg, *sel[r], tokens=B * S, ahead=ahead[r])
            assert torch.equal(pl.keep, whole.keep[rows[r].reshape(-1)]), (R, r)


# -- (b) the reference's partitioned jit --------------------------------------------------

_REF_SCRIPT = r"""
import dataclasses, json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro.configs import get_config, reduce_config
from repro.launch import sharding as SH
from repro.models.transformer import forward_lm, init_cache, init_lm
from repro.train.step import make_prefill_step, make_serve_step
from repro.utils.pytree import tree_map_with_name

args = json.loads(sys.argv[1])
out_npz = sys.argv[2]
inputs = np.load(args["inputs"])
NEW, WINDOW = args["new"], args["window"]
arrays = {}
""" + inspect.getsource(cfg_of) + r"""

def put(prefix, tree):
    tree_map_with_name(lambda n, x: arrays.__setitem__(f"{prefix}/{n}", np.asarray(x)), tree)

for case in args["jobs"]:
    arch, B, P, max_len, shape = args["cases"][case]
    cfg = cfg_of(arch)
    mesh = jax.make_mesh(tuple(shape), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    params = init_lm(cfg, jax.random.PRNGKey(0))
    put(f"{case}/init", params)
    prompts = jnp.asarray(inputs[case])
    cache = init_cache(cfg, B, max_len)
    psh = SH.params_shardings(mesh, params, cfg, data_axis="data", model_axis="model")
    csh = SH.cache_shardings(mesh, cache, cfg, data_axis="data", model_axis="model")
    bsh = SH.batch_shardings(mesh, {"tokens": prompts}, data_axis="data")
    dsh = SH.batch_shardings(mesh, {"tokens": prompts[:, :1]}, data_axis="data")
    rep = SH.replicated(mesh)
    slot = {d: i for i, d in enumerate(mesh.devices.flat)}

    def prefill(params, tokens, cache):
        logits, _, cache = forward_lm(cfg, params, tokens, cache=cache,
                                      cache_index=jnp.asarray(0, jnp.int32))
        return logits[:, -1], cache

    def shards(prefix, cache):
        def one(n, x):
            for sh in x.addressable_shards:
                arrays[f"{prefix}/{n}/{slot[sh.device]}"] = np.asarray(sh.data)
        tree_map_with_name(one, cache)

    with mesh:
        params = jax.device_put(params, psh)
        step = jax.jit(make_prefill_step(cfg), in_shardings=(psh, bsh), out_shardings=None)
        arrays[f"{case}/prefill_step"] = np.asarray(step(params, {"tokens": prompts}))
        pre = jax.jit(prefill, in_shardings=(psh, bsh["tokens"], csh), out_shardings=(None, csh))
        serve = jax.jit(make_serve_step(cfg), in_shardings=(psh, csh, dsh["tokens"], rep),
                        out_shardings=(None, csh))
        logits, cache = pre(params, prompts, jax.device_put(cache, csh))
        shards(f"{case}/cache/prefill", cache)
        toks = [jnp.argmax(logits, -1)]
        arrays[f"{case}/logits/0"] = np.asarray(logits)
        for t in range(1, NEW):
            logits, cache = serve(params, cache, toks[-1][:, None].astype(jnp.int32),
                                  jnp.asarray(P + t - 1, jnp.int32))
            arrays[f"{case}/logits/{t}"] = np.asarray(logits)
            toks.append(jnp.argmax(logits, -1))
        shards(f"{case}/cache/last", cache)
        arrays[f"{case}/tokens"] = np.stack([np.asarray(t) for t in toks], 1)
np.savez(out_npz, **arrays)
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's cases (``JOBS``) in two subprocesses on 8 forced CPU
    devices, run side by side, with ``REPRO_OPT_RING_CACHE=1``."""
    d = tmp_path_factory.mktemp("context_parallel_ref")
    rng = np.random.default_rng(31)
    prompts = {case: rng.integers(3, 512, (B, P)).astype(np.int32)
               for case, (_, B, P, _, _) in sorted(CASES.items())}
    np.savez(d / "in.npz", **prompts)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8", REPRO_OPT_RING_CACHE="1",
               OMP_NUM_THREADS="1")
    procs = []
    for j, jobs in enumerate(JOBS):
        args = dict(cases={k: [a, b, p, m, list(s)] for k, (a, b, p, m, s) in CASES.items()},
                    jobs=jobs, new=NEW, window=WINDOW, inputs=str(d / "in.npz"))
        procs.append(subprocess.Popen([sys.executable, "-c", _REF_SCRIPT, json.dumps(args),
                                       str(d / f"out{j}.npz")], env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    arrays = {}
    for j, proc in enumerate(procs):
        _, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-4000:]
        with np.load(d / f"out{j}.npz") as out:
            arrays.update(out)
    return arrays, prompts


@pytest.fixture(autouse=True)
def _one_torch_thread_and_the_ring(monkeypatch):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setattr(TT, "RING_CACHE", True)  # the reference's REPRO_OPT_RING_CACHE=1
    yield
    torch.set_num_threads(threads)


def _tree(arrays, prefix):
    return tree_from_paths([(k[len(prefix) + 1:], torch.from_numpy(v.copy()))
                            for k, v in sorted(arrays.items()) if k.startswith(prefix + "/")])


def _placed(case, arrays):
    """(cfg, mesh, the reference's params placed by the port, their
    shardings)."""
    arch, _, _, _, shape = CASES[case]
    cfg = cfg_of(arch)
    mesh = tmesh.make_mesh(shape, ("data", "model"), device="cpu")
    params = _tree(arrays, f"{case}/init")
    psh = tsh.params_shardings(mesh, params, cfg, data_axis="data", model_axis="model")
    return cfg, mesh, tsh.device_put(params, psh), psh


# -- the collectives of a context-parallel step ------------------------------------------


def _layers_split(cfg, psh, suffix, axis):
    """Layers whose leaf ``suffix`` the spec splits over ``axis``."""
    n_full, _ = TT.split_layers(cfg)
    n = 0
    for name, sh in tree_leaves_with_path(psh):
        if name.endswith(suffix) and axis in sh.spec:
            n += n_full if name.startswith("scan/") else 1
    return n


def cp_collectives(cfg, psh, R: int, M: int, *, step: str, cached: bool = True,
                   data_axis="data"):
    """The formula of PERF.md §5 for one partitioned forward at a batch the
    batch axis does not divide, ``step`` one of ``"chunks"`` (a prompt
    split into R chunks), ``"whole"`` (a prompt every slot holds whole) or
    ``"decode"`` (one token against a cache whose sequence is split over
    the batch axis), as ``({kind: count}, {axis: count})``.  Over ``model``
    (M > 1), as at a divided batch: the embedding's all-reduce where the
    vocabulary splits; an all-reduce a row-parallel output (attention's
    ``wo``, the GLU/MLP, the RWKV time mix's ``wo``, a MoE combine whose
    experts split); ``wk``/``wv`` all-gathered where the KV heads do not
    split but their spec does; a Mamba layer's in_proj gather and its
    x_proj and out_proj all-reduces; with a cache, an RWKV layer's two
    token-shift states gathered; at a decode step, each attention layer's
    k and v blocks gathered where the cache splits ``head_dim`` (a prompt
    attends over its own new keys); the last logits gathered where they
    come out per vocabulary block.  Over the batch axis (R > 1): each use
    of a leaf FSDP splits, one all-gather; for a chunked prompt, each
    attention layer's new k and v all-gathered, each MoE layer's counts
    by row and expert, each RWKV layer's two chunk-end rows (time mix and
    channel mix) and each Mamba layer's conv halo all-gathered, each RWKV
    or Mamba layer's state handed from chunk to chunk (R - 1 permutes)
    and, with a cache, broadcast from the last chunk (one), and the last
    logits broadcast from the last chunk; at a decode step each attention
    layer's partials all-gathered."""
    n_attn = sum(b.mixer == "attn" for b in cfg.blocks)
    n_dense = sum(b.ffn in ("glu", "mlp") for b in cfg.blocks)
    n_moe = sum(b.ffn == "moe" for b in cfg.blocks)
    n_rec = sum(b.mixer in ("rwkv", "mamba") for b in cfg.blocks)
    n_rwkv = sum(b.mixer == "rwkv" for b in cfg.blocks)
    n_mamba = n_rec - n_rwkv
    ar = ag_m = ag_d = perm = bcast = 0
    if M > 1:
        vocab = cfg.vocab_size % M == 0
        hd, Hkv = cfg.head_dim, cfg.num_kv_heads
        attn = (cfg.num_heads * hd) % M == 0
        ar += vocab + n_attn * attn + n_dense * (cfg.d_ff % M == 0)
        ar += _layers_split(cfg, psh, "moe/w_gate", "model")
        mamba = _layers_split(cfg, psh, "mamba/in_proj", "model")
        rwkv = _layers_split(cfg, psh, "rwkv/wr", "model")
        ar += 2 * mamba + rwkv
        ag_m += mamba + vocab
        if n_attn and attn and Hkv % M and (Hkv * hd) % M == 0:
            ag_m += 2 * n_attn
        if cached:
            ag_m += 2 * rwkv
            if step == "decode" and n_attn and Hkv % M and hd % M == 0:
                ag_m += 2 * n_attn
    if R > 1:
        n_full, _ = TT.split_layers(cfg)
        for name, sh in tree_leaves_with_path(psh):
            if data_axis in sh.spec:
                ag_d += n_full if name.startswith("scan/") else 1
        if step == "chunks":
            ag_d += 2 * n_attn + n_moe * (cfg.moe.routing != "dense") + 2 * n_rwkv + n_mamba
            perm += (R - 1) * n_rec
            bcast += 1 + n_rec * cached
        elif step == "decode":
            ag_d += n_attn
    kinds = {"all_reduce": ar, "all_gather": ag_m + ag_d, "reduce_scatter": 0}
    kinds.update({k: n for k, n in (("permute", perm), ("broadcast", bcast)) if n})
    d_total = ag_d + perm + bcast
    return kinds, {a: n for a, n in (("model", ar + ag_m), (data_axis, d_total)) if n}


def _step_counts():
    return dict(tmesh.collectives), dict(tmesh.collectives_by_axis)


def _close_blocks(cache, arrays, prefix, n):
    for name, x in tree_leaves_with_path(cache):
        assert isinstance(x, Placed), name
        for s in range(n):
            want = arrays[f"{prefix}/{name}/{s}"]
            got = x.block(s).numpy()
            assert got.shape == want.shape, (name, s, got.shape, want.shape)
            np.testing.assert_allclose(got, want, rtol=CACHE_RTOL,
                                       atol=CACHE_ATOL * max(1.0, float(np.abs(want).max())),
                                       err_msg=f"{name} slot {s}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_serve_steps_match_the_reference_jit(ref, case):
    """The engine's prefill and 7 decode steps through ``make_serve_step``
    on placed params and a placed cache, teacher-forced on the reference's
    tokens: logits and every cache block against the reference's, the
    collectives of each step against the formula; the bytes a slot holds
    of params and cache equal ``dryrun.slot_bytes``."""
    arrays, prompts = ref
    cfg, mesh, placed, psh = _placed(case, arrays)
    R, M = mesh.shape["data"], mesh.shape["model"]
    _, B, P, max_len, _ = CASES[case]
    tokens, cache = Engine(cfg, placed, max_len=max_len)._start(placed, prompts[case])
    layout = seq_layout(B, P, R)
    assert layout in ("chunks", "whole")
    if layout == "chunks":
        assert isinstance(tokens, Placed) and tokens.layout.spec == ((), ("data",))
    whole_cache = TT.init_cache(cfg, B, max_len, device="cpu")
    csh = tsh.cache_shardings(mesh, whole_cache, cfg, data_axis="data", model_axis="model")
    for name, x in tree_leaves_with_path(cache):
        assert x.layout == Layout(x.shape, dict(tree_leaves_with_path(csh))[name].spec, mesh)
    want_bytes = tdry.slot_bytes({"p": placed, "c": whole_cache}, {"p": psh, "c": csh}, mesh)
    assert tsh.placed_slot_bytes({"p": placed, "c": cache}, mesh) == [want_bytes] * (R * M)
    step = make_serve_step(cfg)
    toks = arrays[f"{case}/tokens"]
    for t in range(NEW):
        tmesh.reset_collectives()
        if t == 0:
            logits, cache = step(placed, cache, tokens, 0)
            want = cp_collectives(cfg, psh, R, M, step=layout)
        else:
            logits, cache = step(placed, cache, toks[:, t - 1:t], P + t - 1)
            want = cp_collectives(cfg, psh, R, M, step="decode")
        assert _step_counts() == want, (t, _step_counts(), want)
        assert logits.shape == (B, cfg.vocab_size)
        np.testing.assert_allclose(logits.numpy(), arrays[f"{case}/logits/{t}"],
                                   rtol=LOGIT_RTOL, atol=LOGIT_ATOL, err_msg=f"step {t}")
        if t == 0:
            _close_blocks(cache, arrays, f"{case}/cache/prefill", mesh.devices.size)
    _close_blocks(cache, arrays, f"{case}/cache/last", mesh.devices.size)


@pytest.mark.parametrize("case", sorted(CASES))
def test_generate_matches_the_reference(ref, case):
    """``Engine.generate`` on placed params: the reference's 8 greedy
    tokens, and the port's whole Engine's on the same params."""
    arrays, prompts = ref
    cfg, _, placed, _ = _placed(case, arrays)
    max_len = CASES[case][3]
    res = Engine(cfg, placed, max_len=max_len).generate(prompts[case], max_new_tokens=NEW)
    np.testing.assert_array_equal(res.tokens[:, CASES[case][2]:], arrays[f"{case}/tokens"])
    whole = Engine(cfg, _tree(arrays, f"{case}/init"), max_len=max_len)
    np.testing.assert_array_equal(whole.generate(prompts[case], max_new_tokens=NEW).tokens,
                                  res.tokens)


@pytest.mark.parametrize("case", sorted(CASES))
def test_prefill_step_matches_the_reference_jit(ref, case):
    """``make_prefill_step`` (no cache) on placed params, the tokens whole
    and placed by ``batch_shardings``, against the reference's partitioned
    prefill step; the collectives of a forward without a cache."""
    arrays, prompts = ref
    cfg, mesh, placed, psh = _placed(case, arrays)
    _, B, P, _, _ = CASES[case]
    R, M = mesh.shape["data"], mesh.shape["model"]
    batch = {"tokens": prompts[case]}
    bsh = tsh.batch_shardings(mesh, batch, data_axis="data")
    want = cp_collectives(cfg, psh, R, M, step=seq_layout(B, P, R), cached=False)
    for b in (batch, tsh.device_put(batch, bsh)):
        tmesh.reset_collectives()
        got = make_prefill_step(cfg)(placed, b)
        assert _step_counts() == want
        np.testing.assert_allclose(got.numpy(), arrays[f"{case}/prefill_step"],
                                   rtol=LOGIT_RTOL, atol=LOGIT_ATOL)


# -- phase 22's configurations at full width ----------------------------------------------


def _meta_params(cfg):
    """A full-width parameter tree of shapes only (the draws replaced by
    meta tensors)."""
    from unittest import mock

    def draw(*args, **kw):
        return torch.empty(args[0] if args else kw["size"], dtype=torch.float32, device="meta")

    with mock.patch.object(torch, "randn", draw), mock.patch.object(torch, "rand", draw):
        return TT.init_lm(cfg, torch.Generator(), device="meta")


def test_cp_collective_formula_at_full_width():
    """The formula's counts for ``chip_smoke.py``'s phase 22 (gemma3-1b,
    rwkv6-7b with FSDP and granite-moe-1b-a400m, B = 1 on (data 2, model
    2)) as PERF.md §5 writes them, and the cache blocks ``cache_shardings``
    gives there: gemma3-1b's 32,768-slot caches split over data (16,384 a
    slot) and head_dim over model; rwkv6-7b's state whole over data.  At
    full depth: the phase cuts rwkv6-7b and granite-moe to 8 layers (the
    counts scale with the layers)."""
    want = {"gemma3-1b": (32_768, "scan/pos5/k", (4, 1, 16_384, 1, 128),
                          ({"all_reduce": 53, "all_gather": 105, "reduce_scatter": 0,
                            "broadcast": 1}, {"model": 106, "data": 53}),
                          ({"all_reduce": 53, "all_gather": 131, "reduce_scatter": 0},
                           {"model": 158, "data": 26})),
            "rwkv6-7b": (4_112, "scan/pos0/S", (32, 1, 32, 64, 64),
                         ({"all_reduce": 33, "all_gather": 323, "reduce_scatter": 0,
                           "permute": 32, "broadcast": 33}, {"model": 98, "data": 323}),
                         ({"all_reduce": 33, "all_gather": 259, "reduce_scatter": 0},
                          {"model": 98, "data": 194})),
            "granite-moe-1b-a400m": (2_064, "scan/pos0/k", (24, 1, 1_032, 4, 64),
                                     ({"all_reduce": 48, "all_gather": 72,
                                       "reduce_scatter": 0, "broadcast": 1},
                                      {"model": 48, "data": 73}),
                                     ({"all_reduce": 48, "all_gather": 24,
                                       "reduce_scatter": 0}, {"model": 48, "data": 24}))}
    mesh = tmesh.make_mesh((2, 2), ("data", "model"), device="meta")
    for arch, (max_len, leaf, block, prefill, decode) in want.items():
        cfg = get_config(arch)
        with torch.device("meta"):
            params = _meta_params(cfg)
            cache = TT.init_cache(cfg, 1, max_len, device="meta")
        psh = tsh.params_shardings(mesh, params, cfg)
        assert cp_collectives(cfg, psh, 2, 2, step="chunks") == prefill, arch
        assert cp_collectives(cfg, psh, 2, 2, step="decode") == decode, arch
        csh = dict(tree_leaves_with_path(tsh.cache_shardings(mesh, cache, cfg)))
        x = dict(tree_leaves_with_path(cache))[leaf]
        assert Layout(x.shape, csh[leaf].spec, mesh).block_shape == block, arch
