#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py        # from the repo root, on a machine with a card

Phases (any failed check raises, so the script exits non-zero):

1. the card: name, count, and ``nvidia-smi``'s name and power limit;
2. build every kernel from ``src/repro_torch/kernels/csrc`` (``cold_fuse``,
   ``decode_accum``, ``row_sketch``, the three routes of ``flash_attention``
   — ``flash_prefill`` on the tensor cores for bf16, ``flash_decode``
   split-K for decode shapes, ``flash_attention`` FMA loops for f32
   prefill — and the two routes of ``rwkv6_scan``, ``rwkv6_scan`` for
   T > 1 and ``rwkv6_step`` for T = 1: one ``nvcc`` each, all started
   together; time, and ptxas' registers and spills per kernel);
3. each kernel against its plain PyTorch version on the card, at the main
   paths' shapes and on ragged shapes: ``cold_fuse`` at K=5 x
   N=123,969,792 bf16 (one NaN row of weight 0, alpha 1.0 and 0.3);
   ``decode_accum`` at the service shape (C=4 compressed RoBERTa-base
   deltas, block 1024, kb 64, plus a NaN-scale row of weight 0, with
   random offsets where slot 1 repeats slot 0 and with a top-k's offsets
   as the codec writes them; called twice, the two results must be
   bit-identical), at C=64 (the service's ``max_cohort``) at the same
   shape, at block 32768, at a ragged size and at C=1; ``row_sketch`` of the
   bf16 body with 32 buckets, of 1,000,003 f32 with 7 and of 100 elements;
   ``flash_attention`` at gemma3-1b's prefill shape (B=4, Sq=1024,
   Sk=1280, 4 query heads on 1 kv head, hd 256, bf16, window 512 and
   none), at decode (Sq=1, q_offset 1100, bf16 and f32), at stablelm-12b's
   head_dim 160 (B=4, Sq=256, Sk=272, 32 query heads on 8 kv heads: bf16
   prefill on the tensor-core route, f32 prefill on the FMA route, decode at
   q_offset 256 in both), at granite-moe-1b-a400m's (B=4, Sq=1024, Sk=1056,
   16 query heads on 8 kv heads, hd 64, bf16: prefill, and decode at
   q_offset 1024 and 1055), at whisper-tiny's (B=4, Sq=Sk=1500, 6 heads on 6,
   hd 64, bidirectional, bf16 and f32; cross-attention of 4 rows and of 1
   against the 1500 frames on the decode route), at qwen2-vl's (B=4, Sq=512,
   Sk=529, 64 query heads on 8 kv heads, hd 128: prefill, and decode at
   q_offset 512), the ring form of a gemma3-1b local layer's decode step
   (a 512-slot ring in write order at positions 200 and 700, against the
   visible keys in position order), in f32 and bf16 at hd 32-256 with ragged lengths
   (hd 160 among them), and with
   rows that see no key, each call checked to take its route; ``rwkv6_scan`` at
   rwkv6-7b's prefill shape (B=4, T=256, H=64, hd=64, f32, logw down to
   -20), with the state chained across two calls, at the decode shape
   (T=1), as 32 chained T=1 calls against one plain call of T=32, with
   bf16 inputs and at hd 32, each call checked to take its route;
4. kernel and plain-version times (CUDA events, five windows after a
   warm-up, the median printed) beside each kernel's bound, and for
   ``flash_attention`` (gemma3-1b's shapes, then stablelm-12b's hd 160 in
   bf16 and f32, whisper-tiny's bidirectional encoder and cross-attention,
   qwen2-vl's prefill and decode) the route and the time of
   ``scaled_dot_product_attention`` on the same inputs and mask; both
   again replayed from a CUDA graph, which leaves out the host's work per
   call (the device time); ``rwkv6_scan`` likewise per route, with its
   wrapper's host time per call; ``decode_accum`` at C=4 and C=64, on
   both payload kinds, eager and from a CUDA graph, beside
   ``torch.zeros`` of its f32 accumulator (the write floor);
5. small-input checks: the same screen + fuse (the flat engine, and the
   per-leaf engine's ``fisher`` and ``ties`` repositories over a TINY f32
   body), the same small queue drained by the contributor service, phase
   8's three gated rounds and async merge on a TINY f32 body, and reduced
   f32 gemma3 and rwkv6 models serving the same prompts, on the card and
   on the CPU (whose paths the CPU tests hold against the JAX package) must
   agree: decisions, counters, listener calls, files and rows;
6. the ColD Fusion training path (slices 1 and 4), through the entry points
   a user calls, at RoBERTa-base's full width: ``pretrain_mlm`` (20 steps of
   batch 32 x 128 tokens at lr 5e-4 from a body drawn from seed 0, after
   the same at 2e-3 and 1e-3 for their losses only; every loss finite)
   gives theta_0; a Repository over theta_0 runs two iterations of 4
   contributors x 3 finetune steps, an adversarial cohort (3 honest, one
   NaN, one runaway upload) that must fuse 3/5, and a frozen-probe
   evaluation; ``train_multitask`` takes 8 steps over the 4 tasks (body and
   heads finite); 4 ``Contributor(with_fisher=True)`` fuse 4/4 into a
   ``Repository(fusion_op="fisher")`` and 4 contributors 4/4 into a
   ``Repository(fusion_op="ties", density 0.2)``, both finite.  The
   pretrain, multitask and finetune steps, each ``compute_fisher`` call and
   each per-leaf fuse are timed (host clock, synchronised).  After the
   counts are read: the same cohort with all-ones Fishers must equal
   ``average``'s ``cold_fuse`` within 1 bf16 ulp, and ``ties`` on the CPU
   must give the card's result within 1 bf16 ulp on ``embed`` and two other
   leaves, with the same number of kept elements per contributor; the
   ``ties`` threshold (``topk``) is timed on ``embed`` beside ``kthvalue``;
7. the contributor service loop (slice 2) at the same width, in a
   temporary root: ``Repository(root, spill=True)`` behind a
   ``ColdService`` with the novelty screen on; round 1 takes 2 dense
   submissions (one without a rider sketch, so the service sketches it on
   the card), 2 compressed ones and a byte-identical replay that must be
   rejected; round 2 an all-dense cohort; round 3 three honest compressed
   submissions and a runaway one that must fuse 3/4.  Round 1's published
   base is held against ``cold_fuse_plain`` over the host-decoded rows;
8. the Repository lifecycle behind the regression gate, at the same width
   in its own temporary root: ``Repository(spill=True, spill_workers=2)``
   behind ``ColdService(gate=RegressionGate(ProbeSuite(N)))`` with the
   novelty screen and compaction to 2 bases, and a publish listener.
   Round 1: 4 honest dense submissions fuse 4/4 and pass the gate.  Round
   2: 4 submissions of the base plus N(0, s^2) noise, s = 10, 12.5, 15 and
   17.5 (``HARM_SCALES``), admitted by the §9 and novelty screens, trip the
   gate: 4 quarantined, one rollback to a row
   equal to round 1's bit for bit.  Round 3: 2 dense and 2 compressed
   submissions on the rolled-back base fuse 4/4 and pass; compaction
   leaves base_iter0001 and base_iter0002.  Then ``contribute_async`` (alpha
   1/3) must equal ``cold_fuse_plain`` within 1 bf16 ulp, and a runaway
   with a NaN is rejected with state unchanged.  The listener must see
   iterations 1, 2, 1, 2, 3 and the launches must be exact: ``cold_fuse`` 4,
   ``decode_accum`` 1, ``row_sketch`` 6.  ``ProbeSuite.score`` (device row
   and host copy), ``MultitaskEvals.score`` on 4 tasks x 32 x 128,
   ``rollback`` (load, persist, sketch), ``compact`` and each round's
   finetune, submit and serve are timed;
9. the serving path (slice 3), for gemma3-1b (26 layers, d 1152, vocab
   262,144) and then rwkv6-7b (32 layers, d 4096), both at full width in
   bf16 with random weights from seed 0: ``launch.serve.main`` serves 4
   prompts (1024 tokens for gemma3, 256 for rwkv6) x 32 new tokens, then
   ``Engine.generate`` the same on its own model (gemma3's cache 1280
   long, so its 512-token window bites in prefill and decode); prefill and
   decode are timed, and the launches are counted per route (gemma3:
   prefill on the tensor-core route, decode on the split-K route; rwkv6:
   prefill on the scan route, decode on the step route); one
   prefill and 8 decode steps run under ``torch.profiler`` for the
   kernels' device time against the wall time (the device's idle share); then
   both models run teacher-forced on the kernel
   path's tokens once more and once with the kernels' plain versions, and
   the logits and greedy tokens are compared.

10. similarity routing over a base family (slice 6), at the same width in
   its own temporary root, after phase 9: ``RepositoryFamily.create`` on the
   card from phase 7's seed-0 body behind ``ColdService(family=)`` (min
   cohort 2, ``max_bases`` 3, ``split_threshold`` 0.8, ``cross_fuse_every``
   4, the novelty screen, compaction to 2 bases).  Round 0: two task streams
   (``tests/test_routing.py``'s tile-constant direction, 2 contributors each,
   base + 0.01 (c + 1) pat) declare ``main``; the family must end with
   exactly two members on the card, each the fuse of its own stream (1 bf16
   ulp, +1 f32 ulp of the operands where the result cancels).  Round 1:
   every contributor finds its member (``route_of``, ``wait_for_family``,
   ``download_base(family=)``), one row per stream compressed (64 of every
   1024 elements at 16x, so the codec keeps it whole) fuses in its member
   through ``decode_accum``; a compressed row of the other stream's
   direction declaring ``main`` is rejected stale.  Every route's distance
   is printed and held (same stream < 0.6, across streams >= 1.0) before the
   decisions are checked.  After 4 member publishes the quiescent family
   cross-fuses once: both members on the mean of the pre-cross bases.
   Launches are exact (``cold_fuse`` 4, ``decode_accum`` 2, ``row_sketch``
   8); the route decisions, ``spawn``, ``cross_fuse`` and each round's submit
   and serve are timed; the status ``families`` map and the routes ring are
   printed.  Then four real finetunes (2 contributors x tasks 8 and 9, 3
   steps from one base) are scored by ``FamilyRouter`` against each other
   and printed beside ``split_threshold``, not asserted.

11. the fuse-to-serve stack (slice 7), gemma3-1b at full width (999,812,736
   bf16 parameters in 74 leaves, a 2.00 GB row) in its own temporary root,
   after phase 10: ``Repository(spill=True)`` with the MAD screen on behind
   ``ColdService(min_cohort=3)``, and an in-process ``ServingWorker`` with the
   scheduler (batches up to 4) following it.  The initial adoption must copy
   nothing (every served leaf a view of the published row).  A 4 x 1024 ->
   32 request captures iteration 0 and is held in the engine while three
   contributors submit the base plus 0.01 N(0, 1) per leaf and the daemon
   fuses and publishes iteration 1; the follower flips, and the released
   request must return iteration 0 with the tokens of an iteration-0 oracle
   computed before.  A new request must serve iteration 1 with a fresh
   ``Engine``'s tokens; the published base is held against
   ``cold_fuse_plain`` chunk by chunk (phase 8's rule); 8 concurrent
   single-row requests must coalesce into 2 batches of 4, each row equal to
   a re-run of its batch as the scheduler built it (and 2 solo calls are
   timed); ``rollback(0)`` must swap the follower back to the oracle's
   tokens; a cross-process worker must load ``base_iter0000.npz`` onto the
   card and serve the same tokens, with ``serving_state.json`` and
   ``status()["serving"]`` at iteration 0.  Then a ``WorkerPool`` of two
   children (``reduce_config(gemma3-1b)``, the real engine on the card,
   ``--batch``) over a small root behind a ``Router``: both converge on a
   publish, every response equals the parent's ``Engine`` on the published
   npz at its batch size, and a ``kill -9`` of one child under traffic is
   re-routed once per request with none failed.  Launches are exact
   (``SERVE_STACK_LAUNCHES``, worked out from the code): ``cold_fuse`` 2,
   ``flash_attention`` 10,128 (12 generates of 26 layers x 32 tokens, 3 pool
   oracles of 6 layers x 8); swap latencies, request latencies, tokens per
   second, peak memory and the phase's seconds are printed.

12. LM training (slice 8): ``launch.train.main`` trains gemma3-1b at full
   width in f32 (999,812,736 parameters, AdamW) for 30 steps of 8 x 64
   tokens at the launcher's defaults and saves the params; every loss and
   grad_norm must be finite and the mean loss of the last 5 steps below
   that of the first 5; one more step at 2 microbatches must equal the same
   step at 1 (``MB_RTOL``, ``MB_ATOL``).  The saved npz is loaded back
   (equal to the trained tree), the eval step and an ``Engine`` (4 x 64 ->
   8) run over it, with ``flash_attention``'s launches exact by route (the
   eval step: ``prefill_fma`` 26; generate: ``prefill_fma`` 26, ``decode``
   26 x 7), and the kernel path's prefill logits are held against the
   differentiable forward's (``LOGIT_RTOL``).  The same for reduced
   rwkv6-7b (the full model's f32 params and AdamW state, about 121 GB,
   exceed the card), with ``rwkv6_scan`` exact by route (``scan`` 2, ``step``
   2 x 7).  Step times and peak memory are printed.  Then the five example
   twins (``TWINS``: the service demo plain and ``--compress``) run on the
   card as processes started together; each must exit 0 and print its
   healthy lines.

13. the MoE family and the dense archs (slice 9), one model at a time with
   memory freed between them: granite-moe-1b-a400m (24 layers, d 1024, 32
   experts top-8 of d_ff 512, 1,334,628,352 parameters) at full width in
   bf16 through phase 9's sequence (``launch.serve.main`` and
   ``Engine.generate``, 4 x 1024 -> 32, cache 1056), with
   ``flash_attention``'s launches exact by route (``serve_routes``:
   ``prefill_tc`` 48, ``decode`` 1,488), the profile, the MoE FFN alone timed
   per layer at prefill and decode in its gshard routing and in the sort
   routing (held to 4 bf16 ulps of gshard's output), and the teacher-forced
   comparison with the plain versions, whose runs replay the kernel run's
   routing so that phase 9's rule holds at every position
   (``serve_agreement``; the decisions they would have taken otherwise
   are counted per layer and printed).  Then
   granite-moe trained at full width in f32 through ``launch.train.main``
   (30 steps of 8 x 64, every loss, aux and grad_norm finite, the loss
   falling), a step at 2 microbatches against 1 at capacity E / k with the
   aux weight at 0 (``train_and_serve`` says why), one more step profiled
   and split by CUDA events into the gradient and the update
   (``profile_train_step``) beside the MoE's forward and backward alone,
   and the saved npz served
   with exact launches (eval ``prefill_fma`` 24; generate ``prefill_fma`` 24,
   ``decode`` 168); the same for reduced mixtral-8x7b (46.7 B parameters,
   93 GB in bf16, exceed the card); then mistral-nemo-12b, stablelm-12b (hd
   160) and granite-20b (48 query heads on one kv head, so its decode steps
   take ``prefill_tc``) at full width in bf16, 4 x 256 -> 16, through phase
   9's sequence with exact launches, peak memory printed per model.  The arch
   table (parameters, head_dim, GiB, routes, times, peak) is printed as a
   JSON line.

14. the last three archs and the ring cache (slice 10), one model at a time:
   whisper-tiny whole in bf16 (4 encoder and 4 decoder layers, d 384, 6
   heads of 64, vocab 51,865): 4 x 1500 seeded frame embeddings through
   ``whisper_encode`` and ``prime_cross_cache``, a 4-token prompt and 32 new
   tokens greedily through ``make_serve_step``, ``flash_attention``'s
   launches exact by route (``whisper_routes``: the encoder on
   ``prefill_tc``, self- and cross-attention on ``decode``), times, one
   profile and the teacher-forced comparison with the plain versions
   (phase 9's rule); trained at full size in f32 through
   ``launch.train.main`` (30 steps of 8 x 64, zero frames; the loss must
   fall) and its npz served with exact f32 launches.  qwen2-vl-72b at full
   width cut to its first 8 of 80 layers (9,512,820,736 parameters bf16):
   4 prompts of 256 seeded patch embeddings on a 16 x 16 M-RoPE grid and
   256 text tokens through ``forward_lm(cache=, cache_index=0, positions=,
   extra_embeds=)``, 16 greedy serve steps, launches exact, the comparison
   with the plain versions, and a text-only prefill whose logits equal the
   same model's under ordinary RoPE bit for bit; then reduced qwen2-vl
   trained.  jamba-1.5-large-398b at full width cut to layers 0-4 of 72
   (Mamba 0-3, attention 4, MoE 1 and 3; 24,045,576,192 parameters by
   ``param_count``) through phase 9's sequence (``launch.serve.main
   --num-layers 5``, ``Engine.generate``, 4 x 256 -> 16), launches exact by
   route, the comparison replaying the kernel run's MoE routing; one Mamba
   layer at full width giving a 272-token forward's output from 256 + 16
   one-token steps (``MAMBA_ULPS``); reduced jamba trained.  gemma3-1b's
   ring cache: 4 x 384 -> 256 through ``Engine.generate`` with
   ``RING_CACHE`` on and off (the 512-slot rings wrap after decode step
   128), launches exact, both caches' bytes, and the ring's teacher-forced
   logits against the full cache's under phase 9's rule.  The arch table is
   printed as a JSON line.

15. the mesh-sharded Repository engine (slice 11) on an 8-shard mesh of the
   card (``launch.mesh.make_mesh``: every shard on ``cuda:0`` when there is
   one card).  The sharded ops at full width against the unsharded kernels:
   ``fuse_flat_sharded`` at K=5 x N=123,969,792 bf16 (block 65,536, G 237,
   shard_len 15,532,032, 286,464 elements of padding; a NaN row of weight
   0, alpha 1.0 and 0.3) and at K=3 x N=999,812,736 (G 1,907) must give the
   unsharded ``cold_fuse``'s fused row bit for bit and ``sq_diff`` within
   rtol 1e-5; ``fuse_flat_compressed_sharded`` at C=4 RoBERTa-base payloads
   (the codec's top-k offsets, moved whole into their shards) the unsharded
   accumulator and fused row bit for bit; ``row_sketch_sharded`` of the body
   phase 3's sketch bounds; ``row_sketch_shard`` (the entry for a clamped
   block) against ``row_sketch_shard_plain`` on every shard of 200,000 f32.
   Each sharded call: 8 launches, one all-reduce, no gather; each is timed
   beside the unsharded kernel.  Then the service loop through
   ``launch.serve_repository.main(["--mesh", "8", ...])`` at TINY f32 on the
   card and on the CPU (the same decisions, bases within 1e-5, every sharded
   sketch on ``row_sketch_shard``), and at RoBERTa-base width (``MESH_CALLS``):
   round 1 five dense submissions, whole-row and per-shard (``sspec=``), the
   runaway screened out (4/5); round 2 three compressed, whole-row and
   per-shard, and a byte-identical replay rejected (3/3); round 3 two rows
   staged and the daemon stopped.  Every round's decisions and published
   row must equal those of the unsharded daemon over the same queue (the
   compressed files in the other layout, so both do the same arithmetic)
   bit for bit, and the stopped root reopened under 8 shards, 4 and none
   must recover the staged rows into the same base bit for bit.  Launches
   exact (``MESH_LAUNCHES``: ``cold_fuse`` 16, ``decode_accum`` 8,
   ``row_sketch`` 49), the collectives, peak memory and seconds printed.

Before each of phases 6, 7, 8, 10 and 11, before each model of phases 9, 13
and 14, around phases 12's, 13's and 14's eval steps and generates and
around each run of phase 15's mesh daemon, every kernel's launch counter is
set to 0; it is read just after.  The last lines are the kernels' JSON
record (launches from phase 7 for the three fuse kernels, with phase 10's
as ``launches_routed``, from phase 9 for the other two, phase 11's as
``launches_serve_stack``, phase 12's as ``launches_lm_train``, phase 13's as
``launches_archs``, phase 14's as ``launches_archs2`` and phase 15's as
``launches_mesh`` for all five; phase 15's times under ``mesh``),
``nvidia-smi``'s line and
``{"ok": true, "device": {...}}``.  Without a card (or without the rest of
the repository beside it) the script exits non-zero and prints no result.
"""
import contextlib
import dataclasses
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

from repro_torch.configs import CONFIG, TINY, get_config, reduce_config  # noqa: E402
from repro_torch.core import (Contributor, EvalTask, Repository,  # noqa: E402
                              RepositoryFamily, evaluate_base_model, fusion, run_cold_fusion)
from repro_torch.data.synthetic import SyntheticSuite  # noqa: E402
from repro_torch.checkpoint import io as ckpt  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fa_mod  # noqa: E402
from repro_torch.kernels.cold_fuse import cold_fuse, cold_fuse_plain  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels.decode_accum import decode_accum, decode_accum_plain  # noqa: E402
from repro_torch.kernels.flash_attention import (flash_attention,  # noqa: E402
                                                 flash_attention_plain)
from repro_torch.kernels.row_sketch import (row_sketch, row_sketch_plain,  # noqa: E402
                                            row_sketch_shard, row_sketch_shard_plain)
from repro_torch.kernels import rwkv6_scan as rs_mod  # noqa: E402
from repro_torch.kernels.rwkv6_scan import rwkv6_scan, rwkv6_scan_plain  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.launch.serve import main as serve_main  # noqa: E402
from repro_torch.launch.serve_repository import main as serve_repo_main  # noqa: E402
from repro_torch.launch import train as train_launcher  # noqa: E402
from repro_torch.models import mamba as mamba_mod  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models import rwkv as rwkv_mod  # noqa: E402
from repro_torch.models.encoder import init_encoder_body  # noqa: E402
from repro_torch.models import transformer as tt_mod  # noqa: E402
from repro_torch.models import whisper as whisper_mod  # noqa: E402
from repro_torch.models.transformer import forward_lm, init_cache, init_lm  # noqa: E402
from repro_torch.serve.engine import Engine  # noqa: E402
from repro_torch.train import finetune as FT  # noqa: E402
from repro_torch.train import pretrain as pretrain_mod  # noqa: E402
from repro_torch.train import pretrain_mlm, train_multitask  # noqa: E402
from repro_torch.optim import make_optimizer, warmup_cosine_lr  # noqa: E402
from repro_torch.train.losses import lm_loss  # noqa: E402
from repro_torch.train.step import make_eval_step, make_serve_step, make_train_step  # noqa: E402
from repro_torch.serve.cold_service import (AdmissionPolicy, ColdService,  # noqa: E402
                                            ContributorClient)
from repro_torch.serve.probes import MultitaskEvals, ProbeSuite, RegressionGate  # noqa: E402
from repro_torch.serve.hot_swap import ServingWorker  # noqa: E402
from repro_torch.serve.scheduler import batch_bucket  # noqa: E402
from repro_torch.serve.worker_pool import WorkerPool  # noqa: E402
from repro_torch.core.validation import screen_norms  # noqa: E402
from repro_torch.utils.flat import (LANE, CohortSketch, DeltaPayload,  # noqa: E402
                                    FamilyRouter, FlatSpec, ShardedFlatSpec, delta_checksum,
                                    delta_decode, delta_encode, delta_encode_sharded)
from repro_torch.utils.pytree import tree_leaves, tree_leaves_with_path, tree_map  # noqa: E402

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
F32_FLOPS = 67e12           # H100 SXM float32 outside the tensor cores
BF16_FLOPS = 989e12         # H100 SXM bf16 tensor cores, dense
N_ROBERTA = 123_969_792     # elements of the RoBERTa-base body (FlatSpec.size)
K_MAIN = 5
# the training path at full width (phase 6): batch x sequence of every step
SEQ_MAIN, BATCH_MAIN = 128, 32
PRETRAIN_STEPS, MULTITASK_STEPS = 20, 8
# theta_0's lr, not the reference's 2e-3: in bf16 at this width the loss
# rises after the warmup at 2e-3 and at 1e-3; phase 6 runs both (printed,
# not used) beside it, so every run shows why
PRETRAIN_LR = 5e-4
PRETRAIN_LR_REJECTED = (2e-3, 1e-3)
TIES_DENSITY = 0.2
# the leaves whose ties result the CPU recomputes (embed is the largest)
TIES_LEAVES = ("embed", "layers/layer0/attn/wq", "layers/layer11/mlp/w_down")
# the CUDA sources: flash_attention's three routes live in three files
SOURCES = ("cold_fuse", "decode_accum", "row_sketch", "flash_prefill", "flash_decode",
           "flash_attention", "rwkv6_scan", "rwkv6_step")
FLASH_SOURCE = {"prefill_tc": "flash_prefill", "decode": "flash_decode",
                "prefill_fma": "flash_attention"}
RWKV_SOURCE = {"scan": "rwkv6_scan", "step": "rwkv6_step"}
CODEC_BLOCK, CODEC_KB = 1024, 64   # the service's default delta codec
C_SERVICE = 4
C_MAX_COHORT = 64                  # AdmissionPolicy's default max_cohort
# novelty threshold of the service phases: a replay scores 0; three Adam
# steps from a random-init body move nearly every element by about lr, a
# shared isotropic growth that shrinks the relative distance of distinct
# contributions (docs/service_loop.md puts random-like finetunes near
# 0.03; this script's run on an H100 printed 0.056 for the nearest distinct
# pair), so the screen is set at the documented safe floor, not at 0.1
NOVELTY = 0.01
# the lifecycle phase's harmful cohort: row i is the base plus N(0, s_i^2)
# noise per element, s_i = HARM_NOISE * (1 + i / 4), from the reference's
# gate scenario's N(0, 10^2) (tests/test_cold_service.py).  At one scale the
# four rows' sketches agree to 6e-4-8e-4 at RoBERTa-base width (the sketch's
# lower bounds see isotropic noise only through 32 bucket sums), so the
# novelty screen took three for near-duplicates of the first on an H100;
# distinct scales keep the norms within the MAD screen's cutoff
HARM_NOISE = 10.0
HARM_SCALES = tuple(HARM_NOISE * (1 + i / 4) for i in range(4))
# the routed phase: each stream's row is base + ROUTE_S * (c + 1) * its task
# direction (round 1 twice that), about 100 bf16 ulps of the body's typical
# element (N(0, 0.02) init); the router's default split distance
ROUTE_S = 0.01
ROUTE_SPLIT = 0.8
GEMMA = get_config("gemma3-1b")
RWKV = get_config("rwkv6-7b")
GEMMA_WINDOW = GEMMA.pattern[0].window  # the local layers' 512
# relative nudge of the plain attention / recurrence output in the serving
# comparison: about the f32 difference between kernel and plain that the
# "[check] flash_attention ... f32" lines show on an H100 (6e-7 at unit scale)
NUDGE = 1e-6
# the serving phases: 4 prompts of 1024 (gemma3) or 256 (rwkv6) tokens, 32
# new tokens; flash_attention's prefill kernel shape is (B, Sq, Sk, Hq, Hkv,
# hd) with Sk the Engine's max_len, rwkv6_scan's (B, T, H, hd)
SERVE_NEW = 32
GEMMA_PROMPT, GEMMA_MAX_LEN = 1024, 1280
RWKV_PROMPT, RWKV_MAX_LEN = 256, 256 + SERVE_NEW
FLASH_PREFILL = (4, GEMMA_PROMPT, GEMMA_MAX_LEN, GEMMA.num_heads, GEMMA.num_kv_heads,
                 GEMMA.head_dim)
# head_dim 160 in phases 3 and 4, at stablelm-12b's serving shape in phase 13
# (4 prompts of DENSE_PROMPT tokens -> DENSE_NEW, a cache of their sum)
DENSE_PROMPT, DENSE_NEW = 256, 16
STABLELM = get_config("stablelm-12b")
FLASH_HD160 = (4, DENSE_PROMPT, DENSE_PROMPT + DENSE_NEW, STABLELM.num_heads,
               STABLELM.num_kv_heads, STABLELM.head_dim)
# granite-moe-1b-a400m served in phase 13 as gemma3-1b is in phase 9 (hd 64,
# 16 query heads on 8 kv heads: two decode rows per kv head); its prefill
# and decode shapes are held in phase 3 too
MOE_ARCH = "granite-moe-1b-a400m"
GRANITE_MOE = get_config(MOE_ARCH)
MOE_MAX_LEN = GEMMA_PROMPT + SERVE_NEW
FLASH_MOE = (4, GEMMA_PROMPT, MOE_MAX_LEN, GRANITE_MOE.num_heads, GRANITE_MOE.num_kv_heads,
             GRANITE_MOE.head_dim)
RWKV_PREFILL = (4, RWKV_PROMPT, RWKV.d_model // RWKV.ssm.head_dim, RWKV.ssm.head_dim)
# the fuse-to-serve stack (phase 11) on gemma3-1b at full width: K_SWAP
# contributors submit the base plus SWAP_NOISE x N(0, 1) per leaf; SCHED_N
# concurrent single-row requests meet a scheduler of batches up to
# SCHED_BATCH that waits up to SCHED_WAIT s for a batch to fill; the pool's
# children serve reduce_config(gemma3-1b) on the card, POOL_PROMPT tokens ->
# POOL_NEW
N_GEMMA = 999_812_736       # elements of the gemma3-1b tree (FlatSpec.size)
K_SWAP = 3
SWAP_NOISE = 0.01
SCHED_N, SCHED_BATCH, SCHED_WAIT = 8, 4, 0.5
POOL_CFG = reduce_config(GEMMA)
POOL_PROMPT, POOL_NEW, POOL_MAX_LEN = 16, 8, 64
POOL_BUCKETS = (1, 2, 4)    # the scheduler's buckets up to SCHED_BATCH
# worked out from the code before the first card run (PERF.md):
# Engine.generate calls in this process, each one flash_attention launch per
# layer and token: the iteration-0 oracle, the held request, the iteration-1
# request and its fresh-Engine oracle, the scheduler's SCHED_N / SCHED_BATCH
# batches and as many re-runs, 2 solo calls, the request after the rollback
# and the cross-process worker's request; then one oracle per pool bucket on
# the reduced model.  cold_fuse: the gemma3 cohort and the pool's publish.
SERVE_STACK_LAUNCHES = {
    "flash_attention": ((4 + 2 * (SCHED_N // SCHED_BATCH) + 2 + 2) * GEMMA.num_layers * SERVE_NEW
                        + len(POOL_BUCKETS) * POOL_CFG.num_layers * POOL_NEW),
    "cold_fuse": 2,
}

# LM training (phase 12): the launcher's defaults (batch 8 x 64 tokens, lr
# 3e-4, 20 warmup steps) for TRAIN_STEPS steps, f32 as the launcher sets it;
# the trained params then serve TRAIN_PROMPTS prompts of TRAIN_SEQ tokens ->
# TRAIN_NEW new ones.  Tolerances: a step at 2 microbatches against the same
# step at 1 (f32, TF32 off) within MB_RTOL on loss and grad_norm and MB_ATOL
# on every parameter (the lr at that step is 3e-5; the two gradients differ
# by summation order only); the Engine's prefill logits against the
# differentiable forward's within LOGIT_RTOL x max(1, max |logit|)
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR = 30, 8, 64, 3e-4
TRAIN_PROMPTS, TRAIN_NEW = 4, 8
MB_RTOL, MB_ATOL, LOGIT_RTOL = 1e-5, 1e-6, 2e-4
# the example twins (phase 12), each a process on the card, run together:
# (script, arguments, lines its healthy output holds)
TWINS = (
    ("quickstart_torch.py", [], ["[cold] iter 3/3: fused 4/4 contributions",
                                 "ColD Fusion improved the base model"]),
    ("federated_single_dataset_torch.py", ["--dry-run"], ["round 1: fused 2/2"]),
    ("serve_lm_torch.py", [], ["generated 4x16 tokens"]),
    ("train_lm_e2e_torch.py", [], ["  step  200: loss=", "[train] done in"]),
    ("cold_service_demo_torch.py", [], ["-> iteration 3, 6 contributions fused",
                                        "(expected 0.9000) -> OK"]),
    ("cold_service_demo_torch.py", ["--compress"], ["-> iteration 3, 6 contributions fused",
                                                    "(expected 0.9000) -> OK"]),
)

# the last three archs (phase 14), one model at a time: whisper-tiny whole
# (WHISPER_BATCH x 1500 seeded frame embeddings, a WHISPER_PROMPT-token prompt,
# WHISPER_NEW new tokens), qwen2-vl-72b at full width cut to its first
# QWEN_LAYERS of 80 layers (a vision prefill of QWEN_PATCHES patch embeddings
# on a 16 x 16 grid and QWEN_TEXT text tokens, then QWEN_STEPS serve steps),
# jamba-1.5-large-398b at full width cut to its layers 0-4 of 72 (Mamba 0-3,
# attention 4, MoE 1 and 3; 4 x DENSE_PROMPT -> DENSE_NEW), and gemma3-1b
# with and without the ring cache (4 x RING_PROMPT -> RING_NEW: the local
# layers' 512-slot rings wrap after decode step 128)
WHISPER = get_config("whisper-tiny")
WHISPER_BATCH, WHISPER_PROMPT, WHISPER_NEW = 4, 4, 32
QWEN_LAYERS, QWEN_PATCHES, QWEN_TEXT, QWEN_STEPS = 8, 256, 256, 16
QWEN = dataclasses.replace(get_config("qwen2-vl-72b"), num_layers=QWEN_LAYERS)
QWEN_LEN = QWEN_PATCHES + QWEN_TEXT
JAMBA_ARCH = "jamba-1.5-large-398b"
JAMBA = dataclasses.replace(get_config(JAMBA_ARCH), num_layers=5)
RING_PROMPT, RING_NEW = 384, 256
# one Mamba layer at full width, a 272-token forward against 256 + 16
# one-token steps: the same arithmetic, but bf16 GEMMs of other shapes may
# round a last bit otherwise, so within MAMBA_ULPS bf16 ulps of max |y|
MAMBA_ULPS = 4
FLASH_WHISPER = (WHISPER_BATCH, WHISPER.encoder_seq, WHISPER.encoder_seq, WHISPER.num_heads,
                 WHISPER.num_kv_heads, WHISPER.head_dim)
FLASH_QWEN = (4, QWEN_LEN, QWEN_LEN + QWEN_STEPS + 1, QWEN.num_heads, QWEN.num_kv_heads,
              QWEN.head_dim)


def check(ok, msg):
    if not ok:
        raise RuntimeError(f"check failed: {msg}")


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(log: str):
    """One line per compiled kernel: registers and spill bytes."""
    name, out = None, []
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name, spills = m.group(1), "spills not reported"
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            spills = f"spill stores {m.group(1)} B, loads {m.group(2)} B"
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append(f"{name}: {m.group(1)} registers, {spills}")
            name = None
    return out


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(2.0 ** -126))) - 7)


def f32_ulp(x: torch.Tensor) -> torch.Tensor:
    return torch.exp2(torch.floor(torch.log2(x.float().abs().clamp_min(2.0 ** -126))) - 23)


def fused_error(got, want) -> float:
    """max |got - want|, checked against 1 bf16 ulp (bf16) or 2e-5 (f32)."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    check(bool(torch.isfinite(g).all()), "kernel's fused output is not finite")
    if got.dtype == torch.bfloat16:
        ok = bool((err <= bf16_ulp(torch.maximum(g.abs(), w.abs()))).all())
        check(ok, f"fused differs by more than 1 bf16 ulp (max |d| {err.max().item():.3g})")
    else:
        check(err.max().item() <= 2e-5, f"fused max |d| {err.max().item():.3g} > 2e-5")
    return err.max().item()


def sq_error(got, want) -> float:
    nan_g, nan_w = torch.isnan(got), torch.isnan(want)
    check(bool(torch.equal(nan_g, nan_w)), "sq_diff NaN pattern differs")
    rel = ((got - want).abs() / want.abs().clamp_min(1e-30))[~nan_w]
    worst = rel.max().item() if rel.numel() else 0.0
    check(worst <= 1e-3, f"sq_diff relative error {worst:.3g} > 1e-3")
    return worst


def fuse_inputs(K, N, dtype, gen, nan_row=None):
    dev = torch.device("cuda")
    base = 0.05 * torch.randn(N, generator=gen, device=dev)
    contribs = torch.empty((K, N), dtype=dtype, device=dev)
    for k in range(K):
        contribs[k] = base + 1e-3 * torch.randn(N, generator=gen, device=dev)
    w = torch.rand(K, generator=gen, device=dev) + 0.5
    if nan_row is not None:
        contribs[nan_row] = float("nan")
        w[nan_row] = 0.0
    return base.to(dtype), contribs, w


def reset_launches():
    for fn in (cold_fuse, decode_accum, row_sketch, row_sketch_shard):
        fn.launches = 0
    fa_mod.reset_launches()
    rs_mod.reset_launches()


def launches():
    return {"cold_fuse": cold_fuse.launches, "decode_accum": decode_accum.launches,
            "row_sketch": row_sketch.launches, "flash_attention": flash_attention.launches,
            "rwkv6_scan": rwkv6_scan.launches}


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_kernel_checks(gen):
    """cold_fuse against cold_fuse_plain on the card.  Returns the main
    shape's inputs and the largest fused error there."""
    print(f"[check] cold_fuse vs plain, K={K_MAIN} N={N_ROBERTA} bf16, row 3 NaN with weight 0")
    base, contribs, w = fuse_inputs(K_MAIN, N_ROBERTA, torch.bfloat16, gen, nan_row=3)
    worst = 0.0
    for alpha in (1.0, 0.3):
        fk, sk = cold_fuse(base, contribs, w, alpha)
        fp, sp = cold_fuse_plain(base, contribs, w, alpha)
        e, r = fused_error(fk, fp), sq_error(sk, sp)
        worst = max(worst, e)
        print(f"  alpha={alpha}: fused max|d| {e:.3g} (bound 1 bf16 ulp), "
              f"sq max rel err {r:.3g} (bound 1e-3), sq[3]={sk[3].item()}")
        del fp, sp
    for dtype, K, N in ((torch.float32, 3, 10_000_019), (torch.float32, 3, 10_000_020),
                        (torch.bfloat16, 3, 1_000_003)):
        b, c, ww = fuse_inputs(K, N, dtype, gen, nan_row=1)
        fk, sk = cold_fuse(b, c, ww, 0.3)
        fp, sp = cold_fuse_plain(b, c, ww, 0.3)
        e, r = fused_error(fk, fp), sq_error(sk, sp)
        print(f"  ragged {str(dtype).removeprefix('torch.')} K={K} N={N}: fused max|d| {e:.3g} "
              f"(bound {'2e-5' if dtype == torch.float32 else '1 bf16 ulp'}), sq max rel err {r:.3g}")
    return (base, contribs, w), worst


def phase_timing(inputs, card):
    base, contribs, w = inputs
    K, N = contribs.shape
    s = base.element_size()
    nbytes = (K + 1) * N * s + N * s + 2 * K * 4
    flops = 4 * K * N + 3 * N  # per row and element: sub, fma (sq), select, fma (avg)
    bound_bytes, bound_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    bound = max(bound_bytes, bound_ops)
    # five timing windows each; the median is reported, all are printed
    runs = [time_ms(lambda: cold_fuse(base, contribs, w, 1.0), iters=20) for _ in range(5)]
    plain_runs = [time_ms(lambda: cold_fuse_plain(base, contribs, w, 1.0), iters=3, warmup=1)
                  for _ in range(5)]
    ms, plain = sorted(runs)[2], sorted(plain_runs)[2]
    print(f"[time] cold_fuse K={K} N={N} bf16 on {card}: kernel_ms {ms:.4f} "
          f"(windows {[round(r, 4) for r in runs]}), bound_ms {bound:.4f} "
          f"({nbytes / 1e9:.3f} GB at 3.35 TB/s), kernel/bound {ms / bound:.2f}x, "
          f"plain_ms {plain:.4f} (windows {[round(r, 3) for r in plain_runs]})")
    print("[time] library_ms: none — no single PyTorch call computes both fused and sq_diff")
    return ms, plain, bound, "bytes" if bound_bytes >= bound_ops else "operations"


def phase_small_agreement():
    """The card's screen + fuse against the CPU path at a small size."""
    gen = torch.Generator().manual_seed(1)
    body = init_encoder_body(TINY, gen, device="cpu")
    noise = torch.Generator().manual_seed(2)
    uploads = [tree_map(lambda x: x + 0.01 * torch.randn(x.shape, generator=noise), body)
               for _ in range(3)]
    uploads.append(tree_map(lambda x: torch.full_like(x, float("nan")), body))
    bases, recs = [], []
    for dev in ("cpu", "cuda"):
        repo = Repository(tree_map(lambda x: x.to(dev), body))
        for u in uploads:
            repo.upload(tree_map(lambda x: x.to(dev), u))
        recs.append(repo.fuse_pending())
        bases.append(FlatSpec.from_tree(repo.download()).flatten(repo.download()).cpu())
    d = (bases[0] - bases[1]).abs().max().item()
    check(recs[0].n_accepted == recs[1].n_accepted == 3, "small cohort: 3/4 must fuse")
    check(d <= 1e-5, f"card and CPU published bases differ by {d:.3g} > 1e-5")
    print(f"[small] TINY f32 cohort of 4 (one NaN): card vs CPU published base max|d| {d:.3g} "
          f"(bound 1e-5), fused {recs[1].n_accepted}/{recs[1].n_contributions} on both")


def phase_small_per_leaf():
    """The per-leaf engine's fisher and ties repositories, card against CPU,
    on the same TINY f32 cohort (3 noisy uploads and a NaN one)."""
    gen = torch.Generator().manual_seed(3)
    body = init_encoder_body(TINY, gen, device="cpu")
    noise = torch.Generator().manual_seed(4)
    uploads = [tree_map(lambda x: x + 0.01 * torch.randn(x.shape, generator=noise), body)
               for _ in range(3)]
    uploads.append(tree_map(lambda x: torch.full_like(x, float("nan")), body))
    fishers = [tree_map(lambda x: torch.rand(x.shape, generator=noise), body) for _ in uploads]
    for op, kw in (("fisher", {}), ("ties", {"density": TIES_DENSITY})):
        bases, recs = [], []
        for dev in ("cpu", "cuda"):
            on = lambda t: tree_map(lambda x: x.to(dev), t)
            repo = Repository(on(body), fusion_op=op, fusion_kwargs=kw)
            check(not repo.use_flat, f"{op} must take the per-leaf engine")
            for u, f in zip(uploads, fishers):
                repo.upload(on(u), on(f))
            recs.append(repo.fuse_pending())
            bases.append(repo.flat_base_host())
        d = (bases[0] - bases[1]).abs().max().item()
        check(recs[0].n_accepted == recs[1].n_accepted == 3, f"small {op}: 3/4 must fuse")
        check(d <= 1e-5, f"small {op}: card and CPU published bases differ by {d:.3g} > 1e-5")
        print(f"[small] TINY f32 {op} repository, cohort of 4 (one NaN): card vs CPU published "
              f"base max|d| {d:.3g} (bound 1e-5), fused {recs[1].n_accepted}/"
              f"{recs[1].n_contributions} on both")


@contextlib.contextmanager
def timed(module, name):
    """Time every call of ``module.name`` made on this thread on the host
    clock, synchronised on both sides, into the yielded list (seconds);
    restored on exit.  Calls from other threads (the spill executor) run
    untimed."""
    fn, seconds, me = getattr(module, name), [], threading.current_thread()

    def wrapper(*args, **kwargs):
        if threading.current_thread() is not me:
            return fn(*args, **kwargs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        return out

    setattr(module, name, wrapper)
    try:
        yield seconds
    finally:
        setattr(module, name, fn)


def median_ms(seconds) -> str:
    return (f"median {1e3 * float(np.median(seconds)):.1f} ms over {len(seconds)} "
            f"(min {1e3 * min(seconds):.1f}, max {1e3 * max(seconds):.1f})")


def all_finite(tree) -> bool:
    return all(bool(torch.isfinite(x).all()) for x in tree_leaves(tree))


def main_contributors(suite, tids, **kw):
    out = []
    for tid in tids:
        d = suite.dataset(tid, 128, 32, SEQ_MAIN)
        out.append(Contributor(CONFIG, tid, suite.tasks[tid].num_classes, d["x_train"],
                               d["y_train"], steps=3, batch_size=BATCH_MAIN, seed=tid, **kw))
    return out


def loss_summary(losses) -> str:
    warm = max(10, len(losses) // 20)
    return (f"loss {losses[0]:.4f} -> {losses[-1]:.4f}, max after the {warm}-step warmup "
            f"{max(losses[warm:]):.4f} (min {min(losses):.4f}); every step: "
            f"{' '.join(f'{x:.3f}' for x in losses)}")


def phase_pretrain(suite, card):
    """Step 1 of the main path: theta_0 from ``pretrain_mlm`` at full width,
    after the same pretraining at the larger lrs it does not use."""
    for lr in PRETRAIN_LR_REJECTED:
        _, m = pretrain_mlm(CONFIG, suite, steps=PRETRAIN_STEPS, batch_size=BATCH_MAIN,
                            seq_len=SEQ_MAIN, lr=lr)
        check(all(math.isfinite(x) for x in m["loss"]), f"lr {lr:g}: losses not finite")
        print(f"[main] pretrain_mlm at lr {lr:g} (not used): {loss_summary(m['loss'])}")
    t0 = time.perf_counter()
    with timed(pretrain_mod, "mlm_step") as step_s:
        body, m = pretrain_mlm(CONFIG, suite, steps=PRETRAIN_STEPS, batch_size=BATCH_MAIN,
                               seq_len=SEQ_MAIN, lr=PRETRAIN_LR)
    losses = m["loss"]
    check(len(losses) == PRETRAIN_STEPS and all(math.isfinite(x) for x in losses),
          f"pretrain losses not finite: {losses}")
    check(all_finite(body), "pretrained body is not finite")
    print(f"[main] pretrain_mlm {PRETRAIN_STEPS} steps (batch {BATCH_MAIN}, seq {SEQ_MAIN}, "
          f"lr {PRETRAIN_LR:g}): {loss_summary(losses)}; {time.perf_counter() - t0:.1f} s")
    print(f"[time] pretrain step on {card}: {median_ms(step_s)}")
    return body


def phase_fisher(theta, suite, card):
    """One iteration of 4 Contributor(with_fisher=True) into a fisher
    Repository; returns the cohort for the all-ones check."""
    contribs = main_contributors(suite, range(4), with_fisher=True)
    repo = Repository(theta, fusion_op="fisher")
    check(not repo.use_flat, "fusion_op='fisher' must take the per-leaf engine")
    base = repo.download()
    bodies = []
    with timed(FT, "compute_fisher") as fisher_s:
        for c in contribs:
            bodies.append(c.contribute(base))
            repo.upload(bodies[-1], c.last_fisher)
    check(all(all_finite(c.last_fisher) for c in contribs), "a Fisher is not finite")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rec = repo.fuse_pending()
    torch.cuda.synchronize()
    fuse_s = time.perf_counter() - t0
    print(f"[main] fisher iteration: fused {rec.n_accepted}/{rec.n_contributions} "
          f"(diff norms {[f'{n:.4g}' for n in rec.diff_norms]})")
    check((rec.n_accepted, rec.n_contributions) == (4, 4), "the fisher cohort must fuse 4/4")
    check(all_finite(repo.download()), "the fisher base is not finite")
    print(f"[time] compute_fisher on {card} (4 batches of {BATCH_MAIN} x {SEQ_MAIN}, "
          f"f32 squares of bf16 grads): {median_ms(fisher_s)}")
    print(f"[time] fisher fuse on {card} (screen + per-leaf fuse of 4, synchronised): "
          f"{1e3 * fuse_s:.1f} ms")
    return bodies


def phase_ties(theta, contribs, card):
    """One iteration of 4 contributors into a ties Repository; returns the
    base and the cohort for the CPU comparison."""
    repo = Repository(theta, fusion_op="ties", fusion_kwargs={"density": TIES_DENSITY})
    base = repo.download()
    bodies = [c.contribute(base) for c in contribs]
    for b in bodies:
        repo.upload(b)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rec = repo.fuse_pending()
    torch.cuda.synchronize()
    fuse_s = time.perf_counter() - t0
    print(f"[main] ties iteration (density {TIES_DENSITY}): fused {rec.n_accepted}/"
          f"{rec.n_contributions} (diff norms {[f'{n:.4g}' for n in rec.diff_norms]})")
    check((rec.n_accepted, rec.n_contributions) == (4, 4), "the ties cohort must fuse 4/4")
    check(all_finite(repo.download()), "the ties base is not finite")
    print(f"[time] ties fuse on {card} (screen + per-leaf fuse of 4, synchronised): "
          f"{1e3 * fuse_s:.1f} ms")
    return base, bodies, repo.download()


def check_fisher_ones(bodies):
    """With all-ones Fishers the fisher fuse is the plain average."""
    ones = tree_map(lambda x: torch.ones(x.shape, dtype=torch.float32, device=x.device),
                    bodies[0])
    spec = FlatSpec.from_tree(bodies[0])
    got = spec.flatten(fusion.fisher_weighted(bodies, [ones] * len(bodies)))
    want = spec.flatten(fusion.average(bodies))
    err = (got.float() - want.float()).abs()
    ok = bool((err <= bf16_ulp(torch.maximum(got.float().abs(), want.float().abs()))).all())
    check(ok, f"all-ones fisher differs from average by more than 1 bf16 ulp "
              f"(max |d| {err.max().item():.3g})")
    print(f"[check] fisher fuse with all-ones Fishers vs average (cold_fuse) over "
          f"{spec.size:,} bf16: max|d| {err.max().item():.3g}, "
          f"{int(torch.count_nonzero(err))} elements differ, all within 1 bf16 ulp")


def check_ties_on_cpu(base, bodies, fused, card):
    """ties on the CPU against the card's published leaves, and the kept
    elements per contributor; then the threshold's two selections timed."""
    def leaf(tree, path):
        return dict(tree_leaves_with_path(tree))[path]

    for path in TIES_LEAVES:
        b_card, m_card = leaf(base, path), [leaf(b, path) for b in bodies]
        b_cpu, m_cpu = b_card.cpu(), [m.cpu() for m in m_card]
        want = fusion.ties({"w": b_cpu}, [{"w": m} for m in m_cpu], density=TIES_DENSITY)["w"]
        got = leaf(fused, path).cpu()
        err = (got.float() - want.float()).abs()
        ok = bool((err <= bf16_ulp(torch.maximum(got.float().abs(),
                                                 want.float().abs()))).all())
        check(ok, f"ties {path}: card and CPU differ by more than 1 bf16 ulp "
                  f"(max |d| {err.max().item():.3g})")
        kept_card = [int(torch.count_nonzero(fusion.ties_trim(
            m.float() - b_card.float(), TIES_DENSITY))) for m in m_card]
        kept_cpu = [int(torch.count_nonzero(fusion.ties_trim(
            m.float() - b_cpu.float(), TIES_DENSITY))) for m in m_cpu]
        check(kept_card == kept_cpu, f"ties {path}: kept {kept_card} on the card, "
                                     f"{kept_cpu} on the CPU")
        print(f"[check] ties {path} {tuple(got.shape)}: card vs CPU max|d| "
              f"{err.max().item():.3g} (bound 1 bf16 ulp), nonzero kept per contributor "
              f"{kept_card} on both (k = {max(1, int(TIES_DENSITY * got.numel())):,}; a delta "
              "with fewer nonzeros keeps them all)")
    mag = (bodies[0]["embed"].float() - base["embed"].float()).abs().reshape(-1)
    n, k = mag.numel(), max(1, int(TIES_DENSITY * mag.numel()))
    check(fusion.ties_threshold(mag, k).item() == torch.kthvalue(mag, n - k + 1).values.item(),
          "topk's and kthvalue's thresholds differ")
    t_topk = time_ms(lambda: fusion.ties_threshold(mag, k), iters=5)
    t_kth = time_ms(lambda: torch.kthvalue(mag, n - k + 1), iters=5)
    print(f"[time] ties threshold on embed ({n:,} f32, k {k:,}) on {card}: topk {t_topk:.3f} ms, "
          f"kthvalue {t_kth:.3f} ms (the same value)")


def phase_main_path(card):
    suite = SyntheticSuite(vocab_size=CONFIG.vocab_size, num_tasks=16, seed=0)
    theta0 = phase_pretrain(suite, card)
    repo = Repository(theta0)
    spec = FlatSpec.from_tree(repo.download())
    check(spec.size == N_ROBERTA and spec.dtype == "bfloat16",
          f"RoBERTa-base body is {spec.size} {spec.dtype}, expected {N_ROBERTA} bfloat16")
    seq, batch = SEQ_MAIN, BATCH_MAIN
    contribs = main_contributors(suite, range(4))
    t0 = time.perf_counter()
    with timed(FT, "train_step") as ft_s:
        run_cold_fusion(CONFIG, repo, contribs, iterations=2, progress=True)
    torch.cuda.synchronize()
    print(f"[main] 2 iterations x 4 contributors x 3 steps (batch {batch}, seq {seq}) from "
          f"theta_0: {time.perf_counter() - t0:.1f} s")
    print(f"[time] contributor finetune step on {card} (body + head, AdamW): {median_ms(ft_s)}")

    base = repo.download()
    for c in contribs[:3]:
        repo.upload(c.contribute(base))
    repo.upload(tree_map(lambda x: torch.full_like(x, float("nan")), base))
    noise = torch.Generator(device=repo.device).manual_seed(1)
    repo.upload(tree_map(lambda x: x + (100.0 * torch.randn(
        x.shape, generator=noise, device=x.device)).to(x.dtype), base))
    rec = repo.fuse_pending()
    print(f"[main] adversarial cohort: fused {rec.n_accepted}/{rec.n_contributions} "
          f"(diff norms {[f'{n:.4g}' for n in rec.diff_norms]})")
    check((rec.n_accepted, rec.n_contributions) == (3, 5), "the screen must reject NaN and runaway")

    tasks = []
    for tid in (4, 5):
        d = suite.dataset(tid, 64, 64, seq, split_seed=1)
        tasks.append(EvalTask(tid, suite.tasks[tid].num_classes, d["x_train"], d["y_train"],
                              d["x_test"], d["y_test"]))
    acc = evaluate_base_model(CONFIG, repo.download(), tasks, frozen=True, steps=3)
    check(all(math.isfinite(a) and 0.0 <= a <= 1.0 for a in acc.values()), f"accuracy {acc}")
    print(f"[main] frozen-probe accuracy on tasks 4, 5 after 3 head steps: {acc}")

    pub = repo.download()
    pspec = FlatSpec.from_tree(pub)
    row = pspec.flatten(pub)
    check(pspec.size == N_ROBERTA and row.dtype == torch.bfloat16, "published base shape/dtype")
    check(bool(torch.isfinite(row).all()), "published base is not finite")
    print(f"[main] published base: {pspec.size} bf16 elements, all finite")

    # the paper's centralised baseline (Fig. 2) over the same 4 tasks
    datasets = [(c.task_id, c.x, c.y, c.num_classes) for c in contribs]
    with timed(FT, "train_step") as mt_s:
        mt_body, heads = train_multitask(CONFIG, theta0, datasets, steps=MULTITASK_STEPS,
                                         batch_size=batch)
    check(all_finite(mt_body) and all(all_finite(h) for h in heads.values()),
          "multitask body or heads not finite")
    print(f"[main] train_multitask {MULTITASK_STEPS} steps over tasks {sorted(heads)}: body "
          f"and {len(heads)} heads finite")
    print(f"[time] multitask step on {card}: {median_ms(mt_s)}")
    del mt_body, heads

    fisher_bodies = phase_fisher(pub, suite, card)
    ties_held = phase_ties(pub, contribs, card)
    return fisher_bodies, ties_held

def graph_windows(fn, iters: int):
    """Device time per call: ``iters`` calls captured in one CUDA graph and
    replayed, five windows of one replay each (median ms, all windows).
    Without the host's per-call work, this is the kernels' own time."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    runs = [time_ms(graph.replay, iters=1, warmup=0) / iters for _ in range(5)]
    del graph
    return sorted(runs)[2], runs


def median_windows(fn, iters: int, warmup: int = 2):
    """Five timing windows: (median ms, all windows)."""
    runs = [time_ms(fn, iters=iters, warmup=warmup) for _ in range(5)]
    return sorted(runs)[2], runs


def bound_of(nbytes: float, flops: float, peak: float = F32_FLOPS):
    """(bound_ms, bound_by): the larger of bytes at 3.35 TB/s and the
    operations at ``peak`` (f32 67 TFLOP/s unless given)."""
    b, o = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return max(b, o), "bytes" if b >= o else "operations"


def payloads_on_card(C, size, block, kb, gen, nan_row=None, topk=False):
    """Random codec arrays on the card: offsets drawn at random with slot 1
    repeating slot 0 or, with ``topk``, as ``delta_encode`` writes them: a
    row's kb distinct offsets in the order of a top-k of random magnitudes
    (``topk`` of random keys, a chunk of rows at a time); int8 values,
    small f32 scales, weights in [0.5, 1.5)."""
    dev = torch.device("cuda")
    nb = -(-size // block)
    if topk:
        idx = torch.empty((C, nb, kb), dtype=torch.int16, device=dev)
        rows = idx.view(-1, kb)
        chunk = max(1, (1 << 26) // block)  # 256 MB of f32 keys at a time
        for r0 in range(0, rows.shape[0], chunk):
            keys = torch.rand((min(chunk, rows.shape[0] - r0), block), generator=gen, device=dev)
            rows[r0:r0 + keys.shape[0]] = keys.topk(kb, dim=1).indices.to(torch.int16)
        del keys
    else:
        idx = torch.randint(0, block, (C, nb, kb), generator=gen, device=dev).to(torch.int16)
        if kb >= 2:
            idx[:, :, 1] = idx[:, :, 0]
    val = torch.randint(-127, 128, (C, nb, kb), generator=gen, device=dev).to(torch.int8)
    scl = torch.rand((C, nb), generator=gen, device=dev) * 1e-4
    w = torch.rand(C, generator=gen, device=dev) + 0.5
    if nan_row is not None:
        scl[nan_row] = float("nan")
        w[nan_row] = 0.0
    return idx, val, scl, w


# decode_accum's payload kinds: random offsets with slot 1 repeating slot 0
# (every row takes the kernel's path for repeats; the kind the record's
# `ms` has always timed), and the codec's top-k offsets (no repeats, the
# service's traffic)
DECODE_KINDS = ("repeats", "top-k")


def decode_error(got, want):
    """(max |d acc|, max relative d sq), checked against 1e-6·max|acc| and 1e-5."""
    (acc, sq), (acc_p, sq_p) = got, want
    check(bool(torch.isfinite(acc).all()), "decode_accum acc is not finite")
    err = (acc - acc_p).abs().max().item()
    scale = acc_p.abs().max().item()
    check(err <= 1e-6 * scale, f"decode_accum acc max|d| {err:.3g} > 1e-6 x {scale:.3g}")
    nan, nan_p = torch.isnan(sq), torch.isnan(sq_p)
    check(bool(torch.equal(nan, nan_p)), "decode_accum sq NaN pattern differs")
    rel = ((sq - sq_p).abs() / sq_p.abs().clamp_min(1e-30))[~nan_p]
    worst = rel.max().item() if rel.numel() else 0.0
    check(worst <= 1e-5, f"decode_accum sq relative error {worst:.3g} > 1e-5")
    return err, worst


def decode_repeats(args, size, block):
    """Whether two calls on the same inputs give the same bits (sq may hold a
    NaN, which equals nothing as a float, so the bits are compared)."""
    first = decode_accum(*args, size=size, block=block)
    again = decode_accum(*args, size=size, block=block)
    return all(torch.equal(x.view(torch.int32), y.view(torch.int32))
               for x, y in zip(first, again))


def phase_decode_checks(gen):
    """decode_accum against decode_accum_plain on the card, on both payload
    kinds, and called twice on the same inputs, which must give the same
    bits.  Returns the service shape's inputs by (C, kind) and the largest
    acc error."""
    nb = -(-N_ROBERTA // CODEC_BLOCK)
    print(f"[check] decode_accum vs plain, C={C_SERVICE}+1 nb={nb} kb={CODEC_KB} "
          f"block={CODEC_BLOCK} size={N_ROBERTA}, row {C_SERVICE} NaN scale with weight 0")
    inputs, err = {}, 0.0
    for kind in DECODE_KINDS:
        args = payloads_on_card(C_SERVICE + 1, N_ROBERTA, CODEC_BLOCK, CODEC_KB, gen,
                                nan_row=C_SERVICE, topk=kind == "top-k")
        got = decode_accum(*args, size=N_ROBERTA, block=CODEC_BLOCK)
        want = decode_accum_plain(*args, size=N_ROBERTA, block=CODEC_BLOCK)
        e, rel = decode_error(got, want)
        check(decode_repeats(args, N_ROBERTA, CODEC_BLOCK),
              f"decode_accum ({kind} offsets): two calls on the same inputs differ")
        print(f"  service shape, {kind} offsets: acc max|d| {e:.3g} (bound 1e-6 x max|acc| = "
              f"{1e-6 * want[0].abs().max().item():.3g}), sq max rel err {rel:.3g} (bound "
              f"1e-5), sq[{C_SERVICE}]={got[1][C_SERVICE].item()}; called twice: bit-identical")
        err = max(err, e)
        inputs[C_SERVICE, kind] = tuple(t[:C_SERVICE].contiguous() for t in args)
        del got, want, args
    for kind in DECODE_KINDS:
        wide = payloads_on_card(C_MAX_COHORT, N_ROBERTA, CODEC_BLOCK, CODEC_KB, gen,
                                topk=kind == "top-k")
        e, r = decode_error(decode_accum(*wide, size=N_ROBERTA, block=CODEC_BLOCK),
                            decode_accum_plain(*wide, size=N_ROBERTA, block=CODEC_BLOCK))
        check(decode_repeats(wide, N_ROBERTA, CODEC_BLOCK),
              f"decode_accum (C={C_MAX_COHORT}, {kind} offsets): two calls differ")
        err = max(err, e)
        inputs[C_MAX_COHORT, kind] = wide
        print(f"  C={C_MAX_COHORT} (the service's max_cohort) at the service shape, {kind} "
              f"offsets: acc max|d| {e:.3g}, sq max rel err {r:.3g}; called twice: "
              "bit-identical")
        torch.cuda.empty_cache()
    for C, size, block, kb, nan_row in ((3, 10_000_019, 32768, 100, 1),
                                        (1, 1_000_003, 1024, 64, None),
                                        (2, 3_000_001, 2048, 2048, None)):
        args = payloads_on_card(C, size, block, kb, gen, nan_row=nan_row)
        e, r = decode_error(decode_accum(*args, size=size, block=block),
                            decode_accum_plain(*args, size=size, block=block))
        print(f"  ragged C={C} size={size} block={block} kb={kb}: acc max|d| {e:.3g}, "
              f"sq max rel err {r:.3g}")
    return inputs, err


def decode_bound(C, nb, kb):
    """decode_accum's bound at the service size: the payloads read once, the
    f32 accumulator and sq written once."""
    nbytes = C * nb * kb * 3 + C * nb * 4 + C * 4 + N_ROBERTA * 4 + C * 4
    flops = 4 * C * nb * kb  # per entry: dequantise, square-add (2), weight, add
    return bound_of(nbytes, flops) + (nbytes,)


def decode_floor(card):
    """The write floor: ``torch.zeros`` of the f32 accumulator (ms)."""
    floor, runs = median_windows(
        lambda: torch.zeros(N_ROBERTA, dtype=torch.float32, device="cuda"), iters=20)
    print(f"[time] decode_accum write floor: torch.zeros({N_ROBERTA}) f32 on {card}: "
          f"{floor:.4f} ms (windows {[round(r, 4) for r in runs]})")
    return floor


def decode_time(args, kind, card):
    """Eager and CUDA-graph (device) times of one payload at the service
    size, beside its bound: {"ms", "graph_ms", "bound_ms", "bound_by"}."""
    C, nb, kb = args[0].shape
    call = lambda: decode_accum(*args, size=N_ROBERTA, block=CODEC_BLOCK)  # noqa: E731
    bound, bound_by, nbytes = decode_bound(C, nb, kb)
    iters = 20 if C <= C_SERVICE else 5
    ms, runs = median_windows(call, iters=iters)
    g_ms, g_runs = graph_windows(call, iters)
    print(f"[time] decode_accum C={C} nb={nb} kb={kb}, {kind} offsets, on {card}: "
          f"kernel_ms {ms:.4f} (windows {[round(r, 4) for r in runs]}), from a CUDA graph "
          f"(device) {g_ms:.4f} (windows {[round(r, 4) for r in g_runs]}), bound_ms "
          f"{bound:.4f} ({nbytes / 1e6:.1f} MB at 3.35 TB/s), device/bound "
          f"{g_ms / bound:.2f}x")
    return {"ms": ms, "graph_ms": g_ms, "bound_ms": bound, "bound_by": bound_by}


def phase_decode_timing(inputs, card):
    """Eager and CUDA-graph (device) times at C=4 and C=64 on both payload
    kinds beside the bound and the write floor.  The record's ``ms`` and
    ``graph_ms`` are those of the repeated offsets, the kind earlier
    records timed; ``codec_ms`` and ``codec_graph_ms`` those of the codec's
    top-k offsets.  Returns the C=4 (ms, plain_ms, bound_ms, bound_by) and
    the extra numbers."""
    floor = decode_floor(card)
    out = {key: decode_time(a, key[1], card) for key, a in inputs.items()}
    idx, val, scl, w = inputs[C_SERVICE, "repeats"]
    plain, plain_runs = median_windows(
        lambda: decode_accum_plain(idx, val, scl, w, size=N_ROBERTA, block=CODEC_BLOCK),
        iters=3, warmup=1)
    print(f"[time] decode_accum plain C={C_SERVICE}, repeats offsets: plain_ms {plain:.4f} "
          f"(windows {[round(r, 3) for r in plain_runs]})")
    print("[time] decode_accum library_ms: none — no single PyTorch call computes the "
          "weighted scatter acc and the per-row sq together")

    def numbers(C):
        rep, top = out[C, "repeats"], out[C, "top-k"]
        return {"graph_ms": rep["graph_ms"], "codec_ms": top["ms"],
                "codec_graph_ms": top["graph_ms"]}

    main = out[C_SERVICE, "repeats"]
    wide = out[C_MAX_COHORT, "repeats"]
    extra = dict(numbers(C_SERVICE), write_floor_ms=floor,
                 wide=dict(numbers(C_MAX_COHORT), C=C_MAX_COHORT, ms=wide["ms"],
                           bound_ms=wide["bound_ms"]))
    return (main["ms"], plain, main["bound_ms"], main["bound_by"]), extra


def sketch_error(got, want, x):
    """max |d| over the sketch, checked per bucket: sums against 1e-5 x the
    bucket's sum of |x|, sums of squares against 1e-5 relative."""
    nb = got.shape[1]
    pad = (-x.shape[0]) % LANE
    tiles = torch.cat([x.float().abs(), x.new_zeros(pad, dtype=torch.float32)]).view(-1, LANE)
    abs_sum = torch.zeros(nb, device=x.device).index_add_(
        0, torch.arange(tiles.shape[0], device=x.device) % nb, tiles.sum(1))
    check(bool(torch.isfinite(got).all()), "row_sketch output is not finite")
    check(bool(((got[0] - want[0]).abs() <= 1e-5 * abs_sum).all()),
          "row_sketch sums differ by more than 1e-5 x the bucket's sum of |x|")
    rel = ((got[1] - want[1]).abs() / want[1].abs().clamp_min(1e-30)).max().item()
    check(rel <= 1e-5, f"row_sketch sums of squares relative error {rel:.3g} > 1e-5")
    return (got - want).abs().max().item(), rel


def phase_sketch_checks(gen):
    """row_sketch against row_sketch_plain on the card.  Returns the bf16
    body-sized row and the largest error there."""
    dev = torch.device("cuda")
    out = None
    for dtype, N, nb in ((torch.bfloat16, N_ROBERTA, 32), (torch.float32, 1_000_003, 7),
                         (torch.float32, 100, 32)):
        x = (0.05 * torch.randn(N, generator=gen, device=dev) + 0.01).to(dtype)
        e, r = sketch_error(row_sketch(x, nb), row_sketch_plain(x, nb), x)
        print(f"[check] row_sketch vs plain, N={N} {str(dtype).removeprefix('torch.')} "
              f"n_buckets={nb}: max|d| {e:.3g} (sums bound 1e-5 x bucket sum|x|), "
              f"sq-sums max rel err {r:.3g} (bound 1e-5)")
        if out is None:
            out = (x, e)
    return out


def phase_sketch_timing(x, card):
    N = x.shape[0]
    nbytes = N * x.element_size() + 2 * 32 * 4
    bound, bound_by = bound_of(nbytes, 3 * N)  # per element: add, fma (2)
    ms, runs = median_windows(lambda: row_sketch(x, 32), iters=20)
    plain, plain_runs = median_windows(lambda: row_sketch_plain(x, 32), iters=3, warmup=1)
    print(f"[time] row_sketch N={N} bf16 32 buckets on {card}: kernel_ms {ms:.4f} "
          f"(windows {[round(r, 4) for r in runs]}), bound_ms {bound:.4f} "
          f"({nbytes / 1e6:.1f} MB at 3.35 TB/s), kernel/bound {ms / bound:.2f}x, "
          f"plain_ms {plain:.4f} (windows {[round(r, 3) for r in plain_runs]})")
    print("[time] row_sketch library_ms: none — no single PyTorch call computes the "
          "tile-bucketed sums and sums of squares")
    return ms, plain, bound, bound_by


def copy_into_queue(src: str, name: str) -> str:
    """A byte-identical copy of a queue file under another name, made
    visible atomically (the scan ignores ``.tmp-`` names)."""
    dst = os.path.join(os.path.dirname(src), name)
    shutil.copyfile(src, dst + ".tmp-copy")
    os.replace(dst + ".tmp-copy", dst)
    return dst


def serve_until(svc, done, timeout: float = 300.0):
    """Poll the service until ``done(status)`` holds and it is idle; fail at
    once when a cohort is stuck below ``min_cohort`` with the queue empty."""
    t0 = time.perf_counter()
    while True:
        st = svc.run_once()
        check(st["last_error"] is None, f"service error: {st['last_error']}")
        if done(st) and not st["inflight"] and st["staged"] == 0 and st["queue_depth"] == 0:
            return st
        check(not (st["queue_depth"] == 0 and not st["inflight"]
                   and 0 < st["staged"] < svc.policy.min_cohort),
              f"a cohort of {st['staged']} is stuck below min_cohort: {st}")
        check(time.perf_counter() - t0 < timeout, f"service did not settle in {timeout} s: {st}")


def nearest_pair(repo, iteration: int, n: int) -> float:
    """The smallest novelty distance between the newest ``n`` admissions,
    against the base they were admitted under."""
    sk = repo.cohort_sketch
    at = CohortSketch(sk.size, sk.n_buckets)
    at.set_base(sk.bases[iteration])
    ents = [e[2] for e in sk.entries[-n:]]
    return min(at.distance(a, b) for i, a in enumerate(ents) for b in ents[i + 1:])


def drain_small(device, root, rows, spec, b0):
    """A small queue (2 dense rows, one without a rider sketch, 3
    compressed rows, one a runaway, and a replay) drained on ``device``."""
    body = spec.unflatten(b0.to(device))
    repo = Repository(tree_map(lambda x: x.clone(), body), root=root, spill=True)
    svc = ColdService(repo, policy=AdmissionPolicy(min_cohort=5, novelty_threshold=NOVELTY))
    for i, r in enumerate(rows):
        sid = ContributorClient(root, f"c{i}").submit(
            row=r, spec=spec, base_iteration=0, compress=i >= 2, base=b0, sketch=i != 1)
        if i == 2:
            copy_into_queue(os.path.join(root, "queue", sid + ".npz"), "replay-000000.npz")
    st = serve_until(svc, lambda st: st["iteration"] >= 1, timeout=120)
    rec = repo.history[-1]
    return (rec.n_accepted, rec.n_contributions, st["recent_rejects"],
            repo.flat_base_host().float())


def phase_small_service(workdir):
    """The same small queue drained by the service on the CPU and on the card."""
    gen = torch.Generator().manual_seed(3)
    body = init_encoder_body(TINY, gen, device="cpu")
    spec = FlatSpec.from_tree(body)
    b0 = spec.flatten(body)
    rows = [b0 + 0.01 * torch.randn(b0.shape, generator=gen) for _ in range(4)]
    rows.append(b0 + 100.0 * torch.randn(b0.shape, generator=gen))  # the runaway
    out = [drain_small(dev, os.path.join(workdir, f"small-{dev}"), rows, spec, b0)
           for dev in ("cpu", "cuda")]
    (acc_c, k_c, rej_c, base_c), (acc_g, k_g, rej_g, base_g) = out
    d = (base_c - base_g).abs().max().item()
    check((acc_c, k_c) == (acc_g, k_g) == (4, 5), f"small queue: fused {acc_g}/{k_g}, "
          f"CPU {acc_c}/{k_c}, expected 4/5")
    check(rej_c == rej_g and [r["file"] for r in rej_g] == ["replay-000000.npz"],
          f"small queue rejections differ: CPU {rej_c}, card {rej_g}")
    check(d <= 1e-5, f"small queue: card and CPU published bases differ by {d:.3g} > 1e-5")
    print(f"[small] TINY f32 queue (2 dense, 3 compressed incl. a runaway, 1 replay): fused "
          f"{acc_g}/{k_g} and the replay rejected on both; card vs CPU base max|d| {d:.3g} "
          "(bound 1e-5)")


def phase_service_path(workdir):
    """The contributor service loop at RoBERTa-base width (phase 7)."""
    seq, batch = 128, 32
    root = os.path.join(workdir, "service")
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    repo = Repository(init_encoder_body(CONFIG, gen, device="cuda"), root=root, spill=True)
    spec = FlatSpec.from_tree(repo.download())
    check(spec.size == N_ROBERTA and spec.dtype == "bfloat16",
          f"RoBERTa-base body is {spec.size} {spec.dtype}, expected {N_ROBERTA} bfloat16")
    svc = ColdService(repo, policy=AdmissionPolicy(min_cohort=4, novelty_threshold=NOVELTY))
    print(f"[service] root with base_iter0000.npz and the base sketch: "
          f"{time.perf_counter() - t0:.1f} s")
    suite = SyntheticSuite(vocab_size=CONFIG.vocab_size, num_tasks=16, seed=0)
    contribs = []
    for tid in range(8, 12):
        d = suite.dataset(tid, 128, 32, seq)
        contribs.append(Contributor(CONFIG, tid, suite.tasks[tid].num_classes, d["x_train"],
                                    d["y_train"], steps=3, batch_size=batch, seed=tid))
    clients = [ContributorClient(root, f"c{i}") for i in range(4)]
    sizes = {"dense": [], "compressed": []}
    submit_s = {"dense": [], "compressed": []}
    # per round: seconds of finetune, of submit and of serving the queue
    split = {"finetune": [], "submit": [], "serve": []}

    def submit(i, body, base, it, *, compress=False, sketch=None):
        t = time.perf_counter()
        sid = clients[i].submit(body, base_iteration=it, compress=compress,
                                base=base if compress else None, sketch=sketch)
        kind = "compressed" if compress else "dense"
        submit_s[kind].append(time.perf_counter() - t)
        path = os.path.join(root, "queue", sid + ".npz")
        sizes[kind].append(os.path.getsize(path))
        return path

    def finetune():
        t_ft = time.perf_counter()
        base = repo.download()
        bodies = [c.contribute(base) for c in contribs]
        torch.cuda.synchronize()
        split["finetune"].append(time.perf_counter() - t_ft)
        return base, bodies

    def serve(target):
        split["submit"].append(sum(submit_s["dense"]) + sum(submit_s["compressed"])
                               - sum(split["submit"]))
        t_sv = time.perf_counter()
        st = serve_until(svc, lambda st: st["iteration"] >= target)
        split["serve"].append(time.perf_counter() - t_sv)
        return st

    # round 1: 2 dense (one unsketched), 2 compressed and a replay
    t = time.perf_counter()
    base, bodies = finetune()
    b0 = spec.flatten(base)
    paths = [submit(0, bodies[0], base, 0), submit(1, bodies[1], base, 0, sketch=False),
             submit(2, bodies[2], base, 0, compress=True),
             submit(3, bodies[3], base, 0, compress=True)]
    copy_into_queue(paths[2], "replay-000000.npz")
    host_b0 = b0.cpu()
    expect_rows = [spec.flatten(bodies[i]).float() for i in (0, 1)]
    t_dec = time.perf_counter()
    for p in paths[2:]:
        (payload,), _ = ckpt.load_flat_delta(p)
        expect_rows.append(torch.from_numpy(delta_decode(payload, host_b0)).cuda())
    decode_s = time.perf_counter() - t_dec
    st = serve(1)
    round_s = [time.perf_counter() - t]
    rec = repo.history[-1]
    check((rec.n_accepted, rec.n_contributions) == (4, 4),
          f"round 1 fused {rec.n_accepted}/{rec.n_contributions}, expected 4/4")
    rej = st["recent_rejects"]
    check([r["file"] for r in rej] == ["replay-000000.npz"]
          and rej[0]["reason"].startswith("near-duplicate of c2-000000"),
          f"round 1 must reject exactly the replay as a near-duplicate: {rej}")
    want, _ = cold_fuse_plain(b0.float(), torch.stack(expect_rows),
                              torch.ones(4, device="cuda"))
    err = fused_error(spec.flatten(repo.download()), want.to(torch.bfloat16))
    print(f"[service] round 1: fused {rec.n_accepted}/{rec.n_contributions} (2 dense, 2 "
          f"compressed), replay rejected ({rej[0]['reason']}); published base vs "
          f"cold_fuse_plain over the dense and host-decoded rows: max|d| {err:.3g} "
          f"(bound 1 bf16 ulp); nearest novelty distance between the 4 admitted "
          f"{nearest_pair(repo, 0, 4):.4f} (threshold {NOVELTY}); {round_s[-1]:.1f} s")
    del expect_rows, want

    # round 2: an all-dense cohort
    t = time.perf_counter()
    base, bodies = finetune()
    for i in range(4):
        submit(i, bodies[i], base, 1)
    serve(2)
    round_s.append(time.perf_counter() - t)
    rec = repo.history[-1]
    check((rec.n_accepted, rec.n_contributions) == (4, 4),
          f"round 2 fused {rec.n_accepted}/{rec.n_contributions}, expected 4/4")
    print(f"[service] round 2: all-dense cohort fused {rec.n_accepted}/{rec.n_contributions}; "
          f"nearest novelty distance {nearest_pair(repo, 1, 4):.4f}; {round_s[-1]:.1f} s")

    # round 3: 3 honest compressed and a runaway compressed submission
    t = time.perf_counter()
    base, bodies = finetune()
    noise = torch.Generator(device="cuda").manual_seed(1)
    runaway = tree_map(lambda x: x + (100.0 * torch.randn(
        x.shape, generator=noise, device=x.device)).to(x.dtype), base)
    for i in range(3):
        submit(i, bodies[i], base, 2, compress=True)
    submit(3, runaway, base, 2, compress=True)
    serve(3)
    round_s.append(time.perf_counter() - t)
    rec = repo.history[-1]
    check((rec.n_accepted, rec.n_contributions) == (3, 4),
          f"round 3 fused {rec.n_accepted}/{rec.n_contributions}, expected 3/4")
    print(f"[service] round 3: adversarial compressed cohort fused "
          f"{rec.n_accepted}/{rec.n_contributions} (diff norms "
          f"{[f'{n:.4g}' for n in rec.diff_norms]}); {round_s[-1]:.1f} s")

    svc.close()
    row = spec.flatten(repo.download())
    check(row.dtype == torch.bfloat16 and bool(torch.isfinite(row).all()),
          "published base is not finite bf16")
    mean = {k: sum(v) / len(v) for k, v in sizes.items()}
    print(f"[service] queue bytes per submission: dense {mean['dense'] / 1e6:.1f} MB, "
          f"compressed {mean['compressed'] / 1e6:.1f} MB ({mean['dense'] / mean['compressed']:.1f}x "
          "smaller)")
    print(f"[service] submit seconds (flatten, copy to host, sketch, encode, npz write): "
          f"dense {[round(x, 2) for x in submit_s['dense']]}, compressed "
          f"{[round(x, 2) for x in submit_s['compressed']]}")
    t_enc = time.perf_counter()
    delta_encode(spec.flatten(bodies[0]).cpu(), spec.flatten(base).cpu(),
                 k_per_block=CODEC_KB, block=CODEC_BLOCK)
    print(f"[service] host delta_encode of one body: {time.perf_counter() - t_enc:.2f} s; "
          f"host delta_decode of two payloads: {decode_s:.2f} s")
    print(f"[service] wall time per round (finetune + submit + serve): "
          f"{[round(x, 1) for x in round_s]} s; published base iteration {repo.iteration}, "
          "all finite")
    print(f"[service] per round, finetune {[round(x, 2) for x in split['finetune']]} s, "
          f"submit {[round(x, 2) for x in split['submit']]} s, serve (admit, stage, fuse, "
          f"publish) {[round(x, 2) for x in split['serve']]} s")
    return split


# ---------------------------------------------------------------------------
# the Repository lifecycle behind the regression gate
# ---------------------------------------------------------------------------


def gated_service(repo, size):
    """The lifecycle's daemon: min cohort 4, the novelty screen, compaction
    to two bases and the gate with the reference's probe defaults."""
    gate = RegressionGate(ProbeSuite(size, n_tasks=4, n_examples=32, seed=0))
    return ColdService(repo, gate=gate, policy=AdmissionPolicy(
        min_cohort=4, novelty_threshold=NOVELTY, compact_keep_bases=2))


def lifecycle_files(root):
    """(base files, archived rows no manifest entry names, queue npz,
    quarantine npz) of a root."""
    named = {e["file"] for e in ckpt.load_json(
        os.path.join(root, "staging_manifest.json"))["entries"]}
    names = os.listdir(root)
    npz = lambda d: sorted(f for f in os.listdir(os.path.join(root, d)) if f.endswith(".npz"))
    return (sorted(f for f in names if re.match(r"^base_iter\d{4,}\.npz$", f)),
            sorted(f for f in names if re.match(r"^iter\d{4,}_contrib\d{3,}\.npz$", f)
                   and f not in named),
            npz("queue"), npz("quarantine") if os.path.isdir(os.path.join(root, "quarantine"))
            else [])


def rejection(fn):
    """The text of the RuntimeError ``fn()`` raises, or None if it returns."""
    try:
        fn()
    except RuntimeError as err:
        return str(err)
    return None


def small_lifecycle(device, root, body, noise):
    """The lifecycle phase's three gated rounds and async merge on a TINY
    f32 body on ``device``.  Each submission is the submitting root's
    current base plus a noise row from ``noise``, so the two devices see
    the same contributions relative to their own bases."""
    spec = FlatSpec.from_tree(body)
    repo = Repository(tree_map(lambda x: x.to(device), body), root=root, spill=True,
                      spill_workers=2)
    seen = []
    repo.add_publish_listener(lambda it, tree, flat: seen.append((it, flat is not None)))
    svc = gated_service(repo, spec.size)

    def submit(i, name, scale, it, compress=False):
        b = repo.flat_base_host()
        ContributorClient(root, name).submit(row=b + scale * noise[i], spec=spec,
                                             base_iteration=it, compress=compress, base=b)

    counters = lambda st: tuple(st[k] for k in (
        "iteration", "fused_queue_submissions", "rejected_total", "novelty_rejected_total",
        "quarantined_total", "rollbacks_total")) + (st["last_gate"]["ok"],)
    out = {"status": [], "rows": []}
    for i in range(4):
        submit(i, f"h{i}", 0.01, 0)
    out["status"].append(counters(serve_until(svc, lambda st: st["iteration"] == 1, 120)))
    out["rows"].append(repo.flat_base_host())
    for i in range(4):
        submit(4 + i, f"bad{i}", HARM_SCALES[i], 1)
    out["status"].append(counters(serve_until(svc, lambda st: st["rollbacks_total"] >= 1, 120)))
    out["rows"].append(repo.flat_base_host())
    for i in range(4):
        submit(8 + i, f"g{i}", 0.01, 1, compress=i >= 2)
    out["status"].append(counters(serve_until(svc, lambda st: st["iteration"] == 2, 120)))
    out["rows"].append(repo.flat_base_host())
    svc.close()
    rec = repo.contribute_async(spec.unflatten((out["rows"][-1] + 0.01 * noise[12]).to(device)))
    out["rows"].append(repo.flat_base_host())
    bad = out["rows"][-1] + 0.01 * noise[13]
    bad[0] = float("nan")
    reason = rejection(lambda: repo.contribute_async(spec.unflatten(bad.to(device))))
    out["nan_rejected"] = (reason is not None and reason.startswith("async contribution rejected")
                           and torch.equal(repo.flat_base_host(), out["rows"][-1]))
    out.update(seen=seen, op=rec.op, files=lifecycle_files(root),
               history=[(r.n_accepted, r.n_contributions) for r in repo.history])
    return out


def phase_small_lifecycle(workdir):
    """The lifecycle's rounds on a TINY f32 body, on the CPU and on the card:
    the same decisions, counters, listener calls, files and rows."""
    gen = torch.Generator().manual_seed(5)
    body = init_encoder_body(TINY, gen, device="cpu")
    n = FlatSpec.from_tree(body).size
    noise = [torch.randn(n, generator=gen) for _ in range(14)]
    cpu, card = (small_lifecycle(dev, os.path.join(workdir, f"small-life-{dev}"), body, noise)
                 for dev in ("cpu", "cuda"))
    for key in ("status", "seen", "op", "files", "history", "nan_rejected"):
        check(cpu[key] == card[key], f"small lifecycle {key}: CPU {cpu[key]}, card {card[key]}")
    want_status = [(1, 4, 0, 0, 0, 0, True), (1, 4, 0, 0, 4, 1, False),
                   (2, 8, 0, 0, 4, 1, True)]
    check(card["status"] == want_status, f"small lifecycle counters {card['status']}, "
          f"expected {want_status}")
    check(card["seen"] == [(1, True), (2, True), (1, True), (2, True), (3, True)],
          f"small lifecycle listener calls {card['seen']}")
    check(card["files"] == (["base_iter0001.npz", "base_iter0002.npz", "base_iter0003.npz"], [],
                            [], [f"bad{i}-000000.npz" for i in range(4)]),
          f"small lifecycle files {card['files']}")
    check(card["nan_rejected"], "small lifecycle: a NaN async contribution must be rejected "
          "with the row unchanged")
    for dev in (cpu, card):
        check(torch.equal(dev["rows"][1], dev["rows"][0]), "small lifecycle: the rolled-back row "
              "differs from round 1's")
    d = max((a - b).abs().max().item() for a, b in zip(cpu["rows"], card["rows"]))
    check(d <= 1e-5, f"small lifecycle: card and CPU rows differ by {d:.3g} > 1e-5")
    print(f"[small] TINY f32 gated lifecycle (spill_workers 2, compaction to 2 bases): rounds "
          f"{card['status']} (iteration, fused, rejected, near-duplicates, quarantined, "
          f"rollbacks, gate ok) on both; the rollback restores round 1's row bit for bit; "
          f"listener {[it for it, _ in card['seen']]}; {card['op']}, NaN merge rejected; card vs "
          f"CPU rows max|d| {d:.3g} (bound 1e-5)")


@contextlib.contextmanager
def compaction_log(root):
    """Record (ms, bytes of the files it deleted, counts) of every
    ``Repository.compact`` call; the ms include its flush, which waits on
    the executor's publish write."""
    fn, log = Repository.compact, []

    def sizes():
        return {f: os.path.getsize(os.path.join(root, f)) for f in os.listdir(root)
                if ".tmp-" not in f and os.path.isfile(os.path.join(root, f))}

    def wrapper(self, **kw):
        before, t = sizes(), time.perf_counter()
        out = fn(self, **kw)
        ms, after = 1e3 * (time.perf_counter() - t), sizes()
        log.append((ms, sum(n for f, n in before.items() if f not in after), out))
        return out

    Repository.compact = wrapper
    try:
        yield log
    finally:
        Repository.compact = fn


def median_s(fn, n: int = 20) -> float:
    """Median seconds of ``n`` calls of ``fn`` (host clock; ``fn`` ends in
    a device-to-host read, so it is synchronised)."""
    times = []
    for _ in range(n):
        t = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t)
    return float(np.median(times))


def phase_lifecycle(workdir, card, service_split):
    """The Repository lifecycle behind the regression gate at RoBERTa-base
    width: a gated, compacting daemon over spill_workers=2 takes an honest
    cohort, a harmful one (quarantined, rolled back), an honest mixed
    cohort on the rolled-back base, then contribute_async."""
    seq, batch = 128, 32
    root = os.path.join(workdir, "lifecycle")
    gen = torch.Generator(device="cuda").manual_seed(0)
    repo = Repository(init_encoder_body(CONFIG, gen, device="cuda"), root=root, spill=True,
                      spill_workers=2)
    spec = FlatSpec.from_tree(repo.download())
    check(spec.size == N_ROBERTA and spec.dtype == "bfloat16",
          f"RoBERTa-base body is {spec.size} {spec.dtype}, expected {N_ROBERTA} bfloat16")
    seen = []

    def listen(it, tree, flat):
        rec = repo.history[-1] if repo.history else None
        seen.append((it, flat is not None,
                     None if rec is None else (rec.n_accepted, rec.n_contributions)))

    repo.add_publish_listener(listen)
    svc = gated_service(repo, spec.size)
    suite = SyntheticSuite(vocab_size=CONFIG.vocab_size, num_tasks=16, seed=0)
    contribs = []
    for tid in range(8, 12):
        d = suite.dataset(tid, 128, 32, seq)
        contribs.append(Contributor(CONFIG, tid, suite.tasks[tid].num_classes, d["x_train"],
                                    d["y_train"], steps=3, batch_size=batch, seed=tid))
    split = {"finetune": [], "submit": [], "serve": []}

    def finetune():
        t = time.perf_counter()
        base = repo.download()
        bodies = [c.contribute(base) for c in contribs]
        torch.cuda.synchronize()
        split["finetune"].append(time.perf_counter() - t)
        return base, bodies

    def submit_all(items):
        t = time.perf_counter()
        for name, kw in items:
            ContributorClient(root, name).submit(**kw)
        split["submit"].append(time.perf_counter() - t)

    def serve(done):
        t = time.perf_counter()
        st = serve_until(svc, done)
        split["serve"].append(time.perf_counter() - t)
        return st

    # round 1: four honest dense submissions
    base, bodies = finetune()
    submit_all([(f"c{i}", dict(params=bodies[i], base_iteration=0)) for i in range(4)])
    with compaction_log(root) as compacts:
        st = serve(lambda st: st["iteration"] == 1)
    check(seen[-1][2] == (4, 4), f"round 1 fused {seen[-1][2]}, expected (4, 4)")
    check(st["last_gate"]["ok"], f"round 1: the gate must pass: {st['last_gate']}")
    check(ckpt.load_json(os.path.join(root, "gate_state.json"))["iteration"] == 1,
          "round 1: gate_state.json must name iteration 1")
    row1 = repo.flat_base_host()
    print(f"[lifecycle] round 1: fused 4/4 dense, gate ok (probe losses "
          f"{ {k: round(v, 4) for k, v in st['last_gate']['scores'].items()} }, worst delta "
          f"{st['last_gate']['worst_delta']:.4g}); gate_state.json at iteration 1")
    probe = svc.gate.probes
    t_dev = median_s(lambda: probe.score(repo.flat_base()))
    t_host = median_s(lambda: probe.score(row1))
    t_copy = median_s(repo.flat_base_host, 5)
    check(probe.score(repo.flat_base()) == probe.score(row1),
          "ProbeSuite scores differ between the device row and its host copy")
    print(f"[time] ProbeSuite.score (4 tasks x 32 examples, N={N_ROBERTA:,} bf16) on {card}: "
          f"{1e3 * t_dev:.3f} ms from the device row (gather on the card), {1e3 * t_host:.3f} "
          f"ms from the host copy; the host copy itself (flat_base_host, "
          f"{2 * N_ROBERTA / 1e6:.1f} MB) {1e3 * t_copy:.1f} ms (medians)")

    # round 2: a harmful cohort the §9 screen admits
    b1 = repo.flat_base()
    harmful = []
    for i in range(4):
        g = torch.Generator(device="cuda").manual_seed(100 + i)
        harmful.append((b1.float() + HARM_SCALES[i] * torch.randn(
            N_ROBERTA, generator=g, device="cuda")).to(torch.bfloat16))
    submit_all([(f"bad{i}", dict(row=harmful[i], spec=spec, base_iteration=1))
                for i in range(4)])
    del harmful
    rejected0 = st["rejected_total"]
    with compaction_log(root) as more, timed(ckpt, "load") as load_s, \
            timed(Repository, "_persist_base") as persist_s, \
            timed(Repository, "_refresh_base_sketch") as sketch_s, \
            timed(Repository, "rollback") as rollback_s:
        st = serve(lambda st: st["rollbacks_total"] >= 1)
    compacts += more
    check(seen[-2][:2] == (2, True) and seen[-2][2] == (4, 4),
          f"round 2 must publish 4/4 before the gate: listener {seen}")
    check(st["rejected_total"] == rejected0, f"round 2: the screens rejected "
          f"{st['rejected_total'] - rejected0}, expected 0")
    check(not st["last_gate"]["ok"], f"round 2: the gate must trip: {st['last_gate']}")
    files = lifecycle_files(root)
    check((st["quarantined_total"], st["rollbacks_total"]) == (4, 1),
          f"round 2: quarantined {st['quarantined_total']}, rollbacks {st['rollbacks_total']}")
    check(files[2] == [] and files[3] == [f"bad{i}-000000.npz" for i in range(4)],
          f"round 2: queue {files[2]}, quarantine {files[3]}")
    check(repo.iteration == 1 and torch.equal(repo.flat_base_host(), row1),
          "round 2: the rollback must restore round 1's row bit for bit")
    check(ckpt.load_json(os.path.join(root, "gate_state.json"))["iteration"] == 1,
          "round 2: gate_state.json must stay at iteration 1")
    print(f"[lifecycle] round 2: harmful cohort (base + N(0, s^2), s = "
          f"{[round(x, 1) for x in HARM_SCALES]}) admitted 4/4 by the MAD and novelty screens "
          f"(nearest novelty distance {nearest_pair(repo, 1, 4):.4f}), fused 4/4; gate tripped "
          f"(regressed "
          f"{st['last_gate']['regressed']}, worst delta {st['last_gate']['worst_delta']:.4g}, "
          f"tolerance 0.5); quarantined 4, rolled back to iteration 1, row equal to round 1's "
          f"bit for bit; gate_state.json still at iteration 1")
    print(f"[time] rollback on {card}: {rollback_s[0]:.3f} s in all (flush, base_iter0001.npz "
          f"load {sum(load_s):.3f} s, persist {persist_s[-1]:.3f} s, base sketch "
          f"{sketch_s[-1]:.4f} s)")

    # round 3: 2 dense and 2 compressed on the rolled-back base
    decode0 = decode_accum.launches
    base, bodies = finetune()
    submit_all([(f"c{i}", dict(params=bodies[i], base_iteration=1, compress=i >= 2, base=base))
                for i in range(4)])
    with compaction_log(root) as more:
        st = serve(lambda st: st["iteration"] == 2)
    compacts += more
    check(seen[-1][:2] == (2, True) and seen[-1][2] == (4, 4), f"round 3 fused {seen[-1]}")
    check(decode_accum.launches > decode0, "round 3: decode_accum was not launched")
    check(st["last_gate"]["ok"], f"round 3: the gate must pass: {st['last_gate']}")
    files = lifecycle_files(root)
    check(files[0] == ["base_iter0001.npz", "base_iter0002.npz"] and files[1] == [],
          f"round 3: bases {files[0]}, unnamed archived rows {files[1]}")
    print(f"[lifecycle] round 3: fused 4/4 (2 dense, 2 compressed against iteration 1, "
          f"decode_accum {decode_accum.launches - decode0} launch), gate ok; compacted to "
          f"{files[0]}")
    print(f"[time] compact on {card} (with its flush): " + ", ".join(
        f"{ms:.2f} ms removing {removed / 1e6:.1f} MB ({out['bases_removed']} bases, "
        f"{out['rows_removed']} rows)" for ms, removed, out in compacts))
    svc.close()

    # contribute_async: one honest body at alpha 1/3, then a runaway
    base = repo.download()
    body = contribs[0].contribute(base)
    b_row, c_row = spec.flatten(base), spec.flatten(body)
    plain, _ = cold_fuse_plain(b_row, c_row[None], torch.ones(1, device="cuda"), 1.0 / 3.0)
    # the kernel rounds b + a*(t - b) once (an FMA), the plain version twice;
    # where the result cancels to near 0 (t = -2b at a = 1/3) the two differ
    # by an f32 rounding of the operands, which can exceed 1 bf16 ulp of the
    # result.  The exact value: the same formula in f64 at the f32 alpha the
    # kernel receives, rounded once to f32 and then to bf16
    a32 = float(np.float32(1.0 / 3.0))
    exact = (b_row.double() + a32 * (c_row.double() - b_row.double())).float().to(b_row.dtype)
    t = time.perf_counter()
    rec = repo.contribute_async(body)
    async_s = time.perf_counter() - t
    check(rec.op == "async-damped(0.333)" and repo.iteration == 3, f"async record {rec}")
    err = fused_error(repo.flat_base(), exact)
    got, pf = repo.flat_base().float(), plain.float()
    d = (got - pf).abs()
    beyond = d > bf16_ulp(torch.maximum(got.abs(), pf.abs()))
    operands = torch.maximum(b_row.float().abs(), (a32 * (c_row.float() - b_row.float())).abs())
    check(bool((d[beyond] <= f32_ulp(operands[beyond])).all()), "contribute_async differs from "
          "cold_fuse_plain by more than 1 bf16 ulp and the f32 rounding of the operands")
    n_beyond = int(beyond.sum())
    row3 = repo.flat_base_host()
    noise = torch.Generator(device="cuda").manual_seed(1)
    run_row = (b_row.float() + 100.0 * torch.randn(N_ROBERTA, generator=noise,
                                                   device="cuda")).to(torch.bfloat16)
    norm = (run_row.float() - repo.flat_base().float()).norm().item()
    one = screen_norms([norm])
    run_row[0] = float("nan")  # a runaway that diverged
    reason = rejection(lambda: repo.contribute_async(spec.unflatten(run_row)))
    check(reason is not None and reason.startswith("async contribution rejected")
          and repo.iteration == 3
          and torch.equal(repo.flat_base_host(), row3),
          f"the runaway must be rejected with state unchanged: {reason}")
    print(f"[lifecycle] contribute_async (alpha 1/3, {rec.op}) over the same [1, N] stage: vs "
          f"the exactly rounded value max|d| {err:.3g} (bound 1 bf16 ulp); vs cold_fuse_plain "
          f"max|d| {d.max().item():.3g}, {n_beyond} elements beyond 1 bf16 ulp, where the result "
          f"cancels (largest such |result| {got[beyond].abs().max().item() if n_beyond else 0:.3g}), "
          f"each within 1 f32 ulp of the operands; {async_s:.3f} s. The phase-7 "
          f"runaway (norm {norm:.4g}) passes a one-norm screen (accepted {one.accepted}: the MAD "
          f"test needs 3 norms); with one NaN it is rejected ({reason}), iteration and row "
          "unchanged")
    check([s[:2] for s in seen] == [(1, True), (2, True), (1, True), (2, True), (3, True)],
          f"listener calls {seen}")

    # the gate a user would run on real tasks
    held_out = []
    for tid in range(8, 12):
        d = suite.dataset(tid, 1, 32, seq, split_seed=2)
        held_out.append((tid, d["x_test"], d["y_test"], suite.tasks[tid].num_classes))
    evals = MultitaskEvals(CONFIG, repo.download(), held_out, seed=0)
    scores = evals.score(repo.flat_base())
    check(all(math.isfinite(v) for v in scores.values()), f"MultitaskEvals scores {scores}")
    t_ev = median_s(lambda: evals.score(repo.flat_base()), 5)
    print(f"[time] MultitaskEvals.score (4 tasks x 32 x {seq} tokens, RoBERTa-base bf16 "
          f"forward) on {card}: {1e3 * t_ev:.1f} ms (median of 5); losses "
          f"{ {k: round(v, 4) for k, v in scores.items()} }")
    print(f"[lifecycle] finetune (rounds 1, 3) {[round(x, 2) for x in split['finetune']]} s, "
          f"submit (rounds 1-3) {[round(x, 2) for x in split['submit']]} s, serve (admit, stage, "
          f"fuse, probe, publish, compact; round 2 with the rollback) "
          f"{[round(x, 2) for x in split['serve']]} s")
    print(f"[lifecycle] serve of an all-dense cohort of 4 on {card}: round 1 here "
          f"(spill_workers 2, gated, compacting) {split['serve'][0]:.2f} s; phase 7's round 2 "
          f"(synchronous writes, no gate) {service_split['serve'][1]:.2f} s (two runs in one "
          "process on a host whose speed moves 20-30 %)")


# ---------------------------------------------------------------------------
# slice 6: similarity routing over a base family (phase 10)
# ---------------------------------------------------------------------------


def task_pattern(t: int, n: int) -> torch.Tensor:
    """``tests/test_routing.py``'s task direction at full width, on the card:
    constant per 1024-element tile, -1 where (tile + t) is odd.  32 buckets
    is even, so each bucket sees one sign and two tasks' projections are
    exact opposites."""
    tiles = -(-n // LANE)
    sign = 1.0 - 2.0 * ((torch.arange(tiles, device="cuda") + t) % 2).float()
    return sign.repeat_interleave(LANE)[:n]


def sparse_pattern(t: int, n: int) -> torch.Tensor:
    """The same direction as the codec keeps it whole: the first ``CODEC_KB``
    of every ``CODEC_BLOCK`` elements at ``CODEC_BLOCK / CODEC_KB`` times the
    size, zero elsewhere, so its tile sums (the sketch's projections) equal
    the dense pattern's."""
    keep = (torch.arange(n, device="cuda") % CODEC_BLOCK) < CODEC_KB
    return torch.where(keep, task_pattern(t, n) * (CODEC_BLOCK // CODEC_KB), 0.0)


def hold_fuse(got, base, rows, alpha, what, chunk=1 << 26):
    """``got`` (bf16) against ``base + alpha * (mean(rows) - base)`` (unit
    weights), chunk by chunk so a 1 G-element row fits beside the model
    (phase 8's rule): within 1 bf16 ulp of the exactly rounded value and of
    ``cold_fuse_plain``'s, except where the result cancels, and there within
    1 f32 ulp of the operands, the largest |x| of the base and the rows.  The
    kernel sums ``w_k / sum(w) * x_k`` in f32, so where the rows sum to
    (nearly) zero its result carries the rounding of those products, as the
    plain version's does (ROADMAP C.14).  Returns max|d| against the exact
    and the plain value, and the counts beyond 1 bf16 ulp of the plain and
    the exact value."""
    a32 = float(np.float32(alpha))
    ones = torch.ones(len(rows), device=base.device)
    worst, beyond = {"exact": 0.0, "plain": 0.0}, {"exact": 0, "plain": 0}
    for s in range(0, got.numel(), chunk):
        g, b = got[s:s + chunk].float(), base[s:s + chunk]
        rs = [r[s:s + chunk] for r in rows]
        bd = b.double()
        mean = sum(r.double() for r in rs) / len(rs)
        want = {"exact": (bd + a32 * (mean - bd)).float().to(got.dtype).float(),
                "plain": cold_fuse_plain(b.float(), torch.stack([r.float() for r in rs]), ones,
                                         alpha)[0].to(got.dtype).float()}
        check(bool(torch.isfinite(g).all()), f"{what}: the fused row is not finite")
        ops = torch.stack([b.float().abs()] + [r.float().abs() for r in rs]).amax(0)
        for key, w in want.items():
            d = (g - w).abs()
            out = d > bf16_ulp(torch.maximum(g.abs(), w.abs()))
            check(bool((d[out] <= f32_ulp(ops[out])).all()),
                  f"{what}: differs from the {key} value by more than 1 bf16 ulp and 1 f32 ulp "
                  f"of the operands (max|d| {d.max().item():.3g})")
            worst[key] = max(worst[key], d.max().item())
            beyond[key] += int(out.sum())
    return worst["exact"], worst["plain"], beyond["plain"], beyond["exact"]


def delta_term(sk: CohortSketch, d, de) -> float:
    """The router's delta-to-delta distance (``FamilyRouter.route``)."""
    dn = FamilyRouter._delta_norm(d, sk.seg_elems)
    den = max(dn, FamilyRouter._delta_norm(de, sk.seg_elems), CohortSketch.EPS)
    return float(np.sqrt(np.sum((np.asarray(d) - np.asarray(de)) ** 2) / sk.seg_elems)) / den


class Timed:
    """Wraps a callable, recording the host seconds of each call (the card
    synchronised before the clock stops)."""

    def __init__(self, fn):
        self.fn, self.seconds = fn, []

    def __call__(self, *args, **kw):
        t = time.perf_counter()
        out = self.fn(*args, **kw)
        torch.cuda.synchronize()
        self.seconds.append(time.perf_counter() - t)
        return out


def phase_routing(workdir, card):
    """Similarity routing over a RepositoryFamily at RoBERTa-base width
    (phase 10): two task streams split into two members, a round at home
    with compressed rows, a stale cross-family row, one cross-fuse."""
    root = os.path.join(workdir, "routing")
    gen = torch.Generator(device="cuda").manual_seed(0)
    body = init_encoder_body(CONFIG, gen, device="cuda")
    t = time.perf_counter()
    fam = RepositoryFamily.create(body, root=root, spill=True)  # device defaults to cuda
    del body
    svc = ColdService(family=fam, policy=AdmissionPolicy(
        min_cohort=2, max_bases=3, split_threshold=ROUTE_SPLIT, cross_fuse_every=4,
        novelty_threshold=NOVELTY, compact_keep_bases=2))
    setup_s = time.perf_counter() - t
    main = fam.members["main"]
    spec = FlatSpec.from_tree(main.download())
    N = spec.size
    check(N == N_ROBERTA and spec.dtype == "bfloat16" and main.device.type == "cuda",
          f"family main is {N} {spec.dtype} on {main.device}")
    route_t = Timed(svc._router.route)
    svc._router.route = route_t
    spawn_t = Timed(fam.spawn)
    fam.spawn = spawn_t
    cross_t = Timed(fam.cross_fuse)
    fam.cross_fuse = cross_t
    pats = [task_pattern(t, N) for t in range(2)]
    clients = {(t, c): ContributorClient(root, f"t{t}c{c}") for t in range(2) for c in range(2)}
    split = {"submit": [], "serve": []}

    # round 0: both streams declare main at iteration 0
    b0 = main.flat_base()
    rows0, sid0 = {}, {}
    t = time.perf_counter()
    for (ti, c), cl in clients.items():
        rows0[(ti, c)] = (b0.float() + ROUTE_S * (c + 1) * pats[ti]).to(torch.bfloat16)
        sid0[(ti, c)] = cl.submit(row=rows0[(ti, c)], spec=spec, base_iteration=0,
                                  family="main")
    split["submit"].append(time.perf_counter() - t)
    t = time.perf_counter()
    st = serve_until(svc, lambda st: len(st["families"]) >= 2
                     and all(f["iteration"] >= 1 for f in st["families"].values()))
    split["serve"].append(time.perf_counter() - t)
    client = ContributorClient(root, "observer")
    home = {ti: client.route_of(sid0[(ti, 0)])["family"] for ti in range(2)}
    # a publish installs a fresh row, so these stay each member's iteration 1
    round0 = {n: m.flat_base() for n, m in fam.members.items()}

    # every member listens: its round-1 publish is the cross-fuse's input
    published = {}
    for name, m in fam.members.items():
        m.add_publish_listener(lambda it, tree, flat, name=name:
                               published.__setitem__((name, it), flat))

    # round 1: every contributor at its home, one row per stream compressed
    # (kept whole by the codec); a row of stream 1's direction encoded
    # against main and declaring main must be rejected stale
    rows1, decoded = {}, {}
    t = time.perf_counter()
    for (ti, c), cl in clients.items():
        h = cl.route_of(sid0[(ti, c)])["family"]
        cl.wait_for_family(h, 1, timeout=60)
        h_row = spec.flatten(cl.download_base(family=h))
        check(h_row.device.type == "cuda", f"download_base(family={h}) on {h_row.device}")
        step = ROUTE_S * (c + 1) * 2
        if c == 0:
            rows1[(ti, c)] = (h_row.float() + step * pats[ti]).to(torch.bfloat16)
            cl.submit(row=rows1[(ti, c)], spec=spec, base_iteration=1, family=h)
        else:
            row = (h_row.float() + step * sparse_pattern(ti, N)).to(torch.bfloat16)
            sid = cl.submit(row=row, spec=spec, base_iteration=1, family=h, compress=True,
                            base=h_row, k_per_block=CODEC_KB, codec_block=CODEC_BLOCK)
            (payload,), _ = ckpt.load_flat_delta(os.path.join(root, "queue", sid + ".npz"))
            decoded[ti] = torch.from_numpy(delta_decode(payload, h_row.cpu())).cuda()
            del row
    m_row = spec.flatten(client.download_base(family="main"))
    stray = 1 if home[0] == "main" else 0
    forged = (m_row.float() + 3 * ROUTE_S * sparse_pattern(stray, N)).to(torch.bfloat16)
    forger = ContributorClient(root, "forger").submit(
        row=forged, spec=spec, base_iteration=1, family="main", compress=True, base=m_row,
        k_per_block=CODEC_KB, codec_block=CODEC_BLOCK)
    del forged
    split["submit"].append(time.perf_counter() - t)
    t = time.perf_counter()
    st = serve_until(svc, lambda st: st["cross_fuses_total"] >= 1)
    split["serve"].append(time.perf_counter() - t)
    svc.close()

    # the router's evidence first, so that a wrong split names its cause
    for r in st["routes"]:
        d = "none" if r["distance"] is None else f"{r['distance']:.4f}"
        print(f"[route] {r['id']} -> {r['family']} (distance {d}, spawned {r['spawned']}): "
              f"{r['reason']}")
    for r in st["routes"]:
        own = r["id"].split("-")[0]
        ti = int(own[1])
        if r["spawned"]:
            check(r["distance"] >= 1.0, f"spawn route {r} scores below 1.0")
        elif r["distance"] is not None:
            check(r["distance"] < 0.6, f"same-stream route {r} scores 0.6 or more")
        check(r["family"] == home[ti], f"{r['id']} of stream {ti} routed to {r['family']}, "
              f"its stream's member is {home[ti]}")
    sks = {n: m.cohort_sketch for n, m in fam.members.items()}
    cross = []
    for n, sk in sks.items():
        for other, osk in sks.items():
            if other == n:
                continue
            for e in sk.entries:
                cross.append(min(delta_term(sk, e[3], oe[3]) for oe in osk.entries))
    check(min(cross) >= 1.0, f"a cross-stream delta distance is below 1.0: {sorted(cross)[:4]}")
    print(f"[routing] distances: same-stream routes "
          f"{[round(r['distance'], 4) for r in st['routes'] if r['distance'] is not None and not r['spawned']]} "
          f"(bound < 0.6), spawn {[round(r['distance'], 4) for r in st['routes'] if r['spawned']]} "
          f"(bound >= 1.0), every windowed delta against the other member's nearest "
          f"{min(cross):.4f}-{max(cross):.4f} (bound >= 1.0)")

    # the routing decisions and what each member published
    fams = st["families"]
    check(sorted(fams) == ["f1", "main"] and st["families_spawned_total"] == 1,
          f"expected exactly two members, got {sorted(fams)}")
    check(home[0] != home[1], f"both streams routed to {home[0]}")
    for n, m in fam.members.items():
        check(m.flat_base().device.type == "cuda", f"member {n} lives on {m.device}")
    errs = []
    for ti in range(2):
        h = home[ti]
        errs.append(hold_fuse(round0[h], b0, [rows0[(ti, 0)], rows0[(ti, 1)]], 1.0,
                              f"round 0 member {h}"))
    rej = [r for r in st["recent_rejects"] if r["file"] == forger + ".npz"]
    check(len(rej) == 1 and rej[0]["reason"].startswith(
        f"stale: delta encoded against family 'main' but routed to member '{home[stray]}'"),
        f"the cross-family compressed row must be rejected stale: {st['recent_rejects']}")
    check(st["rejected_total"] == 1, f"rejected {st['rejected_total']}, expected 1")
    pre = {}
    for ti in range(2):
        h = home[ti]
        pre[h] = published[(h, 2)]
        errs.append(hold_fuse(pre[h], round0[h], [rows1[(ti, 0)], decoded[ti]], 1.0,
                              f"round 1 member {h}"))
    check(st["cross_fuses_total"] == 1 and all(f["iteration"] == 3 for f in fams.values()),
          f"cross-fuse: {st['cross_fuses_total']} rounds, iterations "
          f"{ {n: f['iteration'] for n, f in fams.items()} }")
    events = [r for r in ckpt.read_jsonl(os.path.join(root, "metrics.jsonl"))
              if r["event"] in ("family_spawn", "cross_fuse")]
    check([e["event"] for e in events] == ["family_spawn", "cross_fuse"],
          f"metrics events {events}")
    for n, m in fam.members.items():
        errs.append(hold_fuse(m.flat_base(), pre[n], [pre[o] for o in pre if o != n], 0.5,
                              f"cross-fuse member {n}"))
        mean_err = fused_error(m.flat_base(), ((pre["main"].double() + pre["f1"].double()) / 2)
                               .float().to(torch.bfloat16))
        errs.append((mean_err, 0.0, 0, 0))
    print(f"[routing] round 0: 4 dense rows declared against main split into "
          f"{sorted(fams)} (stream 0 -> {home[0]}, stream 1 -> {home[1]}); each member's "
          f"base vs its own stream's fuse: max|d| {errs[0][0]:.3g} / {errs[1][0]:.3g} vs the "
          f"exactly rounded value, {errs[0][1]:.3g} / {errs[1][1]:.3g} vs cold_fuse_plain "
          f"(bound 1 bf16 ulp, +1 f32 ulp of the operands where the result cancels: "
          f"{errs[0][2]} / {errs[1][2]} elements)")
    print(f"[routing] round 1: each member fused 1 dense + 1 compressed row at home "
          f"(decode_accum), vs its fuse over the dense and host-decoded rows max|d| "
          f"{errs[2][0]:.3g} / {errs[3][0]:.3g}; the cross-family compressed row rejected: "
          f"{rej[0]['reason']}")
    print(f"[routing] cross-fuse after 4 member publishes, family quiescent: both members vs "
          f"the mean of the two pre-cross bases max|d| {errs[5][0]:.3g} / {errs[7][0]:.3g} "
          f"(bound 1 bf16 ulp); vs cold_fuse_plain at alpha 0.5 {errs[4][1]:.3g} / "
          f"{errs[6][1]:.3g}")
    print(f"[routing] status families: {json.dumps(fams)}")
    print(f"[routing] routes ring: {json.dumps(st['routes'])}")
    print(f"[time] routing on {card}: family create + service start {setup_s:.2f} s; route "
          f"decision per submission (FamilyRouter.route) "
          f"{[round(1e3 * x, 3) for x in route_t.seconds]} ms; spawn "
          f"{[round(x, 2) for x in spawn_t.seconds]} s; cross_fuse "
          f"{[round(x, 2) for x in cross_t.seconds]} s; per round, submit "
          f"{[round(x, 2) for x in split['submit']]} s (round 1 with 3 compressed rows), serve "
          f"(route, admit, stage, fuse, publish, compact; round 1 with the cross-fuse) "
          f"{[round(x, 2) for x in split['serve']]} s")
    del published, pre, round0, rows0, rows1, decoded, pats
    return b0, spec


def real_finetune_scores(b0, spec, card):
    """What the router makes of real finetunes at full width (printed, not
    asserted): 2 contributors x 2 synthetic tasks, 3 steps each from one
    base, as phase 7 makes them; each row scored against every other row's
    delta evidence, as ``FamilyRouter.route`` scores a rider against a
    member holding that one entry."""
    seq, batch = 128, 32
    suite = SyntheticSuite(vocab_size=CONFIG.vocab_size, num_tasks=16, seed=0)
    base = spec.unflatten(b0)
    rows = {}
    t = time.perf_counter()
    for tid in (8, 9):
        d = suite.dataset(tid, 128, 32, seq)
        for c in range(2):
            con = Contributor(CONFIG, tid, suite.tasks[tid].num_classes, d["x_train"],
                              d["y_train"], steps=3, batch_size=batch, seed=100 * tid + c)
            rows[(tid, c)] = spec.flatten(con.contribute(base))
    torch.cuda.synchronize()
    ft_s = time.perf_counter() - t
    sk_base = kops.row_sketch(b0).double().cpu().numpy()
    sketches = {k: kops.row_sketch(r).double().cpu().numpy() for k, r in rows.items()}
    router = FamilyRouter(split_threshold=ROUTE_SPLIT, max_bases=2)
    same, crossed = [], []
    lines = []
    for a in rows:
        for b in rows:
            if a == b:
                continue
            sk = CohortSketch(spec.size)
            sk.set_base(sk_base, iteration=0)
            sk.add("e", sketches[b], delta=sketches[b][0] - sk_base[0])
            dec = router.route(sketches[a], {"main": sk}, declared="main", base_iteration=0)
            score = dec.scores["main"]
            (same if a[0] == b[0] else crossed).append(score)
            lines.append(f"t{a[0]}c{a[1]} vs t{b[0]}c{b[1]} {score:.4f}")
    print(f"[routing] real finetunes (RoBERTa-base, 2 contributors x tasks 8 and 9, 3 steps "
          f"each from one base, {ft_s:.1f} s on {card}): router scores same-task "
          f"{[round(x, 4) for x in same]}, cross-task {[round(x, 4) for x in crossed]} against "
          f"split_threshold {ROUTE_SPLIT} (a score above it would split); "
          f"{'separated' if min(crossed) > ROUTE_SPLIT >= max(same) else 'NOT separated'} at "
          "this threshold (printed, not asserted)")
    print("[routing] real-finetune pairs: " + "; ".join(lines))


# ---------------------------------------------------------------------------
# slice 3: the serving path (flash_attention, rwkv6_scan)
# ---------------------------------------------------------------------------


def bf16_close(got, want, what):
    """max |got - want| (f32), checked elementwise against 1 bf16 ulp of
    the larger side plus 2e-5 x max(1, max |want|): both sides sum in f32
    in another order (the f32 bound, which matters where the sum cancels
    to a small value) and round once."""
    g, w = got.float(), want.float()
    check(bool(torch.isfinite(g).all()), f"{what}: kernel output is not finite")
    err = (g - w).abs()
    tol = bf16_ulp(torch.maximum(g.abs(), w.abs())) + 2e-5 * max(1.0, w.abs().max().item())
    ok = bool((err <= tol).all())
    check(ok, f"{what}: differs by more than 1 bf16 ulp + 2e-5 x max(1, max|plain|) "
          f"(max |d| {err.max().item():.3g})")
    return err.max().item()


def f32_close(got, want, what, rel=2e-5):
    """max |got - want|, checked against rel x max(1, max |want|): f32 sums
    in another order."""
    check(bool(torch.isfinite(got).all()), f"{what}: kernel output is not finite")
    err = (got.float() - want.float()).abs().max().item()
    scale = max(1.0, want.float().abs().max().item())
    check(err <= rel * scale, f"{what}: max |d| {err:.3g} > {rel} x {scale:.3g}")
    return err


def qkv_on_card(B, Sq, Sk, Hq, Hkv, hd, dtype, gen):
    dev = torch.device("cuda")
    return (torch.randn((B, Sq, Hq, hd), generator=gen, device=dev).to(dtype),
            torch.randn((B, Sk, Hkv, hd), generator=gen, device=dev).to(dtype),
            torch.randn((B, Sk, Hkv, hd), generator=gen, device=dev).to(dtype))


def flash_routed(want_route, q, k, v, **kw):
    """flash_attention on the card, checked to launch once through
    ``want_route`` (the route ``fa_mod.route`` names for these shapes)."""
    check(fa_mod.route(q.dtype, q.shape[1], q.shape[2], k.shape[2]) == want_route,
          f"flash: {tuple(q.shape)} {q.dtype} is not routed to {want_route}")
    before = dict(flash_attention.launches_by_route)
    out = flash_attention(q, k, v, **kw)
    after = flash_attention.launches_by_route
    check(after[want_route] == before[want_route] + 1
          and sum(after[r] for r in fa_mod.ROUTES) == sum(before[r] for r in fa_mod.ROUTES) + 1,
          f"flash: the call did not launch once through the {want_route} route")
    return out


def phase_flash_checks(gen):
    """flash_attention against flash_attention_plain on the card, each
    call through the route it must take.  Returns gemma3-1b's
    prefill-shaped bf16 inputs, stablelm-12b's (hd 160) in bf16 and f32 by
    dtype, and the largest error."""
    B, Sq, Sk, Hq, Hkv, hd = FLASH_PREFILL
    q, k, v = qkv_on_card(B, Sq, Sk, Hq, Hkv, hd, torch.bfloat16, gen)
    worst = 0.0
    for window in (GEMMA_WINDOW, None):
        e = bf16_close(flash_routed("prefill_tc", q, k, v, causal=True, window=window),
                       flash_attention_plain(q, k, v, causal=True, window=window),
                       f"flash prefill window={window}")
        worst = max(worst, e)
        print(f"[check] flash_attention vs plain, gemma3-1b prefill B={B} Sq={Sq} Sk={Sk} "
              f"Hq={Hq} Hkv={Hkv} hd={hd} bf16 window={window}, route prefill_tc: max|d| "
              f"{e:.3g} (bound 1 bf16 ulp + 2e-5 x max(1, max|o|))")
        qd = q[:, :1].contiguous()
        e = bf16_close(flash_routed("decode", qd, k, v, causal=True, window=window,
                                    q_offset=1100),
                       flash_attention_plain(qd, k, v, causal=True, window=window,
                                             q_offset=1100), f"flash decode window={window}")
        worst = max(worst, e)
        print(f"[check] flash_attention vs plain, decode Sq=1 q_offset=1100 Sk={Sk} bf16 "
              f"window={window}, route decode: max|d| {e:.3g} (bound 1 bf16 ulp + 2e-5 x "
              "max(1, max|o|))")
        qf, kf, vf = q[:, :1].float(), k.float(), v.float()
        e = f32_close(flash_routed("decode", qf, kf, vf, causal=True, window=window,
                                   q_offset=1100),
                      flash_attention_plain(qf, kf, vf, causal=True, window=window,
                                            q_offset=1100), f"flash f32 decode window={window}")
        print(f"[check] flash_attention vs plain, decode Sq=1 q_offset=1100 Sk={Sk} f32 "
              f"window={window}, route decode: max|d| {e:.3g} (bound 2e-5 x max(1, max|o|))")
    B, Sq, Sk, Hq, Hkv, hd = FLASH_HD160
    q16, k16, v16 = qkv_on_card(B, Sq, Sk, Hq, Hkv, hd, torch.bfloat16, gen)
    hd160 = {}
    for dtype, rt in ((torch.bfloat16, "prefill_tc"), (torch.float32, "prefill_fma")):
        qq, kk, vv = q16.to(dtype), k16.to(dtype), v16.to(dtype)
        close = bf16_close if dtype == torch.bfloat16 else f32_close
        bound = ("1 bf16 ulp + 2e-5 x max(1, max|o|)" if dtype == torch.bfloat16
                 else "2e-5 x max(1, max|o|)")
        e = close(flash_routed(rt, qq, kk, vv, causal=True),
                  flash_attention_plain(qq, kk, vv, causal=True), f"flash hd160 {rt}")
        worst = max(worst, e)
        print(f"[check] flash_attention vs plain, stablelm-12b prefill B={B} Sq={Sq} Sk={Sk} "
              f"Hq={Hq} Hkv={Hkv} hd={hd} {str(dtype)[6:]}, route {rt}: max|d| {e:.3g} "
              f"(bound {bound})")
        qd = qq[:, :1].contiguous()
        e = close(flash_routed("decode", qd, kk, vv, causal=True, q_offset=Sq),
                  flash_attention_plain(qd, kk, vv, causal=True, q_offset=Sq),
                  f"flash hd160 decode {dtype}")
        worst = max(worst, e)
        print(f"[check] flash_attention vs plain, stablelm-12b decode Sq=1 q_offset={Sq} "
              f"Sk={Sk} hd={hd} {str(dtype)[6:]}, route decode: max|d| {e:.3g} (bound {bound})")
        hd160[dtype] = (qq, kk, vv)
    B, Sq, Sk, Hq, Hkv, hd = FLASH_MOE
    qm, km, vm = qkv_on_card(B, Sq, Sk, Hq, Hkv, hd, torch.bfloat16, gen)
    bound = "1 bf16 ulp + 2e-5 x max(1, max|o|)"
    e = bf16_close(flash_routed("prefill_tc", qm, km, vm, causal=True),
                   flash_attention_plain(qm, km, vm, causal=True), "flash granite-moe prefill")
    worst = max(worst, e)
    print(f"[check] flash_attention vs plain, granite-moe prefill B={B} Sq={Sq} Sk={Sk} Hq={Hq} "
          f"Hkv={Hkv} hd={hd} bf16, route prefill_tc: max|d| {e:.3g} (bound {bound})")
    for off in (Sq, Sk - 1):
        qd = qm[:, :1].contiguous()
        e = bf16_close(flash_routed("decode", qd, km, vm, causal=True, q_offset=off),
                       flash_attention_plain(qd, km, vm, causal=True, q_offset=off),
                       f"flash granite-moe decode q_offset={off}")
        worst = max(worst, e)
        print(f"[check] flash_attention vs plain, granite-moe decode Sq=1 q_offset={off} "
              f"Sk={Sk} Hq={Hq} Hkv={Hkv} hd={hd} bf16, route decode: max|d| {e:.3g} "
              f"(bound {bound})")
    del qm, km, vm
    extra, e = phase_flash_checks_archs2(gen)
    worst = max(worst, e)
    for (b, sq, sk, hq, hkv, d, causal, window, off) in (
            (2, 96, 160, 4, 1, 256, True, 64, 0), (2, 77, 133, 8, 2, 64, True, None, 56),
            (2, 70, 111, 8, 2, 160, True, 33, 41),
            (3, 45, 45, 4, 4, 128, False, None, 0),
            (2, 70, 101, 4, 1, 128, True, 17, 31), (1, 33, 40, 4, 2, 32, True, 8, 7)):
        qs, ks, vs = qkv_on_card(b, sq, sk, hq, hkv, d, torch.float32, gen)
        e = f32_close(flash_routed("prefill_fma", qs, ks, vs, causal=causal, window=window,
                                   q_offset=off),
                      flash_attention_plain(qs, ks, vs, causal=causal, window=window,
                                            q_offset=off), f"flash f32 hd={d}")
        print(f"[check] flash_attention vs plain, f32 B={b} Sq={sq} Sk={sk} Hq={hq} Hkv={hkv} "
              f"hd={d} causal={causal} window={window} q_offset={off}, route prefill_fma: "
              f"max|d| {e:.3g} (bound 2e-5 x max(1, max|o|))")
        qb, kb, vb = qs.bfloat16(), ks.bfloat16(), vs.bfloat16()
        e = bf16_close(flash_routed("prefill_tc", qb, kb, vb, causal=causal, window=window,
                                    q_offset=off),
                       flash_attention_plain(qb, kb, vb, causal=causal, window=window,
                                             q_offset=off), f"flash bf16 hd={d}")
        print(f"[check] flash_attention vs plain, the same in bf16, route prefill_tc: max|d| "
              f"{e:.3g} (bound 1 bf16 ulp + 2e-5 x max(1, max|o|))")
    qs, ks, vs = qkv_on_card(1, 40, 64, 4, 1, 64, torch.float32, gen)
    for dtype, rt in ((torch.float32, "prefill_fma"), (torch.bfloat16, "prefill_tc")):
        qq, kk, vv = qs.to(dtype), ks.to(dtype), vs.to(dtype)
        got = flash_routed(rt, qq, kk, vv, causal=True, window=8, q_offset=66)
        want = flash_attention_plain(qq, kk, vv, causal=True, window=8, q_offset=66)
        (f32_close if dtype == torch.float32 else bf16_close)(got, want, "flash partly masked")
        check(bool((got[:, 6:] == 0).all()) and bool((got[:, :5] != 0).any()),
              "flash: rows that see no key must be 0, the others not")
    got = flash_routed("decode", qs[:, :1].bfloat16(), ks.bfloat16(), vs.bfloat16(),
                       causal=True, window=8, q_offset=100)
    check(bool((got == 0).all()), "flash decode: a row that sees no key must be 0")
    print("[check] flash_attention fully masked rows (q_offset 66, window 8, Sk 64: rows 6.. "
          "see no key): exactly 0 in f32 and bf16, rows 0..4 match the plain version; "
          "decode at q_offset 100: exactly 0")
    return (q, k, v), hd160, extra, worst


def phase_flash_checks_archs2(gen):
    """Phase 3 at phase 14's shapes: whisper-tiny's bidirectional encoder
    (Sq = Sk = 1500, hd 64, 6 heads on 6) and its cross-attention of the
    prompt and of one token against the 1500 frames on the decode route, in
    bf16 and f32; qwen2-vl's hd 128 on 64 query heads over 8 kv heads
    (prefill and decode); and the ring form of a sliding-window decode step
    (``causal=True, q_offset=min(i, W - 1)`` over a ring of W = 512 slots in
    write order) against the keys in position order, before and after the
    wrap.  Returns the inputs phase 4 times and the largest error."""
    out, worst = {}, 0.0
    bf_bound, f_bound = "1 bf16 ulp + 2e-5 x max(1, max|o|)", "2e-5 x max(1, max|o|)"
    B, Sq, Sk, Hq, Hkv, hd = FLASH_WHISPER
    qw, kw, vw = qkv_on_card(B, Sq, Sk, Hq, Hkv, hd, torch.bfloat16, gen)
    for dtype, rt in ((torch.bfloat16, "prefill_tc"), (torch.float32, "prefill_fma")):
        qq, kk, vv = qw.to(dtype), kw.to(dtype), vw.to(dtype)
        close, bound = ((bf16_close, bf_bound) if dtype == torch.bfloat16 else
                        (f32_close, f_bound))
        name = str(dtype)[6:]
        e = close(flash_routed(rt, qq, kk, vv, causal=False),
                  flash_attention_plain(qq, kk, vv, causal=False), f"flash whisper {rt}")
        worst = max(worst, e)
        print(f"[check] flash_attention vs plain, whisper-tiny encoder B={B} Sq={Sq} Sk={Sk} "
              f"Hq={Hq} Hkv={Hkv} hd={hd} {name} bidirectional, route {rt}: max|d| {e:.3g} "
              f"(bound {bound})")
        for sq in (WHISPER_PROMPT, 1):
            qd = qq[:, :sq].contiguous()
            e = close(flash_routed("decode", qd, kk, vv, causal=False),
                      flash_attention_plain(qd, kk, vv, causal=False),
                      f"flash whisper cross Sq={sq} {name}")
            worst = max(worst, e)
            print(f"[check] flash_attention vs plain, whisper-tiny cross-attention Sq={sq} "
                  f"Sk={Sk} {name} bidirectional, route decode: max|d| {e:.3g} (bound {bound})")
        if dtype == torch.bfloat16:
            out["whisper"] = (qq, kk, vv)
    B, Sq, Sk, Hq, Hkv, hd = FLASH_QWEN
    qq, kk, vv = qkv_on_card(B, Sq, Sk, Hq, Hkv, hd, torch.bfloat16, gen)
    e = bf16_close(flash_routed("prefill_tc", qq, kk, vv, causal=True),
                   flash_attention_plain(qq, kk, vv, causal=True), "flash qwen2-vl prefill")
    worst = max(worst, e)
    print(f"[check] flash_attention vs plain, qwen2-vl prefill B={B} Sq={Sq} Sk={Sk} Hq={Hq} "
          f"Hkv={Hkv} hd={hd} bf16, route prefill_tc: max|d| {e:.3g} (bound {bf_bound})")
    qd = qq[:, :1].contiguous()
    e = bf16_close(flash_routed("decode", qd, kk, vv, causal=True, q_offset=Sq),
                   flash_attention_plain(qd, kk, vv, causal=True, q_offset=Sq),
                   "flash qwen2-vl decode")
    worst = max(worst, e)
    print(f"[check] flash_attention vs plain, qwen2-vl decode Sq=1 q_offset={Sq} Sk={Sk} "
          f"Hq={Hq} Hkv={Hkv} hd={hd} bf16, route decode: max|d| {e:.3g} (bound {bf_bound})")
    out["qwen2-vl"] = (qq, kk, vv)
    B, _, _, Hq, Hkv, hd = FLASH_PREFILL
    W = GEMMA_WINDOW
    qr, kr, vr = qkv_on_card(B, 1, W, Hq, Hkv, hd, torch.bfloat16, gen)
    for i in (200, 700):
        # slot s holds position i - ((i - s) mod W); the slots of positions
        # max(0, i - W + 1)..i in position order
        order = torch.tensor([p % W for p in range(max(0, i - W + 1), i + 1)], device=qr.device)
        got = flash_routed("decode", qr, kr, vr, causal=True, q_offset=min(i, W - 1))
        want = flash_attention_plain(qr, kr[:, order].contiguous(), vr[:, order].contiguous(),
                                     causal=True, q_offset=len(order) - 1)
        e = bf16_close(got, want, f"flash ring i={i}")
        worst = max(worst, e)
        print(f"[check] flash_attention ring form, gemma3-1b local layer decode at position {i} "
              f"over a ring of {W} slots (q_offset {min(i, W - 1)}), against the plain version "
              f"over the {len(order)} visible keys in position order: max|d| {e:.3g} (bound "
              f"{bf_bound})")
    return out, worst


def visible_entries(Sq, Sk, causal, window, q_offset):
    """Score entries the masks leave visible, summed over the query rows."""
    qp = torch.arange(Sq, dtype=torch.int64) + q_offset
    hi = torch.clamp(qp + 1, max=Sk) if causal else torch.full_like(qp, Sk)
    lo = torch.clamp(qp - window + 1, min=0) if window is not None else torch.zeros_like(qp)
    return int(torch.clamp(hi - lo, min=0).sum())


def visible_keys(Sq, Sk, causal, window, q_offset):
    """Keys that some query row sees: the K and V rows a call must read."""
    lo = max(0, q_offset - window + 1) if window is not None else 0
    hi = min(Sk, q_offset + Sq) if causal else Sk
    return max(0, hi - lo)


def phase_flash_timing(inputs, hd160, archs2, card):
    """Kernel, plain version and SDPA at gemma3-1b's prefill shape (both
    layer kinds) and at decode, then at stablelm-12b's (hd 160) prefill and
    decode in bf16 and f32, then at whisper-tiny's bidirectional encoder and
    cross-attention (bf16) and qwen2-vl's hd 128 on 64:8 heads (prefill and
    decode).  Returns the global-layer prefill numbers and, per line, its
    route and numbers."""
    q, k, v = inputs
    cases = [("prefill global", q, k, v, None, 0, True),
             ("prefill local", q, k, v, GEMMA_WINDOW, 0, True),
             ("decode global", q[:, :1].contiguous(), k, v, None, 1100, True),
             ("decode local", q[:, :1].contiguous(), k, v, GEMMA_WINDOW, 1100, True)]
    for dtype, (q16, k16, v16) in hd160.items():
        name = str(dtype)[6:]
        cases += [(f"stablelm-12b prefill {name}", q16, k16, v16, None, 0, True),
                  (f"stablelm-12b decode {name}", q16[:, :1].contiguous(), k16, v16, None,
                   q16.shape[1], True)]
    qw, kw, vw = archs2["whisper"]
    qq, kq, vq = archs2["qwen2-vl"]
    cases += [("whisper-tiny encoder bidirectional", qw, kw, vw, None, 0, False),
              ("whisper-tiny cross-attention decode", qw[:, :1].contiguous(), kw, vw, None, 0,
               False),
              ("qwen2-vl prefill", qq, kq, vq, None, 0, True),
              ("qwen2-vl decode", qq[:, :1].contiguous(), kq, vq, None, qq.shape[1], True)]
    out, lines = None, []
    for label, qq, k, v, window, off, causal in cases:
        B, sq, Hq, hd = qq.shape
        Sk, Hkv = k.shape[1], k.shape[2]
        rt = fa_mod.route(qq.dtype, sq, Hq, Hkv)
        # q read and o written once; each visible K and V row read once
        nbytes = (2 * qq.numel() * qq.element_size()
                  + 2 * B * Hkv * hd * k.element_size() * visible_keys(sq, Sk, causal, window,
                                                                       off))
        flops = 4 * hd * B * Hq * visible_entries(sq, Sk, causal, window, off)
        peak = BF16_FLOPS if qq.dtype == torch.bfloat16 else F32_FLOPS
        bound, bound_by = bound_of(nbytes, flops, peak)
        iters = 20 if sq > 1 else 200
        ms, runs = median_windows(lambda: flash_attention(qq, k, v, causal=causal, window=window,
                                                          q_offset=off), iters=iters)
        plain, plain_runs = median_windows(lambda: flash_attention_plain(
            qq, k, v, causal=causal, window=window, q_offset=off), iters=5, warmup=1)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (qq, k, v))
        qp = torch.arange(sq, device=qq.device)[:, None] + off
        kp = torch.arange(Sk, device=qq.device)[None, :]
        mask = kp <= qp
        if window is not None:
            mask &= kp > qp - window
        if not causal:  # every key visible: SDPA takes no mask (and may pick its flash kernel)
            mask = None
        lib, lib_runs = median_windows(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True), iters=iters)
        g_ms, g_runs = graph_windows(lambda: flash_attention(qq, k, v, causal=causal,
                                                             window=window, q_offset=off), iters)
        g_lib, g_lib_runs = graph_windows(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True), iters)
        mode = "" if causal else " bidirectional"
        print(f"[time] flash_attention {label} B={B} Sq={sq} Sk={Sk} Hq={Hq} Hkv={Hkv} hd={hd} "
              f"{str(qq.dtype)[6:]}{mode} on {card}: route {rt} ({FLASH_SOURCE[rt]}.cu), kernel_ms "
              f"{ms:.4f} (windows {[round(r, 4) for r in runs]}), "
              f"bound_ms {bound:.4f} ({bound_by}: {nbytes / 1e6:.1f} MB at 3.35 TB/s, "
              f"{flops / 1e9:.2f} GFLOP at {peak / 1e12:.0f} TFLOP/s), kernel/bound "
              f"{ms / bound:.2f}x, "
              f"plain_ms {plain:.4f} (windows {[round(r, 3) for r in plain_runs]}), "
              f"library_ms {lib:.4f} (scaled_dot_product_attention, the same mask, windows "
              f"{[round(r, 4) for r in lib_runs]})")
        print(f"[time] flash_attention {label} replayed from a CUDA graph of {iters} calls "
              f"(device time, no host work per call): kernel {g_ms:.4f} ms (windows "
              f"{[round(r, 4) for r in g_runs]}), kernel/bound {g_ms / bound:.2f}x, "
              f"scaled_dot_product_attention {g_lib:.4f} ms (windows "
              f"{[round(r, 4) for r in g_lib_runs]})")
        lines.append({"label": label, "route": rt, "graph_ms": g_ms, "library_graph_ms": g_lib,
                      "source": f"src/repro_torch/kernels/csrc/{FLASH_SOURCE[rt]}.cu",
                      "ms": ms, "plain_ms": plain, "bound_ms": bound, "bound_by": bound_by,
                      "library_ms": lib})
        if out is None:
            out = (ms, plain, bound, bound_by, lib)
    return out, lines


def rwkv_on_card(B, T, H, hd, dtype, gen, lo=-20.0):
    """Random r, k, v, logw (in [lo, -0.0025], log-uniform magnitudes), u,
    s0 on the card."""
    dev = torch.device("cuda")
    r, k, v = (torch.randn((B, T, H, hd), generator=gen, device=dev).to(dtype)
               for _ in range(3))
    mag = torch.rand((B, T, H, hd), generator=gen, device=dev)
    logw = (-torch.exp(-6.0 + mag * (math.log(-lo) + 6.0))).to(dtype)
    u = 0.5 * torch.randn((H, hd), generator=gen, device=dev)
    s0 = 0.3 * torch.randn((B, H, hd, hd), generator=gen, device=dev)
    return r, k, v, logw, u, s0


def rwkv_routed(want_route, *args):
    """rwkv6_scan on the card, checked to launch once through ``want_route``
    (the route ``rs_mod.route`` names for this T)."""
    check(rs_mod.route(args[0].shape[1]) == want_route,
          f"rwkv: T={args[0].shape[1]} is not routed to {want_route}")
    before = dict(rwkv6_scan.launches_by_route)
    out = rwkv6_scan(*args)
    after = rwkv6_scan.launches_by_route
    check(after[want_route] == before[want_route] + 1
          and sum(after.values()) == sum(before.values()) + 1,
          f"rwkv: the call did not launch once through the {want_route} route")
    return out


def phase_rwkv_checks(gen):
    """rwkv6_scan against rwkv6_scan_plain on the card, each call through
    the route it must take.  Returns rwkv6-7b's prefill-shaped f32 inputs
    and the largest error there."""
    B, T, H, hd = RWKV_PREFILL
    args = rwkv_on_card(B, T, H, hd, torch.float32, gen)
    check(args[3].min().item() < -19.0, "the logw draw must reach -20")
    (y, s), (yp, sp) = rwkv_routed("scan", *args), rwkv6_scan_plain(*args)
    ey, es = f32_close(y, yp, "rwkv y"), f32_close(s, sp, "rwkv state")
    print(f"[check] rwkv6_scan vs plain, rwkv6-7b prefill B={B} T={T} H={H} hd={hd} f32, logw "
          f"in [{args[3].min().item():.2f}, {args[3].max().item():.4f}], route scan: y max|d| "
          f"{ey:.3g}, state max|d| {es:.3g} (bound 2e-5 x max(1, max|plain|))")
    worst = max(ey, es)
    r, k, v, logw, u, s0 = args
    y1, s1 = rwkv_routed("scan", *(t[:, :100].contiguous() for t in (r, k, v, logw)), u, s0)
    y2, s2 = rwkv_routed("scan", *(t[:, 100:].contiguous() for t in (r, k, v, logw)), u, s1)
    e = max(f32_close(torch.cat([y1, y2], 1), yp, "rwkv chained y"),
            f32_close(s2, sp, "rwkv chained state"))
    print(f"[check] rwkv6_scan state chained across two calls (T=100 then 156) vs one plain "
          f"call: max|d| {e:.3g}")
    # decode: one step at rwkv6-7b's decode shape, then 32 chained steps
    # against one plain call of T=32
    one = [t[:, :1].contiguous() for t in (r, k, v, logw)] + [u, s0]
    (y, s), (yp1, sp1) = rwkv_routed("step", *one), rwkv6_scan_plain(*one)
    e = max(f32_close(y, yp1, "rwkv step y"), f32_close(s, sp1, "rwkv step state"))
    print(f"[check] rwkv6_scan vs plain, rwkv6-7b decode B={B} T=1 H={H} hd={hd} f32, logw in "
          f"[{one[3].min().item():.2f}, {one[3].max().item():.4f}], route step: max|d| {e:.3g} "
          "(bound 2e-5 x max(1, max|plain|))")
    n = SERVE_NEW
    yp32, sp32 = rwkv6_scan_plain(*(t[:, :n] for t in (r, k, v, logw)), u, s0)
    st, ys = s0, []
    for t in range(n):
        yt, st = rwkv_routed("step", *(x[:, t:t + 1].contiguous() for x in (r, k, v, logw)), u,
                             st)
        ys.append(yt)
    e = max(f32_close(torch.cat(ys, 1), yp32, "rwkv 32 chained steps y"),
            f32_close(st, sp32, "rwkv 32 chained steps state"))
    print(f"[check] rwkv6_scan {n} chained T=1 calls (route step) vs one plain call of T={n}: "
          f"every y and the state max|d| {e:.3g}")
    rb, kb, vb, wb, ub, sb = rwkv_on_card(2, 45, 8, 64, torch.bfloat16, gen)
    (y, s), (yp2, sp2) = (rwkv_routed("scan", rb, kb, vb, wb, ub, sb),
                          rwkv6_scan_plain(rb, kb, vb, wb, ub, sb))
    check(y.dtype == torch.bfloat16, "rwkv6_scan must keep r's dtype")
    e = bf16_close(y, yp2, "rwkv bf16 y")
    es = f32_close(s, sp2, "rwkv bf16-input state")
    one = [t[:, :1].contiguous() for t in (rb, kb, vb, wb)] + [ub, sb]
    (y, s), (yp2, sp2) = rwkv_routed("step", *one), rwkv6_scan_plain(*one)
    e1 = max(bf16_close(y, yp2, "rwkv bf16 step y"), f32_close(s, sp2, "rwkv bf16 step state"))
    print(f"[check] rwkv6_scan bf16 inputs B=2 T=45 H=8 hd=64: y max|d| {e:.3g} (bound 1 bf16 "
          f"ulp + 2e-5 x max(1, max|y|)), f32 state max|d| {es:.3g}; T=1 (route step) max|d| "
          f"{e1:.3g}")
    a32 = rwkv_on_card(3, 37, 4, 32, torch.float32, gen)
    (y, s), (yp3, sp3) = rwkv_routed("scan", *a32), rwkv6_scan_plain(*a32)
    e = max(f32_close(y, yp3, "rwkv hd32 y"), f32_close(s, sp3, "rwkv hd32 state"))
    one = [t[:, :1].contiguous() for t in a32[:4]] + list(a32[4:])
    (y, s), (yp3, sp3) = rwkv_routed("step", *one), rwkv6_scan_plain(*one)
    e1 = max(f32_close(y, yp3, "rwkv hd32 step y"), f32_close(s, sp3, "rwkv hd32 step state"))
    print(f"[check] rwkv6_scan f32 B=3 T=37 H=4 hd=32: route scan max|d| {e:.3g}, T=1 route step "
          f"max|d| {e1:.3g}")
    return args, worst


def host_us(fn, iters: int = 500) -> float:
    """Host time per call in microseconds: ``iters`` calls on the host
    clock with no synchronisation inside the loop (the device runs behind;
    a call's time is what the host spends issuing it)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    us = (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    return us


def phase_rwkv_timing(args, card):
    """Kernel and plain version at rwkv6-7b's prefill and decode shapes,
    eager and replayed from a CUDA graph; the wrapper's host time per call.  Returns the prefill numbers and, per
    line, its route and numbers."""
    r, k, v, logw, u, s0 = args
    B, T, H, hd = r.shape
    out, lines = None, []
    for label, sl in (("prefill", slice(None)), ("decode", slice(0, 1))):
        a = [t[:, sl].contiguous() for t in (r, k, v, logw)] + [u, s0]
        t_steps = a[0].shape[1]
        rt = rs_mod.route(t_steps)
        # r, k, v, logw read and y written once; u read; the state read and written
        nb = 5 * a[0].numel() * 4 + u.numel() * 4 + 2 * s0.numel() * 4
        flops = 5 * B * t_steps * H * hd * hd  # per state element and step: y 2, k v, S 2
        bd, bd_by = bound_of(nb, flops)
        iters = 20 if t_steps > 1 else 200
        ms, runs = median_windows(lambda: rwkv6_scan(*a), iters=iters)
        g_ms, g_runs = graph_windows(lambda: rwkv6_scan(*a), iters)
        plain, plain_runs = median_windows(lambda: rwkv6_scan_plain(*a), iters=3, warmup=1)
        h_us = host_us(lambda: rwkv6_scan(*a))
        print(f"[time] rwkv6_scan {label} B={B} T={t_steps} H={H} hd={hd} f32 on {card}: route "
              f"{rt} ({RWKV_SOURCE[rt]}.cu), kernel_ms {ms:.4f} (windows "
              f"{[round(x, 4) for x in runs]}), bound_ms {bd:.4f} ({bd_by}: {nb / 1e6:.1f} MB at "
              f"3.35 TB/s, {flops / 1e9:.3f} GFLOP at 67 TFLOP/s), kernel/bound {ms / bd:.2f}x, "
              f"plain_ms {plain:.4f} (windows {[round(x, 3) for x in plain_runs]})")
        print(f"[time] rwkv6_scan {label} replayed from a CUDA graph of {iters} calls (device "
              f"time, no host work per call): kernel {g_ms:.4f} ms (windows "
              f"{[round(x, 4) for x in g_runs]}), kernel/bound {g_ms / bd:.2f}x")
        line = {"label": label, "route": rt, "graph_ms": g_ms, "host_us": h_us}
        if rt == "step":
            # the replay above finds the 4.2 MB state in L2; serving does not
            # (32 layers' states are 134 MB): rotate over 16 states (67 MB)
            # and keep every output, as the cache keeps each layer's
            states = [s0.clone() for _ in range(16)]
            outs = []
            c_ms, c_runs = graph_windows(
                lambda: outs.append(rwkv6_scan(*a[:5], states[len(outs) % 16])), iters)
            del states, outs
            line["graph_cold_ms"] = c_ms
            print(f"[time] rwkv6_scan decode replayed from a CUDA graph, the state cold in L2 "
                  f"(16 states, 67 MB, in turn; every output kept): kernel {c_ms:.4f} ms "
                  f"(windows {[round(x, 4) for x in c_runs]}), kernel/bound {c_ms / bd:.2f}x")
            # the C entry point alone, with the wrapper's arguments prepared once
            y, s_fin = torch.empty_like(a[0]), torch.empty_like(s0)
            lib = rs_mod._lib("rwkv6_step")
            stream = torch._C._cuda_getCurrentRawStream(a[0].get_device())
            c_args = [t.data_ptr() for t in a] + [y.data_ptr(), s_fin.data_ptr(), B, H, hd, 0,
                                                  stream]
            c_us = host_us(lambda: lib.rwkv6_step_launch(*c_args))
            a_us = host_us(lambda: (torch.empty_like(a[0]), torch.empty_like(s0)))
            k_us = host_us(lambda: rs_mod._check(*a))
            print(f"[time] rwkv6_scan decode host time per call on {card}: wrapper "
                  f"{h_us:.2f} us (checks, two outputs, ctypes, launch), of which the C entry "
                  f"point through ctypes (with the launch) {c_us:.2f} us, the two output "
                  f"allocations {a_us:.2f} us, the shape/device checks {k_us:.2f} us")
        else:
            print(f"[time] rwkv6_scan {label} host time per call on {card}: {h_us:.2f} us")
        lines.append({**line, "source": f"src/repro_torch/kernels/csrc/{RWKV_SOURCE[rt]}.cu",
                      "ms": ms, "plain_ms": plain, "bound_ms": bd, "bound_by": bd_by,
                      "library_ms": None})
        if out is None:
            out = (ms, plain, bd, bd_by, None)
    print("[time] rwkv6_scan library_ms: none — no single PyTorch call computes the RWKV6 "
          "recurrence")
    return out, lines


class plain_kernels:
    """Inside the block the serving path computes with the kernels' plain
    versions (the reference run of the comparison): the module globals the
    model calls are swapped, and put back on exit.  ``nudge`` scales their
    f32 result by (1 + nudge) before it is rounded to the working dtype: a
    perturbation of the size of an f32 summation-order difference, whose
    effect on the logits is the yardstick for the kernel's."""

    def __init__(self, nudge: float = 0.0):
        self.nudge = nudge

    def __enter__(self):
        self.saved = (kops.flash_attention, rwkv_mod.rwkv6_scan)
        f = 1.0 + self.nudge

        def flash(q, k, v, **kw):
            return (flash_attention_plain(q.float(), k.float(), v.float(), **kw) * f).to(q.dtype)

        def scan(r, k, v, logw, u, s0):
            y, s = rwkv6_scan_plain(r.float(), k.float(), v.float(), logw.float(), u, s0)
            return (y * f).to(r.dtype), s

        kops.flash_attention = flash
        rwkv_mod.rwkv6_scan = scan
        return self

    def __exit__(self, *exc):
        kops.flash_attention, rwkv_mod.rwkv6_scan = self.saved


@torch.inference_mode()
def teacher_forced(cfg, params, prompts, gen_tokens, max_len, **prefill_kw):
    """(prefill logits [B, P, V], decode logits [B, n-1, V]) with the
    decode steps fed the given generated tokens; ``prefill_kw``
    (``positions``, ``extra_embeds``) go to the prefill."""
    dev = torch.device("cuda")
    B, P = prompts.shape
    cache = init_cache(cfg, B, max_len, device=dev)
    logits, _, cache = forward_lm(cfg, params, torch.as_tensor(prompts, device=dev),
                                  cache=cache, cache_index=0, **prefill_kw)
    serve = make_serve_step(cfg)
    gen = torch.as_tensor(gen_tokens, device=dev)
    dec = []
    for t in range(1, gen.shape[1]):
        lg, cache = serve(params, cache, gen[:, t - 1:t], P + t - 1)
        dec.append(lg)
    return logits, torch.stack(dec, 1)


def phase_serve(arch, cfg, prompt_len, new_tokens, max_len, kernel, card, routes, cli=()):
    """One model at full width through ``launch.serve.main`` (with the extra
    arguments ``cli``) and then ``Engine.generate``, with the launches of
    ``kernel`` counted over both, by route exactly ``routes``; then the
    same prompts through the plain versions, compared
    (``serve_agreement``)."""
    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):  # it prints every prompt: keep its summary line
        res_cli = serve_main(["--arch", arch, "--batch", "4", "--prompt-len", str(prompt_len),
                              "--new-tokens", str(new_tokens), "--seed", "0",
                              "--device", "cuda", *cli])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    print(out.getvalue().splitlines()[0])
    check(res_cli.tokens.shape == (4, prompt_len + new_tokens), "launcher output shape")
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    params = init_lm(cfg, gen, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(x.numel() for x in tree_leaves(params))
    eng = Engine(cfg, params, max_len=max_len)
    prompts = np.random.default_rng(1).integers(3, cfg.vocab_size, (4, prompt_len))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = eng.generate(prompts, max_new_tokens=new_tokens)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    counts = launches()
    by_route = dict({"flash_attention": flash_attention,
                     "rwkv6_scan": rwkv6_scan}[kernel].launches_by_route)
    check(by_route == routes, f"{kernel} launched {by_route} by route serving {arch}, expected "
          f"exactly {routes}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[serve] {arch} ({cfg.num_layers} layers, d {cfg.d_model}, vocab {cfg.vocab_size}, "
          f"{n_params / 1e9:.3f} B params bf16, init {init_s:.2f} s): launcher 4 x {prompt_len} "
          f"-> {new_tokens} in {cli_s:.1f} s (with its own init); Engine.generate 4 x "
          f"{prompt_len} -> {new_tokens} (max_len {max_len}) {gen_s:.3f} s; launches "
          f"{counts}; peak {peak:.2f} GiB")
    print(f"[serve] {arch} {kernel} launches by route: {by_route}, total {counts[kernel]} "
          "(exactly as worked out from the code)")

    # timing split (after the counted run): prefill alone, then whole generates
    with torch.inference_mode():
        toks = torch.as_tensor(prompts, device=dev)

        def prefill():
            eng._prefill(params, toks, init_cache(cfg, 4, max_len, device=dev))

        pre_ms, pre_runs = median_windows(prefill, iters=3, warmup=1)
    gen_runs = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.generate(prompts, max_new_tokens=new_tokens)
        torch.cuda.synchronize()
        gen_runs.append((time.perf_counter() - t0) * 1e3)
    gen_ms = sorted(gen_runs)[1]
    dec_ms = (gen_ms - pre_ms) / (new_tokens - 1)
    print(f"[serve] {arch} on {card}: prefill 4 x {prompt_len} {pre_ms:.2f} ms (windows "
          f"{[round(x, 2) for x in pre_runs]}); generate {gen_ms:.1f} ms (runs "
          f"{[round(x, 1) for x in gen_runs]}); decode {dec_ms:.2f} ms per step of 4 tokens; "
          f"{4 * new_tokens / gen_ms * 1e3:.1f} tokens/s, {4 * prompt_len / pre_ms * 1e3:.0f} "
          "prompt tokens/s in prefill")

    # where the time goes: the kernels' device time in one prefill and in 8
    # decode steps, against the unprofiled wall times above
    with torch.inference_mode():
        cache = init_cache(cfg, 4, max_len, device=dev)
        logits, cache = eng._prefill(params, toks, cache)
        nxt = torch.argmax(logits, dim=-1)[:, None]
        step = make_serve_step(cfg)

        def decode8():
            for t in range(8):
                step(params, cache, nxt, prompt_len + t)

        print_split(arch, f"prefill 4 x {prompt_len}", pre_ms, device_split(prefill))
        print_split(arch, "8 decode steps", 8 * dec_ms, device_split(decode8))
        del cache, logits
        moe_layers = sum(b.ffn == "moe" for b in cfg.blocks)
        if moe_layers:
            moe_timing(arch, cfg, params, prompt_len, pre_ms, dec_ms, moe_layers, card)

    gen_k = res.tokens[:, prompt_len:]
    serve_agreement(arch, cfg, lambda: teacher_forced(cfg, params, prompts, gen_k, max_len),
                    gen_k)
    del params, eng
    torch.cuda.empty_cache()
    return counts[kernel], by_route, {"prefill_ms": pre_ms, "decode_ms": dec_ms,
                                      "tokens_per_s": 4 * new_tokens / gen_ms * 1e3,
                                      "params": n_params, "peak_gib": peak}


def moe_timing(arch, cfg, params, prompt_len, pre_ms, dec_ms, n_layers, card):
    """The MoE FFN alone (router, dispatch, experts, combine: plain PyTorch,
    as the reference leaves it to XLA) at the prefill and decode shapes,
    timed with CUDA events on the first MoE layer's weights and a unit-scale
    input (what the norm before it gives), beside the step times."""
    dev = torch.device("cuda")
    p0 = next(p["moe"] for _, blk, p in tt_mod._layers(cfg, params) if blk.ffn == "moe")
    g = torch.Generator(device=dev).manual_seed(3)
    h = torch.randn((4, prompt_len, cfg.d_model), generator=g, device=dev).to(p0["router"].dtype)
    hd = h[:, :1].contiguous()
    srt = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, routing="sort"))
    with torch.inference_mode():
        t_pre, runs_pre = median_windows(lambda: moe_mod.moe_fwd(cfg, p0, h), iters=3, warmup=1)
        t_dec, runs_dec = median_windows(lambda: moe_mod.moe_fwd(cfg, p0, hd), iters=20)
        s_pre, s_runs = median_windows(lambda: moe_mod.moe_fwd(srt, p0, h), iters=3, warmup=1)
        s_dec, _ = median_windows(lambda: moe_mod.moe_fwd(srt, p0, hd), iters=20)
        # the same semantics (capacity, drops) by gathers; gshard's combine
        # product may reduce split-K partials in bf16 (PyTorch's default for
        # bf16 GEMMs), so within 4 bf16 ulps of the larger side
        got = moe_mod.moe_fwd(srt, p0, h)[0].float()
        want = moe_mod.moe_fwd(cfg, p0, h)[0].float()
        err = (got - want).abs()
        e = err.max().item()
        check(bool(torch.isfinite(got).all()) and bool(
            (err <= 4 * bf16_ulp(torch.maximum(got.abs(), want.abs()))
             + 2e-5 * max(1.0, want.abs().max().item())).all()),
            f"{arch} MoE sort routing vs {cfg.moe.routing}: max|d| {e:.3g} over 4 bf16 ulps")
        del got, want, err
    E, K = cfg.moe.num_experts, cfg.moe.experts_per_token
    T = 4 * prompt_len
    cap = max(int(cfg.moe.capacity_factor * T * K / E), K)
    # the experts' products at capacity, and gshard's dispatch and combine products
    expert_gflop = 2 * 3 * E * cap * cfg.d_model * cfg.d_ff / 1e9
    onehot_gflop = 2 * 2 * T * E * cap * cfg.d_model / 1e9
    print(f"[profile] {arch} MoE FFN alone ({cfg.moe.routing}, {E} experts top-{K}, capacity "
          f"{cap} at 4 x {prompt_len}; CUDA events on {card}): one layer at prefill {t_pre:.3f} "
          f"ms (windows {[round(r, 3) for r in runs_pre]}; {expert_gflop:.1f} GFLOP in the "
          f"experts, {onehot_gflop:.1f} GFLOP in the one-hot dispatch and combine products), x "
          f"{n_layers} layers = {t_pre * n_layers:.2f} ms of the {pre_ms:.2f} ms prefill; at a "
          f"decode step (4 tokens) {t_dec:.4f} ms, x {n_layers} = {t_dec * n_layers:.2f} ms of "
          f"the {dec_ms:.2f} ms step")
    print(f"[profile] {arch} MoE FFN alone, the sort routing (REPRO_OPT_MOE_SORT's gathers in "
          f"place of the one-hot products; CUDA events on {card}): one layer at prefill "
          f"{s_pre:.3f} ms (windows {[round(r, 3) for r in s_runs]}), at a decode step "
          f"{s_dec:.4f} ms; its output vs {cfg.moe.routing}'s max|d| {e:.3g} (bound 4 bf16 ulps "
          "+ 2e-5 x max(1, max|o|))")


class route_replay:
    """Inside the block every MoE router call goes through here, in call
    order.  Without ``fixed`` each call's top-k experts are recorded
    (``calls``); with the list of an earlier run each call routes to that
    run's experts instead of its own top-k, weighted by its own
    probabilities renormalized over them, and the calls where its own
    choice (as a set) differs are counted (``flips``).  So two runs route
    the same way and their outputs differ only by the arithmetic."""

    def __init__(self, fixed=None):
        self.fixed, self.calls, self.flips = fixed, [], []

    def __enter__(self):
        self.saved = moe_mod._router

        def route(cfg, p, x):
            probs, idx, w = self.saved(cfg, p, x)
            if self.fixed is None:
                self.calls.append(idx)
                return probs, idx, w
            want = self.fixed[len(self.flips)]
            self.flips.append((torch.sort(idx, -1).values
                               != torch.sort(want, -1).values).any(-1).sum())
            w = probs.gather(1, want)
            return probs, want, w / w.sum(-1, keepdim=True)

        moe_mod._router = route
        return self

    def __exit__(self, *exc):
        moe_mod._router = self.saved
        if self.fixed is not None and exc[0] is None:
            check(len(self.flips) == len(self.fixed), f"route replay: {len(self.flips)} router "
                  f"calls, {len(self.fixed)} recorded")

    def per_layer(self, n_layers):
        """Differing decisions summed per layer (calls cycle through the layers)."""
        return torch.stack(self.flips).reshape(-1, n_layers).sum(0).tolist()


def logit_diff(a, b):
    """(max |a - b|, mean |a - b|) over bf16 logits, in f32, row by row."""
    mx, tot, n = 0.0, 0.0, 0
    for i in range(a.shape[0]):
        d = (a[i].float() - b[i].float()).abs()
        mx, tot, n = max(mx, d.max().item()), tot + d.sum().item(), n + d.numel()
        del d
    return mx, tot / n


def logits_agreement(kern, plain, floor, what):
    """Kernel-path logits against the plain path's: max and mean |d| must
    stay within 4x those between the plain path and its nudged run
    (``floor``), the spread that rounding the same f32 values to bf16 at a
    different last bit produces through the whole model."""
    check(bool(torch.isfinite(kern).all()), f"{what}: logits not finite")
    mx, mean = logit_diff(kern, plain)
    check(mx <= 4 * floor[0], f"{what}: max|d| {mx:.3g} > 4 x the nudged plain run's "
          f"{floor[0]:.3g}")
    check(mean <= 4 * floor[1], f"{what}: mean|d| {mean:.3g} > 4 x the nudged plain run's "
          f"{floor[1]:.3g}")
    return mx, mean


def serve_agreement(arch, cfg, run, gen_k):
    """The model teacher-forced on the kernel path's tokens (``run()`` gives
    the prefill and decode logits), once more and with the kernels' plain
    versions: logits within 4x those between the
    plain path and its nudged run, and greedy tokens equal wherever the
    plain path's top-2 margin exceeds twice the logit difference.  In a
    model with MoE layers a last-bit difference in attention can flip a
    near-tied top-k choice and move that token's output by O(1), so the
    plain and nudged runs replay the kernel run's routing
    (``route_replay``) and the rule holds at every position; the decisions
    each would have taken otherwise are counted per layer and printed."""
    with route_replay() as rec:
        pre_k, dec_k = run()
    check(np.array_equal(torch.argmax(torch.cat([pre_k[:, -1:], dec_k], 1), -1).cpu().numpy(),
                         gen_k), "teacher-forced kernel path must repeat the generate")
    with plain_kernels(), route_replay(rec.calls) as rep_p:
        pre_p, dec_p = run()
    with plain_kernels(nudge=NUDGE), route_replay(rec.calls) as rep_n:
        pre_n, dec_n = run()
    floor_pre, floor_dec = logit_diff(pre_n, pre_p), logit_diff(dec_n, dec_p)
    del pre_n, dec_n
    a_pre = logits_agreement(pre_k, pre_p, floor_pre, f"{arch} prefill logits")
    a_dec = logits_agreement(dec_k, dec_p, floor_dec, f"{arch} decode logits")
    mean_logit = pre_p[:, -1].float().abs().mean().item()
    steps_k = torch.cat([pre_k[:, -1:], dec_k], 1).float()
    steps_p = torch.cat([pre_p[:, -1:], dec_p], 1).float()
    d_step = (steps_k - steps_p).abs().amax(-1)            # [B, n]
    top2 = torch.topk(steps_p, 2, dim=-1)
    margin = top2.values[..., 0] - top2.values[..., 1]
    dec_np = (margin > 2 * d_step).cpu().numpy()
    agree = top2.indices[..., 0].cpu().numpy() == gen_k
    check(bool(agree[dec_np].all()), f"{arch}: greedy tokens differ from the plain path where "
          "its top-2 margin exceeds twice the logit difference")
    flips = ""
    if rec.calls:
        n_moe = sum(b.ffn == "moe" for b in cfg.blocks)
        per_layer, nudged = rep_p.per_layer(n_moe), rep_n.per_layer(n_moe)
        decisions = sum(c.shape[0] for c in rec.calls)
        flips = (f"; the plain and nudged runs replay the kernel run's MoE routing: their own "
                 f"top-k would differ at {sum(per_layer)} and {sum(nudged)} of {decisions} "
                 f"(token, layer) decisions, per MoE layer {per_layer} (plain)")
    print(f"[serve] {arch} kernel vs plain (teacher-forced): prefill logits max|d| {a_pre[0]:.4g} "
          f"mean|d| {a_pre[1]:.3g}, decode logits max|d| {a_dec[0]:.4g} mean|d| {a_dec[1]:.3g} "
          f"(mean |logit| {mean_logit:.3g}); the plain path nudged by {NUDGE:g} moves them by "
          f"max {floor_pre[0]:.4g} / mean {floor_pre[1]:.3g} (prefill) and max "
          f"{floor_dec[0]:.4g} / mean {floor_dec[1]:.3g} (decode), bound 4x; tokens: "
          f"{int(dec_np.sum())}/{dec_np.size} decided by a margin > 2 x max|d| and all agree; "
          f"{int(agree.sum())}/{agree.size} agree overall" + flips)


def device_split(fn):
    """One call of ``fn`` under ``torch.profiler``: (device-busy ms, top 6
    kernels and the port's own kernels, each as (name, ms, count)), or None
    when the profiler recorded no device event.  Busy is the sum of the
    kernels' device intervals (one stream, so they do not overlap)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    if not by_name:
        return None
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    ours = [(re.search(r"(\w+_kernel)", k).group(1), ms, n) for k, (ms, n) in ranked
            if re.search(r"(flash|rwkv6)\w*_kernel", k)]
    return (sum(ms for ms, _ in by_name.values()), [(k[:70], ms, n) for k, (ms, n) in ranked[:6]],
            ours)


def print_split(arch, what, wall_ms, split):
    if split is None:
        print(f"[profile] {arch} {what}: device time not measured (the profiler recorded no "
              "device event)")
        return
    busy, top, ours = split
    print(f"[profile] {arch} {what}: kernels busy {busy:.2f} ms of {wall_ms:.2f} ms wall "
          f"(unprofiled), device idle {max(0.0, 1 - busy / wall_ms) * 100:.1f} %; top kernels "
          + "; ".join(f"{name} {ms:.3f} ms x{n}" for name, ms, n in top)
          + "; the port's kernels " + "; ".join(f"{name} {ms:.3f} ms x{n}" for name, ms, n in ours))


def small_lm_cfg(arch):
    cfg = reduce_config(get_config(arch))
    if arch == "gemma3-1b":
        pattern = tuple(dataclasses.replace(b, window=8) if b.window else b for b in cfg.pattern)
        cfg = dataclasses.replace(cfg, num_layers=8, pattern=pattern)
    return cfg


def phase_small_lm():
    """Reduced f32 gemma3 (window 8, 8 layers) and rwkv6 on the card and on
    the CPU (whose path the CPU tests hold against the JAX package)."""
    for arch in ("gemma3-1b", "rwkv6-7b"):
        cfg = small_lm_cfg(arch)
        params = init_lm(cfg, torch.Generator().manual_seed(5), device="cpu")
        prompts = np.random.default_rng(6).integers(3, cfg.vocab_size, (3, 12))
        out = {}
        for dev in ("cpu", "cuda"):
            p = tree_map(lambda x: x.to(dev), params)
            res = Engine(cfg, p, max_len=32).generate(prompts, max_new_tokens=16)
            with torch.inference_mode():
                lg, _, _ = forward_lm(cfg, p, torch.as_tensor(res.tokens, device=dev))
            out[dev] = (res.tokens, lg.cpu())
        d = (out["cpu"][1] - out["cuda"][1]).abs().max().item()
        check(np.array_equal(out["cpu"][0], out["cuda"][0]), f"small {arch}: tokens differ")
        check(d <= 1e-4, f"small {arch}: card and CPU logits differ by {d:.3g} > 1e-4")
        print(f"[small] reduced f32 {cfg.name} ({cfg.num_layers} layers): 3 x 12 -> 16 tokens "
              f"identical on card and CPU; logits over all 28 positions max|d| {d:.3g} "
              "(bound 1e-4)")


# ---------------------------------------------------------------------------
# slice 7: the fuse-to-serve stack (phase 11)
# ---------------------------------------------------------------------------


def poll_until(pred, what: str, timeout: float = 300.0, interval: float = 0.01) -> float:
    """Poll ``pred`` until it holds; the seconds it took (a failed check at
    the deadline)."""
    t0 = time.perf_counter()
    while not pred():
        check(time.perf_counter() - t0 < timeout, f"{what} not reached in {timeout} s")
        time.sleep(interval)
    return time.perf_counter() - t0


class HeldEngine:
    """The worker's engine factory: the real ``Engine``, every call recorded
    as (prompts, params, tokens); with ``hold`` set, the next call signals
    ``started`` and waits for ``release`` before the real generate runs."""

    def __init__(self):
        self.engine, self.hold, self.calls = None, None, []
        self.lock = threading.Lock()

    def __call__(self, cfg, params, max_len):
        self.engine = Engine(cfg, params, max_len=max_len)
        return self

    def generate(self, prompts, *, max_new_tokens, params=None):
        hold, self.hold = self.hold, None
        if hold is not None:
            hold["started"].set()
            check(hold["release"].wait(900.0), "the held request was never released")
        res = self.engine.generate(prompts, max_new_tokens=max_new_tokens, params=params)
        with self.lock:
            self.calls.append((np.array(prompts), params, res.tokens))
        return res


def in_thread(fn):
    """Run ``fn()`` on a thread; the returned ``join()`` gives its result or
    raises its error."""
    box = {}

    def run():
        try:
            box["out"] = fn()
        except BaseException as err:  # noqa: BLE001 - re-raised by join
            box["err"] = err

    th = threading.Thread(target=run, daemon=True)
    th.start()

    def join(timeout: float = 900.0):
        th.join(timeout)
        check(not th.is_alive(), f"a request thread did not finish in {timeout} s")
        if "err" in box:
            raise box["err"]
        return box["out"]

    return join


def perturbed_row(spec, base, seed):
    """The base plus SWAP_NOISE x N(0, 1) drawn per leaf from ``seed``, as
    one flat row in the base's dtype."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    tree = tree_map(lambda x: (x.float() + SWAP_NOISE * torch.randn(
        x.shape, generator=g, device="cuda")).to(x.dtype), base)
    return spec.flatten(tree)


def by_reference(params, row) -> bool:
    """Every leaf is a view inside ``row``'s storage and together they
    cover it: adopted without a copy."""
    ptr, leaves = row.untyped_storage().data_ptr(), tree_leaves(params)
    return (all(x.untyped_storage().data_ptr() == ptr for x in leaves)
            and sum(x.numel() for x in leaves) == row.numel())


def timed_generate(eng, prompts, **kw):
    torch.cuda.synchronize()
    t = time.perf_counter()
    res = eng.generate(prompts, max_new_tokens=SERVE_NEW, **kw)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t


def phase_serve_stack(workdir):
    """The fuse-to-serve stack (phase 11) on gemma3-1b: a Repository behind
    the daemon, a hot-swap ServingWorker with the scheduler following it in
    process, a cross-process worker, and a pool of two children behind a
    Router.  Returns what the phase measured."""
    cfg, prompt_len, new, max_len = GEMMA, GEMMA_PROMPT, SERVE_NEW, GEMMA_MAX_LEN
    res = {}
    t_phase = time.perf_counter()
    root = os.path.join(workdir, "serve_stack")
    rng = np.random.default_rng(11)

    # setup: the model on the card, the repository, the daemon, the worker
    theta = init_lm(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    spec = FlatSpec.from_tree(theta)
    t = time.perf_counter()
    repo = Repository(theta, root=root, spill=True)  # the MAD screen on
    del theta
    svc = ColdService(repo, policy=AdmissionPolicy(min_cohort=K_SWAP))
    init_s = time.perf_counter() - t
    st = svc.status()
    check(not st["novelty_screen"] and st["serving"] is None, f"daemon status {st}")
    print(f"[serve-stack] {cfg.name}: {len(spec.leaves)} leaves, N = {spec.size:,} "
          f"{spec.dtype} ({spec.size * 2 / 1e9:.2f} GB row) on {repo.device}; "
          f"Repository + base_iter0000.npz + ColdService {init_s:.2f} s")
    held = HeldEngine()
    w = ServingWorker(cfg, root, repo=repo, max_len=max_len, batch_requests=True,
                      max_batch=SCHED_BATCH, batch_wait_s=SCHED_WAIT, engine_factory=held)
    w.start(interval=0.02)
    poll_until(lambda: w.current_iteration == 0, "the initial adoption")

    # 1. adoption by reference
    row0 = repo.flat_base()
    check(by_reference(w.current().params, row0),
          "the initial adoption copied: a served leaf lies outside the published row")
    res["adopt_s"] = w.last_swap_latency_s
    print(f"[serve-stack] initial adoption in process, by reference (every leaf a view of the "
          f"published row): swap latency {res['adopt_s'] * 1e3:.3f} ms")

    # 2. a request pinned to iteration 0 while iteration 1 is fused and published
    prompts = rng.integers(3, cfg.vocab_size, (4, prompt_len))
    oracle0, _ = timed_generate(Engine(cfg, repo.download(), max_len=max_len), prompts)
    stage = torch.empty((K_SWAP, spec.size), dtype=row0.dtype, device="cuda")
    for c in range(K_SWAP):
        stage[c] = perturbed_row(spec, repo.download(), 1100 + c)
    rows = list(stage)
    hold = {"started": threading.Event(), "release": threading.Event()}
    held.hold = hold
    join = in_thread(lambda: w.generate(prompts, max_new_tokens=new))
    check(hold["started"].wait(600.0), "the pinned request never reached the engine")
    t = time.perf_counter()
    for c, row in enumerate(rows):
        ContributorClient(root, f"c{c}").submit(row=row, spec=spec, base_iteration=0)
    res["submit_s"] = time.perf_counter() - t
    t = time.perf_counter()
    serve_until(svc, lambda st: st["iteration"] >= 1, timeout=600)
    res["serve_s"] = time.perf_counter() - t
    rec = repo.history[-1]
    check((rec.n_accepted, rec.n_contributions) == (K_SWAP, K_SWAP),
          f"cohort fused {rec.n_accepted}/{rec.n_contributions}")
    poll_until(lambda: w.current_iteration == 1, "the swap to iteration 1")
    swap1 = dict(w.last_swap)
    check(swap1["from_iteration"] == 0 and swap1["to_iteration"] == 1, f"swap {swap1}")
    check(by_reference(w.current().params, repo.flat_base()), "iteration 1 adopted by copy")
    check(repo.flat_base().untyped_storage().data_ptr() != row0.untyped_storage().data_ptr(),
          "the publish wrote into the superseded row")
    hold["release"].set()
    got = join()
    check(got.iteration == 0, f"the pinned request served iteration {got.iteration}")
    check(np.array_equal(got.tokens, oracle0.tokens),
          "the pinned request's tokens differ from the iteration-0 oracle's")
    check(w.requests_pinned_across_swaps == 1,
          f"requests_pinned_across_swaps {w.requests_pinned_across_swaps}")
    print(f"[serve-stack] {K_SWAP} dense submissions ({spec.size * 2 / 1e9:.2f} "
          f"GB npz each) {res['submit_s']:.2f} s; the daemon fused {rec.n_accepted}/"
          f"{rec.n_contributions} and published iteration 1 in {res['serve_s']:.2f} s (fuse "
          f"{rec.wall_time:.3f} s); swap 0 -> 1 in process {swap1['swap_latency_s'] * 1e3:.3f} "
          f"ms; the request held across it served iteration 0, tokens equal to the iteration-0 "
          f"oracle ({prompts.shape[0]} x {prompt_len} -> {new}); pinned across swaps: 1")

    # 3. a new request serves iteration 1, as a fresh Engine on the base does
    got1, lat1 = timed_generate(w, prompts)
    fresh, lat_fresh = timed_generate(Engine(cfg, repo.download(), max_len=max_len),
                                      prompts)
    check(got1.iteration == 1, f"a new request served iteration {got1.iteration}")
    check(np.array_equal(got1.tokens, fresh.tokens),
          "iteration 1's tokens differ from a fresh Engine on repo.download()")
    moved = int((got1.tokens[:, prompt_len:] != oracle0.tokens[:, prompt_len:]).sum())
    print(f"[serve-stack] iteration 1 served, tokens equal to a fresh Engine's; "
          f"{moved}/{got1.tokens[:, prompt_len:].size} generated tokens differ from iteration "
          f"0's; 4-row request {lat1:.3f} s through the worker, {lat_fresh:.3f} s on the fresh "
          "Engine")

    # 4. the fused base against cold_fuse_plain, chunk by chunk
    t = time.perf_counter()
    err_exact, err_plain, n_plain, n_exact = hold_fuse(repo.flat_base(), row0, rows, 1.0,
                                                       "the published base")
    print(f"[check] published base ({spec.size:,} elements) vs the exactly rounded mean of "
          f"{K_SWAP} rows: max|d| {err_exact:.3g}, {n_exact} elements beyond 1 bf16 ulp; vs "
          f"cold_fuse_plain: max|d| {err_plain:.3g}, {n_plain} beyond; every one of them "
          f"within 1 f32 ulp of the operands "
          f"({time.perf_counter() - t:.1f} s)")
    res["fuse_inputs"] = (row0, stage)  # timed after the launches are read
    del rows

    # 5. the scheduler: SCHED_N concurrent single-row requests
    sched_prompts = rng.integers(3, cfg.vocab_size, (SCHED_N, prompt_len))
    n0 = len(held.calls)
    gate = threading.Barrier(SCHED_N)

    def client(i):
        return lambda: (gate.wait(), w.generate(sched_prompts[i:i + 1], max_new_tokens=new))[1]

    torch.cuda.synchronize()
    t = time.perf_counter()
    joins = [in_thread(client(i)) for i in range(SCHED_N)]
    served = [j() for j in joins]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    calls = held.calls[n0:]
    sizes = [c[0].shape[0] for c in calls]
    check(all(r.iteration == 1 for r in served), "a batched request left iteration 1")
    check(any(r.batch_size > 1 for r in served), f"nothing coalesced: batches {sizes}")
    check(sizes == [SCHED_BATCH] * (SCHED_N // SCHED_BATCH),
          f"batches {sizes}, expected {SCHED_N // SCHED_BATCH} of {SCHED_BATCH}")
    for prompts_b, params_b, _ in calls:
        # the batch's requests in row order (a padding row repeats the last)
        idx = list(dict.fromkeys(
            next(i for i in range(SCHED_N) if np.array_equal(sched_prompts[i], row))
            for row in prompts_b))
        rebuilt = np.stack([sched_prompts[i] for i in idx])
        pad = batch_bucket(len(idx)) - len(idx)
        rebuilt = np.concatenate([rebuilt, np.repeat(rebuilt[-1:], pad, axis=0)])
        check(np.array_equal(rebuilt, prompts_b), "a batch is not its requests, padded as "
              "the scheduler pads")
        again = held.engine.generate(rebuilt, max_new_tokens=new, params=params_b).tokens
        for j, i in enumerate(idx):
            check(np.array_equal(served[i].tokens[0], again[j]),
                  f"request {i}'s tokens differ from its batch's re-run")
    solo = []
    for i in range(2):
        _, s = timed_generate(held.engine, sched_prompts[i:i + 1],
                              params=w.current().params)
        solo.append(s)
    lats = sorted(r.latency_s for r in served)
    res["sched"] = {"batches": sizes, "latency_s": lats, "wall_s": wall, "solo_s": solo,
                    "tokens_per_s": SCHED_N * new / wall, "solo_tokens_per_s": new / min(solo)}
    print(f"[serve-stack] scheduler: {SCHED_N} concurrent 1 x {prompt_len} -> {new} requests "
          f"in batches {sizes}, each row's tokens equal to a re-run of its batch; per-request "
          f"latency {lats[0]:.3f} / {lats[len(lats) // 2]:.3f} / {lats[-1]:.3f} s (min / "
          f"median / max), {wall:.3f} s wall, {res['sched']['tokens_per_s']:.1f} generated "
          f"tokens/s; solo (one row, straight to the engine) {solo[0]:.3f} / {solo[1]:.3f} s, "
          f"{res['sched']['solo_tokens_per_s']:.1f} tokens/s")

    # 6. rollback: the follower swaps backwards
    t = time.perf_counter()
    repo.rollback(0)
    res["rollback_s"] = time.perf_counter() - t
    poll_until(lambda: w.current_iteration == 0, "the swap back to iteration 0")
    back = dict(w.last_swap)
    check(back["from_iteration"] == 1 and back["to_iteration"] == 0, f"rollback swap {back}")
    got_rb = w.generate(prompts, max_new_tokens=new)
    check(got_rb.iteration == 0 and np.array_equal(got_rb.tokens, oracle0.tokens),
          "after the rollback the worker does not serve the iteration-0 oracle's tokens")
    print(f"[serve-stack] rollback(0) {res['rollback_s']:.2f} s; swap 1 -> 0 "
          f"{back['swap_latency_s'] * 1e3:.3f} ms; tokens equal to the iteration-0 oracle's")

    # 7. a cross-process worker loads the published npz onto the card
    x = ServingWorker(cfg, root, device="cuda", max_len=max_len, worker_id="xproc", name="xproc")
    check(x.poll_once() and x.current_iteration == 0, "the cross-process worker adopted nothing")
    res["xproc_swap_s"] = x.last_swap_latency_s
    check(all(leaf.device == repo.device for leaf in tree_leaves(x.current().params)),
          "the cross-process worker's base is not on the card")
    got_x = x.generate(prompts, max_new_tokens=new)
    check(got_x.iteration == 0 and np.array_equal(got_x.tokens, got_rb.tokens),
          "the cross-process worker's tokens differ from the in-process worker's")
    w._persist_state()
    solo_state = ckpt.load_json(os.path.join(root, "serving_state.json"))
    serving = svc.status()["serving"]
    check(solo_state["iteration"] == 0 and serving["iteration"] == 0
          and serving["n_workers"] == 2 and serving["versions_served"] == [0, 1],
          f"serving state {solo_state['iteration']} / {serving}")
    print(f"[serve-stack] cross-process worker: base_iter0000.npz loaded onto the card, swap "
          f"latency {res['xproc_swap_s']:.3f} s; tokens equal to the in-process worker's; "
          f"serving_state.json iteration {solo_state['iteration']}, status()['serving'] "
          f"iteration {serving['iteration']} over {serving['n_workers']} workers, "
          f"versions {serving['versions_served']}")
    x.stop()
    w.stop()
    svc.close()
    del x, w, held, repo, svc, row0, stage, oracle0, got, got1, fresh
    torch.cuda.empty_cache()

    # 8. a pool of two children (reduced gemma3-1b, real engine, batched) behind a Router
    res["pool"] = pool_run(os.path.join(workdir, "pool"), rng)
    res["seconds"] = time.perf_counter() - t_phase
    return res


def time_cohort_fuse(base, stage, card):
    """``cold_fuse`` at phase 11's cohort shape, beside its bound and the
    plain version (CUDA events, five windows, the median)."""
    K, N = stage.shape
    w = torch.ones(K, device=stage.device)
    s = stage.element_size()
    bound, by = bound_of((K + 2) * N * s + 2 * K * 4, 4 * K * N + 3 * N)
    ms, runs = median_windows(lambda: cold_fuse(base, stage, w, 1.0), iters=5)
    plain, plain_runs = median_windows(lambda: cold_fuse_plain(base, stage, w, 1.0), iters=1,
                                       warmup=1)
    print(f"[time] cold_fuse K={K} N={N:,} {str(stage.dtype)[6:]} (phase 11's cohort) on "
          f"{card}: kernel_ms {ms:.4f} (windows {[round(r, 4) for r in runs]}), bound_ms "
          f"{bound:.4f} ({(K + 2) * N * s / 1e9:.2f} GB at 3.35 TB/s, by {by}), kernel/bound "
          f"{ms / bound:.2f}x; plain_ms {plain:.2f} (windows "
          f"{[round(r, 2) for r in plain_runs]})")
    return {"K": K, "N": N, "ms": ms, "bound_ms": bound, "bound_by": by, "plain_ms": plain}


def pool_run(root, rng):
    """Phase 11's pool: two children over a small root, converging on a
    publish, served tokens against the parent's Engine, one kill -9."""
    params = init_lm(POOL_CFG, torch.Generator(device="cuda").manual_seed(3), device="cuda")
    repo = Repository(params, root=root, spill=True, screen=False)
    pool = WorkerPool(root, 2, arch="gemma3-1b", device="cuda", max_len=POOL_MAX_LEN,
                      poll=0.02, batch=True, max_batch=SCHED_BATCH,
                      warm=(POOL_PROMPT, POOL_NEW))
    out = {}
    try:
        t = time.perf_counter()
        pool.start(timeout=600.0)
        pool.wait_ready(iteration=0, timeout=600.0)
        out["start_s"] = time.perf_counter() - t
        router = pool.router()
        g = torch.Generator(device="cuda").manual_seed(4)
        repo.upload(tree_map(lambda x: x + 0.05 * torch.randn(x.shape, generator=g,
                                                               device="cuda"), params))
        repo.fuse_pending()
        repo.flush()
        t = time.perf_counter()
        pool.wait_ready(iteration=1, timeout=300.0)
        out["converge_s"] = time.perf_counter() - t
        check(sorted(pool.alive()) == ["w0", "w1"]
              and {s["iteration"] for s in pool.states().values()} == {1},
              f"the pool did not converge on iteration 1: {pool.states()}")
        base = ckpt.load(os.path.join(root, "base_iter0001.npz"), device="cuda")
        eng = Engine(POOL_CFG, base, max_len=POOL_MAX_LEN)
        prompt = rng.integers(3, POOL_CFG.vocab_size, POOL_PROMPT)
        oracle = {b: eng.generate(np.repeat(prompt[None], b, axis=0),
                                  max_new_tokens=POOL_NEW).tokens[0] for b in POOL_BUCKETS}
        results, stop = [], threading.Event()

        def client():
            got = []
            while not stop.is_set():
                got.append(router.route(prompt, max_new_tokens=POOL_NEW))
            return got

        joins = [in_thread(client) for _ in range(6)]
        time.sleep(0.5)
        pool.kill("w0")
        time.sleep(1.0)
        stop.set()
        for j in joins:
            results += j()
        after = [router.route(prompt, max_new_tokens=POOL_NEW) for _ in range(4)]
        results += after
        for r in results:
            check(r.iteration == 1 and np.array_equal(r.tokens, oracle[r.batch_size]),
                  f"a pool response (iteration {r.iteration}, batch {r.batch_size}, "
                  f"{r.worker_id}) differs from the parent's Engine on base_iter0001.npz")
        check(all(r.worker_id == "w1" for r in after), "a request reached the killed child")
        st = router.stats()
        n_rerouted = sum(r.rerouted for r in results)
        check(st["failed_total"] == 0 and st["reroutes_total"] == n_rerouted >= 1,
              f"router after the kill: {st}, {n_rerouted} responses marked rerouted")
        out.update(requests=len(results), rerouted=n_rerouted, per_worker=st["per_worker"],
                   batches=sorted({r.batch_size for r in results}))
    finally:
        codes = pool.stop()
    check(codes == {"w0": -9, "w1": 0}, f"pool exit codes {codes}")
    print(f"[serve-stack] pool of 2 children ({POOL_CFG.name}, {POOL_CFG.num_layers} layers, "
          f"f32, real engine on the card, batched): started and adopted iteration 0 in "
          f"{out['start_s']:.1f} s, converged on iteration 1 in {out['converge_s']:.2f} s; "
          f"{out['requests']} routed requests (batch sizes {out['batches']}, per worker "
          f"{out['per_worker']}), every one iteration 1 with the parent's Engine tokens; kill -9 "
          f"of w0 under traffic: {out['rerouted']} requests re-routed once each, 0 failed; "
          f"exit codes {codes}")
    return out


# ---------------------------------------------------------------------------
# slice 8: LM training, serving what it trained, the example twins (phase 12)
# ---------------------------------------------------------------------------


def train_via_launcher(argv, card):
    """``launch.train.main(argv)`` on the card: its result, with the median
    step time and the peak memory printed."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = train_launcher.main(argv + ["--device", "cuda"])
    seconds = time.perf_counter() - t0
    cfg, losses, norms, aux = out["cfg"], out["loss"], out["grad_norm"], out["aux"]
    check(all(math.isfinite(x) for x in losses + norms + aux), f"{cfg.name}: a loss, aux or "
          "grad_norm is not finite")
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    print(f"[train] {cfg.name}: {len(losses)} steps, loss {losses[0]:.4f} -> {losses[-1]:.4f} "
          f"(mean of the first 5 {first:.4f}, of the last 5 {last:.4f}); grad_norm "
          f"{norms[0]:.3f} -> {norms[-1]:.3f}; aux {aux[0]:.4f} -> {aux[-1]:.4f}; step "
          f"{median_ms(out['step_s'][1:])} after the "
          f"first ({1e3 * out['step_s'][0]:.1f} ms); peak "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; the launcher "
          f"{seconds:.1f} s with init and save; on {card}")
    return out, first, last


def check_microbatches(out, card, cfg=None, aux_weight=None):
    """One more step from the trained state at 2 microbatches against the
    same step at 1: loss, grad_norm and every parameter (under ``cfg``,
    the trained config unless given, and ``aux_weight``)."""
    cfg, state = cfg or out["cfg"], out["state"]
    opt = make_optimizer(cfg.optimizer, warmup_cosine_lr(TRAIN_LR, 20, TRAIN_STEPS))
    batch = {"tokens": train_launcher.token_stream(cfg, steps=1, batch=TRAIN_BATCH,
                                                   seq=TRAIN_SEQ, seed=1)}
    one, m1 = make_train_step(cfg, opt, aux_weight=aux_weight)(state, batch)
    two, m2 = make_train_step(cfg, opt, microbatches=2, aux_weight=aux_weight)(state, batch)
    worst = 0.0
    want = dict(tree_leaves_with_path(one["params"]))
    for key, b in tree_leaves_with_path(two["params"]):
        worst = max(worst, (b - want[key]).abs().max().item())
    del one, two, want
    d_loss = abs(float(m2["loss"]) / float(m1["loss"]) - 1)
    d_norm = abs(float(m2["grad_norm"]) / float(m1["grad_norm"]) - 1)
    print(f"[train] {cfg.name}: a step at 2 microbatches vs 1: loss {float(m1['loss']):.6f} "
          f"rel d {d_loss:.2e}, grad_norm {float(m1['grad_norm']):.6f} rel d {d_norm:.2e} "
          f"(bound {MB_RTOL:g}); params max|d| {worst:.3e} (bound {MB_ATOL:g}); on {card}")
    check(d_loss <= MB_RTOL and d_norm <= MB_RTOL, "microbatched loss or grad_norm differs")
    check(worst <= MB_ATOL, f"microbatched step's params differ by {worst:.3e}")


def serve_trained(cfg, npz, trained, kernel, card):
    """Load the saved params, run the eval step, then an Engine over them
    (launches counted around ``generate`` and checked by route); then hold
    the kernel path's prefill logits against the differentiable forward's.
    Returns the launches of the eval step and the generate."""
    dev = torch.device("cuda")
    params = ckpt.load(npz, device=dev)
    saved = dict(tree_leaves_with_path(params))
    check(all(torch.equal(saved[k], v) for k, v in tree_leaves_with_path(trained)),
          f"{cfg.name}: the saved npz does not load back to the trained params")
    stream = train_launcher.token_stream(cfg, steps=2, batch=TRAIN_BATCH, seq=TRAIN_SEQ, seed=2)
    routes = {"flash_attention": flash_attention, "rwkv6_scan": rwkv6_scan}[kernel]
    reset_launches()
    loss = float(make_eval_step(cfg)(params, {"tokens": stream[:TRAIN_BATCH]}))
    evals = launches()
    eval_routes = dict(routes.launches_by_route)
    prompts = stream[TRAIN_BATCH:TRAIN_BATCH + TRAIN_PROMPTS]
    eng = Engine(cfg, params, max_len=TRAIN_SEQ + TRAIN_NEW)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = eng.generate(prompts, max_new_tokens=TRAIN_NEW)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    gens = launches()
    by_route = dict(routes.launches_by_route)
    # one prefill launch per layer (f32: the FMA route), one decode launch
    # per layer and new token after the first (plus flash_attention's
    # combine kernel beside each)
    n, steps = cfg.num_layers, cfg.num_layers * (TRAIN_NEW - 1)
    want_eval = dict.fromkeys(by_route, 0)
    if kernel == "flash_attention":
        want_eval["prefill_fma"] = n
        want_gen = dict(want_eval, decode=steps, decode_combine=steps)
    else:
        want_eval["scan"] = n
        want_gen = dict(want_eval, step=steps)
    check(eval_routes == want_eval, f"{cfg.name} eval step: {kernel} launched {eval_routes} by "
          f"route, expected {want_eval}")
    check(by_route == want_gen, f"{cfg.name} generate: {kernel} launched {by_route} by route, "
          f"expected {want_gen}")
    check(math.isfinite(loss) and res.tokens.shape == (TRAIN_PROMPTS, TRAIN_SEQ + TRAIN_NEW),
          f"{cfg.name}: eval loss {loss} or generate shape {res.tokens.shape}")
    with torch.inference_mode():
        toks = torch.as_tensor(prompts, dtype=torch.long, device=dev)
        kern, _, _ = forward_lm(cfg, params, toks, cache=init_cache(cfg, TRAIN_PROMPTS,
                                                                    TRAIN_SEQ + TRAIN_NEW,
                                                                    device=dev), cache_index=0)
        diff, _, _ = forward_lm(cfg, params, toks, differentiable=True)
        d = (kern - diff).abs().max().item()
        scale = max(1.0, diff.abs().max().item())
        d_loss = abs(float(lm_loss(diff, toks)) - float(lm_loss(kern, toks)))
    del kern, diff
    check(d <= LOGIT_RTOL * scale, f"{cfg.name}: the Engine's prefill logits differ from the "
          f"differentiable forward's by {d:.3g} > {LOGIT_RTOL:g} x {scale:.3g}")
    print(f"[train] {cfg.name} served from the saved npz: eval loss {loss:.4f}; Engine "
          f"{TRAIN_PROMPTS} x {TRAIN_SEQ} -> {TRAIN_NEW} in {gen_s:.3f} s; {kernel} by route "
          f"in the eval step {eval_routes}, in generate {by_route} (expected {want_gen}); "
          f"prefill logits, kernels vs the differentiable forward: max|d| {d:.3g} (bound "
          f"{LOGIT_RTOL:g} x max(1, max|logit|) = {LOGIT_RTOL * scale:.3g}), loss |d| "
          f"{d_loss:.3g}; first tokens {res.tokens[0, TRAIN_SEQ:].tolist()}; on {card}")
    del params, eng
    return evals, gens


def run_twins(card):
    """Every example twin on the card, all started together: each must exit
    0 and print its healthy lines."""
    here = os.path.dirname(os.path.abspath(__file__))
    # the processes share the host's few cores: one CPU thread each
    env = dict(os.environ, OMP_NUM_THREADS="1")
    t0 = time.perf_counter()
    procs = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke-twins-") as tmp:
        for i, (script, args, _) in enumerate(TWINS):
            log = open(os.path.join(tmp, f"{i}.log"), "w+")
            cmd = [sys.executable, os.path.join(here, "examples", script), *args]
            if script.startswith("cold_service"):
                cmd += ["--root", os.path.join(tmp, f"root{i}")]
            procs.append((cmd, log, subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                                                     cwd=here, env=env)))
        failed = []
        for (cmd, log, proc), (script, args, healthy) in zip(procs, TWINS):
            try:
                rc = proc.wait(timeout=max(1.0, 400 - (time.perf_counter() - t0)))
            except subprocess.TimeoutExpired:
                proc.kill()
                rc = proc.wait()
            log.seek(0)
            text = log.read()
            log.close()
            missing = [h for h in healthy if h not in text]
            tail = [ln for ln in text.splitlines() if ln.strip()][-2:]
            print(f"[twins] {script} {' '.join(args)}: rc {rc}, "
                  f"{'healthy' if not missing else f'missing {missing}'}; {' | '.join(tail)}")
            if rc != 0 or missing:
                failed.append(script)
                print(text[-4000:])
    print(f"[twins] {len(TWINS)} runs of the 5 twins on the card together: "
          f"{time.perf_counter() - t0:.1f} s on {card}")
    check(not failed, f"example twins failed on the card: {failed}")


def phase_lm_train(workdir, card):
    """Phase 12: gemma3-1b trained at full width through the launcher, a
    microbatched step held against the plain one, the saved params served;
    reduced rwkv6-7b trained and served; the five example twins.  Returns
    the launches of the eval steps and the generates, summed."""
    t0 = time.perf_counter()
    total = train_and_serve("gemma3-1b", workdir, card)

    npz = os.path.join(workdir, "rwkv6-7b-trained.npz")
    out, _, _ = train_via_launcher(
        ["--arch", "rwkv6-7b", "--reduced", "--steps", str(TRAIN_STEPS), "--log-every", "10",
         "--save", npz], card)
    for counts in serve_trained(out["cfg"], npz, out["state"]["params"], "rwkv6_scan", card):
        total = {k: total[k] + counts[k] for k in total}
    del out
    torch.cuda.empty_cache()
    print(f"[train] launches of the eval steps and generates: {total}; phase "
          f"{time.perf_counter() - t0:.1f} s before the twins, on {card}")
    run_twins(card)
    return total


# ---------------------------------------------------------------------------
# slice 9: the MoE family and the dense archs (phase 13)
# ---------------------------------------------------------------------------

DENSE_ARCHS = ("mistral-nemo-12b", "stablelm-12b", "granite-20b")


def serve_routes(cfg, prompt_len, new_tokens):
    """flash_attention's launches by route over ``launch.serve.main`` and
    ``Engine.generate`` (two bf16 generates), worked out from the code: one
    launch per attention layer for the prefill, one per attention layer and
    new token after the first, each on the route ``flash_attention.route``
    names for its shape (with the decode route's combine beside it)."""
    n = sum(b.mixer == "attn" for b in cfg.blocks)
    steps = n * (new_tokens - 1)
    want = dict.fromkeys(fa_mod.ROUTES + ("decode_combine",), 0)
    want[fa_mod.route(torch.bfloat16, prompt_len, cfg.num_heads, cfg.num_kv_heads)] += 2 * n
    dec = fa_mod.route(torch.bfloat16, 1, cfg.num_heads, cfg.num_kv_heads)
    want[dec] += 2 * steps
    if dec == "decode":
        want["decode_combine"] += 2 * steps
    return want


def serve_arch(arch, cfg, prompt_len, new_tokens, max_len, card, table, cli=()):
    """``phase_serve`` with launches exact by route; the arch's row of the
    table.  Returns its launches."""
    n, routes, res = phase_serve(arch, cfg, prompt_len, new_tokens, max_len, "flash_attention",
                                 card, serve_routes(cfg, prompt_len, new_tokens), cli)
    table.append(arch_row(arch, cfg, res["params"], routes, f"4 x {prompt_len} -> {new_tokens}",
                          res["prefill_ms"], res["decode_ms"], res["peak_gib"]))
    return n


def profile_train_step(out, card):
    """For a model with MoE layers: one more train step from the trained
    state under ``torch.profiler`` (the kernels' device time against the
    launcher's median step); the step split by CUDA events at
    ``grad_sync`` into the gradient (forward and backward) and what
    follows it (clipping, the optimizer's update, the add); and one
    layer's MoE forward and backward alone (at the step's 8 x 64 tokens in
    f32, on the first MoE layer's trained weights and a unit-scale input)."""
    cfg, state = out["cfg"], out["state"]
    opt = make_optimizer(cfg.optimizer, warmup_cosine_lr(TRAIN_LR, 20, TRAIN_STEPS))
    step = make_train_step(cfg, opt)
    batch = {"tokens": train_launcher.token_stream(cfg, steps=1, batch=TRAIN_BATCH,
                                                   seq=TRAIN_SEQ, seed=3)}
    wall = float(np.median(out["step_s"][1:])) * 1e3
    print_split(cfg.name, f"a train step ({TRAIN_BATCH} x {TRAIN_SEQ}, f32)", wall,
                device_split(lambda: step(state, batch)))
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]

    def mark(grads):
        ev[1].record()
        return grads

    marked = make_train_step(cfg, opt, grad_sync=mark)
    split = []
    for _ in range(4):
        ev[0].record()
        marked(state, batch)
        ev[2].record()
        torch.cuda.synchronize()
        split.append((ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])))
    g_ms = float(np.median([a for a, _ in split[1:]]))
    u_ms = float(np.median([b for _, b in split[1:]]))
    print(f"[profile] {cfg.name} train step split at grad_sync (CUDA events, median of 3 after "
          f"a warm-up, on {card}): gradient (forward and backward) {g_ms:.1f} ms, then clip, "
          f"{cfg.optimizer} update and add {u_ms:.1f} ms (runs "
          f"{[(round(a, 1), round(b, 1)) for a, b in split]})")
    n_moe = sum(b.ffn == "moe" for b in cfg.blocks)
    dev = torch.device("cuda")
    p0 = {k: v[0].detach().clone().requires_grad_(True)
          for k, v in state["params"]["scan"]["pos0"]["moe"].items()}
    g = torch.Generator(device=dev).manual_seed(4)
    h = torch.randn((TRAIN_BATCH, TRAIN_SEQ, cfg.d_model), generator=g,
                    device=dev).requires_grad_(True)

    def fwd_bwd():
        with torch.enable_grad():
            y, aux = moe_mod.moe_fwd(cfg, p0, h)
            torch.autograd.grad(y.sum() + aux, [h, *p0.values()])

    t, runs = median_windows(fwd_bwd, iters=3, warmup=1)
    print(f"[profile] {cfg.name} MoE FFN forward and backward alone ({TRAIN_BATCH} x "
          f"{TRAIN_SEQ} tokens, f32; CUDA events on {card}): one layer {t:.3f} ms (windows "
          f"{[round(r, 3) for r in runs]}), x {n_moe} layers = {t * n_moe:.1f} ms of the "
          f"{wall:.1f} ms step")


def train_and_serve(arch, workdir, card, extra=()):
    """``launch.train.main`` for TRAIN_STEPS steps (f32, AdamW), a step at 2
    microbatches against 1, in a model with MoE layers one more step
    profiled (``profile_train_step``), then the saved npz served
    (``serve_trained``).
    Returns the launches of the eval step and the generate, summed.

    In a model with MoE layers the microbatch check holds the gradient
    accumulation at capacity_factor E / k, where no token drops in either
    step, and with the aux weight at 0.  By the reference's design both
    differ otherwise: at granite-moe's
    1.25, 512 tokens share 160 slots per expert and each half of them 80;
    and the load-balance loss is a product of two batch means (f_e, p_e),
    so its mean over two halves is not the whole batch's (a 3e-3 relative
    grad_norm difference on an H100)."""
    npz = os.path.join(workdir, f"{arch}-trained.npz")
    out, first, last = train_via_launcher(
        ["--arch", arch, *extra, "--steps", str(TRAIN_STEPS), "--log-every", "10",
         "--save", npz], card)
    check(last < first, f"{arch}: the loss did not fall ({first:.4f} -> {last:.4f})")
    cfg = out["cfg"]
    if cfg.moe.num_experts:
        no_drop = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.experts_per_token))
        check_microbatches(out, card, cfg=no_drop, aux_weight=0.0)
        profile_train_step(out, card)
    else:
        check_microbatches(out, card)
    trained = out["state"]["params"]
    del out
    torch.cuda.empty_cache()
    total = dict.fromkeys(launches(), 0)
    for counts in serve_trained(cfg, npz, trained, "flash_attention", card):
        total = {k: total[k] + counts[k] for k in total}
    del trained
    torch.cuda.empty_cache()
    return total


def phase_archs(workdir, card):
    """Phase 13: granite-moe-1b-a400m served (4 x 1024 -> 32) and trained
    (30 steps, f32) at full width, reduced mixtral-8x7b trained and served,
    and mistral-nemo-12b, stablelm-12b and granite-20b served at full width
    (4 x 256 -> 16), one at a time.  Returns every kernel's launches over
    the phase and the arch table."""
    t0 = time.perf_counter()
    total = dict.fromkeys(launches(), 0)
    table = []
    total["flash_attention"] += serve_arch(MOE_ARCH, GRANITE_MOE, GEMMA_PROMPT, SERVE_NEW,
                                           MOE_MAX_LEN, card, table)
    for arch, extra in ((MOE_ARCH, ()), ("mixtral-8x7b", ("--reduced",))):
        counts = train_and_serve(arch, workdir, card, extra)
        total = {k: total[k] + counts[k] for k in total}
    for arch in DENSE_ARCHS:
        total["flash_attention"] += serve_arch(arch, get_config(arch), DENSE_PROMPT, DENSE_NEW,
                                               DENSE_PROMPT + DENSE_NEW, card, table)
    print(f"[archs] launches over the phase: {total}; {time.perf_counter() - t0:.1f} s on {card}")
    return total, table


# ---------------------------------------------------------------------------
# slice 10: the last three archs and the ring cache (phase 14)
# ---------------------------------------------------------------------------


def whisper_routes(cfg, dtype, prompt_len, new_tokens, n_frames):
    """flash_attention's launches by route over one whisper generate,
    worked out from the code: one encoder launch per encoder layer (Sq =
    Sk = n_frames, bidirectional), then per decoder layer and decoder call
    (the prompt, then one token a step) a self-attention and a
    cross-attention launch, each on the route its shape takes."""
    want = dict.fromkeys(fa_mod.ROUTES + ("decode_combine",), 0)
    want[fa_mod.route(dtype, n_frames, cfg.num_heads, cfg.num_kv_heads)] += cfg.encoder_layers
    for sq in [prompt_len] + [1] * (new_tokens - 1):
        want[fa_mod.route(dtype, sq, cfg.num_heads, cfg.num_kv_heads)] += 2 * cfg.num_layers
    want["decode_combine"] = want["decode"]
    return want


def whisper_primed(cfg, params, frames, batch, max_len):
    """``whisper_encode`` and ``prime_cross_cache`` into a fresh cache."""
    cache = whisper_mod.init_whisper_cache(cfg, batch, max_len, device=frames.device)
    return whisper_mod.prime_cross_cache(cfg, params, cache,
                                         whisper_mod.whisper_encode(cfg, params, frames))


@torch.inference_mode()
def whisper_generate(cfg, params, frames, prompts, new_tokens, max_len):
    """Greedy whisper decoding as a user drives it: encode, prime, the
    prompt through ``make_serve_step`` at 0, then one serve step a token.
    Returns the new tokens [B, new_tokens]."""
    B, P = prompts.shape
    cache = whisper_primed(cfg, params, frames, B, max_len)
    serve = make_serve_step(cfg)
    lg, cache = serve(params, cache, torch.as_tensor(prompts, dtype=torch.long,
                                                     device=frames.device), 0)
    out = [torch.argmax(lg, dim=-1)]
    for t in range(1, new_tokens):
        lg, cache = serve(params, cache, out[-1][:, None], P + t - 1)
        out.append(torch.argmax(lg, dim=-1))
    return torch.stack(out, 1).cpu().numpy()


@torch.inference_mode()
def whisper_teacher_forced(cfg, params, frames, prompts, gen_tokens, max_len):
    """(prompt logits [B, P, V] from ``whisper_decode``, decode logits
    [B, n-1, V]) with the serve steps fed the given generated tokens."""
    dev = frames.device
    B, P = prompts.shape
    cache = whisper_primed(cfg, params, frames, B, max_len)
    toks = torch.as_tensor(prompts, dtype=torch.long, device=dev)
    pre, _, cache = whisper_mod.whisper_decode(cfg, params, toks, cache=cache, cache_index=0)
    serve = make_serve_step(cfg)
    gen = torch.as_tensor(gen_tokens, dtype=torch.long, device=dev)
    dec = [serve(params, cache, gen[:, t - 1:t], P + t - 1)[0] for t in range(1, gen.shape[1])]
    return pre, torch.stack(dec, 1)


def timed_ms(fn, runs: int = 3):
    """(median, all) wall ms of ``runs`` synchronised calls of ``fn``."""
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times)), times


def arch_row(arch, cfg, n_params, routes, prompt, pre_ms, dec_ms, peak):
    """One row of an arch table (bf16 GiB of the parameters, the routes
    flash_attention took)."""
    return {"arch": arch, "layers": cfg.num_layers, "params": n_params,
            "param_count": cfg.param_count(), "head_dim": cfg.head_dim,
            "gib_bf16": round(n_params * 2 / 2 ** 30, 2),
            "routes": sorted(r for r in fa_mod.ROUTES if routes[r]), "prompt": prompt,
            "prefill_ms": round(pre_ms, 3), "decode_ms": round(dec_ms, 3),
            "peak_gib": round(peak, 2)}


def serve_whisper(card, table):
    """whisper-tiny whole in bf16: seeded frame embeddings, a prompt and
    greedy decoding through the serve step, launches exact by route, the
    times, one profile, and the teacher-forced comparison with the plain
    versions.  Returns the launches."""
    dev = torch.device("cuda")
    cfg, arch = WHISPER, WHISPER.name
    B, P, new = WHISPER_BATCH, WHISPER_PROMPT, WHISPER_NEW
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = whisper_mod.init_whisper(cfg, gen, device=dev)
    n_params = sum(x.numel() for x in tree_leaves(params))
    frames = torch.randn((B, cfg.encoder_seq, cfg.d_model), generator=gen,
                         device=dev).to(torch.bfloat16)
    prompts = np.random.default_rng(1).integers(3, cfg.vocab_size, (B, P))
    max_len = P + new
    want = whisper_routes(cfg, torch.bfloat16, P, new, cfg.encoder_seq)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gen_k = whisper_generate(cfg, params, frames, prompts, new, max_len)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    counts = launches()
    by_route = dict(flash_attention.launches_by_route)
    check(by_route == want, f"{arch}: flash_attention launched {by_route} by route, expected "
          f"exactly {want}")
    check(gen_k.shape == (B, new), f"{arch}: generated {gen_k.shape}")

    def prefill():  # encode, prime and the prompt's serve step
        whisper_generate(cfg, params, frames, prompts, 1, max_len)

    pre_ms, pre_runs = timed_ms(prefill)
    gen_ms, gen_runs = timed_ms(lambda: whisper_generate(cfg, params, frames, prompts, new,
                                                         max_len))
    dec_ms = (gen_ms - pre_ms) / (new - 1)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[archs2] {arch} (encoder {cfg.encoder_layers} + decoder {cfg.num_layers} layers, d "
          f"{cfg.d_model}, {cfg.num_heads} heads of {cfg.head_dim}, {cfg.encoder_seq} frames, "
          f"vocab {cfg.vocab_size}; {n_params:,} parameters in the tree, {cfg.param_count():,} "
          f"by param_count) bf16: {B} x {cfg.encoder_seq} frames, {B} x {P} prompt -> {new} "
          f"tokens, first run {first_s:.2f} s; flash_attention by route {by_route} (exactly as "
          f"worked out from the code); encode + prime + prompt {pre_ms:.2f} ms (runs "
          f"{[round(x, 2) for x in pre_runs]}), generate {gen_ms:.1f} ms (runs "
          f"{[round(x, 1) for x in gen_runs]}), decode {dec_ms:.2f} ms a step; peak {peak:.2f} "
          f"GiB; on {card}")
    print_split(arch, f"a whole generate ({B} x {cfg.encoder_seq} frames, {P} -> {new})", gen_ms,
                device_split(lambda: whisper_generate(cfg, params, frames, prompts, new,
                                                      max_len)))
    serve_agreement(arch, cfg, lambda: whisper_teacher_forced(cfg, params, frames, prompts,
                                                              gen_k, max_len), gen_k)
    table.append(arch_row(arch, cfg, n_params, by_route, f"{B} x {cfg.encoder_seq} frames, "
                          f"{P} -> {new}", pre_ms, dec_ms, peak))
    del params, frames
    torch.cuda.empty_cache()
    return counts


def train_whisper(workdir, card):
    """whisper-tiny trained at full size in f32 through the launcher (zero
    frames, as the reference's launcher feeds them), then its npz served:
    the eval step and a generate with launches exact by route.  Returns
    their launches, summed."""
    dev = torch.device("cuda")
    npz = os.path.join(workdir, "whisper-trained.npz")
    out, first, last = train_via_launcher(["--arch", WHISPER.name, "--steps", str(TRAIN_STEPS),
                                           "--log-every", "10", "--save", npz], card)
    check(last < first, f"whisper-tiny: the loss did not fall ({first:.4f} -> {last:.4f})")
    cfg = out["cfg"]
    params = ckpt.load(npz, device=dev)
    saved = dict(tree_leaves_with_path(params))
    check(all(torch.equal(saved[k], v) for k, v in tree_leaves_with_path(out["state"]["params"])),
          "whisper-tiny: the saved npz does not load back to the trained params")
    del out
    torch.cuda.empty_cache()
    stream = train_launcher.token_stream(cfg, steps=1, batch=TRAIN_BATCH, seq=TRAIN_SEQ, seed=2)
    reset_launches()
    loss = float(make_eval_step(cfg)(params, train_launcher.train_batch(cfg, stream)))
    evals = launches()
    eval_routes = dict(flash_attention.launches_by_route)
    want_eval = whisper_routes(cfg, torch.float32, TRAIN_SEQ, 1, cfg.encoder_seq)
    check(eval_routes == want_eval, f"whisper-tiny eval step: flash_attention launched "
          f"{eval_routes} by route, expected {want_eval}")
    gen = torch.Generator(device=dev).manual_seed(3)
    frames = torch.randn((TRAIN_PROMPTS, cfg.encoder_seq, cfg.d_model), generator=gen, device=dev)
    prompts = stream[:TRAIN_PROMPTS, :WHISPER_PROMPT]
    reset_launches()
    toks = whisper_generate(cfg, params, frames, prompts, TRAIN_NEW, WHISPER_PROMPT + TRAIN_NEW)
    gens = launches()
    by_route = dict(flash_attention.launches_by_route)
    want = whisper_routes(cfg, torch.float32, WHISPER_PROMPT, TRAIN_NEW, cfg.encoder_seq)
    check(by_route == want, f"whisper-tiny generate (f32): flash_attention launched {by_route} "
          f"by route, expected {want}")
    check(math.isfinite(loss), f"whisper-tiny eval loss {loss}")
    print(f"[archs2] whisper-tiny served from the saved npz (f32): eval loss {loss:.4f} (8 x 64 "
          f"tokens, zero frames), flash_attention by route in the eval step {eval_routes}; "
          f"generate {TRAIN_PROMPTS} x {WHISPER_PROMPT} -> {TRAIN_NEW} {by_route} (expected "
          f"{want}); first tokens {toks[0].tolist()}; on {card}")
    del params
    torch.cuda.empty_cache()
    return {k: evals[k] + gens[k] for k in evals}


def qwen_vision_inputs(cfg, gen):
    """4 prompts: QWEN_PATCHES seeded patch embeddings (N(0, 0.02^2), the
    token embeddings' scale) on a 16 x 16 grid at t = 0, h = row, w = col,
    then QWEN_TEXT text tokens at positions 16.. on all three streams.
    Returns (tokens [4, S], positions [3, 4, S], extra_embeds)."""
    dev = torch.device("cuda")
    side = int(round(QWEN_PATCHES ** 0.5))
    pos = torch.zeros((3, 4, QWEN_LEN), dtype=torch.long, device=dev)
    grid = torch.arange(QWEN_PATCHES, device=dev)
    pos[1, :, :QWEN_PATCHES] = grid // side
    pos[2, :, :QWEN_PATCHES] = grid % side
    pos[:, :, QWEN_PATCHES:] = side + torch.arange(QWEN_TEXT, device=dev)
    extra = (0.02 * torch.randn((4, QWEN_PATCHES, cfg.d_model), generator=gen,
                                device=dev)).to(torch.bfloat16)
    tokens = torch.as_tensor(np.random.default_rng(2).integers(3, cfg.vocab_size, (4, QWEN_LEN)),
                             device=dev)
    return tokens, pos, extra


def serve_qwen(card, table):
    """qwen2-vl-72b at full width, its first QWEN_LAYERS layers, bf16: the
    vision prefill through ``forward_lm(cache=, cache_index=0, positions=,
    extra_embeds=)`` and QWEN_STEPS greedy serve steps (positions following
    cache_index, as in the reference), launches exact by route, the times,
    the teacher-forced comparison with the plain versions, and a text-only
    prefill equal to the same model's under ordinary RoPE.  Returns the
    launches."""
    dev = torch.device("cuda")
    cfg, arch = QWEN, QWEN.name
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    params = init_lm(cfg, gen, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(x.numel() for x in tree_leaves(params))
    check(n_params == cfg.param_count(), f"{arch}: {n_params} parameters, param_count says "
          f"{cfg.param_count()}")
    tokens, pos, extra = qwen_vision_inputs(cfg, gen)
    max_len = QWEN_LEN + QWEN_STEPS + 1
    serve = make_serve_step(cfg)

    @torch.inference_mode()
    def vision_generate(steps):
        cache = init_cache(cfg, 4, max_len, device=dev)
        lg, _, cache = forward_lm(cfg, params, tokens, cache=cache, cache_index=0, positions=pos,
                                  extra_embeds=extra)
        out = [torch.argmax(lg[:, -1], dim=-1)]
        for t in range(steps):
            lg, cache = serve(params, cache, out[-1][:, None], QWEN_LEN + t)
            out.append(torch.argmax(lg, dim=-1))
        return torch.stack(out, 1).cpu().numpy()

    reset_launches()
    gen_k = vision_generate(QWEN_STEPS)
    counts = launches()
    by_route = dict(flash_attention.launches_by_route)
    want = dict.fromkeys(by_route, 0)
    want[fa_mod.route(torch.bfloat16, QWEN_LEN, cfg.num_heads, cfg.num_kv_heads)] += \
        cfg.num_layers
    want["decode"] = want["decode_combine"] = cfg.num_layers * QWEN_STEPS
    check(by_route == want, f"{arch}: flash_attention launched {by_route} by route, expected "
          f"exactly {want}")
    pre_ms, pre_runs = timed_ms(lambda: vision_generate(0))
    gen_ms, gen_runs = timed_ms(lambda: vision_generate(QWEN_STEPS))
    dec_ms = (gen_ms - pre_ms) / QWEN_STEPS
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[archs2] {arch} cut to {cfg.num_layers} of 80 layers (d {cfg.d_model}, "
          f"{cfg.num_heads} query heads on {cfg.num_kv_heads} kv heads of {cfg.head_dim}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_size}, M-RoPE sections {cfg.rope.mrope_sections}; "
          f"{n_params:,} parameters bf16, init {init_s:.2f} s): vision prefill 4 x "
          f"({QWEN_PATCHES} patches + {QWEN_TEXT} text) {pre_ms:.2f} ms (runs "
          f"{[round(x, 2) for x in pre_runs]}), {QWEN_STEPS} serve steps, generate {gen_ms:.1f} "
          f"ms (runs {[round(x, 1) for x in gen_runs]}), decode {dec_ms:.2f} ms a step; "
          f"flash_attention by route {by_route} (exactly as worked out from the code); peak "
          f"{peak:.2f} GiB; on {card}")
    print_split(arch, f"the vision prefill 4 x {QWEN_LEN}", pre_ms,
                device_split(lambda: vision_generate(0)))
    serve_agreement(arch, cfg, lambda: teacher_forced(cfg, params, tokens, gen_k, max_len,
                                                      positions=pos, extra_embeds=extra), gen_k)
    rope = dataclasses.replace(cfg, rope=dataclasses.replace(cfg.rope, kind="default"))
    with torch.inference_mode():
        text = tokens[:, QWEN_PATCHES:]
        a = forward_lm(cfg, params, text)[0]
        b = forward_lm(rope, params, text)[0]
        same = bool(torch.equal(a, b))
        d = (a.float() - b.float()).abs().max().item()
    del a, b
    check(same, f"{arch}: text-only M-RoPE logits differ from ordinary RoPE's by {d:.3g}")
    print(f"[archs2] {arch} text-only prefill (4 x {QWEN_TEXT}, t = h = w): logits equal to the "
          f"same model's under rope kind 'default' bit for bit")
    table.append(arch_row(arch, cfg, n_params, by_route, f"4 x ({QWEN_PATCHES} patches + "
                          f"{QWEN_TEXT} text) -> {QWEN_STEPS + 1}", pre_ms, dec_ms, peak))
    del params
    torch.cuda.empty_cache()
    return counts


def mamba_layer_check(card):
    """One Mamba layer at jamba's full width (d 8192, d_inner 16,384,
    d_state 16, dt_rank 512) in bf16: a 272-token forward against 256
    positions and 16 one-token steps carrying the state."""
    dev = torch.device("cuda")
    cfg = JAMBA
    gen = torch.Generator(device=dev).manual_seed(6)
    p = mamba_mod.init_mamba(cfg, gen, torch.bfloat16, dev)
    n = DENSE_PROMPT + DENSE_NEW
    x = torch.randn((4, n, cfg.d_model), generator=gen, device=dev).to(torch.bfloat16)
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        whole, _ = mamba_mod.mamba_fwd(cfg, p, x)
        torch.cuda.synchronize()
        whole_ms = (time.perf_counter() - t0) * 1e3
        state = mamba_mod.init_mamba_state(cfg, 4, torch.bfloat16, dev)
        parts = []
        y, state = mamba_mod.mamba_fwd(cfg, p, x[:, :DENSE_PROMPT], state=state,
                                       return_state=True)
        parts.append(y)
        for t in range(DENSE_PROMPT, n):
            y, state = mamba_mod.mamba_fwd(cfg, p, x[:, t:t + 1], state=state, return_state=True)
            parts.append(y)
        steps = torch.cat(parts, 1).float()
    ref = whole.float()
    err = (steps - ref).abs()
    top = ref.abs().max()
    tol = MAMBA_ULPS * bf16_ulp(top).item()
    check(bool(torch.isfinite(steps).all()) and err.max().item() <= tol,
          f"Mamba layer: incremental vs one forward max|d| {err.max().item():.3g} > {tol:.3g}")
    print(f"[archs2] one Mamba layer at full width (d {cfg.d_model}, d_inner "
          f"{mamba_mod.d_inner(cfg)}, d_state {cfg.ssm.d_state}, dt_rank {cfg.ssm.dt_rank}) bf16, "
          f"4 x {n}: one forward ({whole_ms:.1f} ms) vs {DENSE_PROMPT} + {DENSE_NEW} one-token "
          f"steps: max|d| {err.max().item():.3g}, mean|d| {err.mean().item():.3g} (bound "
          f"{MAMBA_ULPS} bf16 ulps of max|y| {top.item():.3g} = {tol:.3g}); on {card}")
    del p, x, whole, steps, ref, err
    torch.cuda.empty_cache()


def ring_agreement(cfg, params, prompts, gen_full, max_len):
    """Teacher-forced on the full-cache run's tokens: the ring cache's
    logits against the full cache's (both on the kernel), within 4x those
    between the plain path and its nudged run (phase 9's rule)."""
    def run():
        return teacher_forced(cfg, params, prompts, gen_full, max_len)

    saved = tt_mod.RING_CACHE
    try:
        tt_mod.RING_CACHE = True
        pre_r, dec_r = run()
        tt_mod.RING_CACHE = False
        pre_f, dec_f = run()
        with plain_kernels():
            pre_p, dec_p = run()
        with plain_kernels(nudge=NUDGE):
            pre_n, dec_n = run()
    finally:
        tt_mod.RING_CACHE = saved
    floor_pre, floor_dec = logit_diff(pre_n, pre_p), logit_diff(dec_n, dec_p)
    del pre_n, dec_n, pre_p, dec_p
    a_pre = logits_agreement(pre_r, pre_f, floor_pre, "ring vs full cache prefill logits")
    a_dec = logits_agreement(dec_r, dec_f, floor_dec, "ring vs full cache decode logits")
    d_wrap = logit_diff(dec_r[:, 128:], dec_f[:, 128:])
    return a_pre, a_dec, floor_pre, floor_dec, d_wrap


def ring_cache(card):
    """gemma3-1b at full width, 4 x RING_PROMPT -> RING_NEW through
    ``Engine.generate`` with ``RING_CACHE`` on, then off: launches exact
    by route over both, tokens, both caches' bytes, and the teacher-forced
    logits of the two under phase 9's rule.  Returns the launches."""
    dev = torch.device("cuda")
    cfg = GEMMA
    params = init_lm(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    prompts = np.random.default_rng(4).integers(3, cfg.vocab_size, (4, RING_PROMPT))
    max_len = RING_PROMPT + RING_NEW
    saved = tt_mod.RING_CACHE
    res, secs, nbytes = {}, {}, {}
    reset_launches()
    try:
        for ring in (True, False):
            tt_mod.RING_CACHE = ring
            nbytes[ring] = sum(x.numel() * x.element_size()
                               for x in tree_leaves(init_cache(cfg, 4, max_len, device=dev)))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res[ring] = Engine(cfg, params, max_len=max_len).generate(prompts,
                                                                      max_new_tokens=RING_NEW)
            torch.cuda.synchronize()
            secs[ring] = time.perf_counter() - t0
    finally:
        tt_mod.RING_CACHE = saved
    counts = launches()
    by_route = dict(flash_attention.launches_by_route)
    want = serve_routes(cfg, RING_PROMPT, RING_NEW)  # two generates, as phase 9's
    check(by_route == want, f"ring cache: flash_attention launched {by_route} by route, "
          f"expected exactly {want}")
    gen_full = res[False].tokens[:, RING_PROMPT:]
    same = int((res[True].tokens == res[False].tokens).all(axis=0)[RING_PROMPT:].sum())
    a_pre, a_dec, f_pre, f_dec, d_wrap = ring_agreement(cfg, params, prompts, gen_full, max_len)
    print(f"[archs2] gemma3-1b ring cache (local layers' window {GEMMA_WINDOW}), 4 x "
          f"{RING_PROMPT} -> {RING_NEW} (the rings wrap after decode step "
          f"{GEMMA_WINDOW - RING_PROMPT}): cache {nbytes[True] / 2 ** 20:.1f} MiB with the ring, "
          f"{nbytes[False] / 2 ** 20:.1f} MiB without; generate {secs[True]:.2f} s / "
          f"{secs[False]:.2f} s; flash_attention by route over both {by_route} (exactly as worked "
          f"out from the code); tokens equal at {same} of {RING_NEW} positions in all 4 rows; "
          f"teacher-forced ring vs full: prefill max|d| {a_pre[0]:.4g} mean|d| {a_pre[1]:.3g}, "
          f"decode max|d| {a_dec[0]:.4g} mean|d| {a_dec[1]:.3g}, after the wrap max|d| "
          f"{d_wrap[0]:.4g}; the plain path nudged by {NUDGE:g} moves them by max "
          f"{f_pre[0]:.4g} / {f_dec[0]:.4g}, mean {f_pre[1]:.3g} / {f_dec[1]:.3g}, bound 4x; on "
          f"{card}")
    del params
    torch.cuda.empty_cache()
    return counts


def phase_archs2(workdir, card):
    """Phase 14: whisper-tiny served whole and trained at full size,
    qwen2-vl-72b and jamba-1.5-large-398b served at full width (cut in
    depth) and trained reduced, one Mamba layer's incremental form at full
    width, and gemma3-1b's ring cache.  Returns every kernel's launches
    over the phase and the arch table."""
    t0 = time.perf_counter()
    total = dict.fromkeys(launches(), 0)
    table = []

    def add(counts):
        for k in total:
            total[k] += counts[k]

    add(serve_whisper(card, table))
    add(train_whisper(workdir, card))
    add(serve_qwen(card, table))
    _, first, last = train_via_launcher(["--arch", QWEN.name, "--reduced", "--steps",
                                         str(TRAIN_STEPS), "--log-every", "10"], card)
    check(last < first, f"reduced qwen2-vl: the loss did not fall ({first:.4f} -> {last:.4f})")
    total["flash_attention"] += serve_arch(JAMBA_ARCH, JAMBA, DENSE_PROMPT, DENSE_NEW,
                                           DENSE_PROMPT + DENSE_NEW, card, table,
                                           cli=("--num-layers", str(JAMBA.num_layers)))
    mamba_layer_check(card)
    _, first, last = train_via_launcher(["--arch", JAMBA_ARCH, "--reduced", "--steps",
                                         str(TRAIN_STEPS), "--log-every", "10"], card)
    check(last < first, f"reduced jamba: the loss did not fall ({first:.4f} -> {last:.4f})")
    torch.cuda.empty_cache()
    add(ring_cache(card))
    print(f"[archs2] launches over the phase: {total}; {time.perf_counter() - t0:.1f} s on {card}")
    return total, table


# ---------------------------------------------------------------------------
# phase 15: the mesh-sharded Repository engine (slice 11)
# ---------------------------------------------------------------------------

MESH_S = 8                      # shards of the phase's mesh
MESH_AXES = ("model",)
# RoBERTa-base over 8 shards of the default 64 Ki block: G, shard_len, padding
MESH_ROBERTA = (65_536, 237, 15_532_032, 286_464)
MESH_GEMMA = (65_536, 1_907, 124_977_152)
MESH_CLAMPED_N = 200_000        # a clamped block (25,600: 25 tiles) for row_sketch_shard
# the service loop's queue: honest rows are the base plus MESH_NOISE x N(0, 1)
# and a tile-constant +-MESH_NOISE pattern of their own (so the novelty
# screen tells them apart at full width); the runaway adds MESH_RUNAWAY x N(0, 1)
MESH_NOISE, MESH_RUNAWAY = 1e-3, 10.0
# worked out from the code before the first card run (PERF.md): per round of
# the service loop, the sharded calls the daemon makes.  Round 1 (5 dense,
# the runaway screened out): the sketch of the base when the service starts,
# of one per-shard file without a rider sketch, of the published base; a
# fuse and its screen's re-pass; one whole-row file sketched unsharded.
# Round 2 (3 compressed, a replay): the starting and the published
# base's sketches; one compressed fuse.  Round 3 (2 rows staged): the
# starting base's sketch.
MESH_CALLS = {"row_sketch_sharded": 3 + 2 + 1, "row_sketch": 1, "fuse_flat_sharded": 2,
              "fuse_flat_compressed_sharded": 1}
MESH_LAUNCHES = {"cold_fuse": MESH_S * MESH_CALLS["fuse_flat_sharded"],
                 "decode_accum": MESH_S * MESH_CALLS["fuse_flat_compressed_sharded"],
                 "row_sketch": MESH_S * MESH_CALLS["row_sketch_sharded"] + MESH_CALLS["row_sketch"]}


def shard_rows(ss, rows):
    """``[K, N]`` -> S contiguous ``[K, shard_len]`` stacks (the staged
    cohort of a mesh repository), through one padded copy."""
    K = rows.shape[0]
    padded = rows.new_zeros((K, ss.padded_size))
    padded[:, : ss.size] = rows
    grid = padded.view(K, ss.n_super, ss.n_shards, ss.block)
    out = [grid[:, :, s, :].reshape(K, ss.shard_len) for s in range(ss.n_shards)]
    del padded, grid
    return out


def shard_payloads(ss, idx, val, scl, block):
    """Whole-row ``[C, nb, kb]`` codec arrays -> S per-shard ones, as
    ``delta_encode_sharded`` lays them out: codec blocks never straddle a
    shard block, so each is moved whole; padding blocks hold zeros."""
    C, nb, kb = idx.shape
    per = ss.block // block
    nbp = ss.padded_size // block

    def pad(a):
        out = a.new_zeros((C, nbp) + tuple(a.shape[2:]))
        out[:, :nb] = a
        return out.view((C, ss.n_super, ss.n_shards, per) + tuple(a.shape[2:]))

    gi, gv, gs = pad(idx), pad(val), pad(scl)
    return ([gi[:, :, s].reshape(C, ss.n_super * per, kb) for s in range(ss.n_shards)],
            [gv[:, :, s].reshape(C, ss.n_super * per, kb) for s in range(ss.n_shards)],
            [gs[:, :, s].reshape(C, ss.n_super * per) for s in range(ss.n_shards)])


@contextlib.contextmanager
def mesh_calls():
    """Record every sharded op call of the Repository engine with the
    launches and collectives it made (``ops.*`` wrapped for the block; a
    check and a timing call outside it do not count).  Yields the list of
    (name, deltas)."""
    names = ("fuse_flat_sharded", "fuse_flat_compressed_sharded", "row_sketch_sharded",
             "row_sketch")
    saved = {n: getattr(kops, n) for n in names}
    calls = []

    def snap():
        return {"cold_fuse": cold_fuse.launches, "decode_accum": decode_accum.launches,
                "row_sketch": row_sketch.launches, "row_sketch_shard": row_sketch_shard.launches,
                **mesh_mod.collectives}

    def wrap(name, fn):
        def wrapper(*args, **kwargs):
            before = snap()
            out = fn(*args, **kwargs)
            after = snap()
            calls.append((name, {k: after[k] - before[k] for k in after}))
            return out
        return wrapper

    for n in names:
        setattr(kops, n, wrap(n, saved[n]))
    try:
        yield calls
    finally:
        for n in names:
            setattr(kops, n, saved[n])


def check_mesh_calls(calls, S):
    """Every sharded fuse launches its kernel once a shard (``S`` a call; 0
    on the CPU, which runs the plain versions) and makes ONE all-reduce and
    no gather; every sharded sketch likewise."""
    for name, d in calls:
        if name == "row_sketch":
            check(d["row_sketch"] == min(S, 1) and d["all_reduce"] == 0 and d["all_gather"] == 0,
                  f"an unsharded sketch made {d}")
            continue
        kernel = {"fuse_flat_sharded": ("cold_fuse",), "fuse_flat_compressed_sharded":
                  ("decode_accum",), "row_sketch_sharded": ("row_sketch", "row_sketch_shard")}[name]
        check(sum(d[k] for k in kernel) == S, f"{name} launched {d}, expected {S} of {kernel}")
        check(d["all_reduce"] == 1 and d["all_gather"] == 0,
              f"{name} made {d['all_reduce']} all-reduces and {d['all_gather']} gathers, "
              "expected 1 and 0")


def phase_mesh_ops(gen, card):
    """Phase 15, part 1: the three sharded ops at full width against the
    unsharded kernels on the same inputs; returns the timing records."""
    mesh = make_mesh((MESH_S,), MESH_AXES)
    rec = {}
    # cold_fuse at RoBERTa-base width, K=5, a NaN row of weight 0
    base, contribs, w = fuse_inputs(K_MAIN, N_ROBERTA, torch.bfloat16, gen, nan_row=3)
    ss = ShardedFlatSpec.for_size(N_ROBERTA, MESH_S)
    check((ss.block, ss.n_super, ss.shard_len, ss.padded_size - N_ROBERTA) == MESH_ROBERTA,
          f"RoBERTa-base layout {ss}")
    base_s, stage_s = ss.shard_slices(base), shard_rows(ss, contribs)
    for alpha in (1.0, 0.3):
        fk, sk = cold_fuse(base, contribs, w, alpha)
        before = cold_fuse.launches
        mesh_mod.reset_collectives()
        fs, sq = kops.fuse_flat_sharded(base_s, stage_s, w, alpha, mesh=mesh, axes=MESH_AXES)
        check(cold_fuse.launches - before == MESH_S and mesh_mod.collectives ==
              {"all_reduce": 1, "all_gather": 0}, f"sharded fuse made {mesh_mod.collectives}")
        got = ss.unshard(torch.stack(fs))
        check(torch.equal(got, fk), f"sharded fused row differs from cold_fuse's (alpha {alpha})")
        r = sq_error(sq, sk)
        check(r <= 1e-5, f"sharded sq_diff rel err {r:.3g} > 1e-5")
        print(f"[mesh] fuse_flat_sharded K={K_MAIN} N={N_ROBERTA:,} bf16 over {MESH_S} shards "
              f"(block 65,536, G {ss.n_super}, shard_len {ss.shard_len:,}, padding "
              f"{ss.padded_size - N_ROBERTA:,}), alpha {alpha}: fused row equal to cold_fuse's "
              f"bit for bit, sq max rel err {r:.3g} (bound 1e-5), sq[3]={sq[3].item()}")
        del fk, sk, fs, sq, got
    nbytes = (K_MAIN + 2) * N_ROBERTA * 2 + 2 * K_MAIN * 4
    bound, by = bound_of(nbytes, 4 * K_MAIN * N_ROBERTA + 3 * N_ROBERTA)
    ms, runs = median_windows(lambda: kops.fuse_flat_sharded(base_s, stage_s, w, 1.0, mesh=mesh,
                                                             axes=MESH_AXES), iters=20)
    whole, _ = median_windows(lambda: cold_fuse(base, contribs, w, 1.0), iters=20)
    print(f"[time] fuse_flat_sharded K={K_MAIN} N={N_ROBERTA:,} bf16, {MESH_S} shards on one "
          f"card ({card}): {ms:.4f} ms (windows {[round(x, 4) for x in runs]}) against "
          f"cold_fuse unsharded {whole:.4f}, bound_ms {bound:.4f} ({by})")
    rec["cold_fuse"] = {"K": K_MAIN, "N": N_ROBERTA, "shards": MESH_S, "ms": ms,
                        "unsharded_ms": whole, "bound_ms": bound, "bound_by": by}
    del base, contribs, base_s, stage_s
    torch.cuda.empty_cache()

    # cold_fuse at gemma3-1b width, K=3
    base, contribs, w = fuse_inputs(K_SWAP, N_GEMMA, torch.bfloat16, gen)
    ss = ShardedFlatSpec.for_size(N_GEMMA, MESH_S)
    check((ss.block, ss.n_super, ss.shard_len) == MESH_GEMMA, f"gemma3-1b layout {ss}")
    base_s, stage_s = ss.shard_slices(base), shard_rows(ss, contribs)
    fk, sk = cold_fuse(base, contribs, w, 1.0)
    fs, sq = kops.fuse_flat_sharded(base_s, stage_s, w, 1.0, mesh=mesh, axes=MESH_AXES)
    check(torch.equal(ss.unshard(torch.stack(fs)), fk),
          "sharded fused row differs from cold_fuse's at gemma3-1b width")
    r = sq_error(sq, sk)
    check(r <= 1e-5, f"sharded sq_diff rel err {r:.3g} > 1e-5 at gemma3-1b width")
    del fk, sk, fs, sq
    bound, by = bound_of((K_SWAP + 2) * N_GEMMA * 2 + 2 * K_SWAP * 4,
                         4 * K_SWAP * N_GEMMA + 3 * N_GEMMA)
    ms, runs = median_windows(lambda: kops.fuse_flat_sharded(base_s, stage_s, w, 1.0, mesh=mesh,
                                                             axes=MESH_AXES), iters=5)
    whole, _ = median_windows(lambda: cold_fuse(base, contribs, w, 1.0), iters=5)
    print(f"[mesh] fuse_flat_sharded K={K_SWAP} N={N_GEMMA:,} bf16 (G {ss.n_super}, shard_len "
          f"{ss.shard_len:,}): fused row equal to cold_fuse's bit for bit, sq max rel err "
          f"{r:.3g}")
    print(f"[time] fuse_flat_sharded K={K_SWAP} N={N_GEMMA:,} bf16, {MESH_S} shards ({card}): "
          f"{ms:.4f} ms (windows {[round(x, 4) for x in runs]}) against cold_fuse unsharded "
          f"{whole:.4f}, bound_ms {bound:.4f} ({by})")
    rec["cold_fuse_gemma3_1b"] = {"K": K_SWAP, "N": N_GEMMA, "shards": MESH_S, "ms": ms,
                                  "unsharded_ms": whole, "bound_ms": bound, "bound_by": by}
    del base, contribs, base_s, stage_s
    torch.cuda.empty_cache()

    # decode_accum: C=4 compressed RoBERTa-base deltas, per shard
    ss = ShardedFlatSpec.for_size(N_ROBERTA, MESH_S)
    base = (0.05 * torch.randn(N_ROBERTA, generator=gen, device="cuda")).to(torch.bfloat16)
    idx, val, scl, wc = payloads_on_card(C_SERVICE, N_ROBERTA, CODEC_BLOCK, CODEC_KB, gen,
                                         topk=True)
    tail = N_ROBERTA - (idx.shape[1] - 1) * CODEC_BLOCK  # the last codec block's real elements
    val[:, -1][idx[:, -1].long() >= tail] = 0
    pi, pv, ps = shard_payloads(ss, idx, val, scl, CODEC_BLOCK)
    acc, sq_c = decode_accum(idx, val, scl, wc, size=N_ROBERTA, block=CODEC_BLOCK)
    parts = [decode_accum(a, b, c, wc, size=ss.shard_len, block=CODEC_BLOCK)
             for a, b, c in zip(pi, pv, ps)]
    check(torch.equal(ss.unshard(torch.stack([p[0] for p in parts])), acc),
          "per-shard decode_accum accumulators differ from the whole row's")
    del parts
    fk, sk = kops.fuse_flat_compressed(base, idx, val, scl, wc, 0.5, block=CODEC_BLOCK)
    base_s = ss.shard_slices(base)
    before = decode_accum.launches
    mesh_mod.reset_collectives()
    fs, sq = kops.fuse_flat_compressed_sharded(base_s, pi, pv, ps, wc, 0.5, mesh=mesh,
                                               axes=MESH_AXES, block=CODEC_BLOCK)
    check(decode_accum.launches - before == MESH_S and mesh_mod.collectives ==
          {"all_reduce": 1, "all_gather": 0}, f"sharded compressed fuse made {mesh_mod.collectives}")
    check(torch.equal(ss.unshard(torch.stack(fs)), fk),
          "sharded compressed fused row differs from fuse_flat_compressed's")
    r = sq_error(sq, sk)
    check(r <= 1e-5, f"sharded compressed sq rel err {r:.3g} > 1e-5")
    print(f"[mesh] fuse_flat_compressed_sharded C={C_SERVICE} N={N_ROBERTA:,} (codec block "
          f"{CODEC_BLOCK}, kb {CODEC_KB}, the codec's top-k offsets): accumulator and fused row "
          f"equal to the unsharded path's bit for bit, sq max rel err {r:.3g}")
    ms, runs = median_windows(lambda: kops.fuse_flat_compressed_sharded(
        base_s, pi, pv, ps, wc, 0.5, mesh=mesh, axes=MESH_AXES, block=CODEC_BLOCK), iters=10)
    whole, _ = median_windows(lambda: kops.fuse_flat_compressed(
        base, idx, val, scl, wc, 0.5, block=CODEC_BLOCK), iters=10)
    dk, _ = median_windows(lambda: [decode_accum(a, b, c, wc, size=ss.shard_len,
                                                 block=CODEC_BLOCK)
                                    for a, b, c in zip(pi, pv, ps)], iters=10)
    dw, _ = median_windows(lambda: decode_accum(idx, val, scl, wc, size=N_ROBERTA,
                                                block=CODEC_BLOCK), iters=10)
    print(f"[time] fuse_flat_compressed_sharded C={C_SERVICE} N={N_ROBERTA:,}, {MESH_S} shards "
          f"({card}): {ms:.4f} ms (windows {[round(x, 4) for x in runs]}) against the unsharded "
          f"fuse_flat_compressed {whole:.4f}; its {MESH_S} decode_accum launches {dk:.4f} against "
          f"one over the row {dw:.4f}")
    rec["decode_accum"] = {"C": C_SERVICE, "N": N_ROBERTA, "shards": MESH_S,
                           "decode_ms": dk, "unsharded_decode_ms": dw, "fuse_ms": ms,
                           "unsharded_fuse_ms": whole}
    del idx, val, scl, pi, pv, ps, acc, fk, fs, base_s
    torch.cuda.empty_cache()

    # row_sketch of the body, per shard, one all-reduce
    x = (0.05 * torch.randn(N_ROBERTA, generator=gen, device="cuda") + 0.01).to(torch.bfloat16)
    xs = ss.shard_slices(x)
    before = row_sketch.launches
    mesh_mod.reset_collectives()
    got = kops.row_sketch_sharded(xs, mesh=mesh, axes=MESH_AXES, block=ss.block)
    check(row_sketch.launches - before == MESH_S and mesh_mod.collectives ==
          {"all_reduce": 1, "all_gather": 0}, f"sharded sketch made {mesh_mod.collectives}")
    e, r = sketch_error(got, row_sketch(x, 32), x)
    print(f"[mesh] row_sketch_sharded N={N_ROBERTA:,} bf16 (64 tiles a block: row_sketch on each "
          f"slice): max|d| {e:.3g} against the unsharded kernel, sq-sums rel {r:.3g} (phase 3's "
          "bounds)")
    ms, runs = median_windows(lambda: kops.row_sketch_sharded(xs, mesh=mesh, axes=MESH_AXES,
                                                              block=ss.block), iters=20)
    whole, _ = median_windows(lambda: row_sketch(x, 32), iters=20)
    print(f"[time] row_sketch_sharded N={N_ROBERTA:,} bf16, {MESH_S} shards ({card}): {ms:.4f} ms "
          f"(windows {[round(v, 4) for v in runs]}) against row_sketch unsharded {whole:.4f}")
    rec["row_sketch"] = {"N": N_ROBERTA, "shards": MESH_S, "ms": ms, "unsharded_ms": whole}
    del x, xs

    # the new entry at a clamped layout: row_sketch_shard against its plain version
    ss = ShardedFlatSpec.for_size(MESH_CLAMPED_N, MESH_S)
    x = (0.05 * torch.randn(MESH_CLAMPED_N, generator=gen, device="cuda") + 0.01)
    worst = 0.0
    for s, sl in enumerate(ss.shard_slices(x)):
        before = row_sketch_shard.launches
        k = row_sketch_shard(sl, s, MESH_S, ss.block)
        check(row_sketch_shard.launches - before == 1, "row_sketch_shard did not launch")
        p = row_sketch_shard_plain(sl, s, MESH_S, ss.block)
        t = sl.float().view(-1, LANE)
        mag = torch.stack([t.abs().sum(), (t * t).sum()])[:, None]
        d = (k - p).abs()
        check(bool((d <= 1e-5 * mag).all()), f"row_sketch_shard shard {s} differs from its plain "
              f"version by {d.max().item():.3g}")
        worst = max(worst, d.max().item())
    e, r = sketch_error(kops.row_sketch_sharded(ss.shard_slices(x), mesh=mesh, axes=MESH_AXES,
                                                block=ss.block), row_sketch(x, 32), x)
    sl = ss.shard_slices(x)[3]
    bound, by = bound_of(sl.numel() * 4 + 2 * 32 * 4, 3 * sl.numel())
    ms, runs = median_windows(lambda: row_sketch_shard(sl, 3, MESH_S, ss.block), iters=20)
    plain, _ = median_windows(lambda: row_sketch_shard_plain(sl, 3, MESH_S, ss.block), iters=5)
    print(f"[mesh] row_sketch_shard N={MESH_CLAMPED_N:,} f32 over {MESH_S} shards (clamped block "
          f"{ss.block:,}, {ss.block // LANE} tiles): every shard's partial within "
          f"{worst:.3g} of row_sketch_shard_plain (bound 1e-5 x its sum|x|); summed, max|d| "
          f"{e:.3g} against the unsharded kernel")
    print(f"[time] row_sketch_shard one shard ({sl.numel():,} f32, {card}): {ms:.4f} ms (windows "
          f"{[round(v, 4) for v in runs]}), plain {plain:.4f}, bound_ms {bound:.4f} ({by})")
    rec["row_sketch_shard"] = {"N": int(sl.numel()), "ms": ms, "plain_ms": plain,
                               "bound_ms": bound, "bound_by": by, "max_abs_err": worst}
    return rec


def mesh_row(b0, seed, scale=MESH_NOISE, *, host=False):
    """An honest row: the base plus scale x N(0, 1) and a tile-constant
    +-scale pattern of its own seed, in the base's dtype; drawn on the
    base's device, or on the host (``host``: the card and the CPU then
    get the same rows)."""
    dev = torch.device("cpu") if host else b0.device
    g = torch.Generator(device=dev).manual_seed(1000 + seed)
    n = b0.shape[0]
    tiles = -(-n // LANE)
    sign = (torch.randint(0, 2, (tiles,), generator=g, device=dev) * 2 - 1).float()
    pat = sign.repeat_interleave(LANE)[:n]
    noise = torch.randn(n, generator=g, device=dev)
    return (b0.float() + scale * (noise + pat).to(b0.device)).to(b0.dtype)


def payload_to_shards(p, ss):
    """A whole-row payload -> the S per-shard payloads ``delta_encode_sharded``
    writes for the same row: codec blocks never straddle a shard block, so
    each moves whole, and a block of the grid's padding holds what the codec
    writes for zeros (offsets 0..kb-1, values and scale 0)."""
    per, nbp, kb = ss.block // p.block, ss.padded_size // p.block, p.k_per_block
    idx = np.tile(np.arange(kb, dtype=np.int16), (nbp, 1))
    val = np.zeros((nbp, kb), np.int8)
    scl = np.zeros((nbp,), np.float32)
    idx[: p.n_blocks], val[: p.n_blocks], scl[: p.n_blocks] = p.indices, p.values, p.scales
    grid = [a.reshape((ss.n_super, ss.n_shards, per) + a.shape[1:]) for a in (idx, val, scl)]
    return [DeltaPayload(*(np.ascontiguousarray(g[:, s].reshape((-1,) + g.shape[3:]))
                           for g in grid), ss.shard_len, p.block)
            for s in range(ss.n_shards)]


def shards_to_payload(ps, ss):
    """The inverse: S per-shard payloads -> the whole-row payload."""
    block, kb = ps[0].block, ps[0].k_per_block
    per, nb = ss.block // block, -(-ss.size // block)
    arrays = [np.stack([getattr(q, f).reshape((ss.n_super, per) + getattr(q, f).shape[1:])
                        for q in ps], axis=1) for f in ("indices", "values", "scales")]
    return DeltaPayload(*(np.ascontiguousarray(a.reshape((-1,) + a.shape[3:])[:nb])
                          for a in arrays), ss.size, block)


def mesh_base(root, it, spec, device):
    return spec.flatten(ckpt.load(os.path.join(root, f"base_iter{it:04d}.npz"), device=device))


def mesh_view(root):
    st = ckpt.load_json(os.path.join(root, "service_status.json"))
    return {"iteration": st["iteration"], "fused": st["fused_contributions"],
            "rejected": st["rejected_total"], "near_duplicates": st["novelty_rejected_total"],
            "accepted": (st["last_fuse"]["n_accepted"], st["last_fuse"]["n_contributions"]),
            "rejects": [(r["file"], r["reason"]) for r in st["recent_rejects"]]}


def mesh_service(workdir, card, device="cuda", body=None, small=False):
    """Phase 15, part 2: the service loop through ``serve_repository.main``
    with ``--mesh 8`` in a temporary root, three rounds (5 dense with the
    runaway; 3 compressed and a replay; 2 rows staged and the
    daemon stopped), the same queue drained by the unsharded daemon in a
    second root, then the stopped root reopened under 8 shards, 4 and none.
    ``small`` draws the rows on the host (the card and the CPU get the same
    ones) and holds each compressed file's other layout against a fresh
    ``delta_encode``.  Returns the launch counts, the collectives, seconds,
    peak GiB, the recovered base and the two rounds' decisions."""
    t0 = time.perf_counter()
    roots = {"mesh": os.path.join(workdir, "mesh"), "flat": os.path.join(workdir, "flat")}
    if body is None:
        body = init_encoder_body(CONFIG, torch.Generator(device=device).manual_seed(0),
                                 device=device)
    spec = FlatSpec.from_tree(body)
    b0 = spec.flatten(body)
    npz = os.path.join(workdir, "mesh-base.npz")
    ckpt.save(npz, body)
    ss = ShardedFlatSpec.from_spec(spec, MESH_S)
    common = ["--device", device, "--novelty-threshold", str(NOVELTY), "--poll", "0.01",
              "--compact-keep", "1"]

    def row(base, seed, scale=MESH_NOISE):
        return mesh_row(base, seed, scale, host=small)

    def submit(name, r, it, *, sharded, compress=False, sketch=True, base=None):
        sid = ContributorClient(roots["mesh"], name).submit(
            row=r, spec=spec, sspec=ss if sharded else None, base_iteration=it,
            compress=compress, base=base, sketch=sketch)
        if compress:
            # the unsharded daemon gets the same payload bytes in the other
            # layout, under the same rider: each daemon then decodes the same
            # rows in decode_accum (its own layout) and the same ones dense
            # on the host (the other), and the two fuses do the same
            # arithmetic
            pl, meta = ckpt.load_flat_delta(os.path.join(roots["mesh"], "queue", sid + ".npz"))
            other = shards_to_payload(pl, ss) if sharded else payload_to_shards(pl[0], ss)
            if small:
                fresh = (delta_encode(r, base, k_per_block=64) if sharded else
                         delta_encode_sharded(r, base, ss, k_per_block=64))
                check(delta_checksum(other) == delta_checksum(fresh),
                      f"{name}: the rearranged payload differs from a fresh encode")
            ckpt.save_flat_delta(os.path.join(roots["flat"], "queue", sid + ".npz"), other, spec,
                                 sspec=None if sharded else ss, extra=meta["extra"])
        return sid

    def replay(sid):
        for root in roots.values():
            copy_into_queue(os.path.join(root, "queue", sid + ".npz"), "replay-000000.npz")

    def drain(*argv):
        t = time.perf_counter()
        split["submit"].append(t - split.pop("since", t0))
        # every other file reaches the unsharded daemon's queue byte for
        # byte, before the mesh daemon consumes it
        src, dst = os.path.join(roots["mesh"], "queue"), os.path.join(roots["flat"], "queue")
        os.makedirs(dst, exist_ok=True)
        for fn in sorted(os.listdir(src)):
            if fn.endswith(".npz") and not os.path.exists(os.path.join(dst, fn)):
                shutil.copyfile(os.path.join(src, fn), os.path.join(dst, fn))
        for name, root in roots.items():
            mesh = ["--mesh", str(MESH_S)] if name == "mesh" else []
            t = time.perf_counter()
            reset_launches()
            mesh_mod.reset_collectives()
            with contextlib.redirect_stdout(io.StringIO()) as out, mesh_calls() as made:
                check(serve_repo_main(["--root", root, *common, *mesh, *argv]) == 0,
                      f"the {name} daemon failed")
            split[name].append(time.perf_counter() - t)
            for line in out.getvalue().splitlines():
                print(f"  [{name}] {line}")
            if name == "mesh":  # the unsharded daemon's launches are not the mesh path's
                calls.extend(made)
                for k, v in launches().items():
                    total["launches"][k] += v
                for k, v in mesh_mod.collectives.items():
                    total["collectives"][k] += v
                total["row_sketch_shard"] += row_sketch_shard.launches
        split["since"] = time.perf_counter()

    split = {"submit": [], "mesh": [], "flat": []}  # seconds a round
    calls = []
    total = {"launches": dict.fromkeys(launches(), 0), "row_sketch_shard": 0,
             "collectives": dict.fromkeys(mesh_mod.collectives, 0)}
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    # round 1: dense, whole-row and per-shard, two without a rider
    # sketch, and the runaway
    submit("d0", row(b0, 0), 0, sharded=False)
    submit("d1", row(b0, 1), 0, sharded=True, sketch=False)
    submit("d2", row(b0, 2), 0, sharded=False, sketch=False)
    submit("d3", row(b0, 3), 0, sharded=True)
    submit("x0", row(b0, 4, MESH_RUNAWAY), 0, sharded=True)
    drain("--init-npz", npz, "--min-cohort", "5", "--max-iterations", "1")
    v1 = {n: mesh_view(r) for n, r in roots.items()}
    check(v1["mesh"] == v1["flat"], f"round 1 decisions differ: {v1}")
    check(v1["mesh"]["accepted"] == (4, 5), f"round 1 fused {v1['mesh']['accepted']}, "
          "expected 4/5 (the runaway screened out)")
    b1 = mesh_base(roots["mesh"], 1, spec, device)
    check(torch.equal(b1, mesh_base(roots["flat"], 1, spec, device)),
          "round 1: the mesh daemon's base differs from the unsharded one's")
    # round 2: compressed, one whole-row (on a mesh it decodes dense) and
    # two per-shard (decoded per shard in decode_accum), rider sketches
    # off (the daemon corrects the base's sketch from each delta), and a
    # byte-identical replay of a per-shard one.  A dense row among them
    # would be screened out: a top-k delta keeps a fraction of the norm
    submit("k0", row(b1, 5), 1, sharded=False, compress=True, sketch=False, base=b1)
    k1 = submit("k1", row(b1, 6), 1, sharded=True, compress=True, sketch=False, base=b1)
    replay(k1)
    submit("k2", row(b1, 7), 1, sharded=True, compress=True, sketch=False, base=b1)
    drain("--min-cohort", "3", "--max-iterations", "2")
    v2 = {n: mesh_view(r) for n, r in roots.items()}
    check(v2["mesh"] == v2["flat"], f"round 2 decisions differ: {v2}")
    check(v2["mesh"]["accepted"] == (3, 3) and v2["mesh"]["near_duplicates"] == 1 and
          v2["mesh"]["rejects"][-1][0] == "replay-000000.npz",
          f"round 2: {v2['mesh']}, expected 3/3 with the replay rejected")
    b2 = mesh_base(roots["mesh"], 2, spec, device)
    check(torch.equal(b2, mesh_base(roots["flat"], 2, spec, device)),
          "round 2: the mesh daemon's base differs from the unsharded one's")
    # round 3: two rows staged below --min-cohort, then the daemon stops
    submit("d5", row(b2, 8), 2, sharded=False)
    submit("d6", row(b2, 9), 2, sharded=True)
    drain("--min-cohort", "5", "--idle-timeout", "2")
    counts, collectives = total["launches"], total["collectives"]
    shard_launches = total["row_sketch_shard"]
    peak = torch.cuda.max_memory_allocated() / 2**30 if device == "cuda" else 0.0
    check_mesh_calls(calls, MESH_S if device == "cuda" else 0)
    made = {n: sum(1 for c, _ in calls if c == n) for n in MESH_CALLS}
    print(f"[mesh] service loop (--mesh {MESH_S}, {device}): rounds fused "
          f"{v1['mesh']['accepted']}, {v2['mesh']['accepted']}, then 2 rows staged; decisions "
          f"and published rows equal to the unsharded daemon's bit for bit; sharded calls "
          f"{made}; launches {counts}; collectives {collectives}; "
          f"{time.perf_counter() - t0:.1f} s; seconds a round: submit "
          f"{[round(x, 1) for x in split['submit']]}, the mesh daemon "
          f"{[round(x, 1) for x in split['mesh']]}, the unsharded one "
          f"{[round(x, 1) for x in split['flat']]}")
    check(made == MESH_CALLS, f"sharded calls {made}, expected {MESH_CALLS}")

    # the stopped root reopened under 8 shards, 4 and none (and the unsharded
    # daemon's root): every one recovers the two staged rows into the same base
    got = {}
    for name, kw in (("8", {"mesh": make_mesh((MESH_S,), MESH_AXES, device=device)}),
                     ("4", {"mesh": make_mesh((4,), MESH_AXES, device=device)}),
                     ("none", {}), ("flat root", {})):
        src = roots["flat" if name == "flat root" else "mesh"]
        dst = os.path.join(workdir, f"reopen-{name.replace(' ', '-')}")
        shutil.copytree(src, dst)
        repo = Repository.open(dst, device=device, **kw)
        check(repo.n_staged == 2, f"reopened under {name}: {repo.n_staged} staged, expected 2")
        rec = repo.fuse_pending()
        check(rec.n_accepted == 2, f"reopened under {name}: fused {rec.n_accepted}/2")
        got[name] = repo.flat_base_host()
        del repo
    same = all(torch.equal(got["8"], g) for g in got.values())
    check(same, "the staged rows recovered to different bases under 8 shards, 4 and none")
    print(f"[mesh] the stopped root reopened under {MESH_S} shards, 4 and none, and the unsharded "
          "daemon's root: each recovered the 2 staged rows into the same base, bit for bit")
    if device == "cuda":
        print(f"[mesh] torch.cuda.max_memory_allocated over the service loop: {peak:.2f} GiB")
    return {"counts": counts, "row_sketch_shard": shard_launches, "collectives": collectives,
            "seconds": time.perf_counter() - t0, "peak_gib": peak, "base": got["8"],
            "views": (v1["mesh"], v2["mesh"])}


def phase_mesh(workdir, card):
    """Phase 15: the mesh-sharded Repository engine on an 8-shard mesh of
    the card.  Returns (the service loop's launches, the timing records)."""
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(15)
    rec = phase_mesh_ops(gen, card)
    torch.cuda.empty_cache()
    # the same loop at TINY f32 on the card and on the CPU (whose path the
    # CPU tests hold against the JAX package): the same decisions and bases.
    # Its rows are small, so every sharded sketch takes row_sketch_shard
    tiny = dataclasses.replace(TINY, param_dtype="float32", compute_dtype="float32")
    body = init_encoder_body(tiny, torch.Generator().manual_seed(5), device="cpu")
    small = {}
    for dev in ("cpu", "cuda"):
        os.makedirs(os.path.join(workdir, f"small-{dev}"))
        with contextlib.redirect_stdout(io.StringIO()):
            small[dev] = mesh_service(os.path.join(workdir, f"small-{dev}"), card, device=dev,
                                      body=tree_map(lambda x: x.to(dev), body), small=True)
    d = (small["cpu"]["base"].float() - small["cuda"]["base"].float()).abs().max().item()
    check(small["cpu"]["views"] == small["cuda"]["views"],
          f"small mesh loop: decisions differ, CPU {small['cpu']['views']}, card "
          f"{small['cuda']['views']}")
    check(d <= 1e-5, f"small mesh loop: card and CPU bases differ by {d:.3g} > 1e-5")
    want = dict(MESH_LAUNCHES, row_sketch=MESH_CALLS["row_sketch"],
                row_sketch_shard=MESH_S * MESH_CALLS["row_sketch_sharded"])
    got = dict(small["cuda"]["counts"], row_sketch_shard=small["cuda"]["row_sketch_shard"])
    for kernel, n in want.items():
        check(got[kernel] == n, f"{kernel} launched {got[kernel]} times on the small mesh "
              f"loop, expected {n}")
    print(f"[small] TINY f32 mesh service loop ({MESH_S} shards of a clamped block) on the card "
          f"and the CPU: the same decisions each round, the recovered bases within {d:.3g} "
          f"(bound 1e-5); launches on the card {got}")
    del body, small
    run = mesh_service(workdir, card)
    counts = run["counts"]
    for kernel, want in MESH_LAUNCHES.items():
        check(counts[kernel] == want, f"{kernel} launched {counts[kernel]} times on the mesh "
              f"path, expected {want}")
    check(counts["flash_attention"] == counts["rwkv6_scan"] == 0,
          f"the mesh path launched {counts}")
    rec["service"] = {k: run[k] for k in ("seconds", "peak_gib", "collectives")}
    print(f"[mesh] phase {time.perf_counter() - t0:.1f} s on {card}")
    return counts, rec


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name, count, smi = torch.cuda.get_device_name(0), torch.cuda.device_count(), nvidia_smi()
    print(f"[card] {name}, {count} device(s); nvidia-smi: {smi}")
    print(f"[card] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    built = _build.build_all(SOURCES)
    print(f"[build] {len(SOURCES)} sources, one nvcc each, started together: "
          f"{time.perf_counter() - t0:.1f} s")
    for source in SOURCES:
        b = built[source]
        took = f"nvcc {b.seconds:.1f} s" if b.seconds else "built earlier in this checkout"
        print(f"[build] {source}.cu -> {b.path.name}: {took}")
        for line in ptxas_summary(b.log):
            print(f"  ptxas {line}")

    gen = torch.Generator(device="cuda").manual_seed(0)
    inputs, max_err = phase_kernel_checks(gen)
    ms, plain_ms, bound_ms, bound_by = phase_timing(inputs, smi)
    del inputs
    torch.cuda.empty_cache()
    dec_inputs, dec_err = phase_decode_checks(gen)
    dec, dec_extra = phase_decode_timing(dec_inputs, smi)
    del dec_inputs
    torch.cuda.empty_cache()
    sk_row, sk_err = phase_sketch_checks(gen)
    sk = phase_sketch_timing(sk_row, smi)
    del sk_row
    torch.cuda.empty_cache()
    fl_inputs, fl_hd160, fl_archs2, fl_err = phase_flash_checks(gen)
    fl, fl_lines = phase_flash_timing(fl_inputs, fl_hd160, fl_archs2, smi)
    del fl_inputs, fl_hd160, fl_archs2
    rw_inputs, rw_err = phase_rwkv_checks(gen)
    rw, rw_lines = phase_rwkv_timing(rw_inputs, smi)
    del rw_inputs
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(prefix="chip_smoke-") as workdir:
        phase_small_agreement()
        phase_small_per_leaf()
        phase_small_service(workdir)
        phase_small_lifecycle(workdir)
        phase_small_lm()

        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        fisher_bodies, ties_held = phase_main_path(smi)
        loop = launches()
        print(f"[main] launches on the training path: {loop}")
        check(loop["cold_fuse"] >= 4,
              f"cold_fuse launched {loop['cold_fuse']} times on the loop, expected >= 4")
        print(f"[main] torch.cuda.max_memory_allocated: "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        check_fisher_ones(fisher_bodies)
        check_ties_on_cpu(*ties_held, smi)
        del fisher_bodies, ties_held
        torch.cuda.empty_cache()

        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t_service = time.perf_counter()
        service_split = phase_service_path(workdir)
        counts = launches()
        print(f"[service] launches on the service path: {counts}; "
              f"{time.perf_counter() - t_service:.1f} s")
        print(f"[service] torch.cuda.max_memory_allocated: "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        torch.cuda.empty_cache()

        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t_life = time.perf_counter()
        phase_lifecycle(workdir, smi, service_split)
        life = launches()
        print(f"[lifecycle] launches on the lifecycle path: {life}; "
              f"{time.perf_counter() - t_life:.1f} s")
        print(f"[lifecycle] torch.cuda.max_memory_allocated: "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    # worked out from the code: cold_fuse for the two dense cohorts and both
    # async passes (the rejected one launches before its screen; the mixed
    # cohort fuses through decode_accum and a plain combine); row_sketch for
    # the service's first base sketch and each of the 5 base movements
    for kernel, want in (("cold_fuse", 4), ("decode_accum", 1), ("row_sketch", 6)):
        check(life[kernel] == want, f"{kernel} launched {life[kernel]} times on the lifecycle "
              f"path, expected {want}")
    for kernel, least in (("decode_accum", 3), ("row_sketch", 5), ("cold_fuse", 1)):
        check(counts[kernel] >= least, f"{kernel} launched {counts[kernel]} times on the "
              f"service path, expected >= {least}")

    # the serving path (slice 3), one model at a time, counts reset before each
    # prefill: one launch per layer and generate; decode: one per layer and step
    counts["flash_attention"], fl_routes, _ = phase_serve(
        "gemma3-1b", GEMMA, GEMMA_PROMPT, SERVE_NEW, GEMMA_MAX_LEN, "flash_attention", smi,
        serve_routes(GEMMA, GEMMA_PROMPT, SERVE_NEW))
    # two generates: a scan launch per layer each, a step launch per layer and token after
    counts["rwkv6_scan"], rw_routes, _ = phase_serve(
        "rwkv6-7b", RWKV, RWKV_PROMPT, SERVE_NEW, RWKV_MAX_LEN, "rwkv6_scan", smi,
        {"scan": 2 * RWKV.num_layers, "step": 2 * RWKV.num_layers * (SERVE_NEW - 1)})

    # the routed service (slice 6), counts reset just before it
    with tempfile.TemporaryDirectory(prefix="chip_smoke-") as workdir:
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t_route = time.perf_counter()
        b0, spec = phase_routing(workdir, smi)
        routed = launches()
        print(f"[routing] launches on the routed path: {routed}; "
              f"{time.perf_counter() - t_route:.1f} s")
        print(f"[routing] torch.cuda.max_memory_allocated: "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    # worked out from the code (PERF.md): cold_fuse for each member's
    # round-0 dense cohort and each member's cross-fuse; decode_accum for each
    # member's mixed round-1 cohort; row_sketch for main's first base sketch,
    # the spawned member's, and each of the 6 publishes (2 per round, 2 of
    # the cross-fuse)
    for kernel, want in (("cold_fuse", 4), ("decode_accum", 2), ("row_sketch", 8)):
        check(routed[kernel] == want, f"{kernel} launched {routed[kernel]} times on the "
              f"routed path, expected {want}")
    real_finetune_scores(b0, spec, smi)
    del b0
    torch.cuda.empty_cache()

    # the fuse-to-serve stack (slice 7), counts reset just before it
    with tempfile.TemporaryDirectory(prefix="chip_smoke-") as workdir:
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        stack = phase_serve_stack(workdir)
        served = launches()
        stack_routes = dict(flash_attention.launches_by_route)
        print(f"[serve-stack] launches on the serve-stack path: {served}; flash_attention by "
              f"route {stack_routes}; {stack['seconds']:.1f} s on {smi}")
        print(f"[serve-stack] torch.cuda.max_memory_allocated: "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (the worker's Engine keeps "
              "iteration 0's 2.00 GB row for its life, as the reference's does)")
    fuse_at_gemma = time_cohort_fuse(*stack.pop("fuse_inputs"), smi)
    for kernel, want in SERVE_STACK_LAUNCHES.items():
        check(served[kernel] == want, f"{kernel} launched {served[kernel]} times on the "
              f"serve-stack path, expected {want}")
    torch.cuda.empty_cache()

    # LM training and serving what it trained (slice 8), counts reset around
    # the eval steps and generates inside
    with tempfile.TemporaryDirectory(prefix="chip_smoke-") as workdir:
        lm_train = phase_lm_train(workdir, smi)
    torch.cuda.empty_cache()

    # the MoE family and the dense archs (slice 9), counts reset around each run
    with tempfile.TemporaryDirectory(prefix="chip_smoke-") as workdir:
        archs, arch_table = phase_archs(workdir, smi)
    torch.cuda.empty_cache()

    # the last three archs and the ring cache (slice 10), counts reset around each run
    with tempfile.TemporaryDirectory(prefix="chip_smoke-") as workdir:
        archs2, arch2_table = phase_archs2(workdir, smi)
    torch.cuda.empty_cache()

    # the mesh-sharded Repository engine (slice 11), counts reset just
    # before its full-width service loop
    with tempfile.TemporaryDirectory(prefix="chip_smoke-") as workdir:
        mesh_counts, mesh_rec = phase_mesh(workdir, smi)
    torch.cuda.empty_cache()
    print(f"[done] {time.perf_counter() - t0:.1f} s after the card check")

    def record(name, replaces, err, timing, source=None):
        k_ms, k_plain, k_bound, k_by = timing[:4]
        return {"name": name, "route": "cuda",
                "source": f"src/repro_torch/kernels/csrc/{source or name}.cu",
                "replaces": replaces, "launches": counts[name], "max_abs_err": err,
                "ms": k_ms, "plain_ms": k_plain, "bound_ms": k_bound, "bound_by": k_by,
                "library_ms": timing[4] if len(timing) > 4 else None}

    # flash_attention's numbers are those of its first [time] line (prefill,
    # global layer); "routes" holds every [time] line and the serving
    # phase's launches per route
    flash = record("flash_attention", "src/repro/kernels/flash_attention.py:28", fl_err, fl,
                   source=FLASH_SOURCE[fl_lines[0]["route"]])
    flash["launches_by_route"] = fl_routes
    flash["routes"] = fl_lines
    # rwkv6_scan's likewise: the prefill line (scan route), then every line
    rwkv = record("rwkv6_scan", "src/repro/kernels/rwkv6_scan.py:35", rw_err, rw)
    rwkv["launches_by_route"] = rw_routes
    rwkv["routes"] = rw_lines

    fuse_kernels = [
        record("cold_fuse", "src/repro/kernels/cold_fuse.py:61", max_err,
               (ms, plain_ms, bound_ms, bound_by)),
        dict(record("decode_accum", "src/repro/kernels/cold_fuse.py:170", dec_err, dec),
             **dec_extra),
        record("row_sketch", "src/repro/kernels/cold_fuse.py:253", sk_err, sk)]
    for rec in fuse_kernels:  # "launches" is phase 7's; the routed phase's beside it
        rec["launches_routed"] = routed[rec["name"]]
    for rec in fuse_kernels + [flash, rwkv]:  # and phase 11's, 12's, 13's, 14's and 15's
        rec["launches_serve_stack"] = served[rec["name"]]
        rec["launches_lm_train"] = lm_train[rec["name"]]
        rec["launches_archs"] = archs[rec["name"]]
        rec["launches_archs2"] = archs2[rec["name"]]
        rec["launches_mesh"] = mesh_counts[rec["name"]]
    # phase 15's times beside the unsharded kernels'; row_sketch_shard is an
    # entry of row_sketch.cu, held at a clamped layout
    fuse_kernels[0]["mesh"] = {"roberta": mesh_rec["cold_fuse"],
                               "gemma3_1b": mesh_rec["cold_fuse_gemma3_1b"]}
    fuse_kernels[1]["mesh"] = mesh_rec["decode_accum"]
    fuse_kernels[2]["mesh"] = dict(mesh_rec["row_sketch"],
                                   row_sketch_shard=mesh_rec["row_sketch_shard"])
    print(json.dumps({"mesh_service": mesh_rec["service"]}))
    print(json.dumps({"archs": arch_table}))
    print(json.dumps({"archs2": arch2_table}))
    fuse_kernels[0]["at_gemma3_1b"] = fuse_at_gemma
    print(json.dumps({"kernels": fuse_kernels + [flash, rwkv]}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
