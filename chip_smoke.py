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
   take ``prefill_tc``) at full width in bf16 cut to their first
   ``DENSE_LAYERS`` layers (``--num-layers``), 4 x 256 -> 16, through phase
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
   ring cache: 4 x 480 -> 48 through ``Engine.generate`` with
   ``RING_CACHE`` on and off (the 512-slot rings wrap after decode step
   32), launches exact, both caches' bytes, and the ring's teacher-forced
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

16. the model-side ColD mesh (slices 12 and 14) at gemma3-1b's full width
   in f32 (``phase_cold_mesh``), the train state stacked for 2
   contributors from seed 0 and placed by ``cold_shardings``
   (``launch.sharding.device_put``), each slab its own seeded token stream
   of 8 x 64.  (a) Whole slabs, on ``make_cold_mesh(contributors=2,
   replicas=1, model=1)`` (each slab whole on its contributor slot's
   device, the step counter one [2] tensor with slab 0), AdamW: 3 cold
   steps (``make_cold_train_step``; 0 collectives; the slabs must diverge;
   run alone on a machine of several cards, the two slabs sit on two), each
   slab then equal bit for bit to ``make_train_step`` run alone on it;
   ``make_fuse_step(flat=True)`` at alpha 1 (exactly 1 all-reduce, the
   slabs equal bit for bit, the per-leaf path within 1 f32 ulp of the
   operands); 2 more cold steps and a fuse at alpha 0.5 (1 all-reduce, the
   per-leaf path likewise, the slabs' spread halved within 3 f32 ulps).
   (b) Partitioned, on ``make_cold_mesh(contributors=2, replicas=2,
   model=2)``: each slab split into blocks over its replica x model slots
   (every slot's placed bytes equal ``dryrun.slot_bytes``); one SGD cold
   step whose gathered gradients (through ``grad_sync``), loss, grad_norm
   and new params hold against ``make_train_step`` on the whole slab
   (``PARTITIONED_RTOL``); then AdamW from seed 0, 3 + 2 cold steps
   (finite, the slabs diverge, the collectives of each local step equal
   ``partitioned_collectives``, the formula PERF.md states, none over
   ``contrib``; one more under ``torch.profiler``, its device-busy time
   printed) and both fuses at alpha 1 and 0.5 with (a)'s checks.  Slab
   0 of (b)'s fused base, gathered and cast to bf16, is served 4 x 1024 ->
   32 through ``Engine.generate`` with ``flash_attention``'s launches exact
   by route, and phase 9's rule against the plain path; then the same
   slab cast to bf16 in its blocks is served partitioned on its own
   (replica 2, model 2) grid (phase 19's path, launches exact by route)
   and held against the gathered serve by phase 19's rule.  Local step ms
   per slab, fuse ms, peak memory and the bytes across the contributor axis
   (``launch.mesh.collective_bytes``) against sync-DP's gradient bytes are
   printed.

17. the dry-run tooling (slice 13, ``phase_dryrun``, under two minutes):
   (a) ``python -m repro_torch.launch.dryrun`` as a user runs it, the
   partitioned step traced on a meta grid, five processes with no card
   visible, started together before phase 5 and run beside the card's
   phases until phase 17 collects them (``DRYRUN_RUNS``: every arch at
   decode_32k on pod1, gemma3-1b's prefill_32k and decode_32k on pod1 and
   pod2 and its train_4k on pod1, and its ColD step on cold8x2; the rest of
   ``--all --mesh both`` is left to the CLI, ``DRYRUN_LEFT``), one line per
   artifact: the traced grid and its seconds, the three roofline terms,
   the collective bytes a chip, the bottleneck and the peak a slot; (b) phase 9's
   gemma3-1b bf16 prefill (4 x 1024, cache 1280) and one decode step,
   counted by ``utils.op_counts.OpCounter`` on the meta device and on the
   card: equal FLOPs, and the kernels' calls by route equal to the card's
   launches (``prefill_tc`` 26; ``decode`` 26 and ``decode_combine`` 26); (c)
   phase 12's gemma3-1b f32 AdamW step at 8 x 64: its counted FLOPs within
   2 % of 6·N·D plus the full S x S attention of every layer and equal on
   the meta device and the card, the predicted peak beside
   ``torch.cuda.max_memory_allocated``, and the roofline step time beside
   the measured median (``mfu = model_flops / peak / measured``).  Its
   record is a ``{"dryrun": ...}`` line.

18. the partitioned train step with FSDP (slice 14, ``phase_partitioned``,
   under two minutes): mistral-nemo-12b at full width (d 5120, 32:8 heads
   of 128, F 14336, vocab 131072, untied, ``fsdp=True`` as its config has
   it) cut to ``NEMO_LAYERS`` of its 40 layers (``num_layers`` only, the
   cut printed), f32, SGD at 4 x 64.  First one step of the whole model
   (``make_train_step`` on tensors): its loss, grad_norm and the gradients
   and new values of ``NEMO_KEEP`` are kept and the rest freed; then the
   same state placed on ``make_mesh((2, 2), ("replica", "model"))`` (every
   slot's bytes equal ``dryrun.slot_bytes``) and the same step partitioned:
   loss, grad_norm and the kept leaves within ``PARTITIONED_RTOL``, the
   collectives equal ``partitioned_collectives``, the step's peak
   allocation within ``NEMO_PEAK_RTOL`` of ``nemo_peak_bytes``; a second
   step of each timed, and a third partitioned one under
   ``torch.profiler``.  Its record is a ``{"partitioned": ...}`` line.

19. partitioned serving (slice 15, ``phase_partitioned_serve``, under three
   minutes): first ``flash_attention`` and ``rwkv6_scan`` against their
   plain versions at the per-slot shapes (``phase_pserve_kernel_checks``:
   mistral-nemo-12b's 16 query heads on 4 kv heads of 128 and gemma3-1b's
   2 query heads on its one kv head of 256, B = 2, bf16 prefill, decode
   and the ring decode; rwkv6-7b's 32 heads, f32, both routes).  Then each
   of ``PSERVE_MODELS`` at full width in bf16 from seed 0, one at a time
   with memory freed between them: rwkv6-7b (8 of its 32 layers) 4 x 256
   -> 16, mistral-nemo-12b (10 of its 40 layers, ``fsdp=True`` as
   configured) 4 x 256 -> 16, gemma3-1b 4 x 1024 -> 16 (cache 1280: the
   hd-split cache, the window masks) and gemma3-1b with the ring cache 4 x
   500 -> 16 (its 512-slot rings wrap after decode step 12).  Whole first: the Engine's
   tokens, the logits teacher-forced on them (timed: the whole model's
   prefill and decode ms) and the same with the kernels' outputs nudged by
   ``TP_NUDGE`` (the yardstick); then the same params placed by ``params_shardings`` on
   ``make_mesh((2, 2), ("data", "model"))`` (the whole tree freed): every
   slot's bytes of params and cache equal ``dryrun.slot_bytes`` and each
   cache block has the shape ``cache_shardings`` gives; one partitioned
   ``Engine.generate`` with the launches exact by route
   (``pserve_routes``) and the collectives equal to ``new_tokens`` times
   ``serve_collectives`` (by kind and by axis), timed; a prefill timed
   with its collective bytes (a decode step's are the generate's rest),
   one prefill and 1 step under ``torch.profiler`` (the device's activity
   alone); the partitioned model teacher-forced on the whole
   model's tokens against the whole model's logits (``tp_agreement``:
   within 4x the yardstick, tokens equal wherever the margin decides, the
   low-margin ones counted).  Its record is a ``{"partitioned_serve":
   ...}`` line.

20. the partitioned MoE FFN and M-RoPE (slice 16,
   ``phase_partitioned_moe``, under two and a half minutes): first
   ``flash_attention`` against its plain version at the per-slot shapes
   (``phase_pmoe_kernel_checks``: granite-moe's 8 query heads on 4 kv heads
   of 64, mixtral's 16 on 4 of 128 with its 4096 window, qwen2-vl's 32 on 4
   of 128; B = 2, bf16 prefill and decode).  Then each of ``PMOE_SERVE``
   at full width in bf16 from seed 0, one at a time with memory freed
   between them: granite-moe-1b-a400m cut to 8 of its 24 layers (16
   experts a slot) 4 x 1024 -> 32, mixtral-8x7b cut to 4 of its 32 layers
   (4 experts a slot,
   ``fsdp=True`` as configured) 4 x 256 -> 16, qwen2-vl-72b cut to 8 of 80
   layers, phase 14's vision prefill of 4 x (256 patches + 256 text) into
   a placed cache and 16 serve steps.  The whole model's side is phase
   14's (qwen2-vl) run of the same tree and prompts where that phase ran
   (``WHOLE_RUNS``), else run here: its tokens, its
   logits teacher-forced on them with its MoE routing recorded, its times;
   the yardstick is the same run with the kernels nudged by ``TP_NUDGE``
   and the routing replayed.  Then the params placed on
   ``make_mesh((2, 2), ("data", "model"))``: bytes a slot equal
   ``dryrun.slot_bytes``; one partitioned generate (``Engine.generate``; the
   vision prompt through the placed prefill) with the launches exact by
   route and the collectives ``new_tokens`` times ``serve_collectives``;
   a prefill timed with its collective bytes, a prefill and a decode step under
   ``torch.profiler``; the partitioned model teacher-forced on the whole
   model's tokens with the whole run's routing replayed slot by slot
   (``slot_replay``, the decisions it would have taken otherwise counted)
   against the whole model's logits (``tp_agreement``).  Then
   ``PMOE_TRAIN``: one f32 step whole and on ``(replica 2, model 2)``,
   granite-moe (AdamW, 4 x 128) and mixtral cut to 2 layers (SGD, 4 x 64),
   the whole step's routing replayed: loss, aux, grad_norm and the kept
   gradients within ``PARTITIONED_RTOL`` / ``ATOL``, the collectives equal
   ``partitioned_collectives``, bytes a slot ``dryrun.slot_bytes``.  Its
   record is a ``{"partitioned_moe": ...}`` line.

21. the partitioned Mamba mixer, the RWKV train step and adafactor over
   blocks (slice 17, ``phase_partitioned_ssm``): first ``flash_attention``
   against its plain version at jamba's per-slot shape
   (``phase_pssm_kernel_checks``: 32 query heads on 4 kv heads of 128, no
   window, B = 2, bf16 prefill and decode).  Then jamba-1.5-large-398b at
   layers 0-4 of 72 (Mamba 0-3, attention 4, MoE 1 and 3; 24.0 B
   parameters, 48 GB bf16, FSDP as configured) as phase 20 serves its
   models, 4 x 256 -> 16: the whole side phase 14's run (``WHOLE_RUNS``)
   where it ran, the yardstick nudging the Mamba scan's output too
   (``nudged_kernels``), the placed tree built from the same seeded init
   leaf by leaf, each whole leaf dropped once placed (``place_leafwise``:
   the peak held against the whole tree and its largest leaf), launches
   exact by route (``flash_attention`` ``prefill_tc`` 4, ``decode`` 60,
   each with its combine), collectives the formula's (a Mamba layer's
   in_proj gather and two all-reduces).  Then ``PSSM_TRAIN``: one f32
   step whole and on ``(replica 2, model 2)`` of jamba at its layer 0
   with adafactor and of rwkv6-7b at 2 of 32 layers with AdamW, 4 x 64,
   as phase 20's, and the updated parameters held against the whole
   optimizer's update of the same gradients.  Its record is a
   ``{"partitioned_ssm": ...}`` line.
22. **Context-parallel serving** (slice 18, ``phase_context_parallel``):
   one request (B = 1) on ``(data 2, model 2)``, where the batch axis does
   not divide the batch.  First ``flash_decode.cu``'s two new entries,
   ``flash_attention_partials`` over each block of a cache split in two
   and ``merge_partials`` over both blocks' partials, against their plain
   versions at the per-slot decode shapes (gemma3-1b's q [1, 1, 2, 256]
   over 16,384-key blocks, a global layer and a local one whose block 0
   holds no visible key; granite-moe's q [1, 1, 8, 64] on 4 kv heads), bf16
   and f32, and the merged output against ``flash_attention_plain`` over
   the whole cache; then both entries timed against their plain versions
   and SDPA over the whole cache (``[time] flash_attention
   decode_partial`` / ``decode_merge`` lines).  Then ``CP_MODELS`` whole
   and context-parallel: gemma3-1b 1 x 32,752 -> 16 (26 layers, linear
   caches of 32,768), rwkv6-7b (8 of 32 layers) 1 x 4,096 -> 16 (FSDP),
   granite-moe (8 of 24 layers) 1 x 2,048 -> 16: the prompt split into
   two chunks over ``data``, the
   caches' sequence over ``data``; launches exact by route
   (``cp_routes``), collectives a prefill and a decode step the formula's
   (``serve_collectives(step=)``), bytes a slot = ``dryrun.slot_bytes``,
   profiler busy time and peak, and the logits teacher-forced on the whole
   model's tokens within 4x its nudge yardstick (``tp_agreement``).  Its
   record is a ``{"context_parallel": ...}`` line.
23. **Context-parallel training** (slice 19,
   ``phase_context_parallel_train``): one training sequence (B = 1) on
   ``(data 2, model 2)``, f32 SGD, each step whole first (its gradients and
   updated params kept on the host, its memory freed), then partitioned:
   ``CPT_TRAIN``'s gemma3-1b 1 x 2,048 (26 layers, the sequence in two
   chunks over ``data``) and 1 x 4,095 (6 layers, every slot the whole
   sequence), granite-moe 1 x 1,024 (the MoE's queue and aux over chunks),
   rwkv6-7b (2 layers, FSDP) and jamba (layer 0, FSDP) 1 x 256 (the
   states chained by a differentiable send), qwen2-vl (1 layer, plain SGD)
   1 x 1,024 with 256 embedded positions and M-RoPE; gradients and params
   against the whole step's, collectives the formula's
   (``partitioned_collectives(seq=)``), second steps timed, a third
   profiled (idle share), peak under the reckoned bound, no launch.  Then
   qwen2-vl (8 layers, bf16) serves a 2,048-position prompt whose first
   1,296 are ``extra_embeds`` (straddling the chunk edge) -> 16 at B = 1,
   whole and context-parallel: launches exact (``cp_routes``), collectives
   the formula's, logits within 4x the yardstick.  Its record is a
   ``{"context_parallel_train": ...}`` line.
24. **The encoder-decoder partitioned** (slice 20,
   ``phase_partitioned_whisper``): first ``flash_attention`` against its
   plain version at whisper-tiny's per-slot shapes on (2, 2) (B = 2 rows,
   3 of the 6 heads of 64, bf16: the encoder's bidirectional q [2, 1500,
   3, 64], the cross-attention of one token over the 1500 frames, the self
   decode over the 36-slot cache), each timed beside its plain version,
   its bound and SDPA (``[time]`` lines).  Then whisper-tiny at full width
   and depth: one f32 AdamW step at 8 x 448 tokens with 8 x 1500 frames
   whole, then on ``(data 2, model 2)`` and with ``fsdp=True`` on
   ``(replica 2, model 2)``: loss, grad_norm and every gradient against the
   whole step's, every updated parameter against the whole optimizer's
   update of the same gradients (``PARTITIONED_RTOL`` / ``ATOL``), the
   collectives ``partitioned_collectives``' (with the encoder-decoder's
   terms), bytes a slot ``dryrun.slot_bytes``, a second step timed and a
   third profiled, and the eval step on the placed params with its launches
   exact by route.  Then bf16 serving of 4 x 1500 frames and 4-token
   prompts -> 32 whole and on ``(data 2, model 2)`` through encode, prime
   and the serve steps: launches exact by route (``whisper_routes`` times
   the slots), the collectives of encode, prime and each step
   ``whisper_collectives``', encode + prime + prompt ms and decode ms a
   step (each profiled once), the logits teacher-forced on the whole
   model's tokens within 4x the yardstick (``tp_agreement``), and the
   prefill step (tokens and frames) against the whole one.  Its record is
   a ``{"partitioned_whisper": ...}`` line.
25. **Whisper at a batch the batch axis does not divide** (slice 21,
   ``phase_context_parallel_whisper``): one audio request on ``(data 2,
   model 2)``, the encoder's 1,500 positions and the cross cache's in two
   chunks of 750 over data.  First ``flash_attention`` at its per-slot
   shapes (3 of the 6 heads of 64), bf16 and f32, against the plain
   versions: the encoder's chunk q [1, 750, 3, 64] over the 1,500 gathered
   keys, bidirectional; the cross-attention's non-causal ``decode_partial``
   over each 750-key block for one token (q [1, 1, 3, 64]) and the
   prompt's 4 rows (q [1, 4, 3, 64]); ``decode_merge`` of both blocks,
   also against ``flash_attention_plain`` over all 1,500 keys; each timed
   in bf16 beside its plain version, its bound and SDPA over the whole
   1,500 keys (``[time]`` lines).  Then phase 24's train side at 1 x 448
   tokens (in chunks) and 1 x 447 (the whole layout), each with 1 x 1,500
   frames, on ``(data 2, model 2)`` (``pwhisper_train``: gradients and
   updated params against the whole step, the collectives
   ``partitioned_collectives(seq=)``', idle share and peak), and its
   serving side at B = 1, 4 -> 32 (``pwhisper_serve(B=1)``: launches exact
   by route, ``cpw_routes``; the collectives of encode, prime, the prompt
   and each token ``whisper_collectives(step=)``'; the logits against the
   whole model's).  Its record is a ``{"context_parallel_whisper": ...}``
   line.
26. **The production grids** (slice 22, ``phase_pgrid``): the steps read
   their grid from ``data_axis``/``model_axis``, a batch axis may be a
   tuple, and ``pod`` on ``("pod", "data", "model")`` is replicated where
   no spec names it.  First ``flash_attention`` at the per-slot shapes of
   the B = 1 run on grid (b): the partials over each of four 1,028-slot
   blocks (three empty under the local window) and their four-block merge,
   bf16 and f32, also against ``flash_attention_plain`` over all 4,112
   keys; each of the four prompt chunks, q [1, 1,024, 4, 256] over 4,096
   keys, on ``prefill_tc``; the merge and the four partials with it timed
   against their bound, plain version and SDPA over the whole cache
   (``[time]`` lines).  Then gemma3-1b (6 of 26 layers at full width, f32
   SGD) 8 x 512 whole, on grid (a) (pod 2 x data 2 x model 2,
   ``data_axis="data"``) and on grid (b) ((data 2, model 2),
   ``data_axis=("data", "model")``, ``model_axis=None``) with and without
   FSDP: every gradient and updated param within 1e-5 of the leaf's
   largest value of the whole step's, each slot's rows B / R, the
   collectives ``partitioned_collectives(grid=)``' and none over ``pod``,
   the two pods' operands bit-equal (``pod_twins``), bytes a slot
   ``dryrun.slot_bytes``, second steps timed, a third profiled.  Then bf16
   serving, whole and on the grid through ``Engine(data_axis=,
   model_axis=)``, -> 16: gemma3-1b 8 x 512 on (a), 4 x 512 and 1 x 4,096
   (four chunks, four cache blocks) on (b), granite-moe (4 layers) 4 x 512
   on (b): launches exact by route (``pserve_routes``, ``cp_routes``), the
   collectives of each step ``serve_collectives(data_axis=)``', the logits
   within 4x the yardstick (``tp_agreement``).  Its record is a
   ``{"pgrid": ...}`` line.
27. **The partitioned dry run against the card** (slice 23,
   ``phase_pdryrun``): gemma3-1b (6 of 26 layers at full width) on
   ``(data 1, model 8)``, whose 4 query heads the model axis does not
   divide (``wq`` gathered over ``model``, every head on every slot): one
   f32 SGD step 8 x 512 whole and partitioned, every gradient and updated
   param within 1e-5 of the leaf's largest value, the collectives
   ``partitioned_collectives(grid=)``'; bf16 serving 4 x 512 -> 16 whole
   and on the grid (``pgrid_serve``: launches exact by route, logits
   within 4x the yardstick); then the train step, the prefill step and a
   decode step at cache 528 each counted by an ``OpCounter`` on the card
   and held against ``launch.dryrun.trace_step``'s meta trace of the same
   step (``pdryrun_meta``, traced with no card visible beside phases 5-16):
   equal FLOPs, the same collectives by axis, the kernels' calls by route
   equal to the card's launches, the predicted peak of all 8 slots on one
   card within ``PEAK_RTOL`` of the card's (train and prefill).  Its record
   is a ``{"pdryrun": ...}`` line.

Each phase prints ``[phase] <n> <name> <seconds> s``, its wall seconds
from start to end, before the last lines (phases 3 and 4 alternate, one
kernel at a time: each line sums its own calls).

Before each of phases 6, 7, 8, 10, 11 and 16 (and again before each of
phase 16's serves), before each model of phases 9, 13 and 14, around
phases 12's, 13's and 14's eval steps and generates, around each run of
phase 15's mesh daemon, around phase 17's counted prefill and decode step
and around each of phase 19's, 20's, 21's and 22's partitioned generates,
phase 23's train steps and context-parallel generate, phases 24's and
25's partitioned greedy runs, phase 26's train steps and generates and
phase 27's generate,
every kernel's launch
counter is set to 0; it is read just after.  The last lines are the
kernels' JSON record (launches from phase 7 for the three fuse kernels, with phase 10's
as ``launches_routed``, from phase 9 for the other two, phase 11's as
``launches_serve_stack``, phase 12's as ``launches_lm_train``, phase 13's as
``launches_archs``, phase 14's as ``launches_archs2``, phase 15's as
``launches_mesh``, phase 16's serves as ``launches_cold_mesh`` and
``launches_cold_mesh_partitioned``, phase 17's serving step as
``launches_dryrun``, phase 19's partitioned generates summed as
``launches_partitioned_serve``, phase 20's as
``launches_partitioned_moe``, phase 21's as ``launches_partitioned_ssm``,
phase 22's as ``launches_context_parallel``, phase 24's as
``launches_partitioned_whisper``, phase 25's as
``launches_context_parallel_whisper``, phase 26's as ``launches_pgrid``
and phase 27's as ``launches_pdryrun``
for all five; phase 15's times under ``mesh``; phases 19's to 27's
per-slot checks as ``per_slot_max_abs_err``; each kernel's
``cost_formula``; phases 22's, 24's, 25's and 26's ``[time]`` lines
among ``flash_attention``'s ``routes`` and their launches by route as
``launches_by_route_context_parallel``,
``launches_by_route_partitioned_whisper``,
``launches_by_route_context_parallel_whisper`` and
``launches_by_route_pgrid`` and ``launches_by_route_pdryrun``, and one record each for the
two new entries, ``flash_attention.decode_partial`` and
``flash_attention.decode_merge``), phase 16's record as a ``{"cold_mesh": ...}``
line, phase 17's as a ``{"dryrun": ...}`` line, phase 18's as a
``{"partitioned": ...}`` line (its steps launch no kernel), phase 19's as a
``{"partitioned_serve": ...}`` line, phase 20's as a ``{"partitioned_moe":
...}`` line, phase 21's as a ``{"partitioned_ssm": ...}`` line, phase
22's as a ``{"context_parallel": ...}`` line, phase 23's as a
``{"context_parallel_train": ...}`` line, phase 24's as a
``{"partitioned_whisper": ...}`` line, phase 25's as a
``{"context_parallel_whisper": ...}`` line, phase 26's as a ``{"pgrid":
...}`` line, phase 27's as a ``{"pdryrun": ...}`` line, ``nvidia-smi``'s line and
``{"ok": true, "device": {...}}``.  Without a card (or without the rest of
the repository beside it) the script exits non-zero and prints no result.
"""
import atexit
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
from repro_torch.core import (ColdSchedule, Contributor, EvalTask, Repository,  # noqa: E402
                              RepositoryFamily, cold_shardings, evaluate_base_model, fusion,
                              make_cold_train_step, make_fuse_step, run_cold_fusion,
                              stack_for_contributors)
from repro_torch.core.distributed import slab  # noqa: E402
from repro_torch.launch import dryrun as dryrun_mod  # noqa: E402
from repro_torch.launch import sharding as sharding_mod  # noqa: E402
from repro_torch.utils.placed import Placed  # noqa: E402
from repro_torch.data.pipeline import shard_batch  # noqa: E402
from repro_torch.data.synthetic import SyntheticSuite  # noqa: E402
from repro_torch.checkpoint import io as ckpt  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import cold_fuse as cf_mod  # noqa: E402
from repro_torch.kernels import decode_accum as da_mod  # noqa: E402
from repro_torch.kernels import flash_attention as fa_mod  # noqa: E402
from repro_torch.kernels import row_sketch as sk_mod  # noqa: E402
from repro_torch.kernels.cold_fuse import cold_fuse, cold_fuse_plain  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels.decode_accum import decode_accum, decode_accum_plain  # noqa: E402
from repro_torch.kernels.flash_attention import (flash_attention,  # noqa: E402
                                                 flash_attention_partials,
                                                 flash_attention_partials_plain,
                                                 flash_attention_plain, merge_partials,
                                                 merge_partials_plain)
from repro_torch.kernels.row_sketch import (row_sketch, row_sketch_plain,  # noqa: E402
                                            row_sketch_shard, row_sketch_shard_plain)
from repro_torch.kernels import rwkv6_scan as rs_mod  # noqa: E402
from repro_torch.kernels.rwkv6_scan import rwkv6_scan, rwkv6_scan_plain  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.launch.sharding import device_put  # noqa: E402
from repro_torch.launch.serve import main as serve_main  # noqa: E402
from repro_torch.launch.serve_repository import main as serve_repo_main  # noqa: E402
from repro_torch.launch import train as train_launcher  # noqa: E402
from repro_torch.models import layers as layers_mod  # noqa: E402
from repro_torch.models import mamba as mamba_mod  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models import partitioned as pt_mod  # noqa: E402
from repro_torch.models import rwkv as rwkv_mod  # noqa: E402
from repro_torch.models.encoder import init_encoder_body  # noqa: E402
from repro_torch.models import transformer as tt_mod  # noqa: E402
from repro_torch.models import whisper as whisper_mod  # noqa: E402
from repro_torch.models.transformer import forward_lm, init_cache, init_lm  # noqa: E402
from repro_torch.serve.engine import Engine  # noqa: E402
from repro_torch.train import finetune as FT  # noqa: E402
from repro_torch.train import pretrain as pretrain_mod  # noqa: E402
from repro_torch.train import pretrain_mlm, train_multitask  # noqa: E402
from repro_torch.optim import constant_lr, make_optimizer, warmup_cosine_lr  # noqa: E402
from repro_torch.train.losses import lm_loss  # noqa: E402
from repro_torch.train import step as step_mod  # noqa: E402
from repro_torch.train.step import (make_eval_step, make_prefill_step,  # noqa: E402
                                    make_serve_step, make_train_state, make_train_step)
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
from repro_torch.utils.pytree import (tree_from_paths, tree_leaves,  # noqa: E402
                                      tree_leaves_with_path, tree_map)
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.launch.dryrun import tree_bytes  # noqa: E402
from repro_torch.launch.specs import abstract_params  # noqa: E402
from repro_torch.utils.flat import dtype_of  # noqa: E402
from repro_torch.utils.op_counts import OpCounter  # noqa: E402
from repro_torch.utils.roofline import (Roofline, bound_of, model_flops_per_step,  # noqa: E402
                                        peak_flops)

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
# generates timed after the counted one (phases 9 and 13); the script's
# 1200 s budget holds one
SERVE_TIMED_GENERATES = 1
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
# layers' 512-slot rings wrap after decode step 32, and 15 steps follow)
WHISPER = get_config("whisper-tiny")
WHISPER_BATCH, WHISPER_PROMPT, WHISPER_NEW = 4, 4, 32
QWEN_LAYERS, QWEN_PATCHES, QWEN_TEXT, QWEN_STEPS = 8, 256, 256, 16
QWEN = dataclasses.replace(get_config("qwen2-vl-72b"), num_layers=QWEN_LAYERS)
QWEN_LEN = QWEN_PATCHES + QWEN_TEXT
JAMBA_ARCH = "jamba-1.5-large-398b"
JAMBA = dataclasses.replace(get_config(JAMBA_ARCH), num_layers=5)
RING_PROMPT, RING_NEW = 480, 48
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
    flops, nbytes = cf_mod.cost(base, contribs, w, 1.0)
    bound, bound_by = bound_of(nbytes, flops)
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
    return ms, plain, bound, bound_by


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
    flops, nbytes = da_mod.cost(*args, size=N_ROBERTA, block=CODEC_BLOCK)
    bound, bound_by = bound_of(nbytes, flops)
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
    flops, nbytes = sk_mod.cost(x, 32)
    bound, bound_by = bound_of(nbytes, flops)
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
        flops, nbytes = fa_mod.cost(qq, k, v, causal=causal, window=window, q_offset=off)
        peak = peak_flops(qq.dtype)
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
        flops, nb = rs_mod.cost(*a)
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

        pre_ms, pre_runs = median_windows(prefill, iters=1, warmup=1)
    gen_runs = []
    for _ in range(SERVE_TIMED_GENERATES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.generate(prompts, max_new_tokens=new_tokens)
        torch.cuda.synchronize()
        gen_runs.append((time.perf_counter() - t0) * 1e3)
    gen_ms = sorted(gen_runs)[len(gen_runs) // 2]
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
    whole = serve_agreement(arch, cfg, lambda: teacher_forced(cfg, params, prompts, gen_k,
                                                              max_len), gen_k)
    if arch in PMOE_REUSED + PSSM_REUSED:  # phase 20's / 21's whole run of the tree and prompts
        WHOLE_RUNS[arch] = dict(whole, prefill_ms=pre_ms, decode_ms=dec_ms, max_len=max_len,
                                n_layers=cfg.num_layers)
    del params, eng, whole
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
    # the kernel run as phase 20 compares a partitioned run with it
    return {"tokens": gen_k, "logits": torch.cat([pre_k[:, -1:], dec_k], 1).clone(),
            "calls": rec.calls}


def device_split(fn):
    """One call of ``fn`` under ``torch.profiler``: (device-busy ms, top 6
    kernels and the port's own kernels, each as (name, ms, count)), or None
    when the profiler recorded no device event.  Busy is the sum of the
    kernels' device intervals (one stream, so they do not overlap).  Only
    the device's activity is recorded: nothing here reads the host's ops,
    and a run of tens of thousands of them takes the profiler tens of
    seconds to take apart."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
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
    flops, nbytes = cf_mod.cost(base, stage, w)
    bound, by = bound_of(nbytes, flops)
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
DENSE_LAYERS = 10   # each served at full width, cut to its first 10 layers


def serve_routes(cfg, prompt_len, new_tokens):
    """flash_attention's launches by route over ``launch.serve.main`` and
    ``Engine.generate`` (two bf16 generates), worked out from the code: one
    launch per attention layer for the prefill, one per attention layer and
    new token after the first, each on the route ``flash_attention.route``
    names for its shape (with the decode route's combine beside it)."""
    n = sum(b.mixer == "attn" for b in cfg.blocks)
    steps = n * (new_tokens - 1)
    want = dict.fromkeys(fa_mod.COUNTED, 0)
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
        cfg = dataclasses.replace(get_config(arch), num_layers=DENSE_LAYERS)
        total["flash_attention"] += serve_arch(arch, cfg, DENSE_PROMPT, DENSE_NEW,
                                               DENSE_PROMPT + DENSE_NEW, card, table,
                                               cli=("--num-layers", str(DENSE_LAYERS)))
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
    want = dict.fromkeys(fa_mod.COUNTED, 0)
    want[fa_mod.route(dtype, n_frames, cfg.num_heads, cfg.num_kv_heads)] += cfg.encoder_layers
    for sq in [prompt_len] + [1] * (new_tokens - 1):
        want[fa_mod.route(dtype, sq, cfg.num_heads, cfg.num_kv_heads)] += 2 * cfg.num_layers
    want["decode_combine"] = want["decode"]
    return want


def whisper_primed(cfg, params, frames, batch, max_len):
    """``whisper_encode`` and ``prime_cross_cache`` into a fresh cache
    (placed by ``cache_shardings`` on placed params' grid)."""
    cache = whisper_mod.init_whisper_cache(cfg, batch, max_len, device=frames.device)
    if step_mod.is_placed(params):
        mesh = tree_leaves(params)[0].layout.mesh
        cache = device_put(cache, sharding_mod.cache_shardings(mesh, cache, cfg))
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


@torch.inference_mode()
def whisper_stepped(cfg, params, frames, prompts, max_len, feed):
    """The last-position logits [B, n, V] of the prompt through the serve
    step at 0, then of n - 1 serve steps fed the tokens ``feed`` [B, n]
    (teacher-forced), on whole or placed params."""
    dev = frames.device
    B, P = prompts.shape
    cache = whisper_primed(cfg, params, frames, B, max_len)
    serve = make_serve_step(cfg)
    lg, cache = serve(params, cache, torch.as_tensor(prompts, dtype=torch.long, device=dev), 0)
    out = [lg]
    fed = torch.as_tensor(feed, dtype=torch.long, device=dev)
    for t in range(1, fed.shape[1]):
        lg, cache = serve(params, cache, fed[:, t - 1:t], P + t - 1)
        out.append(lg)
    return torch.stack(out, 1)


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
    whole = serve_agreement(arch, cfg, lambda: teacher_forced(
        cfg, params, tokens, gen_k, max_len, positions=pos, extra_embeds=extra), gen_k)
    WHOLE_RUNS[arch] = dict(whole, prefill_ms=pre_ms, decode_ms=dec_ms, max_len=max_len,
                            n_layers=cfg.num_layers)
    del whole
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
    wrap = GEMMA_WINDOW - RING_PROMPT  # the first decode step past the ring's end
    d_wrap = logit_diff(dec_r[:, wrap:], dec_f[:, wrap:])
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
              {"all_reduce": 1, "all_gather": 0, "reduce_scatter": 0},
          f"sharded fuse made {mesh_mod.collectives}")
        got = ss.unshard(torch.stack(fs))
        check(torch.equal(got, fk), f"sharded fused row differs from cold_fuse's (alpha {alpha})")
        r = sq_error(sq, sk)
        check(r <= 1e-5, f"sharded sq_diff rel err {r:.3g} > 1e-5")
        print(f"[mesh] fuse_flat_sharded K={K_MAIN} N={N_ROBERTA:,} bf16 over {MESH_S} shards "
              f"(block 65,536, G {ss.n_super}, shard_len {ss.shard_len:,}, padding "
              f"{ss.padded_size - N_ROBERTA:,}), alpha {alpha}: fused row equal to cold_fuse's "
              f"bit for bit, sq max rel err {r:.3g} (bound 1e-5), sq[3]={sq[3].item()}")
        del fk, sk, fs, sq, got
    flops, nbytes = cf_mod.cost(base, contribs, w)
    bound, by = bound_of(nbytes, flops)
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
    flops, nbytes = cf_mod.cost(base, contribs, w)
    bound, by = bound_of(nbytes, flops)
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
          {"all_reduce": 1, "all_gather": 0, "reduce_scatter": 0},
          f"sharded compressed fuse made {mesh_mod.collectives}")
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
          {"all_reduce": 1, "all_gather": 0, "reduce_scatter": 0},
          f"sharded sketch made {mesh_mod.collectives}")
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
    flops, nbytes = sk_mod.shard_cost(sl, 3, MESH_S, ss.block)
    bound, by = bound_of(nbytes, flops)
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

# ---------------------------------------------------------------------------
# slice 12: the model-side ColD mesh (phase 16)
# ---------------------------------------------------------------------------

# gemma3-1b at full width in f32 with AdamW (the launcher's lr, held), C
# slabs from seed 0 on a (C, 2, 2) contrib/replica/model mesh of the card;
# COLD_H local steps, a fuse at each of COLD_ALPHAS, each slab its own
# seeded token stream of TRAIN_BATCH x TRAIN_SEQ; then slab 0 of the fused
# base, cast to bf16, served 4 x GEMMA_PROMPT -> COLD_SERVE_NEW
COLD_C, COLD_H, COLD_ALPHAS = 2, (3, 2), (1.0, 0.5)
COLD_SERVE_NEW = 16   # the fused base's serves: 4 x GEMMA_PROMPT -> 16
COLD_WHOLE_MESH = dict(contributors=COLD_C, replicas=1, model=1)   # (a): slabs whole
COLD_MESH = dict(contributors=COLD_C, replicas=2, model=2)         # (b): partitioned
PR21_STEP_MS = 189.8        # phase 12's gemma3-1b f32 step (PR 21, PERF.md)
# the partitioned SGD steps against the whole step: tests/test_torch_partitioned.py's
# f32 tolerance (rtol and atol 1e-5 on params and gradients, rtol 1e-5 on loss
# and grad_norm); the sums run in another order over the slots
PARTITIONED_RTOL = PARTITIONED_ATOL = 1e-5
PARTITIONED_SGD_LR = 0.05
NO_COLLECTIVES = {"all_reduce": 0, "all_gather": 0, "reduce_scatter": 0}


def partitioned_collectives(cfg, psh, R: int, M: int, microbatches: int = 1, opt_name="sgd",
                            mesh=None, *, seq=None, masked=False, grid=None):
    """The collectives of one partitioned train step on a (replica R, model
    M) grid, the formula PERF.md §5 states (the same as
    ``tests/test_torch_partitioned.py``'s and, with the MoE, Mamba and RWKV
    blocks and adafactor, ``tests/test_torch_partitioned_ssm.py``'s).  Per
    microbatch, over ``model``: the embedding's all-reduce where the
    vocabulary splits, per layer two output all-reduces and two backward
    input all-reduces for attention and the FFN, the logits' backward input
    all-reduce and the loss's three; KV weights all-gathered
    (reduce-scattered back) where Hkv does not split but their spec does,
    their gradient all-reduced where the spec keeps them whole; ``wq``
    all-gathered (reduce-scattered back) where its spec splits its
    columns but M does not divide the query heads.  A MoE
    layer makes three all-reduces over ``model`` where its experts (or,
    with the lever, its F) split: the combine's and the backward's of the
    router's top-k weights and of the experts' input; and over ``replica``
    the aux loss's all-reduce and the expert counts' all-gather.  A Mamba
    layer whose channels split: the in_proj product's all-gather
    (reduce-scattered back), the x_proj partials' and out_proj's
    all-reduces and the backward all-reduces of its input and of the x_proj
    output (4).  An RWKV layer whose heads split: ``wo``'s all-reduce and
    the backward all-reduces of its input and of its four leaves held
    whole (6).  Over ``replica``: each use of a leaf FSDP splits, one
    all-gather and one reduce-scatter.  Per step: one all-reduce over
    ``replica`` per leaf not split over it and the loss metric's, and the
    global norm's; adafactor adds, for each leaf split over an axis of
    extent > 1, three all-reduces (row sums, column sums, the RMS) where it
    is factored, else one all-gather of its g² and the RMS's all-reduce.
    ``masked``: a batch with a mask adds, per microbatch, the mask's count
    all-reduced over ``replica``.  ``mesh`` (where given) names the batch
    axis (``replica``, or ``data``), read ``FROM_MESH``; ``grid`` (a
    ``models.partitioned.Grid``, phase 26) names it where the step's
    ``data_axis`` does: a tuple of axes, such as ``("data", "model")``,
    is one batch axis of R = its product's slots, and its model axis may
    be None (M = 1).  An axis the grid replicates (``pod`` on grid (a))
    changes no count: each call runs over every group of its axis at once.

    At a batch the batch axis does not divide (``seq``, phase 23, and
    ``tests/test_torch_context_parallel_train.py``), per microbatch over
    the batch axis:
    ``"chunks"`` (the sequence in R chunks) adds each attention layer's k
    and v all-gathered and reduce-scattered back, each RWKV layer's two
    token-shift rows and each Mamba layer's conv halo all-gathered and
    reduce-scattered back, each RWKV or Mamba layer's state sent from chunk
    to chunk (R - 1 permutes forward, R - 1 back) and the loss's chunk-edge
    targets all-gathered (one), the MoE terms as at a divided batch;
    ``"whole"`` (every slot the whole sequence) drops the MoE terms (each
    slot routes the whole batch once).

    The encoder-decoder (whisper, phase 24) counts its encoder's layers and
    each decoder layer's cross-attention as attention layers (their
    ``wo``'s all-reduce, their input's backward all-reduce, their KV
    weights' gathers) and its encoder's MLPs as FFNs; a cross-attention's
    encoder states add one backward all-reduce (each slot's heads' share
    of their gradient).  At a batch the batch axis does not divide (phase
    25), where R divides the N frames (the encoder's positions in R
    chunks), each encoder layer's and each cross-attention's k and v are
    all-gathered and reduce-scattered back over the batch axis, in either
    layout of the tokens; the decoder's self-attention counts as a
    decoder's attention layer."""
    hd = cfg.head_dim
    L = n_self = sum(b.mixer == "attn" for b in cfg.blocks)
    n_dense = sum(b.ffn in ("glu", "mlp") for b in cfg.blocks)
    n_moe = sum(b.ffn == "moe" for b in cfg.blocks)
    n_cross = cfg.num_layers if cfg.is_encoder_decoder else 0
    L += n_cross + cfg.encoder_layers
    n_dense += cfg.encoder_layers
    ar = ag = rs = counts = 0
    if M > 1:
        vocab = cfg.vocab_size % M == 0
        attn = (cfg.num_heads * hd) % M == 0
        ffn = cfg.d_ff % M == 0
        ar += vocab + (2 * L + n_cross) * attn + 2 * n_dense * ffn + vocab + 3 * vocab
        ar += 3 * layers_split(cfg, psh, "moe/w_gate", "model")
        mamba = layers_split(cfg, psh, "mamba/in_proj", "model")
        ar += 4 * mamba + 6 * layers_split(cfg, psh, "rwkv/wr", "model")
        ag += mamba
        rs += mamba
        if L and attn and cfg.num_kv_heads % M:
            if (cfg.num_kv_heads * hd) % M == 0:
                ag += 2 * L
                rs += 2 * L
            else:
                ar += 2 * L
        if L and attn and cfg.num_heads % M:   # wq gathered: the attention replicated
            ag += L
            rs += L
    fsdp_uses = per_step = perm = 0
    if grid is not None:
        mesh = grid.mesh
    data_axis = "replica" if mesh is None else pt_mod.as_grid(grid or mesh).dp
    if R > 1:
        ar += masked
        n_full, _ = tt_mod.split_layers(cfg)
        for name, sh in tree_leaves_with_path(psh):
            if data_axis in sh.spec:
                fsdp_uses += n_full if name.startswith("scan/") else 1
            else:
                per_step += 1
        per_step += 1
        if seq != "whole":
            ar += n_moe
            counts = n_moe * (cfg.moe.routing != "dense")
        # the encoder's and the cross-attention's k/v over the frames' chunks
        frames = 2 * (cfg.encoder_layers + n_cross) * (seq is not None
                                                        and cfg.encoder_seq % R == 0)
        ag += frames
        rs += frames
        if seq == "chunks":
            n_rwkv = sum(b.mixer == "rwkv" for b in cfg.blocks)
            n_mamba = sum(b.mixer == "mamba" for b in cfg.blocks)
            edges = 2 * n_self + 2 * n_rwkv + n_mamba
            ag += edges + 1
            rs += edges
            perm = 2 * (R - 1) * (n_rwkv + n_mamba)
    per_step += 1 if R * M > 1 else 0
    opt_ar = opt_ag = 0
    if opt_name == "adafactor":
        for _, sh in tree_leaves_with_path(psh):
            if any(mesh.extent(a) > 1 for e in sh.spec if e is not None
                   for a in sharding_mod.norm_axes(e)):
                opt_ar += 3 if len(sh.spec) >= 2 else 1
                opt_ag += 0 if len(sh.spec) >= 2 else 1
    out = {"all_reduce": microbatches * ar + per_step + opt_ar,
           "all_gather": microbatches * (ag + counts + fsdp_uses) + opt_ag,
           "reduce_scatter": microbatches * (rs + fsdp_uses)}
    if perm:
        out["permute"] = microbatches * perm
    return out


def layers_split(cfg, psh, suffix, axis):
    """The layers whose leaf ``suffix`` the specs split over ``axis`` (each
    stacked layer once)."""
    n_full, _ = tt_mod.split_layers(cfg)
    return sum((n_full if name.startswith("scan/") else 1)
               for name, sh in tree_leaves_with_path(psh)
               if name.endswith(suffix) and axis in sh.spec)


def blocks_of(x):
    """A slab leaf's stored tensors: a placed leaf's blocks, else the leaf."""
    return x.blocks if isinstance(x, Placed) else [x]


# The phase runs as it is on more than one card too (phase 16 alone, to see
# the two slabs on two cards): it waits for, and reads the peak of, every card.
def sync_cards():
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def reset_cards_peak():
    for i in range(torch.cuda.device_count()):
        torch.cuda.reset_peak_memory_stats(i)


def cards_peak_gib() -> float:
    """The largest peak allocation of any card since the last reset."""
    return max(torch.cuda.max_memory_allocated(i)
               for i in range(torch.cuda.device_count())) / 2 ** 30


def cold_batches(cfg, steps: int):
    """Each slab's own token stream: ``steps`` batches of TRAIN_BATCH x
    TRAIN_SEQ, slab ``c`` from seed 16 + c; stacked ``[steps, C, B, S]``."""
    streams = [train_launcher.token_stream(cfg, steps=steps, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                                           seed=16 + c) for c in range(COLD_C)]
    return np.stack([s.reshape(steps, TRAIN_BATCH, TRAIN_SEQ) for s in streams], 1)


def cold_local_steps(step, run, batches, batch_sh, card, what, want=None):
    """``len(batches)`` cold steps on ``run["state"]`` (held only there, so
    each step's input is freed when its output replaces it), timed; each
    step's collectives must equal ``want`` (none by default), none over the
    contributor axis.  Returns the per-slab step times (ms)."""
    want = want or NO_COLLECTIVES
    per_slab = []
    for toks in batches:
        mesh_mod.reset_collectives()
        sync_cards()
        t0 = time.perf_counter()
        run["state"], m = step(run["state"], shard_batch({"tokens": toks}, batch_sh["tokens"]))
        losses = m["loss"].tolist()
        sync_cards()
        per_slab.append((time.perf_counter() - t0) * 1e3 / COLD_C)
        check(all(math.isfinite(x) for x in losses + m["grad_norm"].tolist()),
              f"{what}: a loss or grad_norm is not finite: {losses}")
        check(mesh_mod.collectives == want and "contrib" not in mesh_mod.collectives_by_axis,
              f"{what}: a local step ran collectives {mesh_mod.collectives} "
              f"{mesh_mod.collectives_by_axis}, expected {want}, none over contrib")
    emb = [blocks_of(x)[0] for x in run["state"]["params"]["embed"]]
    div = (emb[0] - emb[1].to(emb[0].device)).abs().max().item()
    check(div > 0, f"{what}: the slabs did not diverge")
    print(f"[cold-mesh] {what}: {len(batches)} cold steps of {COLD_C} slabs, per slab "
          f"{[round(x, 1) for x in per_slab]} ms (PR 21's plain step {PR21_STEP_MS} ms), losses "
          f"{[round(x, 4) for x in losses]}; collectives a local step {want} "
          f"({dict(mesh_mod.collectives_by_axis)} by axis, none over contrib); the slabs' "
          f"embed differs by max {div:.4g}; peak so far {cards_peak_gib():.2f} GiB; on {card}")
    return per_slab


def cold_fuse_checked(cfg, mesh, state, alpha, h, card):
    """``make_fuse_step(flat=True)`` timed, with exactly one all-reduce;
    against the per-leaf path (1 f32 ulp of the operands) and, at alpha 1,
    the slabs equal bit for bit, else the spread (1 - alpha) times the old
    one (3 f32 ulps: two roundings in the fuse, two in the check).  ``h``
    local steps came before it.  Returns the fused params and a record."""
    sched = ColdSchedule(alpha=alpha)
    params = state["params"]
    mesh_mod.reset_collectives()
    sync_cards()
    t0 = time.perf_counter()
    fused = make_fuse_step(cfg, mesh, sched, flat=True)(params)
    sync_cards()
    flat_ms = (time.perf_counter() - t0) * 1e3
    cols, nbytes = dict(mesh_mod.collectives), dict(mesh_mod.collective_bytes)
    check(cols["all_reduce"] == 1, f"flat fuse (alpha {alpha}): {cols}, expected 1 all-reduce")
    mesh_mod.reset_collectives()
    sync_cards()
    t0 = time.perf_counter()
    per_leaf = make_fuse_step(cfg, mesh, sched, flat=False)(params)
    sync_cards()
    leaf_ms = (time.perf_counter() - t0) * 1e3
    leaf_cols = dict(mesh_mod.collectives)
    worst, unequal, spread_worst, slab_diff = 0.0, 0, 0.0, 0.0
    flat_leaves = dict(tree_leaves_with_path(fused))
    leaf_leaves = dict(tree_leaves_with_path(per_leaf))
    for name, slabs in tree_leaves_with_path(params):
        # compared block by stored block on slab 0's card, each slab's brought there
        for i, b0 in enumerate(blocks_of(slabs[0])):
            dev = b0.device
            xs = [blocks_of(x)[i].to(dev) for x in slabs]
            got = [blocks_of(x)[i].to(dev) for x in flat_leaves[name]]
            want = [blocks_of(x)[i].to(dev) for x in leaf_leaves[name]]
            ops_mag = torch.maximum(xs[0].abs(), xs[1].abs())
            for g, w in zip(got, want):
                d = (g - w).abs()
                unequal += int((d > 0).sum())
                worst = max(worst, (d / f32_ulp(ops_mag)).max().item())
            if alpha == 1.0:
                slab_diff = max(slab_diff, (got[0] - got[1]).abs().max().item())
            else:
                err = ((got[0] - got[1]) - (xs[0] - xs[1]) * (1 - alpha)).abs()
                spread_worst = max(spread_worst, (err / f32_ulp(ops_mag)).max().item())
    check(worst <= 1, f"flat fuse (alpha {alpha}) differs from the per-leaf path by {worst:.3g} "
          "f32 ulps of the operands")
    if alpha == 1.0:
        check(slab_diff == 0, f"after the alpha 1 fuse the slabs differ by {slab_diff:.3g}")
        agree = "the slabs equal bit for bit"
    else:
        check(spread_worst <= 3, f"after the alpha {alpha} fuse the spread is off by "
              f"{spread_worst:.3g} f32 ulps")
        agree = (f"slab 0 - slab 1 = {1 - alpha:g} x the old spread within {spread_worst:.3g} "
                 "f32 ulps of the operands (bound 3)")
    del per_leaf, leaf_leaves
    P = sum(x[0].numel() for _, x in tree_leaves_with_path(params))
    sync_dp = 2 * (COLD_C - 1) * P * 4
    print(f"[cold-mesh] fuse alpha {alpha}: flat {flat_ms:.1f} ms, collectives {cols} carrying "
          f"{nbytes} bytes; per-leaf {leaf_ms:.1f} ms, {leaf_cols['all_reduce']} all-reduces; flat "
          f"vs per-leaf max {worst:.3g} f32 ulps of the operands ({unequal} elements not equal); "
          f"{agree}; bytes across the contributor axis {nbytes['all_reduce']:,} a fuse = "
          f"{nbytes['all_reduce'] / sync_dp:.6f} x sync-DP's 2(C-1)P*4 = {sync_dp:,} a step, "
          f"{nbytes['all_reduce'] / h / sync_dp:.6f} x a step over the {h} local steps; on "
          f"{card}")
    return fused, {"alpha": alpha, "flat_ms": flat_ms, "per_leaf_ms": leaf_ms,
                   "collectives": cols, "bytes": nbytes, "per_leaf_all_reduces":
                   leaf_cols["all_reduce"], "flat_vs_per_leaf_ulps": worst,
                   "sync_dp_bytes_per_step": sync_dp}


def cold_state(cfg, opt, mesh, batches):
    """The train state from seed 0 stacked for COLD_C contributors and
    placed on ``mesh`` by ``cold_shardings``; every slot's placed bytes
    must equal ``dryrun.slot_bytes`` of the same state and specs.  Returns
    (the placed state, state shardings, batch shardings)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    stacked = stack_for_contributors(make_train_state(init_lm(cfg, gen, device="cuda"), opt),
                                     COLD_C)
    state_sh, batch_sh = cold_shardings(mesh, cfg, stacked, {"tokens": batches[0]})
    want = dryrun_mod.slot_bytes(stacked, state_sh, mesh)
    state = device_put(stacked, state_sh)
    del stacked
    got = sharding_mod.placed_slot_bytes(state, mesh)
    check(got == [want] * mesh.devices.size, f"placed bytes a slot {got}, dryrun.slot_bytes "
          f"{want:,}")
    return state, state_sh, batch_sh


def cold_whole(cfg, opt, batches, card, records):
    """Phase 16 (a): the slabs whole on a (2, 1, 1) mesh, each equal bit for
    bit to the plain step run alone on it, then both fuses."""
    mesh = mesh_mod.make_cold_mesh(device="cuda", **COLD_WHOLE_MESH)
    state, state_sh, batch_sh = cold_state(cfg, opt, mesh, batches)
    run = {"state": state}
    del state
    emb = run["state"]["params"]["embed"]
    check(isinstance(emb, list) and isinstance(emb[0], torch.Tensor)
          and tuple(state_sh["opt"]["step"].spec) == (), "the cold state's placement")
    slab_devs = [str(x.device) for x in emb]
    print(f"[cold-mesh] (a) {mesh!r}: the {COLD_C} slabs whole on {slab_devs}, "
          f"{torch.cuda.device_count()} card(s)")
    del emb
    cold = make_cold_train_step(cfg, opt)
    records.update(whole_mesh=repr(mesh), slab_devices=slab_devs, local_ms=[])
    records["local_ms"] += cold_local_steps(cold, run, batches[:COLD_H[0]], batch_sh, card,
                                            "(a) round 1")
    # each slab against the plain step run alone on the same slab and batches
    plain = make_train_step(cfg, opt)
    for c in range(COLD_C):
        gen = torch.Generator(device="cuda").manual_seed(0)
        alone = make_train_state(init_lm(cfg, gen, device="cuda"), opt)
        for toks in batches[:COLD_H[0], c]:
            alone, _ = plain(alone, {"tokens": toks})
        mine = dict(tree_leaves_with_path(slab(run["state"], c)))
        same = [k for k, v in tree_leaves_with_path(alone)
                if (torch.equal(v.to(mine[k].device), mine[k]) if isinstance(v, torch.Tensor)
                    else v == mine[k])]
        check(len(same) == len(mine), f"slab {c} differs from the plain step run alone in "
              f"{len(mine) - len(same)} of {len(mine)} leaves")
        del alone, mine
    print(f"[cold-mesh] (a) each of the {COLD_C} slabs equals make_train_step run alone on it "
          f"({COLD_H[0]} steps), params, m, v and step bit for bit")
    fused, rec1 = cold_fuse_checked(cfg, mesh, run["state"], COLD_ALPHAS[0], COLD_H[0], card)
    run["state"] = {"params": fused, "opt": run["state"]["opt"]}
    del fused
    records["local_ms"] += cold_local_steps(cold, run, batches[COLD_H[0]:], batch_sh, card,
                                            "(a) round 2")
    _, rec2 = cold_fuse_checked(cfg, mesh, run.pop("state"), COLD_ALPHAS[1], COLD_H[1], card)
    records["fuses"] = [rec1, rec2]


def cold_partitioned_sgd(cfg, mesh, batches, card):
    """Phase 16 (b), first: one SGD cold step partitioned over each slab's
    (2, 2) sub-grid against ``make_train_step`` on the whole slab: the
    gathered gradients (``grad_sync`` sees them reduced), loss, grad_norm
    and new params within PARTITIONED_RTOL / ATOL.  Returns a record."""
    opt = make_optimizer("sgd", constant_lr(PARTITIONED_SGD_LR))
    state, _, batch_sh = cold_state(cfg, opt, mesh, batches)
    batch = shard_batch({"tokens": batches[0]}, batch_sh["tokens"])
    grads = []
    local = make_train_step(cfg, opt, grad_sync=lambda g: grads.append(g) or g)
    mesh_mod.reset_collectives()
    sync_cards()
    t0 = time.perf_counter()
    outs = [local(slab(state, c), slab(batch, c)) for c in range(COLD_C)]
    sync_cards()
    step_ms = (time.perf_counter() - t0) * 1e3 / COLD_C
    cols = dict(mesh_mod.collectives)
    del state
    worst = {"grads": 0.0, "params": 0.0, "loss": 0.0, "grad_norm": 0.0}

    def held(what, got, want):
        err = ((got - want).abs() - PARTITIONED_ATOL - PARTITIONED_RTOL * want.abs()).max()
        check(err.item() <= 0, f"partitioned SGD step: {what} off by more than rtol/atol "
              f"{PARTITIONED_RTOL:g}/{PARTITIONED_ATOL:g}")
        rel = ((got - want).abs().max() / want.abs().max().clamp(min=1e-30)).item()
        return rel

    whole = make_train_step(cfg, opt, grad_sync=lambda g: grads.append(g) or g)
    for c in range(COLD_C):
        gen = torch.Generator(device="cuda").manual_seed(0)
        new, m = whole(make_train_state(init_lm(cfg, gen, device="cuda"), opt),
                       {"tokens": batches[0, c]})
        mine_g = dict(tree_leaves_with_path(sharding_mod.gather(grads[c])))
        mine_p = dict(tree_leaves_with_path(sharding_mod.gather(outs[c][0]["params"])))
        for k, v in tree_leaves_with_path(grads.pop()):
            worst["grads"] = max(worst["grads"], held(f"slab {c} grad {k}", mine_g[k], v))
        for k, v in tree_leaves_with_path(new["params"]):
            worst["params"] = max(worst["params"], held(f"slab {c} param {k}", mine_p[k], v))
        for key in ("loss", "grad_norm"):
            got, want = outs[c][1][key].float(), m[key].float().to(outs[c][1][key].device)
            rel = ((got - want).abs() / want.abs()).item()
            check(rel <= PARTITIONED_RTOL, f"slab {c} {key} {got.item()} vs {want.item()}")
            worst[key] = max(worst[key], rel)
        del new, m, mine_g, mine_p
        grads[c] = None
    print(f"[cold-mesh] (b) one SGD cold step partitioned over each slab's (replica 2, model 2) "
          f"slots: {step_ms:.1f} ms a slab, collectives {cols}; against make_train_step on the "
          f"whole slab: largest difference over a leaf's largest value, gradients "
          f"{worst['grads']:.3g}, new params {worst['params']:.3g}; loss {worst['loss']:.3g} "
          f"and grad_norm {worst['grad_norm']:.3g} relative (bounds rtol/atol "
          f"{PARTITIONED_RTOL:g}); on {card}")
    return {"sgd_step_ms_per_slab": step_ms, "collectives": cols, "worst": worst}


def phase_cold_mesh(card):
    """Phase 16: the model-side ColD mesh at gemma3-1b's full width, (a)
    slabs whole, (b) partitioned.  Returns (the serve's launches, the
    phase's record)."""
    t_phase = time.perf_counter()
    reset_cards_peak()
    reset_launches()
    cfg = train_launcher.train_config("gemma3-1b", reduced=False, seq=TRAIN_SEQ)
    opt = make_optimizer(cfg.optimizer, constant_lr(TRAIN_LR))
    batches = cold_batches(cfg, sum(COLD_H))
    records = {}
    cold_whole(cfg, opt, batches, card, records)
    sync_cards()
    records["peak_gib_whole"] = cards_peak_gib()
    torch.cuda.empty_cache()
    reset_cards_peak()

    # (b) partitioned over each slab's replica x model slots
    mesh = mesh_mod.make_cold_mesh(device="cuda", **COLD_MESH)
    records["partitioned"] = part = {"mesh": repr(mesh)}
    part["sgd"] = cold_partitioned_sgd(cfg, mesh, batches, card)
    torch.cuda.empty_cache()
    state, state_sh, batch_sh = cold_state(cfg, opt, mesh, batches)
    run = {"state": state}
    del state
    emb = run["state"]["params"]["embed"]
    check(all(isinstance(x, Placed) for x in emb), "(b): the slabs are not placed in blocks")
    slab_devs = [sorted({str(d) for d in x.layout.mesh.devices.flat}) for x in emb]
    psh = sharding_mod.params_shardings(sharding_mod.sub_mesh(mesh, 0), slab(
        run["state"]["params"], 0), cfg, data_axis="replica", model_axis="model")
    per_slab = partitioned_collectives(cfg, psh, COLD_MESH["replicas"], COLD_MESH["model"])
    want = {k: COLD_C * v for k, v in per_slab.items()}
    print(f"[cold-mesh] (b) {mesh!r}: each slab split over its 4 slots, on {slab_devs}; "
          f"{len(emb[0].blocks)} stored blocks of embed {tuple(emb[0].shape)} a slab")
    del emb
    cold = make_cold_train_step(cfg, opt)
    part["local_ms"] = cold_local_steps(cold, run, batches[:COLD_H[0]], batch_sh, card,
                                        "(b) round 1", want)
    fused, rec1 = cold_fuse_checked(cfg, mesh, run["state"], COLD_ALPHAS[0], COLD_H[0], card)
    run["state"] = {"params": fused, "opt": run["state"]["opt"]}
    del fused
    part["local_ms"] += cold_local_steps(cold, run, batches[COLD_H[0]:], batch_sh, card,
                                         "(b) round 2", want)
    # one more local step under torch.profiler (its result dropped): where the time goes
    split = device_split(lambda: cold(run["state"], shard_batch({"tokens": batches[-1]},
                                                                 batch_sh["tokens"])))
    print_split("gemma3-1b", "partitioned cold step (2 slabs)",
                COLD_C * part["local_ms"][-1], split)
    part["device_busy_ms"] = None if split is None else split[0]
    fused, rec2 = cold_fuse_checked(cfg, mesh, run.pop("state"), COLD_ALPHAS[1], COLD_H[1], card)
    part.update(fuses=[rec1, rec2], collectives_per_local_step=want)
    serve_params = tree_map(lambda x: x.to(torch.bfloat16),
                            sharding_mod.gather(slab(fused, 0)))
    placed_params = tree_map(lambda x: x.to(torch.bfloat16), slab(fused, 0))
    del fused
    sync_cards()
    part["peak_gib_train_fuse"] = cards_peak_gib()
    torch.cuda.empty_cache()
    counts = launches()
    check(all(n == 0 for n in counts.values()), f"the cold steps and fuses launched {counts}")

    # the fused base served on the kernel path: exact launches by route
    prompts = np.random.default_rng(1).integers(3, GEMMA.vocab_size, (4, GEMMA_PROMPT))
    eng = Engine(GEMMA, serve_params, max_len=GEMMA_MAX_LEN)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = eng.generate(prompts, max_new_tokens=COLD_SERVE_NEW)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    served = launches()
    by_route = dict(flash_attention.launches_by_route)
    want_routes = {k: v // 2 for k, v in serve_routes(GEMMA, GEMMA_PROMPT, COLD_SERVE_NEW).items()}
    check(by_route == want_routes, f"the fused base's generate launched flash_attention "
          f"{by_route} by route, expected {want_routes}")
    check(res.tokens.shape == (4, GEMMA_PROMPT + COLD_SERVE_NEW), "fused base: generate shape")
    gen_k = res.tokens[:, GEMMA_PROMPT:]
    serve_agreement("gemma3-1b (fused base)", GEMMA,
                    lambda: teacher_forced(GEMMA, serve_params, prompts, gen_k, GEMMA_MAX_LEN),
                    gen_k)
    del eng

    # the same base served partitioned on the slab's own grid (phase 19's
    # path), held against the gathered serve by phase 19's rule
    grid = placed_params["embed"].layout.mesh
    ref = whole_reference(GEMMA, serve_params, prompts, GEMMA_MAX_LEN, COLD_SERVE_NEW, tokens=gen_k)
    del serve_params
    eng = Engine(GEMMA, placed_params, max_len=GEMMA_MAX_LEN)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = eng.generate(prompts, max_new_tokens=COLD_SERVE_NEW)
    torch.cuda.synchronize()
    part_s = time.perf_counter() - t0
    served_part = launches()
    part_routes = check_pserve_launches("the fused base partitioned", GEMMA, GEMMA_PROMPT,
                                        COLD_SERVE_NEW, grid)[0]
    same = int((res.tokens[:, GEMMA_PROMPT:] == gen_k).sum())
    agreement = tp_agreement("gemma3-1b (fused base, partitioned on its slab's grid)",
                             stepped(GEMMA, placed_params, prompts, GEMMA_MAX_LEN, gen_k)[1], ref)
    del eng, placed_params, ref
    records.update(serve_s=gen_s, flash_routes=by_route, peak_gib=cards_peak_gib(),
                   partitioned_serve={"grid": repr(grid), "serve_s": part_s,
                                      "flash_routes": part_routes, "tokens_equal": same,
                                      "agreement": agreement},
                   seconds=time.perf_counter() - t_phase)
    print(f"[cold-mesh] the fused base (slab 0 of (b), gathered, bf16) served 4 x "
          f"{GEMMA_PROMPT} -> {COLD_SERVE_NEW} in {gen_s:.3f} s, flash_attention by route {by_route} "
          f"(exactly as worked out); partitioned on {grid!r} in {part_s:.3f} s, by route "
          f"{part_routes} (exactly), its tokens equal the gathered serve's at "
          f"{same}/{gen_k.size}; peak {records['peak_gib_whole']:.2f} GiB over (a)'s steps "
          f"and fuses, {part['peak_gib_train_fuse']:.2f} GiB over (b)'s, "
          f"{records['peak_gib']:.2f} GiB with the serves; phase {records['seconds']:.1f} s on "
          f"{card}")
    return served, served_part, records


# ---------------------------------------------------------------------------
# slice 13: the dry-run tooling (phase 17)
# ---------------------------------------------------------------------------

# phase 17 (a): runs of the dry-run CLI, started together on the host with no
# card visible, beside phases 5-16.  The partitioned step traces every slot of
# a sub-grid (the model axis whole: 32 slots on pod1), 1.6 to 168 s an artifact
# on one host core (jamba's MoE widens its grid to 128 slots: 168 s; gemma3-1b's
# train_4k 108 s; its long_500k on the full 256-slot grid about two minutes),
# so the sweep runs every arch at decode_32k on pod1 (two processes),
# gemma3-1b's prefill and decode on both meshes and its train step on pod1,
# and its ColD step, and leaves the rest (DRYRUN_LEFT) to the CLI
DRYRUN_RUNS = (["--arch", "jamba-1.5-large-398b", "whisper-tiny", "gemma3-1b",
                "--shape", "decode_32k", "--mesh", "pod1"],
               ["--arch", "mistral-nemo-12b", "granite-moe-1b-a400m", "qwen2-vl-72b",
                "stablelm-12b", "granite-20b", "mixtral-8x7b", "rwkv6-7b",
                "--shape", "decode_32k", "--mesh", "pod1"],
               ["--arch", "gemma3-1b", "--shape", "prefill_32k", "decode_32k", "--mesh", "both"],
               ["--arch", "gemma3-1b", "--shape", "train_4k", "--mesh", "pod1"],
               ["--arch", "gemma3-1b", "--shape", "train_4k", "--strategy", "cold",
                "--cold-mesh", "8x2"])
DRYRUN_LEFT = ("decode_32k of the other nine archs on pod2; train_4k and prefill_32k of the "
               "other nine on pod1 and pod2; gemma3-1b's train_4k on pod2; long_500k (the full "
               "256- or 512-slot grid) of its four archs; --strategy dp: python -m "
               "repro_torch.launch.dryrun --all --mesh both [--strategy dp]")
# (b): phase 9's gemma3-1b bf16 prefill, then one decode step at cache
# GEMMA_MAX_LEN; each layer one flash_attention call on the route the card takes
DRYRUN_PREFILL_ROUTES = {"prefill_tc": GEMMA.num_layers}
DRYRUN_DECODE_ROUTES = {"decode": GEMMA.num_layers, "decode_combine": GEMMA.num_layers}
# (c): phase 12's f32 AdamW step at TRAIN_BATCH x TRAIN_SEQ; its counted FLOPs
# within TRAIN_FLOPS_RTOL of the analytic count; the predicted peak printed
# beside the card's with the tolerance PERF.md states before the run
TRAIN_FLOPS_RTOL = 0.02
PEAK_RTOL = 0.10


def dryrun_sweep_start():
    """Phase 17 (a)'s CLI runs of ``DRYRUN_RUNS`` and phase 27's meta traces
    (``pdryrun_meta``), started as processes with no card visible, one
    thread each: they trace on the meta device beside the card's phases
    until ``dryrun_sweep`` and ``phase_pdryrun`` collect them (the script's
    1200 s budget cannot hold them in line).  ``stop_sweep`` ends them."""
    root = os.path.dirname(os.path.abspath(__file__))
    src = os.path.join(root, "src")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(filter(None, [src, os.environ.get("PYTHONPATH")])))
    workdir = tempfile.mkdtemp(prefix="chip_smoke-dryrun-")
    out = os.path.join(workdir, "dryrun_torch")
    procs = [subprocess.Popen([sys.executable, "-m", "repro_torch.launch.dryrun", *argv, "--out",
                               out, "--force"], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for argv in DRYRUN_RUNS]
    meta = os.path.join(workdir, "pdryrun_meta.json")
    pdry = subprocess.Popen(
        [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); import chip_smoke; "
         "chip_smoke.pdryrun_meta(sys.argv[2])", root, meta], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    return {"workdir": workdir, "out": out, "procs": procs, "t0": time.perf_counter(),
            "pdryrun": (pdry, meta)}


def stop_sweep(sweep):
    for p in sweep["procs"] + [sweep["pdryrun"][0]]:
        if p.poll() is None:
            p.kill()
            p.wait()
    shutil.rmtree(sweep["workdir"], ignore_errors=True)


def dryrun_sweep(sweep):
    """Phase 17 (a): the started CLI runs collected, every artifact printed
    as a line (the three roofline terms, the bottleneck, the peak a chip).
    Returns the rows and the sum of the artifacts' trace seconds."""
    out, procs = sweep["out"], sweep["procs"]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for argv, p, log in zip(DRYRUN_RUNS, procs, logs):
        check(p.returncode == 0, f"dryrun {' '.join(argv)} exited {p.returncode}:\n{log[-3000:]}")
    rows = []
    for name in sorted(os.listdir(out)):
        res = json.load(open(os.path.join(out, name)))
        if res.get("skipped"):
            print(f"[dryrun] {res['arch']} {res['shape']} {res['mesh']}: skipped ({res['reason']})")
            continue
        check(res["ok"] and res["partitioned"] is True, f"dryrun artifact {name}: {res}")
        r, mem, t = res["roofline"], res["memory_analysis"], res["traced"]
        cols = res["collectives"]
        row = {"arch": res["arch"], "shape": res["shape"], "mesh": res["mesh"],
               "strategy": res["strategy"], "traced_grid": t["grid"], "slots": t["slots"],
               "layout": t["layout"], "rows_a_slot": t["rows_a_slot"],
               "flops_per_chip": r["flops_per_chip"], "hbm_bytes_per_chip": r["hbm_bytes_per_chip"],
               "compute_ms": r["compute_s"] * 1e3, "memory_ms": r["memory_s"] * 1e3,
               "collective_ms": r["collective_s"] * 1e3,
               "collective_bytes_by_axis": {a: sum(k["bytes_per_slot"] for k in kinds.values())
                                            for a, kinds in cols["by_axis"].items()},
               "bottleneck": r["bottleneck"],
               "peak_gib": mem["peak_memory_in_bytes"] / 2**30,
               "traced_peak_gib": mem["traced_peak_bytes"] / 2**30,
               "trace_s": res["trace_wall_s"]}
        rows.append(row)
        by_axis = ", ".join(f"{a} {b / 1e9:.3g} GB" for a, b in
                            row["collective_bytes_by_axis"].items())
        print(f"[dryrun] {row['arch']} {row['shape']} {row['mesh']} ({row['strategy']}), traced "
              f"on {row['traced_grid']} ({row['slots']} of {res['chips']} slots, "
              f"{row['rows_a_slot']} rows a slot, {row['layout']}): compute "
              f"{row['compute_ms']:.2f} ms, memory {row['memory_ms']:.2f} ms, collective "
              f"{row['collective_ms']:.2f} ms ({by_axis} a chip) -> {row['bottleneck']}; peak "
              f"{row['peak_gib']:.2f} GiB a slot, {row['traced_peak_gib']:.2f} GiB on one card "
              f"running the traced slots; traced in {row['trace_s']:.1f} s")
        if "fuse" in res:
            fc = res["fuse"]["collectives"]
            print(f"[dryrun]   its fuse: all-reduce {fc['count_by_kind'].get('all-reduce', 0)} "
                  f"x {fc['bytes_by_kind'].get('all-reduce', 0):,.0f} bytes, all-gather "
                  f"{fc['count_by_kind'].get('all-gather', 0)}")
    seconds = sum(row["trace_s"] for row in rows)
    print(f"[dryrun] sweep: {len(DRYRUN_RUNS)} CLI processes (no card visible, started "
          f"{time.perf_counter() - sweep['t0']:.1f} s before and run beside the card's phases), "
          f"{len(rows)} artifacts traced in {seconds:.1f} s summed; left to the CLI: "
          f"{DRYRUN_LEFT}")
    return rows, seconds


def roofline_line(what, oc, model_flops, dtype, measured_ms):
    """Print a counted step's roofline beside its measured time; returns
    the record."""
    roof = Roofline(flops=oc.flops, hbm_bytes=oc.hbm_bytes, collective_bytes=0.0,
                    model_flops=model_flops, chips=1, dtype=dtype)
    mfu = model_flops / roof.peak / (measured_ms / 1e3)
    share = roof.step_time_s * 1e3 / measured_ms
    print(f"[dryrun] {what}: {oc.flops / 1e9:.2f} GFLOP counted ({model_flops / 1e9:.2f} model), "
          f"{oc.hbm_bytes / 1e9:.2f} GB eager op bytes; roofline compute "
          f"{roof.compute_s * 1e3:.3f} ms, memory {roof.memory_s * 1e3:.3f} ms -> "
          f"{roof.bottleneck}, step {roof.step_time_s * 1e3:.3f} ms; measured {measured_ms:.3f} "
          f"ms (the roofline step {share:.4f} of it); mfu = model_flops / peak / measured = "
          f"{mfu:.4f} (the roofline's {roof.mfu:.4f})")
    return {"flops": oc.flops, "hbm_bytes": oc.hbm_bytes, "model_flops": model_flops,
            "roofline_step_ms": roof.step_time_s * 1e3, "bottleneck": roof.bottleneck,
            "measured_ms": measured_ms, "roofline_share": share, "mfu": mfu,
            "roofline_mfu": roof.mfu}


def dryrun_serve(card):
    """Phase 17 (b): gemma3-1b's bf16 prefill (4 x GEMMA_PROMPT, cache
    GEMMA_MAX_LEN) and one decode step counted on the meta device and on
    the card: equal FLOPs, the counter's kernel calls by route equal to the
    card's launches by route."""
    B, P, L = 4, GEMMA_PROMPT, GEMMA_MAX_LEN
    serve = make_serve_step(GEMMA)

    def counted(params, tokens, device):
        cache = init_cache(GEMMA, B, L, device=device)
        reset_launches()
        with OpCounter() as pre:
            logits = forward_lm(GEMMA, params, tokens, cache=cache, cache_index=0)[0][:, -1]
        pre_launch, total = dict(fa_mod.flash_attention.launches_by_route), launches()
        nxt = torch.argmax(logits, dim=-1)[:, None]
        reset_launches()
        with OpCounter() as dec:
            serve(params, cache, nxt, P)
        total = {k: n + launches()[k] for k, n in total.items()}
        return pre, dec, pre_launch, dict(fa_mod.flash_attention.launches_by_route), total

    with torch.no_grad():
        meta = counted(abstract_params(GEMMA), torch.empty((B, P), dtype=torch.int64,
                                                           device="meta"), "meta")
        check(meta[2] == meta[3] == dict.fromkeys(meta[2], 0), "the meta trace launched")
        gen = torch.Generator(device="cuda").manual_seed(0)
        params = init_lm(GEMMA, gen, device="cuda")
        tokens = torch.randint(0, GEMMA.vocab_size, (B, P), generator=gen, device="cuda")
        card_run = counted(params, tokens, "cuda")
    out = {}
    for i, (what, want) in enumerate((("prefill", DRYRUN_PREFILL_ROUTES),
                                      ("decode step", DRYRUN_DECODE_ROUTES))):
        m, c, launched = meta[i], card_run[i], card_run[2 + i]
        launched = {r: n for r, n in launched.items() if n}
        print(f"[dryrun] gemma3-1b {what}: FLOPs meta {m.flops:,.0f}, card {c.flops:,.0f}; "
              f"flash_attention by route: meta {m.calls('flash_attention')}, card counter "
              f"{c.calls('flash_attention')}, card launches {launched}")
        check(m.flops == c.flops, f"gemma3-1b {what}: meta FLOPs {m.flops} != card {c.flops}")
        check(m.calls("flash_attention") == c.calls("flash_attention") == launched == want,
              f"gemma3-1b {what}: kernel calls by route differ from the launches {want}")
        out[what] = (m, c)
    torch.cuda.synchronize()

    def prefill_once():
        cache = init_cache(GEMMA, B, L, device="cuda")
        forward_lm(GEMMA, params, tokens, cache=cache, cache_index=0)
        return cache

    with torch.no_grad():
        pre_ms, _ = timed_ms(lambda: prefill_once(), runs=5)
        cache = prefill_once()
        nxt = tokens[:, -1:]
        dec_ms, _ = timed_ms(lambda: serve(params, cache, nxt, P), runs=20)
    n = GEMMA.active_param_count()
    rec = {"prefill": roofline_line(f"gemma3-1b prefill 4 x {P} bf16 on {card}", out["prefill"][1],
                                    model_flops_per_step(n, B * P, training=False), "bfloat16",
                                    pre_ms),
           "decode": roofline_line(f"gemma3-1b decode step at cache {L} bf16 on {card}",
                                   out["decode step"][1],
                                   model_flops_per_step(n, B, training=False), "bfloat16",
                                   dec_ms)}
    del params, cache
    torch.cuda.empty_cache()
    return rec, card_run[4]


def dryrun_train(card):
    """Phase 17 (c): phase 12's gemma3-1b f32 AdamW step counted on the meta
    device (FLOPs against 6·N·D plus the full S x S attention of every
    layer, the predicted peak) and on the card (equal FLOPs, the measured
    peak and median step time)."""
    cfg = train_launcher.train_config("gemma3-1b", reduced=False, seq=TRAIN_SEQ)
    opt = make_optimizer(cfg.optimizer, warmup_cosine_lr(TRAIN_LR, warmup=20, total=TRAIN_STEPS))
    step = make_train_step(cfg, opt)
    B, S = TRAIN_BATCH, TRAIN_SEQ
    mstate = make_train_state(abstract_params(cfg), opt)
    mbatch = {"tokens": torch.empty((B, S), dtype=torch.int64, device="meta")}
    with OpCounter() as meta:
        step(mstate, mbatch)
    predicted = tree_bytes(mstate) + tree_bytes(mbatch) + meta.peak_live_bytes
    d, f, v, L = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.num_layers
    hd, nq, nkv = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
    n_mat = L * (d * nq * hd + 2 * d * nkv * hd + nq * hd * d + 3 * d * f) + d * v
    analytic = 6 * n_mat * B * S + 3 * L * 2 * B * S * S * nq * hd * 2
    ratio = meta.flops / analytic
    print(f"[dryrun] gemma3-1b f32 train step {B} x {S}: counted {meta.flops:,.0f} FLOPs, "
          f"6·N·D + attention {analytic:,} (ratio {ratio:.6f}, bound {TRAIN_FLOPS_RTOL:g}); "
          f"predicted peak {predicted / 2**30:.2f} GiB (the state {tree_bytes(mstate) / 2**30:.2f} "
          f"held, then {meta.peak_live_bytes / 2**30:.2f} at most allocated by the step)")
    check(abs(ratio - 1) <= TRAIN_FLOPS_RTOL, f"train step FLOPs {ratio:.4f} of the analytic")
    del mstate

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    m0 = torch.cuda.memory_allocated()
    params = train_launcher.build_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                                         "cuda")
    state = make_train_state(params, opt)
    del params
    batch = {"tokens": train_launcher.token_stream(cfg, steps=1, batch=B, seq=S, seed=0)}
    torch.cuda.reset_peak_memory_stats()
    with OpCounter() as card_oc:
        new, m = step(state, batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - m0
    check(math.isfinite(float(m["loss"])), "the counted train step's loss is not finite")
    del new, m
    print(f"[dryrun] gemma3-1b f32 train step on {card}: FLOPs meta {meta.flops:,.0f}, card "
          f"{card_oc.flops:,.0f}; peak above what was allocated before {peak / 2**30:.2f} GiB "
          f"(torch.cuda.max_memory_allocated) against the predicted {predicted / 2**30:.2f} GiB: "
          f"{peak / predicted - 1:+.2%} (tolerance {PEAK_RTOL:.0%}: "
          f"{'within' if abs(peak / predicted - 1) <= PEAK_RTOL else 'outside'})")
    check(card_oc.flops == meta.flops, "train step FLOPs differ between the meta device and the card")
    times = []
    for _ in range(6):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out, m = step(state, batch)
        float(m["loss"])
        times.append((time.perf_counter() - t) * 1e3)
        del out, m
    measured = float(np.median(times[1:]))
    print(f"[dryrun] gemma3-1b f32 train step on {card}: {[round(x, 1) for x in times]} ms, "
          f"median after the first {measured:.1f}")
    rec = roofline_line(f"gemma3-1b f32 train step {B} x {S} on {card}", meta,
                        model_flops_per_step(cfg.active_param_count(), B * S, training=True),
                        "float32", measured)
    rec.update(analytic_flops=analytic, ratio=ratio, predicted_peak_gib=predicted / 2**30,
               measured_peak_gib=peak / 2**30, step_ms=times)
    del state
    torch.cuda.empty_cache()
    return rec


def phase_dryrun(card, sweep=None):
    """Phase 17: the dry-run tooling, its CLI runs started by
    ``dryrun_sweep_start`` (here, unless ``sweep`` was started earlier).
    Returns the launches of (b)'s counted prefill and decode step on the
    card, and the phase's record."""
    t0 = time.perf_counter()
    own = sweep is None   # a sweep started by main() runs on for phase 27's meta traces
    sweep = sweep or dryrun_sweep_start()
    try:
        rows, sweep_s = dryrun_sweep(sweep)
    finally:
        if own:
            stop_sweep(sweep)
    serve, counts = dryrun_serve(card)
    train = dryrun_train(card)
    seconds = time.perf_counter() - t0
    print(f"[dryrun] phase 17: {seconds:.1f} s on {card}")
    return counts, {"sweep": rows, "sweep_trace_s": sweep_s, "left_to_cli": DRYRUN_LEFT,
                    "serve": serve, "train": train, "seconds": seconds}


# ---------------------------------------------------------------------------
# slice 14: the partitioned train step with FSDP (phase 18)
# ---------------------------------------------------------------------------

# mistral-nemo-12b at full width, cut to NEMO_LAYERS of its 40 layers (depth
# only), f32, SGD at NEMO_BATCH x NEMO_SEQ on a (replica 2, model 2) grid
NEMO_LAYERS, NEMO_BATCH, NEMO_SEQ, NEMO_GRID = 4, 4, 64, (2, 2)
NEMO_KEEP = ("final_norm/scale", "scan/pos0/norm2/scale", "scan/pos0/attn/wk",
             "scan/pos0/attn/wo")
NEMO_PEAK_RTOL = 0.10   # the step's peak allocation against nemo_peak_bytes (PERF.md §5)


def nemo_peak_bytes(cfg, P: int) -> int:
    """The partitioned SGD step's reckoned peak allocation (PERF.md §5): the
    larger of (1) the update, where the placed params, the clipped
    gradients, SGD's updates and the new params are held at once (4 P; the
    unclipped gradients are freed when clipping returns), and (2) the start
    of the backward: the params, the FSDP all-gathers autograd keeps for the
    backward (each slot's copy of its model block gathered over ``replica``:
    R times every layer's weights and the untied lm_head; the embedding's
    gather is freed after the lookup), then the lm_head's gathered gradient
    (R times it again) and its reduce-scattered blocks."""
    R = NEMO_GRID[0]
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.head_dim
    layer = 4 * (d * cfg.num_heads * hd * 2 + d * cfg.num_kv_heads * hd * 2 + 3 * d * f)
    head = 4 * d * cfg.vocab_size
    backward = P + R * cfg.num_layers * layer + R * head + R * head + head
    return max(4 * P, backward)


def phase_partitioned(card):
    """Phase 18: mistral-nemo-12b (``NEMO_LAYERS`` layers, f32, FSDP) one SGD
    step whole, then the same step partitioned over (replica 2, model 2).
    Returns the phase's record."""
    t_phase = time.perf_counter()
    reset_launches()
    base = get_config("mistral-nemo-12b")
    cfg = dataclasses.replace(base, num_layers=NEMO_LAYERS, param_dtype="float32",
                              compute_dtype="float32")
    n_params = cfg.param_count()
    P = 4 * n_params
    print(f"[partitioned] {base.name} at full width (d {cfg.d_model}, {cfg.num_heads}:"
          f"{cfg.num_kv_heads} heads of {cfg.head_dim}, F {cfg.d_ff}, vocab {cfg.vocab_size}, "
          f"untied {not cfg.tie_embeddings}, fsdp {cfg.fsdp}), cut to {cfg.num_layers} of its "
          f"{base.num_layers} layers (num_layers only): {n_params:,} parameters, {P:,} bytes "
          f"in f32; SGD at {NEMO_BATCH} x {NEMO_SEQ}")
    check(cfg.fsdp, "mistral-nemo-12b's config sets fsdp")
    opt = make_optimizer("sgd", constant_lr(PARTITIONED_SGD_LR))
    toks = np.random.default_rng(18).integers(3, cfg.vocab_size, (2, NEMO_BATCH, NEMO_SEQ))

    def fresh_state():
        gen = torch.Generator(device="cuda").manual_seed(0)
        return make_train_state(init_lm(cfg, gen, device="cuda"), opt)

    # the whole step first: keep its loss, grad_norm and NEMO_KEEP's
    # gradients and new values, free the rest
    kept = {}

    def keep(grads):
        kept.update({k: v for k, v in tree_leaves_with_path(grads) if k in NEMO_KEEP})
        return grads

    state = fresh_state()
    torch.cuda.synchronize()
    reset_cards_peak()
    t0 = time.perf_counter()
    new, m = make_train_step(cfg, opt, grad_sync=keep)(state, {"tokens": toks[0]})
    torch.cuda.synchronize()
    whole_ms = (time.perf_counter() - t0) * 1e3
    whole_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    want = {"loss": m["loss"].float(), "grad_norm": m["grad_norm"].float(),
            "grads": dict(kept),
            "params": {k: v for k, v in tree_leaves_with_path(new["params"]) if k in NEMO_KEEP}}
    del state, m
    kept.clear()
    t0 = time.perf_counter()  # a second whole step, timed as the partitioned one is
    new, _ = make_train_step(cfg, opt)(new, {"tokens": toks[1]})
    torch.cuda.synchronize()
    whole_second_ms = (time.perf_counter() - t0) * 1e3
    del new, _
    torch.cuda.empty_cache()
    whole_left = torch.cuda.memory_allocated() / 2 ** 30

    # the same state placed on the grid, the same step partitioned
    mesh = make_mesh(NEMO_GRID, ("replica", "model"))
    state = fresh_state()
    psh = sharding_mod.params_shardings(mesh, state["params"], cfg, data_axis="replica",
                                        model_axis="model")
    sh = {"params": psh, "opt": sharding_mod.opt_state_shardings(mesh, state["opt"], psh)}
    slot_want = dryrun_mod.slot_bytes(state, sh, mesh)
    placed = device_put(state, sh)
    del state
    torch.cuda.empty_cache()
    slot_got = sharding_mod.placed_slot_bytes(placed, mesh)
    check(slot_got == [slot_want] * mesh.devices.size,
          f"placed bytes a slot {slot_got}, dryrun.slot_bytes {slot_want:,}")
    specs = {k: tuple(sh.spec) for k, sh in tree_leaves_with_path(psh)
             if k in ("embed", "lm_head", "scan/pos0/attn/wq")}
    step = make_train_step(cfg, opt, grad_sync=keep)
    cols_want = partitioned_collectives(cfg, psh, *NEMO_GRID)
    reckoned = nemo_peak_bytes(cfg, P)
    torch.cuda.synchronize()
    reset_cards_peak()
    held_before = torch.cuda.memory_allocated()
    mesh_mod.reset_collectives()
    t0 = time.perf_counter()
    placed, pm = step(placed, {"tokens": toks[0]})
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated()
    cols, nbytes = dict(mesh_mod.collectives), dict(mesh_mod.collective_bytes)
    by_axis = dict(mesh_mod.collectives_by_axis)
    got_grads = {k: sharding_mod.gather(v) for k, v in kept.items()}
    got_params = {k: sharding_mod.gather(v) for k, v in tree_leaves_with_path(placed["params"])
                  if k in NEMO_KEEP}
    kept.clear()
    worst, failed = {}, []
    for key in ("loss", "grad_norm"):
        got = pm[key].float()
        worst[key] = ((got - want[key].to(got.device)).abs() / want[key].abs()).item()
        if worst[key] > PARTITIONED_RTOL:
            failed.append(f"{key} {got.item()} vs {want[key].item()}")
    for part, got_tree in (("grads", got_grads), ("params", got_params)):
        for k, w in want[part].items():
            g = got_tree[k]
            if ((g - w).abs() - PARTITIONED_ATOL - PARTITIONED_RTOL * w.abs()).max().item() > 0:
                failed.append(f"{part} {k}")
            worst[f"{part}/{k}"] = ((g - w).abs().max() / w.abs().max()).item()
    del got_grads, got_params, want
    # a second step, timed (the first paid the card's first calls of each shape)
    mesh_mod.reset_collectives()
    t0 = time.perf_counter()
    placed, pm2 = step(placed, {"tokens": toks[1]})
    torch.cuda.synchronize()
    second_ms = (time.perf_counter() - t0) * 1e3
    second_cols = dict(mesh_mod.collectives)
    # a third, under torch.profiler: where the partitioned step's time goes
    split = device_split(lambda: step(placed, {"tokens": toks[1]}))
    print_split(base.name, f"partitioned step ({NEMO_LAYERS} layers, FSDP on "
                f"{NEMO_GRID[0]} x {NEMO_GRID[1]})", second_ms, split)
    del placed, pm
    torch.cuda.empty_cache()
    counts = launches()
    seconds = time.perf_counter() - t_phase
    print(f"[partitioned] specs {specs}; whole step {whole_ms:.1f} ms, second "
          f"{whole_second_ms:.1f} ms, peak {whole_peak:.2f} GiB "
          f"({whole_left:.2f} GiB still allocated after it); "
          f"partitioned over {mesh!r}: first step {first_ms:.1f} ms, second {second_ms:.1f} ms; "
          f"collectives {cols} ({by_axis} by axis; the formula's {cols_want}), carrying "
          f"{nbytes} bytes; against the whole step, largest difference over the largest value: "
          f"{ {k: float(f'{v:.3g}') for k, v in worst.items()} } (bounds rtol/atol "
          f"{PARTITIONED_RTOL:g}); peak {peak / 2 ** 30:.2f} GiB against the reckoned "
          f"{reckoned / 2 ** 30:.2f} (held before the step {held_before / 2 ** 30:.2f}); "
          f"{slot_want:,} bytes a slot; phase {seconds:.1f} s on {card}")
    check(cols == cols_want == second_cols, f"the partitioned steps ran collectives {cols} and "
          f"{second_cols}, expected {cols_want}")
    check(not failed, f"phase 18 against the whole step, beyond rtol/atol "
          f"{PARTITIONED_RTOL:g}/{PARTITIONED_ATOL:g}: {failed}")
    check(math.isfinite(pm2["loss"].item()), f"the second step's loss {pm2['loss'].item()}")
    check(abs(peak - reckoned) <= NEMO_PEAK_RTOL * reckoned,
          f"the partitioned step's peak {peak / 2 ** 30:.2f} GiB is not within "
          f"{NEMO_PEAK_RTOL:.0%} of the reckoned {reckoned / 2 ** 30:.2f} GiB")
    check(all(n == 0 for n in counts.values()), f"the train steps launched {counts}")
    return {"arch": base.name, "layers": cfg.num_layers, "of_layers": base.num_layers,
            "params": n_params, "bytes": P, "grid": list(NEMO_GRID), "slot_bytes": slot_want,
            "whole_ms": whole_ms, "whole_second_ms": whole_second_ms,
            "whole_peak_gib": whole_peak, "first_ms": first_ms,
            "second_ms": second_ms, "collectives": cols, "collective_bytes": nbytes,
            "collectives_by_axis": by_axis, "worst": worst, "peak_gib": peak / 2 ** 30,
            "device_busy_ms": None if split is None else split[0],
            "reckoned_peak_gib": reckoned / 2 ** 30, "seconds": seconds}


# ---------------------------------------------------------------------------
# slice 15: partitioned serving (phase 19)
# ---------------------------------------------------------------------------

# each model at full width in bf16 on a (data 2, model 2) grid of the visible
# cards: (arch, prompt tokens, new tokens, cache length, the ring cache on,
# layers); gemma3-1b's ring run takes 4 x RING_PSERVE_PROMPT (a prefill fits
# its 512-slot rings), which wrap after decode step 512 - RING_PSERVE_PROMPT;
# rwkv6-7b generates RWKV_PSERVE_NEW tokens.  rwkv6-7b (8 of 32 layers) and
# mistral-nemo-12b (10 of 40) are cut in depth, and gemma3-1b's linear run to
# 16 new tokens, to keep the script within its time
PSERVE_GRID = (2, 2)
RING_PSERVE_PROMPT, RING_PSERVE_NEW = 500, 16
RWKV_PSERVE_NEW = 16
GEMMA_PSERVE_NEW = 16
# (arch, prompt, new tokens, cache slots, the ring cache, layers: None for the config's)
PSERVE_MODELS = (("rwkv6-7b", RWKV_PROMPT, RWKV_PSERVE_NEW, RWKV_PROMPT + RWKV_PSERVE_NEW,
                  False, 8),
                 ("mistral-nemo-12b", DENSE_PROMPT, DENSE_NEW, DENSE_PROMPT + DENSE_NEW, False,
                  10),
                 ("gemma3-1b", GEMMA_PROMPT, GEMMA_PSERVE_NEW, GEMMA_MAX_LEN, False, None),
                 ("gemma3-1b", RING_PSERVE_PROMPT, RING_PSERVE_NEW,
                  RING_PSERVE_PROMPT + RING_PSERVE_NEW, True, None))
# the yardstick of a partitioned run against the whole model: each slot's
# row-parallel partial product is rounded to bf16 before the M partials are
# summed (one more bf16 rounding of every element of the layer's output than
# the whole product has), so the whole model's kernel outputs are nudged by
# one bf16 ulp (2^-8), not by an f32 summation-order difference
TP_NUDGE = 2.0 ** -8
PSERVE_DECODE_PROFILED = 1  # decode steps profiled (the profiler's work grows with them)


def serve_collectives(cfg, psh, R: int, M: int, *, cached: bool = True, data_axis="data",
                      step=None):
    """The collectives of one partitioned forward (a prefill or one decode
    step) on a (data R, model M) grid, the formula PERF.md §5 states (the
    same as ``tests/test_torch_partitioned_serve.py``'s and, with the MoE,
    Mamba and RWKV mixers, ``tests/test_torch_partitioned_ssm.py``'s), as
    ``({kind: count}, {axis: count})``.  Over ``model``: the embedding's
    all-reduce where the vocabulary splits; an all-reduce a row-parallel
    output (attention's ``wo``, the GLU/MLP, the RWKV time mix's ``wo``,
    a MoE layer's combine where its experts or F split); ``wk``/``wv``
    all-gathered where the KV heads do not split but their spec does, and
    ``wq`` where M does not divide the query heads but its spec splits its
    columns; a Mamba layer whose channels split, its in_proj product all-gathered and
    its x_proj partials and out_proj all-reduced (1 + 2); with a cache, its
    k and v all-gathered where its spec splits ``head_dim``, and an RWKV
    layer's two token-shift states; the last logits all-gathered where they
    come out per vocabulary block.  Over the batch axis: each use of a leaf
    FSDP splits, one all-gather, the last logits', and a MoE layer's expert
    counts.

    ``step`` names a forward at a batch the batch axis does not divide
    (``tests/test_torch_context_parallel.py``'s ``cp_collectives``):
    ``"chunks"`` (a prompt split into R chunks), ``"whole"`` (a prompt every
    slot holds whole) or ``"decode"`` (one token against a cache whose
    sequence is split over the batch axis).  Over ``model`` the same, but a
    cache's head_dim gathers come at a decode step only (a prompt attends
    over its own new keys).  Over the batch axis: the FSDP gathers; for a
    chunked prompt each attention layer's new k and v gathered, each MoE
    layer's counts by row and expert, the chunk ends gathered (two a RWKV
    layer, the conv halo a Mamba layer), each recurrent layer's state
    handed from chunk to chunk (R - 1 ``permute``s) and, with a cache,
    broadcast from the last chunk (one), and the last logits broadcast from
    the last chunk; at a decode step each attention layer's partials
    gathered.

    ``data_axis`` may be a tuple of axes (phase 26's grid (b),
    ``("data", "model")``): one batch axis of R = its product's slots,
    keyed by the tuple, with M = 1 where the grid has no model axis (the
    ``"model"`` terms vanish).  An axis the grid replicates (``pod``)
    changes no count.

    The encoder-decoder takes ``whisper_collectives`` (``step`` one of its
    forwards, by default the serve step with ``cached`` and the prefill
    step without)."""
    if cfg.is_encoder_decoder:
        return whisper_collectives(cfg, psh, R, M, step or ("serve" if cached else "prefill"),
                                   data_axis)
    n_attn = sum(b.mixer == "attn" for b in cfg.blocks)
    n_dense = sum(b.ffn in ("glu", "mlp") for b in cfg.blocks)
    n_moe = sum(b.ffn == "moe" for b in cfg.blocks)
    n_rwkv = sum(b.mixer == "rwkv" for b in cfg.blocks)
    n_mamba = sum(b.mixer == "mamba" for b in cfg.blocks)
    ar = ag_m = ag_d = perm = bcast = 0
    if M > 1:
        vocab = cfg.vocab_size % M == 0
        hd, Hkv = cfg.head_dim, cfg.num_kv_heads
        attn = (cfg.num_heads * hd) % M == 0
        ar += vocab + n_attn * attn + n_dense * (cfg.d_ff % M == 0)
        ar += layers_split(cfg, psh, "moe/w_gate", "model")
        mamba = layers_split(cfg, psh, "mamba/in_proj", "model")
        rwkv = layers_split(cfg, psh, "rwkv/wr", "model")
        ar += 2 * mamba + rwkv
        ag_m += mamba
        if n_attn and attn and Hkv % M and (Hkv * hd) % M == 0:
            ag_m += 2 * n_attn
        if n_attn and attn and cfg.num_heads % M:
            ag_m += n_attn
        if cached:
            if n_attn and Hkv % M and hd % M == 0 and step in (None, "decode"):
                ag_m += 2 * n_attn
            ag_m += 2 * rwkv
        ag_m += vocab
    if R > 1:
        n_full, _ = tt_mod.split_layers(cfg)
        for name, sh in tree_leaves_with_path(psh):
            if data_axis in sh.spec:
                ag_d += n_full if name.startswith("scan/") else 1
        if step is None:
            ag_d += 1 + n_moe * (cfg.moe.routing != "dense")
        elif step == "chunks":
            ag_d += 2 * n_attn + n_moe * (cfg.moe.routing != "dense") + 2 * n_rwkv + n_mamba
            perm += (R - 1) * (n_rwkv + n_mamba)
            bcast += 1 + (n_rwkv + n_mamba) * cached
        elif step == "decode":
            ag_d += n_attn
    kinds = {"all_reduce": ar, "all_gather": ag_m + ag_d, "reduce_scatter": 0}
    kinds.update({k: n for k, n in (("permute", perm), ("broadcast", bcast)) if n})
    return kinds, {a: n for a, n in (("model", ar + ag_m), (data_axis, ag_d + perm + bcast))
                   if n}


WHISPER_FORWARDS = ("encode", "prime", "prefill", "serve")


def whisper_collectives(cfg, psh, R: int, M: int, what: str, data_axis="data", *, step=None,
                        max_len=None):
    """The collectives of one of the encoder-decoder's partitioned forwards
    on a (data R, model M) grid, the formula PERF.md §5 states, as
    ``({kind: count}, {axis: count})``: ``"encode"`` (``whisper_encode``),
    ``"prime"`` (``prime_cross_cache``), ``"prefill"``
    (``make_prefill_step``: the encoder, then the decoder's cross-attention
    over its states) or ``"serve"`` (``make_serve_step`` against the primed
    cache: a prompt or a token).  Over ``model``: the embedding's all-reduce
    and the last logits' all-gather where the vocabulary splits (the
    decoder's forwards); an all-reduce for each attention's ``wo`` (an
    encoder layer's one, a decoder layer's two) and each MLP; ``wk``/``wv``
    all-gathered where the KV heads do not split but their spec does, for
    each attention that projects them (not a serve step's cross-attention,
    which reads the primed cache); ``wq`` all-gathered for each attention
    (not a prime's) where M does not divide the query heads but its spec
    splits its columns; in a serve step, where the caches' spec
    splits ``head_dim``, each layer's self and cross k and v all-gathered.
    Over the batch axis: each use of a leaf FSDP splits (the leaves that
    forward uses), and the decoder's last logits.

    ``step`` names a forward at a batch the batch axis does not divide
    (phase 25): the tokens' layout, ``"chunks"`` or ``"whole"`` (the
    prefill step, or a prompt at ``cache_index`` 0), or ``"decode"`` (one
    token); any of them for an encode or a prime.  Over ``model`` the same,
    but a serve step gathers the self cache's ``head_dim`` at a decode step
    only.  Over the batch axis, where R divides the N frames (the encoder's
    positions and the cross cache's in R chunks): each encoder layer's k
    and v all-gathered, and each cross-attention's (the prefill step); a
    serve step's cross-attention gathers the partials of its blocks (one a
    layer), after a chunked prompt's query rows (one more).  The
    decoder's self-attention: a chunked prompt's k and v gathered (two a
    layer), a decode step's partials (one a layer, where R divides the self
    cache's ``max_len``, None for yes).  The last logits of a chunked
    prompt are broadcast from the last chunk (one), a whole one's are
    slot 0's."""
    if what not in WHISPER_FORWARDS:
        raise ValueError(f"whisper_collectives: {what!r} is none of {WHISPER_FORWARDS}")
    Le, Ld = cfg.encoder_layers, cfg.num_layers
    hd, Hkv = cfg.head_dim, cfg.num_kv_heads
    enc, dec = what in ("encode", "prefill"), what in ("prefill", "serve")
    ar = ag_m = ag_d = bcast = 0
    if M > 1:
        vocab = dec and cfg.vocab_size % M == 0
        attn = (cfg.num_heads * hd) % M == 0
        kv_gathered = attn and Hkv % M and (Hkv * hd) % M == 0
        ar += vocab + (Le * enc + 2 * Ld * dec) * attn + (Le * enc + Ld * dec) * (cfg.d_ff % M == 0)
        projecting = Le * enc + Ld * ((what == "prefill") + dec + (what == "prime"))
        ag_m += vocab + 2 * projecting * kv_gathered
        ag_m += (Le * enc + 2 * Ld * dec) * (attn and cfg.num_heads % M != 0)
        if what == "serve" and Hkv % M and hd % M == 0:
            ag_m += 4 * Ld if step in (None, "decode") else 2 * Ld
    if R > 1:
        cross_kv = re.compile(r"^dec/layers/layer\d+/xattn/w[kv]$")
        used = {"encode": lambda n: n.startswith("enc/"), "prime": cross_kv.match,
                "prefill": lambda n: True,
                "serve": lambda n: n.startswith("dec/") and not cross_kv.match(n)}[what]
        ag_d += sum(1 for name, sh in tree_leaves_with_path(psh)
                    if data_axis in sh.spec and used(name))
        if step is None:
            ag_d += dec
        else:
            frames = cfg.encoder_seq % R == 0
            ag_d += 2 * Le * enc * frames
            if what == "prefill":
                ag_d += 2 * Ld * (step == "chunks") + 2 * Ld * frames
            elif what == "serve" and step == "decode":
                ag_d += Ld * (max_len is None or max_len % R == 0) + Ld * frames
            elif what == "serve":
                ag_d += 2 * Ld * (step == "chunks") + Ld * frames * (1 + (step == "chunks"))
            bcast += dec and step == "chunks"
    kinds = {"all_reduce": ar, "all_gather": ag_m + ag_d, "reduce_scatter": 0}
    if bcast:
        kinds["broadcast"] = bcast
    return kinds, {a: n for a, n in (("model", ar + ag_m), (data_axis, ag_d + bcast)) if n}


def slot_heads(cfg, M: int) -> int:
    """A model slot's query heads: ``Hq / M``, or all ``Hq`` where M does not
    divide them (``models.partitioned._heads``: the attention replicated)."""
    return cfg.num_heads // M if cfg.num_heads % M == 0 else cfg.num_heads


def pserve_routes(cfg, prompt_len, new_tokens, n_slots: int, M: int):
    """The kernels' launches by route over one partitioned
    ``Engine.generate``, worked out from the code: each slot launches once a
    layer for the prefill and once a layer and new token after the first,
    on the route its own heads take (attention: ``slot_heads`` query heads
    on the KV heads they read)."""
    n_attn = sum(b.mixer == "attn" for b in cfg.blocks)
    n_rwkv = sum(b.mixer == "rwkv" for b in cfg.blocks)
    steps = new_tokens - 1
    flash = dict.fromkeys(fa_mod.COUNTED, 0)
    if n_attn:
        hq, rep = slot_heads(cfg, M), cfg.num_heads // cfg.num_kv_heads
        group = rep if (cfg.num_kv_heads % M == 0 or hq % rep == 0) else (
            hq if rep % hq == 0 else 1)      # query heads a slot's kv head serves
        flash[fa_mod.route(torch.bfloat16, prompt_len, group, 1)] += n_slots * n_attn
        dec = fa_mod.route(torch.bfloat16, 1, group, 1)
        flash[dec] += n_slots * n_attn * steps
        if dec == "decode":
            flash["decode_combine"] += n_slots * n_attn * steps
    rwkv = {"scan": n_slots * n_rwkv, "step": n_slots * n_rwkv * steps}
    return flash, rwkv


def stepped(cfg, params, prompts, max_len, feed=None, n=None, axes=None, **vision):
    """The tokens [B, n] and last-position logits [B, n, V] of a prefill of
    ``prompts`` into a cache and n - 1 decode steps (placed params or
    whole), fed the tokens ``feed`` [B, n] (teacher-forced) or greedy.
    ``vision`` (``positions``, ``extra_embeds``) makes the prefill a
    vision prompt's: ``forward_lm(cache=, cache_index=0, positions=,
    extra_embeds=)`` whole, its placed twin on placed params.  ``axes``:
    the Engine's ``data_axis``/``model_axis`` (phase 26's grids)."""
    eng = Engine(cfg, params, max_len=max_len, **(axes or {}))
    P, n = prompts.shape[1], feed.shape[1] if n is None else n
    with torch.inference_mode():
        toks, cache = eng._start(params, prompts)
        lg = serve_prefill(cfg, params, eng, toks, cache, vision)
        tokens, out = [torch.argmax(lg, -1)], [lg]
        for t in range(1, n):
            nxt = tokens[-1] if feed is None else torch.as_tensor(feed[:, t - 1], device=lg.device)
            lg, cache = eng._serve(params, cache, nxt[:, None], P + t - 1)
            tokens.append(torch.argmax(lg, -1))
            out.append(lg)
        del cache
    return torch.stack(tokens, 1).cpu().numpy(), torch.stack(out, 1)


def serve_prefill(cfg, params, eng, toks, cache, vision):
    """The last-position logits of a prefill into ``cache``: a text
    prompt's through the Engine, a vision prompt's through ``forward_lm``
    whole or its placed twin."""
    if not vision:
        return eng._prefill(params, toks, cache)[0]
    if step_mod.is_placed(params):
        return step_mod._partitioned_last_logits(cfg, params, toks, cache, 0, **vision)
    return forward_lm(cfg, params, toks, cache=cache, cache_index=0, **vision)[0][:, -1]


class nudged_kernels:
    """Inside the block each output of the two kernels the model calls, and
    of the Mamba mixer's selective scan (the recurrence the reference runs
    as ``lax.scan``, plain PyTorch here as ``rwkv6_scan``'s plain twin is),
    is scaled by (1 + nudge) and rounded to its dtype again: the yardstick
    of a comparison between two runs on the kernels."""

    def __init__(self, nudge: float):
        self.f = 1.0 + nudge

    def __enter__(self):
        self.saved = (kops.flash_attention, rwkv_mod.rwkv6_scan, mamba_mod.selective_scan)
        flash, scan, mscan = self.saved
        f = self.f

        def nudged_flash(q, k, v, **kw):
            return (flash(q, k, v, **kw).float() * f).to(q.dtype)

        def nudged_scan(*args):
            y, st = scan(*args)
            return (y.float() * f).to(y.dtype), st

        def nudged_mamba_scan(*args):
            ys, h = mscan(*args)
            return (ys.float() * f).to(ys.dtype), h

        kops.flash_attention, rwkv_mod.rwkv6_scan = nudged_flash, nudged_scan
        mamba_mod.selective_scan = nudged_mamba_scan
        return self

    def __exit__(self, *exc):
        kops.flash_attention, rwkv_mod.rwkv6_scan, mamba_mod.selective_scan = self.saved


def whole_reference(cfg, params, prompts, max_len, n, tokens=None):
    """The whole model's side of a partitioned comparison: its Engine's
    greedy tokens (``tokens``, if already generated), its logits
    teacher-forced on them, the yardstick (the same run with the kernels'
    outputs nudged by ``TP_NUDGE``, ``logit_diff``), and its prefill ms
    and decode ms a step (the teacher-forced run timed, and a prefill
    alone)."""
    eng = Engine(cfg, params, max_len=max_len)
    if tokens is None:
        tokens = eng.generate(prompts, max_new_tokens=n).tokens[:, prompts.shape[1]:]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lw = stepped(cfg, params, prompts, max_len, tokens)[1]
    torch.cuda.synchronize()
    run_ms = (time.perf_counter() - t0) * 1e3
    with torch.inference_mode():
        toks, cache = eng._start(params, prompts)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng._prefill(params, toks, cache)
        torch.cuda.synchronize()
        pre_ms = (time.perf_counter() - t0) * 1e3
        del cache
    check(np.array_equal(torch.argmax(lw, -1).cpu().numpy(), tokens),
          "teacher-forced whole model must repeat its generate")
    with nudged_kernels(TP_NUDGE):
        ln = stepped(cfg, params, prompts, max_len, tokens)[1]
    floor = logit_diff(ln, lw)
    del ln
    return tokens, lw, floor, pre_ms, (run_ms - pre_ms) / (n - 1)


def tp_agreement(what, logits_p, ref):
    """A partitioned run's logits, teacher-forced on the whole model's
    tokens, against the whole model's (``whole_reference``): max and mean
    |d| within 4x the yardstick's, and greedy tokens equal wherever the
    whole model's top-2 margin exceeds twice the logit difference (phase
    9's rule); the low-margin positions are counted.  Returns the record."""
    tokens, lw, floor = ref[:3]
    mx, mean = logits_agreement(logits_p, lw, floor, what)
    d_step = (logits_p.float() - lw.float()).abs().amax(-1)
    top2 = torch.topk(lw.float(), 2, dim=-1)
    decided = ((top2.values[..., 0] - top2.values[..., 1]) > 2 * d_step).cpu().numpy()
    agree = torch.argmax(logits_p, -1).cpu().numpy() == tokens
    check(bool(agree[decided].all()), f"{what}: greedy tokens differ from the whole model's "
          "where its top-2 margin exceeds twice the logit difference")
    print(f"[pserve] {what} vs the whole model (teacher-forced on its tokens): logits max|d| "
          f"{mx:.4g} mean|d| {mean:.3g}; the whole model's kernels nudged by 2^-8 move them by max "
          f"{floor[0]:.4g} / mean {floor[1]:.3g}, bound 4x; tokens: "
          f"{int(decided.sum())}/{decided.size} decided by a margin > 2 x max|d| and all agree, "
          f"{decided.size - int(decided.sum())} low-margin; {int(agree.sum())}/{agree.size} "
          "agree overall")
    return {"max_abs": mx, "mean_abs": mean, "yardstick": list(floor),
            "decided": int(decided.sum()), "low_margin": int(decided.size - decided.sum()),
            "agree": int(agree.sum()), "positions": int(agree.size)}


def check_pserve_launches(what, cfg, prompt_len, new_tokens, mesh):
    """The kernels' launches of one partitioned generate, exact by route."""
    M = mesh.extent("model")
    flash, rwkv = pserve_routes(cfg, prompt_len, new_tokens, mesh.devices.size, M)
    got_f = dict(flash_attention.launches_by_route)
    got_r = dict(rwkv6_scan.launches_by_route)
    check(got_f == flash and got_r == rwkv, f"{what}: launched flash_attention {got_f} and "
          f"rwkv6_scan {got_r} by route, expected {flash} and {rwkv}")
    return got_f, got_r


def check_placement(cfg, placed, psh, cache, mesh, max_len, batch=4, axes=None):
    """Each slot holds what ``placed_slot_bytes`` counts of the placed params
    and cache, equal to ``dryrun.slot_bytes`` by their specs, and each cache
    block has the shape ``cache_shardings`` gives (with ``axes``, its
    ``data_axis``/``model_axis``).  Returns the bytes a slot and the bytes
    stored on the cards (each stored block once)."""
    with torch.device("meta"):
        shapes = init_cache(cfg, batch, max_len, device="meta")
    csh = sharding_mod.cache_shardings(mesh, shapes, cfg, **(axes or {}))
    want = dryrun_mod.slot_bytes({"params": placed, "cache": shapes},
                                 {"params": psh, "cache": csh}, mesh)
    got = sharding_mod.placed_slot_bytes({"params": placed, "cache": cache}, mesh)
    check(got == [want] * mesh.devices.size, f"placed bytes a slot {got}, "
          f"dryrun.slot_bytes {want:,}")
    extent = dict(zip(mesh.axis_names, mesh.devices.shape))
    specs = dict(tree_leaves_with_path(csh))
    for name, x in tree_leaves_with_path(cache):
        block = tuple(n // int(np.prod([extent[a] for a in sharding_mod.norm_axes(e)]))
                      if e is not None else n for n, e in zip(x.shape, specs[name].spec))
        block += tuple(x.shape[len(block):])
        check(all(tuple(x.block(s).shape) == block for s in range(mesh.devices.size)),
              f"cache leaf {name}: blocks "
              f"{[tuple(x.block(s).shape) for s in range(mesh.devices.size)]}, "
              f"cache_shardings gives {block}")
    stored = sum(b.numel() * b.element_size() for _, x in tree_leaves_with_path(placed)
                 for b in x.blocks)
    return want, stored


def pserve_model(arch, prompt_len, new_tokens, max_len, ring, layers, card):
    """One model whole, then partitioned on PSERVE_GRID (the phase 19
    docstring), cut to its first ``layers`` where given: the record of the
    comparison, times and counts."""
    t_model = time.perf_counter()
    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    name = arch + (" (ring cache)" if ring else "")
    saved_ring = tt_mod.RING_CACHE
    tt_mod.RING_CACHE = ring
    try:
        dev = torch.device("cuda")
        sync_cards()
        reset_cards_peak()
        params = init_lm(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
        prompts = np.random.default_rng(1).integers(3, cfg.vocab_size, (4, prompt_len))
        marks = [("init", time.perf_counter())]
        # the whole model: its tokens, logits and yardstick; its times
        ref = whole_reference(cfg, params, prompts, max_len, new_tokens)
        w_pre, w_dec = ref[3:]
        whole_peak = cards_peak_gib()
        marks.append(("whole reference", time.perf_counter()))

        # placed on the grid, the whole tree freed
        mesh = make_mesh(PSERVE_GRID, ("data", "model"))
        psh = sharding_mod.params_shardings(mesh, params, cfg)
        placed = device_put(params, psh)
        del params
        sync_cards()
        torch.cuda.empty_cache()
        reset_cards_peak()
        held = torch.cuda.memory_allocated()
        eng = Engine(cfg, placed, max_len=max_len)
        with torch.inference_mode():
            toks, cache = eng._start(placed, prompts)
        slot_bytes, stored = check_placement(cfg, placed, psh, cache, mesh, max_len)
        del cache
        marks.append(("placement", time.perf_counter()))

        # one partitioned generate, its launches exact by route and its
        # collectives a step the formula's
        per_step, per_axis = serve_collectives(cfg, psh, *PSERVE_GRID)
        reset_launches()
        mesh_mod.reset_collectives()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = eng.generate(prompts, max_new_tokens=new_tokens)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        counts = launches()
        routes = check_pserve_launches(name, cfg, prompt_len, new_tokens, mesh)
        cols, by_axis = dict(mesh_mod.collectives), dict(mesh_mod.collectives_by_axis)
        check(cols == {k: new_tokens * v for k, v in per_step.items()}
              and by_axis == {k: new_tokens * v for k, v in per_axis.items()},
              f"{name}: the generate's collectives {cols} ({by_axis} by axis), expected "
              f"{new_tokens} x {per_step} ({per_axis})")
        gen_p = res.tokens[:, prompt_len:]
        same = int((gen_p == ref[0]).sum())
        marks.append(("partitioned generate", time.perf_counter()))

        gen_bytes = dict(mesh_mod.collective_bytes)
        # times: the generate's, and a prefill alone (its collective bytes
        # too; a decode step's are the rest over new_tokens - 1); then one
        # prefill and PSERVE_DECODE_PROFILED steps under torch.profiler
        with torch.inference_mode():
            _, cache = eng._start(placed, prompts)
            mesh_mod.reset_collectives()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, cache = eng._prefill(placed, toks, cache)
            torch.cuda.synchronize()
            p_pre = (time.perf_counter() - t0) * 1e3
            pre_bytes = dict(mesh_mod.collective_bytes)
            p_dec = (gen_s * 1e3 - p_pre) / (new_tokens - 1)
            dec_bytes = {k: (gen_bytes[k] - pre_bytes[k]) // (new_tokens - 1) for k in gen_bytes}
            nxt = torch.argmax(lg, -1)[:, None]

            def decode_profiled():
                for t in range(PSERVE_DECODE_PROFILED):
                    eng._serve(placed, cache, nxt, prompt_len + t)

            split_dec = device_split(decode_profiled)
            _, cache = eng._start(placed, prompts)
            split_pre = device_split(lambda: eng._prefill(placed, toks, cache))
            del cache, lg
        marks.append(("profile", time.perf_counter()))
        print_split(name, f"partitioned prefill 4 x {prompt_len}", p_pre, split_pre)
        print_split(name, f"{PSERVE_DECODE_PROFILED} partitioned decode steps",
                    PSERVE_DECODE_PROFILED * p_dec, split_dec)
        peak = cards_peak_gib()

        # the partitioned model teacher-forced on the whole model's tokens
        lp = stepped(cfg, placed, prompts, max_len, ref[0])[1]
        agreement = tp_agreement(name, lp, ref)
        del lp, placed, eng, ref
        torch.cuda.empty_cache()
        marks.append(("partitioned teacher-forced", time.perf_counter()))
        split_s = {k: round(t - marks[i][1], 2) for i, (k, t) in enumerate(marks[1:])}
        busy = {k: None if s is None else s[0] for k, s in (("prefill", split_pre),
                                                            ("decode", split_dec))}
        rec = {"arch": arch, "ring": ring, "prompt": prompt_len, "new": new_tokens,
               "max_len": max_len, "grid": list(PSERVE_GRID), "mesh": repr(mesh),
               "slot_bytes": slot_bytes, "stored_bytes": stored, "held_gib": held / 2 ** 30,
               "whole_prefill_ms": w_pre, "whole_decode_ms": w_dec,
               "whole_peak_gib": whole_peak, "prefill_ms": p_pre, "decode_ms": p_dec,
               "generate_s": gen_s, "device_busy_ms": busy, "peak_gib": peak,
               "launches": counts, "flash_routes": routes[0], "rwkv_routes": routes[1],
               "collectives_per_step": per_step, "collectives_by_axis_per_step": per_axis,
               "collective_bytes_prefill": pre_bytes, "collective_bytes_decode_step": dec_bytes,
               "generate_tokens_equal": same, "agreement": agreement,
               "seconds": time.perf_counter() - t_model, "seconds_by_part": split_s}
        print(f"[pserve] {name} on {mesh!r}: {slot_bytes:,} bytes a slot of params and cache "
              f"(= dryrun.slot_bytes), {stored:,} bytes of params stored on the card(s); whole "
              f"model prefill {w_pre:.2f} ms, decode {w_dec:.2f} ms a step, peak "
              f"{whole_peak:.2f} GiB; partitioned prefill {p_pre:.2f} ms, decode {p_dec:.2f} ms "
              f"a step, generate 4 x {prompt_len} -> {new_tokens} {gen_s:.2f} s, peak "
              f"{peak:.2f} GiB (held {held / 2 ** 30:.2f}); launches by route {routes} (exactly "
              f"as worked out); collectives a step {per_step} ({per_axis} by axis; the "
              f"formula's), bytes a prefill {pre_bytes}, a decode step {dec_bytes}; the "
              f"generate's tokens equal the whole model's at {same}/{gen_p.size}; "
              f"{rec['seconds']:.1f} s ({split_s}, init {marks[0][1] - t_model:.1f} s) on {card}")
        return counts, rec
    finally:
        tt_mod.RING_CACHE = saved_ring


def phase_pserve_kernel_checks(gen):
    """flash_attention and rwkv6_scan against their plain versions on the
    card at phase 19's per-slot shapes (B = 2 rows a data slot, the heads a
    model slot holds), each call through the route it must take.  Returns
    the largest error of each."""
    worst = {"flash_attention": 0.0, "rwkv6_scan": 0.0}
    nemo = get_config("mistral-nemo-12b")
    Sk = DENSE_PROMPT + DENSE_NEW
    q, k, v = qkv_on_card(2, DENSE_PROMPT, Sk, nemo.num_heads // 2, nemo.num_kv_heads // 2,
                          nemo.head_dim, torch.bfloat16, gen)
    e1 = bf16_close(flash_routed("prefill_tc", q, k, v), flash_attention_plain(q, k, v),
                    "flash per slot nemo prefill")
    q1 = q[:, :1].contiguous()
    e2 = bf16_close(flash_routed("decode", q1, k, v, q_offset=Sk - 1),
                    flash_attention_plain(q1, k, v, q_offset=Sk - 1), "flash per slot nemo decode")
    print(f"[check] flash_attention per slot, mistral-nemo-12b on model 2: q [2, {DENSE_PROMPT}, "
          f"16, 128] on 4 kv heads, Sk {Sk}, bf16: prefill_tc max|d| {e1:.3g}, decode (q_offset "
          f"{Sk - 1}) {e2:.3g}")
    worst["flash_attention"] = max(e1, e2)
    q, k, v = qkv_on_card(2, GEMMA_PROMPT, GEMMA_MAX_LEN, GEMMA.num_heads // 2, 1,
                          GEMMA.head_dim, torch.bfloat16, gen)
    errs = []
    for window in (GEMMA_WINDOW, None):
        errs.append(bf16_close(flash_routed("prefill_tc", q, k, v, window=window),
                               flash_attention_plain(q, k, v, window=window),
                               f"flash per slot gemma prefill window {window}"))
        q1 = q[:, :1].contiguous()
        errs.append(bf16_close(flash_routed("decode", q1, k, v, window=window, q_offset=1100),
                               flash_attention_plain(q1, k, v, window=window, q_offset=1100),
                               f"flash per slot gemma decode window {window}"))
    # a local layer's 512-slot ring at positions 200 (filling) and 700 (wrapped)
    ring_k, ring_v = k[:, :GEMMA_WINDOW].contiguous(), v[:, :GEMMA_WINDOW].contiguous()
    for pos in (200, 700):
        q1 = q[:, :1].contiguous()
        got = flash_routed("decode", q1, ring_k, ring_v, window=None,
                           q_offset=min(pos, GEMMA_WINDOW - 1))
        errs.append(bf16_close(got, flash_attention_plain(q1, ring_k, ring_v, window=None,
                                                          q_offset=min(pos, GEMMA_WINDOW - 1)),
                               f"flash per slot gemma ring at {pos}"))
    print(f"[check] flash_attention per slot, gemma3-1b on model 2: q [2, {GEMMA_PROMPT}, 2, "
          f"256] on 1 kv head, Sk {GEMMA_MAX_LEN}, bf16, window 512 and none: prefill_tc, "
          f"decode (q_offset 1100) and the ring decode at 200 and 700: max|d| "
          f"{max(errs):.3g} (bound 1 bf16 ulp + 2e-5 x max(1, max|plain|))")
    worst["flash_attention"] = max(worst["flash_attention"], *errs)
    B, T, H, hd = RWKV_PREFILL
    args = rwkv_on_card(2, T, H // 2, hd, torch.float32, gen)
    (y, s), (yp, sp) = rwkv_routed("scan", *args), rwkv6_scan_plain(*args)
    e = max(f32_close(y, yp, "rwkv per slot y"), f32_close(s, sp, "rwkv per slot state"))
    one = [t[:, :1].contiguous() for t in args[:4]] + list(args[4:])
    (y, s), (yp, sp) = rwkv_routed("step", *one), rwkv6_scan_plain(*one)
    e1 = max(f32_close(y, yp, "rwkv per slot step y"), f32_close(s, sp, "rwkv per slot step s"))
    print(f"[check] rwkv6_scan per slot, rwkv6-7b on model 2: [2, {T}, {H // 2}, {hd}] f32, "
          f"route scan max|d| {e:.3g}; T=1 route step {e1:.3g} (bound 2e-5 x max(1, max|plain|))")
    worst["rwkv6_scan"] = max(e, e1)
    return worst


def phase_partitioned_serve(card, gen):
    """Phase 19: the per-slot kernel checks, then each of PSERVE_MODELS whole
    and partitioned.  Returns (launches summed over the partitioned
    generates, the phase's record)."""
    t_phase = time.perf_counter()
    worst = phase_pserve_kernel_checks(gen)
    total = dict.fromkeys(launches(), 0)
    models = []
    for arch, prompt_len, new_tokens, max_len, ring, layers in PSERVE_MODELS:
        counts, rec = pserve_model(arch, prompt_len, new_tokens, max_len, ring, layers, card)
        total = {k: total[k] + counts[k] for k in total}
        models.append(rec)
        torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    print(f"[pserve] phase 19: {seconds:.1f} s on {card}; launches over the partitioned "
          f"generates {total}")
    return total, {"models": models, "per_slot_max_abs_err": worst, "seconds": seconds}


# ---------------------------------------------------------------------------
# slice 16: the partitioned MoE FFN and M-RoPE (phase 20)
# ---------------------------------------------------------------------------

# each model whole, then on a (data 2, model 2) grid of the visible cards, bf16
# at full width with seed-0 weights: granite-moe-1b-a400m cut to 8 of its 24
# layers (16 experts a slot) served 4 x 1024 -> 32; mixtral-8x7b cut to 4
# of its 32 layers (E = 8, 4 a slot; FSDP as configured) served 4 x 256 -> 16;
# qwen2-vl-72b cut to 8 of 80 layers, phase 14's vision prefill 4 x (256
# patches + 256 text) into a placed cache and QWEN_STEPS serve steps.  Then one
# f32 train step whole and on (replica 2, model 2): granite-moe with AdamW at
# 4 x 128, mixtral cut to 2 layers (so that the whole step fits beside the
# placed copy) with SGD at 4 x 64; gradients held at PARTITIONED_RTOL/ATOL.
PMOE_GRID = (2, 2)
MIXTRAL = get_config("mixtral-8x7b")
PMOE_SERVE = (("granite-moe-1b-a400m", dataclasses.replace(GRANITE_MOE, num_layers=8),
               GEMMA_PROMPT, SERVE_NEW, MOE_MAX_LEN),
              ("mixtral-8x7b", dataclasses.replace(MIXTRAL, num_layers=4), DENSE_PROMPT,
               DENSE_NEW, DENSE_PROMPT + DENSE_NEW),
              ("qwen2-vl-72b", QWEN, QWEN_LEN, QWEN_STEPS + 1, QWEN_LEN + QWEN_STEPS + 1))
PMOE_TRAIN = (("granite-moe-1b-a400m", GRANITE_MOE, "adamw", 3e-4, 4, 128,
               ("final_norm/scale", "embed", "scan/pos0/attn/wk", "scan/pos0/moe/router",
                "scan/pos0/moe/w_down")),
              ("mixtral-8x7b", dataclasses.replace(MIXTRAL, num_layers=2), "sgd",
               PARTITIONED_SGD_LR, 4, 64,
               ("final_norm/scale", "scan/pos0/attn/wk", "scan/pos0/moe/router",
                "scan/pos0/moe/w_down")))
# the whole runs phases 13 and 14 leave for phase 20 (the same trees and
# prompts): their tokens, teacher-forced logits, routing and times.  None
# since granite-moe runs here at 8 of its 24 layers (to keep the script
# within its time): phase 20 runs its whole side itself
PMOE_REUSED = ()
WHOLE_RUNS = {}
PMOE_DECODE_PROFILED = 1  # decode steps profiled (the profiler's work grows with them)


class slot_replay:
    """``route_replay``'s replay on the partitioned path: every slot routes
    its replica's rows, so router call ``c`` (the layers in turn, the slots
    in order within a layer) takes the whole run's call ``c // slots``,
    replica ``r``'s share of its rows, and routes to those experts weighted
    by its own renormalized probabilities.  The decisions it would have
    taken otherwise are counted for each of the whole run's calls, once a
    replica (``flips``)."""

    def __init__(self, fixed, R: int, M: int):
        self.fixed, self.R, self.M, self.n, self.flips = fixed, R, M, 0, []

    def __enter__(self):
        self.saved = moe_mod._router

        def route(cfg, p, x):
            probs, idx, w = self.saved(cfg, p, x)
            c, slots = self.n, self.R * self.M
            self.n += 1
            want = self.fixed[c // slots].chunk(self.R)[(c % slots) // self.M].to(idx.device)
            if c % slots == 0:
                self.flips.append(0)
            if c % self.M == 0:  # one slot a replica: the decisions of the whole call
                self.flips[-1] += int((torch.sort(idx, -1).values
                                       != torch.sort(want, -1).values).any(-1).sum())
            w = probs.gather(1, want)
            return probs, want, w / w.sum(-1, keepdim=True)

        moe_mod._router = route
        return self

    def __exit__(self, *exc):
        moe_mod._router = self.saved
        if exc[0] is None:
            check(self.n == len(self.fixed) * self.R * self.M, f"slot replay: {self.n} router "
                  f"calls, {len(self.fixed)} recorded x {self.R * self.M} slots")


def pmoe_inputs(cfg, gen, prompt_len):
    """(prompts, vision): phase 13's seeded text (rng 1), or for qwen2-vl
    phase 14's vision prompt (drawn from ``gen`` after the weights, as
    there) with its positions and extra_embeds."""
    if cfg.rope.kind == "mrope":
        tokens, pos, extra = qwen_vision_inputs(cfg, gen)
        return tokens, {"positions": pos, "extra_embeds": extra}
    prompts = np.random.default_rng(1).integers(3, cfg.vocab_size, (4, prompt_len))
    return torch.as_tensor(prompts, device="cuda"), {}


def timed_run(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def place_leafwise(params, psh):
    """``params`` placed by ``psh`` one leaf at a time, each whole leaf
    dropped from ``params`` once its blocks are made: the peak is the whole
    tree and one leaf's copies, not two trees.  Returns (the placed tree,
    the reckoned rise of the peak above what was allocated before, the
    whole tree among it: its largest leaf, copied)."""
    reckoned = max(x.numel() * x.element_size() for x in tree_leaves(params))
    placed = []
    for name, sh in tree_leaves_with_path(psh):
        *up, last = name.split("/")
        node = params
        for k in up:
            node = node[k]
        placed.append((name, sh.place(node.pop(last))))
    return tree_from_paths(placed), reckoned


def pmoe_serve(arch, cfg, prompt_len, new_tokens, max_len, card, tag="pmoe", leafwise=False,
               shown=("scan/pos0/moe/",)):
    """One model whole (or phase 13's / 14's whole run of it), then
    partitioned on PMOE_GRID: placement, launches exact by route,
    collectives the formula's, times, and the run teacher-forced on the
    whole model's tokens with its routing replayed, held by phase 9's rule.
    ``leafwise`` places the tree one leaf at a time (``place_leafwise``:
    a model whose whole and placed copies do not fit on the card together)
    and holds the peak against the reckoned one.  The specs of the leaves
    under the prefixes ``shown`` are printed.  Returns (launches, the
    record)."""
    t_model = time.perf_counter()
    dev = torch.device("cuda")
    sync_cards()
    reset_cards_peak()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_lm(cfg, gen, device=dev)
    prompts, vision = pmoe_inputs(cfg, gen, prompt_len)
    whole = WHOLE_RUNS.pop(arch, None)
    reused = whole is not None and whole["max_len"] == max_len and \
        whole["n_layers"] == cfg.num_layers
    if reused:
        tokens, lw, calls = whole["tokens"], whole["logits"], whole["calls"]
        w_pre, w_dec = whole["prefill_ms"], whole["decode_ms"]
    else:
        (tokens, _), gen_ms = timed_run(lambda: stepped(cfg, params, prompts, max_len,
                                                        n=new_tokens, **vision))
        _, w_pre = timed_run(lambda: stepped(cfg, params, prompts, max_len, n=1, **vision))
        w_dec = (gen_ms - w_pre) / (new_tokens - 1)
        with route_replay() as rec:
            _, lw = stepped(cfg, params, prompts, max_len, tokens, **vision)
        calls = rec.calls
    del whole
    # the yardstick: the whole model's kernels nudged by 2^-8, its routing replayed
    with nudged_kernels(TP_NUDGE), route_replay(calls):
        _, ln = stepped(cfg, params, prompts, max_len, tokens, **vision)
    floor = logit_diff(ln, lw)
    del ln
    whole_peak = cards_peak_gib()
    marks = [("whole", time.perf_counter())]

    mesh = make_mesh(PMOE_GRID, ("data", "model"))
    psh = sharding_mod.params_shardings(mesh, params, cfg)
    placement = None
    if leafwise:
        sync_cards()
        before = torch.cuda.memory_allocated()
        reset_cards_peak()
        placed, rise = place_leafwise(params, psh)
        sync_cards()
        peak_bytes, reckoned = torch.cuda.max_memory_allocated(), before + rise
        placement = {"peak_gib": peak_bytes / 2 ** 30, "reckoned_gib": reckoned / 2 ** 30,
                     "held_before_gib": before / 2 ** 30}
        check(peak_bytes <= (1 + NEMO_PEAK_RTOL) * reckoned, f"{arch}: placing leaf by leaf "
              f"peaked at {peak_bytes / 2 ** 30:.2f} GiB, reckoned {reckoned / 2 ** 30:.2f} "
              "(what was held, the whole tree among it, and its largest leaf copied)")
    else:
        placed = device_put(params, psh)
    del params
    sync_cards()
    torch.cuda.empty_cache()
    reset_cards_peak()
    held = torch.cuda.memory_allocated()
    with torch.inference_mode():
        _, cache = Engine(cfg, placed, max_len=max_len)._start(placed, prompts)
    slot_bytes, stored = check_placement(cfg, placed, psh, cache, mesh, max_len)
    del cache
    specs = {k: tuple(sh.spec) for k, sh in tree_leaves_with_path(psh)
             if k.startswith(shown)}
    marks.append(("placement", time.perf_counter()))

    # the user's call (Engine.generate; a vision prompt through the placed
    # prefill), counted: launches by route, collectives a step
    per_step, per_axis = serve_collectives(cfg, psh, *PMOE_GRID)
    reset_launches()
    mesh_mod.reset_collectives()
    if vision:
        (gen_p, _), gen_ms = timed_run(lambda: stepped(cfg, placed, prompts, max_len,
                                                       n=new_tokens, **vision))
    else:
        eng = Engine(cfg, placed, max_len=max_len)
        res, gen_ms = timed_run(lambda: eng.generate(prompts.cpu().numpy(),
                                                     max_new_tokens=new_tokens))
        gen_p = res.tokens[:, prompt_len:]
    counts = launches()
    routes = check_pserve_launches(arch, cfg, prompt_len, new_tokens, mesh)
    cols, by_axis = dict(mesh_mod.collectives), dict(mesh_mod.collectives_by_axis)
    check(cols == {k: new_tokens * v for k, v in per_step.items()}
          and by_axis == {k: new_tokens * v for k, v in per_axis.items()},
          f"{arch}: the generate's collectives {cols} ({by_axis} by axis), expected "
          f"{new_tokens} x {per_step} ({per_axis})")
    gen_bytes = dict(mesh_mod.collective_bytes)
    mesh_mod.reset_collectives()
    _, p_pre = timed_run(lambda: stepped(cfg, placed, prompts, max_len, n=1, **vision))
    pre_bytes = dict(mesh_mod.collective_bytes)
    p_dec = (gen_ms - p_pre) / (new_tokens - 1)
    dec_bytes = {k: (gen_bytes[k] - pre_bytes[k]) // (new_tokens - 1) for k in gen_bytes}
    # under torch.profiler (the device alone): a prefill, then decode steps
    # fed the whole model's tokens
    with torch.inference_mode():
        eng = Engine(cfg, placed, max_len=max_len)
        toks, cache = eng._start(placed, prompts)
        split_pre = device_split(lambda: serve_prefill(cfg, placed, eng, toks, cache, vision))

        def decode_profiled():
            for t in range(PMOE_DECODE_PROFILED):
                eng._serve(placed, cache, torch.as_tensor(tokens[:, t:t + 1], device=dev),
                           prompt_len + t)

        split_dec = device_split(decode_profiled)
        del cache
    print_split(arch, f"partitioned prefill 4 x {prompt_len}", p_pre, split_pre)
    print_split(arch, f"{PMOE_DECODE_PROFILED} partitioned decode step(s)",
                PMOE_DECODE_PROFILED * p_dec, split_dec)
    peak = cards_peak_gib()
    marks.append(("partitioned generate", time.perf_counter()))

    # teacher-forced on the whole model's tokens, its routing replayed
    with slot_replay(calls, *PMOE_GRID) as rep:
        _, lp = stepped(cfg, placed, prompts, max_len, tokens, **vision)
    agreement = tp_agreement(arch, lp, (tokens, lw, floor))
    n_moe = sum(b.ffn == "moe" for b in cfg.blocks)
    flips = (np.asarray(rep.flips).reshape(-1, n_moe).sum(0).tolist() if n_moe else [])
    decisions = sum(int(c.shape[0]) for c in calls)
    del lp, lw, placed
    torch.cuda.empty_cache()
    marks.append(("partitioned teacher-forced", time.perf_counter()))
    split_s = {k: round(t - (marks[i - 1][1] if i else t_model), 2)
               for i, (k, t) in enumerate(marks)}
    same = int((gen_p == tokens).sum())
    rec = {"arch": arch, "layers": cfg.num_layers, "prompt": prompt_len, "new": new_tokens,
           "max_len": max_len, "grid": list(PMOE_GRID), "specs": specs,
           "slot_bytes": slot_bytes, "stored_bytes": stored, "held_gib": held / 2 ** 30,
           "whole_reused": reused, "whole_prefill_ms": w_pre, "whole_decode_ms": w_dec,
           "whole_peak_gib": whole_peak, "prefill_ms": p_pre, "decode_ms": p_dec,
           "generate_ms": gen_ms,
           "device_busy_ms": {"prefill": None if split_pre is None else split_pre[0],
                              "decode": None if split_dec is None else split_dec[0]},
           "peak_gib": peak, "launches": counts, "flash_routes": routes[0],
           "collectives_per_step": per_step, "collectives_by_axis_per_step": per_axis,
           "collective_bytes_prefill": pre_bytes, "collective_bytes_decode_step": dec_bytes,
           "generate_tokens_equal": same, "agreement": agreement,
           "routing_flips_per_layer": flips, "routing_decisions": decisions,
           "leafwise_placement": placement,
           "seconds": time.perf_counter() - t_model, "seconds_by_part": split_s}
    if placement is not None:
        print(f"[{tag}] {arch}: placed leaf by leaf, each whole leaf dropped once placed: peak "
              f"{placement['peak_gib']:.2f} GiB against {placement['reckoned_gib']:.2f} reckoned "
              f"({placement['held_before_gib']:.2f} held before, the whole tree among it, and "
              "its largest leaf copied)")
    print(f"[{tag}] {arch} ({cfg.num_layers} layers) on {mesh!r}: specs {specs}; "
          f"{slot_bytes:,} bytes a slot of params and cache (= dryrun.slot_bytes), {stored:,} "
          f"bytes of params stored; whole prefill {w_pre:.2f} ms, decode {w_dec:.2f} ms a step "
          f"({'phase 13/14' if reused else 'this phase'}'s run); partitioned prefill "
          f"{p_pre:.2f} ms, decode {p_dec:.2f} ms a step, peak {peak:.2f} GiB (held "
          f"{held / 2 ** 30:.2f}); launches by route {routes} (exactly as worked out); "
          f"collectives a step {per_step} ({per_axis} by axis; the formula's), bytes a prefill "
          f"{pre_bytes}, a decode step {dec_bytes}; the generate's tokens equal the whole "
          f"model's at {same}/{gen_p.size}; with the whole run's routing replayed, the "
          f"partitioned run's own top-k would differ at {sum(flips)} of {decisions} (token, "
          f"layer) decisions, per MoE layer {flips}; {rec['seconds']:.1f} s ({split_s}) on "
          f"{card}")
    return counts, rec


def pmoe_train(arch, cfg, opt_name, lr, batch, seq, keep_names, card, tag="pmoe",
               check_update=False):
    """One f32 train step whole, then partitioned on (replica 2, model 2),
    the whole step's routing replayed: loss, aux and grad_norm at rtol
    PARTITIONED_RTOL, the ``keep_names`` gradients within PARTITIONED_RTOL
    / ATOL; the collectives the formula's; bytes a slot
    ``dryrun.slot_bytes``.  With ``check_update`` the ``keep_names``
    parameters the partitioned step updated are held, within the same
    bounds, against the whole optimizer's update of the same gradients
    (gathered, clipped by the step's grad_norm): the update over blocks is
    the whole one.  Against the whole step's updated parameters the
    difference is printed: where an update is about ``lr · sign(g)``
    (AdamW's first step, adafactor's rank-1 leaves) a gradient near zero
    that rounds the other way moves it by up to 2 · lr.  Returns the
    record."""
    t0_model = time.perf_counter()
    cfg = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")
    opt = make_optimizer(opt_name, constant_lr(lr))
    toks = np.random.default_rng(20).integers(3, cfg.vocab_size, (batch, seq))
    kept = {}

    def keep(grads):
        kept.update({k: v for k, v in tree_leaves_with_path(grads) if k in keep_names})
        return grads

    def fresh_state():
        gen = torch.Generator(device="cuda").manual_seed(0)
        return make_train_state(init_lm(cfg, gen, device="cuda"), opt)

    reset_cards_peak()
    state = fresh_state()
    init = {k: v.clone() for k, v in tree_leaves_with_path(state["params"]) if k in keep_names}
    with route_replay() as rec:
        (new, wm), whole_ms = timed_run(lambda: make_train_step(cfg, opt, grad_sync=keep)(
            state, {"tokens": toks}))
    whole_peak = cards_peak_gib()
    want = {k: wm[k].float() for k in ("loss", "aux", "grad_norm")}
    want_grads = dict(kept)
    want_new = {k: v for k, v in tree_leaves_with_path(new["params"]) if k in keep_names}
    kept.clear()
    del state, new
    torch.cuda.empty_cache()

    mesh = make_mesh(PMOE_GRID, ("replica", "model"))
    state = fresh_state()
    psh = sharding_mod.params_shardings(mesh, state["params"], cfg, data_axis="replica",
                                        model_axis="model")
    sh = {"params": psh, "opt": sharding_mod.opt_state_shardings(mesh, state["opt"], psh)}
    slot_want = dryrun_mod.slot_bytes(state, sh, mesh)
    placed = device_put(state, sh)
    del state
    torch.cuda.empty_cache()
    slot_got = sharding_mod.placed_slot_bytes(placed, mesh)
    check(slot_got == [slot_want] * mesh.devices.size,
          f"{arch}: placed bytes a slot {slot_got}, dryrun.slot_bytes {slot_want:,}")
    cols_want = partitioned_collectives(cfg, psh, *PMOE_GRID, opt_name=opt_name, mesh=mesh)
    step = make_train_step(cfg, opt, grad_sync=keep)
    reset_cards_peak()
    mesh_mod.reset_collectives()
    with slot_replay(rec.calls, *PMOE_GRID) as rep:
        (placed, pm), step_ms = timed_run(lambda: step(placed, {"tokens": toks}))
    peak = cards_peak_gib()
    cols, nbytes = dict(mesh_mod.collectives), dict(mesh_mod.collective_bytes)
    worst, failed = {}, []

    def held(got, w, what):
        if ((got - w).abs() - PARTITIONED_ATOL - PARTITIONED_RTOL * w.abs()).max().item() > 0:
            failed.append(what)
        worst[what] = ((got - w).abs().max() / w.abs().max().clamp(min=1e-30)).item()

    for key in ("loss", "aux", "grad_norm"):
        got = pm[key].float()
        worst[key] = ((got - want[key].to(got.device)).abs()
                      / want[key].abs().clamp(min=1e-30)).item()
        if worst[key] > PARTITIONED_RTOL:
            failed.append(f"{key} {got.item()} vs {want[key].item()}")
    grads = {k: sharding_mod.gather(kept[k]) for k in want_grads}
    for k, w in want_grads.items():
        held(grads[k], w, f"grads/{k}")
    vs_whole = {}
    if check_update:
        # the whole optimizer on the partitioned step's gradients, clipped as the step clips
        scale = torch.clamp(1.0 / (pm["grad_norm"].float() + 1e-9), max=1.0)
        sub = tree_from_paths(list(init.items()))
        clipped = tree_from_paths([(k, g * scale.to(g.device, g.dtype)) for k, g in grads.items()])
        upd, _ = opt.update(clipped, opt.init(sub), sub)
        for k, u in tree_leaves_with_path(upd):
            got = sharding_mod.gather(dict(tree_leaves_with_path(placed["params"]))[k])
            held(got, init[k] + u, f"params/{k}")
            vs_whole[k] = ((got - want_new[k]).abs().max() / lr).item()
            del got
        del sub, clipped, upd
    kept.clear()
    del want_grads, grads, placed, pm, init, want_new
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t0_model
    print(f"[{tag}] {arch} train step at full width ({cfg.num_layers} layers, f32, {opt_name}, "
          f"{batch} x {seq}) on {mesh!r}: whole step {whole_ms:.1f} ms, partitioned "
          f"{step_ms:.1f} ms, peak {peak:.2f} GiB (whole {whole_peak:.2f}); collectives {cols} "
          f"(the formula's {cols_want}), carrying {nbytes} bytes; the whole step's routing replayed (the partitioned "
          f"step's own top-k would differ at {sum(rep.flips)} decisions); against the whole "
          f"step, largest difference over the largest value "
          f"{ {k: float(f'{v:.3g}') for k, v in worst.items()} } (bounds rtol/atol "
          f"{PARTITIONED_RTOL:g}; params/ against the whole optimizer's update of the same "
          f"gradients); {slot_want:,} bytes a slot; {seconds:.1f} s on {card}")
    if vs_whole:
        print(f"[{tag}] {arch}: updated params against the whole step's, largest |d| in units of "
              f"lr {lr:g}: { {k: float(f'{v:.3g}') for k, v in vs_whole.items()} }")
    check(cols == cols_want, f"{arch}: the partitioned step ran collectives {cols}, expected "
          f"{cols_want}")
    check(not failed, f"{arch}: the partitioned step against the whole step, beyond rtol/atol "
          f"{PARTITIONED_RTOL:g}/{PARTITIONED_ATOL:g}: {failed}")
    return {"arch": arch, "layers": cfg.num_layers, "optimizer": opt_name, "batch": [batch, seq],
            "whole_ms": whole_ms, "step_ms": step_ms, "peak_gib": peak,
            "whole_peak_gib": whole_peak,
            "collectives": cols, "collective_bytes": nbytes, "worst": worst,
            "updated_vs_whole_in_lr": vs_whole,
            "slot_bytes": slot_want, "routing_flips": sum(rep.flips), "seconds": seconds}


def phase_pmoe_kernel_checks(gen):
    """flash_attention against its plain version at phase 20's per-slot
    shapes (B = 2 rows a data slot, the heads a model slot holds), each call
    through the route it must take.  Returns the largest error."""
    errs = []
    for arch, cfg, Sq, Sk, window in (
            ("granite-moe-1b-a400m", GRANITE_MOE, GEMMA_PROMPT, MOE_MAX_LEN, None),
            ("mixtral-8x7b", MIXTRAL, DENSE_PROMPT, DENSE_PROMPT + DENSE_NEW,
             MIXTRAL.pattern[0].window),
            ("qwen2-vl-72b", QWEN, QWEN_LEN, QWEN_LEN + QWEN_STEPS + 1, None)):
        q, k, v = qkv_on_card(2, Sq, Sk, cfg.num_heads // 2, cfg.num_kv_heads // 2,
                              cfg.head_dim, torch.bfloat16, gen)
        e1 = bf16_close(flash_routed("prefill_tc", q, k, v, window=window),
                        flash_attention_plain(q, k, v, window=window),
                        f"flash per slot {arch} prefill")
        q1 = q[:, :1].contiguous()
        e2 = bf16_close(flash_routed("decode", q1, k, v, window=window, q_offset=Sk - 1),
                        flash_attention_plain(q1, k, v, window=window, q_offset=Sk - 1),
                        f"flash per slot {arch} decode")
        print(f"[check] flash_attention per slot, {arch} on model 2: q [2, {Sq}, "
              f"{cfg.num_heads // 2}, {cfg.head_dim}] on {cfg.num_kv_heads // 2} kv heads, Sk "
              f"{Sk}, window {window}, bf16: prefill_tc max|d| {e1:.3g}, decode (q_offset "
              f"{Sk - 1}) {e2:.3g} (bound 1 bf16 ulp + 2e-5 x max(1, max|plain|))")
        errs += [e1, e2]
        del q, k, v, q1
    return max(errs)


def phase_partitioned_moe(card, gen):
    """Phase 20: the per-slot kernel checks, each of PMOE_SERVE whole and
    partitioned, then each of PMOE_TRAIN's steps.  Returns (launches summed
    over the partitioned runs, the phase's record)."""
    t_phase = time.perf_counter()
    err = phase_pmoe_kernel_checks(gen)
    total = dict.fromkeys(launches(), 0)
    served, trained = [], []
    for arch, cfg, prompt_len, new_tokens, max_len in PMOE_SERVE:
        counts, rec = pmoe_serve(arch, cfg, prompt_len, new_tokens, max_len, card)
        total = {k: total[k] + counts[k] for k in total}
        served.append(rec)
        torch.cuda.empty_cache()
    reset_launches()
    for args in PMOE_TRAIN:
        trained.append(pmoe_train(*args, card))
        torch.cuda.empty_cache()
    counts = launches()
    check(all(n == 0 for n in counts.values()), f"the train steps launched {counts}")
    for arch in [a for a in WHOLE_RUNS if a not in PSSM_REUSED]:  # phase 21 takes jamba's
        del WHOLE_RUNS[arch]
    seconds = time.perf_counter() - t_phase
    print(f"[pmoe] phase 20: {seconds:.1f} s on {card}; launches over the partitioned runs "
          f"{total}")
    return total, {"serve": served, "train": trained, "per_slot_max_abs_err": err,
                   "seconds": seconds}


# ---------------------------------------------------------------------------
# phase 21: the partitioned Mamba mixer, the RWKV train step and adafactor
# over blocks (slice 17)
# ---------------------------------------------------------------------------

# jamba-1.5-large-398b at layers 0-4 of 72 (JAMBA: Mamba at 0-3, attention at
# 4, MoE at 1 and 3; 24.0 B parameters, 48 GB bf16) served 4 x 256 -> 16 on
# (data 2, model 2) with FSDP as configured, its whole run phase 14's
# (WHOLE_RUNS), its placed tree built leaf by leaf from the same seeded init;
# then one f32 train step whole and on (replica 2, model 2): jamba at its
# layer 0 (Mamba + GLU, 2.1 B parameters) with adafactor, rwkv6-7b at 2 of 32
# layers with AdamW, each its configured optimizer, 4 x 64.
PSSM_REUSED = (JAMBA_ARCH,)
PSSM_TRAIN = ((JAMBA_ARCH, dataclasses.replace(get_config(JAMBA_ARCH), num_layers=1),
               "adafactor", 1e-3, 4, 64,
               ("embed", "final_norm/scale", "tail/layer0/norm1/scale",
                "tail/layer0/mamba/in_proj", "tail/layer0/mamba/conv_w",
                "tail/layer0/mamba/x_proj", "tail/layer0/mamba/dt_proj",
                "tail/layer0/mamba/dt_bias", "tail/layer0/mamba/A_log", "tail/layer0/mamba/D",
                "tail/layer0/mamba/out_proj", "tail/layer0/glu/w_down")),
              ("rwkv6-7b", dataclasses.replace(RWKV, num_layers=2), "adamw", 3e-4, 4, 64,
               ("final_norm/scale", "scan/pos0/rwkv/mu", "scan/pos0/rwkv/lora_mix/a",
                "scan/pos0/rwkv/lora_mix/b", "scan/pos0/rwkv/lora_w/a", "scan/pos0/rwkv/wr",
                "scan/pos0/rwkv/u", "scan/pos0/rwkv/wo", "scan/pos0/rwkv_cm/wk")))


def phase_pssm_kernel_checks(gen):
    """flash_attention against its plain version at jamba's per-slot shape
    on (data 2, model 2): 2 rows, 32 of its 64 query heads on 4 of its 8 KV
    heads of 128, no rope and no window, each call through the route it
    must take.  Returns the largest error."""
    cfg, Sq, Sk = JAMBA, DENSE_PROMPT, DENSE_PROMPT + DENSE_NEW
    q, k, v = qkv_on_card(2, Sq, Sk, cfg.num_heads // 2, cfg.num_kv_heads // 2, cfg.head_dim,
                          torch.bfloat16, gen)
    e1 = bf16_close(flash_routed("prefill_tc", q, k, v), flash_attention_plain(q, k, v),
                    "flash per slot jamba prefill")
    q1 = q[:, :1].contiguous()
    e2 = bf16_close(flash_routed("decode", q1, k, v, q_offset=Sk - 1),
                    flash_attention_plain(q1, k, v, q_offset=Sk - 1),
                    "flash per slot jamba decode")
    print(f"[check] flash_attention per slot, {JAMBA_ARCH} on model 2: q [2, {Sq}, "
          f"{cfg.num_heads // 2}, {cfg.head_dim}] on {cfg.num_kv_heads // 2} kv heads, Sk {Sk}, "
          f"no window, bf16: prefill_tc max|d| {e1:.3g}, decode (q_offset {Sk - 1}) {e2:.3g} "
          "(bound 1 bf16 ulp + 2e-5 x max(1, max|plain|))")
    return max(e1, e2)


def phase_partitioned_ssm(card, gen):
    """Phase 21: the per-slot kernel check, jamba whole (phase 14's run) and
    partitioned, then each of PSSM_TRAIN's steps.  Returns (launches over
    the partitioned generate, the phase's record)."""
    t_phase = time.perf_counter()
    err = phase_pssm_kernel_checks(gen)
    counts, served = pmoe_serve(JAMBA_ARCH, JAMBA, DENSE_PROMPT, DENSE_NEW,
                                DENSE_PROMPT + DENSE_NEW, card, tag="pssm", leafwise=True,
                                shown=("tail/layer0/mamba/", "tail/layer1/moe/"))
    WHOLE_RUNS.clear()
    torch.cuda.empty_cache()
    reset_launches()
    trained = []
    for args in PSSM_TRAIN:
        trained.append(pmoe_train(*args, card, tag="pssm", check_update=True))
        torch.cuda.empty_cache()
    after = launches()
    check(all(n == 0 for n in after.values()), f"the train steps launched {after}")
    seconds = time.perf_counter() - t_phase
    print(f"[pssm] phase 21: {seconds:.1f} s on {card}; launches over the partitioned generate "
          f"{counts}")
    return counts, {"serve": served, "train": trained, "per_slot_max_abs_err": err,
                    "seconds": seconds}


# ---------------------------------------------------------------------------
# phase 22: context-parallel serving (slice 18)
# ---------------------------------------------------------------------------

# one request (B = 1) served on (data 2, model 2), where the batch axis does
# not divide the batch: the prompt split into two chunks over data, the
# caches' sequence split over data (each data slot a block of the positions),
# a decode step's attention the partials of each slot's block merged across
# data (flash_decode.cu's partials and merge entries).  bf16 at full width with
# seed-0 weights, each model whole first: gemma3-1b (26 layers, linear caches,
# the ring cache off) 32,752 -> 16 in a 32,768-slot cache (prefill_32k's
# sequence: both data slots' blocks hold live keys and the decode writes into
# slot 1's); rwkv6-7b (8 of its 32 layers, FSDP) 4,096 -> 16 (rwkv6_scan
# chained over two chunks of 2,048); granite-moe-1b-a400m (8 of its 24 layers)
# 2,048 -> 16 (the MoE's global order over chunks, the replicated decode row).
# The two are cut in depth to keep the script within its time.
CP_GRID = (2, 2)
CP_NEW = 16
# (arch, prompt, cache slots, layers: None for the config's)
CP_MODELS = (("gemma3-1b", 32_752, 32_768, None), ("rwkv6-7b", 4_096, 4_112, 8),
             (MOE_ARCH, 2_048, 2_064, 8))
CP_DECODE_PROFILED = 1


def cp_routes(cfg, new_tokens, n_slots: int, M: int):
    """The kernels' launches by route over one context-parallel
    ``Engine.generate`` at B = 1, worked out from the code: each slot
    launches the prefill route once a layer on its chunk, and for each new
    token after the first ``decode_partial`` once a attention layer (once a
    group of at most 8 of its query rows a kv head) and ``decode_merge``
    once, or ``step`` once a RWKV layer."""
    n_attn = sum(b.mixer == "attn" for b in cfg.blocks)
    n_rwkv = sum(b.mixer == "rwkv" for b in cfg.blocks)
    steps = new_tokens - 1
    flash = dict.fromkeys(fa_mod.COUNTED, 0)
    if n_attn:
        hq, rep = slot_heads(cfg, M), cfg.num_heads // cfg.num_kv_heads
        rows = rep if (cfg.num_kv_heads % M == 0 or hq % rep == 0) else (
            hq if rep % hq == 0 else 1)      # query heads a slot's kv head serves
        groups = next(g for g in range(1, rows + 1) if rows % g == 0
                      and rows // g <= fa_mod.DECODE_ROWS)
        flash["prefill_tc"] = n_slots * n_attn
        flash["decode_partial"] = n_slots * n_attn * steps * groups
        flash["decode_merge"] = n_slots * n_attn * steps
    return flash, {"scan": n_slots * n_rwkv, "step": n_slots * n_rwkv * steps}


def partials_close(got, want, what):
    """Partials against the plain version's: an empty split's m exactly
    ``EMPTY_M`` on both sides; every other m (log2 units), l and acc
    within ``f32_close``'s 2e-5 x max(1, max |plain|), per column kind.
    Returns the largest error."""
    empty = want[..., 0] == fa_mod.EMPTY_M
    check(bool(torch.equal(got[..., 0] == fa_mod.EMPTY_M, empty)),
          f"{what}: the empty splits differ from the plain version's")
    live = ~empty
    errs = [f32_close(got[..., 0][live], want[..., 0][live], f"{what} m") if live.any() else 0.0,
            f32_close(got[..., 1], want[..., 1], f"{what} l"),
            f32_close(got[..., 2:], want[..., 2:], f"{what} acc")]
    return max(errs)


# phase 22's per-slot decode shapes: (label, (Hq, Hkv, hd, cache slots,
# position, window), the count of empty blocks expected or None)
CP_PARTIAL_CASES = (("gemma3-1b global", (2, 1, 256, 32_768, 32_760, None), None),
                    ("gemma3-1b local", (2, 1, 256, 32_768, 32_760, GEMMA_WINDOW), 1),
                    ("granite-moe", (8, 4, 64, 2_064, 2_060, None), None))


def cp_partial_checks(gen, cases=CP_PARTIAL_CASES, blocks=CP_GRID[0]):
    """The partials and merge entries against their plain versions at the
    per-slot decode shapes ``cases``, bf16 and f32 (phase 22's:
    gemma3-1b's q [1, 1, 2, 256] on one kv head over each 16,384-position
    block of its 32,768-slot cache at position 32,760 (a global layer:
    block 0 whole, block 1 partly; a local layer, window 512: block 0
    empty), and granite-moe's q [1, 1, 8, 64] on 4 kv heads over a
    1,032-slot block); then the merged output of both blocks against
    flash_attention_plain over the whole cache.  Returns the largest error
    and the gemma bf16 inputs (for timing) where ``cases`` hold them.
    ``blocks``: the blocks the cache is cut into (phase 26's four)."""
    worst = 0.0
    kept = None
    for dtype in (torch.bfloat16, torch.float32):
        for label, (Hq, Hkv, hd, L, pos, window), want_empty in cases:
            q, k, v = qkv_on_card(1, 1, L, Hq, Hkv, hd, dtype, gen)
            blk = L // blocks
            parts, empty = [], 0
            for r in range(blocks):
                kb, vb = k[:, r * blk:(r + 1) * blk].contiguous(), v[:, r * blk:(r + 1) * blk]
                vb = vb.contiguous()
                _, q_off, win = layers_mod.cache_block(L, pos, window, r, blocks)
                before = dict(flash_attention.launches_by_route)
                got = flash_attention_partials(q, kb, vb, window=win, q_offset=q_off)
                check(flash_attention.launches_by_route["decode_partial"]
                      == before["decode_partial"] + 1, "partials: not one decode_partial launch")
                want = flash_attention_partials_plain(q, kb, vb, window=win, q_offset=q_off)
                check(got.shape == want.shape, f"partials {tuple(got.shape)} vs plain "
                      f"{tuple(want.shape)}")
                empty += int(torch.all(want[..., 0] == fa_mod.EMPTY_M).item())
                worst = max(worst, partials_close(got, want, f"cp partials {label} block {r}"))
                parts.append(got)
            part = torch.cat(parts, 2)
            before = dict(flash_attention.launches_by_route)
            o = merge_partials(part, 1, dtype)
            check(flash_attention.launches_by_route["decode_merge"]
                  == before["decode_merge"] + 1, "merge: not one decode_merge launch")
            o_plain = merge_partials_plain(part, 1, dtype)
            whole = flash_attention_plain(q, k, v, window=window, q_offset=pos)
            close = bf16_close if dtype == torch.bfloat16 else f32_close
            worst = max(worst, close(o, o_plain, f"cp merge {label}"),
                        close(o, whole, f"cp decode {label} vs the whole cache"))
            if want_empty is not None:
                check(empty == want_empty, f"{label}: {empty} empty blocks, expected "
                      f"{want_empty}")
            if dtype == torch.bfloat16 and label.startswith("gemma3-1b global"):
                kept = (q, k, v, pos)
            print(f"[check] context-parallel decode {label} {str(dtype)[6:]}: q [1, 1, {Hq}, "
                  f"{hd}] on {Hkv} kv heads, {blocks} blocks of {blk} at position {pos} "
                  f"(window {window}): partials and merge vs plain, and the merge vs "
                  f"flash_attention_plain over all {L} keys, max|d| so far {worst:.3g} "
                  "(bf16: 1 bf16 ulp + 2e-5 x max(1, max|plain|); f32 and the partials: 2e-5 x "
                  "max(1, max|plain|))")
    return worst, kept


def cp_timing(inputs, card, n_blocks=CP_GRID[0], routes=None):
    """Kernel, plain version and SDPA for the two entries at gemma3-1b's
    per-slot decode shape (bf16): the partials over block 0 (16,384 keys,
    all visible) and the merge of both blocks' partials; and the two
    blocks' partials plus their merge (one data slot's share of a
    context-parallel step, both blocks on one card) against SDPA over the
    whole gathered cache for the same query.  ``n_blocks``: the blocks the
    cache is cut into (phase 26's four); ``routes``: the lines to time, by
    their first word (all three by default).  Returns the lines."""
    q, k, v, pos = inputs
    L = k.shape[1]
    blk = L // n_blocks
    blocks = [(k[:, r * blk:(r + 1) * blk].contiguous(), v[:, r * blk:(r + 1) * blk].contiguous(),
               layers_mod.cache_block(L, pos, None, r, n_blocks)[1]) for r in range(n_blocks)]
    part = torch.cat([flash_attention_partials(q, kb, vb, q_offset=off) for kb, vb, off in blocks],
                     2)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    mask = torch.arange(L, device=q.device)[None, :] <= pos

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True)

    kb0, vb0, off0 = blocks[0]
    cases = (
        ("decode_partial", "partials over block 0",
         lambda: flash_attention_partials(q, kb0, vb0, q_offset=off0),
         lambda: flash_attention_partials_plain(q, kb0, vb0, q_offset=off0),
         fa_mod.partials_cost(q, kb0, vb0, q_offset=off0), sdpa),
        ("decode_merge", f"merge of the {n_blocks} blocks' partials",
         lambda: merge_partials(part, 1, q.dtype),
         lambda: merge_partials_plain(part, 1, q.dtype), fa_mod.merge_cost(part, 1, q.dtype),
         None),
        ("context-parallel decode", f"the {n_blocks} blocks' partials and their merge",
         lambda: merge_partials(torch.cat([flash_attention_partials(q, kb, vb, q_offset=off)
                                           for kb, vb, off in blocks], 2), 1, q.dtype),
         lambda: merge_partials_plain(torch.cat([flash_attention_partials_plain(
             q, kb, vb, q_offset=off) for kb, vb, off in blocks], 2), 1, q.dtype),
         fa_mod.cost(q, k, v, q_offset=pos), sdpa))
    lines = []
    for route, what, fn, plain_fn, (flops, nbytes), lib_fn in cases:
        if routes is not None and route.split()[0] not in routes:
            continue
        bound, bound_by = bound_of(nbytes, flops, peak_flops(q.dtype))
        ms, runs = median_windows(fn, iters=200)
        plain, _ = median_windows(plain_fn, iters=5, warmup=1)
        g_ms, _ = graph_windows(fn, 200)
        lib = g_lib = None
        if lib_fn is not None:
            lib, _ = median_windows(lib_fn, iters=200)
            g_lib, _ = graph_windows(lib_fn, 200)
        print(f"[time] flash_attention {route} ({what}) gemma3-1b q {list(q.shape)} on 1 kv head, "
              f"{blk}-key blocks of a {L}-slot cache at position {pos}, bf16, on {card}: "
              f"kernel_ms {ms:.4f} (windows {[round(r, 4) for r in runs]}), bound_ms "
              f"{bound:.4f} ({bound_by}: {nbytes / 1e6:.2f} MB at 3.35 TB/s, {flops / 1e9:.3f} "
              f"GFLOP), kernel/bound {ms / bound:.2f}x, plain_ms {plain:.4f}, library_ms "
              + ("n/a (no PyTorch call merges partials)" if lib is None else
                 f"{lib:.4f} (scaled_dot_product_attention over all {L} keys, the same query)")
              + f"; replayed from a CUDA graph: kernel {g_ms:.4f} ms"
              + ("" if g_lib is None else f", SDPA {g_lib:.4f} ms"))
        lines.append({"label": f"{route}: {what}", "route": route, "ms": ms, "plain_ms": plain,
                      "bound_ms": bound, "bound_by": bound_by, "library_ms": lib,
                      "graph_ms": g_ms, "library_graph_ms": g_lib,
                      "source": "src/repro_torch/kernels/csrc/flash_decode.cu"})
    return lines


def cp_model(arch, prompt_len, max_len, layers, card):
    """One model whole, then at B = 1 on CP_GRID (the phase 22 comment), cut
    to its first ``layers`` where given: the record of the comparison,
    times and counts."""
    t_model = time.perf_counter()
    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    saved_ring = tt_mod.RING_CACHE
    tt_mod.RING_CACHE = False
    try:
        dev = torch.device("cuda")
        sync_cards()
        reset_cards_peak()
        params = init_lm(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
        prompts = np.random.default_rng(22).integers(3, cfg.vocab_size, (1, prompt_len))
        marks = [("init", time.perf_counter())]
        ref = whole_reference(cfg, params, prompts, max_len, CP_NEW)
        w_pre, w_dec = ref[3:]
        whole_peak = cards_peak_gib()
        marks.append(("whole reference", time.perf_counter()))

        mesh = make_mesh(CP_GRID, ("data", "model"))
        psh = sharding_mod.params_shardings(mesh, params, cfg)
        placed = device_put(params, psh)
        del params
        sync_cards()
        torch.cuda.empty_cache()
        reset_cards_peak()
        held = torch.cuda.memory_allocated()
        eng = Engine(cfg, placed, max_len=max_len)
        with torch.inference_mode():
            toks, cache = eng._start(placed, prompts)
        check(isinstance(toks, Placed) and toks.layout.spec == ((), ("data",)),
              f"{arch}: the prompt is not placed by its sequence over data")
        slot_bytes, stored = check_placement(cfg, placed, psh, cache, mesh, max_len, batch=1)
        del cache
        marks.append(("placement", time.perf_counter()))

        R, M = CP_GRID
        pre_c = serve_collectives(cfg, psh, R, M, step="chunks")
        dec_c = serve_collectives(cfg, psh, R, M, step="decode")
        reset_launches()
        mesh_mod.reset_collectives()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = eng.generate(prompts, max_new_tokens=CP_NEW)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        counts = launches()
        flash_want, rwkv_want = cp_routes(cfg, CP_NEW, mesh.devices.size, M)
        got_f = dict(flash_attention.launches_by_route)
        got_r = dict(rwkv6_scan.launches_by_route)
        check(got_f == flash_want and got_r == rwkv_want, f"{arch}: launched flash_attention "
              f"{got_f} and rwkv6_scan {got_r} by route, expected {flash_want} and {rwkv_want}")
        cols, by_axis = dict(mesh_mod.collectives), dict(mesh_mod.collectives_by_axis)
        want_cols = {k: pre_c[0].get(k, 0) + (CP_NEW - 1) * dec_c[0].get(k, 0)
                     for k in set(pre_c[0]) | set(dec_c[0])}
        want_axes = {k: pre_c[1].get(k, 0) + (CP_NEW - 1) * dec_c[1].get(k, 0)
                     for k in set(pre_c[1]) | set(dec_c[1])}
        check(cols == want_cols and by_axis == want_axes,
              f"{arch}: the generate's collectives {cols} ({by_axis} by axis), expected "
              f"{want_cols} ({want_axes}): a prefill {pre_c}, {CP_NEW - 1} decode steps {dec_c}")
        gen_bytes = dict(mesh_mod.collective_bytes)
        gen_p = res.tokens[:, prompt_len:]
        same = int((gen_p == ref[0]).sum())
        marks.append(("partitioned generate", time.perf_counter()))

        with torch.inference_mode():
            _, cache = eng._start(placed, prompts)
            mesh_mod.reset_collectives()
            lg, p_pre = timed_run(lambda: eng._prefill(placed, toks, cache)[0])
            pre_bytes = dict(mesh_mod.collective_bytes)
            p_dec = (gen_s * 1e3 - p_pre) / (CP_NEW - 1)
            dec_bytes = {k: (gen_bytes[k] - pre_bytes.get(k, 0)) // (CP_NEW - 1)
                         for k in gen_bytes}
            nxt = torch.argmax(lg, -1)[:, None]

            def decode_profiled():
                for t in range(CP_DECODE_PROFILED):
                    eng._serve(placed, cache, nxt, prompt_len + t)

            split_dec = device_split(decode_profiled)
            _, cache = eng._start(placed, prompts)
            split_pre = device_split(lambda: eng._prefill(placed, toks, cache))
            del cache, lg
        marks.append(("profile", time.perf_counter()))
        print_split(arch, f"context-parallel prefill 1 x {prompt_len}", p_pre, split_pre)
        print_split(arch, f"{CP_DECODE_PROFILED} context-parallel decode steps",
                    CP_DECODE_PROFILED * p_dec, split_dec)
        peak = cards_peak_gib()

        lp = stepped(cfg, placed, prompts, max_len, ref[0])[1]
        agreement = tp_agreement(f"{arch} B=1 context-parallel", lp, ref)
        del lp, placed, eng, ref
        torch.cuda.empty_cache()
        marks.append(("partitioned teacher-forced", time.perf_counter()))
        split_s = {k: round(t - marks[i][1], 2) for i, (k, t) in enumerate(marks[1:])}
        busy = {k: None if v is None else v[0] for k, v in (("prefill", split_pre),
                                                            ("decode", split_dec))}
        idle = {k: None if b is None else max(0.0, 1 - b / w) for (k, b), w in
                zip(busy.items(), (p_pre, CP_DECODE_PROFILED * p_dec))}
        rec = {"arch": arch, "batch": 1, "prompt": prompt_len, "new": CP_NEW,
               "max_len": max_len, "grid": list(CP_GRID), "mesh": repr(mesh),
               "slot_bytes": slot_bytes, "stored_bytes": stored, "held_gib": held / 2 ** 30,
               "whole_prefill_ms": w_pre, "whole_decode_ms": w_dec,
               "whole_peak_gib": whole_peak, "prefill_ms": p_pre, "decode_ms": p_dec,
               "generate_s": gen_s, "device_busy_ms": busy, "device_idle_share": idle,
               "peak_gib": peak, "launches": counts, "flash_routes": got_f, "rwkv_routes": got_r,
               "collectives_prefill": pre_c, "collectives_decode_step": dec_c,
               "collective_bytes_prefill": pre_bytes, "collective_bytes_decode_step": dec_bytes,
               "generate_tokens_equal": same, "agreement": agreement,
               "seconds": time.perf_counter() - t_model, "seconds_by_part": split_s}
        print(f"[cp] {arch} B=1 on {mesh!r}: {slot_bytes:,} bytes a slot of params and cache "
              f"(= dryrun.slot_bytes), {stored:,} bytes of params stored on the card(s); whole "
              f"model prefill {w_pre:.2f} ms, decode {w_dec:.2f} ms a step, peak "
              f"{whole_peak:.2f} GiB; context-parallel prefill {p_pre:.2f} ms, decode "
              f"{p_dec:.2f} ms a step, generate 1 x {prompt_len} -> {CP_NEW} {gen_s:.2f} s, peak "
              f"{peak:.2f} GiB (held {held / 2 ** 30:.2f}); launches by route {got_f} {got_r} "
              f"(exactly as worked out); collectives a prefill {pre_c}, a decode step {dec_c} "
              f"(the formula's), bytes a prefill {pre_bytes}, a decode step {dec_bytes}; the "
              f"generate's tokens equal the whole model's at {same}/{gen_p.size}; "
              f"{rec['seconds']:.1f} s ({split_s}, init {marks[0][1] - t_model:.1f} s) on {card}")
        return counts, rec
    finally:
        tt_mod.RING_CACHE = saved_ring


def phase_context_parallel(card, gen):
    """Phase 22: the partials and merge entries checked and timed at the
    per-slot shapes, then each of CP_MODELS whole and at B = 1 on CP_GRID.
    Returns (launches summed over the context-parallel generates, the
    phase's record)."""
    t_phase = time.perf_counter()
    err, inputs = cp_partial_checks(gen)
    lines = cp_timing(inputs, card)
    del inputs
    torch.cuda.empty_cache()
    total = dict.fromkeys(launches(), 0)
    routes = dict.fromkeys(fa_mod.COUNTED, 0)
    models = []
    for arch, prompt_len, max_len, layers in CP_MODELS:
        counts, rec = cp_model(arch, prompt_len, max_len, layers, card)
        total = {k: total[k] + counts[k] for k in total}
        routes = {k: routes[k] + rec["flash_routes"][k] for k in routes}
        models.append(rec)
        torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    print(f"[cp] phase 22: {seconds:.1f} s on {card}; launches over the context-parallel "
          f"generates {total}, flash_attention by route {routes}")
    return total, {"models": models, "per_slot_max_abs_err": err, "routes": lines,
                   "flash_routes": routes, "seconds": seconds}


# ---------------------------------------------------------------------------
# phase 23: the partitioned train step at B = 1 (slice 19)
# ---------------------------------------------------------------------------

# one training sequence (B = 1) on (data 2, model 2), where the batch axis
# does not divide the batch: the sequence split into two chunks over data
# ("chunks"), or, at a length 2 does not divide, whole on every slot
# ("whole").  f32 with seed-0 weights, each step held against the whole
# step of the same batch, run first and freed.  (arch, config, momentum,
# sequence, vision prefix, gradients and params held).  The sequences were
# halved (gemma3-1b, granite-moe) or quartered (rwkv6-7b and jamba, whose
# recurrences are Python loops over it) to keep the script within its time;
# the two chunks, their edge and every collective term stay.
CPT_GRID = (2, 2)
CPT_LR = PARTITIONED_SGD_LR
CPT_WHOLE_LAYERS = 6        # gemma3-1b at 4,095 (every slot the whole sequence): one period
CPT_TRAIN = (
    ("gemma3-1b", GEMMA, 0.9, 2_048, 0,
     ("embed", "final_norm/scale", "scan/pos0/attn/wq", "scan/pos0/attn/wk",
      "scan/pos5/attn/wo", "tail/layer25/glu/w_down")),
    ("gemma3-1b", dataclasses.replace(GEMMA, num_layers=CPT_WHOLE_LAYERS), 0.9, 4_095, 0,
     ("embed", "scan/pos0/attn/wk", "scan/pos5/attn/wv", "scan/pos5/glu/w_up")),
    (MOE_ARCH, GRANITE_MOE, 0.9, 1_024, 0,
     ("embed", "scan/pos0/moe/router", "scan/pos0/moe/w_gate", "scan/pos0/attn/wv")),
    ("rwkv6-7b", dataclasses.replace(RWKV, num_layers=2), 0.9, 256, 0,
     ("final_norm/scale", "scan/pos0/rwkv/wr", "scan/pos0/rwkv/u", "scan/pos0/rwkv/lora_w/a",
      "scan/pos0/rwkv_cm/wk")),
    (JAMBA_ARCH, dataclasses.replace(get_config(JAMBA_ARCH), num_layers=1), 0.9, 256, 0,
     ("tail/layer0/mamba/in_proj", "tail/layer0/mamba/conv_w", "tail/layer0/mamba/x_proj",
      "tail/layer0/mamba/A_log", "tail/layer0/mamba/out_proj")),
    ("qwen2-vl-72b", dataclasses.replace(get_config("qwen2-vl-72b"), num_layers=1), 0.0, 1_024,
     256, ("final_norm/scale", "scan/pos0/norm1/scale", "scan/pos0/attn/wq",
           "scan/pos0/attn/wk")),
)
# qwen2-vl-72b served at B = 1: 8 of 80 layers, bf16, a 2,048-position prompt
# whose first 1,296 positions are a 36 x 36 grid of merged patches
# (extra_embeds, M-RoPE positions t = 0, h, w), then text; 16 new tokens.
# The two 1,024-position chunks split the vision prefix.
CPT_QWEN_LAYERS, CPT_QWEN_PROMPT, CPT_QWEN_PATCHES, CPT_QWEN_NEW = 8, 2_048, 1_296, 16
_QWEN_SLOT = (QWEN.num_heads // CPT_GRID[1], QWEN.num_kv_heads // CPT_GRID[1], QWEN.head_dim)
# its per-slot decode shapes (q [1, 1, 32, 128] on 4 kv heads over each
# 1,032-slot block of the 2,064-slot cache): the served steps' last
# position, and one in block 0 (block 1 empty)
CPT_PARTIAL_CASES = tuple(
    (f"qwen2-vl-72b at {pos}", _QWEN_SLOT + (CPT_QWEN_PROMPT + CPT_QWEN_NEW, pos, None), empty)
    for pos, empty in ((CPT_QWEN_PROMPT + CPT_QWEN_NEW - 2, 0), (1_020, 1)))


def cpt_slot_checks(gen):
    """flash_attention at the per-slot shapes of the served qwen2-vl
    (CPT_GRID): the partials and merge entries at CPT_PARTIAL_CASES, bf16
    and f32 (``cp_partial_checks``), and each chunk's prefill, q [1, 1,024,
    32, 128] at q_offset 0 and 1,024 over the 2,048 gathered keys on 4 kv
    heads, bf16 through prefill_tc, against their plain versions within
    phase 22's bounds.  Returns the largest error."""
    worst, _ = cp_partial_checks(gen, CPT_PARTIAL_CASES)
    Hq, Hkv, hd = _QWEN_SLOT
    c = CPT_QWEN_PROMPT // CPT_GRID[0]
    q, k, v = qkv_on_card(1, c, CPT_QWEN_PROMPT, Hq, Hkv, hd, torch.bfloat16, gen)
    for r in range(CPT_GRID[0]):
        e = bf16_close(flash_routed("prefill_tc", q, k, v, causal=True, q_offset=r * c),
                       flash_attention_plain(q, k, v, causal=True, q_offset=r * c),
                       f"flash per slot qwen2-vl chunk {r} prefill")
        worst = max(worst, e)
        print(f"[check] flash_attention per slot, qwen2-vl-72b chunk {r} of {CPT_GRID[0]}: q [1, "
              f"{c}, {Hq}, {hd}] on {Hkv} kv heads at q_offset {r * c} over {CPT_QWEN_PROMPT} "
              f"keys, bf16: prefill_tc max|d| {e:.3g} (bound 1 bf16 ulp + 2e-5 x max(1, "
              "max|plain|))")
    del q, k, v
    return worst


def cpt_vision(cfg, n_patches, length, gen):
    """(positions [3, 1, length], extra_embeds [1, n_patches, D]) on the
    card: the patches on a square grid at t = 0, h = row, w = col (N(0,
    0.02^2) embeddings from ``gen``), the text after them on all three
    streams from the grid's side on."""
    dev = torch.device("cuda")
    side = int(round(n_patches ** 0.5))
    pos = torch.zeros((3, 1, length), dtype=torch.long, device=dev)
    grid = torch.arange(n_patches, device=dev)
    pos[1, :, :n_patches], pos[2, :, :n_patches] = grid // side, grid % side
    pos[:, :, n_patches:] = side + torch.arange(length - n_patches, device=dev)
    extra = 0.02 * torch.randn((1, n_patches, cfg.d_model), generator=gen, device=dev)
    return pos, extra.to(dtype_of(cfg.compute_dtype))


def cpt_peak_bound(cfg, psh, placed_params, seq_len: int, seq: str, whole_peak: int) -> int:
    """The reckoned bound of a partitioned step's peak at 1 x ``seq_len``
    on CPT_GRID (PERF.md §5): the whole step's peak plus what partitioning
    adds, each term at its worst.  (R - 1) more gradients of every leaf not
    split over data (each data index holds its own until the all-reduce);
    (R - 1) more copies of every leaf FSDP splits, and of its gradient (each
    data index's gathered block, kept for the backward, and the gradient of
    it before the reduce-scatter); for each MoE layer each slot's E / M
    experts at the whole sequence's capacity C, min(C, its T / R tokens)
    slots an expert, (x, gate, up, act·up, out: 2 D + 3 F floats a slot)
    against the whole's E C; where every slot holds the whole sequence,
    (R - 1) more of the loss's four f32 [S, V] tensors."""
    R = CPT_GRID[0]
    shapes = dict(tree_leaves_with_path(placed_params))
    extra = 0
    for name, sh in tree_leaves_with_path(psh):
        leaf = 4 * shapes[name].numel()
        extra += (R - 1) * (2 * leaf if "data" in sh.spec else leaf)
    moe = cfg.moe
    n_moe = sum(b.ffn == "moe" for b in cfg.blocks)
    if n_moe:
        E, K = moe.num_experts, moe.experts_per_token
        C = max(int(moe.capacity_factor * seq_len * K / E), K)
        per_slot = min(C, seq_len // R) if seq == "chunks" else C
        extra += n_moe * max(R * per_slot - C, 0) * E * (2 * cfg.d_model + 3 * cfg.d_ff) * 4
    if seq == "whole":
        extra += (R - 1) * 4 * seq_len * cfg.vocab_size * 4
    return whole_peak + extra


def cpt_train(arch, cfg, momentum, seq_len, n_vision, keep_names, card):
    """One f32 SGD step (with ``momentum``) of ``cfg`` at 1 x ``seq_len``:
    whole, its loss, aux, grad_norm, ``keep_names``' gradients and updated
    params kept on the host and its memory freed; then the same state
    placed on CPT_GRID and the same step partitioned, held against them
    within PARTITIONED_RTOL / ATOL; its collectives against
    ``partitioned_collectives(seq=)``.  Each side's second step is timed
    (the first pays the allocator's growth), a third partitioned step runs
    under torch.profiler (device busy ms, idle share against the second's
    wall).  The first partitioned step's peak is held under
    ``cpt_peak_bound``.  Returns the record."""
    t0_run = time.perf_counter()
    cfg = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")
    opt = make_optimizer("sgd", constant_lr(CPT_LR), momentum=momentum)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_lm(cfg, gen, device="cuda")
    batch = {"tokens": torch.as_tensor(np.random.default_rng(23).integers(
        3, cfg.vocab_size, (1, seq_len)), device="cuda")}
    if n_vision:
        batch["positions"], batch["extra_embeds"] = cpt_vision(cfg, n_vision, seq_len, gen)
    kept = {}

    def keep(grads):
        kept.update({k: v for k, v in tree_leaves_with_path(grads) if k in keep_names})
        return grads

    def host(tree):
        return {k: v.float().cpu() for k, v in tree.items()}

    state = make_train_state(params, opt)
    del params
    sync_cards()
    whole_held = torch.cuda.memory_allocated()
    reset_cards_peak()
    marks = [("init", time.perf_counter())]
    (new, wm), whole_first_ms = timed_run(lambda: make_train_step(cfg, opt, grad_sync=keep)(
        state, batch))
    whole_peak = torch.cuda.max_memory_allocated()
    want = {k: wm[k].float().item() for k in ("loss", "aux", "grad_norm")}
    want_grads = host(kept)
    want_new = host({k: v for k, v in tree_leaves_with_path(new["params"]) if k in keep_names})
    kept.clear()
    del state, wm
    _, whole_ms = timed_run(lambda: make_train_step(cfg, opt)(new, batch))
    del new, _
    sync_cards()
    torch.cuda.empty_cache()
    marks.append(("whole steps", time.perf_counter()))

    mesh = make_mesh(CPT_GRID, ("data", "model"))
    gen = torch.Generator(device="cuda").manual_seed(0)
    state = make_train_state(init_lm(cfg, gen, device="cuda"), opt)
    psh = sharding_mod.params_shardings(mesh, state["params"], cfg)
    sh = {"params": psh, "opt": sharding_mod.opt_state_shardings(mesh, state["opt"], psh)}
    placed = device_put(state, sh)
    del state
    sync_cards()
    torch.cuda.empty_cache()
    part_held = torch.cuda.memory_allocated()
    R, M = CPT_GRID
    seq = pt_mod.seq_layout(1, seq_len, R)
    reckoned = cpt_peak_bound(cfg, psh, placed["params"], seq_len, seq, whole_peak)
    marks.append(("placement", time.perf_counter()))
    cols_want = partitioned_collectives(cfg, psh, R, M, mesh=mesh, seq=seq)
    step = make_train_step(cfg, opt, grad_sync=keep)
    reset_launches()
    reset_cards_peak()
    mesh_mod.reset_collectives()
    (placed, pm), first_ms = timed_run(lambda: step(placed, batch))
    peak = torch.cuda.max_memory_allocated()
    cols, nbytes = dict(mesh_mod.collectives), dict(mesh_mod.collective_bytes)
    by_axis = dict(mesh_mod.collectives_by_axis)
    counts = launches()
    marks.append(("partitioned step", time.perf_counter()))
    worst, failed = {}, []
    for key in ("loss", "aux", "grad_norm"):
        got = pm[key].float().item()
        worst[key] = abs(got - want[key]) / max(abs(want[key]), 1e-30)
        if worst[key] > PARTITIONED_RTOL:
            failed.append(f"{key} {got} vs {want[key]}")
    new_leaves = dict(tree_leaves_with_path(placed["params"]))
    for part, got_tree, want_tree in (("grads", kept, want_grads),
                                      ("params", new_leaves, want_new)):
        for k, w in want_tree.items():   # one leaf at a time, on the card
            g, w = sharding_mod.gather(got_tree[k]).float(), w.to("cuda")
            if ((g - w).abs() - PARTITIONED_ATOL - PARTITIONED_RTOL * w.abs()).max().item() > 0:
                failed.append(f"{part} {k}")
            worst[f"{part}/{k}"] = ((g - w).abs().max() / w.abs().max().clamp(min=1e-30)).item()
            del g, w
    kept.clear()
    del new_leaves, want_grads, want_new, pm
    marks.append(("compared", time.perf_counter()))
    # a second step timed, a third under torch.profiler: where its time goes
    (placed, pm), step_ms = timed_run(lambda: step(placed, batch))
    marks.append(("second step", time.perf_counter()))
    split = device_split(lambda: step(placed, batch))
    kept.clear()
    marks.append(("profiled step", time.perf_counter()))
    busy = None if split is None else split[0]
    idle = None if busy is None else max(0.0, 1 - busy / step_ms)
    print_split(arch, f"partitioned step at 1 x {seq_len} ({seq})", step_ms, split)
    del placed, pm
    sync_cards()
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t0_run
    split_s = {k: round(t - (marks[i - 1][1] if i else t0_run), 2)
               for i, (k, t) in enumerate(marks)}
    print(f"[cpt] {arch} ({cfg.num_layers} layers, f32, SGD momentum {momentum}) at 1 x {seq_len}"
          f"{f' ({n_vision} embedded positions, M-RoPE)' if n_vision else ''}, {seq} over "
          f"{mesh!r}: whole step {whole_ms:.1f} ms (first {whole_first_ms:.1f}), peak "
          f"{whole_peak / 2 ** 30:.2f} GiB (held {whole_held / 2 ** 30:.2f}); partitioned "
          f"{step_ms:.1f} ms (first {first_ms:.1f}), device busy "
          f"{'n/a' if busy is None else f'{busy:.1f}'} ms, idle "
          f"{'n/a' if idle is None else f'{idle:.1%}'}, peak {peak / 2 ** 30:.2f} GiB (held "
          f"{part_held / 2 ** 30:.2f}, reckoned bound {reckoned / 2 ** 30:.2f}); collectives {cols} "
          f"({by_axis} by axis; the formula's {cols_want}), carrying {nbytes} bytes; against "
          f"the whole step, largest difference over the largest value "
          f"{ {k: float(f'{v:.3g}') for k, v in worst.items()} } (bounds rtol/atol "
          f"{PARTITIONED_RTOL:g}/{PARTITIONED_ATOL:g}); {seconds:.1f} s ({split_s}) on {card}")
    check(cols == cols_want, f"{arch} at 1 x {seq_len}: the partitioned step ran collectives "
          f"{cols}, expected {cols_want}")
    check(not failed, f"{arch} at 1 x {seq_len}: the partitioned step against the whole step, "
          f"beyond rtol/atol {PARTITIONED_RTOL:g}/{PARTITIONED_ATOL:g}: {failed}")
    check(peak <= reckoned, f"{arch} at 1 x {seq_len}: the partitioned step's peak "
          f"{peak / 2 ** 30:.2f} GiB is above the reckoned bound {reckoned / 2 ** 30:.2f} GiB")
    check(all(n == 0 for n in counts.values()), f"{arch}: the train step launched {counts}")
    return {"arch": arch, "layers": cfg.num_layers, "seq": [1, seq_len], "layout": seq,
            "vision": n_vision, "momentum": momentum, "whole_ms": whole_ms,
            "whole_first_ms": whole_first_ms, "step_ms": step_ms, "first_ms": first_ms,
            "device_busy_ms": busy, "device_idle_share": idle,
            "whole_peak_gib": whole_peak / 2 ** 30, "whole_held_gib": whole_held / 2 ** 30,
            "peak_gib": peak / 2 ** 30, "held_gib": part_held / 2 ** 30,
            "reckoned_peak_gib": reckoned / 2 ** 30, "collectives": cols,
            "collectives_by_axis": by_axis, "collective_bytes": nbytes, "worst": worst,
            "seconds": seconds, "seconds_by_part": split_s}


def cpt_serve_qwen(card):
    """qwen2-vl-72b (CPT_QWEN_LAYERS layers, bf16) whole, then at B = 1 on
    CPT_GRID: a vision prompt's prefill (M-RoPE positions, extra_embeds
    straddling the chunk edge) into a cache split over data, then
    CPT_QWEN_NEW - 1 decode steps; launches exact by route (``cp_routes``),
    collectives a prefill and a decode step the formula's
    (``serve_collectives(step=)``), the logits teacher-forced on the whole
    model's tokens within 4x its nudge yardstick (``tp_agreement``).
    Returns (launches over the partitioned generate, the record)."""
    t0_run = time.perf_counter()
    arch, n, P = "qwen2-vl-72b", CPT_QWEN_NEW, CPT_QWEN_PROMPT
    cfg = dataclasses.replace(get_config(arch), num_layers=CPT_QWEN_LAYERS)
    max_len = P + n
    dev = torch.device("cuda")
    sync_cards()
    reset_cards_peak()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_lm(cfg, gen, device=dev)
    pos, extra = cpt_vision(cfg, CPT_QWEN_PATCHES, P, gen)
    vision = {"positions": pos, "extra_embeds": extra}
    prompts = torch.as_tensor(np.random.default_rng(23).integers(3, cfg.vocab_size, (1, P)),
                              device=dev)
    (tokens, _), gen_ms = timed_run(lambda: stepped(cfg, params, prompts, max_len, n=n,
                                                    **vision))
    _, w_pre = timed_run(lambda: stepped(cfg, params, prompts, max_len, n=1, **vision))
    w_dec = (gen_ms - w_pre) / (n - 1)
    _, lw = stepped(cfg, params, prompts, max_len, tokens, **vision)
    with nudged_kernels(TP_NUDGE):
        _, ln = stepped(cfg, params, prompts, max_len, tokens, **vision)
    floor = logit_diff(ln, lw)
    del ln
    whole_peak = cards_peak_gib()

    mesh = make_mesh(CPT_GRID, ("data", "model"))
    psh = sharding_mod.params_shardings(mesh, params, cfg)
    placed = device_put(params, psh)
    del params
    sync_cards()
    torch.cuda.empty_cache()
    reset_cards_peak()
    R, M = CPT_GRID
    pre_c = serve_collectives(cfg, psh, R, M, step="chunks")
    dec_c = serve_collectives(cfg, psh, R, M, step="decode")
    reset_launches()
    mesh_mod.reset_collectives()
    (gen_p, _), p_ms = timed_run(lambda: stepped(cfg, placed, prompts, max_len, n=n, **vision))
    counts = launches()
    flash_want, rwkv_want = cp_routes(cfg, n, mesh.devices.size, M)
    got_f = dict(flash_attention.launches_by_route)
    check(got_f == flash_want, f"{arch} B=1: launched flash_attention {got_f} by route, "
          f"expected {flash_want}")
    cols, by_axis = dict(mesh_mod.collectives), dict(mesh_mod.collectives_by_axis)
    want_cols = {k: pre_c[0].get(k, 0) + (n - 1) * dec_c[0].get(k, 0)
                 for k in set(pre_c[0]) | set(dec_c[0])}
    want_axes = {k: pre_c[1].get(k, 0) + (n - 1) * dec_c[1].get(k, 0)
                 for k in set(pre_c[1]) | set(dec_c[1])}
    check(cols == want_cols and by_axis == want_axes, f"{arch} B=1: the generate's "
          f"collectives {cols} ({by_axis} by axis), expected {want_cols} ({want_axes})")
    gen_bytes = dict(mesh_mod.collective_bytes)
    mesh_mod.reset_collectives()
    _, p_pre = timed_run(lambda: stepped(cfg, placed, prompts, max_len, n=1, **vision))
    pre_bytes = dict(mesh_mod.collective_bytes)
    p_dec = (p_ms - p_pre) / (n - 1)
    dec_bytes = {k: (gen_bytes[k] - pre_bytes.get(k, 0)) // (n - 1) for k in gen_bytes}
    with torch.inference_mode():
        eng = Engine(cfg, placed, max_len=max_len)
        toks, cache = eng._start(placed, prompts)
        split_pre = device_split(lambda: serve_prefill(cfg, placed, eng, toks, cache, vision))
        del cache
    print_split(arch, f"context-parallel vision prefill 1 x {P}", p_pre, split_pre)
    peak = cards_peak_gib()
    lp = stepped(cfg, placed, prompts, max_len, tokens, **vision)[1]
    agreement = tp_agreement(f"{arch} B=1 vision prefill, context-parallel", lp,
                             (tokens, lw, floor))
    same = int((gen_p == tokens).sum())
    del lp, lw, placed
    torch.cuda.empty_cache()
    busy = None if split_pre is None else split_pre[0]
    seconds = time.perf_counter() - t0_run
    print(f"[cpt] {arch} ({cfg.num_layers} layers, bf16) B=1 on {mesh!r}: a {P}-position prompt "
          f"whose first {CPT_QWEN_PATCHES} are extra_embeds (M-RoPE), the chunks of "
          f"{P // R} splitting them; whole prefill {w_pre:.2f} ms, decode {w_dec:.2f} ms a step, "
          f"peak {whole_peak:.2f} GiB; context-parallel prefill {p_pre:.2f} ms (device busy "
          f"{'n/a' if busy is None else f'{busy:.2f}'} ms), decode {p_dec:.2f} ms a step, peak "
          f"{peak:.2f} GiB; launches by route {got_f} (exactly as worked out); collectives a "
          f"prefill {pre_c}, a decode step {dec_c} (the formula's), bytes a prefill {pre_bytes}, "
          f"a decode step {dec_bytes}; the generate's tokens equal the whole model's at "
          f"{same}/{gen_p.size}; {seconds:.1f} s on {card}")
    return counts, {"arch": arch, "layers": cfg.num_layers, "prompt": P,
                    "patches": CPT_QWEN_PATCHES, "new": n, "whole_prefill_ms": w_pre,
                    "whole_decode_ms": w_dec, "whole_peak_gib": whole_peak, "prefill_ms": p_pre,
                    "decode_ms": p_dec, "prefill_device_busy_ms": busy, "peak_gib": peak,
                    "launches": counts, "flash_routes": got_f,
                    "collectives_prefill": pre_c, "collectives_decode_step": dec_c,
                    "collective_bytes_prefill": pre_bytes,
                    "collective_bytes_decode_step": dec_bytes, "generate_tokens_equal": same,
                    "agreement": agreement, "seconds": seconds}


def phase_context_parallel_train(card, gen):
    """Phase 23: each of CPT_TRAIN whole and partitioned at B = 1, then
    flash_attention checked at the served qwen2-vl's per-slot shapes and
    its vision prompt served at B = 1.  Returns (launches over the
    context-parallel generate, the phase's record)."""
    t_phase = time.perf_counter()
    trained = []
    for arch, cfg, momentum, seq_len, n_vision, keep_names in CPT_TRAIN:
        trained.append(cpt_train(arch, cfg, momentum, seq_len, n_vision, keep_names, card))
        torch.cuda.empty_cache()
    err = cpt_slot_checks(gen)
    torch.cuda.empty_cache()
    counts, served = cpt_serve_qwen(card)
    seconds = time.perf_counter() - t_phase
    print(f"[cpt] phase 23: {seconds:.1f} s on {card}; launches over the context-parallel "
          f"vision generate {counts}, none on the train steps")
    return counts, {"train": trained, "serve": served, "per_slot_max_abs_err": err,
                    "seconds": seconds}


# ---------------------------------------------------------------------------
# slice 20: the encoder-decoder partitioned (phase 24)
# ---------------------------------------------------------------------------

# whisper-tiny at full width and depth (4 + 4 layers, d 384, 6 heads of 64,
# 1500 frames, vocab 51,865; 3 heads a model slot): one f32 AdamW step (its
# configured optimizer) at 8 x 448 tokens with 8 x 1500 frames whole, then
# on (data 2, model 2) and with fsdp=True on (replica 2, model 2); then bf16
# serving of 4 x 1500 frames and phase 14's 4-token prompts -> 32 tokens
# whole and on (data 2, model 2), through encode, prime and the serve steps.
PWHISPER_GRID = (2, 2)
PWHISPER_TRAIN = (8, 448)
PWHISPER_LR = 3e-4
PWHISPER_SELF_LEN = WHISPER_PROMPT + WHISPER_NEW   # the self cache's slots


def pwhisper_slot_checks(gen, card):
    """flash_attention at phase 24's per-slot shapes (B = 2 rows a data
    slot, 3 of the 6 heads of 64 a model slot, bf16) against its plain
    version, each call through the route it must take, then timed beside
    the plain version, its bound and ``scaled_dot_product_attention`` (no
    mask: every key is visible in all three): the encoder's bidirectional
    self-attention, q [2, 1500, 3, 64]; the cross-attention of one token
    over the 1500 frames; the self-attention decode over the 36-slot cache
    at its last position.  Returns (the largest error, the [time] lines)."""
    B, H = WHISPER_BATCH // PWHISPER_GRID[0], WHISPER.num_heads // PWHISPER_GRID[1]
    hd, N, L = WHISPER.head_dim, WHISPER.encoder_seq, PWHISPER_SELF_LEN
    q, k, v = qkv_on_card(B, N, N, H, H, hd, torch.bfloat16, gen)
    qs, ks, vs = qkv_on_card(B, 1, L, H, H, hd, torch.bfloat16, gen)
    cases = (("prefill_tc", "encoder self-attention, bidirectional", (q, k, v), {"causal": False}),
             ("decode", f"cross-attention of 1 token over the {N} frames",
              (q[:, :1].contiguous(), k, v), {"causal": False}),
             ("decode", f"self-attention decode over the {L}-slot cache at position {L - 1}",
              (qs, ks, vs), {"q_offset": L - 1}))
    errs, lines = [], []
    for route, what, args, kw in cases:
        errs.append(bf16_close(flash_routed(route, *args, **kw), flash_attention_plain(*args, **kw),
                               f"flash per slot whisper {what}"))
        flops, nbytes = fa_mod.cost(*args, **kw)
        bound, bound_by = bound_of(nbytes, flops, peak_flops(args[0].dtype))
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in args)

        def kernel(args=args, kw=kw):
            return flash_attention(*args, **kw)

        def sdpa(qt=qt, kt=kt, vt=vt):
            return F.scaled_dot_product_attention(qt, kt, vt)

        ms, runs = median_windows(kernel, iters=100)
        plain, _ = median_windows(lambda args=args, kw=kw: flash_attention_plain(*args, **kw),
                                  iters=5, warmup=1)
        lib, _ = median_windows(sdpa, iters=100)
        g_ms, _ = graph_windows(kernel, 100)
        g_lib, _ = graph_windows(sdpa, 100)
        shape = f"q {list(args[0].shape)} over {args[1].shape[1]} keys on {H} kv heads"
        print(f"[time] flash_attention {route} ({what}) whisper-tiny per slot on (2, 2), {shape}, "
              f"bf16, on {card}: kernel_ms {ms:.4f} (windows {[round(r, 4) for r in runs]}), "
              f"bound_ms {bound:.4f} ({bound_by}: {nbytes / 1e6:.2f} MB at 3.35 TB/s, "
              f"{flops / 1e9:.3f} GFLOP), kernel/bound {ms / bound:.2f}x, plain_ms {plain:.4f}, "
              f"library_ms {lib:.4f} (scaled_dot_product_attention, the same inputs); replayed "
              f"from a CUDA graph: kernel {g_ms:.4f} ms, SDPA {g_lib:.4f} ms")
        lines.append({"label": f"whisper-tiny per slot: {what}", "route": route, "ms": ms,
                      "plain_ms": plain, "bound_ms": bound, "bound_by": bound_by,
                      "library_ms": lib, "graph_ms": g_ms, "library_graph_ms": g_lib,
                      "source": f"src/repro_torch/kernels/csrc/{FLASH_SOURCE[route]}.cu"})
    print(f"[check] flash_attention per slot, whisper-tiny on (2, 2): the three shapes above "
          f"against flash_attention_plain: max|d| {max(errs):.3g} (bound 1 bf16 ulp + 2e-5 x "
          "max(1, max|plain|))")
    return max(errs), lines


def pwhisper_train(card, shape=PWHISPER_TRAIN, runs=(("data", False), ("replica", True)),
                   tag="pwhisper"):
    """Phase 24's train side (phase 25's at B = 1, ``shape`` the tokens'
    [B, S]): one f32 AdamW step of whisper-tiny whole (its gradients kept,
    a second step timed), then on (data 2, model 2) and, with fsdp=True, on
    (replica 2, model 2) (``runs``: (batch axis, fsdp) each): loss and
    grad_norm within rtol PARTITIONED_RTOL, every gradient within
    PARTITIONED_RTOL / ATOL of the whole step's and its largest difference
    within PARTITIONED_RTOL of its largest value, every updated parameter
    within the same bounds of the whole optimizer's update of the same
    gradients (AdamW's first step is about lr · sign(g): a gradient near
    zero that rounds the other way would move the whole step's by 2 lr),
    the collectives the formula's (``partitioned_collectives(seq=)``),
    bytes a slot ``dryrun.slot_bytes``; a second step timed, a third under
    ``torch.profiler``; then the eval step on the placed params, launches
    exact by route.  Returns the record."""
    dev = torch.device("cuda")
    Bt, St = shape
    opt = make_optimizer(WHISPER.optimizer, constant_lr(PWHISPER_LR))
    toks = np.random.default_rng(24).integers(3, WHISPER.vocab_size, (Bt, St))
    frames = torch.randn((Bt, WHISPER.encoder_seq, WHISPER.d_model),
                         generator=torch.Generator(device=dev).manual_seed(24), device=dev)
    batch = {"tokens": toks, "frames": frames}
    kept = {}

    def keep(grads):
        kept.clear()
        kept.update(tree_leaves_with_path(grads))
        return grads

    def fresh_state(cfg):
        gen = torch.Generator(device=dev).manual_seed(0)
        return make_train_state(whisper_mod.init_whisper(cfg, gen, device=dev), opt)

    cfg = dataclasses.replace(WHISPER, param_dtype="float32", compute_dtype="float32")
    reset_cards_peak()
    state = fresh_state(cfg)
    whole_step = make_train_step(cfg, opt, grad_sync=keep)
    (new, wm), _ = timed_run(lambda: whole_step(state, batch))
    want_grads = dict(kept)
    want_new = dict(tree_leaves_with_path(new["params"]))
    init = {k: v.clone() for k, v in tree_leaves_with_path(state["params"])}
    _, whole_ms = timed_run(lambda: whole_step(state, batch))
    whole_peak = cards_peak_gib()
    whole_eval = float(make_eval_step(cfg)(state["params"], batch))
    del state, new
    torch.cuda.empty_cache()
    records = []
    for axis, fsdp in runs:
        c = dataclasses.replace(cfg, fsdp=fsdp)
        mesh = make_mesh(PWHISPER_GRID, (axis, "model"))
        state = fresh_state(c)
        psh = sharding_mod.params_shardings(mesh, state["params"], c, data_axis=axis,
                                            model_axis="model")
        sh = {"params": psh, "opt": sharding_mod.opt_state_shardings(mesh, state["opt"], psh)}
        slot_want = dryrun_mod.slot_bytes(state, sh, mesh)
        placed = device_put(state, sh)
        del state
        torch.cuda.empty_cache()
        slot_got = sharding_mod.placed_slot_bytes(placed, mesh)
        check(slot_got == [slot_want] * mesh.devices.size,
              f"whisper-tiny: placed bytes a slot {slot_got}, dryrun.slot_bytes {slot_want:,}")
        seq = pt_mod.seq_layout(Bt, St, PWHISPER_GRID[0])
        cols_want = partitioned_collectives(c, psh, *PWHISPER_GRID, opt_name=c.optimizer,
                                            mesh=mesh, seq=seq)
        step = make_train_step(c, opt, grad_sync=keep)
        reset_cards_peak()
        mesh_mod.reset_collectives()
        (new_p, pm), first_ms = timed_run(lambda: step(placed, batch))
        peak = cards_peak_gib()
        cols, nbytes = dict(mesh_mod.collectives), dict(mesh_mod.collective_bytes)
        worst, failed = {}, []

        def held(got, w, what):
            if ((got - w).abs() - PARTITIONED_ATOL - PARTITIONED_RTOL * w.abs()).max().item() > 0:
                failed.append(what)
            worst[what] = ((got - w).abs().max() / w.abs().max().clamp(min=1e-30)).item()

        for key in ("loss", "grad_norm"):
            got, w = pm[key].float().item(), wm[key].float().item()
            worst[key] = abs(got - w) / abs(w)
            if worst[key] > PARTITIONED_RTOL:
                failed.append(f"{key} {got} vs {w}")
        grads = {k: sharding_mod.gather(g) for k, g in kept.items()}
        g_worst = 0.0
        for k, w in want_grads.items():
            held(grads[k], w, f"grads/{k}")
            g_worst = max(g_worst, worst.pop(f"grads/{k}"))
        # the whole optimizer on the partitioned step's gradients, clipped as the step clips
        scale = torch.clamp(1.0 / (pm["grad_norm"].float() + 1e-9), max=1.0)
        sub = tree_from_paths(list(init.items()))
        clipped = tree_from_paths([(k, g * scale.to(g.device, g.dtype)) for k, g in grads.items()])
        upd, _ = opt.update(clipped, opt.init(sub), sub)
        p_worst, vs_whole = 0.0, 0.0
        new_leaves = dict(tree_leaves_with_path(new_p["params"]))
        for k, u in tree_leaves_with_path(upd):
            got = sharding_mod.gather(new_leaves[k])
            held(got, init[k] + u, f"params/{k}")
            p_worst = max(p_worst, worst.pop(f"params/{k}"))
            vs_whole = max(vs_whole, ((got - want_new[k]).abs().max() / PWHISPER_LR).item())
        del grads, sub, clipped, upd, new_leaves, new_p
        worst.update({"grads": g_worst, "params": p_worst})
        if g_worst > PARTITIONED_RTOL:
            failed.append(f"a gradient {g_worst:.3g} of its largest value off the whole step's")
        _, step_ms = timed_run(lambda: step(placed, batch))
        split = device_split(lambda: step(placed, batch))
        print_split("whisper-tiny", f"partitioned train step on {mesh!r} (fsdp {fsdp}, f32 AdamW, "
                    f"{Bt} x {St} tokens ({seq or 'rows'}), {Bt} x {WHISPER.encoder_seq} frames)",
                    step_ms, split)
        # the eval step on the placed params, on the kernels
        reset_launches()
        p_eval = float(make_eval_step(c)(placed["params"], batch))
        eval_routes = dict(flash_attention.launches_by_route)
        want_routes = {r: mesh.devices.size * n for r, n in
                       whisper_routes(c, torch.float32, St, 1, c.encoder_seq).items()}
        check(eval_routes == want_routes, f"whisper-tiny partitioned eval step: flash_attention "
              f"launched {eval_routes} by route, expected {want_routes}")
        eval_rel = abs(p_eval - whole_eval) / abs(whole_eval)
        check(eval_rel <= PARTITIONED_RTOL, f"whisper-tiny partitioned eval loss {p_eval} vs the "
              f"whole model's {whole_eval}")
        del placed, pm
        torch.cuda.empty_cache()
        print(f"[{tag}] whisper-tiny train step ({c.encoder_layers} + {c.num_layers} "
              f"layers, f32, {c.optimizer}, {Bt} x {St} tokens ({seq or 'rows'} over {axis}), "
              f"{Bt} x {c.encoder_seq} frames) on {mesh!r} (fsdp {fsdp}): whole second "
              f"step {whole_ms:.1f} ms, partitioned first {first_ms:.1f} ms, second "
              f"{step_ms:.1f} ms, device idle "
              + ("not measured" if split is None else f"{max(0.0, 1 - split[0] / step_ms):.1%}")
              + f"; peak {peak:.2f} GiB (whole {whole_peak:.2f}); collectives "
              f"{cols} (the formula's {cols_want}), carrying {nbytes} bytes; largest difference "
              f"over the largest value {worst} (bounds rtol/atol {PARTITIONED_RTOL:g}; params "
              f"against the whole optimizer's update of the same gradients; against the whole "
              f"step's updated params {vs_whole:.3g} lr); eval loss {p_eval:.6f} (whole "
              f"{whole_eval:.6f}), flash_attention by route {eval_routes} (exactly as worked "
              f"out); {slot_want:,} bytes a slot; on {card}")
        check(cols == cols_want, f"whisper-tiny (fsdp {fsdp}): the partitioned step ran "
              f"collectives {cols}, expected {cols_want}")
        check(not failed, f"whisper-tiny (fsdp {fsdp}): the partitioned step against the whole "
              f"step, beyond rtol/atol {PARTITIONED_RTOL:g}/{PARTITIONED_ATOL:g}: {failed[:8]}")
        records.append({"grid": list(PWHISPER_GRID), "axes": [axis, "model"], "fsdp": fsdp,
                        "tokens": [Bt, St], "seq": seq, "first_ms": first_ms, "step_ms": step_ms,
                     "device_busy_ms": None if split is None else split[0], "peak_gib": peak,
                     "collectives": cols, "collective_bytes": nbytes, "worst": worst,
                     "updated_vs_whole_in_lr": vs_whole, "slot_bytes": slot_want,
                     "eval_loss": p_eval, "eval_routes": eval_routes})
    del want_grads, want_new, init
    kept.clear()
    torch.cuda.empty_cache()
    return {"whole_ms": whole_ms, "whole_peak_gib": whole_peak, "whole_eval_loss": whole_eval,
            "loss": wm["loss"].item(), "grad_norm": wm["grad_norm"].item(), "runs": records}


def pwhisper_serve(card, B=WHISPER_BATCH, tag="pwhisper"):
    """Phase 24's serving side (phase 25's at ``B`` = 1): whisper-tiny in
    bf16 (phase 14's seed-0 params, frames and prompts) whole, then placed
    on (data 2, model 2): one greedy run through encode, prime and the
    serve steps with the launches exact by route (``whisper_routes`` times
    the slots; ``cpw_routes`` at a batch the data axis does not divide) and
    the collectives the formula's (``whisper_collectives``: the encode, the
    prime, the prompt's serve step and ``new`` - 1 a token); the times of
    encode + prime + prompt and of a decode step, whole and partitioned,
    and one of each under ``torch.profiler``; the partitioned model
    teacher-forced on the whole model's tokens against its logits
    (``tp_agreement``); the prefill step (tokens and frames) against the
    whole one.  Returns (the launches of the partitioned greedy run, the
    record)."""
    dev = torch.device("cuda")
    cfg = WHISPER
    P, new = WHISPER_PROMPT, WHISPER_NEW
    max_len, N = PWHISPER_SELF_LEN, cfg.encoder_seq
    reset_cards_peak()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = whisper_mod.init_whisper(cfg, gen, device=dev)
    frames = torch.randn((B, N, cfg.d_model), generator=gen, device=dev).to(torch.bfloat16)
    prompts = np.random.default_rng(1).integers(3, cfg.vocab_size, (B, P))
    batch = {"tokens": torch.as_tensor(prompts, device=dev), "frames": frames}
    # the whole model: its tokens, logits teacher-forced on them, the yardstick, its times
    tokens = whisper_generate(cfg, params, frames, prompts, new, max_len)
    lw = whisper_stepped(cfg, params, frames, prompts, max_len, tokens)
    with nudged_kernels(TP_NUDGE):
        ln = whisper_stepped(cfg, params, frames, prompts, max_len, tokens)
    floor = logit_diff(ln, lw)
    del ln
    w_pre, _ = timed_ms(lambda: whisper_generate(cfg, params, frames, prompts, 1, max_len))
    w_gen, _ = timed_ms(lambda: whisper_generate(cfg, params, frames, prompts, new, max_len))
    w_dec = (w_gen - w_pre) / (new - 1)
    w_prefill = make_prefill_step(cfg)(params, batch)
    whole_peak = cards_peak_gib()

    mesh = make_mesh(PWHISPER_GRID, ("data", "model"))
    psh = sharding_mod.params_shardings(mesh, params, cfg)
    placed = device_put(params, psh)
    R, M = PWHISPER_GRID
    seq = pt_mod.seq_layout(B, P, R)   # the prompt's layout; a token's "decode"
    want = {w: whisper_collectives(cfg, psh, R, M, w, step=seq, max_len=max_len)
            for w in WHISPER_FORWARDS}
    want["decode"] = whisper_collectives(cfg, psh, R, M, "serve", step=seq and "decode",
                                         max_len=max_len)
    reset_cards_peak()
    reset_launches()
    mesh_mod.reset_collectives()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got_tokens = whisper_generate(cfg, placed, frames, prompts, new, max_len)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    counts = launches()
    routes = dict(flash_attention.launches_by_route)
    if seq is None:
        want_routes = {r: mesh.devices.size * n
                       for r, n in whisper_routes(cfg, torch.bfloat16, P, new, N).items()}
    else:
        want_routes = cpw_routes(cfg, torch.bfloat16, P, new, max_len, R, M)
    check(routes == want_routes, f"whisper-tiny partitioned generate: flash_attention launched "
          f"{routes} by route, expected {want_routes}")
    cols, by_axis = dict(mesh_mod.collectives), dict(mesh_mod.collectives_by_axis)
    want_cols, want_axis = {}, {}
    for w, n in (("encode", 1), ("prime", 1), ("serve", 1), ("decode", new - 1)):
        for total, part in ((want_cols, want[w][0]), (want_axis, want[w][1])):
            for k, c in part.items():
                total[k] = total.get(k, 0) + n * c
    want_cols = {k: c for k, c in want_cols.items() if c or k in NO_COLLECTIVES}
    check(cols == want_cols and by_axis == want_axis, f"whisper-tiny partitioned generate: "
          f"collectives {cols} ({by_axis} by axis), expected {want_cols} ({want_axis}): encode "
          f"+ prime + {new} serve steps")
    gen_bytes = dict(mesh_mod.collective_bytes)
    same = int((got_tokens == tokens).sum())
    # one prompt step's and one decode step's collectives alone
    with torch.inference_mode():
        cache = whisper_primed(cfg, placed, frames, B, max_len)
        serve = make_serve_step(cfg)
        step_cols = []
        for toks_t, idx in ((batch["tokens"], 0), (torch.as_tensor(tokens[:, :1], device=dev), P)):
            mesh_mod.reset_collectives()
            serve(placed, cache, toks_t, idx)
            step_cols.append((dict(mesh_mod.collectives), dict(mesh_mod.collectives_by_axis)))
        check(step_cols == [want["serve"], want["decode"]], f"whisper-tiny: the prompt's and a "
              f"decode step's collectives {step_cols}, expected {want['serve']} and "
              f"{want['decode']}")
        del cache
    p_pre, _ = timed_ms(lambda: whisper_generate(cfg, placed, frames, prompts, 1, max_len))
    p_gen, _ = timed_ms(lambda: whisper_generate(cfg, placed, frames, prompts, new, max_len))
    p_dec = (p_gen - p_pre) / (new - 1)
    split_pre = device_split(lambda: whisper_generate(cfg, placed, frames, prompts, 1, max_len))
    with torch.inference_mode():
        cache = whisper_primed(cfg, placed, frames, B, max_len)
        lg, cache = make_serve_step(cfg)(placed, cache, batch["tokens"], 0)
        nxt = torch.argmax(lg, -1)[:, None]
        split_dec = device_split(lambda: make_serve_step(cfg)(placed, cache, nxt, P))
        del cache, lg
    print_split("whisper-tiny", f"partitioned encode + prime + prompt ({B} x {N} frames, {P} "
                "tokens)", p_pre, split_pre)
    print_split("whisper-tiny", "1 partitioned decode step", p_dec, split_dec)
    peak = cards_peak_gib()
    lp = whisper_stepped(cfg, placed, frames, prompts, max_len, tokens)
    agreement = tp_agreement(f"whisper-tiny at B = {B} on (data 2, model 2)", lp,
                             (tokens, lw, floor))
    del lp
    # the prefill step (tokens and frames -> last logits), on the kernels
    reset_launches()
    mesh_mod.reset_collectives()
    lg = make_prefill_step(cfg)(placed, batch)
    pre_routes = dict(flash_attention.launches_by_route)
    want_pre = {r: mesh.devices.size * n
                for r, n in whisper_routes(cfg, torch.bfloat16, P, 1, N).items()}
    check(pre_routes == want_pre, f"whisper-tiny partitioned prefill step: flash_attention "
          f"launched {pre_routes} by route, expected {want_pre}")
    check((dict(mesh_mod.collectives), dict(mesh_mod.collectives_by_axis)) == want["prefill"],
          f"whisper-tiny partitioned prefill step: collectives {dict(mesh_mod.collectives)}, "
          f"expected {want['prefill']}")
    pre_mx, pre_mean = logits_agreement(lg[:, None], w_prefill[:, None], floor,
                                        "whisper-tiny partitioned prefill step")
    del lg, w_prefill, placed, params, lw
    torch.cuda.empty_cache()
    busy = {k: None if s is None else s[0] for k, s in (("prefill", split_pre),
                                                        ("decode", split_dec))}
    print(f"[{tag}] whisper-tiny served (bf16, {B} x {N} frames, {B} x {P} prompt -> {new}) on "
          f"{mesh!r}: whole encode + prime + prompt {w_pre:.2f} ms, decode {w_dec:.2f} ms a step, "
          f"peak {whole_peak:.2f} GiB; partitioned {p_pre:.2f} ms and {p_dec:.2f} ms a step, "
          f"greedy run {gen_s:.2f} s, peak {peak:.2f} GiB; launches by route {routes} (exactly "
          f"as worked out); collectives of the run {cols} ({by_axis} by axis; the formula's), "
          f"the prompt's step {want['serve'][0]}, a token's {want['decode'][0]}, carrying "
          f"{gen_bytes} bytes over the run; tokens "
          f"equal the whole model's at {same}/{tokens.size}; the prefill step's last logits "
          f"max|d| {pre_mx:.4g} mean {pre_mean:.3g} against the whole one's, launches "
          f"{pre_routes}; on {card}")
    return counts, {"whole_prefill_ms": w_pre, "whole_decode_ms": w_dec,
                    "whole_peak_gib": whole_peak, "prefill_ms": p_pre, "decode_ms": p_dec,
                    "generate_s": gen_s, "device_busy_ms": busy, "peak_gib": peak,
                    "flash_routes": routes, "collectives": cols, "collectives_by_axis": by_axis,
                    "collective_bytes": gen_bytes,
                    "collectives_per_forward": {w: want[w][0] for w in want},
                    "tokens_equal": same, "agreement": agreement,
                    "prefill_step": {"max_abs": pre_mx, "mean_abs": pre_mean,
                                     "routes": pre_routes}}


def phase_partitioned_whisper(card, gen):
    """Phase 24: flash_attention at the per-slot shapes, then whisper-tiny's
    train side and serving side.  Returns (launches over the partitioned
    greedy run, the phase's record)."""
    t_phase = time.perf_counter()
    err, lines = pwhisper_slot_checks(gen, card)
    torch.cuda.empty_cache()
    trained = pwhisper_train(card)
    counts, served = pwhisper_serve(card)
    seconds = time.perf_counter() - t_phase
    print(f"[pwhisper] phase 24: {seconds:.1f} s on {card}; launches over the partitioned greedy "
          f"run {counts}, none on the train steps")
    return counts, {"train": trained, "serve": served, "per_slot_max_abs_err": err,
                    "routes": lines, "seconds": seconds}


# ---------------------------------------------------------------------------
# phase 25: whisper at a batch the batch axis does not divide (slice 21)
# ---------------------------------------------------------------------------

# one audio request (B = 1) of whisper-tiny at full width on (data 2, model
# 2), four slots on one card: the encoder's 1,500 positions and the cross
# cache's in two chunks of 750 over data.  Trained f32 AdamW at 1 x 448
# tokens (in chunks) and 1 x 447 (every slot all of them), each with 1 x
# 1,500 frames; served bf16 with a 4-token prompt (two chunks) -> 32.
CPW_TRAIN = ((1, 448), (1, 447))
CPW_BATCH = 1


def cpw_routes(cfg, dtype, prompt_len, new_tokens, max_len, R: int, M: int):
    """flash_attention's launches by route over one greedy whisper run at a
    batch the data axis does not divide (encode, prime, the prompt at 0,
    then a token a step) on an (R, M) grid, worked out from the code, each
    of the R M slots on its Hq / M query heads: the encoder's chunk of the
    frames (all of them where R does not divide N) once an encoder layer;
    at the prompt a decoder layer's self-attention on its chunk's rows over
    the prompt's keys, and its cross-attention over its block of the cross
    cache as ``decode_partial`` (once a group of at most 8 query rows a kv
    head, every prompt row) and ``decode_merge`` once; at each token the
    self-attention's partials and merge (where R divides the self cache's
    ``max_len``, else the decode route with its combine) and the
    cross-attention's (where R divides N, else the decode route)."""
    want = dict.fromkeys(fa_mod.COUNTED, 0)
    slots, N, P = R * M, cfg.encoder_seq, prompt_len
    hq, rep = slot_heads(cfg, M), cfg.num_heads // cfg.num_kv_heads
    group = rep if (cfg.num_kv_heads % M == 0 or hq % rep == 0) else (
        hq if rep % hq == 0 else 1)      # query heads a slot's kv head serves

    def partials(rows):   # models.partitioned._partials' calls over ``rows`` query rows
        g = next((g for g in range(1, group + 1)
                  if group % g == 0 and rows * group // g <= fa_mod.DECODE_ROWS), group)
        return g * -(-rows // max(1, fa_mod.DECODE_ROWS // (group // g)))

    def attend(rows, split, layers=cfg.num_layers):
        if split:
            want["decode_partial"] += slots * layers * partials(rows)
            want["decode_merge"] += slots * layers
        else:
            r = fa_mod.route(dtype, rows, group, 1)
            want[r] += slots * layers
            want["decode_combine"] += slots * layers * (r == "decode")

    attend(N // R if N % R == 0 else N, False, cfg.encoder_layers)
    chunk = P // R if P % R == 0 else P
    attend(chunk, False)                              # the prompt's self-attention
    attend(P if N % R == 0 else chunk, N % R == 0)    # its cross-attention
    for _ in range(new_tokens - 1):
        attend(1, max_len % R == 0)
        attend(1, N % R == 0)
    return want


def cpw_slot_checks(gen, card):
    """flash_attention at phase 25's per-slot shapes (B = 1, 3 of the 6
    heads of 64 a model slot, the 1,500 frames in two chunks of 750 over
    data), bf16 and f32, against the plain versions, each through the route
    it must take: the encoder's chunk, q [1, 750, 3, 64] over the 1,500
    gathered keys, bidirectional (``prefill_tc``; f32 ``prefill_fma``);
    the cross-attention's ``decode_partial`` with no mask over each
    750-key block of the cross cache, for one token, q [1, 1, 3, 64], and
    for the prompt's 4 rows, q [1, 4, 3, 64] (the two chunks' rows
    gathered: every row sees both blocks), within ``partials_close``'s
    bounds; ``decode_merge`` of both blocks' partials against the plain
    merge and against flash_attention_plain over all 1,500 keys.  Then, in
    bf16, each timed beside its plain version, its bound and
    ``scaled_dot_product_attention`` over the whole 1,500 keys for the same
    query (no mask).  Returns (the largest error, the [time] lines)."""
    R, M = PWHISPER_GRID
    H, hd, N = WHISPER.num_heads // M, WHISPER.head_dim, WHISPER.encoder_seq
    c, blk = N // R, N // R
    worst, kept = 0.0, None
    for dtype in (torch.bfloat16, torch.float32):
        close = bf16_close if dtype == torch.bfloat16 else f32_close
        q, k, v = qkv_on_card(1, c, N, H, H, hd, dtype, gen)
        route = "prefill_tc" if dtype == torch.bfloat16 else "prefill_fma"
        e = close(flash_routed(route, q, k, v, causal=False),
                  flash_attention_plain(q, k, v, causal=False),
                  f"flash per slot whisper encoder chunk {str(dtype)[6:]}")
        worst = max(worst, e)
        blocks = [(k[:, r * blk:(r + 1) * blk].contiguous(),
                   v[:, r * blk:(r + 1) * blk].contiguous()) for r in range(R)]
        for rows in (1, WHISPER_PROMPT):
            qr = q[:, :rows].contiguous()
            parts = []
            for r, (kb, vb) in enumerate(blocks):
                before = dict(flash_attention.launches_by_route)
                got = flash_attention_partials(qr, kb, vb, causal=False)
                check(flash_attention.launches_by_route["decode_partial"]
                      == before["decode_partial"] + 1, "partials: not one decode_partial launch")
                want = flash_attention_partials_plain(qr, kb, vb, causal=False)
                check(got.shape == want.shape, f"partials {tuple(got.shape)} vs plain "
                      f"{tuple(want.shape)}")
                worst = max(worst, partials_close(got, want, f"whisper cross partials {rows} "
                                                  f"rows block {r} {str(dtype)[6:]}"))
                parts.append(got)
            part = torch.cat(parts, 2)
            before = dict(flash_attention.launches_by_route)
            o = merge_partials(part, rows, dtype)
            check(flash_attention.launches_by_route["decode_merge"]
                  == before["decode_merge"] + 1, "merge: not one decode_merge launch")
            worst = max(worst, close(o, merge_partials_plain(part, rows, dtype),
                                     f"whisper cross merge {rows} rows"),
                        close(o, flash_attention_plain(qr, k, v, causal=False),
                              f"whisper cross {rows} rows vs all {N} keys"))
        print(f"[check] flash_attention per slot, whisper-tiny at B = 1 on (2, 2), "
              f"{str(dtype)[6:]}: the encoder chunk q [1, {c}, {H}, {hd}] over {N} keys "
              f"({route}, bidirectional), the cross partials of q [1, 1, {H}, {hd}] and q [1, "
              f"{WHISPER_PROMPT}, {H}, {hd}] over each {blk}-key block with no mask and their "
              f"merge, against the plain versions and flash_attention_plain over all {N} keys: "
              f"max|d| so far {worst:.3g} (bf16: 1 bf16 ulp + 2e-5 x max(1, max|plain|); f32 "
              "and the partials: 2e-5 x max(1, max|plain|))")
        if dtype == torch.bfloat16:
            kept = (q, k, v, blocks)
        else:
            del q, k, v, blocks
    q, k, v, blocks = kept
    kt, vt = (t.transpose(1, 2).contiguous() for t in (k, v))
    lines = []

    def sdpa_for(qq):
        qt = qq.transpose(1, 2).contiguous()
        return lambda: F.scaled_dot_product_attention(qt, kt, vt)

    def both(qq, plain=False):
        fp, fm = ((flash_attention_partials_plain, merge_partials_plain) if plain
                  else (flash_attention_partials, merge_partials))
        return lambda: fm(torch.cat([fp(qq, kb, vb, causal=False) for kb, vb in blocks], 2),
                          qq.shape[1], qq.dtype)

    q1, q4 = q[:, :1].contiguous(), q[:, :WHISPER_PROMPT].contiguous()
    kb0, vb0 = blocks[0]
    part = torch.cat([flash_attention_partials(q1, kb, vb, causal=False) for kb, vb in blocks], 2)
    cases = (
        ("prefill_tc", f"encoder chunk q [1, {c}, {H}, {hd}] over all {N} keys",
         lambda: flash_attention(q, k, v, causal=False),
         lambda: flash_attention_plain(q, k, v, causal=False),
         fa_mod.cost(q, k, v, causal=False), sdpa_for(q)),
        ("decode_partial", f"cross partials of 1 token over the {blk}-key block 0",
         lambda: flash_attention_partials(q1, kb0, vb0, causal=False),
         lambda: flash_attention_partials_plain(q1, kb0, vb0, causal=False),
         fa_mod.partials_cost(q1, kb0, vb0, causal=False), sdpa_for(q1)),
        ("decode_partial", f"cross partials of the prompt's {WHISPER_PROMPT} rows over block 0",
         lambda: flash_attention_partials(q4, kb0, vb0, causal=False),
         lambda: flash_attention_partials_plain(q4, kb0, vb0, causal=False),
         fa_mod.partials_cost(q4, kb0, vb0, causal=False), sdpa_for(q4)),
        ("decode_merge", "merge of both blocks' partials of 1 token",
         lambda: merge_partials(part, 1, q.dtype), lambda: merge_partials_plain(part, 1, q.dtype),
         fa_mod.merge_cost(part, 1, q.dtype), None),
        ("context-parallel cross decode", "both blocks' partials of 1 token and their merge",
         both(q1), both(q1, plain=True), fa_mod.cost(q1, k, v, causal=False), sdpa_for(q1)))
    for route, what, fn, plain_fn, (flops, nbytes), lib_fn in cases:
        bound, bound_by = bound_of(nbytes, flops, peak_flops(q.dtype))
        ms, runs = median_windows(fn, iters=100)
        plain, _ = median_windows(plain_fn, iters=5, warmup=1)
        g_ms, _ = graph_windows(fn, 100)
        lib = g_lib = None
        if lib_fn is not None:
            lib, _ = median_windows(lib_fn, iters=100)
            g_lib, _ = graph_windows(lib_fn, 100)
        print(f"[time] flash_attention {route} ({what}) whisper-tiny per slot at B = 1 on (2, 2), "
              f"{H} heads of {hd} on {H} kv heads, bf16, on {card}: kernel_ms {ms:.4f} (windows "
              f"{[round(r, 4) for r in runs]}), bound_ms {bound:.4f} ({bound_by}: "
              f"{nbytes / 1e6:.2f} MB at 3.35 TB/s, {flops / 1e9:.3f} GFLOP), kernel/bound "
              f"{ms / bound:.2f}x, plain_ms {plain:.4f}, library_ms "
              + ("n/a (no PyTorch call merges partials)" if lib is None else
                 f"{lib:.4f} (scaled_dot_product_attention over all {N} keys, the same query, "
                 "no mask)")
              + f"; replayed from a CUDA graph: kernel {g_ms:.4f} ms"
              + ("" if g_lib is None else f", SDPA {g_lib:.4f} ms"))
        lines.append({"label": f"whisper-tiny at B = 1 per slot: {what}", "route": route,
                      "ms": ms, "plain_ms": plain, "bound_ms": bound, "bound_by": bound_by,
                      "library_ms": lib, "graph_ms": g_ms, "library_graph_ms": g_lib,
                      "source": "src/repro_torch/kernels/csrc/"
                                + ("flash_prefill.cu" if route == "prefill_tc"
                                   else "flash_decode.cu")})
    del q, k, v, kt, vt, blocks, part, kept
    return worst, lines


def phase_context_parallel_whisper(card, gen):
    """Phase 25: flash_attention at the per-slot shapes of one audio
    request on (data 2, model 2), non-causal partials and merge included;
    then whisper-tiny's train side at 1 x 448 and 1 x 447 tokens with 1 x
    1,500 frames and its serving side at B = 1.  Returns (launches over the
    partitioned greedy run, the phase's record)."""
    t_phase = time.perf_counter()
    err, lines = cpw_slot_checks(gen, card)
    torch.cuda.empty_cache()
    trained = [pwhisper_train(card, shape, (("data", False),), tag="cpw") for shape in CPW_TRAIN]
    counts, served = pwhisper_serve(card, B=CPW_BATCH, tag="cpw")
    seconds = time.perf_counter() - t_phase
    print(f"[cpw] phase 25: {seconds:.1f} s on {card}; launches over the partitioned greedy run "
          f"{counts}, flash_attention by route {served['flash_routes']}, none on the train steps")
    return counts, {"train": trained, "serve": served, "per_slot_max_abs_err": err,
                    "routes": lines, "seconds": seconds}


# ---------------------------------------------------------------------------
# phase 26: the partitioned steps on the reference's production grids (slice 22)
# ---------------------------------------------------------------------------

# grid -> (mesh shape, axis names, data_axis, model_axis): (a) the multi-pod
# mesh's default, where no spec names pod (replicated: each pod runs the
# same program on the same blocks); (b) the dry run's dp strategy, the batch
# over both axes of (data, model) and no tensor parallelism
PGRID_GRIDS = {"a": ((2, 2, 2), ("pod", "data", "model"), "data", "model"),
               "b": ((2, 2), ("data", "model"), ("data", "model"), None)}
# gemma3-1b at full width cut to its first period (5 local layers and the
# global one) of 26; granite-moe at 4 of its 24 layers
PGRID_LAYERS, PGRID_MOE_LAYERS = 6, 4
PGRID_TRAIN_SHAPE = (8, 512)
PGRID_TRAIN = (("a", False), ("b", False), ("b", True))      # (grid, fsdp): f32 SGD
PGRID_NEW = 16
# (arch, grid, batch, prompt, cache slots): the B = 1 run's prompt in four
# chunks of 1,024 and its 4,112 slots in four blocks of 1,028 over (data, model)
PGRID_SERVE = (("gemma3-1b", "a", 8, 512, 528), ("gemma3-1b", "b", 4, 512, 528),
               ("gemma3-1b", "b", 1, 4_096, 4_112), (MOE_ARCH, "b", 4, 512, 528))
PGRID_BLOCKS = 4
# the B = 1 run's per-slot decode shapes: q [1, 1, 4, 256] on one kv head over
# each 1,028-slot block at position 4,110 (a local layer: blocks 0-2 empty)
PGRID_PARTIAL_CASES = (("gemma3-1b global, 4 blocks", (4, 1, 256, 4_112, 4_110, None), None),
                       ("gemma3-1b local, 4 blocks", (4, 1, 256, 4_112, 4_110, GEMMA_WINDOW), 3))
PGRID_DECODE_PROFILED = 1


def axes_json(by_axis):
    """A ``collectives_by_axis`` dict with a tuple of axes keyed by its
    names joined with commas (JSON keys are strings)."""
    return {k if isinstance(k, str) else ",".join(k): v for k, v in by_axis.items()}


def pgrid_grid(g):
    """(mesh, the steps' axes keywords, the ``models.partitioned.Grid``) of
    PGRID_GRIDS' grid ``g``."""
    shape, names, da, ma = PGRID_GRIDS[g]
    mesh = make_mesh(shape, names)
    return mesh, {"data_axis": da, "model_axis": ma}, pt_mod.make_grid(mesh, da, ma)


class pod_twins:
    """Inside the block, every ``axis_all_reduce`` and ``axis_all_gather``
    call over all the slots of a grid whose ``pod`` axis is replicated holds
    each slot's operand equal, bit for bit, to its twin's on the other pod
    (the slot of the same data and model index): the two pods' losses,
    gradients (each all-reduced over data) and logits (gathered over model
    and data) pass through these calls.  On one card the two pods' slots
    share each stored block of the params and the cache (one block a
    device), written by both with these equal values.  ``calls`` and
    ``operands`` count what was compared."""

    def __init__(self, mesh):
        self.pairs, self.n = mesh.groups("pod"), mesh.devices.size
        self.calls = self.operands = 0

    def __enter__(self):
        self.saved = (mesh_mod.axis_all_reduce, mesh_mod.axis_all_gather)
        mesh_mod.axis_all_reduce, mesh_mod.axis_all_gather = (self.wrap(f) for f in self.saved)
        return self

    def wrap(self, real):
        def call(parts, *args, **kw):
            if len(parts) == self.n:
                self.calls += 1
                for grp in self.pairs:
                    a = parts[grp[0]]
                    for s in grp[1:]:
                        b = parts[s]
                        check((a is None) == (b is None) and (a is None or torch.equal(a, b)),
                              f"pods differ: slot {grp[0]} and slot {s}'s operands of a "
                              f"{real.__name__} call")
                        self.operands += 1
            return real(parts, *args, **kw)

        return call

    def __exit__(self, *exc):
        mesh_mod.axis_all_reduce, mesh_mod.axis_all_gather = self.saved


def pgrid_slot_checks(gen, card):
    """flash_attention at the per-slot shapes of phase 26's B = 1 run on
    grid (b): the partials over each of the four 1,028-slot blocks and
    their merge, bf16 and f32 (``cp_partial_checks(blocks=4)``, the merge
    also against flash_attention_plain over all 4,112 keys); each chunk's
    prefill, q [1, 1,024, 4, 256] at q_offset r x 1,024 over the 4,096
    gathered keys on one kv head, bf16 through prefill_tc, window 512 and
    none; then the four-block merge and the whole step's share (four
    partials and their merge) timed against their bound, the plain version
    and SDPA over the whole cache.  Returns (the largest error, the
    ``[time]`` lines)."""
    worst, inputs = cp_partial_checks(gen, PGRID_PARTIAL_CASES, blocks=PGRID_BLOCKS)
    c = PGRID_SERVE[2][3] // PGRID_BLOCKS
    q, k, v = qkv_on_card(1, c, PGRID_SERVE[2][3], 4, 1, 256, torch.bfloat16, gen)
    for window in (None, GEMMA_WINDOW):
        for r in range(PGRID_BLOCKS):
            kw = dict(causal=True, window=window, q_offset=r * c)
            e = bf16_close(flash_routed("prefill_tc", q, k, v, **kw),
                           flash_attention_plain(q, k, v, **kw),
                           f"flash per slot gemma3-1b chunk {r} prefill")
            worst = max(worst, e)
        print(f"[check] flash_attention per slot, gemma3-1b's {PGRID_BLOCKS} chunks on grid (b): "
              f"q [1, {c}, 4, 256] on 1 kv head at q_offset 0..{(PGRID_BLOCKS - 1) * c} over "
              f"{PGRID_SERVE[2][3]} keys, window {window}, bf16: prefill_tc max|d| so far "
              f"{worst:.3g} (bound 1 bf16 ulp + 2e-5 x max(1, max|plain|))")
    del q, k, v
    lines = cp_timing(inputs, card, n_blocks=PGRID_BLOCKS,
                      routes=("decode_merge", "context-parallel"))
    del inputs
    return worst, lines


def pgrid_train(card):
    """gemma3-1b (PGRID_LAYERS layers at full width, f32, SGD momentum 0.9)
    one step at PGRID_TRAIN_SHAPE whole, every gradient and updated param
    kept on the card, a second step timed; then for each of PGRID_TRAIN's
    (grid, fsdp) the same state placed with the grid's axes and the same
    step partitioned: loss, grad_norm, every gradient and every updated
    param against the whole step's (largest difference within
    PARTITIONED_RTOL of the leaf's largest value), each slot's rows (B / R),
    the collectives ``partitioned_collectives(grid=)``' and over the grid's
    axes alone, on grid (a) the two pods' operands equal bit for bit
    (``pod_twins``), bytes a slot ``dryrun.slot_bytes``; a second step
    timed, a third profiled (idle share), the peak.  Returns the runs'
    records."""
    B, S = PGRID_TRAIN_SHAPE
    cfg = dataclasses.replace(GEMMA, num_layers=PGRID_LAYERS, param_dtype="float32",
                              compute_dtype="float32")
    opt = make_optimizer("sgd", constant_lr(PARTITIONED_SGD_LR), momentum=0.9)
    batch = {"tokens": torch.as_tensor(np.random.default_rng(26).integers(
        3, cfg.vocab_size, (B, S)), device="cuda")}
    kept = {}

    def keep(grads):
        kept.update(tree_leaves_with_path(grads))
        return grads

    def fresh():
        gen = torch.Generator(device="cuda").manual_seed(0)
        return make_train_state(init_lm(cfg, gen, device="cuda"), opt)

    t0 = time.perf_counter()
    sync_cards()
    reset_cards_peak()
    state = fresh()
    (new, wm), whole_first = timed_run(lambda: make_train_step(cfg, opt, grad_sync=keep)(
        state, batch))
    del state
    want = {k: wm[k].float().item() for k in ("loss", "grad_norm")}
    want_grads, want_new = dict(kept), dict(tree_leaves_with_path(new["params"]))
    kept.clear()
    _, whole_ms = timed_run(lambda: make_train_step(cfg, opt)(new, batch))
    del _, new, wm
    whole_peak = cards_peak_gib()
    sync_cards()
    torch.cuda.empty_cache()
    whole_s = time.perf_counter() - t0
    runs = []
    for g, fsdp in PGRID_TRAIN:
        t_run = time.perf_counter()
        cfg_g = dataclasses.replace(cfg, fsdp=fsdp)
        mesh, axes, grid = pgrid_grid(g)
        state = fresh()
        psh = sharding_mod.params_shardings(mesh, state["params"], cfg_g, **axes)
        sh = {"params": psh, "opt": sharding_mod.opt_state_shardings(mesh, state["opt"], psh)}
        slot_bytes = dryrun_mod.slot_bytes(state, sh, mesh)
        placed = device_put(state, sh)
        del state
        check(sharding_mod.placed_slot_bytes(placed, mesh) == [slot_bytes] * mesh.devices.size,
              f"grid ({g}): placed bytes a slot differ from dryrun.slot_bytes {slot_bytes:,}")
        sync_cards()
        torch.cuda.empty_cache()
        cols_want = partitioned_collectives(cfg_g, psh, grid.R, grid.M, grid=grid)
        step = make_train_step(cfg_g, opt, grad_sync=keep, grad_shardings=psh, **axes)
        rows = []
        real_loss = pt_mod.partitioned_loss

        def spy(*args, **kw):
            rows.append([t.shape[0] for t in args[4]])
            return real_loss(*args, **kw)

        reset_launches()
        reset_cards_peak()
        mesh_mod.reset_collectives()
        twins = pod_twins(mesh) if "pod" in grid.replicated else contextlib.nullcontext()
        pt_mod.partitioned_loss = spy
        try:
            with twins:
                (placed, pm), first_ms = timed_run(lambda: step(placed, batch))
        finally:
            pt_mod.partitioned_loss = real_loss
        peak = cards_peak_gib()
        cols, by_axis = dict(mesh_mod.collectives), dict(mesh_mod.collectives_by_axis)
        nbytes = dict(mesh_mod.collective_bytes)
        counts = launches()
        worst = {k: abs(pm[k].float().item() - want[k]) / abs(want[k]) for k in want}
        new_leaves = dict(tree_leaves_with_path(placed["params"]))
        for part, got_tree, want_tree in (("grads", kept, want_grads),
                                          ("params", new_leaves, want_new)):
            for k, w in want_tree.items():
                d = (sharding_mod.gather(got_tree[k]).float() - w.float()).abs().max()
                worst[f"{part}/{k}"] = (d / w.float().abs().max().clamp(min=1e-30)).item()
        kept.clear()
        del new_leaves, pm
        (placed, _), step_ms = timed_run(lambda: step(placed, batch))
        split = device_split(lambda: step(placed, batch))
        kept.clear()
        busy = None if split is None else split[0]
        idle = None if busy is None else max(0.0, 1 - busy / step_ms)
        print_split("gemma3-1b", f"partitioned step on grid ({g}), fsdp {fsdp}", step_ms, split)
        del placed, _
        sync_cards()
        torch.cuda.empty_cache()
        over = {k: v for k, v in worst.items() if v > PARTITIONED_RTOL}
        top = sorted(worst.items(), key=lambda kv: -kv[1])[:3]
        twin = (f"; the pods' operands bit-equal over {twins.calls} calls "
                f"({twins.operands} pairs)" if isinstance(twins, pod_twins) else "")
        seconds = time.perf_counter() - t_run
        print(f"[pgrid] gemma3-1b ({PGRID_LAYERS} layers, f32, SGD) {B} x {S} on grid ({g}) "
              f"{mesh!r}, data_axis={axes['data_axis']!r}, model_axis={axes['model_axis']!r}, "
              f"fsdp {fsdp}: rows a slot {rows[0]}; whole step {whole_ms:.1f} ms (first "
              f"{whole_first:.1f}), peak {whole_peak:.2f} GiB; partitioned {step_ms:.1f} ms "
              f"(first {first_ms:.1f}), device busy {'n/a' if busy is None else f'{busy:.1f}'} "
              f"ms, idle {'n/a' if idle is None else f'{idle:.1%}'}, peak {peak:.2f} GiB; "
              f"{slot_bytes:,} bytes a slot (= dryrun.slot_bytes); collectives {cols} "
              f"({by_axis} by axis; the formula's {cols_want}), carrying {nbytes} bytes{twin}; "
              f"largest difference over the leaf's largest value, worst three "
              f"{[(k, float(f'{v:.3g}')) for k, v in top]} (bound {PARTITIONED_RTOL:g}); "
              f"{seconds:.1f} s on {card}")
        check(cols == cols_want, f"grid ({g}): collectives {cols}, expected {cols_want}")
        check(set(by_axis) <= {grid.dp, grid.model}, f"grid ({g}): a collective crossed an "
              f"axis the grid replicates: {by_axis}")
        check(all(r == B // grid.R for r in rows[0]), f"grid ({g}): rows a slot {rows[0]}")
        check(not over, f"grid ({g}): against the whole step beyond {PARTITIONED_RTOL:g}: {over}")
        check(all(n == 0 for n in counts.values()), f"grid ({g}): the train step launched {counts}")
        runs.append({"grid": g, "mesh": repr(mesh), "axes": {k: v for k, v in axes.items()},
                     "fsdp": fsdp, "shape": [B, S], "rows_a_slot": rows[0],
                     "whole_ms": whole_ms, "whole_first_ms": whole_first,
                     "whole_peak_gib": whole_peak, "step_ms": step_ms, "first_ms": first_ms,
                     "device_busy_ms": busy, "device_idle_share": idle, "peak_gib": peak,
                     "slot_bytes": slot_bytes, "collectives": cols,
                     "collectives_by_axis": axes_json(by_axis),
                     "collective_bytes": nbytes, "pod_twins": None if not twin else
                     [twins.calls, twins.operands], "worst": max(worst.values()),
                     "seconds": seconds})
    del want_grads, want_new
    torch.cuda.empty_cache()
    return runs, whole_s


def pgrid_serve(arch, g, B, P, max_len, card):
    """``arch`` (bf16 at full width, PGRID_LAYERS or PGRID_MOE_LAYERS
    layers) whole, then placed on PGRID_GRIDS' grid ``g`` and served by
    ``Engine(data_axis=, model_axis=)`` B x P -> PGRID_NEW: launches exact
    by route (``pserve_routes``, or ``cp_routes`` at a batch the batch axes
    do not divide), the collectives of the prefill and of each decode step
    ``serve_collectives``' over the grid's axes alone, on grid (a) the two
    pods' operands equal bit for bit, bytes a slot ``dryrun.slot_bytes``,
    the generate's tokens against the whole model's, the logits
    teacher-forced on its tokens within 4x the yardstick
    (``tp_agreement``), prefill and decode ms and their device busy time.
    Returns (the launches of the partitioned generate, the record)."""
    t_model = time.perf_counter()
    layers = PGRID_MOE_LAYERS if arch == MOE_ARCH else PGRID_LAYERS
    cfg = dataclasses.replace(get_config(arch), num_layers=layers)
    saved_ring = tt_mod.RING_CACHE
    tt_mod.RING_CACHE = False
    try:
        dev = torch.device("cuda")
        sync_cards()
        reset_cards_peak()
        params = init_lm(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
        prompts = np.random.default_rng(26).integers(3, cfg.vocab_size, (B, P))
        ref = whole_reference(cfg, params, prompts, max_len, PGRID_NEW)
        w_pre, w_dec = ref[3:]
        whole_peak = cards_peak_gib()
        mesh, axes, grid = pgrid_grid(g)
        psh = sharding_mod.params_shardings(mesh, params, cfg, **axes)
        placed = device_put(params, psh)
        del params
        sync_cards()
        torch.cuda.empty_cache()
        reset_cards_peak()
        eng = Engine(cfg, placed, max_len=max_len, **axes)
        with torch.inference_mode():
            toks, cache = eng._start(placed, prompts)
        slot_bytes, stored = check_placement(cfg, placed, psh, cache, mesh, max_len, batch=B,
                                             axes=axes)
        del cache
        R, M, n = grid.R, grid.M, mesh.devices.size
        seq = pt_mod.seq_layout(B, P, R)
        pre_c = serve_collectives(cfg, psh, R, M, data_axis=grid.dp, step=seq)
        dec_c = serve_collectives(cfg, psh, R, M, data_axis=grid.dp,
                                  step=None if seq is None else "decode")
        flash_want, rwkv_want = (pserve_routes(cfg, P, PGRID_NEW, n, M) if seq is None
                                 else cp_routes(cfg, PGRID_NEW, n, M))
        twins = pod_twins(mesh) if "pod" in grid.replicated else contextlib.nullcontext()
        reset_launches()
        mesh_mod.reset_collectives()
        with twins:
            res, gen_ms = timed_run(lambda: eng.generate(prompts, max_new_tokens=PGRID_NEW))
        counts = launches()
        got_f = dict(flash_attention.launches_by_route)
        check(got_f == flash_want and counts["rwkv6_scan"] == 0,
              f"{arch} on grid ({g}): launched flash_attention {got_f}, expected {flash_want}")
        cols, by_axis = dict(mesh_mod.collectives), dict(mesh_mod.collectives_by_axis)
        want_cols = {k: pre_c[0].get(k, 0) + (PGRID_NEW - 1) * dec_c[0].get(k, 0)
                     for k in set(pre_c[0]) | set(dec_c[0])}
        want_axes = {k: pre_c[1].get(k, 0) + (PGRID_NEW - 1) * dec_c[1].get(k, 0)
                     for k in set(pre_c[1]) | set(dec_c[1])}
        check(cols == want_cols and by_axis == want_axes,
              f"{arch} on grid ({g}): the generate's collectives {cols} ({by_axis} by axis), "
              f"expected {want_cols} ({want_axes})")
        gen_bytes = dict(mesh_mod.collective_bytes)
        same = int((res.tokens[:, P:] == ref[0]).sum())
        with torch.inference_mode():
            _, cache = eng._start(placed, prompts)
            lg, p_pre = timed_run(lambda: eng._prefill(placed, toks, cache)[0])
            p_dec = (gen_ms - p_pre) / (PGRID_NEW - 1)
            nxt = torch.argmax(lg, -1)[:, None]

            def decode_profiled():
                for t in range(PGRID_DECODE_PROFILED):
                    eng._serve(placed, cache, nxt, P + t)

            split_dec = device_split(decode_profiled)
            _, cache = eng._start(placed, prompts)
            split_pre = device_split(lambda: eng._prefill(placed, toks, cache))
            del cache, lg
        print_split(arch, f"prefill {B} x {P} on grid ({g})", p_pre, split_pre)
        print_split(arch, f"{PGRID_DECODE_PROFILED} decode step(s) on grid ({g})",
                    PGRID_DECODE_PROFILED * p_dec, split_dec)
        peak = cards_peak_gib()
        lp = stepped(cfg, placed, prompts, max_len, ref[0], axes=axes)[1]
        agreement = tp_agreement(f"{arch} {B} x {P} on grid ({g})", lp, ref)
        del lp, placed, eng, ref
        torch.cuda.empty_cache()
        busy = {k: None if v is None else v[0] for k, v in (("prefill", split_pre),
                                                            ("decode", split_dec))}
        idle = {k: None if b is None else max(0.0, 1 - b / w) for (k, b), w in
                zip(busy.items(), (p_pre, PGRID_DECODE_PROFILED * p_dec))}
        twin = (f"; the pods' operands bit-equal over {twins.calls} calls "
                f"({twins.operands} pairs)" if isinstance(twins, pod_twins) else "")
        seconds = time.perf_counter() - t_model
        rec = {"arch": arch, "layers": layers, "grid": g, "mesh": repr(mesh),
               "axes": axes, "batch": B, "prompt": P, "new": PGRID_NEW, "max_len": max_len,
               "layout": seq, "slot_bytes": slot_bytes, "stored_bytes": stored,
               "whole_prefill_ms": w_pre, "whole_decode_ms": w_dec, "whole_peak_gib": whole_peak,
               "prefill_ms": p_pre, "decode_ms": p_dec, "generate_ms": gen_ms,
               "device_busy_ms": busy, "device_idle_share": idle, "peak_gib": peak,
               "launches": counts, "flash_routes": got_f,
               "collectives_prefill": [pre_c[0], axes_json(pre_c[1])],
               "collectives_decode_step": [dec_c[0], axes_json(dec_c[1])],
               "collective_bytes_generate": gen_bytes,
               "generate_tokens_equal": same, "agreement": agreement,
               "pod_twins": None if not twin else [twins.calls, twins.operands],
               "seconds": seconds}
        print(f"[pgrid] {arch} ({layers} layers, bf16) {B} x {P} -> {PGRID_NEW} on grid ({g}) "
              f"{mesh!r}, data_axis={axes['data_axis']!r}, model_axis={axes['model_axis']!r}"
              f"{'' if seq is None else f', the prompt {seq} over the batch axes'}: "
              f"{slot_bytes:,} bytes a slot (= dryrun.slot_bytes); whole prefill {w_pre:.2f} ms, "
              f"decode {w_dec:.2f} ms a step, peak {whole_peak:.2f} GiB; on the grid prefill "
              f"{p_pre:.2f} ms, decode {p_dec:.2f} ms a step, generate {gen_ms:.0f} ms, device "
              f"idle {idle}, peak {peak:.2f} GiB; launches by route {got_f} (exactly as worked "
              f"out); collectives a prefill {pre_c}, a decode step {dec_c} (the formula's){twin}; "
              f"the generate's tokens equal the whole model's at {same}/{res.tokens[:, P:].size}; "
              f"{seconds:.1f} s on {card}")
        return counts, rec
    finally:
        tt_mod.RING_CACHE = saved_ring


def phase_pgrid(card, gen):
    """Phase 26: flash_attention at the B = 1 run's per-slot shapes on grid
    (b) (four blocks, four chunks), then gemma3-1b's train step on
    PGRID_TRAIN's grids and PGRID_SERVE's models served on theirs, each
    against the whole model.  Returns (launches summed over the
    partitioned generates, the phase's record)."""
    t_phase = time.perf_counter()
    err, lines = pgrid_slot_checks(gen, card)
    torch.cuda.empty_cache()
    train, whole_s = pgrid_train(card)
    total = dict.fromkeys(launches(), 0)
    routes = dict.fromkeys(fa_mod.COUNTED, 0)
    served = []
    for arch, g, B, P, max_len in PGRID_SERVE:
        counts, rec = pgrid_serve(arch, g, B, P, max_len, card)
        total = {k: total[k] + counts[k] for k in total}
        routes = {k: routes[k] + rec["flash_routes"][k] for k in routes}
        served.append(rec)
        torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    print(f"[pgrid] phase 26: {seconds:.1f} s on {card} (the whole train step {whole_s:.1f} s); "
          f"launches over the partitioned generates {total}, flash_attention by route {routes}, "
          "none on the train steps")
    return total, {"train": train, "serve": served, "per_slot_max_abs_err": err,
                   "routes": lines, "flash_routes": routes, "seconds": seconds}


# ---------------------------------------------------------------------------
# slice 23: the partitioned dry run, and attention whose query heads the model
# axis does not divide (phase 27)
# ---------------------------------------------------------------------------

# gemma3-1b at full width cut to its first period (6 of 26 layers) on (data 1,
# model 8): its 4 query heads do not split over 8, so every slot runs all of
# them (wq gathered over model); f32 SGD at PDRY_TRAIN, bf16 serving PDRY_SERVE
PDRY_LAYERS = PGRID_LAYERS
PGRID_GRIDS["m8"] = ((1, 8), ("data", "model"), "data", "model")
PDRY_GRID = "m8"
PDRY_TRAIN = (8, 512)
PDRY_SERVE = (4, 512, 528)      # batch, prompt, cache slots; -> PGRID_NEW tokens
# the steps whose meta predicted peak (the placed inputs' stored blocks + the
# peak the step allocates) is held within PEAK_RTOL of the card's
# torch.cuda.max_memory_allocated above what was allocated before; the decode
# step's is printed
PDRY_PEAK_STEPS = ("train", "prefill")


def pdryrun_cfg(dtype):
    return dataclasses.replace(GEMMA, num_layers=PDRY_LAYERS, param_dtype=dtype,
                               compute_dtype=dtype)


def pdryrun_shapes():
    """The three steps phase 27 traces and runs: (kind, dtype, InputShape)."""
    (B, S), (Bs, P, L) = PDRY_TRAIN, PDRY_SERVE
    return (("train", "float32", InputShape("pdry_train", S, B, "train")),
            ("prefill", "bfloat16", InputShape("pdry_prefill", P, Bs, "prefill")),
            ("decode", "bfloat16", InputShape("pdry_decode", L, Bs, "decode")))


def pdryrun_opt():
    return make_optimizer("sgd", constant_lr(PARTITIONED_SGD_LR), momentum=0.9)


def pdryrun_meta(path):
    """Phase 27's meta side, run with no card visible (``dryrun_sweep_start``
    starts it beside the card's phases): each of ``pdryrun_shapes``' steps
    traced by ``launch.dryrun.trace_step`` on a meta (data 1, model 8) grid,
    its FLOPs, kernel calls by route, collectives by axis and predicted
    peak (the placed inputs' stored blocks on one device plus the peak the
    step allocates) written to ``path`` as JSON."""
    mesh = make_mesh(*PGRID_GRIDS[PDRY_GRID][:2], device="meta")
    out = {}
    for kind, dtype, shape in pdryrun_shapes():
        tr = dryrun_mod.trace_step(pdryrun_cfg(dtype), kind, mesh, shape,
                                   opt=pdryrun_opt() if kind == "train" else None)
        axes = {}
        for (axis, _, _, _), (calls, _) in tr.oc.by_axis.items():
            axes[axis] = axes.get(axis, 0) + int(calls)
        out[kind] = {"flops": tr.oc.flops, "hbm_bytes": tr.oc.hbm_bytes,
                     "flash": tr.oc.calls("flash_attention"), "by_axis": axes_json(axes),
                     "collectives": tr.oc.collectives.count_by_kind,
                     "predicted_peak": tr.held_bytes + tr.oc.peak_live_bytes,
                     "held": tr.held_bytes, "peak_live": tr.oc.peak_live_bytes,
                     "trace_s": tr.wall_s}
        print(f"[pdryrun] meta {kind}: {tr.wall_s:.1f} s", flush=True)
    with open(path, "w") as f:
        json.dump(out, f)


def pdryrun_collect(sweep):
    """The meta side's JSON, once its process ends."""
    proc, path = sweep["pdryrun"]
    log = proc.communicate(timeout=600)[0]
    check(proc.returncode == 0, f"phase 27's meta traces exited {proc.returncode}:\n{log[-3000:]}")
    with open(path) as f:
        return json.load(f)


def pdryrun_against_meta(what, kind, meta, oc, by_axis, peak, card):
    """One counted step on the card held against its meta trace: equal
    FLOPs, the same collectives by axis, the predicted peak within
    PEAK_RTOL (``PDRY_PEAK_STEPS``) of ``peak``, the step's inputs on the
    card (their stored blocks) plus ``torch.cuda.max_memory_allocated``
    above what was allocated when the step began.  Returns the record."""
    m = meta[kind]
    axes = axes_json(by_axis)
    ratio = peak / m["predicted_peak"]
    print(f"[pdryrun] {what}: FLOPs meta {m['flops']:,.0f}, card {oc.flops:,.0f} "
          f"({m['flops'] / 8:,.0f} a slot); collectives by axis meta {m['by_axis']}, card "
          f"{axes}; peak on the card {peak / 2**30:.3f} GiB (its inputs + "
          f"torch.cuda.max_memory_allocated above what was allocated before), predicted {m['predicted_peak'] / 2**30:.3f} GiB "
          f"(inputs {m['held'] / 2**30:.3f} + the step's {m['peak_live'] / 2**30:.3f}): "
          f"{ratio - 1:+.2%} (tolerance {PEAK_RTOL:.0%}"
          f"{'' if kind in PDRY_PEAK_STEPS else ', printed only'}); traced on the meta grid in "
          f"{m['trace_s']:.1f} s on the host; on {card}")
    check(oc.flops == m["flops"], f"{what}: FLOPs card {oc.flops} != meta {m['flops']}")
    check(axes == m["by_axis"], f"{what}: collectives by axis card {axes} != meta {m['by_axis']}")
    if kind in PDRY_PEAK_STEPS:
        check(abs(ratio - 1) <= PEAK_RTOL, f"{what}: peak {peak} vs predicted "
              f"{m['predicted_peak']} beyond {PEAK_RTOL:.0%}")
    return {"flops": oc.flops, "flops_per_slot": oc.flops / 8, "by_axis": axes,
            "peak_bytes": peak, "predicted_peak_bytes": m["predicted_peak"],
            "peak_ratio": ratio, "meta_trace_s": m["trace_s"]}


def pdryrun_train(card, meta):
    """gemma3-1b (PDRY_LAYERS layers, f32, SGD momentum 0.9) one step at
    PDRY_TRAIN whole, every gradient kept, then placed on (data 1, model 8)
    and the same step partitioned: every gradient and updated param within
    PARTITIONED_RTOL of the leaf's largest value of the whole step's, the
    collectives ``partitioned_collectives(grid=)``', no launch; then a
    second step counted by an ``OpCounter`` against the meta trace
    (``pdryrun_against_meta``).  Returns the record."""
    t0 = time.perf_counter()
    B, S = PDRY_TRAIN
    cfg, opt = pdryrun_cfg("float32"), pdryrun_opt()
    batch = {"tokens": torch.as_tensor(np.random.default_rng(27).integers(
        3, cfg.vocab_size, (B, S)), device="cuda")}
    kept = {}

    def keep(grads):
        kept.update(tree_leaves_with_path(grads))
        return grads

    def fresh():
        gen = torch.Generator(device="cuda").manual_seed(0)
        return make_train_state(init_lm(cfg, gen, device="cuda"), opt)

    state = fresh()
    new, wm = make_train_step(cfg, opt, grad_sync=keep)(state, batch)
    del state
    want = {k: wm[k].float().item() for k in ("loss", "grad_norm")}
    want_grads, want_new = dict(kept), dict(tree_leaves_with_path(new["params"]))
    kept.clear()
    del new, wm
    mesh, axes, grid = pgrid_grid(PDRY_GRID)
    state = fresh()
    psh = sharding_mod.params_shardings(mesh, state["params"], cfg, **axes)
    placed = device_put(state, {"params": psh, "opt": sharding_mod.opt_state_shardings(
        mesh, state["opt"], psh)})
    del state
    step = make_train_step(cfg, opt, grad_sync=keep, grad_shardings=psh, **axes)
    cols_want = partitioned_collectives(cfg, psh, grid.R, grid.M, grid=grid)
    reset_launches()
    mesh_mod.reset_collectives()
    (placed, pm), first_ms = timed_run(lambda: step(placed, batch))
    cols = dict(mesh_mod.collectives)
    counts = launches()
    worst = {k: abs(pm[k].float().item() - want[k]) / abs(want[k]) for k in want}
    new_leaves = dict(tree_leaves_with_path(placed["params"]))
    for part, got_tree, want_tree in (("grads", kept, want_grads),
                                      ("params", new_leaves, want_new)):
        for k, w in want_tree.items():
            d = (sharding_mod.gather(got_tree[k]).float() - w.float()).abs().max()
            worst[f"{part}/{k}"] = (d / w.float().abs().max().clamp(min=1e-30)).item()
    kept.clear()
    del new_leaves, pm, want_grads, want_new
    over = {k: v for k, v in worst.items() if v > PARTITIONED_RTOL}
    top = sorted(worst.items(), key=lambda kv: -kv[1])[:3]
    check(cols == cols_want, f"pdryrun train: collectives {cols}, expected {cols_want}")
    check(not over, f"pdryrun train: against the whole step beyond {PARTITIONED_RTOL:g}: {over}")
    check(all(n == 0 for n in counts.values()), f"pdryrun train: the step launched {counts}")
    counted = make_train_step(cfg, opt, grad_shardings=psh, **axes)
    sync_cards()
    torch.cuda.empty_cache()
    held = dryrun_mod.stored_bytes(placed) + dryrun_mod.stored_bytes(batch)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    mesh_mod.reset_collectives()
    t1 = time.perf_counter()
    with OpCounter() as oc:
        placed, _ = counted(placed, batch)
    sync_cards()
    counted_ms = (time.perf_counter() - t1) * 1e3
    peak = held + torch.cuda.max_memory_allocated() - base
    rec = pdryrun_against_meta(f"gemma3-1b ({PDRY_LAYERS} layers, f32, SGD) train step {B} x {S} "
                               f"on (data 1, model 8)", "train", meta, oc,
                               dict(mesh_mod.collectives_by_axis), peak, card)
    del placed, _
    sync_cards()
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t0
    print(f"[pdryrun] gemma3-1b ({PDRY_LAYERS} layers, f32, SGD) {B} x {S} on (data 1, model 8), "
          f"4 query heads on every model slot (wq gathered over model): partitioned step "
          f"{first_ms:.1f} ms (the first), counted {counted_ms:.1f} ms; collectives {cols} (the "
          f"formula's); largest difference over the leaf's largest value, worst three "
          f"{[(k, float(f'{v:.3g}')) for k, v in top]} (bound {PARTITIONED_RTOL:g}); "
          f"{seconds:.1f} s on {card}")
    return dict(rec, collectives=cols, first_ms=first_ms, counted_ms=counted_ms,
                worst=max(worst.values()), seconds=seconds)


def pdryrun_serve_counted(card, meta):
    """gemma3-1b bf16 (PDRY_LAYERS layers) placed on (data 1, model 8): its
    prefill step (``make_prefill_step``, PDRY_SERVE's prompt) and one decode
    step at the last slot of a PDRY_SERVE cache, each counted by an
    ``OpCounter`` on the card against its meta trace, the kernels' calls
    by route equal to the meta trace's and to the card's launches (one
    call a layer and slot).  Returns the record."""
    B, P, L = PDRY_SERVE
    cfg = pdryrun_cfg("bfloat16")
    mesh, axes, grid = pgrid_grid(PDRY_GRID)
    n = mesh.devices.size
    params = init_lm(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    placed = device_put(params, sharding_mod.params_shardings(mesh, params, cfg, **axes))
    del params
    tokens = torch.as_tensor(np.random.default_rng(27).integers(3, cfg.vocab_size, (B, P)),
                             device="cuda")
    out = {}
    with torch.no_grad():
        for kind, want in (("prefill", {"prefill_tc": n * PDRY_LAYERS}),
                           ("decode", {"decode": n * PDRY_LAYERS,
                                       "decode_combine": n * PDRY_LAYERS})):
            if kind == "prefill":
                def run():
                    return make_prefill_step(cfg, **axes)(placed, {"tokens": tokens})
            else:
                cache = init_cache(cfg, B, L, device="cuda")
                cache = device_put(cache, sharding_mod.cache_shardings(mesh, cache, cfg, **axes))

                def run():
                    return make_serve_step(cfg, **axes)(placed, cache, tokens[:, -1:], L - 1)
            held = (dryrun_mod.stored_bytes(placed) + tokens[:, :1 if kind == "decode" else P]
                    .numel() * tokens.element_size()
                    + (dryrun_mod.stored_bytes(cache) if kind == "decode" else 0))
            sync_cards()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            mesh_mod.reset_collectives()
            with OpCounter() as oc:
                run()
            sync_cards()
            peak = held + torch.cuda.max_memory_allocated() - base
            launched = {r: c for r, c in flash_attention.launches_by_route.items() if c}
            calls = oc.calls("flash_attention")
            check(calls == meta[kind]["flash"] == launched == want,
                  f"pdryrun {kind}: flash_attention calls by route card {calls}, meta "
                  f"{meta[kind]['flash']}, launched {launched}, expected {want}")
            out[kind] = pdryrun_against_meta(
                f"gemma3-1b ({PDRY_LAYERS} layers, bf16) {kind} {B} x "
                f"{P if kind == 'prefill' else 1} (cache {L}) on (data 1, model 8)", kind, meta,
                oc, dict(mesh_mod.collectives_by_axis), peak, card)
            out[kind]["flash_routes"] = launched
    del placed
    sync_cards()
    torch.cuda.empty_cache()
    return out


def pdryrun_slot_checks(gen):
    """flash_attention at phase 27's per-slot shapes, every slot all 4
    query heads on the one kv head: the prefill q [4, 512, 4, 256] over
    its 512 keys on ``prefill_tc`` (window 512 and none) and the decode
    step's q [4, 1, 4, 256] at q_offset 527 over the 528-slot cache on
    ``decode``, bf16, against flash_attention_plain.  Returns the largest
    error."""
    B, P, L = PDRY_SERVE
    hd = GEMMA.head_dim
    worst = 0.0
    q, k, v = qkv_on_card(B, P, P, GEMMA.num_heads, GEMMA.num_kv_heads, hd, torch.bfloat16, gen)
    for window in (None, GEMMA_WINDOW):
        kw = dict(causal=True, window=window)
        worst = max(worst, bf16_close(flash_routed("prefill_tc", q, k, v, **kw),
                                      flash_attention_plain(q, k, v, **kw),
                                      f"flash per slot gemma3-1b on model 8, window {window}"))
    q, k, v = qkv_on_card(B, 1, L, GEMMA.num_heads, GEMMA.num_kv_heads, hd, torch.bfloat16, gen)
    for window in (None, GEMMA_WINDOW):
        kw = dict(causal=True, window=window, q_offset=L - 1)
        worst = max(worst, bf16_close(flash_routed("decode", q, k, v, **kw),
                                      flash_attention_plain(q, k, v, **kw),
                                      f"flash per slot gemma3-1b decode on model 8, window "
                                      f"{window}"))
    del q, k, v
    print(f"[check] flash_attention per slot, gemma3-1b on (data 1, model 8) (all 4 query heads "
          f"on 1 kv head, bf16): prefill q [{B}, {P}, 4, {hd}] on prefill_tc and decode q "
          f"[{B}, 1, 4, {hd}] at q_offset {L - 1} on decode, window 512 and none: max|d| "
          f"{worst:.3g} (bound 1 bf16 ulp + 2e-5 x max(1, max|plain|))")
    return worst


def phase_pdryrun(card, sweep=None):
    """Phase 27: gemma3-1b's partitioned train step and serving on (data 1,
    model 8), whose 4 query heads the model axis does not divide, against
    the whole model (``pdryrun_train``; ``pgrid_serve`` on grid "m8"), then
    each step counted on the card against ``launch.dryrun.trace_step``'s
    meta trace (``pdryrun_meta``, started by ``dryrun_sweep_start``, here
    unless ``sweep`` was).  Returns (the launches of the partitioned
    generate, the phase's record)."""
    t0 = time.perf_counter()
    own = sweep is None
    sweep = sweep or dryrun_sweep_start()
    try:
        meta = pdryrun_collect(sweep)
    finally:
        if own:
            stop_sweep(sweep)
    err = pdryrun_slot_checks(torch.Generator(device="cuda").manual_seed(27))
    torch.cuda.empty_cache()
    train = pdryrun_train(card, meta)
    B, P, L = PDRY_SERVE
    counts, served = pgrid_serve("gemma3-1b", PDRY_GRID, B, P, L, card)
    counted = pdryrun_serve_counted(card, meta)
    seconds = time.perf_counter() - t0
    print(f"[pdryrun] phase 27: {seconds:.1f} s on {card}; launches over the partitioned "
          f"generate {counts}, flash_attention by route {served['flash_routes']}")
    return counts, {"train": train, "serve": served, "counted": counted, "meta": meta,
                    "per_slot_max_abs_err": err, "seconds": seconds}


class phase_clock:
    """Prints ``[phase] <n> <name> <seconds> s`` for each phase of the
    script, its wall seconds from start to end.  ``with clock(n, name):``
    times one phase; ``clock.add(n, name, fn, *args)`` adds one call's
    seconds to a phase run in several pieces (phases 3 and 4 alternate,
    one kernel at a time), which ``clock.flush(n)`` prints."""

    def __init__(self):
        self.pending = {}

    @contextlib.contextmanager
    def __call__(self, n: int, name: str):
        t0 = time.perf_counter()
        yield
        print(f"[phase] {n} {name} {time.perf_counter() - t0:.1f} s", flush=True)

    def add(self, n: int, name: str, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        total = self.pending.get(n, (name, 0.0))[1]
        self.pending[n] = (name, total + time.perf_counter() - t0)
        return out

    def flush(self, n: int):
        name, seconds = self.pending.pop(n)
        print(f"[phase] {n} {name} {seconds:.1f} s", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card", file=sys.stderr)
        return 1
    clock = phase_clock()
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with clock(1, "card"):
        name, count, smi = torch.cuda.get_device_name(0), torch.cuda.device_count(), nvidia_smi()
        print(f"[card] {name}, {count} device(s); nvidia-smi: {smi}")
        print(f"[card] torch {torch.__version__}, CUDA {torch.version.cuda}, "
              f"python {sys.version.split()[0]}")

    with clock(2, "build"):
        t_build = time.perf_counter()
        built = _build.build_all(SOURCES)
        print(f"[build] {len(SOURCES)} sources, one nvcc each, started together: "
              f"{time.perf_counter() - t_build:.1f} s")
        for source in SOURCES:
            b = built[source]
            took = f"nvcc {b.seconds:.1f} s" if b.seconds else "built earlier in this checkout"
            print(f"[build] {source}.cu -> {b.path.name}: {took}")
            for line in ptxas_summary(b.log):
                print(f"  ptxas {line}")

    # phases 3 and 4 alternate, one kernel at a time (its inputs freed before the next)
    gen = torch.Generator(device="cuda").manual_seed(0)
    checks, timing = (3, "kernel-checks"), (4, "kernel-timing")
    inputs, max_err = clock.add(*checks, phase_kernel_checks, gen)
    ms, plain_ms, bound_ms, bound_by = clock.add(*timing, phase_timing, inputs, smi)
    del inputs
    torch.cuda.empty_cache()
    dec_inputs, dec_err = clock.add(*checks, phase_decode_checks, gen)
    dec, dec_extra = clock.add(*timing, phase_decode_timing, dec_inputs, smi)
    del dec_inputs
    torch.cuda.empty_cache()
    sk_row, sk_err = clock.add(*checks, phase_sketch_checks, gen)
    sk = clock.add(*timing, phase_sketch_timing, sk_row, smi)
    del sk_row
    torch.cuda.empty_cache()
    fl_inputs, fl_hd160, fl_archs2, fl_err = clock.add(*checks, phase_flash_checks, gen)
    fl, fl_lines = clock.add(*timing, phase_flash_timing, fl_inputs, fl_hd160, fl_archs2, smi)
    del fl_inputs, fl_hd160, fl_archs2
    rw_inputs, rw_err = clock.add(*checks, phase_rwkv_checks, gen)
    rw, rw_lines = clock.add(*timing, phase_rwkv_timing, rw_inputs, smi)
    del rw_inputs
    torch.cuda.empty_cache()
    clock.flush(3)
    clock.flush(4)

    sweep = dryrun_sweep_start()
    atexit.register(stop_sweep, sweep)   # ended whatever phase fails
    with tempfile.TemporaryDirectory(prefix="chip_smoke-") as workdir:
        with clock(5, "small-checks"):
            phase_small_agreement()
            phase_small_per_leaf()
            phase_small_service(workdir)
            phase_small_lifecycle(workdir)
            phase_small_lm()

        with clock(6, "training-path"):
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

        with clock(7, "service-path"):
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

        with clock(8, "lifecycle"):
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
    with clock(9, "serving"):
        counts["flash_attention"], fl_routes, _ = phase_serve(
            "gemma3-1b", GEMMA, GEMMA_PROMPT, SERVE_NEW, GEMMA_MAX_LEN, "flash_attention", smi,
            serve_routes(GEMMA, GEMMA_PROMPT, SERVE_NEW))
        # two generates: a scan launch per layer each, a step launch per layer and token after
        counts["rwkv6_scan"], rw_routes, _ = phase_serve(
            "rwkv6-7b", RWKV, RWKV_PROMPT, SERVE_NEW, RWKV_MAX_LEN, "rwkv6_scan", smi,
            {"scan": 2 * RWKV.num_layers, "step": 2 * RWKV.num_layers * (SERVE_NEW - 1)})

    # the routed service (slice 6), counts reset just before it
    with clock(10, "routing"), tempfile.TemporaryDirectory(prefix="chip_smoke-") as workdir:
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
        # round-0 dense cohort and each member's cross-fuse; decode_accum for
        # each member's mixed round-1 cohort; row_sketch for main's first base
        # sketch, the spawned member's, and each of the 6 publishes (2 per
        # round, 2 of the cross-fuse)
        for kernel, want in (("cold_fuse", 4), ("decode_accum", 2), ("row_sketch", 8)):
            check(routed[kernel] == want, f"{kernel} launched {routed[kernel]} times on the "
                  f"routed path, expected {want}")
        real_finetune_scores(b0, spec, smi)
        del b0
        torch.cuda.empty_cache()

    # the fuse-to-serve stack (slice 7), counts reset just before it
    with clock(11, "serve-stack"):
        with tempfile.TemporaryDirectory(prefix="chip_smoke-") as workdir:
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            stack = phase_serve_stack(workdir)
            served = launches()
            stack_routes = dict(flash_attention.launches_by_route)
            print(f"[serve-stack] launches on the serve-stack path: {served}; flash_attention by "
                  f"route {stack_routes}; {stack['seconds']:.1f} s on {smi}")
            print(f"[serve-stack] torch.cuda.max_memory_allocated: "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (the worker's Engine "
                  "keeps iteration 0's 2.00 GB row for its life, as the reference's does)")
        fuse_at_gemma = time_cohort_fuse(*stack.pop("fuse_inputs"), smi)
        for kernel, want in SERVE_STACK_LAUNCHES.items():
            check(served[kernel] == want, f"{kernel} launched {served[kernel]} times on the "
                  f"serve-stack path, expected {want}")
        torch.cuda.empty_cache()

    # LM training and serving what it trained (slice 8), counts reset around
    # the eval steps and generates inside
    with clock(12, "lm-training"), tempfile.TemporaryDirectory(prefix="chip_smoke-") as workdir:
        lm_train = phase_lm_train(workdir, smi)
    torch.cuda.empty_cache()

    # the MoE family and the dense archs (slice 9), counts reset around each run
    with clock(13, "archs"), tempfile.TemporaryDirectory(prefix="chip_smoke-") as workdir:
        archs, arch_table = phase_archs(workdir, smi)
    torch.cuda.empty_cache()

    # the last three archs and the ring cache (slice 10), counts reset around each run
    with clock(14, "archs2"), tempfile.TemporaryDirectory(prefix="chip_smoke-") as workdir:
        archs2, arch2_table = phase_archs2(workdir, smi)
    torch.cuda.empty_cache()

    # the mesh-sharded Repository engine (slice 11), counts reset just
    # before its full-width service loop
    with clock(15, "mesh"), tempfile.TemporaryDirectory(prefix="chip_smoke-") as workdir:
        mesh_counts, mesh_rec = phase_mesh(workdir, smi)
    torch.cuda.empty_cache()

    # the model-side ColD mesh (slice 12), counts reset at its start (the
    # steps and fuses launch no kernel) and again just before its serve
    with clock(16, "cold-mesh"):
        cold_counts, cold_part_counts, cold_rec = phase_cold_mesh(smi)
    torch.cuda.empty_cache()

    # the dry-run tooling (slice 13): the sweep on the host, then the serving
    # and training steps counted on the meta device and on the card, counts
    # reset around the serving step's prefill and decode
    with clock(17, "dryrun"):
        dry_counts, dry_rec = phase_dryrun(smi, sweep)
    torch.cuda.empty_cache()

    # the partitioned train step with FSDP (slice 14); its steps launch no kernel
    with clock(18, "partitioned-train"):
        part_rec = phase_partitioned(smi)
    torch.cuda.empty_cache()

    # partitioned serving (slice 15), counts reset just before each
    # partitioned generate and summed
    with clock(19, "partitioned-serve"):
        pserve_counts, pserve_rec = phase_partitioned_serve(smi, gen)
    torch.cuda.empty_cache()

    # the partitioned MoE FFN and M-RoPE (slice 16), counts reset just before
    # each partitioned generate and summed; its train steps launch no kernel
    with clock(20, "partitioned-moe"):
        pmoe_counts, pmoe_rec = phase_partitioned_moe(smi, gen)
    torch.cuda.empty_cache()

    # the partitioned Mamba mixer, the RWKV train step and adafactor over
    # blocks (slice 17), counts reset just before the partitioned generate;
    # its train steps launch no kernel
    with clock(21, "partitioned-ssm"):
        pssm_counts, pssm_rec = phase_partitioned_ssm(smi, gen)
    torch.cuda.empty_cache()

    # context-parallel serving at B = 1 (slice 18), counts reset just before
    # each context-parallel generate and summed
    with clock(22, "context-parallel-serve"):
        cp_counts, cp_rec = phase_context_parallel(smi, gen)
    torch.cuda.empty_cache()

    # the partitioned train step at B = 1 and a vision prompt served at B = 1
    # (slice 19): its train steps launch no kernel; counts reset just before
    # the context-parallel vision generate
    with clock(23, "context-parallel-train"):
        cpt_counts, cpt_rec = phase_context_parallel_train(smi, gen)
    torch.cuda.empty_cache()

    # the encoder-decoder partitioned (slice 20): its train steps launch no
    # kernel; counts reset just before the partitioned greedy run
    with clock(24, "partitioned-whisper"):
        pw_counts, pw_rec = phase_partitioned_whisper(smi, gen)
    torch.cuda.empty_cache()

    # whisper at a batch the batch axis does not divide (slice 21): its train
    # steps launch no kernel; counts reset just before the partitioned greedy run
    with clock(25, "context-parallel-whisper"):
        cpw_counts, cpw_rec = phase_context_parallel_whisper(smi, gen)
    torch.cuda.empty_cache()

    # the partitioned steps on the reference's production grids (slice 22):
    # its train steps launch no kernel; counts reset just before each
    # partitioned generate and summed
    with clock(26, "pgrid"):
        pgrid_counts, pgrid_rec = phase_pgrid(smi, gen)
    torch.cuda.empty_cache()

    # the partitioned dry run held against the card, and attention whose query
    # heads model does not divide (slice 23): counts reset just before the
    # partitioned generate
    with clock(27, "pdryrun"):
        pdry_counts, pdry_rec = phase_pdryrun(smi, sweep)
    torch.cuda.empty_cache()
    print(f"[done] {time.perf_counter() - t0:.1f} s after the card check")

    cost_of = {"cold_fuse": cf_mod.cost, "decode_accum": da_mod.cost, "row_sketch": sk_mod.cost,
               "flash_attention": fa_mod.cost, "rwkv6_scan": rs_mod.cost}

    def record(name, replaces, err, timing, source=None):
        k_ms, k_plain, k_bound, k_by = timing[:4]
        cost = cost_of[name]
        return {"name": name, "route": "cuda",
                "source": f"src/repro_torch/kernels/csrc/{source or name}.cu",
                "replaces": replaces, "launches": counts[name], "max_abs_err": err,
                "ms": k_ms, "plain_ms": k_plain, "bound_ms": k_bound, "bound_by": k_by,
                "library_ms": timing[4] if len(timing) > 4 else None,
                "cost_formula": f"{cost.__module__}.cost: " + " ".join(cost.__doc__.split())}

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
    for rec in fuse_kernels + [flash, rwkv]:  # and phase 11's to 17's
        rec["launches_dryrun"] = dry_counts[rec["name"]]
        rec["launches_serve_stack"] = served[rec["name"]]
        rec["launches_lm_train"] = lm_train[rec["name"]]
        rec["launches_archs"] = archs[rec["name"]]
        rec["launches_archs2"] = archs2[rec["name"]]
        rec["launches_mesh"] = mesh_counts[rec["name"]]
        rec["launches_cold_mesh"] = cold_counts[rec["name"]]
        rec["launches_cold_mesh_partitioned"] = cold_part_counts[rec["name"]]
        rec["launches_partitioned_serve"] = pserve_counts[rec["name"]]
        rec["launches_partitioned_moe"] = pmoe_counts[rec["name"]]
        rec["launches_partitioned_ssm"] = pssm_counts[rec["name"]]
        rec["launches_context_parallel"] = cp_counts[rec["name"]]
        rec["launches_partitioned_whisper"] = pw_counts[rec["name"]]
        rec["launches_context_parallel_whisper"] = cpw_counts[rec["name"]]
        rec["launches_pgrid"] = pgrid_counts[rec["name"]]
        rec["launches_pdryrun"] = pdry_counts[rec["name"]]
    for rec in (flash, rwkv):
        rec["per_slot_max_abs_err"] = pserve_rec["per_slot_max_abs_err"][rec["name"]]
    flash["per_slot_max_abs_err"] = max(flash["per_slot_max_abs_err"],
                                        pmoe_rec["per_slot_max_abs_err"],
                                        pssm_rec["per_slot_max_abs_err"],
                                        cp_rec["per_slot_max_abs_err"],
                                        cpt_rec["per_slot_max_abs_err"],
                                        pw_rec["per_slot_max_abs_err"],
                                        cpw_rec["per_slot_max_abs_err"],
                                        pgrid_rec["per_slot_max_abs_err"],
                                        pdry_rec["per_slot_max_abs_err"])
    # the context-parallel decode's two entries of flash_decode.cu: their
    # [time] lines, and their launches on phase 22's generates
    flash["routes"] += (cp_rec["routes"] + pw_rec["routes"] + cpw_rec["routes"]
                        + pgrid_rec["routes"])
    flash["launches_by_route_context_parallel"] = cp_rec["flash_routes"]
    flash["launches_by_route_partitioned_whisper"] = pw_rec["serve"]["flash_routes"]
    flash["launches_by_route_context_parallel_whisper"] = cpw_rec["serve"]["flash_routes"]
    flash["launches_by_route_pgrid"] = pgrid_rec["flash_routes"]
    flash["launches_by_route_pdryrun"] = pdry_rec["serve"]["flash_routes"]
    cp_entries = []
    for line in cp_rec["routes"][:2]:
        cp_entries.append({
            "name": f"flash_attention.{line['route']}", "route": "cuda", "source": line["source"],
            "replaces": "src/repro/kernels/flash_attention.py:28",
            "launches": cp_rec["flash_routes"][line["route"]],
            "launches_context_parallel_whisper": cpw_rec["serve"]["flash_routes"][line["route"]],
            "launches_pgrid": pgrid_rec["flash_routes"][line["route"]],
            "max_abs_err": cp_rec["per_slot_max_abs_err"], "ms": line["ms"],
            "plain_ms": line["plain_ms"], "bound_ms": line["bound_ms"],
            "bound_by": line["bound_by"], "library_ms": line["library_ms"],
            "cost_formula": {"decode_partial": "repro_torch.kernels.flash_attention."
                             "partials_cost", "decode_merge": "repro_torch.kernels."
                             "flash_attention.merge_cost"}[line["route"]]})
    # phase 15's times beside the unsharded kernels'; row_sketch_shard is an
    # entry of row_sketch.cu, held at a clamped layout
    fuse_kernels[0]["mesh"] = {"roberta": mesh_rec["cold_fuse"],
                               "gemma3_1b": mesh_rec["cold_fuse_gemma3_1b"]}
    fuse_kernels[1]["mesh"] = mesh_rec["decode_accum"]
    fuse_kernels[2]["mesh"] = dict(mesh_rec["row_sketch"],
                                   row_sketch_shard=mesh_rec["row_sketch_shard"])
    print(json.dumps({"mesh_service": mesh_rec["service"]}))
    print(json.dumps({"cold_mesh": cold_rec}))
    print(json.dumps({"dryrun": dry_rec}))
    print(json.dumps({"partitioned": part_rec}))
    print(json.dumps({"partitioned_serve": pserve_rec}))
    print(json.dumps({"partitioned_moe": pmoe_rec}))
    print(json.dumps({"partitioned_ssm": pssm_rec}))
    print(json.dumps({"context_parallel": cp_rec}))
    print(json.dumps({"context_parallel_train": dict(cpt_rec, launches=cpt_counts)}))
    print(json.dumps({"partitioned_whisper": dict(pw_rec, launches=pw_counts)}))
    print(json.dumps({"context_parallel_whisper": dict(cpw_rec, launches=cpw_counts)}))
    print(json.dumps({"pgrid": dict(pgrid_rec, launches=pgrid_counts)}))
    print(json.dumps({"pdryrun": dict(pdry_rec, launches=pdry_counts)}))
    print(json.dumps({"archs": arch_table}))
    print(json.dumps({"archs2": arch2_table}))
    fuse_kernels[0]["at_gemma3_1b"] = fuse_at_gemma
    print(json.dumps({"kernels": fuse_kernels + [flash, rwkv] + cp_entries}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
