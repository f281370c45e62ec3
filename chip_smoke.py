#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``magiattention_tpu_torch``) on one
NVIDIA card.

    python3 chip_smoke.py [--seed N]

Phases, each printing one JSON line:

1. build — compile the nine Hopper kernels (the row-major ``flex_fwd``,
   ``flex_fwd_hb``, ``flex_dq``, ``flex_dkv``, the sparse-grid
   ``flex_fwd_sparse``, ``flex_fwd_sparse_hb``, ``flex_dq_sparse``,
   ``flex_dkv_sparse``, and ``paged_decode``) from the sources in
   ``magiattention_tpu_torch/csrc/`` with nvcc for sm_90a, all at once
   (with mutated copies for the planted faults and the sparse forwards'
   every-rise AMLA variant, and the previous, pre-TMA row-major forward and
   backward walks, the previous sparse-grid forward and backward walks and
   the previous CUDA-core decode walk as yardstick libraries), print
   ptxas's registers and spills and, for the eight flex kernels, the count
   of ``HGMMA`` (wgmma)
   and ``UTMALDG`` (TMA load) instructions in ``cuobjdump -sass``, for
   ``paged_decode`` its ``HMMA`` (mma.sync), ``LDGSTS`` (cp.async) and
   ``LDSM`` (ldmatrix), and print the card's name and power limit as
   nvidia-smi reports them (the builds recorded by the compile tracker
   with telemetry on, for the telemetry phase);
2. kernels — each kernel against its plain PyTorch version on the card, in
   bf16 at head_dim 128 (and 64 for the head-batched and sparse-grid
   forwards), on the mask families and ragged lengths below (``flex_fwd``
   and the backward at head_dim 128 and 64 with 4, 2 and 1 q heads per kv
   head, the backward with a random lse cotangent; the
   head-batched row-major forward at 1, 2 and 4 q heads per kv head and G
   and 2G heads per block, and whether it equals ``flex_fwd`` bit for bit;
   the sparse grid at 1, 2 and 4 q heads per kv head and one, G and 2G
   heads per work item; softcap and sink on one case each; the sparse-grid
   backward again at d 128 and 64 and 1, 2, 3, 4 and 8 q heads per kv head
   on the heterogeneous masks and one of short walks, with softcap on one
   case and uncovered rows on another, bit for bit equal to ``flex_dq`` /
   ``flex_dkv`` on the same tables; the sparse-grid forwards at the same
   widths on the same masks and one whose keys grow along the sequence, so
   that AMLA's reference moves, at head_block 1 and G), each kernel run
   twice for the same bits, each with its stated tolerance; faults
   planted in the kernels (the backward walks cut short, the AMLA rescale
   of O skipped once per row in mutated copies of both sparse forwards, on
   rising logits, every head
   of a head-batched item reading the first head's kv head in a mutated
   copy of ``flex_fwd_hb``, the second consumer warpgroup's partial dropped
   from the odd-G merge in a mutated copy of ``flex_fwd``, the second
   consumer warpgroup's dK partial dropped before the final sum in a
   mutated copy of ``flex_dkv``, and in mutated copies of the persistent
   sparse backward each dq item after a block's first reusing the previous
   item's resident Q and dO, and the dK/dV partials not zeroed between a
   block's items), which the checks must catch; all eight flex kernels at
   head_dim 32 in bf16 (the 64-byte-swizzle tiles) under the same bounds,
   and the four row-major kernels on float32 q/k/v (the CUDA-core walks)
   at d 32, 64 and 128 within the float32 row of
   ``telemetry.numerics.DEFAULT_BUDGETS``, with two more planted faults
   (the d-32 tile's k-slice offset dropped in ``flex_fwd_hb``; the float32
   forward's rescale of O skipped); then the
   row-major kernels' times at their main path's shapes, each in turns with
   the previous walk (``flex_fwd`` and ``flex_fwd_hb`` at head_block G and
   2G on the serving prefill and on causal 8192 at the training widths;
   ``flex_dq`` and ``flex_dkv`` on the latter) beside the plain version's,
   a PyTorch ``scaled_dot_product_attention`` yardstick and the card's
   bound; the same at the new widths (``narrow_timing``): the row-major
   four on the dit problem (8 q / 4 kv heads of d 32 on the 32,768-token
   chunk-causal mask) in bf16 and float32 and the sparse four at d 32 on
   the 16k hetero mask in bf16 and float32, each first checked there
   against its plain version run head by head; the sparse four in float32
   (the CUDA-core walks) at d 32, 64 and 128 and 1, 2, 3, 4 and 8 q heads
   per kv head on the hetero and rising-logits masks, the backward bit for
   bit the row-major float32 pair, with three plants (the AMLA rescale of O
   skipped once, a dq item's second head computed as its first, the dk/dv
   work list's odd claims redoing the item before); ``paged_decode`` at d
   128 / 64, bf16 / f32, 1-16 q heads per kv
   head, pages of 16, 64 and 128 tokens and 1, 3, 4 and 16 splits, each
   launch twice for the same bits, NaN past the lengths changing no bit,
   and its shared mode (the cascade's level 1) at 1, 3 and 8 members, with
   two planted faults (each split's last chunk dropped; every member on
   member 0's q); and at d 32 and 24 and 48 q heads per kv head (the wide
   walks) in the flat, shared, tick and TP-slice modes; the bf16 wide walk
   (``decode_wide_sm90.cuh``) at 33, 48, 64, 71, 128 and 200 q heads a kv
   head (and 48 x 2) x d 32 / 64 / 128 x pages of 16 / 64 / 128, NaN past
   every length, 1 / 2 / 4 splits, softcap, two runs bit for bit, TP slices
   bit for bit the one launch and a batch past one launch's walks in row
   blocks (``wide_walk_cases``), with three plants (the bf16 walk keeping
   V's rows past the live tokens, its merge nodes taking their first child
   alone; the float32 WIDE mode's tiles reading the first tile's q), timed
   at DiTConfig's, StarCoder-15B's (d 128 and 32) and Falcon-7B's attention
   on the serving prompts' 8 lengths and on 32 sequences, the wide rows in
   turns with the previous wide walk (``wide_decode_timing``); then the
   ``wide_serving`` path: an engine at StarCoder-15B's (48 / 1, d 128) and
   at Falcon-7B's (71 / 1, d 64) attention prefilling the 8 serving prompts
   and decoding 64 greedy steps through ``paged_decode`` (one launch a
   step), each step held against the plain decode within the kernel bounds
   and its tokens equal to the plain decode's but at counted near ties,
   device and host ms a step;
3. serving — the port's serving path at Llama-3.1-8B attention widths
   (32 q heads, 8 kv heads, head_dim 128, bf16, page size 128): admit 8
   requests, prefill them (one chunked, so the continuation path runs) with
   the automatic kernel choice (row-major, head_block 4: ``flex_fwd_hb``),
   run 64 decode steps over the batch, and hold prefill outputs (prompts up
   to 4096 tokens) and every 8th decode step against the plain versions;
   each prefill's host ms split into the plan build, the tables' upload
   and the rest;
   on the final batch ``paged_decode``'s time in turns with the previous
   walk, the split sweep (kernel alone, and with the merge in device time)
   there and on one 32K-token sequence, the plain version, SDPA and the
   bound (``decode_timing``);
   then the same at multi-head widths (32 q / 32 kv heads), where the
   choice is head_block 1 and the prefill runs ``flex_fwd``;
4. prefix — shared-prefix serving at the same widths: a 4000-token prompt
   (31 full pages and a 32-token tail), then 7 requests that begin with it
   (``admit(tokens=)`` forks onto its pages; the first write of each splits
   the shared tail page) and add 300-2000 tokens each, one prefilled in
   512-token chunks; each suffix's rows held against the plain causal
   attention over its whole prompt; 32 decode steps of the 8 with cascade
   decode (one group on the 31 shared pages, its level 1 in the kernel's
   shared mode, counted), the first step's cascade ``auto`` and ``on`` held
   against the flat path and the plain decode; the pages in use against a
   flat engine's; cascade against flat decode attention on the final state,
   on the host clock and in device time;
5. training — the port's Llama trainer at the widths of the repo's
   ``LlamaConfig`` (vocab 32000, dim 2048, 16 q / 8 kv heads, head_dim 128,
   ffn 5632, bf16 compute, fp32 masters), cut from 16 to 4 layers, on one
   8192-token stream packed as documents [4096, 2048, 2048]: 6 AdamW steps
   on a fixed batch from ``--seed`` with the harness's blocking (row-major,
   head_block 2: ``flex_fwd_hb``), one layer's attention call of the first
   step held against the plain forward and backward; then the same run with
   ``cfg.remat`` (each decoder layer under ``torch.utils.checkpoint``): its
   six losses bit for bit the plain run's, its step ms and peak memory
   beside the plain run's, and one more ``flex_fwd_hb`` a layer and step,
   the recompute (``training_remat`` in the kernels line);
6. hetero — ``flex_flash_attn_func`` with its default arguments, forward and
   backward, on the 16384-token varlen block-causal mask (12 documents),
   once at the ``LlamaConfig`` attention widths (16 q / 8 kv heads) and
   once at 8 / 8: the automatic choice must take the sparse grid (head_block
   2, then 1) and launch only the sparse-grid kernels; out, lse and the
   gradients held against the plain versions; each kernel's time beside its
   own with the work list in index order (not longest walk first), the
   row-major kernel's on the same problem, the plain version's, a PyTorch
   varlen (or SDPA) yardstick and the card's bound, each kernel in turns
   with the previous sparse walk, the forward also in turns with its
   variant that moves AMLA's reference on every rise, and the slice's
   forward + backward in device time;
7. block_sparse — the block-sparse entry points at the LlamaConfig
   attention widths (16 q / 8 kv heads, d 128, bf16) on 16,384 tokens,
   forward and backward: (a) ``dsa_attn_func`` through its indexer
   (causal, the top 16 blocks of 128: 2,048 keys, DeepSeek-V3.2's index
   top-k), (b) ``index_attn_func`` on (a)'s selection, which must give
   (a)'s bits, (c) ``block_sparse_attn_func`` on a seeded ~10% block mask
   at tq 8,192 != tk 16,384, (d) ``sparse_load_attn_func`` on 8 seeded
   disjoint ranges of 4,096 keys, causal; each launches ``flex_fwd`` then
   ``flex_dq`` + ``flex_dkv`` once (the plan built at the kernel's 64 x 64
   tile from the callers' 128 x 128 blocking) and is held against dense
   attention on the card over a mask built from the caller's selection; a
   plan whose causal refinement marks the crossing tiles FULL, planted on
   this side, must fail out and lse;
8. sink — ``flash_attention_with_sink`` at gpt-oss-120b's attention widths
   (64 q / 8 kv heads, head_dim 64, one learned sink logit per head),
   bf16, batch 2 x 8,192 as one packed call, forward and backward with
   dsink: its local layers' 128-token sliding window (the sparse grid at
   head_block 8: ``flex_fwd_sparse_hb``, ``flex_dq_sparse``,
   ``flex_dkv_sparse``) and full causal (``flex_fwd_hb``, ``flex_dq``,
   ``flex_dkv``), against dense attention with the sink on the card; one
   small ``ssh`` and one ``shd`` case (the kernels, then the sink folded
   in) against the same call on the plain forward
   (``MAGI_ATTENTION_KERNEL_BACKEND=torch``);
9. planner_host — host ms of the plan builder with the native entry
   emitter and with ``MAGI_ATTENTION_CPP_BACKEND=0`` (the hetero mask, the
   serving 4096-token causal prefill, the cp_attn cold key's planning at
   cp 2 and 4), and a 4096-token serving prefill split on the host clock
   into plan, table upload and the rest, cold and warm: printed, not
   claimed;
10. cp_attn — context parallelism through the keyed API
   (``magi_attn_flex_key`` -> ``dispatch`` -> ``calc_attn`` ->
   ``undispatch``), forward and backward in bf16 at d 128 on the hetero
   mask with chunks of 512, 16 / 8 heads (head_block 2: ``flex_fwd_hb``)
   and 8 / 8 (``flex_fwd``), at cp=2 with overlap degree 0 and cp=4 with
   degree 2 (auto group-collective impl). The cp ranks are processes
   (``testing.dist.RankPool``) sharing ``cuda:0`` over a gloo group, which
   takes CUDA tensors for its all-to-all, all-gather and all-reduce and
   stages its send/recv through pinned host buffers (printed with the
   backend); their times are not cp speeds. Rank 0 holds the gathered out,
   lse, dq, dk, dv against single-card ``flex_flash_attn_func`` pinned to
   the row-major grid on the same inputs; each rank holds one kernel call
   of its plan (its tables, received rows and kv_pad) against the plain
   versions; a cast whose backward skips the dK/dV reduce, planted in the
   ranks, must fail the dk and dv checks;
11. cp_qo_attn — qo-comm through the keyed API (``MAGI_ATTENTION_QO_COMM=1``,
   set for the rank tasks only): the dynamic solver cuts the hetero mask's
   attention plane into cp regions, Q and K/V rows are cast to each
   region's owner, one ``flex_fwd`` call there (head_block 1 at every G, as
   the JAX package's qo branch), and the partial (out, lse) rows are
   LSE-reduced back to their owners; forward and backward at cp=2 (16 / 8
   heads, auto impl, a trainable sink folded in after the merge) and cp=4
   (8 / 8, a2a). Rank 0 holds the gathered out, lse, dq, dk, dv and dsink
   against single-card ``flex_flash_attn_func`` with the same sink; each
   rank must launch ``flex_fwd``, ``flex_dq`` and ``flex_dkv`` once; each
   rank's kernel call of the first run is held against the plain versions; an
   O-return reduce that drops the remote partials, planted in the ranks,
   must fail the out and lse checks; the plan (impls, received rows,
   buffers, region areas) and the first key's host ms are printed;
12. cp_training — the training phase's trainer (same weights, batch and
   optimizer from ``--seed``) at cp=2 (degree 0) and cp=4 (degree 2), 6
   AdamW steps each: every step's loss against the training phase's cp=1
   loss and the first step's gradients (summed over the ranks) against
   cp=1's, within ``CP_LOSS_ATOL`` / ``CP_GRAD_REL_L2``; the step times and
   peak memory per rank, labelled as ranks sharing one card;
13. parallel_training — the training phase's model (full widths, 4
   layers) over two streams of its mask under dp2 x cp2, cp2 x tp2, pp2 x
   cp2 (GPipe: 2 microbatches, 3 ticks) and pp2 x cp2 x tp2 (8 ranks),
   ``models.make_parallel_groups`` row-major over (pp, dp, cp, tp), 3 AdamW
   steps each, against the cp=1 trainer on the card on the same weights
   and streams: every step's loss within ``CP_LOSS_ATOL``, every
   first-step gradient (a tp shard against its slice, a stage's layers
   against theirs) within ``CP_GRAD_REL_L2``, the same losses on every
   rank, only ``flex_fwd_hb`` / ``flex_dq`` / ``flex_dkv`` at head_block 2;
   tp all-reduces a step, pp ticks, step ms and peak memory per rank;
13b. dit — the Magi-1 DiT trainer (``models.build_magi_dit``) at
   ``DiTConfig()``'s widths (dim 256, 4 layers, 8 q / 4 kv heads of d 32,
   ffn 512, text 64 x 64) on one 32,768-token stream of 8 AR chunks of
   4,096 (the repo's Magi-1 video mask at half its length): 3 AdamW steps
   in float32 (the config's default: the float32 CUDA-core walks) and 3 in
   bfloat16 (the wgmma walks at d 32) from the same seeded weights and
   batch, each step's loss finite and the bf16 losses within 2e-2 of the
   f32 ones, step ms, tokens/s, peak memory, ``flex_fwd_hb`` / ``flex_dq``
   / ``flex_dkv`` launched once a layer a step (head_block 2), layer 0's
   first attention call against the plain versions head by head; moving
   the last chunk's latents moves no earlier token's velocity by 1e-5
   (f32); then dp2 x cp2 and cp 4 as ranks sharing the card over gloo,
   float32, on 16,384 tokens (4 chunks): each rank's gathered velocities
   and global loss within 1e-4 of cp = 1 on the card, one AdamW step, the
   same loss on every rank;
14. cp_baselines — the six cp baselines (``parallel.baselines``) at the
   LlamaConfig attention widths on 16,384 tokens, causal and hetero: ring
   and Ulysses at cp 2 and 4, USP and the double ring at 2 x 2, hybrid DCP
   at cp 2 and 4, forward and backward gathered against single-card
   ``flex_flash_attn_func`` within the kernel bounds; USP-NSA at cp 2,
   forward, against single-card ``nsa_attn`` on each rank's head block
   and, for head 0, a plain dense-masked float32 NSA (``nsa_dense_head``);
   each run's launches and bytes on the wire per rank beside
   MagiAttention's own plan's K/V rows at the same mask and cp;
15. cp_hier_attn — hierarchical two-level comm through the keyed API: the
   four cp ranks as 2 nodes x 2 (``comm.make_hier_cp_groups``), the
   cp_attn mask at 16 / 8 heads, degree 0, a2a (run A), at 8 / 8, degree
   2, hops on the intra level (run B), and on run A's key
   ``make_varlen_key_for_new_mask_after_dispatch`` with a 1024-token
   sliding window per document (run C, which must inherit the
   hierarchical plan); the gathered results against single-card
   ``flex_flash_attn_func``, rank 0's kernel call against the plain
   versions, the plan's rows that cross between nodes against the flat
   plan's (both printed), ``roll`` of dispatched integer labels by 1, -1
   and 4097 exactly equal to the dispatch of ``torch.roll``, and two
   planted hierarchical reduces (pad slots summed onto row 0; the
   gateway's pre-reduce skipped) that must fail dk and dv only;
16. cp_hier_training — the cp_training trainer at cp=4 as 2 x 2 over the
   hierarchical groups, degree 0, 6 AdamW steps, against cp=1's losses and
   first-step gradients;
17. cp_xattn — ``magi_attn_cross_key`` at cp=2 and cp=4, 16 / 8 heads:
   8192 queries as documents [4096, 2048, 2048] attending FULL to their
   own span of a 3000-row memory [1500, 750, 750] (padded to the chunk
   multiple), forward and backward against single-card
   ``flex_flash_attn_func`` with tq != tk, and a planted skip of the
   memory's dK/dV reduce that must fail dk and dv only;
18. cp_plan_reuse — a new mask every call under
   ``MAGI_ATTENTION_PLAN_REUSE=bucket`` at cp=2, 16 / 8 heads, chunk 512:
   six varlen block-causal requests (``CP_REUSE_STREAM``: a cold key whose
   documents canonicalise onto the bucket grid, a bucket hit on its
   canonical plan, an exact hit, a bucket hit through the tail extend, the
   canonical mask itself, another bucket) through ``magi_attn_varlen_key``
   -> ``dispatch`` -> ``calc_attn`` -> ``undispatch`` and the backward: each
   request's tier as the JAX package resolves it, its key's host ms, the
   rows padded, one ``flex_fwd_hb``, ``flex_dq`` and ``flex_dkv`` per rank;
   rank 0's gathered results against single-card ``flex_flash_attn_func``
   on the request's real mask, the exact hit bitwise its first call, the
   first bucket hit's kernel call against the plain versions; a planted
   bucketed runtime that pads only the tail (as an exact key does) instead
   of each document's segment, which must fail out, lse and the gradients;
   and a host-only tally of 12 packed batches of 16384 tokens
   (``utils.pack_corpus``) through the keys: tiers and median host ms;
19. cp_decode — ``serving.cp_decode_attn`` at cp=2 and cp=4 (ranks sharing
   the card over gloo): 8 histories of 4,096-32,768 tokens (32 / 8 heads,
   d 128, bf16, page 128), each rank holding a contiguous shard of each in
   its local cache (the last rank none of the first), one ``paged_decode``
   a rank, the merge an all-gather and the LSE tree; rank 0's merged out
   and lse against single-card ``decode_attn_paged`` over the whole
   histories and against the plain version; the merge's host ms; a merge
   that drops one rank's partial, planted, must fail;
20. scheduler — ``serving.Scheduler`` at the serving widths (token budget
   2048, chunks of 512): the 8 prompts of the serving phase and, once the
   4096-token one has prefilled, 3 requests extending it by token ids
   (forks, so cascade pairs ride in the ticks), 16 decode steps each, under
   ``MAGI_ATTENTION_UNIFIED_TICK`` off, on and auto: the same schedule in
   each, every request's outputs under on and auto within the kernel bound
   of off's, at most one launch an on tick and one ``paged_decode`` a fused
   tick; fused ticks (every 6th, each new largest, the first with cascade
   pairs) against the plain version in blocks of rows, and on each new
   largest one with prefill rows the planted off-by-one valid length
   (``start + i``), which must fail; one launch of an 8000-token row beside
   three short ones against the plain version; per mode each tick's wall
   ms (host clock, synchronised), launches and kernel event ms, and for the
   largest fused tick ``paged_decode``'s time alone and its bound beside
   the per-request path's ``flex_fwd_hb`` + ``paged_decode`` event ms on
   the same tick;
21. tiered — disaggregated serving (``serving.TieredEngine`` /
   ``TieredScheduler``) at the serving widths, every tier on ``cuda:0``
   (so no disaggregation speed): TP decode on the serving phase's final
   pool sharded on its kv heads at tp 2 and 4, out and lse bit for bit the
   one-launch decode's, one ``paged_decode`` a slice, against the plain
   version, with whether the bits also hold when each slice sizes its
   clusters for its own heads, and a planted slice reading its neighbour's
   kv heads, which must fail; the scheduler phase's first six prompts with
   8 decode steps each through ``MAGI_ATTENTION_SERVING_MESH`` =
   ``prefill=1,decode=2x1`` and ``2x2`` (prefill budget 2048, decode 16,
   chunks of 512): every page stream's digest checked at its destination,
   every request's outputs within 2e-3 of the one-card ``Scheduler``'s,
   per tick the wall ms and kernel event ms, the streams' bytes and host
   ms; replica pools too small for their requests' growth (a
   ``DecodeTierFault``, the requests replayed, outputs within the same
   bound); a planted stream that drops its last page, which must fail its
   digest;
22. resilience — ``MAGI_ATTENTION_GUARD`` and ``MAGI_ATTENTION_CHAOS`` on
   the card, in parts, each part's launches counted from zero: the serving
   phase's pool, ``decode_attn_paged`` over its 8 sequences under ``off``,
   ``check`` and ``repair`` without chaos, bit for bit equal, with each
   mode's kernel ms a call (``torch.profiler``) and synchronised host ms;
   ``corrupt_partial`` at ``split0`` raising ``NumericalGuardError`` under
   ``check`` and quarantined to (0, -inf) under ``repair`` (off's bits
   elsewhere); cp 2 over gloo at causal 8192, 16 / 8 heads, degree 1:
   ``check`` bit for bit ``off``, a ``stage0`` plant on rank 0 raising on
   rank 0 only, ``repair`` finite forward and backward, ``plan_error``
   falling back to degree 0 within the kernel bound of the staged result,
   ``hops_build_error`` giving the a2a collective's bits, ``corrupt_cast``
   caught at ``stage0``, a ``straggler`` leaving the bits and adding device
   ms; a 1024-token prompt and three forks at the serving widths, cascade
   decode under the split plant (``check`` raises, ``repair`` finite),
   ``prefill_error`` releasing its pages, ``alloc_fail`` and
   ``pool_exhaust`` answering ``alloc_error`` and ``pool_exhausted``; the
   tiered trace at ``prefill=1,decode=2x1`` under ``decode_fault`` replayed
   to the clean run's bits; and a flat ``paged_decode`` of 70,000 one-page
   sequences (8 / 8 heads, d 64), past one launch's 65,535 row groups, in
   two row-block launches against the plain version;
23. telemetry — serving observability on the card: the scheduler phase's
   trace under ``MAGI_ATTENTION_UNIFIED_TICK=auto``, telemetry off then on
   (``MAGI_ATTENTION_TELEMETRY=1``, the Prometheus endpoint on a free port,
   the shadow check at every 4th per-request decode batch, the memory
   pressure watcher at a free fraction of 0.95, dumps into a scratch
   directory): the same ``StepReport``s and ``torch.equal`` outputs; the
   scraped ``/metrics`` equal to ``render_prometheus(snapshot())``,
   ``/healthz`` answering; one complete request trace per request with its
   TTFT not below its queue time; the shadow checks (``paged_decode``
   against the plain decode on live batches) within the bf16 budget, the
   largest ulp distance printed; a decode step synchronising no more with
   telemetry on than off (``torch.cuda.set_sync_debug_mode("warn")``); the
   ``mem_pressure``, ``numerical_guard`` (a ``split0`` plant under
   ``check``), ``engine_fault`` (``prefill_error``, with a span ring small
   enough to drop spans) and ``decode_tier_fault`` (the tiered trace at
   ``prefill=1,decode=2x1`` under ``decode_fault``) dumps, each with the
   card allocator's numbers and the pools' fragmentation maps; the serving
   pool's ledger against its tensors' bytes and one measured decode step
   (``ledger_vs_measured``); every required series (serving, scheduler,
   traces, prefix cache with a CoW split and an eviction, builds and the
   plan solver's hit and miss, tiers, memory); and the host ms a tick
   costs with telemetry off and on, in turns after a warm-up drain;
24. profiling — the device side of telemetry, in parts, each part's
   launches counted from zero: ``telemetry.profile_roofline`` measured on
   the serving path's causal 4096 prefill (32 / 8, d 128, bf16) at the
   automatic choice (``flex_fwd_hb``) and at head_block 1 (``flex_fwd``)
   and on the hetero mask at 8 / 8 (``flex_fwd_sparse``): the achieved
   fraction of the 989 TF/s peak at most 1.05 and within 10% of the mask
   FLOPs over the kernels phase's own time of that kernel, with the gap's
   fractions; the hetero mask's block-occupancy map equal, tile for tile,
   to the plan the sparse grid launched with; ``api.profile_attn_timeline``
   at cp=2 over gloo on the cp_attn phase's key (degree 0) and on the same
   mask at degree 1: one stage a plan piece, each stage's cast and kernel
   ms, the serial sum, the pipelined whole and the measured / predicted
   ratio (the ranks share the card: no cp speed); ``MAGI_ATTENTION_NUMERICS``
   off and census ``torch.equal`` on the serving pool's decode batch and on
   the cp=2 keyed forward at degree 1, the decode census equal to a plain
   recomputation from the same kernel partials, the merges' mass deviation
   under 1e-5, a ``finite:8.0`` plant moving its site's out max-abs to 8.0,
   the census's added device ms (the reductions) and host ms
   (paired medians) a decode call; the cp_plan_reuse stream's plan-cache,
   bucket, incremental and eviction counters (telemetry on for the stream)
   against its tiers; every series of the plan, plan-cache, timeline,
   roofline and numerics catalogs recorded.
25. tuning — the autotuner (``tuning/``): the four forward kernels timed at
   every candidate of the cost model (head_block 1 / G / 2G on both grids)
   on the serving prefill at 32 / 8 and 32 / 32, causal 8192 and the hetero
   mask at 16 / 8, the hetero mask at 8 / 8 and a sliding window of 512 on
   8192; the model's efficiency and slot fees fitted to them by
   non-negative least squares, and the merge round's fee from the
   decode_timing split sweeps, each printed with every sample's predicted /
   measured ratio; the model's top pick against the candidate measured
   fastest (reported where they differ); ``flex_flash_attn_func`` under
   ``MAGI_ATTENTION_AUTOTUNE=measure`` with a temporary
   ``MAGI_ATTENTION_AUTOTUNE_CACHE_DIR`` on the prefill and the hetero mask
   at 16 / 8 and 8 / 8 (no failed candidate, the winner against the plain
   version, back from disk with the same bits after the process cache is
   dropped); the split tuners at one split on the serving batch, the 32K
   sequence and every scheduler tick geometry, and the host µs of a
   memoised split call and of a repeat kernel choice; the roofline's
   unattributed share with the committed fees and with this run's fit.
26. analysis — ``analysis/`` on the card: the cp_attn phase's hetero mask
   at the LlamaConfig widths through the keyed API at overlap degree 1,
   cp=2 over hops and a2a under ``MAGI_ATTENTION_VALIDATE`` off, plan and
   trace, and cp=4 as 2 x 2 under off and plan (three cold plan builds a
   mode, their host ms), forward and backward bit for bit equal across the
   modes, one sanitizer check counted per plan built and no failure; the
   trace runs' collectives recorded live (``comm.group_collective
   .record_collectives``) and gathered: their census the plan's expectation
   (twice it with the backward), uniform and well paired across the ranks,
   equal to each rank's dry records of the same plan; a stage
   ``recv_sel`` corrupted on one rank must raise ``PlanValidationError``
   under ``plan`` before any launch, with one failure counted; the
   serving-state interleaving checker's smoke matrix and both plants at the
   JAX package's counts, with a real decode step on the card before and
   after it, bit for bit (the stubs are gone); the upcast census of the cp
   runtime and the flex entry on the card equal to the checked-in table;
   the port linting clean and the analysis CLI's ``--self-test`` passing.
27. fleet — ``fleet/`` on the card: one seeded trace (``FLEET_TRACE``:
   MMPP arrivals at 0.5 a tick with bursts at 4, about 70 requests of
   64-2048 prompt tokens, three in four opening with one of four 512-token
   shared system prompts, lognormal outputs around 16 tokens) replayed by
   ``fleet.FleetSimulator``'s own loop through the real engine on the card
   at the serving widths (32 / 8 heads, d 128, bf16, pages of 128), in
   single mode (``Scheduler``, budget 2048) and tiered mode (prefill=1,
   decode=2x1, every tier on ``cuda:0``), each under the SLO autopilot with
   knobs sized for this geometry; a subclass swaps the stubbed device layer
   for the card, the requests for bf16 rows drawn on the card and the tick
   clock for one that stamps each tick's start after a synchronise. Each
   mode's report must equal the stubbed simulator's on the same trace,
   request for request (TTFT, token latency, tokens, evictions, finish
   tick), window for window and action for action; every request's prompt
   tail and last decode output against plain attention over its own rows;
   per mode the ticks, wall s, ms a tick, TTFT and token-latency ms (p50 /
   p99), prefill and decode tokens/s, attainment, actions, peak concurrency
   and pages, and the launches (``flex_fwd_hb`` and ``paged_decode``).
   ``FleetSimulator.run`` resets the telemetry registry: it runs last.
28. instrument (run before fleet) — profiling, checkpoints, the bench
   harness and the gate on the card: the serving widths (3 requests, 4
   decode steps) with profile mode off, then under
   ``MAGI_ATTENTION_PROFILE_MODE=1`` and ``utils.switch_profile()``: the
   outputs bit for bit, the Chrome trace holding ``magi_prefill_attn``,
   ``magi_decode_attn`` and ``magi_kvcache_append`` around kernel launches;
   the keyed cp API at cp=2 (degree 1) the same way, each rank's trace
   holding ``magi_stage0_cast`` / ``_kernel`` / ``_lse_merge``; the
   training phase's trainer 2 steps, ``utils.save_train_state``, a
   restore into a fresh model and optimizer (a drifted template raising),
   2 more: the 4 losses bit for bit those of 4 steps in a row;
   ``benchmarking.do_bench`` and ``MemoryRecorder`` on ``flex_fwd_hb`` and
   ``flex_dq`` beside the smoke's own CUDA-event times and
   ``max_memory_allocated``; ``telemetry.baseline.check_gate`` on a
   history it writes (passing, then failing a lowered entry); and an
   engine at StarCoder-15B's attention (48 q heads over 1 kv head, d 128)
   whose greedy tokens through ``paged_decode`` equal the plain decode's.

The line before the last lists the nine kernels with their launches on the
main paths (and which paths launched them: ``training_remat``,
``block_sparse``, ``sink``, ``cp_decode``, ``scheduler``, ``tiered``,
``resilience``, ``telemetry``, ``profiling``, ``tuning``, ``analysis``,
``fleet``, ``instrument`` and ``wide_serving`` among them; every path's launches must be in
it), errors and times; the
last line is
``{"ok": true, "device": {...}}``. Any failure exits non-zero before that
line; nothing falls back to a plain version. Needs one card and no network.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import math
import os
import shutil
import subprocess
import sys
import time

HQ, HK, D = 32, 8, 128  # Llama-3.1-8B attention widths
TRAIN_HQ, TRAIN_HK = 16, 8  # the repo's LlamaConfig
PAGE = 128
BLOCK = 64  # the flex kernels' tile (ops/flex_attn.py HOPPER_TILES)
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
PEAK_F32_FLOPS = 67e12  # H100 SXM CUDA-core FP32 (the float32 walks are CUDA-core work)
# bf16 outputs vs the plain f32 computation rounded to bf16: the kernels
# round P to bf16 before P.V and round the output once; lse and the row max
# come from f32 accumulations in another summation order
OUT_ATOL, OUT_RTOL = 1e-2, 1e-2
LSE_ATOL = 2e-4
# the backward kernels' dq/dk/dv vs the plain f32 backward: the kernels
# round P and dS to bf16 before their products (as the TPU kernels do), so
# an entry's error scales with the terms that make it up. Three checks per
# tensor: the largest error within GRAD_RTOL of the largest entry (plus
# GRAD_ATOL); the relative L2 error within GRAD_L2 (bf16 rounding of P and
# dS alone gives a few 1e-3); and, since on a long causal walk the first
# rows and keys of a document are far larger than the rest and would hide a
# wrong tail from the first two, each 64-row (or 64-key) block of each head
# within GRAD_RTOL of that block's own largest entry, plus GRAD_BLOCK_ATOL
# of the tensor's largest entry (f32 summation-order noise)
GRAD_RTOL, GRAD_ATOL, GRAD_L2, GRAD_BLOCK_ATOL = 2e-2, 1e-3, 1e-2, 1e-5
GRAD_BLOCK = 64
ROW_MAJOR = ("flex_fwd", "flex_fwd_hb", "flex_dq", "flex_dkv")
SPARSE = ("flex_fwd_sparse", "flex_fwd_sparse_hb", "flex_dq_sparse", "flex_dkv_sparse")
FLEX_KERNELS = ROW_MAJOR + SPARSE
# the largest out (or gradient) error of each kernel over every comparison
MAX_ERR = {name: 0.0 for name in (*FLEX_KERNELS, "paged_decode")}
TRAINING_KERNELS = ("flex_fwd_hb", "flex_dq", "flex_dkv")


class SmokeFailure(Exception):
    pass


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def with_library(kernel, lib, fn):
    """``fn`` (launches of ``kernel`` through its wrapper) on the library
    ``lib`` in place of the kernel's own: a mutated build, a variant or
    another checkout's build. Its launches are not counted."""
    from magiattention_tpu_torch import csrc

    def run():
        real, launched = csrc._libs[kernel], csrc.launches[kernel]
        csrc._libs[kernel] = lib
        try:
            return fn()
        finally:
            csrc._libs[kernel], csrc.launches[kernel] = real, launched

    return run


def out_errors(out, ref_out, pairs) -> tuple[dict, list[str]]:
    """The forward checks: out within OUT_ATOL + OUT_RTOL*|ref|, and each
    (key, got, ref) of ``pairs`` (lse, rowmax) within LSE_ATOL with -inf
    exactly where the plain version has it. Returns the errors measured and
    the checks that failed."""
    import torch

    out, ref_out = out.float(), ref_out.float()
    if not bool(torch.isfinite(out).all()):
        return {}, ["finite"]
    err = (out - ref_out).abs()
    errs = {"out_max_abs_err": float(err.max()) if err.numel() else 0.0}
    failed = ["out"] if bool((err > OUT_ATOL + OUT_RTOL * ref_out.abs()).any()) else []
    for key, got, ref in pairs:
        got, ref = got.float(), ref.float()
        if not bool((torch.isneginf(got) == torch.isneginf(ref)).all()):
            failed.append(f"{key}_neginf")
            continue
        fin = torch.isfinite(ref)
        e = float((got[fin] - ref[fin]).abs().max()) if bool(fin.any()) else 0.0
        errs[f"{key}_max_abs_err"] = e
        if e > LSE_ATOL:
            failed.append(key)
    return errs, failed


def compare(kernel, name, out, ref_out, lse=None, ref_lse=None, extra=None):
    """Out within OUT_ATOL + OUT_RTOL*|ref|, lse (and ``extra`` pairs)
    within LSE_ATOL with -inf exactly where the plain version has it."""
    pairs = [("lse", lse, ref_lse)] + [(k, g, r) for k, (g, r) in (extra or {}).items()]
    errs, failed = out_errors(out, ref_out, [p for p in pairs if p[1] is not None])
    check(not failed, f"{name}: {kernel} fails the {failed} check(s): {errs}")
    emit({"phase": "kernels", "kernel": kernel, "case": name, **errs})
    MAX_ERR[kernel] = max(MAX_ERR[kernel], errs["out_max_abs_err"])


def grad_errors(got, ref) -> tuple[dict, list[str]]:
    """The three gradient checks of one head-major [h, t, d] tensor against
    its plain version: the errors measured, and the checks that failed."""
    import torch
    import torch.nn.functional as Fn

    got, ref = got.float(), ref.float()
    if not bool(torch.isfinite(got).all()):
        return {}, ["finite"]
    diff = (got - ref).abs()
    ref_max = float(ref.abs().max())
    ref_l2 = float(ref.norm())
    pad = (0, 0, 0, (-ref.shape[1]) % GRAD_BLOCK)

    def block_max(x):  # [h, t, d] -> [h, t / GRAD_BLOCK], the max of each block
        x = Fn.pad(x, pad)
        return x.reshape(x.shape[0], -1, GRAD_BLOCK * x.shape[2]).amax(-1)

    blk_err, blk_ref = block_max(diff), block_max(ref.abs())
    blk_tol = GRAD_RTOL * blk_ref + GRAD_BLOCK_ATOL * ref_max
    errs = {
        "max_abs_err": float(diff.max()),
        "max_tol": GRAD_RTOL * ref_max + GRAD_ATOL,
        "rel_l2": float((got - ref).norm()) / ref_l2 if ref_l2 else float(diff.max()),
        # the largest block error as a share of its tolerance (<= 1 passes)
        "block_err_over_tol": float((blk_err / blk_tol.clamp_min(1e-30)).max()),
    }
    failed = [c for c, ok in (("max", errs["max_abs_err"] <= errs["max_tol"]),
                              ("rel_l2", errs["rel_l2"] <= GRAD_L2),
                              ("blocks", bool((blk_err <= blk_tol).all()))) if not ok]
    return errs, failed


def compare_grads(kernel, name, pairs) -> None:
    """Each (what, got, ref), head-major [h, t, d], passes the three checks
    of :func:`grad_errors`."""
    rec = {"case": name}
    for what, got, ref in pairs:
        errs, failed = grad_errors(got, ref)
        rec.update({f"{what}_{k}": x for k, x in errs.items()})
        check(not failed, f"{name}: {what} fails the {failed} check(s): {errs}")
        MAX_ERR[kernel] = max(MAX_ERR[kernel], errs["max_abs_err"])
    emit({"phase": "kernels", "kernel": kernel, **rec})


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Device ms per call of ``fn``: CUDA events around ``reps`` calls after
    ``warmup``, with a spin kernel holding the stream while the host
    enqueues them (as :func:`queued_ms`), so that a wrapper whose host work
    outlasts its kernels is not timed by the host's launch gaps."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e9 * (2 * one_s * reps + 2e-3)))  # cycles, at most ~2 GHz
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(flops: float, nbytes: float, peak: float = PEAK_BF16_FLOPS) -> tuple[float, str]:
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


# the flex kernels' wgmma (HGMMA), TMA loads (UTMALDG) and 1-D bulk
# copies (UBLKCP); paged_decode's mma.sync (HMMA), cp.async (LDGSTS) and
# ldmatrix (LDSM)
FLEX_SASS = ("HGMMA", "UTMALDG", "UBLKCP")
DECODE_SASS = ("HMMA", "LDGSTS", "LDSM")


def sass_counts(path: str, ops=FLEX_SASS) -> dict | None:
    """The count of each instruction of ``ops`` in a library's SASS, from
    the toolkit's ``cuobjdump``; None where the toolkit has none."""
    import shutil

    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", path], capture_output=True, text=True, timeout=300,
                          check=True).stdout
    return {op: sass.count(op) for op in ops}


def nvidia_smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


# -- flex forward: kernel vs plain ------------------------------------------


class Flex:
    """One flex-attention problem, head-major and padded as
    ``flex_attn_with_meta`` lays it out, callable through the kernel or the
    plain version."""

    def __init__(self, gen, tq, tk, hq, hk, q_ranges, k_ranges, types, *,
                 softcap=0.0, sink=None, d=D, head_block=None, out_dtype=None, k_ramp=None,
                 dtype=None):
        import torch
        from magiattention_tpu_torch.ops import flex_attn as fa

        self.tq, self.tk = tq, tk
        self.dtype = dtype = dtype or torch.bfloat16
        bq, bk = fa.resolve_tile(d, None, None)
        self.meta = fa.build_block_meta(q_ranges, k_ranges, types, tq, tk,
                                        block_q=bq, block_k=bk)
        tqp = self.meta.num_q_blocks * bq
        tkp = self.meta.num_k_blocks * bk

        def rand(t, h, tp):
            x = torch.randn((h, t, d), generator=gen, device="cuda")
            return fa._pad_tokens(x.to(dtype), tp)

        self.q, self.k, self.v = rand(tq, hq, tqp), rand(tk, hk, tkp), rand(tk, hk, tkp)
        if dtype == torch.float32:
            # positive v: the float32 budget's relative and ulp bounds measure
            # two summation orders, not the kernel, on near-zero outputs
            self.v = self.v.abs()
        if k_ramp is not None:  # keys scaled from 1 to k_ramp along the sequence
            ramp = torch.linspace(1.0, k_ramp, tk, device="cuda")[None, :, None]
            self.k[:, :tk] = (self.k[:, :tk].float() * ramp).to(dtype)
        self.sink = (
            torch.full((hq,), 0.0, device="cuda") if sink is None
            else torch.as_tensor(sink, dtype=torch.float32, device="cuda")
        )
        self.params = fa.FlexAttnParams(
            block_q=bq, block_k=bk, scale=1.0 / math.sqrt(d), softcap=softcap,
            has_sink=sink is not None, out_dtype=out_dtype or dtype,
        )
        self.tables = fa.fwd_tables(self.meta, "cuda:0")
        self.btables = fa.bwd_tables(self.meta, "cuda:0")
        self.do = rand(tq, hq, tqp)
        self.dlse = torch.randn((hq, tqp), generator=gen, device="cuda")
        self._bwd = None
        # the sparse grid, head_block q heads per forward work item (default G)
        self.sparse_params = dataclasses.replace(self.params, grid="sparse")
        self.set_head_block(hq // hk if head_block is None else head_block)

    def bwd_inputs(self):
        """(q, k, v, dout, lse, delta_eff) as the autograd Function hands
        them to the backward: lse from the forward kernel, delta_eff = sum
        dout * out - dlse with a random lse cotangent."""
        if self._bwd is None:
            out, lse, _ = self.kernel()
            delta = (self.do.float() * out.float()).sum(-1) - self.dlse
            self._bwd = (self.q, self.k, self.v, self.do, lse, delta)
        return self._bwd

    def dq_kernel(self):
        from magiattention_tpu_torch.ops import flex_attn as fa

        return fa._dq_kernel(*self.bwd_inputs(), self.tables, self.params)

    def dkv_kernel(self):
        from magiattention_tpu_torch.ops import flex_attn as fa

        return fa._dkv_kernel(*self.bwd_inputs(), self.btables, self.params)

    def dq_plain(self):
        from magiattention_tpu_torch.ops import flex_attn as fa

        return fa._dq_torch(*self.bwd_inputs(), self.tables, self.params)

    def dkv_plain(self):
        from magiattention_tpu_torch.ops import flex_attn as fa

        return fa._dkv_torch(*self.bwd_inputs(), self.btables, self.params)

    def check_bwd(self, name) -> None:
        """Both backward kernels against the plain backward, and against
        themselves: a second run gives the same bits (no atomics)."""
        import torch

        dq, (dk, dv) = self.dq_kernel(), self.dkv_kernel()
        torch.cuda.synchronize()
        dq2, (dk2, dv2) = self.dq_kernel(), self.dkv_kernel()
        check(torch.equal(dq, dq2), f"{name}: flex_dq differs between two runs")
        check(torch.equal(dk, dk2) and torch.equal(dv, dv2),
              f"{name}: flex_dkv differs between two runs")
        tq, tk = self.tq, self.tk
        compare_grads("flex_dq", name, [("dq", dq[:, :tq], self.dq_plain()[:, :tq])])
        ref_dk, ref_dv = self.dkv_plain()
        compare_grads("flex_dkv", name, [("dk", dk[:, :tk], ref_dk[:, :tk]),
                                         ("dv", dv[:, :tk], ref_dv[:, :tk])])

    def planted_faults(self, planted) -> dict:
        """The gradient checks on four faults planted in the kernels'
        work: the last entry of each q-major walk skipped (dq), the last
        entry of each k-major walk skipped (dk, dv), the last k block's
        dk and dv zeroed, and ``flex_dkv`` built with its second consumer
        warpgroup's dK partial dropped (dk). Returns, per fault and tensor,
        which checks catch it; a fault that the three checks together let
        through fails the smoke. Nothing here is counted as a main-path
        launch."""
        import torch
        from magiattention_tpu_torch.ops import flex_attn as fa

        def skip_last(tab):
            return (*tab[:6], (tab[6] - 1).clamp_min(0).contiguous())

        tq, tk = self.tq, self.tk
        ref_dq = self.dq_plain()[:, :tq]
        ref_dk, ref_dv = (x[:, :tk] for x in self.dkv_plain())
        dq_skip = fa._dq_kernel(*self.bwd_inputs(), skip_last(self.tables), self.params)
        dk_skip, dv_skip = fa._dkv_kernel(*self.bwd_inputs(), skip_last(self.btables),
                                          self.params)
        dk, dv = (x[:, :tk].clone() for x in self.dkv_kernel())
        last = (tk - 1) // GRAD_BLOCK * GRAD_BLOCK
        dk[:, last:], dv[:, last:] = 0.0, 0.0
        dk_drop = with_library("flex_dkv", planted["flex_dkv"], self.dkv_kernel)()[0]
        torch.cuda.synchronize()
        plants = {
            "skip_last_q_walk_entry": [("dq", dq_skip[:, :tq], ref_dq)],
            "skip_last_k_walk_entry": [("dk", dk_skip[:, :tk], ref_dk),
                                       ("dv", dv_skip[:, :tk], ref_dv)],
            "zero_last_k_block": [("dk", dk, ref_dk), ("dv", dv, ref_dv)],
            "drop_second_warpgroup_dk_partial:flex_dkv": [("dk", dk_drop[:, :tk], ref_dk)],
        }
        caught = {}
        for plant, pairs in plants.items():
            for what, got, ref in pairs:
                errs, failed = grad_errors(got, ref)
                caught[f"{plant}:{what}"] = {"failed_checks": failed, **errs}
                check(bool(failed), f"planted fault {plant} passes the {what} checks: {errs}")
        return caught

    def kernel(self):
        from magiattention_tpu_torch.ops import flex_attn as fa

        return fa._fwd_kernel(self.q, self.k, self.v, self.sink, self.tables, self.params)

    def plain(self):
        from magiattention_tpu_torch.ops import flex_attn as fa

        return fa._fwd_torch(self.q, self.k, self.v, self.sink, self.tables, self.params)

    def check(self, name) -> None:
        """``flex_fwd`` against the plain forward, twice for the same bits."""
        import torch

        out, lse, rowmax = self.kernel()
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip((out, lse, rowmax), self.kernel())),
              f"{name}: flex_fwd differs between two runs")
        ref_out, ref_lse, ref_rowmax = self.plain()
        tq = self.tq
        compare("flex_fwd", name, out[:, :tq], ref_out[:, :tq], lse[:, :tq],
                       ref_lse[:, :tq], {"rowmax": (rowmax[:, :tq], ref_rowmax[:, :tq])})

    # -- the head-batched row-major forward -------------------------------------

    def hb_kernel(self, hb):
        from magiattention_tpu_torch.ops import flex_attn as fa

        return fa._fwd_hb_kernel(self.q, self.k, self.v, self.sink, self.tables,
                                 dataclasses.replace(self.params, head_block=hb))

    def hb_errors(self, got):
        """(errors, failed checks) of a head-batched forward's results
        against the plain forward, cut to the real rows."""
        out, lse, rowmax = got
        ref_out, ref_lse, ref_rowmax = self.plain()
        tq = self.tq
        return out_errors(out[:, :tq], ref_out[:, :tq],
                          [("lse", lse[:, :tq], ref_lse[:, :tq]),
                           ("rowmax", rowmax[:, :tq], ref_rowmax[:, :tq])])

    def check_hb(self, name, hb) -> bool:
        """``flex_fwd_hb`` at head_block ``hb`` against the plain forward,
        twice for the same bits. Returns whether it equals ``flex_fwd`` on
        the same inputs bit for bit."""
        import torch

        got = self.hb_kernel(hb)
        torch.cuda.synchronize()
        again = self.hb_kernel(hb)
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"{name}: flex_fwd_hb differs between two runs")
        errs, failed = self.hb_errors(got)
        check(not failed, f"{name}: flex_fwd_hb fails the {failed} check(s): {errs}")
        emit({"phase": "kernels", "kernel": "flex_fwd_hb", "case": name, "head_block": hb, **errs})
        MAX_ERR["flex_fwd_hb"] = max(MAX_ERR["flex_fwd_hb"], errs["out_max_abs_err"])
        return all(torch.equal(a, b) for a, b in zip(got, self.kernel()))

    # -- the sparse grid ------------------------------------------------------

    def set_head_block(self, hb) -> None:
        """The sparse grid at ``hb`` q heads per forward work item."""
        from magiattention_tpu_torch.ops import flex_attn as fa

        hq, hk = self.q.shape[0], self.k.shape[0]
        self.hb = hb
        self.sparse_params = dataclasses.replace(self.sparse_params, head_block=hb)
        self.work = fa.sparse_work(self.meta, "cuda:0", hq, hk, hb)
        self.fwd_sparse_name = "flex_fwd_sparse_hb" if hb > 1 else "flex_fwd_sparse"

    def sparse_kernel(self):
        from magiattention_tpu_torch.ops import flex_attn as fa

        fwd = fa._fwd_sparse_hb_kernel if self.hb > 1 else fa._fwd_sparse_kernel
        return fwd(self.q, self.k, self.v, self.sink, self.tables, self.work, self.sparse_params)

    def sparse_plain(self):
        from magiattention_tpu_torch.ops import flex_attn as fa

        return fa._fwd_torch_sparse(self.q, self.k, self.v, self.sink, self.tables,
                                    self.sparse_params)

    def dq_sparse_kernel(self, tables=None):
        from magiattention_tpu_torch.ops import flex_attn as fa

        return fa._dq_sparse_kernel(*self.bwd_inputs(), tables or self.tables, self.work,
                                    self.sparse_params)

    def dkv_sparse_kernel(self, tables=None):
        from magiattention_tpu_torch.ops import flex_attn as fa

        return fa._dkv_sparse_kernel(*self.bwd_inputs(), tables or self.btables, self.work,
                                     self.sparse_params)

    def sparse_fwd_pairs(self, got):
        """(out, [(lse...), (rowmax...)]) of a sparse forward against the
        plain sparse forward, cut to the real rows."""
        out, lse, rowmax = got
        ref_out, ref_lse, ref_rowmax = self.sparse_plain()
        tq = self.tq
        return (out[:, :tq], ref_out[:, :tq],
                [("lse", lse[:, :tq], ref_lse[:, :tq]),
                 ("rowmax", rowmax[:, :tq], ref_rowmax[:, :tq])])

    def check_sparse(self, name) -> None:
        """The sparse forward of this head_block against its plain version,
        and the sparse dq/dkv against the plain backward; each kernel twice,
        for the same bits."""
        import torch

        got = self.sparse_kernel()
        torch.cuda.synchronize()
        again = self.sparse_kernel()
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"{name}: {self.fwd_sparse_name} differs between two runs")
        out, ref_out, pairs = self.sparse_fwd_pairs(got)
        compare(self.fwd_sparse_name, name, out, ref_out, extra={k: (g, r) for k, g, r in pairs})
        dq, (dk, dv) = self.dq_sparse_kernel(), self.dkv_sparse_kernel()
        torch.cuda.synchronize()
        dq2, (dk2, dv2) = self.dq_sparse_kernel(), self.dkv_sparse_kernel()
        check(torch.equal(dq, dq2), f"{name}: flex_dq_sparse differs between two runs")
        check(torch.equal(dk, dk2) and torch.equal(dv, dv2),
              f"{name}: flex_dkv_sparse differs between two runs")
        tq, tk = self.tq, self.tk
        compare_grads("flex_dq_sparse", name, [("dq", dq[:, :tq], self.dq_plain()[:, :tq])])
        ref_dk, ref_dv = self.dkv_plain()
        compare_grads("flex_dkv_sparse", name, [("dk", dk[:, :tk], ref_dk[:, :tk]),
                                                ("dv", dv[:, :tk], ref_dv[:, :tk])])


# -- planted faults in mutated copies of the forward kernels ----------------------

# The AMLA forward with its rescale of O skipped once per row: at the first
# tile where a row's integer base-2 reference rises, the accumulator keeps
# its old scale while l takes the new one. Planted into a copy of
# flex_fwd_sm90.cuh's AMLA mode, built as each sparse-grid forward; the
# checks of ``check_sparse`` must catch it.
PLANT_SKIP_RESCALE = [
    ("    float m[2] = {-INFINITY, -INFINITY}, ref[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};\n",
     "    float m[2] = {-INFINITY, -INFINITY}, ref[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};\n"
     "    bool planted[2] = {false, false};\n"),
    ("        if (__any_sync(0xffffffffu, delta[0] != 0 || delta[1] != 0)) {\n",
     "        for (int rr = 0; rr < 2; ++rr)\n"
     "          if (delta[rr] != 0 && !planted[rr]) { planted[rr] = true; delta[rr] = 0; }\n"
     "        if (__any_sync(0xffffffffu, delta[0] != 0 || delta[1] != 0)) {\n"),
]


# The head-batched row-major forward with the head-mapping bug that head
# batching invites: every head of a work item reads the kv head of the
# item's first head. Planted into a copy of flex_fwd_sm90.cuh's producer,
# built as flex_fwd_hb; the checks of ``check_hb`` must catch it where an
# item spans two kv heads.
PLANT_FIRST_KV_HEAD = [
    ("    const int kvh = h0 / group;\n", "    const int kvh = h_item / group;\n"),
]

# The warp-specialised forward with the second consumer warpgroup's
# (reference, l, O) partial dropped from the merge that ends an odd-G walk
# (the two warpgroups split a head's walk by k block). Planted into a copy of
# flex_fwd_sm90.cuh, built as flex_fwd; the forward checks must catch it.
PLANT_DROP_WG1_PARTIAL = [
    ("    const float w1 = ref1 == -INFINITY ? 0.f : expf(ref1 - rs);\n",
     "    const float w1 = 0.f;\n"),
]


# The warp-specialised dk/dv with the second consumer warpgroup's dK partial
# dropped before the final sum (each warpgroup takes every other (entry, q
# head) step of the walk). Planted into a copy of flex_bwd_sm90.cuh; the
# backward checks must catch it.
PLANT_DROP_WG1_DK = [
    ("      add_stashed<0, J>(dka, sib_k, tid);\n", ""),
]

# The persistent dq with the next item reusing the previous item's resident
# tiles: after a block's first item the producer loads no Q and dO and only
# arrives on the resident buffer's barrier. Planted into a copy of
# flex_bwd_sm90.cuh, built as flex_dq_sparse; the gradient checks must catch
# it.
PLANT_STALE_RESIDENT = [
    ("  mbar_expect_tx(bars.res_full(r), L::RESIDENT);\n",
     "  if (n > 0) {  // planted: the previous item's Q and dO stay\n"
     "    mbar_arrive(bars.res_full(r));\n"
     "    return;\n"
     "  }\n"
     "  mbar_expect_tx(bars.res_full(r), L::RESIDENT);\n"),
]

# The persistent dk/dv with the dK and dV partials zeroed only before a
# block's first item, so that each later item adds to the last one's.
# Planted into a copy of flex_dkv_sparse.cu; the gradient checks must catch
# it.
PLANT_KEEP_PARTIALS = [
    ("      zero(dka);\n      zero(dva);\n",
     "      if (n == 0) {  // planted: the partials carried from item to item\n"
     "        zero(dka);\n"
     "        zero(dva);\n"
     "      }\n"),
]

# The d-32 tile path with every 16-wide k slice of a K-major operand read
# from the first (the slice's 32-byte offset in the 64-byte swizzled row
# dropped). Planted into a copy of flex_sm90.cuh, built as flex_fwd_hb; the
# forward checks at d 32 must catch it.
PLANT_D32_FIRST_SLICE = [
    ("  if constexpr (D == 32) return smem_desc<D>(tile + kk * 32, 16, 512);\n",
     "  if constexpr (D == 32) return smem_desc<D>(tile, 16, 512);\n"),
]

# The float32 forward walk with O not rescaled when a row's max rises (l is
# rescaled, O keeps its old reference). Planted into a copy of
# flex_simt.cuh, built as flex_fwd; the float32 budget must catch it.
PLANT_F32_NO_RESCALE = [
    ("          for (int jj = 0; jj < CJ; ++jj) o[i][jj] *= alpha;\n", ""),
]

# The float32 sparse walks: the AMLA forward with O's rescale skipped the
# first time each row's reference moves (l takes it, O keeps the old
# scale); the dq items of head pairs computing their first head twice; and
# each odd claim of the dk/dv work list computing the item claimed before
# it (so that half the items are never written). Planted into copies of
# flex_simt.cuh, built as the sparse kernels; the float32 budget must catch
# each (``f32_sparse_planted_faults``).
PLANT_F32_AMLA_SKIP = [
    ("    float m[RPT], ref[RPT], l[RPT], o[RPT][CJ];\n",
     "    float m[RPT], ref[RPT], l[RPT], o[RPT][CJ];\n    int planted_rows = 0;\n"),
    ("          for (int jj = 0; jj < CJ; ++jj) o[i][jj] = amla_rescale(o[i][jj], delta);\n",
     "          if (delta != 0 && !(planted_rows & (1 << i))) planted_rows |= 1 << i;\n"
     "          else\n"
     "            for (int jj = 0; jj < CJ; ++jj) o[i][jj] = amla_rescale(o[i][jj], delta);\n"),
]
PLANT_F32_FIRST_HEAD = [
    ("      dq_item<D>(a, smem, item / nq * heads_per_item + hh, item % nq);\n",
     "      dq_item<D>(a, smem, item / nq * heads_per_item, item % nq);\n"),
]
PLANT_F32_PAIRED_ITEMS = [
    ("    const int item = work[n];\n    dkv_item<D>(a, smem, item / nk, item % nk);\n",
     "    const int item = work[n - n % 2];  // planted: odd claims redo the item before\n"
     "    dkv_item<D>(a, smem, item / nk, item % nk);\n"),
]

# Each split's last chunk dropped from the tensor-core walk; and, in the
# shared mode, every member reading member 0's q. Planted into copies of
# decode_sm90.cuh; the checks of ``decode_planted_faults`` must catch both.
PLANT_DROP_LAST_CHUNK = [
    ("  const int nchunks = (n + CH - 1) / CH;\n",
     "  const int nchunks = max(0, (n + CH - 1) / CH - 1);\n"),
]
PLANT_MEMBER0_Q = [
    ("      const int qm = i / group;  // the member whose q this row is\n",
     "      const int qm = shared ? 0 : i / group;\n"),
]

# The wide decode walks (a group past one walk's rows) with a fault each:
# decode_wide_sm90.cuh's V rows past a walk's live tokens left as the page
# holds them (caught only where NaN sits there), its merge nodes taking
# their first child alone, and decode_simt.cuh's WIDE mode reading each
# tile's scores from the first tile's rows. The checks of
# ``wide_decode_planted_faults`` must catch each at G 48.
PLANT_WIDE_TAIL_KEPT = [
    ("        if (live < CH) {  // V's rows past the live tokens: zeros, whatever the page held\n",
     "        if (live < 0) {  // planted: V's rows past the live tokens kept\n"),
]
PLANT_WIDE_FIRST_CHILD = [
    ("      merge_slots<D>(a, walk0 + (size_t)left * slot_floats, span * slot_floats, nc, rows,\n",
     "      merge_slots<D>(a, walk0 + (size_t)left * slot_floats, span * slot_floats, 1, rows,\n"),
]
PLANT_SIMT_FIRST_TILE = [
    ("      const float* tq = sQ + t0 * D;\n", "      const float* tq = sQ;\n"),
]


# Each mutated build: (the kernel source compiled, the source mutated, its
# plants), in a directory of its own beside the kernels.
PLANTED = {
    "flex_fwd_sparse": ("flex_fwd_sparse.cu", "flex_fwd_sm90.cuh", PLANT_SKIP_RESCALE),
    "flex_fwd_sparse_hb": ("flex_fwd_sparse_hb.cu", "flex_fwd_sm90.cuh", PLANT_SKIP_RESCALE),
    "flex_fwd_hb": ("flex_fwd_hb.cu", "flex_fwd_sm90.cuh", PLANT_FIRST_KV_HEAD),
    "flex_fwd_drop_partial": ("flex_fwd.cu", "flex_fwd_sm90.cuh", PLANT_DROP_WG1_PARTIAL),
    "flex_dkv": ("flex_dkv.cu", "flex_bwd_sm90.cuh", PLANT_DROP_WG1_DK),
    "flex_dq_sparse_stale_resident": ("flex_dq_sparse.cu", "flex_bwd_sm90.cuh",
                                      PLANT_STALE_RESIDENT),
    "flex_dkv_sparse_unzeroed": ("flex_dkv_sparse.cu", "flex_dkv_sparse.cu",
                                 PLANT_KEEP_PARTIALS),
    "flex_fwd_hb_d32_first_slice": ("flex_fwd_hb.cu", "flex_sm90.cuh", PLANT_D32_FIRST_SLICE),
    "flex_fwd_f32_no_rescale": ("flex_fwd.cu", "flex_simt.cuh", PLANT_F32_NO_RESCALE),
    "paged_decode_drop_last_chunk": ("decode.cu", "decode_sm90.cuh", PLANT_DROP_LAST_CHUNK),
    "paged_decode_member0_q": ("decode.cu", "decode_sm90.cuh", PLANT_MEMBER0_Q),
    "flex_fwd_sparse_f32_skip_rescale": ("flex_fwd_sparse.cu", "flex_simt.cuh",
                                         PLANT_F32_AMLA_SKIP),
    "flex_dq_sparse_f32_first_head": ("flex_dq_sparse.cu", "flex_simt.cuh", PLANT_F32_FIRST_HEAD),
    "flex_dkv_sparse_f32_paired_items": ("flex_dkv_sparse.cu", "flex_simt.cuh",
                                         PLANT_F32_PAIRED_ITEMS),
    "paged_decode_wide_tail_kept": ("decode.cu", "decode_wide_sm90.cuh", PLANT_WIDE_TAIL_KEPT),
    "paged_decode_wide_first_child": ("decode.cu", "decode_wide_sm90.cuh",
                                      PLANT_WIDE_FIRST_CHILD),
    "paged_decode_simt_first_tile": ("decode.cu", "decode_simt.cuh", PLANT_SIMT_FIRST_TILE),
}

# Variants of the kernels, timed beside them and never launched on a main
# path: the sparse-grid forwards with AMLA's integer reference moved on every
# rise of a row's max (the TPU kernel's rule) instead of only past
# AMLA_MOVE_AT, in mutated copies of flex_fwd_sm90.cuh.
AMLA_EVERY_RISE = [
    ("top > ref[rr] + AMLA_MOVE_AT;", "top > ref[rr];"),
]
VARIANTS = {
    "flex_fwd_sparse_every_rise": ("flex_fwd_sparse.cu", "flex_fwd_sm90.cuh", AMLA_EVERY_RISE),
    "flex_fwd_sparse_hb_every_rise": ("flex_fwd_sparse_hb.cu", "flex_fwd_sm90.cuh",
                                      AMLA_EVERY_RISE),
}

# The row-major backward walk before TMA and wgmma (flex_bwd.cuh's per-item
# bodies, mma.sync, one warpgroup, one (head, block) item per thread block
# on the (blocks, heads) grid), built beside the kernels as the yardstick of
# ``bwd_timing``. Never launched on a main path.
MMA_SYNC_WALK_SOURCE = r"""
#include "flex_bwd.cuh"
using namespace flex;
#define ARGS const bf16 *q, const bf16 *k, const bf16 *v, const bf16 *dout, const float *lse, \
    const float *delta, const int *blk, const int *sid, const int *runs, const int *bounds, \
    const int *rs, const int *rc
#define PASS q, k, v, dout, lse, delta, blk, sid, runs, bounds, rs, rc
template <int D> __global__ void __launch_bounds__(NTHREADS)
dq_walk(ARGS, float *dq, int group, int tqp, int tkp, float scale, float softcap) {
  extern __shared__ __align__(16) unsigned char smem[];
  dq_item<D>(PASS, dq, group, tqp, tkp, scale, softcap, blockIdx.y, blockIdx.x, smem);
}
template <int D> __global__ void __launch_bounds__(NTHREADS)
dkv_walk(ARGS, float *dk, float *dv, int group, int tqp, int tkp, float scale, float softcap) {
  extern __shared__ __align__(16) unsigned char smem[];
  dkv_item<D>(PASS, dk, dv, group, tqp, tkp, scale, softcap, blockIdx.y, blockIdx.x, smem);
}
template <typename K> cudaError_t prepare(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}
extern "C" {
const char *magi_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }
int mma_sync_flex_dq(ARGS, float *dq, int hq, int hk, int tqp, int tkp, int d, int nq,
                     float scale, float softcap, cudaStream_t st) {
  const dim3 grid(nq, hq);
  cudaError_t err = d == 64 ? prepare(dq_walk<64>, dq_smem<64>())
                            : prepare(dq_walk<128>, dq_smem<128>());
  if (err != cudaSuccess) return err;
  if (d == 64)
    dq_walk<64><<<grid, NTHREADS, dq_smem<64>(), st>>>(PASS, dq, hq / hk, tqp, tkp, scale,
                                                       softcap);
  else
    dq_walk<128><<<grid, NTHREADS, dq_smem<128>(), st>>>(PASS, dq, hq / hk, tqp, tkp, scale,
                                                         softcap);
  return cudaGetLastError();
}
int mma_sync_flex_dkv(ARGS, float *dk, float *dv, int hq, int hk, int tqp, int tkp, int d,
                      int nk, float scale, float softcap, cudaStream_t st) {
  const dim3 grid(nk, hk);
  cudaError_t err = d == 64 ? prepare(dkv_walk<64>, dkv_smem<64>())
                            : prepare(dkv_walk<128>, dkv_smem<128>());
  if (err != cudaSuccess) return err;
  if (d == 64)
    dkv_walk<64><<<grid, NTHREADS, dkv_smem<64>(), st>>>(PASS, dk, dv, hq / hk, tqp, tkp, scale,
                                                         softcap);
  else
    dkv_walk<128><<<grid, NTHREADS, dkv_smem<128>(), st>>>(PASS, dk, dv, hq / hk, tqp, tkp,
                                                           scale, softcap);
  return cudaGetLastError();
}
}
"""

# The row-major forward walk before TMA and wgmma (flex_fwd.cuh's fwd_rows:
# mma.sync, synchronous tile loads), in both launch shapes it had: one q
# head per thread block on the (q blocks, q heads) grid, and head_block q
# heads (a kv head's heads two at a time where G is even) on the (head
# groups, q blocks) grid with the q blocks last first. bf16 out. Built
# beside the kernels as the forward's yardstick; never launched on a main
# path.
MMA_SYNC_FWD_SOURCE = r"""
#include "flex_fwd.cuh"
using namespace flex;
#define ARGS const bf16 *q, const bf16 *k, const bf16 *v, const float *sink, const int *kblk, \
    const int *sid, const int *runs, const int *bounds, const int *rs, const int *rc, bf16 *out, \
    float *lse, float *rowmax
#define PASS q, k, v, sink, kblk, sid, runs, bounds, rs, rc, out, lse, rowmax
template <int D> __global__ void __launch_bounds__(NTHREADS)
fwd_walk(ARGS, int group, int tqp, int tkp, float scale, float softcap, int has_sink) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = blockIdx.y;
  fwd_rows<D, 1, bf16>(PASS, h, h / group, blockIdx.x, tqp, tkp, scale, softcap, has_sink, smem);
}
template <int D, int NH> __global__ void __launch_bounds__(NH * NTHREADS)
fwd_hb_walk(ARGS, int group, int tqp, int tkp, int nq, int head_block, float scale,
            float softcap, int has_sink) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int h_item = blockIdx.x * head_block;
  const int i = nq - 1 - blockIdx.y;
  for (int c = 0; c < head_block; c += NH) {
    if (c > 0) __syncthreads();
    fwd_rows<D, NH, bf16>(PASS, h_item + c, (h_item + c) / group, i, tqp, tkp, scale, softcap,
                          has_sink, smem);
  }
}
template <typename K> cudaError_t prepare(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}
#define LAUNCH(KERNEL, SMEM, THREADS, ...)                          \
  do {                                                              \
    cudaError_t err = prepare(KERNEL, SMEM);                        \
    if (err != cudaSuccess) return err;                             \
    KERNEL<<<grid, THREADS, SMEM, st>>>(PASS, __VA_ARGS__);         \
    return cudaGetLastError();                                      \
  } while (0)
extern "C" {
const char *magi_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }
int mma_sync_flex_fwd(ARGS, int hq, int hk, int tqp, int tkp, int d, int nq, float scale,
                      float softcap, int has_sink, cudaStream_t st) {
  const dim3 grid(nq, hq);
  if (d == 64) {
    auto kernel = fwd_walk<64>;
    LAUNCH(kernel, (fwd_smem_bytes<64, 1>()), NTHREADS, hq / hk, tqp, tkp, scale, softcap,
           has_sink);
  }
  auto kernel = fwd_walk<128>;
  LAUNCH(kernel, (fwd_smem_bytes<128, 1>()), NTHREADS, hq / hk, tqp, tkp, scale, softcap,
         has_sink);
}
#define LAUNCH_HB(DIM, NH)                                                                      \
  do {                                                                                         \
    auto kernel = fwd_hb_walk<DIM, NH>;                                                        \
    LAUNCH(kernel, (fwd_smem_bytes<DIM, NH>()), NH * NTHREADS, hq / hk, tqp, tkp, nq,          \
           head_block, scale, softcap, has_sink);                                              \
  } while (0)
int mma_sync_flex_fwd_hb(ARGS, int hq, int hk, int tqp, int tkp, int d, int nq, int head_block,
                         float scale, float softcap, int has_sink, cudaStream_t st) {
  const dim3 grid(hq / head_block, nq);
  const bool pairs = (hq / hk) % 2 == 0;
  if (d == 64 && pairs) LAUNCH_HB(64, 2);
  if (d == 64) LAUNCH_HB(64, 1);
  if (pairs) LAUNCH_HB(128, 2);
  LAUNCH_HB(128, 1);
}
}
"""

# The previous decode walk (decode_simt.cuh at bf16: CUDA cores, one page at
# a time, nothing in flight while the block computes), built beside the
# kernels as the yardstick of ``decode_timing``. Never launched on a main path.
DECODE_SIMT_SOURCE = r"""
#include "decode_simt.cuh"
extern "C" {
const char *magi_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }
int simt_paged_decode(const void *q, const void *kp, const void *vp, const void *bt,
                      const void *sl, void *out, void *lse, int b, int hq, int hk, int d,
                      int ps, int mpp, int splits, float scale, float softcap, cudaStream_t st) {
  if (d == 64)
    return decode_simt::launch<__nv_bfloat16, 64>(q, kp, vp, bt, sl, out, lse, b, hq, hk, ps,
                                                  mpp, splits, 0, scale, softcap, st);
  return decode_simt::launch<__nv_bfloat16, 128>(q, kp, vp, bt, sl, out, lse, b, hq, hk, ps,
                                                 mpp, splits, 0, scale, softcap, st);
}
}
"""


# The previous wide decode walk (decode_wide_mma.cuh: mma.sync, one warp an
# m16 row tile over a block-wide cp.async ring, clusters taking a walk's
# chunks in turn), built beside the kernels as the yardstick of
# ``wide_decode_timing``. Never launched on a main path.
DECODE_WIDE_MMA_SOURCE = r"""
#include "decode_wide_mma.cuh"
extern "C" {
const char *magi_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }
int mma_wide_paged_decode(const void *q, const void *kp, const void *vp, const void *bt,
                          const void *sl, void *out, void *lse, int b, int hq, int hk, int d,
                          int ps, int mpp, int splits, int cluster_heads, float scale,
                          float softcap, cudaStream_t st) {
  using namespace decode_sm90;
#define MAGI_WIDE_MMA(D)                                                                    \
  return launch_wide<D>((const bf16 *)q, (const bf16 *)kp, (const bf16 *)vp, (const int *)bt, \
                        (const int *)sl, (float *)out, (float *)lse, b, hq, hk, ps, mpp,      \
                        splits, cluster_heads, scale, softcap, st)
  switch (d) {
    case 32: MAGI_WIDE_MMA(32);
    case 64: MAGI_WIDE_MMA(64);
    case 128: MAGI_WIDE_MMA(128);
    default: return cudaErrorInvalidValue;
  }
}
}
"""


# The sparse-grid backward before TMA and wgmma (flex_bwd.cuh's per-item
# bodies, mma.sync, one warpgroup, in persistent blocks that take one (q
# head, q block) or (kv head, k block) item after another from a work list
# through flex_tile.cuh::next_item's __syncthreads), built beside the
# kernels as the yardstick of the ``hetero`` phase. Never launched on a main
# path.
MMA_SYNC_SPARSE_SOURCE = r"""
#include "flex_bwd.cuh"
using namespace flex;
#define ARGS const bf16 *q, const bf16 *k, const bf16 *v, const bf16 *dout, const float *lse, \
    const float *delta, const int *blk, const int *sid, const int *runs, const int *bounds, \
    const int *rs, const int *rc, const int *work, int *counter
#define PASS q, k, v, dout, lse, delta, blk, sid, runs, bounds, rs, rc
template <int D> __global__ void __launch_bounds__(NTHREADS)
dq_sparse_walk(ARGS, float *dq, int group, int tqp, int tkp, int nq, int n_items, float scale,
               float softcap) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_item;
  for (int item = next_item(counter, &s_item); item < n_items; item = next_item(counter, &s_item))
    dq_item<D>(PASS, dq, group, tqp, tkp, scale, softcap, work[item] / nq, work[item] % nq, smem);
}
template <int D> __global__ void __launch_bounds__(NTHREADS)
dkv_sparse_walk(ARGS, float *dk, float *dv, int group, int tqp, int tkp, int nk, int n_items,
                float scale, float softcap) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_item;
  for (int item = next_item(counter, &s_item); item < n_items; item = next_item(counter, &s_item))
    dkv_item<D>(PASS, dk, dv, group, tqp, tkp, scale, softcap, work[item] / nk, work[item] % nk,
                smem);
}
#define LAUNCH(KERNEL, SMEM, ...)                                                        \
  do {                                                                                   \
    auto kernel = KERNEL;                                                                \
    int grid = 0;                                                                        \
    cudaError_t err = persistent_launch_dims(kernel, NTHREADS, SMEM, n_items, counter, st, \
                                             grid);                                      \
    if (err != cudaSuccess) return err;                                                  \
    kernel<<<grid, NTHREADS, SMEM, st>>>(PASS, work, counter, __VA_ARGS__);              \
    return cudaGetLastError();                                                           \
  } while (0)
extern "C" {
const char *magi_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }
int mma_sync_flex_dq_sparse(ARGS, float *dq, int hq, int hk, int tqp, int tkp, int d, int nq,
                            int n_items, float scale, float softcap, cudaStream_t st) {
  if (d == 64)
    LAUNCH(dq_sparse_walk<64>, dq_smem<64>(), dq, hq / hk, tqp, tkp, nq, n_items, scale, softcap);
  LAUNCH(dq_sparse_walk<128>, dq_smem<128>(), dq, hq / hk, tqp, tkp, nq, n_items, scale, softcap);
}
int mma_sync_flex_dkv_sparse(ARGS, float *dk, float *dv, int hq, int hk, int tqp, int tkp, int d,
                             int nk, int n_items, float scale, float softcap, cudaStream_t st) {
  if (d == 64)
    LAUNCH(dkv_sparse_walk<64>, dkv_smem<64>(), dk, dv, hq / hk, tqp, tkp, nk, n_items, scale,
           softcap);
  LAUNCH(dkv_sparse_walk<128>, dkv_smem<128>(), dk, dv, hq / hk, tqp, tkp, nk, n_items, scale,
         softcap);
}
}
"""

# The sparse-grid forward before TMA and wgmma (flex_fwd_sparse.cuh:
# mma.sync, synchronous tile loads, persistent blocks of NH x 4 warps taking
# items through flex_tile.cuh::next_item), with the kernels' C signature,
# built beside them as the yardstick of the ``hetero`` phase. Never launched
# on a main path.
MMA_SYNC_FWD_SPARSE_SOURCE = r"""
#include "flex_fwd_sparse.cuh"
extern "C" {
const char *magi_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }
int mma_sync_flex_fwd_sparse(const void *q, const void *k, const void *v, const void *sink,
                             const void *kblk, const void *sid, const void *runs,
                             const void *bounds, const void *rs, const void *rc,
                             const void *work, void *counter, void *out, void *lse, void *rowmax,
                             int hq, int hk, int tqp, int tkp, int head_dim, int nq, int block_q,
                             int block_k, int n_items, int heads_per_item, float scale,
                             float softcap, int has_sink, int out_f32, void *stream) {
  if (hk <= 0 || hq % hk != 0) return cudaErrorInvalidValue;
  if (heads_per_item > 1 && (hq / hk) % 2 == 0)  // a head pair of one kv head at a time
    return flex::dispatch_fwd_sparse<2>(q, k, v, sink, kblk, sid, runs, bounds, rs, rc, work,
                                        counter, out, lse, rowmax, hq, hk, tqp, tkp, head_dim, nq,
                                        block_q, block_k, n_items, heads_per_item, scale, softcap,
                                        has_sink, out_f32, stream);
  return flex::dispatch_fwd_sparse<1>(q, k, v, sink, kblk, sid, runs, bounds, rs, rc, work,
                                      counter, out, lse, rowmax, hq, hk, tqp, tkp, head_dim, nq,
                                      block_q, block_k, n_items, heads_per_item, scale, softcap,
                                      has_sink, out_f32, stream);
}
}
"""

# the previous walks, yardsticks built beside the kernels
YARDSTICKS = {"mma_sync_walk": MMA_SYNC_WALK_SOURCE, "mma_sync_fwd": MMA_SYNC_FWD_SOURCE,
              "mma_sync_sparse": MMA_SYNC_SPARSE_SOURCE,
              "mma_sync_fwd_sparse": MMA_SYNC_FWD_SPARSE_SOURCE,
              "decode_simt": DECODE_SIMT_SOURCE, "decode_wide_mma": DECODE_WIDE_MMA_SOURCE}


def start_planted_build(names=None):
    """nvcc of each mutated build of ``PLANTED`` and ``VARIANTS`` and each
    yardstick of ``YARDSTICKS`` (default: all), each in a directory of its
    own under ``csrc/build/planted/``, started now and collected by
    :func:`planted_libraries`. Nothing of it is counted as a main-path
    launch."""
    import shutil as sh

    from magiattention_tpu_torch import csrc

    names = [*PLANTED, *VARIANTS, *YARDSTICKS] if names is None else list(names)
    procs = {}
    for name in names:
        out_dir = os.path.join(csrc.BUILD_DIR, "planted", name)
        os.makedirs(out_dir, exist_ok=True)
        for f in os.listdir(csrc._DIR):
            if f.endswith((".cu", ".cuh")):
                sh.copyfile(os.path.join(csrc._DIR, f), os.path.join(out_dir, f))
        if name in YARDSTICKS:
            source = f"{name}.cu"
            with open(os.path.join(out_dir, source), "w") as f:
                f.write(YARDSTICKS[name])
        else:
            source, mutated, plants = {**PLANTED, **VARIANTS}[name]
            with open(os.path.join(csrc._DIR, mutated)) as f:
                src = f.read()
            for old, new in plants:
                check(src.count(old) == 1,
                      f"planted fault: {old.strip()!r} is not in {mutated} once")
                src = src.replace(old, new)
            with open(os.path.join(out_dir, mutated), "w") as f:
                f.write(src)
        lib = os.path.join(out_dir, f"lib{name}_planted.so")
        cmd = [csrc._nvcc(), *csrc.NVCC_FLAGS, "-o", lib, os.path.join(out_dir, source)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), lib)
    return procs


def planted_libraries(procs) -> dict:
    import ctypes

    from magiattention_tpu_torch import csrc

    libs = {}
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for name, (proc, path) in procs.items():
        log, _ = proc.communicate()
        check(proc.returncode == 0, f"planted {name} did not build:\n{log}")
        lib = ctypes.CDLL(path)
        if name == "mma_sync_walk":
            # q k v dout lse delta | 6 tables | outputs | 6 ints | scale softcap stream
            for fn, outs in ((lib.mma_sync_flex_dq, 1), (lib.mma_sync_flex_dkv, 2)):
                fn.argtypes, fn.restype = [P] * 12 + [P] * outs + [I] * 6 + [F, F, P], ctypes.c_int
        elif name == "mma_sync_sparse":
            # q k v dout lse delta | 6 tables | work counter | outputs | 7 ints | scale softcap stream
            for fn, outs in ((lib.mma_sync_flex_dq_sparse, 1), (lib.mma_sync_flex_dkv_sparse, 2)):
                fn.argtypes = [P] * 12 + [P] * 2 + [P] * outs + [I] * 7 + [F, F, P]
                fn.restype = ctypes.c_int
        elif name == "decode_simt":
            # q k v bt sl | out lse | b hq hk d ps mpp splits | scale softcap stream
            fn = lib.simt_paged_decode
            fn.argtypes, fn.restype = [P] * 7 + [I] * 7 + [F, F, P], ctypes.c_int
        elif name == "decode_wide_mma":
            # q k v bt sl | out lse | b hq hk d ps mpp splits cluster_heads | scale softcap stream
            fn = lib.mma_wide_paged_decode
            fn.argtypes, fn.restype = [P] * 7 + [I] * 8 + [F, F, P], ctypes.c_int
        elif name == "mma_sync_fwd_sparse":  # the sparse forwards' C signature less in_f32
            fn = lib.mma_sync_flex_fwd_sparse
            args = csrc.KERNELS["flex_fwd_sparse"].argtypes
            fn.argtypes, fn.restype = args[:-2] + args[-1:], ctypes.c_int
        elif name == "mma_sync_fwd":
            # q k v sink | 6 tables | out lse rowmax | 6 (7) ints | scale softcap has_sink stream
            for fn, ints in ((lib.mma_sync_flex_fwd, 6), (lib.mma_sync_flex_fwd_hb, 7)):
                fn.argtypes, fn.restype = [P] * 13 + [I] * ints + [F, F, I, P], ctypes.c_int
        else:
            source = {**PLANTED, **VARIANTS}[name][0]
            kernel = next(k for k in csrc.KERNELS.values() if k.source == source)
            fn = getattr(lib, kernel.entry)
            fn.argtypes, fn.restype = kernel.argtypes, ctypes.c_int
        lib.magi_error_string.argtypes = [ctypes.c_int]
        lib.magi_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def sparse_planted_faults(gen, p, planted) -> dict:
    """The checks on faults planted in each sparse-grid kernel: the AMLA
    rescale of O skipped once per row (both forwards, through the mutated
    builds, at p's widths on causal 4096 with rising logits, so that the
    reference moves), and on problem ``p`` the last entry of each q-major
    walk skipped
    (``flex_dq_sparse``), the last entry of each k-major walk skipped
    (``flex_dkv_sparse``), and two faults of the persistent pipeline in
    mutated builds: each dq item after a block's first reusing the previous
    item's resident Q and dO, and the dK/dV partials not zeroed between a
    block's items. Returns which checks catch each; a fault that passes them
    all fails the smoke."""
    import torch

    def skip_last(tab):
        return (*tab[:6], (tab[6] - 1).clamp_min(0).contiguous())

    caught = {}
    hq, hk = p.q.shape[0], p.k.shape[0]
    rising = Flex(gen, 4096, 4096, hq, hk, [(0, 4096)], [(0, 4096)], [1], k_ramp=RISING_K)
    for name in ("flex_fwd_sparse", "flex_fwd_sparse_hb"):
        rising.set_head_block(hq // hk if name.endswith("_hb") else 1)
        got = with_library(name, planted[name], rising.sparse_kernel)()
        torch.cuda.synchronize()
        out, ref_out, pairs = rising.sparse_fwd_pairs(got)
        errs, failed = out_errors(out, ref_out, pairs)
        caught[f"skip_rescale_once_per_row:{name}"] = {"failed_checks": failed, **errs}
        check(bool(failed), f"planted fault in {name} passes the forward checks: {errs}")
    tq, tk = p.tq, p.tk
    ref_dq = p.dq_plain()[:, :tq]
    ref_dk, ref_dv = (x[:, :tk] for x in p.dkv_plain())
    dq = p.dq_sparse_kernel(skip_last(p.tables))
    dk, dv = p.dkv_sparse_kernel(skip_last(p.btables))
    dq_stale = with_library("flex_dq_sparse", planted["flex_dq_sparse_stale_resident"],
                            p.dq_sparse_kernel)()
    dk_kept, dv_kept = with_library("flex_dkv_sparse", planted["flex_dkv_sparse_unzeroed"],
                                    p.dkv_sparse_kernel)()
    torch.cuda.synchronize()
    for plant, what, got, ref in (("skip_last_q_walk_entry:flex_dq_sparse", "dq", dq[:, :tq], ref_dq),
                                  ("skip_last_k_walk_entry:flex_dkv_sparse", "dk", dk[:, :tk], ref_dk),
                                  ("skip_last_k_walk_entry:flex_dkv_sparse", "dv", dv[:, :tk], ref_dv),
                                  ("previous_item_resident_tiles:flex_dq_sparse", "dq",
                                   dq_stale[:, :tq], ref_dq),
                                  ("partials_not_zeroed_between_items:flex_dkv_sparse", "dk",
                                   dk_kept[:, :tk], ref_dk),
                                  ("partials_not_zeroed_between_items:flex_dkv_sparse", "dv",
                                   dv_kept[:, :tk], ref_dv)):
        errs, failed = grad_errors(got, ref)
        caught[f"{plant}:{what}"] = {"failed_checks": failed, **errs}
        check(bool(failed), f"planted fault {plant} passes the {what} checks: {errs}")
    return caught


def flex_cases(gen) -> None:
    """``flex_fwd`` and the backward at head_dim 128 and 64 with 4, 2 and 1
    q heads per kv head (a head pair per block at G 4 and 2, one head with
    its walk split between the two consumer warpgroups at G 1), and
    ``flex_fwd`` with its out in float32."""
    C, F, I, B = 1, 0, 2, 3
    hq = 8
    cases = [
        ("flex_causal_whole", 2048, 2048, [(0, 2048)], [(0, 2048)], [C], {}),
        ("flex_varlen_causal", 2000, 2000, [(0, 700), (700, 1500), (1500, 2000)],
         [(0, 700), (700, 1500), (1500, 2000)], [C, C, C], {"softcap": 30.0}),
        ("flex_full", 512, 768, [(0, 512)], [(0, 768)], [F], {}),
        ("flex_invcausal", 768, 768, [(0, 768)], [(0, 768)], [I], {}),
        ("flex_bicausal", 512, 768, [(0, 512)], [(0, 768)], [B], {}),
        ("flex_continuation", 512, 2560, [(0, 512)], [(0, 2560)], [C], {}),
        ("flex_uncovered_rows_sink", 1000, 1000, [(0, 600)], [(0, 600)], [C],
         {"sink": [0.5, -1.0, 2.0, 0.0, 1.0, -3.0, 0.25, 4.0]}),
        ("flex_uncovered_rows", 1000, 1000, [(100, 600)], [(0, 500)], [F], {}),
    ]
    import torch

    for name, tq, tk, qr, kr, ty, kw in cases:
        p = Flex(gen, tq, tk, hq, 2, qr, kr, ty, **kw)
        p.check(name)
        p.check_bwd(f"{name}_bwd_g4")
        for d, g in ((128, 4), (64, 1)):  # out in float32
            Flex(gen, tq, tk, hq, hq // g, qr, kr, ty, d=d, out_dtype=torch.float32,
                 **kw).check(f"{name}_g{g}_d{d}_f32_out")
        for d, g in ((128, 2), (128, 1), (64, 4), (64, 2), (64, 1)):
            pg = Flex(gen, tq, tk, hq, hq // g, qr, kr, ty, d=d, **kw)
            pg.check(f"{name}_g{g}_d{d}")
            pg.check_bwd(f"{name}_bwd_g{g}_d{d}")


def fwd_planted_faults(gen, planted) -> dict:
    """The forward checks on two faults planted in mutated builds of the
    forward walk: every head of a ``flex_fwd_hb`` item on the first head's
    kv head (a causal 2048 case at G = 2 whose head_block 4 spans two kv
    heads), and, at G = 1, the second consumer warpgroup's partial dropped
    from the merge of ``flex_fwd`` (causal 2048 at 8 / 8 heads). Returns
    which checks catch each; a fault that passes them fails the smoke."""
    import torch

    caught = {}
    p = Flex(gen, 2048, 2048, 8, 4, [(0, 2048)], [(0, 2048)], [1])
    p1 = Flex(gen, 2048, 2048, 8, 8, [(0, 2048)], [(0, 2048)], [1])
    for plant, q, got in (
        ("first_kv_head_for_every_head:flex_fwd_hb", p,
         with_library("flex_fwd_hb", planted["flex_fwd_hb"], lambda: p.hb_kernel(4))()),
        ("drop_second_warpgroup_partial:flex_fwd", p1,
         with_library("flex_fwd", planted["flex_fwd_drop_partial"], p1.kernel)()),
    ):
        torch.cuda.synchronize()
        errs, failed = q.hb_errors(got)
        caught[plant] = {"failed_checks": failed, **errs}
        check(bool(failed), f"planted fault {plant} passes the forward checks: {errs}")
    return caught


def hb_cases(gen) -> dict:
    """``flex_fwd_hb`` against the plain forward on the mask families of
    ``flex_cases`` (softcap on one, sink on another) at 8 q heads with G
    q heads per kv head, G in {1, 2, 4}, head_block G and 2G (2 at G = 1:
    an item of two kv heads), d 128 and 64. Returns how many cases equal
    ``flex_fwd`` bit for bit."""
    C, F, I, B = 1, 0, 2, 3
    cases = [
        ("hb_causal_whole", 2048, 2048, [(0, 2048)], [(0, 2048)], [C], {}),
        ("hb_varlen_causal_softcap", 2000, 2000, [(0, 700), (700, 1500), (1500, 2000)],
         [(0, 700), (700, 1500), (1500, 2000)], [C, C, C], {"softcap": 30.0}),
        ("hb_full", 512, 768, [(0, 512)], [(0, 768)], [F], {}),
        ("hb_invcausal", 768, 768, [(0, 768)], [(0, 768)], [I], {}),
        ("hb_bicausal", 512, 768, [(0, 512)], [(0, 768)], [B], {}),
        ("hb_continuation", 512, 2560, [(0, 512)], [(0, 2560)], [C], {}),
        ("hb_uncovered_rows_sink", 1000, 1000, [(0, 600)], [(0, 600)], [C],
         {"sink": [0.5, -1.0, 2.0, 0.0, 1.0, -3.0, 0.25, 4.0]}),
        ("hb_uncovered_rows", 1000, 1000, [(100, 600)], [(0, 500)], [F], {}),
    ]
    equal, differ = 0, []
    for name, tq, tk, qr, kr, ty, kw in cases:
        for g in (1, 2, 4):
            for d in (128, 64):
                p = Flex(gen, tq, tk, 8, 8 // g, qr, kr, ty, d=d, **kw)
                for hb in ((2,) if g == 1 else (g, 2 * g)):
                    case = f"{name}_g{g}_d{d}"
                    if p.check_hb(case, hb):
                        equal += 1
                    else:
                        differ.append(f"{case}_hb{hb}")
    return {"cases": equal + len(differ), "bitwise_equal_to_flex_fwd": equal,
            "differ_from_flex_fwd": differ}


def sparse_cases(gen) -> None:
    """The sparse-grid kernels against their plain versions: every mask
    family with 4 q heads per kv head at d 128 (a work item of G heads,
    packed two at a time, and of one head), and the heterogeneous masks
    also at G 2 / d 64 and G 1 / d 128 (a work item of two kv heads)."""
    from magiattention_tpu_torch.testing.workloads import (
        shared_question_q_overlap, split_slices, varlen_block_causal,
    )

    C, F, I, B = 1, 0, 2, 3
    hetero = [
        ("sparse_varlen_block_causal", 4096, 4096, *split_slices(varlen_block_causal(4096)), {}),
        ("sparse_shared_question", 4096, 4096, *split_slices(shared_question_q_overlap(4096)),
         {}),
    ]
    cases = [
        ("sparse_causal_whole", 2048, 2048, [(0, 2048)], [(0, 2048)], [C], {}),
        ("sparse_varlen_causal_softcap_sink", 2000, 2000,
         [(0, 700), (700, 1500), (1500, 2000)], [(0, 700), (700, 1500), (1500, 2000)],
         [C, C, C], {"softcap": 30.0, "sink": [0.5, -1.0, 2.0, 0.0, 1.0, -3.0, 0.25, 4.0]}),
        ("sparse_full", 512, 768, [(0, 512)], [(0, 768)], [F], {}),
        ("sparse_invcausal", 768, 768, [(0, 768)], [(0, 768)], [I], {}),
        ("sparse_bicausal", 512, 768, [(0, 512)], [(0, 768)], [B], {}),
        ("sparse_uncovered_rows", 1000, 1000, [(100, 600)], [(0, 500)], [F], {}),
        *hetero,
    ]
    for name, tq, tk, qr, kr, ty, kw in cases:
        for hb in (4, 1):
            Flex(gen, tq, tk, 8, 2, qr, kr, ty, head_block=hb, **kw).check_sparse(
                f"{name}_g4_hb{hb}")
    for name, tq, tk, qr, kr, ty, kw in hetero:
        Flex(gen, tq, tk, 4, 2, qr, kr, ty, d=64, **kw).check_sparse(f"{name}_g2_d64_hb2")
        Flex(gen, tq, tk, 4, 4, qr, kr, ty, head_block=2, **kw).check_sparse(
            f"{name}_g1_hb2")


NARROW_D = 32  # DiTConfig's head_dim: a 64-byte row, the 64-byte TMA swizzle


def narrow_cases(gen) -> dict:
    """All eight flex kernels at head_dim 32 in bf16 against their plain
    versions under the bounds of the d 64 / 128 cases, each twice for the
    same bits: ``flex_fwd``, ``flex_fwd_hb`` (head_block G and 2G) and the
    backward at G 1, 2 and 4 (8 q heads) on causal, varlen causal with a
    softcap, uncovered rows with a sink and a bi-causal tq != tk mask; the
    sparse grid (head_block 1 and G) at G 1, 2 and 4 on the two
    heterogeneous masks, its backward bit for bit ``flex_dq`` /
    ``flex_dkv``'s. Returns the line's summary."""
    import torch
    from magiattention_tpu_torch.testing.workloads import (
        shared_question_q_overlap, split_slices, varlen_block_causal,
    )

    C, B = 1, 3
    rows = [
        ("causal", 2048, 2048, [(0, 2048)], [(0, 2048)], [C], {}),
        ("varlen_causal_softcap", 2000, 2000, [(0, 700), (700, 1500), (1500, 2000)],
         [(0, 700), (700, 1500), (1500, 2000)], [C, C, C], {"softcap": 30.0}),
        ("uncovered_rows_sink", 1000, 1000, [(0, 600)], [(0, 600)], [C],
         {"sink": [0.5, -1.0, 2.0, 0.0, 1.0, -3.0, 0.25, 4.0]}),
        ("bicausal", 512, 768, [(0, 512)], [(0, 768)], [B], {}),
    ]
    n_row = n_sparse = 0
    for name, tq, tk, qr, kr, ty, kw in rows:
        for g in (1, 2, 4):
            p = Flex(gen, tq, tk, 8, 8 // g, qr, kr, ty, d=NARROW_D, **kw)
            case = f"d32_{name}_g{g}"
            p.check(case)
            for hb in ((2,) if g == 1 else (g, 2 * g)):
                p.check_hb(case, hb)
            p.check_bwd(f"{case}_bwd")
            n_row += 1
    hetero = [("varlen_block_causal", 4096, *split_slices(varlen_block_causal(4096))),
              ("shared_question", 4096, *split_slices(shared_question_q_overlap(4096)))]
    for name, t, qr, kr, ty in hetero:
        for g in (1, 2, 4):
            for hb in (1, max(g, 2)):
                p = Flex(gen, t, t, 2 * g, 2, qr, kr, ty, d=NARROW_D, head_block=hb)
                case = f"d32_sparse_{name}_g{g}_hb{hb}"
                p.check_sparse(case)
                dq, (dk, dv) = p.dq_sparse_kernel(), p.dkv_sparse_kernel()
                rm_dq, (rm_dk, rm_dv) = p.dq_kernel(), p.dkv_kernel()
                check(torch.equal(dq, rm_dq) and torch.equal(dk, rm_dk) and torch.equal(dv, rm_dv),
                      f"{case}: the sparse backward differs from flex_dq / flex_dkv")
                n_sparse += 1
    return {"phase": "kernels", "kernel": "all eight flex kernels", "head_dim": NARROW_D,
            "dtype": "bfloat16", "row_major_problems": n_row, "sparse_problems": n_sparse,
            "twice_bitwise_equal": n_row + n_sparse}


def f32_budget():
    """The float32 row of ``telemetry.numerics.DEFAULT_BUDGETS``."""
    from magiattention_tpu_torch.telemetry.numerics import DEFAULT_BUDGETS

    return DEFAULT_BUDGETS["float32"]


def f32_report(got, ref, grad: bool = False, got_lse=None, ref_lse=None) -> tuple[dict, list]:
    """One float32 result against its plain version within the float32 row
    of ``telemetry.numerics.DEFAULT_BUDGETS``: an output (with its lse) on
    every entry; a gradient, which has entries near zero where a few ulps of
    an O(1) sum are a huge relative and ulp distance, within the row's
    absolute bound everywhere and the whole row on the entries of at least
    1% of its largest magnitude (as tests/test_torch_flex_attn_bwd.py).
    Returns the stats and the breached ones."""
    import numpy as np
    from magiattention_tpu_torch.telemetry.numerics import divergence_report

    budget = f32_budget()
    g, r = (x.detach().float().cpu().numpy() for x in (got, ref))
    if not grad:
        lse = {} if got_lse is None else dict(
            test_lse=got_lse.detach().float().cpu().numpy(),
            ref_lse=ref_lse.detach().float().cpu().numpy())
        rep = divergence_report(r, g, **lse)
        stats = {"max_abs": rep.out_max_abs, "max_rel": rep.out_max_rel,
                 "max_ulp": rep.out_max_ulp, "lse_max_abs": rep.lse_max_abs}
        return stats, budget.violations(rep)
    abs_only = dataclasses.replace(budget, max_rel=float("inf"), max_ulp=float("inf"))
    rep_all = divergence_report(r, g)
    big = np.abs(r) >= 1e-2 * np.abs(r).max()
    rep_big = divergence_report(r[big], g[big])
    stats = {"max_abs": rep_all.out_max_abs, "big_max_rel": rep_big.out_max_rel,
             "big_max_ulp": rep_big.out_max_ulp}
    return stats, abs_only.violations(rep_all) + [f"big.{v}" for v in budget.violations(rep_big)]


def hold_fwd(kernel, name, f32, out, ref, lse, ref_lse, mx=None, ref_mx=None,
             positive_v=True) -> dict:
    """A forward's out, lse (and rowmax, where given) against its plain
    version: bf16 under the kernels phase's bounds (:func:`compare`),
    float32 within the float32 budget (:func:`f32_report`; where v is not
    positive, as in a model, out is held as a gradient is) with rowmax
    within its lse bound. Returns the float32 stats (empty for bf16)."""
    import torch

    rowmax = [] if mx is None else [("rowmax", mx, ref_mx)]
    if not f32:
        compare(kernel, name, out, ref, lse, ref_lse, {k: (g, r) for k, g, r in rowmax})
        return {}
    if positive_v:
        stats, bad = f32_report(out, ref, got_lse=lse, ref_lse=ref_lse)
        pairs = rowmax
    else:
        stats, bad = f32_report(out, ref, grad=True)
        pairs = [("lse", lse, ref_lse), *rowmax]
    for what, got, want in pairs:
        fin = torch.isfinite(want)
        stats[f"{what}_max_abs"] = float((got[fin] - want[fin]).abs().max()) if bool(fin.any()) \
            else 0.0
        if not torch.equal(torch.isneginf(got), torch.isneginf(want)) or \
                stats[f"{what}_max_abs"] > f32_budget().lse_max_abs:
            bad.append(what)
    check(not bad, f"{name}: {kernel} breaches the float32 budget {bad}: {stats}")
    MAX_ERR[kernel] = max(MAX_ERR[kernel], stats["max_abs"])
    emit({"phase": "kernels", "kernel": kernel, "case": name, **stats})
    return stats


def hold_grad(kernel, name, f32, what, got, ref) -> dict:
    """A gradient against its plain version: :func:`compare_grads` for a
    bf16 problem, the float32 budget's gradient rule (:func:`f32_report`)
    for a float32 one. Returns the float32 stats (empty for bf16)."""
    if not f32:
        compare_grads(kernel, name, [(what, got, ref)])
        return {}
    stats, bad = f32_report(got, ref, grad=True)
    check(not bad, f"{name}: {what} breaches the float32 budget {bad}: {stats}")
    MAX_ERR[kernel] = max(MAX_ERR[kernel], stats["max_abs"])
    emit({"phase": "kernels", "kernel": kernel, "case": name, what: stats})
    return stats


def f32_problem_check(p, name) -> dict:
    """``flex_fwd``, ``flex_fwd_hb`` (head_block G and 2G; 2 at G = 1),
    ``flex_dq`` and ``flex_dkv`` on float32 problem ``p`` against their
    plain versions (:func:`f32_report`), each twice for the same bits, and
    the head-batched forward equal to ``flex_fwd`` bit for bit."""
    import torch

    rec = {}
    tq, tk = p.tq, p.tk
    got = p.kernel()
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got, p.kernel())),
          f"{name}: flex_fwd differs between two runs")
    ref_out, ref_lse, ref_mx = p.plain()
    g = p.q.shape[0] // p.k.shape[0]
    for hb, run in [(None, got)] + [(hb, p.hb_kernel(hb))
                                    for hb in ((2,) if g == 1 else (g, 2 * g))]:
        kernel = "flex_fwd" if hb is None else "flex_fwd_hb"
        rec[kernel if hb is None else f"{kernel}:{hb}"] = hold_fwd(
            kernel, name, True, *(x[:, :tq] for x in (run[0], ref_out, run[1], ref_lse, run[2],
                                                     ref_mx)))
        check(all(torch.equal(a, b) for a, b in zip(run, got)),
              f"{name}: {kernel} at head_block {hb} differs from flex_fwd")
    dq, (dk, dv) = p.dq_kernel(), p.dkv_kernel()
    torch.cuda.synchronize()
    dq2, (dk2, dv2) = p.dq_kernel(), p.dkv_kernel()
    check(torch.equal(dq, dq2) and torch.equal(dk, dk2) and torch.equal(dv, dv2),
          f"{name}: the float32 backward differs between two runs")
    ref_dk, ref_dv = p.dkv_plain()
    for kernel, what, x, ref in (("flex_dq", "dq", dq[:, :tq], p.dq_plain()[:, :tq]),
                                 ("flex_dkv", "dk", dk[:, :tk], ref_dk[:, :tk]),
                                 ("flex_dkv", "dv", dv[:, :tk], ref_dv[:, :tk])):
        rec[what] = hold_grad(kernel, name, True, what, x, ref)
    return rec


def f32_cases(gen) -> dict:
    """The four row-major kernels on float32 q/k/v (the CUDA-core walks of
    ``csrc/flex_simt.cuh``) at head_dim 32, 64 and 128: causal 2048 at G 2,
    and at d 32 also G 1 with a softcap and a sink on varlen causal, and G 4
    on uncovered rows (:func:`f32_problem_check`). Returns the line."""
    import torch

    f32 = dict(dtype=torch.float32)
    cases = [(f"f32_causal_g2_d{d}", Flex(gen, 2048, 2048, 8, 4, [(0, 2048)], [(0, 2048)], [1],
                                          d=d, **f32)) for d in (NARROW_D, 64, 128)]
    cases += [
        ("f32_varlen_causal_softcap_sink_g1_d32",
         Flex(gen, 2000, 2000, 8, 8, [(0, 700), (700, 1500), (1500, 2000)],
              [(0, 700), (700, 1500), (1500, 2000)], [1, 1, 1], d=NARROW_D, softcap=30.0,
              sink=[0.5, -1.0, 2.0, 0.0, 1.0, -3.0, 0.25, 4.0], **f32)),
        ("f32_uncovered_rows_g4_d32",
         Flex(gen, 1000, 1000, 8, 2, [(100, 600)], [(0, 500)], [0], d=NARROW_D, **f32)),
    ]
    line = {"phase": "kernels", "kernel": "flex_fwd+flex_fwd_hb+flex_dq+flex_dkv",
            "dtype": "float32", "cases": {}}
    for name, p in cases:
        line["cases"][name] = f32_problem_check(p, name)
    return line


def narrow_planted_faults(gen, planted) -> dict:
    """Two faults planted in mutated builds of the walks this slice added:
    ``flex_fwd_hb`` at d 32 with every 16-wide k slice of S = Q K^T read
    from the first one (the 64-byte swizzle's slice offset dropped), and
    ``flex_fwd``'s float32 walk with O not rescaled when a row's max rises.
    Returns which checks catch each; a fault that passes them fails the
    smoke."""
    import torch

    caught = {}
    p = Flex(gen, 2048, 2048, 8, 4, [(0, 2048)], [(0, 2048)], [1], d=NARROW_D)
    got = with_library("flex_fwd_hb", planted["flex_fwd_hb_d32_first_slice"],
                       lambda: p.hb_kernel(2))()
    torch.cuda.synchronize()
    errs, failed = p.hb_errors(got)
    caught["first_k_slice_only:flex_fwd_hb:d32"] = {"failed_checks": failed, **errs}
    check(bool(failed), f"the planted d-32 slice fault passes the forward checks: {errs}")
    pf = Flex(gen, 2048, 2048, 8, 4, [(0, 2048)], [(0, 2048)], [1], d=NARROW_D,
              dtype=torch.float32)
    out, lse, _ = with_library("flex_fwd", planted["flex_fwd_f32_no_rescale"], pf.kernel)()
    ref_out, ref_lse, _ = pf.plain()
    stats, bad = f32_report(out[:, :2048], ref_out[:, :2048], got_lse=lse[:, :2048],
                            ref_lse=ref_lse[:, :2048])
    caught["no_rescale_of_o:flex_fwd:f32"] = {"breached": bad, **stats}
    check(bool(bad), f"the planted float32 rescale fault passes the float32 budget: {stats}")
    return caught


def f32_sparse_cases(gen) -> dict:
    """The four sparse-grid kernels on float32 q/k/v (the CUDA-core walks of
    ``csrc/flex_simt.cuh``: the forwards in AMLA's base-2 softmax, the
    backward the row-major items) at head_dim 32, 64 and 128 and 1, 2, 3, 4
    and 8 q heads per kv head (2 kv heads) on the heterogeneous varlen mask
    and on a causal one whose keys grow along the sequence (AMLA's reference
    moves): the forwards at head_block 1 and G (2 at G = 1) within the
    float32 row of ``telemetry.numerics.DEFAULT_BUDGETS`` against the plain
    sparse forward, the backward within it against the plain backward and
    bit for bit equal to the row-major float32 ``flex_dq`` / ``flex_dkv`` on
    the same tables; each kernel twice for the same bits. Returns the line."""
    import torch
    from magiattention_tpu_torch.testing.workloads import split_slices, varlen_block_causal

    masks = [("varlen_block_causal", 4096, *split_slices(varlen_block_causal(4096)), {}),
             ("rising_logits_causal", 2048, [(0, 2048)], [(0, 2048)], [1], {"k_ramp": RISING_K})]
    worst, n = {}, 0
    for m, t, qr, kr, ty, kw in masks:
        for d in (NARROW_D, 64, 128):
            for g in SPARSE_BWD_GROUPS:
                name = f"f32_sparse_{m}_g{g}_d{d}"
                p = Flex(gen, t, t, 2 * g, 2, qr, kr, ty, d=d, dtype=torch.float32, **kw)
                for hb in (1, max(g, 2)):
                    p.set_head_block(hb)
                    got = p.sparse_kernel()
                    torch.cuda.synchronize()
                    check(bitwise(got, p.sparse_kernel()),
                          f"{name}: {p.fwd_sparse_name} differs between two runs")
                    out, ref_out, pairs = p.sparse_fwd_pairs(got)
                    (_, lse, ref_lse), (_, mx, ref_mx) = pairs
                    stats = hold_fwd(p.fwd_sparse_name, f"{name}_hb{hb}", True, out, ref_out,
                                     lse, ref_lse, mx, ref_mx)
                    worst[p.fwd_sparse_name] = max(worst.get(p.fwd_sparse_name, 0.0),
                                                   stats["max_abs"])
                dq, (dk, dv) = p.dq_sparse_kernel(), p.dkv_sparse_kernel()
                torch.cuda.synchronize()
                check(torch.equal(dq, p.dq_sparse_kernel())
                      and bitwise((dk, dv), p.dkv_sparse_kernel()),
                      f"{name}: the float32 sparse backward differs between two runs")
                check(torch.equal(dq, p.dq_kernel()) and bitwise((dk, dv), p.dkv_kernel()),
                      f"{name}: the float32 sparse backward differs from flex_dq / flex_dkv")
                ref_dk, ref_dv = p.dkv_plain()
                for kernel, what, x, ref in (
                        ("flex_dq_sparse", "dq", dq[:, :t], p.dq_plain()[:, :t]),
                        ("flex_dkv_sparse", "dk", dk[:, :t], ref_dk[:, :t]),
                        ("flex_dkv_sparse", "dv", dv[:, :t], ref_dv[:, :t])):
                    stats = hold_grad(kernel, name, True, what, x, ref)
                    worst[kernel] = max(worst.get(kernel, 0.0), stats["max_abs"])
                n += 1
    return {"phase": "kernels", "kernel": "the sparse four in float32", "problems": n,
            "twice_bitwise_equal": n, "backward_bitwise_equal_to_row_major": n,
            "max_abs_err": worst}


def f32_sparse_planted_faults(gen, planted) -> dict:
    """Three faults planted in mutated builds of the float32 sparse walks:
    the AMLA rescale of O skipped once per row (``flex_fwd_sparse``, on
    rising logits, where the reference moves), the second head of each dq
    item computed as the first (``flex_dq_sparse`` at G 4, items of head
    pairs), and each odd claim of the dk/dv work list redoing the item
    before it (``flex_dkv_sparse``). Returns which checks catch each; a fault that
    passes them fails the smoke."""
    import torch

    f32 = torch.float32
    caught = {}
    p = Flex(gen, 2048, 2048, 4, 2, [(0, 2048)], [(0, 2048)], [1], d=64, dtype=f32,
             k_ramp=RISING_K, head_block=1)
    got = with_library("flex_fwd_sparse", planted["flex_fwd_sparse_f32_skip_rescale"],
                       p.sparse_kernel)()
    torch.cuda.synchronize()
    out, ref_out, pairs = p.sparse_fwd_pairs(got)
    stats, bad = f32_report(out, ref_out, got_lse=pairs[0][1], ref_lse=pairs[0][2])
    caught["skip_amla_rescale_once:flex_fwd_sparse:f32"] = {"breached": bad, **stats}
    check(bool(bad), f"the planted float32 AMLA fault passes the float32 budget: {stats}")
    from magiattention_tpu_torch.testing.workloads import split_slices, varlen_block_causal

    q = Flex(gen, 4096, 4096, 8, 2, *split_slices(varlen_block_causal(4096)), d=64, dtype=f32)
    ref_dq = q.dq_plain()[:, :4096]
    ref_dk = q.dkv_plain()[0][:, :4096]
    dq = with_library("flex_dq_sparse", planted["flex_dq_sparse_f32_first_head"],
                      q.dq_sparse_kernel)()
    # NaN in the blocks the allocator hands the planted dk / dv next: an item
    # never written shows as such, not as a stale copy of a right answer
    poison = [torch.full_like(q.k, float("nan")) for _ in range(2)]
    del poison
    dk = with_library("flex_dkv_sparse", planted["flex_dkv_sparse_f32_paired_items"],
                      q.dkv_sparse_kernel)()[0]
    torch.cuda.synchronize()
    for plant, got, ref in (("first_head_twice:flex_dq_sparse:f32", dq[:, :4096], ref_dq),
                            ("paired_items:flex_dkv_sparse:f32", dk[:, :4096], ref_dk)):
        stats, bad = f32_report(got, ref, grad=True)
        caught[plant] = {"breached": bad, **stats}
        check(bool(bad), f"the planted fault {plant} passes the float32 budget: {stats}")
    return caught


SPARSE_BWD_GROUPS = (1, 2, 3, 4, 8)  # q heads per kv head of the sparse backward cases
SHORT_DOCS = (64, 128, 64, 192, 128, 64, 64, 128)  # the short-walk mask's document lengths


def short_walk_docs(t):
    """Documents of ``SHORT_DOCS`` tokens in turn (whole tiles), packed back
    to back over t tokens, each causal over itself: each q (and k) block
    walks one to three tiles, most one or two, so a work list of many short
    items."""
    bounds, a, j = [], 0, 0
    while a < t:
        b = min(t, a + SHORT_DOCS[j % len(SHORT_DOCS)])
        bounds.append((a, b))
        a, j = b, j + 1
    return bounds, bounds, [1] * len(bounds)


def sparse_bwd_cases(gen) -> dict:
    """``flex_dq_sparse`` and ``flex_dkv_sparse`` against the plain backward
    at d 128 and 64 and G 1, 2, 3, 4 and 8 (2 kv heads) on the two
    heterogeneous masks and the short-walk one, plus softcap on one case
    and uncovered rows on another: each kernel twice for the same bits, and
    against ``flex_dq`` / ``flex_dkv`` on the same inputs and tables, which
    they must equal bit for bit (the same per-item walk in the same order).
    Returns the line's summary, with the short-walk mask's walk lengths."""
    import numpy as np
    import torch
    from magiattention_tpu_torch.ops.block_sparse import row_tables
    from magiattention_tpu_torch.testing.workloads import (
        shared_question_q_overlap, split_slices, varlen_block_causal,
    )

    masks = [
        ("varlen_block_causal", 4096, *split_slices(varlen_block_causal(4096))),
        ("shared_question", 4096, *split_slices(shared_question_q_overlap(4096))),
        ("short_walks", 4096, *short_walk_docs(4096)),
    ]
    cases = [(f"{m}_g{g}_d{d}", t, qr, kr, ty, g, d, {})
             for m, t, qr, kr, ty in masks for d in (128, 64) for g in SPARSE_BWD_GROUPS]
    cases += [("varlen_block_causal_softcap_g4_d128", *masks[0][1:], 4, 128, {"softcap": 30.0}),
              ("uncovered_rows_g3_d64", 1000, [(100, 600)], [(0, 500)], [0], 3, 64, {})]
    walks = {}
    for name, t, qr, kr, ty, g, d, kw in cases:
        p = Flex(gen, t, t, 2 * g, 2, qr, kr, ty, d=d, **kw)
        if name.startswith("short_walks") and not walks:
            for side, major, nb in (("q", p.meta.fwd_q_block, p.meta.num_q_blocks),
                                    ("k", p.meta.bwd_k_block, p.meta.num_k_blocks)):
                rc = row_tables(major, nb)[1]
                walks[side] = {"blocks": int(nb), "median": float(np.median(rc)),
                               "max": int(rc.max()), "share_one_or_two": float((rc <= 2).mean())}
        dq, (dk, dv) = p.dq_sparse_kernel(), p.dkv_sparse_kernel()
        torch.cuda.synchronize()
        dq2, (dk2, dv2) = p.dq_sparse_kernel(), p.dkv_sparse_kernel()
        check(torch.equal(dq, dq2), f"{name}: flex_dq_sparse differs between two runs")
        check(torch.equal(dk, dk2) and torch.equal(dv, dv2),
              f"{name}: flex_dkv_sparse differs between two runs")
        rm_dq, (rm_dk, rm_dv) = p.dq_kernel(), p.dkv_kernel()
        check(torch.equal(dq, rm_dq), f"{name}: flex_dq_sparse differs from flex_dq")
        check(torch.equal(dk, rm_dk) and torch.equal(dv, rm_dv),
              f"{name}: flex_dkv_sparse differs from flex_dkv")
        compare_grads("flex_dq_sparse", f"sparse_bwd_{name}",
                      [("dq", dq[:, :t], p.dq_plain()[:, :t])])
        ref_dk, ref_dv = p.dkv_plain()
        compare_grads("flex_dkv_sparse", f"sparse_bwd_{name}",
                      [("dk", dk[:, :t], ref_dk[:, :t]), ("dv", dv[:, :t], ref_dv[:, :t])])
    return {"phase": "kernels", "kernel": "flex_dq_sparse+flex_dkv_sparse", "cases": len(cases),
            "twice_bitwise_equal": len(cases), "bitwise_equal_to_row_major": len(cases),
            "short_walks": walks}


RISING_K = 12.0  # the rising-logits cases' last key scale: late tiles pass a row's reference


def sparse_fwd_cases(gen) -> dict:
    """``flex_fwd_sparse`` (head_block 1) and ``flex_fwd_sparse_hb``
    (head_block G; 2 at G = 1, an item of two kv heads) against the plain
    sparse forward at d 128 and 64 and G 1, 2, 3, 4 and 8 (2 kv heads) on
    the two heterogeneous masks, the short-walk one and a causal one whose
    keys grow along the sequence (so that AMLA's reference moves and O's
    exponent-add rescale runs), plus softcap and sink on one case and
    uncovered rows on another: each kernel twice for the same bits. Returns
    the line's summary."""
    import torch
    from magiattention_tpu_torch.testing.workloads import (
        shared_question_q_overlap, split_slices, varlen_block_causal,
    )

    vbc = split_slices(varlen_block_causal(4096))
    masks = [
        ("varlen_block_causal", 4096, *vbc, {}),
        ("shared_question", 4096, *split_slices(shared_question_q_overlap(4096)), {}),
        ("short_walks", 4096, *short_walk_docs(4096), {}),
        ("rising_logits_causal", 2048, [(0, 2048)], [(0, 2048)], [1], {"k_ramp": RISING_K}),
    ]
    cases = [(f"{m}_g{g}_d{d}", t, qr, kr, ty, g, d, kw)
             for m, t, qr, kr, ty, kw in masks for d in (128, 64) for g in SPARSE_BWD_GROUPS]
    cases += [("varlen_block_causal_softcap_sink_g4_d128", 4096, *vbc, 4, 128,
               {"softcap": 30.0, "sink": [0.5, -1.0, 2.0, 0.0, 1.0, -3.0, 0.25, 4.0]}),
              ("uncovered_rows_g3_d64", 1000, [(100, 600)], [(0, 500)], [0], 3, 64, {})]
    n = 0
    for name, t, qr, kr, ty, g, d, kw in cases:
        p = Flex(gen, t, t, 2 * g, 2, qr, kr, ty, d=d, **kw)
        for hb in (1, max(g, 2)):
            p.set_head_block(hb)
            got = p.sparse_kernel()
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(got, p.sparse_kernel())),
                  f"{name}: {p.fwd_sparse_name} differs between two runs")
            out, ref_out, pairs = p.sparse_fwd_pairs(got)
            compare(p.fwd_sparse_name, f"sparse_fwd_{name}_hb{hb}", out, ref_out,
                    extra={k: (x, y) for k, x, y in pairs})
            n += 1
    return {"phase": "kernels", "kernel": "flex_fwd_sparse+flex_fwd_sparse_hb", "cases": n,
            "twice_bitwise_equal": n}


def mma_sync_fwd(lib, p, head_block=None):
    """A launcher of the previous forward walk (the ``mma_sync_fwd`` side
    library) on ``p``'s inputs, in ``flex_fwd``'s launch shape or, with a
    ``head_block``, ``flex_fwd_hb``'s; checked once against the plain
    forward. A yardstick only: nothing here is counted as a launch."""
    import torch

    q, k, v = p.q, p.k, p.v
    hq, tqp, d = q.shape
    hk, tkp = k.shape[0], k.shape[1]
    out = torch.empty((hq, tqp, d), dtype=torch.bfloat16, device="cuda")
    lse, rowmax = (torch.empty((hq, tqp), device="cuda") for _ in range(2))
    ptrs = [x.data_ptr() for x in (q, k, v, p.sink, *p.tables[1:7], out, lse, rowmax)]
    shape = [hq, hk, tqp, tkp, d, tqp // BLOCK] + ([] if head_block is None else [head_block])
    fn = lib.mma_sync_flex_fwd if head_block is None else lib.mma_sync_flex_fwd_hb
    prm = p.params

    def run():
        code = fn(*ptrs, *shape, prm.scale, prm.softcap, int(prm.has_sink),
                  torch.cuda.current_stream().cuda_stream)
        check(code == 0, f"the previous forward walk: CUDA error {code}")

    run()
    torch.cuda.synchronize()
    _, failed = p.hb_errors((out, lse, rowmax))
    check(not failed, f"the previous forward walk fails the {failed} check(s)")
    return run


def fwd_in_turns(p, planted, g, reps) -> dict:
    """``flex_fwd`` and ``flex_fwd_hb`` at head_block ``g`` (and 2g where
    given) on problem ``p``, each timed in turns with the previous walk in
    the same launch shape (new, old, old, new). Returns the samples and the
    means under ``name`` and ``previous:name``."""
    old = planted["mma_sync_fwd"]
    runs = {"flex_fwd": (p.kernel, mma_sync_fwd(old, p))}
    for hb in g:
        runs[f"hb{hb}"] = (lambda hb=hb: p.hb_kernel(hb), mma_sync_fwd(old, p, hb))
    samples = {}
    for name, (new, prev) in runs.items():
        for which, fn in (("", new), ("previous:", prev), ("previous:", prev), ("", new)):
            samples.setdefault(which + name, []).append(cuda_ms(fn, reps=reps))
    return {"samples": samples, "ms": {n: sum(x) / len(x) for n, x in samples.items()}}


def fwd_bound(p, t, hq, hk) -> tuple[float, str]:
    """The forward's bound on a t-token problem: 4 d FLOPs per unmasked
    pair and q head; q, k, v read and out, lse written once."""
    flops = 4.0 * p.meta.total_area * D * hq
    nbytes = 2 * (2 * t * hq * D + 2 * t * hk * D) + 4 * 2 * t * hq
    return bound(flops, nbytes)


def flex_timing(gen, t: int, planted) -> dict:
    """The serving prefill's forward on one causal prompt at the serving
    widths: ``flex_fwd`` (head_block 1) and ``flex_fwd_hb`` at head_block G
    and 2G, each checked at this shape first and timed in turns with the
    previous walk in its launch shape; the plain version, SDPA and the
    card's bound for that work. Returns one timing record per kernel
    (``flex_fwd_hb`` at G, the automatic choice) and the 2G times."""
    import torch.nn.functional as Fn

    p = Flex(gen, t, t, HQ, HK, [(0, t)], [(0, t)], [1])
    g = HQ // HK
    p.check(f"flex_causal_{t}_serving_widths")
    bitwise = {hb: p.check_hb(f"flex_causal_{t}_serving_widths", hb) for hb in (g, 2 * g)}
    turns = fwd_in_turns(p, planted, (g, 2 * g), reps=20)
    ms = turns["ms"]
    plain_ms = cuda_ms(p.plain, reps=3, warmup=1)
    q = p.q[:, :t].unsqueeze(0)
    k = p.k[:, :t].unsqueeze(0)
    v = p.v[:, :t].unsqueeze(0)
    lib_ms = cuda_ms(
        lambda: Fn.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True),
        reps=20,
    )
    bound_ms, bound_by = fwd_bound(p, t, HQ, HK)
    names = {"flex_fwd": "flex_fwd", "flex_fwd_hb": f"hb{g}", "flex_fwd_hb_2g": f"hb{2 * g}"}

    def record(kernel_ms):
        return {"ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": lib_ms}

    emit({"phase": "fwd_timing", "tokens": t, "hq": HQ, "hk": HK, "card": nvidia_smi_line(),
          "ms_in_turns": turns["samples"], "ms": ms, "plain_ms": plain_ms, "sdpa_ms": lib_ms,
          "bound_ms": bound_ms, "bitwise_equal_to_flex_fwd": bitwise,
          "previous_walk_ms": {k: ms[f"previous:{n}"] for k, n in names.items()},
          "speedup_over_previous_walk": {k: ms[f"previous:{n}"] / ms[n]
                                         for k, n in names.items()},
          "share_of_bound": {k: bound_ms / ms[n] for k, n in names.items()}})
    return {"flex_fwd": record(ms["flex_fwd"]), "flex_fwd_hb": record(ms[f"hb{g}"]),
            "flex_fwd_hb_2g_ms": ms[f"hb{2 * g}"]}


def mma_sync_walk(lib, p):
    """Launchers of the previous backward walk (the ``mma_sync_walk`` side
    library) on ``p``'s backward inputs, checked once against the plain
    backward. A yardstick only: nothing here is counted as a launch."""
    import torch

    q, k, v, do, lse, delta = p.bwd_inputs()
    hq, tqp, d = q.shape
    hk, tkp = k.shape[0], k.shape[1]
    f32 = dict(dtype=torch.float32, device="cuda")
    dq, dk, dv = torch.empty((hq, tqp, d), **f32), *(torch.empty((hk, tkp, d), **f32)
                                                     for _ in range(2))
    head = [x.data_ptr() for x in (q, k, v, do, lse, delta)]

    def run(fn, tables, outs, blocks):
        code = fn(*head, *(x.data_ptr() for x in tables[1:7]), *(o.data_ptr() for o in outs),
                  hq, hk, tqp, tkp, d, blocks, p.params.scale, p.params.softcap,
                  torch.cuda.current_stream().cuda_stream)
        check(code == 0, f"the previous backward walk: CUDA error {code}")

    def run_dq():
        run(lib.mma_sync_flex_dq, p.tables, (dq,), tqp // BLOCK)

    def run_dkv():
        run(lib.mma_sync_flex_dkv, p.btables, (dk, dv), tkp // BLOCK)

    run_dq()
    run_dkv()
    torch.cuda.synchronize()
    ref_dk, ref_dv = p.dkv_plain()
    for what, got, ref, t in (("dq", dq, p.dq_plain(), p.tq), ("dk", dk, ref_dk, p.tk),
                              ("dv", dv, ref_dv, p.tk)):
        _, failed = grad_errors(got[:, :t], ref[:, :t])
        check(not failed, f"the previous backward walk's {what} fails the {failed} check(s)")
    return run_dq, run_dkv


def bwd_timing(gen, t: int, planted) -> dict:
    """Both backward kernels and their plain versions on one causal
    sequence at the training widths, each kernel's bound from its own work,
    each kernel timed in turns with the previous walk on the same problem
    (new, old, old, new), and the backward of PyTorch's
    ``scaled_dot_product_attention`` on the same problem (fwd+bwd minus fwd)
    as a yardstick for the pair."""
    import torch
    import torch.nn.functional as Fn

    hq, hk = TRAIN_HQ, TRAIN_HK
    p = Flex(gen, t, t, hq, hk, [(0, t)], [(0, t)], [1])
    p.check_bwd(f"flex_bwd_causal_{t}_training_widths")
    p.check(f"flex_causal_{t}_training_widths")
    p.check_hb(f"flex_causal_{t}_training_widths", hq // hk)
    emit({"phase": "planted_faults", "case": f"flex_bwd_causal_{t}_training_widths",
          "caught": p.planted_faults(planted)})
    emit({"phase": "planted_faults", "case": f"sparse_grid_causal_{t}_training_widths",
          "caught": sparse_planted_faults(gen, p, planted)})
    old_dq, old_dkv = mma_sync_walk(planted["mma_sync_walk"], p)
    runs = {"flex_dq": p.dq_kernel, "mma_sync_dq": old_dq,
            "flex_dkv": p.dkv_kernel, "mma_sync_dkv": old_dkv}
    samples = {name: [] for name in runs}
    for new, old in (("flex_dq", "mma_sync_dq"), ("flex_dkv", "mma_sync_dkv")):
        for name in (new, old, old, new):
            samples[name].append(cuda_ms(runs[name], reps=10))
    ms = {name: sum(x) / len(x) for name, x in samples.items()}
    dq_ms, dkv_ms = ms["flex_dq"], ms["flex_dkv"]
    dq_plain_ms = cuda_ms(p.dq_plain, reps=2, warmup=1)
    dkv_plain_ms = cuda_ms(p.dkv_plain, reps=2, warmup=1)
    q, k, v = (x[:, :t].unsqueeze(0).detach().requires_grad_() for x in (p.q, p.k, p.v))
    do = p.do[:, :t].unsqueeze(0)

    def fwd():
        return Fn.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)

    def fwd_bwd():
        torch.autograd.grad(fwd(), (q, k, v), do)

    g = hq // hk
    # the trainer's forward is flex_fwd_hb at head_block G
    turns = fwd_in_turns(p, planted, (g,), reps=10)
    fwd_ms, hb_ms = turns["ms"]["flex_fwd"], turns["ms"][f"hb{g}"]
    fwd_b = fwd_bound(p, t, hq, hk)[0]
    sdpa_fwd_ms = cuda_ms(fwd, reps=10)
    sdpa_bwd_ms = cuda_ms(fwd_bwd, reps=10) - sdpa_fwd_ms
    area = p.meta.total_area
    in_bytes = 2 * (2 * t * hq * D + 2 * t * hk * D) + 4 * 2 * t * hq  # q, do, k, v; lse, delta
    dq_bound = bound(6.0 * area * D * hq, in_bytes + 4 * t * hq * D)
    dkv_bound = bound(8.0 * area * D * hq, in_bytes + 4 * 2 * t * hk * D)
    return {
        "tokens": t, "hq": hq, "hk": hk, "area": area, "card": nvidia_smi_line(),
        "ms_in_turns": samples,
        "previous_walk_ms": {"flex_dq": ms["mma_sync_dq"], "flex_dkv": ms["mma_sync_dkv"]},
        "speedup_over_previous_walk": {"flex_dq": ms["mma_sync_dq"] / dq_ms,
                                       "flex_dkv": ms["mma_sync_dkv"] / dkv_ms},
        "share_of_bound": {"flex_dq": dq_bound[0] / dq_ms, "flex_dkv": dkv_bound[0] / dkv_ms},
        "flex_dq": {"ms": dq_ms, "plain_ms": dq_plain_ms, "bound_ms": dq_bound[0],
                    "bound_by": dq_bound[1], "library_ms": sdpa_bwd_ms},
        "flex_dkv": {"ms": dkv_ms, "plain_ms": dkv_plain_ms, "bound_ms": dkv_bound[0],
                     "bound_by": dkv_bound[1], "library_ms": None},
        "sdpa_bwd_ms_for_the_pair": sdpa_bwd_ms,
        "flex_fwd_ms_same_problem": fwd_ms,
        f"flex_fwd_hb_head_block_{g}_ms_same_problem": hb_ms,
        "sdpa_fwd_ms_same_problem": sdpa_fwd_ms,
        "fwd_ms_in_turns": turns["samples"],
        "fwd_bound_ms": fwd_b,
        "fwd_previous_walk_ms": {"flex_fwd": turns["ms"]["previous:flex_fwd"],
                                 "flex_fwd_hb": turns["ms"][f"previous:hb{g}"]},
        "fwd_speedup_over_previous_walk": {
            "flex_fwd": turns["ms"]["previous:flex_fwd"] / fwd_ms,
            "flex_fwd_hb": turns["ms"][f"previous:hb{g}"] / hb_ms},
        "fwd_share_of_bound": {"flex_fwd": fwd_b / fwd_ms, "flex_fwd_hb": fwd_b / hb_ms},
    }


# -- paged decode: kernel vs plain ------------------------------------------

DECODE_MPP = 48  # the kernel cases' table width: divisible by every split count below
DECODE_SPLITS = (1, 3, 4, 16)
DECODE_SHARED_PAGES = 12  # the shared-mode cases' prefix pages: divisible by 1, 3 and 4
DECODE_SWEEP = (1, 2, 4, 8, 16)


def decode_cache(gen, lengths, mpp=64):
    """A bf16 cache at the serving widths holding one random sequence per
    slot, every slot owning max_pages_per_seq pages (page 0 unused)."""
    import torch
    from magiattention_tpu_torch.serving import (
        assign_block_table, make_paged_kv_cache, write_prefill_kv,
    )

    cache = make_paged_kv_cache(len(lengths) * mpp + 1, PAGE, HK, D,
                                max_seqs=len(lengths), max_pages_per_seq=mpp)
    for slot, n in enumerate(lengths):
        assign_block_table(cache, slot, list(range(1 + slot * mpp, 1 + (slot + 1) * mpp)))
        kv = torch.randn((2, n, HK, D), generator=gen, device="cuda").to(torch.bfloat16)
        write_prefill_kv(cache, slot, kv[0], kv[1])
    return cache


def decode_problem(gen, d, dtype, hq, hk, ps, lengths, mpp=DECODE_MPP):
    """A ``dtype`` cache holding one random sequence per slot on a random
    permutation of the pool's pages (page 0 unused), ``mpp`` pages a slot,
    and a random query per slot."""
    import torch
    from magiattention_tpu_torch.serving import (
        assign_block_table, make_paged_kv_cache, write_prefill_kv,
    )

    b = len(lengths)
    cache = make_paged_kv_cache(b * mpp + 1, ps, hk, d, max_seqs=b,
                                max_pages_per_seq=mpp, dtype=dtype)
    pages = (torch.randperm(b * mpp, generator=gen, device="cuda") + 1).tolist()
    for slot, n in enumerate(lengths):
        assign_block_table(cache, slot, pages[slot * mpp:(slot + 1) * mpp])
        kv = torch.randn((2, n, hk, d), generator=gen, device="cuda").to(dtype)
        write_prefill_kv(cache, slot, kv[0], kv[1])
    q = torch.randn((b, hq, d), generator=gen, device="cuda").to(dtype)
    return cache, q


def decode_parts(q, cache, bt, sl, splits, softcap=0.0, shared=False):
    """The kernel's per-split partials (out_parts, lse_parts), one launch."""
    import torch
    from magiattention_tpu_torch.serving import decode_attn as da

    params = da.DecodeParams(1.0 / math.sqrt(q.shape[2]), softcap, splits, torch.float32)
    return da._decode_partials_kernel(q, cache, bt, sl, params, shared=shared)


def bitwise(a, b) -> bool:
    """Each tensor of ``a`` equal, bit for bit, to its partner in ``b``."""
    import torch

    return all(torch.equal(x, y) for x, y in zip(a, b))


def nan_past_lengths(cache, lengths):
    """A copy of ``cache`` whose every position past a slot's length in the
    slot's own pages (the rest of its last page, and the pages after it)
    holds NaN in K and V."""
    import torch

    dirty = dataclasses.replace(cache, k_pages=cache.k_pages.clone(),
                                v_pages=cache.v_pages.clone())
    ps = cache.page_size
    for slot, n in enumerate(lengths):
        pos = torch.arange(n, cache.max_pages_per_seq * ps, device="cuda")
        page = cache.block_tables[slot].long()[pos // ps]
        dirty.k_pages[page, pos % ps] = float("nan")
        dirty.v_pages[page, pos % ps] = float("nan")
    return dirty


def decode_cases(gen) -> dict:
    """``paged_decode`` against its plain version (``decode_reference``, one
    f32 split) on the card. The serving widths on ragged lengths through the
    public entry; then d 128 / 64, bf16 / f32, G 1, 2, 4, 8 (and 16 at
    bf16), pages of 16, 64 and 128 tokens, 1, 3, 4 and 16 splits, softcap on
    one case, ragged and zero lengths on shuffled pages, each launch run
    twice for the same bits; positions past each length set to NaN in a
    copy of the cache (same bits as on the clean cache); and the shared mode
    (the cascade's level 1) at 1, 3 and 8 members, against the plain
    version and the flat mode over the broadcast table. Returns the summary
    line."""
    import torch
    from magiattention_tpu_torch.serving import decode_attn as da
    from magiattention_tpu_torch.serving import decode_attn_paged, decode_reference

    lengths = [0, 1, PAGE, PAGE + 1, 1000, 4096, 4097, 8000]
    cache = decode_cache(gen, lengths)
    b = len(lengths)
    slots = torch.arange(b, device="cuda")
    q = torch.randn((b, HQ, D), generator=gen, device="cuda").to(torch.bfloat16)
    ref_out, ref_lse = decode_reference(q, cache, cache.block_tables, cache.seq_lens)
    for splits in (1, 4):
        out, lse = decode_attn_paged(q, cache, slots, num_splits=splits, out_dtype=torch.float32)
        torch.cuda.synchronize()
        check(bool((out[0] == 0).all()), "decode: zero-length slot out is not 0")
        compare("paged_decode", f"decode_ragged_splits{splits}", out, ref_out, lse, ref_lse)

    worst = {"out_max_abs_err": 0.0, "lse_max_abs_err": 0.0}
    shared_vs_flat = dict(worst)
    counts = {"flat": 0, "shared": 0, "nan_tail": 0}

    def held(name, parts, ref):
        out, lse = da._merge_splits(*parts)
        errs, failed = out_errors(out, ref[0], [("lse", lse, ref[1])])
        check(not failed, f"{name}: paged_decode fails the {failed} check(s): {errs}")
        for k in worst:
            worst[k] = max(worst[k], errs.get(k, 0.0))
        MAX_ERR["paged_decode"] = max(MAX_ERR["paged_decode"], errs["out_max_abs_err"])

    def twice(name, *args, **kw):
        first = decode_parts(*args, **kw)
        again = decode_parts(*args, **kw)
        torch.cuda.synchronize()
        check(bitwise(first, again), f"{name}: two runs of paged_decode differ")
        return first

    bf16, f32 = torch.bfloat16, torch.float32
    hk = 2
    for d in (128, 64):
        for dtype in (bf16, f32):
            for g in (1, 2, 4, 8) + ((16,) if dtype == bf16 else ()):
                for ps in (16, 64, 128):
                    full = DECODE_MPP * ps
                    lens = [0, 1, ps - 1, ps + 1, 5 * ps + 3, full // 2 + 7, full - 1, full]
                    cache, q = decode_problem(gen, d, dtype, g * hk, hk, ps, lens)
                    bt, sl = cache.block_tables, cache.seq_lens
                    softcap = 4.0 if (d, dtype, g, ps) == (128, bf16, 4, 64) else 0.0
                    ref = decode_reference(q, cache, bt, sl, softcap=softcap)
                    tag = f"d{d}_{str(dtype)[6:]}_g{g}_ps{ps}" + ("_softcap" if softcap else "")
                    for splits in DECODE_SPLITS:
                        parts = twice(f"{tag}_splits{splits}", q, cache, bt, sl, splits, softcap)
                        held(f"{tag}_splits{splits}", parts, ref)
                        counts["flat"] += 1
                    if g == 4 and ps == 64:
                        dirty = nan_past_lengths(cache, lens)
                        for splits in (1, 4):
                            check(bitwise(decode_parts(q, cache, bt, sl, splits, softcap),
                                          decode_parts(q, dirty, bt, sl, splits, softcap)),
                                  f"{tag}_splits{splits}: NaN past the lengths changes the output")
                            counts["nan_tail"] += 1

    # the shared mode: every member reads one table row and one length
    w = DECODE_SHARED_PAGES
    for d in (128, 64):
        for dtype in (bf16, f32):
            for ps in (16, 128):
                cache = da.PagedKVCache(
                    *(torch.randn((4 * w + 1, ps, hk, d), generator=gen, device="cuda").to(dtype)
                      for _ in range(2)),
                    torch.zeros((1, w), dtype=torch.int32, device="cuda"),
                    torch.zeros((1,), dtype=torch.int32, device="cuda"))
                pages = (torch.randperm(4 * w, generator=gen, device="cuda")[:w] + 1).int()
                for g in (1, 2, 4, 8):
                    for members in (1, 3, 8):
                        # a partial last page at 3 members: the mask and the NaN tail
                        plen = w * ps - (5 if members == 3 else 0)
                        q = torch.randn((members, g * hk, d), generator=gen,
                                        device="cuda").to(dtype)
                        bt_b = pages[None].expand(members, w).contiguous()
                        sl_b = torch.full((members,), plen, dtype=torch.int32, device="cuda")
                        sl_1 = sl_b[:1]
                        ref = decode_reference(q, cache, bt_b, sl_b)
                        tag = f"shared_d{d}_{str(dtype)[6:]}_ps{ps}_g{g}_m{members}"
                        for splits in (1, 3, 4):
                            parts = twice(f"{tag}_splits{splits}", q, cache, pages[None], sl_1,
                                          splits, shared=True)
                            held(f"{tag}_splits{splits}", parts, ref)
                            flat = da._merge_splits(*decode_parts(q, cache, bt_b, sl_b, splits))
                            out, lse = da._merge_splits(*parts)
                            errs, failed = out_errors(out, flat[0], [("lse", lse, flat[1])])
                            check(not failed, f"{tag}_splits{splits}: the shared mode fails the "
                                  f"{failed} check(s) against the flat mode: {errs}")
                            for k in shared_vs_flat:
                                shared_vs_flat[k] = max(shared_vs_flat[k], errs.get(k, 0.0))
                            entry = da._decode_shared_prefix(q, cache, pages, plen,
                                                             num_splits=splits)
                            check(bitwise(entry, da._merge_splits(*parts)),
                                  f"{tag}_splits{splits}: _decode_shared_prefix differs from "
                                  "its kernel's merged partials")
                            counts["shared"] += 1
                        if members == 3:
                            dirty = dataclasses.replace(cache, k_pages=cache.k_pages.clone(),
                                                        v_pages=cache.v_pages.clone())
                            last = pages[-1].long()
                            dirty.k_pages[last, ps - 5:] = float("nan")
                            dirty.v_pages[last, ps - 5:] = float("nan")
                            clean = decode_parts(q, cache, pages[None], sl_1, 4, shared=True)
                            check(bitwise(clean, decode_parts(q, dirty, pages[None], sl_1, 4,
                                                              shared=True)),
                                  f"{tag}: NaN past the prefix length changes the output")
                            counts["nan_tail"] += 1
    return {"phase": "kernels", "kernel": "paged_decode", "cases": counts,
            "two_runs_bitwise_equal": True, **worst, "shared_vs_flat": shared_vs_flat}


def decode_planted_faults(gen, planted) -> dict:
    """The checks on the two faults planted in ``paged_decode``: each split's
    last chunk dropped (a flat batch at the serving widths, 4 splits), and
    every member on member 0's q (the shared mode, 3 members). Returns which
    checks catch each; a fault that passes them all fails the smoke."""
    import torch
    from magiattention_tpu_torch.serving import decode_attn as da
    from magiattention_tpu_torch.serving import decode_reference

    lens = [1, 100, PAGE + 1, 1000, 3000, 6000]
    cache, q = decode_problem(gen, D, torch.bfloat16, HQ, HK, PAGE, lens)
    bt, sl = cache.block_tables, cache.seq_lens
    pages, plen = bt[5, :DECODE_SHARED_PAGES], DECODE_SHARED_PAGES * PAGE
    qs = q[:3]
    runs = {
        "paged_decode_drop_last_chunk": (
            lambda: decode_parts(q, cache, bt, sl, 4), decode_reference(q, cache, bt, sl)),
        "paged_decode_member0_q": (
            lambda: decode_parts(qs, cache, pages[None], sl[5:6].clamp_max(plen), 4, shared=True),
            decode_reference(qs, cache, pages[None].expand(3, -1),
                             sl[5:6].clamp_max(plen).expand(3))),
    }
    caught = {}
    for name, (run, (ref_out, ref_lse)) in runs.items():
        out, lse = da._merge_splits(*with_library("paged_decode", planted[name], run)())
        torch.cuda.synchronize()
        errs, failed = out_errors(out, ref_out, [("lse", lse, ref_lse)])
        caught[name] = {"failed_checks": failed, **errs}
        check(bool(failed), f"planted fault {name} passes the decode checks: {errs}")
    return caught


# paged_decode at this slice's widths: (head_dim, q heads per kv head, kv
# heads): d 32 at G 1, 4 and 16, then groups past one walk's rows, a GQA
# group of 24 and StarCoder-15B's 48 q heads over 1 kv head, at d 128 and 32
WIDE_DECODE = ((32, 1, 2), (32, 4, 2), (32, 16, 2), (128, 24, 2), (32, 24, 2), (128, 48, 1),
               (32, 48, 1))


def wide_decode_cases(gen) -> dict:
    """``paged_decode`` at head_dim 32 and at 24 and 48 q heads per kv head
    (:data:`WIDE_DECODE`), bf16 and f32, against its plain version
    (``decode_reference``): the flat mode on ragged and zero lengths on
    shuffled pages of 16 and 128 tokens at 1 and 3 splits; the shared mode
    (the cascade's level 1) at 3 and 8 members, against the plain version
    and the flat mode; the one-launch tick's per-row tables (the rows of a
    prefill chunk, each a longer prefix of one sequence's pages); and TP's
    head slices (``tp_decode_attn`` over two slices of a 2-kv-head pool,
    each launch passing the pool's ``cluster_heads``), which must equal the
    one launch bit for bit. Each launch twice for the same bits. Returns the
    summary line."""
    import torch
    from magiattention_tpu_torch.serving import decode_attn as da
    from magiattention_tpu_torch.serving import (
        decode_attn_paged, decode_reference, shard_kv_cache, tp_decode_attn,
    )

    worst = {"out_max_abs_err": 0.0, "lse_max_abs_err": 0.0}
    counts = {"flat": 0, "shared": 0, "tick": 0, "tp_slices_bitwise": 0}

    def held(name, parts, ref):
        out, lse = da._merge_splits(*parts)
        errs, failed = out_errors(out, ref[0], [("lse", lse, ref[1])])
        check(not failed, f"{name}: paged_decode fails the {failed} check(s): {errs}")
        for k in worst:
            worst[k] = max(worst[k], errs.get(k, 0.0))
        MAX_ERR["paged_decode"] = max(MAX_ERR["paged_decode"], errs["out_max_abs_err"])
        return out, lse

    def twice(name, *args, **kw):
        first = decode_parts(*args, **kw)
        check(bitwise(first, decode_parts(*args, **kw)), f"{name}: two runs of paged_decode differ")
        return first

    for dtype in (torch.bfloat16, torch.float32):
        for d, g, hk in WIDE_DECODE:
            for ps in (16, 128):
                full = DECODE_MPP * ps
                lens = [0, 1, ps + 1, 5 * ps + 3, full // 2 + 7, full]
                cache, q = decode_problem(gen, d, dtype, g * hk, hk, ps, lens)
                bt, sl = cache.block_tables, cache.seq_lens
                ref = decode_reference(q, cache, bt, sl)
                tag = f"wide_d{d}_{str(dtype)[6:]}_g{g}_hk{hk}_ps{ps}"
                for splits in (1, 3):
                    held(f"{tag}_splits{splits}", twice(f"{tag}_splits{splits}", q, cache, bt, sl,
                                                        splits), ref)
                    counts["flat"] += 1
                if ps != 128 or g < 24:
                    continue
                # the shared mode: every member reads slot 5's first 12 pages
                w = DECODE_SHARED_PAGES
                pages, plen = bt[5, :w], w * ps - 5
                for members in (3, 8):
                    qm = torch.randn((members, g * hk, d), generator=gen, device="cuda").to(dtype)
                    bt_b = pages[None].expand(members, w).contiguous()
                    sl_b = torch.full((members,), plen, dtype=torch.int32, device="cuda")
                    mref = decode_reference(qm, cache, bt_b, sl_b)
                    for splits in (1, 3):
                        name = f"{tag}_shared_m{members}_splits{splits}"
                        parts = twice(name, qm, cache, pages[None], sl_b[:1], splits, shared=True)
                        out, lse = held(name, parts, mref)
                        flat = da._merge_splits(*decode_parts(qm, cache, bt_b, sl_b, splits))
                        errs, failed = out_errors(out, flat[0], [("lse", lse, flat[1])])
                        check(not failed, f"{name}: the shared mode fails the {failed} "
                              f"check(s) against the flat mode: {errs}")
                        counts["shared"] += 1
                # the tick's per-row tables: 5 rows of a prefill chunk of slot 4
                rows = 5
                bt_r = bt[4:5].expand(rows, -1).contiguous()
                sl_r = (sl[4] - rows + 1 + torch.arange(rows, device="cuda")).int()
                qr = torch.randn((rows, g * hk, d), generator=gen, device="cuda").to(dtype)
                held(f"{tag}_tick", twice(f"{tag}_tick", qr, cache, bt_r, sl_r, 1),
                     decode_reference(qr, cache, bt_r, sl_r))
                counts["tick"] += 1
                if hk == 2:  # TP: two head slices, each launch sized for the pool's 2 kv heads
                    slots = torch.arange(len(lens), device="cuda")
                    one = decode_attn_paged(q, cache, slots, num_splits=1, out_dtype=torch.float32)
                    sc = shard_kv_cache(cache, ["cuda:0", "cuda:0"])
                    tp = tp_decode_attn(q, sc, slots, devices=["cuda:0", "cuda:0"], num_splits=1,
                                        out_dtype=torch.float32)
                    check(bitwise(one, tp), f"{tag}: TP head slices differ from the one launch")
                    counts["tp_slices_bitwise"] += 1
    return {"phase": "kernels", "kernel": "paged_decode", "widths": [list(x) for x in WIDE_DECODE],
            "cases": counts, "two_runs_bitwise_equal": True, **worst}


def wide_decode_planted_faults(gen, planted) -> dict:
    """The checks on the faults planted in the wide decode walks at G 48 (48
    q heads over 1 kv head, d 128), NaN past every length: the bf16 walk
    keeping V's rows past a walk's live tokens, its merge nodes taking their
    first child alone, and the float32 WIDE mode's tiles reading the first
    tile's q. Returns which checks catch each; a fault that passes them
    fails the smoke."""
    import torch
    from magiattention_tpu_torch.serving import decode_attn as da
    from magiattention_tpu_torch.serving import decode_reference

    caught = {}
    lens = [1, 100, PAGE + 1, 1000, 3000, 6000]
    for name, dtype in (("paged_decode_wide_tail_kept", torch.bfloat16),
                        ("paged_decode_wide_first_child", torch.bfloat16),
                        ("paged_decode_simt_first_tile", torch.float32)):
        cache, q = decode_problem(gen, D, dtype, 48, 1, PAGE, lens)
        bt, sl = cache.block_tables, cache.seq_lens
        ref_out, ref_lse = decode_reference(q, cache, bt, sl)
        dirty = nan_past_lengths(cache, lens)
        out, lse = da._merge_splits(*with_library(
            "paged_decode", planted[name], lambda: decode_parts(q, dirty, bt, sl, 1))())
        torch.cuda.synchronize()
        errs, failed = out_errors(out, ref_out, [("lse", lse, ref_lse)])
        caught[name] = {"failed_checks": failed, **errs}
        check(bool(failed), f"planted fault {name} passes the decode checks: {errs}")
    return caught


# the new wide walk's card cases (decode_wide_sm90.cuh): (q heads per kv
# head, kv heads); each at head_dim 32, 64 and 128 on pages of 16, 64 and 128
WIDE_WALK = ((33, 1), (48, 1), (64, 1), (71, 1), (128, 1), (200, 1), (48, 2))


def wide_walk_cases(gen) -> dict:
    """The bf16 wide walk against its plain version (``decode_reference``
    on the clean cache) at every group of :data:`WIDE_WALK` x head_dim 32 /
    64 / 128 x pages of 16 / 64 / 128: ragged tails not a multiple of 64
    (and zero, one and full lengths) with NaN planted past every length in
    the cache the kernel reads; 1, 2 and 4 splits in turn, softcap on at
    pages of 64; each launch twice for the same bits. Then 96 q / 2 kv heads
    (G 48) under ``tp_decode_attn`` at tp 2, bit for bit the one launch, and
    a batch past one launch's walks (``WIDE_MAX_WALKS``) in row blocks.
    Returns the summary line."""
    import torch
    from magiattention_tpu_torch import csrc
    from magiattention_tpu_torch.serving import decode_attn as da
    from magiattention_tpu_torch.serving import (
        decode_attn_paged, decode_reference, shard_kv_cache, tp_decode_attn,
    )

    worst = {"out_max_abs_err": 0.0, "lse_max_abs_err": 0.0}
    cases = 0
    for d in (32, 64, 128):
        for g, hk in WIDE_WALK:
            for i, ps in enumerate((16, 64, 128)):
                mpp = max(24, -(-(700 // ps + 1) // 4) * 4)  # every length below; 4 splits
                lens = [0, 1, 63, ps + 3, 300, 2 * 64 * 5 + 17, mpp * ps]
                cache, q = decode_problem(gen, d, torch.bfloat16, g * hk, hk, ps, lens, mpp=mpp)
                bt, sl = cache.block_tables, cache.seq_lens
                softcap = 30.0 if ps == 64 else 0.0
                splits = (1, 2, 4)[(i + g) % 3]
                ref = decode_reference(q, cache, bt, sl, softcap=softcap)
                dirty = nan_past_lengths(cache, lens)
                name = f"wide_walk_d{d}_g{g}_hk{hk}_ps{ps}_splits{splits}"
                first = decode_parts(q, dirty, bt, sl, splits, softcap)
                check(bitwise(first, decode_parts(q, dirty, bt, sl, splits, softcap)),
                      f"{name}: two runs of paged_decode differ")
                out, lse = da._merge_splits(*first)
                errs, failed = out_errors(out, ref[0], [("lse", lse, ref[1])])
                check(not failed, f"{name}: paged_decode fails the {failed} check(s): {errs}")
                for k in worst:
                    worst[k] = max(worst[k], errs.get(k, 0.0))
                MAX_ERR["paged_decode"] = max(MAX_ERR["paged_decode"], errs["out_max_abs_err"])
                cases += 1
                del cache, dirty
    # TP: 96 q heads over 2 kv heads, two slices each launched for the pool's 2
    lens = [5, 700, 1500, 3001]
    cache, q = decode_problem(gen, D, torch.bfloat16, 96, 2, PAGE, lens, mpp=32)
    slots = torch.arange(len(lens), device="cuda")
    tp_bitwise = 0
    for splits in (1, 2):
        one = decode_attn_paged(q, cache, slots, num_splits=splits, out_dtype=torch.float32)
        sc = shard_kv_cache(cache, ["cuda:0", "cuda:0"])
        tp = tp_decode_attn(q, sc, slots, devices=["cuda:0", "cuda:0"], num_splits=splits,
                            out_dtype=torch.float32)
        check(bitwise(one, tp), f"wide walk, G 48 x 2 kv heads, {splits} split(s): the TP "
              "head slices differ from the one launch")
        tp_bitwise += 1
    # a batch past one launch's walks, in row blocks
    b = da.WIDE_MAX_WALKS + 7
    lens = [1 + (i * 37) % PAGE for i in range(b)]
    cache, q = decode_problem(gen, 64, torch.bfloat16, 48, 1, PAGE, lens, mpp=1)
    bt, sl = cache.block_tables, cache.seq_lens
    launched = csrc.launches["paged_decode"]
    out, lse = da._merge_splits(*decode_parts(q, cache, bt, sl, 1))
    row_blocks = csrc.launches["paged_decode"] - launched
    check(row_blocks == len(da.kernel_row_blocks(b, 48, torch.bfloat16, False)) == 2,
          f"wide walk row blocks: {row_blocks} launches for {b} walks")
    ref = decode_reference(q, cache, bt, sl)
    errs, failed = out_errors(out, ref[0], [("lse", lse, ref[1])])
    check(not failed, f"wide walk row blocks: paged_decode fails the {failed} check(s): {errs}")
    return {"phase": "kernels", "kernel": "paged_decode", "walk": "wide (decode_wide_sm90.cuh)",
            "groups": [list(x) for x in WIDE_WALK], "head_dims": [32, 64, 128],
            "page_sizes": [16, 64, 128], "cases": cases, "nan_past_lengths": True,
            "two_runs_bitwise_equal": True, "tp2_bitwise_equal": tp_bitwise,
            "row_block_launches": row_blocks, **worst}


def simt_decode(lib, q, cache, bt, sl, splits):
    """A launcher of the previous decode walk (the ``decode_simt`` side
    library) on these inputs, checked once against the plain version. A
    yardstick only: nothing here is counted as a launch."""
    import torch
    from magiattention_tpu_torch.serving import decode_attn as da
    from magiattention_tpu_torch.serving import decode_reference

    b, hq, d = q.shape
    out = torch.empty((b, splits, hq, d), device="cuda")
    lse = torch.empty((b, splits, hq), device="cuda")
    bt, sl = bt.int().contiguous(), sl.int().contiguous()

    def run():
        code = lib.simt_paged_decode(
            q.data_ptr(), cache.k_pages.data_ptr(), cache.v_pages.data_ptr(), bt.data_ptr(),
            sl.data_ptr(), out.data_ptr(), lse.data_ptr(), b, hq, cache.num_kv_heads, d,
            cache.page_size, bt.shape[1], splits, 1.0 / math.sqrt(d), 0.0,
            torch.cuda.current_stream().cuda_stream)
        check(code == 0, f"the previous decode walk: CUDA error {code}")

    run()
    torch.cuda.synchronize()
    ref_out, ref_lse = decode_reference(q, cache, bt, sl)
    got_out, got_lse = da._merge_splits(out, lse)
    _, failed = out_errors(got_out, ref_out, [("lse", got_lse, ref_lse)])
    check(not failed, f"the previous decode walk fails the {failed} check(s)")
    return run


def queued_ms(fn, reps: int = 1, repeats: int = 3) -> dict:
    """Device time of ``fn`` with the host kept ahead of the card: a spin
    kernel holds the stream while the host enqueues ``reps`` calls, so the
    CUDA events around them time the device's work back to back, without
    the host's launch gaps (a host-bound call timed with plain events times
    the host). The median of ``repeats`` such windows. ``queue_prefilled``
    says the spin outlasted the enqueueing in every window; where it is
    False the time includes host gaps. Keep ``reps`` times the call's
    kernels well under the launch queue's depth (about a thousand)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    times, enqueue, prefilled = [], [], True
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(2e9 * (2 * one_s * reps + 2e-3)))  # cycles, at most ~2 GHz
        start.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        enqueue.append((time.perf_counter() - t0) * 1e3 / reps)
        prefilled = prefilled and not start.query()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return {"ms": sorted(times)[len(times) // 2],
            "host_enqueue_ms": sorted(enqueue)[len(enqueue) // 2], "queue_prefilled": prefilled}


def decode_bound(tokens: int, b: int, splits: int, table_entries: int, hq: int = HQ,
                 hk: int = HK, d: int = D) -> tuple[float, str]:
    """The card's bound on one bf16 decode launch (default: at the serving
    widths): 4 d FLOPs per cached token and q head; each cached K/V row and
    q read once, each partial written once."""
    flops = 4.0 * tokens * hq * d
    nbytes = (2 * 2 * tokens * hk * d + 2 * b * hq * d
              + 4 * b * splits * hq * (d + 1) + 4 * (table_entries + b))
    return bound(flops, nbytes)


def wide_mma_decode(lib, q, cache, bt, sl, splits):
    """A launcher of the previous wide walk (the ``decode_wide_mma`` side
    library, PR 25's) on these inputs, checked once against the plain
    version. A yardstick only: nothing here is counted as a launch."""
    import torch
    from magiattention_tpu_torch.serving import decode_attn as da
    from magiattention_tpu_torch.serving import decode_reference

    b, hq, d = q.shape
    out = torch.empty((b, splits, hq, d), device="cuda")
    lse = torch.empty((b, splits, hq), device="cuda")
    bt, sl = bt.int().contiguous(), sl.int().contiguous()
    hk = cache.num_kv_heads

    def run():
        code = lib.mma_wide_paged_decode(
            q.data_ptr(), cache.k_pages.data_ptr(), cache.v_pages.data_ptr(), bt.data_ptr(),
            sl.data_ptr(), out.data_ptr(), lse.data_ptr(), b, hq, hk, d, cache.page_size,
            bt.shape[1], splits, hk, 1.0 / math.sqrt(d), 0.0,
            torch.cuda.current_stream().cuda_stream)
        check(code == 0, f"the previous wide walk: CUDA error {code}")

    run()
    torch.cuda.synchronize()
    ref_out, ref_lse = decode_reference(q, cache, bt, sl)
    got_out, got_lse = da._merge_splits(out, lse)
    _, failed = out_errors(got_out, ref_out, [("lse", got_lse, ref_lse)])
    check(not failed, f"the previous wide walk fails the {failed} check(s)")
    return run


# the widths of the decode rows timed at this width: DiTConfig's attention
# (8 q / 4 kv heads of d 32, the cluster walk), and the wide walk at
# StarCoder-15B's 48 q heads over 1 kv head (d 128, and d 32) and Falcon-7B's
# 71 over 1 (d 64), each on the serving prompts' 8 lengths and on those
# lengths four times (32 sequences, where bytes rather than launch latency
# set the bound); the G-48 d-128 row of 8 keeps its name of PR 25
WIDE_DECODE_TIMED = {"d32_bf16": (8, 4, 32, 1), "g48_bf16": (48, 1, 128, 1),
                     "g48_d128_b32": (48, 1, 128, 4), "g48_d32_b8": (48, 1, 32, 1),
                     "g48_d32_b32": (48, 1, 32, 4), "g71_d64_b8": (71, 1, 64, 1),
                     "g71_d64_b32": (71, 1, 64, 4)}
WIDE_DECODE_LENS = (1000, 1733, 2048, 2900, 4096, 5120, 6500, 8000)  # the serving prompts


def wide_decode_timing(gen, planted) -> tuple[dict, dict]:
    """``paged_decode`` at the widths of :data:`WIDE_DECODE_TIMED`, bf16,
    pages of 128, one split: the kernel's time (CUDA events, the stream
    held), where the group takes the wide walk in turns with the previous
    wide walk (``decode_wide_mma``, PR 25's: new, previous, new, previous);
    the plain version's, SDPA over the gathered KV and the card's bound;
    each first held against its plain version. Returns (the line,
    {"paged_decode": {width: record}})."""
    import torch
    import torch.nn.functional as Fn
    from magiattention_tpu_torch.serving import decode_attn as da
    from magiattention_tpu_torch.serving import decode_reference, gather_kv

    line, recs = {"phase": "wide_decode_timing", "card": nvidia_smi_line(),
                  "lengths": list(WIDE_DECODE_LENS)}, {}
    for width, (hq, hk, d, rep) in WIDE_DECODE_TIMED.items():
        lens = WIDE_DECODE_LENS * rep
        cache, q = decode_problem(gen, d, torch.bfloat16, hq, hk, PAGE, lens, mpp=64)
        b = len(lens)
        bt, sl = cache.block_tables, cache.seq_lens
        prm = da.DecodeParams(1.0 / math.sqrt(d), 0.0, 1, torch.bfloat16)
        out, lse = da._merge_splits(*decode_parts(q, cache, bt, sl, 1))
        ref_out, ref_lse = decode_reference(q, cache, bt, sl)
        errs, failed = out_errors(out, ref_out, [("lse", lse, ref_lse)])
        check(not failed, f"wide_decode_timing {width}: paged_decode fails {failed}: {errs}")
        kernel = lambda: da._decode_partials_kernel(q, cache, bt, sl, prm)
        wide = da.takes_wide_walk(hq // hk, torch.bfloat16, False)
        prev = {}
        if wide:
            old = wide_mma_decode(planted["decode_wide_mma"], q, cache, bt, sl, 1)
            turns = [cuda_ms(f, reps=50) for f in (kernel, old, kernel, old)]
            ms = (turns[0] + turns[2]) / 2
            prev = {"previous_walk_ms": (turns[1] + turns[3]) / 2, "turns_ms": turns}
            prev["speedup_over_previous_walk"] = prev["previous_walk_ms"] / ms
        else:
            ms = cuda_ms(kernel, reps=50)
        plain_ms = cuda_ms(lambda: da._decode_torch(q, cache, bt, sl, prm), reps=5, warmup=1)
        lmax = max(lens)
        kv = [gather_kv(cache, s, max_len=lmax) for s in range(b)]
        k = torch.stack([x[0] for x in kv]).transpose(1, 2)  # [b, hk, L, d]
        v = torch.stack([x[1] for x in kv]).transpose(1, 2)
        mask = (torch.arange(lmax, device="cuda")[None] < sl[:, None].long())[:, None, None, :]
        qs = q[:, :, None, :]
        lib_ms = cuda_ms(
            lambda: Fn.scaled_dot_product_attention(qs, k, v, attn_mask=mask, enable_gqa=True),
            reps=50)
        bound_ms, bound_by = decode_bound(sum(lens), b, 1, bt.numel(), hq, hk, d)
        recs[width] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                       "bound_by": bound_by, "library_ms": lib_ms}
        line[width] = {"hq": hq, "hk": hk, "head_dim": d, "batch": b, "walk": "wide" if wide
                       else "cluster", **recs[width], **prev, **errs,
                       "share_of_bound": bound_ms / ms, "vs_library": ms / lib_ms,
                       "library": "scaled_dot_product_attention(enable_gqa, gathered KV)"}
        del cache, k, v, kv
        torch.cuda.empty_cache()
    return line, {"paged_decode": recs}


# the wide walk's main path: a ServingEngine at two multi-query attention
# layouts (q heads, kv heads, head_dim): StarCoder-15B's and Falcon-7B's
WIDE_SERVING = {"starcoder15b": (48, 1, 128), "falcon7b": (71, 1, 64)}
WIDE_SERVING_STEPS = 64  # decode steps of the serving prompts (WIDE_DECODE_LENS)
WIDE_SERVING_VOCAB = 4096  # the greedy loop's toy vocabulary
# a greedy token may differ from the plain decode's only where the plain
# logits' top two lie within this share of their spread (a near tie that the
# kernel's bf16 P, within its bounds, can flip)
WIDE_SERVING_TIE = 1e-2


def wide_serving_layout(seed: int, hq: int, hk: int, d: int) -> dict:
    """One layout of :data:`WIDE_SERVING`: the 8 serving prompts prefilled,
    then :data:`WIDE_SERVING_STEPS` greedy decode steps of all 8, each
    step's next token the argmax of a seeded projection of the decode output
    and its next q / k / v a seeded embedding of that token (the weights
    are random, from ``seed``). Each step's tokens from the kernel's output
    must equal the plain decode's (``decode_reference`` over the same
    cache); ``paged_decode`` must launch once a step. The device ms of a
    step (CUDA events, synchronised) and its host ms (the call's wall
    time, the stream not synchronised), medians over the steps. Every
    step's output is held against the plain decode's within the kernel's
    bounds; the tokens equal the plain decode's but at near ties
    (:data:`WIDE_SERVING_TIE`), which are counted: over 512 greedy choices
    a tie close enough for bf16 P to flip occurs."""
    import torch
    from magiattention_tpu_torch.serving import ServingEngine, decode_reference

    gen = torch.Generator(device="cuda").manual_seed(seed)
    embed = torch.randn((WIDE_SERVING_VOCAB, (hq + 2 * hk) * d), generator=gen, device="cuda")
    proj = torch.randn((hq * d, WIDE_SERVING_VOCAB), generator=gen, device="cuda") / (hq * d) ** 0.5

    def qkv(tokens):
        x = embed[tokens].to(torch.bfloat16).view(len(tokens), hq + 2 * hk, d)
        return (x[:, :hq].contiguous(), x[:, hq:hq + hk].contiguous(),
                x[:, hq + hk:].contiguous())

    pages = sum(-(-(n + WIDE_SERVING_STEPS) // PAGE) for n in WIDE_DECODE_LENS) + 8
    engine = ServingEngine(num_pages=pages, num_kv_heads=hk, head_dim=d, page_size=PAGE,
                           max_seqs=len(WIDE_DECODE_LENS),
                           max_pages_per_seq=-(-(max(WIDE_DECODE_LENS) + WIDE_SERVING_STEPS)
                                               // PAGE), dtype=torch.bfloat16)
    launches, prefill_launches, slots, last = {}, {}, [], []
    worst, near_ties = {"out_max_abs_err": 0.0, "lse_max_abs_err": 0.0}, []
    for n in WIDE_DECODE_LENS:
        prompt = torch.randint(0, WIDE_SERVING_VOCAB, (n,), generator=gen, device="cuda")
        res = engine.admit(n)
        check(res.admitted, f"wide serving: admission {res}")
        out, _ = counted(prefill_launches, lambda: engine.prefill(*qkv(prompt), res.slot))
        last.append(int((out[-1].float().flatten() @ proj).argmax()))
        slots.append(res.slot)
    idx = torch.as_tensor(slots, device="cuda")
    tokens, device_ms, host_ms = [last], [], []
    for _ in range(WIDE_SERVING_STEPS):
        q, k, v = qkv(torch.as_tensor(tokens[-1], device="cuda"))
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        out, lse = counted(launches, lambda: engine.decode_step(q, k, v, slots))
        host_ms.append((time.perf_counter() - t0) * 1e3)
        end.record()
        torch.cuda.synchronize()
        device_ms.append(start.elapsed_time(end))
        ref, ref_lse = decode_reference(q, engine.cache, engine.cache.block_tables[idx],
                                        engine.cache.seq_lens[idx])
        errs, failed = out_errors(out, ref, [("lse", lse, ref_lse)])
        check(not failed, f"wide serving {hq}/{hk} step {len(tokens)}: paged_decode fails the "
              f"{failed} check(s): {errs}")
        for key in worst:
            worst[key] = max(worst[key], errs[key])
        logits, ref_logits = (x.float().flatten(1) @ proj for x in (out, ref))
        got, want = logits.argmax(1).tolist(), ref_logits.argmax(1).tolist()
        for i, (a, w) in enumerate(zip(got, want)):
            if a == w:
                continue
            # bf16 P moves a logit by about 1e-3 of its spread: a token may
            # flip only where the plain decode's top two nearly tie
            margin = float(ref_logits[i, w] - ref_logits[i, a])
            spread = float(ref_logits[i].std())
            check(margin <= WIDE_SERVING_TIE * spread,
                  f"wide serving {hq}/{hk} step {len(tokens)}: kernel token {a} != plain token "
                  f"{w} at a plain margin of {margin / spread:.3g} of the logits' spread")
            near_ties.append({"step": len(tokens), "sequence": i, "margin_over_spread":
                              margin / spread})
        tokens.append(got)
    check(launches.get("paged_decode", 0) == WIDE_SERVING_STEPS,
          f"wide serving {hq}/{hk}: decode launches {launches}")
    del engine
    torch.cuda.empty_cache()
    med = lambda xs: sorted(xs)[len(xs) // 2]
    return {"layout": {"hq": hq, "hk": hk, "head_dim": d, "page_size": PAGE},
            "prompts": list(WIDE_DECODE_LENS), "steps": WIDE_SERVING_STEPS,
            "tokens": len(WIDE_DECODE_LENS) * WIDE_SERVING_STEPS,
            "tokens_equal_plain": len(WIDE_DECODE_LENS) * WIDE_SERVING_STEPS - len(near_ties),
            "near_ties": near_ties, "last_tokens": tokens[-1], **worst,
            "decode_device_ms_per_step": med(device_ms), "decode_host_ms_per_step": med(host_ms),
            "decode_launches": launches, "prefill_launches": prefill_launches}


def wide_serving(seed: int) -> dict:
    """The wide walk's main path at each layout of :data:`WIDE_SERVING`;
    its launches are the two layouts' prefills' and decode steps'."""
    line = {"phase": "wide_serving", "card": nvidia_smi_line()}
    launches = {}
    for name, (hq, hk, d) in WIDE_SERVING.items():
        line[name] = wide_serving_layout(seed, hq, hk, d)
        for part in ("decode_launches", "prefill_launches"):
            for n, c in line[name][part].items():
                launches[n] = launches.get(n, 0) + c
    line["launches"] = launches
    return line


def split_sweep(q, cache, bt, seq_lens) -> dict:
    """The kernel alone (CUDA events) and the kernel with ``merge_partials``
    as a decode step runs them (device time, queue pre-filled), at each
    split count of DECODE_SWEEP that divides the table width."""
    import torch
    from magiattention_tpu_torch.serving import decode_attn as da

    sweep = {}
    for s in DECODE_SWEEP:
        if bt.shape[1] % s:
            continue
        prm = da.DecodeParams(1.0 / math.sqrt(D), 0.0, s, torch.bfloat16)
        sweep[s] = {
            "kernel_ms": cuda_ms(lambda: da._decode_partials_kernel(q, cache, bt, seq_lens, prm),
                                 reps=50),
            "kernel_and_merge": queued_ms(lambda: da._decode(q, cache, bt, seq_lens, prm)),
        }
    return sweep


def decode_timing(engine, slots, gen, planted) -> dict:
    """On the serving path's final batch state: the kernel at the resolved
    split count in turns with the previous walk at the split count its rule
    gave (new, old, old, new), and both at that count; the split sweep on
    this batch and on one 32K-token sequence; the plain version, SDPA over
    the gathered KV, and the card's bound for that work."""
    import torch
    import torch.nn.functional as Fn
    from magiattention_tpu_torch.serving import decode_attn as da
    from magiattention_tpu_torch.serving import gather_kv

    cache = engine.cache
    b = len(slots)
    idx = torch.as_tensor(slots, device="cuda")
    bt, seq_lens = cache.block_tables[idx], cache.seq_lens[idx]
    splits = da.resolve_num_splits(None, cache, b, HQ)
    # the previous rule: enough splits for two thread blocks an SM
    prev_splits = da._clamp_splits(-(-2 * 132 // (b * HK)), bt.shape[1])

    def kernel(s):
        prm = da.DecodeParams(1.0 / math.sqrt(D), 0.0, s, torch.bfloat16)
        return lambda: da._decode_partials_kernel(q, cache, bt, seq_lens, prm)

    q = torch.randn((b, HQ, D), generator=gen, device="cuda").to(torch.bfloat16)
    old = simt_decode(planted["decode_simt"], q, cache, bt, seq_lens, prev_splits)
    samples = {"new": [], "previous": [], f"new_at_{prev_splits}_splits": []}
    for which, fn in (("new", kernel(splits)), ("previous", old),
                      (f"new_at_{prev_splits}_splits", kernel(prev_splits)),
                      (f"new_at_{prev_splits}_splits", kernel(prev_splits)),
                      ("previous", old), ("new", kernel(splits))):
        samples[which].append(cuda_ms(fn, reps=50))
    mean = {k: sum(v) / len(v) for k, v in samples.items()}
    ms, prev_ms = mean["new"], mean["previous"]
    sweep = split_sweep(q, cache, bt, seq_lens)
    long_cache = decode_cache(gen, [32 * 1024 - 64], mpp=256)
    q1 = q[:1].contiguous()
    long_sweep = split_sweep(q1, long_cache, long_cache.block_tables[:1], long_cache.seq_lens[:1])
    plain_ms = cuda_ms(lambda: da._decode_torch(
        q, cache, bt, seq_lens, da.DecodeParams(1.0 / math.sqrt(D), 0.0, splits, torch.bfloat16)),
        reps=5, warmup=1)
    lens = [engine.length(s) for s in slots]
    lmax = max(lens)
    kv = [gather_kv(cache, s, max_len=lmax) for s in slots]
    k = torch.stack([x[0] for x in kv]).transpose(1, 2)  # [b, hk, L, d]
    v = torch.stack([x[1] for x in kv]).transpose(1, 2)
    mask = (torch.arange(lmax, device="cuda")[None] < seq_lens[:, None].long())[:, None, None, :]
    qs = q[:, :, None, :]
    lib_ms = cuda_ms(
        lambda: Fn.scaled_dot_product_attention(qs, k, v, attn_mask=mask, enable_gqa=True),
        reps=50,
    )
    tokens = sum(lens)
    bound_ms, bound_by = decode_bound(tokens, b, splits, bt.numel())
    return {"card": nvidia_smi_line(), "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lib_ms, "splits": splits,
            "cached_tokens": tokens, "ms_in_turns": samples,
            "previous_walk": {"splits": prev_splits, "ms": prev_ms},
            f"new_at_{prev_splits}_splits_ms": mean[f"new_at_{prev_splits}_splits"],
            "speedup_over_previous_walk": prev_ms / ms, "share_of_bound": bound_ms / ms,
            "split_sweep": sweep,
            "split_sweep_one_sequence": {
                "cached_tokens": int(long_cache.seq_lens[0]),
                "bound_ms": decode_bound(int(long_cache.seq_lens[0]), 1, 1, 256)[0],
                "sweep": long_sweep}}


# -- the serving path ----------------------------------------------------------


def plain_causal_prefill(q, k, v):
    """The plain version of a causal prefill ([t, h, d] layout): the rows of
    ``q`` are the last ``len(q)`` positions of the prompt whose keys are
    ``k`` (bottom-right aligned causal, as a continued prefill attends)."""
    from magiattention_tpu_torch.ops import flex_attn as fa

    t, tk = q.shape[0], k.shape[0]
    bq, bk = fa.resolve_tile(D, None, None)
    meta = fa.build_block_meta([(0, t)], [(0, tk)], [1], t, tk, block_q=bq, block_k=bk)
    params = fa.FlexAttnParams(bq, bk, 1.0 / math.sqrt(D), 0.0, False, q.dtype)
    sink = q.new_zeros((q.shape[1],), dtype=q.dtype).float()
    out, lse, _ = fa._fwd_torch(
        fa._pad_tokens(q.transpose(0, 1), meta.num_q_blocks * bq),
        fa._pad_tokens(k.transpose(0, 1), meta.num_k_blocks * bk),
        fa._pad_tokens(v.transpose(0, 1), meta.num_k_blocks * bk), sink,
        fa.fwd_tables(meta, str(q.device)), params,
    )
    return out.transpose(0, 1)[:t], lse.transpose(0, 1)[:t]


def serving(gen, hq=None, hk=None, prompts=(1000, 1733, 2048, 2900, 4096, 5120, 6500, 8000),
            chunked=3, steps=64, phase="serving") -> tuple[dict, object, list[int]]:
    """The serving path at ``hq`` / ``hk`` heads: admit the prompts, prefill
    them (prompt ``chunked`` in 2048-token chunks) with the automatic kernel
    choice, run ``steps`` decode steps over the batch; every forward must
    launch the chosen kernel (``flex_fwd_hb`` at head_block G > 1,
    ``flex_fwd`` at G = 1) and no other flex kernel."""
    import torch
    from magiattention_tpu_torch import csrc
    from magiattention_tpu_torch.ops import flex_attn as fa
    from magiattention_tpu_torch.serving import ServingEngine, decode_reference

    hq, hk = hq or HQ, hk or HK
    g = hq // hk
    choice = fa.auto_kernel_config([(0, prompts[0])], [(0, prompts[0])], hq, hk,
                                   attn_type_map=[1], head_dim=D)
    check(choice == (64, 64, g, "row_major"),
          f"{phase}: the causal prefill's choice is {choice}, not (64, 64, {g}, 'row_major')")
    fwd = "flex_fwd_hb" if g > 1 else "flex_fwd"
    engine = ServingEngine(num_pages=1024, num_kv_heads=hk, head_dim=D, page_size=PAGE,
                           max_seqs=16, max_pages_per_seq=64, dtype=torch.bfloat16)
    csrc.reset_launch_counts()
    slots, prefill_ms, prefill_split, checked = [], [], [], []
    for i, t in enumerate(prompts):
        res = engine.admit(t)
        check(res.admitted, f"admission of a {t}-token prompt refused: {res.reason}")
        q = torch.randn((t, hq, D), generator=gen, device="cuda").to(torch.bfloat16)
        kv = torch.randn((2, t, hk, D), generator=gen, device="cuda").to(torch.bfloat16)
        if i == chunked:
            os.environ["MAGI_ATTENTION_PREFILL_CHUNK"] = "2048"
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with host_split() as spent:
                out, lse = engine.prefill(q, kv[0], kv[1], res.slot)
                torch.cuda.synchronize()
            prefill_ms.append((time.perf_counter() - t0) * 1e3)
            prefill_split.append({**spent, "rest": prefill_ms[-1] - spent["plan"]
                                  - spent["table_upload"]})
        finally:
            os.environ.pop("MAGI_ATTENTION_PREFILL_CHUNK", None)
        check(out.shape == (t, hq, D) and bool(torch.isfinite(out).all()),
              f"prefill {t}: bad output")
        if t <= 4096:
            ref_out, ref_lse = plain_causal_prefill(q, kv[0], kv[1])
            compare(fwd, f"{phase}_prefill_{t}" + ("_chunked" if i == chunked else ""),
                    out, ref_out, lse, ref_lse)
            checked.append(t)
        slots.append(res.slot)

    step_ms = []
    for step in range(steps):
        q = torch.randn((len(slots), hq, D), generator=gen, device="cuda").to(torch.bfloat16)
        kv = torch.randn((2, len(slots), hk, D), generator=gen, device="cuda").to(torch.bfloat16)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, lse = engine.decode_step(q, kv[0], kv[1], slots)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        check(bool(torch.isfinite(out).all()), f"decode step {step}: non-finite out")
        if step % 8 == 0:
            idx = torch.as_tensor(slots, device="cuda")
            ref_out, ref_lse = decode_reference(
                q, engine.cache, engine.cache.block_tables[idx], engine.cache.seq_lens[idx])
            compare("paged_decode", f"{phase}_decode_step{step}", out, ref_out, lse, ref_lse)
    lengths = [engine.length(s) for s in slots]
    check(lengths == [t + steps for t in prompts], f"final lengths {lengths}")
    launches = {n: csrc.launches[n] for n in (*FLEX_KERNELS, "paged_decode") if csrc.launches[n]}
    forwards = len(prompts) + math.ceil(prompts[chunked] / 2048) - 1
    check(launches.get("paged_decode", 0) > 0 and launches.get(fwd) == forwards
          and set(launches) == {fwd, "paged_decode"},
          f"{phase} launches {launches}: expected {forwards} of {fwd} (one per forward), "
          "paged_decode, and no other kernel")
    decode_s = sum(step_ms) / 1e3
    summary = {
        "phase": phase,
        "heads": {"hq": hq, "hk": hk, "head_dim": D},
        "choice": dict(zip(("block_q", "block_k", "head_block", "grid"), choice)),
        "prompts": list(prompts),
        "prefill_ms": prefill_ms,
        # each prefill's host ms in the plan builder, the tables' upload and the rest
        "prefill_split_ms": prefill_split,
        "prefill_checked_tokens": checked,
        "decode_steps": steps,
        "decode_batch": len(slots),
        "decode_ms_per_step": sum(step_ms) / steps,
        "decode_ms_per_step_after_first": sum(step_ms[1:]) / (steps - 1),
        "decode_tokens_per_s": len(slots) * steps / decode_s,
        "launches": launches,
        "pages_in_use": engine.allocator.pages_in_use,
    }
    return summary, engine, slots


# -- shared-prefix serving ----------------------------------------------------------

PREFIX_LEN = 4000  # 31 full pages of 128 tokens and a 32-token tail
PREFIX_SUFFIXES = (300, 512, 777, 1024, 1500, 1800, 2000)
PREFIX_CHUNKED = 4  # the 1500-token suffix is prefilled in 512-token chunks
PREFIX_CHUNK = 512
PREFIX_STEPS = 32
VOCAB = 128256  # Llama-3.1-8B's vocabulary: the token ids the trie hashes


def prefix(gen) -> dict:
    """Shared-prefix serving through ``ServingEngine``'s defaults: one
    registrant prompt, 7 requests forking onto its pages, cascade decode.
    Every prefill row is held against the plain causal attention over its
    whole prompt, the first decode step's cascade ``auto`` and ``on``
    against the flat path and the plain decode."""
    import torch
    from magiattention_tpu_torch import csrc
    from magiattention_tpu_torch.serving import ServingEngine, plan_cascade_groups
    from magiattention_tpu_torch.serving import decode_attn as da

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    full = PREFIX_LEN // PAGE
    engine = ServingEngine(num_pages=1024, num_kv_heads=HK, head_dim=D, page_size=PAGE,
                           max_seqs=16, max_pages_per_seq=64, dtype=torch.bfloat16)
    ids = torch.randint(0, VOCAB, (PREFIX_LEN + sum(PREFIX_SUFFIXES),), generator=gen,
                        device="cuda").tolist()
    system, rest = ids[:PREFIX_LEN], ids[PREFIX_LEN:]
    k_sys, v_sys = rand(PREFIX_LEN, HK, D), rand(PREFIX_LEN, HK, D)
    csrc.reset_launch_counts()

    def timed_prefill(q, k, v, slot):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, lse = engine.prefill(q, k, v, slot)
        torch.cuda.synchronize()
        return out, lse, (time.perf_counter() - t0) * 1e3

    res = engine.admit(PREFIX_LEN, tokens=system)
    check(res.admitted and res.prefix_len == 0, f"prefix: registrant admission {res}")
    q = rand(PREFIX_LEN, HQ, D)
    out, lse, registrant_ms = timed_prefill(q, k_sys, v_sys, res.slot)
    ref_out, ref_lse = plain_causal_prefill(q, k_sys, v_sys)
    compare("flex_fwd_hb", f"prefix_registrant_{PREFIX_LEN}", out, ref_out, lse, ref_lse)
    slots, suffix_ms = [res.slot], []
    tail_page = engine.allocator.slot_pages(res.slot)[full]
    for i, n in enumerate(PREFIX_SUFFIXES):
        toks, rest = system + rest[:n], rest[n:]
        res = engine.admit(len(toks), tokens=toks)
        check(res.admitted and res.prefix_len == PREFIX_LEN,
              f"prefix: request {i} admitted as {res}, not with prefix_len {PREFIX_LEN}")
        q, k, v = rand(n, HQ, D), rand(n, HK, D), rand(n, HK, D)
        if i == PREFIX_CHUNKED:
            os.environ["MAGI_ATTENTION_PREFILL_CHUNK"] = str(PREFIX_CHUNK)
        try:
            out, lse, ms = timed_prefill(q, k, v, res.slot)
        finally:
            os.environ.pop("MAGI_ATTENTION_PREFILL_CHUNK", None)
        suffix_ms.append(ms)
        ref_out, ref_lse = plain_causal_prefill(q, torch.cat([k_sys, k]), torch.cat([v_sys, v]))
        compare("flex_fwd_hb", f"prefix_suffix_{n}" + ("_chunked" if i == PREFIX_CHUNKED else ""),
                out, ref_out, lse, ref_lse)
        pages = engine.allocator.slot_pages(res.slot)
        check(pages[:full] == engine.allocator.slot_pages(slots[0])[:full]
              and pages[full] != tail_page,
              f"prefix: request {i} does not share the 31 full pages or kept the shared tail")
        slots.append(res.slot)
    # the copy-on-write splits left the registrant's tail page as it wrote it
    tail = PREFIX_LEN - full * PAGE
    check(torch.equal(engine.cache.k_pages[tail_page, :tail], k_sys[full * PAGE:])
          and torch.equal(engine.cache.v_pages[tail_page, :tail], v_sys[full * PAGE:]),
          "prefix: a fork's write changed the registrant's tail page")
    pages_after_prefill = engine.allocator.pages_in_use
    lengths = [PREFIX_LEN + n for n in (0, *PREFIX_SUFFIXES)]
    flat_pages = sum(engine.allocator.pages_needed(t) for t in lengths)
    check(flat_pages - pages_after_prefill >= len(PREFIX_SUFFIXES) * full,
          f"prefix: {pages_after_prefill} pages in use, a flat engine's {flat_pages}: "
          f"fewer than {len(PREFIX_SUFFIXES) * full} saved")
    groups = plan_cascade_groups(engine._slot_prefix, slots)
    check(len(groups) == 1 and len(groups[0].members) == len(slots)
          and len(groups[0].shared_pages) == full,
          f"prefix: cascade groups {[(len(g.shared_pages), g.members) for g in groups]}")

    # the kernel's shared-mode launches (the cascade's level 1), counted on
    # their own beside csrc.launches
    real_partials, shared_launches = da._decode_partials_kernel, [0]

    def counting_partials(*args, shared=False, **kw):
        shared_launches[0] += int(shared)
        return real_partials(*args, shared=shared, **kw)

    da._decode_partials_kernel = counting_partials
    try:
        return prefix_decode(gen, engine, slots, groups, lengths, rand, shared_launches, {
            "registrant_prefill_ms": registrant_ms,
            "suffix_prefill_ms": suffix_ms,
            "pages_in_use_after_prefill": pages_after_prefill,
            "flat_engine_pages": flat_pages,
            "pages_saved": flat_pages - pages_after_prefill,
        })
    finally:
        da._decode_partials_kernel = real_partials


def prefix_decode(gen, engine, slots, groups, lengths, rand, shared_launches, line) -> dict:
    """The prefix phase's decode: the first step three ways on one state
    (cascade ``auto``, ``on`` and flat, each against the plain decode, the
    cascade against the flat path), then the rest of the steps with cascade
    ``auto``; the decode attention alone on the final state, cascade
    against flat, on the host clock and in device time."""
    import torch
    from magiattention_tpu_torch import csrc, env
    from magiattention_tpu_torch.serving import (
        cascade_decode_attn, decode_attn_paged, decode_reference,
    )
    from magiattention_tpu_torch.serving import decode_attn as da

    full = PREFIX_LEN // PAGE
    # the first step three ways on one state: cascade auto, on, and flat
    seq_lens, host_lens = engine.cache.seq_lens.clone(), dict(engine._lengths)
    q, k, v = rand(len(slots), HQ, D), rand(len(slots), HK, D), rand(len(slots), HK, D)
    first = {}
    for mode in ("auto", "on", "off"):
        engine.cache.seq_lens.copy_(seq_lens)
        engine._lengths.update(host_lens)
        first[mode] = engine.decode_step(q, k, v, slots, cascade=mode)
    torch.cuda.synchronize()
    idx = torch.as_tensor(slots, device="cuda")
    ref_out, ref_lse = decode_reference(q, engine.cache, engine.cache.block_tables[idx],
                                        engine.cache.seq_lens[idx])
    for mode, (out, lse) in first.items():
        compare("paged_decode", f"prefix_decode_step0_cascade_{mode}", out, ref_out, lse, ref_lse)
    for mode in ("auto", "on"):
        compare("paged_decode", f"prefix_decode_step0_cascade_{mode}_vs_flat", first[mode][0],
                first["off"][0], first[mode][1], first["off"][1])
    step_ms = []
    for step in range(1, PREFIX_STEPS):
        q, k, v = rand(len(slots), HQ, D), rand(len(slots), HK, D), rand(len(slots), HK, D)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, lse = engine.decode_step(q, k, v, slots)  # MAGI_ATTENTION_CASCADE, default auto
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if step % 8 == 0:
            ref_out, ref_lse = decode_reference(q, engine.cache, engine.cache.block_tables[idx],
                                                engine.cache.seq_lens[idx])
            compare("paged_decode", f"prefix_decode_step{step}", out, ref_out, lse, ref_lse)
    check([engine.length(s) for s in slots] == [t + PREFIX_STEPS for t in lengths],
          f"prefix: final lengths {[engine.length(s) for s in slots]}")
    launches = {n: csrc.launches[n] for n in (*FLEX_KERNELS, "paged_decode") if csrc.launches[n]}
    forwards = 1 + len(PREFIX_SUFFIXES) + math.ceil(PREFIX_SUFFIXES[PREFIX_CHUNKED] / PREFIX_CHUNK) - 1
    check(launches.get("flex_fwd_hb") == forwards and launches.get("paged_decode", 0) > 0
          and set(launches) == {"flex_fwd_hb", "paged_decode"},
          f"prefix launches {launches}: expected {forwards} of flex_fwd_hb, paged_decode, "
          "and no other kernel")
    # cascade auto and on ran level 1 in the shared mode: the first step's
    # two cascades and the PREFIX_STEPS - 1 steps after it, one group each
    check(shared_launches[0] == PREFIX_STEPS + 1,
          f"prefix: {shared_launches[0]} shared-mode launches, not {PREFIX_STEPS + 1}")
    shared_on_main_path = shared_launches[0]
    # the decode attention alone on the final state, cascade against flat,
    # in turns (host clock, synchronised: what a decode step pays for it)
    attn = {"cascade": lambda: cascade_decode_attn(q, engine.cache, slots, groups),
            "flat": lambda: decode_attn_paged(q, engine.cache, idx)}
    attn_ms = {name: [] for name in attn}
    for name in ("cascade", "flat", "flat", "cascade"):
        attn[name]()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            attn[name]()
        torch.cuda.synchronize()
        attn_ms[name].append((time.perf_counter() - t0) * 1e2)
    device_ms = {name: [] for name in attn}
    for name in ("cascade", "flat", "flat", "cascade"):
        device_ms[name].append(queued_ms(attn[name], reps=3))
    # level 1 alone on the final state: the kernel's shared mode against its
    # flat mode over the broadcast table (what level 1 ran before the shared
    # mode), one split, with the bytes each must read
    g = groups[0]
    pages = torch.as_tensor(g.shared_pages, dtype=torch.int32, device="cuda")[None]
    qg = q[torch.as_tensor(g.members, device="cuda")]
    members = len(g.members)
    sl1 = torch.full((1,), g.prefix_len, dtype=torch.int32, device="cuda")
    prm = da.DecodeParams(1.0 / math.sqrt(D), 0.0, 1, torch.bfloat16)
    kv_bytes = 2 * 2 * g.prefix_len * HK * D
    level1 = {
        "shared_mode_ms": cuda_ms(lambda: da._decode_partials_kernel(
            qg, engine.cache, pages, sl1, prm, shared=True), reps=50),
        "broadcast_table_ms": cuda_ms(lambda: da._decode_partials_kernel(
            qg, engine.cache, pages.expand(members, -1).contiguous(),
            sl1.expand(members).contiguous(), prm), reps=50),
        "shared_mode_kv_bytes": kv_bytes,
        "broadcast_table_kv_bytes": members * kv_bytes,
        "shared_mode_bound_ms": bound(4.0 * g.prefix_len * HQ * D * members, kv_bytes)[0],
    }
    decode_s = sum(step_ms) / 1e3
    return {
        "phase": "prefix",
        "card": nvidia_smi_line(),
        "heads": {"hq": HQ, "hk": HK, "head_dim": D, "page_size": PAGE},
        "prefix_tokens": PREFIX_LEN, "shared_full_pages": full, "suffixes": list(PREFIX_SUFFIXES),
        "chunked_suffix": {"tokens": PREFIX_SUFFIXES[PREFIX_CHUNKED], "chunk": PREFIX_CHUNK},
        **line,
        "pages_in_use_after_decode": engine.allocator.pages_in_use,
        "cascade_mode": env.cascade_mode(),
        "cascade_groups": [{"members": len(g.members), "shared_pages": len(g.shared_pages)}
                           for g in groups],
        "decode_steps": PREFIX_STEPS,
        "decode_batch": len(slots),
        "decode_ms_per_step_cascade_auto_steps_2_to_32": sum(step_ms) / len(step_ms),
        "decode_tokens_per_s": len(slots) * len(step_ms) / decode_s,
        "decode_attention_ms_final_state_in_turns": attn_ms,
        "decode_attention_device_ms_final_state_in_turns": device_ms,
        "level1_kernel_final_state": level1,
        "launches": launches,
        "paged_decode_shared_mode_launches": shared_on_main_path,
    }


# -- the training path ---------------------------------------------------------


TRAIN_LAYERS = 4  # cut from the config's 16 to keep the smoke within its time
TRAIN_DOCS = [4096, 2048, 2048]  # one 8192-token stream, three documents
TRAIN_STEPS = 6
ADAMW = dict(lr=3e-4, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)  # optax.adamw's


def attention_check(model, cap) -> None:
    """One layer's attention call from the first step against the plain
    forward and backward on the card: its q, k, v, the forward's out and lse,
    the dout that reached it and the dq, dk, dv it gave back."""
    import torch
    from magiattention_tpu_torch.ops import flex_attn as fa

    meta, cfg = model.meta, model.cfg
    tqp, tkp = meta.num_q_blocks * meta.block_q, meta.num_k_blocks * meta.block_k
    t = cap["q"].shape[0]

    def head_major(x, tp):
        return fa._pad_tokens(x.transpose(0, 1), tp)

    q, out, do = (head_major(cap[n], tqp) for n in ("q", "out", "dout"))
    k, v = (head_major(cap[n], tkp) for n in ("k", "v"))
    params = fa.FlexAttnParams(meta.block_q, meta.block_k, 1.0 / math.sqrt(cfg.head_dim),
                               0.0, False, cfg.torch_dtype)
    ftab, btab = fa.fwd_tables(meta, "cuda:0"), fa.bwd_tables(meta, "cuda:0")
    sink = torch.zeros((q.shape[0],), device="cuda")
    ref_out, ref_lse, _ = fa._fwd_torch(q, k, v, sink, ftab, params)
    compare("flex_fwd_hb", "training_layer0_step0", cap["out"], ref_out[:, :t].transpose(0, 1),
            cap["lse"], ref_lse[:, :t].transpose(0, 1))
    # the model does not use lse: its cotangent is 0, delta_eff = sum dout * out
    lse = head_major(cap["lse"], tqp)
    delta = (do.float() * out.float()).sum(-1)
    ref_dq = fa._dq_torch(q, k, v, do, lse, delta, ftab, params)
    compare_grads("flex_dq", "training_layer0_step0",
                  [("dq", cap["dq"].transpose(0, 1), ref_dq[:, :t])])
    ref_dk, ref_dv = fa._dkv_torch(q, k, v, do, lse, delta, btab, params)
    compare_grads("flex_dkv", "training_layer0_step0",
                  [("dk", cap["dk"].transpose(0, 1), ref_dk[:, :t]),
                   ("dv", cap["dv"].transpose(0, 1), ref_dv[:, :t])])


KERNEL_GROUPS = (  # kernel-name fragments -> the layer a step's device time goes to
    ("attention kernels", ("flex_fwd_kernel", "flex_fwd_hb_kernel", "flex_dq_kernel",
                           "flex_dkv_kernel")),
    ("matrix products", ("gemm", "nvjet", "xmma", "cutlass")),
    ("optimizer", ("multi_tensor", "adam")),
)


def profile_step(step, batch) -> dict:
    """One more train step under ``torch.profiler``: device time by kernel
    group, the step's host-clock time, and the device's idle share of it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(*batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # kernels only: a GPU user annotation (e.g. "Optimizer.step#AdamW.step")
    # spans kernels that are counted on their own
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
               and not getattr(e, "is_user_annotation", False)]
    groups = {name: 0.0 for name, _ in KERNEL_GROUPS}
    groups["other kernels"] = 0.0
    for e in kernels:
        ms = e.self_device_time_total / 1e3
        group = next((n for n, frags in KERNEL_GROUPS
                      if any(f in e.key.lower() for f in frags)), "other kernels")
        groups[group] += ms
    device_ms = sum(groups.values())
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    return {
        "wall_ms": wall_ms,
        "device_ms": device_ms,
        "device_idle_share": 1.0 - device_ms / wall_ms if device_ms else None,
        "device_ms_by_group": groups,
        "top_kernels_ms": [[e.key[:80], e.self_device_time_total / 1e3, e.count] for e in top],
    }


def training(seed: int, grads_path: str) -> dict:
    import torch
    from magiattention_tpu_torch import csrc
    from magiattention_tpu_torch.api import infer_varlen_mask_from_batch
    from magiattention_tpu_torch.models import LlamaConfig, build_magi_llama, make_model_train_step
    from magiattention_tpu_torch.ops import flex_attn_with_meta

    full = LlamaConfig()
    cfg = dataclasses.replace(full, n_layers=TRAIN_LAYERS)
    total = sum(TRAIN_DOCS)
    qr, kr, ts = infer_varlen_mask_from_batch(TRAIN_DOCS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build_magi_llama(cfg, total, qr, kr, ts, seed=seed)  # the card, by default
    choice = (model.meta.block_q, model.meta.block_k, model.head_block)
    check(choice == (64, 64, cfg.n_heads // cfg.n_kv_heads),
          f"training: the harness's blocking is {choice}, not (64, 64, G)")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (total,), generator=gen, device="cuda")
    labels = torch.roll(tokens, -1)  # the next token
    pos = torch.arange(total, device="cuda")  # global position ids
    step = make_model_train_step(model, torch.optim.AdamW(model.parameters(), **ADAMW))

    cap = {}

    def capture(q, k, v):
        """The model's attention, holding on to the first call's operands,
        results and gradients (no extra launch)."""
        out, lse = flex_attn_with_meta(q, k, v, model.meta, out_dtype=cfg.torch_dtype,
                                       head_block=model.head_block)
        if not cap:
            cap.update(q=q.detach(), k=k.detach(), v=v.detach(), out=out.detach(), lse=lse.detach())
            for name, x in (("dq", q), ("dk", k), ("dv", v), ("dout", out)):
                x.register_hook(lambda g, name=name: cap.__setitem__(name, g))
        return out

    losses, step_ms = [], []
    csrc.reset_launch_counts()
    for i in range(TRAIN_STEPS):
        if i == 0:
            model.attention = capture  # shadows the method for the first step
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = float(step(tokens, labels, pos))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
        if i == 0:
            del model.attention
            # the first step's gradients, for the cp_training phase to hold its own against
            torch.save([p.grad.detach().cpu() for p in model.parameters()], grads_path)
    launches = {n: csrc.launches[n] for n in FLEX_KERNELS if csrc.launches[n]}
    peak = torch.cuda.max_memory_allocated()
    expected = TRAIN_LAYERS * TRAIN_STEPS
    check(launches == {n: expected for n in TRAINING_KERNELS},
          f"training launches {launches}, expected {expected} of each of {TRAINING_KERNELS} "
          "and no other flex kernel")
    check(all(math.isfinite(x) for x in losses), f"non-finite loss: {losses}")
    check(losses[-1] < losses[0], f"the loss did not fall on a fixed batch: {losses}")
    check(set(cap) == {"q", "k", "v", "out", "lse", "dq", "dk", "dv", "dout"},
          f"the first step's attention call captured only {sorted(cap)}")
    attention_check(model, cap)
    # a seventh step, after the six counted ones, under the profiler
    profile = profile_step(step, (tokens, labels, pos))
    med = sorted(step_ms[1:])[len(step_ms[1:]) // 2]
    del cap, step, model  # the remat run's peak counts its own model only
    remat = remat_training(cfg, (total, qr, kr, ts), seed, (tokens, labels, pos), losses)
    return {
        "phase": "training",
        "config": {**dataclasses.asdict(cfg), "n_layers_full": full.n_layers},
        "cut": f"n_layers {full.n_layers} -> {TRAIN_LAYERS} (depth only; every width as configured)",
        "choice": {"block_q": choice[0], "block_k": choice[1], "head_block": choice[2],
                   "grid": "row_major"},
        "docs": TRAIN_DOCS,
        "tokens_per_step": total,
        "optimizer": {"AdamW": {**ADAMW, "betas": list(ADAMW["betas"])}},
        "losses": losses,
        "step_ms": step_ms,
        "median_step_ms_steps_2_to_6": med,
        "tokens_per_s": total / (med / 1e3),
        "max_memory_allocated_bytes": peak,
        "launches": launches,
        "profiled_extra_step": profile,
        "remat": {**remat, "remat_off": {"median_step_ms_steps_2_to_6": med,
                                         "peak_gb": peak / 1e9}},
    }


def remat_training(cfg, mask, seed: int, batch, losses_off) -> dict:
    """The training run again with ``cfg.remat`` (each decoder layer under
    ``torch.utils.checkpoint``): the same weights from ``seed``, the same
    batch and TRAIN_STEPS AdamW steps. Its losses must equal the plain run's
    bit for bit (the kernels are deterministic, and the backward recomputes
    each layer from the same input); each step runs one more ``flex_fwd_hb``
    a layer, the recompute. The launch counts are zeroed just before it."""
    import torch
    from magiattention_tpu_torch import csrc
    from magiattention_tpu_torch.models import build_magi_llama, make_model_train_step

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build_magi_llama(dataclasses.replace(cfg, remat=True), *mask, seed=seed)
    step = make_model_train_step(model, torch.optim.AdamW(model.parameters(), **ADAMW))
    losses, step_ms = [], []
    csrc.reset_launch_counts()
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(step(*batch)))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = {n: csrc.launches[n] for n in FLEX_KERNELS if csrc.launches[n]}
    peak = torch.cuda.max_memory_allocated()
    per_run = TRAIN_LAYERS * TRAIN_STEPS
    check(launches == {"flex_fwd_hb": 2 * per_run, "flex_dq": per_run, "flex_dkv": per_run},
          f"remat training launches {launches}, expected {2 * per_run} flex_fwd_hb (forward and "
          f"recompute) and {per_run} flex_dq and flex_dkv")
    check(losses == losses_off, f"remat losses {losses} differ from the plain run's {losses_off}")
    del step, model
    torch.cuda.empty_cache()
    med = sorted(step_ms[1:])[len(step_ms[1:]) // 2]
    return {"losses": losses, "losses_equal_bitwise": True, "step_ms": step_ms,
            "median_step_ms_steps_2_to_6": med, "max_memory_allocated_bytes": peak,
            "peak_gb": peak / 1e9, "launches": launches,
            "extra_flex_fwd_hb_per_step": (launches["flex_fwd_hb"] - per_run) / TRAIN_STEPS}


# -- the heterogeneous-mask path ---------------------------------------------------

def in_rank(fn):
    """A rank task that hands its cached device memory back when it ends:
    the ranks share the card, and one task's cached blocks (the plain
    versions' dense scores, a model and its optimizer state) would starve
    the next task's ranks."""
    import functools

    @functools.wraps(fn)
    def run(*args):
        import gc

        import torch

        try:
            return fn(*args)
        finally:
            gc.collect()
            torch.cuda.empty_cache()

    return run


# -- the Magi-1 DiT on the card -----------------------------------------------

# The repo's Magi-1 video mask shape (docs/dist_bench.md, 8 AR chunks) at half
# its 64k length: 32,768 tokens as 8 chunks of 4,096; the cp layouts take 4
# chunks of 4,096.
DIT_T, DIT_CHUNK, DIT_CP_T = 32768, 4096, 16384
DIT_STEPS = 3
DIT_PERTURB = 0.02  # the JAX causality test's noise on the adaLN-zero start
DIT_BF16_LOSS_TOL = 2e-2  # |bf16 loss - f32 loss| a step, same weights and batch
DIT_CAUSAL_TOL = 1e-5  # an earlier token's velocity move (float32)
DIT_CP_TOL = 1e-4  # dp2 x cp2 and cp 4 velocities and losses against cp = 1
DIT_LAYOUTS = (dict(dp=2, cp=2), dict(cp=4))
DIT_KERNELS = ("flex_fwd_hb", "flex_dq", "flex_dkv")  # head_block G = 2, the row-major grid


def dit_params(seed: int, cfg):
    """``init_dit_params`` from ``seed`` on the card plus DIT_PERTURB of
    seeded noise, so that the adaLN-zero start (every block the identity,
    the velocity 0) is broken and attention mixes tokens."""
    import torch
    from magiattention_tpu_torch.models import init_dit_params

    gen = torch.Generator(device="cuda").manual_seed(seed)
    tree = init_dit_params(gen, cfg)

    def noisy(x):
        return x + DIT_PERTURB * torch.randn(x.shape, generator=gen, device="cuda")

    return {**{n: noisy(x) for n, x in tree.items() if n != "layers"},
            "layers": [{n: noisy(x) for n, x in layer.items()} for layer in tree["layers"]]}


def dit_batch(seed: int, cfg, batch: int, t: int) -> dict:
    """A rectified-flow batch from ``seed`` on the card: latents, text,
    per-chunk t in [0.05, 0.95] broadcast to tokens, the noised latents, the
    velocity target, and ``lat_moved`` (the last chunk's latents moved by
    10), [batch, t, ...] in natural order."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed + 1)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    lat = randn(batch, t, cfg.in_dim)
    text = randn(batch, cfg.text_len, cfg.text_dim)
    tc = (0.05 + 0.9 * torch.rand((batch, t // DIT_CHUNK), generator=gen, device="cuda"))
    tc = tc.repeat_interleave(DIT_CHUNK, dim=1)
    noise = randn(batch, t, cfg.in_dim)
    noised = (1 - tc[..., None]) * lat + tc[..., None] * noise
    moved = noised.clone()
    moved[:, -DIT_CHUNK:] += 10.0
    return {"noised": noised, "target_v": noise - lat, "t_chunk": tc, "text": text,
            "lat_moved": moved}


def by_head(fn, q, k, v, *rest, tables, params, sink=None):
    """A plain flex function (``_fwd_torch``, ``_fwd_torch_sparse``,
    ``_dq_torch`` or ``_dkv_torch``) on head-major tensors, one q head at a
    time: the whole call's dense [hq, t, t] f32 scores do not fit the card
    at 32k tokens. Forwards give (out, lse, rowmax) and dq its gradient
    stacked over the heads; dk, dv sum the q heads of each kv head."""
    import torch

    hq, hk = q.shape[0], k.shape[0]
    g = hq // hk
    parts = []
    for h in range(hq):
        kv = (k[h // g:h // g + 1], v[h // g:h // g + 1])
        per = [x[h:h + 1] for x in rest]  # dout, lse, delta of the backward
        args = (q[h:h + 1], *kv, *per) if rest else (q[h:h + 1], *kv, sink[h:h + 1])
        parts.append(fn(*args, tables, params))
    if fn.__name__ == "_dkv_torch":
        return tuple(torch.cat([sum(parts[h][i] for h in range(j * g, (j + 1) * g))
                                for j in range(hk)]) for i in range(2))
    if isinstance(parts[0], tuple):
        return tuple(torch.cat([p[i] for p in parts]) for i in range(len(parts[0])))
    return torch.cat(parts)


def flex_bounds(area: int, t: int, hq: int, hk: int, d: int, f32: bool) -> dict:
    """Each flex kernel's bound on a t-token problem of ``area`` unmasked
    pairs (as the kernels phase reckons it): 4 d (forward), 6 d (dq) and 8
    d (dk/dv) FLOPs per pair and q head at 989 TFLOP/s bf16, or 67 TFLOP/s
    of CUDA-core FP32 for float32; q, k, v (and dout) read, the outputs
    (out, or f32 gradients) and the f32 lse / rowmax / delta once."""
    e, peak = (4, PEAK_F32_FLOPS) if f32 else (2, PEAK_BF16_FLOPS)
    kv_in = e * (t * hq * d + 2 * t * hk * d)
    bwd_in = e * (2 * t * hq * d + 2 * t * hk * d) + 4 * 2 * t * hq
    return {"fwd": bound(4.0 * area * d * hq, kv_in + e * t * hq * d + 4 * 2 * t * hq, peak),
            "dq": bound(6.0 * area * d * hq, bwd_in + 4 * t * hq * d, peak),
            "dkv": bound(8.0 * area * d * hq, bwd_in + 4 * 2 * t * hk * d, peak)}


def held_by_head(p, name, sparse=False) -> dict:
    """``p``'s kernels (the row-major pair and backward, or the sparse
    grid's) against their plain versions run head by head
    (:func:`by_head`), in p's dtype's bounds; returns the plain versions'
    device ms."""
    import torch
    from magiattention_tpu_torch.ops import flex_attn as fa

    f32 = p.dtype == torch.float32
    # one q head a call: head_block 1 (the plain versions' results do not depend on it)
    params = dataclasses.replace(p.sparse_params if sparse else p.params, head_block=1)
    tq, tk = p.tq, p.tk
    kw = dict(tables=p.tables, params=params)
    plain_fwd = fa._fwd_torch_sparse if sparse else fa._fwd_torch
    ms = {}
    t0 = time.perf_counter()
    ref = by_head(plain_fwd, p.q, p.k, p.v, sink=p.sink, **kw)
    torch.cuda.synchronize()
    ms["fwd"] = (time.perf_counter() - t0) * 1e3
    bwd = p.bwd_inputs()
    t0 = time.perf_counter()
    ref_dq = by_head(fa._dq_torch, *bwd, **kw)
    torch.cuda.synchronize()
    ms["dq"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    ref_dk, ref_dv = by_head(fa._dkv_torch, *bwd, tables=p.btables, params=params)
    torch.cuda.synchronize()
    ms["dkv"] = (time.perf_counter() - t0) * 1e3
    fwds = ({p.fwd_sparse_name: p.sparse_kernel()} if sparse else
            {"flex_fwd": p.kernel(), "flex_fwd_hb": p.hb_kernel(p.q.shape[0] // p.k.shape[0])})
    dq, (dk, dv) = ((p.dq_sparse_kernel(), p.dkv_sparse_kernel()) if sparse else
                    (p.dq_kernel(), p.dkv_kernel()))
    dq_name, dkv_name = ("flex_dq_sparse", "flex_dkv_sparse") if sparse else ("flex_dq", "flex_dkv")
    grads = [(dq_name, "dq", dq[:, :tq], ref_dq[:, :tq]), (dkv_name, "dk", dk[:, :tk], ref_dk[:, :tk]),
             (dkv_name, "dv", dv[:, :tk], ref_dv[:, :tk])]
    for kernel, (out, lse, mx) in fwds.items():
        hold_fwd(kernel, name, f32, *(x[:, :tq] for x in (out, ref[0], lse, ref[1], mx, ref[2])))
    for kernel, what, got, want in grads:
        hold_grad(kernel, name, f32, what, got, want)
    return ms


def masked_sdpa(q, k, v, mask):
    """One PyTorch call computing the same attention over a boolean [t, t]
    mask (head-major [h, t, d] q, k/v repeated to hq heads inside the call):
    ``scaled_dot_product_attention`` on the memory-efficient backend. A
    yardstick only."""
    import torch.nn.functional as Fn
    from torch.nn.attention import SDPBackend, sdpa_kernel

    g = q.shape[0] // k.shape[0]

    def fn():
        qs, ks, vs = (x.unsqueeze(0) for x in (q, k.repeat_interleave(g, 0),
                                               v.repeat_interleave(g, 0)))
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            return Fn.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask)

    return fn


def library_fwd_bwd(fn_of, q, k, v, do) -> tuple[float | None, float | None, str | None]:
    """(forward ms, backward ms as fwd + bwd minus fwd, why not) of a
    library yardstick ``fn_of(q, k, v)``; a refusal fails nothing."""
    import torch

    try:
        fwd_ms = cuda_ms(fn_of(q, k, v), reps=5)
        ql, kl, vl = (x.detach().requires_grad_() for x in (q, k, v))
        fn = fn_of(ql, kl, vl)
        bwd_ms = cuda_ms(lambda: torch.autograd.grad(fn(), (ql, kl, vl), do), reps=5) - fwd_ms
        return fwd_ms, bwd_ms, None
    except RuntimeError as exc:
        return None, None, f"{type(exc).__name__}: {str(exc)[:160]}"


def narrow_timing(gen, f32_gen) -> tuple[dict, dict]:
    """The flex kernels at this slice's new widths, in device time, each
    checked first at its timed shape against its plain version run head by
    head: rows 1, 2, 5 and 7 (``flex_fwd``, ``flex_fwd_hb`` at head_block
    G, ``flex_dq``, ``flex_dkv``) on the dit problem (DiTConfig's 8 q / 4
    kv heads of d 32 on the 32,768-token chunk-causal mask) in bf16 and in
    float32; rows 3, 4, 6 and 8 at d 32 in bf16 and (inputs from ``f32_gen``)
    float32 on the 16,384-token varlen
    block-causal mask at the same heads. Each beside the plain version's
    ms, the card's bound (:func:`flex_bounds`) and a PyTorch yardstick:
    SDPA over the boolean mask (its backward for dq) for the row-major
    kernels, ``library_attention`` for the sparse grid. Returns (the line,
    {kernel: {width: record}})."""
    import torch
    from magiattention_tpu_torch.models import DiTConfig, chunk_causal_mask
    from magiattention_tpu_torch.testing.workloads import split_slices, varlen_block_causal

    cfg = DiTConfig()
    hq, hk, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    g = hq // hk
    qr, kr, ty = chunk_causal_mask(DIT_T, DIT_CHUNK)
    recs, line = {}, {"phase": "narrow_timing", "card": nvidia_smi_line(), "tokens": DIT_T,
                      "hq": hq, "hk": hk, "head_dim": d}
    pos = torch.arange(DIT_T, device="cuda")
    mask = pos[None] < (pos[:, None] // DIT_CHUNK + 1) * DIT_CHUNK
    for dtype, width in ((torch.bfloat16, "d32_bf16"), (torch.float32, "d32_f32")):
        p = Flex(gen, DIT_T, DIT_T, hq, hk, qr, kr, ty, d=d, dtype=dtype)
        plain = held_by_head(p, f"dit_problem_{width}")
        reps = 20 if dtype == torch.bfloat16 else 3
        ms = {"flex_fwd": cuda_ms(p.kernel, reps), "flex_fwd_hb": cuda_ms(lambda: p.hb_kernel(g), reps),
              "flex_dq": cuda_ms(p.dq_kernel, reps), "flex_dkv": cuda_ms(p.dkv_kernel, reps)}
        lib_fwd, lib_bwd, why = library_fwd_bwd(lambda a, b, c: masked_sdpa(a, b, c, mask),
                                                p.q, p.k, p.v, p.do.unsqueeze(0))
        b = flex_bounds(p.meta.total_area, DIT_T, hq, hk, d, dtype == torch.float32)
        for name, kind, lib in (("flex_fwd", "fwd", lib_fwd), ("flex_fwd_hb", "fwd", lib_fwd),
                                ("flex_dq", "dq", lib_bwd), ("flex_dkv", "dkv", None)):
            recs.setdefault(name, {})[width] = {
                "ms": ms[name], "plain_ms": plain[kind], "bound_ms": b[kind][0],
                "bound_by": b[kind][1], "library_ms": lib}
        line[width] = {"ms": ms, "plain_ms_by_head": plain, "area": p.meta.total_area,
                       "share_of_bound": {n: recs[n][width]["bound_ms"] / ms[n] for n in ms},
                       "library": "scaled_dot_product_attention(EFFICIENT_ATTENTION, boolean mask)",
                       "library_fwd_ms": lib_fwd, "library_bwd_ms_for_dq_dk_dv": lib_bwd,
                       "library_note": why}
        del p
        torch.cuda.empty_cache()
    del mask
    t = HETERO_T
    hqr, hkr, hty = split_slices(varlen_block_causal(t))
    docs = sorted({a for a, _ in hqr} | {b for _, b in hqr})
    cu = torch.tensor(docs, dtype=torch.int32, device="cuda")
    max_len = int(torch.diff(cu).max())
    for dtype, width, g_in in ((torch.bfloat16, "d32_bf16", gen),
                               (torch.float32, "d32_f32", f32_gen)):
        f32 = dtype == torch.float32
        reps = 5 if f32 else 20
        p = Flex(g_in, t, t, hq, hk, hqr, hkr, hty, d=d, head_block=1, dtype=dtype)
        plain = held_by_head(p, f"hetero_{width}_hb1", sparse=True)
        ms = {"flex_fwd_sparse": cuda_ms(p.sparse_kernel, reps)}
        p.set_head_block(g)
        held_by_head(p, f"hetero_{width}_hb{g}", sparse=True)
        ms.update({"flex_fwd_sparse_hb": cuda_ms(p.sparse_kernel, reps),
                   "flex_dq_sparse": cuda_ms(p.dq_sparse_kernel, reps),
                   "flex_dkv_sparse": cuda_ms(p.dkv_sparse_kernel, reps)})
        lib_name = None

        def lib_of(a, b_, c):
            nonlocal lib_name
            fn, lib_name = library_attention(*(x[:, :t].transpose(0, 1).contiguous()
                                               for x in (a, b_, c)), cu, max_len)
            return fn

        do = p.do[:, :t].transpose(0, 1)
        lib_fwd, lib_bwd, why = library_fwd_bwd(lib_of, p.q, p.k, p.v, do)
        b = flex_bounds(p.meta.total_area, t, hq, hk, d, f32)
        for name, kind, lib in (("flex_fwd_sparse", "fwd", lib_fwd),
                                ("flex_fwd_sparse_hb", "fwd", lib_fwd),
                                ("flex_dq_sparse", "dq", lib_bwd), ("flex_dkv_sparse", "dkv", None)):
            recs.setdefault(name, {})[width] = {
                "ms": ms[name], "plain_ms": plain[kind], "bound_ms": b[kind][0],
                "bound_by": b[kind][1], "library_ms": lib}
        line[f"hetero_{width}"] = {"tokens": t, "ms": ms, "plain_ms_by_head": plain,
                                   "area": p.meta.total_area, "library": lib_name,
                                   "library_fwd_ms": lib_fwd,
                                   "library_bwd_ms_for_dq_dk_dv": lib_bwd, "library_note": why,
                                   "share_of_bound": {n: recs[n][width]["bound_ms"] / ms[n]
                                                      for n in ms}}
    del p
    torch.cuda.empty_cache()
    return line, recs


def dit_attention_check(model, cap, name) -> None:
    """Layer 0's attention call of the first step against the plain forward
    and backward, head by head (:func:`by_head`): its q, k, v, out and lse,
    the dout that reached it and the dq, dk, dv it gave back; bf16 under the
    kernels phase's bounds, float32 within the float32 budget."""
    import torch
    from magiattention_tpu_torch.ops import flex_attn as fa

    meta, cfg = model.meta, model.cfg
    tqp, tkp = meta.num_q_blocks * meta.block_q, meta.num_k_blocks * meta.block_k
    t = cap["q"].shape[0]

    def head_major(x, tp):
        return fa._pad_tokens(x.transpose(0, 1), tp)

    q, out, do = (head_major(cap[n], tqp) for n in ("q", "out", "dout"))
    k, v = (head_major(cap[n], tkp) for n in ("k", "v"))
    params = fa.FlexAttnParams(meta.block_q, meta.block_k, 1.0 / math.sqrt(cfg.head_dim),
                               0.0, False, cfg.torch_dtype)
    ftab, btab = fa.fwd_tables(meta, "cuda:0"), fa.bwd_tables(meta, "cuda:0")
    sink = torch.zeros((q.shape[0],), device="cuda")
    ref_out, ref_lse, _ = by_head(fa._fwd_torch, q, k, v, sink=sink, tables=ftab, params=params)
    lse = head_major(cap["lse"], tqp)
    delta = (do.float() * out.float()).sum(-1)  # the model's lse cotangent is 0
    ref_dq = by_head(fa._dq_torch, q, k, v, do, lse, delta, tables=ftab, params=params)
    ref_dk, ref_dv = by_head(fa._dkv_torch, q, k, v, do, lse, delta, tables=btab,
                             params=params)
    f32 = cfg.torch_dtype == torch.float32
    # the model's v is not positive: a float32 out is held as a gradient is
    hold_fwd("flex_fwd_hb", name, f32, cap["out"].transpose(0, 1), ref_out[:, :t],
             cap["lse"].transpose(0, 1), ref_lse[:, :t], positive_v=False)
    for kernel, what, got, want in (("flex_dq", "dq", cap["dq"], ref_dq),
                                    ("flex_dkv", "dk", cap["dk"], ref_dk),
                                    ("flex_dkv", "dv", cap["dv"], ref_dv)):
        hold_grad(kernel, name, f32, what, got.transpose(0, 1), want[:, :t])


def dit_train(cfg, params, data, t: int, steps: int, name: str, check_layer0: bool) -> dict:
    """``build_magi_dit`` at cp = 1 on the card (its default device) over
    ``data``'s [1, t] stream and ``steps`` AdamW steps: the losses, step
    ms, tokens/s, peak memory, the flex launches of the steps, and (with
    ``check_layer0``) layer 0's first attention call against the plain
    versions."""
    import torch
    from magiattention_tpu_torch import csrc
    from magiattention_tpu_torch.models import build_magi_dit
    from magiattention_tpu_torch.ops import flex_attn_with_meta

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build_magi_dit(cfg, t, DIT_CHUNK, params=params)  # the card, by default
    choice = (model.meta.block_q, model.meta.block_k, model.head_block)
    check(choice == (64, 64, cfg.n_heads // cfg.n_kv_heads),
          f"{name}: the harness's blocking is {choice}, not (64, 64, G)")
    pos = torch.arange(t, device="cuda")[None]
    batch = (data["noised"], data["target_v"], data["t_chunk"], pos, data["text"])
    step = model.make_train_step(torch.optim.AdamW(model.parameters(), **ADAMW))
    cap = {}

    def capture(q, k, v):
        out, lse = flex_attn_with_meta(q, k, v, model.meta, out_dtype=cfg.torch_dtype,
                                       head_block=model.head_block)
        if not cap:
            cap.update(q=q.detach(), k=k.detach(), v=v.detach(), out=out.detach(),
                       lse=lse.detach())
            for n, x in (("dq", q), ("dk", k), ("dv", v), ("dout", out)):
                x.register_hook(lambda gr, n=n: cap.__setitem__(n, gr))
        return out

    losses, step_ms = [], []
    csrc.reset_launch_counts()
    for i in range(steps):
        if i == 0 and check_layer0:
            model.attention = capture  # shadows the method for the first step
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(step(*batch)))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if i == 0 and check_layer0:
            del model.attention
    launches = {n: csrc.launches[n] for n in FLEX_KERNELS if csrc.launches[n]}
    peak = torch.cuda.max_memory_allocated()
    expected = cfg.n_layers * steps  # one flex call a layer a step, forward and backward
    check(launches == {n: expected for n in DIT_KERNELS},
          f"{name}: launches {launches}, expected {expected} of each of {DIT_KERNELS}")
    check(all(math.isfinite(x) for x in losses), f"{name}: non-finite loss {losses}")
    if check_layer0:
        check(set(cap) == {"q", "k", "v", "out", "lse", "dq", "dk", "dv", "dout"},
              f"{name}: the first step's attention call captured only {sorted(cap)}")
        dit_attention_check(model, cap, f"{name}_layer0_step0")
    med = sorted(step_ms)[len(step_ms) // 2]
    return {"losses": losses, "step_ms": step_ms, "median_step_ms": med,
            "tokens_per_s": t / (med / 1e3), "peak_gb": peak / 1e9, "launches": launches,
            "launches_per_step": {n: c / steps for n, c in launches.items()},
            "launches_per_step_reckoned": {n: cfg.n_layers for n in DIT_KERNELS}}


def dit_velocities(cfg, params, data, t: int) -> dict:
    """cp = 1 on the card, float32: the velocities of ``data`` and of its
    moved last chunk, [b, t, in_dim], and the loss, no gradient."""
    import torch
    from magiattention_tpu_torch.models import build_magi_dit

    model = build_magi_dit(cfg, t, DIT_CHUNK, params=params)
    b = data["noised"].shape[0]
    pos = torch.arange(t, device="cuda").expand(b, -1)
    with torch.no_grad():
        vel = {n: model(data[n], data["t_chunk"], pos, data["text"])
               for n in ("noised", "lat_moved")}
        loss = float(model.loss(data["noised"], data["target_v"], data["t_chunk"], pos,
                                data["text"]))
    return {"vel": vel["noised"], "vel_moved": vel["lat_moved"], "loss": loss}


@in_rank
def dit_rank(group, seed: int, layout: dict, ref_path: str) -> dict:
    """One rank of the DiT under a (dp, cp) layout on the card (float32,
    the phase's weights and two-stream batch from ``seed``): the gathered
    velocities against cp = 1's (saved by the phase), the global loss, one
    AdamW step, and this rank's flex launches."""
    import torch
    import torch.distributed as dist
    from magiattention_tpu_torch import csrc
    from magiattention_tpu_torch.models import DiTConfig, build_magi_dit, make_parallel_groups

    cp_rank_setup()
    cfg = DiTConfig()
    groups = make_parallel_groups(**layout)
    params = dit_params(seed, cfg)
    data = dit_batch(seed, cfg, 2, DIT_CP_T)
    csrc.reset_launch_counts()
    model = build_magi_dit(cfg, DIT_CP_T, DIT_CHUNK, groups=groups, params=params)
    tc = model.shard(data["t_chunk"], pad_value=-1.0)
    text = model.dp_rows(data["text"])
    pos = model.position_ids().cuda().expand(tc.shape[0], -1)
    with torch.no_grad():
        vel = model.gather(model(model.shard(data["noised"]), tc, pos, text))
    batch = (model.shard(data["noised"]), model.shard(data["target_v"]), tc, pos, text)
    step = model.make_train_step(torch.optim.AdamW(model.parameters(), **ADAMW))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = float(step(*batch))
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    ref = torch.load(ref_path)
    return {"rank": dist.get_rank(), "coords": groups.coords, "loss": loss,
            "loss_diff": abs(loss - ref["loss"]),
            "vel_max_abs_diff": float((vel - ref["vel"].cuda()).abs().max()),
            "step_ms": step_ms, "head_block": model.head_block,
            "launches": {n: csrc.launches[n] for n in FLEX_KERNELS if csrc.launches[n]}}


def dit_phase(pools, seed: int, scratch: str) -> dict:
    """The Magi-1 DiT trainer on the card at ``DiTConfig()``'s widths (dim
    256, 4 layers, 8 q / 4 kv heads of d 32, ffn 512, text 64 x 64) on one
    32,768-token stream of 8 AR chunks: 3 AdamW steps in float32 (the
    config's default) and 3 in bfloat16, from the same weights and batch;
    layer 0's first attention call against the plain versions in each; the
    chunk-causal property in float32 (moving the last chunk's latents moves
    no earlier token's velocity by DIT_CAUSAL_TOL); then dp2 x cp2 and cp 4
    as ranks sharing the card over gloo, float32, on 16,384 tokens (4
    chunks), each rank's gathered velocities and loss within DIT_CP_TOL of
    cp = 1 on the card and every rank the same loss."""
    import torch
    from magiattention_tpu_torch.models import DiTConfig

    t_start = time.perf_counter()
    cfg32 = DiTConfig()
    cfg16 = dataclasses.replace(cfg32, dtype="bfloat16")
    params = dit_params(seed, cfg32)
    data = dit_batch(seed, cfg32, 1, DIT_T)
    runs = {"float32": dit_train(cfg32, params, data, DIT_T, DIT_STEPS, "dit_f32", True),
            "bfloat16": dit_train(cfg16, params, data, DIT_T, DIT_STEPS, "dit_bf16", True)}
    diffs = [abs(a - b) for a, b in zip(runs["bfloat16"]["losses"], runs["float32"]["losses"])]
    check(max(diffs) <= DIT_BF16_LOSS_TOL,
          f"dit: the bf16 losses are {max(diffs)} from the f32 ones (> {DIT_BF16_LOSS_TOL})")
    one = dit_velocities(cfg32, params, data, DIT_T)
    move = (one["vel"] - one["vel_moved"]).abs().amax(dim=(0, 2))  # per token
    earlier, own = float(move[:DIT_T - DIT_CHUNK].max()), float(move[DIT_T - DIT_CHUNK:].max())
    check(earlier < DIT_CAUSAL_TOL and own > 1e-3,
          f"dit: moving the last chunk moved an earlier velocity by {earlier} (own {own})")
    del one
    torch.cuda.empty_cache()
    # the cp layouts' reference: cp = 1 on the card on their two 16k streams
    ref = dit_velocities(cfg32, params, dit_batch(seed, cfg32, 2, DIT_CP_T), DIT_CP_T)
    ref_path = os.path.join(scratch, "dit_cp1.pt")
    torch.save({"vel": ref["vel"].cpu(), "loss": ref["loss"]}, ref_path)
    del ref
    torch.cuda.empty_cache()
    t_cp = time.perf_counter()
    layouts, launches = {}, {}
    for layout in DIT_LAYOUTS:
        got = pools[4].run(dit_rank, seed, layout, ref_path)
        name = layout_name(layout)
        check(all(r["vel_max_abs_diff"] <= DIT_CP_TOL and r["loss_diff"] <= DIT_CP_TOL
                  for r in got), f"dit {name}: against cp = 1 {[(r['vel_max_abs_diff'], r['loss_diff']) for r in got]}")
        check(len({r["loss"] for r in got}) == 1, f"dit {name}: the ranks' losses differ")
        check(all(set(r["launches"]) == set(DIT_KERNELS) for r in got),
              f"dit {name}: launches {[r['launches'] for r in got]}")
        for r in got:
            for n, c in r["launches"].items():
                launches[n] = launches.get(n, 0) + c
        layouts[name] = {"loss": got[0]["loss"],
                         "vel_max_abs_diff": max(r["vel_max_abs_diff"] for r in got),
                         "loss_diff": max(r["loss_diff"] for r in got),
                         "step_ms": [r["step_ms"] for r in got],
                         "head_block": got[0]["head_block"],
                         "launches_by_rank": [r["launches"] for r in got]}
    cp_s = time.perf_counter() - t_cp
    path_launches = {n: runs["float32"]["launches"].get(n, 0) + runs["bfloat16"]["launches"].get(n, 0)
                     for n in DIT_KERNELS}
    return {"phase": "dit", "card": nvidia_smi_line(),
            "config": dataclasses.asdict(cfg32), "tokens": DIT_T, "chunk": DIT_CHUNK,
            "cut": "none of the widths; one 32,768-token stream (the 64k video mask at half "
                   "its length)",
            "weights": f"init_dit_params(seed {seed}) + {DIT_PERTURB} N(0, 1) noise",
            "optimizer": {"AdamW": {**ADAMW, "betas": list(ADAMW["betas"])}},
            "runs": runs, "bf16_minus_f32_loss": diffs,
            "causality": {"earlier_max_move": earlier, "last_chunk_max_move": own},
            "cp": {"tokens": DIT_CP_T, "layouts": layouts, "seconds": cp_s},
            "launches": path_launches, "cp_launches": launches,
            "seconds": time.perf_counter() - t_start}


HETERO_T = 16384  # testing/workloads.py::varlen_block_causal(16384): 12 documents, seed 7
HETERO_RUNS = ((TRAIN_HQ, TRAIN_HK, 2), (8, 8, 1))  # (hq, hk, the head_block the choice must give)


def library_attention(q, k, v, cu, max_len):
    """One PyTorch call computing the same causal-per-document attention
    ([t, h, d] bf16), a yardstick only: ``torch.nn.attention.varlen.varlen_attn``
    where the installed torch has it, else ``scaled_dot_product_attention``
    over the boolean block-diagonal causal mask with k/v repeated to hq
    heads on the memory-efficient backend. Returns (fn, what ran)."""
    import inspect

    import torch
    import torch.nn.functional as Fn

    hq, hk = q.shape[1], k.shape[1]

    def rep(x):  # k/v repeated to hq heads, inside the call so autograd sees it
        return x.repeat_interleave(hq // hk, 1)

    try:
        from torch.nn.attention import varlen

        params = inspect.signature(varlen.varlen_attn).parameters
        kw = {"is_causal": True} if "is_causal" in params else {"window_size": (-1, 0)}
        gqa = hq != hk and "enable_gqa" in params
        if gqa:
            kw["enable_gqa"] = True

        def fn():
            kv = (k, v) if gqa or hq == hk else (rep(k), rep(v))
            return varlen.varlen_attn(q, *kv, cu, cu, max_len, max_len, **kw)

        fn()
        return fn, f"torch.nn.attention.varlen.varlen_attn({', '.join(sorted(kw))})"
    except (ImportError, AttributeError, RuntimeError, TypeError) as exc:
        reason = f"{type(exc).__name__}: {str(exc)[:120]}"
    from torch.nn.attention import SDPBackend, sdpa_kernel

    t = q.shape[0]
    doc = torch.repeat_interleave(torch.arange(cu.numel() - 1, device=q.device), torch.diff(cu))
    pos = torch.arange(t, device=q.device)
    mask = (doc[:, None] == doc[None]) & (pos[None] <= pos[:, None])

    def fn():
        qs, ks, vs = (x.transpose(0, 1).unsqueeze(0) for x in (q, rep(k), rep(v)))
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            out = Fn.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask)
        return out.squeeze(0).transpose(0, 1)

    fn()
    return fn, f"scaled_dot_product_attention(EFFICIENT_ATTENTION, boolean mask) [varlen: {reason}]"


def mma_sync_sparse(lib, p, bwd_args, refs):
    """Launchers of the previous sparse-grid backward (the ``mma_sync_sparse``
    yardstick library) on ``bwd_args`` over per-head dq items and the dkv
    work list, checked once against the plain backward's (dq, dk, dv)
    ``refs``. A yardstick only: nothing here is counted as a launch."""
    import torch
    from magiattention_tpu_torch.ops.block_sparse import row_tables, work_list

    q, k, v, do, lse, delta = bwd_args
    hq, tqp, d = q.shape
    hk, tkp = k.shape[0], k.shape[1]
    nq, nk = tqp // BLOCK, tkp // BLOCK
    dq_items = torch.from_numpy(work_list(row_tables(p.meta.fwd_q_block, nq)[1], hq)).cuda()
    counter = torch.empty((1,), dtype=torch.int32, device="cuda")
    f32 = dict(dtype=torch.float32, device="cuda")
    dq, dk, dv = torch.empty((hq, tqp, d), **f32), *(torch.empty((hk, tkp, d), **f32)
                                                     for _ in range(2))
    head = [x.data_ptr() for x in bwd_args]

    def run(fn, tables, items, outs, blocks):
        code = fn(*head, *(x.data_ptr() for x in tables[1:7]), items.data_ptr(),
                  counter.data_ptr(), *(o.data_ptr() for o in outs), hq, hk, tqp, tkp, d, blocks,
                  items.numel(), p.params.scale, p.params.softcap,
                  torch.cuda.current_stream().cuda_stream)
        check(code == 0, f"the previous sparse backward walk: CUDA error {code}")

    def run_dq():
        run(lib.mma_sync_flex_dq_sparse, p.tables, dq_items, (dq,), nq)

    def run_dkv():
        run(lib.mma_sync_flex_dkv_sparse, p.btables, p.work.dkv, (dk, dv), nk)

    run_dq()
    run_dkv()
    torch.cuda.synchronize()
    for what, got, ref, t in zip(("dq", "dk", "dv"), (dq, dk, dv), refs, (p.tq, p.tk, p.tk)):
        _, failed = grad_errors(got[:, :t], ref[:, :t])
        check(not failed, f"the previous sparse walk's {what} fails the {failed} check(s)")
    return run_dq, run_dkv


def mma_sync_fwd_sparse(lib, p):
    """A launcher of the previous sparse forward (the ``mma_sync_fwd_sparse``
    yardstick library) on ``p``'s inputs and forward work list, checked once
    against the plain sparse forward. A yardstick only: nothing here is
    counted as a launch."""
    import torch

    q, k, v = p.q, p.k, p.v
    hq, tqp, d = q.shape
    hk, tkp = k.shape[0], k.shape[1]
    out = torch.empty((hq, tqp, d), dtype=torch.bfloat16, device="cuda")
    lse, rowmax = (torch.empty((hq, tqp), device="cuda") for _ in range(2))
    counter = torch.empty((1,), dtype=torch.int32, device="cuda")
    ptrs = [x.data_ptr() for x in (q, k, v, p.sink, *p.tables[1:7], p.work.fwd, counter, out,
                                   lse, rowmax)]
    prm = p.sparse_params

    def run():
        code = lib.mma_sync_flex_fwd_sparse(
            *ptrs, hq, hk, tqp, tkp, d, tqp // BLOCK, BLOCK, BLOCK, p.work.fwd.numel(), p.hb,
            prm.scale, prm.softcap, int(prm.has_sink), 0, torch.cuda.current_stream().cuda_stream)
        check(code == 0, f"the previous sparse forward walk: CUDA error {code}")

    run()
    torch.cuda.synchronize()
    o, r, pairs = p.sparse_fwd_pairs((out, lse, rowmax))
    _, failed = out_errors(o, r, pairs)
    check(not failed, f"the previous sparse forward walk fails the {failed} check(s)")
    return run


def hetero_run(gen, qr, kr, ty, hq, hk, expect_hb, planted, timed) -> tuple[dict, dict, dict]:
    """One default-argument forward and backward through
    ``flex_flash_attn_func`` on the varlen mask: the resolved choice, the
    launches, the results against the plain versions, and (``timed``) each
    kernel's time with the row-major one's, the plain one's, the bound and
    the library yardstick, the backward kernels in turns with the previous
    sparse walk, and the slice's forward + backward in device time. Returns
    (summary, launches, per-kernel times)."""
    import dataclasses as dc

    import torch
    from magiattention_tpu_torch import csrc
    from magiattention_tpu_torch.ops import flex_attn as fa
    from magiattention_tpu_torch.tuning import exact_mask_area

    t = HETERO_T
    bq, bk, hb, grid = fa.auto_kernel_config(qr, kr, hq, hk, attn_type_map=ty, head_dim=D)
    check((grid, hb) == ("sparse", expect_hb),
          f"hq {hq} / hk {hk}: the choice is grid={grid!r} head_block={hb}, not sparse/{expect_hb}")
    p = Flex(gen, t, t, hq, hk, qr, kr, ty, head_block=hb)
    q, k, v = (x[:, :t].transpose(0, 1).contiguous().requires_grad_() for x in (p.q, p.k, p.v))
    dout = p.do[:, :t].transpose(0, 1).contiguous()
    dlse = p.dlse[:, :t].transpose(0, 1).contiguous()

    torch.cuda.synchronize()
    csrc.reset_launch_counts()
    t0 = time.perf_counter()
    out, lse = fa.flex_flash_attn_func(q, k, v, qr, kr, ty)  # every choice left to the port
    dq, dk, dv = torch.autograd.grad((out, lse), (q, k, v), (dout, dlse))
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = {n: csrc.launches[n] for n in FLEX_KERNELS}
    fwd_name = "flex_fwd_sparse_hb" if hb > 1 else "flex_fwd_sparse"
    want = {n: int(n in (fwd_name, "flex_dq_sparse", "flex_dkv_sparse")) for n in FLEX_KERNELS}
    check(launches == want, f"hq {hq} / hk {hk}: launches {launches}, expected {want}")

    # the plain versions on the same inputs: the sparse forward on every
    # head at once, the dense backward one kv head's group at a time
    ref_out, ref_lse, _ = p.sparse_plain()
    compare(fwd_name, f"hetero_{hq}_{hk}", out.transpose(0, 1), ref_out[:, :t],
            lse.transpose(0, 1), ref_lse[:, :t])
    g = hq // hk
    ftab, btab, params = p.tables, p.btables, p.sparse_params
    tqp = p.q.shape[1]

    def head_major(x):
        return fa._pad_tokens(x.detach().transpose(0, 1), tqp)

    lse_h = head_major(lse)
    delta = (head_major(dout).float() * head_major(out).float()).sum(-1) - head_major(dlse)
    groups = range(hk) if timed else range(1)

    def plain_dq():
        return torch.cat([fa._dq_torch(p.q[j * g:(j + 1) * g], p.k[j:j + 1], p.v[j:j + 1],
                                       p.do[j * g:(j + 1) * g], lse_h[j * g:(j + 1) * g],
                                       delta[j * g:(j + 1) * g], ftab, params)
                          for j in groups])

    def plain_dkv():
        pairs = [fa._dkv_torch(p.q[j * g:(j + 1) * g], p.k[j:j + 1], p.v[j:j + 1],
                               p.do[j * g:(j + 1) * g], lse_h[j * g:(j + 1) * g],
                               delta[j * g:(j + 1) * g], btab, params) for j in groups]
        return torch.cat([a for a, _ in pairs]), torch.cat([b for _, b in pairs])

    nh, nk = len(groups) * g, len(groups)
    ref_dq = plain_dq()
    compare_grads("flex_dq_sparse", f"hetero_{hq}_{hk}",
                  [("dq", dq.transpose(0, 1)[:nh], ref_dq[:, :t])])
    ref_dk, ref_dv = plain_dkv()
    compare_grads("flex_dkv_sparse", f"hetero_{hq}_{hk}",
                  [("dk", dk.transpose(0, 1)[:nk], ref_dk[:, :t]),
                   ("dv", dv.transpose(0, 1)[:nk], ref_dv[:, :t])])
    area = exact_mask_area(qr, kr, ty)
    summary = {"hq": hq, "hk": hk, "choice": {"block_q": bq, "block_k": bk, "head_block": hb,
                                              "grid": grid},
               "launches": launches, "fwd_bwd_wall_ms": wall_ms, "pairs": area,
               "plain_checked_heads": nh}
    if not timed:
        return summary, launches, {}

    # times on the same problem: the sparse kernels (through the wrappers,
    # with the backward's own inputs), the row-major ones, the plain ones
    rm = dc.replace(params, head_block=1, grid="row_major")
    bwd_args = (p.q, p.k, p.v, p.do, lse_h, delta)
    fwd = fa._fwd_sparse_hb_kernel if hb > 1 else fa._fwd_sparse_kernel
    # each kernel in turns with the previous sparse walk (new, old, old, new)
    old = dict(zip(("flex_dq_sparse", "flex_dkv_sparse"),
                   mma_sync_sparse(planted["mma_sync_sparse"], p, bwd_args,
                                   (ref_dq, ref_dk, ref_dv))))
    old[fwd_name] = mma_sync_fwd_sparse(planted["mma_sync_fwd_sparse"], p)
    new = {fwd_name: lambda: fwd(p.q, p.k, p.v, p.sink, ftab, p.work, params),
           "flex_dq_sparse": lambda: fa._dq_sparse_kernel(*bwd_args, ftab, p.work, params),
           "flex_dkv_sparse": lambda: fa._dkv_sparse_kernel(*bwd_args, btab, p.work, params)}
    # and the forward in turns with its variant that moves AMLA's reference
    # on every rise of a row's max
    every_rise = with_library(fwd_name, planted[f"{fwd_name}_every_rise"], new[fwd_name])
    every_rise_errs, failed = out_errors(*p.sparse_fwd_pairs(every_rise()))
    check(not failed, f"the every-rise variant of {fwd_name} fails the {failed} check(s)")
    turns = {}
    for name in new:
        for which, fn in (("", new[name]), ("previous:", old[name]), ("previous:", old[name]),
                          ("", new[name])):
            turns.setdefault(which + name, []).append(cuda_ms(fn, reps=20))
    for which, fn in (("", new[fwd_name]), ("every_rise:", every_rise),
                      ("every_rise:", every_rise), ("", new[fwd_name])):
        turns.setdefault(which + fwd_name, []).append(cuda_ms(fn, reps=20))
    mean = {n: sum(x) / len(x) for n, x in turns.items()}
    ms = {n: mean[n] for n in new}

    def fwd_bwd():  # the slice as a user calls it, plans and lists cached
        o, l = fa.flex_flash_attn_func(q, k, v, qr, kr, ty)
        torch.autograd.grad((o, l), (q, k, v), (dout, dlse))

    fwd_bwd_event_ms = cuda_ms(fwd_bwd, reps=5)
    # the same kernels with their work lists in index order (head group,
    # then block): what taking the longest walks first buys
    in_order = fa.SparseWork(*(torch.sort(w).values for w in p.work))
    index_order_ms = {
        fwd_name: cuda_ms(lambda: fwd(p.q, p.k, p.v, p.sink, ftab, in_order, params), reps=20),
        "flex_dq_sparse": cuda_ms(lambda: fa._dq_sparse_kernel(*bwd_args, ftab, in_order, params),
                                  reps=20),
        "flex_dkv_sparse": cuda_ms(
            lambda: fa._dkv_sparse_kernel(*bwd_args, btab, in_order, params), reps=20),
    }
    row_major_ms = {
        "flex_fwd": cuda_ms(lambda: fa._fwd_kernel(p.q, p.k, p.v, p.sink, ftab, rm), reps=20),
        **({"flex_fwd_hb": cuda_ms(lambda: fa._fwd_hb_kernel(
            p.q, p.k, p.v, p.sink, ftab, dc.replace(rm, head_block=hb)), reps=20)}
           if hb > 1 else {}),
        "flex_dq": cuda_ms(lambda: fa._dq_kernel(*bwd_args, ftab, rm), reps=20),
        "flex_dkv": cuda_ms(lambda: fa._dkv_kernel(*bwd_args, btab, rm), reps=20),
    }
    plain_ms = {
        fwd_name: cuda_ms(p.sparse_plain, reps=1, warmup=1),
        "flex_dq_sparse": cuda_ms(plain_dq, reps=1, warmup=1),
        "flex_dkv_sparse": cuda_ms(plain_dkv, reps=1, warmup=1),
    }
    docs = sorted({a for a, _ in qr} | {b for _, b in qr})
    cu = torch.tensor(docs, dtype=torch.int32, device="cuda")
    qb, kb_, vb = (x.detach().to(torch.bfloat16) for x in (q, k, v))
    lib_fwd, lib_name = library_attention(qb, kb_, vb, cu, int(torch.diff(cu).max()))
    lib_ms = cuda_ms(lib_fwd, reps=10)
    ql, kl, vl = (x.detach().requires_grad_() for x in (qb, kb_, vb))
    lib_train, _ = library_attention(ql, kl, vl, cu, int(torch.diff(cu).max()))
    try:  # fwd + bwd minus fwd: the library's backward, dq, dk and dv together
        lib_bwd_ms = cuda_ms(lambda: torch.autograd.grad(lib_train(), (ql, kl, vl), dout),
                             reps=10) - lib_ms
        lib_bwd_note = None
    except RuntimeError as exc:  # a yardstick only: its absence fails nothing
        lib_bwd_ms, lib_bwd_note = None, f"{type(exc).__name__}: {str(exc)[:120]}"
    in_bytes = 2 * (2 * t * hq * D + 2 * t * hk * D)  # q, dout (or out), k, v in bf16
    bounds = {
        fwd_name: bound(4.0 * area * D * hq, 2 * (t * hq * D + 2 * t * hk * D)
                        + 2 * t * hq * D + 4 * 2 * t * hq),
        "flex_dq_sparse": bound(6.0 * area * D * hq, in_bytes + 4 * 2 * t * hq + 4 * t * hq * D),
        "flex_dkv_sparse": bound(8.0 * area * D * hq, in_bytes + 4 * 2 * t * hq
                                 + 4 * 2 * t * hk * D),
    }
    times = {
        name: {"ms": ms[name], "plain_ms": plain_ms[name], "bound_ms": bounds[name][0],
               "bound_by": bounds[name][1],
               "library_ms": {fwd_name: lib_ms, "flex_dq_sparse": lib_bwd_ms}.get(name)}
        for name in ms
    }
    rm_twin = {fwd_name: "flex_fwd_hb" if hb > 1 else "flex_fwd", "flex_dq_sparse": "flex_dq",
               "flex_dkv_sparse": "flex_dkv"}
    summary.update({"card": nvidia_smi_line(), "ms": ms, "ms_in_turns": turns,
                    "previous_walk_ms": {n: mean[f"previous:{n}"] for n in new},
                    "speedup_over_previous_walk": {n: mean[f"previous:{n}"] / ms[n] for n in new},
                    "over_row_major_same_problem": {n: ms[n] / row_major_ms[rm_twin[n]]
                                                    for n in new},
                    "share_of_bound": {n: bounds[n][0] / ms[n] for n in ms},
                    "amla_every_rise_ms": {fwd_name: mean[f"every_rise:{fwd_name}"]},
                    "amla_every_rise_errs": every_rise_errs,
                    "fwd_over_library": ms[fwd_name] / lib_ms,
                    "kernels_ms_sum": sum(ms.values()), "fwd_bwd_event_ms": fwd_bwd_event_ms,
                    "index_order_ms": index_order_ms,
                    "row_major_ms_same_problem": row_major_ms, "plain_ms": plain_ms,
                    "bound_ms": {n: b[0] for n, b in bounds.items()},
                    "library": lib_name, "library_fwd_ms": lib_ms,
                    "library_bwd_ms_for_dq_dk_dv": lib_bwd_ms, "library_bwd_note": lib_bwd_note})
    return summary, launches, times


def hetero(gen, planted) -> tuple[dict, dict]:
    """The slice's path: ``flex_flash_attn_func`` with its defaults on the
    16k varlen block-causal mask at the LlamaConfig attention widths and at
    8 / 8 heads. Returns (the phase's line, the kernels' times)."""
    from magiattention_tpu_torch.testing.workloads import split_slices, varlen_block_causal

    qr, kr, ty = split_slices(varlen_block_causal(HETERO_T))
    runs, launches, times = [], {}, {}
    for hq, hk, expect_hb in HETERO_RUNS:
        summary, counts, t = hetero_run(gen, qr, kr, ty, hq, hk, expect_hb, planted, timed=True)
        runs.append(summary)
        times.update({n: x for n, x in t.items() if n not in times})
        for n, c in counts.items():
            launches[n] = launches.get(n, 0) + c
    check(runs[0]["pairs"] == 18_758_257, f"the 16k varlen mask has {runs[0]['pairs']} pairs")
    return {"phase": "hetero", "tokens": HETERO_T, "documents": len(qr), "head_dim": D,
            "runs": runs, "launches": launches}, times


# -- block-sparse, index, sparse-load and DSA attention ------------------------------

BS_T = 16384
BS_BLOCK = 128  # the callers' blocking (the JAX package's default), not the kernel tile
DSA_TOPK = 16  # blocks of 128: 2,048 keys a q block, DeepSeek-V3.2's index top-k
BS_TQ = 8192  # (c): tq != tk
BS_DENSITY = 0.10  # (c): the share of caller tiles selected
SL_RANGES, SL_KEYS = 8, 4096  # (d): disjoint selected key ranges, keys in all
BS_KERNELS = ("flex_fwd", "flex_dq", "flex_dkv")  # head_block 1, the row-major grid


def plain_attention(q, k, v, mask, dout, dlse, sink=None) -> dict:
    """The plain version of an attention entry point: dense masked attention
    in f32 on the card over an independently built [tq, tk] bool ``mask``,
    one kv head's q heads at a time (their [G, tq, tk] scores fit), forward
    and backward by autograd. q [tq, hq, d], k/v [tk, hk, d]; ``sink`` [hq]
    logits or None. Returns token-major f32 out, lse, dq, dk, dv (and dsink);
    the lse cotangent is dropped on rows without a key, as the kernels'
    backward drops it there."""
    import torch

    tq, hq, d = q.shape
    tk, hk = k.shape[0], k.shape[1]
    g = hq // hk
    res = {n: [] for n in ("out", "lse", "dq", "dk", "dv", "dsink")}
    for j in range(hk):
        h = slice(j * g, (j + 1) * g)
        qj = q[:, h].float().transpose(0, 1).contiguous().requires_grad_()  # [g, tq, d]
        kj, vj = (x[:, j].float().contiguous().requires_grad_() for x in (k, v))  # [tk, d]
        leaves = [qj, kj, vj]
        s = torch.matmul(qj, kj.T).mul_(1.0 / math.sqrt(d)).masked_fill_(~mask, float("-inf"))
        m = s.amax(-1).detach()
        if sink is not None:
            sj = sink[h].float().detach().clone().requires_grad_()
            leaves.append(sj)
            m = torch.maximum(m, sj.detach()[:, None])
        m = torch.where(torch.isfinite(m), m, 0.0)
        p = torch.exp(s - m[..., None])
        del s
        l = p.sum(-1)
        if sink is not None:
            l = l + torch.exp(sj[:, None] - m)
        l_safe = torch.where(l > 0, l, 1.0)
        out = torch.matmul(p, vj) / l_safe[..., None]
        lse = torch.where(l > 0, m + torch.log(l_safe), float("-inf"))
        dl = torch.where(torch.isfinite(lse), dlse[:, h].float().T, 0.0)
        grads = torch.autograd.grad((out, lse), leaves,
                                    (dout[:, h].float().transpose(0, 1), dl))
        del p
        res["out"].append(out.detach().transpose(0, 1))
        res["lse"].append(lse.detach().T)
        res["dq"].append(grads[0].transpose(0, 1))
        res["dk"].append(grads[1][:, None])
        res["dv"].append(grads[2][:, None])
        if sink is not None:
            res["dsink"].append(grads[3])
    return {n: torch.cat(x, dim=0 if n == "dsink" else 1) for n, x in res.items() if x}


def block_dense_mask(bm, tq, tk, bq, bk, causal):
    """The [tq, tk] pairs a caller's block mask means, on the card: every
    token pair of a selected tile, k <= q + tk - tq under ``causal``."""
    import torch

    bm = torch.as_tensor(bm, device="cuda")
    qi, ki = torch.arange(tq, device="cuda"), torch.arange(tk, device="cuda")
    mask = bm.index_select(0, qi // bq).index_select(1, ki // bk)
    if causal:
        mask &= ki[None] <= qi[:, None] + (tk - tq)
    return mask


def entry_fwd_bwd(fn, q, k, v, dout, dlse, extra=()):
    """One forward and backward through an entry point ``fn(q, k, v,
    *extra)`` -> (out, lse); the launches it made, its host wall ms (first
    call: the plan included) and its results."""
    import torch
    from magiattention_tpu_torch import csrc

    leaves = [x.detach().requires_grad_() for x in (q, k, v, *extra)]
    torch.cuda.synchronize()
    csrc.reset_launch_counts()
    t0 = time.perf_counter()
    out, lse = fn(*leaves)
    grads = torch.autograd.grad((out, lse), leaves, (dout, dlse))
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = {n: c for n, c in csrc.launches.items() if c}
    return {"out": out.detach(), "lse": lse.detach(), "grads": grads, "launches": launches,
            "wall_ms": wall_ms}


def check_against_plain(name, got, ref, fwd, dq="flex_dq", dkv="flex_dkv") -> dict:
    """Out and lse against the plain version (the smoke's forward bounds),
    dq, dk, dv against its gradients (the three gradient checks); dsink,
    which the autograd Function computes from lse and delta rather than a
    kernel, by the same three checks. Returns dsink's errors (or {})."""
    compare(fwd, name, got["out"], ref["out"], got["lse"], ref["lse"])
    dq_, dk_, dv_ = (g.transpose(0, 1) for g in got["grads"][:3])
    compare_grads(dq, name, [("dq", dq_, ref["dq"].transpose(0, 1))])
    compare_grads(dkv, name, [("dk", dk_, ref["dk"].transpose(0, 1)),
                              ("dv", dv_, ref["dv"].transpose(0, 1))])
    if "dsink" not in ref:
        return {}
    errs, failed = grad_errors(got["grads"][3].reshape(1, -1, 1), ref["dsink"].reshape(1, -1, 1))
    check(not failed, f"{name}: dsink fails the {failed} check(s): {errs}")
    return errs


def sparse_load_ranges(rng, tk):
    """SL_RANGES disjoint key ranges of SL_KEYS keys in all, one in each
    SL_RANGES-th of [0, tk), at seeded lengths and offsets."""
    import numpy as np

    lengths = rng.integers(SL_KEYS // SL_RANGES // 2, SL_KEYS // SL_RANGES * 3 // 2,
                           SL_RANGES)
    lengths[-1] += SL_KEYS - lengths.sum()
    span = tk // SL_RANGES
    starts = [i * span + int(rng.integers(0, span - n + 1)) for i, n in enumerate(lengths)]
    return np.asarray([(s, s + int(n)) for s, n in zip(starts, lengths)], np.int64)


def block_sparse_phase(gen, seed) -> dict:
    """The block-sparse entry points at the LlamaConfig attention widths
    (16 q / 8 kv heads, d 128, bf16) on 16,384 tokens, forward and
    backward: (a) ``dsa_attn_func`` through its indexer (causal, top-16
    blocks of 128), (b) ``index_attn_func`` on (a)'s selection (must give
    (a)'s bits), (c) ``block_sparse_attn_func`` on a seeded ~10% block mask
    at tq 8192 != tk 16384, (d) ``sparse_load_attn_func`` on 8 seeded
    disjoint ranges of 4,096 keys, causal. Each runs ``flex_fwd`` then
    ``flex_dq`` + ``flex_dkv`` once and is held against
    :func:`plain_attention` on a mask built from the caller's selection; a
    plan whose causal refinement marks the crossing tiles FULL, planted on
    this side, must fail out and lse."""
    import numpy as np
    import torch
    from magiattention_tpu_torch.extensions import dsa_attn_func, dsa_topk_blocks
    from magiattention_tpu_torch.ops import block_sparse as bs
    from magiattention_tpu_torch.ops import flex_attn as fa
    from magiattention_tpu_torch.ops import index_attn_func, sparse_load_attn_func

    t, hq, hk = BS_T, TRAIN_HQ, TRAIN_HK
    rng = np.random.default_rng(seed)
    q, k, v, dout = (torch.randn((t, h, D), generator=gen, device="cuda").to(torch.bfloat16)
                     for h in (hq, hk, hk, hq))
    dlse = torch.randn((t, hq), generator=gen, device="cuda")
    blk = dict(block_q=BS_BLOCK, block_k=BS_BLOCK)
    want = {n: 1 for n in BS_KERNELS}
    runs, launches = {}, {}

    def record(name, got, **extra):
        check(got["launches"] == want, f"block_sparse {name}: launches {got['launches']}, "
              f"expected {want}")
        for n, c in got["launches"].items():
            launches[n] = launches.get(n, 0) + c
        runs[name] = {"fwd_bwd_wall_ms": got["wall_ms"], **extra}

    # (a) DSA through its indexer
    t0 = time.perf_counter()
    sel = dsa_topk_blocks(q, k, DSA_TOPK, **blk)
    indexer_ms = (time.perf_counter() - t0) * 1e3
    dsa = entry_fwd_bwd(lambda q, k, v: dsa_attn_func(q, k, v, topk=DSA_TOPK, **blk), q, k, v,
                        dout, dlse)
    bm_a = np.zeros((t // BS_BLOCK, t // BS_BLOCK), bool)
    for i, row in enumerate(sel):
        bm_a[i, row[row >= 0]] = True
    mask_a = block_dense_mask(bm_a, t, t, BS_BLOCK, BS_BLOCK, True)
    ref = plain_attention(q, k, v, mask_a, dout, dlse)
    check_against_plain("block_sparse_dsa", dsa, ref, "flex_fwd")
    record("dsa", dsa, indexer_host_ms=indexer_ms, selected_blocks=int(bm_a.sum()),
           pairs=int(mask_a.sum()))

    # (b) the same selection passed in: the same plan, the same bits
    idx = entry_fwd_bwd(lambda q, k, v: index_attn_func(q, k, v, sel, causal=True, **blk), q, k,
                        v, dout, dlse)
    same = all(torch.equal(a, b) for a, b in zip((idx["out"], idx["lse"], *idx["grads"]),
                                                  (dsa["out"], dsa["lse"], *dsa["grads"])))
    check(same, "block_sparse: index_attn_func on the DSA selection is not bitwise dsa_attn_func")
    record("index", idx, bitwise_dsa=same)

    # the planted fault: the crossing tiles' causal slice made FULL
    meta = bs.block_mask_meta(bm_a, t, t, D, causal=True, **blk)
    bounds = meta.slice_bounds.copy().reshape(-1, 5)
    bounds[1, 4] = 0
    planted = dataclasses.replace(meta, slice_bounds=bounds.reshape(-1))
    pout, plse = fa.flex_attn_with_meta(q, k, v, planted)
    _, failed = out_errors(pout, ref["out"], [("lse", plse, ref["lse"])])
    check({"out", "lse"} <= set(failed),
          f"block_sparse: the planted FULL crossing tiles were caught by {failed} only")
    del ref, mask_a

    # (c) a ~10% block mask, tq != tk, not causal
    bm_c = rng.random((BS_TQ // BS_BLOCK, t // BS_BLOCK)) < BS_DENSITY
    bsp = entry_fwd_bwd(lambda q, k, v: bs.block_sparse_attn_func(q, k, v, bm_c, **blk),
                        q[:BS_TQ], k, v, dout[:BS_TQ], dlse[:BS_TQ])
    mask_c = block_dense_mask(bm_c, BS_TQ, t, BS_BLOCK, BS_BLOCK, False)
    ref = plain_attention(q[:BS_TQ], k, v, mask_c, dout[:BS_TQ], dlse[:BS_TQ])
    check_against_plain("block_sparse_tq8192_tk16384", bsp, ref, "flex_fwd")
    record("block_sparse", bsp, selected_blocks=int(bm_c.sum()), pairs=int(mask_c.sum()))
    del ref, mask_c

    # (d) sparse load: 8 disjoint ranges, causal against global positions
    ranges = sparse_load_ranges(rng, t)
    sl = entry_fwd_bwd(lambda q, k, v: sparse_load_attn_func(q, k, v, ranges, causal=True),
                       q, k, v, dout, dlse)
    selected = torch.zeros(t, dtype=torch.bool, device="cuda")
    for a, b in ranges.tolist():
        selected[a:b] = True
    ki = torch.arange(t, device="cuda")
    mask_d = selected[None] & (ki[None] <= ki[:, None])
    ref = plain_attention(q, k, v, mask_d, dout, dlse)
    check_against_plain("sparse_load_8x4096", sl, ref, "flex_fwd")
    record("sparse_load", sl, ranges=ranges.tolist(), pairs=int(mask_d.sum()))
    del ref, mask_d
    return {"phase": "block_sparse", "tokens": t, "heads": {"hq": hq, "hk": hk, "head_dim": D},
            "caller_block": BS_BLOCK, "kernel_tile": list(fa.resolve_tile(D, None, None)),
            "runs": runs, "launches": launches,
            "planted_full_crossing_tiles_caught_by": failed}


# -- attention sinks: gpt-oss-120b's attention widths -------------------------------

SINK_B, SINK_T = 2, 8192
SINK_HQ, SINK_HK, SINK_D = 64, 8, 64  # gpt-oss-120b: 64 q / 8 kv heads, head_dim 64
SINK_WINDOW = 128  # its local layers' sliding window
SINK_SMALL_T = 1024  # the correction-path cases (ssh, shd)


def sink_phase(gen) -> dict:
    """``flash_attention_with_sink`` at gpt-oss-120b's attention widths, bf16,
    one learned sink logit per head (``sh``), batch 2 x 8,192 tokens,
    forward and backward with dsink: the 128-token sliding window of its
    local layers (the sparse grid at head_block 8: ``flex_fwd_sparse_hb``,
    ``flex_dq_sparse``, ``flex_dkv_sparse``) and full causal (row-major:
    ``flex_fwd_hb``, ``flex_dq``, ``flex_dkv``), one launch of each for the
    packed batch, against :func:`plain_attention` per sequence; then one
    small ``ssh`` and one ``shd`` case (the kernels without a sink, the
    correction after) against the same call on the plain forward
    (``MAGI_ATTENTION_KERNEL_BACKEND=torch``)."""
    import torch
    from magiattention_tpu_torch.api.functools import infer_attn_mask_from_sliding_window
    from magiattention_tpu_torch.common.mask import make_attn_mask_from_ranges
    from magiattention_tpu_torch.extensions import flash_attention_with_sink
    from magiattention_tpu_torch.ops import flex_attn as fa

    b, t, hq, hk, d = SINK_B, SINK_T, SINK_HQ, SINK_HK, SINK_D
    g = hq // hk

    def rand(t, h):
        return torch.randn((b, t, h, d), generator=gen, device="cuda").to(torch.bfloat16)

    q, k, v, dout = rand(t, hq), rand(t, hk), rand(t, hk), rand(t, hq)
    dlse = torch.randn((b, t, hq), generator=gen, device="cuda")
    logits = torch.randn((hq,), generator=gen, device="cuda")
    runs, launches = {}, {}
    kinds = {
        "window": (dict(window=SINK_WINDOW), "sparse",
                   ("flex_fwd_sparse_hb", "flex_dq_sparse", "flex_dkv_sparse")),
        "causal": (dict(causal=True), "row_major", ("flex_fwd_hb", "flex_dq", "flex_dkv")),
    }
    for name, (kw, grid, kernels) in kinds.items():
        if name == "window":
            qr, kr, ts = infer_attn_mask_from_sliding_window(t, SINK_WINDOW)
            qr, kr, ts = qr.to_naive_ranges(), kr.to_naive_ranges(), [int(x) for x in ts]
        else:
            qr, kr, ts = [(0, t)], [(0, t)], [1]
        choice = fa.auto_kernel_config(qr, kr, hq, hk, attn_type_map=ts, head_dim=d)
        check(choice == (64, 64, g, grid), f"sink {name}: the choice is {choice}, not "
              f"(64, 64, {g}, {grid!r})")
        got = entry_fwd_bwd(
            lambda q, k, v, s: flash_attention_with_sink(q, k, v, s, return_lse=True, **kw),
            q, k, v, dout, dlse, extra=(logits,))
        want = {n: 1 for n in kernels}
        check(got["launches"] == want, f"sink {name}: launches {got['launches']}, expected {want}")
        for n, c in got["launches"].items():
            launches[n] = launches.get(n, 0) + c
        mask = torch.from_numpy(make_attn_mask_from_ranges(qr, kr, ts, t, t)).to("cuda")
        refs = [plain_attention(q[i], k[i], v[i], mask, dout[i], dlse[i], sink=logits)
                for i in range(b)]
        ref = {n: torch.stack([r[n] for r in refs]) for n in ("out", "lse", "dq", "dk", "dv")}
        ref["dsink"] = sum(r["dsink"] for r in refs)
        flat = {"out": got["out"].flatten(0, 1), "lse": got["lse"].flatten(0, 1),
                "grads": tuple(x.flatten(0, 1) for x in got["grads"][:3]) + (got["grads"][3],)}
        ref_flat = {n: (x if n == "dsink" else x.flatten(0, 1)) for n, x in ref.items()}
        dsink = check_against_plain(f"sink_{name}_{b}x{t}", flat, ref_flat, *kernels)
        runs[name] = {"choice": dict(zip(("block_q", "block_k", "head_block", "grid"), choice)),
                      "fwd_bwd_wall_ms": got["wall_ms"], "pairs_per_sequence": int(mask.sum()),
                      "dsink": dsink}
        del refs, ref, mask

    # the correction path: per-row logits and value-carrying sinks
    ts_ = SINK_SMALL_T
    qs, ks, vs, ds = rand(ts_, hq), rand(ts_, hk), rand(ts_, hk), rand(ts_, hq)
    dls = torch.randn((b, ts_, hq), generator=gen, device="cuda")
    small = {"ssh": torch.randn((b, ts_, 2, hq), generator=gen, device="cuda"),
             "shd": torch.randn((2, hq, d), generator=gen, device="cuda")}
    for layout, s in small.items():
        def call(q, k, v, s, layout=layout):
            return flash_attention_with_sink(q, k, v, s, sink_layout=layout, causal=True,
                                             return_lse=True)

        got = entry_fwd_bwd(call, qs, ks, vs, ds, dls, extra=(s,))
        want = {n: 1 for n in ("flex_fwd_hb", "flex_dq", "flex_dkv")}
        check(got["launches"] == want,
              f"sink {layout}: launches {got['launches']}, expected {want}")
        for n, c in got["launches"].items():
            launches[n] = launches.get(n, 0) + c
        os.environ["MAGI_ATTENTION_KERNEL_BACKEND"] = "torch"  # the plain forward, on the card
        try:
            plain = entry_fwd_bwd(call, qs, ks, vs, ds, dls, extra=(s,))
        finally:
            os.environ.pop("MAGI_ATTENTION_KERNEL_BACKEND")
        check(not plain["launches"], f"sink {layout}: the plain run launched {plain['launches']}")
        ref = {"out": plain["out"].flatten(0, 1), "lse": plain["lse"].flatten(0, 1),
               **{n: x.flatten(0, 1) for n, x in zip(("dq", "dk", "dv"), plain["grads"])},
               "dsink": plain["grads"][3]}
        flat = {"out": got["out"].flatten(0, 1), "lse": got["lse"].flatten(0, 1),
                "grads": tuple(x.flatten(0, 1) for x in got["grads"][:3]) + (got["grads"][3],)}
        dsink = check_against_plain(f"sink_{layout}_{b}x{ts_}", flat, ref, "flex_fwd_hb")
        runs[layout] = {"fwd_bwd_wall_ms": got["wall_ms"], "dsink": dsink}
    return {"phase": "sink", "batch": b, "tokens": t,
            "heads": {"hq": hq, "hk": hk, "head_dim": d}, "sink_layout": "sh",
            "window": SINK_WINDOW, "runs": runs, "launches": launches}


# -- the host planner's cost, native emitter against the Python loops ---------------

PLAN_REPS = 9


@contextlib.contextmanager
def host_split():
    """Host ms spent in the plan builder (``build_block_meta``, as the flex
    entry points call it), in the part of it after the entries are emitted
    (``assemble_block_meta``: sorts, dummies, pads, mask flags) and in the
    tables' upload (``_device_tables``) while the block runs: yields the
    dict that collects them (``plan`` includes ``plan_assemble``)."""
    from magiattention_tpu_torch.ops import block_meta
    from magiattention_tpu_torch.ops import flex_attn as fa

    where = {"plan": (fa, "build_block_meta"), "plan_assemble": (block_meta, "assemble_block_meta"),
             "table_upload": (fa, "_device_tables")}
    spent = {part: 0.0 for part in where}
    real = {part: getattr(mod, name) for part, (mod, name) in where.items()}

    def timed(part):
        def fn(*a, **kw):
            t0 = time.perf_counter()
            try:
                return real[part](*a, **kw)
            finally:
                spent[part] += (time.perf_counter() - t0) * 1e3
        return fn

    for part, (mod, name) in where.items():
        setattr(mod, name, timed(part))
    try:
        yield spent
    finally:
        for part, (mod, name) in where.items():
            setattr(mod, name, real[part])


def planner_host() -> dict:
    """Host ms (median and range of PLAN_REPS calls each, the two builders in
    turns, on the card's host CPU) of building the plan with the native
    emitter and with ``MAGI_ATTENTION_CPP_BACKEND=0``:
    the 16k hetero mask's ``build_block_meta``, the serving path's
    4096-token causal prefill's, and the cp_attn cold key's host planning
    (dispatch meta + ``build_dist_attn_plan`` at cp 2 degree 0 and cp 4
    degree 2, in this process: the ranks add their process-group calls and
    uploads). Then a 4096-token serving prefill at the serving widths split
    on the host clock into the plan, the table upload and the rest, cold
    (plan and tables built) and warm (both cached). Printed, not claimed."""
    import gc
    import statistics

    import torch
    from magiattention_tpu_torch.common import AttnMaskType, AttnRanges
    from magiattention_tpu_torch.meta import make_dispatch_meta_from_qk_ranges
    from magiattention_tpu_torch.meta.solver.overlap_solver import OverlapConfig
    from magiattention_tpu_torch.ops import flex_attn as fa
    from magiattention_tpu_torch.parallel.dist_attn import build_dist_attn_plan
    from magiattention_tpu_torch.serving import ServingEngine
    from magiattention_tpu_torch.testing.workloads import split_slices, varlen_block_causal

    qr, kr, ty = split_slices(varlen_block_causal(HETERO_T))

    def cold_key(cp, degree):
        mq, _, bucket = make_dispatch_meta_from_qk_ranges(
            AttnRanges.from_ranges(qr), AttnRanges.from_ranges(kr),
            [AttnMaskType(t) for t in ty], HETERO_T, HETERO_T, CP_CHUNK, cp)
        build_dist_attn_plan(mq, bucket, block_q=BLOCK, block_k=BLOCK,
                             overlap_config=OverlapConfig(degree=degree))

    cases = {
        "hetero_16k": lambda: fa.build_block_meta(qr, kr, ty, HETERO_T, HETERO_T,
                                                  block_q=BLOCK, block_k=BLOCK),
        "serving_prefill_4096": lambda: fa.build_block_meta([(0, 4096)], [(0, 4096)], [1], 4096,
                                                            4096, block_q=BLOCK, block_k=BLOCK),
        "cp_attn_cold_key_cp2": lambda: cold_key(2, 0),
        "cp_attn_cold_key_cp4": lambda: cold_key(4, 2),
    }

    # the two builders in turns (native, Python, then Python, native, ...),
    # each call after a garbage collection, so that neither inherits the
    # other's garbage or a drift of the host
    runs = {name: {"native": [], "python": []} for name in cases}
    try:
        for rep in range(PLAN_REPS):
            turns = (("native", "1"), ("python", "0"))
            for label, flag in turns if rep % 2 == 0 else turns[::-1]:
                os.environ["MAGI_ATTENTION_CPP_BACKEND"] = flag
                for name, fn in cases.items():
                    gc.collect()
                    t0 = time.perf_counter()
                    fn()
                    runs[name][label].append((time.perf_counter() - t0) * 1e3)
    finally:
        os.environ.pop("MAGI_ATTENTION_CPP_BACKEND")
    plan_ms = {n: {lb: statistics.median(ts) for lb, ts in r.items()} for n, r in runs.items()}
    plan_ms_range = {n: {lb: [min(ts), max(ts)] for lb, ts in r.items()} for n, r in runs.items()}

    # the serving prefill, split into the plan, the table upload and the rest
    engine = ServingEngine(num_pages=256, num_kv_heads=HK, head_dim=D, page_size=PAGE,
                           max_seqs=4, max_pages_per_seq=64, dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(1)
    t = 4096
    q = torch.randn((t, HQ, D), generator=gen, device="cuda").to(torch.bfloat16)
    kv = torch.randn((2, t, HK, D), generator=gen, device="cuda").to(torch.bfloat16)
    split = {"cold": [], "warm": []}
    for rep in range(2 * PLAN_REPS + 1):
        which = "cold" if rep % 2 == 0 else "warm"
        if which == "cold":
            for cache in (fa._cached_meta, fa.fwd_tables, fa.bwd_tables):
                cache.cache_clear()
        slot = engine.admit(t).slot
        gc.collect()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with host_split() as spent:
            engine.prefill(q, kv[0], kv[1], slot)
            torch.cuda.synchronize()
        total = (time.perf_counter() - t0) * 1e3
        engine.free(slot)
        if rep:  # the first call also loads the kernel library
            split[which].append({"total": total, **spent,
                                 "rest": total - spent["plan"] - spent["table_upload"]})
    prefill_split = {w: {p: statistics.median(r[p] for r in rs) for p in rs[0]}
                     for w, rs in split.items()}
    return {"phase": "planner_host", "card": nvidia_smi_line(), "clock": "host",
            "reps": PLAN_REPS, "plan_ms": plan_ms, "plan_ms_range": plan_ms_range,
            "native_over_python": {n: x["native"] / x["python"] for n, x in plan_ms.items()},
            "serving_prefill_4096_split_ms": prefill_split}


# -- context parallelism: cp ranks as processes sharing the card ------------------

CP_ATTN_T = HETERO_T  # varlen_block_causal(16384), the hetero mask
CP_CHUNK = 512
CP_ATTN_HEADS = ((TRAIN_HQ, TRAIN_HK), (8, 8))  # head_block 2 -> flex_fwd_hb; G = 1 -> flex_fwd
CP_RUNS = ((2, 0), (4, 2))  # (cp ranks, overlap degree)
CP_KERNELS = ("flex_fwd", "flex_fwd_hb", "flex_dq", "flex_dkv")
CP_OPS = ("all_to_all_single", "batch_isend_irecv", "all_gather", "all_reduce")
# cp vs cp=1 training on one seed, both in bf16 with fp32 masters: the
# attention sums its keys in another order and tile split (degree 0: own
# rows then received rows in one buffer; degree 2: three partials merged
# in f32), and the gradients are summed over the ranks; each bf16 product
# rounds at ~4e-3 relative, averaged over the 8192 tokens of the loss. So a
# step's loss may move by a few 1e-3 of its ~10.4 and each parameter's
# gradient by ~1e-2 relative L2; a lost dK/dV reduce or a wrong shard moves
# the attention weights' gradients by O(1).
CP_LOSS_ATOL = 2e-2
CP_GRAD_REL_L2 = 5e-2


def cp_rank_setup():
    """A cp rank's process: the card, and the plain versions in full f32."""
    import torch

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def cp_comm_facts(group) -> dict:
    """The group's backend and which collectives it stages through host
    buffers for CUDA tensors (``comm.group_collective.staging``)."""
    import torch
    import torch.distributed as dist
    from magiattention_tpu_torch.comm.group_collective import staging

    dev = torch.device("cuda", 0)
    return {"backend": dist.get_backend(group),
            "staged_through_host": [op for op in CP_OPS if staging(group, dev, op)]}


def _cp_stage_check(cap) -> dict:
    """The captured kernel call of this rank's plan (its tables, run
    translation, received rows and kv_pad) against the plain versions on
    the same inputs, one kv head's q heads at a time: the forward, and the
    backward kernels on the cotangents that reached the call."""
    import torch
    from magiattention_tpu_torch.ops import flex_attn as fa

    qh, kh, vh, ftab, btab, params, sink = cap["args"]
    out, lse = cap["out"], cap["lse"]
    hq, hk = qh.shape[0], kh.shape[0]
    g = hq // hk
    fwd_name = "flex_fwd_hb" if params.head_block > 1 else "flex_fwd"
    sink1d = torch.zeros((hq,), device=qh.device) if sink is None else sink.float()
    dout = cap["dout"]
    dlse = cap.get("dlse")
    if dlse is None:  # an lse that reaches no loss gets no cotangent
        dlse = torch.zeros_like(lse)
    do = dout.to(qh.dtype)
    delta = (dout.float() * out.float()).sum(-1) - dlse.float()
    dq = fa._dq_kernel(qh, kh, vh, do, lse, delta, ftab, params)
    dk, dv = fa._dkv_kernel(qh, kh, vh, do, lse, delta, btab, params)
    errs = {}
    for j in range(hk):
        hs = slice(j * g, (j + 1) * g)
        ks = slice(j, j + 1)
        ref_out, ref_lse, _ = fa._fwd_torch(qh[hs], kh[ks], vh[ks], sink1d[hs], ftab, params)
        e, failed = out_errors(out[hs], ref_out, [("lse", lse[hs], ref_lse)])
        check(not failed, f"cp stage call: {fwd_name} kv head {j} fails {failed}: {e}")
        errs[fwd_name] = max(errs.get(fwd_name, 0.0), e["out_max_abs_err"])
        args = (qh[hs], kh[ks], vh[ks], do[hs], lse[hs], delta[hs])
        ref_dq = fa._dq_torch(*args, ftab, params)
        ref_dk, ref_dv = fa._dkv_torch(*args, btab, params)
        for kernel, what, got, ref in (("flex_dq", "dq", dq[hs], ref_dq),
                                       ("flex_dkv", "dk", dk[ks], ref_dk),
                                       ("flex_dkv", "dv", dv[ks], ref_dv)):
            e, failed = grad_errors(got, ref)
            check(not failed, f"cp stage call: {what} kv head {j} fails {failed}: {e}")
            errs[kernel] = max(errs.get(kernel, 0.0), e["max_abs_err"])
    return {"kernel_max_abs_err": errs, "kv_pad": int(kh.shape[1]),
            "q_pad": int(qh.shape[1])}


def capturing(real_core, cap: dict):
    """A stand-in for ``flex_attn_headmajor`` that calls ``real_core`` and
    keeps the last call's operands, results and the cotangents that reach
    them in ``cap`` (no extra launch), for ``_cp_stage_check``. Only the
    kept call's cotangents are kept: an earlier call (a model's earlier
    layer) gets its cotangent later in the backward."""
    import torch

    def capture(qh, kh, vh, ftab, btab, params, sink=None):
        out_h, lse_h, rowmax = real_core(qh, kh, vh, ftab, btab, params, sink=sink)
        cap.clear()
        call = object()
        cap.update(call=call, args=tuple(x.detach() if torch.is_tensor(x) else x
                                         for x in (qh, kh, vh, ftab, btab, params, sink)),
                   out=out_h.detach(), lse=lse_h.detach())

        def keep(name):
            def hook(g):
                if cap.get("call") is call:
                    cap[name] = g
            return hook

        out_h.register_hook(keep("dout"))
        lse_h.register_hook(keep("dlse"))
        return out_h, lse_h, rowmax

    return capture


def vs_single_card(got, q, k, v, g_out, g_lse, qr, kr, ty, hq, hk) -> tuple[dict, list]:
    """The gathered (out, lse, dq, dk, dv) of a cp run against single-card
    ``flex_flash_attn_func`` pinned to the row-major grid on the same
    inputs and cotangents: (errors, failed checks)."""
    import torch
    from magiattention_tpu_torch.ops.flex_attn import flex_flash_attn_func

    out, lse, dq, dk, dv = got
    qs, ks, vs = (x.detach().requires_grad_() for x in (q, k, v))
    ro, rl = flex_flash_attn_func(qs, ks, vs, qr, kr, ty, block_q=BLOCK, block_k=BLOCK,
                                  head_block=hq // hk, grid="row_major")
    loss = (ro.float() * g_out.float()).sum() + torch.where(
        torch.isfinite(rl), rl * g_lse, 0.0).sum()
    loss.backward()
    errs, failed = out_errors(out, ro.detach(), [("lse", lse, rl.detach())])
    for what, g, ref in (("dq", dq, qs.grad), ("dk", dk, ks.grad), ("dv", dv, vs.grad)):
        e, f = grad_errors(g.transpose(0, 1), ref.transpose(0, 1))
        errs.update({f"{what}_{n}": x for n, x in e.items()})
        failed += [f"{what}:{c}" for c in f]
    return errs, failed


def keyed_fwd_bwd(key, q, k, v, g_out, g_lse, cross=False):
    """``dispatch`` (``dispatch_kv`` for a cross key's memory) ->
    ``calc_attn`` -> ``undispatch``, and the backward of sum(out * g_out) +
    sum(lse * g_lse) over the covered rows: the gathered (out, lse, dq, dk,
    dv)."""
    import torch
    from magiattention_tpu_torch import api

    qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
    kv = api.dispatch_kv if cross else api.dispatch
    out_l, meta = api.calc_attn(api.dispatch(qg, key), kv(kg, key), kv(vg, key), key)
    out, lse = api.undispatch(out_l, key), api.undispatch(meta.lse, key)
    loss = (out.float() * g_out.float()).sum() + torch.where(
        torch.isfinite(lse), lse * g_lse, 0.0).sum()
    loss.backward()
    return out.detach(), lse.detach(), qg.grad, kg.grad, vg.grad


@in_rank
def cp_attn_rank(group, hq: int, hk: int, degree: int, seed: int, stage_check: bool,
                 skip_reduce: bool = False) -> dict:
    """One rank of the keyed cp API on the card: ``magi_attn_varlen_key``'s
    flex twin on the hetero mask -> ``dispatch`` -> ``calc_attn`` ->
    ``undispatch``, forward and backward (bf16, d 128, random out and lse
    cotangents); its kernel launches; a second, timed run; on rank 0 the
    gathered out, lse, dq, dk, dv against single-card
    ``flex_flash_attn_func`` pinned to the row-major grid on the same
    inputs; with ``stage_check`` its last kernel call against the plain
    versions. ``skip_reduce`` plants the fault of a cast whose backward
    drops the received rows' dK/dV (rank 0 then returns the failed checks
    instead of raising)."""
    import torch
    import torch.distributed as dist
    from magiattention_tpu_torch import api, csrc
    from magiattention_tpu_torch.comm import group_collective as gc
    from magiattention_tpu_torch.config import DistAttnConfig
    from magiattention_tpu_torch.meta.solver.overlap_solver import OverlapConfig
    from magiattention_tpu_torch.parallel import dist_attn
    from magiattention_tpu_torch.testing.workloads import split_slices, varlen_block_causal

    cp_rank_setup()
    rank, t = dist.get_rank(group), CP_ATTN_T
    qr, kr, ty = split_slices(varlen_block_causal(t))
    gen = torch.Generator(device="cuda").manual_seed(seed)  # the same inputs on every rank
    q, k, v, g_out = (torch.randn((t, h, D), generator=gen, device="cuda", dtype=torch.bfloat16)
                      for h in (hq, hk, hk, hq))
    g_lse = torch.randn((t, hq), generator=gen, device="cuda")
    key = api.magi_attn_flex_key(
        qr, kr, ty, t, t, group, num_heads=(hq, hk), head_dim=D, chunk_size=CP_CHUNK,
        dist_attn_config=DistAttnConfig(overlap_config=OverlapConfig(degree=degree)),
    )  # the card, by default
    plan = api.get_runtime_mgr(key).plan
    cap = {}
    real_core, real_bwd = dist_attn.flex_attn_headmajor, gc.GroupCast.backward
    if skip_reduce:
        gc.GroupCast.backward = staticmethod(
            lambda ctx, g: (g.new_zeros((ctx.rt.num_local_rows,) + tuple(g.shape[1:])), None, None))
    if stage_check:
        dist_attn.flex_attn_headmajor = capturing(real_core, cap)
    try:
        torch.cuda.synchronize()
        csrc.reset_launch_counts()
        got = keyed_fwd_bwd(key, q, k, v, g_out, g_lse)
        torch.cuda.synchronize()
        launches = {n: csrc.launches[n] for n in FLEX_KERNELS if csrc.launches[n]}
    finally:
        dist_attn.flex_attn_headmajor, gc.GroupCast.backward = real_core, real_bwd
    res = {"rank": rank, "launches": launches, **cp_comm_facts(group),
           "overlap_degree": plan.overlap_degree, "impls": [c.impl for c in plan.comms()],
           "recv_rows": [list(c.recv_total) for c in plan.comms()],
           "shard_rows": plan.shard_q_len}
    if stage_check:
        res["stage_check"] = _cp_stage_check(cap)
    if not skip_reduce:  # a second run, timed (the ranks share the card)
        dist.barrier(group)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        keyed_fwd_bwd(key, q, k, v, g_out, g_lse)
        torch.cuda.synchronize()
        res["fwd_bwd_ms_ranks_sharing_one_card"] = (time.perf_counter() - t0) * 1e3
        res["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
    if rank == 0:  # the gathered results against the single-card kernel path
        errs, failed = vs_single_card(got, q, k, v, g_out, g_lse, qr, kr, ty, hq, hk)
        res.update(vs_single_card=errs, failed=failed)
        if not skip_reduce:
            check(not failed, f"cp={dist.get_world_size(group)} degree {degree} heads "
                  f"{hq}/{hk}: the gathered results fail {failed}: {errs}")
    return res


def cp_attn(pools, seed: int) -> dict:
    """The keyed cp API at cp=2 (degree 0) and cp=4 (degree 2), 16 / 8 and
    8 / 8 heads, auto group-collective impl; one stage call per rank held
    against the plain versions (cp=2 at 16 / 8, cp=4 at 8 / 8); the planted
    skip of the dK/dV reduce must fail the dk / dv checks."""
    runs, launches = [], {}
    for cp, degree in CP_RUNS:
        for hq, hk in CP_ATTN_HEADS:
            check_stage = (cp == 2) == (hq != hk)
            res = pools[cp].run(cp_attn_rank, hq, hk, degree, seed, check_stage)
            for r in res:
                for n, c in r["launches"].items():
                    launches[n] = launches.get(n, 0) + c
                for n, e in r.get("stage_check", {}).get("kernel_max_abs_err", {}).items():
                    MAX_ERR[n] = max(MAX_ERR[n], e)
            fwd = "flex_fwd_hb" if hq > hk else "flex_fwd"
            for r in res:
                check(set(r["launches"]) == {fwd, "flex_dq", "flex_dkv"},
                      f"cp={cp} heads {hq}/{hk} rank {r['rank']}: launches {r['launches']}")
            runs.append({"cp": cp, "overlap_degree": res[0]["overlap_degree"], "heads": [hq, hk],
                         "impls": res[0]["impls"], "recv_rows": res[0]["recv_rows"],
                         "backend": res[0]["backend"],
                         "staged_through_host": res[0]["staged_through_host"],
                         "launches_per_rank": [r["launches"] for r in res],
                         "vs_single_card": res[0]["vs_single_card"],
                         "stage_checks": [r["stage_check"] for r in res if "stage_check" in r],
                         "fwd_bwd_ms_ranks_sharing_one_card": [
                             r["fwd_bwd_ms_ranks_sharing_one_card"] for r in res],
                         "max_memory_allocated_bytes": [r["max_memory_allocated_bytes"]
                                                        for r in res]})
            check(res[0]["overlap_degree"] == degree,
                  f"cp={cp}: the plan has degree {res[0]['overlap_degree']}, not {degree}")
    planted = pools[2].run(cp_attn_rank, 8, 8, 0, seed, False, True)[0]
    caught = {c.split(":")[0] for c in planted["failed"]}
    check({"dk", "dv"} <= caught and not caught - {"dk", "dv"},
          f"the planted skip of the dK/dV reduce: failed checks {planted['failed']}, "
          "expected dk and dv only")
    return {"phase": "cp_attn", "tokens": CP_ATTN_T, "chunk": CP_CHUNK, "head_dim": D,
            "dtype": "bfloat16", "note": "times with the cp ranks sharing one card: not cp speeds",
            "runs": runs, "launches": launches,
            "planted_skip_dkv_reduce": {"caught": sorted(caught), "failed": planted["failed"]}}


CP_QO_RUNS = (  # (cp ranks, hq, hk, group-collective impl, with a sink)
    (2, TRAIN_HQ, TRAIN_HK, "auto", True),
    (4, 8, 8, "a2a", False),
)
CP_QO_KERNELS = ("flex_fwd", "flex_dq", "flex_dkv")  # head_block 1 at every G, as JAX's qo branch


def drop_remote_partials():
    """Plant an O-return reduce that loses every partial computed on another
    rank: each such row arrives as (0, -inf). Returns a function that puts
    the real reduce back."""
    import torch
    from magiattention_tpu_torch.comm import group_collective as gc

    real = gc.return_rows

    def dropping(y, rt, group, fill=0.0):
        parts = real(y, rt, group, fill)
        if rt.impl == "hops":
            remote = [torch.full((rows.shape[0],), bool(h.shift % rt.cp_size), device=rows.device)
                      for h, (rows, _) in zip(rt.hops, parts)]
        else:  # a2a: block i of the returned buffer came from rank i
            remote = [(rt.back_pos // rt.max_send) != rt.rank]
        return [(torch.where(m.view((-1,) + (1,) * (rows.ndim - 1)), torch.full_like(rows, fill),
                             rows), seg) for (rows, seg), m in zip(parts, remote)]

    gc.return_rows = dropping

    def restore():
        gc.return_rows = real

    return restore


@in_rank
def cp_qo_attn_rank(group, hq: int, hk: int, impl: str, with_sink: bool, seed: int,
                    stage_check: bool, drop_remote: bool = False) -> dict:
    """One rank of qo-comm through the keyed API on the card:
    ``MAGI_ATTENTION_QO_COMM=1`` -> ``magi_attn_flex_key`` on the hetero mask
    -> ``dispatch`` -> ``calc_attn`` -> ``undispatch``, forward and backward
    (bf16, d 128, random out and lse cotangents, and with ``with_sink`` a
    trainable [hq] f32 sink from the seed); the plan's facts and the first
    key's host ms; its kernel launches; a second, timed run; on rank 0 the
    gathered out, lse, dq, dk, dv (and dsink) against single-card
    ``flex_flash_attn_func`` pinned to the row-major grid with the same
    sink; with ``stage_check`` its kernel call against the plain versions.
    ``drop_remote`` plants an O-return reduce that drops every remote
    partial (rank 0 then returns the failed checks instead of raising). The
    flags are set for this task only."""
    import torch
    import torch.distributed as dist
    from magiattention_tpu_torch import api, csrc
    from magiattention_tpu_torch.ops.flex_attn import flex_flash_attn_func
    from magiattention_tpu_torch.parallel import QoCommPlan, qo_comm
    from magiattention_tpu_torch.testing.workloads import split_slices, varlen_block_causal

    cp_rank_setup()
    saved = {n: os.environ.get(n) for n in ("MAGI_ATTENTION_QO_COMM",
                                            "MAGI_ATTENTION_GROUP_COLL_IMPL")}
    os.environ["MAGI_ATTENTION_QO_COMM"] = "1"
    os.environ["MAGI_ATTENTION_GROUP_COLL_IMPL"] = impl
    restore = drop_remote_partials() if drop_remote else None
    real_core = qo_comm.flex_attn_headmajor
    try:
        rank, t = dist.get_rank(group), CP_ATTN_T
        qr, kr, ty = split_slices(varlen_block_causal(t))
        gen = torch.Generator(device="cuda").manual_seed(seed)  # the same inputs on every rank
        q, k, v, g_out = (torch.randn((t, h, D), generator=gen, device="cuda",
                                      dtype=torch.bfloat16) for h in (hq, hk, hk, hq))
        g_lse = torch.randn((t, hq), generator=gen, device="cuda")
        sink = torch.randn((hq,), generator=gen, device="cuda") if with_sink else None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        key = api.magi_attn_flex_key(qr, kr, ty, t, t, group, num_heads=(hq, hk), head_dim=D,
                                     chunk_size=CP_CHUNK, sink=sink)  # the card, by default
        key_ms = (time.perf_counter() - t0) * 1e3
        plan = api.get_runtime_mgr(key).plan
        check(isinstance(plan, QoCommPlan), f"MAGI_ATTENTION_QO_COMM=1 planned {type(plan)}")

        def run():
            qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
            sg = None if sink is None else sink.detach().requires_grad_()
            out_l, meta = api.calc_attn(*(api.dispatch(x, key) for x in (qg, kg, vg)), key,
                                        sink=sg)
            out, lse = api.undispatch(out_l, key), api.undispatch(meta.lse, key)
            loss = (out.float() * g_out.float()).sum() + torch.where(
                torch.isfinite(lse), lse * g_lse, 0.0).sum()
            loss.backward()
            return (out.detach(), lse.detach(), qg.grad, kg.grad, vg.grad,
                    None if sg is None else sg.grad)

        cap = {}
        if stage_check:
            qo_comm.flex_attn_headmajor = capturing(real_core, cap)
        torch.cuda.synchronize()
        csrc.reset_launch_counts()
        out, lse, dq, dk, dv, dsink = run()
        torch.cuda.synchronize()
        launches = {n: csrc.launches[n] for n in FLEX_KERNELS if csrc.launches[n]}
        qo_comm.flex_attn_headmajor = real_core
        res = {"rank": rank, "launches": launches, **cp_comm_facts(group),
               "key_host_ms": key_ms, "impls": [plan.comm_q.impl, plan.comm_kv.impl],
               "recv_total": {"q": plan.comm_q.recv_total[rank],
                              "kv": plan.comm_kv.recv_total[rank]},
               "q_buf_pad": plan.q_buf_pad, "kv_buf_pad": plan.kv_buf_pad,
               "rank_areas": list(plan.rank_areas), "shard_rows": plan.shard_len,
               "q_remote_rows": plan.comm_q.true_rows_total - plan.comm_q.local_rows_total}
        if stage_check:
            res["stage_check"] = _cp_stage_check(cap)
        if not drop_remote:  # a second run, timed (the ranks share the card)
            dist.barrier(group)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            res["fwd_bwd_ms_ranks_sharing_one_card"] = (time.perf_counter() - t0) * 1e3
            res["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
        if rank == 0:  # the gathered results against the single-card kernel path
            qs, ks, vs = (x.detach().requires_grad_() for x in (q, k, v))
            ss = None if sink is None else sink.detach().requires_grad_()
            ro, rl = flex_flash_attn_func(qs, ks, vs, qr, kr, ty, sink=ss, block_q=BLOCK,
                                          block_k=BLOCK, head_block=hq // hk, grid="row_major")
            loss = (ro.float() * g_out.float()).sum() + torch.where(
                torch.isfinite(rl), rl * g_lse, 0.0).sum()
            loss.backward()
            errs, failed = out_errors(out, ro.detach(), [("lse", lse, rl.detach())])
            pairs = [("dq", dq.transpose(0, 1), qs.grad.transpose(0, 1)),
                     ("dk", dk.transpose(0, 1), ks.grad.transpose(0, 1)),
                     ("dv", dv.transpose(0, 1), vs.grad.transpose(0, 1))]
            if sink is not None:  # [hq] as one [1, hq, 1] tensor
                pairs.append(("dsink", dsink.view(1, -1, 1), ss.grad.view(1, -1, 1)))
            for what, got, ref in pairs:
                e, f = grad_errors(got, ref)
                errs.update({f"{what}_{n}": x for n, x in e.items()})
                failed += [f"{what}:{c}" for c in f]
            res.update(vs_single_card=errs, failed=failed)
            if not drop_remote:
                check(not failed, f"qo cp={dist.get_world_size(group)} heads {hq}/{hk} "
                      f"{impl}: the gathered results fail {failed}: {errs}")
        return res
    finally:
        qo_comm.flex_attn_headmajor = real_core
        if restore is not None:
            restore()
        for n, val in saved.items():
            if val is None:
                os.environ.pop(n, None)
            else:
                os.environ[n] = val


def cp_qo_attn(pools, seed: int) -> dict:
    """qo-comm through the keyed API: cp=2 at 16 / 8 heads with the auto
    group-collective impl and a trainable sink, cp=4 at 8 / 8 on a2a; each
    rank launches ``flex_fwd``, ``flex_dq`` and ``flex_dkv`` once per
    forward + backward; each rank's kernel call of the first run against
    the plain versions; a planted O-return reduce that drops the remote
    partials must fail out and lse."""
    runs, launches = [], {}
    for i, (cp, hq, hk, impl, with_sink) in enumerate(CP_QO_RUNS):
        res = pools[cp].run(cp_qo_attn_rank, hq, hk, impl, with_sink, seed, i == 0)
        for r in res:
            check(r["launches"] == {n: 1 for n in CP_QO_KERNELS},
                  f"qo cp={cp} heads {hq}/{hk} rank {r['rank']}: launches {r['launches']}, "
                  f"expected one each of {CP_QO_KERNELS}")
            for n, c in r["launches"].items():
                launches[n] = launches.get(n, 0) + c
            for n, e in r.get("stage_check", {}).get("kernel_max_abs_err", {}).items():
                MAX_ERR[n] = max(MAX_ERR[n], e)
        check(res[0]["q_remote_rows"] > 0, f"qo cp={cp}: the plan moves no Q rows, so the "
              "LSE reduce carries no remote partial")
        runs.append({"cp": cp, "heads": [hq, hk], "impl_flag": impl, "sink": with_sink,
                     "impls": res[0]["impls"], "backend": res[0]["backend"],
                     "staged_through_host": res[0]["staged_through_host"],
                     "recv_total_per_rank": [r["recv_total"] for r in res],
                     "q_buf_pad": res[0]["q_buf_pad"], "kv_buf_pad": res[0]["kv_buf_pad"],
                     "rank_areas": res[0]["rank_areas"], "q_remote_rows": res[0]["q_remote_rows"],
                     "key_host_ms_per_rank": [r["key_host_ms"] for r in res],
                     "launches_per_rank": [r["launches"] for r in res],
                     "vs_single_card": res[0]["vs_single_card"],
                     "stage_checks": [r["stage_check"] for r in res if "stage_check" in r],
                     "fwd_bwd_ms_ranks_sharing_one_card": [
                         r["fwd_bwd_ms_ranks_sharing_one_card"] for r in res],
                     "max_memory_allocated_bytes": [r["max_memory_allocated_bytes"]
                                                    for r in res]})
    cp, hq, hk, impl, _ = CP_QO_RUNS[1]
    planted = pools[cp].run(cp_qo_attn_rank, hq, hk, impl, False, seed, False, True)[0]
    caught = {c.split(":")[0] for c in planted["failed"]}
    check("out" in caught and any(c.startswith("lse") for c in caught),
          f"the planted drop of remote partials: failed checks {planted['failed']}, "
          "expected out and lse among them")
    return {"phase": "cp_qo_attn", "tokens": CP_ATTN_T, "chunk": CP_CHUNK, "head_dim": D,
            "dtype": "bfloat16", "note": "ranks sharing one card: not cp speeds",
            "runs": runs, "launches": launches,
            "planted_drop_remote_partials": {"caught": sorted(caught),
                                             "failed": planted["failed"]}}


@in_rank
def cp_training_rank(group, degree: int, seed: int, cp1_grads: str, steps: int,
                     hier: tuple | None = None) -> dict:
    """One rank of the Llama trainer under cp on the card: the ``training``
    phase's model, batch and weights from ``seed``, this rank's shard,
    ``steps`` AdamW steps; rank 0 holds the first step's gradients (summed
    over the ranks) against cp=1's, saved by the ``training`` phase, and
    the first step's last kernel call against the plain versions.
    ``hier`` = (n_inter, n_intra) builds the model over the hierarchical
    groups of that layout."""
    import torch
    import torch.distributed as dist
    from magiattention_tpu_torch import csrc
    from magiattention_tpu_torch.api import infer_varlen_mask_from_batch
    from magiattention_tpu_torch.meta.solver.overlap_solver import OverlapConfig
    from magiattention_tpu_torch.models import LlamaConfig, build_magi_llama, make_model_train_step
    from magiattention_tpu_torch.parallel import dist_attn

    cp_rank_setup()
    rank = dist.get_rank(group)
    cfg = dataclasses.replace(LlamaConfig(), n_layers=TRAIN_LAYERS)
    total = sum(TRAIN_DOCS)
    qr, kr, ts = infer_varlen_mask_from_batch(TRAIN_DOCS)
    torch.cuda.reset_peak_memory_stats()
    cp_group = hier_cp_groups(group, hier) if hier else group
    model = build_magi_llama(cfg, total, qr, kr, ts, seed=seed, cp_group=cp_group,
                             chunk_size=CP_CHUNK, overlap_config=OverlapConfig(degree=degree))
    gen = torch.Generator(device="cuda").manual_seed(seed)  # the training phase's batch
    tokens = torch.randint(0, cfg.vocab_size, (total,), generator=gen, device="cuda")
    labels = torch.roll(tokens, -1)
    tok, lab = model.shard(tokens), model.shard(labels)
    pos = model.position_ids().cuda()
    step = make_model_train_step(model, torch.optim.AdamW(model.parameters(), **ADAMW))
    losses, step_ms, grad_rel_l2, cap = [], [], None, {}
    real_core = dist_attn.flex_attn_headmajor
    if rank == 0:  # keep the first step's last kernel call (no extra launch)
        dist_attn.flex_attn_headmajor = capturing(real_core, cap)
    csrc.reset_launch_counts()
    try:
        for i in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(float(step(tok, lab, pos)))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            dist_attn.flex_attn_headmajor = real_core
            if i == 0 and rank == 0:
                ref = torch.load(cp1_grads)
                grad_rel_l2 = [float((p.grad - r.cuda()).norm() / r.norm())
                               for p, r in zip(model.parameters(), ref)]
                del ref
    finally:
        dist_attn.flex_attn_headmajor = real_core
    launches = {n: csrc.launches[n] for n in FLEX_KERNELS if csrc.launches[n]}
    stage = _cp_stage_check(cap) if rank == 0 else None
    cap.clear()
    return {"rank": rank, "losses": losses, "step_ms": step_ms, "stage_check": stage,
            "launches": launches, "grad_rel_l2": grad_rel_l2,
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
            "head_block": model.head_block, "overlap_degree": model.plan.overlap_degree,
            "impls": [c.impl for c in model.plan.comms()], "hier": model.plan.hier,
            **cp_comm_facts(group)}


def cp_training(pools, seed: int, cp1: dict, runs_of=CP_RUNS, hier=None,
                phase="cp_training") -> dict:
    """The training phase's trainer at cp=2 (degree 0) and cp=4 (degree 2),
    or over ``hier``'s two-level groups at the (cp, degree) of ``runs_of``:
    every step's loss within CP_LOSS_ATOL of cp=1's, the first step's
    gradients of every parameter within CP_GRAD_REL_L2 relative L2, rank
    0's first-step kernel call against the plain versions."""
    runs, launches = [], {}
    for cp, degree in runs_of:
        res = pools[cp].run(cp_training_rank, degree, seed, cp1["grads_path"], TRAIN_STEPS, hier)
        check(res[0]["hier"] == (tuple(hier) if hier else None),
              f"cp={cp}: the plan's layout is {res[0]['hier']}, not {hier}")
        for r in res:
            check(r["losses"] == res[0]["losses"], f"cp={cp}: the ranks report other losses")
            check(set(r["launches"]) == set(TRAINING_KERNELS),
                  f"cp={cp} rank {r['rank']}: launches {r['launches']}, expected "
                  f"{TRAINING_KERNELS}")
            for n, c in r["launches"].items():
                launches[n] = launches.get(n, 0) + c
        diffs = [abs(a - b) for a, b in zip(res[0]["losses"], cp1["losses"])]
        check(max(diffs) <= CP_LOSS_ATOL,
              f"cp={cp}: losses {res[0]['losses']} vs cp=1 {cp1['losses']}")
        worst = max(res[0]["grad_rel_l2"])
        check(worst <= CP_GRAD_REL_L2,
              f"cp={cp}: a first-step gradient is {worst} relative L2 from cp=1's")
        for n, e in res[0]["stage_check"]["kernel_max_abs_err"].items():
            MAX_ERR[n] = max(MAX_ERR[n], e)
        runs.append({"cp": cp, "hier": res[0]["hier"], "overlap_degree": res[0]["overlap_degree"],
                     "impls": res[0]["impls"], "head_block": res[0]["head_block"],
                     "backend": res[0]["backend"],
                     "staged_through_host": res[0]["staged_through_host"],
                     "losses": res[0]["losses"], "loss_abs_diff_vs_cp1": diffs,
                     "grad_rel_l2_vs_cp1_max": worst, "stage_check": res[0]["stage_check"],
                     "step_ms_ranks_sharing_one_card": [r["step_ms"] for r in res],
                     "max_memory_allocated_bytes_per_rank": [r["max_memory_allocated_bytes"]
                                                             for r in res],
                     "launches_per_rank": [r["launches"] for r in res]})
    return {"phase": phase, "docs": TRAIN_DOCS, "chunk": CP_CHUNK,
            "layers": TRAIN_LAYERS, "steps": TRAIN_STEPS, "cp1_losses": cp1["losses"],
            "tolerance": {"loss_abs": CP_LOSS_ATOL, "grad_rel_l2": CP_GRAD_REL_L2},
            "note": "times with the cp ranks sharing one card: not cp speeds",
            "runs": runs, "launches": launches}


# -- the trainer's parallel layouts: dp, tp, pp as ranks sharing the card ----------

PAR_LAYOUTS = (  # row-major over (pp, dp, cp, tp), as the JAX mesh
    dict(dp=2, cp=2),
    dict(cp=2, tp=2),
    dict(pp=2, cp=2),  # 2 microbatches, 3 ticks
    dict(pp=2, cp=2, tp=2),  # the 4-D composition: 8 ranks
)
PAR_BATCH = 2  # two streams of the training mask
PAR_STEPS = 3


def layout_name(layout: dict) -> str:
    return " x ".join(f"{a}{layout[a]}" for a in ("pp", "dp", "cp", "tp") if a in layout)


def par_batch(seed: int, cfg, total: int):
    """The phase's two token streams and their next-token labels, on the
    card, from ``seed`` (the same on every rank)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (PAR_BATCH, total), generator=gen, device="cuda")
    return tokens, torch.roll(tokens, -1, dims=1)


def named_layers(model, first: int = 0):
    """(name, parameter) of a model's weights, its layers numbered from
    ``first`` (a pipeline stage's first global layer)."""
    from magiattention_tpu_torch.models.llama import LAYER_KEYS

    yield "embed", model.embed
    for i, layer in enumerate(model.layers):
        for k in LAYER_KEYS:
            yield f"layers.{first + i}.{k}", getattr(layer, k)
    yield "final_norm", model.final_norm
    yield "lm_head", model.lm_head


def par_reference(seed: int, grads_path: str) -> dict:
    """The cp=1 trainer on the card over the phase's two streams: the
    losses of PAR_STEPS AdamW steps, the first step's gradients saved by
    name for the layouts to hold theirs against."""
    import torch
    from magiattention_tpu_torch.api import infer_varlen_mask_from_batch
    from magiattention_tpu_torch.models import LlamaConfig, build_magi_llama, make_model_train_step

    cfg = dataclasses.replace(LlamaConfig(), n_layers=TRAIN_LAYERS)
    total = sum(TRAIN_DOCS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build_magi_llama(cfg, total, *infer_varlen_mask_from_batch(TRAIN_DOCS), seed=seed)
    tokens, labels = par_batch(seed, cfg, total)
    pos = torch.arange(total, device="cuda").expand(PAR_BATCH, -1)
    step = make_model_train_step(model, torch.optim.AdamW(model.parameters(), **ADAMW))
    losses, step_ms = [], []
    for i in range(PAR_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(step(tokens, labels, pos)))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            torch.save({n: p.grad.detach().cpu() for n, p in named_layers(model)}, grads_path)
    peak = torch.cuda.max_memory_allocated()
    del step, model
    torch.cuda.empty_cache()
    return {"losses": losses, "step_ms": step_ms, "max_memory_allocated_bytes": peak}


@in_rank
def par_train_rank(group, layout: dict, seed: int, grads_path: str, steps: int) -> dict:
    """One rank of a (pp, dp, cp, tp) layout of the trainer on the card:
    ``make_parallel_groups``, the model (``build_magi_llama_pp`` under pp)
    on the reference's weights from ``seed``, this rank's part of the two
    streams, ``steps`` AdamW steps. A rank at dp 0, cp 0 holds the first
    step's gradients (summed as the step sums them) against its slice of
    the reference's: its stage's layers, its tp columns or rows."""
    import torch
    import torch.distributed as dist
    from magiattention_tpu_torch import csrc
    from magiattention_tpu_torch.api import infer_varlen_mask_from_batch
    from magiattention_tpu_torch.comm.group_collective import record_collectives
    from magiattention_tpu_torch.models import (
        LlamaConfig,
        build_magi_llama,
        build_magi_llama_pp,
        make_model_train_step,
        make_parallel_groups,
        shard_llama_params,
    )

    cp_rank_setup()
    cfg = dataclasses.replace(LlamaConfig(), n_layers=TRAIN_LAYERS)
    total = sum(TRAIN_DOCS)
    torch.cuda.reset_peak_memory_stats()
    groups = make_parallel_groups(**layout)
    (pp, _, _, tp), (stage, d, c, t) = groups.sizes, groups.coords
    build = build_magi_llama_pp if pp > 1 else build_magi_llama
    model = build(cfg, total, *infer_varlen_mask_from_batch(TRAIN_DOCS), seed=seed,
                  groups=groups, chunk_size=CP_CHUNK)
    tokens, labels = par_batch(seed, cfg, total)
    tok, lab = model.shard(tokens), model.shard(labels)
    pos = model.position_ids().cuda().expand(tok.shape[0], -1)
    step = make_model_train_step(model, torch.optim.AdamW(model.parameters(), **ADAMW))
    losses, step_ms, grad_rel_l2 = [], [], None
    csrc.reset_launch_counts()
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with record_collectives("live") if i == 0 else contextlib.nullcontext() as recs:
            losses.append(float(step(tok, lab, pos)))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            psums = sum(1 for r in recs if r.op == "psum")
            if d == 0 and c == 0:
                ref = torch.load(grads_path, mmap=True, weights_only=True)
                per = cfg.n_layers // pp
                grad_rel_l2 = {}
                for name, p in named_layers(model, stage * per):
                    r = ref[name]
                    if name.startswith("layers."):
                        r = shard_llama_params({"layers": [{name.rsplit(".", 1)[1]: r}]}, t,
                                               tp)["layers"][0][name.rsplit(".", 1)[1]]
                    r = r.cuda()
                    grad_rel_l2[name] = float((p.grad - r).norm() / r.norm())
                del ref
    launches = {n: csrc.launches[n] for n in FLEX_KERNELS if csrc.launches[n]}
    return {"rank": dist.get_rank(group), "coords": list(groups.coords), "losses": losses,
            "step_ms": step_ms, "launches": launches, "grad_rel_l2": grad_rel_l2,
            "head_block": model.head_block,
            "heads": [model.layers[0].wq.shape[1] // D, model.layers[0].wk.shape[1] // D],
            "tp_all_reduces_per_step": psums,
            "microbatches": tok.shape[0], "pp_ticks": model.ticks if pp > 1 else None,
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}


def parallel_training(pools, seed: int, scratch: str) -> dict:
    """The training phase's model (full widths, 4 layers) over two streams
    of its mask under dp2 x cp2, cp2 x tp2, pp2 x cp2 and pp2 x cp2 x tp2,
    ranks sharing the card over gloo, against the cp=1 trainer on the card
    on the same weights and streams: every step's loss within CP_LOSS_ATOL,
    every first-step gradient (a tp shard against its slice, a stage's
    layers against theirs) within CP_GRAD_REL_L2 relative L2, the same
    losses on every rank, and only flex_fwd_hb, flex_dq and flex_dkv
    launched, at head_block G = 2 (per-rank heads 8 / 4 under tp)."""
    from magiattention_tpu_torch.testing.dist import RankPool

    t0 = time.perf_counter()
    # the 8-rank pool starts while the reference runs, and is closed at the end
    own = {n: RankPool(n, backend="gloo", env={
        "MAGI_ATTENTION_TRACE_DIR": os.environ["MAGI_ATTENTION_TRACE_DIR"]})
        for n in {math.prod(lay.values()) for lay in PAR_LAYOUTS} - set(pools)}
    try:
        return _parallel_training(pools | own, seed, scratch, t0)
    finally:
        for pool in own.values():
            pool.close()


def _parallel_training(pools, seed: int, scratch: str, t0: float) -> dict:
    grads_path = os.path.join(scratch, "par_ref_grads.pt")
    ref = par_reference(seed, grads_path)
    runs, launches = [], {}
    for layout in PAR_LAYOUTS:
        n = math.prod(layout.values())
        res = pools[n].run(par_train_rank, layout, seed, grads_path, PAR_STEPS)
        name = layout_name(layout)
        tp = layout.get("tp", 1)
        for r in res:
            worst_rank = max(abs(a - b) for a, b in zip(r["losses"], res[0]["losses"]))
            check(worst_rank <= 1e-6, f"{name}: rank {r['rank']} reports losses {r['losses']}, "
                  f"rank 0 {res[0]['losses']}")
            check(set(r["launches"]) == set(TRAINING_KERNELS),
                  f"{name} rank {r['rank']}: launches {r['launches']}, expected {TRAINING_KERNELS}")
            check(r["head_block"] == 2 and r["heads"] == [TRAIN_HQ // tp, TRAIN_HK // tp],
                  f"{name} rank {r['rank']}: heads {r['heads']} at head_block {r['head_block']}")
            if layout.get("pp", 1) > 1:
                want = r["microbatches"] + layout["pp"] - 1
                check(r["pp_ticks"] == want, f"{name} rank {r['rank']}: {r['pp_ticks']} GPipe "
                      f"ticks, expected {want}")
            for k, c in r["launches"].items():
                launches[k] = launches.get(k, 0) + c
        diffs = [abs(a - b) for a, b in zip(res[0]["losses"], ref["losses"])]
        check(max(diffs) <= CP_LOSS_ATOL, f"{name}: losses {res[0]['losses']} vs cp=1 "
              f"{ref['losses']}")
        grads = {}
        for r in res:
            if r["grad_rel_l2"] is not None:
                grads.update({f"{k}@pp{r['coords'][0]}tp{r['coords'][3]}": v
                              for k, v in r["grad_rel_l2"].items()})
        checked = {k.split("@")[0] for k in grads}
        check(len(checked) == 3 + 9 * TRAIN_LAYERS, f"{name}: gradients checked {sorted(checked)}")
        worst = max(grads, key=grads.get)
        check(grads[worst] <= CP_GRAD_REL_L2,
              f"{name}: the first-step gradient of {worst} is {grads[worst]} relative L2 from "
              "cp=1's")
        runs.append({"layout": name, "ranks": n, "losses": res[0]["losses"],
                     "loss_abs_diff_vs_cp1": diffs, "grad_rel_l2_vs_cp1_max": grads[worst],
                     "grad_rel_l2_worst": worst, "grads_checked": len(grads),
                     "heads_per_rank": res[0]["heads"], "head_block": res[0]["head_block"],
                     "tp_all_reduces_per_step": res[0]["tp_all_reduces_per_step"],
                     "pp_ticks": res[0]["pp_ticks"],
                     "step_ms_ranks_sharing_one_card": [r["step_ms"] for r in res],
                     "max_memory_allocated_bytes_per_rank": [r["max_memory_allocated_bytes"]
                                                             for r in res],
                     "launches_per_rank": [r["launches"] for r in res]})
    return {"phase": "parallel_training", "card": nvidia_smi_line(), "docs": TRAIN_DOCS,
            "streams": PAR_BATCH, "layers": TRAIN_LAYERS, "steps": PAR_STEPS,
            "chunk": CP_CHUNK, "cp1": ref,
            "tolerance": {"loss_abs": CP_LOSS_ATOL, "grad_rel_l2": CP_GRAD_REL_L2},
            "note": "times with the ranks sharing one card: not parallel speeds",
            "runs": runs, "launches": launches, "wall_s": time.perf_counter() - t0}


# -- the cp baselines: ring, Ulysses, USP, double ring, hybrid DCP, USP-NSA ----------

BASE_T = CP_ATTN_T  # 16,384 tokens
BASE_MASKS = ("causal", "hetero")
BASE_RUNS = (  # (scheme, layout): cp, or (outer, inner) subgroups
    ("ring", dict(cp=2)), ("ring", dict(cp=4)),
    ("ulysses", dict(cp=2)), ("ulysses", dict(cp=4)),
    ("usp", dict(outer=2, inner=2)),  # (ring, ulysses)
    ("double_ring", dict(outer=2, inner=2)),
    ("hybrid_dcp", dict(cp=2)), ("hybrid_dcp", dict(cp=4)),
)
BASE_NSA = dict(block=64, topk=8, window=256)  # NsaConfig()'s defaults
BASE_KERNELS = ("flex_fwd_hb", "flex_dq", "flex_dkv")  # head_block G = 2, the row-major grid


def base_slices(mask: str):
    """(slices [S, 5], q_ranges, k_ranges, types) of a phase mask."""
    import numpy as np
    from magiattention_tpu_torch.testing.workloads import split_slices, varlen_block_causal

    sl = [(0, BASE_T, 0, BASE_T, 1)] if mask == "causal" else varlen_block_causal(BASE_T)
    return (np.asarray(sl, np.int64), *split_slices(sl))


def sent_bytes(records) -> float:
    """Bytes this rank puts on the wire for the recorded collectives: a
    ppermute its payload, an all-to-all all blocks but its own, a tiled
    all-gather its block to every other rank, an all-reduce 2 (n - 1) / n
    of its payload (a ring)."""
    import torch

    total = 0.0
    for r in records:
        n = r.size
        b = math.prod(r.shape) * getattr(torch, r.dtype.split(".")[-1]).itemsize
        total += {"ppermute": b, "all_to_all": b * (n - 1) / n, "all_gather": b * (n - 1),
                  "psum": 2 * b * (n - 1) / n}[r.op]
    return total


def base_fn(kind: str, layout: dict, group, slices, qr, kr, ty, params):
    """The baseline's ``make_*_attn_fn`` over ``group`` (its subgroups for
    USP and the double ring)."""
    from magiattention_tpu_torch.parallel import baselines as bl

    cp = math.prod(layout.values())
    if kind == "ring":
        return bl.make_ring_attn_fn(bl.build_ring_attn_plan(slices, BASE_T, cp), group, params)
    if kind == "ulysses":
        return bl.make_ulysses_attn_fn(bl.build_ulysses_plan(qr, kr, ty, BASE_T, cp), group,
                                       params)
    if kind == "hybrid_dcp":
        return bl.make_hybrid_dcp_attn_fn(bl.build_hybrid_dcp_plan(slices, BASE_T, cp), group,
                                          params)
    groups = hier_cp_groups(group, (layout["outer"], layout["inner"]))
    if kind == "usp":
        return bl.make_usp_attn_fn(bl.build_usp_plan(slices, BASE_T, layout["inner"],
                                                     layout["outer"]), groups, params)
    return bl.make_double_ring_attn_fn(bl.build_double_ring_plan(
        slices, BASE_T, layout["outer"], layout["inner"]), groups, params)


@in_rank
def base_rank(group, kind: str, layout: dict, mask: str, seed: int) -> dict:
    """One rank of a cp baseline on the card (16 / 8 heads, d 128, bf16,
    head_block 2): this rank's shard (contiguous; zigzag for hybrid DCP),
    forward and backward of sum(out * g_out) + sum(lse * g_lse) with its
    collectives recorded, its launches; a second, timed run; on rank 0 the
    gathered out, lse, dq, dk, dv against single-card
    ``flex_flash_attn_func`` on the same inputs (``vs_single_card``)."""
    import torch
    import torch.distributed as dist
    from magiattention_tpu_torch import csrc
    from magiattention_tpu_torch.comm.group_collective import record_collectives
    from magiattention_tpu_torch.comm.primitives import all_gather_tiled
    from magiattention_tpu_torch.ops.flex_attn import FlexAttnParams
    from magiattention_tpu_torch.parallel import baselines as bl

    cp_rank_setup()
    rank, cp = dist.get_rank(group), dist.get_world_size(group)
    hq, hk = TRAIN_HQ, TRAIN_HK
    slices, qr, kr, ty = base_slices(mask)
    gen = torch.Generator(device="cuda").manual_seed(seed)  # the same inputs on every rank
    q, k, v, g_out = (torch.randn((BASE_T, h, D), generator=gen, device="cuda",
                                  dtype=torch.bfloat16) for h in (hq, hk, hk, hq))
    g_lse = torch.randn((BASE_T, hq), generator=gen, device="cuda")
    params = FlexAttnParams(BLOCK, BLOCK, 1.0 / math.sqrt(D), 0.0, False, torch.bfloat16,
                            head_block=hq // hk)
    fn = base_fn(kind, layout, group, slices, qr, kr, ty, params)
    zig = kind == "hybrid_dcp"

    def order(x):
        return bl.zigzag_dispatch(x, BASE_T, cp) if zig else x

    rows = slice(rank * (BASE_T // cp), (rank + 1) * (BASE_T // cp))
    go, gl = order(g_out)[rows], order(g_lse)[rows]

    def fwd_bwd(record: bool):
        qs, ks, vs = (order(x)[rows].detach().clone().requires_grad_() for x in (q, k, v))
        with record_collectives("live") if record else contextlib.nullcontext() as fwd:
            out, lse = fn(qs, ks, vs)
        loss = (out.float() * go.float()).sum() + torch.where(
            torch.isfinite(lse), lse * gl, 0.0).sum()
        with record_collectives("live") if record else contextlib.nullcontext() as bwd:
            loss.backward()
        return (out, lse, qs.grad, ks.grad, vs.grad), fwd, bwd

    torch.cuda.synchronize()
    csrc.reset_launch_counts()
    got, fwd_recs, bwd_recs = fwd_bwd(True)
    torch.cuda.synchronize()
    launches = {n: csrc.launches[n] for n in FLEX_KERNELS if csrc.launches[n]}
    dist.barrier(group)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fwd_bwd(False)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    gathered = [all_gather_tiled(x.detach().contiguous(), group) for x in got]
    if zig:
        gathered = [bl.zigzag_undispatch(x, BASE_T, cp) for x in gathered]
    res = {"rank": rank, "launches": launches, "wall_ms": wall_ms,
           "fwd_bytes_sent": sent_bytes(fwd_recs), "bwd_bytes_sent": sent_bytes(bwd_recs),
           "fwd_collectives": sorted({r.op for r in fwd_recs}),
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
    if rank == 0:
        errs, failed = vs_single_card(gathered, q, k, v, g_out, g_lse, qr, kr, ty, hq, hk)
        res.update(vs_single_card=errs, failed=failed)
    return res


def nsa_dense_head(q, k, v, cfg, head: int):
    """A plain dense-masked NSA for query ``head`` of a head block (q [t,
    hq, d], k / v [t, hk, d], bf16): out [t, d] float32, independent of
    ``nsa_attn``'s arithmetic. Each branch is a full [t, t] (the compressed
    one [t, t / block]) float32 score matrix under its mask, the window
    branch too. Only the top-k ranking of the selected branch is taken
    from block scores at the inputs' precision, as ``nsa_attn`` ranks them
    (its bf16 einsum over the whole block): a float32 ranking picks other
    blocks at near ties."""
    import torch

    t, hq, d = q.shape
    g, b = hq // k.shape[1], cfg.block
    nb, scale = t // b, 1.0 / math.sqrt(d)
    # the ranking, op for op as nsa_attn's on the same block (the same ties)
    kc = k.repeat_interleave(g, dim=1).reshape(nb, b, hq, d).mean(dim=1)
    sb = (torch.einsum("qhd,bhd->hqb", q, kc) * scale).reshape(hq, nb, b, nb).sum(dim=2)
    blocks = torch.arange(nb, device=q.device)
    sb = torch.where(blocks[None, None, :] <= blocks[None, :, None], sb, float("-inf"))
    top = torch.topk(sb, min(cfg.topk, nb), dim=-1).indices[head]  # [q blocks, topk]
    chosen = torch.zeros((nb, nb), dtype=torch.bool, device=q.device)
    chosen[blocks[:, None], top] = True

    qf, kf, vf = q[:, head].float(), k[:, head // g].float(), v[:, head // g].float()
    rows = torch.arange(t, device=q.device)
    causal = rows[None, :] <= rows[:, None]

    def attend(scores, mask, values):
        p = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
        return p.nan_to_num(0.0) @ values  # a row with no key attends nothing

    kcf, vcf = (x.reshape(nb, b, d).mean(dim=1) for x in (kf, vf))
    out_cmp = attend(qf @ kcf.T * scale, blocks[None, :] < (rows // b)[:, None], vcf)
    dense = qf @ kf.T * scale
    out_slc = attend(dense, causal & chosen[rows // b][:, rows // b], vf)
    out_win = attend(dense, causal & (rows[:, None] - rows[None, :] < cfg.window), vf)
    return (out_cmp + out_slc + out_win) / 3.0


@in_rank
def base_nsa_rank(group, seed: int) -> dict:
    """USP-NSA at cp 2 on the card, forward only (causal, ``NsaConfig()``):
    rank 0 holds the gathered out against single-card ``nsa_attn`` on each
    rank's head block of the same inputs, and its head 0 against
    ``nsa_dense_head`` within the kernel bounds."""
    import torch
    import torch.distributed as dist
    from magiattention_tpu_torch import csrc
    from magiattention_tpu_torch.comm.primitives import all_gather_tiled
    from magiattention_tpu_torch.parallel import baselines as bl

    cp_rank_setup()
    rank, cp = dist.get_rank(group), dist.get_world_size(group)
    cfg = bl.NsaConfig(**BASE_NSA)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn((BASE_T, h, D), generator=gen, device="cuda", dtype=torch.bfloat16)
               for h in (TRAIN_HQ, TRAIN_HK, TRAIN_HK))
    rows = slice(rank * (BASE_T // cp), (rank + 1) * (BASE_T // cp))
    fn = bl.make_usp_nsa_attn_fn(BASE_T, group, cfg)
    torch.cuda.synchronize()
    csrc.reset_launch_counts()
    out = fn(q[rows], k[rows], v[rows])
    torch.cuda.synchronize()
    launches = {n: csrc.launches[n] for n in FLEX_KERNELS if csrc.launches[n]}
    dist.barrier(group)
    t0 = time.perf_counter()
    fn(q[rows], k[rows], v[rows])
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    out = all_gather_tiled(out.contiguous(), group)
    res = {"rank": rank, "launches": launches, "wall_ms": wall_ms}
    if rank == 0:
        hq, hk = TRAIN_HQ // cp, TRAIN_HK // cp
        ref = torch.cat([bl.nsa_attn(q[:, j * hq:(j + 1) * hq], k[:, j * hk:(j + 1) * hk],
                                     v[:, j * hk:(j + 1) * hk], cfg) for j in range(cp)], dim=1)
        errs, failed = out_errors(out, ref, [])
        dense = nsa_dense_head(q[:, :hq], k[:, :hk], v[:, :hk], cfg, 0)
        dense_errs, dense_failed = out_errors(out[:, 0], dense, [])
        res.update(vs_single_card=errs, failed=failed + [f"dense_{f}" for f in dense_failed],
                   vs_dense_head0=dense_errs, bitwise=bool(torch.equal(out, ref)))
    return res


def magi_recv_rows(mask: str, cp: int) -> list:
    """K/V rows MagiAttention's own plan (degree 0, chunk CP_CHUNK) has each
    rank receive for the same mask and cp, built on the host."""
    from magiattention_tpu_torch.common.enum import AttnMaskType
    from magiattention_tpu_torch.common.ranges import AttnRanges
    from magiattention_tpu_torch.meta.dispatch_meta import make_dispatch_meta_from_qk_ranges
    from magiattention_tpu_torch.meta.solver.overlap_solver import OverlapConfig
    from magiattention_tpu_torch.parallel.dist_attn import build_dist_attn_plan

    _, qr, kr, ty = base_slices(mask)
    mq, _, bucket = make_dispatch_meta_from_qk_ranges(
        AttnRanges.from_ranges(qr), AttnRanges.from_ranges(kr), [AttnMaskType(t) for t in ty],
        BASE_T, BASE_T, chunk_size=CP_CHUNK, cp_size=cp)
    plan = build_dist_attn_plan(mq, bucket, block_q=BLOCK, block_k=BLOCK,
                                overlap_config=OverlapConfig(degree=0))
    return [int(x) for x in plan.comm.recv_total]


def cp_baselines(pools, seed: int) -> dict:
    """The six cp baselines at ``LlamaConfig``'s attention widths on 16,384
    tokens, causal and ``hetero``: ring and Ulysses at cp 2 and 4, USP and
    the double ring at 2 x 2, hybrid DCP at cp 2 and 4, forward and
    backward within the kernel bounds of single-card attention; USP-NSA at
    cp 2, forward only, against single-card NSA. Each run's bytes on the
    wire per rank beside MagiAttention's own plan's K/V rows at the same
    mask and cp."""
    t0 = time.perf_counter()
    row_bytes = 2 * TRAIN_HK * D * 2  # one K and one V row of every kv head, bf16
    magi = {(m, cp): magi_recv_rows(m, cp) for m in BASE_MASKS for cp in (2, 4)}
    runs, launches = [], {}
    for kind, layout in BASE_RUNS:
        cp = math.prod(layout.values())
        for mask in BASE_MASKS:
            res = pools[cp].run(base_rank, kind, layout, mask, seed)
            name = f"{kind} {'x'.join(str(x) for x in layout.values())} {mask}"
            check(not res[0]["failed"], f"{name}: the gathered results fail "
                  f"{res[0]['failed']}: {res[0]['vs_single_card']}")
            for r in res:
                check(set(r["launches"]) == set(BASE_KERNELS),
                      f"{name} rank {r['rank']}: launches {r['launches']}")
                for k, c in r["launches"].items():
                    launches[k] = launches.get(k, 0) + c
            magi_rows = magi[(mask, cp)]
            runs.append({
                "scheme": kind, "layout": layout, "mask": mask,
                "vs_single_card": res[0]["vs_single_card"],
                "launches_per_rank": [r["launches"] for r in res],
                "fwd_collectives": res[0]["fwd_collectives"],
                "fwd_bytes_sent_per_rank": [r["fwd_bytes_sent"] for r in res],
                "bwd_bytes_sent_per_rank": [r["bwd_bytes_sent"] for r in res],
                "fwd_kv_rows_equivalent_per_rank": [r["fwd_bytes_sent"] / row_bytes
                                                    for r in res],
                "magi_recv_rows_per_rank": magi_rows,
                "magi_fwd_bytes_per_rank": [x * row_bytes for x in magi_rows],
                "wall_ms_ranks_sharing_one_card": [r["wall_ms"] for r in res],
                "max_memory_allocated_bytes": [r["max_memory_allocated_bytes"] for r in res]})
    nsa = pools[2].run(base_nsa_rank, seed)
    check(not nsa[0]["failed"], f"usp_nsa cp2: the gathered out fails {nsa[0]['failed']}: "
          f"{nsa[0]['vs_single_card']}, head 0 vs dense {nsa[0]['vs_dense_head0']}")
    for r in nsa:
        check(bool(r["launches"]), f"usp_nsa rank {r['rank']}: no flex launch")
        for k, c in r["launches"].items():
            launches[k] = launches.get(k, 0) + c
    runs.append({"scheme": "usp_nsa", "layout": {"cp": 2}, "mask": "causal",
                 "nsa": BASE_NSA, "vs_single_card": nsa[0]["vs_single_card"],
                 "vs_dense_head0": nsa[0]["vs_dense_head0"],
                 "bitwise_single_card": nsa[0]["bitwise"],
                 "launches_per_rank": [r["launches"] for r in nsa],
                 "wall_ms_ranks_sharing_one_card": [r["wall_ms"] for r in nsa]})
    return {"phase": "cp_baselines", "card": nvidia_smi_line(), "tokens": BASE_T,
            "heads": [TRAIN_HQ, TRAIN_HK], "head_dim": D, "dtype": "bfloat16",
            "note": "times with the cp ranks sharing one card: not cp speeds",
            "runs": runs, "launches": launches, "wall_s": time.perf_counter() - t0}


# -- hierarchical cp, cross-attention keys -------------------------------------------

CP_HIER = (2, 2)  # cp=4 as 2 nodes x 2 ranks
CP_HIER_RUNS = (  # (run, hq, hk, overlap degree, group-collective impl, new mask)
    ("A", TRAIN_HQ, TRAIN_HK, 0, "a2a", False),
    ("B", 8, 8, 2, "hops", False),
    ("C", TRAIN_HQ, TRAIN_HK, 0, "a2a", True),
)
CP_HIER_WINDOW = 1024  # run C: a causal sliding window of 1024 keys per document
ROLL_SHIFTS = (1, -1, 4097)
HIER_PLANTS = ("pad_rows", "no_pre_reduce")


_HIER_CP_GROUPS = {}


def hier_cp_groups(group, shape):
    """This rank process's ``make_hier_cp_groups(group, *shape)``, made on
    its first call for ``(group, shape)`` and reused by every later task:
    each call would create and keep new subgroups, and a cached key keeps
    the runtime of the groups it was planned with."""
    from magiattention_tpu_torch.comm import make_hier_cp_groups

    key = (id(group), tuple(shape))
    if key not in _HIER_CP_GROUPS:
        _HIER_CP_GROUPS[key] = make_hier_cp_groups(group, *shape)
    return _HIER_CP_GROUPS[key]


def plant_hier_reduce(kind: str):
    """Plant a faulty backward of the hierarchical cast in this rank
    (``comm.hier.group_reduce_hier``): ``"pad_rows"``, an inter-level
    reduce built from ``send_idx`` alone, whose sent-back buffer is filled
    pair by pair without the pair counts and whose every slot is summed
    onto its ``send_idx`` row, so the pads land on row 0; or
    ``"no_pre_reduce"``, a gateway that keeps one consumer's partial of a
    row where the real reduce sums them. Returns a function that puts the
    real reduce back."""
    import torch
    from magiattention_tpu_torch.comm import hier
    from magiattention_tpu_torch.comm.group_collective import (
        all_to_all_rows,
        cast_transpose,
        exchange,
    )

    def pad_rows(y, rt, group):
        w, s = rt.cp_size, rt.max_send
        counts = torch.bincount(torch.div(rt.recv_sel, s, rounding_mode="floor"), minlength=w)
        off = torch.cumsum(counts, 0) - counts
        idx = (off[:, None] + torch.arange(s, device=y.device)[None, :]).reshape(-1)
        recv = all_to_all_rows(y.index_select(0, idx.clamp(max=y.shape[0] - 1)), group)
        acc = y.new_zeros((rt.num_local_rows,) + tuple(y.shape[1:]))
        return acc.index_add_(0, rt.send_idx, recv)

    def keep_one(y, rt, group):
        acc = y.new_zeros((rt.num_local_rows,) + tuple(y.shape[1:]))
        if rt.impl == "hops":
            for h in rt.hops:
                back = y.new_zeros((h.size,) + tuple(y.shape[1:]))
                back[: h.recv_pos.shape[0]] = y.index_select(0, h.recv_pos)
                if h.shift % rt.cp_size:
                    back = exchange(back, (rt.rank - h.shift) % rt.cp_size,
                                    (rt.rank + h.shift) % rt.cp_size, group)
                acc.index_copy_(0, h.seg, back[: h.seg.shape[0]])
            return acc
        back = y.new_zeros((rt.cp_size * rt.max_send,) + tuple(y.shape[1:]))
        back.index_copy_(0, rt.recv_sel, y[: rt.recv_sel.shape[0]])
        recv = all_to_all_rows(back, group)
        return acc.index_copy_(0, rt.back_rows, recv.index_select(0, rt.back_pos))

    real = hier.group_reduce_hier

    def planted(y, hr, groups):
        if kind == "pad_rows":
            return pad_rows(cast_transpose(y, hr.intra, groups.intra), hr.inter, groups.inter)
        return cast_transpose(keep_one(y, hr.intra, groups.intra), hr.inter, groups.inter)

    hier.group_reduce_hier = planted

    def restore():
        hier.group_reduce_hier = real

    return restore


@in_rank
def cp_hier_attn_rank(group, hq: int, hk: int, degree: int, impl: str, new_mask: bool,
                      seed: int, plant: str | None = None) -> dict:
    """One rank of the keyed API over the hierarchical groups on the card:
    the cp_attn mask at (hq, hk), overlap ``degree``, ``impl`` pinned for
    this task; with ``new_mask`` the attention runs on
    ``make_varlen_key_for_new_mask_after_dispatch``'s sliding-window key
    over the first key's dispatch. Forward and backward, its launches and
    the plan's facts (the layout, impls, received rows, the rows that
    cross between nodes, and on rank 0 those of the flat plan of the same
    mask and dispatch); rank 0's kernel call against the plain versions;
    a second, timed run; on run A ``roll`` of dispatched labels; rank 0's
    gathered results against single-card ``flex_flash_attn_func``.
    ``plant`` plants a faulty hierarchical reduce (rank 0 then returns the
    failed checks instead of raising)."""
    import torch
    import torch.distributed as dist
    from magiattention_tpu_torch import api, csrc
    from magiattention_tpu_torch.api import infer_attn_mask_from_cu_seqlens
    from magiattention_tpu_torch.comm import node_crossing_rows
    from magiattention_tpu_torch.common import AttnMaskType, AttnRanges
    from magiattention_tpu_torch.config import DistAttnConfig
    from magiattention_tpu_torch.meta import make_global_bucket_from_qk_ranges
    from magiattention_tpu_torch.meta.solver.overlap_solver import OverlapConfig
    from magiattention_tpu_torch.parallel import build_dist_attn_plan, dist_attn
    from magiattention_tpu_torch.testing.workloads import split_slices, varlen_block_causal

    cp_rank_setup()
    saved = os.environ.get("MAGI_ATTENTION_GROUP_COLL_IMPL")
    os.environ["MAGI_ATTENTION_GROUP_COLL_IMPL"] = impl
    restore = plant_hier_reduce(plant) if plant else None
    real_core = dist_attn.flex_attn_headmajor
    try:
        rank, t = dist.get_rank(group), CP_ATTN_T
        slices = varlen_block_causal(t)
        qr, kr, ty = split_slices(slices)
        gen = torch.Generator(device="cuda").manual_seed(seed)  # the same inputs on every rank
        q, k, v, g_out = (torch.randn((t, h, D), generator=gen, device="cuda",
                                      dtype=torch.bfloat16) for h in (hq, hk, hk, hq))
        g_lse = torch.randn((t, hq), generator=gen, device="cuda")
        groups = hier_cp_groups(group, CP_HIER)
        oc = OverlapConfig(degree=degree)
        key = api.magi_attn_flex_key(qr, kr, ty, t, t, groups, num_heads=(hq, hk), head_dim=D,
                                     chunk_size=CP_CHUNK,
                                     dist_attn_config=DistAttnConfig(overlap_config=oc))
        if new_mask:
            cu = [s[0] for s in slices] + [t]
            key = api.make_varlen_key_for_new_mask_after_dispatch(
                cu, key, causal=False, window_size=(CP_HIER_WINDOW, 0))
            wq, wk, wt = infer_attn_mask_from_cu_seqlens(cu, causal=False,
                                                         window_size=(CP_HIER_WINDOW, 0))
            qr, kr, ty = ([r.to_naive_range() for r in wq], [r.to_naive_range() for r in wk],
                          [int(x) for x in wt])
        mgr = api.get_runtime_mgr(key)
        plan = mgr.plan
        check(plan.hier == CP_HIER and key.hier == CP_HIER,
              f"hier run: the plan's layout is {plan.hier}, the key's {key.hier}")
        cap = {}
        stage_check = rank == 0 and plant is None
        if stage_check:
            dist_attn.flex_attn_headmajor = capturing(real_core, cap)
        torch.cuda.synchronize()
        csrc.reset_launch_counts()
        got = keyed_fwd_bwd(key, q, k, v, g_out, g_lse)
        torch.cuda.synchronize()
        launches = {n: csrc.launches[n] for n in FLEX_KERNELS if csrc.launches[n]}
        dist_attn.flex_attn_headmajor = real_core
        res = {"rank": rank, "launches": launches, **cp_comm_facts(group),
               "hier": list(plan.hier), "overlap_degree": plan.overlap_degree,
               "stages": len(plan.stages), "impls": [c.impl for c in plan.comms()],
               "recv_rows": [list(c.recv_total) for c in plan.comms()],
               "node_crossing_rows": sum(node_crossing_rows(c, *CP_HIER) for c in plan.comms())}
        if stage_check:
            res["stage_check"] = _cp_stage_check(cap)
        if rank == 0:  # the flat plan of the same mask on the same dispatch
            meta = mgr.dispatch_meta
            bucket = make_global_bucket_from_qk_ranges(
                AttnRanges.from_ranges(qr), AttnRanges.from_ranges(kr),
                [AttnMaskType(x) for x in ty], t, meta.chunk_size)
            flat = build_dist_attn_plan(meta, bucket, block_q=plan.block_q, block_k=plan.block_k,
                                        overlap_config=oc)
            res["flat_node_crossing_rows"] = sum(node_crossing_rows(c, *CP_HIER)
                                                 for c in flat.comms())
            res["flat_recv_rows"] = [list(c.recv_total) for c in flat.comms()]
        if plant is None:  # a second run, timed (the ranks share the card)
            dist.barrier(group)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            keyed_fwd_bwd(key, q, k, v, g_out, g_lse)
            torch.cuda.synchronize()
            res["fwd_bwd_ms_ranks_sharing_one_card"] = (time.perf_counter() - t0) * 1e3
            res["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
        if plant is None and not new_mask:  # roll of dispatched labels, exact
            labels = torch.randint(0, 128256, (t,), generator=gen, device="cuda")
            local = api.dispatch(labels, key)
            res["roll_exact"] = {
                s: bool(torch.equal(api.roll(local, key, s),
                                    api.dispatch(torch.roll(labels, s), key)))
                for s in ROLL_SHIFTS}
        if rank == 0:
            errs, failed = vs_single_card(got, q, k, v, g_out, g_lse, qr, kr, ty, hq, hk)
            res.update(vs_single_card=errs, failed=failed)
            if plant is None:
                check(not failed, f"hier cp heads {hq}/{hk} degree {degree} {impl} new_mask="
                      f"{new_mask}: the gathered results fail {failed}: {errs}")
        return res
    finally:
        dist_attn.flex_attn_headmajor = real_core
        if restore is not None:
            restore()
        if saved is None:
            os.environ.pop("MAGI_ATTENTION_GROUP_COLL_IMPL", None)
        else:
            os.environ["MAGI_ATTENTION_GROUP_COLL_IMPL"] = saved


def cp_hier_attn(pools, seed: int) -> dict:
    """The keyed API at cp=4 as 2 x 2: runs A, B, C (``CP_HIER_RUNS``);
    each rank launches its forward, ``flex_dq`` and ``flex_dkv`` once per
    kernel call of its plan (one at degree 0, one per stage and the host
    stage at degree 2); run A's rows that cross between nodes must be
    fewer than the flat plan's; run C must inherit the layout; ``roll`` on
    run A exact; the planted hierarchical reduces (on run A) must fail dk
    and dv only."""
    runs, launches = [], {}
    for name, hq, hk, degree, impl, new_mask in CP_HIER_RUNS:
        res = pools[4].run(cp_hier_attn_rank, hq, hk, degree, impl, new_mask, seed)
        r0 = res[0]
        fwd = "flex_fwd_hb" if hq > hk else "flex_fwd"
        calls = 1 + r0["stages"] if degree else 1
        for r in res:
            check(r["launches"] == {fwd: calls, "flex_dq": calls, "flex_dkv": calls},
                  f"hier run {name} rank {r['rank']}: launches {r['launches']}, expected "
                  f"{calls} each of {fwd}, flex_dq, flex_dkv")
            for n, c in r["launches"].items():
                launches[n] = launches.get(n, 0) + c
            for n, e in r.get("stage_check", {}).get("kernel_max_abs_err", {}).items():
                MAX_ERR[n] = max(MAX_ERR[n], e)
            if "roll_exact" in r:
                check(all(r["roll_exact"].values()),
                      f"hier run {name} rank {r['rank']}: roll not exact {r['roll_exact']}")
        check(r0["overlap_degree"] == degree and set(r0["impls"]) == {impl},
              f"hier run {name}: degree {r0['overlap_degree']}, impls {r0['impls']}")
        if name == "A":
            check(0 < r0["node_crossing_rows"] < r0["flat_node_crossing_rows"],
                  f"hier run A: {r0['node_crossing_rows']} rows cross between nodes, the flat "
                  f"plan's {r0['flat_node_crossing_rows']}")
        runs.append({"run": name, "heads": [hq, hk], "overlap_degree": degree,
                     "impl_flag": impl, "new_mask": new_mask, "hier": r0["hier"],
                     "impls": r0["impls"], "recv_rows": r0["recv_rows"],
                     "node_crossing_rows": r0["node_crossing_rows"],
                     "flat_node_crossing_rows": r0["flat_node_crossing_rows"],
                     "flat_recv_rows": r0["flat_recv_rows"],
                     "backend": r0["backend"], "staged_through_host": r0["staged_through_host"],
                     "roll_exact": [r.get("roll_exact") for r in res] if name == "A" else None,
                     "launches_per_rank": [r["launches"] for r in res],
                     "vs_single_card": r0["vs_single_card"],
                     "stage_check": r0["stage_check"],
                     "fwd_bwd_ms_ranks_sharing_one_card": [
                         r["fwd_bwd_ms_ranks_sharing_one_card"] for r in res],
                     "max_memory_allocated_bytes": [r["max_memory_allocated_bytes"]
                                                    for r in res]})
    planted = {}
    _, hq, hk, degree, impl, _ = CP_HIER_RUNS[0]
    for plant in HIER_PLANTS:
        got = pools[4].run(cp_hier_attn_rank, hq, hk, degree, impl, False, seed, plant)[0]
        caught = {c.split(":")[0] for c in got["failed"]}
        check({"dk", "dv"} <= caught and not caught - {"dk", "dv"},
              f"the planted hier reduce {plant}: failed checks {got['failed']}, expected dk "
              "and dv only")
        planted[plant] = {"caught": sorted(caught), "failed": got["failed"]}
    return {"phase": "cp_hier_attn", "tokens": CP_ATTN_T, "chunk": CP_CHUNK, "head_dim": D,
            "dtype": "bfloat16", "layout": list(CP_HIER), "window": CP_HIER_WINDOW,
            "roll_shifts": list(ROLL_SHIFTS),
            "note": "ranks sharing one card: not cp speeds", "runs": runs,
            "launches": launches, "planted_hier_reduce": planted}


CP_XATTN_Q_DOCS = (4096, 2048, 2048)
CP_XATTN_K_DOCS = (1500, 750, 750)  # 3000 memory rows: not a chunk multiple, so the K side pads
CP_XATTN_CHUNKS = (512, 256)  # (chunk_size_q, chunk_size_k)
CP_XATTN_RUNS = (2, 4)


def cross_mask():
    """(q_ranges, k_ranges, types): each query document attends FULL to its
    own span of the memory."""
    import itertools

    qb = list(itertools.accumulate(CP_XATTN_Q_DOCS, initial=0))
    kb = list(itertools.accumulate(CP_XATTN_K_DOCS, initial=0))
    return list(zip(qb, qb[1:])), list(zip(kb, kb[1:])), [0] * len(CP_XATTN_Q_DOCS)


@in_rank
def cp_xattn_rank(group, seed: int, skip_reduce: bool = False) -> dict:
    """One rank of ``magi_attn_cross_key`` on the card at the training
    widths (16 / 8 heads, d 128, bf16): queries and memory from the seed,
    ``dispatch`` / ``dispatch_kv`` -> ``calc_attn`` -> ``undispatch``,
    forward and backward; its launches and the key's padding; rank 0's
    kernel call (its q shard, the padded memory buffer and kv_pad) against
    the plain versions, and its gathered results against single-card
    ``flex_flash_attn_func`` with tq != tk. ``skip_reduce`` plants a cast
    whose backward drops the memory rows' dK/dV (rank 0 then returns the
    failed checks)."""
    import torch
    import torch.distributed as dist
    from magiattention_tpu_torch import api, csrc
    from magiattention_tpu_torch.comm import group_collective as gc
    from magiattention_tpu_torch.parallel import dist_attn

    cp_rank_setup()
    rank = dist.get_rank(group)
    hq, hk = TRAIN_HQ, TRAIN_HK
    tq, tk = sum(CP_XATTN_Q_DOCS), sum(CP_XATTN_K_DOCS)
    qr, kr, ty = cross_mask()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, g_out = (torch.randn((tq, hq, D), generator=gen, device="cuda", dtype=torch.bfloat16)
                for _ in range(2))
    k, v = (torch.randn((tk, hk, D), generator=gen, device="cuda", dtype=torch.bfloat16)
            for _ in range(2))
    g_lse = torch.randn((tq, hq), generator=gen, device="cuda")
    key = api.magi_attn_cross_key(qr, kr, ty, tq, tk, group, num_heads=(hq, hk), head_dim=D,
                                  chunk_size_q=CP_XATTN_CHUNKS[0], chunk_size_k=CP_XATTN_CHUNKS[1])
    mgr = api.get_runtime_mgr(key)
    cap = {}
    stage_check = rank == 0 and not skip_reduce
    real_bwd, real_core = gc.GroupCast.backward, dist_attn.flex_attn_headmajor
    if skip_reduce:
        gc.GroupCast.backward = staticmethod(
            lambda ctx, g: (g.new_zeros((ctx.rt.num_local_rows,) + tuple(g.shape[1:])), None, None))
    if stage_check:
        dist_attn.flex_attn_headmajor = capturing(real_core, cap)
    try:
        torch.cuda.synchronize()
        csrc.reset_launch_counts()
        got = keyed_fwd_bwd(key, q, k, v, g_out, g_lse, cross=True)
        torch.cuda.synchronize()
        launches = {n: csrc.launches[n] for n in FLEX_KERNELS if csrc.launches[n]}
    finally:
        gc.GroupCast.backward, dist_attn.flex_attn_headmajor = real_bwd, real_core
    args = api.get_xattn_args(key)
    res = {"rank": rank, "launches": launches, **cp_comm_facts(group),
           "pad_size_k": mgr.pad_size_k, "pad_size_q": key.pad_size,
           "shards": [args.shard_q_len, args.shard_k_len],
           "impls": [c.impl for c in mgr.plan.comms()],
           "recv_rows": [list(c.recv_total) for c in mgr.plan.comms()]}
    if stage_check:
        res["stage_check"] = _cp_stage_check(cap)
    if rank == 0:
        errs, failed = vs_single_card(got, q, k, v, g_out, g_lse, qr, kr, ty, hq, hk)
        res.update(vs_single_card=errs, failed=failed)
        if not skip_reduce:
            check(not failed, f"xattn cp={dist.get_world_size(group)}: the gathered results "
                  f"fail {failed}: {errs}")
    return res


def cp_xattn(pools, seed: int) -> dict:
    """Cross-attention keys at cp=2 and cp=4: one ``flex_fwd_hb``,
    ``flex_dq`` and ``flex_dkv`` per rank; the memory padded; rank 0's
    kernel call against the plain versions; a planted
    skip of the memory's dK/dV reduce (cp=2) must fail dk and dv only."""
    runs, launches = [], {}
    for cp in CP_XATTN_RUNS:
        res = pools[cp].run(cp_xattn_rank, seed)
        for r in res:
            check(r["launches"] == {n: 1 for n in TRAINING_KERNELS},
                  f"xattn cp={cp} rank {r['rank']}: launches {r['launches']}")
            for n, c in r["launches"].items():
                launches[n] = launches.get(n, 0) + c
        check(res[0]["pad_size_k"] > 0, f"xattn cp={cp}: the memory was not padded")
        for n, e in res[0]["stage_check"]["kernel_max_abs_err"].items():
            MAX_ERR[n] = max(MAX_ERR[n], e)
        runs.append({"cp": cp, "pad_size_q": res[0]["pad_size_q"],
                     "pad_size_k": res[0]["pad_size_k"], "shards": res[0]["shards"],
                     "impls": res[0]["impls"], "recv_rows": res[0]["recv_rows"],
                     "backend": res[0]["backend"],
                     "launches_per_rank": [r["launches"] for r in res],
                     "vs_single_card": res[0]["vs_single_card"],
                     "stage_check": res[0]["stage_check"]})
    got = pools[2].run(cp_xattn_rank, seed, True)[0]
    caught = {c.split(":")[0] for c in got["failed"]}
    check({"dk", "dv"} <= caught and not caught - {"dk", "dv"},
          f"the planted skip of the memory's dK/dV reduce: failed checks {got['failed']}, "
          "expected dk and dv only")
    return {"phase": "cp_xattn", "q_docs": CP_XATTN_Q_DOCS, "k_docs": CP_XATTN_K_DOCS,
            "chunks": CP_XATTN_CHUNKS, "heads": [TRAIN_HQ, TRAIN_HK], "head_dim": D,
            "dtype": "bfloat16", "note": "ranks sharing one card: not cp speeds",
            "runs": runs, "launches": launches,
            "planted_skip_memory_dkv_reduce": {"caught": sorted(caught),
                                               "failed": got["failed"]}}


CP_REUSE_STREAM = (  # (request, documents, the tier JAX's _try_plan_reuse resolves it through)
    ("A", (3000, 5000, 1500, 6000), "cold"),  # canonical documents (3072, 5120, 1536, 6144)
    ("B", (2900, 4700, 1400, 5900), "bucket"),
    ("C", (2900, 4700, 1400, 5900), "exact"),  # B again, on B's inputs
    ("D", (2900, 4700, 1400, 6000), "bucket"),  # B's last document grown: the tail extend
    ("E", (3072, 5120, 1536, 6144), "exact"),  # on the grid: the canonical runtime's own key
    ("F", (7000, 7000, 2000), "cold"),  # another bucket: (7168, 7168, 2048)
)
CP_REUSE_PATCHED = ("D",)  # bucket hits through try_incremental_update
CP_PACKED_BATCHES = 12
CP_PACKED_CAPACITY = 16384
CP_PACKED_DOC_MEDIAN = 1500  # tokens; lognormal lengths, sigma 1, in [32, 32768]


def key_tier(iface, make_key) -> tuple:
    """``make_key()`` and the tier it resolved through: ``bucket`` (a
    fingerprint hit), ``cold`` (a plan was solved: the canonical mask's, or
    the mask's own where reuse does not apply) or ``exact`` (the key was
    cached); with the host ms of the call and whether a bucket hit patched
    its bucket's last row maps (the O(delta) tail extend). ``iface`` is the
    port's ``api/interface.py`` (the tests pass the JAX package's too: its
    caches have the same fields)."""
    import torch

    cache = iface._plan_reuse_cache
    hits, misses, n = cache.hits, cache.misses, len(iface._runtime_dict)
    maps_before = {id(e.last_maps) for e in cache._d.values()}
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    key = make_key()
    ms = (time.perf_counter() - t0) * 1e3
    if cache.hits > hits:
        tier = "bucket"
    elif cache.misses > misses or len(iface._runtime_dict) > n:
        tier = "cold"
    else:
        tier = "exact"
    mgr = iface.get_runtime_mgr(key)
    patched = tier == "bucket" and any(
        e.canonical_key == mgr.canonical_key and id(e.last_maps) in maps_before
        for e in cache._d.values())
    return key, tier, ms, patched


def reuse_fallback(docs) -> str:
    """Why a varlen-causal request is not served by a bucketed runtime, in
    the JAX package's three cases."""
    from magiattention_tpu_torch import env
    from magiattention_tpu_torch.meta.plan_fingerprint import bucket_len

    if env.is_qo_comm_enable():
        return "qo-comm"
    if all(bucket_len(d) == d for d in docs):
        return "identity: every document on the bucket grid"
    return "unbucketable"


@in_rank
def cp_plan_reuse_rank(group, seed: int, stream=CP_REUSE_STREAM, heads=(TRAIN_HQ, TRAIN_HK),
                       head_dim=D, chunk=CP_CHUNK, packed=(CP_PACKED_BATCHES, CP_PACKED_CAPACITY),
                       device="cuda") -> dict:
    """One rank of the keyed API under ``MAGI_ATTENTION_PLAN_REUSE=bucket``
    (set for this task only): each request of ``stream`` through
    ``magi_attn_varlen_key`` -> ``dispatch`` -> ``calc_attn`` ->
    ``undispatch``, forward and backward (bf16 on the card, inputs and
    cotangents from the seed; a repeated mask reuses its inputs): its tier,
    host ms, canonical and padded totals, launches; on rank 0 the gathered
    out, lse, dq, dk, dv against single-card ``flex_flash_attn_func`` on
    the request's REAL mask, C's bitwise against B's, and the kernel call of
    the first bucket hit against the plain versions. Then the planted fault
    (B's runtime rebuilt from row maps that pad only the tail, as an exact
    key pads, instead of each document's segment), and the host-only tally
    of a ``utils.pack_corpus`` stream of ``packed`` (batches, capacity)
    through the keys, with no attention call. All of that with telemetry
    off; last, the stream once more from a cleared cache with telemetry on,
    unchecked: its tiers, key host ms, counters and series (the profiling
    phase holds the counters against the tiers)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from magiattention_tpu_torch import api, csrc
    from magiattention_tpu_torch.api import interface
    from magiattention_tpu_torch.api.functools import compute_pad_size
    from magiattention_tpu_torch.meta.plan_fingerprint import RowMaps, canonicalize_mask
    from magiattention_tpu_torch.parallel import dist_attn
    from magiattention_tpu_torch.utils import pack_corpus

    if device == "cuda":
        cp_rank_setup()
    rank, cp = dist.get_rank(group), dist.get_world_size(group)
    hq, hk = heads
    dtype = torch.bfloat16 if device == "cuda" else torch.float32
    gen = torch.Generator(device=device).manual_seed(seed)  # the same inputs on every rank
    inputs, by_name = {}, {}  # a repeated mask reuses its inputs

    def key_of(cu):
        return api.magi_attn_varlen_key(cu, cu[-1], group, num_heads=(hq, hk), head_dim=head_dim,
                                        chunk_size=chunk, out_dtype=dtype, device=device)

    def launched():
        return {n: csrc.launches[n] for n in FLEX_KERNELS if csrc.launches[n]}

    os.environ["MAGI_ATTENTION_PLAN_REUSE"] = "bucket"
    api.clear_cache()
    try:
        requests, outs, keys = [], {}, {}
        csrc.reset_launch_counts()
        for name, docs, _ in stream:
            t = sum(docs)
            if docs not in inputs:
                inputs[docs] = tuple(
                    torch.randn((t, h, head_dim), generator=gen, device=device, dtype=dtype)
                    for h in (hq, hk, hk, hq)) + (
                    torch.randn((t, hq), generator=gen, device=device),)
            q, k, v, g_out, g_lse = by_name[name] = inputs[docs]
            cu = np.concatenate([[0], np.cumsum(docs)]).astype(int).tolist()
            key, tier, ms, patched = key_tier(interface, lambda: key_of(cu))
            keys[name] = key
            mgr = api.get_runtime_mgr(key)
            bucketed = isinstance(mgr, api.BucketedDistAttnRuntimeMgr)
            canon = canonicalize_mask(key.q_ranges, key.k_ranges, key.attn_type_map, t)
            cap, before = {}, launched()
            # the first bucket hit's kernel call (the kernels alone run on the card)
            stage = (device == "cuda" and rank == 0 and tier == "bucket"
                     and not any(r["tier"] == "bucket" for r in requests))
            real_core = dist_attn.flex_attn_headmajor
            if stage:
                dist_attn.flex_attn_headmajor = capturing(real_core, cap)
            try:
                got = keyed_fwd_bwd(key, q, k, v, g_out, g_lse)
                if device == "cuda":
                    torch.cuda.synchronize()
            finally:
                dist_attn.flex_attn_headmajor = real_core
            after = launched()
            req = {"request": name, "docs": list(docs), "tokens": t, "tier": tier,
                   "key_host_ms": ms, "patched": patched, "bucketed": bucketed,
                   "fallback": None if bucketed else reuse_fallback(docs),
                   "canonical_total": None if canon is None else canon.total_seqlen,
                   "dispatched_total": mgr.dispatch_meta.total_seqlen,
                   "exact_key_total": t + compute_pad_size(t, cp, chunk),
                   "rows_padded": mgr.dispatch_meta.total_seqlen - t,
                   "launches": {n: c - before.get(n, 0) for n, c in after.items()
                                if c - before.get(n, 0)}}
            if stage:
                req["stage_check"] = _cp_stage_check(cap)
            if rank == 0:
                qr, kr, ty = (list(key.q_ranges), list(key.k_ranges), list(key.attn_type_map))
                errs, failed = vs_single_card(got, q, k, v, g_out, g_lse, qr, kr, ty, hq, hk)
                req["vs_single_card"] = errs
                check(not failed, f"cp_plan_reuse request {name} ({tier}): the gathered results "
                      f"fail {failed}: {errs}")
                outs[name] = got
            requests.append(req)
        launches = {}  # the stream's own: no reference or stage-check launch
        for req in requests:
            for n, c in req["launches"].items():
                launches[n] = launches.get(n, 0) + c
        res = {"rank": rank, "requests": requests, "launches": launches}
        if rank == 0 and "B" in outs and "C" in outs:
            res["c_bitwise_b"] = all(torch.equal(a, b) for a, b in zip(outs["C"], outs["B"]))

        # the planted fault: B's request on row maps that pad the tail only
        kb = keys["B"]
        mgr_b = api.get_runtime_mgr(kb)
        t = kb.total_seqlen_q - kb.pad_size
        canon_total = canonicalize_mask(kb.q_ranges, kb.k_ranges, kb.attn_type_map, t).total_seqlen
        tail_maps = RowMaps.from_segments([(0, t, canon_total - t)], t, canon_total)
        planted = dataclasses.replace(kb, flags=kb.flags + ("planted_tail_only_pad",))
        interface._runtime_dict.put(planted, interface._make_bucketed_mgr(
            planted, api.get_runtime_mgr(mgr_b.canonical_key), tail_maps))
        q, k, v, g_out, g_lse = by_name["B"]
        got = keyed_fwd_bwd(planted, q, k, v, g_out, g_lse)
        if rank == 0:
            errs, failed = vs_single_card(got, q, k, v, g_out, g_lse, list(kb.q_ranges),
                                          list(kb.k_ranges), list(kb.attn_type_map), hq, hk)
            res["planted_tail_only_pad"] = {"failed": failed, "vs_single_card": errs}

        # the host-only tally: packed batches of a fixed capacity
        n_batches, capacity = packed
        rng = np.random.default_rng(seed)
        lens = np.clip(rng.lognormal(np.log(CP_PACKED_DOC_MEDIAN), 1.0, 4 * n_batches * capacity
                                     // CP_PACKED_DOC_MEDIAN), 32, 32768).astype(int)
        batches = pack_corpus((np.zeros(n, np.int64) for n in lens), capacity,
                              flush_incomplete=False)
        tally = []
        for _, (_, cu) in zip(range(n_batches), batches):
            _, tier, ms, patched = key_tier(interface, lambda: key_of(cu))  # cu[-1] == capacity
            tally.append({"docs": len(cu) - 1, "tier": tier, "key_host_ms": ms,
                          "patched": patched})
        res["packed"] = tally

        # the stream again from a cleared cache, telemetry on: its counters
        # and series (the profiling phase), kept out of the timed pass above
        from magiattention_tpu_torch import telemetry

        api.clear_cache()
        telemetry.set_enabled(True)
        telemetry.reset()
        tiers, on_ms = [], []
        for name, docs, _ in stream:
            cu = np.concatenate([[0], np.cumsum(docs)]).astype(int).tolist()
            key, tier, ms, _ = key_tier(interface, lambda: key_of(cu))
            tiers.append(tier)
            on_ms.append(ms)
            keyed_fwd_bwd(key, *by_name[name])
        snap = telemetry.snapshot()
        telemetry.set_enabled(None)
        res["stream_telemetry"] = {
            "rank": rank, "tiers": tiers, "key_host_ms": on_ms, "counters": snap["counters"],
            "names": sorted({n.split("{")[0] for kind in ("counters", "gauges", "histograms")
                             for n in snap[kind]})}
        return res
    finally:
        from magiattention_tpu_torch import telemetry

        telemetry.set_enabled(None)
        telemetry.reset()
        os.environ.pop("MAGI_ATTENTION_PLAN_REUSE", None)
        api.clear_cache()


def cp_plan_reuse(pools, seed: int) -> dict:
    """Bucketed plan reuse at cp=2 (16 / 8 heads, d 128, chunk 512): the
    request stream's tiers as the JAX package resolves them, each request
    within the ``cp_attn`` bounds of single-card attention on its real
    mask, C bitwise B, one ``flex_fwd_hb``, ``flex_dq`` and ``flex_dkv``
    per request and rank, the first bucket hit's kernel call against the
    plain versions; the planted tail-only pad must fail out, lse and the
    gradients; the packed stream's tiers and host ms tallied."""
    import statistics

    res = pools[2].run(cp_plan_reuse_rank, seed)
    launches = {}
    for r in res:
        for req in r["requests"]:
            name, tier = req["request"], req["tier"]
            expect = dict((n, x) for n, _, x in CP_REUSE_STREAM)[name]
            check(tier == expect, f"cp_plan_reuse rank {r['rank']} request {name}: tier {tier}, "
                  f"the JAX package resolves it as {expect}")
            check(req["patched"] == (name in CP_REUSE_PATCHED),
                  f"cp_plan_reuse request {name}: patched {req['patched']}")
            check(req["launches"] == {n: 1 for n in TRAINING_KERNELS},
                  f"cp_plan_reuse rank {r['rank']} request {name}: launches {req['launches']}")
        for n, c in r["launches"].items():
            launches[n] = launches.get(n, 0) + c
    r0 = res[0]
    check(r0.get("c_bitwise_b") is True, "cp_plan_reuse: C (an exact hit on B's runtime) is not "
          "bitwise B")
    for req in r0["requests"]:
        for n, e in req.get("stage_check", {}).get("kernel_max_abs_err", {}).items():
            MAX_ERR[n] = max(MAX_ERR[n], e)
    check(any("stage_check" in req for req in r0["requests"]),
          "cp_plan_reuse: no bucket hit's kernel call was held against the plain versions")
    caught = {c.split(":")[0] for c in r0["planted_tail_only_pad"]["failed"]}
    check({"out", "lse", "dq", "dk", "dv"} <= caught,
          f"the planted tail-only pad: failed checks {r0['planted_tail_only_pad']['failed']}, "
          "expected out, lse, dq, dk and dv")
    tally = {}
    for tier in ("cold", "bucket", "exact"):
        ms = [b["key_host_ms"] for r in res for b in r["packed"] if b["tier"] == tier]
        tally[tier] = {"keys": len(ms), "median_host_ms": statistics.median(ms) if ms else None}
    return {"phase": "cp_plan_reuse", "cp": 2, "chunk": CP_CHUNK, "heads": [TRAIN_HQ, TRAIN_HK],
            "head_dim": D, "dtype": "bfloat16", "mode": "MAGI_ATTENTION_PLAN_REUSE=bucket",
            "note": "ranks sharing one card over gloo: host ms per rank, not cp speeds",
            "requests": [{**req, "key_host_ms_per_rank": [r["requests"][i]["key_host_ms"]
                                                         for r in res]}
                         for i, req in enumerate(r0["requests"])],
            "launches": launches,
            "stream_telemetry": [r["stream_telemetry"] for r in res],
            "planted_tail_only_pad": {"caught": sorted(caught),
                                      **r0["planted_tail_only_pad"]},
            "packed_stream": {"batches": CP_PACKED_BATCHES, "capacity": CP_PACKED_CAPACITY,
                              "doc_median": CP_PACKED_DOC_MEDIAN, "by_tier": tally,
                              "per_batch_rank0": res[0]["packed"]}}


# -- the serving control layer: the scheduler in its three tick modes ------------------

SCHED_PROMPTS = (1000, 1733, 2048, 2900, 4096, 5120, 6500, 8000)
SCHED_STEPS = 16  # decode steps of every request
SCHED_BASE = 4  # the 4096-token prompt: its token ids are registered, the forks extend it
SCHED_FORK_SUFFIXES = (300, 700, 1100)  # submitted once the base has prefilled
SCHED_BUDGET, SCHED_CHUNK = 2048, 512
SCHED_MODES = ("off", "on", "auto")
SCHED_CHECK_EVERY = 6  # every 6th fused tick of the `on` run against the plain version
SCHED_ROW_BLOCK = 16  # the plain version's rows at a time (each gathers its whole prefix)


def sched_requests(gen) -> tuple[list, list]:
    """The trace: 8 requests of 1000-8000 tokens (the base carrying token
    ids), and 3 higher-priority requests extending the base by token ids,
    each with SCHED_STEPS decode steps. Made once, shared by the modes."""
    import torch
    from magiattention_tpu_torch.serving import Request

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    def request(rid, t, tokens=None, priority=0, prefix=None):
        q, k, v = rand(t, HQ, D), rand(t, HK, D), rand(t, HK, D)
        if prefix is not None:  # a fork's prompt begins with the base's rows
            q, k, v = (torch.cat([p, x]) for p, x in zip(prefix, (q, k, v)))
        return Request(rid=rid, prompt_q=q, prompt_k=k, prompt_v=v, decode_q=rand(SCHED_STEPS, HQ, D),
                       decode_k=rand(SCHED_STEPS, HK, D), decode_v=rand(SCHED_STEPS, HK, D),
                       tokens=tokens, priority=priority)

    ids = torch.randint(0, VOCAB, (SCHED_PROMPTS[SCHED_BASE] + sum(SCHED_FORK_SUFFIXES),),
                        generator=gen, device="cuda").tolist()
    base_ids, rest = ids[:SCHED_PROMPTS[SCHED_BASE]], ids[SCHED_PROMPTS[SCHED_BASE]:]
    reqs = [request(i, t, tokens=base_ids if i == SCHED_BASE else None)
            for i, t in enumerate(SCHED_PROMPTS)]
    base = reqs[SCHED_BASE]
    forks = []
    for j, n in enumerate(SCHED_FORK_SUFFIXES):
        toks, rest = base_ids + rest[:n], rest[n:]
        forks.append(request(len(SCHED_PROMPTS) + j, n, tokens=toks, priority=1,
                             prefix=(base.prompt_q, base.prompt_k, base.prompt_v)))
    return reqs, forks


def uncounted(fn):
    """``fn()`` with the kernels' launch counts restored after it: a launch
    made to compare or time a kernel is no main-path launch."""
    from magiattention_tpu_torch import csrc

    saved = dict(csrc.launches)
    try:
        return fn()
    finally:
        csrc.launches.update(saved)


def merge_tick_pairs(tick, out, lse):
    """Each cascade pair's prefix row merged into its main row, as
    ``unified_tick_attn`` merges them."""
    import torch
    from magiattention_tpu_torch.ops import correct_attn_out_lse

    k = tick.num_pairs
    if not k:
        return out, lse
    pairs = torch.from_numpy(tick.merge_pairs()[:k]).to(out.device).long()
    mains, prefs = pairs[:, 0], pairs[:, 1]
    o_m, l_m = correct_attn_out_lse(out[prefs], lse[prefs], out[mains], lse[mains])
    return out.index_copy(0, mains, o_m), lse.index_copy(0, mains, l_m)


def tick_plain(cache, q_rows, tick):
    """The plain version of a tick's real rows: ``decode_reference`` in
    blocks of SCHED_ROW_BLOCK rows, each block over its longest prefix, the
    cascade pairs merged. f32 (out, lse)."""
    import torch
    from magiattention_tpu_torch.serving import decode_reference

    n, ps = tick.num_rows, cache.page_size
    bt = torch.from_numpy(tick.block_tables()).cuda()
    valid = tick.valid_lens()
    valid_t = torch.from_numpy(valid).cuda()
    outs, lses = [], []
    for r0 in range(0, n, SCHED_ROW_BLOCK):
        r1 = min(n, r0 + SCHED_ROW_BLOCK)
        w = max(1, -(-int(valid[r0:r1].max()) // ps))
        o, l = decode_reference(q_rows[r0:r1], cache, bt[r0:r1, :w], valid_t[r0:r1])
        outs.append(o)
        lses.append(l)
    return merge_tick_pairs(tick, torch.cat(outs), torch.cat(lses))


def tick_facts(cache, tick) -> dict:
    """A tick's geometry and the card's bound on its one launch: 4 d FLOPs
    per (row, covered token, q head); bytes: each page the tick covers read
    once, q read once, each row's partial written once. ``row_read_bytes``:
    what the rows read without reuse (each its own prefix)."""
    import numpy as np

    valid = tick.valid_lens()
    bt = tick.block_tables()
    n, ps = tick.num_rows, cache.page_size
    used = {int(p) for r in range(n) for p in bt[r, : -(-int(valid[r]) // ps)]}
    rows, entries = tick.finalize()
    page_bytes = ps * HK * D * 2 * 2  # K and V, bf16
    tokens = int(np.asarray(valid, np.int64).sum())
    nbytes = len(used) * page_bytes + rows * HQ * D * 2 + rows * HQ * (D + 1) * 4 + bt.nbytes
    bound_ms, bound_by = bound(4.0 * tokens * HQ * D, nbytes)
    return {"rows": n, "row_capacity": rows, "entry_capacity": entries,
            "prefill_rows": sum(s.num_rows for s in tick.segments if s.kind == "prefill"),
            "decode_rows": sum(1 for s in tick.segments if s.kind == "decode"),
            "cascade_pairs": tick.num_pairs, "covered_tokens": tokens,
            "pages_read": len(used), "bound_bytes": nbytes, "bound_ms": bound_ms,
            "bound_by": bound_by, "row_read_bytes": tokens * HK * D * 2 * 2,
            "row_read_ms_at_peak_bytes": tokens * HK * D * 2 * 2 / PEAK_BYTES * 1e3}


class TickWatch:
    """The instruments of a scheduler run: CUDA events around every kernel
    launch (per tick, by kernel), and each fused tick's inputs and f32
    result as ``ServingEngine.unified_tick`` hands them to and gets them
    from ``unified_tick_attn``, for the checks after the tick."""

    def __init__(self):
        self.events, self.fused = [], None

    def __enter__(self):
        import torch
        from magiattention_tpu_torch import csrc
        from magiattention_tpu_torch.serving import engine as engine_mod

        self._launch, self._tick_attn = csrc.launch, engine_mod.unified_tick_attn

        def launch(name, *args):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            self._launch(name, *args)
            end.record()
            self.events.append((name, start, end))

        def tick_attn(q_rows, cache, tick, **kw):
            out, lse = self._tick_attn(q_rows, cache, tick, **kw)
            self.fused = (q_rows, tick, out, lse, kw["num_splits"])
            return out, lse

        csrc.launch, engine_mod.unified_tick_attn = launch, tick_attn
        return self

    def __exit__(self, *exc):
        from magiattention_tpu_torch import csrc
        from magiattention_tpu_torch.serving import engine as engine_mod

        csrc.launch, engine_mod.unified_tick_attn = self._launch, self._tick_attn

    def take(self) -> tuple[dict, object]:
        """This tick's event ms by kernel (after a synchronise), and its
        fused call if it made one."""
        ms = {}
        for name, start, end in self.events:
            ms[name] = ms.get(name, 0.0) + start.elapsed_time(end)
        fused, self.events, self.fused = self.fused, [], None
        return ms, fused


def sched_check_tick(engine, fused, name, planted=False) -> dict:
    """One fused tick's result (its rows after the cascade merge) against
    the plain version; ``planted``: also the kernel on the tick's table
    with every prefill row's valid length one short (off by one), which the
    check must fail."""
    import torch
    from magiattention_tpu_torch.serving import decode_partials_for_tables

    q_rows, tick, out, lse, splits = fused
    n = tick.num_rows
    check(bool((out[n:] == 0).all()) and bool(torch.isneginf(lse[n:]).all()),
          f"{name}: a padding row (valid 0) is not the exact (0, -inf)")
    ref_o, ref_l = tick_plain(engine.cache, q_rows, tick)
    errs, failed = out_errors(out[:n], ref_o, [("lse", lse[:n], ref_l)])
    check(not failed, f"{name}: the fused tick fails the {failed} check(s) against the plain "
          f"version: {errs}")
    MAX_ERR["paged_decode"] = max(MAX_ERR["paged_decode"], errs["out_max_abs_err"])
    res = {"tick_vs_plain": errs}
    if planted:
        bad = tick.valid_lens().copy()
        for s in tick.segments:
            if s.kind == "prefill":
                bad[s.row_lo:s.row_hi] -= 1  # valid = start + i
        bt = torch.from_numpy(tick.block_tables()).cuda()
        got_o, got_l = merge_tick_pairs(tick, *uncounted(lambda: decode_partials_for_tables(
            q_rows, engine.cache, bt, torch.from_numpy(bad).cuda(), num_splits=splits)))
        _, caught = out_errors(got_o[:n], ref_o, [("lse", got_l[:n], ref_l)])
        check(bool(caught), f"{name}: the planted off-by-one prefill valid length passed")
        res["planted_valid_off_by_one"] = {"caught": caught}
    return res


def sched_run(mode, reqs, forks) -> tuple[dict, dict]:
    """One drain of the trace under ``MAGI_ATTENTION_UNIFIED_TICK=mode``:
    per tick the report, the wall ms (host clock, synchronised), the kernel
    launches and their event ms; under ``on`` every SCHED_CHECK_EVERY-th
    fused tick, each new largest one (with the planted fault) and the first
    with cascade pairs against the plain version, the largest also timed
    alone. Returns the run's line and each request's outputs."""
    import torch
    from magiattention_tpu_torch import csrc
    from magiattention_tpu_torch.serving import Scheduler, ServingEngine
    from magiattention_tpu_torch.serving import decode_attn as da
    from magiattention_tpu_torch.serving.scheduler import PREFILLING

    os.environ["MAGI_ATTENTION_UNIFIED_TICK"] = mode
    engine = ServingEngine(num_pages=1024, num_kv_heads=HK, head_dim=D, page_size=PAGE,
                           max_seqs=16, max_pages_per_seq=64, dtype=torch.bfloat16)
    sched = Scheduler(engine, token_budget=SCHED_BUDGET, chunk=SCHED_CHUNK)
    for r in reqs:
        sched.submit(r)
    forked, ticks, checks, largest, n_fused = False, [], [], None, 0
    try:
        with TickWatch() as watch:
            while not sched.done or not forked:
                base = sched._active.get(SCHED_BASE)
                if not forked and (SCHED_BASE in sched._finished
                                   or (base is not None and base.status != PREFILLING)):
                    for f in forks:
                        sched.submit(f)
                    forked = True
                before = dict(csrc.launches)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                rep = sched.step()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
                ev_ms, fused = watch.take()
                launched = {n: csrc.launches[n] - before[n] for n in csrc.launches
                            if csrc.launches[n] != before[n]}
                tick = {"step": rep.step, "decode_batch": rep.decode_batch,
                        "prefill_chunks": [list(c) for c in rep.prefill_chunks],
                        "tokens_used": rep.tokens_used, "admitted": list(rep.admitted),
                        "finished": sorted(rep.finished), "wall_ms": wall,
                        "programs": list(sched._tick_programs), "launches": launched,
                        "kernel_event_ms": ev_ms}
                if fused is not None:
                    n_fused += 1
                    facts = tick_facts(engine.cache, fused[1])
                    tick["fused"] = facts
                    check(launched == {"paged_decode": 1},
                          f"scheduler {mode} tick {rep.step}: a fused tick launched {launched}, "
                          "not paged_decode once")
                    new_max = largest is None or facts["covered_tokens"] > largest["covered_tokens"]
                    first_pairs = facts["cascade_pairs"] and not any(
                        c["cascade_pairs"] for c in checks)
                    if mode == "on" and (new_max or first_pairs
                                         or n_fused % SCHED_CHECK_EVERY == 0):
                        res = sched_check_tick(engine, fused, f"scheduler tick {rep.step}",
                                               planted=new_max and facts["prefill_rows"] > 0)
                        checks.append({"step": rep.step, **facts, **res})
                    if mode == "on" and new_max:
                        q_rows, t, _, _, splits = fused
                        bt = torch.from_numpy(t.block_tables()).cuda()
                        valid = torch.from_numpy(t.valid_lens()).cuda()
                        ms = uncounted(lambda: cuda_ms(lambda: da.decode_partials_for_tables(
                            q_rows, engine.cache, bt, valid, num_splits=splits), reps=5))
                        largest = {"step": rep.step, **facts, "paged_decode_ms": ms,
                                   "paged_decode_event_ms_in_run": ev_ms.get("paged_decode")}
                    elif new_max:
                        largest = {"step": rep.step, **facts}
                if mode == "on":
                    check(sum(launched.values()) <= 1,
                          f"scheduler on tick {rep.step}: {launched} launches, more than one")
                watch.events.clear()  # the checks' launches belong to no tick
                ticks.append(tick)
                check(len(ticks) < 400, f"scheduler {mode}: not drained in 400 ticks")
    finally:
        os.environ.pop("MAGI_ATTENTION_UNIFIED_TICK", None)
    outs = {rid: (st.prefill_out_tail, st.decode_outs) for rid, st in sched._finished.items()}
    check(len(outs) == len(reqs) + len(forks)
          and all(st.status == "finished" and st.tokens_done == SCHED_STEPS
                  for st in sched._finished.values()),
          f"scheduler {mode}: not every request finished its {SCHED_STEPS} steps")
    walls = sorted(t["wall_ms"] for t in ticks)
    line = {"mode": mode, "ticks": len(ticks), "wall_ms_total": sum(walls),
            "wall_ms_median": walls[len(walls) // 2], "wall_ms_max": walls[-1],
            "fused_ticks": n_fused,
            # each tick's wall less its kernels' event ms: the host's share
            "wall_less_kernel_ms_total": sum(t["wall_ms"] - sum(t["kernel_event_ms"].values())
                                             for t in ticks),
            "launches_per_tick_max": max(sum(t["launches"].values()) for t in ticks),
            "largest_fused_tick": largest, "checked_ticks": checks,
            "per_tick": {"wall_ms": [t["wall_ms"] for t in ticks],
                         "launches": [sum(t["launches"].values()) for t in ticks],
                         "kernel_event_ms": [sum(t["kernel_event_ms"].values()) for t in ticks],
                         "fused_rows": [t["fused"]["rows"] if "fused" in t else 0
                                        for t in ticks]}}
    del engine, sched
    torch.cuda.empty_cache()
    return line, outs, ticks


def sched_long_short(gen) -> dict:
    """One launch whose rows are one 8000-token history and three short
    ones (1, 37 and 300 tokens) on a 64-page table (few walks: the kernel
    spreads each over a cluster sized on the table width), and one with 31
    short rows beside the long one (one block a walk); every row against
    the plain version."""
    import torch
    from magiattention_tpu_torch.serving import decode_partials_for_tables, decode_reference

    res = {}
    for lens in ([8000, 1, 37, 300], [8000] + [1 + 13 * i for i in range(31)]):
        cache = decode_cache(gen, lens, mpp=64)
        q = torch.randn((len(lens), HQ, D), generator=gen, device="cuda").to(torch.bfloat16)
        bt, sl = cache.block_tables[: len(lens)], cache.seq_lens[: len(lens)]
        out, lse = uncounted(lambda: decode_partials_for_tables(q, cache, bt, sl))
        ref_o, ref_l = decode_reference(q, cache, bt, sl)
        errs, failed = out_errors(out, ref_o, [("lse", lse, ref_l)])
        check(not failed, f"scheduler: the long-and-short launch of {len(lens)} rows fails "
              f"{failed}: {errs}")
        MAX_ERR["paged_decode"] = max(MAX_ERR["paged_decode"], errs["out_max_abs_err"])
        res[f"rows_{len(lens)}"] = errs
    return res


def scheduler_phase(gen) -> dict:
    """The serving control layer: the same trace under each tick mode; the
    schedules identical, each request's outputs under ``on`` and ``auto``
    within the kernel bound of ``off``'s, at most one launch an ``on`` tick
    and one ``paged_decode`` a fused tick, sampled fused ticks and a
    long-and-short launch against the plain version, the planted off-by-one
    caught; per mode the tick wall ms and launches, and for the largest
    fused tick its ``paged_decode`` ms and bound beside the per-request
    path's ``flex_fwd_hb`` + ``paged_decode`` event ms on the same tick."""
    from magiattention_tpu_torch import csrc

    reqs, forks = sched_requests(gen)
    csrc.reset_launch_counts()
    runs, outs, ticks, launches = {}, {}, {}, {}
    for mode in SCHED_MODES:
        before = dict(csrc.launches)
        runs[mode], outs[mode], ticks[mode] = sched_run(mode, reqs, forks)
        launches[mode] = {n: csrc.launches[n] - before[n] for n in csrc.launches
                          if csrc.launches[n] != before[n]}
    total = {n: csrc.launches[n] for n in csrc.launches if csrc.launches[n]}
    keys = ("step", "decode_batch", "prefill_chunks", "tokens_used", "admitted", "finished")
    schedule = [[t[k] for k in keys] for t in ticks["off"]]
    for mode in ("on", "auto"):
        check([[t[k] for k in keys] for t in ticks[mode]] == schedule,
              f"scheduler: the {mode} schedule differs from off's")
    worst = {}
    for mode in ("on", "auto"):
        for rid, (tail, dec) in outs["off"].items():
            tail_m, dec_m = outs[mode][rid]
            pairs = list(zip(dec, dec_m)) + [(tail, tail_m)]
            for ref, got in pairs:
                errs, failed = out_errors(got, ref, [])
                check(not failed, f"scheduler: request {rid} under {mode} differs from off's "
                      f"beyond the kernel bound: {errs}")
                worst[mode] = max(worst.get(mode, 0.0), errs["out_max_abs_err"])
    check(any(c["cascade_pairs"] for c in runs["on"]["checked_ticks"]),
          "scheduler: no checked on tick carried cascade pairs")
    check(any("planted_valid_off_by_one" in c for c in runs["on"]["checked_ticks"]),
          "scheduler: the planted off-by-one was never run")
    big = runs["on"]["largest_fused_tick"]
    off_tick = next(t for t in ticks["off"] if t["step"] == big["step"])
    big["per_request_path_same_tick"] = {
        "programs": off_tick["programs"], "launches": off_tick["launches"],
        "kernel_event_ms": off_tick["kernel_event_ms"],
        "flex_fwd_hb_plus_paged_decode_event_ms": sum(
            off_tick["kernel_event_ms"].get(n, 0.0) for n in ("flex_fwd_hb", "paged_decode")),
        "wall_ms": off_tick["wall_ms"]}
    big["wall_ms"] = next(t["wall_ms"] for t in ticks["on"] if t["step"] == big["step"])
    check(launches["off"].get("flex_fwd_hb", 0) > 0 and "flex_fwd_hb" not in launches["on"]
          and set(total) == {"flex_fwd_hb", "paged_decode"},
          f"scheduler launches {launches}: flex_fwd_hb on the per-request path only")
    return {"phase": "scheduler", "heads": {"hq": HQ, "hk": HK, "head_dim": D},
            "dtype": "bfloat16", "page": PAGE, "prompts": list(SCHED_PROMPTS),
            "fork_suffixes": list(SCHED_FORK_SUFFIXES), "decode_steps": SCHED_STEPS,
            "token_budget": SCHED_BUDGET, "chunk": SCHED_CHUNK, "card": nvidia_smi_line(),
            "schedule_ticks": len(schedule), "on_auto_vs_off_out_max_abs_err": worst,
            "long_and_short_launch": sched_long_short(gen),
            "largest_fused_tick": big, "launches": total, "launches_by_mode": launches,
            "tick_programs": sorted({p for m in SCHED_MODES for t in ticks[m]
                                     for p in t["programs"] if p.startswith("tick[")}),
            "modes": {m: runs[m] for m in SCHED_MODES}}


# -- context-parallel decode -------------------------------------------------------

CP_DECODE_LENS = (4096, 6000, 8192, 10000, 16384, 20000, 24576, 32768)
CP_DECODE_RUNS = (2, 4)


def cp_decode_shards(lens, cp):
    """Each rank's contiguous [lo, hi) of every history; the last rank holds
    none of the first sequence."""
    out = []
    for s, n in enumerate(lens):
        cuts = [n * r // cp for r in range(cp + 1)]
        if s == 0:
            cuts[cp - 1] = n
        out.append([(cuts[r], cuts[r + 1]) for r in range(cp)])
    return out


@in_rank
def cp_decode_rank(group, seed: int, drop_rank: int | None = None) -> dict:
    """One rank of ``cp_decode_attn`` on the card: the 8 histories (the
    same on every rank, from ``seed``) cut into contiguous shards, this
    rank's in a local bf16 cache; the local decode (``paged_decode``) and
    the cross-rank merge over gloo; the merge alone on the host clock; on
    rank 0 the merged out and lse against single-card ``decode_attn_paged``
    over the whole histories and against the plain version. ``drop_rank``
    plants a merge that drops that rank's partial (rank 0 then returns the
    failed checks instead of raising)."""
    import torch
    import torch.distributed as dist
    from magiattention_tpu_torch import csrc
    from magiattention_tpu_torch.serving import (
        assign_block_table, cp_decode, cp_decode_attn, cp_merge_partials, decode_attn_paged,
        decode_reference, make_paged_kv_cache, write_prefill_kv)

    cp_rank_setup()
    rank, cp = dist.get_rank(group), dist.get_world_size(group)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((len(CP_DECODE_LENS), HQ, D), generator=gen, device="cuda").to(torch.bfloat16)
    hist = [torch.randn((2, n, HK, D), generator=gen, device="cuda").to(torch.bfloat16)
            for n in CP_DECODE_LENS]
    shards = cp_decode_shards(CP_DECODE_LENS, cp)

    def cache_of(spans):
        need = [-(-(hi - lo) // PAGE) for lo, hi in spans]
        mpp = max(max(need), 1)
        cache = make_paged_kv_cache(len(spans) * mpp + 1, PAGE, HK, D, max_seqs=len(spans),
                                    max_pages_per_seq=mpp, dtype=torch.bfloat16)
        for s, (lo, hi) in enumerate(spans):
            assign_block_table(cache, s, list(range(1 + s * mpp, 1 + (s + 1) * mpp)))
            if hi > lo:
                write_prefill_kv(cache, s, hist[s][0, lo:hi], hist[s][1, lo:hi])
        return cache

    cache = cache_of([sh[rank] for sh in shards])
    slots = torch.arange(len(CP_DECODE_LENS), device="cuda")
    real = cp_decode.all_gather_v
    if drop_rank is not None:
        def dropping(x, sizes, grp):
            flat = real(x, sizes, grp)
            b = sizes[drop_rank]
            flat[drop_rank * b:(drop_rank + 1) * b] = 0.0 if x.dim() == 3 else float("-inf")
            return flat

        cp_decode.all_gather_v = dropping
    try:
        dist.barrier(group)
        csrc.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, lse = cp_decode_attn(q, cache, slots, group=group, cp_size=cp)
        torch.cuda.synchronize()
        call_ms = (time.perf_counter() - t0) * 1e3
        launches = {n: csrc.launches[n] for n in csrc.launches if csrc.launches[n]}
    finally:
        cp_decode.all_gather_v = real
    res = {"rank": rank, "launches": launches, "first_call_host_ms": call_ms,
           "shard_tokens": [hi - lo for lo, hi in (sh[rank] for sh in shards)]}
    if drop_rank is None:
        local = uncounted(lambda: decode_attn_paged(q, cache, slots, out_dtype=torch.float32))
        merge_ms = []
        for _ in range(3):
            dist.barrier(group)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cp_merge_partials(*local, group=group, cp_size=cp)
            torch.cuda.synchronize()
            merge_ms.append((time.perf_counter() - t0) * 1e3)
        res["merge_host_ms"] = merge_ms
    if rank == 0:
        whole = cache_of([(0, n) for n in CP_DECODE_LENS])
        single = uncounted(lambda: decode_attn_paged(q, whole, slots))
        plain_o, plain_l = [], []
        for s, n in enumerate(CP_DECODE_LENS):  # one sequence at a time: each gathers its table
            w = -(-n // PAGE)
            o, l = decode_reference(q[s:s + 1], whole, whole.block_tables[s:s + 1, :w],
                                    whole.seq_lens[s:s + 1])
            plain_o.append(o)
            plain_l.append(l)
        failed = []
        for what, (ro, rl) in (("single_card", single), ("plain", (torch.cat(plain_o),
                                                                   torch.cat(plain_l)))):
            errs, bad = out_errors(out, ro, [("lse", lse, rl)])
            res[f"vs_{what}"] = errs
            failed += [f"{b}:{what}" for b in bad]
        res["failed"] = failed
        if drop_rank is None:
            check(not failed, f"cp_decode cp={cp}: the merged result fails {failed}: "
                  f"{res['vs_single_card']} {res['vs_plain']}")
    return res


def cp_decode_phase(pools, seed: int) -> dict:
    """``cp_decode_attn`` at cp=2 and cp=4 (ranks sharing one card over
    gloo): one ``paged_decode`` launch per rank, the merged result against
    single-card decode and the plain version; the planted drop of a rank's
    partial must fail."""
    runs, launches = [], {}
    for cp in CP_DECODE_RUNS:
        res = pools[cp].run(cp_decode_rank, seed)
        for r in res:
            check(r["launches"] == {"paged_decode": 1},
                  f"cp_decode cp={cp} rank {r['rank']}: launches {r['launches']}")
            for n, c in r["launches"].items():
                launches[n] = launches.get(n, 0) + c
        MAX_ERR["paged_decode"] = max(MAX_ERR["paged_decode"],
                                      res[0]["vs_plain"]["out_max_abs_err"])
        runs.append({"cp": cp, "vs_single_card": res[0]["vs_single_card"],
                     "vs_plain": res[0]["vs_plain"],
                     "shard_tokens_per_rank": [r["shard_tokens"] for r in res],
                     "first_call_host_ms_per_rank": [r["first_call_host_ms"] for r in res],
                     "merge_host_ms_per_rank": [r["merge_host_ms"] for r in res]})
    planted = pools[2].run(cp_decode_rank, seed, 1)[0]
    check(bool(planted["failed"]), "cp_decode: the planted drop of rank 1's partial passed")
    return {"phase": "cp_decode", "lengths": list(CP_DECODE_LENS),
            "heads": {"hq": HQ, "hk": HK, "head_dim": D}, "dtype": "bfloat16", "page": PAGE,
            "note": "ranks sharing one card over gloo: host ms, not cp speeds", "runs": runs,
            "launches": launches, "planted_drop_rank_partial": {"failed": planted["failed"]}}


# -- disaggregated serving ---------------------------------------------------------

TIERED_SPECS = ("prefill=1,decode=2x1", "prefill=1,decode=2x2")
TIERED_PROMPTS = SCHED_PROMPTS[:6]  # the scheduler trace's first six prompts, 1000-5120 tokens
TIERED_STEPS = 8
TIERED_BUDGETS = (SCHED_BUDGET, 16)  # (prefill, decode) tokens a tick
TIERED_ATOL = 2e-3  # tiered decode outputs against the one-card scheduler's
TIERED_DEVICES = ["cuda:0"] * 5  # every tier on the one card


def tiered_tp_decode(engine, slots, gen) -> dict:
    """TP decode on the serving path's final pool (8 sequences, 8 kv heads,
    one split): at tp 2 and 4 over ``cuda:0`` repeated, out and lse bit for
    bit equal to the one-launch decode and within the kernel bound of the
    plain version, one ``paged_decode`` launch a slice; whether the bits
    also hold with each slice's clusters sized for its own heads (no
    ``cluster_heads``); and a planted fault, each slice's q over its
    neighbour's kv heads, which the plain check must catch."""
    import torch
    from magiattention_tpu_torch import csrc
    from magiattention_tpu_torch.serving import (
        ShardedPagedKVCache, decode_attn_paged, decode_reference, shard_kv_cache, tp_decode_attn,
    )
    from magiattention_tpu_torch.serving import distributed as dist_mod

    cache = engine.cache
    idx = torch.as_tensor(slots, device="cuda")
    q = torch.randn((len(slots), HQ, D), generator=gen, device="cuda").to(torch.bfloat16)
    ref_out, ref_lse = uncounted(lambda: decode_attn_paged(q, cache, idx))
    plain_o, plain_l = decode_reference(q, cache, cache.block_tables[idx], cache.seq_lens[idx])
    res = {}
    for tp in (2, 4):
        devs = TIERED_DEVICES[:tp]
        sc = shard_kv_cache(cache, devs)
        csrc.reset_launch_counts()
        out, lse = tp_decode_attn(q, sc, idx, devices=devs)
        launched = {n: c for n, c in csrc.launches.items() if c}
        check(launched == {"paged_decode": tp},
              f"tp_decode tp={tp}: launched {launched}, not paged_decode once a slice")
        check(torch.equal(out, ref_out) and torch.equal(lse, ref_lse),
              f"tp_decode tp={tp}: not bit for bit the one-launch decode")
        compare("paged_decode", f"tiered_tp{tp}_decode", out, plain_o, lse, plain_l)
        real = dist_mod.decode_attn_paged

        def own_clusters(*a, **kw):  # each slice's clusters sized for its own kv heads
            return real(*a, **{**kw, "cluster_heads": 0})

        dist_mod.decode_attn_paged = own_clusters
        try:
            o_own, l_own = uncounted(lambda: tp_decode_attn(q, sc, idx, devices=devs))
        finally:
            dist_mod.decode_attn_paged = real
        # planted: shard i holds shard i+1's kv heads
        rolled = ShardedPagedKVCache(sc.shards[1:] + sc.shards[:1])
        got_o, got_l = uncounted(lambda: tp_decode_attn(q, rolled, idx, devices=devs))
        _, caught = out_errors(got_o, plain_o, [("lse", got_l, plain_l)])
        check(bool(caught), f"tp_decode tp={tp}: the planted neighbour-heads slice passed")
        ms = uncounted(lambda: cuda_ms(lambda: tp_decode_attn(q, sc, idx, devices=devs), reps=20))
        res[f"tp{tp}"] = {"bitwise_equal_one_launch": True,
                          "bitwise_equal_without_cluster_heads":
                              bool(torch.equal(o_own, ref_out) and torch.equal(l_own, ref_lse)),
                          "launches": launched, "planted_neighbour_heads_caught": caught,
                          "ms": ms}
        del sc, rolled
    res["one_launch_ms"] = uncounted(lambda: cuda_ms(lambda: decode_attn_paged(q, cache, idx),
                                                     reps=20))
    res["cached_tokens"] = int(cache.seq_lens[idx].sum())
    return res


def tiered_requests(gen, prompts, steps) -> list:
    """One request a prompt (token ids through a fixed table, so that a
    replay's fork finds the same KV), ``steps`` decode steps each."""
    import torch
    from magiattention_tpu_torch.serving import Request

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    reqs = []
    for rid, t in enumerate(prompts):
        ids = torch.randint(0, VOCAB, (t,), generator=gen, device="cuda").tolist()
        reqs.append(Request(rid=rid, prompt_q=rand(t, HQ, D), prompt_k=rand(t, HK, D),
                            prompt_v=rand(t, HK, D), decode_q=rand(steps, HQ, D),
                            decode_k=rand(steps, HK, D), decode_v=rand(steps, HK, D),
                            tokens=ids))
    return reqs


def tiered_engine(spec, **kw):
    """A ``TieredEngine`` over ``spec`` (through ``MAGI_ATTENTION_SERVING_MESH``)
    on TIERED_DEVICES, with stream digests checked; ``kw`` overrides the
    serving phase's pool geometry."""
    import torch
    from magiattention_tpu_torch.serving import TieredEngine

    os.environ["MAGI_ATTENTION_SERVING_MESH"] = spec  # the user's way to pick the layout
    try:
        geom = {**dict(num_pages=1024, max_seqs=16, max_pages_per_seq=64), **kw}
        return TieredEngine(num_kv_heads=HK, head_dim=D, page_size=PAGE, dtype=torch.bfloat16,
                            devices=TIERED_DEVICES, verify_streams=True, **geom)
    finally:
        os.environ.pop("MAGI_ATTENTION_SERVING_MESH", None)


def tiered_run(spec, reqs, **kw) -> tuple[dict, dict]:
    """Drain ``reqs`` through a ``TieredScheduler`` over ``spec`` (every tier
    on ``cuda:0``): per tick the report, wall ms (host clock, synchronised),
    launches and kernel event ms; every stream's bytes, host ms and digest
    check. Returns the run's line and each request's decode outputs."""
    import torch
    from magiattention_tpu_torch import csrc
    from magiattention_tpu_torch.serving import TieredScheduler

    eng = tiered_engine(spec, **kw)
    sched = TieredScheduler(eng, prefill_budget=TIERED_BUDGETS[0],
                            decode_budget=TIERED_BUDGETS[1], chunk=SCHED_CHUNK)
    for r in reqs:
        sched.submit(r)
    ticks, streams = [], []
    with TickWatch() as watch:
        while not sched.done:
            before = dict(csrc.launches)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rep = sched.step()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            ev_ms, _ = watch.take()
            launched = {n: csrc.launches[n] - before[n] for n in csrc.launches
                        if csrc.launches[n] != before[n]}
            groups = sum(1 for p in sched._tick_programs if p.startswith("decode["))
            check(launched.get("paged_decode", 0) == groups * eng.mesh_spec["decode_tp"],
                  f"tiered {spec} tick {rep.step}: {launched} for {groups} decode groups, not "
                  "one paged_decode a slice")
            streams += [{"sid": s.sid, "replica": s.replica, "pages": s.pages,
                         "tokens": s.tokens, "bytes": s.nbytes,
                         "host_ms": s.duration_s * 1e3, "digest_ok": s.digest_ok}
                        for s in sched.last_stream_reports]
            ticks.append({"step": rep.step, "decode_batch": rep.decode_batch,
                          "prefill_chunks": [list(c) for c in rep.prefill_chunks],
                          "wall_ms": wall, "launches": launched, "kernel_event_ms": ev_ms,
                          "streams": len(sched.last_stream_reports)})
            check(len(ticks) < 400, f"tiered {spec}: not drained in 400 ticks")
    check(all(s["digest_ok"] for s in streams) and len(streams) >= len(reqs),
          f"tiered {spec}: a stream's digest failed or a request never streamed: {streams}")
    outs = {rid: st.decode_outs for rid, st in sched._finished.items()}
    check(all(st.status == "finished" and st.tokens_done == st.request.num_new_tokens
              for st in sched._finished.values()) and len(outs) == len(reqs),
          f"tiered {spec}: not every request finished")
    walls = [t["wall_ms"] for t in ticks]
    line = {"spec": spec, "ticks": len(ticks), "wall_ms_total": sum(walls),
            "wall_ms_max": max(walls),
            "wall_less_kernel_ms_total": sum(t["wall_ms"] - sum(t["kernel_event_ms"].values())
                                             for t in ticks),
            "replicas_used": sorted({s["replica"] for s in streams}),
            "restarts": [r.restarts for r in eng.replicas],
            "streams": {"count": len(streams), "bytes": sum(s["bytes"] for s in streams),
                        "host_ms_total": sum(s["host_ms"] for s in streams),
                        "host_ms_max": max(s["host_ms"] for s in streams)},
            "requeues": {rid: st.requeues for rid, st in sched._finished.items() if st.requeues},
            "per_tick": {"wall_ms": walls, "decode_batch": [t["decode_batch"] for t in ticks],
                         "launches": [sum(t["launches"].values()) for t in ticks]}}
    del sched, eng
    torch.cuda.empty_cache()
    return line, outs


def single_card_run(reqs) -> tuple[dict, dict]:
    """The same requests through the one-card ``Scheduler`` at the two tiers'
    summed budget: the reference outputs, and its wall ms."""
    import torch
    from magiattention_tpu_torch.serving import Scheduler, ServingEngine

    engine = ServingEngine(num_pages=1024, num_kv_heads=HK, head_dim=D, page_size=PAGE,
                           max_seqs=16, max_pages_per_seq=64, dtype=torch.bfloat16)
    sched = Scheduler(engine, token_budget=sum(TIERED_BUDGETS), chunk=SCHED_CHUNK)
    for r in reqs:
        sched.submit(r)
    walls = []
    while not sched.done:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sched.step()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    outs = {rid: st.decode_outs for rid, st in sched._finished.items()}
    del sched, engine
    torch.cuda.empty_cache()
    return {"ticks": len(walls), "wall_ms_total": sum(walls), "wall_ms_max": max(walls)}, outs


def outs_err(got: dict, ref: dict) -> float:
    """The largest |difference| of any request's decode outputs."""
    import torch

    check(set(got) == set(ref), f"requests differ: {sorted(got)} vs {sorted(ref)}")
    return max(float((torch.stack(got[r]).float() - torch.stack(ref[r]).float()).abs().max())
               for r in ref)


def tiered_planted_stream(gen) -> dict:
    """A stream whose hop drops its last page: the destination digest must
    fail."""
    eng = tiered_engine("prefill=1,decode=1x2")
    (req,) = tiered_requests(gen, (1000,), 1)
    real = eng._stream_pages

    def drop_last(src_pages, rep, dst_pages):
        pk, pv = real(src_pages[:-1], rep, dst_pages[:-1])
        return eng._prefill.cache.k_pages[src_pages], eng._prefill.cache.v_pages[src_pages]

    eng._stream_pages = drop_last
    res = eng.admit(req.prompt_len, tokens=req.tokens)
    uncounted(lambda: eng.prefill(req.prompt_q, req.prompt_k, req.prompt_v, res.slot))
    (report,) = eng.take_stream_reports()
    check(report.digest_ok is False, "tiered: the planted stream that drops its last page passed")
    return {"pages": report.pages, "caught": True}


def tiered_phase(gen, tp_line) -> dict:
    """Disaggregated serving at the serving widths, every tier on the one
    card: TP decode (``tp_line``, from :func:`tiered_tp_decode`); the first
    six scheduler prompts with 8 decode steps each through a
    ``TieredScheduler`` over ``prefill=1,decode=2x1`` and ``2x2`` (in turns,
    each twice), every
    stream's digest checked and every request's outputs within TIERED_ATOL
    of the one-card ``Scheduler``'s; a replica pool too small for its
    requests' growth (a ``DecodeTierFault``, the requests replayed, outputs
    within the same bound of a run with room); the planted stream. No
    disaggregation speed: the tiers share one card."""
    from magiattention_tpu_torch import csrc

    reqs = tiered_requests(gen, TIERED_PROMPTS, TIERED_STEPS)
    ref_line, ref_outs = uncounted(lambda: single_card_run(reqs))
    csrc.reset_launch_counts()
    runs, errs = {spec: [] for spec in TIERED_SPECS}, {}
    for spec in (*TIERED_SPECS, *reversed(TIERED_SPECS)):  # in turns: a, b, b, a
        line, outs = tiered_run(spec, reqs)
        runs[spec].append(line)
        err = outs_err(outs, ref_outs)
        errs[spec] = max(errs.get(spec, 0.0), err)
        check(err <= TIERED_ATOL, f"tiered {spec}: decode outputs {err} from the one-card "
              f"scheduler's (bound {TIERED_ATOL})")
        check(line["replicas_used"] == [0, 1], f"tiered {spec}: one replica idle")
    launches = {n: c for n, c in csrc.launches.items() if c}
    check(set(launches) == {"flex_fwd_hb", "paged_decode"},
          f"tiered launches {launches}: not flex_fwd_hb prefill and paged_decode")
    # three one-page prompts on pools of 3 pages: two share replica 0,
    # where the second one's growth into a second page fails
    fault_reqs = tiered_requests(gen, (PAGE,) * 3, 3)
    fault_line, fault_outs = uncounted(lambda: tiered_run(
        "prefill=1,decode=2x2", fault_reqs, num_pages=3, max_seqs=2, max_pages_per_seq=3))
    _, room_outs = uncounted(lambda: tiered_run("prefill=1,decode=2x2", fault_reqs))
    faulted = [rid for rid, rq in fault_line["requeues"].items()
               if ("decode", "decode_fault") in rq]
    check(bool(faulted) and max(fault_line["restarts"]) >= 1,
          f"tiered fault run: no DecodeTierFault ({fault_line['requeues']})")
    fault_err = outs_err(fault_outs, room_outs)
    check(fault_err <= TIERED_ATOL, f"tiered fault run: replayed outputs {fault_err} off")
    return {"phase": "tiered", "heads": {"hq": HQ, "hk": HK, "head_dim": D},
            "dtype": "bfloat16", "page": PAGE, "devices": TIERED_DEVICES,
            "card": nvidia_smi_line(), "prompts": list(TIERED_PROMPTS),
            "decode_steps": TIERED_STEPS, "budgets": dict(zip(("prefill", "decode"),
                                                             TIERED_BUDGETS)),
            "chunk": SCHED_CHUNK, "tp_decode": tp_line, "single_card": ref_line,
            "runs": runs, "out_max_abs_err_vs_single_card": errs,
            "replica_fault": {"faulted_requests": faulted, "restarts": fault_line["restarts"],
                              "requeues": fault_line["requeues"],
                              "out_max_abs_err_vs_room": fault_err},
            "planted_stream_drop_last_page": tiered_planted_stream(gen),
            "launches": launches}


# -- resilience: chaos, guards and the degradation paths ------------------------------

RES_PLANT = "corrupt_partial:site=split0,value=nan"  # seed 0: (row 0, head 0) of split 0
RES_CP_T = 8192  # the cp part: causal 8192 at the LlamaConfig widths, degree 1
RES_STAGE0 = "corrupt_partial:site=stage0,value=nan,rank=0,seed=64"
RES_STRAGGLER = "straggler:hop=1,delay=32"
RES_ROW_SEQS = 70_000  # one-page sequences: past the 65,535 row groups of one launch
RES_ROW_PAGE = 16
RES_ROW_HEADS, RES_ROW_D = 8, 64
RES_PREFIX = 1024  # the cascade part's shared prompt: 8 full pages
RES_FORKS = (200, 300, 500)


@contextlib.contextmanager
def magi_flags(**flags):
    """``MAGI_ATTENTION_<NAME>`` set for the block (a None value unsets it),
    the bounded chaos injectors rearmed on the way in and out; restored
    after."""
    from magiattention_tpu_torch.resilience import reset_chaos

    names = {f"MAGI_ATTENTION_{k}": v for k, v in flags.items()}
    saved = {n: os.environ.get(n) for n in names}
    for n, v in names.items():
        if v is None:
            os.environ.pop(n, None)
        else:
            os.environ[n] = str(v)
    reset_chaos()
    try:
        yield
    finally:
        for n, v in saved.items():
            if v is None:
                os.environ.pop(n, None)
            else:
                os.environ[n] = v
        reset_chaos()


def resilience_flags(guard: str = "off", chaos: str = ""):
    """``MAGI_ATTENTION_GUARD`` / ``_CHAOS`` set for the block (the bounded
    injectors rearmed on the way in and out), then restored."""
    return magi_flags(GUARD=guard, CHAOS=chaos)


def guard_sites(fn):
    """The sites of the ``NumericalGuardError`` that ``fn()`` raises, or None
    when it returns."""
    from magiattention_tpu_torch.resilience import NumericalGuardError

    try:
        fn()
    except NumericalGuardError as e:
        return list(e.sites)
    return None


def counted(launches: dict, fn):
    """``fn()`` with the kernels' counts zeroed just before it; its launches
    are added into ``launches``."""
    from magiattention_tpu_torch import csrc

    csrc.reset_launch_counts()
    try:
        return fn()
    finally:
        for n, c in csrc.launches.items():
            if c:
                launches[n] = launches.get(n, 0) + c


def guard_cost(fn, calls: int = 20) -> dict:
    """A call's cost in the current guard mode: ``device_ms``, the kernels'
    device time a call (``torch.profiler``; a guarded call reads its code on
    the host, so CUDA events around a run of calls would time the host's
    gaps), ``host_ms``, the call's synchronised latency (median), and the
    kernels a call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    ms = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    return {"device_ms": sum(e.self_device_time_total for e in kernels) / 1e3 / calls,
            "host_ms": sorted(ms)[calls // 2],
            "kernels_per_call": sum(e.count for e in kernels) / calls}


def resilience_decode(engine, slots, gen) -> dict:
    """The serving pool's decode (``decode_attn_paged`` over the serving
    phase's 8 sequences at Llama-3.1-8B widths, one split): ``off``,
    ``check`` and ``repair`` with no chaos bit for bit equal, each mode's
    cost a call (:func:`guard_cost`); the split-0 plant under
    ``check`` raising naming ``split0``, under ``repair`` giving (0, -inf) at
    (row 0, head 0) and off's bits everywhere else."""
    import torch
    from magiattention_tpu_torch.serving import decode_attn_paged

    idx = torch.as_tensor(slots, device="cuda")
    q = torch.randn((len(slots), HQ, D), generator=gen, device="cuda").to(torch.bfloat16)
    launches, got, cost = {}, {}, {}

    def step():
        return decode_attn_paged(q, engine.cache, idx)

    for mode in ("off", "check", "repair"):
        with resilience_flags(mode):
            got[mode] = counted(launches, step)
            cost[mode] = uncounted(lambda: guard_cost(step))
    off_out, off_lse = got["off"]
    for mode in ("check", "repair"):
        check(torch.equal(got[mode][0], off_out) and torch.equal(got[mode][1], off_lse),
              f"resilience decode: {mode} without chaos differs from off")
    with resilience_flags("check", RES_PLANT):
        sites = counted(launches, lambda: guard_sites(step))
    check(sites == ["split0"], f"resilience decode: the split-0 plant under check raised {sites}")
    with resilience_flags("repair", RES_PLANT):
        out, lse = counted(launches, step)
    keep = torch.ones(lse.shape, dtype=torch.bool, device="cuda")
    keep[0, 0] = False
    check(bool(torch.isneginf(lse[0, 0])) and bool((out[0, 0] == 0).all())
          and torch.equal(out[keep], off_out[keep]) and torch.equal(lse[keep], off_lse[keep]),
          "resilience decode: repair of the split-0 plant is not (0, -inf) at (0, 0) with off's "
          "bits elsewhere")
    check(set(launches) == {"paged_decode"}, f"resilience decode launches {launches}")
    return {"batch": len(slots), "guard_cost": cost, "launches": launches,
            "cases": {"check_no_chaos": "bitwise_off", "repair_no_chaos": "bitwise_off",
                      "split0_check": {"raised": sites},
                      "split0_repair": "(0, -inf) at (0, 0), off elsewhere"}}


def resilience_serving(gen) -> dict:
    """The cascade and the engine's degradation paths at the serving widths:
    a 1024-token prompt and three forks onto its pages, cascade decode under
    the split-0 plant (``check`` raises naming ``split0``, ``repair`` is
    finite); a ``prefill_error:times=1`` prefill raising and the free pages
    back at their count; ``alloc_fail:times=1`` answering ``alloc_error``;
    ``pool_exhaust`` answering ``pool_exhausted`` without raising."""
    import torch
    from magiattention_tpu_torch.resilience import ChaosInjectedError
    from magiattention_tpu_torch.serving import ServingEngine

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    launches = {}
    engine = ServingEngine(num_pages=64, num_kv_heads=HK, head_dim=D, page_size=PAGE,
                           max_seqs=8, max_pages_per_seq=16, dtype=torch.bfloat16)
    ids = torch.randint(0, VOCAB, (RES_PREFIX + sum(RES_FORKS),), generator=gen,
                        device="cuda").tolist()
    system, rest, slots = ids[:RES_PREFIX], ids[RES_PREFIX:], []
    for n in (0, *RES_FORKS):
        toks, rest = system + rest[:n], rest[n:]
        res = engine.admit(len(toks), tokens=toks)
        left = len(toks) - res.prefix_len
        check(res.admitted and (n == 0 or res.prefix_len == RES_PREFIX),
              f"resilience cascade: admission {res}")
        counted(launches, lambda: engine.prefill(rand(left, HQ, D), rand(left, HK, D),
                                                 rand(left, HK, D), res.slot))
        slots.append(res.slot)
    b = len(slots)

    def cascade_step():
        return engine.decode_step(rand(b, HQ, D), rand(b, HK, D), rand(b, HK, D), slots,
                                  cascade=True)

    with resilience_flags("check", RES_PLANT):
        sites = counted(launches, lambda: guard_sites(cascade_step))
    check(sites == ["split0"], f"resilience cascade: the plant under check raised {sites}")
    with resilience_flags("repair", RES_PLANT):
        out, lse = counted(launches, cascade_step)
    groups = engine.last_decode_info.get("cascade_groups")
    check(groups == 1 and bool(torch.isfinite(out).all()) and not bool(torch.isnan(lse).any()),
          f"resilience cascade: repair gave {groups} groups, finite {bool(torch.isfinite(out).all())}")

    free = engine.allocator.num_pages - engine.allocator.pages_in_use
    res = engine.admit(1500)
    check(res.admitted, f"resilience prefill_error: admission {res}")
    with resilience_flags(chaos="prefill_error:times=1"):
        try:
            counted(launches, lambda: engine.prefill(rand(1500, HQ, D), rand(1500, HK, D),
                                                     rand(1500, HK, D), res.slot))
            raised = None
        except ChaosInjectedError as e:
            raised = type(e).__name__
    free_after = engine.allocator.num_pages - engine.allocator.pages_in_use
    check(raised == "ChaosInjectedError" and free_after == free,
          f"resilience prefill_error: raised {raised}, free pages {free} -> {free_after}")
    verdicts = {}
    for spec in ("alloc_fail:times=1", "pool_exhaust"):
        with resilience_flags(chaos=spec):
            v = engine.admit(300)
        verdicts[spec] = v.reason
    check(verdicts == {"alloc_fail:times=1": "alloc_error", "pool_exhaust": "pool_exhausted"},
          f"resilience admission verdicts {verdicts}")
    check(engine.admit(300).admitted, "resilience: admission after chaos cleared refused")
    check(set(launches) == {"flex_fwd_hb", "paged_decode"}, f"resilience serving {launches}")
    del engine
    torch.cuda.empty_cache()
    return {"launches": launches, "cases": {
        "cascade_split0_check": {"raised": sites}, "cascade_split0_repair": "finite",
        "prefill_error": {"raised": raised, "free_pages": [free, free_after]},
        "admission": verdicts}}


def resilience_tiers(gen) -> dict:
    """The tiered phase's trace at ``prefill=1,decode=2x1`` on cuda:0, clean
    and under ``decode_fault:times=1``: the faulted replica's requests
    replay, one replica restarts, and every request's decode outputs equal
    the clean run's bit for bit."""
    spec, launches = "prefill=1,decode=2x1", {}
    reqs = tiered_requests(gen, TIERED_PROMPTS, TIERED_STEPS)
    clean_line, clean = counted(launches, lambda: tiered_run(spec, reqs))
    with resilience_flags(chaos="decode_fault:times=1"):
        line, outs = counted(launches, lambda: tiered_run(spec, reqs))
    faulted = sorted(rid for rid, rq in line["requeues"].items() if ("decode", "decode_fault") in rq)
    err = outs_err(outs, clean)
    check(bool(faulted) and sum(line["restarts"]) == 1 and err == 0.0,
          f"resilience tiers: faulted {faulted}, restarts {line['restarts']}, outputs {err} off")
    return {"launches": launches, "cases": {"decode_fault": {
        "faulted_requests": faulted, "restarts": line["restarts"], "ticks": line["ticks"],
        "clean_ticks": clean_line["ticks"], "out_max_abs_err_vs_clean": err}}}


@in_rank
def resilience_cp_rank(group, seed: int) -> dict:
    """One rank of the keyed cp API on the card under the resilience flags:
    cp 2, degree 1, causal RES_CP_T at 16 / 8 heads, d 128, bf16. Every run
    is the forward of ``dispatch`` -> ``calc_attn`` on this rank's shard;
    the repair run also the backward. Returns this rank's raised sites and
    its checks' facts; the parent asserts them."""
    import torch
    import torch.distributed as dist
    from magiattention_tpu_torch import api, csrc
    from magiattention_tpu_torch.config import DistAttnConfig
    from magiattention_tpu_torch.meta.solver.overlap_solver import OverlapConfig

    cp_rank_setup()
    rank, t = dist.get_rank(group), RES_CP_T
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, g_out = (torch.randn((t, h, D), generator=gen, device="cuda", dtype=torch.bfloat16)
                      for h in (TRAIN_HQ, TRAIN_HK, TRAIN_HK, TRAIN_HQ))
    g_lse = torch.randn((t, TRAIN_HQ), generator=gen, device="cuda")

    def key_of(degree=1):
        return api.magi_attn_flex_key(
            [(0, t)], [(0, t)], [1], t, t, group, num_heads=(TRAIN_HQ, TRAIN_HK), head_dim=D,
            chunk_size=CP_CHUNK,
            dist_attn_config=DistAttnConfig(overlap_config=OverlapConfig(degree=degree)))

    def forward(key, grad=False):
        qs, ks, vs = (api.dispatch(x, key).detach().requires_grad_(grad) for x in (q, k, v))
        out, meta = api.calc_attn(qs, ks, vs, key)
        if grad:
            go, gl = api.dispatch(g_out, key), api.dispatch(g_lse, key)
            loss = (out.float() * go.float()).sum() + torch.where(
                torch.isfinite(meta.lse), meta.lse * gl, 0.0).sum()
            loss.backward()
            return out.detach(), meta.lse, (qs.grad, ks.grad, vs.grad)
        return out.detach(), meta.lse

    def run(impl, guard="off", chaos="", fn=None):
        os.environ["MAGI_ATTENTION_GROUP_COLL_IMPL"] = impl
        try:
            with resilience_flags(guard, chaos):
                key = key_of()
                return (fn or forward)(key), api.get_runtime_mgr(key).plan
        finally:
            os.environ.pop("MAGI_ATTENTION_GROUP_COLL_IMPL", None)

    def raised(impl, guard, chaos):
        sites = run(impl, guard, chaos, fn=lambda key: guard_sites(lambda: forward(key)))[0]
        every = [None] * dist.get_world_size(group)
        dist.all_gather_object(every, sites, group=group)
        return every

    dist.barrier(group)
    torch.cuda.synchronize()
    csrc.reset_launch_counts()
    (off_out, off_lse), plan = run("a2a")
    check(plan.overlap_degree == 1, f"resilience cp: the plan has degree {plan.overlap_degree}")
    (chk_out, chk_lse), _ = run("a2a", "check")
    res = {"rank": rank, "check_bitwise_off": torch.equal(chk_out, off_out)
           and torch.equal(chk_lse, off_lse)}
    res["stage0_check_raised"] = raised("a2a", "check", RES_STAGE0)
    (rep_out, rep_lse, grads), _ = run("a2a", "repair", RES_STAGE0,
                                      fn=lambda key: forward(key, grad=True))
    res["repair_finite"] = {"out": bool(torch.isfinite(rep_out).all()),
                            "lse": not bool(torch.isnan(rep_lse).any()),
                            "grads": all(bool(torch.isfinite(g).all()) for g in grads)}
    (fb_out, fb_lse), fb_plan = run("a2a", chaos="plan_error:times=1")
    errs, failed = out_errors(fb_out, off_out, [("lse", fb_lse, off_lse)])
    res["plan_error"] = {"degree": fb_plan.overlap_degree, "vs_staged": errs, "failed": failed}
    (hb_out, hb_lse), hb_plan = run("hops", chaos="hops_build_error:times=1")
    res["hops_build_error"] = {
        "impls": [c.impl for c in hb_plan.comms()],
        "reasons": [c.impl_reason for c in hb_plan.comms()],
        "bitwise_a2a": torch.equal(hb_out, off_out) and torch.equal(hb_lse, off_lse)}
    res["corrupt_cast_check_raised"] = raised("a2a", "check", "corrupt_cast:value=nan,seed=3")

    def timed(key):
        forward(key)  # warm
        ms = []
        for _ in range(5):
            dist.barrier(group)
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out, lse = forward(key)
            end.record()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(end))
        return out, lse, sorted(ms)[len(ms) // 2]

    (h_out, h_lse, h_ms), h_plan = run("hops", fn=timed)
    (s_out, s_lse, s_ms), _ = run("hops", chaos=RES_STRAGGLER, fn=timed)
    res["straggler"] = {"impls": [c.impl for c in h_plan.comms()],
                        "bitwise": torch.equal(s_out, h_out) and torch.equal(s_lse, h_lse),
                        "device_ms": h_ms, "device_ms_with_straggler": s_ms,
                        "added_device_ms": s_ms - h_ms}
    torch.cuda.synchronize()
    res["launches"] = {n: c for n, c in csrc.launches.items() if c}
    return res


def resilience_cp(pools, seed: int) -> dict:
    """The cp part on ranks sharing the card (cp 2, gloo): check without chaos
    bit for bit off; the stage-0 plant caught on rank 0 only; repair finite
    forward and backward; a plan build failure falling back to degree 0
    within the kernel bound of the staged result; a hop-plan build failure
    giving the a2a collective and its bits; a corrupted cast caught at the
    stage that read it; a straggler leaving the bits and adding device ms."""
    res = pools[2].run(resilience_cp_rank, seed)
    launches = {}
    for r in res:
        for n, c in r["launches"].items():
            launches[n] = launches.get(n, 0) + c
        check(r["check_bitwise_off"], f"resilience cp rank {r['rank']}: check differs from off")
        check(r["stage0_check_raised"] == [["stage0"], None],
              f"resilience cp: the stage-0 plant raised {r['stage0_check_raised']}")
        check(all(r["repair_finite"].values()), f"resilience cp repair {r['repair_finite']}")
        check(r["plan_error"]["degree"] == 0 and not r["plan_error"]["failed"],
              f"resilience cp plan_error: {r['plan_error']}")
        hb = r["hops_build_error"]
        check(set(hb["impls"]) == {"a2a"} and set(hb["reasons"]) == {"degraded_hops_build_error"}
              and hb["bitwise_a2a"], f"resilience cp hops_build_error: {hb}")
        check(r["corrupt_cast_check_raised"] == [["stage0"], ["stage0"]],
              f"resilience cp corrupt_cast: raised {r['corrupt_cast_check_raised']}")
        check(r["straggler"]["bitwise"] and set(r["straggler"]["impls"]) == {"hops"},
              f"resilience cp straggler: {r['straggler']}")
    check(set(launches) == {"flex_fwd_hb", "flex_dq", "flex_dkv"}, f"resilience cp {launches}")
    r0 = res[0]
    return {"launches": launches, "cases": {
        "check_no_chaos": "bitwise_off", "stage0_check": {"raised": r0["stage0_check_raised"]},
        "stage0_repair": r0["repair_finite"], "plan_error": r0["plan_error"],
        "hops_build_error": r0["hops_build_error"],
        "corrupt_cast_check": {"raised": r0["corrupt_cast_check_raised"]},
        "straggler": [r["straggler"] for r in res]}}


def resilience_row_blocks(gen) -> dict:
    """A flat ``paged_decode`` of RES_ROW_SEQS one-page sequences at 8 / 8
    heads, d 64, bf16: past the grid's 65,535 row groups, so it launches in
    row blocks, and it must equal the plain version."""
    import torch
    from magiattention_tpu_torch.serving import (
        decode_attn_paged, decode_reference, make_paged_kv_cache)

    n, ps, h, d = RES_ROW_SEQS, RES_ROW_PAGE, RES_ROW_HEADS, RES_ROW_D
    cache = make_paged_kv_cache(n + 1, ps, h, d, max_seqs=n, max_pages_per_seq=1,
                                dtype=torch.bfloat16)
    cache.k_pages.copy_(torch.randn(cache.k_pages.shape, generator=gen, device="cuda"))
    cache.v_pages.copy_(torch.randn(cache.v_pages.shape, generator=gen, device="cuda"))
    cache.block_tables[:, 0] = torch.arange(1, n + 1, device="cuda", dtype=cache.block_tables.dtype)
    cache.seq_lens.copy_(torch.randint(1, ps + 1, (n,), generator=gen, device="cuda"))
    q = torch.randn((n, h, d), generator=gen, device="cuda").to(torch.bfloat16)
    launches = {}
    out, lse = counted(launches, lambda: decode_attn_paged(q, cache, torch.arange(n,
                                                                                 device="cuda")))
    check(launches == {"paged_decode": 2}, f"resilience row blocks: launches {launches}")
    ref_out, ref_lse = decode_reference(q, cache, cache.block_tables, cache.seq_lens)
    compare("paged_decode", f"row_blocks_{n}", out, ref_out, lse, ref_lse)
    err = float((out.float() - ref_out).abs().max())
    del cache, q
    torch.cuda.empty_cache()
    return {"launches": launches, "cases": {"row_blocks": {
        "sequences": n, "heads": [h, h], "head_dim": d, "page": ps, "out_max_abs_err": err}}}


def resilience_phase(parts: dict, t0: float) -> dict:
    """The resilience line: every part's cases, the guards' cost by mode, and
    the phase's launches summed over its parts (each part's counts zeroed
    just before it)."""
    launches = {}
    for part in parts.values():
        for n, c in part["launches"].items():
            launches[n] = launches.get(n, 0) + c
    return {"phase": "resilience", "card": nvidia_smi_line(),
            "guard_cost_decode": parts["decode"]["guard_cost"],
            "cases": {name: part["cases"] for name, part in parts.items()},
            "launches": launches, "launches_by_part": {n: p["launches"] for n, p in parts.items()},
            "wall_s": time.perf_counter() - t0}


# -- serving observability: the telemetry layer on the serving path ----------------

TEL_MODE = "auto"  # MAGI_ATTENTION_UNIFIED_TICK of the phase's scheduler runs
TEL_SHADOW_RATE = 4  # every 4th per-request decode batch against the plain decode
TEL_MEM_PRESSURE = 0.95  # free-page fraction: the trace's pool stays under it, so it fires
TEL_COST_REPEATS = 5  # telemetry off / on drains of the trace, in turns
TEL_RING_SMALL = 8  # the engine-fault run's span ring: small enough to drop spans
TEL_MEM_TOL = 0.25  # one decode step's measured temporaries vs the ledger's scratch
TEL_PREFIX = 1000  # the CoW part's prompt: 7 full pages and a 104-token tail


def tel_drain(reqs, forks) -> dict:
    """One drain of the scheduler phase's trace (its forks submitted once the
    base prompt has prefilled) through a fresh engine and ``Scheduler`` at the
    serving widths, under whatever flags are set: each tick's report, its
    host ms (the ``step()`` call on the host clock) and wall ms (synchronised
    before and after), and each request's outputs."""
    import torch
    from magiattention_tpu_torch.serving import Scheduler, ServingEngine
    from magiattention_tpu_torch.serving.scheduler import PREFILLING

    engine = ServingEngine(num_pages=1024, num_kv_heads=HK, head_dim=D, page_size=PAGE,
                           max_seqs=16, max_pages_per_seq=64, dtype=torch.bfloat16)
    sched = Scheduler(engine, token_budget=SCHED_BUDGET, chunk=SCHED_CHUNK)
    for r in reqs:
        sched.submit(r)
    forked, reports, host, wall = False, [], [], []
    while not sched.done or not forked:
        base = sched._active.get(SCHED_BASE)
        if not forked and (SCHED_BASE in sched._finished
                           or (base is not None and base.status != PREFILLING)):
            for f in forks:
                sched.submit(f)
            forked = True
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reports.append(sched.step())
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        host.append((t1 - t0) * 1e3)
        wall.append((time.perf_counter() - t0) * 1e3)
        check(len(reports) < 400, "telemetry: the trace did not drain in 400 ticks")
    outs = {rid: (st.prefill_out_tail, st.decode_outs) for rid, st in sched._finished.items()}
    check(len(outs) == len(reqs) + len(forks)
          and all(st.tokens_done == SCHED_STEPS for st in sched._finished.values()),
          "telemetry: not every request finished its decode steps")
    return {"reports": reports, "outs": outs, "host_ms": host, "wall_ms": wall,
            "flight_ticks": len(sched._flight.snapshot_ticks())}


def tel_cost(reqs, forks) -> dict:
    """Host ms per tick with telemetry off and on (the flag alone: no shadow
    check, watcher or server): one warm-up drain, then TEL_COST_REPEATS
    pairs of drains in turns (off, on). Per drain the median tick and the
    mean tick (host and wall); per mode the median of the drains; and the
    pairs' differences (on less off), median and range."""
    import statistics

    tel_drain(reqs, forks)  # warm-up: first-use costs land in no measured drain
    per = {"off": [], "on": []}
    for _ in range(TEL_COST_REPEATS):
        for mode in ("off", "on"):
            with magi_flags(TELEMETRY="1" if mode == "on" else "0"):
                run = tel_drain(reqs, forks)
            per[mode].append({"host_ms_median": statistics.median(run["host_ms"]),
                              "host_ms_mean": statistics.fmean(run["host_ms"]),
                              "wall_ms_median": statistics.median(run["wall_ms"]),
                              "wall_ms_mean": statistics.fmean(run["wall_ms"]),
                              "ticks": len(run["host_ms"])})
    keys = ("host_ms_median", "host_ms_mean", "wall_ms_median", "wall_ms_mean")
    out = {mode: {k: statistics.median(r[k] for r in runs) for k in keys}
           for mode, runs in per.items()}
    for k in ("host_ms_median", "host_ms_mean"):
        diffs = sorted(b[k] - a[k] for a, b in zip(per["off"], per["on"]))
        out[f"on_minus_off_{k}"] = {"median": statistics.median(diffs), "min": diffs[0],
                                    "max": diffs[-1]}
    out["drains"] = per
    return out


def tel_same_runs(off, on) -> None:
    """The telemetry-off and -on drains: equal ``StepReport``s, every output
    ``torch.equal``."""
    import torch

    check([dataclasses.asdict(r) for r in on["reports"]]
          == [dataclasses.asdict(r) for r in off["reports"]],
          "telemetry: the StepReports differ between telemetry off and on")
    for rid, (tail, dec) in off["outs"].items():
        tail_on, dec_on = on["outs"][rid]
        check(torch.equal(tail, tail_on) and len(dec) == len(dec_on)
              and all(torch.equal(a, b) for a, b in zip(dec, dec_on)),
              f"telemetry: request {rid}'s outputs differ between telemetry off and on")


def tel_scrape() -> dict:
    """``GET /metrics`` of the running server parsed and equal to the
    rendered snapshot; ``/healthz`` answers."""
    import urllib.request

    from magiattention_tpu_torch import telemetry

    server = telemetry.ensure_metrics_server()
    check(server is not None, "telemetry: no metrics server was started by the engine")
    base = f"http://127.0.0.1:{server.port}"
    text = urllib.request.urlopen(base + "/metrics", timeout=30).read().decode()
    rendered = telemetry.render_prometheus(telemetry.snapshot())
    parsed = telemetry.parse_prometheus_text(text)
    check(text == rendered and parsed == telemetry.parse_prometheus_text(rendered),
          "telemetry: the scraped /metrics differs from render_prometheus(snapshot())")
    health = urllib.request.urlopen(base + "/healthz", timeout=30).read()
    check(health == b"ok\n", f"telemetry: /healthz answered {health!r}")
    return {"port": server.port, "series": len(parsed), "bytes": len(text)}


def tel_traces(n_requests: int) -> dict:
    """One complete trace per request, submit first and finished last, each
    with its TTFT not below its queue time."""
    from magiattention_tpu_torch import telemetry

    traces = telemetry.export_request_traces()
    rids = sorted(t.rid for t in traces.values())
    check(rids == list(range(n_requests)), f"telemetry: traces of requests {rids}")
    bad = [t.rid for t in traces.values()
           if not t.complete or t.spans[0]["kind"] != "submit"
           or t.spans[-1]["kind"] != "finished" or t.stats["ttft_s"] is None
           or t.stats["ttft_s"] < t.stats["queue_s"]]
    check(not bad, f"telemetry: incomplete traces or TTFT below queue time: {bad}")
    ttft = sorted(t.stats["ttft_s"] * 1e3 for t in traces.values())
    return {"requests": len(traces), "spans": sum(len(t.spans) for t in traces.values()),
            "ttft_ms": {"min": ttft[0], "median": ttft[len(ttft) // 2], "max": ttft[-1]}}


def tel_dump(path: str, trigger: str) -> dict:
    """A flight dump's trigger and its memory section: every source with the
    card allocator's numbers and a fragmentation map."""
    with open(path) as f:
        payload = json.load(f)
    check(payload["trigger"]["trigger"] == trigger,
          f"telemetry: dump {path} is a {payload['trigger']['trigger']} dump, not {trigger}")
    memory = payload.get("memory") or {}
    pools = {}
    for name, src in memory.items():
        engines = [src] if "ledger" in src else [v for v in src.values() if isinstance(v, dict)]
        for eng in engines:
            check("allocator" in eng and "fragmentation" in eng,
                  f"telemetry: the {trigger} dump's memory source {name} lacks the allocator "
                  "numbers or the fragmentation map")
            pools[eng["fragmentation"]["pool"]] = {
                "allocator": eng["allocator"], "states": eng["fragmentation"]["state_counts"]}
    check(bool(pools), f"telemetry: the {trigger} dump has no memory section")
    return {"ticks": len(payload["ticks"]), "context": payload["trigger"]["context"],
            "pools": pools, "numerics": "numerics" in payload}


def tel_dumps_of(trigger: str) -> list:
    from magiattention_tpu_torch import telemetry

    out = []
    for path in telemetry.get_flight_recorder().dump_paths:
        with open(path) as f:
            if json.load(f)["trigger"]["trigger"] == trigger:
                out.append(path)
    return out


def tel_serving_pool(gen) -> dict:
    """The serving phase's pool geometry with 8 sequences of 1000 tokens: one
    decode step's synchronising calls with telemetry off and on (shadow
    sampling 0; ``torch.cuda.set_sync_debug_mode("warn")``), in turns; the
    ledger's pool bytes against the pool tensors', and one decode step's
    measured memory against the ledger (``ledger_vs_measured``)."""
    import warnings

    import torch
    from magiattention_tpu_torch import telemetry
    from magiattention_tpu_torch.serving import ServingEngine, decode_attn_paged

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    engine = ServingEngine(num_pages=1024, num_kv_heads=HK, head_dim=D, page_size=PAGE,
                           max_seqs=16, max_pages_per_seq=64, dtype=torch.bfloat16)
    slots = []
    for _ in range(8):
        res = engine.admit(1000)
        engine.prefill(rand(1000, HQ, D), rand(1000, HK, D), rand(1000, HK, D), res.slot)
        slots.append(res.slot)
    syncs = {"off": [], "on": []}
    with magi_flags(SHADOW_SAMPLE_RATE="0"):
        for mode in ("warm", "off", "on", "off", "on"):
            telemetry.set_enabled(mode == "on")
            q, k, v = rand(8, HQ, D), rand(8, HK, D), rand(8, HK, D)
            torch.cuda.synchronize()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    engine.decode_step(q, k, v, slots)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            if mode != "warm":
                syncs[mode].append(sum("synchroniz" in str(w.message) for w in caught))
    telemetry.set_enabled(True)
    check(max(syncs["on"]) <= min(syncs["off"]),
          f"telemetry: a decode step with telemetry on synchronises more than off: {syncs}")
    led = telemetry.serving_memory_ledger(engine, num_q_heads=HQ, decode_batch=len(slots),
                                          num_splits=1)
    pool = engine.cache.k_pages.nbytes + engine.cache.v_pages.nbytes
    check(led.total("pool") == pool,
          f"telemetry: the ledger's pool bytes {led.total('pool')} != the pool's {pool}")
    idx = torch.as_tensor(slots, device="cuda")
    q = rand(len(slots), HQ, D)
    measured = uncounted(lambda: telemetry.measure_program_memory(
        lambda q_, c_, i_: decode_attn_paged(q_, c_, i_, num_splits=1), q, engine.cache, idx))
    cmp = telemetry.ledger_vs_measured(led, measured, program="decode_step")
    temp_ratio = measured["temp_bytes"] / max(cmp.predicted_scratch_bytes, 1)
    check(cmp.within(0.10) and abs(temp_ratio - 1.0) <= TEL_MEM_TOL,
          f"telemetry: one decode step's memory off the ledger: {cmp.to_json()}, measured "
          f"temporaries {temp_ratio:.3f} x the ledger's scratch (tolerance {TEL_MEM_TOL})")
    telemetry.fragmentation_map(engine.allocator, record=True)
    telemetry.record_hbm_sample(telemetry.sample_memory_stats())
    line = {"syncs_per_decode_step": syncs, "pool_bytes": pool,
            "ledger_vs_measured": {**cmp.to_json(), "measured": measured,
                                   "temp_vs_scratch": temp_ratio, "tolerance": TEL_MEM_TOL}}
    del engine
    torch.cuda.empty_cache()
    return line


def tel_prefix_and_guard(gen) -> dict:
    """A small pool at the serving widths: a 1000-token prompt registered, a
    fork extending it (its first write splits the shared tail page), both
    released, a long tokenless admission evicting the trie's pages; then a
    decode under ``MAGI_ATTENTION_GUARD=check`` with the split-0 plant, which
    raises naming ``split0`` and dumps ``numerical_guard``."""
    import torch
    from magiattention_tpu_torch.serving import ServingEngine

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    engine = ServingEngine(num_pages=16, num_kv_heads=HK, head_dim=D, page_size=PAGE,
                           max_seqs=4, max_pages_per_seq=16, dtype=torch.bfloat16)
    big_len = 12 * PAGE - 10  # its next decode token stays in its last page: no growth
    ids = torch.randint(0, VOCAB, (TEL_PREFIX + 100,), generator=gen, device="cuda").tolist()
    a = engine.admit(TEL_PREFIX, tokens=ids[:TEL_PREFIX])
    engine.prefill(rand(TEL_PREFIX, HQ, D), rand(TEL_PREFIX, HK, D), rand(TEL_PREFIX, HK, D),
                   a.slot)
    b = engine.admit(len(ids), tokens=ids)
    check(b.prefix_len == TEL_PREFIX, f"telemetry: the fork matched {b.prefix_len} tokens")
    engine.prefill(rand(100, HQ, D), rand(100, HK, D), rand(100, HK, D), b.slot)
    engine.free(a.slot)
    engine.free(b.slot)
    big = engine.admit(big_len)
    check(big.admitted, f"telemetry: the evicting admission was refused: {big}")
    engine.prefill(rand(big_len, HQ, D), rand(big_len, HK, D), rand(big_len, HK, D), big.slot)
    with magi_flags(GUARD="check", CHAOS=RES_PLANT):
        sites = guard_sites(lambda: engine.decode_step(rand(1, HQ, D), rand(1, HK, D),
                                                       rand(1, HK, D), [big.slot]))
    check(sites == ["split0"], f"telemetry: the split-0 plant under check raised {sites}")
    dumps = tel_dumps_of("numerical_guard")
    check(len(dumps) == 1, f"telemetry: {len(dumps)} numerical_guard dumps")
    line = {"guard_raised": sites, "numerical_guard_dump": tel_dump(dumps[0], "numerical_guard")}
    del engine
    torch.cuda.empty_cache()
    return line


def tel_plan_solver() -> dict:
    """One cold and one warm resolution of a 4096-token causal prefill's key
    through the scheduler's plan probe (a one-rank gloo group on the CPU):
    the plan solver's miss and hit seconds, and the ms a hit saved."""
    import torch.distributed as dist
    from magiattention_tpu_torch.serving import PlanReuseProbe

    made = not dist.is_initialized()
    probe = PlanReuseProbe(num_heads=(HQ, HK), head_dim=D, chunk_size=SCHED_CHUNK)
    try:
        for _ in range(2):
            probe.note_prefill(0, 0, 4096)
    finally:
        from magiattention_tpu_torch import api

        api.clear_cache()
        if made and dist.is_initialized():
            dist.destroy_process_group()
    return {"resolutions": probe.stats.total_resolutions}


def tel_engine_fault(reqs) -> dict:
    """The trace under ``prefill_error:times=1`` with a span ring of
    TEL_RING_SMALL: the first prefill raises out of the tick, the aborted
    tick is recorded and the ``engine_fault`` dump flushed, and the ring
    drops spans (``magi_trace_events_dropped_total``)."""
    import torch
    from magiattention_tpu_torch.resilience import ChaosInjectedError
    from magiattention_tpu_torch.serving import Scheduler, ServingEngine
    from magiattention_tpu_torch.telemetry import events

    events._buffer = None  # the ring is sized when it is first made
    try:
        with magi_flags(CHAOS="prefill_error:times=1", TELEMETRY_RING_SIZE=TEL_RING_SMALL):
            engine = ServingEngine(num_pages=1024, num_kv_heads=HK, head_dim=D, page_size=PAGE,
                                   max_seqs=16, max_pages_per_seq=64, dtype=torch.bfloat16)
            sched = Scheduler(engine, token_budget=SCHED_BUDGET, chunk=SCHED_CHUNK)
            for r in reqs:
                sched.submit(r)
            try:
                sched.step()
                raised = None
            except ChaosInjectedError as e:
                raised = type(e).__name__
            dropped = events.get_event_buffer().dropped
    finally:
        events._buffer = None
    check(raised == "ChaosInjectedError", f"telemetry: the prefill_error tick raised {raised}")
    check(dropped > 0, "telemetry: the small ring dropped no span")
    dumps = tel_dumps_of("engine_fault")
    check(len(dumps) == 1, f"telemetry: {len(dumps)} engine_fault dumps")
    with open(dumps[0]) as f:
        aborted = json.load(f)["ticks"][-1].get("aborted", "")
    check("ChaosInjectedError" in aborted, f"telemetry: the dump's last tick is {aborted!r}")
    del sched, engine
    torch.cuda.empty_cache()
    return {"raised": raised, "ring": TEL_RING_SMALL, "dropped_spans": dropped,
            "engine_fault_dump": tel_dump(dumps[0], "engine_fault")}


def tel_tiered_fault(gen) -> dict:
    """The tiered trace at ``prefill=1,decode=2x1`` on cuda:0 under
    ``decode_fault:times=1`` with telemetry on: the distserve series and a
    ``decode_tier_fault`` dump."""
    spec = "prefill=1,decode=2x1"
    reqs = tiered_requests(gen, TIERED_PROMPTS, TIERED_STEPS)
    with magi_flags(CHAOS="decode_fault:times=1"):
        line, _ = tiered_run(spec, reqs)
    check(sum(line["restarts"]) == 1, f"telemetry tiers: restarts {line['restarts']}")
    dumps = tel_dumps_of("decode_tier_fault")
    check(len(dumps) == 1, f"telemetry tiers: {len(dumps)} decode_tier_fault dumps")
    return {"spec": spec, "ticks": line["ticks"], "restarts": line["restarts"],
            "decode_tier_fault_dump": tel_dump(dumps[0], "decode_tier_fault")}


def tel_required(snap) -> dict:
    """Every series of the REQUIRED sets the phase must populate, and of
    REQUIRED_MEMORY_METRICS (all recorded here), by metric name."""
    from magiattention_tpu_torch import telemetry

    present = {k.split("{")[0] for sec in snap.values() for k in sec}
    sets = {name: getattr(telemetry, f"REQUIRED_{name}_METRICS")
            for name in ("SERVING", "SCHED", "TRACE", "PREFIX", "COMPILE", "DISTSERVE", "MEMORY")}
    missing = {name: sorted(set(s) - present) for name, s in sets.items() if set(s) - present}
    check(not missing, f"telemetry: required series missing: {missing}")
    return {name: len(s) for name, s in sets.items()}


def telemetry_phase(gen) -> dict:
    """Serving observability on the card: the scheduler phase's trace under
    ``MAGI_ATTENTION_UNIFIED_TICK=auto``, telemetry off then on (the
    Prometheus endpoint on a free port, the shadow check at every
    TEL_SHADOW_RATE-th decode batch, the memory-pressure watcher at
    TEL_MEM_PRESSURE, dumps into a scratch directory): the same reports and
    bits; the scrape equal to the snapshot; one complete trace per request;
    the shadow checks within the bf16 budget; no added synchronisation; the
    planted faults' dumps (``numerical_guard``, ``engine_fault``,
    ``mem_pressure``, ``decode_tier_fault``) each with the allocator's
    numbers and the pool's fragmentation map; the ledger against the pool
    and a measured decode step; the required series; and the host ms a tick
    costs with telemetry off and on. The phase's launches are counted from
    zero at its start; the comparisons' are not."""
    import socket
    import tempfile

    from magiattention_tpu_torch import csrc, telemetry

    t0 = time.perf_counter()
    reqs, forks = sched_requests(gen)
    dump_dir = tempfile.mkdtemp(prefix="chip_smoke_trace_")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    csrc.reset_launch_counts()
    try:
        with magi_flags(UNIFIED_TICK=TEL_MODE, TRACE_DIR=dump_dir, TELEMETRY="0",
                        METRICS_PORT="0", SHADOW_SAMPLE_RATE="0", MEM_PRESSURE_THRESHOLD="0"):
            cost = tel_cost(reqs, forks)
            off = tel_drain(reqs, forks)
            # the on run's traces and dumps alone; the registry keeps the
            # cost runs' records and the kernel builds' (main() records them)
            telemetry.get_event_buffer().clear()
            telemetry.reset_request_traces()
            telemetry.reset_flight_recorder()
            telemetry.reset_numerics_census()
            with magi_flags(TELEMETRY="1", METRICS_PORT=port, SHADOW_SAMPLE_RATE=TEL_SHADOW_RATE,
                            MEM_PRESSURE_THRESHOLD=TEL_MEM_PRESSURE):
                on = tel_drain(reqs, forks)
                tel_same_runs(off, on)
                scrape = tel_scrape()
                traces = tel_traces(len(reqs) + len(forks))
                census = telemetry.get_numerics_census().numerics_snapshot()
                div = telemetry.snapshot()["histograms"].get("magi_numerics_shadow_divergence")
                check(census["shadow_checks"] > 0 and census["shadow_breaches"] == 0
                      and div is not None and div["count"] == census["shadow_checks"],
                      f"telemetry: shadow checks {census['shadow_checks']}, breaches "
                      f"{census['shadow_breaches']}: "
                      + json.dumps([{"violations": r["violations"], **{
                          k: r["report"][k] for k in ("out_max_abs", "out_max_rel", "out_max_ulp",
                                                      "out_mean_ulp", "lse_max_abs",
                                                      "lse_max_ulp", "worst")}}
                          for r in census["shadow"]]))
                pressure = tel_dumps_of("mem_pressure")
                check(len(pressure) == 1, f"telemetry: {len(pressure)} mem_pressure dumps")
                mem_pressure = tel_dump(pressure[0], "mem_pressure")
                pool = tel_serving_pool(gen)
                prefix_guard = tel_prefix_and_guard(gen)
                solver = tel_plan_solver()
                fault = tel_engine_fault(reqs)
                tiers = tel_tiered_fault(gen)
                snap = telemetry.snapshot()
                required = tel_required(snap)
                summary = telemetry.telemetry_summary(snap)
    finally:
        telemetry.stop_metrics_server()
        telemetry.set_enabled(None)
        telemetry.reset()
        telemetry.reset_flight_recorder()
        shutil.rmtree(dump_dir, ignore_errors=True)
    launches = {n: c for n, c in csrc.launches.items() if c}
    check(set(launches) == {"flex_fwd_hb", "paged_decode"},
          f"telemetry: the phase launched {launches}")
    compiles = telemetry.get_compile_tracker().stats()
    return {"phase": "telemetry", "card": nvidia_smi_line(), "mode": TEL_MODE,
            "heads": {"hq": HQ, "hk": HK, "head_dim": D}, "dtype": "bfloat16", "page": PAGE,
            "requests": len(reqs) + len(forks), "ticks": len(on["reports"]),
            "cost_host_ms_per_tick": cost, "shadow": {
                "rate": TEL_SHADOW_RATE, "checks": census["shadow_checks"],
                "breaches": census["shadow_breaches"], "max_ulp": div["max"],
                "max_ulp_every_output_last_checks": max(
                    r["report"]["out_max_ulp"] for r in census["shadow"]),
                "max_abs_last_checks": max(r["report"]["out_max_abs"] for r in census["shadow"]),
                "budget_max_ulp": telemetry.budget_for_dtype("bfloat16").max_ulp},
            "scrape": scrape, "traces": traces, "mem_pressure_dump": mem_pressure,
            "serving_pool": pool, "prefix_and_guard": prefix_guard, "plan_solver": solver,
            "engine_fault": fault, "tiered_fault": tiers, "required_series": required,
            "builds": {lab: st for lab, st in compiles.items()},
            "counters": {k: v for k, v in snap["counters"].items()
                         if k.startswith(("magi_guard", "magi_flight", "magi_trace",
                                          "magi_tier_faults", "magi_prefix"))},
            "summary": summary.splitlines(), "launches": launches,
            "wall_s": time.perf_counter() - t0}


# -- the device side of telemetry: roofline, occupancy, timeline, census, cp counters ----

PROF_REPS = 7  # timed reps of the roofline's measurement (warm-up 1, the median kept)
PROF_ROOFLINE_TOL = 0.10  # the roofline's fraction against the kernels phase's own time
PROF_CENSUS_PAIRS = 15  # off / census decode calls in turns for the census's cost
PROF_MASS_DEV = 1e-5  # a clean merge's softmax-mass deviation, f32 partials
PROF_PLANT = "finite:8.0"


def prof_census_decode(engine, slots, gen) -> dict:
    """The census on one decode batch of the serving pool (8 sequences at
    Llama-3.1-8B widths, one split): ``MAGI_ATTENTION_NUMERICS`` off and
    census ``torch.equal``; the census's values equal a plain torch
    recomputation from the same kernel partials; the merge's mass deviation
    under PROF_MASS_DEV; a ``finite:8.0`` plant at split 0 moves its out
    max-abs to 8.0 (a real lse may exceed 8.0); the census's cost a call:
    the reductions' device ms (CUDA events, the stream held) and the
    synchronised host ms, census less off, in turns (paired medians). Then
    one shadow-checked decode step (the ``magi_numerics_shadow_*`` series).
    Telemetry is on, into a registry of its own."""
    import statistics

    import torch
    from magiattention_tpu_torch import telemetry
    from magiattention_tpu_torch.ops.correction import merge_partials
    from magiattention_tpu_torch.serving import decode_attn as da
    from magiattention_tpu_torch.telemetry.roofline import device_ms

    idx = torch.as_tensor(slots, device="cuda")
    q = torch.randn((len(slots), HQ, D), generator=gen, device="cuda").to(torch.bfloat16)
    launches = {}

    def step():
        return da.decode_attn_paged(q, engine.cache, idx)

    telemetry.set_enabled(True)
    telemetry.reset_numerics_census()
    with telemetry.scoped_registry():
        try:
            with magi_flags(NUMERICS="off"):
                off = counted(launches, step)
            with magi_flags(NUMERICS="census"):
                on = counted(launches, step)
            check(torch.equal(on[0], off[0]) and torch.equal(on[1], off[1]),
                  "profiling census decode: census on differs from off")
            got = telemetry.get_numerics_census().numerics_snapshot()["census"]["decode"]
            # the plain recomputation from the same partials (one split: the
            # census takes the lse as its max-logit proxy, as JAX's does)
            b = len(slots)
            params = da.DecodeParams(scale=1.0 / math.sqrt(D), softcap=0.0,
                                     num_splits=da.resolve_num_splits(None, engine.cache, b, HQ),
                                     out_dtype=q.dtype)
            cache = engine.cache
            out_p, lse_p = uncounted(lambda: da._decode_partials_kernel(
                q, cache, cache.block_tables[idx], cache.seq_lens[idx], params))
            outs = [out_p[:, i] for i in range(params.num_splits)]
            lses = [lse_p[:, i] for i in range(params.num_splits)]
            merged = merge_partials(outs, lses)[1]
            want = {}
            for i, (o, l) in enumerate(zip(outs, lses)):
                finite = l[l > float("-inf")]
                want[f"split{i}"] = {"logit_max": float(l.max()),
                                     "lse_min": float(finite.min()), "lse_max": float(l.max()),
                                     "out_max_abs": float(o.abs().max())}
            mass = sum(torch.exp(l - merged) for l in lses)
            want["final"] = {"mass_dev": float((mass - 1.0).abs().max())}
            check(set(got) == set(want), f"profiling census decode: sites {got}, want {want}")
            err = max(abs(got[s][k] - v) for s, st in want.items() for k, v in st.items())
            check(err <= 1e-6, f"profiling census decode: {got} against the plain recomputation "
                  f"{want}")
            check(got["final"]["mass_dev"] < PROF_MASS_DEV,
                  f"profiling census decode: mass deviation {got['final']['mass_dev']}")
            with magi_flags(NUMERICS="census",
                            CHAOS=f"corrupt_partial:site=split0,value={PROF_PLANT},seed=3"):
                counted(launches, step)
            planted = telemetry.get_numerics_census().numerics_snapshot()["census"]["decode"]
            check(planted["split0"]["out_max_abs"] == 8.0 and got["split0"]["out_max_abs"] < 8.0,
                  f"profiling census decode: the {PROF_PLANT} plant moved split0 to "
                  f"{planted['split0']} from {got['split0']}")
            # the cost: the reductions alone on the device, and whole calls in turns
            with magi_flags(NUMERICS="census"):
                dev_ms = uncounted(lambda: device_ms(
                    lambda: da._split_census(outs, lses, merged), reps=PROF_REPS, warmup=2,
                    cuda=True))
            host = {"off": [], "census": []}
            for _ in range(PROF_CENSUS_PAIRS + 2):
                for mode in ("off", "census"):
                    with magi_flags(NUMERICS=mode):
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        counted(launches, step)
                        torch.cuda.synchronize()
                        host[mode].append((time.perf_counter() - t0) * 1e3)
            pairs = [c - o for o, c in zip(host["off"][2:], host["census"][2:])]  # 2 warm-up pairs
            with magi_flags(NUMERICS="census", SHADOW_SAMPLE_RATE="1"):
                k, v = (torch.randn((b, HK, D), generator=gen, device="cuda").to(torch.bfloat16)
                        for _ in range(2))
                counted(launches, lambda: engine.decode_step(q, k, v, slots))
            names = {s.split("{")[0] for kind in ("counters", "gauges", "histograms")
                     for s in telemetry.snapshot()[kind]}
        finally:
            telemetry.set_enabled(None)
        return {"batch": b, "splits": params.num_splits, "census": got, "planted_split0":
                planted["split0"], "plain_recomputation_max_abs_diff": err,
                "added_device_ms_reductions": dev_ms,
                "host_ms_off_median": statistics.median(host["off"][2:]),
                "host_ms_census_median": statistics.median(host["census"][2:]),
                "added_host_ms_paired_median": statistics.median(pairs),
                "added_host_ms_paired_range": [min(pairs), max(pairs)],
                "series": sorted(names), "launches": launches}


@in_rank
def prof_cp_rank(group, seed: int, t: int = CP_ATTN_T, heads=(TRAIN_HQ, TRAIN_HK), head_dim=D,
                 chunk=CP_CHUNK, device="cuda") -> dict:
    """One rank of the profiling phase's cp part, at cp=2 on the card: the
    measured timeline (``api.profile_attn_timeline``) of the ``cp_attn``
    phase's key (the hetero mask, 16 / 8 heads, degree 0) and of the same
    mask at degree 1; then on the degree-1 key the forward under census off,
    on, and on with a ``finite:8.0`` plant at the host stage. Returns the
    timelines, the census values, whether off and on are ``torch.equal``,
    the series recorded and the launches. ``device="cpu"`` rehearses it on
    the CPU (float32; give a small ``t``)."""
    import torch
    import torch.distributed as dist
    from magiattention_tpu_torch import api, csrc, telemetry
    from magiattention_tpu_torch.config import DistAttnConfig
    from magiattention_tpu_torch.meta.solver.overlap_solver import OverlapConfig
    from magiattention_tpu_torch.testing.workloads import split_slices, varlen_block_causal

    if device == "cuda":
        cp_rank_setup()
    qr, kr, ty = split_slices(varlen_block_causal(t))
    hq, hk = heads
    dtype = torch.bfloat16 if device == "cuda" else torch.float32
    gen = torch.Generator(device=device).manual_seed(seed)
    q, k, v = (torch.randn((t, h, head_dim), generator=gen, device=device, dtype=dtype)
               for h in (hq, hk, hk))
    telemetry.set_enabled(True)
    telemetry.reset()
    telemetry.reset_numerics_census()
    csrc.reset_launch_counts()
    res = {"rank": dist.get_rank(group), "timelines": {}, "census": {}}
    try:
        keys = {d: api.magi_attn_flex_key(
            qr, kr, ty, t, t, group, num_heads=(hq, hk), head_dim=head_dim, chunk_size=chunk,
            out_dtype=dtype, device=device,
            dist_attn_config=DistAttnConfig(overlap_config=OverlapConfig(degree=d)))
            for d in (0, 1)}
        for d, key in keys.items():
            plan = api.get_runtime_mgr(key).plan
            tl = api.profile_attn_timeline(key)
            res["timelines"][d] = {
                **dataclasses.asdict(tl), "report": tl.report(),
                "plan_pieces": 1 if plan.overlap_degree == 0 else 1 + len(plan.stages),
                "plan_degree": plan.overlap_degree}
        key = keys[1]
        outs = {}
        for run, flags in (("off", dict(NUMERICS="off")), ("census", dict(NUMERICS="census")),
                           ("planted", dict(NUMERICS="census", CHAOS="corrupt_partial:site=host,"
                                            f"value={PROF_PLANT},seed=3"))):
            with magi_flags(**flags):
                out_l, meta = api.calc_attn(api.dispatch(q, key), api.dispatch(k, key),
                                            api.dispatch(v, key), key)
                outs[run] = (api.undispatch(out_l, key), api.undispatch(meta.lse, key))
                res["census"][run] = telemetry.get_numerics_census().numerics_snapshot()[
                    "census"].get("parallel", {})
        res["census_equal_off"] = all(torch.equal(a, b)
                                      for a, b in zip(outs["off"], outs["census"]))
        snap = telemetry.snapshot()
        res["series"] = sorted({s.split("{")[0] for kind in ("counters", "gauges", "histograms")
                                for s in snap[kind]})
        res["launches"] = {n: c for n, c in csrc.launches.items() if c}
        return res
    finally:
        telemetry.set_enabled(None)
        telemetry.reset()
        api.clear_cache()


def prof_cp(pools, seed: int) -> list:
    return pools[2].run(prof_cp_rank, seed)


def prof_roofline() -> tuple[list, dict, set]:
    """``telemetry.profile_roofline`` (measured on the card) on the serving
    path's causal 4096 prefill (32 / 8, d 128, bf16) at the automatic choice
    (``flex_fwd_hb``, head_block G) and at head_block 1 (``flex_fwd``), and on
    the hetero mask at 8 / 8 (the sparse grid, ``flex_fwd_sparse``). Returns
    the lines, the launches and the series recorded."""
    from magiattention_tpu_torch import csrc, telemetry
    from magiattention_tpu_torch.testing.workloads import split_slices, varlen_block_causal

    causal = ([(0, 4096)], [(0, 4096)], [1])
    cases = (
        ("serving_prefill", "flex_fwd_hb", causal, HQ, HK, {}),
        ("serving_prefill_hb1", "flex_fwd", causal, HQ, HK,
         dict(block_q=64, block_k=64, head_block=1, grid="row_major")),
        ("hetero_8x8", "flex_fwd_sparse", split_slices(varlen_block_causal(HETERO_T)), 8, 8, {}),
    )
    lines, launches = [], {}
    telemetry.set_enabled(True)
    telemetry.reset()
    try:
        for name, kernel, (qr, kr, ts), hq, hk, pins in cases:
            rep = counted(launches, lambda: telemetry.profile_roofline(
                qr, kr, ts, num_heads_q=hq, num_heads_kv=hk, head_dim=D, measure=True,
                reps=PROF_REPS, workload=name, **pins))
            lines.append({"workload": name, "kernel": kernel, "heads": [hq, hk],
                          "rung": f"{rep.block_q}x{rep.block_k}x{rep.head_block}",
                          "grid": rep.grid, "card": rep.card, "peak_tflops": rep.peak_tflops,
                          "measured_ms": rep.measured_ms, "achieved_tflops": rep.measured_tflops,
                          "fraction_of_peak": rep.efficiency, "mask_density": rep.mask_density,
                          "overcompute_ratio": rep.overcompute_ratio,
                          "gap_fractions": rep.gap_fractions(),
                          "dominant_waste": rep.dominant_waste, "mask_flops": rep.mask_flops})
        names = {s.split("{")[0] for s in telemetry.snapshot()["gauges"]}
    finally:
        telemetry.set_enabled(None)
    return lines, launches, names


def prof_occupancy() -> dict:
    """The hetero mask's block-occupancy map at the kernel's tile, against
    the plan the sparse grid launched with in the ``hetero`` phase (the
    same cached plan ``flex_flash_attn_func`` built): its enumeration must
    be the plan's live (q block, k block) tiles, one for one."""
    import numpy as np
    from magiattention_tpu_torch import telemetry
    from magiattention_tpu_torch.ops import flex_attn as fa
    from magiattention_tpu_torch.testing.workloads import split_slices, varlen_block_causal

    qr, kr, ts = split_slices(varlen_block_causal(HETERO_T))
    bq, bk = fa.resolve_tile(D, None, None)
    q_arr, k_arr, t_arr = (np.ascontiguousarray(np.asarray(a, dtype=np.int64))
                           for a in (qr, kr, ts))
    meta = fa._cached_meta(q_arr.reshape(-1, 2).tobytes(), k_arr.reshape(-1, 2).tobytes(),
                           t_arr.tobytes(), len(ts), HETERO_T, HETERO_T, bq, bk)
    occ = telemetry.block_occupancy_map(qr, kr, ts, bq, bk)
    enum = occ.to_enumeration()
    live = meta.fwd_slice_id < meta.num_slices
    planned = set(zip(meta.fwd_q_block[live].tolist(), meta.fwd_k_block[live].tolist()))
    mapped = set(zip(enum.major.tolist(), enum.minor.tolist()))
    check(mapped == planned and len(enum.major) == occ.active_blocks_total,
          f"profiling occupancy: the map's {len(mapped)} tiles are not the launched plan's "
          f"{len(planned)} (missing {len(planned - mapped)}, extra {len(mapped - planned)})")
    return {"tile": [bq, bk], "tiles": len(mapped), "plan_entries": int(meta.num_fwd_entries),
            "dead_q_blocks": occ.dead_q_blocks, "block_density": occ.block_density,
            "density_histogram": occ.density_histogram()}


def prof_counters(reuse_line: dict) -> dict:
    """The ``cp_plan_reuse`` stream's plan-cache counters (its telemetry-on
    pass, which must resolve the timed pass's tiers) against the tiers the
    phase resolved (the JAX package's):
    a hit per exact or bucket tier, a miss per cold one; a bucket hit per
    bucket tier, a bucket miss per cold bucketed one; a patch per patched
    hit and a rebuild per other bucket hit; no eviction (the caches hold the
    stream)."""
    reqs = reuse_line["requests"]
    tiers = [r["tier"] for r in reqs]
    bucket = tiers.count("bucket")
    patched = sum(bool(r["patched"]) for r in reqs)
    want = {"magi_plan_cache_hits": bucket + tiers.count("exact"),
            "magi_plan_cache_misses": tiers.count("cold"),
            "magi_runtime_cache_hits_total": bucket + tiers.count("exact"),
            "magi_runtime_cache_misses_total": tiers.count("cold"),
            "magi_plan_bucket_hits_total": bucket,
            "magi_plan_bucket_misses_total": sum(r["tier"] == "cold" and r["bucketed"]
                                                 for r in reqs),
            "magi_plan_incremental_patches_total": patched,
            "magi_plan_incremental_fallbacks_total": bucket - patched}
    got = {}
    for r in reuse_line["stream_telemetry"]:
        check(r["tiers"] == tiers, f"profiling counters: rank {r['rank']}'s telemetry pass "
              f"resolved {r['tiers']}, the timed pass {tiers}")
        c = {k: v for k, v in r["counters"].items() if k.split("{")[0] in want
             or k.startswith("magi_plan_cache_evictions_total")}
        check({k: c.get(k, 0) for k in want} == want
              and not any(k.startswith("magi_plan_cache_evictions_total") for k in c),
              f"profiling counters: rank {r['rank']} counted {c}, the tiers {tiers} give {want}")
        got[r["rank"]] = c
    return {"tiers": tiers, "expected": want, "counters_per_rank": got}


def profiling_phase(parts: dict, reuse_line: dict, times: dict, t0: float) -> dict:
    """The device side of telemetry on the card: the roofline against the
    kernels phase's own times (within PROF_ROOFLINE_TOL, at most 1.05 of
    peak), the occupancy map against the launched sparse plan, the cp
    timelines (one piece per plan piece), the census (off / on equal, the
    plant moving the census), the cp counters against the tiers, and every
    series of the plan, plan-cache, timeline, roofline and numerics
    catalogs recorded."""
    from magiattention_tpu_torch import telemetry

    card = nvidia_smi_line()
    roof, roof_launches, roof_series = prof_roofline()
    for line in roof:
        ms = times[line["kernel"]]["ms"]
        expected = line["mask_flops"] / (ms * 1e-3) / (line["peak_tflops"] * 1e12)
        line.update(kernels_phase_ms=ms, kernels_phase_fraction=expected)
        check(line["fraction_of_peak"] <= 1.05,
              f"profiling roofline {line['workload']}: {line['fraction_of_peak']} of peak")
        check(abs(line["fraction_of_peak"] / expected - 1.0) <= PROF_ROOFLINE_TOL,
              f"profiling roofline {line['workload']}: {line['fraction_of_peak']:.4f} of peak "
              f"against the kernels phase's {expected:.4f} ({line['kernel']} {ms} ms)")
        print(f"profiling roofline {line['workload']} [{line['kernel']}, {line['rung']} "
              f"{line['grid']}] on {card}: {line['fraction_of_peak']:.4f} of "
              f"{line['peak_tflops']:g} TF/s (kernels phase {expected:.4f}); gap "
              + ", ".join(f"{k} {v:.3f}" for k, v in line["gap_fractions"].items()), flush=True)
    occupancy = prof_occupancy()
    timelines, census_cp, rank_series = [], [], set()
    launches = dict(roof_launches)
    for n, c in parts["census_decode"]["launches"].items():
        launches[n] = launches.get(n, 0) + c
    for r in parts["cp"]:
        rank_series |= set(r["series"])
        for n, c in r["launches"].items():
            launches[n] = launches.get(n, 0) + c
        for d, tl in r["timelines"].items():
            check(len(tl["stages"]) == tl["plan_pieces"],
                  f"profiling timeline rank {r['rank']} degree {d}: {len(tl['stages'])} stages, "
                  f"the plan has {tl['plan_pieces']}")
        c = r["census"]
        check(r["census_equal_off"], f"profiling census cp rank {r['rank']}: on differs from off")
        check(set(c["census"]) == {"host", "stage0", "final"}
              and c["census"]["final"]["mass_dev"] < PROF_MASS_DEV,
              f"profiling census cp rank {r['rank']}: {c['census']}")
        check(c["planted"]["host"]["out_max_abs"] == 8.0
              and c["census"]["host"]["out_max_abs"] < 8.0,
              f"profiling census cp rank {r['rank']}: the plant moved the host site to "
              f"{c['planted']['host']} from {c['census']['host']}")
        census_cp.append({"rank": r["rank"], "census": c["census"],
                          "planted_host": c["planted"]["host"]})
    for d, tl in parts["cp"][0]["timelines"].items():
        timelines.append({k: tl[k] for k in ("plan_degree", "plan_pieces", "stages", "hops",
                                              "measured_total_ms", "serial_total_ms",
                                              "hideable_comm_ms", "overlap_efficiency",
                                              "predicted_total_ms", "prediction_error_ratio")})
        print(f"profiling timeline cp=2 degree {tl['plan_degree']} on {card} (the ranks share one "
              f"card: no cp speed): {len(tl['stages'])} stages, "
              + "; ".join(f"{s['stage']} cast {s['comm_ms']:.3f} ms kernel {s['calc_ms']:.3f} ms"
                          for s in tl["stages"])
              + f"; serial {tl['serial_total_ms']:.3f} ms, pipelined "
              f"{tl['measured_total_ms']:.3f} ms, measured/predicted "
              f"{tl['prediction_error_ratio']:.2f}x", flush=True)
    dec = parts["census_decode"]
    print(f"profiling census decode on {card}: +{dec['added_device_ms_reductions']:.4f} device ms "
          f"(the reductions), +{dec['added_host_ms_paired_median']:.4f} host ms a call (paired "
          f"median of {PROF_CENSUS_PAIRS})", flush=True)
    counters = prof_counters(reuse_line)
    series = roof_series | rank_series | set(dec["series"])
    for r in reuse_line["stream_telemetry"]:
        series |= set(r["names"])
    required = (set(telemetry.REQUIRED_PLAN_METRICS) | set(telemetry.REQUIRED_PLAN_CACHE_METRICS)
                | set(telemetry.REQUIRED_TIMELINE_METRICS)
                | set(telemetry.REQUIRED_ROOFLINE_METRICS)
                | set(telemetry.REQUIRED_NUMERICS_METRICS))
    check(required <= series, f"profiling: series never recorded: {sorted(required - series)}")
    return {"phase": "profiling", "card": card, "roofline": roof, "occupancy": occupancy,
            "timeline_cp2": timelines,
            "note": "the cp ranks share one card over gloo: timelines are no cp speed",
            "census_decode": {k: v for k, v in dec.items() if k not in ("series", "launches")},
            "census_cp2": census_cp, "cp_counters": counters,
            "required_series": len(required), "launches": launches,
            "seconds": time.perf_counter() - t0}


# -- tuning: the autotuner on the card ---------------------------------------------

TUNE_WINDOW = 512  # the narrow-band workload: a sliding window of 512 keys on 8192 tokens
TUNE_REPS = 20  # timed forwards a candidate in the fit
TUNE_SPLIT_CALLS = 1000  # repeat split-tuner calls timed on the host
TUNE_CHOICE_CALLS = 200  # repeat kernel choices timed on the host
TUNE_MEASURED = ("prefill_4096_32x8", "hetero_16x8", "hetero_8x8")  # run under measure


def tune_shapes():
    """(name, q_ranges, k_ranges, types, hq, hk) of the fit's workloads: the
    serving prefill at 32 / 8 and 32 / 32, causal 8192 and the hetero mask
    at the training widths, the hetero mask at 8 / 8, and a narrow band."""
    from magiattention_tpu_torch.api.functools import infer_attn_mask_from_sliding_window
    from magiattention_tpu_torch.testing.workloads import split_slices, varlen_block_causal

    def causal(t):
        return [(0, t)], [(0, t)], [1]

    wq, wk, wt = infer_attn_mask_from_sliding_window(8192, TUNE_WINDOW)
    window = (wq.to_naive_ranges(), wk.to_naive_ranges(), [int(x) for x in wt])
    hetero = split_slices(varlen_block_causal(HETERO_T))
    return (("prefill_4096_32x8", *causal(4096), HQ, HK),
            ("prefill_4096_32x32", *causal(4096), HQ, HQ),
            ("causal_8192_16x8", *causal(8192), TRAIN_HQ, TRAIN_HK),
            ("hetero_16x8", *hetero, TRAIN_HQ, TRAIN_HK),
            ("hetero_8x8", *hetero, 8, 8),
            (f"window_{TUNE_WINDOW}_8192_16x8", *window, TRAIN_HQ, TRAIN_HK))


def fwd_kernel_name(head_block: int, grid: str) -> str:
    """The forward kernel a (head_block, grid) candidate launches."""
    if grid == "sparse":
        return "flex_fwd_sparse_hb" if head_block > 1 else "flex_fwd_sparse"
    return "flex_fwd_hb" if head_block > 1 else "flex_fwd"


def tune_samples(gen) -> list:
    """Every candidate of the cost model on each fit workload, timed alone
    (the forward kernel on head-major operands, CUDA events, the stream
    held), with the counts the model prices it by. Not main-path launches."""
    import torch
    from magiattention_tpu_torch.ops import flex_attn as fa
    from magiattention_tpu_torch.tuning import cost_model as cm

    samples = []
    for name, qr, kr, ty, hq, hk in tune_shapes():
        t = max(e for _, e in qr)
        p = Flex(gen, t, t, hq, hk, qr, kr, ty)
        for c in cm.rank_candidates(qr, kr, ty, hq, hk, head_dim=D):
            check(c.feasible, f"tuning {name}: candidate {c.kernel_config} is not feasible")
            params = dataclasses.replace(p.params, head_block=c.head_block, grid=c.grid)
            work = (fa.sparse_work(p.meta, "cuda:0", hq, hk, c.head_block)
                    if c.grid == "sparse" else None)

            def fwd(params=params, work=work):
                with torch.no_grad():
                    return fa.flex_attn_headmajor(p.q, p.k, p.v, p.tables, p.btables, params,
                                                  work=work)

            ms = uncounted(lambda: cuda_ms(fwd, reps=TUNE_REPS))
            samples.append({
                "shape": name, "kernel": fwd_kernel_name(c.head_block, c.grid),
                "head_block": c.head_block, "grid": c.grid, "ms": ms, "entries": c.entries,
                "mma_at_peak_s": 4.0 * D * hq * c.entries * c.block_q * c.block_k
                / PEAK_BF16_FLOPS,
                "live": c.live_slots, "dead": c.dead_slots})
        del p
        torch.cuda.empty_cache()
    return samples


def tune_fit(samples) -> dict:
    """Efficiency and the three slot fees by non-negative least squares on
    the relative residuals (each sample's time weighs as much as any
    other's): t = mma_at_peak / eff + live * LIVE + dead * DEAD (row-major)
    or live * SPARSE (sparse)."""
    import numpy as np
    from scipy.optimize import nnls

    a = np.array([[s["mma_at_peak_s"],
                   s["live"] if s["grid"] == "row_major" else 0.0,
                   s["dead"] if s["grid"] == "row_major" else 0.0,
                   s["live"] if s["grid"] == "sparse" else 0.0] for s in samples], dtype=np.float64)
    t = np.array([s["ms"] * 1e-3 for s in samples])
    aw = a / t[:, None]
    scale = aw.max(axis=0)
    scale[scale == 0] = 1.0
    x, _ = nnls(aw / scale, np.ones_like(t))
    x = x / scale
    check(x[0] > 0, f"tuning fit: no tensor-core term ({x})")
    pred = a @ x
    for s, pr in zip(samples, pred):
        s["predicted_ms"] = float(pr) * 1e3
        s["predicted_over_measured"] = float(pr) * 1e3 / s["ms"]
    ratios = [s["predicted_over_measured"] for s in samples]
    return {"mma_efficiency": float(1.0 / x[0]), "live_slot_s": float(x[1]),
            "dead_slot_s": float(x[2]), "sparse_slot_s": float(x[3]),
            "ratio_min": min(ratios), "ratio_max": max(ratios),
            "rms_relative_residual": float(np.sqrt(np.mean((np.array(ratios) - 1.0) ** 2)))}


@contextlib.contextmanager
def cost_constants(fit: dict):
    """The cost model priced with ``fit``'s efficiency and fees."""
    from magiattention_tpu_torch.tuning import cost_model as cm

    names = {"MMA_EFFICIENCY": fit["mma_efficiency"], "LIVE_SLOT_S": fit["live_slot_s"],
             "DEAD_SLOT_S": fit["dead_slot_s"], "SPARSE_SLOT_S": fit["sparse_slot_s"]}
    saved = {n: getattr(cm, n) for n in names}
    for n, v in names.items():
        setattr(cm, n, v)
    try:
        yield
    finally:
        for n, v in saved.items():
            setattr(cm, n, v)


def tune_model_picks(samples, fit) -> list:
    """Each workload's top pick under the model with this run's fit (and
    with the committed constants) against the candidate measured fastest;
    a disagreement is reported with both times."""
    from magiattention_tpu_torch.tuning import cost_model as cm

    out = []
    for name, qr, kr, ty, hq, hk in tune_shapes():
        mine = {(s["head_block"], s["grid"]): s for s in samples if s["shape"] == name}
        fastest = min(mine.values(), key=lambda s: s["ms"])
        with cost_constants(fit):
            pick = cm.rank_candidates(qr, kr, ty, hq, hk, head_dim=D)[0]
        committed = cm.rank_candidates(qr, kr, ty, hq, hk, head_dim=D)[0]
        got = mine[pick.head_block, pick.grid]
        line = {"shape": name, "model_pick": got["kernel"], "model_head_block": got["head_block"],
                "model_pick_ms": got["ms"], "fastest": fastest["kernel"],
                "fastest_head_block": fastest["head_block"], "fastest_ms": fastest["ms"],
                "agree": got is fastest, "pick_over_fastest": got["ms"] / fastest["ms"],
                "committed_pick": fwd_kernel_name(committed.head_block, committed.grid),
                "committed_head_block": committed.head_block}
        if not line["agree"]:
            print(f"tuning model pick {name}: {got['kernel']} (head_block {got['head_block']}) "
                  f"{got['ms']:.4f} ms, the fastest {fastest['kernel']} (head_block "
                  f"{fastest['head_block']}) {fastest['ms']:.4f} ms", flush=True)
        out.append(line)
    return out


def tune_merge_fee(dec_t) -> dict:
    """The merge round's device ms from the decode_timing split sweeps: the
    kernel with ``merge_partials`` less the kernel alone at each split count
    s above one, less the same difference at one split (no merge), over the
    s - 1 pairwise merges; the median over both sweeps."""
    fees = []
    for sweep in (dec_t["split_sweep"], dec_t["split_sweep_one_sequence"]["sweep"]):
        base = sweep[1]["kernel_and_merge"]["ms"] - sweep[1]["kernel_ms"]
        fees += [(r["kernel_and_merge"]["ms"] - r["kernel_ms"] - base) / (s - 1)
                 for s, r in sweep.items() if s > 1]
    fees.sort()
    return {"merge_round_s": fees[len(fees) // 2] * 1e-3, "samples_ms": fees}


def tune_splits_serving(engine, slots) -> dict:
    """The split tuner on the serving batch and on the decode_timing
    phase's 32K-token sequence (each must give one split), and the host
    cost of a memoised repeat call: ``select_decode_splits`` and the
    engine's ``resolve_num_splits`` path, TUNE_SPLIT_CALLS calls each."""
    from magiattention_tpu_torch import tuning
    from magiattention_tpu_torch.serving import decode_attn as da

    cache, b = engine.cache, len(slots)
    kw = dict(head_dim=D, dtype=cache.k_pages.dtype, device=cache.k_pages.device)
    got = {}
    for name, (batch, mpp) in {"serving_batch": (b, cache.max_pages_per_seq),
                               "one_sequence_32k": (1, 256)}.items():
        dec = tuning.select_decode_splits(batch, mpp, PAGE, HQ, HK, **kw)
        check(dec.head_block == 1, f"tuning splits {name}: {dec.head_block} splits ({dec.reason})")
        got[name] = {"batch": batch, "max_pages_per_seq": mpp, "splits": dec.head_block,
                     "predicted_ms": dec.predicted_ms, "reason": dec.reason}
    mpp = cache.max_pages_per_seq
    t0 = time.perf_counter()
    for _ in range(TUNE_SPLIT_CALLS):
        tuning.select_decode_splits(b, mpp, PAGE, HQ, HK, **kw)
    tuner_us = (time.perf_counter() - t0) * 1e6 / TUNE_SPLIT_CALLS
    t0 = time.perf_counter()
    for _ in range(TUNE_SPLIT_CALLS):
        da.resolve_num_splits(None, cache, b, HQ)
    resolve_us = (time.perf_counter() - t0) * 1e6 / TUNE_SPLIT_CALLS
    return {"decode": got, "memoised_select_decode_splits_host_us": tuner_us,
            "memoised_resolve_num_splits_host_us": resolve_us}


def counter_total(snap, name: str, **labels) -> float:
    """A counter's value summed over its series whose labels include
    ``labels``."""
    want = [f"{k}={v}" for k, v in labels.items()]
    return sum(v for key, v in snap["counters"].items()
               if key.split("{")[0] == name and all(w in key for w in want))


def tune_measure(gen) -> tuple[list, dict]:
    """``flex_flash_attn_func`` with its default arguments under
    ``MAGI_ATTENTION_AUTOTUNE=measure`` on the serving prefill and the
    hetero mask at 16 / 8 and 8 / 8, a fresh temp
    ``MAGI_ATTENTION_AUTOTUNE_CACHE_DIR``: the measured winner against the
    plain version (the kernels phase's tolerances), then the process cache
    dropped and the call again, which must take the winner from disk and
    give the same bits; no candidate may fail. Returns the lines and the
    launches (the tuner's timed candidates included: they are the path's)."""
    import tempfile

    import torch
    from magiattention_tpu_torch import telemetry, tuning
    from magiattention_tpu_torch.ops import flex_attn as fa

    lines, launches = [], {}
    cache_dir = tempfile.mkdtemp(prefix="chip_smoke_tuning_")
    telemetry.set_enabled(True)
    telemetry.reset()
    try:
        with magi_flags(AUTOTUNE="measure", AUTOTUNE_CACHE_DIR=cache_dir):
            tuning.reset_tuning_cache()
            for name, qr, kr, ty, hq, hk in tune_shapes():
                if name not in TUNE_MEASURED:
                    continue
                t = max(e for _, e in qr)
                p = Flex(gen, t, t, hq, hk, qr, kr, ty)
                q, k, v = (x[:, :t].transpose(0, 1).contiguous() for x in (p.q, p.k, p.v))

                def call():
                    with torch.no_grad():
                        return fa.flex_flash_attn_func(q, k, v, qr, kr, ty)

                out, lse = counted(launches, call)
                dec = tuning.select_block_config(qr, kr, ty, hq, hk, head_dim=D,
                                                 dtype=str(q.dtype), device=q.device)
                check(dec.source == "measured",
                      f"tuning measure {name}: the winner is {dec.source} ({dec.reason})")
                kernel = fwd_kernel_name(dec.head_block, dec.grid)
                ref_out, ref_lse, _ = p.sparse_plain()
                compare(kernel, f"tuning_measure_{name}", out.transpose(0, 1), ref_out[:, :t],
                        lse.transpose(0, 1), ref_lse[:, :t])
                tuning.reset_tuning_cache()
                disk = counter_total(telemetry.snapshot(), "magi_autotune_cache_hits_total",
                                     layer="disk")
                out2, lse2 = counted(launches, call)
                check(counter_total(telemetry.snapshot(), "magi_autotune_cache_hits_total",
                                    layer="disk") == disk + 1,
                      f"tuning measure {name}: the winner did not come back from disk")
                check(torch.equal(out2, out) and torch.equal(lse2, lse),
                      f"tuning measure {name}: the disk winner gave other bits")
                lines.append({"shape": name, "heads": [hq, hk], "winner": kernel,
                              "head_block": dec.head_block, "grid": dec.grid,
                              "measured_ms": dec.measured_ms, "predicted_ms": dec.predicted_ms,
                              "reason": dec.reason})
                del p, q, k, v, out, lse, out2, lse2
                torch.cuda.empty_cache()
            snap = telemetry.snapshot()
            failures = counter_total(snap, "magi_autotune_measure_failures_total")
            check(failures == 0, f"tuning measure: {failures} candidates failed")
            measured = counter_total(snap, "magi_autotune_measurements_total")
            files = sorted(os.listdir(cache_dir))
    finally:
        telemetry.set_enabled(None)
        tuning.reset_tuning_cache()
        shutil.rmtree(cache_dir, ignore_errors=True)
    return lines, {"launches": launches, "measurements": measured, "failures": failures,
                   "cache_files": len(files)}


def tune_roofline(prof_line: dict, fit: dict) -> list:
    """The profiling phase's three roofline workloads: the ``unattributed``
    share with the committed fees (the profiling phase's own report) and
    with this run's fit."""
    from magiattention_tpu_torch.telemetry import roofline
    from magiattention_tpu_torch.testing.workloads import split_slices, varlen_block_causal

    masks = {"serving_prefill": ([(0, 4096)], [(0, 4096)], [1]),
             "serving_prefill_hb1": ([(0, 4096)], [(0, 4096)], [1]),
             "hetero_8x8": split_slices(varlen_block_causal(HETERO_T))}
    fees = roofline.StepFees(fit["live_slot_s"], fit["dead_slot_s"],
                             fit["sparse_slot_s"] - fit["live_slot_s"])
    out = []
    for line in prof_line["roofline"]:
        qr, kr, ts = masks[line["workload"]]
        bq, bk, hb = (int(x) for x in line["rung"].split("x"))
        hq, hk = line["heads"]
        rep = roofline.analyze_workload(
            qr, kr, ts, num_heads_q=hq, num_heads_kv=hk, head_dim=D, block_q=bq, block_k=bk,
            head_block=hb, grid=line["grid"], card=line["card"], fees=fees,
            measured_ms=line["measured_ms"], workload=line["workload"])
        out.append({"workload": line["workload"], "kernel": line["kernel"],
                    "unattributed_committed_fees": line["gap_fractions"]["unattributed"],
                    "unattributed_this_fit": rep.gap_fractions()["unattributed"],
                    "gap_this_fit": rep.gap_fractions()})
    return out


def tuning_phase(gen, dec_t: dict, serving_splits: dict, sched_line: dict, prof_line: dict,
                 t0: float) -> dict:
    """The autotuner on the card: (a) the cost model's efficiency and slot
    fees fitted on every candidate of six workloads and the merge round's
    fee from the decode split sweeps, each sample's predicted / measured
    ratio; (b) the model's top pick against the candidate measured fastest;
    (c) measure mode end to end (no failure, the disk round trip, the plain
    version); (d) the split tuners at one split on every decode geometry the
    smoke ran (the serving batch, the 32K sequence, the scheduler's ticks)
    and the memoised call's host cost, and a repeat kernel choice's; (e) the
    roofline's unattributed share with the fees."""
    from magiattention_tpu_torch import tuning
    from magiattention_tpu_torch.ops import flex_attn as fa

    card = nvidia_smi_line()
    samples = tune_samples(gen)
    fit = tune_fit(samples)
    fit.update(tune_merge_fee(dec_t))
    print(f"tuning fit on {card}: mma_efficiency {fit['mma_efficiency']:.6f}, live_slot_s "
          f"{fit['live_slot_s']:.6e}, dead_slot_s {fit['dead_slot_s']:.6e}, sparse_slot_s "
          f"{fit['sparse_slot_s']:.6e}, merge_round_s {fit['merge_round_s']:.6e}", flush=True)
    for s in samples:
        print(f"tuning sample {s['shape']} {s['kernel']} head_block {s['head_block']}: "
              f"{s['ms']:.4f} ms measured, {s['predicted_ms']:.4f} predicted, ratio "
              f"{s['predicted_over_measured']:.4f}", flush=True)
    picks = tune_model_picks(samples, fit)
    measure_lines, measure = tune_measure(gen)
    ticks = []
    for label in sched_line["tick_programs"]:
        rows, entries, splits = (int(x.split("=")[1]) for x in label[5:-1].split(","))
        dec = tuning.select_tick_splits(rows, entries, PAGE, HQ, HK, head_dim=D,
                                        dtype="bfloat16", device="cuda")
        check(splits == 1 and dec.head_block == 1,
              f"tuning splits: the scheduler's {label} (the tuner now: {dec.head_block})")
        ticks.append(label)
    check(dec_t["splits"] == 1, f"tuning splits: the serving batch ran {dec_t['splits']} splits")
    choice_us = {}
    for name, qr, kr, ty, hq, hk in tune_shapes():
        if name in TUNE_MEASURED:  # a repeat kernel choice: the fingerprint memo, a memory hit
            fa.auto_kernel_config(qr, kr, hq, hk, attn_type_map=ty, head_dim=D, device="cuda")
            t1 = time.perf_counter()
            for _ in range(TUNE_CHOICE_CALLS):
                fa.auto_kernel_config(qr, kr, hq, hk, attn_type_map=ty, head_dim=D,
                                      device="cuda")
            choice_us[name] = (time.perf_counter() - t1) * 1e6 / TUNE_CHOICE_CALLS
    roof = tune_roofline(prof_line, fit)
    for r in roof:
        print(f"tuning roofline {r['workload']} [{r['kernel']}] on {card}: unattributed "
              f"{r['unattributed_committed_fees']:.4f} with the committed fees, "
              f"{r['unattributed_this_fit']:.4f} with this fit", flush=True)
    return {"phase": "tuning", "card": card, "fit": fit, "samples": samples,
            "model_picks": picks, "model_pick_disagreements": sum(not p["agree"] for p in picks),
            "measure": measure_lines, "measurements": measure["measurements"],
            "measure_failures": measure["failures"], "cache_files": measure["cache_files"],
            "splits": {**serving_splits, "scheduler_ticks": ticks},
            "repeat_choice_host_us": choice_us,
            "roofline": roof, "launches": measure["launches"],
            "seconds": time.perf_counter() - t0}


ANALYSIS_MODES = ("off", "plan", "trace")
ANALYSIS_IMPLS = ("hops", "a2a")
ANALYSIS_DEGREE = 1  # one overlap stage: its cast is what the sanitizer and the census read
ANALYSIS_BUILDS = 3  # cold plan builds a (impl, mode), for the host ms median
ANALYSIS_HEADS = (TRAIN_HQ, TRAIN_HK)
# the interleaving checker's smoke matrix and plants: the JAX package's
# counts on the same models (states, transitions; counterexample events)
ANALYSIS_LIFECYCLE = {"0:engine": (62, 190), "1:scheduler": (48, 62), "2:tiered": (25, 26)}


def _analysis_fwd_bwd(key, q, k, v, g_out, g_lse, record: bool = False):
    """``dispatch`` -> ``calc_attn`` -> the backward of this rank's share of
    sum(out * g_out) + sum(lse * g_lse) over covered rows: this rank's
    (out, lse, dq, dk, dv) shards, and with ``record`` the comm layer's live
    records of the forward and of the backward."""
    import torch
    from magiattention_tpu_torch import api
    from magiattention_tpu_torch.comm.group_collective import record_collectives

    qd, kd, vd = (api.dispatch(x, key).detach().requires_grad_() for x in (q, k, v))
    go, gl = api.dispatch(g_out, key), api.dispatch(g_lse, key)
    rec = (lambda: record_collectives("live")) if record else (lambda: contextlib.nullcontext([]))
    with rec() as fwd:
        out, meta = api.calc_attn(qd, kd, vd, key)
    loss = (out.float() * go.float()).sum() + torch.where(
        torch.isfinite(meta.lse), meta.lse * gl, 0.0).sum()
    with rec() as bwd:
        loss.backward()
    return (out.detach(), meta.lse.detach(), qd.grad, kd.grad, vd.grad), list(fwd), list(bwd)


def _validate_counters() -> tuple[int, int]:
    from magiattention_tpu_torch import telemetry

    c = telemetry.snapshot()["counters"]
    return (int(sum(v for k, v in c.items() if k.startswith("magi_validate_plan_checks"))),
            int(sum(v for k, v in c.items() if k.startswith("magi_validate_failures"))))


@in_rank
def analysis_cp_rank(group, seed: int, hier=None) -> dict:
    """One rank of the path under validation: the hetero mask at the
    LlamaConfig widths through the keyed API at degree 1, under
    ``MAGI_ATTENTION_VALIDATE`` off, plan and trace (``hier``: the 2 x 2
    hierarchical groups, off and plan), hops and a2a (hier: the default
    impl). Each (impl, mode) builds its plan ``ANALYSIS_BUILDS`` times from a
    cleared cache (the builds' host ms), then runs the forward and backward
    once; every mode's shards must equal the off run's bit for bit. The
    trace runs record the comm layer live, gathered over the group: their
    census against the plan's expectation, uniform and well paired across
    ranks, and equal to this rank's dry records of the same plan."""
    import statistics

    import torch
    import torch.distributed as dist
    from magiattention_tpu_torch import api, csrc, env, telemetry
    from magiattention_tpu_torch.analysis import spmd_audit as sa
    from magiattention_tpu_torch.analysis import trace_audit as ta
    from magiattention_tpu_torch.api import interface
    from magiattention_tpu_torch.config import DistAttnConfig
    from magiattention_tpu_torch.meta.solver.overlap_solver import OverlapConfig
    from magiattention_tpu_torch.testing.workloads import split_slices, varlen_block_causal

    cp_rank_setup()
    rank, t = dist.get_rank(group), CP_ATTN_T
    hq, hk = ANALYSIS_HEADS
    qr, kr, ty = split_slices(varlen_block_causal(t))
    gen = torch.Generator(device="cuda").manual_seed(seed)  # the same inputs on every rank
    q, k, v, g_out = (torch.randn((t, h, D), generator=gen, device="cuda", dtype=torch.bfloat16)
                      for h in (hq, hk, hk, hq))
    g_lse = torch.randn((t, hq), generator=gen, device="cuda")
    cp_group = hier_cp_groups(group, hier) if hier else group
    config = DistAttnConfig(overlap_config=OverlapConfig(degree=ANALYSIS_DEGREE))
    impls, modes = (("auto",), ("off", "plan")) if hier else (ANALYSIS_IMPLS, ANALYSIS_MODES)
    real_build, times = interface.build_dist_attn_plan, []

    def timed_build(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return real_build(*args, **kwargs)
        finally:
            times.append((time.perf_counter() - t0) * 1e3)

    build_ms, bitwise, live, plans_checked = {}, {}, {}, 0
    telemetry.set_enabled(True)
    telemetry.reset()
    interface.build_dist_attn_plan = timed_build
    try:
        torch.cuda.synchronize()
        csrc.reset_launch_counts()
        for impl in impls:
            ref = None
            for mode in modes:
                with magi_flags(VALIDATE=mode, GROUP_COLL_IMPL=None if impl == "auto" else impl):
                    times.clear()
                    for _ in range(ANALYSIS_BUILDS):
                        api.clear_cache()
                        key = api.magi_attn_flex_key(qr, kr, ty, t, t, cp_group, num_heads=(hq, hk),
                                                     head_dim=D, chunk_size=CP_CHUNK,
                                                     dist_attn_config=config)
                    plans_checked += ANALYSIS_BUILDS if mode != "off" else 0
                    build_ms[f"{impl}/{mode}"] = statistics.median(times)
                    plan = api.get_runtime_mgr(key).plan
                    got, fwd, bwd = _analysis_fwd_bwd(key, q, k, v, g_out, g_lse,
                                                      record=mode == "trace")
                torch.cuda.synchronize()
                if ref is None:
                    ref = got
                else:
                    bitwise[f"{impl}/{mode}"] = all(torch.equal(a, b) for a, b in zip(got, ref))
                if mode == "trace":
                    payload = torch.float32 if env.is_backward_high_precision_reduce() \
                        else torch.bfloat16
                    mine = {"rank": rank, "fwd": fwd, "fwd_bwd": fwd + bwd,
                            "expected_fwd": ta.expected_plan_cast_collectives(plan),
                            "dry": ta.plan_cast_records(plan, rank, tail=(2, hk, D),
                                                        dtype=payload, device="cuda",
                                                        backward=True)}
                    every = [None] * dist.get_world_size(group)
                    dist.all_gather_object(every, mine, group=group)
                    res = [dict(r, fwd=[e["fwd"] for e in every],
                                fwd_bwd=[e["fwd_bwd"] for e in every]) for r in every]
                    errors, sig = sa.live_dist_attn_errors(f"cp=2 {impl}", res, impl)
                    live[impl] = {"errors": errors, "signature": sig,
                                  "census_fwd": ta.collective_census(fwd),
                                  "census_fwd_bwd": ta.collective_census(fwd + bwd),
                                  "expected_fwd": mine["expected_fwd"],
                                  "impls": [c.impl for c in plan.comms()]}
        torch.cuda.synchronize()
        launches = {n: csrc.launches[n] for n in FLEX_KERNELS if csrc.launches[n]}
    finally:
        interface.build_dist_attn_plan = real_build
        api.clear_cache()
    checks, failures = _validate_counters()
    telemetry.reset()
    telemetry.set_enabled(None)
    return {"rank": rank, "launches": launches, "plan_build_host_ms": build_ms,
            "bitwise_equal_to_off": bitwise, "live": live, "plans_checked": plans_checked,
            "validate_checks": checks, "validate_failures": failures,
            "overlap_degree": plan.overlap_degree}


@in_rank
def analysis_plant_rank(group, seed: int) -> dict:
    """The planted corruption: rank 0's plan of the cp=2 hetero key gets a
    stage ``recv_sel`` that is not a permutation (two slots read one source
    row). Under ``MAGI_ATTENTION_VALIDATE=plan`` the key raises
    ``PlanValidationError`` on that rank before any kernel launch, with one
    failure counted; the other rank's plan is clean. The outcomes are
    gathered before either rank goes on."""
    import numpy as np
    import torch.distributed as dist
    from magiattention_tpu_torch import api, csrc, telemetry
    from magiattention_tpu_torch.analysis import PlanValidationError
    from magiattention_tpu_torch.config import DistAttnConfig
    from magiattention_tpu_torch.meta.solver.overlap_solver import OverlapConfig
    from magiattention_tpu_torch.parallel import dist_attn
    from magiattention_tpu_torch.testing.workloads import split_slices, varlen_block_causal

    cp_rank_setup()
    rank, t = dist.get_rank(group), CP_ATTN_T
    qr, kr, ty = split_slices(varlen_block_causal(t))
    real = dist_attn._build_dist_attn_plan

    def corrupt(*args, **kwargs):
        plan = real(*args, **kwargs)
        if rank != 0:
            return plan
        comm = plan.stages[0].comm
        rs = np.array(comm.recv_sel, copy=True)
        d = next(i for i in range(comm.cp_size) if comm.recv_total[i] >= 2)
        rs[d, 1] = rs[d, 0]
        st0 = dataclasses.replace(plan.stages[0], comm=dataclasses.replace(comm, recv_sel=rs))
        return dataclasses.replace(plan, stages=(st0,) + plan.stages[1:])

    telemetry.set_enabled(True)
    telemetry.reset()
    raised = None
    dist_attn._build_dist_attn_plan = corrupt
    try:
        with magi_flags(VALIDATE="plan"):
            api.clear_cache()
            csrc.reset_launch_counts()
            try:
                api.magi_attn_flex_key(qr, kr, ty, t, t, group, num_heads=ANALYSIS_HEADS,
                                       head_dim=D, chunk_size=CP_CHUNK,
                                       dist_attn_config=DistAttnConfig(
                                           overlap_config=OverlapConfig(degree=ANALYSIS_DEGREE)))
            except PlanValidationError as e:
                raised = str(e)
            launched = sum(csrc.launches.values())
    finally:
        dist_attn._build_dist_attn_plan = real
        api.clear_cache()
    checks, failures = _validate_counters()
    telemetry.reset()
    telemetry.set_enabled(None)
    mine = {"rank": rank, "raised": raised, "launches": launched, "checks": checks,
            "failures": failures}
    every = [None] * dist.get_world_size(group)
    dist.all_gather_object(every, mine, group=group)
    return {"rank": rank, "every": every}


def analysis_decode_probe(seed: int) -> dict:
    """One real serving decode step on ``cuda:0`` at the serving phase's
    widths (a 1000-token prompt prefilled, then one step): its (out, lse)
    and the ``paged_decode`` launches it made."""
    import torch
    from magiattention_tpu_torch import csrc
    from magiattention_tpu_torch.serving import ServingEngine

    engine = ServingEngine(num_pages=16, num_kv_heads=HK, head_dim=D, page_size=PAGE, max_seqs=2,
                           max_pages_per_seq=8, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    prompt = [torch.randn((1000, h, D), generator=gen, device="cuda", dtype=torch.bfloat16)
              for h in (HQ, HK, HK)]
    step = [torch.randn((1, h, D), generator=gen, device="cuda", dtype=torch.bfloat16)
            for h in (HQ, HK, HK)]
    res = engine.admit(1000)
    check(res.admitted, f"analysis decode probe: admission refused ({res.reason})")
    engine.prefill(*prompt, res.slot)
    before = csrc.launches["paged_decode"]
    out, lse = engine.decode_step(*step, [res.slot])
    torch.cuda.synchronize()
    return {"out": out, "lse": lse, "paged_decode": csrc.launches["paged_decode"] - before,
            "cache_type": type(engine.cache).__name__}


def analysis_phase(pools, seed: int) -> dict:
    """The ``analysis`` phase: ``MAGI_ATTENTION_VALIDATE`` on the keyed cp
    path (cp=2 flat, hops and a2a, off / plan / trace; cp=4 as 2 x 2, off /
    plan), the live collective records against the comm metas and the dry
    records, the planted corruption, the interleaving checker's smoke
    matrix and plants on this machine with a real decode step before and
    after it, the upcast census on the card against the checked-in table,
    and the port's lint and CLI self-test."""
    import torch
    from magiattention_tpu_torch.analysis import lifecycle as lc
    from magiattention_tpu_torch.analysis import trace_audit as ta
    from magiattention_tpu_torch.analysis.__main__ import main as analysis_cli
    from magiattention_tpu_torch.analysis.lint import lint_errors

    t0 = time.perf_counter()
    flat = pools[2].run(analysis_cp_rank, seed, None)
    parts_s = {"cp2": time.perf_counter() - t0}
    hier = pools[4].run(analysis_cp_rank, seed, CP_HIER)
    parts_s["cp4_2x2"] = time.perf_counter() - t0 - sum(parts_s.values())
    launches = {}
    for r in flat + hier:
        for n, c in r["launches"].items():
            launches[n] = launches.get(n, 0) + c
    for label, res in (("cp=2", flat), ("cp=4 2x2", hier)):
        for r in res:
            check(all(r["bitwise_equal_to_off"].values()) and r["bitwise_equal_to_off"],
                  f"analysis {label} rank {r['rank']}: validation changed a bit: "
                  f"{r['bitwise_equal_to_off']}")
            check(r["validate_checks"] == r["plans_checked"] and r["validate_failures"] == 0,
                  f"analysis {label} rank {r['rank']}: {r['validate_checks']} checks / "
                  f"{r['validate_failures']} failures for {r['plans_checked']} plans built")
            check(r["overlap_degree"] == ANALYSIS_DEGREE,
                  f"analysis {label}: the plan has degree {r['overlap_degree']}")
            check(set(r["launches"]) == set(TRAINING_KERNELS),
                  f"analysis {label} rank {r['rank']}: launches {r['launches']}")
    for impl in ANALYSIS_IMPLS:
        for r in flat:
            lv = r["live"][impl]
            check(not lv["errors"], f"analysis cp=2 {impl} rank {r['rank']}: the live "
                  f"records fail {lv['errors']}")
            check(lv["census_fwd"] == lv["expected_fwd"] and lv["expected_fwd"]
                  and lv["census_fwd_bwd"] == {o: 2 * c for o, c in lv["expected_fwd"].items()},
                  f"analysis cp=2 {impl}: census {lv['census_fwd']} / {lv['census_fwd_bwd']} "
                  f"against {lv['expected_fwd']}")
    plant = pools[2].run(analysis_plant_rank, seed)[0]["every"]
    parts_s["plant"] = time.perf_counter() - t0 - sum(parts_s.values())
    check(plant[0]["raised"] is not None and "permutation" in plant[0]["raised"]
          and plant[0]["failures"] == 1 and plant[0]["launches"] == 0
          and plant[1]["raised"] is None and plant[1]["failures"] == 0,
          f"analysis: the planted recv_sel corruption: {plant}")

    # the interleaving checker on this machine, a real decode step around it
    probe_before = analysis_decode_probe(seed)
    lc_t0 = time.perf_counter()
    errors, report = lc.run_lifecycle_check(smoke=True)
    counts = {k: (r["states"], r["transitions"]) for k, r in report.items()}
    plants = lc.run_mutation_self_test()
    lc_s = time.perf_counter() - lc_t0
    check(not errors and counts == ANALYSIS_LIFECYCLE and not plants,
          f"analysis lifecycle: {counts} (want {ANALYSIS_LIFECYCLE}), errors {errors[:2]}, "
          f"plants {plants}")
    probe_after = analysis_decode_probe(seed)
    check(probe_after["cache_type"] == "PagedKVCache" and probe_after["paged_decode"] >= 1
          and probe_before["paged_decode"] >= 1
          and torch.equal(probe_after["out"], probe_before["out"])
          and torch.equal(probe_after["lse"], probe_before["lse"]),
          "analysis: the decode step after the lifecycle check differs from the one before "
          f"(stubs left behind?): {probe_after['cache_type']}, launches "
          f"{probe_before['paged_decode']} / {probe_after['paged_decode']}")

    parts_s["lifecycle_and_decode_probes"] = time.perf_counter() - t0 - sum(parts_s.values())

    # the op census on the card: the same table as the CPU's
    census_errors, census = ta.audit_dtypes(ta.load_expectations(), device="cuda")
    check(not census_errors, f"analysis: the upcast census on the card: {census_errors}")
    lint = lint_errors(os.path.dirname(os.path.abspath(__file__)))
    check(not lint, f"analysis: the port does not lint clean: {lint}")
    out = io.StringIO()  # the CLI's entry in this process: its report, not the smoke's lines
    with contextlib.redirect_stdout(out):
        rc = analysis_cli(["--only", "lint", "--only", "plan", "--self-test"])
    check(rc == 0, f"analysis CLI --self-test exited {rc}: {out.getvalue()[-2000:]}")
    parts_s["census_lint_cli"] = time.perf_counter() - t0 - sum(parts_s.values())
    r0 = flat[0]
    return {
        "phase": "analysis", "tokens": CP_ATTN_T, "heads": list(ANALYSIS_HEADS),
        "overlap_degree": ANALYSIS_DEGREE, "card": nvidia_smi_line(),
        "plan_build_host_ms_rank0": {"cp2": r0["plan_build_host_ms"],
                                     "cp4_2x2": hier[0]["plan_build_host_ms"]},
        "note": "plan-build host ms: median of cold builds, the cp ranks sharing one card",
        "bitwise_equal_to_off": {"cp2": [r["bitwise_equal_to_off"] for r in flat],
                                 "cp4_2x2": [r["bitwise_equal_to_off"] for r in hier]},
        "validate_checks": [r["validate_checks"] for r in flat + hier],
        "validate_failures": sum(r["validate_failures"] for r in flat + hier),
        "live": {impl: {k: flat[0]["live"][impl][k] for k in
                        ("census_fwd", "census_fwd_bwd", "expected_fwd", "signature", "impls")}
                 for impl in ANALYSIS_IMPLS},
        "planted_recv_sel": {"raised": plant[0]["raised"][:160],
                             "failures": plant[0]["failures"],
                             "launches_before_raise": plant[0]["launches"]},
        "lifecycle": {"counts": counts, "seconds": lc_s,
                      "decode_probe_bitwise": True},
        "upcast_census_card": census, "lint_findings": 0, "parts_s": parts_s,
        "launches": launches, "wall_s": time.perf_counter() - t0,
    }


# -- the fleet layer: a seeded trace through the real engine ------------------------

# generate_trace's arguments (the seed is --seed): MMPP arrivals, calm at 0.5
# requests a tick and bursts at 4, 512-token shared system prompts (4 pages,
# a zipf pool of 4) on 3 of 4 requests, chat-length suffixes, lognormal
# outputs around 16 tokens, Llama-3.1-8B's vocabulary
FLEET_TRACE = dict(horizon_ticks=64, arrival="mmpp", rate=0.5, burst_rate=4.0, burst_prob=0.05,
                   calm_prob=0.25, page_size=PAGE, prefix_pool=4, prefix_pages=4,
                   zipf_alpha=1.2, shared_fraction=0.75, suffix_len_range=(64, 1536),
                   output_len_median=16, output_len_sigma=0.6, output_len_max=64, vocab=VOCAB)
FLEET_GEOM = dict(num_pages=1024, max_seqs=64, max_pages_per_seq=24, chunk=SCHED_CHUNK)
FLEET_MODES = {"single": dict(token_budget=SCHED_BUDGET),
               "tiered": dict(dp=2, prefill_budget=SCHED_BUDGET, decode_budget=64)}
FLEET_SLO = dict(ttft_p99_ticks=16, toklat_p99_ticks=8, attainment_target=0.9)
FLEET_WINDOW, FLEET_COOLDOWN = 8, 3
FLEET_KERNELS = ("flex_fwd", "flex_fwd_hb", "paged_decode")  # flex_fwd only at head_block 1


def fleet_knob_specs(mode: str):
    """The autopilot's knobs sized for this geometry (``default_knob_specs``
    is sized for the simulator's toy budgets: its token_budget ceiling of
    1024 would clamp 2048 on the first action); the admission watermark as
    the package's."""
    from magiattention_tpu_torch.fleet import KnobSpec, default_knob_specs

    watermark = [s for s in default_knob_specs(mode) if s.name == "admission_watermark"]
    if mode == "single":
        return (KnobSpec("token_budget", 1024, 8192, 512, SCHED_BUDGET), *watermark)
    return (KnobSpec("decode_budget", 16, 512, 16, 64),
            KnobSpec("prefill_budget", 1024, 8192, 512, SCHED_BUDGET), *watermark)


def fleet_sim_kwargs(mode: str) -> dict:
    from magiattention_tpu_torch.fleet import Autopilot, SLOTargets

    slo = SLOTargets(**FLEET_SLO)
    pilot = Autopilot(slo, knob_specs=fleet_knob_specs(mode), cooldown_windows=FLEET_COOLDOWN)
    return dict(mode=mode, autopilot=pilot, slo=slo, window_ticks=FLEET_WINDOW, **FLEET_GEOM,
                **FLEET_MODES[mode])


def fleet_card_simulator(seed: int):
    """``fleet.FleetSimulator`` on the card: its replay loop, with the real
    engine and scheduler (every tier on ``cuda:0`` in tiered mode) in place
    of the stubbed device layer, bf16 requests drawn on the card, and a tick
    clock that stamps each tick's start on the host clock once the card has
    finished the previous tick. A request's rows come from generators seeded
    by ``seed`` and its ``prefix_id`` (the shared prompt: two requests that
    share it carry the same K/V) and by its ``rid`` (the rest)."""
    import torch
    from magiattention_tpu_torch.fleet import FleetSimulator, TickClock
    from magiattention_tpu_torch.serving import (
        Request,
        Scheduler,
        ServingEngine,
        TieredEngine,
        TieredScheduler,
    )

    class CardClock(TickClock):
        def __init__(self):
            self._t, self.stamps = 0.0, []

        @property
        def t(self):
            return self._t

        @t.setter
        def t(self, value):
            torch.cuda.synchronize()
            self.stamps.append(time.perf_counter())
            self._t = value

    def rows(g, t):
        return [torch.randn((t, h, D), generator=g, device="cuda").to(torch.bfloat16)
                for h in (HQ, HK, HK)]

    class CardFleet(FleetSimulator):
        def __init__(self, trace, **kw):
            super().__init__(trace, **kw)
            prefix_len = trace.meta["prefix_pages"] * trace.page_size
            prefixes, self.rows = {}, {}
            for tr in trace.requests:  # drawn before the replay: no tick pays for them
                g = torch.Generator(device="cuda").manual_seed(seed * 1_000_003 + tr.rid)
                head = 0
                if tr.prefix_id >= 0:
                    if tr.prefix_id not in prefixes:
                        pg = torch.Generator(device="cuda").manual_seed(
                            seed * 1_000_003 + 500_000 + tr.prefix_id)
                        prefixes[tr.prefix_id] = rows(pg, prefix_len)
                    head = prefix_len
                prompt = rows(g, tr.prompt_len - head)
                if head:
                    prompt = [torch.cat([p, x]) for p, x in zip(prefixes[tr.prefix_id], prompt)]
                self.rows[tr.rid] = (prompt, rows(g, tr.output_len))
            self.reports, self.plan_ms, self.peak_pages, self.cascade_steps = [], [], 0, 0

        def _device_layer(self):
            return contextlib.nullcontext()

        def _make_clock(self):
            self.clock = CardClock()
            return self.clock

        def _build_stack(self, clock):
            geom = dict(num_pages=self.num_pages, page_size=self.trace.page_size,
                        max_seqs=self.max_seqs, max_pages_per_seq=self.max_pages_per_seq,
                        num_kv_heads=HK, head_dim=D, dtype=torch.bfloat16)
            if self.mode == "single":
                engine = ServingEngine(device="cuda", **geom)
                sched = Scheduler(engine, token_budget=self.token_budget, chunk=self.chunk,
                                  max_decode_batch=self.max_decode_batch, clock=clock)
                pools = [engine.allocator]
            else:
                engine = TieredEngine(
                    mesh_spec={"prefill": 1, "decode_dp": self.dp, "decode_tp": 1},
                    devices=["cuda:0"] * (1 + self.dp), stream_queue_max=self.stream_queue_max,
                    **geom)
                sched = TieredScheduler(engine, prefill_budget=self.prefill_budget,
                                        decode_budget=self.decode_budget, chunk=self.chunk,
                                        max_decode_batch=self.max_decode_batch, clock=clock)
                pools = [engine.allocator] + [r.engine.allocator for r in engine.replicas]
            step = sched.step

            def recorded_step():
                with host_split() as spent:  # the tick's host ms in the plan builder
                    rep = step()
                self.reports.append(rep)
                self.plan_ms.append(spent["plan"] + spent["table_upload"])
                self.peak_pages = max(self.peak_pages, sum(p.pages_in_use for p in pools))
                info = engine.last_decode_info or {}
                self.cascade_steps += bool(rep.decode_ran and info.get("cascade_groups"))
                return rep

            sched.step = recorded_step
            self.sched, self.engine = sched, engine
            return sched, engine

        def _mk_request(self, tr):
            (q, k, v), (dq, dk, dv) = self.rows[tr.rid]
            return Request(rid=tr.rid, prompt_q=q, prompt_k=k, prompt_v=v, decode_q=dq,
                           decode_k=dk, decode_v=dv, tokens=list(tr.prompt_tokens),
                           max_new_tokens=tr.output_len, priority=tr.priority,
                           trace_id=f"fleet-{self.trace.name}-{tr.rid}")

    return CardFleet


def plain_last_row(q, k, v):
    """Plain attention of one query row [hq, d] over every key [t, hk, d],
    in float32."""
    import torch

    g = q.shape[0] // k.shape[1]
    kk, vv = (x.float().repeat_interleave(g, dim=1) for x in (k, v))
    s = torch.einsum("hd,thd->ht", q.float(), kk) / math.sqrt(q.shape[-1])
    return torch.einsum("ht,thd->hd", torch.softmax(s, dim=-1), vv)


def pct(xs, q: float) -> float | None:
    import numpy as np

    return float(np.percentile(xs, q)) if len(xs) else None


def fleet_cold_start() -> None:
    """Drop the process's plans, their device tables and the tuning memos:
    each mode's replay starts as a fresh server would, with no plan an
    earlier phase or mode built."""
    from magiattention_tpu_torch.ops import flex_attn as fa
    from magiattention_tpu_torch.tuning import reset_tuning_cache

    for cached in (fa._cached_meta, fa.fwd_tables, fa.bwd_tables, fa.sparse_work):
        cached.cache_clear()
    reset_tuning_cache()


def fleet_run(mode: str, trace, card_cls) -> dict:
    """One mode's replay on the card and through the stubbed simulator: the
    reports equal request for request, window for window and action for
    action; each request's prompt tail and last decode output against the
    plain attention of its own rows; per-tick, TTFT and token-latency ms from
    the tick stamps."""
    import torch
    from magiattention_tpu_torch import csrc, telemetry
    from magiattention_tpu_torch.fleet import FleetSimulator

    sim = card_cls(trace, **fleet_sim_kwargs(mode))
    fleet_cold_start()
    csrc.reset_launch_counts()
    try:
        rep = sim.run()
        torch.cuda.synchronize()
        sim.clock.stamps.append(time.perf_counter())  # the last tick's end
        launches = {n: csrc.launches[n] for n in csrc.launches if csrc.launches[n]}
        stub = FleetSimulator(trace, **fleet_sim_kwargs(mode)).run()
    finally:
        telemetry.set_enabled(None)
    fields = ("rid", "arrival_tick", "ttft_ticks", "toklat_ticks", "tokens", "evictions",
              "finish_tick")
    diffs = [(a.rid, [f for f in fields if getattr(a, f) != getattr(b, f)])
             for a, b in zip(rep.requests, stub.requests)]
    equal = (len(rep.requests) == len(stub.requests) and not any(d for _, d in diffs)
             and rep.windows == stub.windows and rep.actions == stub.actions)
    check(equal, f"fleet {mode}: the card's replay differs from the stubbed simulator's: "
          f"{[d for d in diffs if d[1]][:5]}, windows equal {rep.windows == stub.windows}, "
          f"actions {rep.actions} vs {stub.actions}")
    check(rep.offered == trace.num_requests and rep.finished == rep.offered,
          f"fleet {mode}: {rep.finished} of {rep.offered} requests finished "
          f"({trace.num_requests} in the trace)")
    check(set(launches) <= set(FLEET_KERNELS) and launches.get("flex_fwd_hb", 0) > 0
          and launches.get("paged_decode", 0) > 0,
          f"fleet {mode} launches {launches}: flex_fwd_hb and paged_decode, and no other "
          "kernel than flex_fwd")
    worst = {"flex_fwd_hb": 0.0, "paged_decode": 0.0}
    for rid, st in sim.sched._finished.items():
        (q, k, v), (dq, dk, dv) = sim.rows[rid]
        n = st.tokens_done
        check(st.prefill_out_tail is not None and n == st.request.max_new_tokens
              and len(st.decode_outs) >= n, f"fleet {mode}: request {rid} finished without "
              "its outputs")
        for kernel, got, ref in (
                ("flex_fwd_hb", st.prefill_out_tail, plain_last_row(q[-1], k, v)),
                ("paged_decode", st.decode_outs[-1],
                 plain_last_row(dq[n - 1], torch.cat([k, dk[:n]]), torch.cat([v, dv[:n]])))):
            errs, failed = out_errors(got, ref, [])
            check(not failed, f"fleet {mode}: request {rid}'s {kernel} output fails {failed}: "
                  f"{errs}")
            worst[kernel] = max(worst[kernel], errs["out_max_abs_err"])
    for kernel, e in worst.items():
        MAX_ERR[kernel] = max(MAX_ERR[kernel], e)
    stamps = sim.clock.stamps
    check(len(stamps) == rep.ticks_run + 1, f"fleet {mode}: {len(stamps)} stamps for "
          f"{rep.ticks_run} ticks")
    tick_ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    ttft_ms, toklat_ms, plan_share = [], [], []
    arrivals = {r.rid: r.arrival_tick for r in trace.requests}
    for st in sim.sched._finished.values():
        arrival = arrivals[st.rid]
        first, last = int(st.first_token_at), int(st.last_token_at)
        ttft_ms.append((stamps[first + 1] - stamps[arrival]) * 1e3)
        plan_share.append(sum(sim.plan_ms[arrival:first + 1]) / ttft_ms[-1])
        if st.tokens_done > 1:
            toklat_ms.append((stamps[last + 1] - stamps[first + 1]) * 1e3 / (st.tokens_done - 1))
    wall_s = stamps[-1] - stamps[0]
    prefill_tokens = sum(n for r in sim.reports for _rid, n in r.prefill_chunks)
    decode_tokens = sum(r.decode_batch for r in sim.reports)
    return {
        "ticks": rep.ticks_run, "wall_s": wall_s,
        "ms_per_tick": {"p50": pct(tick_ms, 50), "p99": pct(tick_ms, 99), "max": max(tick_ms)},
        "ttft_ms": {"p50": pct(ttft_ms, 50), "p99": pct(ttft_ms, 99)},
        # the plan builder's host ms (plan and table upload) over a request's
        # ticks from arrival to first token, as a share of its TTFT
        "plan_share_of_ttft": {"p50": pct(plan_share, 50), "p99": pct(plan_share, 99)},
        "plan_ms_total": sum(sim.plan_ms),
        "ticks_with_a_plan_build": sum(ms > 0 for ms in sim.plan_ms),
        "cascade_decode_steps": sim.cascade_steps,
        "token_latency_ms": {"p50": pct(toklat_ms, 50), "p99": pct(toklat_ms, 99)},
        "ttft_ticks": {"p50": rep.ttft_p50, "p99": rep.ttft_p99},
        "token_latency_ticks_p99": rep.toklat_p99,
        "prefill_tokens": prefill_tokens, "decode_tokens": decode_tokens,
        "prefill_tokens_per_s": prefill_tokens / wall_s,
        "decode_tokens_per_s": decode_tokens / wall_s,
        "offered": rep.offered, "finished": rep.finished,
        "attainment_offered": rep.attainment_offered, "goodput_tokens": rep.goodput_tokens,
        "actions": [list(a) for a in rep.actions], "final_knobs": rep.final_knobs,
        "holds": sorted({h[1] for w in rep.windows for h in w.get("holds", [])}),
        "peak_concurrent": rep.peak_concurrent, "peak_pages_in_use": sim.peak_pages,
        "evictions": sum(r.evictions for r in rep.requests),
        "equal_to_stub": equal, "out_max_abs_err": worst, "launches": launches,
        "per_tick_ms": tick_ms, "per_tick_plan_ms": sim.plan_ms,
    }


def fleet_phase(seed: int) -> dict:
    """The ``fleet`` phase: one seeded MMPP trace of shared-prefix chat
    requests replayed by the fleet simulator's own loop through the real
    engine on the card at the serving widths, in single and tiered mode
    under the SLO autopilot, each against the stubbed simulator on the same
    trace. ``FleetSimulator.run`` resets the telemetry registry, so no phase
    that reads the builds' compile records may come after this one."""
    import torch
    from magiattention_tpu_torch.fleet import generate_trace
    from magiattention_tpu_torch.fleet.workload import validate_trace

    t0 = time.perf_counter()
    trace = generate_trace("card", seed=seed, **FLEET_TRACE)
    check(not validate_trace(trace), f"fleet: the trace fails its lint: {validate_trace(trace)}")
    card_cls = fleet_card_simulator(seed)
    modes = {}
    for mode in FLEET_MODES:
        modes[mode] = fleet_run(mode, trace, card_cls)
        torch.cuda.empty_cache()
    launches = {}
    for line in modes.values():
        for n, c in line["launches"].items():
            launches[n] = launches.get(n, 0) + c
    prompt = [len(r.prompt_tokens) for r in trace.requests]
    return {
        "phase": "fleet", "card": nvidia_smi_line(),
        "heads": {"hq": HQ, "hk": HK, "head_dim": D}, "dtype": "bfloat16", "page": PAGE,
        "trace": {"requests": trace.num_requests, "horizon_ticks": trace.horizon_ticks,
                  "prompt_tokens": {"min": min(prompt), "max": max(prompt),
                                    "total": sum(prompt)},
                  "shared": sum(r.prefix_id >= 0 for r in trace.requests),
                  "output_tokens": sum(r.output_len for r in trace.requests),
                  "offered_per_tick": [int(x) for x in trace.offered_per_tick()]},
        "geometry": {**FLEET_GEOM, **{m: FLEET_MODES[m] for m in FLEET_MODES}},
        "slo": FLEET_SLO, "window_ticks": FLEET_WINDOW, "cooldown_windows": FLEET_COOLDOWN,
        "note": "ms from host stamps at each tick's start after a synchronise; TTFT = the "
                "first-token tick's end less the arrival tick's start; each mode starts with "
                "no plan cached (fleet_cold_start)",
        "modes": modes, "launches": launches, "wall_s": time.perf_counter() - t0,
    }


# -- the instrument phase: profiling, checkpoints, the bench harness, the gate --

NEW_CASES_SEED = 25  # the seed offset of the generator the newer cases draw from
INSTR_PROMPTS = (1000, 2048, 3000)  # the serving part's requests
INSTR_STEPS = 4  # decode steps of each
INSTR_SERVING_RANGES = ("magi_prefill_attn", "magi_decode_attn", "magi_kvcache_append")
INSTR_CP_RANGES = ("magi_stage0_cast", "magi_stage0_kernel", "magi_stage0_lse_merge")
INSTR_TRAIN_STEPS = 2  # N: N steps, save, restore, N more against 2N uninterrupted
INSTR_MQA = (48, 1, 128)  # StarCoder-15B's attention: 48 q heads over 1 kv head of d 128
INSTR_MQA_VOCAB = 4096  # the greedy loop's toy vocabulary
INSTR_GATE_METRICS = ("flex_fwd_hb_tflops", "flex_dq_tflops")


def trace_ranges(path: str, labels) -> dict:
    """Each label's ranges in a ``torch.profiler`` Chrome trace (its
    ``user_annotation`` events) and the CUDA launches the host made inside
    them (``cuda_runtime`` events whose name holds ``Launch``, on the same
    thread, between the range's start and end)."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    launches = [e for e in events if e.get("cat") == "cuda_runtime" and "Launch" in e["name"]]
    out = {}
    for label in labels:
        ranges = [e for e in events if e.get("cat") == "user_annotation" and e["name"] == label]
        inside = sum(1 for r in ranges for e in launches if e.get("tid") == r.get("tid")
                     and r["ts"] <= e["ts"] <= r["ts"] + r["dur"])
        out[label] = {"ranges": len(ranges), "launches_inside": inside}
    return out


def instr_serving_run(seed: int) -> tuple[list, dict]:
    """The serving path at the serving widths: admit INSTR_PROMPTS, prefill
    each, INSTR_STEPS decode steps of the batch, on inputs from ``seed``;
    returns every output and the launches."""
    import torch
    from magiattention_tpu_torch.serving import ServingEngine

    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    launches, outs = {}, []
    engine = ServingEngine(num_pages=128, num_kv_heads=HK, head_dim=D, page_size=PAGE,
                           max_seqs=4, max_pages_per_seq=32, dtype=torch.bfloat16)
    slots = []
    for n in INSTR_PROMPTS:
        res = engine.admit(n)
        check(res.admitted, f"instrument serving: admission {res}")
        outs.extend(counted(launches, lambda: engine.prefill(rand(n, HQ, D), rand(n, HK, D),
                                                             rand(n, HK, D), res.slot)))
        slots.append(res.slot)
    b = len(slots)
    for _ in range(INSTR_STEPS):
        outs.extend(counted(launches, lambda: engine.decode_step(
            rand(b, HQ, D), rand(b, HK, D), rand(b, HK, D), slots)))
    torch.cuda.synchronize()
    del engine
    return outs, launches


def instr_serving(seed: int, trace_dir: str) -> dict:
    """Part 1: the serving run with profile mode off, then again under
    ``MAGI_ATTENTION_PROFILE_MODE=1`` and ``switch_profile()`` (the trace
    into ``MAGI_ATTENTION_TRACE_DIR``): the outputs bit for bit the same,
    the trace holding the serving ranges around kernel launches."""
    from magiattention_tpu_torch.utils.instrument import switch_profile

    off, launches = instr_serving_run(seed)
    with magi_flags(PROFILE_MODE="1", TRACE_DIR=trace_dir):
        with switch_profile() as sess:
            on, _ = instr_serving_run(seed)
    check(sess.path is not None and sess.path.startswith(trace_dir),
          f"instrument serving: the session wrote {sess.path}, not into {trace_dir}")
    check(bitwise(off, on), "instrument serving: the outputs under profile mode differ")
    ranges = trace_ranges(sess.path, INSTR_SERVING_RANGES)
    check(all(r["ranges"] and r["launches_inside"] for r in ranges.values()),
          f"instrument serving: ranges missing or empty in the trace: {ranges}")
    return {"launches": launches, "trace_bytes": os.path.getsize(sess.path),
            "ranges": ranges, "outputs_bitwise_profile_on_off": True}


@in_rank
def instr_cp_rank(group, seed: int, trace_dir: str) -> dict:
    """Part 2, one cp rank: the keyed API's forward at degree 1 on the hetero
    mask (``LlamaConfig``'s 16 / 8 heads, d 128, bf16) with profile mode off,
    then under profile mode in a ``switch_profile`` session of this rank's;
    the outputs bit for bit, the stage ranges in the trace."""
    import torch
    import torch.distributed as dist
    from magiattention_tpu_torch import api
    from magiattention_tpu_torch.config import DistAttnConfig
    from magiattention_tpu_torch.meta.solver.overlap_solver import OverlapConfig
    from magiattention_tpu_torch.testing.workloads import split_slices, varlen_block_causal
    from magiattention_tpu_torch.utils.instrument import switch_profile

    cp_rank_setup()
    rank, t = dist.get_rank(group), CP_ATTN_T
    qr, kr, ty = split_slices(varlen_block_causal(t))
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn((t, h, D), generator=gen, device="cuda", dtype=torch.bfloat16)
               for h in (TRAIN_HQ, TRAIN_HK, TRAIN_HK))
    key = api.magi_attn_flex_key(
        qr, kr, ty, t, t, group, num_heads=(TRAIN_HQ, TRAIN_HK), head_dim=D,
        chunk_size=CP_CHUNK, dist_attn_config=DistAttnConfig(overlap_config=OverlapConfig(degree=1)))

    def fwd():
        with torch.no_grad():
            out_l, meta = api.calc_attn(api.dispatch(q, key), api.dispatch(k, key),
                                        api.dispatch(v, key), key)
            return api.undispatch(out_l, key), api.undispatch(meta.lse, key)

    off = fwd()
    with magi_flags(PROFILE_MODE="1"):
        with switch_profile(os.path.join(trace_dir, f"rank{rank}")) as sess:
            on = fwd()
            torch.cuda.synchronize()
    return {"rank": rank, "degree": api.get_runtime_mgr(key).plan.overlap_degree,
            "bitwise": bitwise(off, on), "ranges": trace_ranges(sess.path, INSTR_CP_RANGES)}


def instr_cp(pools, seed: int, trace_dir: str) -> dict:
    """Part 2 over ``RankPool(2)``, ranks sharing the card."""
    ranks = pools[2].run(instr_cp_rank, seed, trace_dir)
    for r in ranks:
        check(r["degree"] == 1 and r["bitwise"], f"instrument cp: rank {r['rank']}: {r}")
        check(all(x["ranges"] and x["launches_inside"] for x in r["ranges"].values()),
              f"instrument cp: rank {r['rank']}'s stage ranges missing or empty: {r['ranges']}")
    return {"cp": 2, "ranks": ranks}


def instr_checkpoint(seed: int, scratch: str) -> dict:
    """Part 3: the Llama trainer as the training phase runs it (4 layers of
    ``LlamaConfig``, the 8192-token stream, AdamW): 2N steps in a row; then
    from the same start N steps, a save, a restore into a fresh model and
    optimizer (``template`` their state dicts), N more: the 2N losses bit
    for bit; and a template with one weight's shape drifted must raise."""
    import torch
    from magiattention_tpu_torch import csrc
    from magiattention_tpu_torch.api import infer_varlen_mask_from_batch
    from magiattention_tpu_torch.models import LlamaConfig, build_magi_llama, make_model_train_step
    from magiattention_tpu_torch.utils.checkpoint import (
        latest_step, restore_train_state, save_train_state,
    )

    cfg = dataclasses.replace(LlamaConfig(), n_layers=TRAIN_LAYERS)
    total = sum(TRAIN_DOCS)
    mask = infer_varlen_mask_from_batch(TRAIN_DOCS)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (total,), generator=gen, device="cuda")
    batch = (tokens, torch.roll(tokens, -1), torch.arange(total, device="cuda"))

    def trainer(init_seed):
        model = build_magi_llama(cfg, total, *mask, seed=init_seed)
        opt = torch.optim.AdamW(model.parameters(), **ADAMW)
        return model, opt, make_model_train_step(model, opt)

    n = INSTR_TRAIN_STEPS
    launches = {}
    model, opt, step = trainer(seed)
    straight = counted(launches, lambda: [float(step(*batch)) for _ in range(2 * n)])
    del model, opt, step
    model, opt, step = trainer(seed)
    first = [float(step(*batch)) for _ in range(n)]
    path = os.path.join(scratch, "instr_ckpt")
    t0 = time.perf_counter()
    save_train_state(path, n, {"model": model.state_dict(), "optimizer": opt.state_dict()})
    save_s = time.perf_counter() - t0
    del model, opt, step
    torch.cuda.empty_cache()
    model, opt, step = trainer(seed + 1)  # another init: the restore must overwrite it
    template = {"model": model.state_dict(), "optimizer": opt.state_dict()}
    t0 = time.perf_counter()
    at, state = restore_train_state(path, template=template)
    restore_s = time.perf_counter() - t0
    model.load_state_dict(state["model"])
    opt.load_state_dict(state["optimizer"])
    resumed = first + [float(step(*batch)) for _ in range(n)]
    check(at == n == latest_step(path), f"instrument checkpoint: restored step {at}, saved {n}")
    check(resumed == straight, f"instrument checkpoint: losses {resumed} != {straight}")
    drifted = dict(template["model"])
    name = next(iter(drifted))
    drifted[name] = torch.empty((drifted[name].shape[0] + 1, *drifted[name].shape[1:]),
                                dtype=drifted[name].dtype)
    try:
        restore_train_state(path, template={"model": drifted})
        raised = None
    except ValueError as exc:
        raised = str(exc)[:160]
    check(raised is not None, "instrument checkpoint: a drifted template restored")
    nbytes = sum(os.path.getsize(os.path.join(path, str(n), f))
                 for f in os.listdir(os.path.join(path, str(n))))
    del model, opt, step, state, template, drifted
    torch.cuda.empty_cache()
    return {"launches": launches, "losses_2n": straight, "resumed_bitwise": True,
            "save_s": save_s, "restore_s": restore_s, "checkpoint_bytes": nbytes,
            "drift_raised": raised}


def instr_bench(gen) -> dict:
    """Part 4: ``do_bench`` (record_memory) and a ``MemoryRecorder`` on
    ``flex_fwd_hb`` at §6's row-2 problem (the causal 4096 prefill, 32 / 8
    heads, head_block 4) and ``flex_dq`` at row 5's (causal 8192, 16 / 8):
    the medians beside the smoke's own CUDA-event times of the same calls,
    the peaks beside ``torch.cuda.max_memory_allocated``. Timing launches
    only: none is a main path's."""
    import torch
    from magiattention_tpu_torch import csrc
    from magiattention_tpu_torch.benchmarking import MemoryRecorder, do_bench

    rec = {}
    saved = dict(csrc.launches)
    for name, (t, hq, hk), run_of in (
            ("flex_fwd_hb", (4096, HQ, HK), lambda p: lambda: p.hb_kernel(HQ // HK)),
            ("flex_dq", (8192, TRAIN_HQ, TRAIN_HK), lambda p: p.dq_kernel)):
        p = Flex(gen, t, t, hq, hk, [(0, t)], [(0, t)], [1])
        run = run_of(p)
        run()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with MemoryRecorder() as mem:
            res = do_bench(run, warmup=3, rep=20, inner=5, record_memory=True)
        peak = torch.cuda.max_memory_allocated()
        smoke = cuda_ms(run, reps=20)
        flops = {"flex_fwd_hb": 4.0, "flex_dq": 6.0}[name] * p.meta.total_area * D * hq
        rec[name] = {"tokens": t, "hq": hq, "hk": hk, "do_bench_median_ms": res.median_ms,
                     "do_bench_min_max_ms": [res.min_ms, res.max_ms], "smoke_cuda_ms": smoke,
                     "ratio": res.median_ms / smoke, "tflops": res.tflops(flops),
                     "do_bench_peak_bytes": res.peak_bytes,
                     "memory_recorder_peak_bytes": max(mem.peak_bytes.values(), default=None),
                     "max_memory_allocated_bytes": peak}
        check(res.peak_bytes and res.peak_bytes <= peak and mem.peak_bytes,
              f"instrument bench {name}: peaks {rec[name]}")
        del p
        torch.cuda.empty_cache()
    csrc.launches.update(saved)
    return rec


def instr_gate(bench: dict, scratch: str) -> dict:
    """Part 5: ``telemetry.baseline`` on a history this phase writes: two
    entries of part 4's rates, expectations seeded from them, the gate on
    the newest; then an entry lowered past the tolerance, which must fail."""
    import torch
    from magiattention_tpu_torch.telemetry import baseline

    path = os.path.join(scratch, baseline.HISTORY_FILENAME)
    metrics = {f"{k}_tflops": v["tflops"] for k, v in bench.items()}
    card, limit = torch.cuda.get_device_name(0), nvidia_smi_line().split(", ")[-1]
    for i in range(2):
        baseline.append_history(path, baseline.make_history_entry(
            source=f"instrument_{i}", metrics=metrics, device=card, power_limit=limit,
            recorded_unix=int(time.time())))
    hist = baseline.load_history(path)
    windows = baseline.seed_expectations(hist)
    passed = baseline.check_gate(baseline.newest_metrics(hist), windows)
    tol = baseline.default_tolerance()
    lowered = {k: v * (1.0 - 2.0 * tol) for k, v in metrics.items()}
    baseline.append_history(path, baseline.make_history_entry(
        source="instrument_lowered", metrics=lowered, device=card, power_limit=limit))
    failed = baseline.check_gate(baseline.newest_metrics(baseline.load_history(path)), windows)
    check(not any(r.failed for r in passed) and all(r.failed for r in failed),
          f"instrument gate: {[r.status for r in passed]} then {[r.status for r in failed]}")
    return {"tolerance": tol, "entries": len(baseline.load_history(path)),
            "passes": [r.status for r in passed], "lowered": [r.status for r in failed],
            "report": baseline.gate_report(failed, baseline.rung_changes(hist))}


def instr_mqa(seed: int) -> dict:
    """Part 6: a ServingEngine at StarCoder-15B's attention layout (48 q
    heads over 1 kv head, d 128, bf16) answering three requests through the
    widened ``paged_decode``: a greedy loop whose next token is the argmax
    of a seeded projection of the decode output and whose next q / k / v
    are a seeded embedding of that token. Each step's token from the
    kernel's output must equal the one from the plain decode's
    (``decode_reference``) over the same cache."""
    import torch
    from magiattention_tpu_torch.serving import ServingEngine, decode_reference

    hq, hk, d = INSTR_MQA
    gen = torch.Generator(device="cuda").manual_seed(seed)
    embed = torch.randn((INSTR_MQA_VOCAB, (hq + 2 * hk) * d), generator=gen, device="cuda")
    proj = torch.randn((hq * d, INSTR_MQA_VOCAB), generator=gen, device="cuda") / (hq * d) ** 0.5

    def qkv(tokens):
        x = embed[tokens].to(torch.bfloat16).view(len(tokens), hq + 2 * hk, d)
        return (x[:, :hq].contiguous(), x[:, hq:hq + hk].contiguous(),
                x[:, hq + hk:].contiguous())

    launches = {}
    engine = ServingEngine(num_pages=96, num_kv_heads=hk, head_dim=d, page_size=PAGE,
                           max_seqs=4, max_pages_per_seq=32, dtype=torch.bfloat16)
    slots, last = [], []
    for n in INSTR_PROMPTS:
        prompt = torch.randint(0, INSTR_MQA_VOCAB, (n,), generator=gen, device="cuda")
        res = engine.admit(n)
        check(res.admitted, f"instrument mqa: admission {res}")
        out, _ = counted(launches, lambda: engine.prefill(*qkv(prompt), res.slot))
        last.append(int((out[-1].float().flatten() @ proj).argmax()))
        slots.append(res.slot)
    tokens, steps = [last], 16
    idx = torch.as_tensor(slots, device="cuda")
    for _ in range(steps):
        q, k, v = qkv(torch.as_tensor(tokens[-1], device="cuda"))
        out, _ = counted(launches, lambda: engine.decode_step(q, k, v, slots))
        ref, _ = decode_reference(q, engine.cache, engine.cache.block_tables[idx],
                                  engine.cache.seq_lens[idx])
        got = (out.float().flatten(1) @ proj).argmax(1).tolist()
        want = (ref.float().flatten(1) @ proj).argmax(1).tolist()
        check(got == want, f"instrument mqa: kernel tokens {got} != plain tokens {want}")
        tokens.append(got)
    check(launches.get("paged_decode", 0) == steps, f"instrument mqa launches {launches}")
    del engine
    return {"layout": {"hq": hq, "hk": hk, "head_dim": d}, "requests": len(slots),
            "steps": steps, "tokens_equal_plain": True, "tokens": tokens, "launches": launches}


def instrument_phase(seed: int, gen, cp_part: dict, scratch: str, t0: float) -> dict:
    """The phase's line: the serving ranges (part 1), the cp stage ranges
    (part 2, run with the cp pools: ``cp_part``), checkpoint and resume
    (3), the bench harness (4), the gate (5), the multi-query engine (6);
    the launches of parts 1, 3 and 6, the main paths."""
    trace_dir = os.path.join(scratch, "instr_traces")
    serving_part = instr_serving(seed, trace_dir)
    ckpt = instr_checkpoint(seed, scratch)
    bench = instr_bench(gen)
    gate = instr_gate(bench, scratch)
    mqa = instr_mqa(seed)
    launches = {}
    for part in (serving_part, ckpt, mqa):
        for n, c in part["launches"].items():
            launches[n] = launches.get(n, 0) + c
    return {"phase": "instrument", "card": nvidia_smi_line(), "serving": serving_part,
            "cp": cp_part, "checkpoint": ckpt, "bench": bench, "gate": gate, "mqa": mqa,
            "launches": launches, "wall_s": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one card",
              file=sys.stderr)
        return 1
    from magiattention_tpu_torch import csrc

    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    if "MAGI_ATTENTION_TRACE_DIR" not in os.environ:
        # the flight recorder is always on: its dumps go to a directory of
        # this run's, not into the checkout
        import atexit
        import tempfile

        os.environ["MAGI_ATTENTION_TRACE_DIR"] = tempfile.mkdtemp(prefix="chip_smoke_dumps_")
        atexit.register(shutil.rmtree, os.environ["MAGI_ATTENTION_TRACE_DIR"], True)
    t0 = time.perf_counter()
    planted_procs = start_planted_build()  # nvcc runs beside the real build
    from magiattention_tpu_torch import telemetry

    telemetry.set_enabled(True)  # the builds' compile records: the telemetry phase reads them
    try:
        built = csrc.build(ptxas_verbose=True)
    finally:
        telemetry.set_enabled(None)
    for name in csrc.KERNELS:
        csrc.load(name)
    planted = planted_libraries(planted_procs)
    emit({
        "phase": "build",
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "wall_s": time.perf_counter() - t0,
        "nvcc_s": {n: r["seconds"] for n, r in built.items()},
        "ptxas": {n: [ln.strip() for ln in r["log"].splitlines()
                      if "registers" in ln or "spill" in ln or "setmaxnreg" in ln
                      or (n == "paged_decode" and "entry function" in ln)]
                  for n, r in built.items()},
        "sass": {**{n: sass_counts(built[n]["path"]) for n in FLEX_KERNELS},
                 "paged_decode": sass_counts(built["paged_decode"]["path"], DECODE_SASS)},
    })
    print(nvidia_smi_line(), flush=True)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    # the cases and timings added with the float32 sparse walks and the wide
    # decode walks draw from a generator of their own, so that every other
    # phase keeps the inputs it drew before they were added
    gen_new = torch.Generator(device="cuda")
    gen_new.manual_seed(args.seed + NEW_CASES_SEED)
    flex_cases(gen)
    hb_line = hb_cases(gen)
    emit({"phase": "kernels", "kernel": "flex_fwd_hb", **hb_line})
    emit({"phase": "planted_faults", "case": "fwd_causal_2048",
          "caught": fwd_planted_faults(gen, planted)})
    sparse_cases(gen)
    emit(sparse_fwd_cases(gen))
    emit(sparse_bwd_cases(gen))
    emit(narrow_cases(gen))
    emit(f32_cases(gen))
    emit(f32_sparse_cases(gen_new))
    emit({"phase": "planted_faults", "case": "d32_and_float32_walks",
          "caught": {**narrow_planted_faults(gen, planted),
                     **f32_sparse_planted_faults(gen_new, planted)}})
    fwd_t = flex_timing(gen, 4096, planted)
    bwd_t = bwd_timing(gen, sum(TRAIN_DOCS), planted)
    emit({"phase": "bwd_timing", **bwd_t})
    narrow_line, narrow_t = narrow_timing(gen, gen_new)
    emit(narrow_line)
    torch.cuda.empty_cache()
    emit(decode_cases(gen))
    emit({"phase": "planted_faults", "case": "paged_decode",
          "caught": decode_planted_faults(gen, planted)})
    emit(wide_decode_cases(gen_new))
    emit(wide_walk_cases(gen_new))
    emit({"phase": "planted_faults", "case": "paged_decode_wide",
          "caught": wide_decode_planted_faults(gen_new, planted)})
    wide_line, wide_t = wide_decode_timing(gen_new, planted)
    emit(wide_line)
    narrow_t.update(wide_t)
    wide_serving_line = wide_serving(args.seed)
    emit(wide_serving_line)

    summary, engine, slots = serving(gen)
    emit(summary)
    dec_t = decode_timing(engine, slots, gen, planted)
    emit({"phase": "decode_timing", **dec_t})
    tune_t0 = time.perf_counter()
    tune_serving = tune_splits_serving(engine, slots)  # the tuning phase's split part
    tune_wall = time.perf_counter() - tune_t0
    tp_line = tiered_tp_decode(engine, slots, gen)  # the tiered phase's TP decode, on this pool
    res_t0 = time.perf_counter()
    res_parts = {"decode": resilience_decode(engine, slots, gen)}  # the resilience phase's first part
    res_wall = time.perf_counter() - res_t0
    prof_t0 = time.perf_counter()
    prof_parts = {"census_decode": prof_census_decode(engine, slots, gen)}  # the profiling phase's
    prof_wall = time.perf_counter() - prof_t0
    del engine
    torch.cuda.empty_cache()
    # multi-head widths (G = 1): the choice is head_block 1, the prefill flex_fwd
    mha, engine, _ = serving(gen, hq=HQ, hk=HQ, prompts=(2048, 3000), chunked=1, steps=8,
                             phase="serving_mha")
    emit(mha)
    del engine
    prefix_line = prefix(gen)
    emit(prefix_line)
    torch.cuda.empty_cache()

    import atexit
    import tempfile

    from magiattention_tpu_torch.testing.dist import RankPool

    scratch = tempfile.mkdtemp(prefix="chip_smoke_")
    instr_scratch = tempfile.mkdtemp(prefix="chip_smoke_instr_")  # the instrument phase's
    atexit.register(shutil.rmtree, instr_scratch, True)
    grads_path = os.path.join(scratch, "cp1_grads.pt")
    train = training(args.seed, grads_path)
    emit(train)
    torch.cuda.empty_cache()

    hetero_line, hetero_t = hetero(gen, planted)
    emit(hetero_line)
    torch.cuda.empty_cache()
    block_sparse_line = block_sparse_phase(gen, args.seed)
    emit(block_sparse_line)
    torch.cuda.empty_cache()
    sink_line = sink_phase(gen)
    emit(sink_line)
    torch.cuda.empty_cache()
    emit(planner_host())

    # context parallelism: the ranks are processes sharing cuda:0 over gloo,
    # spawned after the kernels above were built (each loads the libraries)
    pools = {cp: RankPool(cp, backend="gloo", env={"MAGI_ATTENTION_TRACE_DIR": os.environ[
        "MAGI_ATTENTION_TRACE_DIR"]}) for cp, _ in CP_RUNS}
    try:
        cp_attn_line = cp_attn(pools, args.seed)
        emit(cp_attn_line)
        cp_qo_line = cp_qo_attn(pools, args.seed)
        emit(cp_qo_line)
        cp1 = {"losses": train["losses"], "grads_path": grads_path}
        cp_train_line = cp_training(pools, args.seed, cp1)
        emit(cp_train_line)
        par_train_line = parallel_training(pools, args.seed, scratch)
        emit(par_train_line)
        dit_line = dit_phase(pools, args.seed, scratch)
        emit(dit_line)
        baselines_line = cp_baselines(pools, args.seed)
        emit(baselines_line)
        cp_hier_line = cp_hier_attn(pools, args.seed)
        emit(cp_hier_line)
        cp_hier_train_line = cp_training(pools, args.seed, cp1, runs_of=((4, 0),), hier=CP_HIER,
                                         phase="cp_hier_training")
        emit(cp_hier_train_line)
        cp_xattn_line = cp_xattn(pools, args.seed)
        emit(cp_xattn_line)
        cp_reuse_line = cp_plan_reuse(pools, args.seed)
        emit(cp_reuse_line)
        cp_decode_line = cp_decode_phase(pools, args.seed)
        emit(cp_decode_line)
        res_t0 = time.perf_counter()
        res_parts["cp"] = resilience_cp(pools, args.seed)
        res_wall += time.perf_counter() - res_t0
        prof_t0 = time.perf_counter()
        prof_parts["cp"] = prof_cp(pools, args.seed)
        prof_wall += time.perf_counter() - prof_t0
        instr_t0 = time.perf_counter()
        instr_cp_part = instr_cp(pools, args.seed, os.path.join(instr_scratch, "instr_traces"))
        instr_wall = time.perf_counter() - instr_t0
        analysis_line = analysis_phase(pools, args.seed)
        emit(analysis_line)
    finally:
        for pool in pools.values():
            pool.close()
        shutil.rmtree(scratch, ignore_errors=True)
    torch.cuda.empty_cache()
    sched_line = scheduler_phase(gen)
    emit(sched_line)
    tiered_line = tiered_phase(gen, tp_line)
    emit(tiered_line)
    res_t0 = time.perf_counter() - res_wall
    res_parts.update(serving=resilience_serving(gen), tiers=resilience_tiers(gen),
                     row_blocks=resilience_row_blocks(gen))
    resilience_line = resilience_phase(res_parts, res_t0)
    emit(resilience_line)
    telemetry_line = telemetry_phase(gen)
    emit(telemetry_line)
    times = {"flex_fwd": fwd_t["flex_fwd"], "flex_fwd_hb": fwd_t["flex_fwd_hb"],
             "flex_dq": bwd_t["flex_dq"], "flex_dkv": bwd_t["flex_dkv"],
             "paged_decode": dec_t, **hetero_t}
    profiling_line = profiling_phase(prof_parts, cp_reuse_line, times,
                                     time.perf_counter() - prof_wall)
    emit(profiling_line)
    tuning_line = tuning_phase(gen, dec_t, tune_serving, sched_line, profiling_line,
                               time.perf_counter() - tune_wall)
    emit(tuning_line)
    instrument_line = instrument_phase(args.seed, gen_new, instr_cp_part, instr_scratch,
                                       time.perf_counter() - instr_wall)
    emit(instrument_line)
    fleet_line = fleet_phase(args.seed)  # resets the telemetry registry: no reader after it
    emit(fleet_line)

    # launches on the main paths: each path's counts were zeroed just before it
    by_path = {"serving": summary["launches"], "serving_mha": mha["launches"],
               "prefix": prefix_line["launches"], "training": train["launches"],
               "training_remat": train["remat"]["launches"],
               "hetero": hetero_line["launches"], "block_sparse": block_sparse_line["launches"],
               "sink": sink_line["launches"], "cp_attn": cp_attn_line["launches"],
               "cp_qo_attn": cp_qo_line["launches"], "cp_training": cp_train_line["launches"],
               "parallel_training": par_train_line["launches"],
               "dit": dit_line["launches"], "dit_cp": dit_line["cp_launches"],
               "cp_baselines": baselines_line["launches"],
               "cp_hier_attn": cp_hier_line["launches"],
               "cp_hier_training": cp_hier_train_line["launches"],
               "cp_xattn": cp_xattn_line["launches"],
               "cp_plan_reuse": cp_reuse_line["launches"],
               "cp_decode": cp_decode_line["launches"], "scheduler": sched_line["launches"],
               "tiered": tiered_line["launches"], "resilience": resilience_line["launches"],
               "telemetry": telemetry_line["launches"], "profiling": profiling_line["launches"],
               "tuning": tuning_line["launches"], "analysis": analysis_line["launches"],
               "fleet": fleet_line["launches"], "instrument": instrument_line["launches"],
               "wide_serving": wide_serving_line["launches"]}
    sources = {
        "flex_fwd": ("flex_fwd.cu", "magiattention_tpu/ops/flex_attn.py:543"),
        "flex_fwd_hb": ("flex_fwd_hb.cu", "magiattention_tpu/ops/flex_attn.py:388"),
        "flex_fwd_sparse": ("flex_fwd_sparse.cu", "magiattention_tpu/ops/flex_attn.py:772"),
        "flex_fwd_sparse_hb": ("flex_fwd_sparse_hb.cu", "magiattention_tpu/ops/flex_attn.py:938"),
        "flex_dq": ("flex_dq.cu", "magiattention_tpu/ops/flex_attn.py:1168"),
        "flex_dq_sparse": ("flex_dq_sparse.cu", "magiattention_tpu/ops/flex_attn.py:1127"),
        "flex_dkv": ("flex_dkv.cu", "magiattention_tpu/ops/flex_attn.py:1397"),
        "flex_dkv_sparse": ("flex_dkv_sparse.cu", "magiattention_tpu/ops/flex_attn.py:1347"),
        "paged_decode": ("decode.cu", "magiattention_tpu/serving/decode_attn.py:284"),
    }
    check(set(sources) == set(csrc.KERNELS), f"the kernels line misses {set(csrc.KERNELS) - set(sources)}")
    kernels = []
    for name, (src, replaces) in sources.items():
        paths = {p: n[name] for p, n in by_path.items() if n.get(name)}
        check(bool(paths), f"{name} was launched on no main path")
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"magiattention_tpu_torch/csrc/{src}", "replaces": replaces,
            "launches": sum(paths.values()), "launches_by_path": paths,
            "max_abs_err": MAX_ERR[name],
            **{k: times[name][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            # the same keys at this slice's new widths (narrow_timing): d 32 bf16, d 32 f32
            **({"at_new_widths": narrow_t[name]} if name in narrow_t else {}),
        })
    # every path's launches are in the line: a phase cannot launch unseen
    launched = {(p, n) for p, counts in by_path.items() for n, c in counts.items() if c}
    listed = {(p, k["name"]) for k in kernels for p in k["launches_by_path"]}
    check(launched == listed, f"launches missing from the kernels line: {launched - listed}")
    check(all(any(counts.values()) for counts in by_path.values()),
          f"a main path launched no kernel: {[p for p, c in by_path.items() if not any(c.values())]}")
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
