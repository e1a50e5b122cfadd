#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. the card (``nvidia-smi`` name and power limit) and the torch/CUDA versions;
  2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (nvcc):
     each kernel's registers and spill stores (``-Xptxas -v``), and the
     tensor-core instructions (HMMA, HGMMA) its SASS holds (``cuobjdump``);
     the bf16 flash kernel, the bf16-query int8-K/V flash kernel, the bf16
     MoE gate/up and down kernels (both routes) and the chunked WKV-6 kernel
     must hold some;
  3. each kernel at the serving path's shapes against its plain PyTorch
     version on the card, with its time (CUDA events, median of 25, L2
     flushed before each run), the plain version's time (median of 5), the
     ``F.scaled_dot_product_attention`` yardstick where one call computes the
     same function, and the least time the card could take (bytes over
     3.35 TB/s or operations over the peak rate of their type); then the
     tiles' edges, bf16 outputs to 2 bf16 ulps of each row: flash at
     lengths 1, 63, 65, 129 (and 100, 200, 77), windows of 8 and 100, GQA-8,
     10 over 1 and head dims 16 and 32, with bf16 K/V and with int8 K/V;
     decode (native and int8) at lengths
     around the split's chunk, 0 and 1, with windows starting inside a chunk;
     and phases 25-27's edges: head dim 64 (flash over bf16, int8 and
     float32 K/V; decode native, int8 and paged, bf16 and float32), GQA
     group 7 (56 over 8, 28 over 4, 14 over 2, 7 over 1), not causal with
     Sq != Skv (32, 1 and 77 rows against 1500 and 130) and Skv = 1500
     (whisper's encoder, and a decode over all 1500 frames);
  4. the smoke config in float32: greedy tokens from the plain path on the CPU
     and the kernel path on the card must be identical, native and int8 cache;
  5. deepseek-7b at its published size (30 layers, d_model 4096, bf16, random
     weights from seed 0): ``ServeSession.generate`` greedy at batch 8, prompt
     512, 64 new tokens, native and int8 KV cache, with the launch counters
     showing that every attention call went through the kernels.

Training (``repro_torch.launch.train``'s session: the demo fleet of 1 host
+ 2 CSD-class workers, tuned to 60 rows of which 24 are valid, AdamW, the
goyal schedule):
  6. the training path's kernels (flash attention, row quantizer, int8-K/V
     flash attention) at the full-width training shapes (Q/K/V (60, 256, 32,
     128) bf16) against their plain versions: the quantizer bit for bit at
     noise 0.5, at random noise and at a ragged row count, with the route
     ``quantize_plan`` names, then at its routes' edges (rows of 16, 24, 45
     and 300, R of 1 and ragged, views with unaligned bases, zero rows,
     denormals beside a huge value, .5 ties); times and bounds as in phase 3;
  7. the smoke config in float32: ``Session.run`` for 6 steps on the CPU
     (plain versions) and on the card (kernels) from the same weights, in
     ``f32`` and ``int8-fused``; per-step losses must agree;
  8. deepseek-7b at full width, depth cut 30 -> 8 layers (AdamW state of 30
     layers does not fit 80 GB), seq 256: ``Session.run`` for 4 steps in
     ``f32`` and in ``int8-fused``, with ms/step (the step alone, and the
     whole loop with the data plane's batch assembly), valid tokens/s, peak
     memory, finite losses and grad norms, and launch counters.

MoE serving (qwen3-moe-30b-a3b; the deepseek state is freed first):
  9. the MoE kernels at the path's shapes against their plain versions, with
     slot tables from ``moe_routing`` of random activations through a random
     router: the expert GEMM and the combine at the prefill shape (T 4096,
     C 384) and the decode shape (T 8, C 8), plus a capacity-overflow case
     (C 128), each with the route it took and the GEMM's gate/up and down
     kernels timed apart (``torch.profiler``), then the routes' edges (ragged
     f and d, one token, dbrx's widths, 300 experts; the combine on both
     routes and a token past MAX_K slots), and the flash and decode kernels
     (native and int8) at qwen3's GQA-8 shapes (32 query heads over 4 kv
     heads); times and bounds as in phase 3, the combine's yardstick
     ``index_add_`` over the kept rows, the GEMM's three products as
     ``torch.bmm`` on gathered rows as a note;
 10. both MoE smoke configs (qwen3-moe-30b-a3b, dbrx-132b) in float32: greedy
     tokens from the plain path on the CPU and the kernels on the card must be
     identical, native and int8 cache, every MoE layer through both kernels;
 11. qwen3-moe-30b-a3b at its published size (48 layers, not cut, bf16,
     random weights from seed 0): ``ServeSession.generate`` greedy at batch 8,
     prompt 512, 32 new tokens, native and int8 KV cache;
 12. profiles, after every timed run (a generate timed after the profiler ran
     measured slower decode steps): one training step per model of phases 8
     and 19 and precision (the recurrent models' in f32 only:
     PROFILE_F32_ONLY), the
     decode step of phase 5, the MoE decode step of phase 11, the
     recurrent decode steps of phase 15, a decode-only engine step of
     phase 22's cell (8 requests in 8 slots, native KV) and the native
     decode steps of phases 25-27
     (``torch.profiler``, device time by kind, busy ms, idle share; the MoE
     step split into matmul, attention, fused_moe, routing and other).

Recurrent serving (rwkv6-7b, recurrentgemma-2b; after the MoE state is freed):
 13. the WKV-6 and RG-LRU scan kernels at the prefill shapes (B 8, S 512;
     64 heads of 64 in bf16, lru width 2560 in f32) and at ragged smoke-size
     shapes, and the flash (S 3072, window 2048) and decode (2048-row cache,
     native and int8) kernels at recurrentgemma's 10 query heads over one kv
     head of 256, against their plain versions (the RG-LRU scan bit for
     bit); times and bounds as in phase 3; then WKV-6 cases of their own
     (bf16 at S 45 and 300, not multiples of the chunked kernel's 16 steps,
     bf16 at head dim 16, decays near 1e-30 and near 1) and RG-LRU cases of
     its own, bit for bit (S 1, 45, 300 and 513, not multiples of its
     32-step tiles; W 300 and 33; B 1; decays of exactly 1.0 and near 0);
 14. both recurrent smoke configs in float32 (recurrentgemma with native and
     int8 cache, prompt 13 > its window 8): greedy tokens from the plain path
     on the CPU and the kernels on the card must be identical, through
     ``ServeSession.generate`` and through the batched route
     (``make_prefill_step`` then ``make_serve_step``); on the card the
     batched prefill's cache must equal the stepped prefill's leaf for leaf;
 15. both configs at their published size (random weights from seed 0),
     the batched route at batch 8, prompt 512, 64 greedy steps (rwkv6-7b;
     recurrentgemma-2b native and int8), and recurrentgemma-2b at prompt 3072
     (longer than its window) with 16 steps: prefill ms, decode ms/step,
     tok/s, peak memory, launches of every kernel per prefill and step;
 16. ``ServeSession.generate`` at full width over the first half of the
     layers (native, batch 8, prompt 512, 64 new tokens; the whole depth
     until phase 36 came), the reference's own recurrent route (the prompt
     stepped through ``decode_step``): its prefill ms beside the batched
     one; then
     the largest difference between the two routes' states, a reading, at
     prompt 64 (cut from 512 to keep the run near 5 minutes, from 128 when
     phase 36 came) in bf16 and
     in float32.

Recurrent training (``launch/train.py``'s session, as phases 6-8):
 17. the path's kernels at its full-width shapes against their plain
     versions: the WKV-6 scan, float and int8 r/k/v (60 rows, seq 256, 64
     heads of 64, bf16), the RG-LRU scan, float and int8 x, bit for bit (60
     rows, seq 128, width 2560, f32), the quantizer bit for bit at the
     path's rows (2560 f32, recurrentgemma's RG-LRU input; 64 bf16,
     rwkv6-7b's r/k/v; 256 bf16, recurrentgemma's K/V), flash attention
     with float and int8 K/V at D = 256 (10 query heads over one kv head,
     window 2048) and at D = 32, each also at a ragged smoke-size shape, and
     the WKV-6 and RG-LRU cases of phase 13 for both entries;
     then the gradients of ``ops.rwkv6_scan``,
     ``rwkv6_scan_q8``, ``rglru_scan``, ``rglru_scan_q8`` and
     ``flash_attention_q8`` (D = 256) on the card against the plain ops'
     autograd gradients, for every input, at 4 rows; times and bounds as in
     phase 3;
 18. both recurrent smoke configs in float32, as phase 7: ``Session.run`` for
     6 steps on the CPU and on the card in ``f32`` and ``int8-fused``;
     per-step losses agree, and the launch counters show every scan and
     attention call (the remat recompute included) went through its kernel;
 19. rwkv6-7b (4 of 32 layers, seq 256) and recurrentgemma-2b (26 layers,
     seq 128) at full width: ``Session.run`` for 4 steps in ``f32`` and
     ``int8-fused``, reported as phase 8.  Phase 12 profiles one step of
     each.

The serve engine (``repro_torch.serve.ServeEngine``: continuous batching,
chunked prefill stepped through ``decode_step``, a prefix cache over a page
pool; after recurrent training):
 20. the paged decode kernels, native and int8, against their plain versions
     and, bit for bit, against the contiguous decode kernel on the gathered
     rows: at deepseek-7b's shape (B 8, 32 heads of 128, pages of 8, 577-row
     tables over a scattered pool, ragged valid lengths incl. 0 and 1; f32
     and bf16), qwen3's GQA-8 (32 heads over 4), a window of 256, ragged
     smoke-size cases with pages of 16 (D 32, 16, 256), three rows
     sharing their first pages, and lengths around the decode split's chunk
     (0, 1, chunk - 1, chunk, chunk + 1; windows starting inside a chunk;
     pages of 8 and 16); times and bounds as in phase 3, the contiguous
     kernel's time on the same rows beside them;
 21. ServeEngine on the smoke configs (dense, both MoE, rwkv6, recurrentgemma;
     f32; tests/test_serve_engine.py's engine config): greedy tokens from the
     plain path on the CPU and the kernels on the card identical, native and
     int8 cache, and equal to ``ServeSession.generate``'s on the card where
     both routes agree by construction (native cache, or recurrentgemma
     whose generate also steps its prompt: with an int8 cache the two
     prefill routes may round K/V to different int8 rows, and the
     reference's own engine and generate part at qwen3-moe);
     ``benchmarks/serve_smoke.py``'s three checks (admit mid-decode, prefix
     cache hit, streaming order) on the card; a masked decode step keeps an
     inactive slot's cache bit for bit;
 22. deepseek-7b at its published width, 15 of its 30 layers
     (ENGINE_FULL_LAYERS; 30 until phase 36 came), bf16, seed-0 weights,
     through ``run_load``: 12 requests submitted at once, prompt 64 of which
     32 are a shared prefix, 32 greedy tokens, 8 slots of 128 rows, a pool of
     128 blocks of 8, chunks of 16 under a budget of 64, native and int8 KV:
     the load report (wall, req/s, tok/s, latency and TTFT p50/p99, steps,
     prefix hit rate; a smoke reading, not a cell: the lengths are set, not
     drawn from a trace, and a p99 of 12 requests is their maximum), peak
     memory, launches, the share of tokens equal to
     ``generate``'s (a reading); then the paged kernels over the engine's own
     pool and block tables for every layer, against the contiguous kernel on
     the same rows gathered and the plain version.  The engine's own decode
     runs the contiguous kernel over its slots, as the reference's does, so
     the paged launches of this path are those of the pool check.

Checkpoint / restart and elastic replanning (``Session.run`` with a
``checkpoint_dir``, ``Session.apply``; after the engine, before the profiles):
 23. deepseek-7b at full width cut to 2 layers (1.244 B params: bf16 params
     and f32 AdamW state are a 12.4 GB checkpoint), seq 256, f32, the demo
     fleet, in a temporary directory removed at the end (short disk fails):
     S0 trains 6 steps and saves once, synchronously; S1 (checkpoint every
     3, async) trains 3; its checkpoint, restored with every CRC checked,
     equals S1's state bit for bit; S2 (S1's config and directory) resumes at
     step 3: its first batch is S0's fourth and its losses and grad norms at
     steps 4-6 equal S0's to rtol 1e-6 (and whether bit-equal); checkpoint
     bytes, free disk, sync save s, the async save's snapshot ms against the
     step's ms, the background write s and restore s;
 24. 2 steps, ``WorkerLost(["csd/1"])``, 2 steps, ``WorkerJoined("csd", 1)``,
     2 steps, params and optimizer state carried across: the smoke config on
     the CPU and on the card from the same weights in f32 and int8-fused
     (losses within phase 7's tolerances, the step rebuilt exactly when the
     rows change, as the reference rebuilds it, no private shard re-homed,
     launches of 6 steps), then phase 23's model in int8-fused on the card,
     step ms before and after each event.

The five remaining configs (after phase 24, before the profiles; each freed
before the next is built, its predicted peak printed before its weights):
 before 25, phase 3's kernel checks at phases 25-27's shapes (flash at
     deepseek-coder-33b's GQA-7 prefill, whisper's encoder, cross and self
     prefill, qwen2-vl-7b's GQA-7 prefill over 1536 rows; decode native and
     int8 at the coder's 577 rows, whisper's self (97 rows) and cross (1500
     frames) and the VL's 1601 rows), then the five smoke configs in
     float32, as phase 4: greedy tokens from the plain path on the CPU and
     the kernels on the card identical, native and int8 cache;
 25. ``families_serving``: qwen1.5-4b, minitron-8b and deepseek-coder-33b at
     their published sizes (bf16, seed-0 weights; the coder's 33.3 B params
     are 62.1 GiB) through ``ServeSession.generate``, batch 8, prompt 512,
     32 greedy tokens, native and int8 KV, as phase 5;
 26. ``encdec_serving``: whisper-medium (24 + 24 layers, head dim 64) over
     1500 stub frames drawn from the seed, prompt 32, 32 greedy tokens
     through ``ServeSession.generate(..., frames=)``, native cache and the
     8-leaf int8 cache (quantized cross K/V);
 27. ``vlm_serving``: qwen2-vl-7b over 1024 stub patch embeddings and 512
     text tokens through ``ServeSession.generate(..., patch_embeds=)``, 32
     greedy tokens, native and int8;
 each prints prefill ms, decode ms/step, peak GiB and launch counts (every
 attention call through the kernels), and its seconds beside its budget.

Training the MoE, encoder-decoder and vision-language families (after
phase 27, before the profiles; each run's predicted peak printed before its
weights, each freed before the next is built):
 before 28, phase 3's kernel checks at phases 28-30's training shapes (flash
     and int8-K/V flash at qwen3-moe's (60, 256, 32 over 4, 128), whisper's
     encoder (16, 1500, 16, 64) and self-attention (16, 256), qwen2-vl's
     (8, 1536, 28 over 4, 128); flash at whisper's cross-attention, 256 rows
     against 1500 frames; the quantizer over their K rows; the expert GEMM
     and the combine at T 15,360 / C 1,280), phase 17's gradient check for
     ``ops.fused_moe_mlp`` at 4 rows with the aux loss in the cotangent (and
     the aux loss's own router gradient non-zero), then the four smoke
     configs in float32, CPU vs card, f32 and int8-fused, as phase 7: both
     MoE configs for 6 steps through ``Session.run``, whisper and qwen2-vl
     for 3 steps through ``make_train_step`` with frames / patch embeddings
     (SGD, from fan-in weights: ``cross_device_family_train`` says why);
 28. ``moe_training``: qwen3-moe-30b-a3b at full width, depth cut 48 -> 3
     layers, seq 256, through ``Session.run`` on the demo fleet (60 rows,
     24 valid), as phase 8, with each step's router aux loss (non-zero);
 29. ``encdec_training``: whisper-medium at full depth and width through
     ``make_train_step``, 16 rows of 256 decoder tokens over 1500 stub
     frames from the seed, as phase 8;
 30. ``vlm_training``: qwen2-vl-7b at full width, depth cut 28 -> 8 layers,
     through ``make_train_step``, 8 rows of 1024 stub patches + 512 text
     tokens (the loss scores the text), as phase 8.
 Phase 12 profiles one f32 step of each of phases 28-30 (the largest
 "other" kernels named), phase 28's routing split out and the plain MoE
 backward of one layer timed on CUDA events.

Multi-process cluster training, hostsync (after phase 30, before the
profiles):
 before 31, the row quantizer at the int8 codec's shapes (phase 31's two
     bucket vectors as rows of 512 f32, 1,609,760 and 819,208 rows, and a
     ragged vector's zero-padded last row) at noise 0.5, bit for bit and
     timed beside its byte bound; the codec on the card against the codec
     on the CPU (payload bytes and residuals, two steps, a ragged length);
     flash at a worker's (20, 256, 32, 128);
 31. ``cluster_training``: deepseek-7b at full width, 2 of 30 layers, seq
     256, FleetSpec.demo(3) (40 rows, 20 a worker) through a single-process
     card Session for 3 steps, then through 2 worker processes sharing the
     card (``ClusterCoordinator``) under ``TransportSpec.production()``
     (int8, ring, 2 buckets, overlap): equal replica digests, the step-1
     loss equal to the single process's at rtol 1e-5, steps 2-3 within
     1e-2, each worker's launches (the quantizer once a bucket a step),
     ms a step and its split, wire bytes, compression ratio, predicted and
     measured peaks; card memory and the host's MemAvailable printed before
     the launch; the kernels line's launches are the two workers' sums;
 32. the smoke config through 2 worker processes under ``TransportSpec()``
     (star, no compression) against the single-process card Session:
     losses at rtol 1e-5, equal digests.

The measured tune, the serving example and the dry run (after phase 32,
before the profiles):
 33. ``measured_tune``: ``train_session_factory(measured_tune=True)`` at
     phase 8's cell (deepseek-7b, 8 of 30 layers, seq 256), the driver's
     fleet with the host capped at TUNE_HOST_CAP rows, in f32 and
     int8-fused: every timed (class, batch, ms), the tuned batches, margin
     and reference class, the tune's weights released, then 3 steps of
     ``Session.run`` at the tuned plan (ms a step, peak against
     ``predicted_train_peak_gib`` and the dry run's trace of the same step,
     the roofline fraction: 6 N seq x the valid rows over 989e12 FLOP/s x
     the step, N without the embedding table, and beside it the fraction
     with the table counted and over every row, padding included);
     launches counted from before the tune to after the run, then flash,
     the quantizer and the int8-K/V flash kernel at the plan's rows.
     ``repro_torch.examples.serve_batched``'s flow on every arch's smoke
     config: the card's greedy tokens equal the CPU's, each family's
     kernels launched;
 34. the dry run's memory model: deepseek-7b's train_4k (4 rows, 2
     layers), prefill_32k (batch 1) and decode_32k (batch 2), each cut
     printed: ``launch/dryrun.py``'s predicted peak (a meta-device trace)
     against ``torch.cuda.max_memory_allocated`` around the same step on
     the card, within 10% or 2 GiB, the larger; finite outputs.  The
     40-cell table is ``python -m repro_torch.launch.dryrun --out`` (no
     card: meta tensors).

Data-parallel training over ``torch.distributed`` (after phase 34, before
the profiles):
 35. ``spmd_training``: phase 31's cell (deepseek-7b, 2 of 30 layers, seq
     256, FleetSpec.demo(3)'s 40 rows, f32, AdamW, 3 steps) through the
     ``spmd`` worker path (``WorkerRuntime`` with mode ``spmd``: the
     launch/train.py factory, ``Session.shard()`` on the ``DeviceMesh``,
     ``make_spmd_train_step``) as the one rank of an NCCL group on the card
     (the card's machine has one card, and NCCL puts no two ranks on one):
     the backend, world size, mesh, ``plan.describe()``, the fed span's
     ``FeedReceipt``, ms a step and its split, flash launches against the
     expected count, the losses against the single-process card Session's
     of phase 31 at rtol 1e-6 (the largest gap printed); then
     ``compressed_allreduce`` on the phase's first 64 MiB gradient bucket
     (seed-0 weights, the first batch: 256 rows of 65,536 f32, the
     quantizer's ``scalar`` route) as a path of its own,
     ``compressed_allreduce`` (the spmd step sums with ``dist.all_reduce``
     and never calls it), its counts set to 0 just before that one call and
     read just after; then ``ring_allreduce``, ``hierarchical_allreduce`` and
     ``pipeline_apply`` at n = 1 (equal to their input, or to ``stage_fn``),
     the kernel's ``(q, scale)`` at the bucket's shape bit-equal to the
     plain quantizer's, both timed beside the byte bound, the compressed
     allreduce's time, and flash at a rank's (40, 256, 32, 128).  Its lap
     is printed beside SPMD_BUDGET_S.

ZeRO-3 over the data axis (after phase 35, before the profiles):
 36. ``zero3_training``: phase 31's cell under its published ``fsdp=True``
     (every leaf but the norms carries ``embed``) through 2 ``spmd`` ranks
     that share the card (``ClusterCoordinator`` with mode ``spmd`` and
     ``backend="gloo"``: NCCL puts no two ranks on one card; gloo takes the
     card's tensors), 20 rows a rank: each rank holds and updates only its
     shards, gathers a layer's weights where it runs and gets their
     gradients reduce-scattered.  Held: the step-1 loss against phase 31's
     single-process card Session at SPMD_RTOL and steps 2-3 at
     ZERO3_LATER_RTOL (the ranks' bf16 partial gradients); the losses and
     the parameters against the same arithmetic in this one process
     (``world2_reference``: each batch's two halves, their partial
     gradients summed in f32 and rounded to bf16) at SPMD_RTOL and digest
     for digest; the gathered parameters' digests equal on both ranks; each
     rank's resident parameter and moment bytes exactly the sum of its
     shard shapes' bytes; flash launched as phase 8's count (the kernel is
     held to its plain version at this 20-row shape in phase 31's checks,
     whose record the kernels line repeats for this path).  Printed: each
     rank's peak beside phase 31's replicated worker's, ms a step and its
     split (grad with the gathers and reduce-scatters, reduce, apply) and
     wire bytes a step by kind.  Its lap is printed beside ZERO3_BUDGET_S.

Tensor and expert parallelism over the model axis (after phase 36, before the
profiles): two ranks that share the card over ``gloo`` (each ``chip_smoke.py
--rank PHASE RANK DIR``: NCCL puts no two ranks on one card), mesh ``data 1 x
model 2`` (``make_host_mesh``), ``build_sharding_plan``, ``init_rank_params``
(each leaf drawn whole, the rank's piece kept) and
``make_spmd_train_step(plan=)``, the launch counts set to 0 just before the
steps and read just after:
 37. ``tp_training``: phase 31's cell (deepseek-7b, 2 of 30 layers, seq 256,
     its 40 rows on each rank, its batches, weights and schedule, AdamW,
     TP_STEPS steps): a rank holds 16 query heads, 5,504 FFN columns and
     51,200 vocabulary rows.  Held: the step-1 loss and gradient norm
     against phase 31's single process at TP_LOSS_RTOL and TP_GNORM_RTOL;
     the two ranks' losses equal; the digests of the leaves replicated over
     ``model`` equal; each rank's resident parameter and moment bytes
     exactly the sum of its pieces' shapes' bytes; flash launched as phase
     8's count, at 16 over 16 heads; the step's collectives equal
     ``roofline.collectives.tp_step_ops`` op for op; flash at a rank's
     (40, 256, 16, 128) against its plain version.  Printed: ms a step and
     its split, each rank's peak, wire bytes a step by kind beside the
     closed form's.  Its lap is printed beside TP_BUDGET_S.
 38. ``ep_training``: dbrx-132b at full width cut to 1 of 40 layers, 8 rows x
     256 seeded tokens, AdamW, EP_STEPS steps: the one-process fused path's
     forward and backward on the whole seed-0 weights first (then freed), then
     the two ranks, each holding 8 of 16 experts, 24 query heads over 4 KV
     heads and 50,176 vocabulary rows.  Held as phase 37, step 1 against the
     one-process fused path; the expert GEMM and combine launched on each
     rank at E 8, C 640, d 6,144, f 10,752 (the group-local EP layer) and held
     there to their plain versions on a rank's slot tables of the whole
     routing; flash at a rank's (8, 256, 24 over 4, 128).  Its lap is printed
     beside EP_BUDGET_S.
 39. ``tp_family_training("tpr")``, the ``tp_recurrent_training`` path
     (``--rank tpr``, TP_FAMILY_CELLS): rwkv6-7b at full width cut to 2 of 32
     layers, 8 rows x 256, f32, and recurrentgemma-2b cut to 3 of 26 layers
     (R, R, A), 8 rows x 256, once in f32 and once in int8-fused; AdamW,
     TP_STEPS steps a cell, bf16 weights from seed 0 with the block
     matrices redrawn at their fan-in; each cell's one process on the card
     first (forward and backward on the whole weights, then freed).  A
     rwkv6 rank holds 32 of 64 heads (the WKV scan at (8, 256, 32, 64)), a
     recurrentgemma rank 1,280 of 2,560 RG-LRU channels (its int8 scan
     quantized with the whole row's scale) and 5 of 10 query heads over the
     one KV head.  Held as phase 38, per cell: step 1 against the one
     process, the ranks' losses and replicated digests equal, resident
     bytes, launches, flash and scan shapes, the collectives equal
     ``tp_step_ops`` op for op; then the WKV-6, RG-LRU, quantizer and flash
     kernels at a rank's shapes against their plain versions.
 40. ``tp_family_training("tpe")``, the ``tp_encdec_vlm_training`` path:
     whisper-medium at full width, 4 of 24 encoder and 4 of 24 decoder
     layers, 4 rows x 256 tokens over 1,500 frames, and qwen2-vl-7b cut to 2
     of 28 layers, 2 rows x (1,024 patches + 512 tokens), f32, held as
     phase 39; flash at a rank's whisper encoder, decoder and cross shapes
     (8 of 16 heads) and qwen2-vl's (14 over 2 heads) against its plain
     version beside SDPA.  Laps beside TP_FAMILY_BUDGET_S.

Serving under the model axis (after phase 40, before the profiles), the same
two ranks and mesh (``chip_smoke.py --rank tsd|tsf``), each rank under
``sharding.use_mesh`` on its pieces of the weights (``init_rank_params``,
then ``_serve_fan_in``: every block matrix redrawn at its fan-in); each cell
served first by one process on the card, the yardstick (a bf16 cell then
again with the same weights in float32: the yardstick of bf16's own
rounding), whose weights are then freed (TS_CELLS: each arch at full width
in bf16, batch 8, 4 greedy tokens, and cut to 4 layers in float32, batch 4,
8 greedy tokens):
 41. ``tp_serving("tsd")``, the ``tp_serving_dense_moe`` path: deepseek-7b
     (30 layers, native and int8 K/V) and qwen3-moe-30b-a3b (24 of 48 layers:
     the one process and then the two ranks each fit the card) through
     ``ServeSession.generate`` at batch 8, prompt 128: a rank serves 16 of 32
     heads, the MoE layer's 64 of 128 experts (the group-local EP path).
 42. ``tp_serving("tsf")``, the ``tp_serving_families`` path:
     rwkv6-7b and recurrentgemma-2b through the batched route
     (``make_prefill_step`` at prompt 128, then ``make_serve_step``) and
     ``generate``'s stepped prefill at prompt 4 (float32: 8); whisper-medium (prompt 32
     over 1,500 stub frames) and qwen2-vl-7b (256 stub patches + 128 tokens)
     through ``generate``.
     Held a cell: the two ranks' tokens and logits equal; each main-path
     run's launches (counts set to 0 just before it, read just after) every
     kernel's expected count (``_ts_launches``), in the one process and on
     each rank; each cache leaf's bytes, of ``init_cache`` and of the
     prefill, its ``Layout.local`` shape's; the collectives ``tp_serve_ops``
     op for op; the whole prefill's and N teacher-forced decode steps'
     logits (fed the one process's tokens, from the main path's own prefill
     cache) within TS_LOGIT_SHARE of the one process's largest |logit| in a
     float32 cell (TS_INT8_LOGIT_SHARE over an int8 cache) and within
     TS_BF16_GAP times the one process's own bf16-against-float32 gap in a
     bf16 cell; the first tokens the one process's (bf16: where its own
     rounding changes none of its greedy tokens); int8 K/V bytes within TS_INT8_LSB of the one
     process's at the rank's heads at the prompt's rows, every layer in
     float32, the first in bf16 (a later layer's input carries the bf16
     rounding of the ranks' partial sums; every layer's byte counts are
     printed).  Printed: prefill ms, decode ms a step and peak a rank.  Then
     each kernel at a rank's bf16 serving shapes against its plain version
     (``ts_kernel_records``), its launches the bf16 cells' main-path runs'
     on both ranks.  Laps beside TS_BUDGET_S.

Each record of the kernels line carries the main path (``serving``,
``training``, ``moe_serving``, ``recurrent_serving``, ``recurrent_training``,
``engine_serving``, ``families_serving``, ``encdec_serving``,
``vlm_serving``, ``moe_training``, ``encdec_training``, ``vlm_training``,
``cluster_training``, ``measured_tune``, ``spmd_training``,
``compressed_allreduce``, ``zero3_training``, ``tp_training``,
``ep_training``, ``tp_recurrent_training``, ``tp_encdec_vlm_training``,
``tp_serving_dense_moe`` or ``tp_serving_families``)
whose shapes it was
timed at and whose launches it counts, and a ``shape`` where one path times a
kernel at two or where its shape is not the path's first.
The last two lines are ``{"kernels": [...]}`` and
``{"ok": true, "device": {...}}``.  Without a card, or without the port's
sources beside this file, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
if (ROOT / "src" / "repro_torch").is_dir():        # else main() fails before any phase
    sys.path.insert(0, str(ROOT / "src"))
    # the card's peaks (device.py, re-exported by launch/mesh.py) and the kernels' bound formulas
    from repro_torch.roofline.cost import attention_ops, bound, wkv6_ops
    from repro_torch.examples.serve_batched import generate_batched
N_TIMED = 25
N_PLAIN = 5
MOE_KERNELS = ("moe_gate_up_kernel", "moe_down_kernel", "moe_gate_up_tc_kernel",
               "moe_down_tc_kernel", "moe_gate_up_skinny_kernel", "moe_down_skinny_kernel",
               "moe_invert_kernel", "moe_combine_kernel", "moe_combine_scan_kernel")
# the kernels that must run on the tensor cores (phase 2)
TENSOR_CORE_KERNELS = (("flash_fwd_tc_kernel", "flash_fwd_int8_tc_kernel") + MOE_KERNELS[2:6]
                       + ("wkv6_chunk_kernel",))
# the MoE routing's top-k, stable sort, slot scatters, count scan and softmax
# (its elementwise ops fall in "other")
ROUTING_KERNELS = ("sort", "topk", "scan", "scatter", "softmax")


def fail(msg: str) -> int:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    return 1


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def timed_ms(fn, flush, runs: int = N_TIMED) -> float:
    """Median device time of ``fn()`` over ``runs`` runs, L2 flushed before each."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        flush()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def timed_plain(fn, flush) -> float:
    """A plain version's median device time, over N_PLAIN runs: they take
    0.1-90 ms a call, where 25 runs cost the script ~14 s and a median of 5
    spreads little."""
    return timed_ms(fn, flush, N_PLAIN)


def kernel_ms(torch, fn, flush, groups):
    """Device ms per call of ``fn()`` spent in each group of kernels (``{label:
    name substrings}``), from ``torch.profiler`` over N_TIMED calls, L2 flushed
    before each: the mean; None where the profiler saw no such kernel."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(N_TIMED):
            flush()
            fn()
        torch.cuda.synchronize()
    sums = {label: None for label in groups}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for label, names in groups.items():
            if any(n in e.name for n in names):
                sums[label] = (sums[label] or 0.0) + (e.time_range.end - e.time_range.start)
    return {k: (None if v is None else v / N_TIMED / 1e3) for k, v in sums.items()}


def build_report(log: str):
    """One line per source and per compiled kernel (nvcc's ``-Xptxas -v``
    log): the kernel, its registers and its spill stores."""
    lines, name, spill = [], "?", "?"
    for line in log.splitlines():
        if line.startswith("=="):
            lines.append(line.strip())
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m:
            lines.append(f"{name}: {m.group(1)} registers, {spill} bytes spill stores")
    mangled = sorted({w for ln in lines for w in re.findall(r"_Z\w+", ln)})
    if mangled and shutil.which("c++filt"):
        plain = subprocess.run(["c++filt"], input="\n".join(mangled), capture_output=True,
                               text=True, timeout=60).stdout.splitlines()
        short = (n.replace("(anonymous namespace)::", "").removeprefix("void ").split("(")[0]
                 for n in plain)
        names = dict(zip(mangled, short))
        lines = [re.sub(r"_Z\w+", lambda m: names.get(m.group(0), m.group(0)), ln)
                 for ln in lines]
    return lines


def sass_report(lib_dir: Path, nvcc: str):
    """Tensor-core instructions in each compiled kernel's SASS
    (``cuobjdump --dump-sass`` on the built libraries): ``{kernel: (HMMA,
    HGMMA)}`` with demangled, shortened names."""
    cuobjdump = str(Path(nvcc).parent / "cuobjdump")
    counts = {}
    for lib in sorted(lib_dir.glob("lib*.so")):
        sass = subprocess.run([cuobjdump, "--dump-sass", str(lib)], check=True,
                              capture_output=True, text=True, timeout=300).stdout
        name = None
        for line in sass.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                name = m.group(1)
                counts[name] = [0, 0]
            elif name is not None:
                counts[name][0] += len(re.findall(r"\bHMMA\.", line))
                counts[name][1] += len(re.findall(r"\bHGMMA\.", line))
    mangled = sorted(counts)
    short = mangled
    if mangled and shutil.which("c++filt"):
        plain = subprocess.run(["c++filt"], input="\n".join(mangled), capture_output=True,
                               text=True, timeout=60).stdout.splitlines()
        short = [n.replace("(anonymous namespace)::", "").removeprefix("void ").split("(")[0]
                 for n in plain]
    return {s: tuple(counts[m]) for s, m in zip(short, mangled)}


def kernel_checks(torch, ops, R, F, dev):
    """Phase 3: every kernel against its plain version at the main path's shapes."""
    from repro_torch.kernels.decode_attention import decode_attention, decode_attention_int8
    from repro_torch.kernels.flash_attention import flash_attention_fwd

    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    scratch = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    flush = scratch.zero_
    B, S, H, D, CACHE = 8, 512, 32, 128, 577
    valid = torch.tensor([576, 1, 300, 513, 576, 0, 450, 520], dtype=torch.int32, device=dev)
    rows = int(valid.sum())
    tol = {torch.bfloat16: 2e-2, torch.float32: 1e-4}   # bf16 output rounding; f32 reassociation
    records = []

    def rand(*shape, dtype):
        return torch.randn(*shape, generator=gen, device=dev, dtype=torch.float32).to(dtype)

    def check(name, kernel, plain, dtype):
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        ok = math.isfinite(err) and err <= tol[dtype]
        print(f"[check] {name} {str(dtype).split('.')[-1]}: max_abs_err={err:.3e} "
              f"tol={tol[dtype]:.0e} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version: {err} > {tol[dtype]}")
        return err

    for dtype in (torch.float32, torch.bfloat16):
        # -- flash attention: prefill, causal, MHA --------------------------------
        q, k, v = (rand(B, S, H, D, dtype=dtype) for _ in range(3))
        err = check("flash_attention", lambda: flash_attention_fwd(q, k, v, causal=True),
                    lambda: R.flash_attention_ref(q, k, v, causal=True), dtype)
        if dtype == torch.bfloat16:
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            flops = 4 * D * B * H * S * (S + 1) // 2
            nbytes = 4 * q.numel() * q.element_size()
            b_ms, b_by = bound(nbytes, flops, "bfloat16")
            records.append(dict(
                name="flash_attention", path="serving", route="cuda",
                source="src/repro_torch/kernels/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention.py:133",
                launches=0, max_abs_err=err,
                ms=timed_ms(lambda: flash_attention_fwd(q, k, v, causal=True), flush),
                plain_ms=timed_plain(lambda: R.flash_attention_ref(q, k, v, causal=True), flush),
                bound_ms=b_ms, bound_by=b_by,
                library_ms=timed_ms(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True), flush),
            ))
        del q, k, v

        # -- decode attention, native cache ---------------------------------------
        q = rand(B, 1, H, D, dtype=dtype)
        kc, vc = rand(B, CACHE, H, D, dtype=dtype), rand(B, CACHE, H, D, dtype=dtype)
        err = check("decode_attention", lambda: decode_attention(q, kc, vc, valid),
                    lambda: R.decode_attention_ref(q, kc, vc, valid), dtype)
        if dtype == torch.bfloat16:
            mask = (torch.arange(CACHE, device=dev)[None, :] < valid[:, None])[:, None, None, :]
            qt, kt, vt = q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2)
            esz = kc.element_size()
            nbytes = 2 * rows * H * D * esz + 2 * q.numel() * esz + valid.numel() * 4
            b_ms, b_by = bound(nbytes, 4 * D * H * rows, "bfloat16")
            records.append(dict(
                name="decode_attention", path="serving", route="cuda",
                source="src/repro_torch/kernels/csrc/decode_attention.cu",
                replaces="src/repro/kernels/decode_attention.py:327",
                launches=0, max_abs_err=err,
                ms=timed_ms(lambda: decode_attention(q, kc, vc, valid), flush),
                plain_ms=timed_plain(lambda: R.decode_attention_ref(q, kc, vc, valid), flush),
                bound_ms=b_ms, bound_by=b_by,
                # valid_len 0 rows give NaN here (all masked); timing only
                library_ms=timed_ms(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask), flush),
            ))

        # -- decode attention, int8 cache -----------------------------------------
        kq, ks = R.quantize_int8_ref(kc)
        vq, vs = R.quantize_int8_ref(vc)
        del kc, vc
        err = check("decode_attention_int8",
                    lambda: decode_attention_int8(q, kq, ks, vq, vs, valid),
                    lambda: R.decode_attention_int8_ref(q, kq, ks, vq, vs, valid), dtype)
        if dtype == torch.bfloat16:
            nbytes = 2 * rows * H * (D + 4) + 2 * q.numel() * q.element_size() + valid.numel() * 4
            b_ms, b_by = bound(nbytes, 4 * D * H * rows, "bfloat16")
            records.append(dict(
                name="decode_attention_int8", path="serving", route="cuda",
                source="src/repro_torch/kernels/csrc/decode_attention.cu",
                replaces="src/repro/kernels/decode_attention.py:378",
                launches=0, max_abs_err=err,
                ms=timed_ms(lambda: decode_attention_int8(q, kq, ks, vq, vs, valid), flush),
                plain_ms=timed_plain(
                    lambda: R.decode_attention_int8_ref(q, kq, ks, vq, vs, valid), flush),
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
            ))
        del q, kq, ks, vq, vs
    del scratch
    for rec in records:
        print(json.dumps(rec))
    return records


def tile_edge_checks(torch, R, dev):
    """Phase 3, the tiles' edges: the bf16 flash kernel, over bf16 and over
    int8 K/V, at lengths that are not a multiple of its tiles, windows that
    end inside a tile, GQA-8, 10-over-1 and every head dim; the decode
    kernels at lengths around the
    split's chunk, 0 and 1, and a window that starts inside a chunk; each
    against its plain version, bf16 outputs to 2 bf16 ulps of each row."""
    from repro_torch.kernels.decode_attention import (
        chunk_rows, decode_attention, decode_attention_int8,
    )
    from repro_torch.kernels.flash_attention import flash_attention_fwd, flash_attention_int8_fwd

    gen = torch.Generator(device=dev)
    gen.manual_seed(77)
    bf16 = torch.bfloat16

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(bf16)

    # B, S, H, Hkv, D, causal, window
    flash_cases = [(2, S, 4, 4, 128, True, None) for S in (1, 63, 65, 129)]
    flash_cases += [(2, 200, 4, 4, 128, True, 8), (2, 200, 4, 4, 128, True, 100),
                    (2, 129, 32, 4, 128, True, None), (2, 129, 10, 1, 256, True, 100),
                    (3, 65, 4, 2, 16, True, None), (3, 65, 4, 2, 32, True, 8),
                    (2, 100, 8, 8, 128, False, None), (2, 77, 10, 1, 256, False, 8)]
    for B, S, H, Hkv, D, causal, window in flash_cases:
        q, k, v = randn(B, S, H, D), randn(B, S, Hkv, D), randn(B, S, Hkv, D)
        tag = f"S={S} H={H}/{Hkv} D={D} causal={causal} window={window} bf16"
        row_ulp_check(torch, f"flash_attention edge {tag}",
                      flash_attention_fwd(q, k, v, causal=causal, window=window),
                      R.flash_attention_ref(q, k, v, causal=causal, window=window))
        # the same cases over int8 K/V (the bf16-query tensor-core route)
        (kq, ks), (vq, vs) = R.quantize_int8_ref(k), R.quantize_int8_ref(v)
        row_ulp_check(torch, f"flash_attention_q8 edge {tag}",
                      flash_attention_int8_fwd(q, kq, ks, vq, vs, causal=causal, window=window),
                      R.flash_attention_ref(q, R.dequantize_int8_ref(kq, ks),
                                            R.dequantize_int8_ref(vq, vs), causal=causal,
                                            window=window))
    for H, Hkv, D in ((32, 4, 128), (10, 1, 256), (32, 32, 128), (4, 2, 16), (4, 1, 32)):
        ch = chunk_rows(D, bf16)
        rows = 2 * ch + 8
        valid = torch.tensor([ch - 1, ch, ch + 1, 0, 1, ch + ch // 2, rows, 2 * ch + 1],
                             dtype=torch.int32, device=dev)
        q = randn(8, 1, H, D)
        k, v = randn(8, rows, Hkv, D), randn(8, rows, Hkv, D)
        (kq, ks), (vq, vs) = R.quantize_int8_ref(k), R.quantize_int8_ref(v)
        for window in (None, 100, 20):
            tag = f"H={H}/{Hkv} D={D} valid {valid.tolist()} window={window} bf16"
            row_ulp_check(torch, f"decode_attention edge {tag}",
                          decode_attention(q, k, v, valid, window=window),
                          R.decode_attention_ref(q, k, v, valid, window=window))
            row_ulp_check(torch, f"decode_attention_int8 edge {tag}",
                          decode_attention_int8(q, kq, ks, vq, vs, valid, window=window),
                          R.decode_attention_int8_ref(q, kq, ks, vq, vs, valid, window=window))
    torch.cuda.empty_cache()
    family_tile_edges(torch, R, dev)


def cross_device(torch, ops, get_model, smoke_config, ServeSession, dev):
    """Phase 4: smoke config in f32, plain path on the CPU vs kernels on the card."""
    base = smoke_config("deepseek-7b")
    prompt = torch.from_numpy(np.random.default_rng(1).integers(0, base.vocab, (2, 13)))
    for kv in ("native", "int8"):
        model = get_model(base.with_(kv_cache_dtype=kv))
        cpu_params, _ = model.init_params(seed=0, device="cpu")
        gpu_params = {k: _to(v, dev) for k, v in cpu_params.items()}
        want = ServeSession(model=model, params=cpu_params, device="cpu").generate(
            prompt, max_new_tokens=6).tokens
        ops.reset_launches()
        got = ServeSession(model=model, params=gpu_params, device=dev).generate(
            prompt, max_new_tokens=6).tokens.cpu()
        counts = dict(ops.LAUNCHES)
        print(f"[cross-device] {kv}: cpu={want.tolist()} gpu={got.tolist()} launches={counts}")
        if not torch.equal(want, got):
            raise AssertionError(f"{kv}: greedy tokens differ between CPU and card")
        decode_op = "decode_attention_int8" if kv == "int8" else "decode_attention"
        if counts["flash_attention"] != base.n_layers or counts[decode_op] != 6 * base.n_layers:
            raise AssertionError(f"{kv}: attention did not run through the kernels: {counts}")


def _to(tree, dev):
    return {k: _to(v, dev) for k, v in tree.items()} if isinstance(tree, dict) else tree.to(dev)


def full_width(torch, ops, get_model, get_config, ServeSession, dev):
    """Phase 5: deepseek-7b at its published size through ServeSession.generate."""
    B, P, N = 8, 512, 64
    cfg = get_config("deepseek-7b")
    t0 = time.perf_counter()
    params, _ = get_model(cfg).init_params(seed=0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"[full] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{n_params / 1e9:.3f} B params ({str(cfg.dtype)}), init "
          f"{time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    prompt = torch.randint(0, cfg.vocab, (B, P), generator=gen, device=dev)
    totals = {name: 0 for name in ops.LAUNCHES}
    results = {}
    for kv in ("native", "int8"):
        model = get_model(cfg.with_(kv_cache_dtype=kv))
        serve = ServeSession(model=model, params=params, device=dev)
        logits, cache = model.prefill(params, prompt, P + N + 1)    # warm-up + check
        torch.cuda.synchronize()
        if tuple(logits.shape) != (B, 1, cfg.vocab) or not torch.isfinite(logits).all():
            raise AssertionError(f"{kv}: prefill logits {tuple(logits.shape)} not finite")
        del logits, cache
        torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launches()
        out = serve.generate(prompt, max_new_tokens=N)
        counts = dict(ops.LAUNCHES)
        peak = torch.cuda.max_memory_allocated(dev)
        toks = out.tokens
        decode_op = "decode_attention_int8" if kv == "int8" else "decode_attention"
        print(f"[full] {kv}: prefill {out.prefill_time * 1e3:.3f} ms, decode "
              f"{out.decode_tok_s:.3f} tok/s ({out.ms_per_step:.3f} ms/step), peak memory "
              f"{peak / 2**30:.3f} GiB, launches {counts}")
        if tuple(toks.shape) != (B, N + 1) or int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab:
            raise AssertionError(f"{kv}: tokens {tuple(toks.shape)} out of range")
        if counts["flash_attention"] != cfg.n_layers or counts[decode_op] != cfg.n_layers * N:
            raise AssertionError(f"{kv}: attention did not run through the kernels: {counts}")
        for name, c in counts.items():
            totals[name] += c
        results[kv] = (out.ms_per_step, toks.cpu())
    agree = (results["native"][1] == results["int8"][1]).float().mean().item()
    print(f"[full] native vs int8 KV: {agree:.3f} of generated tokens agree")
    return totals, {kv: r[0] for kv, r in results.items()}


def profile_serving(torch, get_model, get_config, dev, ms_per_step):
    """Phase 12, serving: the decode step of phase 5 and the engine decode
    step of phase 22."""
    B, P, N = 8, 512, 64
    cfg = get_config("deepseek-7b")
    params, _ = get_model(cfg).init_params(seed=0, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    prompt = torch.randint(0, cfg.vocab, (B, P), generator=gen, device=dev)
    for kv, step_ms in ms_per_step.items():
        model = get_model(cfg.with_(kv_cache_dtype=kv))
        logits, cache = model.prefill(params, prompt, P + N + 1)
        busy = profile_decode(torch, model, params, cache, logits, P)
        del logits, cache
        if busy is not None:
            print(f"[profile] {kv}: device busy {busy:.3f} ms of {step_ms:.3f} ms "
                  f"per decode step: idle share {1 - busy / step_ms:.3f}")
    profile_engine_step(torch, get_model, get_config, params, dev)


def profile_decode(torch, model, params, cache, logits, pos0, steps=6, moe=False):
    """Device time of one decode step by kind of kernel, from torch.profiler
    over ``steps`` steps (after 2 unprofiled ones).  Returns the device-busy
    ms per step, or None when the profiler saw no device activity."""
    from torch.profiler import ProfilerActivity, profile

    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
    B = tok.shape[0]

    def step(t, tok):
        pos = torch.full((B,), pos0 + t, dtype=torch.int32, device=tok.device)
        out, _ = model.decode_step(params, tok, cache, pos)
        return torch.argmax(out[:, -1], dim=-1).to(torch.int32)[:, None]

    for t in range(2):
        tok = step(t, tok)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for t in range(2, 2 + steps):
            tok = step(t, tok)
        torch.cuda.synchronize()
    return device_time_by_kind(torch, prof, steps, "decode step", moe)


def device_time_by_kind(torch, prof, steps, what, moe=False, top_other=0):
    """Print device ms per step by kind of kernel; return device-busy ms per
    step (union of device spans), or None when the profiler saw none.  A MoE
    step also splits out its routing kernels.  The profiles record device
    activity only: host ops are not read here, and turning every recorded
    event into a Python object costs ~65 us an event (an rwkv6-7b train step
    launches ~90,000 kernels, several host events each)."""
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        print("[profile] not measured: the profiler saw no device activity")
        return None
    kinds, others = {}, {}
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for start, end, name in spans:
        low = name.lower()
        kind = ("flash_attention" if "flash_fwd" in name else
                "decode_attention" if "decode_kernel" in name or "decode_tc_kernel" in name else
                "quantize" if "quantize_rows_" in name else
                "wkv6_scan" if "wkv6_kernel" in name or "wkv6_chunk_kernel" in name else
                "rglru_scan" if "rglru_" in name else
                "fused_moe" if any(w in name for w in MOE_KERNELS) else
                "matmul" if any(w in low for w in ("gemm", "cutlass", "xmma", "nvjet")) else
                "routing" if moe and any(w in low for w in ROUTING_KERNELS) else
                "other")
        kinds[kind] = kinds.get(kind, 0.0) + (end - start)
        if kind == "other":
            others[name] = others.get(name, 0.0) + (end - start)
        if start > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = start, end
        else:
            cur_e = max(cur_e, end)
    busy += cur_e - cur_s
    per_step = {k: round(v / steps / 1e3, 4) for k, v in sorted(kinds.items())}
    print(f"[profile] device ms per {what} by kind: {per_step}; "
          f"{len(spans) / steps:.0f} device activities per {what}")
    for name, t in sorted(others.items(), key=lambda kv: -kv[1])[:top_other]:
        print(f"[profile]   other: {t / steps / 1e3:.3f} ms {name[:150]}")
    return busy / steps / 1e3


def train_kernel_checks(torch, ops, R, F, dev):
    """Phase 6: the training path's kernels at the full-width training shapes."""
    from repro_torch.kernels.flash_attention import flash_attention_fwd, flash_attention_int8_fwd
    from repro_torch.kernels.quantize import quantize_rows

    gen = torch.Generator(device=dev)
    gen.manual_seed(4321)
    scratch = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    flush = scratch.zero_
    B, S, H, D = 60, 256, 32, 128                  # the tuned demo batch at seq 256
    bf16 = torch.bfloat16
    k, v, q = (torch.randn(B, S, H, D, generator=gen, device=dev).to(bf16) for _ in range(3))
    rows = k.view(-1, D)
    records = []
    tol = 2e-2                                      # bf16 output rounding
    flops = 4 * D * B * H * S * (S + 1) // 2        # causal pairs only

    # -- flash attention (the f32 / bf16 precisions' kernel), causal, MHA ------
    err = (flash_attention_fwd(q, k, v, causal=True).float()
           - R.flash_attention_ref(q, k, v, causal=True).float()).abs().max().item()
    torch.cuda.synchronize()
    ok = math.isfinite(err) and err <= tol
    print(f"[check] flash_attention bfloat16 {(B, S, H, D)}: max_abs_err={err:.3e} "
          f"tol={tol:.0e} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"flash_attention disagrees with its plain version: {err}")
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    b_ms, b_by = bound(4 * q.numel() * q.element_size(), flops, "bfloat16")
    records.append(dict(
        name="flash_attention", path="training", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:133",
        launches=0, max_abs_err=err,
        ms=timed_ms(lambda: flash_attention_fwd(q, k, v, causal=True), flush),
        plain_ms=timed_plain(lambda: R.flash_attention_ref(q, k, v, causal=True), flush),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=timed_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True), flush),
    ))
    del qt, kt, vt

    # -- row quantizer: bit-equal to its plain version ------------------------
    records.append(quant_record(torch, R, "training", rows, flush))     # noise 0.5
    cases = [("random noise", rows, torch.rand(rows.shape, generator=gen, device=dev)),
             ("ragged R=1001", rows[:1001], 0.5)]
    for label, x, noise in cases:
        quant_check(torch, R, f"{label}, {tuple(x.shape)} bf16", x, noise)
    del cases
    quantize_edge_checks(torch, R, dev)

    # -- int8-K/V flash attention, causal, at the main path's noise 0.5 --------
    kq, ks = (t.view(B, S, H, -1) for t in quantize_rows(rows, 0.5))
    vq, vs = (t.view(B, S, H, -1) for t in quantize_rows(v.view(-1, D), 0.5))
    del k, v, rows

    def kernel():
        return flash_attention_int8_fwd(q, kq, ks, vq, vs, causal=True)

    def plain():
        return R.flash_attention_ref(q, R.dequantize_int8_ref(kq, ks),
                                     R.dequantize_int8_ref(vq, vs), causal=True)

    err = (kernel().float() - plain().float()).abs().max().item()
    torch.cuda.synchronize()
    ok = math.isfinite(err) and err <= tol
    print(f"[check] flash_attention_q8 bfloat16: max_abs_err={err:.3e} tol={tol:.0e} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"flash_attention_q8 disagrees with its plain version: {err}")
    # the op on float K/V against flash_attention_q8_ref (quantize + dequantize + attend)
    kf, vf = R.dequantize_int8_ref(kq, ks, bf16), R.dequantize_int8_ref(vq, vs, bf16)
    op_err = (ops.flash_attention_q8(q, kf, vf, causal=True).float()
              - R.flash_attention_q8_ref(q, kf, vf, causal=True).float()).abs().max().item()
    print(f"[check] ops.flash_attention_q8 vs flash_attention_q8_ref: "
          f"max_abs_err={op_err:.3e} tol={tol:.0e} {'ok' if op_err <= tol else 'FAIL'}")
    if not (math.isfinite(op_err) and op_err <= tol):
        raise AssertionError(f"ops.flash_attention_q8 disagrees with its plain version: {op_err}")
    del kf, vf
    nbytes = (2 * q.numel() * q.element_size()             # q in, out
              + kq.numel() + vq.numel() + ks.numel() * 4 + vs.numel() * 4)
    b_ms, b_by = bound(nbytes, flops, "bfloat16")
    records.append(dict(
        name="flash_attention_q8", path="training", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:200",
        launches=0, max_abs_err=err,
        ms=timed_ms(kernel, flush), plain_ms=timed_plain(plain, flush),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
    ))
    del q, kq, ks, vq, vs, scratch
    for rec in records:
        print(json.dumps(rec))
    return records


def quant_check(torch, R, label, x, noise):
    """The quantizer on the card against its plain version, bit for bit."""
    from repro_torch.kernels.quantize import quantize_plan, quantize_rows

    aligned = x.data_ptr() % 16 == 0 and (not isinstance(noise, torch.Tensor)
                                          or noise.data_ptr() % 16 == 0)
    route = quantize_plan(*x.shape, x.dtype, aligned)
    got, want = quantize_rows(x, noise), R.quantize_int8_ref(x, noise)
    torch.cuda.synchronize()
    same = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    print(f"[check] quantize_int8 {label} (route {route}): "
          f"{'bit-equal' if same else 'DIFFERS'}")
    if not same:
        raise AssertionError(f"quantize_int8 ({label}) differs from its plain version")
    return route


def quant_record(torch, R, path, rows, flush):
    """The kernels-line record of the quantizer at noise 0.5 over ``rows``
    (R, N), checked bit for bit first; its route goes into ``shape``."""
    from repro_torch.kernels.quantize import quantize_rows

    dt = str(rows.dtype).split(".")[-1]
    route = quant_check(torch, R, f"{tuple(rows.shape)} {dt} at noise 0.5", rows, 0.5)
    R_, N = rows.shape
    nbytes = R_ * N * rows.element_size() + R_ * N + R_ * 4     # x in, q and scales out
    b_ms, b_by = bound(nbytes, 0.0, "float32")
    return dict(
        name="quantize_int8", path=path, shape=f"rows {tuple(rows.shape)} {dt}, route {route}",
        route="cuda", source="src/repro_torch/kernels/csrc/quantize.cu",
        replaces="src/repro/kernels/quantize.py:38", launches=0, max_abs_err=0.0,
        ms=timed_ms(lambda: quantize_rows(rows, 0.5), flush),
        plain_ms=timed_plain(lambda: R.quantize_int8_ref(rows, 0.5), flush),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)


def quantize_edge_checks(torch, R, dev):
    """Phase 6: the quantizer's routes at their edges, bit for bit against
    the plain version at noise 0.5 and at random noise: groups of 2 and 4
    lanes (rows of 16) and of 3 pieces in a group of 4 (24 bf16), widths
    that are no multiple of 16 bytes (45 and 300 bf16), the wide route at
    300 f32, views whose base is not 16-byte aligned, R of 1 and ragged R;
    every case holds a zero row (the scale floor), a row of one huge value
    among denormals and a row whose x / scale lands on .5 ties."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(2468)
    bf16, f32 = torch.bfloat16, torch.float32

    def rows_of(R_, N, dtype):
        x = torch.randn(R_, N, generator=gen, device=dev) * 3.0
        specials = [torch.zeros(N, device=dev),
                    torch.rand(N, generator=gen, device=dev) * 1e-39,   # denormals
                    torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5] * N,
                                 device=dev)[:N]]                      # scale 1: ties
        specials[1][N // 2] = 3.0e38
        for i, row in enumerate(specials if R_ >= len(specials) else []):
            x[(i * 7) % R_] = row
        return x.to(dtype)

    flat = torch.randn(1001 * 64 + 1, generator=gen, device=dev).to(bf16)
    odd = rows_of(1002, 45, bf16)
    cases = [(rows_of(1001, 16, f32), "rows of 16 f32"),
             (rows_of(1001, 16, bf16), "rows of 16 bf16"),
             (rows_of(333, 24, bf16), "rows of 24 bf16"),
             (rows_of(777, 45, bf16), "rows of 45 bf16"),
             (rows_of(513, 300, bf16), "rows of 300 bf16"),
             (rows_of(129, 300, f32), "rows of 300 f32"),
             (rows_of(1, 64, bf16), "R=1 rows of 64 bf16"),
             (rows_of(1, 2560, f32), "R=1 rows of 2560 f32"),
             (rows_of(4099, 64, bf16), "ragged rows of 64 bf16"),
             (rows_of(37, 2560, f32), "ragged rows of 2560 f32"),
             (odd[1:], "a view one row into rows of 45 bf16"),
             (flat[1:].view(1001, 64), "a view one element in, rows of 64 bf16")]
    for x, label in cases:
        for noise in (0.5, torch.rand(x.shape, generator=gen, device=dev)):
            kind = "random noise" if isinstance(noise, torch.Tensor) else "noise 0.5"
            quant_check(torch, R, f"edge {label} {tuple(x.shape)}, {kind}", x, noise)
    # a noise tensor whose base is not 16-byte aligned takes the scalar route too
    x = rows_of(257, 64, bf16)
    noise = torch.rand(257 * 64 + 1, generator=gen, device=dev)[1:].view(257, 64)
    quant_check(torch, R, "edge rows of 64 bf16, a noise view one element in", x, noise)


def expected_train_launches(cfg, prec, steps):
    """Kernel launches of ``steps`` training steps of ``cfg`` under ``prec``
    with remat (each layer's forward runs twice: the forward and its
    recompute in the backward): every attention layer through the flash
    kernel, every recurrent layer through its scan, every MoE layer through
    the expert GEMM and the combine, and under int8-fused the row quantizer
    for K and V, for r, k and v, or for the RG-LRU input.  Whisper's
    cross-attention runs the float flash kernel under every precision, as
    the reference's does."""
    if cfg.family == "rglru":
        kinds = [cfg.block_pattern[i % len(cfg.block_pattern)] for i in range(cfg.n_layers)]
    elif cfg.family == "encdec":
        kinds = ["A"] * (cfg.n_enc_layers + cfg.n_dec_layers) + ["X"] * cfg.n_dec_layers
    elif cfg.family == "moe":
        kinds = ["A", "E"] * cfg.n_layers
    else:
        kinds = ["W" if cfg.family == "rwkv6" else "A"] * cfg.n_layers
    q8 = prec == "int8-fused"
    # kind -> (kernels, whether int8-fused takes their _q8 entry, rows quantized)
    per_kind = {"A": (("flash_attention",), True, 2),            # K, V
                "R": (("rglru_scan",), True, 1),                 # x
                "W": (("rwkv6_scan",), True, 3),                 # r, k, v
                "X": (("flash_attention",), False, 0),
                "E": (("fused_moe_gemm", "fused_moe_combine"), False, 0)}
    out = {}
    for kind in kinds:
        names, swaps, n_rows = per_kind[kind]
        for name in names:
            name += "_q8" if q8 and swaps else ""
            out[name] = out.get(name, 0) + 2 * steps
        if q8 and n_rows:
            out["quantize_int8"] = out.get("quantize_int8", 0) + 2 * steps * n_rows
    return out


def cross_device_train(torch, ops, train_session_factory, dev, arch="deepseek-7b"):
    """Phases 7 and 18: a smoke config in f32, Session.run on the CPU (plain
    versions) vs on the card (kernels), from the same weights."""
    import copy

    rtol = {"f32": 1e-4, "int8-fused": 1e-2}   # f32 reassociation; int8 rounding flips
    steps = 6
    for prec in ("f32", "int8-fused"):
        kw = dict(arch=arch, steps=steps, seq=32, precision=prec)
        cpu = train_session_factory(device="cpu", **kw)
        params, _ = cpu.init_state()
        gpu_params = _to(copy.deepcopy(params), dev)
        want = [h["loss"] for h in cpu.run(params).history]
        gpu = train_session_factory(device=dev, **kw)
        ops.reset_launches()
        report = gpu.run(gpu_params)
        counts = dict(ops.LAUNCHES)
        got = [h["loss"] for h in report.history]
        print(f"[cross-device] train {arch} {prec}: cpu={[round(x, 6) for x in want]} "
              f"gpu={[round(x, 6) for x in got]} launches={counts}")
        if not np.allclose(got, want, rtol=rtol[prec], atol=0.0):
            raise AssertionError(f"{arch} {prec}: per-step losses differ between CPU and card")
        _check_launches(counts, expected_train_launches(gpu.model.cfg, prec, steps),
                        f"{arch} {prec} training")


# the full-width training cells: arch -> (layers, seq).  deepseek-7b is cut
# to 8 layers (the AdamW state of the full depth does not fit 80 GB), rwkv6-7b
# to 4 (its plain scan backward, ~0.5 s a layer a step, kept the whole run
# over 1,130 s on a slow host at 8); recurrentgemma-2b runs all 26 at seq 128
# (its 256,000-entry vocabulary makes the logits the largest tensors of a
# step); qwen3-moe-30b-a3b
# (phase 28) keeps 3 of 48 layers: 2.49 B params, 30 GB of weights and AdamW
# state, beside logits of 151,936 columns
# steps a full-width training run takes (phases 8, 19, 28-30): the median of
# steps 2-4 is the reading (5 steps until the run gained phase 36)
TRAIN_STEPS = 4
TRAIN_CELLS = {"deepseek-7b": (8, 256), "rwkv6-7b": (4, 256), "recurrentgemma-2b": (26, 128),
               "qwen3-moe-30b-a3b": (3, 256)}


def predicted_train_peak_gib(cfg, n_params, rows, seq_in, seq_out):
    """A training step's predicted peak: bf16 weights and gradients and f32
    AdamW moments (12 B a parameter), the logits over ``seq_in`` positions
    and their gradient in bf16, the float32 copy of the ``seq_out`` scored
    positions and its softmax gradient, and each layer's saved input (remat)."""
    n_layers = cfg.n_enc_layers + cfg.n_dec_layers if cfg.family == "encdec" else cfg.n_layers
    logits = rows * cfg.vocab * (seq_in * 2 * 2 + seq_out * 4 * 2)
    saved = rows * max(seq_in, cfg.n_frames) * cfg.d_model * 2 * n_layers
    return (n_params * 12 + logits + saved) / 2**30


def report_train(cfg, arch, prec, hist, wall, rows, valid_rows, seq, peak, counts, steps,
                 get_config):
    """Phase 8's lines for one full-width training run; raises on a
    non-finite loss or grad norm, or on a MoE step without its aux loss;
    returns the median ms a step (steps 2 to the last)."""
    ms = statistics.median(h["step_time"] for h in hist[1:]) * 1e3
    data_ms = statistics.median(h["data_time"] for h in hist[1:]) * 1e3
    valid_tok_s = valid_rows * seq / (ms / 1e3)
    loop_ms = wall / steps * 1e3          # all steps, batch assembly included
    n_layers = (f"{cfg.n_enc_layers} + {cfg.n_dec_layers}" if cfg.family == "encdec" else
                f"{cfg.n_layers} of {get_config(arch).n_layers}")
    print(f"[train] {cfg.name} {prec}: {n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.param_count() / 1e9:.3f} B params ({str(cfg.dtype)}), rows {rows} "
          f"({valid_rows} valid) x seq {seq}")
    print(f"[train] {cfg.name} {prec}: {ms:.3f} ms/step (median of steps 2-{steps}), "
          f"{valid_tok_s:.1f} valid tok/s, first step {hist[0]['step_time'] * 1e3:.1f} ms, "
          f"peak memory {peak / 2**30:.3f} GiB, launches {counts}")
    print(f"[train] {cfg.name} {prec}: whole loop {wall * 1e3:.1f} ms for "
          f"{steps} steps ({loop_ms:.3f} ms/step, "
          f"{valid_rows * seq / (loop_ms / 1e3):.1f} valid tok/s), of which batch "
          f"assembly {data_ms:.3f} ms/step (median of steps 2-{steps})")
    print(f"[train] {cfg.name} {prec}: losses {[round(h['loss'], 4) for h in hist]} "
          f"grad_norm {[round(h['grad_norm'], 3) for h in hist]} "
          f"aux {[round(h['aux'], 4) for h in hist]}")
    if not all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"]) for h in hist):
        raise AssertionError(f"{cfg.name} {prec}: non-finite loss or grad norm")
    if cfg.family == "moe" and not all(h["aux"] > 0 for h in hist):
        raise AssertionError(f"{cfg.name} {prec}: the router's aux loss is missing")
    return ms


def full_width_train(torch, ops, train_session_factory, get_config, dev, arch="deepseek-7b"):
    """Phases 8, 19 and 28: ``arch`` at full width, depth and seq from
    TRAIN_CELLS, through Session.run for TRAIN_STEPS steps in f32 and
    int8-fused."""
    steps = TRAIN_STEPS
    layers, seq = TRAIN_CELLS[arch]
    totals = {name: 0 for name in ops.LAUNCHES}
    step_ms = {}
    for prec in ("f32", "int8-fused"):
        session = train_session_factory(arch=arch, device=dev, full_config=True,
                                        n_layers=layers, seq=seq, steps=steps, precision=prec)
        cfg = session.model.cfg
        sched = session.tune().schedule
        torch.cuda.empty_cache()
        print(f"[train] {cfg.name} {prec}: predicted peak "
              f"{predicted_train_peak_gib(cfg, cfg.param_count(), sched.global_rows, seq, seq):.2f}"
              f" GiB; allocated before {torch.cuda.memory_allocated(dev) / 2**30:.3f} GiB")
        torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launches()
        report = session.run()
        counts = dict(ops.LAUNCHES)
        peak = torch.cuda.max_memory_allocated(dev)
        ms = report_train(cfg, arch, prec, report.history, report.wall_time, sched.global_rows,
                          sched.valid_rows, seq, peak, counts, steps, get_config)
        _check_launches(counts, expected_train_launches(cfg, prec, steps),
                        f"{cfg.name} {prec} training")
        for name, c in counts.items():
            totals[name] += c
        step_ms[(arch, prec)] = ms
        del session, report
        torch.cuda.empty_cache()
    return totals, step_ms


# the recurrent cells profiled in f32 only: their int8-fused steps profiled
# within 0.6% of the f32 ones in every kind but the quantizer's 1.5-1.7 ms
# (PERF.md §5), at 12-34 s a profile on a slow host; phase 19 still times
# both precisions
PROFILE_F32_ONLY = ("rwkv6-7b", "recurrentgemma-2b")


def profile_train(torch, train_session_factory, dev, step_ms):
    """Phase 12, training: one profiled step per (arch, precision) at the
    shapes of phases 8, 19 and 28 (PROFILE_F32_ONLY: f32 alone), after a
    warm step, on fresh weights; then one more step split into its parts
    (``profile_step``)."""
    for (arch, prec), ms in step_ms.items():
        if prec != "f32" and arch in PROFILE_F32_ONLY:
            continue
        t0 = time.perf_counter()
        layers, seq = TRAIN_CELLS[arch]
        session = train_session_factory(arch=arch, device=dev, full_config=True,
                                        n_layers=layers, seq=seq, steps=2, precision=prec)
        params, opt_state = session.init_state()
        profile_step(torch, dev, f"{arch} {prec}", session.model, session.optimizer,
                     session.compile().step_fn, params, opt_state,
                     lambda: session.dataset.next_device_batch(dev), ms)
        del session, params, opt_state
        torch.cuda.empty_cache()
        print(f"[time] phase 12's {arch} {prec} training profile: "
              f"{time.perf_counter() - t0:.1f} s")


def profile_side_train(torch, get_model, get_config, dev, step_ms):
    """Phase 12, phases 29-30: one profiled f32 step of each, as
    ``profile_train``, on fresh weights and batches drawn from the seed."""
    from repro_torch.optim import adamw

    for arch, ms in step_ms.items():
        layers, rows, seq, n_patches = SIDE_TRAIN[arch]
        cfg = get_config(arch)
        if layers is not None:
            cfg = cfg.with_(n_layers=layers)
        model, opt = get_model(cfg), adamw()
        params, _ = model.init_params(seed=0, device=dev)
        step, opt_state = _side_step(get_model, cfg, params, rows, 2, opt)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        profile_step(torch, dev, f"{arch} f32", model, opt, step, params, opt_state,
                     lambda: _side_batch(torch, cfg, rows, seq, n_patches, gen, dev), ms)
        del params, opt_state, step
        torch.cuda.empty_cache()


def profile_step(torch, dev, label, model, optimizer, step, params, opt_state, next_batch, ms):
    """One warm step, one profiled step (device ms by kind, the largest
    "other" kernels, busy ms and the idle share of ``ms``), then one step in
    its parts on CUDA events; for a MoE model also one layer's plain MoE
    backward at the step's T tokens on CUDA events."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops
    from repro_torch.models.dense import _layer
    from repro_torch.models.moe import expert_capacity
    from repro_torch.optim.optimizers import tree_leaves
    from repro_torch.train.steps import loss_fn, value_and_grad

    cfg = model.cfg
    params, opt_state, _ = step(params, opt_state, next_batch())        # warm
    torch.cuda.synchronize()
    batch = next_batch()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        params, opt_state, metrics = step(params, opt_state, batch)
        torch.cuda.synchronize()
    busy = device_time_by_kind(torch, prof, 1, f"{label} train step", moe=cfg.family == "moe",
                               top_other=6)
    if busy is not None:
        print(f"[profile] {label}: device busy {busy:.3f} ms of {ms:.3f} ms per "
              f"train step: idle share {1 - busy / ms:.3f}")
    del prof
    # the parts of make_train_step's step, one after another, on CUDA events
    batch = next_batch()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    ev[0].record()
    with torch.no_grad():
        loss_fn(model, params, batch)
    ev[1].record()
    _, grads = value_and_grad(model, params, batch)
    ev[2].record()
    opt_state, params = optimizer.update(grads, opt_state, params, metrics["lr"])
    ev[3].record()
    torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in tree_leaves(grads)))
    ev[4].record()
    torch.cuda.synchronize()
    part = [ev[i].elapsed_time(ev[i + 1]) for i in range(4)]
    print(f"[profile] {label}: one step in parts (CUDA events): forward+backward "
          f"{part[1]:.3f} ms (a forward alone {part[0]:.3f} ms), AdamW update "
          f"{part[2]:.3f} ms, grad norm {part[3]:.3f} ms")
    del grads
    if cfg.family == "moe":
        # one layer's MoE backward (the plain recompute through
        # fused_moe_mlp_ref) at the step's T tokens, its input drawn at
        # unit scale (as the RMS-normed activations), on CUDA events
        lp = _layer(params["blocks"], 0)["moe"]
        T = batch["tokens"].numel()
        gen = torch.Generator(device=dev)
        gen.manual_seed(28)
        x = torch.randn(T, cfg.d_model, generator=gen, device=dev).to(cfg.dtype)
        args = [t.detach().requires_grad_() for t in
                (x, lp["router"], lp["wi_gate"], lp["wi_up"], lp["wo"])]
        C = expert_capacity(T, cfg.n_experts, cfg.experts_per_token, cfg.capacity_factor)
        out, aux = ops.fused_moe_mlp(*args, k=cfg.experts_per_token, capacity=C)
        g_out = torch.randn(out.shape, generator=gen, device=dev).to(out.dtype)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        torch.autograd.grad((out, aux), args, (g_out, torch.ones_like(aux)))
        ev[1].record()
        torch.cuda.synchronize()
        bwd = ev[0].elapsed_time(ev[1])
        print(f"[profile] {label}: the plain MoE backward {bwd:.3f} ms a layer at T {T} "
              f"(CUDA events; aux {float(aux):.3f}), x {cfg.n_layers} layers = "
              f"{bwd * cfg.n_layers:.3f} ms, {bwd * cfg.n_layers / ms:.3f} of the {ms:.3f} ms step")


# ---------------------------------------------------------------------------
# MoE serving (qwen3-moe-30b-a3b)
# ---------------------------------------------------------------------------


def moe_gemm_combine_records(torch, R, F, x, router, wg, wu, wo, k, C, label, path, flush,
                             timed=True, first_expert=None):
    """The expert GEMM (to one bf16 ulp of its largest output) and the
    combine (bit for bit) on slot tables from ``moe_routing`` of ``x``
    through ``router``, against their plain versions; when ``timed``, the
    GEMM's gate/up and down kernels apart (``torch.profiler``), the three
    products as ``torch.bmm`` on gathered rows as a note, and both
    kernels' kernels-line records for ``path``.  With ``first_expert``
    the weights are an expert-parallel rank's experts ``first_expert ..``
    of the router's: the slot tables are theirs of the whole routing."""
    from repro_torch.kernels import fused_moe as FM

    T, d = x.shape
    E, _, f = wg.shape
    bf16 = torch.bfloat16
    slot_tok, slot_gate, _, _, keep, _ = FM.moe_routing(x, router, k, C)
    if first_expert is not None:
        mine = slice(first_expert * C, (first_expert + E) * C)
        slot_tok, slot_gate = slot_tok[mine], slot_gate[mine]
    live = slot_tok[:, 0] < T
    n_live = int(live.sum())
    n_exp = int(live.view(E, C).any(dim=1).sum())     # experts holding a token
    route, croute = FM.gemm_route(T, d, f, E, C, x.dtype), FM.combine_route(E * C, T, d)
    y = FM.fused_moe_gemm(x, wg, wu, wo, slot_tok, slot_gate)
    want = R.fused_moe_gemm_ref(x, wg, wu, wo, slot_tok, slot_gate)
    torch.cuda.synchronize()
    err = (y.float() - want.float()).abs().max().item()
    # one bf16 ulp of the largest output: both compute the same f32 value
    # up to summation order, then round once to bf16
    tol = want.float().abs().max().item() * 2.0 ** -7
    ok = math.isfinite(err) and err <= tol
    print(f"[check] fused_moe_gemm {label} T={T} C={C} (route {route}): {n_live} of "
          f"{E * C} slots live ({n_exp} experts), {int((~keep).sum())} copies dropped; "
          f"max_abs_err={err:.3e} tol={tol:.3e} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"fused_moe_gemm ({label}) disagrees with its plain version")
    del want
    out = FM.fused_moe_combine(y, slot_tok, T)
    same = torch.equal(out, R.fused_moe_combine_ref(y, slot_tok, T))
    print(f"[check] fused_moe_combine {label} (route {croute}): "
          f"{'bit-equal' if same else 'DIFFERS'}")
    if not same:
        raise AssertionError(f"fused_moe_combine ({label}) differs from its plain version")
    if not timed:
        return []
    gemm = lambda: FM.fused_moe_gemm(x, wg, wu, wo, slot_tok, slot_gate)  # noqa: E731
    split = kernel_ms(torch, gemm, flush, {"gate/up": ("moe_gate_up",),
                                           "down": ("moe_down",)})
    gu, dn = ("not measured" if v is None else f"{v:.4f} ms" for v in split.values())
    print(f"[time] fused_moe_gemm {label} (route {route}): gate/up {gu}, down {dn} "
          f"(profiler, mean of 25)")
    esz = x.element_size()
    nbytes = n_exp * 3 * d * f * wg.element_size() + x.numel() * esz + y.numel() * esz \
        + slot_tok.numel() * 8
    b_ms, b_by = bound(nbytes, 6.0 * n_live * d * f, "bfloat16")
    records = [dict(
        name="fused_moe_gemm", path=path, shape=label, route="cuda",
        source="src/repro_torch/kernels/csrc/fused_moe.cu",
        replaces="src/repro/kernels/fused_moe.py:140",
        launches=0, max_abs_err=err,
        ms=timed_ms(gemm, flush),
        plain_ms=timed_plain(lambda: R.fused_moe_gemm_ref(x, wg, wu, wo, slot_tok, slot_gate),
                          flush),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
    )]
    kept = live.nonzero()[:, 0]
    tok_kept, y_kept = slot_tok[kept, 0].long(), y[kept]
    # a note, not a library time (no one call computes the whole
    # function): the three products as torch.bmm on rows gathered beforehand
    xs = torch.where(live[:, None], x[slot_tok[:, 0].long().clamp(max=T - 1)], 0)
    xs = xs.view(E, C, d)
    bmm_ms = timed_ms(
        lambda: torch.bmm(F.silu(torch.bmm(xs, wg)) * torch.bmm(xs, wu), wo), flush)
    print(f"[time] fused_moe_gemm {label}: the three products as torch.bmm on gathered "
          f"rows {bmm_ms:.4f} ms (h in bf16: a yardstick, not the same function)")
    del xs
    nbytes = n_live * d * esz + T * d * esz + slot_tok.numel() * 4
    b_ms, b_by = bound(nbytes, float(n_live * d), "float32")
    records.append(dict(
        name="fused_moe_combine", path=path, shape=label, route="cuda",
        source="src/repro_torch/kernels/csrc/fused_moe.cu",
        replaces="src/repro/kernels/fused_moe.py:200",
        launches=0, max_abs_err=0.0,
        ms=timed_ms(lambda: FM.fused_moe_combine(y, slot_tok, T), flush),
        plain_ms=timed_plain(lambda: R.fused_moe_combine_ref(y, slot_tok, T), flush),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=timed_ms(lambda: torch.zeros(T, d, dtype=bf16, device=x.device).index_add_(
            0, tok_kept, y_kept), flush),
    ))
    return records


def moe_kernel_checks(torch, R, F, dev):
    """Phase 9: the MoE path's kernels at its shapes against their plain
    versions on the card, slot tables from ``moe_routing``."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import decode_attention, decode_attention_int8
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.models.moe import expert_capacity

    cfg = get_config("qwen3-moe-30b-a3b")
    d, f, E, k = cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.experts_per_token
    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev)
    gen.manual_seed(2024)
    scratch = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    flush = scratch.zero_
    records = []

    def rand(*shape, std=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * std).to(bf16)

    # one layer's experts and router, at the model's init scales
    wg, wu = rand(E, d, f, std=d ** -0.5), rand(E, d, f, std=d ** -0.5)
    wo = rand(E, f, d, std=f ** -0.5)
    router = torch.randn(d, E, generator=gen, device=dev) * d ** -0.5

    for label, T, C in (("prefill", 4096, expert_capacity(4096, E, k, cfg.capacity_factor)),
                        ("decode", 8, expert_capacity(8, E, k, cfg.capacity_factor)),
                        ("overflow", 4096, 128)):
        records += moe_gemm_combine_records(torch, R, F, rand(T, d), router, wg, wu, wo, k, C,
                                            label, "moe_serving", flush,
                                            timed=label != "overflow")
    del wg, wu, wo, router
    moe_edge_checks(torch, R, dev)

    # -- attention at qwen3's GQA-8 shapes: 32 query heads over 4 kv heads -----
    B, S, H, Hkv, D, CACHE = 8, 512, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim(), 577
    q, kk, vv = rand(B, S, H, D), rand(B, S, Hkv, D), rand(B, S, Hkv, D)

    def check(name, got, want):
        return row_ulp_check(torch, f"{name} GQA-8 bf16", got, want)

    err = check("flash_attention", flash_attention_fwd(q, kk, vv, causal=True),
                R.flash_attention_ref(q, kk, vv, causal=True))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, kk, vv))
    b_ms, b_by = bound(2 * (q.numel() + kk.numel()) * 2, 4 * D * B * H * S * (S + 1) // 2,
                       "bfloat16")
    records.append(dict(
        name="flash_attention", path="moe_serving", shape="prefill GQA-8", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:133",
        launches=0, max_abs_err=err,
        ms=timed_ms(lambda: flash_attention_fwd(q, kk, vv, causal=True), flush),
        plain_ms=timed_plain(lambda: R.flash_attention_ref(q, kk, vv, causal=True), flush),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=timed_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), flush),
    ))
    del q, kk, vv, qt, kt, vt

    valid = torch.tensor([576, 1, 300, 513, 576, 0, 450, 520], dtype=torch.int32, device=dev)
    rows = int(valid.sum())
    q = rand(B, 1, H, D)
    kc, vc = rand(B, CACHE, Hkv, D), rand(B, CACHE, Hkv, D)
    err = check("decode_attention", decode_attention(q, kc, vc, valid),
                R.decode_attention_ref(q, kc, vc, valid))
    mask = (torch.arange(CACHE, device=dev)[None, :] < valid[:, None])[:, None, None, :]
    qt, kt, vt = q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2)
    b_ms, b_by = bound(2 * rows * Hkv * D * 2 + 2 * q.numel() * 2 + B * 4,
                       4 * D * H * rows, "bfloat16")
    records.append(dict(
        name="decode_attention", path="moe_serving", shape="decode GQA-8", route="cuda",
        source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:327",
        launches=0, max_abs_err=err,
        ms=timed_ms(lambda: decode_attention(q, kc, vc, valid), flush),
        plain_ms=timed_plain(lambda: R.decode_attention_ref(q, kc, vc, valid), flush),
        bound_ms=b_ms, bound_by=b_by,
        # valid_len 0 rows give NaN here (all masked); timing only
        library_ms=timed_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True), flush),
    ))
    kq, ks = R.quantize_int8_ref(kc)
    vq, vs = R.quantize_int8_ref(vc)
    err = check("decode_attention_int8", decode_attention_int8(q, kq, ks, vq, vs, valid),
                R.decode_attention_int8_ref(q, kq, ks, vq, vs, valid))
    b_ms, b_by = bound(2 * rows * Hkv * (D + 4) + 2 * q.numel() * 2 + B * 4,
                       4 * D * H * rows, "bfloat16")
    records.append(dict(
        name="decode_attention_int8", path="moe_serving", shape="decode GQA-8", route="cuda",
        source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:378",
        launches=0, max_abs_err=err,
        ms=timed_ms(lambda: decode_attention_int8(q, kq, ks, vq, vs, valid), flush),
        plain_ms=timed_plain(lambda: R.decode_attention_int8_ref(q, kq, ks, vq, vs, valid),
                          flush),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
    ))
    del q, kc, vc, qt, kt, vt, kq, ks, vq, vs, scratch
    torch.cuda.empty_cache()
    for rec in records:
        print(json.dumps(rec))
    return records


def moe_edge_checks(torch, R, dev):
    """Phase 9, the routes' edges: the expert GEMM against its plain version
    (bf16 to one bf16 ulp of the largest output, float32 to 1e-5 of it) at a
    ragged f (96 over 64-column tiles) and d (48 over 32-deep stages), one
    token, dbrx's d 6144 x f 10,752 at C 4 (tc_decode) and C 160
    (tc_prefill), and 300 experts at C 8 (more than tc_decode lists:
    tc_prefill); the combine on both routes bit for bit against its plain
    version, and a token with more than MAX_K slots (a NaN row on both)."""
    from repro_torch.kernels import fused_moe as FM

    gen = torch.Generator(device=dev)
    gen.manual_seed(99)
    bf16, f32 = torch.bfloat16, torch.float32

    def randn(*shape, std=1.0, dtype=bf16):
        return (torch.randn(*shape, generator=gen, device=dev) * std).to(dtype)

    def combine_both(label, y, slot_tok, T, nan_rows=()):
        want = R.fused_moe_combine_ref(y, slot_tok, T)
        keep = [t for t in range(T) if t not in nan_rows]
        for route in FM.COMBINE_ROUTES:
            out = FM.fused_moe_combine(y, slot_tok, T, route=route)
            same = torch.equal(out[keep], want[keep]) and all(
                bool(out[t].isnan().all()) for t in nan_rows)
            print(f"[check] fused_moe_combine edge {label} (route {route}): "
                  f"{'bit-equal' if same else 'DIFFERS'}"
                  + (f", NaN rows {list(nan_rows)}" if nan_rows else ""))
            if not same:
                raise AssertionError(f"fused_moe_combine edge {label} ({route}) differs")

    # T, d, f, E, k, C, dtype
    cases = [(8, 64, 96, 8, 2, 8, bf16), (100, 48, 96, 4, 2, 64, bf16),
             (1, 2048, 768, 128, 8, 8, bf16), (8, 6144, 10752, 16, 4, 4, bf16),
             (512, 6144, 10752, 16, 4, 160, bf16), (8, 256, 128, 300, 2, 8, bf16),
             (8, 64, 96, 8, 2, 8, f32), (100, 48, 96, 4, 2, 64, f32)]
    for T, d, f, E, k, C, dt in cases:
        x = randn(T, d, dtype=dt)
        router = randn(d, E, std=d ** -0.5, dtype=f32)
        wg, wu = randn(E, d, f, std=d ** -0.5, dtype=dt), randn(E, d, f, std=d ** -0.5, dtype=dt)
        wo = randn(E, f, d, std=f ** -0.5, dtype=dt)
        slot_tok, slot_gate = FM.moe_routing(x, router, k, C)[:2]
        route = FM.gemm_route(T, d, f, E, C, dt)
        y = FM.fused_moe_gemm(x, wg, wu, wo, slot_tok, slot_gate)
        want = R.fused_moe_gemm_ref(x, wg, wu, wo, slot_tok, slot_gate).float()
        err = (y.float() - want).abs().max().item()
        tol = want.abs().max().item() * (2.0 ** -7 if dt == bf16 else 1e-5)
        ok = math.isfinite(err) and err <= tol
        label = f"T={T} d={d} f={f} E={E} C={C} {str(dt).split('.')[-1]}"
        print(f"[check] fused_moe_gemm edge {label} (route {route}): max_abs_err={err:.3e} "
              f"tol={tol:.3e} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"fused_moe_gemm edge {label} disagrees with its plain version")
        combine_both(label, y, slot_tok, T)
        del x, wg, wu, wo, y, want
    # token 0 keeps 40 slots (> MAX_K), token 1 ten, the rest are empty
    slot_tok = torch.full((64, 1), 2, dtype=torch.int32, device=dev)
    slot_tok[:40], slot_tok[40:50] = 0, 1
    combine_both("T=2 S=64, 40 slots of token 0", randn(64, 32), slot_tok, 2, nan_rows=(0,))
    torch.cuda.empty_cache()


def cross_device_moe(torch, ops, get_model, smoke_config, ServeSession, dev):
    """Phase 10: both MoE smoke configs in f32, plain path on the CPU vs
    kernels on the card, from the same weights."""
    N = 6
    prompt = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (2, 13)))
    for arch in ("qwen3-moe-30b-a3b", "dbrx-132b"):
        base = smoke_config(arch)
        for kv in ("native", "int8"):
            model = get_model(base.with_(kv_cache_dtype=kv))
            cpu_params, _ = model.init_params(seed=0, device="cpu")
            gpu_params = _to(cpu_params, dev)
            want = ServeSession(model=model, params=cpu_params, device="cpu").generate(
                prompt, max_new_tokens=N).tokens
            ops.reset_launches()
            got = ServeSession(model=model, params=gpu_params, device=dev).generate(
                prompt, max_new_tokens=N).tokens.cpu()
            counts = dict(ops.LAUNCHES)
            print(f"[cross-device] {arch} {kv}: cpu={want.tolist()} gpu={got.tolist()} "
                  f"launches={counts}")
            if not torch.equal(want, got):
                raise AssertionError(f"{arch} {kv}: greedy tokens differ between CPU and card")
            calls = (N + 1) * base.n_layers                  # prefill + N decode steps
            if counts["fused_moe_gemm"] != calls or counts["fused_moe_combine"] != calls:
                raise AssertionError(f"{arch} {kv}: MoE layers did not run through the "
                                     f"kernels: {counts}")


def full_width_moe(torch, ops, get_model, get_config, ServeSession, dev):
    """Phase 11: qwen3-moe-30b-a3b at its published size through
    ServeSession.generate."""
    B, P, N = 8, 512, 32
    cfg = get_config("qwen3-moe-30b-a3b")
    t0 = time.perf_counter()
    params, _ = get_model(cfg).init_params(seed=0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"[moe] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_experts} "
          f"experts top-{cfg.experts_per_token}, {n_params / 1e9:.3f} B params "
          f"({str(cfg.dtype)}), init {time.perf_counter() - t0:.1f} s, allocated "
          f"{torch.cuda.memory_allocated(dev) / 2**30:.3f} GiB")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    prompt = torch.randint(0, cfg.vocab, (B, P), generator=gen, device=dev)
    totals = {name: 0 for name in ops.LAUNCHES}
    results = {}
    for kv in ("native", "int8"):
        model = get_model(cfg.with_(kv_cache_dtype=kv))
        serve = ServeSession(model=model, params=params, device=dev)
        logits, cache = model.prefill(params, prompt, P + N + 1)    # warm-up + check
        torch.cuda.synchronize()
        if tuple(logits.shape) != (B, 1, cfg.vocab) or not torch.isfinite(logits).all():
            raise AssertionError(f"{kv}: prefill logits {tuple(logits.shape)} not finite")
        del logits, cache
        torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launches()
        out = serve.generate(prompt, max_new_tokens=N)
        counts = dict(ops.LAUNCHES)
        peak = torch.cuda.max_memory_allocated(dev)
        toks = out.tokens
        decode_op = "decode_attention_int8" if kv == "int8" else "decode_attention"
        print(f"[moe] {kv}: prefill {out.prefill_time * 1e3:.3f} ms, decode "
              f"{out.decode_tok_s:.3f} tok/s ({out.ms_per_step:.3f} ms/step), peak memory "
              f"{peak / 2**30:.3f} GiB, launches {counts}")
        if tuple(toks.shape) != (B, N + 1) or int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab:
            raise AssertionError(f"{kv}: tokens {tuple(toks.shape)} out of range")
        calls = (N + 1) * cfg.n_layers
        if (counts["fused_moe_gemm"] != calls or counts["fused_moe_combine"] != calls
                or counts["flash_attention"] != cfg.n_layers
                or counts[decode_op] != cfg.n_layers * N):
            raise AssertionError(f"{kv}: the MoE path did not run through the kernels: {counts}")
        for name, c in counts.items():
            totals[name] += c
        results[kv] = (out.ms_per_step, toks.cpu())
    agree = (results["native"][1] == results["int8"][1]).float().mean().item()
    print(f"[moe] native vs int8 KV: {agree:.3f} of generated tokens agree")
    del params
    torch.cuda.empty_cache()
    return totals, {kv: r[0] for kv, r in results.items()}


def profile_moe_serving(torch, get_model, get_config, dev, ms_per_step):
    """Phase 12, MoE serving: the decode step of phase 11."""
    B, P, N = 8, 512, 64
    cfg = get_config("qwen3-moe-30b-a3b")
    params, _ = get_model(cfg).init_params(seed=0, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    prompt = torch.randint(0, cfg.vocab, (B, P), generator=gen, device=dev)
    for kv, step_ms in ms_per_step.items():
        model = get_model(cfg.with_(kv_cache_dtype=kv))
        logits, cache = model.prefill(params, prompt, P + N + 1)
        busy = profile_decode(torch, model, params, cache, logits, P, moe=True)
        del logits, cache
        if busy is not None:
            print(f"[profile] moe {kv}: device busy {busy:.3f} ms of {step_ms:.3f} ms "
                  f"per decode step: idle share {1 - busy / step_ms:.3f}")
    del params
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Recurrent serving (rwkv6-7b, recurrentgemma-2b)
# ---------------------------------------------------------------------------

RECURRENT_CASES = (("rwkv6-7b", "native"), ("recurrentgemma-2b", "native"),
                   ("recurrentgemma-2b", "int8"))


def close_check(torch, label, got, want, rtol, atol):
    """``|got - want| <= atol + rtol |want|`` everywhere, or raise; returns
    the max abs error."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    err = diff.max().item()
    ok = bool(torch.isfinite(got).all()) and bool((diff <= atol + rtol * want.abs()).all())
    print(f"[check] {label}: max_abs_err={err:.3e} (rtol {rtol:.0e}, atol {atol:.3e}) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label} disagrees with its plain version")
    return err


def row_ulp_check(torch, label, got, want, ulps=2):
    """bf16 attention output against its plain version: each row (the last
    axis) within ``ulps`` bf16 ulps of that row's largest |want|, exactly 0
    where the row is all 0 (no live key).  Both sides compute in float32 and
    round once, so a 1-ulp rounding flip is the expected difference; a
    long-window row's outputs are small, so its bound is small too.  Returns
    the max abs error."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    rowmax = want.abs().amax(dim=-1, keepdim=True)
    exp = torch.frexp(rowmax).exponent.float()
    bnd = torch.where(rowmax > 0, ulps * torch.exp2(exp - 8), torch.zeros_like(rowmax))
    err = diff.max().item()
    ratio = (diff / torch.where(bnd > 0, bnd, torch.ones_like(bnd))).max().item()
    ok = bool(torch.isfinite(got).all()) and bool((diff <= bnd).all())
    print(f"[check] {label}: max_abs_err={err:.3e}, max err/bound={ratio:.3f} "
          f"(bound {ulps} bf16 ulps of each row's max |want|) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label} disagrees with its plain version")
    return err


def wkv6_edge_checks(torch, R, dev, int8):
    """Phases 13 and 17: WKV-6 cases of their own generator (the phases'
    other cases draw what they drew before) against the plain version, for
    the float entry or (``int8``) the int8 entry at the training quantizer's
    rows: bf16 at S 45 and 300 (not multiples of the chunked kernel's 16
    steps), at head dim 16, and with decays near 1e-30 (the floor) and near 1
    (a long memory)."""
    from repro_torch.kernels.quantize import quantize_rows
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan, rwkv6_scan_int8

    gen = torch.Generator(device=dev)
    gen.manual_seed(9191)
    bf16 = torch.bfloat16

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    def q8(x):
        q, s = quantize_rows(x.reshape(-1, x.shape[-1]), 0.5)
        return q.view(x.shape), s.view(x.shape[:-1] + (1,))

    for label, (B, S, H, D), decay in (("S=45", (2, 45, 4, 64), "model"),
                                       ("S=300", (2, 300, 4, 64), "model"),
                                       ("D=16", (2, 45, 4, 16), "model"),
                                       ("decay ~1e-30", (2, 300, 4, 64), "floor"),
                                       ("decay ~1", (2, 300, 4, 64), "one")):
        r, k, v = (randn(B, S, H, D).to(bf16) for _ in range(3))
        if decay == "model":
            w = torch.exp(-torch.exp(randn(B, S, H, D) * 0.5))
        elif decay == "floor":
            w = 1e-30 * (1 + torch.rand(B, S, H, D, generator=gen, device=dev))
        else:
            w = 1 - 0.01 * torch.rand(B, S, H, D, generator=gen, device=dev)
        w, u = w.to(bf16), randn(H, D)
        if int8:
            (rq, rs), (kq, ks), (vq, vs) = q8(r), q8(k), q8(v)
            out, state = rwkv6_scan_int8(rq, rs, kq, ks, vq, vs, w, u, bf16)
            want_out, want_state = R.rwkv6_scan_ref(
                R.dequantize_int8_ref(rq, rs), R.dequantize_int8_ref(kq, ks),
                R.dequantize_int8_ref(vq, vs), w, u)
            name = "rwkv6_scan_q8"
        else:
            out, state = rwkv6_scan(r, k, v, w, u)
            want_out, want_state = R.rwkv6_scan_ref(r, k, v, w, u)
            name = "rwkv6_scan"
        torch.cuda.synchronize()
        # as the phases hold the bf16 kernels: one bf16 ulp of the largest
        # |out|; the state to rtol 1e-4 plus 1e-4 of its largest |value|
        tag = f"{name} edge {label} {(B, S, H, D)}"
        want_out = want_out.to(bf16)
        atol = 2.0 ** (math.frexp(want_out.float().abs().max().item())[1] - 8)
        close_check(torch, f"{tag} bf16 out", out, want_out, 0.0, atol)
        close_check(torch, f"{tag} state", state, want_state, 1e-4,
                    1e-4 * want_state.abs().max().item())


def bit_check(torch, label, got, want):
    """``got`` equals ``want`` bit for bit; -> 0.0, the error."""
    torch.cuda.synchronize()
    same = torch.equal(got, want)
    print(f"[check] {label}: {'bit-equal' if same else 'DIFFERS'}")
    if not same:
        err = (got.float() - want.float()).abs().max().item()
        raise AssertionError(f"{label} differs from its plain version (max_abs_err={err:.3e})")
    return 0.0


def rglru_edge_checks(torch, R, dev, int8):
    """The RG-LRU scan's cases of its own, bit for bit against the plain
    version: the float entry or (``int8``) the int8 entry over the training
    quantizer's x.  S of 1, 45, 300 and 513 (no multiples of the kernel's
    32-step tiles), W of 300 (a partial block; for int8 x, rows that are no
    multiple of 16 bytes) and 33 (no multiple of 4: 4-byte pieces), B of 1,
    and decays of exactly 1.0 (every third channel) and near 0 (every third
    from the second, 1e-30 to 1e-6) among decays in (0.5, 1)."""
    from repro_torch.kernels.quantize import quantize_rows
    from repro_torch.kernels.rglru_scan import rglru_scan, rglru_scan_int8

    gen = torch.Generator(device=dev)
    gen.manual_seed(1357)
    name = "rglru_scan_q8" if int8 else "rglru_scan"
    for B, S, W in ((2, 1, 2560), (2, 45, 2560), (2, 300, 2560), (2, 513, 2560),
                    (2, 45, 300), (1, 513, 300), (3, 70, 33)):
        a = torch.rand(B, S, W, generator=gen, device=dev) * 0.5 + 0.5
        a[..., 0::3] = 1.0
        a[..., 1::3] = 10.0 ** (-6.0 - 24.0 * torch.rand(B, S, len(range(1, W, 3)),
                                                         generator=gen, device=dev))
        x = torch.randn(B, S, W, generator=gen, device=dev)
        if int8:
            q, s = quantize_rows(x.view(-1, W), 0.5)
            xq, xs = q.view(B, S, W), s.view(B, S, 1)
            got, want = rglru_scan_int8(a, xq, xs), R.rglru_scan_ref(
                a, R.dequantize_int8_ref(xq, xs))
        else:
            got, want = rglru_scan(a, x), R.rglru_scan_ref(a, x)
        bit_check(torch, f"{name} edge {(B, S, W)}, decays of 1.0 and near 0", got, want)


def recurrent_kernel_checks(torch, R, F, dev):
    """Phase 13: the two scan kernels and the attention kernels at the
    recurrent serving path's shapes against their plain versions on the card."""
    from repro_torch.kernels.decode_attention import decode_attention, decode_attention_int8
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.rglru_scan import rglru_scan
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan

    gen = torch.Generator(device=dev)
    gen.manual_seed(6060)
    scratch = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    flush = scratch.zero_
    bf16, f32 = torch.bfloat16, torch.float32
    records = []

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    # -- WKV-6 scan: rwkv6-7b's prefill (B 8, S 512, 64 heads of 64), and a
    #    ragged smoke-size case; w as the model makes it, exp(-exp(.)) in (0, 1)
    for label, (B, S, H, D), dtype in (("prefill", (8, 512, 64, 64), bf16),
                                       ("ragged", (2, 45, 4, 16), f32)):
        r, k, v = (randn(B, S, H, D).to(dtype) for _ in range(3))
        w = torch.exp(-torch.exp(randn(B, S, H, D) * 0.5)).to(dtype)
        u = randn(H, D)
        out, state = rwkv6_scan(r, k, v, w, u)
        want_out, want_state = R.rwkv6_scan_ref(r, k, v, w, u)
        torch.cuda.synchronize()
        if dtype == bf16:
            # one bf16 ulp of the largest |out|: both compute the same f32
            # value up to summation order, then round once
            atol = 2.0 ** (math.frexp(want_out.float().abs().max().item())[1] - 8)
            err = close_check(torch, f"rwkv6_scan {label} {(B, S, H, D)} bf16 out", out,
                              want_out, 0.0, atol)
        else:
            err = close_check(torch, f"rwkv6_scan {label} {(B, S, H, D)} f32 out", out,
                              want_out, 1e-4, 1e-5)
        # the state sums terms of both signs: rtol 1e-4 plus 1e-4 of its largest |value|
        close_check(torch, f"rwkv6_scan {label} state", state, want_state, 1e-4,
                    1e-4 * want_state.abs().max().item())
        if label == "prefill":
            nbytes = 5 * r.numel() * r.element_size() + u.numel() * 4 + state.numel() * 4
            b_ms, b_by = bound(nbytes, wkv6_ops(B, S, H, D), "bfloat16")
            records.append(dict(
                name="rwkv6_scan", path="recurrent_serving", shape=f"prefill {(B, S, H, D)}",
                route="cuda", source="src/repro_torch/kernels/csrc/rwkv6_scan.cu",
                replaces="src/repro/kernels/rwkv6_scan.py:119",
                launches=0, max_abs_err=err,
                ms=timed_ms(lambda: rwkv6_scan(r, k, v, w, u), flush),
                plain_ms=timed_plain(lambda: R.rwkv6_scan_ref(r, k, v, w, u), flush),
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
            ))
        del r, k, v, w, u, out, state, want_out, want_state
    wkv6_edge_checks(torch, R, dev, int8=False)

    # -- RG-LRU scan: recurrentgemma-2b's prefill (B 8, S 512, lru_width 2560)
    #    and a case ragged in S and W; decays in (0.5, 0.999) so the carry
    #    lives; bit for bit (both round a multiply, then an add, in step order)
    for label, (B, S, W) in (("prefill", (8, 512, 2560)), ("ragged", (2, 45, 300))):
        a = torch.rand(B, S, W, generator=gen, device=dev) * 0.499 + 0.5
        x = randn(B, S, W)
        err = bit_check(torch, f"rglru_scan {label} {(B, S, W)} f32", rglru_scan(a, x),
                        R.rglru_scan_ref(a, x))
        if label == "prefill":
            b_ms, b_by = bound(3 * x.numel() * 4, 2.0 * x.numel(), "float32")
            records.append(dict(
                name="rglru_scan", path="recurrent_serving", shape=f"prefill {(B, S, W)}",
                route="cuda", source="src/repro_torch/kernels/csrc/rglru_scan.cu",
                replaces="src/repro/kernels/rglru_scan.py:65",
                launches=0, max_abs_err=err,
                ms=timed_ms(lambda: rglru_scan(a, x), flush),
                plain_ms=timed_plain(lambda: R.rglru_scan_ref(a, x), flush),
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
            ))
        del a, x
    rglru_edge_checks(torch, R, dev, int8=False)

    # -- attention at recurrentgemma-2b's shapes: 10 query heads over one kv
    #    head of 256 (MQA), local window 2048, a prompt longer than the window
    B, S, H, Hkv, D, WIN = 8, 3072, 10, 1, 256, 2048
    q, kk, vv = randn(B, S, H, D).to(bf16), randn(B, S, Hkv, D).to(bf16), \
        randn(B, S, Hkv, D).to(bf16)
    err = row_ulp_check(torch, f"flash_attention MQA-10 D=256 window {WIN} S={S} bf16",
                        flash_attention_fwd(q, kk, vv, causal=True, window=WIN),
                        R.flash_attention_ref(q, kk, vv, causal=True, window=WIN))
    pairs = WIN * (WIN + 1) // 2 + (S - WIN) * WIN      # live (query, key) pairs per head
    qt, kt, vt = (t.transpose(1, 2) for t in (q, kk, vv))
    pos = torch.arange(S, device=dev)
    mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - WIN)
    b_ms, b_by = bound(2 * (q.numel() + kk.numel()) * 2, 4.0 * D * B * H * pairs, "bfloat16")
    records.append(dict(
        name="flash_attention", path="recurrent_serving",
        shape=f"prefill MQA-10 D=256 S={S} window {WIN}", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:133",
        launches=0, max_abs_err=err,
        ms=timed_ms(lambda: flash_attention_fwd(q, kk, vv, causal=True, window=WIN), flush),
        plain_ms=timed_plain(lambda: R.flash_attention_ref(q, kk, vv, causal=True, window=WIN),
                          flush),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=timed_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True), flush),
    ))
    del q, kk, vv, qt, kt, vt, mask

    CACHE = WIN
    valid = torch.tensor([2048, 1, 1000, 2047, 577, 0, 1500, 2048], dtype=torch.int32,
                         device=dev)
    rows = int(valid.sum())
    q = randn(B, 1, H, D).to(bf16)
    kc, vc = randn(B, CACHE, Hkv, D).to(bf16), randn(B, CACHE, Hkv, D).to(bf16)
    err = row_ulp_check(torch, "decode_attention MQA-10 D=256 bf16",
                        decode_attention(q, kc, vc, valid),
                        R.decode_attention_ref(q, kc, vc, valid))
    amask = (torch.arange(CACHE, device=dev)[None, :] < valid[:, None])[:, None, None, :]
    qt, kt, vt = q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2)
    b_ms, b_by = bound(2 * rows * Hkv * D * 2 + 2 * q.numel() * 2 + B * 4,
                       4.0 * D * H * rows, "bfloat16")
    records.append(dict(
        name="decode_attention", path="recurrent_serving", shape="decode MQA-10 D=256",
        route="cuda", source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:327",
        launches=0, max_abs_err=err,
        ms=timed_ms(lambda: decode_attention(q, kc, vc, valid), flush),
        plain_ms=timed_plain(lambda: R.decode_attention_ref(q, kc, vc, valid), flush),
        bound_ms=b_ms, bound_by=b_by,
        # valid_len 0 rows give NaN here (all masked); timing only
        library_ms=timed_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=amask, enable_gqa=True), flush),
    ))
    kq, ks = R.quantize_int8_ref(kc)
    vq, vs = R.quantize_int8_ref(vc)
    err = row_ulp_check(torch, "decode_attention_int8 MQA-10 D=256 bf16",
                        decode_attention_int8(q, kq, ks, vq, vs, valid),
                        R.decode_attention_int8_ref(q, kq, ks, vq, vs, valid))
    b_ms, b_by = bound(2 * rows * Hkv * (D + 4) + 2 * q.numel() * 2 + B * 4,
                       4.0 * D * H * rows, "bfloat16")
    records.append(dict(
        name="decode_attention_int8", path="recurrent_serving", shape="decode MQA-10 D=256",
        route="cuda", source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:378",
        launches=0, max_abs_err=err,
        ms=timed_ms(lambda: decode_attention_int8(q, kq, ks, vq, vs, valid), flush),
        plain_ms=timed_plain(lambda: R.decode_attention_int8_ref(q, kq, ks, vq, vs, valid),
                          flush),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
    ))
    del q, kc, vc, qt, kt, vt, kq, ks, vq, vs, amask, scratch
    torch.cuda.empty_cache()
    for rec in records:
        print(json.dumps(rec))
    return records


def _expected_launches(cfg, kv, prefills, decode_steps):
    """Launches of the recurrent path's kernels for ``prefills`` batched
    prefills and ``decode_steps`` decode steps of ``cfg``."""
    if cfg.family == "rwkv6":
        return {"rwkv6_scan": prefills * cfg.n_layers}
    kinds = [cfg.block_pattern[i % len(cfg.block_pattern)] for i in range(cfg.n_layers)]
    n_a = kinds.count("A")
    decode_op = "decode_attention_int8" if kv == "int8" else "decode_attention"
    return {"rglru_scan": prefills * (cfg.n_layers - n_a), "flash_attention": prefills * n_a,
            decode_op: decode_steps * n_a}


def _check_launches(counts, expect, what):
    bad = {k: (counts[k], n) for k, n in expect.items() if counts[k] != n}
    if bad:
        raise AssertionError(f"{what}: launches (got, expected) {bad}: {counts}")


def _per_leaf(fn, *trees, prefix=""):
    """``{"A/k": fn(leaf of each tree), ...}`` over nested dicts of tensors."""
    if isinstance(trees[0], dict):
        out = {}
        for k in trees[0]:
            out.update(_per_leaf(fn, *(t[k] for t in trees), prefix=f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: fn(*trees)}


def _cache_diff(a, b):
    """Largest |a - b| per cache leaf."""
    return _per_leaf(lambda x, y: (x.float() - y.float()).abs().max().item(), a, b)


def cross_device_recurrent(torch, ops, get_model, smoke_config, ServeSession, dev):
    """Phase 14: both recurrent smoke configs in f32, the plain path on the CPU
    vs the kernels on the card, through ServeSession.generate and through the
    batched route; on the card, the batched prefill's cache against the
    stepped prefill's."""
    B, P, N = 2, 13, 6                  # prompt 13 > recurrentgemma's window 8
    prompt = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (B, P)))
    gprompt = prompt.to(dev)
    for arch, kv in RECURRENT_CASES:
        cfg = smoke_config(arch).with_(kv_cache_dtype=kv)
        model = get_model(cfg)
        cpu_params, _ = model.init_params(seed=0, device="cpu")
        gpu_params = _to(cpu_params, dev)
        serve = ServeSession(model=model, params=gpu_params, device=dev)
        want = ServeSession(model=model, params=cpu_params, device="cpu").generate(
            prompt, max_new_tokens=N).tokens
        ops.reset_launches()
        got = serve.generate(gprompt, max_new_tokens=N).tokens.cpu()
        counts = dict(ops.LAUNCHES)
        print(f"[cross-device] {arch} {kv} generate: cpu={want.tolist()} gpu={got.tolist()} "
              f"launches={counts}")
        if not torch.equal(want, got):
            raise AssertionError(f"{arch} {kv}: generate tokens differ between CPU and card")
        expect = {k: 0 for k in ("rwkv6_scan", "rglru_scan", "flash_attention")}
        expect.update({k: n for k, n in _expected_launches(cfg, kv, 0, P + N).items() if n})
        _check_launches(counts, expect, f"{arch} {kv} generate")

        cache_len = P + N + 1
        want_b = generate_batched(model, cpu_params, prompt, N, cache_len)[0]
        ops.reset_launches()
        got_b = generate_batched(model, gpu_params, gprompt, N, cache_len)[0].cpu()
        counts = dict(ops.LAUNCHES)
        print(f"[cross-device] {arch} {kv} batched: cpu={want_b.tolist()} gpu={got_b.tolist()} "
              f"launches={counts}")
        if not torch.equal(want_b, got_b):
            raise AssertionError(f"{arch} {kv}: batched-route tokens differ between CPU and card")
        _check_launches(counts, _expected_launches(cfg, kv, 1, N), f"{arch} {kv} batched")

        _, batched = model.prefill(gpu_params, gprompt, cache_len)
        _, stepped = serve._prefill_recurrent(gprompt, cache_len)
        diff = _cache_diff(batched, stepped)
        # int8 cache bytes: K/V from a batched and a one-row matmul may fall
        # on either side of a rounding tie, so 1 LSB
        bad = {k: d for k, d in diff.items()
               if not d <= (1.0 if k in ("A/k", "A/v") and kv == "int8" else 1e-3)}
        print(f"[cross-device] {arch} {kv}: batched vs stepped prefill cache, max |diff| per "
              f"leaf {diff} {'ok' if not bad else 'FAIL'}")
        if bad:
            raise AssertionError(f"{arch} {kv}: batched and stepped prefill caches differ: {bad}")


def full_width_recurrent(torch, ops, get_model, get_config, ServeSession, dev):
    """Phases 15-16 (and the full-width half of 14's comparison): both
    recurrent configs at their published size, random weights from seed 0."""
    B, P, N = 8, 512, 64
    P_LONG, N_LONG = 3072, 16
    P_STATE = 64
    totals = {name: 0 for name in ops.LAUNCHES}
    decode_ms = {}
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def run(model, cfg, kv, params, prompt, n_new, what):
        P_ = prompt.shape[1]
        # the first prefill at this shape, timed apart and checked: it holds
        # the one-time costs (allocator growth, first launches at new shapes)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, prompt, P_ + n_new + 1)
        torch.cuda.synchronize(dev)
        first_s = time.perf_counter() - t0
        if tuple(logits.shape) != (B, 1, cfg.vocab) or not torch.isfinite(logits).all():
            raise AssertionError(f"{cfg.name} {kv} {what}: prefill logits not finite")
        del logits, cache
        torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launches()
        toks, pre_s, dec_s = generate_batched(model, params, prompt, n_new, P_ + n_new + 1)
        counts = dict(ops.LAUNCHES)
        peak = torch.cuda.max_memory_allocated(dev)
        ms_step = dec_s / n_new * 1e3
        print(f"[recurrent] {cfg.name} {kv} {what}: batch {B}, prompt {P_}: prefill "
              f"{pre_s * 1e3:.3f} ms (the first at this shape {first_s * 1e3:.3f} ms), "
              f"decode {ms_step:.3f} ms/step "
              f"({n_new * B / dec_s:.3f} tok/s), peak memory {peak / 2**30:.3f} GiB, "
              f"launches {counts}")
        if (tuple(toks.shape) != (B, n_new + 1) or int(toks.min()) < 0
                or int(toks.max()) >= cfg.vocab):
            raise AssertionError(f"{cfg.name} {kv}: tokens {tuple(toks.shape)} out of range")
        _check_launches(counts, _expected_launches(cfg, kv, 1, n_new), f"{cfg.name} {kv} {what}")
        for name, c in counts.items():
            totals[name] += c
        return pre_s, ms_step

    for arch in ("rwkv6-7b", "recurrentgemma-2b"):
        cfg = get_config(arch)
        t0 = time.perf_counter()
        params, _ = get_model(cfg).init_params(seed=0, device=dev)
        torch.cuda.synchronize()
        n_params = sum(t.numel() for t in _leaves(params))
        print(f"[recurrent] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
              f"{n_params / 1e9:.3f} B params ({str(cfg.dtype)}), init "
              f"{time.perf_counter() - t0:.1f} s")
        prompt = torch.randint(0, cfg.vocab, (B, P), generator=gen, device=dev)
        batched_prefill_s = {}
        for a, kv in RECURRENT_CASES:
            if a != arch:
                continue
            model = get_model(cfg.with_(kv_cache_dtype=kv))
            batched_prefill_s[kv], decode_ms[(arch, kv)] = run(
                model, cfg, kv, params, prompt, N, "batched route")

        model = get_model(cfg)
        if cfg.family == "rglru":
            # phase 15: a prompt longer than the window: the rotating cache
            # from the first decode step, the windowed flash with tile skips
            long_prompt = torch.randint(0, cfg.vocab, (B, P_LONG), generator=gen, device=dev)
            run(model, cfg, "native", params, long_prompt, N_LONG,
                f"prompt {P_LONG} > window {cfg.window}")
            del long_prompt

        # phase 16: the reference's own recurrent route, the prompt stepped
        # through decode_step, over the first half of the layers (the whole
        # depth took 93 s of a slow host's run; the step is host-bound, so its
        # time scales with the layers)
        half = cfg.with_(n_layers=cfg.n_layers // 2)
        torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launches()
        out = ServeSession(model=get_model(half), params=params, device=dev).generate(
            prompt, max_new_tokens=N)
        counts = dict(ops.LAUNCHES)
        peak = torch.cuda.max_memory_allocated(dev)
        expect = {k: 0 for k in ("rwkv6_scan", "rglru_scan", "flash_attention")}
        expect.update({k: n for k, n in _expected_launches(half, "native", 0, P + N).items() if n})
        _check_launches(counts, expect, f"{arch} generate")
        for name, c in counts.items():
            totals[name] += c
        print(f"[recurrent] {cfg.name} native ServeSession.generate over {half.n_layers} of "
              f"{cfg.n_layers} layers: prefill (prompt stepped through decode_step) "
              f"{out.prefill_time * 1e3:.3f} ms vs batched prefill over all {cfg.n_layers} "
              f"{batched_prefill_s['native'] * 1e3:.3f} ms; decode {out.ms_per_step:.3f} ms/step "
              f"({out.decode_tok_s:.3f} tok/s), peak memory {peak / 2**30:.3f} GiB, "
              f"launches {counts}")
        serve = ServeSession(model=model, params=params, device=dev)
        # the two routes' states, a reading: the prompt cut to P_STATE (512
        # stepped decode steps more would double the phase; 64 since phase
        # 36), in bf16 and in float32, where rounding does not pile up
        # through the layers
        short = prompt[:, :P_STATE]
        for dtype in dict.fromkeys((cfg.dtype, torch.float32)):
            if dtype != cfg.dtype:
                del params, serve
                torch.cuda.empty_cache()
                model = get_model(cfg.with_(dtype=dtype))
                params, _ = model.init_params(seed=0, device=dev)
                serve = ServeSession(model=model, params=params, device=dev)
            _, batched = model.prefill(params, short, P_STATE + 1)
            _, stepped = serve._prefill_recurrent(short, P_STATE + 1)
            print(f"[recurrent] {cfg.name}: batched vs stepped prefill state, prompt {P_STATE}, "
                  f"{str(dtype).split('.')[-1]} (a reading): max |diff| per leaf "
                  f"{_cache_diff(batched, stepped)}, max |value| per leaf "
                  f"{_per_leaf(lambda x: x.float().abs().max().item(), stepped)}")
            del batched, stepped
        del params, model, serve, out, prompt, short
        torch.cuda.empty_cache()
    return totals, decode_ms


def profile_recurrent_serving(torch, get_model, get_config, dev, ms_per_step):
    """Phase 12, recurrent serving: the decode step of phase 15's batched route."""
    B, P, N = 8, 512, 64
    for arch in ("rwkv6-7b", "recurrentgemma-2b"):
        cfg = get_config(arch)
        params, _ = get_model(cfg).init_params(seed=0, device=dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        prompt = torch.randint(0, cfg.vocab, (B, P), generator=gen, device=dev)
        for (a, kv), step_ms in ms_per_step.items():
            if a != arch:
                continue
            model = get_model(cfg.with_(kv_cache_dtype=kv))
            logits, cache = model.prefill(params, prompt, P + N + 1)
            busy = profile_decode(torch, model, params, cache, logits, P)
            del logits, cache
            if busy is not None:
                print(f"[profile] {arch} {kv}: device busy {busy:.3f} ms of {step_ms:.3f} ms "
                      f"per decode step: idle share {1 - busy / step_ms:.3f}")
        del params
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Recurrent training (rwkv6-7b, recurrentgemma-2b)
# ---------------------------------------------------------------------------


def grad_check(torch, label, got, want, share):
    """Each gradient within ``share`` of its largest |want|, or raise."""
    for name, g, w in zip(label[1], got, want):
        if g.dtype != w.dtype:
            raise AssertionError(f"{label[0]} d{name}: dtype {g.dtype} != {w.dtype}")
        close_check(torch, f"{label[0]} d{name} ({str(g.dtype).split('.')[-1]})", g, w, 0.0,
                    share * w.float().abs().max().item())


def recurrent_train_kernel_checks(torch, ops, R, F, dev):
    """Phase 17: the recurrent training path's kernels at its full-width
    shapes (and ragged smoke-size ones) against their plain versions on the
    card, and the gradients of its differentiable ops against the plain
    ops' gradients."""
    from repro_torch.kernels.flash_attention import flash_attention_fwd, flash_attention_int8_fwd
    from repro_torch.kernels.quantize import quantize_rows
    from repro_torch.kernels.rglru_scan import rglru_scan, rglru_scan_int8
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan, rwkv6_scan_int8

    gen = torch.Generator(device=dev)
    gen.manual_seed(7070)
    scratch = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    flush = scratch.zero_
    bf16, f32 = torch.bfloat16, torch.float32
    records = []

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    def q8(x):
        """The training quantizer's int8 and scales over the last axis."""
        q, s = quantize_rows(x.reshape(-1, x.shape[-1]), 0.5)
        return q.view(x.shape), s.view(x.shape[:-1] + (1,))

    def deq(q, s):
        return R.dequantize_int8_ref(q, s)

    def record(name, shape, source, replaces, err, kernel, plain, nbytes, flops, dtype,
               library=None):
        b_ms, b_by = bound(nbytes, flops, dtype)
        records.append(dict(
            name=name, path="recurrent_training", shape=shape, route="cuda",
            source=f"src/repro_torch/kernels/csrc/{source}",
            replaces=f"src/repro/kernels/{replaces}", launches=0, max_abs_err=err,
            ms=timed_ms(kernel, flush), plain_ms=timed_plain(plain, flush),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=None if library is None else timed_ms(library, flush)))

    # -- WKV-6, float and int8: rwkv6-7b's training shape (60 rows, seq 256,
    #    64 heads of 64, bf16) and a ragged smoke-size one (f32)
    for label, (B, S, H, D), dtype in (("train", (60, 256, 64, 64), bf16),
                                       ("ragged", (2, 45, 4, 16), f32)):
        r, k, v = (randn(B, S, H, D).to(dtype) for _ in range(3))
        w = torch.exp(-torch.exp(randn(B, S, H, D) * 0.5)).to(dtype)
        u = randn(H, D)
        (rq, rs), (kq, ks), (vq, vs) = q8(r), q8(k), q8(v)
        rd, kd, vd = deq(rq, rs), deq(kq, ks), deq(vq, vs)
        ops_ = wkv6_ops(B, S, H, D)
        for name, kernel, plain in (
                ("rwkv6_scan", lambda: rwkv6_scan(r, k, v, w, u),
                 lambda: R.rwkv6_scan_ref(r, k, v, w, u)),
                ("rwkv6_scan_q8", lambda: rwkv6_scan_int8(rq, rs, kq, ks, vq, vs, w, u, dtype),
                 lambda: R.rwkv6_scan_ref(rd, kd, vd, w, u))):
            out, state = kernel()
            want_out, want_state = plain()
            want_out = want_out.to(dtype)
            torch.cuda.synchronize()
            if dtype == bf16:
                # one bf16 ulp of the largest |out|, as phase 13 bounds the float kernel
                atol = 2.0 ** (math.frexp(want_out.float().abs().max().item())[1] - 8)
                err = close_check(torch, f"{name} {label} {(B, S, H, D)} bf16 out", out,
                                  want_out, 0.0, atol)
            else:
                err = close_check(torch, f"{name} {label} {(B, S, H, D)} f32 out", out,
                                  want_out, 1e-4, 1e-5)
            close_check(torch, f"{name} {label} state", state, want_state, 1e-4,
                        1e-4 * want_state.abs().max().item())
            if label == "train":
                act = 3 * r.numel() * (1 if name.endswith("q8") else r.element_size())
                scales = 3 * rs.numel() * 4 if name.endswith("q8") else 0
                nbytes = (act + scales + 2 * w.numel() * w.element_size() + u.numel() * 4
                          + state.numel() * 4)                    # w in, out (same dtype)
                record(name, f"train {(B, S, H, D)}", "rwkv6_scan.cu",
                       "rwkv6_scan.py:171" if name.endswith("q8") else "rwkv6_scan.py:119",
                       err, kernel, plain, nbytes, ops_, "bfloat16")
            del out, state, want_out, want_state
        del r, k, v, w, u, rq, rs, kq, ks, vq, vs, rd, kd, vd
    for int8 in (False, True):
        wkv6_edge_checks(torch, R, dev, int8)

    # -- RG-LRU, float and int8: recurrentgemma-2b's training shape (60 rows,
    #    seq 128, lru width 2560, f32 gates) and a ragged one; bit for bit,
    #    and the quantizer at rows of W bit for bit too
    for label, (B, S, W) in (("train", (60, 128, 2560)), ("ragged", (2, 45, 300))):
        a = torch.rand(B, S, W, generator=gen, device=dev) * 0.499 + 0.5
        x = randn(B, S, W)
        if label == "train":
            records.append(quant_record(torch, R, "recurrent_training", x.view(-1, W), flush))
        else:
            quant_check(torch, R, f"rows of {W} f32 {tuple(x.shape)}", x.view(-1, W), 0.5)
        xq, xs = q8(x)
        xd = deq(xq, xs)
        for name, kernel, plain in (("rglru_scan", lambda: rglru_scan(a, x),
                                     lambda: R.rglru_scan_ref(a, x)),
                                    ("rglru_scan_q8", lambda: rglru_scan_int8(a, xq, xs),
                                     lambda: R.rglru_scan_ref(a, xd))):
            bit_check(torch, f"{name} {label} {(B, S, W)} f32", kernel(), plain())
            if label == "train":
                x_bytes = xq.numel() + xs.numel() * 4 if name.endswith("q8") else x.numel() * 4
                record(name, f"train {(B, S, W)}", "rglru_scan.cu",
                       "rglru_scan.py:103" if name.endswith("q8") else "rglru_scan.py:65",
                       0.0, kernel, plain, 2 * a.numel() * 4 + x_bytes, 2.0 * x.numel(),
                       "float32")
        del a, x, xq, xs, xd
    rglru_edge_checks(torch, R, dev, int8=True)

    # -- the quantizer at the path's other rows, bit for bit: rwkv6-7b's r, k
    #    and v (60 x 256 x 64 heads, rows of 64 bf16) and recurrentgemma-2b's
    #    K and V (60 x 128 x one kv head, rows of 256 bf16)
    for R_, N in ((60 * 256 * 64, 64), (60 * 128, 256)):
        rows = randn(R_, N).to(bf16)
        records.append(quant_record(torch, R, "recurrent_training", rows, flush))
        del rows

    # -- flash attention, float and int8 K/V, at recurrentgemma's head dims:
    #    D = 256 at its training shape (60 rows, seq 128, 10 query heads over
    #    one kv head, window 2048), D = 32 at its smoke shape (window 8)
    for label, (B, S, H, Hkv, D, WIN), dtype in (
            ("train", (60, 128, 10, 1, 256, 2048), bf16),
            ("smoke", (2, 13, 2, 1, 32, 8), f32)):
        q, kk, vv = randn(B, S, H, D).to(dtype), randn(B, S, Hkv, D).to(dtype), \
            randn(B, S, Hkv, D).to(dtype)
        (kq, ks), (vq, vs) = q8(kk), q8(vv)
        kd, vd = deq(kq, ks), deq(vq, vs)
        pairs = sum(min(i + 1, WIN) for i in range(S))    # live (query, key) pairs per head
        flops = 4.0 * D * B * H * pairs
        for name, kernel, plain in (
                ("flash_attention",
                 lambda: flash_attention_fwd(q, kk, vv, causal=True, window=WIN),
                 lambda: R.flash_attention_ref(q, kk, vv, causal=True, window=WIN)),
                ("flash_attention_q8",
                 lambda: flash_attention_int8_fwd(q, kq, ks, vq, vs, causal=True, window=WIN),
                 lambda: R.flash_attention_ref(q, kd, vd, causal=True, window=WIN))):
            tag = f"{name} MQA-{H} D={D} S={S} window {WIN} {str(dtype).split('.')[-1]}"
            if dtype == bf16:
                err = row_ulp_check(torch, tag, kernel(), plain())
            else:
                err = close_check(torch, tag, kernel(), plain(), 1e-4, 1e-5)
            if label == "train":
                kv_bytes = (kq.numel() * 2 + ks.numel() * 8 if name.endswith("q8")
                            else 2 * kk.numel() * kk.element_size())
                qt, kt, vt = (t.transpose(1, 2) for t in (q, kk, vv))
                library = None if name.endswith("q8") else (
                    lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                           enable_gqa=True))
                record(name, f"train MQA-{H} D={D} S={S}", "flash_attention.cu",
                       "flash_attention.py:200" if name.endswith("q8")
                       else "flash_attention.py:133",
                       err, kernel, plain, 2 * q.numel() * q.element_size() + kv_bytes, flops,
                       "bfloat16", library)
                del qt, kt, vt
        del q, kk, vv, kq, ks, vq, vs, kd, vd

    # -- gradients: each differentiable op of the path with its kernel (on
    #    the card) against the plain op's autograd gradients; the int8-fused
    #    ops' gradients are the plain op's at the dequantized inputs (the
    #    reference's straight-through vjp), cast to the inputs' dtypes.
    #    Batch cut to 4 rows (the plain WKV's autograd keeps ~3 (B, H, D, D)
    #    f32 tensors per step); every other axis as in training.
    def grads_of(fn, inputs, cots):
        leaves = [t.detach().requires_grad_() for t in inputs]
        outs = fn(*leaves)
        outs = outs if isinstance(outs, tuple) else (outs,)
        loss = sum((o.float() * c).sum() for o, c in zip(outs, cots))
        return torch.autograd.grad(loss, leaves)

    B = 4
    r, k, v = (randn(B, 256, 64, 64).to(bf16) for _ in range(3))
    w = torch.exp(-torch.exp(randn(B, 256, 64, 64) * 0.5)).to(bf16)
    u = randn(64, 64)
    cots = (randn(B, 256, 64, 64), randn(B, 64, 64, 64))
    rd, kd, vd = (deq(*q8(t)) for t in (r, k, v))
    grad_check(torch, ("ops.rwkv6_scan", "rkvwu"),
               grads_of(ops.rwkv6_scan, (r, k, v, w, u), cots),
               grads_of(R.rwkv6_scan_ref, (r, k, v, w, u), cots), 2 ** -7)
    # the reference's vjp: of the plain scan with its output cast to r's dtype
    want = grads_of(lambda *a: (lambda o, st: (o.to(bf16), st))(*R.rwkv6_scan_ref(*a)),
                    (rd, kd, vd, w, u), cots)
    want = [g.to(t.dtype) for g, t in zip(want, (r, k, v, w, u))]
    grad_check(torch, ("ops.rwkv6_scan_q8", "rkvwu"),
               grads_of(ops.rwkv6_scan_q8, (r, k, v, w, u), cots), want, 2 ** -7)
    del r, k, v, w, u, cots, rd, kd, vd, want

    a = torch.rand(B, 128, 2560, generator=gen, device=dev) * 0.499 + 0.5
    x = randn(B, 128, 2560)
    cot = (randn(B, 128, 2560),)
    grad_check(torch, ("ops.rglru_scan", "ax"), grads_of(ops.rglru_scan, (a, x), cot),
               grads_of(R.rglru_scan_ref, (a, x), cot), 1e-5)
    grad_check(torch, ("ops.rglru_scan_q8", "ax"), grads_of(ops.rglru_scan_q8, (a, x), cot),
               grads_of(R.rglru_scan_ref, (a, deq(*q8(x))), cot), 1e-5)
    del a, x, cot

    q, kk, vv = randn(B, 128, 10, 256).to(bf16), randn(B, 128, 1, 256).to(bf16), \
        randn(B, 128, 1, 256).to(bf16)
    cot = (randn(B, 128, 10, 256),)
    kd, vd = deq(*q8(kk)), deq(*q8(vv))
    want = grads_of(lambda *t: R.flash_attention_ref(*t, causal=True, window=2048),
                    (q, kd, vd), cot)
    grad_check(torch, ("ops.flash_attention_q8 D=256", "qkv"),
               grads_of(lambda *t: ops.flash_attention_q8(*t, causal=True, window=2048),
                        (q, kk, vv), cot), [g.to(bf16) for g in want], 2 ** -7)
    del q, kk, vv, cot, kd, vd, want, scratch
    torch.cuda.empty_cache()
    for rec in records:
        print(json.dumps(rec))
    return records


# ---------------------------------------------------------------------------
# The serve engine (continuous batching) and the paged decode kernels
# ---------------------------------------------------------------------------

# tests/test_serve_engine.py's SMOKE_CONFIG
ENGINE_SMOKE = dict(max_slots=2, max_len=48, block_size=4, num_blocks=32, prefill_chunk=8,
                    token_budget=16)
# phase 22's load, engine_deepseek7b_shared_prefix: a smoke reading of the
# engine path, not yet a cell (its lengths are set here, not drawn from a
# public trace; prompts are short because the stepped prefill takes a
# batch-1 decode step a token; a p99 over 12 requests is their maximum)
ENGINE_FULL = dict(max_slots=8, max_len=128, block_size=8, num_blocks=128, prefill_chunk=16,
                   token_budget=64)
# phase 22's depth: the engine's step is host-bound (its wall scales with the
# layers), and the whole 30 took 113 s of a slow host's run
ENGINE_FULL_LAYERS = 15
ENGINE_LOAD = dict(n_requests=12, prompt_len=64, max_new_tokens=32, shared_prefix_len=32, seed=0)
# the engine steps every prompt token through a batch-1 decode step on the
# host, so its wall grows with depth: 8 of 30 layers keep phase 22 and its
# profile near a minute on a slow host
ENGINE_CASES = (("deepseek-7b", "native"), ("deepseek-7b", "int8"),
                ("qwen3-moe-30b-a3b", "native"), ("qwen3-moe-30b-a3b", "int8"),
                ("dbrx-132b", "native"), ("dbrx-132b", "int8"), ("rwkv6-7b", "native"),
                ("recurrentgemma-2b", "native"), ("recurrentgemma-2b", "int8"))


def paged_kernel_checks(torch, R, dev):
    """Phase 20: the paged decode kernels against their plain versions, and
    against the contiguous kernel on the gathered rows."""
    from repro_torch.kernels.decode_attention import (
        chunk_rows, decode_attention, decode_attention_int8, paged_decode_attention,
        paged_decode_attention_int8,
    )

    gen = torch.Generator(device=dev)
    gen.manual_seed(2020)
    scratch = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    flush = scratch.zero_
    tol = {torch.bfloat16: 2e-2, torch.float32: 1e-4}   # as phase 3
    records = []

    def rand(*shape, dtype, gen=gen):
        return torch.randn(*shape, generator=gen, device=dev, dtype=torch.float32).to(dtype)

    def check(label, got, want, t):
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        ok = math.isfinite(err) and err <= t
        print(f"[check] {label}: max_abs_err={err:.3e} tol={t:.0e} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{label} disagrees with its plain version: {err} > {t}")
        return err

    def same(label, got, want):
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            err = (got.float() - want.float()).abs().max().item()
            raise AssertionError(f"{label}: paged and contiguous kernels differ by {err}")
        print(f"[check] {label}: paged == contiguous on the gathered rows, bit for bit")

    valid577 = [576, 1, 300, 513, 576, 0, 450, 520]
    cases = [
        # label, B, H, Hkv, D, page, rows, valid, window, dtypes, record
        ("deepseek-7b MHA", 8, 32, 32, 128, 8, 577, valid577, None,
         (torch.float32, torch.bfloat16), True),
        ("qwen3 GQA-8", 8, 32, 4, 128, 8, 577, valid577, None, (torch.bfloat16,), True),
        ("MHA window 256", 8, 32, 32, 128, 8, 577, valid577, 256, (torch.bfloat16,), False),
        ("smoke D=32 GQA-2", 3, 4, 2, 32, 16, 45, [45, 0, 17], None,
         (torch.float32, torch.bfloat16), False),
        ("smoke D=16 MQA window 12", 3, 2, 1, 16, 16, 40, [40, 1, 23], 12,
         (torch.float32,), False),
        ("smoke D=256 MQA-10", 2, 10, 1, 256, 16, 70, [70, 33], None, (torch.bfloat16,), False),
    ]
    # lengths around the decode split's chunk, 0 and 1; windows starting
    # inside a chunk; pages of 8 and 16
    def edge(ch):
        return [ch - 1, ch, ch + 1, 0, 1, ch + ch // 2, 2 * ch + 8, 2 * ch + 1]

    c64, c256 = chunk_rows(128, torch.bfloat16), chunk_rows(256, torch.bfloat16)
    edge_cases = [
        ("edge lengths GQA-4", 8, 8, 2, 128, 8, 2 * c64 + 8, edge(c64), None,
         (torch.float32, torch.bfloat16), False),
        ("edge lengths MHA window 100", 8, 4, 4, 128, 16, 2 * c64 + 8, edge(c64), 100,
         (torch.bfloat16,), False),
        ("edge lengths MQA-10 D=256 window 20", 8, 10, 1, 256, 8, 2 * c256 + 8, edge(c256), 20,
         (torch.bfloat16,), False),
        ("edge lengths D=16 window 70", 8, 2, 1, 16, 16, 2 * c64 + 16, edge(c64), 70,
         (torch.float32,), False),
    ]
    def run_cases(cases, gen):
        for label, B, H, Hkv, D, page, rows, valid_l, window, dtypes, record in cases:
            NP = -(-rows // page)
            valid = torch.tensor(valid_l, dtype=torch.int32, device=dev)
            live = int(valid.sum())
            P = B * NP + 5                   # the rows' pages scattered over a pool
            table = torch.randperm(P, generator=gen, device=dev)[:B * NP].reshape(B, NP).to(
                torch.int32)
            for dtype in dtypes:
                name = f"{label} {str(dtype).split('.')[-1]}"
                q = rand(B, 1, H, D, dtype=dtype, gen=gen)
                kp, vp = (rand(P, page, Hkv, D, dtype=dtype, gen=gen) for _ in range(2))
                run = lambda: paged_decode_attention(q, kp, vp, table, valid, window=window)
                plain = lambda: R.paged_decode_attention_ref(q, kp, vp, table, valid, window=window)
                err = check(f"paged_decode_attention {name}", run(), plain(), tol[dtype])
                kc, vc = R.gather_pages(kp, table), R.gather_pages(vp, table)
                contiguous = lambda: decode_attention(q, kc, vc, valid, window=window)
                same(f"paged_decode_attention {name}", run(), contiguous())
                (kq, ks), (vq, vs) = R.quantize_int8_ref(kp), R.quantize_int8_ref(vp)
                run8 = lambda: paged_decode_attention_int8(q, kq, ks, vq, vs, table, valid,
                                                           window=window)
                plain8 = lambda: R.paged_decode_attention_int8_ref(q, kq, ks, vq, vs, table, valid,
                                                                   window=window)
                err8 = check(f"paged_decode_attention_int8 {name}", run8(), plain8(), tol[dtype])
                gq = [R.gather_pages(t, table) for t in (kq, ks, vq, vs)]
                contiguous8 = lambda: decode_attention_int8(q, *gq, valid, window=window)
                same(f"paged_decode_attention_int8 {name}", run8(), contiguous8())
                if record and dtype == torch.bfloat16:
                    # bytes: each live row's K and V once (per sequence, as the TPU
                    # kernel reads shared pages), q and out, the live pages' table
                    # entries and valid_len
                    pages_read = sum(-(-v // page) for v in valid_l)
                    small = 2 * q.numel() * 2 + 4 * pages_read + 4 * B
                    for nm, fn, pl, cf, nbytes, e in (
                            ("paged_decode_attention", run, plain, contiguous,
                             2 * live * Hkv * D * 2 + small, err),
                            ("paged_decode_attention_int8", run8, plain8, contiguous8,
                             2 * live * Hkv * (D + 4) + small, err8)):
                        b_ms, b_by = bound(nbytes, 4 * D * H * live, "bfloat16")
                        rec = dict(
                            name=nm, path="engine_serving", via="engine pool check",
                            route="cuda", source="src/repro_torch/kernels/csrc/decode_attention.cu",
                            replaces=("src/repro/kernels/decode_attention.py:265"
                                      if nm.endswith("int8") else
                                      "src/repro/kernels/decode_attention.py:202"),
                            launches=0, max_abs_err=e, ms=timed_ms(fn, flush),
                            plain_ms=timed_plain(pl, flush), bound_ms=b_ms, bound_by=b_by,
                            # no one PyTorch call computes a paged decode: a gather
                            # and then SDPA is two
                            library_ms=None, contiguous_ms=timed_ms(cf, flush))
                        if label != "deepseek-7b MHA":
                            rec["shape"] = label
                        records.append(rec)
                del q, kp, vp, kc, vc, kq, ks, vq, vs, gq

    run_cases(cases, gen)

    # three rows sharing their first pages (a cached prefix)
    B, H, Hkv, D, page = 3, 32, 32, 128, 8
    P = 8
    table = torch.tensor([[0, 1, 2, 3], [0, 1, 4, 5], [0, 1, 6, 7]], dtype=torch.int32,
                         device=dev)
    valid = torch.tensor([32, 25, 17], dtype=torch.int32, device=dev)
    q = rand(B, 1, H, D, dtype=torch.bfloat16)
    kp, vp = (rand(P, page, Hkv, D, dtype=torch.bfloat16) for _ in range(2))
    got = paged_decode_attention(q, kp, vp, table, valid)
    same("paged_decode_attention shared prefix", got,
         decode_attention(q, R.gather_pages(kp, table), R.gather_pages(vp, table), valid))
    check("paged_decode_attention shared prefix", got,
          R.paged_decode_attention_ref(q, kp, vp, table, valid), tol[torch.bfloat16])
    (kq, ks), (vq, vs) = R.quantize_int8_ref(kp), R.quantize_int8_ref(vp)
    got8 = paged_decode_attention_int8(q, kq, ks, vq, vs, table, valid)
    same("paged_decode_attention_int8 shared prefix", got8,
         decode_attention_int8(q, *(R.gather_pages(t, table) for t in (kq, ks, vq, vs)), valid))
    check("paged_decode_attention_int8 shared prefix", got8,
          R.paged_decode_attention_int8_ref(q, kq, ks, vq, vs, table, valid),
          tol[torch.bfloat16])
    edge_gen = torch.Generator(device=dev)
    edge_gen.manual_seed(2121)
    run_cases(edge_cases, edge_gen)
    del scratch
    torch.cuda.empty_cache()
    for rec in records:
        print(json.dumps(rec))
    return records


def _engine_tokens(engine, prompts, n):
    return [o.tokens for o in engine.generate_batch(prompts, max_new_tokens=n)]


def serve_smoke_checks(make, vocab, what):
    """``benchmarks/serve_smoke.py``'s three checks, on engines from ``make()``."""
    rng = np.random.default_rng(0)
    p0, p1 = rng.integers(0, vocab, 6).tolist(), rng.integers(0, vocab, 6).tolist()
    solo = [_engine_tokens(make(), [p], 6)[0] for p in (p0, p1)]
    eng = make()
    r0 = eng.submit(p0, max_new_tokens=6)
    eng.step()                                   # r0 prefills and starts decoding
    r1 = eng.submit(p1, max_new_tokens=3)        # lands mid-decode
    first_r1 = r0_done = None
    step = 1
    while eng.has_work():
        for ev in eng.step():
            if ev.request_id == r1 and first_r1 is None:
                first_r1 = step
            if ev.request_id == r0 and ev.done:
                r0_done = step
        step += 1
    if first_r1 is None or r0_done is None or not first_r1 < r0_done:
        raise AssertionError(f"{what}: r1 first token at {first_r1}, r0 done at {r0_done}")
    if eng.output(r0).tokens != solo[0] or eng.output(r1).tokens != solo[1][:3]:
        raise AssertionError(f"{what}: interleaving changed the tokens")
    print(f"[serve-smoke] {what} admit-mid-decode: r1 first token at step {first_r1}, r0 "
          f"done at step {r0_done}, outputs equal the solo runs")

    rng = np.random.default_rng(1)
    prefix = rng.integers(0, vocab, 12).tolist()
    prompts = [prefix + rng.integers(0, vocab, 4).tolist() for _ in range(3)]
    cold = [_engine_tokens(make(), [p], 4)[0] for p in prompts]
    eng = make()
    warm = _engine_tokens(eng, prompts, 4)
    stats = eng.prefix_cache_stats
    if stats.hit_blocks <= 0 or warm != cold:
        raise AssertionError(f"{what}: prefix cache hits {stats.hit_blocks}, warm == cold "
                             f"{warm == cold}")
    print(f"[serve-smoke] {what} prefix cache: hit rate {stats.hit_rate:.3f} "
          f"({stats.hit_blocks}/{stats.queries} block probes), hits equal the cold runs")

    eng = make()
    rng = np.random.default_rng(2)
    rids = [eng.submit(rng.integers(0, vocab, 5).tolist(), max_new_tokens=4) for _ in range(3)]
    events = {r: [] for r in rids}
    while eng.has_work():
        for ev in eng.step():
            events[ev.request_id].append(ev)
    for rid in rids:
        evs = events[rid]
        if ([e.index for e in evs] != list(range(len(evs))) or sum(e.done for e in evs) != 1
                or not evs[-1].done or [e.token for e in evs] != eng.output(rid).tokens):
            raise AssertionError(f"{what}: request {rid}'s stream is out of order: {evs}")
    print(f"[serve-smoke] {what} streaming: {len(rids)} requests, consecutive indices, "
          f"one terminal event each")


def _slot_copy(tree, slot):
    return {k: _slot_copy(v, slot) if isinstance(v, dict) else v[:, slot].clone()
            for k, v in tree.items()}


def masked_step_check(torch, model, params, dev, stale_pos, what):
    """One masked decode step on the card: the inactive slot (its stale
    position inside rows it holds) is kept bit for bit, the active one moves."""
    from repro_torch.serve.runner import StepRunner

    cache = model.init_cache(2, 24, device=dev)
    runner = StepRunner(model)
    prompt = torch.from_numpy(np.random.default_rng(9).integers(0, model.cfg.vocab, (2, 16)))
    runner.extend(params, prompt.to(dev), cache, 0)
    before = [_slot_copy(cache, s) for s in (0, 1)]
    tok, _ = runner.decode(params, torch.tensor([[3], [4]], dtype=torch.int32, device=dev),
                           cache, np.asarray([16, stale_pos], np.int32),
                           np.asarray([True, False]), [None, None], np.zeros(2, np.float32),
                           np.zeros(2, np.int32))
    idle_same = all(torch.equal(a, b) for a, b in zip(_leaves(_slot_copy(cache, 1)),
                                                        _leaves(before[1])))
    active_moved = any(not torch.equal(a, b) for a, b in zip(_leaves(_slot_copy(cache, 0)),
                                                               _leaves(before[0])))
    if not (idle_same and active_moved and int(tok[1]) == 0):
        raise AssertionError(f"{what}: masked step: idle slot kept {idle_same}, active "
                             f"slot moved {active_moved}")
    print(f"[masked-step] {what}: the inactive slot (stale pos {stale_pos}) is bit-identical "
          f"after the step, the active one moved")


def cross_device_engine(torch, ops, get_model, smoke_config, ServeSession, dev):
    """Phase 21: ServeEngine on the smoke configs in f32, plain path on the
    CPU vs kernels on the card, and the serve-smoke checks on the card."""
    from repro_torch.serve import EngineConfig, ServeEngine

    config = EngineConfig(**ENGINE_SMOKE)
    weights = {}
    for arch, kv in ENGINE_CASES:
        base = smoke_config(arch)
        model = get_model(base.with_(kv_cache_dtype=kv))
        if arch not in weights:
            cpu_params, _ = model.init_params(seed=0, device="cpu")
            weights[arch] = (cpu_params, _to(cpu_params, dev))
        cpu_params, gpu_params = weights[arch]
        prompts = np.random.default_rng(1).integers(0, base.vocab, (3, 11))
        plist = [p.tolist() for p in prompts]
        want = _engine_tokens(ServeEngine(model=model, params=cpu_params, config=config,
                                          device="cpu"), plist, 6)
        ops.reset_launches()
        got = _engine_tokens(ServeEngine(model=model, params=gpu_params, config=config,
                                         device=dev), plist, 6)
        counts = {k: c for k, c in ops.LAUNCHES.items() if c}
        print(f"[engine] {arch} {kv}: cpu={want} gpu={got} launches={counts}")
        if want != got:
            raise AssertionError(f"{arch} {kv}: engine greedy tokens differ between CPU and card")
        decode_op = "decode_attention_int8" if kv == "int8" else "decode_attention"
        needed = {"dense": (decode_op,), "moe": (decode_op, "fused_moe_gemm", "fused_moe_combine"),
                  "rglru": (decode_op,), "rwkv6": ()}[base.family]
        if any(counts.get(k, 0) == 0 for k in needed) or counts.get("flash_attention", 0):
            raise AssertionError(f"{arch} {kv}: the engine's steps missed a kernel: {counts}")
        # generate prefills attention families in one batch, the engine steps
        # the prompt: in float32 they agree on the smoke configs; with an int8
        # cache the two routes' K/V may round to different int8 rows and the
        # tokens part (the reference's own engine and generate do at qwen3-moe)
        if kv == "native" or base.family == "rglru":
            oracle = ServeSession(model=model, params=gpu_params, device=dev).generate(
                torch.from_numpy(prompts), max_new_tokens=5).tokens.cpu().tolist()
            if oracle != got:
                raise AssertionError(f"{arch} {kv}: engine {got} != generate {oracle} on the card")
            print(f"[engine] {arch} {kv}: engine tokens equal ServeSession.generate's on the card")
    for arch in ("deepseek-7b", "rwkv6-7b", "recurrentgemma-2b"):
        model, gpu_params = get_model(smoke_config(arch)), weights[arch][1]
        serve_smoke_checks(lambda: ServeEngine(model=model, params=gpu_params, config=config,
                                               device=dev), model.cfg.vocab, arch)
    for arch, kv, stale in (("deepseek-7b", "native", 5), ("deepseek-7b", "int8", 5),
                            ("qwen3-moe-30b-a3b", "native", 5), ("rwkv6-7b", "native", 5),
                            ("recurrentgemma-2b", "native", 3),
                            ("recurrentgemma-2b", "int8", 12)):
        model = get_model(smoke_config(arch).with_(kv_cache_dtype=kv))
        masked_step_check(torch, model, weights[arch][1], dev, stale, f"{arch} {kv}")


def _load_prompts(vocab):
    """The prompts ``run_load`` draws for ENGINE_LOAD (the same calls, in order)."""
    rng = np.random.default_rng(ENGINE_LOAD["seed"])
    P, S = ENGINE_LOAD["prompt_len"], ENGINE_LOAD["shared_prefix_len"]
    prefix = rng.integers(0, vocab, size=(S,)).tolist()
    return [prefix + rng.integers(0, vocab, size=(P - S,)).tolist()
            for _ in range(ENGINE_LOAD["n_requests"])]


def engine_pool_check(torch, ops, R, engine, prompts, dev, what):
    """The paged kernels over the engine's own page pool and block tables:
    for every request whose prompt blocks are still resident, each layer's
    paged decode against the contiguous kernel over the same rows gathered
    (bit for bit) and against the plain version."""
    from repro_torch.kernels.decode_attention import decode_attention, decode_attention_int8
    from repro_torch.serve import hash_chain

    alloc, pool = engine.adapter.allocator, engine.adapter.pool
    bs = alloc.block_size
    rows = []
    for p in prompts:
        chain = hash_chain(p, bs)
        if all(alloc.contains(h) for h in chain):
            rows.append([alloc.lookup(h) for h in chain])
    if not rows:
        raise AssertionError(f"{what}: no request's blocks are resident in the pool")
    table = torch.tensor(rows, dtype=torch.int32, device=dev)
    n = table.shape[1] * bs
    cfg = engine.model.cfg
    gen = torch.Generator(device=dev)
    gen.manual_seed(22)
    q = torch.randn(len(rows), 1, cfg.n_heads, cfg.resolved_head_dim(), generator=gen,
                    device=dev).to(cfg.dtype)
    valid = torch.full((len(rows),), n, dtype=torch.int32, device=dev)
    int8 = "k_scale" in pool
    got_all, plain_all = [], []
    for layer in range(cfg.n_layers):
        pages = [pool[k][layer] for k in (("k", "k_scale", "v", "v_scale") if int8 else ("k", "v"))]
        gathered = [R.gather_pages(t, table) for t in pages]
        if int8:
            got = ops.paged_decode_attention_int8(q, *pages, table, valid)
            contiguous = decode_attention_int8(q, *gathered, valid)
            plain = R.paged_decode_attention_int8_ref(q, *pages, table, valid)
        else:
            got = ops.paged_decode_attention(q, *pages, table, valid)
            contiguous = decode_attention(q, *gathered, valid)
            plain = R.paged_decode_attention_ref(q, *pages, table, valid)
        torch.cuda.synchronize()
        if not torch.equal(got, contiguous):
            raise AssertionError(f"{what} layer {layer}: paged != contiguous on the pool's rows")
        got_all.append(got)
        plain_all.append(plain)
    # bf16 outputs of |O(10)|: hold each row to 2 bf16 ulps of its largest
    # value, as phase 13 does (both sides compute in f32 and round once)
    worst = row_ulp_check(torch, f"paged decode over the engine pool {what}, all layers",
                          torch.stack(got_all), torch.stack(plain_all))
    print(f"[engine-pool] {what}: {len(rows)} requests' {table.shape[1]} resident pages each, "
          f"{cfg.n_layers} layers: paged == contiguous bit for bit, max_abs_err vs plain "
          f"{worst:.3e}")


def full_width_engine(torch, ops, R, get_model, get_config, ServeSession, dev):
    """Phase 22: deepseek-7b at its published width, ENGINE_FULL_LAYERS of
    its 30 layers, through ServeEngine + run_load (the
    engine_deepseek7b_shared_prefix smoke reading), native and int8."""
    from repro_torch.serve import EngineConfig, ServeEngine, run_load

    cfg = get_config("deepseek-7b").with_(n_layers=ENGINE_FULL_LAYERS)
    params, _ = get_model(cfg).init_params(seed=0, device=dev)
    torch.cuda.synchronize()
    prompts = _load_prompts(cfg.vocab)
    N = ENGINE_LOAD["max_new_tokens"]
    totals = {name: 0 for name in ops.LAUNCHES}
    for kv in ("native", "int8"):
        model = get_model(cfg.with_(kv_cache_dtype=kv))
        engine = ServeEngine(model=model, params=params, config=EngineConfig(**ENGINE_FULL),
                             device=dev)
        held = sum(t.numel() * t.element_size()
                   for t in _leaves(engine.adapter.cache)) + sum(
                       t.numel() * t.element_size() for t in _leaves(engine.adapter.pool))
        print(f"[engine-full] {kv}: slots + pool {held / 2**30:.3f} GiB, "
              f"{torch.cuda.memory_allocated(dev) / 2**30:.3f} GiB allocated before the run")
        torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launches()
        t0 = time.perf_counter()
        report = run_load(engine, **ENGINE_LOAD)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev)
        print(f"[engine-full] {kv}: {json.dumps(report.to_json())}")
        print(f"[engine-full] {kv}: wall {wall:.3f} s (run_load's clock {report.wall_s} s), "
              f"peak memory {peak / 2**30:.3f} GiB, decoded {engine.tokens_decoded}")
        engine_pool_check(torch, ops, R, engine, prompts, dev, f"deepseek-7b {kv}")
        counts = dict(ops.LAUNCHES)
        print(f"[engine-full] {kv}: launches {counts}")
        outs = [engine.output(r) for r in range(ENGINE_LOAD["n_requests"])]
        decode_op = "decode_attention_int8" if kv == "int8" else "decode_attention"
        paged_op = "paged_decode_attention_int8" if kv == "int8" else "paged_decode_attention"
        if any(len(o.tokens) != N or min(o.tokens) < 0 or max(o.tokens) >= cfg.vocab
               for o in outs):
            raise AssertionError(f"{kv}: engine outputs out of range")
        if report.prefix_hit_rate <= 0:
            raise AssertionError(f"{kv}: the shared prefix produced no cache hits")
        if (counts[decode_op] == 0 or counts[decode_op] % cfg.n_layers or counts["flash_attention"]
                or counts[paged_op] != cfg.n_layers):
            raise AssertionError(f"{kv}: launches {counts}")
        # the engine's greedy tokens beside generate's (batched prefill): a reading
        gen_out = ServeSession(model=model, params=params, device=dev).generate(
            torch.tensor(prompts, device=dev), max_new_tokens=N - 1).tokens.cpu()
        agree = (gen_out == torch.tensor([o.tokens for o in outs])).float().mean().item()
        print(f"[engine-full] {kv}: {agree:.3f} of the engine's tokens equal generate's")
        for name, c in counts.items():
            totals[name] += c
        del engine, gen_out
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    return totals


def profile_engine_step(torch, get_model, get_config, params, dev, steps=4):
    """Phase 12, the engine: decode-only engine steps of phase 22's load
    (native KV; 8 requests in the 8 slots, every prompt prefilled), timed on
    the host clock and then profiled.  The first request prefills alone and
    publishes the shared prefix, so the other seven step only their own 32
    prompt tokens."""
    from repro_torch.serve import EngineConfig, ServeEngine
    from repro_torch.serve.scheduler import RequestStatus
    from torch.profiler import ProfilerActivity, profile

    cfg = get_config("deepseek-7b")
    engine = ServeEngine(model=get_model(cfg), params=params, config=EngineConfig(**ENGINE_FULL),
                         device=dev)
    prompts = _load_prompts(cfg.vocab)[:ENGINE_FULL["max_slots"]]

    def prefill(ps):
        for p in ps:
            engine.submit(p, max_new_tokens=ENGINE_LOAD["max_new_tokens"])
        while any(r.status is not RequestStatus.RUNNING
                  for r in engine.scheduler.requests.values()):
            engine.step()

    prefill(prompts[:1])
    prefill(prompts[1:])
    for _ in range(2):
        engine.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        engine.step()
    step_ms = (time.perf_counter() - t0) / steps * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            engine.step()
        torch.cuda.synchronize()
    busy = device_time_by_kind(torch, prof, steps, "engine decode step")
    if busy is not None:
        print(f"[profile] engine native: device busy {busy:.3f} ms of {step_ms:.3f} ms "
              f"per engine decode step (8 slots): idle share {1 - busy / step_ms:.3f}")
    del engine
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Checkpoint / restart and elastic replanning (phases 23-24)
# ---------------------------------------------------------------------------

# the full-width cell of phases 23-24: deepseek-7b cut to 2 layers (1.244 B
# params; bf16 params + f32 AdamW state are 12.4 GB a checkpoint), seq 256
CKPT_LAYERS, CKPT_SEQ = 2, 256


def _recording(session):
    """Keep a host copy of the tokens of every batch the session's batcher
    hands out."""
    seen = []
    ds = session.dataset
    inner = ds.next_batch

    def next_batch():
        b = inner()
        seen.append(b["tokens"].copy())
        return b

    ds.next_batch = next_batch
    return seen


def _dir_bytes(path: Path) -> int:
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())


def checkpoint_restart(torch, ops, train_session_factory, dev, root: Path):
    """Phase 23: deepseek-7b at full width (2 layers, seq 256, f32, the demo
    fleet): S0 runs 6 steps uninterrupted (one sync save at its end); S1
    (checkpoint every 3, async) runs 3 steps; its checkpoint is restored and
    held to S1's state bit for bit; S2 (same config and directory) resumes at
    step 3 and runs to 6, its batches and per-step losses and grad norms held
    to S0's."""
    from repro_torch.checkpoint import restore
    from repro_torch.checkpoint.manager import _flatten_with_paths

    kw = dict(arch="deepseek-7b", device=dev, full_config=True, n_layers=CKPT_LAYERS,
              seq=CKPT_SEQ, steps=6, precision="f32")
    s0 = train_session_factory(checkpoint_dir=str(root / "s0"), checkpoint_every=6, **kw)
    s0.config.async_checkpoint = False
    cfg = s0.model.cfg
    # params (bf16 at full width) + AdamW's f32 mu and nu + the 4-byte step
    like, _ = s0.model.init_params(abstract=True)
    expect_bytes = sum(t.numel() * (t.element_size() + 8) for t in _leaves(like)) + 4
    free = shutil.disk_usage(root).free
    need = 2 * expect_bytes                 # S2 writes step 6 beside S1's step 3
    print(f"[ckpt] {cfg.name}: {cfg.n_layers} layers, {cfg.param_count() / 1e9:.3f} B params, "
          f"a checkpoint {expect_bytes / 1e9:.3f} GB; free disk {free / 1e9:.1f} GB under "
          f"{root} (needs {need / 1e9:.1f} GB)")
    if free < need:
        raise AssertionError(f"phase 23 needs {need / 1e9:.1f} GB of disk, {free / 1e9:.1f} GB "
                             f"are free")
    b0 = _recording(s0)
    r0 = s0.run()
    h0 = r0.history
    m0 = s0.checkpoints
    on_disk = _dir_bytes(root / "s0")
    print(f"[ckpt] S0: 6 steps, losses {[round(h['loss'], 6) for h in h0]}; sync save at step 6: "
          f"snapshot {m0.last_snapshot_s:.3f} s + write {m0.last_write_s:.3f} s = "
          f"{m0.last_snapshot_s + m0.last_write_s:.3f} s for {on_disk} bytes "
          f"({on_disk / (m0.last_snapshot_s + m0.last_write_s) / 1e9:.2f} GB/s)")
    if on_disk < expect_bytes:
        raise AssertionError(f"S0's checkpoint holds {on_disk} bytes, fewer than {expect_bytes}")
    shutil.rmtree(root / "s0")
    del s0, r0
    torch.cuda.empty_cache()

    run_dir = str(root / "run")
    s1 = train_session_factory(checkpoint_dir=run_dir, checkpoint_every=3, **kw)
    if not s1.config.async_checkpoint:
        raise AssertionError("S1 must save asynchronously")
    r1 = s1.run(steps=3)
    m1 = s1.checkpoints
    step_ms = statistics.median(h["step_time"] for h in r1.history[1:]) * 1e3
    print(f"[ckpt] S1: 3 steps ({step_ms:.3f} ms/step, median of steps 2-3), async save at "
          f"step 3: the caller blocked {m1.last_snapshot_s * 1e3:.1f} ms for the host snapshot "
          f"({m1.last_snapshot_s * 1e3 / step_ms:.2f} steps), the background write took "
          f"{m1.last_write_s:.3f} s")
    t = time.perf_counter()
    state, meta = restore(run_dir, {"params": r1.params, "opt": r1.opt_state}, device=dev)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t
    saved = dict(_flatten_with_paths({"params": r1.params, "opt": r1.opt_state}))
    got = dict(_flatten_with_paths(state))
    differ = [k for k in saved if not (
        got[k] == saved[k] if isinstance(saved[k], int) else torch.equal(got[k], saved[k]))]
    print(f"[ckpt] restore of step {meta['step']} with CRC32 over every leaf: {restore_s:.3f} s; "
          f"{len(saved)} leaves, {len(differ)} differ from S1's state")
    if differ or meta["step"] != 3 or sorted(got) != sorted(saved):
        raise AssertionError(f"restored leaves differ from the saved ones: {differ[:5]}")
    del s1, r1, state, saved, got
    torch.cuda.empty_cache()

    s2 = train_session_factory(checkpoint_dir=run_dir, checkpoint_every=3, **kw)
    b2 = _recording(s2)
    ops.reset_launches()
    r2 = s2.run()
    counts = dict(ops.LAUNCHES)
    h2 = r2.history
    print(f"[ckpt] S2: start_step {r2.start_step}, losses {[round(h['loss'], 6) for h in h2]} "
          f"grad_norm {[round(h['grad_norm'], 4) for h in h2]}; S0's steps 4-6: losses "
          f"{[round(h['loss'], 6) for h in h0[3:]]} grad_norm "
          f"{[round(h['grad_norm'], 4) for h in h0[3:]]}; launches "
          f"{ {k: v for k, v in counts.items() if v} }")
    if r2.start_step != 3 or r2.steps_run != 3:
        raise AssertionError(f"S2 resumed at {r2.start_step} and ran {r2.steps_run} steps")
    if not np.array_equal(b2[0], b0[3]):
        raise AssertionError("S2's first batch is not S0's fourth")
    bit_equal = all(h2[i][k] == h0[3 + i][k] for i in range(3) for k in ("loss", "grad_norm"))
    for key in ("loss", "grad_norm"):
        if not np.allclose([h[key] for h in h2], [h[key] for h in h0[3:]], rtol=1e-6, atol=0.0):
            raise AssertionError(f"S2's {key} at steps 4-6 differs from S0's")
    print(f"[ckpt] S2's losses and grad norms at steps 4-6 equal S0's to rtol 1e-6; "
          f"bit-equal: {bit_equal}")
    _check_launches(counts, expected_train_launches(cfg, "f32", 3), "resumed training")
    del s2, r2
    torch.cuda.empty_cache()


def _elastic_sequence(session, params):
    """Run 2 steps, lose csd/1, run 2, a csd joins, run 2 (params and
    optimizer state carried across): the losses, the replans and step ms."""
    from repro_torch.api import WorkerJoined, WorkerLost
    from repro_torch.core.privacy import audit_custody

    r = session.run(params, steps=2)
    losses, parts = [h["loss"] for h in r.history], [r.history]
    compiles, replans = [session.compile_count], []
    for event in (WorkerLost(["csd/1"]), WorkerJoined("csd", 1)):
        rows = session.tune().schedule.global_rows
        res = session.apply(event)
        new_rows = session.tune().schedule.global_rows
        # the reference's rule: the step is rebuilt only when the rows change
        if res.recompiled != (new_rows != rows):
            raise AssertionError(f"{event}: recompiled={res.recompiled} with rows "
                                 f"{rows} -> {new_rows}")
        r = session.run(r.params, opt_state=r.opt_state, steps=2)
        losses += [h["loss"] for h in r.history]
        parts.append(r.history)
        compiles.append(session.compile_count)
        replans.append((type(event).__name__, rows, new_rows, res.recompiled,
                        res.dropped_shards))
        if compiles[-1] != compiles[-2] + int(res.recompiled):
            raise AssertionError(f"{event}: compile count {compiles}")
    audit = audit_custody(session.devices.custody_log)
    if any(audit.values()) or r.opt_state.step != 6:
        raise AssertionError(f"custody audit {audit}, optimizer step {r.opt_state.step}")
    return losses, parts, compiles, replans, audit


def elastic_replan(torch, ops, train_session_factory, dev):
    """Phase 24: WorkerLost then WorkerJoined between training runs, the
    smoke config on the CPU (plain versions) against the card (kernels)
    from the same weights in f32 and int8-fused, then deepseek-7b at phase
    23's full width in int8-fused on the card."""
    import copy

    rtol = {"f32": 1e-4, "int8-fused": 1e-2}       # phase 7's
    for prec in ("f32", "int8-fused"):
        kw = dict(steps=6, seq=32, precision=prec)
        cpu = train_session_factory(device="cpu", **kw)
        params, _ = cpu.init_state()
        gpu_params = _to(copy.deepcopy(params), dev)
        want, _, cpu_compiles, _, _ = _elastic_sequence(cpu, params)
        gpu = train_session_factory(device=dev, **kw)
        ops.reset_launches()
        got, _, compiles, replans, audit = _elastic_sequence(gpu, gpu_params)
        counts = dict(ops.LAUNCHES)
        print(f"[elastic] smoke {prec}: cpu={[round(x, 6) for x in want]} "
              f"gpu={[round(x, 6) for x in got]} compiles {compiles} replans {replans} "
              f"custody audit {audit} launches { {k: v for k, v in counts.items() if v} }")
        if not np.allclose(got, want, rtol=rtol[prec], atol=0.0):
            raise AssertionError(f"{prec}: losses across the events differ between CPU and card")
        if compiles != cpu_compiles:
            raise AssertionError(f"{prec}: compile counts {compiles} on the card, "
                                 f"{cpu_compiles} on the CPU")
        _check_launches(counts, expected_train_launches(gpu.model.cfg, prec, 6),
                        f"elastic {prec} training")

    session = train_session_factory(arch="deepseek-7b", device=dev, full_config=True,
                                    n_layers=CKPT_LAYERS, seq=CKPT_SEQ, steps=6,
                                    precision="int8-fused")
    cfg = session.model.cfg
    ops.reset_launches()
    losses, parts, compiles, replans, audit = _elastic_sequence(session, None)
    counts = dict(ops.LAUNCHES)
    ms = [[round(h["step_time"] * 1e3, 3) for h in part] for part in parts]
    print(f"[elastic] {cfg.name} int8-fused, {cfg.n_layers} layers, seq {CKPT_SEQ}: step ms "
          f"before the events {ms[0]}, after WorkerLost {ms[1]}, after WorkerJoined {ms[2]}; "
          f"rows {[r[1:3] for r in replans]}, compiles {compiles}, losses "
          f"{[round(x, 4) for x in losses]}, custody audit {audit}, launches "
          f"{ {k: v for k, v in counts.items() if v} }")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError("non-finite loss across the elastic events")
    _check_launches(counts, expected_train_launches(cfg, "int8-fused", 6),
                    "full-width elastic training")
    del session
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phases 25-27: qwen1.5-4b, minitron-8b, deepseek-coder-33b, whisper-medium
# and qwen2-vl-7b
# ---------------------------------------------------------------------------

FAMILY_ARCHS = ("qwen1.5-4b", "minitron-8b", "deepseek-coder-33b")
SLICE_ARCHS = FAMILY_ARCHS + ("whisper-medium", "qwen2-vl-7b")
# seconds each of this slice's phases should take on the card (printed
# beside what it took; a run over budget is reported, not failed)
SLICE_BUDGET_S = {"kernels": 30, "cross-device": 30, "25": 90, "26": 30, "27": 30}
REPLACES = {"flash_attention": "src/repro/kernels/flash_attention.py:133",
            "flash_attention_q8": "src/repro/kernels/flash_attention.py:200",
            "decode_attention": "src/repro/kernels/decode_attention.py:327",
            "decode_attention_int8": "src/repro/kernels/decode_attention.py:378"}


def family_tile_edges(torch, R, dev):
    """Phase 3, this slice's tile edges, from a generator of their own (the
    earlier cases draw what they drew before): flash at head dim 64 over
    bf16, int8 and float32 K/V, GQA group 7 (56 over 8, 28 over 4, 14 over
    2, 7 over 1), not causal with Sq != Skv (whisper's cross-attention: 32,
    1 and 77 decoder rows against 1500 and 130 frames, past the 64-row
    tile's edge) and Skv = 1500 (whisper's bidirectional encoder); decode at
    head dim 64 and group 7 at lengths around the split's chunk, contiguous
    (native and int8, bf16 and float32) and paged (pages of 16, bit for bit
    against the contiguous kernel on the gathered rows), and over all 1500
    frames.  bf16 outputs to 2 bf16 ulps of each row, float32 to 1e-4 as
    phase 3."""
    from repro_torch.kernels.decode_attention import (
        chunk_rows, decode_attention, decode_attention_int8, paged_decode_attention,
        paged_decode_attention_int8,
    )
    from repro_torch.kernels.flash_attention import flash_attention_fwd, flash_attention_int8_fwd

    gen = torch.Generator(device=dev)
    gen.manual_seed(2525)
    bf16, f32 = torch.bfloat16, torch.float32

    def randn(*shape, dtype=bf16):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    def edge(label, got, want, dtype):
        if dtype == bf16:
            row_ulp_check(torch, label, got, want)
        else:
            close_check(torch, label, got, want, rtol=0.0, atol=1e-4)

    def same(label, got, want):
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"{label}: paged and contiguous kernels differ")
        print(f"[check] {label}: paged == contiguous on the gathered rows, bit for bit")

    # B, Sq, Skv, H, Hkv, D, causal, window, float32 too
    flash_cases = [(2, 65, 65, 4, 4, 64, True, None, True),
                   (2, 129, 129, 16, 16, 64, True, 8, False),
                   (2, 200, 200, 14, 2, 64, True, None, True),
                   (2, 129, 129, 56, 8, 128, True, None, False),
                   (2, 100, 100, 28, 4, 128, True, 40, False),
                   (2, 33, 33, 7, 1, 64, False, None, True),
                   (2, 32, 1500, 16, 16, 64, False, None, True),
                   (2, 1, 1500, 16, 16, 64, False, None, False),
                   (2, 77, 130, 14, 2, 64, False, None, True),
                   (1, 1500, 1500, 16, 16, 64, False, None, False)]
    for B, Sq, Skv, H, Hkv, D, causal, window, also_f32 in flash_cases:
        q, k, v = randn(B, Sq, H, D), randn(B, Skv, Hkv, D), randn(B, Skv, Hkv, D)
        tag = f"Sq={Sq} Skv={Skv} H={H}/{Hkv} D={D} causal={causal} window={window}"
        (kq, ks), (vq, vs) = R.quantize_int8_ref(k), R.quantize_int8_ref(v)
        kd, vd = R.dequantize_int8_ref(kq, ks), R.dequantize_int8_ref(vq, vs)
        for dtype in (bf16, f32) if also_f32 else (bf16,):
            qx, kx, vx = (t.to(dtype) for t in (q, k, v))
            name = f"{tag} {str(dtype).split('.')[-1]}"
            edge(f"flash_attention edge {name}",
                 flash_attention_fwd(qx, kx, vx, causal=causal, window=window),
                 R.flash_attention_ref(qx, kx, vx, causal=causal, window=window), dtype)
            edge(f"flash_attention_q8 edge {name}",
                 flash_attention_int8_fwd(qx, kq, ks, vq, vs, causal=causal, window=window),
                 R.flash_attention_ref(qx, kd, vd, causal=causal, window=window), dtype)
        del q, k, v, kq, ks, vq, vs, kd, vd

    for H, Hkv, D in ((16, 16, 64), (14, 2, 64), (56, 8, 128), (28, 4, 128), (7, 1, 64)):
        ch = chunk_rows(D, bf16)
        rows = 2 * ch + 8
        valid = torch.tensor([ch - 1, ch, ch + 1, 0, 1, ch + ch // 2, rows, 2 * ch + 1],
                             dtype=torch.int32, device=dev)
        q = randn(8, 1, H, D)
        k, v = randn(8, rows, Hkv, D), randn(8, rows, Hkv, D)
        (kq, ks), (vq, vs) = R.quantize_int8_ref(k), R.quantize_int8_ref(v)
        for window in (None, 100, 20):
            tag = f"H={H}/{Hkv} D={D} valid {valid.tolist()} window={window}"
            row_ulp_check(torch, f"decode_attention edge {tag} bf16",
                          decode_attention(q, k, v, valid, window=window),
                          R.decode_attention_ref(q, k, v, valid, window=window))
            row_ulp_check(torch, f"decode_attention_int8 edge {tag} bf16",
                          decode_attention_int8(q, kq, ks, vq, vs, valid, window=window),
                          R.decode_attention_int8_ref(q, kq, ks, vq, vs, valid, window=window))
        tag = f"H={H}/{Hkv} D={D} valid {valid.tolist()} float32"
        q32, k32, v32 = q.float(), k.float(), v.float()
        edge(f"decode_attention edge {tag}", decode_attention(q32, k32, v32, valid),
             R.decode_attention_ref(q32, k32, v32, valid), f32)
        edge(f"decode_attention_int8 edge {tag}", decode_attention_int8(q32, kq, ks, vq, vs, valid),
             R.decode_attention_int8_ref(q32, kq, ks, vq, vs, valid), f32)
        # paged: the same rows as pages of 16 scattered over a pool
        page = 16
        NP = -(-rows // page)
        P = 8 * NP + 3
        table = torch.randperm(P, generator=gen, device=dev)[:8 * NP].reshape(8, NP).to(
            torch.int32)
        kp, vp = randn(P, page, Hkv, D), randn(P, page, Hkv, D)
        (kpq, kps), (vpq, vps) = R.quantize_int8_ref(kp), R.quantize_int8_ref(vp)
        for window in (None, 20):
            tag = f"H={H}/{Hkv} D={D} pages of {page} window={window} bf16"
            got = paged_decode_attention(q, kp, vp, table, valid, window=window)
            row_ulp_check(torch, f"paged_decode_attention edge {tag}", got,
                          R.paged_decode_attention_ref(q, kp, vp, table, valid, window=window))
            same(f"paged_decode_attention edge {tag}", got,
                 decode_attention(q, R.gather_pages(kp, table), R.gather_pages(vp, table), valid,
                                  window=window))
            got8 = paged_decode_attention_int8(q, kpq, kps, vpq, vps, table, valid, window=window)
            row_ulp_check(torch, f"paged_decode_attention_int8 edge {tag}", got8,
                          R.paged_decode_attention_int8_ref(q, kpq, kps, vpq, vps, table, valid,
                                                            window=window))
            same(f"paged_decode_attention_int8 edge {tag}", got8,
                 decode_attention_int8(q, *(R.gather_pages(t, table)
                                            for t in (kpq, kps, vpq, vps)), valid,
                                       window=window))
        del q, k, v, kq, ks, vq, vs, kp, vp, kpq, kps, vpq, vps

    # whisper's cross-attention decode: one row against all 1500 frames
    q, k, v = randn(8, 1, 16, 64), randn(8, 1500, 16, 64), randn(8, 1500, 16, 64)
    (kq, ks), (vq, vs) = R.quantize_int8_ref(k), R.quantize_int8_ref(v)
    valid = torch.full((8,), 1500, dtype=torch.int32, device=dev)
    row_ulp_check(torch, "decode_attention edge 1500 frames H=16/16 D=64 bf16",
                  decode_attention(q, k, v, valid), R.decode_attention_ref(q, k, v, valid))
    row_ulp_check(torch, "decode_attention_int8 edge 1500 frames H=16/16 D=64 bf16",
                  decode_attention_int8(q, kq, ks, vq, vs, valid),
                  R.decode_attention_int8_ref(q, kq, ks, vq, vs, valid))
    q32, k32, v32 = q.float(), k.float(), v.float()
    edge("decode_attention edge 1500 frames H=16/16 D=64 float32",
         decode_attention(q32, k32, v32, valid), R.decode_attention_ref(q32, k32, v32, valid), f32)
    edge("decode_attention_int8 edge 1500 frames H=16/16 D=64 float32",
         decode_attention_int8(q32, kq, ks, vq, vs, valid),
         R.decode_attention_int8_ref(q32, kq, ks, vq, vs, valid), f32)
    torch.cuda.empty_cache()


def _attention_record(name, path, shape, err, fn, plain, nbytes, flops, library, flush):
    """A kernels-line record: bound from the bytes the call must move and its
    bf16 operations, times from CUDA events (median of 25, L2 flushed)."""
    b_ms, b_by = bound(nbytes, flops, "bfloat16")
    src = "flash_attention.cu" if name.startswith("flash") else "decode_attention.cu"
    return dict(name=name, path=path, shape=shape, route="cuda",
                source=f"src/repro_torch/kernels/csrc/{src}", replaces=REPLACES[name],
                launches=0, max_abs_err=err, ms=timed_ms(fn, flush),
                plain_ms=timed_plain(plain, flush), bound_ms=b_ms, bound_by=b_by,
                library_ms=None if library is None else timed_ms(library, flush))


def family_kernel_checks(torch, R, F, dev):
    """Phase 3's kernel checks at phases 25-27's shapes, bf16, each held to
    its plain version at 2 bf16 ulps a row and timed (its plain version, SDPA
    where one call computes the same function, its bound): families_serving
    at deepseek-coder-33b's GQA group 7 (prefill (8, 512, 56 over 8, 128),
    decode over 577 rows); encdec_serving at whisper-medium's head dim 64
    (the encoder (8, 1500, 16, 64) bidirectional, the cross-attention
    prefill of 32 decoder rows against 1500 frames, the decoder's causal
    self-attention prefill of 32 rows, its self decode over 97 rows and its
    cross decode over 1500 frames, native and int8); vlm_serving at
    qwen2-vl-7b's group 7 (prefill (8, 1536, 28 over 4, 128), decode over
    1601 rows)."""
    from repro_torch.kernels.decode_attention import decode_attention, decode_attention_int8
    from repro_torch.kernels.flash_attention import flash_attention_fwd

    gen = torch.Generator(device=dev)
    gen.manual_seed(2526)
    scratch = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    flush = scratch.zero_
    records = []

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)

    def flash(path, shape, B, Sq, Skv, H, Hkv, D, causal):
        q, k, v = rand(B, Sq, H, D), rand(B, Skv, Hkv, D), rand(B, Skv, Hkv, D)
        run = lambda: flash_attention_fwd(q, k, v, causal=causal)               # noqa: E731
        plain = lambda: R.flash_attention_ref(q, k, v, causal=causal)           # noqa: E731
        err = row_ulp_check(torch, f"flash_attention {path} {shape}", run(), plain())
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        pairs = Sq * (Sq + 1) // 2 if causal else Sq * Skv
        records.append(_attention_record(
            "flash_attention", path, shape, err, run, plain,
            2 * (2 * q.numel() + 2 * k.numel()), 4 * D * B * H * pairs,
            lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                   enable_gqa=Hkv != H), flush))

    def decode(path, shape, H, Hkv, D, cache, valid_l):
        B = len(valid_l)
        valid = torch.tensor(valid_l, dtype=torch.int32, device=dev)
        rows = int(valid.sum())
        q = rand(B, 1, H, D)
        k, v = rand(B, cache, Hkv, D), rand(B, cache, Hkv, D)
        run = lambda: decode_attention(q, k, v, valid)                          # noqa: E731
        plain = lambda: R.decode_attention_ref(q, k, v, valid)                  # noqa: E731
        err = row_ulp_check(torch, f"decode_attention {path} {shape}", run(), plain())
        mask = (torch.arange(cache, device=dev)[None, :] < valid[:, None])[:, None, None, :]
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        small = 2 * q.numel() * 2 + B * 4
        records.append(_attention_record(
            "decode_attention", path, shape, err, run, plain,
            2 * rows * Hkv * D * 2 + small, 4 * D * H * rows,
            lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                   enable_gqa=Hkv != H), flush))
        (kq, ks), (vq, vs) = R.quantize_int8_ref(k), R.quantize_int8_ref(v)
        run8 = lambda: decode_attention_int8(q, kq, ks, vq, vs, valid)           # noqa: E731
        plain8 = lambda: R.decode_attention_int8_ref(q, kq, ks, vq, vs, valid)   # noqa: E731
        err8 = row_ulp_check(torch, f"decode_attention_int8 {path} {shape}", run8(), plain8())
        records.append(_attention_record(
            "decode_attention_int8", path, shape, err8, run8, plain8,
            2 * rows * Hkv * (D + 4) + small, 4 * D * H * rows, None, flush))

    flash("families_serving", "deepseek-coder-33b prefill GQA-7", 8, 512, 512, 56, 8, 128, True)
    decode("families_serving", "deepseek-coder-33b decode GQA-7", 56, 8, 128, 577,
           [576, 1, 300, 513, 576, 0, 450, 520])
    flash("encdec_serving", "whisper encoder", 8, 1500, 1500, 16, 16, 64, False)
    flash("encdec_serving", "whisper cross prefill", 8, 32, 1500, 16, 16, 64, False)
    flash("encdec_serving", "whisper self prefill", 8, 32, 32, 16, 16, 64, True)
    decode("encdec_serving", "whisper self decode", 16, 16, 64, 97,
           [96, 33, 64, 80, 96, 40, 90, 70])
    decode("encdec_serving", "whisper cross decode", 16, 16, 64, 1500, [1500] * 8)
    flash("vlm_serving", "qwen2-vl-7b prefill GQA-7", 8, 1536, 1536, 28, 4, 128, True)
    decode("vlm_serving", "qwen2-vl-7b decode GQA-7", 28, 4, 128, 1601,
           [1600, 1537, 1568, 1590, 1600, 1545, 1580, 1555])
    del scratch
    torch.cuda.empty_cache()
    for rec in records:
        print(json.dumps(rec))
    return records


def _side_inputs(torch, cfg, B, n_patches, gen, dev):
    """The stub frontend's output drawn from ``gen``: whisper's frames (B,
    n_frames, d_model), the VLM's patch embeddings (B, n_patches, d_model)."""
    if cfg.family == "encdec":
        return {"frames": torch.randn(B, cfg.n_frames, cfg.d_model, generator=gen,
                                      device=dev).to(cfg.dtype)}
    if cfg.family == "vlm":
        return {"patch_embeds": torch.randn(B, n_patches, cfg.d_model, generator=gen,
                                            device=dev).to(cfg.dtype)}
    return {}


def _slice_launches(cfg, kv, decode_steps):
    """(flash launches, decode op, decode launches) of one prefill and
    ``decode_steps`` steps: whisper's prefill runs the encoder and, per
    decoder layer, its self and its cross attention; each step both."""
    decode_op = "decode_attention_int8" if kv == "int8" else "decode_attention"
    if cfg.family == "encdec":
        return cfg.n_enc_layers + 2 * cfg.n_dec_layers, decode_op, 2 * cfg.n_dec_layers * \
            decode_steps
    return cfg.n_layers, decode_op, cfg.n_layers * decode_steps


def cross_device_slice(torch, ops, get_model, smoke_config, ServeSession, dev):
    """Before phases 25-27, as phase 4: the five configs' smoke variants in
    float32, greedy tokens from the plain path on the CPU and the kernels on
    the card identical, native and int8 cache, every attention call of the
    card's run through the kernels."""
    for arch in SLICE_ARCHS:
        base = smoke_config(arch)
        rng = np.random.default_rng(25)
        prompt = torch.from_numpy(rng.integers(0, base.vocab, (2, 13)))
        cpu_gen = torch.Generator()
        cpu_gen.manual_seed(25)
        side = _side_inputs(torch, base, 2, 4, cpu_gen, "cpu")
        for kv in ("native", "int8"):
            model = get_model(base.with_(kv_cache_dtype=kv))
            cpu_params, _ = model.init_params(seed=0, device="cpu")
            gpu_params = _to(cpu_params, dev)
            want = ServeSession(model=model, params=cpu_params, device="cpu").generate(
                prompt, max_new_tokens=6, **side).tokens
            ops.reset_launches()
            got = ServeSession(model=model, params=gpu_params, device=dev).generate(
                prompt, max_new_tokens=6, **side).tokens.cpu()
            counts = {k: c for k, c in ops.LAUNCHES.items() if c}
            print(f"[slice] {arch} smoke {kv}: cpu={want.tolist()} gpu={got.tolist()} "
                  f"launches={counts}")
            if not torch.equal(want, got):
                raise AssertionError(f"{arch} {kv}: greedy tokens differ between CPU and card")
            n_flash, decode_op, n_decode = _slice_launches(base, kv, 6)
            if (counts.get("flash_attention") != n_flash
                    or counts.get(decode_op) != n_decode or len(counts) != 2):
                raise AssertionError(f"{arch} {kv}: attention did not run through the kernels: "
                                     f"{counts}")


def predicted_peak_gib(cfg, n_params, B, seq, cache_len, kv):
    """Weights, the KV cache (whisper: its self and cross K/V) and the
    prefill's widest live activations (the MLP's three intermediates, the
    rows' f32 norm, q/k/v/out), in GiB."""
    hd = cfg.resolved_head_dim()
    row = hd * 2 if kv == "native" else hd + 4
    if cfg.family == "encdec":
        kv_bytes = cfg.n_dec_layers * B * (cache_len + cfg.n_frames) * cfg.n_kv_heads * row * 2
        seq = max(seq, cfg.n_frames)
    else:
        kv_bytes = cfg.n_layers * B * cache_len * cfg.n_kv_heads * row * 2
    act = B * seq * (3 * cfg.d_ff * 2 + cfg.d_model * 4 + 4 * cfg.n_heads * hd * 2)
    return (n_params * 2 + kv_bytes + act) / 2**30


def _serve_full(torch, ops, get_model, ServeSession, cfg, params, prompt, side, n_new, tag,
                dev):
    """Native and int8 KV: a warm-up prefill (checked), then the greedy run
    with the counts reset just before it and read just after; returns the
    launch totals and the ms a decode step, by KV dtype."""
    B, P = prompt.shape
    n_prefix = P + (side["patch_embeds"].shape[1] if "patch_embeds" in side else 0)
    totals = {name: 0 for name in ops.LAUNCHES}
    toks, step_ms = {}, {}
    for kv in ("native", "int8"):
        model = get_model(cfg.with_(kv_cache_dtype=kv))
        logits, cache = model.prefill(params, prompt, n_prefix + n_new + 1, **side)
        torch.cuda.synchronize()
        if tuple(logits.shape) != (B, 1, cfg.vocab) or not torch.isfinite(logits).all():
            raise AssertionError(f"{cfg.name} {kv}: prefill logits {tuple(logits.shape)} "
                                 f"not finite")
        del logits, cache
        torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launches()
        out = ServeSession(model=model, params=params, device=dev).generate(
            prompt, max_new_tokens=n_new, **side)
        counts = dict(ops.LAUNCHES)
        peak = torch.cuda.max_memory_allocated(dev)
        print(f"[{tag}] {cfg.name} {kv}: prefill {out.prefill_time * 1e3:.3f} ms, decode "
              f"{out.decode_tok_s:.3f} tok/s ({out.ms_per_step:.3f} ms/step), peak memory "
              f"{peak / 2**30:.3f} GiB, launches {({k: c for k, c in counts.items() if c})}")
        t = out.tokens
        if tuple(t.shape) != (B, n_new + 1) or int(t.min()) < 0 or int(t.max()) >= cfg.vocab:
            raise AssertionError(f"{cfg.name} {kv}: tokens {tuple(t.shape)} out of range")
        n_flash, decode_op, n_decode = _slice_launches(cfg, kv, n_new)
        if counts["flash_attention"] != n_flash or counts[decode_op] != n_decode:
            raise AssertionError(f"{cfg.name} {kv}: attention did not run through the kernels: "
                                 f"{counts}")
        for name, c in counts.items():
            totals[name] += c
        toks[kv], step_ms[kv] = t.cpu(), out.ms_per_step
    agree = (toks["native"] == toks["int8"]).float().mean().item()
    print(f"[{tag}] {cfg.name} native vs int8 KV: {agree:.3f} of generated tokens agree")
    return totals, step_ms


def full_width_slice(torch, ops, get_model, get_config, ServeSession, dev, archs, tag,
                     B=8, P=512, n_new=32, n_patches=1024):
    """Phases 25-27: each arch at its published size (bf16, seed-0 weights
    built on the card slice by slice) through ``ServeSession.generate``,
    batch 8, 32 greedy tokens, native and int8 KV: the dense configs at
    prompt ``P``; whisper-medium over 1500 stub frames at prompt ``P``;
    qwen2-vl-7b over ``n_patches`` stub patch embeddings and ``P`` text
    tokens.  Each arch's predicted peak is printed
    before its weights are built; they are freed after it.  Returns the
    launch totals and each arch's native ms a decode step."""
    totals, step_ms = {name: 0 for name in ops.LAUNCHES}, {}
    for arch in archs:
        cfg = get_config(arch)
        model = get_model(cfg)
        abstract, _ = model.init_params(abstract=True)
        n_params = sum(t.numel() for t in _leaves(abstract))
        n_vis = n_patches if cfg.family == "vlm" else 0
        cache_len = n_vis + P + n_new + 1
        torch.cuda.empty_cache()
        print(f"[{tag}] {arch}: {n_params / 1e9:.3f} B params; predicted peak "
              f"{predicted_peak_gib(cfg, n_params, B, n_vis + P, cache_len, 'native'):.2f} GiB "
              f"native (weights {n_params * 2 / 2**30:.2f}); allocated before "
              f"{torch.cuda.memory_allocated(dev) / 2**30:.3f} GiB")
        t0 = time.perf_counter()
        params, _ = model.init_params(seed=0, device=dev)
        torch.cuda.synchronize()
        print(f"[{tag}] {arch}: weights built in {time.perf_counter() - t0:.1f} s, allocated "
              f"{torch.cuda.memory_allocated(dev) / 2**30:.3f} GiB")
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        prompt = torch.randint(0, cfg.vocab, (B, P), generator=gen, device=dev)
        side = _side_inputs(torch, cfg, B, n_patches, gen, dev)
        counts, ms = _serve_full(torch, ops, get_model, ServeSession, cfg, params, prompt, side,
                                 n_new, tag, dev)
        for name, c in counts.items():
            totals[name] += c
        step_ms[arch] = ms["native"]
        del params, prompt, side
        torch.cuda.empty_cache()
    return totals, step_ms


def profile_slice(torch, get_model, get_config, dev, step_ms, B=8, P=512, n_patches=1024):
    """Phase 12, this slice's cells: one native decode step of each arch of
    phases 25-27 after its prefill (whisper at prompt 32), device time by
    kind, busy ms and the idle share of the step phases 25-27 timed."""
    for arch, ms in step_ms.items():
        cfg = get_config(arch)
        model = get_model(cfg)
        torch.cuda.empty_cache()
        params, _ = model.init_params(seed=0, device=dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        p = 32 if cfg.family == "encdec" else P
        prompt = torch.randint(0, cfg.vocab, (B, p), generator=gen, device=dev)
        side = _side_inputs(torch, cfg, B, n_patches, gen, dev)
        n_prefix = p + (n_patches if cfg.family == "vlm" else 0)
        logits, cache = model.prefill(params, prompt, n_prefix + 16, **side)
        print(f"[profile] {arch}:")
        busy = profile_decode(torch, model, params, cache, logits, n_prefix)
        if busy is not None:
            print(f"[profile] {arch} native: device busy {busy:.3f} ms of {ms:.3f} ms per "
                  f"decode step: idle share {1 - busy / ms:.3f}")
        del params, logits, cache, prompt, side
    torch.cuda.empty_cache()


def slice_phases(torch, ops, R, F, get_model, get_config, smoke_config, ServeSession, dev):
    """This slice's kernel checks, the smoke configs CPU vs card, then
    phases 25-27, each timed against its budget -> (records, launch totals
    by path, native ms a decode step by arch)."""
    spent = {}

    def timed(label, fn):
        t0 = time.perf_counter()
        out = fn()
        spent[label] = time.perf_counter() - t0
        over = " OVER BUDGET" if spent[label] > SLICE_BUDGET_S[label] else ""
        print(f"[slice] phase {label}: {spent[label]:.1f} s (budget "
              f"{SLICE_BUDGET_S[label]} s){over}")
        return out

    records = timed("kernels", lambda: family_kernel_checks(torch, R, F, dev))
    timed("cross-device", lambda: cross_device_slice(torch, ops, get_model, smoke_config,
                                                     ServeSession, dev))
    totals, step_ms = {}, {}
    for phase, path, archs, kw in (("25", "families_serving", FAMILY_ARCHS, {}),
                                   ("26", "encdec_serving", ("whisper-medium",), {"P": 32}),
                                   ("27", "vlm_serving", ("qwen2-vl-7b",), {})):
        totals[path], ms = timed(phase, lambda: full_width_slice(
            torch, ops, get_model, get_config, ServeSession, dev, archs, path.split("_")[0],
            **kw))
        step_ms.update(ms)
    return records, totals, step_ms


# ---------------------------------------------------------------------------
# Training the MoE, encoder-decoder and vision-language families (28-30)
# ---------------------------------------------------------------------------

# phases 29-30 through make_train_step: arch -> (layers, or None for all,
# rows, decoder / text tokens, stub patches); all rows valid
SIDE_TRAIN = {"whisper-medium": (None, 16, 256, 0), "qwen2-vl-7b": (8, 8, 512, 1024)}


def attention_records(torch, R, F, rand, flush, path, shape, B, Sq, Skv, H, Hkv, D, causal,
                      int8=True):
    """Flash at (B, Sq, H, D) over (B, Skv, Hkv, D) bf16 K/V from ``rand``,
    held to its plain version at 2 bf16 ulps a row and timed beside SDPA;
    with ``int8``, the quantizer over the K rows (bit for bit) and the
    int8-K/V flash kernel too.  -> the kernels-line records."""
    from repro_torch.kernels.flash_attention import flash_attention_fwd, flash_attention_int8_fwd
    from repro_torch.kernels.quantize import quantize_rows

    records = []
    q, k, v = rand(B, Sq, H, D), rand(B, Skv, Hkv, D), rand(B, Skv, Hkv, D)
    run = lambda: flash_attention_fwd(q, k, v, causal=causal)               # noqa: E731
    plain = lambda: R.flash_attention_ref(q, k, v, causal=causal)           # noqa: E731
    err = row_ulp_check(torch, f"flash_attention {path} {shape}", run(), plain())
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    flops = attention_ops(B, H, Sq, Skv, D, causal)
    records.append(_attention_record(
        "flash_attention", path, shape, err, run, plain,
        2 * (2 * q.numel() + 2 * k.numel()), flops,
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                               enable_gqa=Hkv != H), flush))
    del qt, kt, vt
    if not int8:
        return records
    rec = quant_record(torch, R, path, k.view(-1, D), flush)
    records.append(dict(rec, shape=f"{shape}: K {rec['shape']}"))
    kq, ks = (t.view(B, Skv, Hkv, -1) for t in quantize_rows(k.view(-1, D), 0.5))
    vq, vs = (t.view(B, Skv, Hkv, -1) for t in quantize_rows(v.view(-1, D), 0.5))
    del k, v
    run8 = lambda: flash_attention_int8_fwd(q, kq, ks, vq, vs, causal=causal)  # noqa: E731
    plain8 = lambda: R.flash_attention_ref(                                  # noqa: E731
        q, R.dequantize_int8_ref(kq, ks), R.dequantize_int8_ref(vq, vs), causal=causal)
    err8 = row_ulp_check(torch, f"flash_attention_q8 {path} {shape}", run8(), plain8())
    records.append(_attention_record(
        "flash_attention_q8", path, shape, err8, run8, plain8,
        2 * q.numel() * 2 + kq.numel() + vq.numel() + (ks.numel() + vs.numel()) * 4,
        flops, None, flush))
    return records


def train_family_kernel_checks(torch, R, F, dev):
    """Before phase 28: phase 3's kernel checks at the training shapes of
    phases 28-30, bf16, each held to its plain version on the card (flash
    and int8-K/V flash to 2 bf16 ulps a row, the quantizer and the combine
    bit for bit, the expert GEMM to one bf16 ulp of its largest output) and
    timed: MT, qwen3-moe-30b-a3b's attention (60, 256, 32 over 4, 128) and
    its expert GEMM and combine at T 15,360 / C 1,280 (128 experts top-8, d
    2048, f 768); ET, whisper-medium's encoder (16, 1500, 16, 64)
    bidirectional, its causal self-attention (16, 256, 16, 64) and its
    cross-attention (256 rows against 1500 frames; float K/V under every
    precision); VT, qwen2-vl-7b's (8, 1536, 28 over 4, 128).  Under
    int8-fused each self-attention quantizes its K and V rows: the
    quantizer is checked and timed over K's."""
    from repro_torch.configs import get_config
    from repro_torch.models.moe import expert_capacity

    gen = torch.Generator(device=dev)
    gen.manual_seed(2828)
    scratch = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    flush = scratch.zero_
    bf16 = torch.bfloat16

    def rand(*shape, std=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * std).to(bf16)

    def attention(*args, **kw):
        return attention_records(torch, R, F, rand, flush, *args, **kw)

    records = attention("moe_training", "MT (60, 256, 32 over 4, 128)", 60, 256, 256, 32, 4,
                        128, True)
    records += attention("encdec_training", "ET encoder (16, 1500, 16, 64)", 16, 1500, 1500,
                         16, 16, 64, False)
    records += attention("encdec_training", "ET self (16, 256, 16, 64)", 16, 256, 256, 16, 16,
                         64, True)
    records += attention("encdec_training", "ET cross 256 rows x 1500 frames", 16, 256, 1500,
                         16, 16, 64, False, int8=False)
    records += attention("vlm_training", "VT (8, 1536, 28 over 4, 128)", 8, 1536, 1536, 28, 4,
                         128, True)

    cfg = get_config("qwen3-moe-30b-a3b")
    d, f, E, k = cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.experts_per_token
    T = 60 * 256
    C = expert_capacity(T, E, k, cfg.capacity_factor)
    wg, wu = rand(E, d, f, std=d ** -0.5), rand(E, d, f, std=d ** -0.5)
    wo = rand(E, f, d, std=f ** -0.5)
    router = rand(d, E, std=d ** -0.5)
    records += moe_gemm_combine_records(torch, R, F, rand(T, d), router, wg, wu, wo, k, C,
                                        f"MT T {T} C {C}", "moe_training", flush)
    del wg, wu, wo, router, scratch
    torch.cuda.empty_cache()
    for rec in records:
        print(json.dumps(rec))
    return records


def moe_grad_check(torch, ops, R, dev):
    """Before phase 28, as phase 17: the gradients of ``ops.fused_moe_mlp``
    (the kernels forward, the plain recompute backward) on the card against
    the plain op's autograd gradients, every input, at 4 rows of phase 28
    (T 1,024; d 2048, 128 experts top-8, f 768, bf16), with a cotangent on
    the aux loss; then the aux loss alone: its gradient reaches the router
    (non-zero) and equals the plain op's."""
    from repro_torch.configs import get_config
    from repro_torch.models.moe import expert_capacity

    cfg = get_config("qwen3-moe-30b-a3b")
    d, f, E, k = cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.experts_per_token
    T = 4 * 256
    C = expert_capacity(T, E, k, cfg.capacity_factor)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1717)
    bf16 = torch.bfloat16

    def rand(*shape, std=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * std).to(bf16)

    inputs = (rand(T, d), rand(d, E, std=d ** -0.5), rand(E, d, f, std=d ** -0.5),
              rand(E, d, f, std=d ** -0.5), rand(E, f, d, std=f ** -0.5))

    def grads_of(fn, cots):
        leaves = [t.detach().requires_grad_() for t in inputs]
        out, aux = fn(*leaves)
        loss = (out.float() * cots[0]).sum() + aux * cots[1]
        return torch.autograd.grad(loss, leaves)

    def kernel(*a):
        return ops.fused_moe_mlp(*a, k=k, capacity=C)

    def plain(*a):
        return R.fused_moe_mlp_ref(*a, k, C)

    cots = (torch.randn(T, d, generator=gen, device=dev), 1.0)
    grad_check(torch, ("ops.fused_moe_mlp", ("x", "router", "wi_gate", "wi_up", "wo")),
               grads_of(kernel, cots), grads_of(plain, cots), 2 ** -7)
    aux_only = (torch.zeros(T, d, device=dev), 1.0)
    got, want = grads_of(kernel, aux_only)[1], grads_of(plain, aux_only)[1]
    size = want.float().abs().max().item()
    print(f"[check] ops.fused_moe_mlp: the aux loss's router gradient, max |d router| "
          f"{size:.3e}")
    if not size > 0:
        raise AssertionError("the aux loss does not reach the router's gradient")
    close_check(torch, "ops.fused_moe_mlp d router of aux (bfloat16)", got, want, 0.0,
                2 ** -7 * size)
    torch.cuda.empty_cache()


def fan_in_weights(torch, params, seed):
    """``params`` with every stacked projection redrawn from ``seed`` at
    N(0, 1/fan_in) over the axes it contracts (attention q/k/v over d_model,
    its out-projection over heads x head dim, an MLP matrix over its input
    width), as tests/test_torch_families.py::numpy_params draws them;
    embeddings, norms and biases kept.  The port's init, as the reference's,
    reads a stacked leaf's fan-in from its layer axis."""
    gen = torch.Generator()
    gen.manual_seed(seed)

    def walk(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif v.dim() == 4 and k in ("wq", "wk", "wv", "wo"):
                fan_in = v.shape[1] * (v.shape[2] if k == "wo" else 1)
                out[k] = torch.randn(v.shape, generator=gen).to(v.dtype) / fan_in ** 0.5
            elif v.dim() == 3 and k in ("wi", "wo", "wi_gate", "wi_up"):
                out[k] = torch.randn(v.shape, generator=gen).to(v.dtype) / v.shape[1] ** 0.5
            else:
                out[k] = v
        return out

    return walk(params)


def _side_batch(torch, cfg, rows, seq, n_patches, gen, dev):
    """A training batch drawn from ``gen``: tokens and labels (rows, seq),
    every position scored, and whisper's frames or the VLM's patch
    embeddings (the VLM's logits cover [patches | text]; the loss scores
    the text)."""
    def toks():
        return torch.randint(0, cfg.vocab, (rows, seq), generator=gen, device=dev,
                             dtype=torch.int32)

    return {"tokens": toks(), "labels": toks(),
            "loss_mask": torch.ones(rows, seq, dtype=torch.float32, device=dev),
            **_side_inputs(torch, cfg, rows, n_patches, gen, dev)}


def _side_step(get_model, cfg, params, rows, steps, opt):
    """make_train_step with ``opt`` and the goyal schedule at ``rows`` valid
    rows -> (step, the optimizer's state of ``params``)."""
    from repro_torch.optim import goyal_schedule
    from repro_torch.train.steps import make_train_step

    sched = goyal_schedule(1e-3, rows, base_batch=256, warmup_steps=20, total_steps=steps)
    return make_train_step(get_model(cfg), opt, sched), opt.init(params)


def cross_device_family_train(torch, ops, get_model, smoke_config, train_session_factory, dev):
    """Before phase 28, as phase 7: the smoke configs in float32 from the
    same weights, the plain path on the CPU against the kernels on the
    card, in f32 and int8-fused: both MoE configs for 6 steps through
    Session.run, whisper and qwen2-vl for 3 steps through make_train_step
    with frames / patch embeddings in the batch; per-step losses within
    phase 7's tolerances and every kernel launch of the card's run counted.
    whisper and qwen2-vl train from ``fan_in_weights`` with SGD.  At the
    port's init (the reference's: q/k/v at std 0.71 where 1/sqrt(d_model) is
    0.125) the card's and the CPU's float32 rounding part their logits by
    3.6e-3 (whisper) and 1.2e-3 (qwen2-vl) with the plain attention on both
    as with the kernels (``scripts/init_rounding_probe.py``), and AdamW's
    first update moves every coordinate by about +-lr, on a sign rounding
    noise picks where a gradient is near zero: a 1e-6 perturbation of the
    gradients moves their losses by 1e-3 at that init, 7e-5 at fan-in
    weights under AdamW and 1e-7 under SGD
    (``scripts/side_train_noise_probe.py``)."""
    import copy

    from repro_torch.optim import sgd_momentum

    for arch in ("qwen3-moe-30b-a3b", "dbrx-132b"):
        cross_device_train(torch, ops, train_session_factory, dev, arch)
    rtol = {"f32": 1e-4, "int8-fused": 1e-2}   # phase 7's
    steps, rows, seq, n_patches = 3, 4, 16, 4
    for arch in SIDE_TRAIN:
        for prec in ("f32", "int8-fused"):
            cfg = smoke_config(arch).with_(train_precision=prec)
            params = fan_in_weights(torch, get_model(cfg).init_params(seed=0, device="cpu")[0], 3)
            gpu_params = _to(copy.deepcopy(params), dev)
            gen = torch.Generator()
            gen.manual_seed(28)
            batches = [_side_batch(torch, cfg, rows, seq, n_patches, gen, "cpu")
                       for _ in range(steps)]
            losses = {}
            for where, p in (("cpu", params), ("gpu", gpu_params)):
                step, state = _side_step(get_model, cfg, p, rows, steps, sgd_momentum())
                ops.reset_launches()
                losses[where] = []
                for b in batches:
                    p, state, m = step(p, state, _to(b, dev) if where == "gpu" else b)
                    losses[where].append(float(m["loss"]))
            counts = dict(ops.LAUNCHES)
            print(f"[cross-device] train {arch} {prec}: cpu="
                  f"{[round(x, 6) for x in losses['cpu']]} gpu="
                  f"{[round(x, 6) for x in losses['gpu']]} launches={counts}")
            if not np.allclose(losses["gpu"], losses["cpu"], rtol=rtol[prec], atol=0.0):
                raise AssertionError(f"{arch} {prec}: per-step losses differ between CPU and card")
            _check_launches(counts, expected_train_launches(cfg, prec, steps),
                            f"{arch} {prec} training")


def full_width_side_train(torch, ops, get_model, get_config, dev, arch):
    """Phases 29 and 30: ``arch`` at full width (depth from SIDE_TRAIN)
    through make_train_step with AdamW (bf16 weights, float32 moments) for
    TRAIN_STEPS steps in f32 and int8-fused, on batches
    drawn from the seed on the card (stub frames or patch embeddings from
    the seed too), reported as phase 8; the predicted peak is printed
    before the weights are built, and they are freed after each run."""
    from repro_torch.optim import adamw

    layers, rows, seq, n_patches = SIDE_TRAIN[arch]
    steps = TRAIN_STEPS
    totals = {name: 0 for name in ops.LAUNCHES}
    step_ms = {}
    for prec in ("f32", "int8-fused"):
        cfg = get_config(arch).with_(train_precision=prec)
        if layers is not None:
            cfg = cfg.with_(n_layers=layers)
        torch.cuda.empty_cache()
        print(f"[train] {cfg.name} {prec}: predicted peak "
              f"{predicted_train_peak_gib(cfg, cfg.param_count(), rows, n_patches + seq, seq):.2f}"
              f" GiB; allocated before {torch.cuda.memory_allocated(dev) / 2**30:.3f} GiB")
        params, _ = get_model(cfg).init_params(seed=0, device=dev)
        step, state = _side_step(get_model, cfg, params, rows, steps, adamw())
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launches()
        hist = []
        t0 = time.perf_counter()
        for _ in range(steps):
            td = time.perf_counter()
            batch = _side_batch(torch, cfg, rows, seq, n_patches, gen, dev)
            ts = time.perf_counter()
            params, state, metrics = step(params, state, batch)
            metrics = {k: float(v) for k, v in metrics.items()}   # waits for the card
            metrics["step_time"] = time.perf_counter() - ts
            metrics["data_time"] = ts - td
            hist.append(metrics)
        wall = time.perf_counter() - t0
        counts = dict(ops.LAUNCHES)
        peak = torch.cuda.max_memory_allocated(dev)
        step_ms[(arch, prec)] = report_train(cfg, arch, prec, hist, wall, rows, rows, seq, peak,
                                             counts, steps, get_config)
        _check_launches(counts, expected_train_launches(cfg, prec, steps),
                        f"{cfg.name} {prec} training")
        for name, c in counts.items():
            totals[name] += c
        del params, state, step, batch
        torch.cuda.empty_cache()
    return totals, step_ms


# ---------------------------------------------------------------------------
# Multi-process cluster training, hostsync (phases 31-32)
# ---------------------------------------------------------------------------

# phase 31's cell, cluster_hostsync_deepseek7b: deepseek-7b at full width cut
# to 2 layers (as phases 23-24), seq 256, through the training driver's
# session (launch/train.py::train_session_factory, its --cluster-processes
# route) on FleetSpec.demo(3)'s own batch caps: 4 dp-groups of 10 rows (40
# rows, 16 valid), 2 groups and 20 rows a worker; f32 (bf16 weights), AdamW.
# 2 worker processes share the card under TransportSpec.production() (int8,
# ring, 2 buckets, overlap).  (The driver's own caps give 40 rows a worker,
# which peaked at ~38 GiB in phase 23: two do not fit.)
CLUSTER_CELL = dict(arch="deepseek-7b", full_config=True, n_layers=CKPT_LAYERS,
                    seq=CKPT_SEQ, csds=3, fleet={})
# (4 until phases 37-38 joined the run: a step of a worker or a gloo rank
# takes ~10 s, and the run keeps inside its 1,200 s)
CLUSTER_STEPS = 3


def _mem_available_gib() -> float:
    """The host's MemAvailable (``/proc/meminfo``), GiB."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) / 2**20
    return float("nan")


def cluster_bucket_lens():
    """The lengths of phase 31's two bucket vectors (``plan_buckets`` over
    the model's leaves in the reference's order)."""
    from repro_torch.launch.train import train_session_factory
    from repro_torch.train.steps import plan_buckets, tree_leaves_sorted

    session = train_session_factory(device="cpu", **CLUSTER_CELL)
    like, _ = session.model.init_params(abstract=True, device="cpu")
    leaves = tree_leaves_sorted(like)
    return [sum(leaves[i].numel() for i in grp) for grp in plan_buckets(like, 2)]


def cluster_kernel_checks(torch, R, F, dev, bucket_lens):
    """Before phase 31: the row quantizer at the int8 codec's shapes -- the
    bucket vectors of phase 31 as rows of 512 f32, and a ragged vector whose
    last row is padded with zeros -- at noise 0.5, bit for bit against its
    plain version, timed, beside its byte bound; the codec itself on the
    card against the codec on the CPU (its plain quantizer): payload bytes
    and residuals equal over two steps at a ragged length; then flash at a
    worker's shape, (20, 256, 32, 128) bf16, within 2 bf16 ulps a row."""
    from repro_torch.core.topology import TransportSpec
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.launch.transport import GradCodec

    gen = torch.Generator(device=dev)
    gen.manual_seed(3131)
    scratch = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    flush = scratch.zero_
    chunk = TransportSpec.production().chunk
    records = []
    for n in bucket_lens:
        rows = -(-n // chunk)
        x = torch.zeros(rows * chunk, device=dev)
        x[:n] = torch.randn(n, generator=gen, device=dev) * 1e-3
        records.append(quant_record(torch, R, "cluster_training", x.view(rows, chunk), flush))
        del x
        torch.cuda.empty_cache()
    n = 1001 * chunk - 300                       # a ragged tail: 212 values + 300 zeros
    x = torch.zeros(1001 * chunk, device=dev)
    x[:n] = torch.randn(n, generator=gen, device=dev)
    records.append(quant_record(torch, R, "cluster_training", x.view(1001, chunk), flush))

    card, host = (GradCodec(TransportSpec(compression="int8", chunk=chunk)) for _ in range(2))
    n = 3 * 2**20 + 77
    for step in range(2):
        vec = torch.randn(n, generator=gen, device=dev) * 10.0 ** -step
        got, want = card.encode(0, vec), host.encode(0, vec.cpu())
        same = (got["q"].tobytes() == want["q"].tobytes()
                and got["s"].tobytes() == want["s"].tobytes()
                and torch.equal(card._residual[0].cpu(), host._residual[0]))
        print(f"[check] GradCodec int8 on the card vs on the CPU, n {n} (ragged), step "
              f"{step + 1}: payload and residual {'bit-equal' if same else 'DIFFER'}")
        if not same:
            raise AssertionError("the card's int8 codec differs from its CPU path")
    del card, host, vec, x

    B, S, H, D = 20, 256, 32, 128
    q, k, v = (torch.randn(B, S, H, D, generator=gen, device=dev).to(torch.bfloat16)
               for _ in range(3))
    err = row_ulp_check(torch, f"flash_attention cluster_training {(B, S, H, D)} bf16",
                        flash_attention_fwd(q, k, v, causal=True),
                        R.flash_attention_ref(q, k, v, causal=True))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    records.append(_attention_record(
        "flash_attention", "cluster_training", f"a worker's ({B}, {S}, {H}, {D})", err,
        lambda: flash_attention_fwd(q, k, v, causal=True),
        lambda: R.flash_attention_ref(q, k, v, causal=True),
        4 * q.numel() * q.element_size(), 4 * D * B * H * S * (S + 1) // 2,
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True), flush))
    del q, k, v, qt, kt, vt, scratch
    torch.cuda.empty_cache()
    for rec in records:
        print(json.dumps(rec))
    return records


def predicted_cluster_peaks_gib(cfg, n_params, bucket_lens, rows, seq):
    """A worker's predicted peaks, (device, host) GiB.  Device, the largest
    of: the forward and backward over its rows -- bf16 weights and
    gradients and f32 moments (12 B a parameter), 20 B a logit (one process
    at 80 rows of this model peaked at 51.8 GiB on the H100: 12 B a
    parameter and 19.4 B a logit), each layer's saved input -- beside the
    f32 error-feedback residuals (4 B a parameter); the reduce (bf16
    weights, f32 moments, residuals, the f32 bucket vectors, y and the int8
    payload of the largest bucket); the apply (the bf16 gradients landed
    from the host sums, their f32 quotients and AdamW's four temporaries of
    the largest leaf, the (vocab, d_model) table).  Host:
    the largest bucket's own and peer int8 payloads, its two decoded f32
    vectors and their sum, and the other bucket's sum."""
    w, big = n_params, max(bucket_lens)
    fwd = 16 * w + rows * seq * (cfg.vocab * 20 + cfg.d_model * 2 * cfg.n_layers)
    reduce = 10 * w + 4 * w + 4 * w + 4 * big + big
    apply = 10 * w + 4 * w + 2 * w + 4 * w + 4 * 4 * cfg.vocab * cfg.d_model
    host = 2 * big + 3 * 4 * big + 4 * (sum(bucket_lens) - big)
    return max(fwd, reduce, apply) / 2**30, host / 2**30


def _run_workers(coord, timeout):
    """Launch the coordinator's workers, wait, and return their records in
    process order; a non-zero return code fails with the workers' logs.
    The workers' allocator maps segments on demand
    (``expandable_segments``): they share the card, and blocks one keeps
    cached in fixed segments the other cannot use."""
    import os

    old = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        coord.launch(resume_steps=0)
    finally:
        if old is None:
            del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = old
    try:
        result = coord.wait(timeout=timeout)
    finally:
        coord.close()
    if not result.ok:
        print(coord.tail_logs(60), file=sys.stderr)
        raise AssertionError(f"cluster workers failed: return codes {result.returncodes}")
    return [result.record(p) for p in range(len(result.returncodes))]


def _cluster_report(rec, what):
    """Phase 31-32's lines for one worker: ms a step and its split, wire
    bytes, compression ratio, peak memory, launches."""
    t, split = rec["transport"], rec["step_split"]
    steps = max(1, split["steps"])
    ms = statistics.median(rec["step_times"][1:]) * 1e3
    print(f"[cluster] {what} worker {rec['process']} ({rec['device']}, groups "
          f"{rec['local_workers']}, rows {rec['receipt']['rows_local']} of "
          f"{rec['receipt']['rows_global']}): {ms:.3f} ms/step (median of steps "
          f"2-{len(rec['step_times'])}), first step {rec['step_times'][0] * 1e3:.1f} ms; "
          f"a step (mean of {steps}): grad {split['grad_s'] / steps * 1e3:.1f} ms, encode "
          f"{t['encode_s_per_step'] * 1e3:.1f}, wire wait {t['wait_s_per_step'] * 1e3:.1f} "
          f"(wire {t['wire_s_per_step'] * 1e3:.1f} and decode-sum "
          f"{t['decode_s_per_step'] * 1e3:.1f} on the reducer's thread), apply (the sums "
          f"landed leaf by leaf) {split['apply_s'] / steps * 1e3:.1f}")
    print(f"[cluster] {what} worker {rec['process']}: {t['topology']} "
          f"{t['spec']['compression']}, {t['spec']['buckets']} bucket(s), overlap "
          f"{t['spec']['overlap']}: wire {t['wire_bytes_per_step']} bytes a step of "
          f"{t['raw_bytes_per_step']} raw (compression {t['compression_ratio']}x); losses "
          f"{[round(x, 6) for x in rec['losses']]}; digest {rec['param_digest']}; launches "
          f"{ {k: v for k, v in rec['launches'].items() if v} }; addressable only "
          f"{rec['addressable_only']}")
    return ms


def cluster_training(torch, ops, dev, bucket_lens, root: Path):
    """Phase 31: phase 31's cell through a single-process card ``Session``
    for CLUSTER_STEPS steps, then through 2 worker processes on the one card
    (``ClusterCoordinator`` over the driver's ``train_session_factory``, as
    ``launch/train.py --cluster-processes 2`` runs it) under
    ``TransportSpec.production()``: equal replica digests, the step-1 loss
    equal to the single-process run's at rtol 1e-5 (it is read from raw
    sums, before any update), steps 2-3 within 1e-2, each worker's
    launches (the quantizer once a bucket a step; flash as phase 8's count
    for its steps), its ms a step and split, wire bytes, compression ratio,
    predicted and measured peak.  Returns the workers' summed launches, the
    single process's losses, the workers' peaks and the single process's
    gradient norms."""
    import gc

    from repro_torch.core.topology import ClusterSpec, TransportSpec
    from repro_torch.launch.cluster import ClusterCoordinator
    from repro_torch.launch.train import train_session_factory

    single = train_session_factory(device=dev, steps=CLUSTER_STEPS, **CLUSTER_CELL)
    cfg, sched = single.model.cfg, single.tune().schedule
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    report = single.run()
    counts = dict(ops.LAUNCHES)
    want = [h["loss"] for h in report.history]
    want_norms = [h["grad_norm"] for h in report.history]
    single_ms = statistics.median(h["step_time"] for h in report.history[1:]) * 1e3
    print(f"[cluster] single process: {cfg.name} {cfg.n_layers} layers, "
          f"{cfg.param_count() / 1e9:.3f} B params, rows {sched.global_rows} "
          f"({sched.valid_rows} valid) x seq {CLUSTER_CELL['seq']}: {single_ms:.3f} ms/step "
          f"(median of steps 2-{CLUSTER_STEPS}), peak "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB, losses "
          f"{[round(x, 6) for x in want]}, launches { {k: v for k, v in counts.items() if v} }")
    _check_launches(counts, expected_train_launches(cfg, "f32", CLUSTER_STEPS),
                    "single-process training")
    del single, report
    gc.collect()
    torch.cuda.empty_cache()

    rows = sched.global_rows // 2
    dev_peak, host_peak = predicted_cluster_peaks_gib(cfg, cfg.param_count(), bucket_lens, rows,
                                                      CLUSTER_CELL["seq"])
    free, total = torch.cuda.mem_get_info(dev)
    print(f"[cluster] before the launch: card free {free / 2**30:.2f} of {total / 2**30:.2f} GiB "
          f"(this process holds {torch.cuda.memory_reserved(dev) / 2**30:.3f} GiB reserved); "
          f"host MemAvailable {_mem_available_gib():.1f} GiB; predicted a worker: device "
          f"{dev_peak:.2f} GiB, host {host_peak:.2f} GiB beyond its interpreter; buckets "
          f"{bucket_lens} f32 ({[-(-n // 512) for n in bucket_lens]} rows of 512)")
    coord = ClusterCoordinator(
        ClusterSpec(processes=2, transport=TransportSpec.production()),
        "repro_torch.launch.train:train_session_factory",
        {**CLUSTER_CELL, "cluster_processes": 2, "steps": CLUSTER_STEPS, "device": "cuda"},
        run_dir=str(root / "cluster"))
    recs = _run_workers(coord, timeout=900)
    expect = {"quantize_int8": CLUSTER_STEPS * len(bucket_lens),
              "flash_attention": expected_train_launches(cfg, "f32", CLUSTER_STEPS)[
                  "flash_attention"]}
    totals = {name: 0 for name in ops.LAUNCHES}
    for rec in recs:
        _cluster_report(rec, "phase 31")
        print(f"[cluster] phase 31 worker {rec['process']}: peak {rec['peak_bytes'] / 2**30:.3f} "
              f"GiB (predicted {dev_peak:.2f}); host peak resident "
              f"{rec['host_peak_bytes'] / 2**30:.2f} GiB, its interpreter and torch included "
              f"(predicted {host_peak:.2f} beyond them)")
        _check_launches(rec["launches"], expect, f"worker {rec['process']}")
        for name, c in rec["launches"].items():
            totals[name] += c
        if not (rec["addressable_only"] and rec["receipt"]["rows_local"] == rows):
            raise AssertionError(f"worker {rec['process']} was fed {rec['receipt']}")
        got = rec["losses"]
        rel = [abs(g - w) / abs(w) for g, w in zip(got, want)]
        print(f"[cluster] phase 31 worker {rec['process']}: losses against the single process "
              f"{[round(x, 6) for x in want]}: relative differences {[f'{x:.2e}' for x in rel]}")
        if not all(math.isfinite(x) for x in got) or rel[0] > 1e-5 or max(rel[1:]) > 1e-2:
            raise AssertionError(f"worker {rec['process']}: losses {got} against {want}")
    if recs[0]["param_digest"] != recs[1]["param_digest"]:
        raise AssertionError(f"replica digests differ: {[r['param_digest'] for r in recs]}")
    print(f"[cluster] phase 31: replica digests equal ({recs[0]['param_digest']}); the "
          f"single process's {single_ms:.3f} ms/step against the workers' above")
    return totals, want, [rec["peak_bytes"] for rec in recs], want_norms


def cluster_smoke(smoke_config, dev, root: Path):
    """Phase 32: the smoke config (``demo_session_factory``: FleetSpec.demo(3),
    seq 16, CLUSTER_STEPS steps) through 2 worker processes on the card under
    ``TransportSpec()`` (star, no compression) against the single-process
    card ``Session`` of the same factory: losses at rtol 1e-5, equal
    replica digests, flash launched as phase 7's count."""
    from repro_torch.core.topology import ClusterSpec, TransportSpec
    from repro_torch.launch.cluster import ClusterCoordinator, demo_session_factory

    kw = dict(steps=CLUSTER_STEPS, seq_len=16)
    report = demo_session_factory(processes=1, device=dev, **kw).run()
    want = [h["loss"] for h in report.history]
    coord = ClusterCoordinator(ClusterSpec(processes=2, transport=TransportSpec()),
                               "repro_torch.launch.cluster:demo_session_factory",
                               {"processes": 2, "device": "cuda", **kw},
                               run_dir=str(root / "cluster-smoke"))
    recs = _run_workers(coord, timeout=300)
    cfg = smoke_config("deepseek-7b")
    for rec in recs:
        _cluster_report(rec, "phase 32")
        _check_launches(rec["launches"], expected_train_launches(cfg, "f32", CLUSTER_STEPS),
                        f"phase 32 worker {rec['process']}")
        if not np.allclose(rec["losses"], want, rtol=1e-5, atol=0.0):
            raise AssertionError(f"worker {rec['process']}: losses {rec['losses']} against "
                                 f"the single process's {want}")
    if recs[0]["param_digest"] != recs[1]["param_digest"]:
        raise AssertionError(f"replica digests differ: {[r['param_digest'] for r in recs]}")
    print(f"[cluster] phase 32: losses equal the single process's {[round(x, 6) for x in want]} "
          f"at rtol 1e-5; replica digests equal ({recs[0]['param_digest']})")


# phase 33: Algorithm 1 over real step times (``launch/train.py
# --measured-tune``) at phase 8's cell.  A step's fixed cost (AdamW over 2.46 B
# params) makes every batch look cheap, so the tune puts the host at its cap
# and the plan pads every group to it: at the driver's cap of 64, 192 rows;
# at 32, 96 rows ran out of the card's memory (62.9 GiB allocated and 9.4
# asked on the H100 80GB HBM3); the cap is cut to 24 (72 rows)
TUNE_CELL = dict(arch="deepseek-7b", full_config=True, n_layers=8, seq=256)
TUNE_HOST_CAP = 24
TUNE_STEPS = 3


def measured_tune(torch, ops, R, F, train_session_factory, get_config, dev):
    """Phase 33: ``train_session_factory(measured_tune=True)`` in f32 and
    int8-fused: every timed (class, batch, ms), the tuned batches, margin
    and reference class; the tune's weights freed; then ``Session.run`` for
    TUNE_STEPS steps at the tuned plan (ms a step, peak, the roofline
    fraction); launches counted from before the tune to after the run.
    Then flash, the quantizer and int8-K/V flash at the plan's rows.
    -> (launch totals, kernels-line records)."""
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import PEAK_FLOPS_BF16
    from repro_torch.launch.train import DRIVER_FLEET

    fleet = dict(DRIVER_FLEET, host_max_batch=TUNE_HOST_CAP)
    print(f"[tune] fleet {fleet} (the driver's host_max_batch 64 cut to {TUNE_HOST_CAP}: "
          f"see TUNE_CELL)")
    seq = TUNE_CELL["seq"]
    totals = {name: 0 for name in ops.LAUNCHES}
    rows = {}
    for prec in ("f32", "int8-fused"):
        session = train_session_factory(device=dev, steps=TUNE_STEPS, precision=prec,
                                        measured_tune=True, fleet=fleet, **TUNE_CELL)
        cfg, bench = session.model.cfg, session.benchmark
        ops.reset_launches()
        t0 = time.perf_counter()
        plan = session.tune()
        tune_s = time.perf_counter() - t0
        tune_counts = dict(ops.LAUNCHES)
        for name, batch, t in bench.timings:
            print(f"[tune] {cfg.name} {prec}: {name} batch {batch}: {t * 1e3:.3f} ms")
        print(f"[tune] {cfg.name} {prec}: tuned batches {plan.batches}, margin "
              f"{plan.result.margin:.0%}, reference class {plan.result.reference_class}; "
              f"{len(bench.timings)} timings, {4 * len(bench.timings)} steps in {tune_s:.1f} s")
        _check_launches(tune_counts,
                        expected_train_launches(cfg, prec, 4 * len(bench.timings)),
                        f"{cfg.name} {prec} measured tune")
        bench.release()
        sched = plan.schedule
        rows[prec] = sched.global_rows
        traced = dryrun.trace(cfg, ShapeSpec("tuned", "train", seq, sched.global_rows)).peak
        print(f"[tune] {cfg.name} {prec}: plan {sched.group_batches} -> {sched.global_rows} rows "
              f"({sched.valid_rows} valid); predicted peak "
              f"{predicted_train_peak_gib(cfg, cfg.param_count(), sched.global_rows, seq, seq):.2f}"
              f" GiB, the dry run's trace of the step {traced / 2**30:.3f} GiB; allocated after "
              f"the tune's release {torch.cuda.memory_allocated(dev) / 2**30:.3f} GiB")
        torch.cuda.reset_peak_memory_stats(dev)
        report = session.run()
        counts = dict(ops.LAUNCHES)
        run_counts = {k: counts[k] - tune_counts[k] for k in counts}
        peak = torch.cuda.max_memory_allocated(dev)
        ms = report_train(cfg, TUNE_CELL["arch"], prec, report.history, report.wall_time,
                          sched.global_rows, sched.valid_rows, seq, peak, run_counts,
                          TUNE_STEPS, get_config)
        _check_launches(run_counts, expected_train_launches(cfg, prec, TUNE_STEPS),
                        f"{cfg.name} {prec} training at the tuned plan")
        # model work is 6 N tokens over the valid rows (padding rows are work,
        # not progress); N without the input embedding table, a gather that
        # does no matrix product, is the headline; the roofline module's
        # convention (N = param_count, the table counted) and the count over
        # every row, padding included, are printed beside it
        n_all = cfg.param_count()
        n_mm = n_all - cfg.vocab * cfg.d_model
        step_s = ms / 1e3

        def fraction(n, n_rows):
            return 6.0 * n * n_rows * seq / (PEAK_FLOPS_BF16 * step_s)

        print(f"[tune] {cfg.name} {prec}: roofline fraction "
              f"{fraction(n_mm, sched.valid_rows):.4f} (6 N seq x {sched.valid_rows} valid rows, "
              f"N = {n_mm:,} without the {cfg.vocab} x {cfg.d_model} embedding table, "
              f"{6.0 * n_mm * sched.valid_rows * seq:.4e} FLOPs over 989e12 FLOP/s x "
              f"{ms:.3f} ms); {fraction(n_all, sched.valid_rows):.4f} with the table counted "
              f"(N = param_count {n_all:,}, the roofline module's 6 N tokens); "
              f"{fraction(n_all, sched.global_rows):.4f} over all {sched.global_rows} rows, "
              f"{sched.global_rows - sched.valid_rows} of them padding; on {card_line()}")
        for name, c in counts.items():
            totals[name] += c
        del session, report, plan, bench
        torch.cuda.empty_cache()

    gen = torch.Generator(device=dev)
    gen.manual_seed(3333)
    scratch = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)

    B = rows["f32"]
    records = attention_records(torch, R, F, rand, scratch.zero_, "measured_tune",
                                f"tuned plan ({B}, {seq}, 32, 128)", B, seq, seq, 32, 32,
                                128, True)
    del scratch
    for rec in records:
        print(json.dumps(rec))
    return totals, records


def serve_batched_examples(torch, ops, get_model, smoke_config, dev):
    """Phase 33, serving: ``repro_torch.examples.serve_batched``'s flow
    (``Model.prefill``, then greedy serve steps) on every arch's smoke
    config, float32 weights from seed 0 on the CPU copied to the card:
    the card's tokens must equal the CPU's, and each family's kernels must
    launch."""
    from repro_torch.configs import ARCHS
    from repro_torch.examples.serve_batched import side_inputs

    B, P, N = 2, 16, 8
    family_kernels = {"moe": "fused_moe_gemm", "rwkv6": "rwkv6_scan", "rglru": "rglru_scan"}
    for arch in ARCHS:
        model = get_model(smoke_config(arch))
        params, _ = model.init_params(seed=0, device="cpu")
        prompt = torch.from_numpy(
            np.random.default_rng(0).integers(0, model.cfg.vocab, (B, P), dtype=np.int32))
        want = generate_batched(model, params, prompt, N,
                                **side_inputs(model, B, 0, torch.device("cpu")))[0]
        ops.reset_launches()
        got, pre_s, dec_s = generate_batched(model, _to(params, dev), prompt.to(dev), N,
                                             **side_inputs(model, B, 0, dev))
        counts = {k: c for k, c in ops.LAUNCHES.items() if c}
        same = torch.equal(got.cpu(), want)
        print(f"[serve_batched] {arch}: prefill {pre_s * 1e3:.1f} ms, {N} steps "
              f"{dec_s * 1e3:.1f} ms, tokens CPU = card: {same}, launches {counts}")
        if not same:
            raise AssertionError(f"serve_batched {arch}: card tokens {got.tolist()} != CPU "
                                 f"{want.tolist()}")
        need = family_kernels.get(model.cfg.family, "decode_attention")
        if not counts.get(need):
            raise AssertionError(f"serve_batched {arch}: {need} never launched: {counts}")


# phase 34: three cells of SHAPES cut to one card, (shape, rows, layers):
# train_4k at 8 rows of 2 layers is predicted at 82.7 GiB, over the card
DRYRUN_CELLS = (("train_4k", 4, 2), ("prefill_32k", 1, None), ("decode_32k", 2, None))
DRYRUN_GATE = (0.10, 2.0)      # within 10% or 2 GiB of the card's peak, the larger


def dryrun_memory(torch, dev):
    """Phase 34: for each DRYRUN_CELLS cell of deepseek-7b, the dry run's
    predicted peak (``launch/dryrun.py``, a meta-device trace) against
    ``torch.cuda.max_memory_allocated`` around the same step on the card
    (seed-0 weights, zero tokens), from the same inputs' allocation on; the
    step's loss (train) or logits (prefill, decode) must be finite."""
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.launch import dryrun
    from repro_torch.models.api import get_model

    for shape_name, batch, layers in DRYRUN_CELLS:
        shape = SHAPES[shape_name]
        cfg = get_config("deepseek-7b")
        if layers is not None:
            cfg = dryrun._with_layers(cfg, layers)
        print(f"[dryrun] deepseek-7b {shape_name}: cut to batch {batch} of "
              f"{shape.global_batch}, {dryrun._depth(cfg)} layers of 30, seq {shape.seq_len}")
        rec = dryrun.dryrun_cell("deepseek-7b", shape_name, batch=batch, n_layers=layers)
        pred = rec["memory"]["peak_bytes"]
        model = get_model(cfg)
        torch.cuda.empty_cache()
        params, inputs = dryrun.step_inputs(model, shape, batch, device=dev)
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        out = dryrun.run_step(model, shape, params, inputs)
        torch.cuda.synchronize(dev)
        step_s = time.perf_counter() - t0
        meas = torch.cuda.max_memory_allocated(dev)
        checked = {"train": lambda o: o[2]["loss"], "prefill": lambda o: o[0],
                   "decode": lambda o: o[1]}[shape.kind](out)
        finite = bool(torch.isfinite(checked).all())
        gate = max(DRYRUN_GATE[0] * meas, DRYRUN_GATE[1] * 2**30)
        print(f"[dryrun] deepseek-7b {shape_name}: predicted peak {pred / 2**30:.3f} GiB, "
              f"card {meas / 2**30:.3f} GiB, gap {(pred - meas) / 2**30:+.3f} GiB "
              f"({(pred - meas) / meas:+.2%}; gate {gate / 2**30:.3f} GiB), arguments "
              f"{rec['memory']['argument_size_in_bytes'] / 2**30:.3f} GiB, step {step_s:.2f} s, "
              f"outputs finite: {finite}; {rec['flops']:.4e} FLOPs counted")
        del params, inputs, out, checked
        torch.cuda.empty_cache()
        if not finite:
            raise AssertionError(f"dry-run cell {shape_name}: non-finite outputs on the card")
        if abs(pred - meas) > gate:
            raise AssertionError(f"dry-run cell {shape_name}: predicted {pred} B, card {meas} B")


# ---------------------------------------------------------------------------
# Data-parallel training over torch.distributed, spmd (phase 35)
# ---------------------------------------------------------------------------

# phase 35's cell, spmd_deepseek7b_world1: phase 31's cell (CLUSTER_CELL) as the
# one rank of an NCCL group; seconds the phase should take (printed beside
# what it took)
SPMD_BUDGET_S = 60.0
SPMD_RTOL = 1e-6


def spmd_training(torch, ops, R, F, dev, single_losses, root: Path):
    """Phase 35 (see the module doc): -> (the spmd path's launches, the
    compressed allreduce's, kernels-line records).  The process group is the phase's own, up for the phase and
    destroyed at its end on every exit path."""
    import gc

    import torch.distributed as dist

    from repro_torch.distributed.allreduce import (
        bucketize, compressed_allreduce, flatten_grads, hierarchical_allreduce, payload_rows,
        ring_allreduce,
    )
    from repro_torch.distributed.pipeline import pipeline_apply
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.quantize import quantize_plan, quantize_rows
    from repro_torch.launch.cluster import WorkerRuntime
    from repro_torch.launch.mesh import ClusterContext, make_host_mesh
    from repro_torch.launch.train import train_session_factory
    from repro_torch.train.steps import make_partial_grad_step

    t0 = time.perf_counter()
    ctx = ClusterContext(0, 1, mode="spmd", device=dev)
    ctx.init_process_group(f"file://{root / 'spmd-store'}", timeout=300.0)
    try:
        # -- the main path: counts set to 0 before, read after --
        ops.reset_launches()
        rec = WorkerRuntime(
            process_id=0, num_processes=1, sync_address=None, membership_dir=None,
            factory="repro_torch.launch.train:train_session_factory",
            factory_kwargs={**CLUSTER_CELL, "cluster_processes": 1, "steps": CLUSTER_STEPS,
                            "device": "cuda"},
            mode="spmd").run(resume_steps=0)
        gc.collect()
        torch.cuda.empty_cache()
        t_run = time.perf_counter()
        # the phase's first gradient bucket: seed-0 weights on the first batch
        session = train_session_factory(device=dev, steps=1, **CLUSTER_CELL)
        cfg = session.model.cfg
        params, _ = session.init_state(init_opt=False)
        batch = session.dataset.next_device_batch(dev)
        grads, _ = make_partial_grad_step(session.model)(params, batch)
        del params, session, batch
        flat, _ = flatten_grads(grads)
        del grads
        bucket = bucketize(flat)[0].clone()
        del flat
        torch.cuda.empty_cache()
        gen = torch.Generator(device=dev)
        gen.manual_seed(3535)
        noise = torch.rand(bucket.shape, generator=gen, device=dev)
        residual = torch.zeros_like(bucket)
        counts = {k: rec["launches"].get(k, 0) for k in ops.LAUNCHES}
        # -- compressed_allreduce, a path of its own (the spmd step sums with
        #    dist.all_reduce): counts set to 0 before, read after --
        ops.reset_launches()
        total, new_res = compressed_allreduce(bucket, residual, noise)
        torch.cuda.synchronize(dev)
        comp_counts = dict(ops.LAUNCHES)
        t_path = time.perf_counter()

        # -- what the path printed --
        ms = statistics.median(rec["step_times"][1:]) * 1e3
        split, steps = rec["step_split"], max(1, rec["step_split"]["steps"])
        print(f"[spmd] backend {rec['backend']}, world size {rec['world_size']}, mesh "
              f"{rec['mesh']}; {rec['plan']}; on {rec['device']}")
        print(f"[spmd] fed span: {rec['receipt']} (addressable only "
              f"{rec['addressable_only']}); groups {rec['local_workers']}")
        print(f"[spmd] {cfg.name} {cfg.n_layers} layers, {CLUSTER_STEPS} steps: {ms:.3f} ms/step "
              f"(median of steps 2-{CLUSTER_STEPS}), first step "
              f"{rec['step_times'][0] * 1e3:.1f} ms; a step (mean of {steps}): grad "
              f"{split['grad_s'] / steps * 1e3:.1f} ms, all_reduce "
              f"{split['reduce_s'] / steps * 1e3:.1f}, apply "
              f"{split['apply_s'] / steps * 1e3:.1f}; peak {rec['peak_bytes'] / 2**30:.3f} GiB; "
              f"digest {rec['param_digest']}")
        if (rec["backend"], rec["world_size"], rec["mode"]) != ("nccl", 1, "spmd"):
            raise AssertionError(f"phase 35 ran {rec['mode']} over {rec['backend']} at world "
                                 f"{rec['world_size']}")
        if not (rec["addressable_only"] and rec["receipt"]["rows_local"]
                == rec["receipt"]["rows_global"] == rec["global_rows"]):
            raise AssertionError(f"the spmd rank was fed {rec['receipt']}")
        _check_launches(rec["launches"], {"flash_attention": expected_train_launches(
            cfg, "f32", CLUSTER_STEPS)["flash_attention"]}, "spmd training")
        got = rec["losses"]
        gaps = [abs(g - w) / abs(w) for g, w in zip(got, single_losses)]
        print(f"[spmd] losses {[round(x, 6) for x in got]} against the single-process card "
              f"Session's {[round(x, 6) for x in single_losses]}: largest relative gap "
              f"{max(gaps):.3e} (rtol {SPMD_RTOL:g})")
        if len(got) != len(single_losses) or not all(math.isfinite(x) for x in got) \
                or max(gaps) > SPMD_RTOL:
            raise AssertionError(f"spmd losses {got} against {single_losses}")

        # -- the library at n = 1 (not counted) --
        x = torch.randn(1037, generator=gen, device=dev)
        mesh = make_host_mesh(data=1, model=1)
        w = torch.randn(1, 16, 16, generator=gen, device=dev) * 0.3
        mb = torch.randn(8, 2, 16, generator=gen, device=dev)

        def stage(p, h):
            return torch.tanh(h @ p["w"])

        same = {
            "ring_allreduce": torch.equal(ring_allreduce(x), x),
            "hierarchical_allreduce": torch.equal(hierarchical_allreduce(
                x, intra_group=mesh.get_group("data"), inter_group=mesh.get_group("model")), x),
            "pipeline_apply": torch.equal(pipeline_apply(stage, {"w": w}, mb), torch.stack(
                [stage({"w": w[0]}, mb[t]) for t in range(mb.shape[0])])),
            "compressed_allreduce": torch.equal(new_res, bucket - total),
        }
        print(f"[spmd] at n = 1 on {mesh}: {same}")
        if not all(same.values()):
            raise AssertionError(f"a collective at n = 1 changed its input: {same}")

        # -- the kernels at the path's shapes, against their plain versions --
        scratch = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
        flush = scratch.zero_
        mat, nmat = payload_rows(bucket + residual, noise)
        route = quantize_plan(*mat.shape, mat.dtype, mat.data_ptr() % 16 == 0)
        (qk, sk), (qp, sp) = quantize_rows(mat, nmat), R.quantize_int8_ref(mat, nmat)
        torch.cuda.synchronize(dev)
        q_same = torch.equal(qk, qp) and torch.equal(sk, sp)
        print(f"[check] quantize_int8 compressed_allreduce rows "
              f"{tuple(mat.shape)} f32 (route {route}), random noise: "
              f"{'bit-equal' if q_same else 'DIFFERS'}")
        if not q_same:
            raise AssertionError("the quantizer at compressed_allreduce's shape differs from "
                                 "its plain version")
        nbytes = mat.numel() * 4 + nmat.numel() * 4 + mat.numel() + mat.shape[0] * 4
        b_ms, b_by = bound(nbytes, 0.0, "float32")
        records = [dict(
            name="quantize_int8", path="compressed_allreduce",
            shape=f"rows {tuple(mat.shape)} float32, random noise, route {route}",
            route="cuda", source="src/repro_torch/kernels/csrc/quantize.cu",
            replaces="src/repro/kernels/quantize.py:38", launches=0, max_abs_err=0.0,
            ms=timed_ms(lambda: quantize_rows(mat, nmat), flush),
            plain_ms=timed_plain(lambda: R.quantize_int8_ref(mat, nmat), flush),
            bound_ms=b_ms, bound_by=b_by, library_ms=None)]
        comp_ms = timed_ms(lambda: compressed_allreduce(bucket, residual, noise), flush)
        print(f"[spmd] compressed_allreduce of the first bucket ({bucket.numel():,} f32): "
              f"{comp_ms:.4f} ms (CUDA events, median of {N_TIMED}); the quantizer alone "
              f"{records[0]['ms']:.4f}, bound {b_ms:.4f} ({b_by})")
        del mat, nmat, qk, sk, qp, sp, bucket, noise, residual, total, new_res
        B, S, H, D = rec["global_rows"], CLUSTER_CELL["seq"], 32, 128
        q, k, v = (torch.randn(B, S, H, D, generator=gen, device=dev).to(torch.bfloat16)
                   for _ in range(3))
        err = row_ulp_check(torch, f"flash_attention spmd_training {(B, S, H, D)} bf16",
                            flash_attention_fwd(q, k, v, causal=True),
                            R.flash_attention_ref(q, k, v, causal=True))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        records.append(_attention_record(
            "flash_attention", "spmd_training", f"a rank's ({B}, {S}, {H}, {D})", err,
            lambda: flash_attention_fwd(q, k, v, causal=True),
            lambda: R.flash_attention_ref(q, k, v, causal=True),
            4 * q.numel() * q.element_size(), 4 * D * B * H * S * (S + 1) // 2,
            lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True), flush))
        del q, k, v, qt, kt, vt, scratch
        torch.cuda.empty_cache()
        for r in records:
            print(json.dumps(r))
    finally:
        dist.destroy_process_group()
    took = time.perf_counter() - t0
    print(f"[spmd] phase 35: {took:.1f} s (budget {SPMD_BUDGET_S:.0f}; the worker path "
          f"{t_run - t0:.1f}, the bucket and its compressed allreduce {t_path - t_run:.1f})")
    return counts, comp_counts, records


# ---------------------------------------------------------------------------
# ZeRO-3 over the data axis (phase 36)
# ---------------------------------------------------------------------------

# phase 36's cell, zero3_deepseek7b_world2: phase 31's cell (CLUSTER_CELL) under
# its published fsdp=True through 2 spmd ranks that share the card over gloo;
# seconds the phase should take (printed beside what it took)
ZERO3_BUDGET_S = 120.0
# steps 2-3 against the single process: each rank's partial gradient is
# rounded to bf16 (the cell's weights) before the two are summed, and AdamW's
# ~3e-6 lr on bf16 weights turns such a rounding into whole-ulp weight flips
# (phase 31 holds its workers' later steps at 1e-2 for the same reason); the
# same arithmetic in one process (``world2_reference``) is held at SPMD_RTOL
ZERO3_LATER_RTOL = 1e-2


def _paths(tree, prefix=""):
    """{'a/b': leaf} of a nested dict."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_paths(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


def zero3_resident_bytes():
    """(parameter bytes, moment bytes) a world-2 ZeRO-3 rank of phase 36's
    cell holds, the sums of its shard shapes' bytes, and the same for a
    replicated rank (the whole tree)."""
    from repro_torch.distributed.sharding import iter_layouts
    from repro_torch.launch.train import train_session_factory

    session = train_session_factory(device="cpu", **CLUSTER_CELL)
    plan = session.spmd_plan(2)
    like = _paths(session.model.init_params(abstract=True, device="cpu")[0])
    shard = whole = shard_n = whole_n = 0
    for path, lay in iter_layouts(plan.params):
        leaf = like[path]
        n, full = math.prod(lay.shard_shape(tuple(leaf.shape))), leaf.numel()
        shard, whole = shard + n * leaf.element_size(), whole + full * leaf.element_size()
        shard_n, whole_n = shard_n + n, whole_n + full
    return (shard, 2 * 4 * shard_n), (whole, 2 * 4 * whole_n), plan.describe()


def world2_reference(torch, dev):
    """Phase 36's arithmetic in this one process, no collective: each step's
    40 rows split into the two ranks' 20, a partial gradient over each
    (``make_partial_grad_step``), the two summed in float32 and rounded to
    the leaf's dtype (what the reduce-scatter and the bf16 all-reduce of two
    partials give), the loss sums added, then ``make_apply_step``.  ->
    (losses, the parameters' digest)."""
    from repro_torch.launch.cluster import _params_digest
    from repro_torch.launch.train import train_session_factory
    from repro_torch.optim.optimizers import tree_map
    from repro_torch.optim.schedules import goyal_schedule
    from repro_torch.train.steps import make_apply_step, make_partial_grad_step

    session = train_session_factory(device=dev, steps=CLUSTER_STEPS, **CLUSTER_CELL)
    cfg, tp = session.config, session.tune()
    sched = goyal_schedule(cfg.base_lr, tp.schedule.valid_rows, base_batch=cfg.base_batch,
                           warmup_steps=cfg.warmup_steps, total_steps=cfg.total_steps)
    grad_step = make_partial_grad_step(session.model, aux_weight=cfg.aux_weight)
    apply_step = make_apply_step(session.optimizer, sched, aux_weight=cfg.aux_weight)
    params, opt_state = session.init_state()
    losses = []
    for _ in range(CLUSTER_STEPS):
        batch = session.dataset.next_device_batch(dev)
        half = tp.schedule.global_rows // 2
        parts = [grad_step(params, {k: v[i * half:(i + 1) * half] for k, v in batch.items()})
                 for i in range(2)]
        grads = tree_map(lambda a, b: (a.float() + b.float()).to(a.dtype), parts[0][0],
                         parts[1][0])
        sums = {k: parts[0][1][k].float() + parts[1][1][k].float() for k in parts[0][1]}
        del parts
        params, opt_state, metrics = apply_step(params, opt_state, grads, sums)
        losses.append(float(metrics["loss"]))
        del grads
    digest = _params_digest(params)
    del session, params, opt_state
    torch.cuda.empty_cache()
    return losses, digest


def zero3_training(torch, ops, dev, single_losses, replicated_peaks, root: Path):
    """Phase 36 (see the module doc): -> the two ranks' summed launches."""
    from repro_torch.core.topology import ClusterSpec
    from repro_torch.launch.cluster import ClusterCoordinator
    from repro_torch.launch.train import train_session_factory

    t0 = time.perf_counter()
    (p_bytes, m_bytes), (whole_p, whole_m), plan = zero3_resident_bytes()
    cfg = train_session_factory(device="cpu", **CLUSTER_CELL).model.cfg
    free, total = torch.cuda.mem_get_info(dev)
    print(f"[zero3] {cfg.name} fsdp={cfg.fsdp}, {cfg.n_layers} layers, "
          f"{cfg.param_count() / 1e9:.3f} B params; the plan of 2 ranks: {plan}; a rank's shards: params {p_bytes:,} B, "
          f"moments {m_bytes:,} B (replicated: {whole_p:,} and {whole_m:,}); card free "
          f"{free / 2**30:.2f} of {total / 2**30:.2f} GiB before the launch")
    coord = ClusterCoordinator(
        ClusterSpec(processes=2, mode="spmd"), "repro_torch.launch.train:train_session_factory",
        {**CLUSTER_CELL, "cluster_processes": 2, "steps": CLUSTER_STEPS, "device": "cuda"},
        run_dir=str(root / "zero3"), backend="gloo")
    recs = _run_workers(coord, timeout=600)
    t_ref = time.perf_counter()
    ref_losses, ref_digest = world2_reference(torch, dev)
    t_ref = time.perf_counter() - t_ref
    expect = expected_train_launches(cfg, "f32", CLUSTER_STEPS)["flash_attention"]
    totals = {name: 0 for name in ops.LAUNCHES}
    for rec, rep_peak in zip(recs, replicated_peaks):
        what = f"[zero3] rank {rec['process']}"
        if (rec["mode"], rec["backend"], rec["world_size"], rec["zero3"]) != \
                ("spmd", "gloo", 2, True):
            raise AssertionError(f"{what} ran {rec['mode']} over {rec['backend']} at world "
                                 f"{rec['world_size']}, zero3 {rec['zero3']}")
        split, steps = rec["step_split"], max(1, rec["step_split"]["steps"])
        ms = statistics.median(rec["step_times"][1:]) * 1e3
        print(f"{what} ({rec['device']}, rows {rec['receipt']['rows_local']} of "
              f"{rec['receipt']['rows_global']}): {ms:.3f} ms/step (median of steps "
              f"2-{CLUSTER_STEPS}), first step {rec['step_times'][0] * 1e3:.1f} ms; a step (mean "
              f"of {steps}): grad with the gathers and reduce-scatters "
              f"{split['grad_s'] / steps * 1e3:.1f} ms, reduce (the norms' and the loss sums' "
              f"all-reduces) {split['reduce_s'] / steps * 1e3:.1f}, apply "
              f"{split['apply_s'] / steps * 1e3:.1f}")
        print(f"{what}: wire bytes a step by kind {rec['collective_bytes']} in "
              f"{len(rec['collective_ops'])} collectives (gloo over the card's tensors)")
        held = rec["param_bytes"] + rec["moment_bytes"]
        print(f"{what}: resident params {rec['param_bytes']:,} B, moments "
              f"{rec['moment_bytes']:,} B ({held / 2**30:.3f} GiB; a replicated rank "
              f"{(whole_p + whole_m) / 2**30:.3f}); peak {rec['peak_bytes'] / 2**30:.3f} GiB "
              f"(phase 31's replicated worker, same rows: {rep_peak / 2**30:.3f}); launches "
              f"{ {k: v for k, v in rec['launches'].items() if v} }")
        if (rec["param_bytes"], rec["moment_bytes"]) != (p_bytes, m_bytes):
            raise AssertionError(f"{what} holds {rec['param_bytes']} + {rec['moment_bytes']} B, "
                                 f"its shards are {p_bytes} + {m_bytes}")
        _check_launches(rec["launches"], {"flash_attention": expect}, what)
        if not (rec["addressable_only"] and rec["receipt"]["rows_local"] * 2
                == rec["receipt"]["rows_global"]):
            raise AssertionError(f"{what} was fed {rec['receipt']}")
        got = rec["losses"]
        gaps = [abs(g - w) / abs(w) for g, w in zip(got, single_losses)]
        ref_gaps = [abs(g - w) / abs(w) for g, w in zip(got, ref_losses)]
        print(f"{what}: losses {[round(x, 6) for x in got]}; against the single-process card "
              f"Session's {[round(x, 6) for x in single_losses]} relative gaps "
              f"{[f'{x:.3e}' for x in gaps]} (step 1 held at rtol {SPMD_RTOL:g}, steps "
              f"2-{CLUSTER_STEPS} at {ZERO3_LATER_RTOL:g}: the ranks' bf16 partial gradients); "
              f"against the same arithmetic in one process, largest {max(ref_gaps):.3e} "
              f"(rtol {SPMD_RTOL:g})")
        if len(got) != len(single_losses) or not all(math.isfinite(x) for x in got) \
                or gaps[0] > SPMD_RTOL or max(gaps[1:]) > ZERO3_LATER_RTOL \
                or max(ref_gaps) > SPMD_RTOL:
            raise AssertionError(f"{what}: losses {got} against {single_losses} (one process) "
                                 f"and {ref_losses} (its two halves)")
        for name, c in rec["launches"].items():
            totals[name] += c
    digests = {rec["param_digest"] for rec in recs}
    print(f"[zero3] phase 36: gathered parameter digests {sorted(digests)}; the same "
          f"arithmetic in one process {ref_digest}")
    if len(digests) != 1:
        raise AssertionError(f"gathered digests differ: {[r['param_digest'] for r in recs]}")
    if digests != {ref_digest}:
        raise AssertionError(f"the ranks' parameters {digests} are not the one-process "
                             f"arithmetic's {ref_digest}")
    took = time.perf_counter() - t0
    print(f"[zero3] phase 36: {took:.1f} s (budget {ZERO3_BUDGET_S:.0f}; the one-process "
          f"arithmetic {t_ref:.1f})")
    return totals


# phases 37-38: tensor and expert parallelism over the model axis, two gloo
# ranks that share the card (NCCL puts no two ranks on one) on mesh
# data 1 x model 2.  Phase 37's cell, tp_deepseek7b_model2: phase 31's cell
# (CLUSTER_CELL, the same batches, weights and schedule); phase 38's,
# ep_dbrx132b_model2: dbrx-132b at full width cut to 1 of 40 layers, 8 rows
# x 256 of seeded tokens, AdamW at a constant lr.  Seconds each phase should
# take (printed beside what it took), its steps, and the step-1 bounds
# against the one process (predicted in PERF.md before the first run: each
# rank's bf16 partial sums of a head group, an FFN column block, a
# vocabulary block or its experts are rounded once, summed in float32 and
# rounded again)
TP_BUDGET_S, EP_BUDGET_S = 90.0, 110.0
TP_STEPS, EP_STEPS = 3, 2
TP_LOSS_RTOL, TP_GNORM_RTOL = 2e-3, 2e-2
EP_CELL = dict(arch="dbrx-132b", n_layers=1, rows=8, seq=256, lr=3e-6, seed=0)


def _rank_tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def _replicated_digest(params, plan):
    """sha256 of the leaves the plan keeps whole over ``model``, in the
    reference's leaf order."""
    import hashlib

    import torch

    from repro_torch.train.steps import tree_leaves_sorted

    h = hashlib.sha256()
    for t, lay in zip(tree_leaves_sorted(params), tree_leaves_sorted(plan.params)):
        if lay.model_dim is None:
            t = t.detach().cpu().contiguous()
            h.update((t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy().tobytes())
    return h.hexdigest()[:16]


def _tp_rank_run(torch, ops, dev, rank, model, optimizer, sched, plan, next_batch, steps,
                 seed, params=None):
    """One rank of phases 37-40: its pieces of the seed's weights
    (``init_rank_params``, or ``params`` where given), ``steps`` of
    ``make_spmd_train_step(plan=)``
    with the launch counts set to 0 just before and read just after, the
    heads and expert shapes the kernels ran at, the last step's
    collectives.  -> the rank's record."""
    from repro_torch.kernels import ops as kops
    from repro_torch.roofline.collectives import collective_bytes
    from repro_torch.train.steps import init_rank_params, make_spmd_train_step

    if params is None:
        params = init_rank_params(model, plan, rank, seed=seed, device=dev)
    opt_state = optimizer.init(params)
    timing, log = {}, []
    shapes = {"flash_heads": set(), "moe": set(), "scans": set()}
    step = make_spmd_train_step(model, optimizer, sched, timing=timing, plan=plan,
                                collective_log=log)
    seen = {name: getattr(kops, name) for name in (
        "flash_attention", "flash_attention_q8", "fused_moe_gemm", "rwkv6_scan",
        "rwkv6_scan_q8", "rglru_scan", "rglru_scan_q8")}

    def flash_seen(name):
        def run(q, *a, **kw):
            shapes["flash_heads"].add((int(q.shape[2]), int(a[0].shape[2])))
            return seen[name](q, *a, **kw)
        return run

    def gemm_seen(x, wg, wu, wo, slot_tok, slot_gate):
        E = int(wg.shape[0])
        shapes["moe"].add((E, int(slot_tok.shape[0]) // E, int(wg.shape[1]), int(wg.shape[2])))
        return seen["fused_moe_gemm"](x, wg, wu, wo, slot_tok, slot_gate)

    def scan_seen(name, arg):
        def run(*a, **kw):
            shapes["scans"].add((name, tuple(int(n) for n in a[arg].shape)))
            return seen[name](*a, **kw)
        return run

    wrapped = {"flash_attention": flash_seen("flash_attention"),
               "flash_attention_q8": flash_seen("flash_attention_q8"),
               "fused_moe_gemm": gemm_seen, "rwkv6_scan": scan_seen("rwkv6_scan", 0),
               "rwkv6_scan_q8": scan_seen("rwkv6_scan_q8", 0),
               "rglru_scan": scan_seen("rglru_scan", 1),
               "rglru_scan_q8": scan_seen("rglru_scan_q8", 1)}
    for name, fn in wrapped.items():
        setattr(kops, name, fn)
    losses, norms, times = [], [], []
    try:
        ops.reset_launches()
        for _ in range(steps):
            batch = next_batch()
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            params, opt_state, metrics = step(params, opt_state, batch)
            losses.append(float(metrics["loss"]))
            norms.append(float(metrics["grad_norm"]))
            times.append(time.perf_counter() - t0)
        launches = dict(ops.LAUNCHES)
    finally:
        for name, fn in seen.items():
            setattr(kops, name, fn)
    return {"rank": rank, "losses": losses, "grad_norms": norms, "step_times": times,
            "step_split": timing, "launches": launches,
            "flash_heads": sorted(shapes["flash_heads"]), "moe_shapes": sorted(shapes["moe"]),
            "scan_shapes": sorted(shapes["scans"]),
            "collective_ops": [list(op) for op in log],
            "collective_bytes": collective_bytes(log),
            "param_bytes": _rank_tree_bytes(params),
            "moment_bytes": _rank_tree_bytes(opt_state.mu) + _rank_tree_bytes(opt_state.nu),
            "peak_bytes": torch.cuda.max_memory_allocated(dev),
            "replicated_digest": _replicated_digest(params, plan),
            "plan": plan.describe()}


def _ep_batch(torch, cfg, dev):
    """Phase 38's batch: seeded tokens over the vocabulary, every position scored."""
    rng = np.random.default_rng(EP_CELL["seed"] + 38)
    toks = rng.integers(0, cfg.vocab, (EP_CELL["rows"], EP_CELL["seq"] + 1))
    return {"tokens": torch.from_numpy(toks[:, :-1]).to(dev),
            "labels": torch.from_numpy(toks[:, 1:]).to(dev),
            "loss_mask": torch.ones(EP_CELL["rows"], EP_CELL["seq"], device=dev)}


def _ep_config():
    from repro_torch.configs import get_config

    return get_config(EP_CELL["arch"]).with_(n_layers=EP_CELL["n_layers"])


def rank_main(argv) -> int:
    """A rank of phase 37 (``tp``), 38 (``ep``), 39 (``tpr``), 40
    (``tpe``), 41 (``tsd``) or 42 (``tsf``): ``chip_smoke.py --rank PHASE
    RANK IO`` joins the two ranks' gloo group at ``IO/store``, runs its cell
    or cells and writes ``IO/PHASE.RANK.json``."""
    import datetime

    import torch
    import torch.distributed as dist

    from repro_torch.device import resolve_device
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.api import get_model
    from repro_torch.optim import adamw
    from repro_torch.train.steps import build_sharding_plan

    phase, rank, io = argv[0], int(argv[1]), Path(argv[2])
    dev = resolve_device("cuda")
    dist.init_process_group("gloo", init_method=f"file://{io}/store-{phase}", rank=rank,
                            world_size=2, timeout=datetime.timedelta(seconds=300))
    try:
        mesh = make_host_mesh(data=1, model=2)
        if phase == "tp":
            from repro_torch.launch.train import train_session_factory
            from repro_torch.optim.schedules import goyal_schedule

            session = train_session_factory(device=dev, steps=CLUSTER_STEPS, **CLUSTER_CELL)
            cfg, tp = session.config, session.tune()
            sched = goyal_schedule(cfg.base_lr, tp.schedule.valid_rows,
                                   base_batch=cfg.base_batch, warmup_steps=cfg.warmup_steps,
                                   total_steps=cfg.total_steps)
            model, optimizer = session.model, session.optimizer
            plan = build_sharding_plan(model, optimizer, mesh=mesh,
                                       global_rows=tp.schedule.global_rows,
                                       seq_len=CLUSTER_CELL["seq"], device=dev)
            rec = _tp_rank_run(torch, ops, dev, rank, model, optimizer, sched, plan,
                               lambda: session.dataset.next_device_batch(dev), TP_STEPS,
                               cfg.seed)
        elif phase == "ep":
            cfg = _ep_config()
            model, optimizer = get_model(cfg), adamw()
            plan = build_sharding_plan(model, optimizer, mesh=mesh, global_rows=EP_CELL["rows"],
                                       seq_len=EP_CELL["seq"], device=dev)
            batch = _ep_batch(torch, cfg, dev)
            rec = _tp_rank_run(torch, ops, dev, rank, model, optimizer,
                               lambda s: torch.tensor(EP_CELL["lr"], device=dev), plan,
                               lambda: batch, EP_STEPS, EP_CELL["seed"])
        elif phase in TS_CELLS:
            rec = _ts_rank_cells(torch, ops, dev, rank, mesh, phase, io)
        else:
            rec = _tp_family_ranks(torch, ops, dev, rank, mesh, phase)
        with open(io / f"{phase}.{rank}.json", "w") as f:
            json.dump(rec, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


def _run_ranks(phase: str, io: Path, timeout: float):
    """Start the two ranks of ``phase`` together, wait, stop both on any
    failure, and return their records."""
    import os

    env = dict(os.environ, PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
    procs = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--rank", phase,
                               str(r), str(io)], cwd=str(ROOT), env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    logs = []
    try:
        for proc in procs:
            logs.append(proc.communicate(timeout=timeout)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if any(proc.returncode != 0 for proc in procs):
        for r, log in enumerate(logs):
            print(f"[{phase}] rank {r} log:\n{log[-6000:]}", file=sys.stderr)
        raise AssertionError(f"{phase} ranks failed: {[p.returncode for p in procs]}")
    out = []
    for r in range(2):
        with open(io / f"{phase}.{r}.json") as f:
            out.append(json.load(f))
    return out


def _tp_report(torch, tag, cfg, recs, rows, seq, resident, want_launches, want_heads,
               want_loss, want_norm, label, patches=0):
    """Print and hold the ranks of phases 37-40 (see the module doc); -> the
    two ranks' summed launches."""
    from repro_torch.roofline.collectives import collective_bytes, tp_step_ops

    ops_want = tp_step_ops(cfg, rows, seq, 2, patches=patches)
    totals = {}
    for rec in recs:
        what = f"[{tag}] rank {rec['rank']}"
        split, n = rec["step_split"], max(1, rec["step_split"]["steps"])
        ms = statistics.median(rec["step_times"][1:]) * 1e3
        print(f"{what} ({rec['plan']}): {ms:.3f} ms/step (median of steps 2-{len(rec['step_times'])}), "
              f"first {rec['step_times'][0] * 1e3:.1f} ms; a step (mean of {n}): grad with the "
              f"model axis's collectives {split['grad_s'] / n * 1e3:.1f} ms, reduce "
              f"{split['reduce_s'] / n * 1e3:.1f}, apply {split['apply_s'] / n * 1e3:.1f}")
        print(f"{what}: wire bytes a step by kind {rec['collective_bytes']} in "
              f"{len(rec['collective_ops'])} collectives (gloo over the card's tensors); "
              f"roofline.collectives.tp_step_ops: {collective_bytes(ops_want)} in "
              f"{len(ops_want)}")
        if sorted(map(tuple, rec["collective_ops"])) != sorted(ops_want):
            raise AssertionError(f"{what}: collectives {rec['collective_ops']} are not the "
                                 f"closed form's {ops_want}")
        print(f"{what}: resident params {rec['param_bytes']:,} B, moments "
              f"{rec['moment_bytes']:,} B ({(rec['param_bytes'] + rec['moment_bytes']) / 2**30:.3f}"
              f" GiB); peak {rec['peak_bytes'] / 2**30:.3f} GiB; launches "
              f"{ {k: v for k, v in rec['launches'].items() if v} }; flash at (heads, KV heads) "
              f"{rec['flash_heads']}; expert GEMM at (E, C, d, f) {rec['moe_shapes']}")
        if (rec["param_bytes"], rec["moment_bytes"]) != resident:
            raise AssertionError(f"{what} holds {rec['param_bytes']} + {rec['moment_bytes']} B, "
                                 f"its pieces are {resident}")
        _check_launches(rec["launches"], want_launches, what)
        if [tuple(h) for h in rec["flash_heads"]] != want_heads:
            raise AssertionError(f"{what}: flash ran at {rec['flash_heads']}, not {want_heads}")
        gap = abs(rec["losses"][0] - want_loss) / abs(want_loss)
        ngap = abs(rec["grad_norms"][0] - want_norm) / abs(want_norm)
        print(f"{what}: losses {[round(x, 6) for x in rec['losses']]}, grad norms "
              f"{[round(x, 6) for x in rec['grad_norms']]}; step 1 against {label} (loss "
              f"{want_loss:.6f}, grad norm {want_norm:.6f}): relative gaps {gap:.3e} (bound "
              f"{TP_LOSS_RTOL:g}) and {ngap:.3e} (bound {TP_GNORM_RTOL:g})")
        if not all(math.isfinite(x) for x in rec["losses"] + rec["grad_norms"]) \
                or gap > TP_LOSS_RTOL or ngap > TP_GNORM_RTOL:
            raise AssertionError(f"{what}: step 1 ({rec['losses'][0]}, {rec['grad_norms'][0]}) "
                                 f"against ({want_loss}, {want_norm})")
        for name, c in rec["launches"].items():
            totals[name] = totals.get(name, 0) + c
    if recs[0]["losses"] != recs[1]["losses"]:
        raise AssertionError(f"[{tag}] the ranks' losses differ: "
                             f"{[r['losses'] for r in recs]}")
    if recs[0]["replicated_digest"] != recs[1]["replicated_digest"]:
        raise AssertionError(f"[{tag}] the leaves replicated over model differ: "
                             f"{[r['replicated_digest'] for r in recs]}")
    print(f"[{tag}] the ranks' losses equal; the digests of the leaves replicated over model "
          f"equal ({recs[0]['replicated_digest']})")
    return totals


def _resident(plan, model):
    """(parameter bytes, AdamW moment bytes) a rank of ``plan`` holds: the
    sums of its pieces' shapes' bytes."""
    from repro_torch.distributed.sharding import iter_layouts

    like = _paths(model.init_params(abstract=True, device="cpu")[0])
    p = n = 0
    for path, lay in iter_layouts(plan.params):
        k = math.prod(lay.shard_shape(tuple(like[path].shape)))
        p, n = p + k * like[path].element_size(), n + k
    return p, 2 * 4 * n


def _model2_plan(torch, model, rows, seq):
    """The plan of a data 1 x model 2 mesh, resolved on the host."""
    from repro_torch.distributed.sharding import ProcessMesh
    from repro_torch.optim import adamw
    from repro_torch.train.steps import build_sharding_plan

    return build_sharding_plan(model, adamw(), mesh=ProcessMesh(torch.device("cpu"), (1, 2)),
                               global_rows=rows, seq_len=seq)


def tp_training(torch, ops, R, F, dev, single_losses, single_norms, root: Path):
    """Phase 37 (see the module doc): -> (the ranks' summed launches, records)."""
    from repro_torch.launch.train import train_session_factory

    t0 = time.perf_counter()
    session = train_session_factory(device="cpu", **CLUSTER_CELL)
    cfg, rows = session.model.cfg, session.tune().schedule.global_rows
    plan = _model2_plan(torch, session.model, rows, CLUSTER_CELL["seq"])
    resident = _resident(plan, session.model)
    print(f"[tp] {cfg.name}, {cfg.n_layers} layers, {cfg.param_count() / 1e9:.3f} B params, "
          f"rows {rows} x seq {CLUSTER_CELL['seq']}, mesh data 1 x model 2 ({plan.describe()}): "
          f"a rank holds {cfg.n_heads // 2} query heads, {cfg.d_ff // 2} FFN columns, "
          f"{cfg.vocab // 2} vocabulary rows; params {resident[0]:,} B, moments "
          f"{resident[1]:,} B")
    recs = _run_ranks("tp", root, timeout=600)
    want = {"flash_attention": expected_train_launches(cfg, "f32", TP_STEPS)["flash_attention"]}
    totals = _tp_report(torch, "tp", cfg, recs, rows, CLUSTER_CELL["seq"], resident, want,
                        [(cfg.n_heads // 2, cfg.n_kv_heads // 2)], single_losses[0],
                        single_norms[0], "phase 31's single process")
    gen = torch.Generator(device=dev)
    gen.manual_seed(3737)
    scratch = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)

    hd, h = cfg.resolved_head_dim(), cfg.n_heads // 2
    records = attention_records(torch, R, F, rand, scratch.zero_, "tp_training",
                                f"a rank's ({rows}, {CLUSTER_CELL['seq']}, {h}, {hd})", rows,
                                CLUSTER_CELL["seq"], CLUSTER_CELL["seq"], h,
                                cfg.n_kv_heads // 2, hd, True, int8=False)
    print(f"[tp] phase 37: {time.perf_counter() - t0:.1f} s (budget {TP_BUDGET_S:.0f})")
    return totals, records


def ep_baseline(torch, dev):
    """Phase 38's one process: the whole seed-0 weights, forward and
    backward of the fused path on the batch.  -> (loss, grad norm)."""
    import gc

    from repro_torch.models.api import get_model
    from repro_torch.train.steps import value_and_grad

    cfg = _ep_config()
    model = get_model(cfg)
    params, _ = model.init_params(seed=EP_CELL["seed"], device=dev)
    (_, parts), grads = value_and_grad(model, params, _ep_batch(torch, cfg, dev))
    norm = float(torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in _leaves(grads))))
    loss = float(parts["loss"])
    peak = torch.cuda.max_memory_allocated(dev)
    del params, grads
    gc.collect()
    torch.cuda.empty_cache()
    return loss, norm, peak


def ep_training(torch, ops, R, F, dev, root: Path):
    """Phase 38 (see the module doc): -> (the ranks' summed launches, records)."""
    from repro_torch.models.api import get_model
    from repro_torch.models.moe import expert_capacity

    t0 = time.perf_counter()
    cfg = _ep_config()
    model = get_model(cfg)
    rows, seq = EP_CELL["rows"], EP_CELL["seq"]
    plan = _model2_plan(torch, model, rows, seq)
    resident = _resident(plan, model)
    T, E = rows * seq, cfg.n_experts
    C = expert_capacity(T, E, cfg.experts_per_token, cfg.capacity_factor)
    torch.cuda.reset_peak_memory_stats(dev)
    t_base = time.perf_counter()
    want_loss, want_norm, base_peak = ep_baseline(torch, dev)
    t_base = time.perf_counter() - t_base
    print(f"[ep] {cfg.name}, {cfg.n_layers} of 40 layers, {cfg.param_count() / 1e9:.3f} B params, "
          f"rows {rows} x seq {seq}, mesh data 1 x model 2 ({plan.describe()}): a rank holds "
          f"{E // 2} of {E} experts (C = {C} slots an expert), {cfg.n_heads // 2} query heads "
          f"over {cfg.n_kv_heads // 2} KV heads, {cfg.vocab // 2} vocabulary rows; params "
          f"{resident[0]:,} B, moments {resident[1]:,} B ({sum(resident) / 2**30:.2f} GiB); the "
          f"one-process fused path, forward and backward: loss {want_loss:.6f}, grad norm "
          f"{want_norm:.6f}, peak {base_peak / 2**30:.2f} GiB, {t_base:.1f} s")
    print(f"[ep] before the ranks: this process holds "
          f"{torch.cuda.memory_reserved(dev) / 2**30:.3f} GiB reserved; card free "
          f"{torch.cuda.mem_get_info(dev)[0] / 2**30:.2f} GiB")
    recs = _run_ranks("ep", root, timeout=900)
    want = {"flash_attention": EP_STEPS * 2 * cfg.n_layers,
            "fused_moe_gemm": EP_STEPS * 2 * cfg.n_layers,
            "fused_moe_combine": EP_STEPS * 2 * cfg.n_layers}
    totals = _tp_report(torch, "ep", cfg, recs, rows, seq, resident, want,
                        [(cfg.n_heads // 2, cfg.n_kv_heads // 2)], want_loss, want_norm,
                        "the one-process fused path")
    shape = (E // 2, C, cfg.d_model, cfg.d_ff)
    for rec in recs:
        if [tuple(s) for s in rec["moe_shapes"]] != [shape]:
            raise AssertionError(f"[ep] rank {rec['rank']}: the expert GEMM ran at "
                                 f"{rec['moe_shapes']}, not {[shape]}")
    gen = torch.Generator(device=dev)
    gen.manual_seed(3838)
    scratch = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    bf16 = torch.bfloat16

    def rand(*shape, std=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * std).to(bf16)

    hd, h = cfg.resolved_head_dim(), cfg.n_heads // 2
    records = attention_records(torch, R, F, rand, scratch.zero_, "ep_training",
                                f"a rank's ({rows}, {seq}, {h} over {cfg.n_kv_heads // 2}, {hd})",
                                rows, seq, seq, h, cfg.n_kv_heads // 2, hd, True, int8=False)
    d, f = cfg.d_model, cfg.d_ff
    x, router = rand(T, d), rand(d, E, std=d ** -0.5)
    wg, wu, wo = rand(E // 2, d, f, std=d ** -0.5), rand(E // 2, d, f, std=d ** -0.5), \
        rand(E // 2, f, d, std=f ** -0.5)
    records += moe_gemm_combine_records(torch, R, F, x, router, wg, wu, wo,
                                        cfg.experts_per_token, C,
                                        f"EP: a rank's 8 of 16 experts (T={T}, C={C})",
                                        "ep_training", scratch.zero_, first_expert=0)
    del x, wg, wu, wo
    torch.cuda.empty_cache()
    print(f"[ep] phase 38: {time.perf_counter() - t0:.1f} s (budget {EP_BUDGET_S:.0f})")
    return totals, records


# phases 39-40: tensor parallelism for the recurrent, encoder-decoder and
# vision-language families, two gloo ranks sharing the card at mesh data 1 x
# model 2, as phases 37-38.  Each cell: its arch at full width cut to
# ``layers`` (whisper: that many encoder and decoder layers), ``rows`` x
# ``seq`` seeded tokens (and the VLM's ``patches`` patch embeddings, the
# encoder-decoder's n_frames frames), AdamW at a constant ``lr``, seed-0
# weights with their block matrices redrawn at their fan-in
# (``_fan_in_tree``: at the port's init the step-1 gradient of these cut
# models is chaotic, so a rank's bf16 rounding alone moved recurrentgemma-2b's
# gradient norm from the one process's by 6.6%), its train precision; held as
# phase 38, step 1 against the one process on the same weights and batch.
# recurrentgemma-2b runs in f32 and in int8-fused.
TP_FAMILY_CELLS = {
    "tpr": (dict(name="rwkv6-7b", arch="rwkv6-7b", layers=2, rows=8, seq=256, patches=0,
                 prec="f32", lr=1e-5, seed=0),
            dict(name="recurrentgemma-2b f32", arch="recurrentgemma-2b", layers=3, rows=8,
                 seq=256, patches=0, prec="f32", lr=1e-5, seed=0),
            dict(name="recurrentgemma-2b int8-fused", arch="recurrentgemma-2b", layers=3,
                 rows=8, seq=256, patches=0, prec="int8-fused", lr=1e-5, seed=0)),
    "tpe": (dict(name="whisper-medium", arch="whisper-medium", layers=4, rows=4, seq=256,
                 patches=0, prec="f32", lr=1e-5, seed=0),
            dict(name="qwen2-vl-7b", arch="qwen2-vl-7b", layers=2, rows=2, seq=512,
                 patches=1024, prec="f32", lr=1e-5, seed=0)),
}
TP_FAMILY_PHASES = {"tpr": ("39", "tp_recurrent_training"),
                    "tpe": ("40", "tp_encdec_vlm_training")}
TP_FAMILY_BUDGET_S = {"tpr": 75.0, "tpe": 75.0}


def _tp_family_config(cell):
    from repro_torch.configs import get_config

    cfg = get_config(cell["arch"]).with_(train_precision=cell["prec"])
    if cfg.family == "encdec":
        return cfg.with_(n_enc_layers=cell["layers"], n_dec_layers=cell["layers"])
    return cfg.with_(n_layers=cell["layers"])


def _fan_in_tree(torch, params, seed):
    """``params`` with every stacked block matrix (a leaf of three or more
    dims under ``blocks``, ``groups``, ``enc_blocks`` or ``dec_blocks``, the
    QKV biases aside) redrawn in place at N(0, 1/fan_in) over the axes it
    contracts: its second, and an attention out-projection's heads x head
    dim, as tests/test_torch_tp_families.py::numpy_params draws them.  The
    port's init, as the reference's, reads a stacked leaf's fan-in from its
    layer axis (std 1/sqrt(layers)): at seed 0, whisper-medium cut to 4 + 4
    layers starts at a gradient norm of 1.6e9.  Drawn on the leaves' device
    from ``seed`` in sorted path order, so every process draws the same."""
    gen = None
    for path, t in sorted(_paths(params).items()):
        name = path.rsplit("/", 1)[-1]
        if (t.dim() < 3 or name in ("bq", "bk", "bv")
                or path.split("/")[0] not in ("blocks", "groups", "enc_blocks", "dec_blocks")):
            continue
        if gen is None:
            gen = torch.Generator(device=t.device)
            gen.manual_seed(seed)
        fan_in = t.shape[1] * (t.shape[2] if name == "wo" and t.dim() == 4 else 1)
        t.copy_(torch.randn(t.shape, generator=gen, device=t.device) / fan_in ** 0.5)
    return params


def _tp_family_weights(torch, model, cell, dev):
    """A cell's whole weights: the seed's init, its block matrices redrawn
    at their fan-in."""
    params, _ = model.init_params(seed=cell["seed"], device=dev)
    return _fan_in_tree(torch, params, cell["seed"] + 1)


def _tp_family_batch(torch, cfg, cell, dev):
    """A cell's batch, drawn on the card from its seed (the same in every
    process): tokens and labels, every position scored, and the stub
    frontend's frames or patch embeddings."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(cell["seed"] + 3939)
    rows, seq = cell["rows"], cell["seq"]
    toks = torch.randint(0, cfg.vocab, (rows, seq + 1), generator=gen, device=dev)
    return {"tokens": toks[:, :-1].contiguous(), "labels": toks[:, 1:].contiguous(),
            "loss_mask": torch.ones(rows, seq, device=dev),
            **_side_inputs(torch, cfg, rows, cell["patches"], gen, dev)}


def _tp_family_ranks(torch, ops, dev, rank, mesh, phase):
    """A rank of phase 39 or 40: each cell's plan (checked), then its steps
    (``_tp_rank_run``), its state freed before the next.  -> {name: record}."""
    import gc

    from repro_torch.distributed.sharding import check_plan
    from repro_torch.models.api import get_model
    from repro_torch.optim import adamw
    from repro_torch.optim.optimizers import tree_map
    from repro_torch.train.steps import build_sharding_plan

    out = {}
    for cell in TP_FAMILY_CELLS[phase]:
        cfg = _tp_family_config(cell)
        model, optimizer = get_model(cfg), adamw()
        plan = check_plan(build_sharding_plan(model, optimizer, mesh=mesh,
                                              global_rows=cell["rows"], seq_len=cell["seq"],
                                              device=dev), 2)
        batch = _tp_family_batch(torch, cfg, cell, dev)
        torch.cuda.reset_peak_memory_stats(dev)
        params = tree_map(lambda t, lay: lay.local(t, rank).clone(),
                          _tp_family_weights(torch, model, cell, dev), plan.params)
        torch.cuda.empty_cache()
        out[cell["name"]] = _tp_rank_run(
            torch, ops, dev, rank, model, optimizer,
            lambda s, lr=cell["lr"]: torch.tensor(lr, device=dev), plan, lambda: batch,
            TP_STEPS, cell["seed"], params=params)
        del batch, params
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _tp_family_baseline(torch, cfg, cell, dev):
    """A cell's one process on the card: its whole weights, forward and
    backward on its batch.  -> (loss, grad norm, peak bytes)."""
    import gc

    from repro_torch.models.api import get_model
    from repro_torch.train.steps import value_and_grad

    model = get_model(cfg)
    torch.cuda.reset_peak_memory_stats(dev)
    params = _tp_family_weights(torch, model, cell, dev)
    (_, parts), grads = value_and_grad(model, params, _tp_family_batch(torch, cfg, cell, dev))
    norm = float(torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in _leaves(grads))))
    loss, peak = float(parts["loss"]), torch.cuda.max_memory_allocated(dev)
    del params, grads
    gc.collect()
    torch.cuda.empty_cache()
    return loss, norm, peak


def _tp_family_shapes(cfg, cell):
    """(flash (heads, KV heads) a rank runs, its scans' (name, shape)) on a
    model axis of 2."""
    B, S = cell["rows"], cell["seq"]
    q8 = cell["prec"] == "int8-fused"
    if cfg.family == "rwkv6":
        H = cfg.d_model // cfg.rwkv_head_dim // 2
        return [], [("rwkv6_scan_q8" if q8 else "rwkv6_scan", (B, S, H, cfg.rwkv_head_dim))]
    heads = [(cfg.n_heads // 2, cfg.n_kv_heads // 2 if cfg.n_kv_heads % 2 == 0
              else cfg.n_kv_heads)]
    if cfg.family == "rglru":
        return heads, [("rglru_scan_q8" if q8 else "rglru_scan", (B, S, cfg.lru_width // 2))]
    return heads, []


def tp_family_training(torch, ops, R, F, dev, phase, root: Path):
    """Phase 39 (``tpr``) or 40 (``tpe``), see the module doc: each cell's
    one process on the card first (then freed), the two ranks, the checks
    of phase 38 a cell, then each kernel of the path at a rank's shapes
    against its plain version.  -> (the ranks' summed launches, records)."""
    from repro_torch.models.api import get_model

    number, path = TP_FAMILY_PHASES[phase]
    t0 = time.perf_counter()
    base = {}
    for cell in TP_FAMILY_CELLS[phase]:
        cfg = _tp_family_config(cell)
        model = get_model(cfg)
        plan = _model2_plan(torch, model, cell["rows"], cell["seq"])
        resident = _resident(plan, model)
        t_base = time.perf_counter()
        loss, norm, peak = _tp_family_baseline(torch, cfg, cell, dev)
        print(f"[{phase}] {cfg.name} ({cell['prec']}, {str(cfg.dtype).split('.')[-1]} weights), "
              f"{cell['layers']} layers"
              f"{' each side' if cfg.family == 'encdec' else ''}, "
              f"{cfg.param_count() / 1e9:.3f} B params, rows {cell['rows']} x seq {cell['seq']}"
              f"{' + ' + str(cell['patches']) + ' patches' if cell['patches'] else ''}, mesh "
              f"data 1 x model 2 ({plan.describe()}): a rank's params {resident[0]:,} B, "
              f"moments {resident[1]:,} B ({sum(resident) / 2**30:.2f} GiB); the one process, "
              f"forward and backward: loss {loss:.6f}, grad norm {norm:.6f}, peak "
              f"{peak / 2**30:.2f} GiB, {time.perf_counter() - t_base:.1f} s")
        base[cell["name"]] = (cfg, resident, loss, norm)
    print(f"[{phase}] before the ranks: this process holds "
          f"{torch.cuda.memory_reserved(dev) / 2**30:.3f} GiB reserved; card free "
          f"{torch.cuda.mem_get_info(dev)[0] / 2**30:.2f} GiB")
    recs = _run_ranks(phase, root, timeout=900)
    totals = {}
    for cell in TP_FAMILY_CELLS[phase]:
        cfg, resident, loss, norm = base[cell["name"]]
        heads, scans = _tp_family_shapes(cfg, cell)
        mine = [rec[cell["name"]] for rec in recs]
        got = _tp_report(torch, f"{phase} {cell['name']}", cfg, mine, cell["rows"],
                         cell["seq"], resident,
                         expected_train_launches(cfg, cell["prec"], TP_STEPS), heads, loss,
                         norm, "the one process", patches=cell["patches"])
        for rec in mine:
            if [(n, tuple(s)) for n, s in rec["scan_shapes"]] != scans:
                raise AssertionError(f"[{phase}] {cell['name']} rank {rec['rank']}: the scans "
                                     f"ran at {rec['scan_shapes']}, not {scans}")
        print(f"[{phase}] {cell['name']}: flash at (heads, KV heads) {heads}, scans at {scans} on "
              f"each rank")
        for name, c in got.items():
            totals[name] = totals.get(name, 0) + c
    records = tp_family_kernel_records(torch, R, F, dev, phase, path)
    print(f"[{phase}] phase {number}: {time.perf_counter() - t0:.1f} s (budget "
          f"{TP_FAMILY_BUDGET_S[phase]:.0f})")
    return totals, records


def tp_family_kernel_records(torch, R, F, dev, phase, path):
    """The kernels of phase 39's or 40's path at a rank's shapes (model = 2)
    against their plain versions on the card, timed: -> the kernels-line
    records of the kernels the path launched.  Phase 39 also holds the
    int8 WKV-6 scan at its rank's shape (not launched there: its rwkv6 cell
    trains in f32) and prints it."""
    from repro_torch.kernels.quantize import quantize_rows
    from repro_torch.kernels.rglru_scan import rglru_scan, rglru_scan_int8
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan, rwkv6_scan_int8

    gen = torch.Generator(device=dev)
    gen.manual_seed(4040 if phase == "tpe" else 3939)
    scratch = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    flush = scratch.zero_
    bf16 = torch.bfloat16

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(bf16)

    def record(name, shape, source, replaces, err, kernel, plain, nbytes, flops, dtype):
        b_ms, b_by = bound(nbytes, flops, dtype)
        return dict(name=name, path=path, shape=shape, route="cuda",
                    source=f"src/repro_torch/kernels/csrc/{source}",
                    replaces=f"src/repro/kernels/{replaces}", launches=0, max_abs_err=err,
                    ms=timed_ms(kernel, flush), plain_ms=timed_plain(plain, flush),
                    bound_ms=b_ms, bound_by=b_by, library_ms=None)

    def show(rec):
        print(f"[{phase}] not launched on the {path} path, held at a rank's shape: "
              f"{json.dumps(rec)}")

    records = []
    if phase == "tpe":
        whisper, vlm = (_tp_family_config(c) for c in TP_FAMILY_CELLS["tpe"])
        wc, vc = TP_FAMILY_CELLS["tpe"]
        B, S, F_, H, D = wc["rows"], wc["seq"], whisper.n_frames, whisper.n_heads // 2, \
            whisper.resolved_head_dim()
        for label, Sq, Skv, causal in (("encoder", F_, F_, False), ("decoder self", S, S, True),
                                       ("cross", S, F_, False)):
            records += attention_records(
                torch, R, F, rand, flush, path,
                f"whisper {label}: a rank's ({B}, {Sq} over {Skv}, {H}, {D})", B, Sq, Skv, H, H,
                D, causal, int8=False)
        B, S, H = vc["rows"], vc["patches"] + vc["seq"], vlm.n_heads // 2
        records += attention_records(
            torch, R, F, rand, flush, path,
            f"qwen2-vl: a rank's ({B}, {S}, {H} over {vlm.n_kv_heads // 2}, "
            f"{vlm.resolved_head_dim()})", B, S, S, H, vlm.n_kv_heads // 2,
            vlm.resolved_head_dim(), True, int8=False)
        del scratch
        torch.cuda.empty_cache()
        return records

    wc, gc_ = TP_FAMILY_CELLS["tpr"][:2]
    rw, rg = _tp_family_config(wc), _tp_family_config(gc_)
    # WKV-6 at a rank's heads, bf16 (the cell's weights and activations)
    B, S, H, D = wc["rows"], wc["seq"], rw.d_model // rw.rwkv_head_dim // 2, rw.rwkv_head_dim
    r, k, v = (rand(B, S, H, D) for _ in range(3))
    w = torch.exp(-torch.exp(torch.randn(B, S, H, D, generator=gen, device=dev) * 0.5)).to(bf16)
    u = torch.randn(H, D, generator=gen, device=dev)
    q = [quantize_rows(t.reshape(-1, D), 0.5) for t in (r, k, v)]
    (rq, rs), (kq, ks), (vq, vs) = ((a.view(B, S, H, D), b.view(B, S, H, 1)) for a, b in q)
    deq = R.dequantize_int8_ref
    for name, kernel, plain in (
            ("rwkv6_scan", lambda: rwkv6_scan(r, k, v, w, u),
             lambda: R.rwkv6_scan_ref(r, k, v, w, u)),
            ("rwkv6_scan_q8", lambda: rwkv6_scan_int8(rq, rs, kq, ks, vq, vs, w, u, bf16),
             lambda: R.rwkv6_scan_ref(deq(rq, rs), deq(kq, ks), deq(vq, vs), w, u))):
        out, state = kernel()
        want_out, want_state = plain()
        want_out = want_out.to(bf16)
        torch.cuda.synchronize()
        atol = 2.0 ** (math.frexp(want_out.float().abs().max().item())[1] - 8)
        err = close_check(torch, f"{name} a rank's {(B, S, H, D)} bf16 out", out, want_out,
                          0.0, atol)
        close_check(torch, f"{name} a rank's state", state, want_state, 1e-4,
                    1e-4 * want_state.abs().max().item())
        q8 = name.endswith("q8")
        nbytes = (3 * r.numel() * (1 if q8 else 2) + (3 * rs.numel() * 4 if q8 else 0)
                  + 2 * w.numel() * 2 + u.numel() * 4 + state.numel() * 4)
        rec = record(name, f"rwkv6-7b: a rank's {(B, S, H, D)} bf16", "rwkv6_scan.cu",
                     "rwkv6_scan.py:171" if q8 else "rwkv6_scan.py:119", err, kernel, plain,
                     nbytes, wkv6_ops(B, S, H, D), "bfloat16")
        if name == "rwkv6_scan":
            records.append(rec)
        else:
            show(rec)
        del out, state, want_out, want_state
    del r, k, v, w, u, rq, rs, kq, ks, vq, vs
    # RG-LRU at a rank's channels: the int8 input quantized against the
    # whole row's absmax (four more columns), float32 gates
    B, S, W = gc_["rows"], gc_["seq"], rg.lru_width // 2
    a = torch.rand(B, S, W, generator=gen, device=dev) * 0.499 + 0.5
    x = torch.randn(B, S, W, generator=gen, device=dev)
    row = 2.0 * x.abs().amax(dim=-1, keepdim=True)        # the other rank's larger absmax
    wide = torch.cat([x, row.expand(B, S, 4)], dim=-1).view(-1, W + 4)
    rec = quant_record(torch, R, path, wide, flush)
    records.append(dict(rec, shape=f"recurrentgemma-2b: a rank's {B * S} rows of {W} f32 and "
                                   f"the whole row's absmax as 4 more columns, {rec['shape']}"))
    xq, xs = quantize_rows(wide, 0.5)
    xq, xs = xq[:, :W].contiguous().view(B, S, W), xs.view(B, S, 1)
    xd = deq(xq, xs)
    for name, kernel, plain in (("rglru_scan_q8", lambda: rglru_scan_int8(a, xq, xs),
                                 lambda: R.rglru_scan_ref(a, xd)),
                                ("rglru_scan", lambda: rglru_scan(a, x),
                                 lambda: R.rglru_scan_ref(a, x))):
        bit_check(torch, f"{name} a rank's {(B, S, W)} f32", kernel(), plain())
        q8 = name.endswith("q8")
        x_bytes = xq.numel() + xs.numel() * 4 if q8 else x.numel() * 4
        records.append(record(name, f"recurrentgemma-2b: a rank's {(B, S, W)}",
                              "rglru_scan.cu", "rglru_scan.py:103" if q8 else "rglru_scan.py:65",
                              0.0, kernel, plain, 2 * a.numel() * 4 + x_bytes, 2.0 * x.numel(),
                              "float32"))
    del a, x, row, wide, xq, xs, xd
    # the local attention at a rank's 5 query heads over the one KV head, D
    # 256 (window 2048 > seq: causal), over bf16 and int8 K/V; the K rows'
    # quantizer
    H, Hkv, D = rg.n_heads // 2, rg.n_kv_heads, rg.resolved_head_dim()
    records += attention_records(torch, R, F, rand, flush, path,
                                 f"recurrentgemma-2b: a rank's ({B}, {S}, {H} over {Hkv}, {D})",
                                 B, S, S, H, Hkv, D, True, int8=True)
    del scratch
    torch.cuda.empty_cache()
    return records


# phases 41-42: serving under the model axis, tensor- and expert-parallel
# prefill and decode on two gloo ranks that share the card at mesh data 1 x
# model 2, as phases 37-40.  Each cell: its arch at full width, cut to
# ``layers`` where given (whisper: that many encoder and decoder layers),
# weights of ``dtype`` from ``seed`` with every block matrix redrawn at its
# fan-in a layer slice at a time (``_serve_fan_in``), ``B`` rows of a seeded
# ``P``-token prompt (whisper's frames, qwen2-vl's ``patches`` patch
# embeddings before it), ``N`` greedy tokens, each KV dtype of ``kvs``; the
# recurrent pair through the batched route (``make_prefill_step`` at ``P``,
# then ``make_serve_step``) and through generate's stepped prefill at ``P2``
# tokens.  The bf16 cells are at full depth but qwen3-moe (48 -> 24 layers,
# so that the one process and then the two ranks each fit the card with
# margin), batch 8, cut to 4 greedy tokens and a stepped prefill of 4 tokens
# (16 and 32 would take the script past its limit: over gloo a rank's
# rwkv6-7b decode step takes 0.9 s); their logits are held to the one
# process within TS_BF16_GAP times the one process's own bf16 rounding (its
# bf16 logits against the same weights in float32), which alone moves these
# random-weight models' logits by 1-20% of the largest.  The float32 cells,
# 4 layers each, batch 4, 8 greedy tokens and a stepped prefill of 8, hold
# a rank to the one process without that rounding.
def _ts_cell(arch, dtype, layers=None, kvs=("native",), stepped=False, patches=0, P=None):
    """A cell of phases 41-42: float32 ones at 4 layers, batch 4, prompt 32,
    8 greedy tokens; bf16 ones at batch 8, prompt 128 (whisper 32), 4 greedy
    tokens; the recurrent pair's (``stepped``) generate prompt of N tokens."""
    f32 = dtype == "float32"
    N = 8 if f32 else 4
    return dict(name=arch + (" f32" if f32 else ""), arch=arch, dtype=dtype,
                layers=4 if f32 else layers, kvs=kvs, B=4 if f32 else 8,
                P=P or (32 if f32 else 128), N=N, P2=N if stepped else 0, patches=patches,
                seed=0)


TS_CELLS = {
    "tsd": (_ts_cell("deepseek-7b", "float32", kvs=("native", "int8")),
            _ts_cell("qwen3-moe-30b-a3b", "float32"),
            _ts_cell("deepseek-7b", "bfloat16", kvs=("native", "int8")),
            _ts_cell("qwen3-moe-30b-a3b", "bfloat16", layers=24)),
    "tsf": (_ts_cell("rwkv6-7b", "float32", stepped=True),
            _ts_cell("recurrentgemma-2b", "float32", stepped=True),
            _ts_cell("whisper-medium", "float32"),
            _ts_cell("qwen2-vl-7b", "float32", patches=64),
            _ts_cell("rwkv6-7b", "bfloat16", stepped=True),
            _ts_cell("recurrentgemma-2b", "bfloat16", stepped=True),
            _ts_cell("whisper-medium", "bfloat16", P=32),
            _ts_cell("qwen2-vl-7b", "bfloat16", patches=256)),
}
TS_PHASES = {"tsd": ("41", "tp_serving_dense_moe"), "tsf": ("42", "tp_serving_families")}
TS_BUDGET_S = {"tsd": 90.0, "tsf": 120.0}
TS_LOGIT_SHARE = 1e-4        # a float32 cell's logits within this share of the largest |logit|
# ... and over an int8 cache, whose 1-LSB flips (TS_INT8_LSB) move the attention: a rank's
# flips moved deepseek-7b's (4 layers, on the H100) by 2.3e-4
TS_INT8_LOGIT_SHARE = 1e-3
TS_INT8_LSB = 1              # int8 K/V bytes within this of the one process's (float32: every
                             # layer; bf16: the first, whose input both sides round alike)
# a bf16 cell's logits within this many times the one process's own bf16-against-float32
# gap: the rank is a second bf16 rounding of the same function, and two roundings that are
# each that far from the float32 logits are at most twice as far from each other
TS_BF16_GAP = 2.0


def _ts_config(cell, kv, dtype=None):
    import torch

    from repro_torch.configs import get_config

    cfg = get_config(cell["arch"]).with_(kv_cache_dtype=kv,
                                         dtype=getattr(torch, dtype or cell["dtype"]))
    if not cell["layers"]:
        return cfg
    if cfg.family == "encdec":
        return cfg.with_(n_enc_layers=cell["layers"], n_dec_layers=cell["layers"])
    return cfg.with_(n_layers=cell["layers"])


def _serve_fan_in(torch, params, seed, plan=None, rank=0):
    """Every stacked block matrix of ``params`` (as ``_fan_in_tree`` picks
    them) redrawn at N(0, 1/fan_in) over the axes it contracts (an expert
    matrix's third, its per-expert input), one layer slice of the whole
    leaf at a time from one generator in sorted path order, so every process
    draws the same numbers; under ``plan`` ``params`` are the pieces of flat
    ``rank``, which keeps its piece of each slice."""
    from repro_torch.distributed.sharding import iter_layouts

    lays = dict(iter_layouts(plan.params)) if plan is not None else {}
    gen = None
    for path, t in sorted(_paths(params).items()):
        name = path.rsplit("/", 1)[-1]
        if (t.dim() < 3 or name in ("bq", "bk", "bv")
                or path.split("/")[0] not in ("blocks", "groups", "enc_blocks", "dec_blocks")):
            continue
        if gen is None:
            gen = torch.Generator(device=t.device)
            gen.manual_seed(seed)
        lay = lays.get(path)
        whole = tuple(t.shape) if lay is None else lay.whole_shape(tuple(t.shape))
        if "/moe/" in path and name != "router":
            fan_in = whole[2]
        else:
            fan_in = whole[1] * (whole[2] if name == "wo" and len(whole) == 4 else 1)
        for i in range(whole[0]):
            w = torch.randn(whole[1:], generator=gen, device=t.device) / fan_in ** 0.5
            t[i].copy_(w if lay is None else lay.local(w[None], rank)[0])
    return params


def _upcast(tree):
    """Every floating leaf of a nested dict to float32, in place, one leaf
    at a time (its bf16 storage freed as it goes)."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _upcast(v)
        elif v.is_floating_point():
            tree[k] = v.float()


def _tree_clone(tree):
    return {k: _tree_clone(v) if isinstance(v, dict) else v.clone() for k, v in tree.items()}


def _ts_inputs(torch, cfg, cell, dev):
    """A cell's seeded prompt (B, P), the recurrent pair's generate prompt
    (B, P2), and whisper's frames or qwen2-vl's patch embeddings, drawn on
    the card (the same in every process)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(cell["seed"] + 4141)
    B = cell["B"]
    prompt = torch.randint(0, cfg.vocab, (B, cell["P"]), generator=gen, device=dev)
    prompt2 = (torch.randint(0, cfg.vocab, (B, cell["P2"]), generator=gen, device=dev)
               if cell["P2"] else None)
    return prompt, prompt2, _side_inputs(torch, cfg, B, cell["patches"], gen, dev)


def _ts_launches(cfg, cell, route):
    """Each kernel's launches in one main-path run of ``cell`` in one
    process or on a rank at model = 2 (a rank runs every layer's kernels at
    its heads or experts): generate's prefill and N steps (the recurrent
    pair's prompt stepped: P2 + N steps), or the recurrent pair's batched
    prefill and N steps (``route`` "batched")."""
    N, kv = cell["N"], cfg.kv_cache_dtype
    if cfg.family in ("rwkv6", "rglru"):
        batched = route == "batched"
        return _expected_launches(cfg, kv, int(batched), N if batched else cell["P2"] + N)
    n_flash, decode_op, n_decode = _slice_launches(cfg, kv, N)
    want = {"flash_attention": n_flash, decode_op: n_decode}
    if cfg.family == "moe":
        want["fused_moe_gemm"] = want["fused_moe_combine"] = (N + 1) * cfg.n_layers
    return want


class _KeptPrefill:
    """``model`` whose ``prefill`` keeps its last position's logits and its
    cache in ``kept``: generate's own prefill, read after the run.  The
    decode steps write the cache's later rows in place; a step from a given
    position writes that row before it reads the rows up to it."""

    def __init__(self, model):
        self.model, self.kept = model, {}

    def __getattr__(self, name):
        return getattr(self.model, name)

    def prefill(self, *args, **kwargs):
        logits, cache = self.model.prefill(*args, **kwargs)
        self.kept.update(logits=logits[:, -1], cache=cache)
        return logits, cache


def _ts_serve(torch, ops, model, params, cell, inputs, dev, forced=None):
    """One cell's serving in this process (the one process, or a rank under
    the mesh in scope): the main path (generate; the recurrent pair's
    batched route, then generate's stepped prefill), each run with its
    collectives recorded and its launches set to 0 just before it and read
    just after; then ``N`` decode steps fed ``forced`` (the one process's
    tokens; its own where None) from the main path's own prefill cache.
    -> (record, the logits of the prefill's last position and of each step
    (B, N+1, V), the prefill's int8 K/V and scales at the prompt's rows (the
    int8 cells are dense: leaves (L, B, T, Hkv, ·)))."""
    from repro_torch.api.serving import ServeSession
    from repro_torch.roofline.collectives import recording
    from repro_torch.train.steps import make_prefill_step, make_serve_step

    B, P, N = cell["B"], cell["P"], cell["N"]
    prompt, prompt2, side = inputs
    n_pre = P + cell["patches"]
    cache_len = n_pre + N + 1
    rec, logs, counts = {}, {}, {}
    torch.cuda.reset_peak_memory_stats(dev)
    if model.cfg.family in ("rwkv6", "rglru"):
        log = []
        ops.reset_launches()
        with recording(log):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            logits, cache = make_prefill_step(model, cache_len)(params, prompt)
            tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
            torch.cuda.synchronize(dev)
            t1 = time.perf_counter()
            # the decode steps update the state in place: keep the prefill's
            kept = {"logits": logits[:, -1], "cache": _tree_clone(cache)}
            torch.cuda.synchronize(dev)
            t_kept = time.perf_counter()
            step, toks = make_serve_step(model), [tok]
            for t in range(N):
                pos = torch.full((B,), P + t, dtype=torch.int32, device=dev)
                tok, _, cache = step(params, tok, cache, pos)
                toks.append(tok)
            torch.cuda.synchronize(dev)
            t2 = time.perf_counter()
        counts["batched"] = dict(ops.LAUNCHES)
        del logits, cache
        logs["batched"] = log
        rec.update(tokens=torch.cat(toks, dim=1), prefill_ms=(t1 - t0) * 1e3,
                   step_ms=(t2 - t_kept) / N * 1e3)
        log = []
        ops.reset_launches()
        with recording(log):
            out = ServeSession(model=model, params=params, device=dev).generate(
                prompt2, max_new_tokens=N)
        counts["generate"] = dict(ops.LAUNCHES)
        logs["generate"] = log
        rec.update(gen_tokens=out.tokens, gen_prefill_ms=out.prefill_time * 1e3,
                   gen_step_ms=out.ms_per_step)
    else:
        keep = _KeptPrefill(model)
        log = []
        ops.reset_launches()
        with recording(log):
            out = ServeSession(model=keep, params=params, device=dev).generate(
                prompt, max_new_tokens=N, cache_len=cache_len, **side)
        counts["generate"] = dict(ops.LAUNCHES)
        kept = keep.kept
        logs["generate"] = log
        rec.update(tokens=out.tokens, prefill_ms=out.prefill_time * 1e3,
                   step_ms=out.ms_per_step)
    rec["peak"] = torch.cuda.max_memory_allocated(dev)
    rec["launches"] = counts
    forced = rec["tokens"] if forced is None else forced
    cache = kept["cache"]
    first = {path: t[:, :, :n_pre].clone() for path, t in _paths(cache).items()
             if t.dtype == torch.int8 or path.endswith("_scale")}
    rows = [kept["logits"]]
    for t in range(N):
        pos = torch.full((B,), n_pre + t, dtype=torch.int32, device=dev)
        logits, cache = model.decode_step(params, forced[:, t:t + 1].to(torch.int32), cache,
                                          pos)
        rows.append(logits[:, -1])
    rec["cache_bytes"] = {path: t.numel() * t.element_size() for path, t in _paths(cache).items()}
    rec["ops"] = {k: [list(op) for op in v] for k, v in logs.items()}
    return rec, torch.stack(rows, dim=1), first


def _ts_rank_cells(torch, ops, dev, rank, mesh, phase, io: Path):
    """A rank of phase 41 or 42: each cell's plan, its pieces of the seed's
    weights (``init_rank_params``, then ``_serve_fan_in``), then each KV
    dtype served under the mesh (``_ts_serve``, fed the one process's
    tokens from ``io``), its int8 prefill cache held to the one process's at
    the rank's heads.  Rank 0 leaves its logits in ``io``.  -> record."""
    import gc
    import hashlib

    from repro_torch.distributed.sharding import (
        _divisible_spec, layout_for, spec_for, use_mesh, use_rules,
    )
    from repro_torch.models.api import get_model
    from repro_torch.optim import adamw
    from repro_torch.train.steps import build_sharding_plan, init_rank_params

    out = {}
    for cell in TS_CELLS[phase]:
        params = None
        for kv in cell["kvs"]:
            cfg = _ts_config(cell, kv)
            model = get_model(cfg)
            plan = build_sharding_plan(model, adamw(), mesh=mesh, global_rows=cell["B"],
                                       seq_len=cell["P"], device=dev)
            if params is None:
                params = _serve_fan_in(torch, init_rank_params(model, plan, rank,
                                                               seed=cell["seed"], device=dev),
                                       cell["seed"] + 1, plan, rank)
            tag = f"{cell['name']} {kv}"
            yard = torch.load(io / f"{phase}-{cell['name']}-{kv}.yard.pt", map_location="cpu")
            inputs = _ts_inputs(torch, cfg, cell, dev)
            with use_rules(plan.rules), use_mesh(mesh):
                whole = model.init_cache(cell["B"], cell["P"] + cell["patches"] + cell["N"] + 1,
                                         device=dev)
                init_bytes = {p: t.numel() * t.element_size() for p, t in _paths(whole).items()}
                del whole
                rec, logits, first = _ts_serve(torch, ops, model, params, cell, inputs, dev,
                                               forced=yard["tokens"].to(dev))
                axes = _paths(model.cache_logical_axes())
            rec["init_bytes"] = init_bytes
            rec["tokens"] = rec["tokens"].tolist()
            if "gen_tokens" in rec:
                rec["gen_tokens"] = rec["gen_tokens"].tolist()
            rec["int8"] = {}
            for path, mine in first.items():
                full = yard["cache"][path]
                lay = layout_for(_divisible_spec(spec_for(axes[path], plan.rules),
                                                 tuple(full.shape), mesh), mesh)
                want = lay.local(full, rank).to(dev)
                if mine.dtype == torch.int8:
                    # a layer at a time: (max |byte diff|, bytes that differ, bytes)
                    diff = (mine.int() - want.int()).abs().flatten(1)
                    rec["int8"][path] = [[int(m), int(c), diff.shape[1]] for m, c in
                                         zip(diff.amax(dim=1), (diff > 0).sum(dim=1))]
                else:
                    rec["int8"][path] = [float(((mine - want).abs() / want.abs().clamp_min(
                        1e-30)).max())]
            h = hashlib.sha256(logits.detach().float().cpu().numpy().tobytes())
            rec["logits_digest"] = h.hexdigest()[:16]
            if rank == 0:
                torch.save(logits.cpu(), io / f"{phase}-{cell['name']}-{kv}.rank0.pt")
            out[tag] = rec
            del logits, first, yard, inputs
        del params
        gc.collect()
        torch.cuda.empty_cache()
    return {"cells": out}


def _first_divergence(a, b) -> int:
    """The first token index (along the generated sequence) at which any row
    of ``a`` and ``b`` differ, or -1."""
    diff = (np.asarray(a) != np.asarray(b)).any(axis=0)
    return int(diff.argmax()) if diff.any() else -1


def _ts_check_launches(counts, cfg, cell, what):
    """``counts`` (route -> every kernel's launches) against ``_ts_launches``,
    every kernel it does not name at 0."""
    for route, got in counts.items():
        want = dict.fromkeys(got, 0)
        want.update(_ts_launches(cfg, cell, route))
        _check_launches(got, want, f"{what} {route}")


def tp_serving(torch, ops, R, F, dev, phase, root: Path):
    """Phase 41 (``tsd``) or 42 (``tsf``), see the module doc: each cell's
    one process on the card first (its tokens, logits and int8 prefill
    cache kept; a bf16 cell then served again with its weights in float32,
    the yardstick of its own rounding; the weights freed), the two ranks
    (``--rank tsd|tsf``), the checks a cell, then each kernel of the path at
    a rank's serving shapes against its plain version.  -> (the launches of
    the bf16 cells' main-path runs on both ranks, records)."""
    import gc

    from repro_torch.distributed.sharding import ProcessMesh, use_mesh, use_rules
    from repro_torch.models.api import get_model
    from repro_torch.roofline.collectives import collective_bytes, tp_serve_ops

    number, path = TS_PHASES[phase]
    t0 = time.perf_counter()
    base = {}
    for cell in TS_CELLS[phase]:
        params = None
        for kv in cell["kvs"]:
            cfg = _ts_config(cell, kv)
            model = get_model(cfg)
            if params is None:
                t_init = time.perf_counter()
                params, _ = model.init_params(seed=cell["seed"], device=dev)
                _serve_fan_in(torch, params, cell["seed"] + 1)
                t_init = time.perf_counter() - t_init
            inputs = _ts_inputs(torch, cfg, cell, dev)
            t_run = time.perf_counter()
            rec, logits, first = _ts_serve(torch, ops, model, params, cell, inputs, dev)
            tag = f"{cell['name']} {kv}"
            _ts_check_launches(rec["launches"], cfg, cell, f"[{phase}] {tag} the one process")
            torch.save({"tokens": rec["tokens"].cpu(),
                        "cache": {p: t.cpu() for p, t in first.items()}},
                       root / f"{phase}-{cell['name']}-{kv}.yard.pt")
            plan = _model2_plan(torch, model, cell["B"], cell["P"])
            with use_rules(plan.rules), use_mesh(ProcessMesh(torch.device("cpu"), (1, 2))):
                like = model.init_cache(cell["B"], cell["P"] + cell["patches"] + cell["N"] + 1,
                                        device="meta")
            want_bytes = {p: t.numel() * t.element_size() for p, t in _paths(like).items()}
            base[tag] = dict(cfg=cfg, plan=plan, rec=rec, logits=logits.cpu(), inputs=inputs,
                             want_bytes=want_bytes, cell=cell, kv=kv)
            print(f"[{phase}] {tag} ({str(cfg.dtype).split('.')[-1]} weights), "
                  f"{cfg.n_layers if cfg.family != 'encdec' else cfg.n_enc_layers} layers"
                  f"{' each side' if cfg.family == 'encdec' else ''}, "
                  f"{cfg.param_count() / 1e9:.3f} B params, batch {cell['B']} x prompt "
                  f"{cell['P']}{' + ' + str(cell['patches']) + ' patches' if cell['patches'] else ''}"
                  f", {cell['N']} greedy tokens: the one process: prefill "
                  f"{rec['prefill_ms']:.3f} ms, decode {rec['step_ms']:.3f} ms/step"
                  + (f", generate's stepped prefill at {cell['P2']} tokens "
                     f"{rec['gen_prefill_ms']:.3f} ms then {rec['gen_step_ms']:.3f} ms/step"
                     if "gen_tokens" in rec else "")
                  + f", peak {rec['peak'] / 2**30:.2f} GiB (weights drawn in {t_init:.1f} s, "
                  f"served in {time.perf_counter() - t_run:.1f} s)")
            del logits, first
        if cell["dtype"] == "bfloat16":
            # the one process's own bf16 rounding: the same weights and inputs in float32,
            # fed the same tokens
            _upcast(params)
            for kv in cell["kvs"]:
                b = base[f"{cell['name']} {kv}"]
                cfg32 = _ts_config(cell, kv, "float32")
                prompt, prompt2, side = b.pop("inputs")
                rec32, logits32, _ = _ts_serve(
                    torch, ops, get_model(cfg32), params, cell,
                    (prompt, prompt2, {k: v.float() for k, v in side.items()}), dev,
                    forced=b["rec"]["tokens"])
                _ts_check_launches(rec32["launches"], cfg32, cell,
                                   f"[{phase}] {cell['name']} {kv} in float32")
                b["own_gap"] = (logits32.cpu() - b["logits"].float()).abs().max().item()
                # bf16 keeps a route's tokens where it changes none of the one process's
                agree = {k: (rec32[k] == b["rec"][k]).float().mean().item()
                         for k in ("tokens", "gen_tokens") if k in rec32}
                b["keeps"] = {k: a == 1.0 for k, a in agree.items()}
                print(f"[{phase}] {cell['name']} {kv}: the one process's bf16 logits against "
                      f"the same weights in float32 (prefill and {cell['N']} teacher-forced "
                      f"steps): max gap {b['own_gap']:.4e}, "
                      f"{b['own_gap'] / logits32.abs().max().item():.3e} of the largest "
                      f"|logit|; greedy tokens agree {agree}")
                del logits32, rec32
        for b in base.values():
            b.pop("inputs", None)
        del params
        gc.collect()
        torch.cuda.empty_cache()
    print(f"[{phase}] before the ranks: this process holds "
          f"{torch.cuda.memory_reserved(dev) / 2**30:.3f} GiB reserved; card free "
          f"{torch.cuda.mem_get_info(dev)[0] / 2**30:.2f} GiB")
    t_ranks = time.perf_counter()
    recs = _run_ranks(phase, root, timeout=900)
    print(f"[{phase}] the two ranks: {time.perf_counter() - t_ranks:.1f} s")
    totals = {}
    for tag, b in base.items():
        cfg, plan, yard, cell = b["cfg"], b["plan"], b["rec"], b["cell"]
        mine = [rec["cells"][tag] for rec in recs]
        what = f"[{phase}] {tag}"
        B, P, N = cell["B"], cell["P"], cell["N"]
        f32 = cell["dtype"] == "float32"
        for key in ("tokens", "gen_tokens"):
            if key not in yard:
                continue
            ranks = [r[key] for r in mine]
            if ranks[0] != ranks[1]:
                raise AssertionError(f"{what}: the ranks' {key} differ")
            want = yard[key].cpu().numpy()
            got = np.asarray(ranks[0])
            same_first = bool((got[:, 0] == want[:, 0]).all())
            # bf16: held where the one process's own rounding changes none of its tokens
            held = f32 or b["keeps"][key]
            print(f"{what}: {key}: the two ranks equal; first token "
                  f"{'equal to' if same_first else 'DIFFERS from'} the one process's ("
                  f"{'held' if held else 'not held: bf16 rounding alone changes its tokens'}), "
                  f"first later divergence at index {_first_divergence(got, want)} of "
                  f"{N + 1} ({(got == want).mean():.3f} of tokens agree)")
            if held and not same_first:
                raise AssertionError(f"{what}: the first {key} differ from the one process's")
        if mine[0]["logits_digest"] != mine[1]["logits_digest"]:
            raise AssertionError(f"{what}: the ranks' logits differ")
        got = torch.load(root / f"{phase}-{cell['name']}-{b['kv']}.rank0.pt")
        want = b["logits"]
        scale = want.float().abs().max().item()
        gap = (got.float() - want.float()).abs().max().item()
        if f32:
            share = TS_INT8_LOGIT_SHARE if b["kv"] == "int8" else TS_LOGIT_SHARE
            limit, why = share * scale, f"{share:g} of the largest"
        else:
            limit = TS_BF16_GAP * b["own_gap"]
            why = f"{TS_BF16_GAP:g} x the one process's own bf16 gap {b['own_gap']:.4e}"
        print(f"{what}: the whole prefill and {N} teacher-forced decode logits "
              f"{tuple(got.shape)} equal on both ranks; max |rank - one process| {gap:.4e}, "
              f"{gap / scale:.3e} of the largest |logit| {scale:.3f} (bound {limit:.4e}: {why})")
        if not math.isfinite(gap) or gap > limit:
            raise AssertionError(f"{what}: logits {gap} from the one process's (bound {limit})")
        for rec in mine:
            who = f"{what} rank {mine.index(rec)}"
            for leaf, st in rec["int8"].items():
                if isinstance(st[0], list):
                    worst = max(m for m, _, _ in st)
                    print(f"{who}: int8 {leaf} at the rank's heads against the one process's: "
                          f"max |byte diff| {worst}; a layer at a time (max, bytes that differ "
                          f"of {st[0][2]:,}): {[(m, c) for m, c, _ in st]}")
                    # bf16: the first layer quantizes the same rows on both sides (the
                    # embedding's reduce is exact); a later layer's input carries the
                    # bf16 rounding of the ranks' partial sums, so it is printed
                    held = worst if f32 else st[0][0]
                    if held > TS_INT8_LSB:
                        raise AssertionError(f"{who}: int8 {leaf} off by {held} LSB "
                                             f"({'every layer' if f32 else 'its first layer'})")
                else:
                    print(f"{who}: {leaf} at the rank's heads: max relative gap {st[0]:.3e}")
            for name, want_b in (("init_cache", rec["init_bytes"]),
                                 ("prefill's cache", rec["cache_bytes"])):
                if want_b != b["want_bytes"]:
                    raise AssertionError(f"{who}: {name} bytes {want_b}, the Layout.local shapes' "
                                         f"{b['want_bytes']}")
            cache_total = sum(rec["cache_bytes"].values())
            print(f"{who}: every cache leaf's bytes are its Layout.local shape's "
                  f"({cache_total:,} B, the one process's {sum(yard['cache_bytes'].values()):,})"
                  f"; prefill {rec['prefill_ms']:.3f} ms, decode {rec['step_ms']:.3f} ms/step"
                  + (f", generate's stepped prefill {rec['gen_prefill_ms']:.3f} ms then "
                     f"{rec['gen_step_ms']:.3f} ms/step" if "gen_tokens" in rec else "")
                  + f", peak {rec['peak'] / 2**30:.2f} GiB; launches "
                  f"{ {r: {k: v for k, v in c.items() if v} for r, c in rec['launches'].items()} }")
            _ts_check_launches(rec["launches"], cfg, cell, who)
            if not f32:
                for counts in rec["launches"].values():
                    for name, c in counts.items():
                        totals[name] = totals.get(name, 0) + c
            if cfg.family in ("rwkv6", "rglru"):
                want_ops = {"batched": tp_serve_ops(cfg, plan, B, P, N),
                            "generate": tp_serve_ops(cfg, plan, B, 0, cell["P2"] + N)}
            else:
                want_ops = {"generate": tp_serve_ops(cfg, plan, B, P, N,
                                                     patches=cell["patches"])}
            for key, ops_want in want_ops.items():
                got_ops = sorted(map(tuple, rec["ops"][key]))
                print(f"{who}: {key}'s collectives: {len(got_ops)}, wire bytes by kind "
                      f"{collective_bytes(got_ops)}; roofline.collectives.tp_serve_ops: "
                      f"{len(ops_want)}, {collective_bytes(ops_want)}")
                if got_ops != sorted(ops_want):
                    raise AssertionError(f"{who}: {key}'s collectives are not tp_serve_ops'")
    print(f"[{phase}] launches of the bf16 cells' main-path runs on the {path} path (both "
          f"ranks, each run's counts held to its expected ones): "
          f"{ {k: v for k, v in totals.items() if v} }")
    records = ts_kernel_records(torch, R, F, dev, phase, path)
    print(f"[{phase}] phase {number}: {time.perf_counter() - t0:.1f} s (budget "
          f"{TS_BUDGET_S[phase]:.0f})")
    return totals, records


def ts_kernel_records(torch, R, F, dev, phase, path):
    """The kernels of phase 41's or 42's path at a rank's serving shapes
    (model = 2) against their plain versions on the card, timed: flash at a
    rank's prefill heads (SDPA beside it), decode over a rank's heads of the
    cache (native, and int8 for deepseek-7b), the expert GEMM and combine on
    a rank's 64 of qwen3's 128 experts at the prefill's and a decode step's
    tokens, the WKV-6 scan at a rank's 32 of 64 heads, the RG-LRU scan at
    a rank's 1,280 of 2,560 channels.  -> the kernels-line records."""
    from repro_torch.kernels.decode_attention import decode_attention, decode_attention_int8
    from repro_torch.kernels.rglru_scan import rglru_scan
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan
    from repro_torch.models.moe import expert_capacity

    gen = torch.Generator(device=dev)
    gen.manual_seed(4141 if phase == "tsd" else 4242)
    scratch = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    flush = scratch.zero_
    bf16 = torch.bfloat16
    records = []

    def rand(*shape, std=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * std).to(bf16)

    def decode(shape, H, Hkv, D, cache, valid_l, int8):
        B = len(valid_l)
        valid = torch.tensor(valid_l, dtype=torch.int32, device=dev)
        rows = int(valid.sum())
        q, k, v = rand(B, 1, H, D), rand(B, cache, Hkv, D), rand(B, cache, Hkv, D)
        run = lambda: decode_attention(q, k, v, valid)                          # noqa: E731
        plain = lambda: R.decode_attention_ref(q, k, v, valid)                  # noqa: E731
        err = row_ulp_check(torch, f"decode_attention {path} {shape}", run(), plain())
        mask = (torch.arange(cache, device=dev)[None, :] < valid[:, None])[:, None, None, :]
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        small = 2 * q.numel() * 2 + B * 4
        records.append(_attention_record(
            "decode_attention", path, shape, err, run, plain, 2 * rows * Hkv * D * 2 + small,
            4 * D * H * rows, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=Hkv != H), flush))
        if int8:
            (kq, ks), (vq, vs) = R.quantize_int8_ref(k), R.quantize_int8_ref(v)
            run8 = lambda: decode_attention_int8(q, kq, ks, vq, vs, valid)           # noqa: E731
            plain8 = lambda: R.decode_attention_int8_ref(q, kq, ks, vq, vs, valid)   # noqa: E731
            err8 = row_ulp_check(torch, f"decode_attention_int8 {path} {shape}", run8(),
                                 plain8())
            records.append(_attention_record(
                "decode_attention_int8", path, shape, err8, run8, plain8,
                2 * rows * Hkv * (D + 4) + small, 4 * D * H * rows, None, flush))

    def flash(label, B, Sq, Skv, H, Hkv, D, causal):
        records.extend(attention_records(torch, R, F, rand, flush, path,
                                         f"{label}: a rank's ({B}, {Sq}"
                                         f"{'' if Sq == Skv else ' over ' + str(Skv)}, {H}"
                                         f"{'' if Hkv == H else ' over ' + str(Hkv)}, {D})",
                                         B, Sq, Skv, H, Hkv, D, causal, int8=False))

    cells = {c["arch"]: c for c in TS_CELLS[phase] if c["dtype"] == "bfloat16"}
    if phase == "tsd":
        dc, qc = cells["deepseek-7b"], cells["qwen3-moe-30b-a3b"]
        ds, qm = _ts_config(dc, "native"), _ts_config(qc, "native")
        B, P, N = dc["B"], dc["P"], dc["N"]
        valid = [P + N // 2] * B
        flash("deepseek-7b prefill", B, P, P, ds.n_heads // 2, ds.n_kv_heads // 2,
              ds.resolved_head_dim(), True)
        decode(f"deepseek-7b decode: a rank's ({B}, 1, {ds.n_heads // 2}, "
               f"{ds.resolved_head_dim()}) over {P + N + 1} rows", ds.n_heads // 2,
               ds.n_kv_heads // 2, ds.resolved_head_dim(), P + N + 1, valid, int8=True)
        H, Hkv, D = qm.n_heads // 2, qm.n_kv_heads // 2, qm.resolved_head_dim()
        flash("qwen3-moe prefill", B, P, P, H, Hkv, D, True)
        decode(f"qwen3-moe decode: a rank's ({B}, 1, {H} over {Hkv}, {D}) over "
               f"{P + N + 1} rows", H, Hkv, D, P + N + 1, valid, int8=False)
        d, f, E, k = qm.d_model, qm.d_ff, qm.n_experts, qm.experts_per_token
        router = rand(d, E, std=d ** -0.5)
        wg, wu, wo = rand(E // 2, d, f, std=d ** -0.5), rand(E // 2, d, f, std=d ** -0.5), \
            rand(E // 2, f, d, std=f ** -0.5)
        for T, label in ((B * P, "prefill"), (B, "decode")):
            C = expert_capacity(T, E, k, qm.capacity_factor)
            records += moe_gemm_combine_records(
                torch, R, F, rand(T, d), router, wg, wu, wo, k, C,
                f"EP {label}: a rank's {E // 2} of {E} experts (T={T}, C={C})", path, flush,
                first_expert=0)
        del router, wg, wu, wo
    else:
        wc, gc_, hc, vc = (cells[a] for a in ("rwkv6-7b", "recurrentgemma-2b",
                                               "whisper-medium", "qwen2-vl-7b"))
        rw, rg, wh, vl = (_ts_config(c, "native") for c in (wc, gc_, hc, vc))
        B, S, H, D = wc["B"], wc["P"], rw.d_model // rw.rwkv_head_dim // 2, rw.rwkv_head_dim
        r, k, v = (rand(B, S, H, D) for _ in range(3))
        w = torch.exp(-torch.exp(torch.randn(B, S, H, D, generator=gen, device=dev) * 0.5)
                      ).to(bf16)
        u = torch.randn(H, D, generator=gen, device=dev)
        out, state = rwkv6_scan(r, k, v, w, u)
        want_out, want_state = R.rwkv6_scan_ref(r, k, v, w, u)
        want_out = want_out.to(bf16)
        atol = 2.0 ** (math.frexp(want_out.float().abs().max().item())[1] - 8)
        err = close_check(torch, f"rwkv6_scan {path} a rank's {(B, S, H, D)} bf16 out", out,
                          want_out, 0.0, atol)
        close_check(torch, f"rwkv6_scan {path} a rank's state", state, want_state, 1e-4,
                    1e-4 * want_state.abs().max().item())
        nbytes = 3 * r.numel() * 2 + 2 * w.numel() * 2 + u.numel() * 4 + state.numel() * 4
        b_ms, b_by = bound(nbytes, wkv6_ops(B, S, H, D), "bfloat16")
        records.append(dict(
            name="rwkv6_scan", path=path, shape=f"rwkv6-7b prefill: a rank's {(B, S, H, D)} bf16",
            route="cuda", source="src/repro_torch/kernels/csrc/rwkv6_scan.cu",
            replaces="src/repro/kernels/rwkv6_scan.py:119", launches=0, max_abs_err=err,
            ms=timed_ms(lambda: rwkv6_scan(r, k, v, w, u), flush),
            plain_ms=timed_plain(lambda: R.rwkv6_scan_ref(r, k, v, w, u), flush),
            bound_ms=b_ms, bound_by=b_by, library_ms=None))
        del r, k, v, w, u, out, state, want_out, want_state
        B, S, W = gc_["B"], gc_["P"], rg.lru_width // 2
        a = torch.rand(B, S, W, generator=gen, device=dev) * 0.499 + 0.5
        x = torch.randn(B, S, W, generator=gen, device=dev)
        bit_check(torch, f"rglru_scan {path} a rank's {(B, S, W)} f32", rglru_scan(a, x),
                  R.rglru_scan_ref(a, x))
        b_ms, b_by = bound(3 * a.numel() * 4, 2.0 * x.numel(), "float32")
        records.append(dict(
            name="rglru_scan", path=path,
            shape=f"recurrentgemma-2b prefill: a rank's {(B, S, W)} f32", route="cuda",
            source="src/repro_torch/kernels/csrc/rglru_scan.cu",
            replaces="src/repro/kernels/rglru_scan.py:65", launches=0, max_abs_err=0.0,
            ms=timed_ms(lambda: rglru_scan(a, x), flush),
            plain_ms=timed_plain(lambda: R.rglru_scan_ref(a, x), flush),
            bound_ms=b_ms, bound_by=b_by, library_ms=None))
        del a, x
        N = gc_["N"]
        cache = gc_["P"] + N + 1
        H, Hkv, D = rg.n_heads // 2, rg.n_kv_heads, rg.resolved_head_dim()
        flash("recurrentgemma-2b prefill", B, S, S, H, Hkv, D, True)
        decode(f"recurrentgemma-2b decode: a rank's ({B}, 1, {H} over {Hkv}, {D}) over "
               f"{cache} rows", H, Hkv, D, cache, [S + N // 2] * B, int8=False)
        B, H, D, F_ = hc["B"], wh.n_heads // 2, wh.resolved_head_dim(), wh.n_frames
        flash("whisper-medium encoder", B, F_, F_, H, H, D, False)
        decode(f"whisper-medium cross decode: a rank's ({B}, 1, {H}, {D}) over {F_} frames",
               H, H, D, F_, [F_] * B, int8=False)
        B, S = vc["B"], vc["patches"] + vc["P"]
        H, Hkv, D = vl.n_heads // 2, vl.n_kv_heads // 2, vl.resolved_head_dim()
        flash("qwen2-vl-7b prefill", B, S, S, H, Hkv, D, True)
        decode(f"qwen2-vl-7b decode: a rank's ({B}, 1, {H} over {Hkv}, {D}) over "
               f"{S + vc['N'] + 1} rows", H, Hkv, D, S + vc["N"] + 1,
               [S + vc["N"] // 2] * B, int8=False)
    del scratch
    torch.cuda.empty_cache()
    for rec in records:
        print(json.dumps(rec))
    return records


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def main() -> int:
    src = ROOT / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        return fail(f"the port's sources are not beside this script ({src / 'repro_torch'})")
    import torch

    if not torch.cuda.is_available():
        return fail("no CUDA device is available")
    import torch.nn.functional as F

    from repro_torch.api.serving import ServeSession
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.device import resolve_device
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import ref as R
    from repro_torch.launch.train import train_session_factory
    from repro_torch.models.api import get_model

    t_start = time.perf_counter()
    dev = resolve_device("cuda")
    print(card_line())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    _build.KERNELS.build()
    print(f"[build] {_build.KERNELS.build_seconds:.1f} s")
    for line in build_report(_build.KERNELS.build_log):
        print(f"[build] {line}")
    tensor_ops = sass_report(_build.KERNELS.out_dir, _build.nvcc_path())
    for name, (hmma, hgmma) in tensor_ops.items():
        print(f"[sass] {name}: {hmma} HMMA, {hgmma} HGMMA")
    for kernel in TENSOR_CORE_KERNELS:
        tc = [n for n in tensor_ops if kernel in n]
        if not tc or any(sum(tensor_ops[n]) == 0 for n in tc):
            raise AssertionError(f"{kernel} holds no tensor-core instruction: {tc}")

    last = [t_start]

    def lap(label):
        """The seconds since the previous lap: where the run's wall goes."""
        now = time.perf_counter()
        print(f"[time] {label}: {now - last[0]:.1f} s")
        last[0] = now

    lap("phases 1-2 (the build included)")
    records = kernel_checks(torch, ops, R, F, dev)
    tile_edge_checks(torch, R, dev)
    records += train_kernel_checks(torch, ops, R, F, dev)
    lap("phases 3 and 6")
    cross_device(torch, ops, get_model, smoke_config, ServeSession, dev)
    cross_device_train(torch, ops, train_session_factory, dev)
    lap("phases 4 and 7")
    # the main paths: counts are reset before and read after each run
    serve_totals, decode_ms = full_width(torch, ops, get_model, get_config, ServeSession, dev)
    lap("phase 5")
    train_totals, train_ms = full_width_train(torch, ops, train_session_factory, get_config,
                                              dev)
    lap("phase 8")
    # MoE serving: the dense model's state is gone with its phases' locals
    torch.cuda.empty_cache()
    print(f"[moe] before the MoE phases: {torch.cuda.memory_allocated(dev) / 2**30:.3f} GiB "
          f"allocated")
    records += moe_kernel_checks(torch, R, F, dev)
    cross_device_moe(torch, ops, get_model, smoke_config, ServeSession, dev)
    moe_totals, moe_ms = full_width_moe(torch, ops, get_model, get_config, ServeSession, dev)
    lap("phases 9-11")
    # recurrent serving, after the MoE state is freed
    records += recurrent_kernel_checks(torch, R, F, dev)
    cross_device_recurrent(torch, ops, get_model, smoke_config, ServeSession, dev)
    lap("phases 13-14")
    rec_totals, rec_ms = full_width_recurrent(torch, ops, get_model, get_config, ServeSession,
                                              dev)
    lap("phases 15-16")
    # recurrent training
    records += recurrent_train_kernel_checks(torch, ops, R, F, dev)
    for arch in ("rwkv6-7b", "recurrentgemma-2b"):
        cross_device_train(torch, ops, train_session_factory, dev, arch)
    rec_train_totals = {name: 0 for name in ops.LAUNCHES}
    for arch in ("rwkv6-7b", "recurrentgemma-2b"):
        totals, ms = full_width_train(torch, ops, train_session_factory, get_config, dev, arch)
        train_ms.update(ms)
        for name, c in totals.items():
            rec_train_totals[name] += c
    lap("phases 17-19")
    # the serve engine: paged decode kernels, smoke engines, deepseek-7b engine load
    torch.cuda.empty_cache()
    records += paged_kernel_checks(torch, R, dev)
    cross_device_engine(torch, ops, get_model, smoke_config, ServeSession, dev)
    lap("phases 20-21")
    engine_totals = full_width_engine(torch, ops, R, get_model, get_config, ServeSession, dev)
    lap("phase 22")
    # checkpoint / restart and elastic replanning at full width
    torch.cuda.empty_cache()
    ckpt_root = Path(tempfile.mkdtemp(prefix="chip-smoke-ckpt-"))
    try:
        checkpoint_restart(torch, ops, train_session_factory, dev, ckpt_root)
    finally:
        shutil.rmtree(ckpt_root, ignore_errors=True)
    lap("phase 23")
    elastic_replan(torch, ops, train_session_factory, dev)
    lap("phase 24")
    # qwen1.5-4b, minitron-8b, deepseek-coder-33b, whisper-medium, qwen2-vl-7b
    torch.cuda.empty_cache()
    slice_records, slice_totals, slice_ms = slice_phases(
        torch, ops, R, F, get_model, get_config, smoke_config, ServeSession, dev)
    records += slice_records
    lap("phases 25-27 (their kernel checks and smoke configs included)")
    # training the MoE, encoder-decoder and vision-language families
    torch.cuda.empty_cache()
    records += train_family_kernel_checks(torch, R, F, dev)
    moe_grad_check(torch, ops, R, dev)
    lap("phases 28-30's kernel checks and the MoE gradient check")
    cross_device_family_train(torch, ops, get_model, smoke_config, train_session_factory, dev)
    lap("phases 28-30's smoke configs, CPU vs card")
    family_train_totals = {}
    family_train_totals["moe_training"], ms = full_width_train(
        torch, ops, train_session_factory, get_config, dev, "qwen3-moe-30b-a3b")
    train_ms[("qwen3-moe-30b-a3b", "f32")] = ms[("qwen3-moe-30b-a3b", "f32")]   # profiled
    lap("phase 28")
    side_ms = {}
    for phase, path, arch in (("29", "encdec_training", "whisper-medium"),
                              ("30", "vlm_training", "qwen2-vl-7b")):
        family_train_totals[path], ms = full_width_side_train(
            torch, ops, get_model, get_config, dev, arch)
        side_ms[arch] = ms[(arch, "f32")]                                   # profiled
        lap(f"phase {phase}")
    # multi-process cluster training: 2 worker processes share the card
    torch.cuda.empty_cache()
    bucket_lens = cluster_bucket_lens()
    records += cluster_kernel_checks(torch, R, F, dev, bucket_lens)
    lap("phase 31's kernel checks")
    cluster_root = Path(tempfile.mkdtemp(prefix="chip-smoke-cluster-"))
    try:
        cluster_totals, cluster_losses, cluster_peaks, cluster_norms = cluster_training(
            torch, ops, dev, bucket_lens, cluster_root)
        lap("phase 31")
        cluster_smoke(smoke_config, dev, cluster_root)
        lap("phase 32")
    finally:
        shutil.rmtree(cluster_root, ignore_errors=True)
    # the measured tune, the serving example on every arch, the dry run's memory model
    torch.cuda.empty_cache()
    tune_totals, tune_records = measured_tune(torch, ops, R, F, train_session_factory,
                                              get_config, dev)
    records += tune_records
    lap("phase 33's measured tune")
    serve_batched_examples(torch, ops, get_model, smoke_config, dev)
    lap("phase 33's serving example")
    dryrun_memory(torch, dev)
    lap("phase 34")
    # data-parallel training through the spmd worker path, one NCCL rank
    torch.cuda.empty_cache()
    spmd_root = Path(tempfile.mkdtemp(prefix="chip-smoke-spmd-"))
    try:
        spmd_totals, comp_totals, spmd_records = spmd_training(
            torch, ops, R, F, dev, cluster_losses, spmd_root)
    finally:
        shutil.rmtree(spmd_root, ignore_errors=True)
    records += spmd_records
    lap("phase 35")
    # ZeRO-3: two spmd ranks share the card over gloo, each holding its shards
    torch.cuda.empty_cache()
    zero_root = Path(tempfile.mkdtemp(prefix="chip-smoke-zero3-"))
    try:
        zero_totals = zero3_training(torch, ops, dev, cluster_losses, cluster_peaks, zero_root)
    finally:
        shutil.rmtree(zero_root, ignore_errors=True)
    # flash at a rank's 20 rows is phase 31's worker shape, held to its plain
    # version there; its launches here are the ZeRO-3 path's
    records += [dict(r, path="zero3_training", shape="a rank's (20, 256, 32, 128), phase 31's "
                     "check") for r in records
                if r["name"] == "flash_attention" and r["path"] == "cluster_training"]
    lap("phase 36")
    # tensor and expert parallelism: two gloo ranks share the card, mesh data 1 x model 2
    torch.cuda.empty_cache()
    tp_root = Path(tempfile.mkdtemp(prefix="chip-smoke-tp-"))
    try:
        tp_totals, tp_records = tp_training(torch, ops, R, F, dev, cluster_losses,
                                            cluster_norms, tp_root)
        lap("phase 37")
        torch.cuda.empty_cache()
        ep_totals, ep_records = ep_training(torch, ops, R, F, dev, tp_root)
        lap("phase 38")
        family_tp = {}
        for phase in ("tpr", "tpe"):
            torch.cuda.empty_cache()
            number, path = TP_FAMILY_PHASES[phase]
            family_tp[path], recs = tp_family_training(torch, ops, R, F, dev, phase, tp_root)
            records += recs
            lap(f"phase {number}")
        # serving under the model axis, the same two ranks' layout
        for phase in ("tsd", "tsf"):
            torch.cuda.empty_cache()
            number, path = TS_PHASES[phase]
            family_tp[path], recs = tp_serving(torch, ops, R, F, dev, phase, tp_root)
            records += recs
            lap(f"phase {number}")
    finally:
        shutil.rmtree(tp_root, ignore_errors=True)
    records += tp_records + ep_records
    # profiles after every timed run: a generate timed after the profiler ran
    # measured slower decode steps
    t_profiles = time.perf_counter()
    profile_train(torch, train_session_factory, dev, train_ms)
    lap("phase 12's training profiles")
    profile_side_train(torch, get_model, get_config, dev, side_ms)
    lap("phase 12's phase 29-30 profiles")
    profile_serving(torch, get_model, get_config, dev, decode_ms)
    lap("phase 12's serving and engine profiles")
    profile_moe_serving(torch, get_model, get_config, dev, moe_ms)
    profile_recurrent_serving(torch, get_model, get_config, dev, rec_ms)
    lap("phase 12's MoE and recurrent serving profiles")
    profile_slice(torch, get_model, get_config, dev, slice_ms)
    lap("phase 12's phase 25-27 profiles")
    print(f"[time] phase 12: {time.perf_counter() - t_profiles:.1f} s")
    totals = {"serving": serve_totals, "training": train_totals, "moe_serving": moe_totals,
              "recurrent_serving": rec_totals, "recurrent_training": rec_train_totals,
              "engine_serving": engine_totals, **slice_totals, **family_train_totals,
              "cluster_training": cluster_totals, "measured_tune": tune_totals,
              "spmd_training": spmd_totals, "compressed_allreduce": comp_totals,
              "zero3_training": zero_totals, "tp_training": tp_totals,
              "ep_training": ep_totals, **family_tp}
    for rec in records:
        rec["launches"] = totals[rec["path"]][rec["name"]]
        print(f"[launches] {rec['name']} on the {rec['path']} path: {rec['launches']}"
              + (f" (timed at the {rec['shape']} shape)" if "shape" in rec else ""))
        if rec["launches"] == 0:
            raise AssertionError(f"{rec['name']} never launched on the {rec['path']} path")
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(card_line())                    # again, beside the numbers at the end
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(rank_main(sys.argv[2:]) if sys.argv[1:2] == ["--rank"] else main())
