#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (``src/repro_torch``) on one
NVIDIA Hopper card.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit:

1. device: a CUDA card must be present; prints its name and power limit;
2. build: compiles the five hand-written kernels from
   ``src/repro_torch/csrc`` with nvcc (sm_90a), all at once;
3. kernels vs plain: each kernel against its plain PyTorch version on the
   card at the path's shapes (clustered_decode: B=4, L=64, Hq=32,
   Hkv=8, Dh=128, C=64, R=256 in bf16, f32 and f32 + softcap 50;
   paged_clustered_decode: the same data as 130 packed rows in a 256-row
   bucket over a pool of 16-position blocks behind a shuffled block
   table, in the same three cases, bit-equal to clustered_decode on every
   real row both with the engine's row groups and one row per block, and
   its window floor ``wlo`` exact;
   distance_argmin: L1 and L2 at N=2^20, D=16, K=64, at N=2^16,
   D=128, K=1,024 and at the quickstart's shapes (4,595 x 12, K=3;
   5,000 x 8, K 2-8), L1 also bit for bit against its sequential twin;
   bitserial_median: ``torch.equal`` on medians and totals at the
   qwen3-4b serve's compaction (1,152 members x 320 points x 128 dims,
   K=64, 16 bits, count weights with zeros) and absorb (288 members,
   K=32) shapes, a blocking admission's (288 members x 2,048 points x 128
   dims, K=64, 16 bits, 0/1 weights below the frontier), the gemma2-27b
   serve's (compaction 1,472 members, absorb 368, admission 368 members x
   8,192 points), qwen2-moe-a2.7b's in 5n (compaction 1,536 members,
   absorb 384, admission 384 members x 2,048 points), phase 4b's (absorb
   2 and compaction 4 members x 24 points x 16 dims, K=8; admission 2
   members x 96 points), the fit's streamed shape (2^20 x 16, K=64, 32
   bits) and the Trainer's straggler median and MAD (8 and 64 step times
   x 1, K=1, 16 bits, no weights), each twice;
   flash_decode: B=4, S=2048, Hq=32, Hkv=8, Dh=128, t=1500, 0 and 2500 in
   bf16, f32 and f32 + softcap 50, and against
   ``attention.decode_attention``; clustered_decode and
   paged_clustered_decode also at gemma2-27b's heads (32 over 16 kv heads,
   query scale 1/12, softcap 50), paged bit-equal to dense, at
   qwen2-moe-a2.7b's heads in 5n (16 over 16 kv heads of 128, bf16: the
   mixed step's 64-token chunk beside 3 decode rows in a 128-row bucket
   and a 4-row decode step, paged bit-equal to dense), at internvl2-76b's
   heads in 5p (64 over 8 kv heads of 128, GQA group 8, the same two
   steps, paged bit-equal to dense), at phase 4b's TINY
   'G' layer in f32 (2 slots, 4 / 2 heads of 16, C=8, R=16 in
   blocks of 4, an 8-token chunk in either slot and a decode-only step:
   within 1e-5 of plain, paged bit-equal to dense), and
   paged_clustered_decode in 5h's quota layout (one centroid of count 0,
   a ring of 2,048 positions in 128 blocks of 16, rows at 96-2,048
   positions) against its plain version and, in f32, exact attention);
   clustered_decode also at 5u's dry-run shape (128 slots, one token, C
   512, R 256, bf16, two bf16 ulps);
4. model agreement: the reduced qwen3 in f32 decodes (mixed and plain
   steps, clustered cache) and prefills (logits at ``last_pos`` and the
   exact B=1 cache) with the same numbers on the card as on the CPU;
4b. recurrent state beside the clustered kernels: the reference's TINY
   'GM' (a 'G' layer and a Mamba2 'M' layer) and 'GR' (an RG-LRU 'R'
   layer) in f32, port weights from seed 0, batch 2, max_seq 96,
   ``KVCompressConfig(n_clusters=8, iters=4, keep_recent=16,
   refresh_every=8)``, TestRecurrentServing's streams: static exact,
   chunked dense (chunk 8), chunked paged (blocks of 4), blocking dense,
   and the swap's 8 requests unpressured (48 blocks) and scheduled (10
   blocks, ``SLOConfig(priority_admission=False)``).  Gates: chunked ==
   static, paged == chunked, blocking == chunked, scheduled == unpressured
   token for token; clustered_decode once an engine step (one 'G' layer)
   in the dense clustered serves and paged_clustered_decode in the paged
   ones, the other never; bitserial_median >= absorbs + compress
   admissions + compactions; preemptions and resumes >= 1;
   state_bytes_recurrent > 0, kv_retired_recurrent 0, pools back to 0;
   every serve also runs on the CPU, and its card tokens must equal the
   CPU's, request for request.  Phase 3 checks B1, B2 and B3 at these
   serves' shapes first;
4c. MoE beside the clustered kernels: the reduced qwen2-moe-a2.7b (2 'G'
   layers, 8 routed experts top-2 and a shared expert) in f32, port
   weights from seed 0, batch 4, max_seq 96, 4 clusters over a ring of
   16, 5 requests of 9-40 prompt tokens: chunked dense, chunked paged and
   blocking dense, on the card and on the CPU.  Gates: card tokens == CPU
   tokens in every mode; the mode's decode kernel launched layers x
   engine steps, the other never; bitserial_median >= absorbs + compress
   admissions + compactions > 0.  Then the metrics reference's battery
   (``telemetry.reference_registry(device="cuda")``, six tiny serves):
   its table must equal the committed ``docs/metrics_torch.md``'s;
4d. MLA, the frontend stub and the encoder-decoder, reduced: the reduced
   deepseek-v3-671b (MLA over a latent cache, one dense layer, then MoE)
   and internvl2-76b (the vision stub's projection, GQA 8 / 2) in f32,
   port weights from seed 0, batch 2, max_seq 64, 4 requests of 12-40
   prompt tokens, served static, blocking over exact KV and blocking under
   ``KVCompressConfig(n_clusters=8, iters=4, keep_recent=16,
   refresh_every=8)`` on the card and on the CPU.  Gates: card tokens ==
   CPU tokens in every mode; deepseek-v3: blocking clustered == blocking
   exact and no kernel launched (the latent stays exact); internvl2's
   clustered serve: clustered_decode layers x engine steps,
   bitserial_median >= absorbs + compress admissions + compactions > 0.
   Then the model entry points: internvl2's ``prefill(frontend_embeds=)``
   and seamless-m4t-medium's ``prefill(enc_embeds=)`` (2 encoder layers,
   2 decoder layers with cross-attention), each with 4 greedy
   ``decode_step``s: logits within 1e-4 of the CPU's, tokens equal;
4e. training, reduced: one ``make_train_step`` step (AdamW at lr 1e-2
   with no warmup, remat, loss chunks of 16) of each of qwen3-4b, gemma2-27b, gemma3-4b,
   mamba2-2.7b, recurrentgemma-9b, deepseek-v3-671b (MTP), qwen2-moe-a2.7b,
   internvl2-76b (frontend) and seamless-m4t-medium (enc-dec) at
   ``get_reduced`` in f32, parameters from seed 0, on a SyntheticLM batch
   of 2 x 64, on the card and on the CPU.  Gates: every MoE layer's expert
   sets equal; the loss and every metric within 1e-5, the gradient norm
   within 1e-4 (relative); each clipped gradient leaf within 1e-4 of its
   largest CPU entry; the updated parameters within 1e-5, but for at
   most 0.1 % that move by at most 2 lr (AdamW's first step moves each
   element by about lr, and a gradient near 0 may take the other sign);
   a skipped update and one gradient leaf 1 % off, planted in the card's
   result, must each fail those gates.  Then
   tests/test_system.py's TINY Trainer on the card: 25 steps, a
   checkpoint every 10, bitserial_median launched 2 x (25 - 7) = 36 times
   (the straggler median and MAD), a crash at step 17 and a resume whose
   parameters are within 1e-5 of the uninterrupted run's, the loss
   falling by 0.2;
5. serve: qwen3-4b at full width (random weights, seed 0, bf16) answers 8
   requests through the continuous engine with chunked admission and a
   clustered KV cache; the clustered_decode launch count must equal
   layers x engine steps, and the memory manager's medians must have run
   bitserial_median (launches >= absorbs + compactions);
5b. paged serve: the same requests through the paged engine
   (``PagedKVConfig(block_size=16)``, packed ragged launches); the
   paged_clustered_decode launch count must equal layers x engine steps,
   bitserial_median gated as in 5, and the pool must recycle blocks and
   drain to zero;
5c. blocking serve: the same requests and weights with ``prefill_chunk=0``
   (the reference's default): one bucket-padded prefill an admission,
   then ``_clusterize`` — ``compress_cache_batched`` for the 5 prompts
   longer than R - refresh = 224, the ring alone for the other 3; no
   absorbs, compactions > 0, clustered_decode launches = layers x engine
   steps, bitserial_median >= compress admissions + compactions,
   0 < prefill_pad_frac < 1; token agreement with phase 5 is printed, not
   gated;
5d. paged blocking serve: phase 5c's gates with paged_clustered_decode,
   plus phase 5b's pool gates; agreement with 5c printed, not gated;
5e. static serve: ``engine="static"`` with exact KV, the 8 requests at
   batch 4 (left-padded prefill, plain decode attention): well-formed
   tokens and no kernel launch, as in the reference;
5v. mesh serve: a one-rank NCCL world (a file store in a temporary
   directory, no network) and ``make_serving_mesh("1x1")``; phase 5's
   requests on phase 5's weights through the mesh engine
   (``ServerConfig(mesh=...)``), chunked dense (**Cut**: its chunked
   paged serve, for the smoke's time; 5y serves paged through the mesh),
   the decode kernel launched through the head island (its heads' block,
   an ``all_gather`` over the model group) and each step's tokens
   gathered over the data group.  Gates: the backend is nccl and the
   world 1; the tokens equal 5's request for request; clustered_decode
   launched layers x engine steps and paged_clustered_decode never;
   bitserial_median >= absorbs + compactions > 0.  One card holds one NCCL rank, so the
   multi-rank parity of the mesh engine is held on the CPU (gloo,
   tests/test_torch_sharded_serving.py);
5h. quota serve: the 8 requests through paged exact KV under
   QuotaRetention (no ``kv_compress``, blocking admission, blocks of 16,
   a pool one block short of the two largest reservations): every request
   complete, refused reservations > 0 (admissions deferred),
   ``kv_retired_quota`` > 0, ``kv_retired_frontier`` 0, ``pool_blocks_end``
   0, ``pool_occupancy_peak`` <= 1, paged_clustered_decode launched layers
   x engine steps, clustered_decode and bitserial_median 0; agreement with
   5e printed, not gated;
5i. prefix sharing: 8 requests, each a 1,024-token template (from
   ``default_rng(0)``) plus a unique suffix of 8-60 tokens, 40-72 new
   tokens each, served paged and chunked (blocks of 16, the slots' 64)
   twice in turns: unshared, then with
   ``prefix_share=PrefixShareConfig(max_entries=1)``.  Gates: tokens
   equal the unshared serve's, prefix_hits >= 1 and prefix_tokens_reused
   = 1,024 x prefix_hits, fewer prefill chunks than unshared,
   kv_shared_blocks and kv_bytes_saved > 0, pool_blocks_end 0 and allocs
   = frees in both, and each serve's paged_clustered_decode = layers x
   engine steps, clustered_decode 0, bitserial_median >= absorbs +
   compactions;
5j. template store: one Server with
   ``template_store=TemplateStoreConfig(max_entries=2)`` over a pool of 96
   blocks serves two bursts of the template (suffixes from
   ``default_rng(1)`` and ``(2)``).  Gates: after burst 1 pinned blocks >
   0 and the pool holds exactly the pins; burst 2's tokens equal a cold
   Server's (no store), it hits the store and feeds fewer prefill chunks
   than burst 1; template_hits_total is the sum of both serves'
   prefix_hits; pool_blocks_end 0 after each serve; invalidate_templates()
   drains the pool; the kernel gates of 5i for all three serves.  Each
   Server's construction is timed (the store's epoch hashes the weights'
   8 GB);
5k. SLO scheduler: 16 requests from ``default_rng(3)`` (prompts of
   96-1,024 tokens, 40-72 new tokens; uids 12-15 priority 1, at the FIFO
   tail), paged and chunked in arrival order, served (a) over the slots'
   64 blocks without a scheduler, then (b) over 40 blocks with
   ``scheduler=SLOConfig(priority_admission=False)`` and
   ``telemetry=TelemetryConfig(trace=True)``.  Gates on (b): no
   PoolExhausted; sched_preemptions >= 1, sched_swaps_in >= 1,
   sched_shed_high 0; every protected request complete and unshed; every
   unshed request's tokens equal (a)'s; paged_clustered_decode = layers x
   engine steps, clustered_decode 0, bitserial_median >= absorbs +
   compactions (in (a) too); pool_frees == pool_allocs and
   pool_blocks_end 0; ``validate_trace`` against last_stats clean, and
   the swap_out and resume spans equal sched_swaps_out and
   sched_swaps_in.  Printed: every sched_* counter, the swap bytes peak,
   the re-adopted and re-uploaded blocks, ``phase_breakdown``, TTFT p50 /
   p95 by class in (a) and (b); the Chrome trace goes to
   ``chiprun_out/slo_trace.json``.  Then one slot of a full-width paged
   cache (random contents, 3 slots over 40 blocks of 16) is swapped to
   the host and back into another slot's fresh blocks
   (``tests/_torch_swap.py``): its state and bytes bit for bit, the
   re-adopted block and every other block unchanged;
5y. prefix sharing, the template store and the SLO scheduler on the mesh:
   right after 5k, on phase 5's weights, through the one-rank NCCL mesh
   of 5v: (a) 5j's two templated bursts through one mesh Server with
   ``TemplateStoreConfig(max_entries=2)`` over 5j's 96 blocks, then
   ``invalidate_templates()``; (b) 5k's oversubscribed stream over 40
   blocks with ``SLOConfig(priority_admission=False)``, traced.  A
   one-rank mesh is the one-card schedule, so the gates are 5j's and 5k
   (b)'s records: each burst's tokens and its counters (prefix hits,
   tokens reused, pinned blocks, entries, prefill chunks) equal 5j's, the
   pool drains to 0 after invalidation; (b)'s tokens, shed flags and
   sched_* counters equal 5k (b)'s, and its trace validates; each serve's
   paged_clustered_decode = layers x engine steps, clustered_decode 0,
   bitserial_median >= absorbs + compactions.  Printed: wall and ITL p50
   against 5j's / 5k's, the store Server's construction (the weights'
   digest, gathered over the world) and the collectives a step.  The
   swap payload's move between data shards, steering and the deadline
   verdict are held on the CPU (gloo, tests/test_torch_sharded_slo.py,
   tests/test_torch_sharded_prefix.py);
5s. the serving CLI (``repro_torch.launch.serve``) on qwen3-4b at full
   width and depth: (a) ``--arch qwen3-4b --requests 16 --kv-clusters
   32`` in a subprocess (``PYTHONPATH=src``, the module run as ``python
   -m`` runs it, through ``runpy.run_module``, its own weights from seed
   0; blocking clustered at the CLI's defaults: batch 4, max_seq 256, 8
   new tokens), whose launch counts and last_stats a bootstrap prints
   after the CLI's lines; gates: rc 0, ``16 completions, 128 tokens``,
   the reference's lines in its order, clustered_decode 36 x engine
   steps, paged_clustered_decode 0, bitserial_median >= compress
   admissions + compactions > 0.  (b) ``main([...,
   "--paged", "--prefill-chunk", "16", "--priority-demo", "--trace-out",
   "chiprun_out/serve_cli_trace.json"], params=<phase 5's weights>)``:
   ``SLOConfig()`` at its default ``priority_admission=True``; gates:
   paged_clustered_decode 36 x engine steps, clustered_decode 0,
   bitserial_median >= absorbs + compactions, sched_shed_high 0, every
   unshed request complete, pool_blocks_end 0, the written trace clean
   under ``validate_chrome_file``; printed: preemptions, deferrals, TTFT
   p95 by class.  (c) ``main([..., "--paged", "--prefill-chunk", "16",
   "--persist-templates"], params=...)``: the warm re-serve prints
   ``tokens identical: True`` with store hits > 0, each serve's kernel
   gates as (b)'s, the pool at 0 after ``invalidate_templates()``;
5t. the example twin, ``examples/serve_clustered_kv_torch.py``'s
   ``run("cuda")`` at its own shapes (SMALL, 'GL', 'GM' in f32, weights
   from seeds 0, 1, 2): no line reads DIVERGED, ``schema problems: 0``,
   ``0 protected shed``, every pool at 0 at drain, the CPU run's 23
   lines, the ``[kv]`` rel-err within 0.005 of the CPU run's (an int
   seed draws the same weights on both), and clustered_decode,
   paged_clustered_decode and bitserial_median each launched;
5u. the dry run's qwen3-4b x decode_32k cell in kv_mode "clustered"
   (``repro_torch.launch.dryrun.run_cell(..., device="cuda",
   params=...)``) at full width and depth on phase 5's weights: 128
   slots at position 32,767, C 512 + R 256 entries a kv head (every
   centroid counted, the ring full), 2 warm steps and 10 timed.  Gates:
   clustered_decode launched 36 times a step (and 36 in the meta count);
   the measured step no shorter than the ideal (params and cache read
   once at the card's HBM rate); the peak allocation within 10 % of the
   predicted device bytes; every logit finite; the same cell in exact KV
   (618 GB of cache) counted on meta reads ``fits_80gb`` false.  Printed:
   the three terms, the ideal, the measured step, the fraction, the
   peak, and one step under torch.profiler (the host's enqueue time, the
   device's busy time and idle share);
5r. qwen3-4b training at full width and depth on the same bf16 weights:
   the port's Trainer for 10 steps of 2 x 1,024 tokens (AdamW lr 3e-4,
   warmup 2, remat, loss chunks of 256, f32 moments), a checkpoint of
   step 10 in the reference's format in a fresh temporary directory
   (removed after; the depth is cut if its disk cannot hold the 40.2 GB,
   never the save), then 2 steps with k-means codebook gradient
   compression.  Gates: losses and gradient norms finite; batch 0's loss
   falls by ``TRAIN5R_MARGIN`` (a planted step at lr 0 first does not
   move it); bitserial_median launched 2 x (10 - 7) = 6 times;
   ``latest_step`` 10 and meta.json listing every parameter and moment
   leaf.  Printed: seconds a step, launches, peak memory, the
   checkpoint's bytes and seconds.  Then qwen3's weights are freed;
5z. 5r's training through a one-rank NCCL mesh, after 5r has freed its
   state: 5r's starting weights drawn again (the same card generator and
   seed, cut to 5r's depth), the mesh Trainer (``launch.steps.
   lower_step`` on the (data=1, model=1) mesh: the blocks placed by
   ``rules.place_train_state``, each leaf gathered through
   ``rules.GatherLeaf``) for 5r's 10 steps on 5r's batches, its final
   checkpoint through ``ckpt.save_gathered`` in a fresh temporary
   directory (removed after).  Gates: every step's loss and gradient norm
   equal to 5r's within ``TRAIN5Z_RTOL`` = 1e-6 relative (on one rank
   every collective is an identity, so bit for bit is expected; the
   differences are printed); bitserial_median launched 6 times;
   ``latest_step`` 10 and meta.json listing every parameter and moment
   leaf; batch 0's loss falls by ``TRAIN5R_MARGIN``.  Printed: seconds a
   step, peak memory against 5r's, the collectives a step (the leaves
   gathered and reduced; NCCL calls issued, 0 on one rank), the save's
   bytes and seconds;
5f. gemma2-27b at full width and depth (46 layers 'LG', window 4,096,
   d_model 4608, 32/16 heads of 128, d_ff 36864, vocab 256000; bf16
   weights from ``init_params`` seed 0, 54.5 GB), ``max_seq`` 8,192,
   batch 4, blocking admission, the same KVCompressConfig: 6 requests,
   three prompts past the window (4,352-6,144) and three of 256-3,072,
   48-80 new tokens each: ``kv_retired_window`` and
   ``kv_retired_frontier`` > 0, clustered_decode launched 'G' layers (23)
   x engine steps and paged_clustered_decode 0, bitserial_median >=
   compress admissions + compactions; the peak of
   ``torch.cuda.max_memory_allocated()`` printed;
5g. the same paged (``PagedKVConfig(block_size=16)``): paged_clustered_
   decode 23 x engine steps, clustered_decode 0, ``pool_frees ==
   pool_allocs``, ``pool_blocks_end`` 0; agreement with 5f printed, not
   gated;
5l. recurrentgemma-9b at full width, depth cut from 38 to 3 layers
   (one 'RRL' repeat: 2 RG-LRU 'R' layers of width 4,096 and 1 'L'
   layer, window 2,048; 5l's host-bound serves scale with depth, ~6-7 s
   a layer on a slow host, where the whole smoke took 995 s at 38 layers,
   949 s at 21 and ~1,000 s at 6; d_model
   4,096, 16 heads over 1 kv head of 256, d_ff 12,288, vocab 256,000;
   bf16 weights from ``init_params`` seed 0, the gate weights f32),
   ``max_seq`` 4,096, batch 4, the smoke's KVCompressConfig (inert: no
   'G' layer), 4 requests from ``default_rng(5)`` (a 2,112-token prompt
   past the window and three of 96-128, 24-40 new tokens): chunked dense
   (chunk 64), chunked paged (blocks of 16) and blocking dense (a
   sequential prefill, bucket 1).  Gates: every request complete;
   kv_retired_window > 0, kv_retired_recurrent 0; state_bytes_recurrent
   4 x (3 x 4,096 x 2 + 4,096 x 4) = 163,840 B a slot; B1, B2 and B3
   never launched; paged: frees == allocs, end 0.  Printed: chunked vs
   blocking and paged vs dense agreement, the host dispatches (non-view
   aten ops) and wall of one mixed and one decode step, peak memory;
5m. mamba2-2.7b at full width, depth cut to 16 of its 64 'M' layers
   (``MAMBA_LAYERS``; d_model 2,560,
   d_state 128, expand 2, 80 heads of 64, vocab 50,280; bf16 weights from
   seed 0), ``max_seq`` 2,048, batch 4, 4 requests from
   ``default_rng(6)`` (prompts of 96-128, 24-40 new tokens): chunked dense
   and blocking dense; the paged construction must raise the reference's
   "ring-family" ValueError.  Gates: every request complete; B1, B2 and
   B3 never launched; state_bytes_recurrent 16 x (3 x 5,376 x 2 + 80 x
   64 x 128 x 4) = 42,459,136 B a slot; blocking tokens == chunked
   tokens on all 4 requests (every launch steps a recurrent column at the
   slot count).  Printed as in 5l;
5n. qwen2-moe-a2.7b at full width and depth (24 'G' layers, d_model
   2,048, 16 / 16 heads of 128, each FFN a MoE of 60 routed experts of
   1,408, top-4 softmax, and a shared expert of 5,632; vocab 151,936
   untied; bf16 weights from seed 0, the routers f32; 14.3 B
   parameters), ``max_seq`` 2,048, batch 4, chunk 64, the smoke's
   KVCompressConfig, 4 requests from ``default_rng(7)`` (prompts of
   96-768 tokens, 24-40 new tokens): chunked dense, chunked paged (blocks
   of 16) and blocking dense.  First one full-width MoE layer on (4, 64,
   2,048) bf16 rows against the CPU (in f32 on the same weights): routes
   equal but near-ties, y within 2^-5 of its largest magnitude.  Gates:
   every request complete; clustered_decode 24 x engine steps in the
   dense serves, paged_clustered_decode in the paged one, the other
   never; bitserial_median >= absorbs + compress admissions +
   compactions > 0 in every serve; paged frees == allocs, end 0.
   Printed: chunked vs blocking and paged vs dense agreement (a MoE
   launch's capacity drops depend on its other rows), each serve's steps,
   wall and tokens sha256, the host dispatches and wall of one mixed and
   one decode step, peak memory;
5w. MoE on the mesh: 5n's requests on 5n's weights through the mesh
   engine of a one-rank NCCL world (5v's), chunked dense at 5n's
   ServerConfig (**Cut**: its chunked paged serve, for the smoke's time;
   the reduced qwen2-moe serves paged through a one-rank mesh in
   tests/test_torch_gpu.py).  Gates: tokens equal 5n's chunked serve
   request for request (one data shard: 5n's capacities);
   clustered_decode launched 24 x engine steps through the head island
   and paged_clustered_decode never; bitserial_median >= absorbs +
   compactions > 0; the rank holds all 60 experts of every routed bank;
   every MoE call took the mesh's sharded dispatch.  Printed: wall, ITL
   p50, the MoE branch counts and the rank's parameter and expert
   bytes.  One card
   holds one NCCL rank: expert parallelism across ranks, and the a2a
   dispatch, are held on the CPU (gloo, tests/test_torch_sharded_moe.py)
   and by ``benchmarks/mesh_serve_torch.py --arch`` on four cards;
5o. deepseek-v3-671b at full width (d_model 7,168, 128 heads, MLA with
   q_lora 1,536, kv_lora 512, rope 64; 256 routed experts of 2,048 top-8
   sigmoid and a shared expert; vocab 129,280 untied) with its depth cut
   to 5 of 61 layers (the 3 dense layers of d_ff 18,432 and 2 MoE layers;
   no MTP module): bf16 weights from seed 0, the routers f32, ~53 GB;
   ``max_seq`` 4,096, batch 4, 4 requests from ``default_rng(8)``
   (prompts of 256-2,048 tokens, 24-40 new tokens): static, blocking over
   exact KV and blocking under the smoke's KVCompressConfig.  Gates:
   every request complete; B1, B2 and B3 never launched and no absorb
   (the latent stays exact, as in the reference; a compaction pass that
   finds nothing to cluster still counts in ``kv_compactions``, as in
   the reference); blocking clustered tokens == blocking exact tokens.
   Printed: each serve's steps, wall and tokens sha256, static vs
   blocking agreement, the host dispatches and wall of one decode step,
   peak memory;
5x. MLA on the mesh: 2 of 5o's 4 requests (**Cut**, for the smoke's
   time) on 5o's weights through the one-rank
   NCCL mesh, blocking under the smoke's KVCompressConfig (the latent
   over slots only, decoded in full; the config's ``impl="a2a"`` with 256
   routed experts on one rank takes the sharded fallback).  Gates: tokens
   equal 5o's blocking clustered serve's for those requests; B1, B2 and
   B3 never launched;
   the a2a branch never taken, the fallback taken.  Printed: wall, ITL
   p50 and the MoE branch counts;
5p. internvl2-76b at full width (d_model 8,192, 64 query heads over 8 kv
   heads of 128, d_ff 28,672, vocab 128,256 untied, the vision stub's
   projection) with its depth cut to 36 of 80 layers, bf16 weights from
   seed 0, 65.95 GB; ``max_seq`` 2,048, batch 4, the smoke's
   KVCompressConfig, 4 requests from ``default_rng(9)`` (prompts of
   96-1,536 tokens, 24-40 new tokens), text-only: blocking clustered,
   then static.  Gates: every request complete; clustered_decode 36 x
   engine steps and paged_clustered_decode 0 in the blocking serve,
   bitserial_median >= absorbs + compress admissions + compactions > 0;
   no kernel in the static one.  Then the vision stub's entry points on
   an exact cache: ``prefill(frontend_embeds=(4, 64, 8,192))`` over 64
   text tokens and 16 greedy ``decode_step``s, each step held against a
   fresh prefill over the same tokens (``decode_vs_prefill``'s gates,
   among them planted faults that must read above the bound);
5q. seamless-m4t-medium at full width and depth (12 encoder and 12
   decoder layers, d_model 1,024, 16 heads of 64, vocab 256,206 tied),
   bf16 from seed 0: ``prefill(enc_embeds=(4, 853, 1,024))`` (853 frames
   drawn from 256-1,024 by ``default_rng(10)``) over 32-token decoder
   prompts and 32 greedy ``decode_step``s, ``max_seq`` 128.  Gates:
   every logit finite, the cross caches bit-identical before and after
   the steps, and ``decode_vs_prefill``'s gates;
6. clustering: ``clustering.fit`` at its default, L1 medians, k=64 on
   2^20 x 16 points from a threefry k-means++ start: both of its kernels,
   distance_argmin (assignment) and bitserial_median (median update),
   must launch; then the paper's pipeline of
   ``examples/quickstart_torch.py`` on the card at the table generators'
   default sizes (wine_like 4,595 rows, census_like 5,000);
7. times: per kernel, the median over 50 launches of its own device time
   (torch.profiler's CUDA activity, L2 flushed before each launch) beside
   the wrapper call's CUDA-event time, its plain version, a library
   yardstick (device time too) and the card's bound; clustered_decode in
   its mixed, serve-like mixed (chunk_len [64, 1, 1, 1]) and one-token
   forms and one-token at 5u's shape (128 slots, C 512),
   paged_clustered_decode mixed, decode-only and in 5h's quota
   layout (SDPA over each row's gathered entries), distance_argmin
   in L1 at the fit's shape and L2 at the quickstart's k sweep (5,000 x
   8, K=5), one row each in the kernels line with its ``shape``, and L2
   at the fit's shape too (``torch.cdist`` then ``.min(1)`` as the
   yardstick); and the k-medians fit's time per
   iteration beside distance_argmin's share of it.

It imports ``repro_torch`` only (5k's round trip is
``tests/_torch_swap.py``, which does too).  The second-to-last line is the kernels
JSON, ``{"kernels": [{"name": ..., ...}, ...]}`` with one object per
kernel (``chiprun_out/chip_smoke.json`` keys the same objects by name;
B1's and B2's carry ``launches_windowed`` from 5f / 5g, B2's
``launches_quota`` from 5h and its quota form's times under ``quota``,
B2's and B3's ``launches_prefix_share`` from 5i's shared serve,
``launches_template_store`` from 5j's two store serves,
``launches_slo`` from 5k's scheduled serve, ``launches_recurrent``
from 4b's chunked serves, by pattern, ``launches_moe`` from 5n's
serves, by mode, B1's and B3's ``launches_frontend`` from 5p's
blocking serve, and B1's, B2's and B3's ``launches_cli`` from 5s, by
part, ``launches_example`` from 5t, B1's and B3's ``launches_mesh``
from 5v, B2's and B3's ``launches_mesh_store`` (its two serves) and
``launches_mesh_slo`` from 5y, and B1's and B3's ``launches_mesh_moe``
from 5w; B1's
``launches_dryrun_per_step`` from 5u and its times at 5u's shape under
``dryrun``),
and the last line ``{"ok": true, "device": {...}}``; the full record goes
to ``chiprun_out/chip_smoke.json``.  Each phase's seconds are printed as
it ends.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out"

# serving path shapes of qwen3-4b under the smoke's ServerConfig
B, L, HQ, HKV, DH, C, R = 4, 64, 32, 8, 128, 64, 256
T_SLOTS = [100, 1000, 300, 50]       # unwrapped, wrapped, wrapped, unwrapped
CL_SLOTS = [64, 64, 1, 1]            # two chunks in flight, two decode rows
CL_SERVE = [64, 1, 1, 1]             # the engine's mixed step: one chunk
COV_SLOTS = [0, 900, 60, 10]         # cov >= t + chunk_len - R everywhere
BS = 16                              # paged: positions per pool block
N_BUCKET = 256                       # paged: row bucket of the 130 rows
QWEN_GEO = dict(b=B, l=L, dh=DH, c=C, r=R, t=T_SLOTS, cov=COV_SLOTS,
                cl=CL_SLOTS)
# 4b's TINY 'GM' / 'GR' 'G' layer as its serves hand it to the kernels
# (batch 2, chunks of 8, 4 / 2 heads of 16, query scale 1/4, no softcap,
# C 8 over a ring of R 16, blocks of 4, buckets up to 16 rows): a wrapped
# slot and an unwrapped one, each taking the chunk in turn
REC_HQ, REC_HKV, REC_BS, REC_BUCKET = 4, 2, 4, 16
REC_GEO = dict(b=2, l=8, dh=16, c=8, r=16, t=[40, 9], cov=[32, 4],
               cl=[8, 1])
# 4b's bitserial_median calls (1 'G' layer, 2 kv heads): an absorb (one
# slot's 2 heads) and a compaction (2 slots x 2 heads) over C + R = 24
# points, K = C; a blocking admission's fit over max_seq 96 points of the
# longest prompt (60 tokens), refresh 8
REC_MED_CASES = [("4b absorb", 2, 8, 16), ("4b compaction", 4, 8, 16)]
REC_ADMISSION = ("4b admission", 1, 2, 96, 60)
REC_REFRESH = 8
N_PTS, D_PTS, K_PTS = 1 << 20, 16, 64
# distance_argmin in the quickstart: the wine table's two fits (4,595 x 12,
# K = 3) and the census table's k sweep (5,000 x 8, K 2-8); L2 is timed at
# the sweep's true k
DA_QUICKSTART = [(4595, 12, 3)] + [(5000, 8, k) for k in range(2, 9)]
DA_L2_TIMED = (5000, 8, 5)
# gemma2-27b's attention (5f, 5g): 32 query heads over 16 kv heads of 128,
# query scale (4608 / 32)^-0.5, logit softcap 50; 23 of its 46 layers are
# 'G' (clustered), and it serves at max_seq 8,192
GEMMA_HQ, GEMMA_HKV, GEMMA_SCALE, GEMMA_CAP = 32, 16, 144 ** -0.5, 50.0
GEMMA_G_LAYERS, GEMMA_MAX_SEQ = 23, 8192
# qwen2-moe-a2.7b's attention (5n): 24 'G' layers of 16 query heads over 16
# kv heads of 128 (GQA group 1), query scale 128^-0.5, no softcap; its
# engine's mixed step is one 64-token chunk beside 3 decode rows (67 packed
# rows in a 128-row bucket), its decode-only step 4 rows
MOE_HQ, MOE_HKV, MOE_LAYERS = 16, 16, 24
MOE_STEPS = [(CL_SERVE, 128), ([1, 1, 1, 1], 4)]
# internvl2-76b's attention (5p): 36 'G' layers (depth cut from 80) of 64
# query heads over 8 kv heads of 128 (GQA group 8), query scale 128^-0.5,
# no softcap, the same engine steps; its compactions (36 x 4 x 8 members)
# and blocking admissions (36 x 8 members x 2,048 points) are qwen3-4b's
# bitserial_median shapes
IVL_HQ, IVL_HKV, IVL_LAYERS = 64, 8, 36
# bitserial_median members of the serve's memory manager over C + R points:
# a compaction clusters (layers x 4 slots x kv heads) at once, an absorb
# (layers x kv heads) of one slot into the prompt budget; qwen3-4b's 36
# layers of 8 kv heads, then gemma2-27b's 23 'G' layers of 16
N_LAYERS = 36
MED_CASES = [("compaction", N_LAYERS * B * HKV, C, 16),
             ("absorb", N_LAYERS * HKV, C // 2, 16),
             ("gemma2 compaction", GEMMA_G_LAYERS * B * GEMMA_HKV, C, 16),
             ("gemma2 absorb", GEMMA_G_LAYERS * GEMMA_HKV, C // 2, 16),
             ("qwen2-moe compaction", MOE_LAYERS * B * MOE_HKV, C, 16),
             ("qwen2-moe absorb", MOE_LAYERS * MOE_HKV, C // 2, 16)]
# the serving CLI in 5s at its defaults with --kv-clusters 32 (qwen3-4b,
# batch 4, max_seq 256, prompts of at most 159 tokens, C 32 over a ring of
# R 64, refresh 32, chunks of 16, paged blocks of 16): two slots whose ring
# has wrapped (t + cl > R) and two whose ring has not, cov >= t + cl - R;
# every step form: a chunk in an unwrapped slot, a chunk in a wrapped one,
# two chunks, decode rows only, each in its power-of-two row bucket.  Its
# bitserial_median calls: an absorb (one slot, K = the prompt budget C),
# a compaction (4 slots) over C + R = 96 points, and the blocking
# admission's fit over max_seq points of the longest prompt
CLI_C, CLI_R, CLI_MAX_SEQ, CLI_PLEN, CLI_REFRESH = 32, 64, 256, 159, 32
CLI_GEO = dict(b=B, l=16, dh=DH, c=CLI_C, r=CLI_R, t=[40, 150, 96, 10],
               cov=[0, 110, 48, 0], cl=[16, 1, 1, 1])
CLI_STEPS = [([16, 1, 1, 1], 32), ([1, 16, 1, 1], 32),
             ([1, 1, 16, 16], 64), ([1, 1, 1, 1], 4)]
CLI_MED_CASES = [("CLI absorb", N_LAYERS * HKV, CLI_C, 16),
                 ("CLI compaction", N_LAYERS * B * HKV, CLI_C, 16)]
CLI_ADMISSION = ("CLI admission", N_LAYERS, HKV, CLI_MAX_SEQ, CLI_PLEN)
# the dry run's qwen3-4b x decode_32k cell in kv_mode "clustered" (5u):
# 128 slots decoding one token each at C 512 + R 256 entries a kv head
# (StepOptions' defaults), the served slots near position 32,767; phase 3
# holds B1 there with wrapped rings, some ring entries behind the frontier
DRY_ARCH, DRY_SHAPE, DRY_SLOTS, DRY_C, DRY_SEQ = (
    "qwen3-4b", "decode_32k", 128, 512, 32768)
DRY_T = [DRY_SEQ - 1 - (7 * b) % 300 for b in range(DRY_SLOTS)]
DRY_GEO = dict(b=DRY_SLOTS, l=1, dh=DH, c=DRY_C, r=R, t=DRY_T,
               cov=[t + 1 - R + 10 * (b % 3) for b, t in enumerate(DRY_T)],
               cl=[1] * DRY_SLOTS)
# 5u's gates: peak allocation at most this over the predicted device bytes
DRY_PEAK_SLACK = 1.10
# bitserial_median at a blocking admission's clustering: _clusterize fits
# the B=1 prefill cache of every clustered layer at once, (layers x kv
# heads) members of max_seq points each, weight 1 below the frontier cov of
# the longest prompt (plen - (R - refresh)) and 0 on the tail and the pad;
# qwen3-4b's longest prompt is 1,321 (5c, 5d), gemma2-27b's comes from
# gemma2_lengths (5f, 5g)
ADM_S, ADM_PLEN = 2048, 1321
ADM_COV = ADM_PLEN - (R - 32)
# flash_decode: qwen3-4b under the smoke's max_seq, t not a chunk multiple;
# phase 3 also checks t = 0 (all masked) and t > S
FD_S, FD_T = 2048, 1500
FD_TS = (FD_T, 0, FD_S + 452)
# tokens sha256 of both serves while each decode kernel's block walked all
# C + R entries alone (before the warps split them), printed beside this
# run's: the new reduction order may move a greedy token
SHA_ONE_WALK = "5d59b931804a1476"
# 5h's quota layout (qwen3-4b, max_seq 2,048, blocks of BS): one dead
# centroid (count 0) and a ring of Q_R positions, T = Q_R / BS blocks a
# row; the checked and timed decode rows sit at Q_POS, from a short ring to
# a full one, and each slot maps the blocks of Q_AHEAD positions beyond
# its row, as a reservation does
Q_R, Q_AHEAD = 2048, 64
Q_POS = [1536, 2047, 95, 700]
# 5i / 5j's templated bursts: TPL_N requests sharing one TPL_LEN-token
# template; 5j's pool holds the slots' 4 x 16 blocks and a surplus for the
# store's pins, as the reference's template_store_bench sizes its pool
TPL_LEN, TPL_N, TPL_POOL = 1024, 8, 96
# 5k's oversubscribed stream: SLO_N requests, the last SLO_HIGH of them
# priority 1 at the FIFO tail, served over SLO_POOL blocks (62.5 % of the
# slots' 4 x 16, the reference slo_bench's 10 of 16); the full-width swap
# round trip takes a pool of SWAP_POOL blocks over 3 slots
SLO_N, SLO_HIGH, SLO_POOL, SWAP_POOL = 16, 4, 40, 40


def say(*a):
    print(*a, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, n=50, warm=5):
    """Median CUDA-event time of ``n`` calls after ``warm`` warm-ups: the
    whole call, host work of a wrapper included (``call_ms``)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return float(np.median(times))


#: device-kernel names of this repository's CUDA sources (namespace
#: repro), demangled or mangled
REPRO_KERNELS = ("repro::", "5repro")
FLUSH_BYTES = 64 << 20               # more than the H100's 50 MB of L2


def _device_activities(prof):
    """(name, start ns, duration ns) of every device activity the
    profiler recorded, in start order."""
    from torch.autograd import DeviceType

    acts = [(e.name(), e.start_ns(), e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA]
    return sorted(acts, key=lambda a: a[1])


_FLUSH_NAMES: set = set()
_FLUSH: list = []


def _flush_fn(torch):
    """The L2 flush, an f64 fill of one 64 MB buffer kept for the process:
    the fill's kernel (its vector width) follows the buffer's alignment, so
    a new buffer per call could launch a kernel of another name than the
    one ``_flush_names`` read."""
    if not _FLUSH:
        buf = torch.empty(FLUSH_BYTES // 8, dtype=torch.float64,
                          device="cuda")
        _FLUSH.append(lambda: buf.fill_(1.0))
    return _FLUSH[0]


def _flush_names(torch, flush, probes=8, tries=5):
    """Names of the device activities of ``flush``, read once from a trace
    of ``probes`` flushes and kept: CUPTI may drop a trace's first
    activity, so a trace of one flush can come back empty."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        if _FLUSH_NAMES:
            break
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(probes):
                flush()
            torch.cuda.synchronize()
        acts = _device_activities(prof)
        # every flush is one kernel of one name: keep a name only if it
        # ran at least probes - 1 times (the first may be dropped)
        names = [a[0] for a in acts]
        _FLUSH_NAMES.update(x for x in set(names)
                            if names.count(x) >= probes - 1)
    if not _FLUSH_NAMES:
        raise AssertionError(f"device_ms: no flush activity in {tries} "
                             f"traces of {probes} flushes")
    return _FLUSH_NAMES


def device_ms(torch, fn, match=None, n=50, warm=5, tries=5):
    """Median over ``n`` calls of ``fn`` of the device time of one call,
    read from torch.profiler's CUDA activity: the summed durations of the
    call's kernels whose name contains ``match`` (a string or a tuple of
    strings), or of all the call's device activities when ``match`` is
    None.  Before each call an f64 fill of 64 MB leaves L2 cold, as each
    layer's attention finds it in the serve; the fill separates the calls
    in the trace and is not counted.  Two more calls than ``n`` run
    under the profiler, and the last ``n`` count.  CUPTI may drop
    activities from a trace: a call that lost its flush merges with its
    neighbour, one that lost a kernel comes up short, so only the calls
    with the usual number of counted kernels are kept; a trace that keeps
    fewer than ``n // 2`` of them is taken again, up to ``tries``
    traces."""
    from torch.profiler import ProfilerActivity, profile

    if isinstance(match, str):
        match = (match,)
    flush = _flush_fn(torch)
    flush_names = _flush_names(torch, flush)
    for _ in range(warm):
        flush()
        fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n + 2):
                flush()
                fn()
            torch.cuda.synchronize()
        calls = []                # [device ns, kernels counted]
        for name, _, dur in _device_activities(prof):
            if name in flush_names:
                calls.append([0, 0])
            elif calls and (match is None or any(m in name for m in match)):
                calls[-1][0] += dur
                calls[-1][1] += 1
        # the first calls of a trace may lose an activity: the last n
        calls = calls[-n:]
        counts = [c[1] for c in calls if c[1]]
        usual = max(set(counts), key=counts.count) if counts else 0
        kept = [c[0] for c in calls if c[1] == usual and c[0] > 0]
        if usual and len(kept) >= n // 2:
            return float(np.median(kept)) / 1e6
        if not calls:             # no flush recognised: read its name again
            _FLUSH_NAMES.clear()
            flush_names = _flush_names(torch, flush)
    seen = sorted({a[0][:60] for a in _device_activities(prof)})
    raise AssertionError(
        f"device_ms: {len(calls)} calls of {n} separated in the trace, "
        f"{len(kept)} with the usual {usual} counted kernels (match "
        f"{match}), {tries} traces; flush {sorted(flush_names)}, seen "
        f"{seen}")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def decode_inputs(torch, dev, dtype, hq=HQ, hkv=HKV, geo=None):
    """B1's inputs at qwen3-4b's serve shapes, or at ``geo``'s (REC_GEO:
    4b's TINY 'G' layer) with its chunk lengths ``cl``."""
    geo = geo or QWEN_GEO
    b, lw, dh, c, r = geo["b"], geo["l"], geo["dh"], geo["c"], geo["r"]
    g = torch.Generator(device="cpu").manual_seed(0)
    rnd = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    counts = torch.randint(0, 5, (b, c, hkv), generator=g).float()
    return dict(
        q=rnd(b, lw, hq, dh).to(dev, dtype),
        k_cents=rnd(b, c, hkv, dh).to(dev, dtype),
        v_cents=rnd(b, c, hkv, dh).to(dev, dtype),
        counts=counts.to(dev),                  # ~20% empty clusters
        k_tail=rnd(b, r, hkv, dh).to(dev, dtype),
        v_tail=rnd(b, r, hkv, dh).to(dev, dtype),
        t=torch.tensor(geo["t"], dtype=torch.int32, device=dev),
        cov=torch.tensor(geo["cov"], dtype=torch.int32, device=dev),
        chunk_len=torch.tensor(geo["cl"], dtype=torch.int32, device=dev))


def check_clustered_decode(torch, cd, dev):
    """bf16 (vs plain in f32 cast to bf16, 2 bf16 ulps), f32 and f32 with
    softcap 50 (1e-5); valid rows only."""
    max_err = 0.0
    cases = [("bf16", torch.bfloat16, None, 1.6e-2),
             ("f32", torch.float32, None, 1e-5),
             ("f32_softcap50", torch.float32, 50.0, 1e-5)]
    for name, dtype, cap, tol in cases:
        x = decode_inputs(torch, dev, dtype)
        got = cd.clustered_decode_cuda(**x, scale=DH ** -0.5, softcap=cap)
        f32 = {k: (v.float() if v.is_floating_point() else v)
               for k, v in x.items()}
        want = cd.clustered_decode_plain(**f32, scale=DH ** -0.5,
                                         softcap=cap).to(dtype)
        # the one-token decode form on the same cache
        x1 = dict(x, q=x["q"][:, 0].contiguous(), chunk_len=None)
        got1 = cd.clustered_decode_cuda(**x1, scale=DH ** -0.5, softcap=cap)
        want1 = cd.clustered_decode_plain(
            **dict(f32, q=f32["q"][:, 0], chunk_len=None), scale=DH ** -0.5,
            softcap=cap).to(dtype)
        torch.cuda.synchronize()
        for b in range(B):
            n = CL_SLOTS[b]
            torch.testing.assert_close(got[b, :n].float(),
                                       want[b, :n].float(), rtol=tol,
                                       atol=tol)
            max_err = max(max_err, (got[b, :n].float()
                                    - want[b, :n].float()).abs().max().item())
        torch.testing.assert_close(got1.float(), want1.float(), rtol=tol,
                                   atol=tol)
        max_err = max(max_err, (got1.float() - want1.float()).abs().max()
                      .item())
        say(f"clustered_decode {name}: kernel == plain within {tol} "
            f"(max abs err so far {max_err:.3e})")
    return max_err


def check_dryrun_decode(torch, cd, dev):
    """B1 at the dry-run cell's shape (``DRY_GEO``: 128 slots, C 512, R
    256, one token, qwen3-4b's heads) in bf16, against its plain version
    in f32 cast to bf16, within phase 3's two bf16 ulps."""
    x = decode_inputs(torch, dev, torch.bfloat16, geo=DRY_GEO)
    x = dict(x, q=x["q"][:, 0].contiguous(), chunk_len=None)
    got = cd.clustered_decode_cuda(**x, scale=DH ** -0.5)
    f32 = {k: (v.float() if torch.is_tensor(v) and v.is_floating_point()
               else v) for k, v in x.items()}
    want = cd.clustered_decode_plain(**f32, scale=DH ** -0.5).to(
        torch.bfloat16)
    torch.cuda.synchronize()
    tol = 1.6e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    err = (got.float() - want.float()).abs().max().item()
    say(f"clustered_decode at the dry run's shape (B {DRY_SLOTS}, C "
        f"{DRY_C}, R {R}, one token, bf16): kernel == plain within {tol} "
        f"(max abs err {err:.3e})")
    return err


def paged_inputs(torch, x, cl, bucket, seed=1, bs=BS):
    """The dense kernel's inputs ``x`` as packed paged rows: each slot's
    live ring blocks (positions in [cov, t + cl)) scattered through a
    shuffled block table into a pool of ``bs``-position blocks; unmapped
    entries point at the base block 0, which holds non-zero garbage, as
    ``BlockPool.table_for_read`` maps them; one row per (slot, chunk row
    i < cl[slot]), padded to ``bucket`` rows on slot 0 with qpos1 0.
    Returns (kernel args, rows, mapped block count)."""
    from repro_torch.runtime.kv_pool import live_blocks

    dev = x["q"].device
    nsl, r, hkv, dh = x["k_tail"].shape
    hq = x["q"].shape[-2]
    ts, covs = x["t"].tolist(), x["cov"].tolist()
    nt = r // bs
    g = torch.Generator(device="cpu").manual_seed(seed)
    mapped = [(b, bi) for b in range(nsl)
              for bi in live_blocks(ts[b] + cl[b], covs[b], r, bs)]
    nb = 1 + len(mapped) + 8                    # base + mapped + spares
    ids = (1 + torch.randperm(nb - 1, generator=g)[:len(mapped)]).tolist()
    table = torch.zeros(nsl, nt, dtype=torch.int32)
    pools = {}
    for key in ("k_tail", "v_tail"):
        pool = torch.randn(nb, bs, hkv, dh, generator=g).to(dev, x[key].dtype)
        blocks = x[key].reshape(nsl, nt, bs, hkv, dh)
        for (b, bi), gid in zip(mapped, ids):
            pool[gid] = blocks[b, bi]
            table[b, bi] = gid
        pools[key] = pool
    rows = [(b, i) for b in range(nsl) for i in range(cl[b])]
    vec = torch.zeros(4, bucket, dtype=torch.int32)   # slot, qpos1, tw, cov
    for k, (b, i) in enumerate(rows):
        vec[:, k] = torch.tensor([b, ts[b] + i + 1, ts[b] + cl[b], covs[b]])
    vec = vec.to(dev)
    q = torch.zeros(bucket, hq, dh, dtype=x["q"].dtype, device=dev)
    q[:len(rows)] = x["q"][[b for b, _ in rows], [i for _, i in rows]]
    args = dict(q=q, k_cents=x["k_cents"], v_cents=x["v_cents"],
                counts=x["counts"], k_pool=pools["k_tail"],
                v_pool=pools["v_tail"], row_slot=vec[0].contiguous(),
                row_bt=table.to(dev)[vec[0].long()].contiguous(),
                qpos1=vec[1].contiguous(), tw=vec[2].contiguous(),
                cov=vec[3].contiguous())
    return args, rows, len(mapped)


def sha16(t):
    """First 16 hex digits of the sha256 of a tensor's bytes."""
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]


def bits(torch, t):
    """A float tensor's bit patterns, for exact comparison (-0 != +0)."""
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def check_paged_decode(torch, cd, pcd, dev):
    """paged_clustered_decode on B1's phase-3 data: against its plain
    version (same cases and tolerances as B1), bit for bit against B1 on
    every real row, and (f32) the window floor: (cov, wlo) equals
    (max(cov, wlo), 0) exactly and masks more than cov alone."""
    max_err = 0.0
    cases = [("bf16", torch.bfloat16, None, 1.6e-2),
             ("f32", torch.float32, None, 1e-5),
             ("f32_softcap50", torch.float32, 50.0, 1e-5)]
    for name, dtype, cap, tol in cases:
        x = decode_inputs(torch, dev, dtype)
        args, rows, n_mapped = paged_inputs(torch, x, CL_SLOTS, N_BUCKET)
        args = with_groups(torch, pcd, args)
        kw = dict(scale=DH ** -0.5, softcap=cap)
        got = pcd.paged_clustered_decode_cuda(**args, **kw)
        alone = pcd.paged_clustered_decode_cuda(
            **dict(args, row_group=None), **kw)       # one row per block
        f32 = {k: (v.float() if v.is_floating_point() else v)
               for k, v in args.items()}
        want = pcd.paged_clustered_decode_plain(**f32, **kw).to(dtype)
        dense = cd.clustered_decode_cuda(**x, **kw)
        torch.cuda.synchronize()
        n = len(rows)
        torch.testing.assert_close(got[:n].float(), want[:n].float(),
                                   rtol=tol, atol=tol)
        if not torch.isfinite(got).all():
            raise AssertionError(f"paged {name}: non-finite output")
        max_err = max(max_err, (got[:n].float() - want[:n].float()).abs()
                      .max().item())
        ref = dense[[b for b, _ in rows], [i for _, i in rows]]
        for form, out in (("grouped", got), ("one row per block", alone)):
            differ = (bits(torch, out[:n]) != bits(torch, ref)).flatten(
                1).any(1)
            if differ.any():
                raise AssertionError(
                    f"paged {name} ({form}): {int(differ.sum())} of {n} real "
                    "rows differ from clustered_decode bit for bit")
        say(f"paged_clustered_decode {name}: kernel == plain within {tol}; "
            f"all {n} real rows bit-equal to clustered_decode, grouped as "
            "the engine groups them and one row per block "
            f"({n_mapped} mapped blocks of {BS}, {N_BUCKET}-row bucket; "
            f"max abs err so far {max_err:.3e})")
        if name != "f32":
            continue
        cov = args["cov"]
        wlo = torch.zeros_like(cov)
        wlo[0:n:3] = cov[0:n:3] + 37              # above cov
        wlo[1:n:3] = torch.clamp(cov[1:n:3] - 5, min=0)   # below cov
        floor = pcd.paged_clustered_decode_cuda(**args, wlo=wlo, **kw)
        merged = pcd.paged_clustered_decode_cuda(
            **dict(args, cov=torch.maximum(cov, wlo)),
            wlo=torch.zeros_like(wlo), **kw)
        torch.cuda.synchronize()
        if not torch.equal(bits(torch, floor[:n]), bits(torch, merged[:n])):
            raise AssertionError("paged wlo: (cov, wlo) != (max(cov, wlo), "
                                 "0) bit for bit")
        moved = (floor[0:n:3] - got[0:n:3]).abs().amax((1, 2))
        if not (moved > 0).all():
            raise AssertionError("paged wlo: the window floor masked nothing")
        say("paged_clustered_decode f32 window floor: (cov, wlo) == "
            "(max(cov, wlo), 0) bit for bit on every real row")
    return max_err


def check_gemma_decode(torch, cd, pcd, dev):
    """B1 and B2 at the shapes of gemma2-27b's 'G' layers in 5f and 5g: 32
    query heads over 16 kv heads, query scale 1/12, logit softcap 50, on
    phase 3's cache and rows; each against its plain version (bf16: 2 bf16
    ulps, f32: 1e-5) and B2 bit-equal to B1 on every real row."""
    max_err = 0.0
    kw = dict(scale=GEMMA_SCALE, softcap=GEMMA_CAP)
    for name, dtype, tol in (("bf16", torch.bfloat16, 1.6e-2),
                             ("f32", torch.float32, 1e-5)):
        x = decode_inputs(torch, dev, dtype, GEMMA_HQ, GEMMA_HKV)
        args, rows, _ = paged_inputs(torch, x, CL_SLOTS, N_BUCKET)
        args = with_groups(torch, pcd, args)
        fl = lambda d: {k: (v.float() if v.is_floating_point()  # noqa: E731
                            else v) for k, v in d.items()}
        got = cd.clustered_decode_cuda(**x, **kw)
        want = cd.clustered_decode_plain(**fl(x), **kw).to(dtype)
        pg = pcd.paged_clustered_decode_cuda(**args, **kw)
        pw = pcd.paged_clustered_decode_plain(**fl(args), **kw).to(dtype)
        torch.cuda.synchronize()
        n = len(rows)
        sel = ([b for b, _ in rows], [i for _, i in rows])
        for got_r, want_r in ((got[sel], want[sel]), (pg[:n], pw[:n])):
            torch.testing.assert_close(got_r.float(), want_r.float(),
                                       rtol=tol, atol=tol)
            max_err = max(max_err, (got_r.float() - want_r.float()).abs()
                          .max().item())
        if not torch.equal(bits(torch, pg[:n]), bits(torch, got[sel])):
            raise AssertionError(f"gemma2 heads {name}: paged rows differ "
                                 "from clustered_decode bit for bit")
        say(f"gemma2 heads ({GEMMA_HQ}/{GEMMA_HKV}, softcap {GEMMA_CAP:g}) "
            f"{name}: clustered_decode and paged_clustered_decode == plain "
            f"within {tol}, paged bit-equal to dense on all {n} real rows "
            f"(max abs err so far {max_err:.3e})")
    return max_err


def check_moe_decode(torch, cd, pcd, dev, hq=MOE_HQ, hkv=MOE_HKV,
                     label="qwen2-moe", geo=QWEN_GEO, steps=MOE_STEPS):
    """B1 and B2 at the shapes of qwen2-moe-a2.7b's 'G' layers in 5n
    (MOE_STEPS: 16 query heads over 16 kv heads of 128, bf16, qwen3's C,
    R and slots), or at ``hq`` / ``hkv`` heads (internvl2-76b's 64 over 8
    in 5p, GQA group 8): the engine's mixed step (a 64-token chunk in slot
    0 beside 3 decode rows, a 128-row bucket) and a decode-only step (a
    4-row bucket), each against its plain version within phase 3's bf16
    tolerance (2 bf16 ulps), B2 bit-equal to B1 on every real row (grouped
    as the engine groups them and one row per block), and B1's one-token
    form against its plain version.  ``geo`` and ``steps`` give another
    cache and other steps (CLI_GEO, CLI_STEPS: the serving CLI's)."""
    max_err, tol = 0.0, 1.6e-2
    kw = dict(scale=DH ** -0.5, softcap=None)
    fl = lambda d: {k: (v.float() if v is not None  # noqa: E731
                        and v.is_floating_point() else v)
                    for k, v in d.items()}
    for cl, bucket in steps:
        x = decode_inputs(torch, dev, torch.bfloat16, hq, hkv,
                          dict(geo, cl=cl, l=max(cl)))
        args, rows, n_mapped = paged_inputs(torch, x, cl, bucket)
        args = with_groups(torch, pcd, args)
        x1 = dict(x, q=x["q"][:, 0].contiguous(), chunk_len=None)
        got = cd.clustered_decode_cuda(**x, **kw)
        want = cd.clustered_decode_plain(**fl(x), **kw).to(torch.bfloat16)
        got1 = cd.clustered_decode_cuda(**x1, **kw)
        want1 = cd.clustered_decode_plain(**fl(x1), **kw).to(torch.bfloat16)
        pg = pcd.paged_clustered_decode_cuda(**args, **kw)
        alone = pcd.paged_clustered_decode_cuda(**dict(args, row_group=None),
                                                **kw)
        pw = pcd.paged_clustered_decode_plain(**fl(args), **kw).to(
            torch.bfloat16)
        torch.cuda.synchronize()
        n = len(rows)
        sel = ([b for b, _ in rows], [i for _, i in rows])
        for got_r, want_r in ((got[sel], want[sel]), (got1, want1),
                              (pg[:n], pw[:n])):
            torch.testing.assert_close(got_r.float(), want_r.float(),
                                       rtol=tol, atol=tol)
            max_err = max(max_err, (got_r.float() - want_r.float()).abs()
                          .max().item())
        for form, out in (("grouped", pg), ("one row per block", alone)):
            if not torch.equal(bits(torch, out[:n]), bits(torch, got[sel])):
                raise AssertionError(
                    f"{label} heads, chunk lengths {cl} ({form}): paged "
                    "rows differ from clustered_decode bit for bit")
        say(f"{label} heads ({hq}/{hkv} of {DH}, bf16, C {geo['c']}, R "
            f"{geo['r']}, t {geo['t']}, chunk lengths {cl}): clustered_decode (and its one-token form) and "
            f"paged_clustered_decode == plain within {tol}, paged bit-equal "
            f"to dense on all {n} real rows ({n_mapped} mapped blocks of "
            f"{BS}, {bucket}-row bucket; max abs err so far {max_err:.3e})")
    return max_err


def check_rec_tiny_decode(torch, cd, pcd, dev):
    """B1 and B2 at the shapes of 4b's TINY 'G' layer (REC_GEO: 2 slots,
    4 / 2 heads of 16, C 8, a ring of 16 in blocks of 4, query scale 1/4),
    f32: the 8-token chunk in either slot beside the other's decode row
    (a 16-row bucket) and a decode-only step (a 2-row bucket), each
    against its plain version within 1e-5, B2 bit-equal to B1 on every
    real row (grouped as the engine groups them and one row per block),
    and B1's one-token form against its plain version."""
    max_err, tol = 0.0, 1e-5
    kw = dict(scale=REC_GEO["dh"] ** -0.5, softcap=None)
    for cl, bucket in (([8, 1], REC_BUCKET), ([1, 8], REC_BUCKET),
                       ([1, 1], 2)):
        x = decode_inputs(torch, dev, torch.float32, REC_HQ, REC_HKV,
                          dict(REC_GEO, cl=cl))
        args, rows, n_mapped = paged_inputs(torch, x, cl, bucket, bs=REC_BS)
        args = with_groups(torch, pcd, args)
        x1 = dict(x, q=x["q"][:, 0].contiguous(),
                  chunk_len=torch.ones_like(x["chunk_len"]))
        got = cd.clustered_decode_cuda(**x, **kw)
        want = cd.clustered_decode_plain(**x, **kw)
        got1 = cd.clustered_decode_cuda(**x1, **kw)
        want1 = cd.clustered_decode_plain(**x1, **kw)
        pg = pcd.paged_clustered_decode_cuda(**args, **kw)
        alone = pcd.paged_clustered_decode_cuda(**dict(args, row_group=None),
                                                **kw)
        pw = pcd.paged_clustered_decode_plain(**args, **kw)
        torch.cuda.synchronize()
        n = len(rows)
        sel = ([b for b, _ in rows], [i for _, i in rows])
        for got_r, want_r in ((got[sel], want[sel]), (got1, want1),
                              (pg[:n], pw[:n])):
            torch.testing.assert_close(got_r, want_r, rtol=tol, atol=tol)
            max_err = max(max_err, (got_r - want_r).abs().max().item())
        for form, out in (("grouped", pg), ("one row per block", alone)):
            if not torch.equal(bits(torch, out[:n]), bits(torch, got[sel])):
                raise AssertionError(
                    f"4b TINY chunk lengths {cl} ({form}): paged rows differ"
                    " from clustered_decode bit for bit")
        say(f"4b TINY heads ({REC_HQ}/{REC_HKV} of {REC_GEO['dh']}, chunk "
            f"lengths {cl}): clustered_decode (and its one-token form) and "
            f"paged_clustered_decode == plain within {tol}, paged bit-equal "
            f"to dense on all {n} real rows ({n_mapped} mapped blocks of "
            f"{REC_BS}, {bucket}-row bucket; max abs err so far "
            f"{max_err:.3e})")
    return max_err


def quota_inputs(torch, dev, dtype, seed=4):
    """B2's inputs in 5h's quota layout at qwen3-4b's heads: slot b's one
    decode row at position Q_POS[b] (qpos1 = tw = Q_POS[b] + 1, cov 0),
    one centroid of count 0 whose payload is garbage, a ring of Q_R
    positions in Q_R / BS blocks a row, the blocks of positions below
    Q_POS[b] + 1 + Q_AHEAD mapped through a shuffled table and the rest
    at base block 0, which holds garbage.  Returns (kernel args, the
    dense rings (B, Q_R, Hkv, Dh) of k and v, the count of blocks holding
    a position a row can see)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    nt = Q_R // BS
    depth = [min(p + 1 + Q_AHEAD, Q_R) for p in Q_POS]
    mapped = [(b, bi) for b in range(B) for bi in range(-(-depth[b] // BS))]
    nb = 1 + len(mapped) + 8
    ids = (1 + torch.randperm(nb - 1, generator=g)[:len(mapped)]).tolist()
    table = torch.zeros(B, nt, dtype=torch.int32)
    rings, pools = {}, {}
    for key in ("k", "v"):
        pool = torch.randn(nb, BS, HKV, DH, generator=g)
        ring = torch.randn(B, Q_R, HKV, DH, generator=g)
        blocks = ring.reshape(B, nt, BS, HKV, DH)
        for (b, bi), gid in zip(mapped, ids):
            pool[gid] = blocks[b, bi]
            table[b, bi] = gid
        # the ring as the pool holds it: unmapped blocks read block 0
        rings[key] = pool[table.long()].reshape(B, Q_R, HKV, DH).to(dev, dtype)
        pools[key] = pool.to(dev, dtype)
    pos1 = torch.tensor([p + 1 for p in Q_POS], dtype=torch.int32,
                        device=dev)
    args = dict(q=torch.randn(B, HQ, DH, generator=g).to(dev, dtype),
                k_cents=torch.randn(B, 1, HKV, DH, generator=g).to(dev, dtype),
                v_cents=torch.randn(B, 1, HKV, DH, generator=g).to(dev, dtype),
                counts=torch.zeros(B, 1, HKV, device=dev),
                k_pool=pools["k"], v_pool=pools["v"],
                row_slot=torch.arange(B, dtype=torch.int32, device=dev),
                row_bt=table.to(dev).contiguous(), qpos1=pos1,
                tw=pos1.clone(), cov=torch.zeros_like(pos1))
    needed = sum(-(-(p + 1) // BS) for p in Q_POS)
    return args, rings, needed


def check_paged_quota(torch, attention, pcd, dev):
    """B2 in 5h's quota layout (one dead centroid, a ring of Q_R positions
    through Q_R / BS blocks a row): against its plain version (bf16: 2 bf16
    ulps; f32 and f32 with softcap 50: 1e-5), and in f32 against exact
    attention over each row's visible positions
    (``attention.decode_attention`` on the gathered ring): the count-0
    centroid's NEG mask leaves no weight behind."""
    max_err = 0.0
    for name, dtype, cap, tol in (("bf16", torch.bfloat16, None, 1.6e-2),
                                  ("f32", torch.float32, None, 1e-5),
                                  ("f32_softcap50", torch.float32, 50.0,
                                   1e-5)):
        args, rings, _ = quota_inputs(torch, dev, dtype)
        args = with_groups(torch, pcd, args)
        kw = dict(scale=DH ** -0.5, softcap=cap)
        got = pcd.paged_clustered_decode_cuda(**args, **kw)
        f32 = {k: (v.float() if v.is_floating_point() else v)
               for k, v in args.items()}
        want = pcd.paged_clustered_decode_plain(**f32, **kw).to(dtype)
        exact = attention.decode_attention(
            args["q"].float(), rings["k"].float(), rings["v"].float(),
            t=args["qpos1"], **kw).to(dtype)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)
        if dtype == torch.float32:
            torch.testing.assert_close(got, exact, rtol=tol, atol=tol)
        if not torch.isfinite(got).all():
            raise AssertionError(f"quota {name}: non-finite output")
        max_err = max(max_err, (got.float() - want.float()).abs().max()
                      .item())
        say(f"paged_clustered_decode quota {name} (C 1 of count 0, ring "
            f"{Q_R} in {Q_R // BS} blocks of {BS}, rows at {Q_POS}): kernel "
            f"== plain within {tol}"
            + (" and == exact attention" if dtype == torch.float32 else "")
            + f" (max abs err so far {max_err:.3e})")
    return max_err


def da_inputs(torch, dev, n=N_PTS, d=D_PTS, k=K_PTS, seed=0):
    """Points and centroids of the distance_argmin checks and times (the
    fit's shape by default), with centroid 5 a copy of centroid 2 and
    point 0 placed on it where K > 5."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
    c = torch.from_numpy(rng.normal(size=(k, d)).astype(np.float32))
    if k > 5:
        c[5] = c[2]              # duplicated centroid: the first index wins
        x[0] = c[2]
    return x.to(dev), c.to(dev)


def check_distance_argmin(torch, da, dev):
    """Against the plain version at the fit's shape, at a 1,024 x 128 bank
    and at the quickstart's shapes (>= 99.99 % of assignments equal, every
    disagreement a near-tie, mindist within 1e-5, for L2 at D = 128 within
    4 ulps of the largest |x|^2 + |c|^2, where the expansion cancels); L1
    also bit for bit against the sequential twin run on the card."""
    max_err = {"l1": 0.0, "l2": 0.0}
    for n, d, k in [(N_PTS, D_PTS, K_PTS), (1 << 16, 128, 1024),
                    *DA_QUICKSTART]:
        x, c = da_inputs(torch, dev, n, d, k)
        for metric in ("l1", "l2"):
            a, m = da.distance_argmin_cuda(x, c, metric=metric)
            a0, m0 = da.distance_argmin_plain(x, c, metric=metric)
            torch.cuda.synchronize()
            agree = (a == a0).float().mean().item()
            if agree < 0.9999:
                raise AssertionError(f"{metric} {n}x{d}, K {k}: assignments "
                                     f"agree on {agree}")
            diff = torch.nonzero(a != a0)[:, 0]
            if len(diff):
                # a disagreement must be a near-tie of the two distances
                xd = x[diff]
                if metric == "l1":
                    d_k = (xd - c[a[diff].long()]).abs().sum(1)
                    d_p = (xd - c[a0[diff].long()]).abs().sum(1)
                else:
                    d_k = ((xd - c[a[diff].long()]) ** 2).sum(1)
                    d_p = ((xd - c[a0[diff].long()]) ** 2).sum(1)
                torch.testing.assert_close(d_k, d_p, rtol=1e-5, atol=1e-5)
            atol = 1e-5
            if metric == "l2" and d > D_PTS:
                # the expansion cancels: at a point on a centroid its error
                # is ulps of |x|^2 + |c|^2 (~256 at D = 128, ulp 1.5e-5)
                atol = 4 * torch.finfo(torch.float32).eps * float(
                    (x * x).sum(1).max() + (c * c).sum(1).max())
            torch.testing.assert_close(m, m0, rtol=1e-5, atol=atol)
            if k > 5 and (int(a[0]) != 2 or int((a == 5).sum()) != 0):
                raise AssertionError(f"{metric}: duplicated centroid did not "
                                     "resolve to the first index")
            twin = ""
            if metric == "l1":
                a_t, m_t = da.distance_argmin_sequential(x, c, metric="l1")
                if not (torch.equal(a, a_t)
                        and torch.equal(bits(torch, m), bits(torch, m_t))):
                    raise AssertionError(f"l1 {n}x{d}, K {k}: not bit-equal "
                                         "to the sequential twin")
                twin = "; bit-equal to the sequential twin"
                del a_t, m_t
            err = (m - m0).abs().max().item()
            max_err[metric] = max(max_err[metric], err)
            say(f"distance_argmin {metric} {n} x {d}, K {k}: assignments "
                f"agree on {agree * 100:.5f}% ({len(diff)} near-ties), "
                f"mindist max abs err {err:.3e}{twin}")
        del x, c
    return max_err


def median_inputs(torch, dev, m, k, bits, seed=0, c=C, r=R, dh=DH):
    """Words as the memory manager makes them: m members of c + r normal
    keys of dh dims at their 16-bit auto scale; the first c points are
    centroid summaries weighted by counts in [0, 2000) (a fifth empty), the
    r ring points by 0/1 masks; random assignments to k clusters."""
    from repro_torch.core import quantizer

    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(m, c + r, dh, generator=g, device=dev)
    spec = quantizer.FixedPointSpec(
        bits=bits, scale=quantizer.auto_scale(x, bits).unsqueeze(-2))
    u = quantizer.to_unsigned_order(quantizer.quantize(x, spec), bits)
    a = torch.randint(0, k, (m, c + r), generator=g, device=dev,
                      dtype=torch.int32)
    cnt = torch.randint(0, 2000, (m, c), generator=g, device=dev).float()
    cnt = cnt * (torch.rand(m, c, generator=g, device=dev) >= 0.2)
    mask = torch.randint(0, 2, (m, r), generator=g, device=dev).float()
    return u, a, torch.cat([cnt, mask], 1)


def stream_inputs(torch, dev, seed=1):
    """The phase-6 fit's shape: 2^20 x 16 points at 32 bits, k = 64, unit
    weights."""
    from repro_torch.core import quantizer

    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(N_PTS, D_PTS, generator=g, device=dev) * 4.0
    spec = quantizer.FixedPointSpec(bits=32,
                                    scale=quantizer.auto_scale(x, 32))
    u = quantizer.to_unsigned_order(quantizer.quantize(x, spec), 32)
    a = torch.randint(0, K_PTS, (N_PTS,), generator=g, device=dev,
                      dtype=torch.int32)
    return u, a


def admission_inputs(torch, dev, seed=2, layers=N_LAYERS, heads=HKV,
                     s=ADM_S, plen=ADM_PLEN, c=C, r=R, dh=DH, refresh=32):
    """Words as ``_clusterize`` hands them to the median update: (layer,
    head) members of ``s`` keys at the fit's 16-bit scale, taken over the
    weighted points only (the pad past the ``plen``-token prompt is drawn
    8x wider, so its words saturate as the pad tokens' keys may); 0/1
    weights ``pos < plen - (r - refresh)`` broadcast over the heads; random
    assignments to c clusters.  The defaults are qwen3-4b's longest
    prompt."""
    from repro_torch.core import quantizer

    g = torch.Generator(device=dev).manual_seed(seed)
    pos = torch.arange(s, device=dev)
    x = torch.randn(layers, heads, s, dh, generator=g, device=dev)
    x = x * torch.where(pos < plen, 1.0, 8.0)[:, None]
    w = (pos < plen - (r - refresh)).to(torch.float32).expand(layers, heads,
                                                               s)
    spec = quantizer.FixedPointSpec(bits=16, scale=quantizer.auto_scale(
        x * w[..., None], 16).unsqueeze(-2))
    u = quantizer.to_unsigned_order(quantizer.quantize(x, spec), 16)
    a = torch.randint(0, c, (layers, heads, s), generator=g, device=dev,
                      dtype=torch.int32)
    return u, a, w


def admission_cases():
    """(name, layers, kv heads, points, longest prompt) of the blocking
    admissions' fits: qwen3-4b's in 5c / 5d, gemma2-27b's 'G' layers in 5f
    / 5g, qwen2-moe-a2.7b's in 5n's blocking serve."""
    lens, _ = gemma2_lengths(np.random.default_rng(0))
    moe_lens = [r.prompt_len for r in draw_requests(1, **MOE_STREAM)[0]]
    return [("admission", N_LAYERS, HKV, ADM_S, ADM_PLEN),
            ("gemma2 admission", GEMMA_G_LAYERS, GEMMA_HKV, GEMMA_MAX_SEQ,
             int(lens.max())),
            ("qwen2-moe admission", MOE_LAYERS, MOE_HKV, ADM_S,
             max(moe_lens))]


def check_bitserial_median(torch, bsm, dev):
    """Medians and totals bit for bit (``torch.equal``) against the plain
    version: integer weights keep every f32 vote sum exact.  Returns the
    largest absolute difference of median words and totals over all
    cases (0 when they are equal)."""
    max_err = 0.0

    def err(med, tot, med0, tot0):
        return max((med - med0).abs().max().item(),
                   (tot - tot0).abs().max().item())

    geos = {"4b": dict(c=REC_GEO["c"], r=REC_GEO["r"], dh=REC_GEO["dh"]),
            "CLI": dict(c=CLI_C, r=CLI_R, dh=DH)}
    for name, m, k, bits in MED_CASES + REC_MED_CASES + CLI_MED_CASES:
        geo = geos.get(name.split()[0], dict(c=C, r=R, dh=DH))
        u, a, w = median_inputs(torch, dev, m, k, bits, **geo)
        runs = [bsm.grouped_median_bits_cuda(u, a, k, w, bits=bits)
                for _ in range(2)]
        med0, tot0 = bsm.grouped_median_bits_plain(u, a, k, weights=w,
                                                   bits=bits)
        torch.cuda.synchronize()
        for med, tot in runs:
            max_err = max(max_err, err(med, tot, med0, tot0))
            if not (torch.equal(med, med0) and torch.equal(tot, tot0)):
                raise AssertionError(f"bitserial_median {name}: kernel != "
                                     "plain")
        say(f"bitserial_median {name} ({m} members x "
            f"{geo['c'] + geo['r']} points x {geo['dh']} "
            f"dims, K={k}, {bits} bits, count weights): kernel == plain bit "
            "for bit (medians and totals), two runs equal")
        del u, a, w, runs, med0, tot0
    geos = {"4b": dict(geos["4b"], refresh=REC_REFRESH),
            "CLI": dict(geos["CLI"], refresh=CLI_REFRESH)}
    for name, layers, heads, s, plen in (admission_cases()
                                         + [REC_ADMISSION, CLI_ADMISSION]):
        geo = geos.get(name.split()[0], dict(c=C, r=R, dh=DH, refresh=32))
        u, a, w = admission_inputs(torch, dev, layers=layers, heads=heads,
                                   s=s, plen=plen, **geo)
        runs = [bsm.grouped_median_bits_cuda(u, a, geo["c"], w, bits=16)
                for _ in range(2)]
        med0, tot0 = bsm.grouped_median_bits_plain(u, a, geo["c"],
                                                   weights=w, bits=16)
        torch.cuda.synchronize()
        for med, tot in runs:
            max_err = max(max_err, err(med, tot, med0, tot0))
            if not (torch.equal(med, med0) and torch.equal(tot, tot0)):
                raise AssertionError(f"bitserial_median {name}: kernel != "
                                     "plain")
        form = ("resident" if bsm.resident_bytes(s, geo["dh"], geo["c"])
                <= bsm.RESIDENT_MAX_BYTES else "streamed")
        say(f"bitserial_median {name} ({layers} x {heads} members x {s} "
            f"points x {geo['dh']} dims, K={geo['c']}, 16 bits, weights pos "
            f"< {plen - (geo['r'] - geo['refresh'])}, {form} form): kernel "
            "== plain bit for bit (medians and totals), two runs equal")
        del u, a, w, runs, med0, tot0
    u, a = stream_inputs(torch, dev)
    runs = [bsm.grouped_median_bits_cuda(u, a, K_PTS, bits=32)
            for _ in range(2)]
    med0, tot0 = bsm.grouped_median_bits_plain(u, a, K_PTS, bits=32)
    torch.cuda.synchronize()
    for med, tot in runs:
        max_err = max(max_err, err(med, tot, med0, tot0))
        if not (torch.equal(med, med0) and torch.equal(tot, tot0)):
            raise AssertionError("bitserial_median streamed: kernel != plain")
    say(f"bitserial_median streamed ({N_PTS} x {D_PTS}, K={K_PTS}, 32 bits, "
        "unit weights): kernel == plain bit for bit, two runs equal")
    return float(max_err)


def check_trainer_median(torch, bsm, dev):
    """bitserial_median at the Trainer's shapes (phases 4e and 5r): the
    straggler median of 8 and of 64 step times (N x 1 words, K 1, 16 bits,
    no weights), then the MAD's input |times - median|, quantized as
    ``core.bitserial.median`` does; kernel == plain bit for bit, two runs
    equal.  Returns the largest difference (0 when equal)."""
    from repro_torch.core import quantizer

    g = torch.Generator(device="cpu").manual_seed(9)
    max_err = 0.0
    for n in (8, 64):
        times = (0.05 + 0.01 * torch.rand(n, 1, generator=g)).to(dev)
        x = times
        for what in ("median", "MAD"):
            scale = quantizer.auto_scale(x, 16).reshape(1)
            spec = quantizer.FixedPointSpec(bits=16, scale=scale)
            u = quantizer.to_unsigned_order(quantizer.quantize(x, spec), 16)
            a = torch.zeros(n, dtype=torch.int32, device=dev)
            runs = [bsm.grouped_median_bits_cuda(u, a, 1, bits=16)
                    for _ in range(2)]
            med0, tot0 = bsm.grouped_median_bits_plain(u, a, 1, bits=16)
            torch.cuda.synchronize()
            for med, tot in runs:
                max_err = max(max_err, (med - med0).abs().max().item(),
                              (tot - tot0).abs().max().item())
                if not (torch.equal(med, med0) and torch.equal(tot, tot0)):
                    raise AssertionError(f"bitserial_median Trainer {what} "
                                         f"of {n}: kernel != plain")
            say(f"bitserial_median Trainer {what} of {n} step times ({n} x "
                "1 words, K=1, 16 bits, no weights): kernel == plain bit "
                "for bit, two runs equal")
            x = (times - quantizer.dequantize(quantizer.from_unsigned_order(
                med0.reshape(1), 16), spec)).abs()
    return float(max_err)


def decode_cache(torch, dev, dtype, seed=3):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(B, HQ, DH, generator=g, device=dev).to(dtype),
            torch.randn(B, FD_S, HKV, DH, generator=g, device=dev).to(dtype),
            torch.randn(B, FD_S, HKV, DH, generator=g, device=dev).to(dtype))


def bf16_ulp(torch, x):
    """One bf16 ulp of each |x| = m 2^e (m in [0.5, 1)): 2^(e - 8); values
    below 2^-20 take the ulp of 2^-20."""
    _, e = torch.frexp(x.abs().clamp(min=2.0 ** -20))
    return torch.ldexp(torch.ones_like(x), e - 8)


def check_flash_decode(torch, fd, dev):
    """bf16 (vs plain in f32 cast to bf16: within 2 bf16 ulps of each value,
    plus 1e-6 for f32 sums near 0), f32 and f32 with softcap 50 (1e-5);
    each also against decode_attention on the cache; each at t = FD_T and
    at the edges a split rule breaks first, t = 0 (every position masked:
    the mean of v) and t > S (every position visible)."""
    from repro_torch.models import attention

    max_err = 0.0
    cases = [("bf16", torch.bfloat16, None, "2 bf16 ulps"),
             ("f32", torch.float32, None, 1e-5),
             ("f32_softcap50", torch.float32, 50.0, 1e-5)]
    for name, dtype, cap, tol in cases:
        q, k, v = decode_cache(torch, dev, dtype)
        kw = dict(scale=DH ** -0.5, softcap=cap)
        for t in FD_TS:
            got = fd.flash_decode_cuda(q, k, v, t, **kw)
            want = fd.flash_decode_plain(q.float(), k.float(), v.float(), t,
                                         **kw).to(dtype)
            full = attention.decode_attention(q.float(), k.float(),
                                              v.float(), t=t, **kw).to(dtype)
            torch.cuda.synchronize()
            for ref in (want, full):
                g, r = got.float(), ref.float()
                if dtype == torch.bfloat16:
                    over = (g - r).abs() > 2 * bf16_ulp(torch, r) + 1e-6
                    if bool(over.any()):
                        raise AssertionError(
                            f"flash_decode {name} t={t}: {int(over.sum())} "
                            "values beyond 2 bf16 ulps")
                else:
                    torch.testing.assert_close(g, r, rtol=tol, atol=tol)
            max_err = max(max_err, (got.float() - want.float()).abs().max()
                          .item())
        say(f"flash_decode {name}: kernel == plain and == decode_attention "
            f"within {tol} at t = {', '.join(map(str, FD_TS))} (max abs err "
            f"so far {max_err:.3e})")
    return max_err


# ---------------------------------------------------------------------------
# phase 4: the whole model on the card against the CPU, small and f32
# ---------------------------------------------------------------------------


def check_small_model(torch, dev):
    from repro_torch import configs
    from repro_torch.models import transformer as tfm

    cfg = dataclasses.replace(configs.get_reduced("qwen3-4b"),
                              dtype="float32")
    p_cpu = tfm.init_params(0, cfg, device="cpu")
    p_gpu = {"embed": {k: v.to(dev) for k, v in p_cpu["embed"].items()},
             "layers": [{k: {kk: vv.to(dev) for kk, vv in v.items()}
                         for k, v in lp.items()} for lp in p_cpu["layers"]],
             "final_norm": {k: v.to(dev)
                            for k, v in p_cpu["final_norm"].items()}}
    caches = [tfm.init_cache(cfg, 2, 64, kv_mode="clustered", kv_clusters=8,
                             kv_tail=16, device=d) for d in ("cpu", dev)]
    rng = np.random.default_rng(0)
    steps = [((0, 6), (0, 3)), ((6, 6), (3, 6))] + [None] * 4
    t = np.zeros(2, np.int32)
    worst = 0.0
    for step in steps:
        if step is None:
            tok = rng.integers(0, cfg.vocab, size=(2, 1)).astype(np.int32)
            tv, kw = t.copy(), {}
            t += 1
        else:
            tok = rng.integers(0, cfg.vocab, size=(2, 6)).astype(np.int32)
            tv = np.array([s[0] for s in step], np.int32)
            cl = np.array([s[1] for s in step], np.int32)
            kw = {"chunk_len": cl}
            t = tv + cl
        outs = []
        for params, cache, d in ((p_cpu, caches[0], "cpu"),
                                 (p_gpu, caches[1], dev)):
            kwd = {k: torch.from_numpy(v).to(d) for k, v in kw.items()}
            logits, _ = tfm.decode_step(params, cfg, cache,
                                        torch.from_numpy(tok).to(d),
                                        torch.from_numpy(tv).to(d), **kwd)
            outs.append(logits.float().cpu())
        torch.testing.assert_close(outs[1], outs[0], rtol=1e-4, atol=1e-4)
        worst = max(worst, (outs[1] - outs[0]).abs().max().item())
    say(f"reduced qwen3 f32 decode: card == CPU logits (max abs err "
        f"{worst:.3e}) over 2 mixed + 4 decode steps")
    # blocking admission's prefill: a right-padded prompt, logits of its
    # last real position, and the exact B=1 cache padded to max_seq
    tok = rng.integers(0, cfg.vocab, size=(1, 48)).astype(np.int32)
    outs = [tfm.prefill(params, cfg, torch.from_numpy(tok).to(d), max_seq=64,
                        last_pos=37)
            for params, d in ((p_cpu, "cpu"), (p_gpu, dev))]
    torch.testing.assert_close(outs[1][0].cpu(), outs[0][0], rtol=1e-4,
                               atol=1e-4)
    worst = (outs[1][0].cpu() - outs[0][0]).abs().max().item()
    for lc, lg in zip(outs[0][1]["layers"], outs[1][1]["layers"]):
        for key in ("k", "v"):
            torch.testing.assert_close(lg[key].cpu(), lc[key], rtol=1e-4,
                                       atol=1e-4)
            worst = max(worst, (lg[key].cpu() - lc[key]).abs().max().item())
    say(f"reduced qwen3 f32 prefill (48 tokens, last_pos 37): card == CPU "
        f"logits and B=1 cache (max abs err {worst:.3e})")


# ---------------------------------------------------------------------------
# phase 5: serve qwen3-4b
# ---------------------------------------------------------------------------


def serve_workload(torch, dev, paged=None, params=None, chunk=64,
                   engine="continuous", compress=True, mesh=None):
    """The smoke's serve: qwen3-4b at full width (random weights from seed
    0, bf16) behind a clustered-KV Server — paged when ``paged`` is a
    ``PagedKVConfig``, with blocking admission when ``chunk`` is 0, over
    exact KV under a block quota when ``compress`` is False, on the
    serving ``mesh`` when one is given — or, with ``engine="static"``, the
    static engine over exact KV; and 8 requests.  ``params`` reuses weights made by an earlier call.  Returns
    ``(cfg, server, requests, prompts)``; benchmarks/profile_torch_serve.py
    and serve_times.py serve the same workload."""
    from repro_torch import configs
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime.server import Server, ServerConfig

    cfg = configs.get_config("qwen3-4b")           # all 36 layers
    if params is None:
        t0 = time.perf_counter()
        params = tfm.init_params(torch.Generator(device=dev).manual_seed(0),
                                 cfg, device=dev)
        torch.cuda.synchronize()
        say(f"qwen3-4b params ({cfg.n_layers} layers, d_model "
            f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
            f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
            f"{cfg.dtype}) initialised in {time.perf_counter() - t0:.1f} s")
    ccfg = smoke_kv_compress()
    if engine == "static":
        scfg = ServerConfig(batch_size=4, max_seq=2048, engine="static")
    else:
        scfg = ServerConfig(batch_size=4, max_seq=2048, prefill_chunk=chunk,
                            kv_compress=ccfg if compress else None,
                            paged=paged, mesh=mesh)
    srv = Server(cfg, scfg, params, device=dev)
    reqs, prompts = draw_requests(cfg.vocab, **QWEN3_STREAM)
    return cfg, srv, reqs, prompts


def smoke_kv_compress():
    """The clustered KV cache of every qwen3-4b serve of the smoke."""
    from repro_torch.core.kv_compress import KVCompressConfig

    return KVCompressConfig(n_clusters=64, iters=4, bits=16, keep_recent=256,
                            refresh_every=32, prompt_clusters=32)


def draw_requests(vocab, seed, prompt, new=(24, 40), n=4, lead=(),
                  new_last=False):
    """``n`` requests and their prompts from ``default_rng(seed)``: prompt
    lengths ``lead``, then draws from ``prompt`` (lo, hi); new tokens from
    ``new`` (lo, hi), drawn together after the lengths, or with
    ``new_last`` one request at a time after the prompts (the reduced
    models' streams); prompt tokens below ``vocab``."""
    from repro_torch.core.request_cluster import Request

    rng = np.random.default_rng(seed)
    lens = np.concatenate([np.asarray(lead, np.int64), rng.integers(
        prompt[0], prompt[1] + 1, size=n - len(lead))])
    if not new_last:
        gens = rng.integers(new[0], new[1] + 1, size=n)
    prompts = {i: rng.integers(0, vocab, size=int(lens[i])).astype(np.int32)
               for i in range(n)}
    if new_last:
        gens = [rng.integers(new[0], new[1] + 1) for _ in range(n)]
    return [Request(i, int(lens[i]), int(gens[i])) for i in range(n)], prompts


# the streams: qwen3-4b's 8 requests (5, 5c-5e, 5h), recurrentgemma-9b's
# one prompt of 2,112 (past the 2,048 window) beside three of 96-128 (5l;
# cut from 5 of 96-512: a mixed step dispatches ~100k host ops, so a
# serve's wall follows its prompt tokens), mamba2-2.7b's 96-128 (5m;
# narrowed from 96-384 as 5l's are), qwen2-moe-a2.7b's (5n),
# deepseek-v3's (5o) and internvl2's (5p); the reduced qwen2-moe's (4c)
# and the reduced zoo's (4d)
QWEN3_STREAM = dict(seed=0, prompt=(96, 1536), new=(40, 72), n=8)
RG_STREAM = dict(seed=5, prompt=(96, 128), lead=(2112,))
MAMBA_STREAM = dict(seed=6, prompt=(96, 128))
MOE_STREAM = dict(seed=7, prompt=(96, 768))
DSV3_STREAM = dict(seed=8, prompt=(256, 2048))
IVL_STREAM = dict(seed=9, prompt=(96, 1536))
MOE_TINY_STREAM = dict(seed=7, prompt=(9, 40), new=(6, 12), n=5,
                       new_last=True)
ZOO_TINY_STREAM = dict(seed=11, prompt=(12, 40), new=(6, 20),
                       new_last=True)


def check_tokens(cfg, reqs, outs, mode):
    """Every request got its max_new_tokens tokens, all in range."""
    for o in outs:
        want = reqs[o.uid].max_new_tokens
        if len(o.tokens) != want:
            raise AssertionError(f"{mode} uid {o.uid}: {len(o.tokens)} "
                                 f"tokens, want {want}")
        if not all(0 <= t < cfg.padded_vocab for t in o.tokens):
            raise AssertionError(f"{mode} uid {o.uid}: token out of range")


def run_serve(torch, srv, reqs, prompts, mode):
    """One serve, timed to the card's last step: its tokens (each request
    complete and in range), last_stats and kernel launches."""
    from repro_torch.kernels import ops

    ops.reset_launches()
    t0 = time.perf_counter()
    outs = srv.serve(reqs, prompts)
    if srv.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check_tokens(srv.cfg, reqs, outs, mode)
    st = dict(srv.last_stats)
    st.update(srv.last_admission)       # blocking admissions by form
    tokens = {o.uid: list(map(int, o.tokens)) for o in outs}
    digest = hashlib.sha256(json.dumps(tokens, sort_keys=True).encode())
    return {"stats": st, "wall_s": wall, "launches": ops.launch_counts(),
            "engine_steps": int(st.get("decode_steps", 0)),
            "tokens": tokens,
            "tokens_sha256": digest.hexdigest()[:16]}


def serve_qwen3(torch, dev, smi, paged=None, params=None, chunk=64):
    """Serve the workload once, dense or paged, with chunked (``chunk``
    > 0) or blocking admission, and hold it to its gates.  Returns
    (record, params)."""
    cfg, srv, reqs, prompts = serve_workload(torch, dev, paged, params,
                                             chunk)
    lens = np.array([r.prompt_len for r in reqs])
    mode = ("paged" if paged is not None else "dense") + (
        "" if chunk else " blocking")
    rec = run_serve(torch, srv, reqs, prompts, mode)
    st, launches, wall = rec["stats"], rec["launches"], rec["wall_s"]
    ccfg = srv.scfg.kv_compress
    if chunk:
        if not (st["kv_absorbs"] > 0 and st["kv_compactions"] > 0):
            raise AssertionError(f"{mode}: absorbs {st['kv_absorbs']}, "
                                 f"compactions {st['kv_compactions']}: the "
                                 "clustered path did not run")
        need = int(st["kv_absorbs"]) + int(st["kv_compactions"])
        what = "absorbs + compactions"
    else:
        # prompts longer than R - refresh build centroids at admission
        n_comp = int((lens > ccfg.keep_recent - ccfg.refresh).sum())
        got = (int(st["kv_admit_compress"]), int(st["kv_admit_tail"]))
        if got != (n_comp, len(lens) - n_comp):
            raise AssertionError(
                f"{mode}: {got[0]} admissions through "
                f"compress_cache_batched and {got[1]} tail-only, want "
                f"{n_comp} and {len(lens) - n_comp}")
        if not (st["kv_absorbs"] == 0 and st["kv_compactions"] > 0):
            raise AssertionError(f"{mode}: absorbs {st['kv_absorbs']} "
                                 f"(want 0), compactions "
                                 f"{st['kv_compactions']} (want > 0)")
        if not 0.0 < st["prefill_pad_frac"] < 1.0:
            raise AssertionError(f"{mode}: prefill_pad_frac "
                                 f"{st['prefill_pad_frac']}")
        need = n_comp + int(st["kv_compactions"])
        what = "compress admissions + compactions"
    steps = int(st["decode_steps"])
    n_med = launches["bitserial_median"]
    if not (n_med >= need and n_med > 0):
        raise AssertionError(
            f"{mode}: grouped_median_bits launched bitserial_median {n_med} "
            f"times, want >= {what} = {need}: the memory manager's medians "
            "did not run on the kernel")
    kernel, other = (("paged_clustered_decode", "clustered_decode")
                     if paged is not None else
                     ("clustered_decode", "paged_clustered_decode"))
    if launches[kernel] != cfg.n_layers * steps or launches[other] != 0:
        raise AssertionError(
            f"{mode}: {kernel} launched {launches[kernel]} times, want "
            f"layers x steps = {cfg.n_layers} x {steps}; {other} "
            f"{launches[other]}, want 0")
    pool = ""
    if paged is not None:
        allocs, frees = int(st["pool_allocs"]), int(st["pool_frees"])
        peak, end = int(st["pool_blocks_peak"]), int(st["pool_blocks_end"])
        if not (frees == allocs > peak and end == 0):
            raise AssertionError(
                f"paged pool: allocs {allocs}, frees {frees}, peak {peak}, "
                f"end {end}: want frees == allocs > peak and end 0")
        pool = (f"; pool {int(st['pool_blocks_total'])} blocks of "
                f"{paged.block_size}, peak {peak}, {allocs} allocs = "
                f"{frees} frees, end {end}, launch_pad_frac "
                f"{st['launch_pad_frac']:.4f}")
    admit = ("" if chunk else
             f", {int(st['kv_admit_compress'])} compress + "
             f"{int(st['kv_admit_tail'])} tail-only admissions, "
             f"_clusterize {st['clusterize_s']:.3f} s, prefill_pad_frac "
             f"{st['prefill_pad_frac']:.4f}")
    say(f"{mode} serve: 8 requests ({int(lens.sum())} prompt tokens, "
        f"{int(st['gen_tokens'])} generated) in {wall:.1f} s wall; "
        f"{steps} engine steps, {int(st['kv_absorbs'])} absorbs, "
        f"{int(st['kv_compactions'])} compactions{admit}; {kernel} "
        f"launches {launches[kernel]} = {cfg.n_layers} x {steps}{pool}; "
        f"bitserial_median launches {n_med} (>= {need} {what}; "
        f"{n_med / steps:.3f} per engine step); tokens sha256 "
        f"{rec['tokens_sha256']} (one-walk kernels: {SHA_ONE_WALK})")
    say(f"[{smi}] {mode}: wall_s {wall:.3f}  tokens_per_s "
        f"{st['tokens_per_s']:.1f}  tokens_per_s_wall "
        f"{st['tokens_per_s_wall']:.1f}  ttft_p50_ms "
        f"{st['ttft_p50_ms']:.1f}  ttft_p95_ms {st['ttft_p95_ms']:.1f}  "
        f"itl_p50_ms {st['itl_p50_ms']:.2f}  itl_p95_ms "
        f"{st['itl_p95_ms']:.2f}"
        + ("" if chunk else f"  clusterize_s {st['clusterize_s']:.3f}  "
           f"prefill_pad_frac {st['prefill_pad_frac']:.4f}"))
    return dict(rec, n_layers=cfg.n_layers), srv.params


@contextlib.contextmanager
def one_rank_mesh(tag):
    """A one-rank NCCL world (a file store in a temporary directory, no
    network) and its ``make_serving_mesh("1x1")``, torn down on exit;
    raises unless the backend is nccl and the world 1."""
    import datetime
    import shutil
    import tempfile

    import torch.distributed as dist
    from repro_torch.launch.mesh import make_serving_mesh

    tmp = tempfile.mkdtemp(prefix=f"chip_smoke_{tag}_")
    t0 = time.perf_counter()
    dist.init_process_group(
        "nccl", init_method=f"file://{tmp}/store", rank=0, world_size=1,
        timeout=datetime.timedelta(seconds=300))
    try:
        mesh = make_serving_mesh("1x1")
        backend, world = dist.get_backend(), dist.get_world_size()
        say(f"{tag} mesh: backend {backend}, world size {world}, mesh 1x1 "
            f"{tuple(mesh.mesh_dim_names)} over {mesh.device_type}, up in "
            f"{time.perf_counter() - t0:.1f} s")
        if (backend, world) != ("nccl", 1):
            raise AssertionError(f"{tag}: backend {backend} world {world}, "
                                 f"want nccl 1")
        yield mesh
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)


def serve_mesh(torch, dev, smi, params, dense):
    """5v: phase 5's requests on its weights through the mesh engine of a
    one-rank NCCL world, chunked dense, held to 5's gates and its tokens
    (``dense``: 5's record; the paged serve is cut, 5y serves paged
    through the mesh).  Returns the record and one island gather's host
    cost (``island_gather_us``)."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    problems, recs = [], {}
    with one_rank_mesh("5v") as mesh:
        cfg, srv, reqs, prompts = serve_workload(torch, dev, None, params,
                                                 mesh=mesh)
        rec = run_serve(torch, srv, reqs, prompts, "5v mesh dense")
        recs["dense"] = rec
        st, launches = rec["stats"], rec["launches"]
        steps = rec["engine_steps"]
        need = int(st["kv_absorbs"]) + int(st["kv_compactions"])
        if (launches["clustered_decode"] != cfg.n_layers * steps
                or launches["paged_clustered_decode"] != 0):
            problems.append(
                f"clustered_decode {launches['clustered_decode']} (want "
                f"{cfg.n_layers} x {steps}), paged_clustered_decode "
                f"{launches['paged_clustered_decode']} (want 0)")
        if not launches["bitserial_median"] >= need > 0:
            problems.append(
                f"bitserial_median {launches['bitserial_median']}, want >= "
                f"absorbs + compactions = {need} > 0")
        diff = [uid for uid, t in dense["tokens"].items()
                if rec["tokens"][uid] != t]
        if diff:
            problems.append(f"tokens of uids {diff} differ from phase 5's")
        say(f"5v mesh dense serve: {int(st['gen_tokens'])} tokens in "
            f"{rec['wall_s']:.1f} s wall; {steps} engine steps, "
            f"{int(st['kv_absorbs'])} absorbs, "
            f"{int(st['kv_compactions'])} compactions; clustered_decode "
            f"launches {launches['clustered_decode']} = {cfg.n_layers} x "
            f"{steps} through the head island; bitserial_median "
            f"{launches['bitserial_median']}; tokens sha256 "
            f"{rec['tokens_sha256']} (phase 5: {dense['tokens_sha256']}); "
            f"{len(dense['tokens']) - len(diff)} of {len(dense['tokens'])} "
            f"requests equal")
        say(f"[{smi}] 5v mesh dense: wall_s {rec['wall_s']:.3f}  "
            f"tokens_per_s {st['tokens_per_s']:.1f}  ttft_p50_ms "
            f"{st['ttft_p50_ms']:.1f}  itl_p50_ms {st['itl_p50_ms']:.2f}  "
            f"collectives a step: {cfg.n_layers} all_gather (model) + 1 "
            f"all_gather (data)")
        # what one island gather costs: a decode step's (4, 32, 128) bf16
        # head block through the model group's all_gather and cat, 200
        # times, the card synchronised at the end
        group = mesh.get_group("model")
        x = torch.zeros((4, 32, 128), dtype=torch.bfloat16, device=dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(200):
            parts = [torch.empty_like(x)]
            dist.all_gather(parts, x, group=group)
            torch.cat(parts, dim=-2)
        torch.cuda.synchronize()
        gather_us = (time.perf_counter() - t1) / 200 * 1e6
        recs["island_gather_us"] = gather_us
        say(f"[{smi}] 5v island gather: {gather_us:.1f} us a call (host "
            f"clock over 200 calls, synchronised at the end); "
            f"{cfg.n_layers} a step = "
            f"{gather_us * cfg.n_layers / 1e3:.2f} ms")
    say(f"5v mesh wall: {time.perf_counter() - t0:.1f} s")
    if problems:
        raise AssertionError("5v mesh serve: " + "; ".join(problems))
    return recs


def compare_tokens(dense, paged, what="paged vs dense"):
    """How many requests' tokens the second serve shares with the first,
    and where each other request first differs (not gated: the trunk GEMMs
    see other row counts, so cuBLAS may round differently)."""
    first = {}
    for uid, want in dense["tokens"].items():
        got = paged["tokens"][uid]
        diff = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
        if diff:
            first[uid] = diff[0]
    say(f"{what} tokens: {len(dense['tokens']) - len(first)} of "
        f"{len(dense['tokens'])} requests equal"
        + ("" if not first else "; first differing position by uid "
           + json.dumps(first)))
    return first


def serve_static(torch, dev, smi, params):
    """Phase 5e: the static engine over exact KV (the reference's
    baseline): the batcher's batches one at a time, each a left-padded
    prefill then plain decode.  It runs none of the kernels."""
    from repro_torch.kernels import ops

    cfg, srv, reqs, prompts = serve_workload(torch, dev, params=params,
                                             engine="static")
    ops.reset_launches()
    t0 = time.perf_counter()
    outs = srv.serve(reqs, prompts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    check_tokens(cfg, reqs, outs, "static")
    if any(launches.values()):
        raise AssertionError(f"static: kernels launched {launches}, want "
                             "none (static decode is plain attention)")
    tokens = {o.uid: list(map(int, o.tokens)) for o in outs}
    digest = hashlib.sha256(json.dumps(tokens, sort_keys=True).encode())
    st = srv.last_stats
    say(f"[{smi}] static serve: 8 requests at batch 4 in {wall:.3f} s "
        f"wall, plan_waste {st['plan_waste']:.4f}, no kernel launch; "
        f"tokens sha256 {digest.hexdigest()[:16]}")
    return {"wall_s": wall, "stats": st, "launches": launches,
            "tokens": tokens, "tokens_sha256": digest.hexdigest()[:16]}


def serve_quota(torch, dev, smi, params, static):
    """Phase 5h: the 8 requests through paged exact KV under
    QuotaRetention (no kv_compress, blocking admission), with a pool one
    block short of the two largest reservations: every request completes,
    an admission the pool cannot reserve defers (counted where the pool
    refuses it: every ring write was reserved at admission, so only
    admissions are refused), positions retire only at request exit,
    paged_clustered_decode runs every layer of every engine step over the
    one dead centroid and the 2,048-position ring, and nothing clusters
    (clustered_decode and bitserial_median at 0).  Token agreement with
    5e's static engine (exact KV too) is printed, not gated."""
    from repro_torch.core.retention import QuotaRetention
    from repro_torch.kernels import ops
    from repro_torch.runtime import kv_pool

    from repro_torch import configs

    # the quota layout's ring is max_seq (Q_R) positions
    quota = QuotaRetention(BS, Q_R // BS)
    reqs, _ = draw_requests(configs.get_config("qwen3-4b").vocab,
                            **QWEN3_STREAM)
    need = sorted(quota.admit_blocks(min(r.prompt_len, Q_R),
                                     r.max_new_tokens) for r in reqs)
    pool_blocks = need[-1] + need[-2] - 1
    paged = kv_pool.PagedKVConfig(block_size=BS, pool_blocks=pool_blocks)
    cfg, srv, reqs, prompts = serve_workload(torch, dev, paged, params,
                                             chunk=0, compress=False)
    refused = [0]
    ensure = kv_pool.BlockPool.ensure

    def counting_ensure(self, *a, **k):
        try:
            return ensure(self, *a, **k)
        except kv_pool.PoolExhausted:
            refused[0] += 1
            raise

    ops.reset_launches()
    kv_pool.BlockPool.ensure = counting_ensure
    try:
        t0 = time.perf_counter()
        outs = srv.serve(reqs, prompts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        kv_pool.BlockPool.ensure = ensure
    launches = ops.launch_counts()
    st = srv.last_stats
    check_tokens(cfg, reqs, outs, "quota")
    steps = int(st["decode_steps"])
    want = {"paged_clustered_decode": cfg.n_layers * steps,
            "clustered_decode": 0, "bitserial_median": 0}
    got = {k: launches[k] for k in want}
    if got != want:
        raise AssertionError(f"quota: launches {got}, want {want} "
                             f"(layers x steps = {cfg.n_layers} x {steps})")
    if not (st["kv_retired_quota"] > 0 and st["kv_retired_frontier"] == 0
            and st["pool_blocks_end"] == 0
            and st["pool_occupancy_peak"] <= 1.0 and refused[0] > 0):
        raise AssertionError(
            f"quota: kv_retired_quota {st['kv_retired_quota']} (want > 0), "
            f"kv_retired_frontier {st['kv_retired_frontier']} (want 0), "
            f"pool_blocks_end {st['pool_blocks_end']} (want 0), "
            f"pool_occupancy_peak {st['pool_occupancy_peak']} (want <= 1), "
            f"refused reservations {refused[0]} (want > 0)")
    tokens = {o.uid: list(map(int, o.tokens)) for o in outs}
    digest = hashlib.sha256(json.dumps(tokens, sort_keys=True).encode())
    say(f"[{smi}] quota serve: 8 requests in {wall:.3f} s wall, {steps} "
        f"engine steps; pool {pool_blocks} blocks of {BS} (reservations "
        f"{need}, the two largest {need[-1]} + {need[-2]}), peak "
        f"{int(st['pool_blocks_peak'])}, occupancy "
        f"{st['pool_occupancy_peak']:.4f}, {refused[0]} refused "
        f"reservations, kv_retired_quota {int(st['kv_retired_quota'])}, end "
        f"{int(st['pool_blocks_end'])}; paged_clustered_decode launches "
        f"{launches['paged_clustered_decode']} = {cfg.n_layers} x {steps}; "
        f"tokens sha256 {digest.hexdigest()[:16]}; tokens_per_s "
        f"{st['tokens_per_s']:.1f} ttft_p50_ms {st['ttft_p50_ms']:.1f} "
        f"itl_p50_ms {st['itl_p50_ms']:.2f}")
    rec = {"n_layers": cfg.n_layers, "stats": st, "wall_s": wall,
           "launches": launches, "engine_steps": steps,
           "pool_blocks": pool_blocks, "reservations": need,
           "refused_reservations": refused[0], "tokens": tokens,
           "tokens_sha256": digest.hexdigest()[:16]}
    rec["vs_static_first_diff"] = compare_tokens(static, rec,
                                                 "quota vs static (exact KV)")
    return rec


# 5i and 5j: templated bursts (a long shared prompt, short unique
# suffixes), prefix-shared and through the template store


def templated_stream(vocab, sfx_seed=0):
    """TPL_N requests, each the one TPL_LEN-token template plus a unique
    suffix of 8-60 tokens (below one chunk, so the pure-template boundary
    is the longest reusable prefix) and 40-72 new tokens.  From
    ``default_rng(0)``: suffix lengths, budgets, the template (over the
    vocab), then the suffixes; ``sfx_seed`` draws the suffixes and their
    budgets from ``default_rng(sfx_seed)`` instead (the same template).
    Every length is drawn before any token, so the schedule does not
    depend on the vocab."""
    from repro_torch.core.request_cluster import Request

    def lengths(rng):
        return rng.integers(8, 61, size=TPL_N), rng.integers(40, 73,
                                                             size=TPL_N)

    base = np.random.default_rng(0)
    sfx, gens = lengths(base)
    template = base.integers(0, vocab, size=TPL_LEN)
    rng = base
    if sfx_seed:
        rng = np.random.default_rng(sfx_seed)
        sfx, gens = lengths(rng)
    reqs, prompts = [], {}
    for i in range(TPL_N):
        tail = rng.integers(0, vocab, size=int(sfx[i]))
        prompts[i] = np.concatenate([template, tail]).astype(np.int32)
        reqs.append(Request(i, len(prompts[i]), int(gens[i])))
    return reqs, prompts


def templated_server(cfg, params, dev, pool_blocks=0, **kw):
    """A paged chunked Server with the smoke's KV config (5i, 5j):
    ``batch_size=4``, ``max_seq=2048``, ``prefill_chunk=64``, blocks of
    BS (``pool_blocks`` 0: the slots' own 4 x 16), and ``kw`` (prefix
    sharing or the template store)."""
    from repro_torch.runtime.kv_pool import PagedKVConfig
    from repro_torch.runtime.server import Server, ServerConfig

    return Server(cfg, ServerConfig(
        batch_size=4, max_seq=2048, prefill_chunk=64,
        kv_compress=smoke_kv_compress(),
        paged=PagedKVConfig(block_size=BS, pool_blocks=pool_blocks), **kw),
        params, device=dev)


def prefix_share_serves(torch, dev, cfg, params):
    """5i's two serves of the templated stream, in turns: unshared paged,
    then with ``prefix_share=PrefixShareConfig(max_entries=1)`` (the
    reference's single-template setting), both over the slots' own 64
    blocks.  Returns (unshared, shared) records."""
    from repro_torch.runtime.prefix_cache import PrefixShareConfig

    reqs, prompts = templated_stream(cfg.vocab)
    unshared = run_serve(torch, templated_server(cfg, params, dev), reqs,
                         prompts, "5i unshared")
    shared = run_serve(torch, templated_server(
        cfg, params, dev, prefix_share=PrefixShareConfig(max_entries=1)),
        reqs, prompts, "5i prefix-shared")
    return unshared, shared


def template_store_serves(torch, dev, cfg, params):
    """5j: one Server with ``template_store=TemplateStoreConfig(
    max_entries=2)`` over a pool of TPL_POOL blocks serves two bursts of
    the template (suffixes from ``default_rng(1)``, then ``(2)``), then a
    cold Server (no store) serves burst 2; then ``invalidate_templates``.
    Each Server's construction is timed: the store's includes the content
    hash of the weights (its epoch)."""
    from repro_torch.runtime.template_store import TemplateStoreConfig

    t0 = time.perf_counter()
    srv = templated_server(cfg, params, dev, TPL_POOL,
                           template_store=TemplateStoreConfig(max_entries=2))
    init_store_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cold = templated_server(cfg, params, dev, TPL_POOL)
    init_cold_s = time.perf_counter() - t0
    bursts = [templated_stream(cfg.vocab, seed) for seed in (1, 2)]
    first = run_serve(torch, srv, *bursts[0], "5j store serve 1")
    pins = {"pinned": srv._store.pinned_blocks(),
            "allocated": srv._tmpl_pool.allocated()}
    second = run_serve(torch, srv, *bursts[1], "5j store serve 2")
    cold_rec = run_serve(torch, cold, *bursts[1], "5j cold serve 2")
    pool = srv._tmpl_pool
    srv.invalidate_templates()
    return {"serves": [first, second], "cold": cold_rec,
            "after_serve_1": pins, "drained": pool.allocated(),
            "init_store_s": init_store_s, "init_cold_s": init_cold_s}


def paged_launch_gate(cfg, rec, mode):
    """The paged engine's kernels: paged_clustered_decode once a layer an
    engine step, clustered_decode never, bitserial_median at least once
    an absorb and a compaction."""
    st, launches, steps = rec["stats"], rec["launches"], rec["engine_steps"]
    need = int(st["kv_absorbs"]) + int(st["kv_compactions"])
    got = (launches["paged_clustered_decode"], launches["clustered_decode"])
    if (got != (cfg.n_layers * steps, 0)
            or not launches["bitserial_median"] >= need > 0):
        raise AssertionError(
            f"{mode}: paged_clustered_decode {got[0]} (want {cfg.n_layers} "
            f"x {steps}), clustered_decode {got[1]} (want 0), "
            f"bitserial_median {launches['bitserial_median']} (want >= "
            f"absorbs + compactions = {need} > 0)")


def share_line(st):
    return (f"{int(st['prefill_chunks'])} prefill chunks, "
            f"{int(st.get('prefix_hits', 0))} hits, "
            f"{int(st.get('prefix_tokens_reused', 0))} tokens reused, "
            f"kv_shared_blocks {int(st['kv_shared_blocks'])}, kv_bytes_saved "
            f"{int(st['kv_bytes_saved'])}, pool peak "
            f"{int(st['pool_blocks_peak'])} of {int(st['pool_blocks_total'])}"
            f", {int(st['pool_allocs'])} allocs / {int(st['pool_frees'])} "
            f"frees, {int(st['pool_cow'])} copy-on-write, "
            f"{int(st['pool_retains'])} retains, end "
            f"{int(st['pool_blocks_end'])}")


def times_line(rec):
    st = rec["stats"]
    return (f"wall_s {rec['wall_s']:.3f}  engine steps {rec['engine_steps']}"
            f"  ttft_p50_ms {st['ttft_p50_ms']:.1f}  ttft_p95_ms "
            f"{st['ttft_p95_ms']:.1f}  itl_p50_ms {st['itl_p50_ms']:.2f}  "
            f"tokens_per_s {st['tokens_per_s']:.1f}")


def serve_prefix_share(torch, dev, smi, params):
    """Phase 5i: the templated stream unshared, then prefix-shared, with
    its gates (see the module docstring)."""
    from repro_torch import configs

    cfg = configs.get_config("qwen3-4b")
    unshared, shared = prefix_share_serves(torch, dev, cfg, params)
    for mode, rec in (("5i unshared", unshared), ("5i shared", shared)):
        paged_launch_gate(cfg, rec, mode)
        say(f"[{smi}] {mode}: {times_line(rec)}; {share_line(rec['stats'])}"
            f"; tokens sha256 {rec['tokens_sha256']}")
    st, st0 = shared["stats"], unshared["stats"]
    hits = int(st["prefix_hits"])
    problems = []
    if compare_tokens(unshared, shared, "5i shared vs unshared"):
        problems.append("tokens differ from the unshared serve's")
    if hits < 1 or st["prefix_tokens_reused"] != TPL_LEN * hits:
        problems.append(f"{hits} hits reusing {st['prefix_tokens_reused']} "
                        f"tokens, want >= 1 hit of {TPL_LEN} each")
    if not st["prefill_chunks"] < st0["prefill_chunks"]:
        problems.append(f"prefill_chunks {st['prefill_chunks']}, unshared "
                        f"{st0['prefill_chunks']}")
    if not (st["kv_shared_blocks"] > 0 and st["kv_bytes_saved"] > 0):
        problems.append("no block shared")
    for rec in (unshared, shared):
        s = rec["stats"]
        if not (s["pool_blocks_end"] == 0
                and s["pool_allocs"] == s["pool_frees"]):
            problems.append(f"pool end {s['pool_blocks_end']}, allocs "
                            f"{s['pool_allocs']}, frees {s['pool_frees']}")
    if problems:
        raise AssertionError("5i prefix sharing: " + "; ".join(problems))
    return {"unshared": unshared, "shared": shared}


def serve_template_store(torch, dev, smi, params):
    """Phase 5j: two bursts through one Server's template store, a cold
    Server on burst 2, then invalidation, with its gates (see the module
    docstring)."""
    from repro_torch import configs

    cfg = configs.get_config("qwen3-4b")
    rec = template_store_serves(torch, dev, cfg, params)
    (first, second), cold = rec["serves"], rec["cold"]
    for mode, r in (("5j store serve 1", first), ("5j store serve 2", second),
                    ("5j cold serve 2", cold)):
        paged_launch_gate(cfg, r, mode)
        say(f"[{smi}] {mode}: {times_line(r)}; {share_line(r['stats'])}"
            f"; tokens sha256 {r['tokens_sha256']}")
    st1, st2 = first["stats"], second["stats"]
    say(f"[{smi}] 5j Server init: {rec['init_store_s']:.3f} s with the store "
        f"(its epoch hashes the weights' bytes), {rec['init_cold_s']:.3f} s "
        f"without; after serve 1 {rec['after_serve_1']['pinned']} pinned "
        f"blocks, pool allocated {rec['after_serve_1']['allocated']}; "
        f"template_entries {int(st2['template_entries'])}, "
        f"template_hits_total {int(st2['template_hits_total'])}, "
        f"template_clusters {int(st2['template_clusters'])}, "
        f"template_cohesion_mean {st2['template_cohesion_mean']:.4f}; after "
        f"invalidate_templates() the pool holds {rec['drained']} blocks")
    problems = []
    pins = rec["after_serve_1"]
    if not (st1["template_pinned_blocks"] > 0
            and pins["allocated"] == pins["pinned"] > 0):
        problems.append(f"after serve 1: template_pinned_blocks "
                        f"{st1['template_pinned_blocks']}, pool {pins}")
    if compare_tokens(cold, second, "5j warm vs cold (burst 2)"):
        problems.append("the warm serve's tokens differ from the cold's")
    if not (st2["prefix_hits"] > 0
            and st2["prefill_chunks"] < st1["prefill_chunks"]):
        problems.append(f"serve 2: {st2['prefix_hits']} hits, prefill_chunks "
                        f"{st2['prefill_chunks']} against serve 1's "
                        f"{st1['prefill_chunks']}")
    if st2["template_hits_total"] != st1["prefix_hits"] + st2["prefix_hits"]:
        problems.append(f"template_hits_total {st2['template_hits_total']}")
    if st1["pool_blocks_end"] != 0 or st2["pool_blocks_end"] != 0:
        problems.append("pool_blocks_end beyond the pins")
    if rec["drained"] != 0:
        problems.append(f"{rec['drained']} blocks after invalidation")
    if problems:
        raise AssertionError("5j template store: " + "; ".join(problems))
    return rec


# 5k: the SLO scheduler over an oversubscribed pool, traced


def slo_stream(vocab):
    """SLO_N requests from ``default_rng(3)``: prompts of 96-1,024 tokens
    and 40-72 new tokens each (every length drawn before any token, so the
    schedule does not depend on the vocab); the last SLO_HIGH are priority
    1, at the FIFO tail, the slo_bench's worst case for admission blind to
    priority."""
    from repro_torch.core.request_cluster import Request

    rng = np.random.default_rng(3)
    lens = rng.integers(96, 1025, size=SLO_N)
    gens = rng.integers(40, 73, size=SLO_N)
    reqs = [Request(i, int(lens[i]), int(gens[i]),
                    priority=int(i >= SLO_N - SLO_HIGH))
            for i in range(SLO_N)]
    prompts = {i: rng.integers(0, vocab, size=int(lens[i])).astype(np.int32)
               for i in range(SLO_N)}
    return reqs, prompts


def slo_serve(torch, dev, cfg, params, reqs, prompts, scheduled,
              trace_path=None, mesh=None, pool_blocks=SLO_POOL):
    """One serve of ``slo_stream``, paged and chunked in arrival order
    (``use_clustered_batching=False``): over the slots' own 64 blocks with
    no scheduler, untraced, or (``scheduled``) over ``pool_blocks`` blocks
    (a data shard's; SLO_POOL) with
    ``SLOConfig(priority_admission=False)`` (priority acts through
    preemption alone) and ``TelemetryConfig(trace=True)``, its Chrome
    trace written to ``trace_path`` when given; through ``mesh`` when
    given.  Returns its record, with its completions' ``shed`` flags and
    TTFTs and, traced, its trace and ``phase_breakdown``."""
    from repro_torch.kernels import ops
    from repro_torch.runtime.kv_pool import PagedKVConfig
    from repro_torch.runtime.scheduler import SLOConfig
    from repro_torch.runtime.server import Server, ServerConfig
    from repro_torch.runtime.telemetry import (TelemetryConfig,
                                               phase_breakdown)

    kw = {}
    if not scheduled:
        pool_blocks = 0
    else:
        kw = dict(scheduler=SLOConfig(priority_admission=False),
                  telemetry=TelemetryConfig(trace=True))
    srv = Server(cfg, ServerConfig(
        batch_size=4, max_seq=2048, prefill_chunk=64,
        kv_compress=smoke_kv_compress(), use_clustered_batching=False,
        paged=PagedKVConfig(block_size=BS, pool_blocks=pool_blocks),
        mesh=mesh, **kw), params, device=dev)
    ops.reset_launches()
    t0 = time.perf_counter()
    outs = srv.serve(reqs, prompts)
    if srv.device.type == "cuda":
        torch.cuda.synchronize()
    rec = {"wall_s": time.perf_counter() - t0,
           "launches": ops.launch_counts(),
           "stats": dict(srv.last_stats),
           "tokens": {o.uid: list(map(int, o.tokens)) for o in outs},
           "shed": {o.uid: o.shed for o in outs},
           "ttft_ms": {o.uid: o.prefill_ms for o in outs}}
    rec["engine_steps"] = int(rec["stats"]["decode_steps"])
    if srv.tracer is not None:
        rec["trace"] = srv.last_trace
        rec["phases_ms"] = phase_breakdown(srv.last_trace)
        if trace_path is not None:
            srv.export_trace(str(trace_path))
    return rec


def slo_serves(torch, dev, cfg, params, trace_path=None):
    """5k's two serves of ``slo_stream`` (``slo_serve``): (a) unpressured,
    then (b) scheduled and traced.  Returns (requests, a, b)."""
    reqs, prompts = slo_stream(cfg.vocab)
    return (reqs,
            slo_serve(torch, dev, cfg, params, reqs, prompts, False),
            slo_serve(torch, dev, cfg, params, reqs, prompts, True,
                      trace_path))


def ttft_by_class(reqs, rec):
    """TTFT p50 / p95 (ms) of each priority class's unshed requests."""
    out = {}
    for prio in sorted({r.priority for r in reqs}):
        v = [rec["ttft_ms"][r.uid] for r in reqs
             if r.priority == prio and not rec["shed"][r.uid]]
        out[prio] = ((float(np.percentile(v, 50)),
                      float(np.percentile(v, 95))) if v else (0.0, 0.0))
    return out


def serve_slo(torch, dev, smi, params):
    """Phase 5k: the oversubscribed stream unpressured, then scheduled and
    traced, with its gates (see the module docstring); then the swap
    protocol round-trips one slot of qwen3-4b's full-width paged cache
    bit for bit (tests/_torch_swap.py)."""
    from repro_torch import configs
    from repro_torch.runtime.telemetry import validate_trace

    cfg = configs.get_config("qwen3-4b")
    OUT.mkdir(exist_ok=True)
    trace_path = OUT / "slo_trace.json"
    reqs, free, sched = slo_serves(torch, dev, cfg, params, trace_path)
    for mode, rec in (("5k unpressured", free), ("5k scheduled", sched)):
        paged_launch_gate(cfg, rec, mode)
    st = sched["stats"]
    problems = []
    for r in reqs:
        toks = free["tokens"][r.uid]
        if (len(toks) != r.max_new_tokens or free["shed"][r.uid]
                or not all(0 <= t < cfg.padded_vocab for t in toks)):
            problems.append(f"unpressured uid {r.uid}: {len(toks)} tokens "
                            f"(want {r.max_new_tokens}), shed "
                            f"{free['shed'][r.uid]}")
    if not (st["sched_preemptions"] >= 1 and st["sched_swaps_in"] >= 1
            and st["sched_shed_high"] == 0):
        problems.append(f"preemptions {st['sched_preemptions']}, swaps_in "
                        f"{st['sched_swaps_in']}, shed_high "
                        f"{st['sched_shed_high']}")
    for r in reqs:
        toks, shed = sched["tokens"][r.uid], sched["shed"][r.uid]
        if r.priority >= 1 and (shed or len(toks) != r.max_new_tokens):
            problems.append(f"protected uid {r.uid}: {len(toks)} tokens, "
                            f"shed {shed}")
        if not shed and toks != free["tokens"][r.uid]:
            problems.append(f"uid {r.uid}: tokens differ from the "
                            "unpressured serve's")
    if not (st["pool_frees"] == st["pool_allocs"]
            and st["pool_blocks_end"] == 0):
        problems.append(f"pool allocs {st['pool_allocs']}, frees "
                        f"{st['pool_frees']}, end {st['pool_blocks_end']}")
    trace = sched["trace"]
    bad = validate_trace(trace, totals=st)
    if bad:
        problems.append("trace: " + "; ".join(bad[:5]))
    spans = {name: sum(e["name"] == name for e in trace)
             for name in ("swap_out", "resume", "shed", "brownout")}
    if (spans["swap_out"] != st["sched_swaps_out"]
            or spans["resume"] != st["sched_swaps_in"]):
        problems.append(f"spans {spans} against sched_swaps_out "
                        f"{st['sched_swaps_out']}, sched_swaps_in "
                        f"{st['sched_swaps_in']}")
    # kv_bytes_peak_per_shard is the pool's peak blocks x bytes a block
    block_bytes = int(st["kv_bytes_peak_per_shard"]
                      // st["pool_blocks_peak"])
    sched_keys = {k: int(v) for k, v in st.items() if k.startswith("sched_")}
    say(f"[{smi}] 5k scheduled: {times_line(sched)}; {sched_keys}; swap "
        f"bytes peak {int(st['sched_swapped_peak_blocks']) * block_bytes} "
        f"({int(st['sched_swapped_peak_blocks'])} blocks of {block_bytes} "
        f"B); readopted {int(st['sched_readopted_blocks'])}, re-uploaded "
        f"{int(st['sched_reuploaded_blocks'])} blocks; pool peak "
        f"{int(st['pool_blocks_peak'])} of {int(st['pool_blocks_total'])}, "
        f"{int(st['pool_allocs'])} allocs = {int(st['pool_frees'])} frees, "
        f"end {int(st['pool_blocks_end'])}; trace {len(trace)} events "
        f"{spans}, written to chiprun_out/{trace_path.name}")
    say(f"[{smi}] 5k unpressured: {times_line(free)}; pool peak "
        f"{int(free['stats']['pool_blocks_peak'])} of "
        f"{int(free['stats']['pool_blocks_total'])}")
    say(f"[{smi}] 5k phase_breakdown (ms): " + json.dumps(
        {k: round(v, 3) for k, v in sched["phases_ms"].items()}))
    for name, rec in (("unpressured", free), ("scheduled", sched)):
        say(f"[{smi}] 5k {name} TTFT p50 / p95 ms by priority class: "
            + ", ".join(f"class {p}: {a:.1f} / {b:.1f}"
                        for p, (a, b) in ttft_by_class(reqs, rec).items())
            + f"; wall_s {rec['wall_s']:.3f}")
    # the swap protocol on the full-width paged cache (random contents)
    sys.path.insert(0, str(ROOT / "tests"))
    from _torch_swap import swap_round_trip

    t0 = time.perf_counter()
    fresh, readopted, nbytes = swap_round_trip(
        dev, cfg, seed=0, slots=3, blocks=SWAP_POOL, bs=BS, tail=R,
        clusters=C, max_seq=2048)
    torch.cuda.synchronize()
    say(f"[{smi}] 5k full-width swap round trip: {fresh} fresh blocks "
        f"re-uploaded and {readopted} re-adopted, {nbytes} B of host "
        f"payload (snapshot and ring), bit for bit, other blocks unchanged "
        f"({time.perf_counter() - t0:.1f} s)")
    if problems:
        raise AssertionError("5k SLO scheduler: " + "; ".join(problems))
    sched.pop("trace")
    return {"unpressured": free, "scheduled": sched,
            "round_trip": {"fresh": fresh, "readopted": readopted,
                           "bytes": nbytes}}


# 5y: 5j's store bursts and 5k's scheduled stream through the one-rank
# NCCL mesh (5v's), on phase 5's weights

STORE_KEYS = ("prefix_hits", "prefix_tokens_reused", "template_pinned_blocks",
              "template_entries", "prefill_chunks", "pool_blocks_end")
SLO_KEYS = ("sched_preemptions", "sched_swaps_in", "sched_swaps_out",
            "sched_sheds", "sched_shed_high", "sched_deferrals",
            "sched_readopted_blocks", "sched_reuploaded_blocks",
            "pool_blocks_end")


def serve_mesh_runtime(torch, dev, smi, params, store, slo):
    """Phase 5y: (a) 5j's two templated bursts through one mesh Server
    with ``TemplateStoreConfig(max_entries=2)`` over TPL_POOL blocks, then
    ``invalidate_templates()``; (b) 5k's oversubscribed stream scheduled
    and traced over SLO_POOL blocks, both through the one-rank NCCL mesh.
    ``store`` and ``slo`` are 5j's and 5k's records: a one-rank mesh is
    the one-card schedule, so the tokens, the shed flags and the counters
    must equal theirs.  Returns the records."""
    from repro_torch import configs
    from repro_torch.runtime.telemetry import validate_trace
    from repro_torch.runtime.template_store import TemplateStoreConfig

    cfg = configs.get_config("qwen3-4b")
    t0 = time.perf_counter()
    problems, out = [], {}
    with one_rank_mesh("5y") as mesh:
        t1 = time.perf_counter()
        srv = templated_server(
            cfg, params, dev, TPL_POOL, mesh=mesh,
            template_store=TemplateStoreConfig(max_entries=2))
        out["init_store_s"] = time.perf_counter() - t1
        serves = []
        for i, seed in enumerate((1, 2)):
            rec = run_serve(torch, srv, *templated_stream(cfg.vocab, seed),
                            f"5y store serve {i + 1}")
            serves.append(rec)
        pool = srv._tmpl_pool
        srv.invalidate_templates()
        out["store"], out["drained"] = serves, pool.allocated()
        reqs, prompts = slo_stream(cfg.vocab)
        sched = slo_serve(torch, dev, cfg, params, reqs, prompts, True,
                          mesh=mesh)
        out["slo"] = sched
    for i, (rec, want) in enumerate(zip(serves, store["serves"])):
        mode = f"5y store serve {i + 1}"
        paged_launch_gate(cfg, rec, mode)
        if rec["tokens"] != want["tokens"]:
            problems.append(f"{mode}: tokens differ from 5j's")
        got = {k: rec["stats"][k] for k in STORE_KEYS}
        exp = {k: want["stats"][k] for k in STORE_KEYS}
        if got != exp:
            problems.append(f"{mode}: {got}, 5j's {exp}")
        say(f"[{smi}] {mode}: {times_line(rec)} (5j: itl_p50_ms "
            f"{want['stats']['itl_p50_ms']:.2f}, wall_s "
            f"{want['wall_s']:.3f}); {share_line(rec['stats'])}; tokens "
            f"sha256 {rec['tokens_sha256']} (5j: {want['tokens_sha256']})")
    if not serves[1]["stats"]["prefix_hits"] > 0:
        problems.append("store serve 2 did not hit the store")
    if out["drained"] != 0:
        problems.append(f"{out['drained']} blocks after invalidation")
    want = slo["scheduled"]
    paged_launch_gate(cfg, sched, "5y scheduled")
    if sched["tokens"] != want["tokens"] or sched["shed"] != want["shed"]:
        problems.append("5y scheduled: tokens or shed flags differ from "
                        "5k (b)'s")
    got = {k: sched["stats"][k] for k in SLO_KEYS}
    exp = {k: want["stats"][k] for k in SLO_KEYS}
    if got != exp:
        problems.append(f"5y scheduled: {got}, 5k (b)'s {exp}")
    bad = validate_trace(sched["trace"], totals=sched["stats"])
    if bad:
        problems.append("5y trace: " + "; ".join(bad[:5]))
    sched["trace_events"] = len(sched.pop("trace"))
    steps = sum(r["engine_steps"] for r in (*serves, sched))
    say(f"[{smi}] 5y scheduled: {times_line(sched)} (5k (b): itl_p50_ms "
        f"{want['stats']['itl_p50_ms']:.2f}, wall_s {want['wall_s']:.3f}); "
        f"{got}; trace {sched['trace_events']} events, "
        f"{'clean' if not bad else 'NOT clean'}")
    say(f"[{smi}] 5y mesh: store Server init {out['init_store_s']:.3f} s "
        f"(the weights' digest and one all_gather of it over the world); "
        f"collectives a step: {cfg.n_layers} all_gather (model) + 1 "
        f"all_gather (data), {steps} engine steps in all; no swap payload "
        f"moves (one data shard), no deadline broadcast (no deadline set)")
    say(f"5y mesh runtime wall: {time.perf_counter() - t0:.1f} s")
    if problems:
        raise AssertionError("5y mesh runtime: " + "; ".join(problems))
    return out


# 5f and 5g: gemma2-27b at full width and depth, max_seq GEMMA_MAX_SEQ
# (prompts past the 4,096 window), the smoke's KVCompressConfig


def gemma2_workload(torch, dev, paged=None, params=None):
    """gemma2-27b (46 layers, 'LG', window 4,096; bf16 weights from
    ``init_params`` seed 0) behind a clustered-KV Server with blocking
    admission, paged when ``paged`` is a ``PagedKVConfig``; 6 requests
    from ``default_rng(0)``: three prompts in [4352, 6144], so each window
    ring has wrapped at admission, three in [256, 3072], each with 48-80
    new tokens.  Returns ``(cfg, server, requests, prompts)``."""
    from repro_torch import configs
    from repro_torch.core import tree
    from repro_torch.core.kv_compress import KVCompressConfig
    from repro_torch.core.request_cluster import Request
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime.server import Server, ServerConfig

    cfg = configs.get_config("gemma2-27b")
    if params is None:
        t0 = time.perf_counter()
        params = tfm.init_params(torch.Generator(device=dev).manual_seed(0),
                                 cfg, device=dev)
        torch.cuda.synchronize()
        n_bytes = sum(t.numel() * t.element_size()
                      for t in tree.leaves(params))
        say(f"gemma2-27b params ({cfg.n_layers} layers "
            f"'{cfg.layer_pattern}', window {cfg.sliding_window}, d_model "
            f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
            f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
            f"{cfg.dtype}, {n_bytes / 1e9:.2f} GB) initialised in "
            f"{time.perf_counter() - t0:.1f} s")
    ccfg = KVCompressConfig(n_clusters=64, iters=4, bits=16, keep_recent=256,
                            refresh_every=32, prompt_clusters=32)
    srv = Server(cfg, ServerConfig(batch_size=4, max_seq=GEMMA_MAX_SEQ,
                                   kv_compress=ccfg, paged=paged),
                 params, device=dev)
    rng = np.random.default_rng(0)
    lens, gens = gemma2_lengths(rng)
    reqs = [Request(i, int(lens[i]), int(gens[i])) for i in range(6)]
    prompts = {i: rng.integers(0, cfg.vocab, size=int(lens[i]))
               .astype(np.int32) for i in range(6)}
    return cfg, srv, reqs, prompts


def gemma2_lengths(rng):
    """The 6 requests' prompt lengths (three in [4352, 6144], three in
    [256, 3072]) and new tokens (48-80), the first draws from ``rng``."""
    lens = np.concatenate([rng.integers(4352, 6145, size=3),
                           rng.integers(256, 3073, size=3)])
    return lens, rng.integers(48, 81, size=6)


def serve_gemma2(torch, dev, smi, paged=None, params=None):
    """Phases 5f (dense) and 5g (paged): serve gemma2-27b's workload once
    and hold it to its gates: every request complete, both retention
    policies retired positions (windows slid, the coverage frontier
    advanced), the decode kernel of the mode launched once for each of the
    23 'G' layers of every engine step and the other one not at all (the
    'L' layers run plain windowed attention, as in the reference),
    bitserial_median at least once for each compress admission and
    compaction, and (paged) every block back.  Returns (record, params)."""
    from repro_torch.models import transformer as tfm

    cfg, srv, reqs, prompts = gemma2_workload(torch, dev, paged, params)
    mode = "gemma2 " + ("paged" if paged is not None else "dense")
    torch.cuda.reset_peak_memory_stats()
    rec = run_serve(torch, srv, reqs, prompts, mode)
    peak = torch.cuda.max_memory_allocated()
    st, launches, wall = rec["stats"], rec["launches"], rec["wall_s"]
    ccfg = srv.scfg.kv_compress
    lens = np.array([r.prompt_len for r in reqs])
    n_g = tfm.layer_kinds(cfg).count("G")
    steps = int(st["decode_steps"])
    kernel, other = (("paged_clustered_decode", "clustered_decode")
                     if paged is not None else
                     ("clustered_decode", "paged_clustered_decode"))
    if launches[kernel] != n_g * steps or launches[other] != 0:
        raise AssertionError(
            f"{mode}: {kernel} launched {launches[kernel]} times, want 'G' "
            f"layers x steps = {n_g} x {steps}; {other} {launches[other]}, "
            "want 0")
    if not (st["kv_retired_window"] > 0 and st["kv_retired_frontier"] > 0):
        raise AssertionError(
            f"{mode}: kv_retired_window {st['kv_retired_window']}, "
            f"kv_retired_frontier {st['kv_retired_frontier']}: want both "
            "> 0")
    n_comp = int((lens > ccfg.keep_recent - ccfg.refresh).sum())
    if int(st["kv_admit_compress"]) != n_comp:
        raise AssertionError(f"{mode}: {int(st['kv_admit_compress'])} "
                             f"compress admissions, want {n_comp}")
    need = n_comp + int(st["kv_compactions"])
    n_med = launches["bitserial_median"]
    if not (n_med >= need and n_med > 0):
        raise AssertionError(
            f"{mode}: bitserial_median launched {n_med} times, want >= "
            f"compress admissions + compactions = {need}")
    pool = ""
    if paged is not None:
        allocs, frees = int(st["pool_allocs"]), int(st["pool_frees"])
        if not (frees == allocs and int(st["pool_blocks_end"]) == 0):
            raise AssertionError(
                f"{mode} pool: allocs {allocs}, frees {frees}, end "
                f"{int(st['pool_blocks_end'])}: want frees == allocs, end 0")
        pool = (f"; pool peak {int(st['pool_blocks_peak'])} of "
                f"{int(st['pool_blocks_total'])} blocks, {allocs} allocs = "
                f"{frees} frees")
    say(f"[{smi}] {mode} serve: 6 requests (prompts {lens.tolist()}, "
        f"{int(st['gen_tokens'])} generated) in {wall:.3f} s wall; {steps} "
        f"engine steps, {int(st['kv_compactions'])} compactions, "
        f"{int(st['kv_admit_compress'])} compress + "
        f"{int(st['kv_admit_tail'])} tail-only admissions; kv_retired_window "
        f"{int(st['kv_retired_window'])}, kv_retired_frontier "
        f"{int(st['kv_retired_frontier'])}; {kernel} launches "
        f"{launches[kernel]} = {n_g} x {steps}; bitserial_median {n_med} "
        f"(>= {need}){pool}; peak memory allocated {peak / 2**30:.2f} GiB; "
        f"tokens_per_s {st['tokens_per_s']:.1f} ttft_p50_ms "
        f"{st['ttft_p50_ms']:.1f} itl_p50_ms {st['itl_p50_ms']:.2f} "
        f"clusterize_s {st['clusterize_s']:.3f}; tokens sha256 "
        f"{rec['tokens_sha256']}")
    return (dict(rec, n_layers=cfg.n_layers, g_layers=n_g, peak_bytes=peak,
                 max_seq=srv.scfg.max_seq, prompt_lens=lens.tolist()),
            srv.params)


# ---------------------------------------------------------------------------
# phase 4b: the clustered kernels beside recurrent state, TINY 'GM' / 'GR'
# ---------------------------------------------------------------------------

# tests/test_serving_engine.py's TestRecurrentServing: its KVCompressConfig,
# and its swap's pools (48 blocks unpressured, 10 scheduled)
REC_CC = dict(n_clusters=8, iters=4, keep_recent=16, refresh_every=8)
REC_POOL_BIG, REC_POOL_TIGHT = 48, 10


def rec_tiny_cfg(pattern):
    """The reference's pinned GM_REC / GR_REC: f32, 2 layers, d_model 64,
    4 / 2 heads of 16, d_ff 128, vocab 64; Mamba2 d_state 16, d_conv 4,
    expand 2, heads of 32, chunk 32; RG-LRU width 64."""
    from repro_torch.models.config import ModelConfig, SSMConfig

    kw = dict(name=pattern.lower(), family="hybrid", n_layers=2, d_model=64,
              n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab=64,
              pad_vocab_multiple=16, dtype="float32", layer_pattern=pattern)
    if "M" in pattern:
        kw["ssm"] = SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=32,
                              n_groups=1, chunk=32)
    else:
        kw["lru_width"] = 64
    return ModelConfig(**kw)


def rec_tiny_streams():
    """TestRecurrentServing's two streams, copied: ``_rec_stream`` (4
    requests from ``default_rng(9)``) and the swap case's 8 (from
    ``default_rng(3)``, the last three priority 1)."""
    from repro_torch.core.request_cluster import Request

    rng = np.random.default_rng(9)
    spec = [(60, 12), (9, 10), (48, 9), (21, 14)]
    rec = ([Request(i, l, g) for i, (l, g) in enumerate(spec)],
           {i: rng.integers(0, 64, size=(l,)).astype(np.int32)
            for i, (l, _) in enumerate(spec)})
    rng = np.random.default_rng(3)
    reqs, prompts = [], {}
    for i in range(8):
        plen = int(rng.integers(6, 30))
        prompts[i] = rng.integers(0, 64, size=(plen,)).astype(np.int32)
        reqs.append(Request(i, plen, int(rng.integers(6, 14)),
                            priority=1 if i >= 5 else 0))
    return rec, (reqs, prompts)


def rec_tiny_serves(torch, dev, cfg, params):
    """One pattern's 4b serves on ``dev``: static exact, chunked dense,
    chunked paged (blocks of 4), blocking dense on the stream of 4, then
    the swap's stream unpressured (48 blocks) and scheduled (10 blocks,
    ``SLOConfig(priority_admission=False)``).  Returns {name: record}."""
    from repro_torch.core.kv_compress import KVCompressConfig
    from repro_torch.runtime.kv_pool import PagedKVConfig
    from repro_torch.runtime.scheduler import SLOConfig
    from repro_torch.runtime.server import Server, ServerConfig

    (reqs, prompts), (sreqs, sprompts) = rec_tiny_streams()
    ccfg = KVCompressConfig(**REC_CC)
    chunked = dict(batch_size=2, max_seq=96, kv_compress=ccfg,
                   prefill_chunk=8)
    swap = dict(chunked, use_clustered_batching=False)
    serves = {
        "static": (ServerConfig(batch_size=1, max_seq=96, engine="static",
                                use_clustered_batching=False), False),
        "chunked": (ServerConfig(**chunked), False),
        "paged": (ServerConfig(**chunked, paged=PagedKVConfig(block_size=4)),
                  False),
        "blocking": (ServerConfig(batch_size=2, max_seq=96,
                                  kv_compress=ccfg), False),
        "swap unpressured": (ServerConfig(**swap, paged=PagedKVConfig(
            block_size=4, pool_blocks=REC_POOL_BIG)), True),
        "swap scheduled": (ServerConfig(**swap, paged=PagedKVConfig(
            block_size=4, pool_blocks=REC_POOL_TIGHT),
            scheduler=SLOConfig(priority_admission=False)), True),
    }
    out = {}
    for name, (scfg, is_swap) in serves.items():
        srv = Server(cfg, scfg, params, device=dev)
        r, p = (sreqs, sprompts) if is_swap else (reqs, prompts)
        out[name] = run_serve(torch, srv, r, p, f"4b {cfg.layer_pattern} "
                              f"{name}")
    return out


def check_rec_tiny(torch, dev, smi):
    """Phase 4b: 'GM' and 'GR' at TINY width on the card, each serve also
    run on the CPU from the same port weights (seed 0).  Gates on the
    card: chunked == static, paged == chunked, blocking == chunked and the
    scheduled swap == unpressured, token for token; clustered_decode once
    an engine step (one 'G' layer) in every dense clustered serve and
    paged_clustered_decode once a step in every paged one, the other
    never; bitserial_median >= absorbs + compress admissions +
    compactions; at least one preemption and one resume; every serve's
    state_bytes_recurrent > 0 and kv_retired_recurrent 0; every pool back
    to 0; every serve's tokens equal the CPU's run of it (f32 at TINY
    width: the card's and the CPU's GEMMs agree on these tokens)."""
    from repro_torch.models import transformer as tfm

    record = {}
    for pattern in ("GM", "GR"):
        cfg = rec_tiny_cfg(pattern)
        params = tfm.init_params(0, cfg, device="cpu")
        card = rec_tiny_serves(torch, dev, cfg, params)
        cpu = rec_tiny_serves(torch, torch.device("cpu"), cfg, params)
        problems = []
        for a, b in (("chunked", "static"), ("paged", "chunked"),
                     ("blocking", "chunked")):
            if card[a]["tokens"] != card[b]["tokens"]:
                problems.append(f"{a} tokens differ from {b}'s")
        free, sched = card["swap unpressured"], card["swap scheduled"]
        if sched["tokens"] != free["tokens"]:
            problems.append("swap scheduled tokens differ from unpressured")
        st = sched["stats"]
        if not (st["sched_preemptions"] >= 1 and st["sched_swaps_in"] >= 1):
            problems.append(f"preemptions {st['sched_preemptions']}, swaps "
                            f"in {st['sched_swaps_in']}")
        for name, rec in card.items():
            st, ln = rec["stats"], rec["launches"]
            if name == "static":
                if any(ln.values()):
                    problems.append(f"static launched {ln}")
                continue
            steps = rec["engine_steps"]
            kernel, other = (
                ("paged_clustered_decode", "clustered_decode")
                if "pool_blocks_end" in st else
                ("clustered_decode", "paged_clustered_decode"))
            if (ln[kernel], ln[other]) != (steps, 0):
                problems.append(f"{name}: {kernel} {ln[kernel]} (want 1 x "
                                f"{steps}), {other} {ln[other]} (want 0)")
            need = (int(st["kv_absorbs"]) + int(st["kv_compactions"])
                    + int(st.get("kv_admit_compress", 0)))
            if not ln["bitserial_median"] >= need > 0:
                problems.append(f"{name}: bitserial_median "
                                f"{ln['bitserial_median']}, want >= {need}"
                                " > 0")
            if not (st["state_bytes_recurrent"] > 0
                    and st["kv_retired_recurrent"] == 0):
                problems.append(f"{name}: state_bytes_recurrent "
                                f"{st['state_bytes_recurrent']}, "
                                f"kv_retired_recurrent "
                                f"{st['kv_retired_recurrent']}")
            if st.get("pool_blocks_end", 0) != 0:
                problems.append(f"{name}: pool_blocks_end "
                                f"{st['pool_blocks_end']}")
        agree = {name: sum(card[name]["tokens"][u] == cpu[name]["tokens"][u]
                           for u in card[name]["tokens"])
                 for name in card}
        for name, n in agree.items():
            if n != len(card[name]["tokens"]):
                problems.append(f"{name}: card tokens equal the CPU's on {n}"
                                f" of {len(card[name]['tokens'])} requests")
        sched_st = card["swap scheduled"]["stats"]
        say(f"[{smi}] 4b {pattern}: "
            + "; ".join(f"{name} {rec['engine_steps']} steps "
                        f"{rec['wall_s']:.3f} s, launches "
                        f"{ {k: v for k, v in rec['launches'].items() if v} }"
                        for name, rec in card.items())
            + f"; swap: {int(sched_st['sched_preemptions'])} preemptions, "
            f"{int(sched_st['sched_swaps_in'])} resumes, state_bytes_"
            f"recurrent {int(sched_st['state_bytes_recurrent'])} B; card == "
            f"CPU tokens (requests): {agree}")
        if problems:
            raise AssertionError(f"4b {pattern}: " + "; ".join(problems))
        record[pattern] = {"card": card, "cpu_agree": agree}
    return record


# ---------------------------------------------------------------------------
# 5l and 5m: recurrentgemma-9b (depth cut) and mamba2-2.7b at full width
# ---------------------------------------------------------------------------

# recurrentgemma-9b: 38 layers 'RRL' (26 'R', 12 'L', window 2,048), cut
# to RG_LAYERS (2 'R', 1 'L'); mamba2-2.7b: 64 'M' layers, cut to
# MAMBA_LAYERS (the smoke's time: a mixed step dispatches ~2,200 host ops
# a layer).  Per-slot
# recurrent state bytes: an 'R' layer's bf16 (3, lru_width) conv tail and
# f32 h, an 'M' layer's bf16 (3, d_inner + 2 d_state) conv tail and f32
# (heads, head_dim, d_state) state
RG_MAX_SEQ, MAMBA_MAX_SEQ, REC_CHUNK = 4096, 2048, 64
RG_LAYERS = 3
RG_STATE_B = 2 * (3 * 4096 * 2 + 4096 * 4)    # RG_LAYERS' 2 'R' layers
MAMBA_LAYERS = 16
MAMBA_STATE_B = MAMBA_LAYERS * (3 * 5376 * 2 + 80 * 64 * 128 * 4)


def full_width_params(torch, dev, cfg):
    """bf16 weights from ``init_params`` seed 0 on ``dev``, timed."""
    from repro_torch.core import tree
    from repro_torch.models import transformer as tfm

    t0 = time.perf_counter()
    gen = (torch.Generator(device=dev).manual_seed(0) if dev.type == "cuda"
           else 0)
    params = tfm.init_params(gen, cfg, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    leaves = tree.leaves(params)
    n_par = sum(t.numel() for t in leaves)
    n_bytes = sum(t.numel() * t.element_size() for t in leaves)
    say(f"{cfg.name} params ({cfg.n_layers} layers '{cfg.layer_pattern}', "
        f"d_model {cfg.d_model}, vocab {cfg.vocab}, {cfg.dtype}: "
        f"{n_par:,} parameters, {n_bytes / 1e9:.2f} GB, the leaves the "
        f"reference reads uncast f32) initialised in "
        f"{time.perf_counter() - t0:.1f} s")
    return params, n_par, n_bytes


def recurrent_serves(torch, dev, cfg, params, max_seq, reqs, prompts, modes):
    """Serve the requests once per mode, with the smoke's KVCompressConfig
    (inert: no 'G' layer to cluster): "chunked" (chunk 64), "paged" (the
    same over blocks of 16) and "blocking" (one sequential prefill an
    admission, bucket 1).  Returns {mode: run_serve record}."""
    from repro_torch.runtime.kv_pool import PagedKVConfig
    from repro_torch.runtime.server import Server, ServerConfig

    kw = {"chunked": dict(prefill_chunk=REC_CHUNK),
          "paged": dict(prefill_chunk=REC_CHUNK,
                        paged=PagedKVConfig(block_size=BS)),
          "blocking": {}}
    out = {}
    for mode in modes:
        srv = Server(cfg, ServerConfig(batch_size=4, max_seq=max_seq,
                                       kv_compress=smoke_kv_compress(),
                                       **kw[mode]), params, device=dev)
        out[mode] = run_serve(torch, srv, reqs, prompts, f"{cfg.name} "
                              f"{mode}")
    return out


class _OpCounter:
    """Counts the non-view aten ops dispatched in its ``with`` block: the
    host's dispatches, each of which launches at least one kernel when its
    tensors are on the card (views launch none)."""

    def __init__(self, torch):
        from torch.utils._python_dispatch import TorchDispatchMode

        counter = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if not func.is_view:
                    counter.n += 1
                return func(*args, **(kwargs or {}))

        self.n = 0
        self.mode = Mode()

    def __enter__(self):
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self.mode.__exit__(*exc)


def step_dispatches(torch, dev, cfg, params, max_seq,
                    forms=("mixed", "decode")):
    """Host dispatches (non-view aten ops) and wall ms of one mixed engine
    step (4 slots, a 64-token chunk beside 3 decode rows) and of one
    decode step, on a fresh dense cache of the serve's layout, as
    ``transformer.decode_step`` runs them (``forms``: which of the two; an
    MLA model has no mixed step).  The counts do not depend on the widths
    or the device for these models (no kernel wrapper runs)."""
    from repro_torch.models import transformer as tfm

    ccfg = smoke_kv_compress()
    cache = tfm.init_cache(cfg, 4, max_seq, kv_mode="clustered",
                           kv_clusters=ccfg.n_clusters,
                           kv_tail=ccfg.keep_recent, device=dev)
    rng = np.random.default_rng(0)
    out = {}
    with torch.inference_mode():
        for name, width, cl in (("mixed", REC_CHUNK, [REC_CHUNK, 1, 1, 1]),
                                ("decode", 1, None)):
            if name not in forms:
                continue
            tok = torch.from_numpy(rng.integers(
                0, cfg.vocab, size=(4, width)).astype(np.int32)).to(dev)
            t = torch.tensor([0, 100, 200, 300], dtype=torch.int32,
                             device=dev)
            kw = ({} if cl is None else
                  {"chunk_len": torch.tensor(cl, dtype=torch.int32,
                                             device=dev)})
            with _OpCounter(torch) as c:           # warms the timed run
                tfm.decode_step(params, cfg, cache, tok, t, **kw)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            tfm.decode_step(params, cfg, cache, tok, t, **kw)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            out[name] = {"dispatches": c.n,
                         "ms": (time.perf_counter() - t0) * 1e3}
    return out


def serve_recurrent_full(torch, dev, smi, arch):
    """Phases 5l (recurrentgemma-9b, depth cut to ``RG_LAYERS``: chunked
    dense, chunked paged, blocking dense) and 5m (mamba2-2.7b, depth cut
    to ``MAMBA_LAYERS``: chunked dense, blocking dense; the paged
    construction must raise the
    reference's "ring-family" ValueError) at full width, bf16 weights
    from seed 0.
    Gates: every request complete; B1, B2 and B3 never launched (no 'G'
    layer, as in the reference); state_bytes_recurrent exactly the
    per-slot figure (RG_STATE_B, MAMBA_STATE_B) and kv_retired_recurrent
    0; recurrentgemma: kv_retired_window > 0, paged pool_frees ==
    pool_allocs and pool_blocks_end 0; mamba2: blocking == chunked on
    every request.  Printed: recurrentgemma's chunked vs blocking and
    paged vs dense agreement, host dispatches and wall of one mixed and
    one decode step, each serve's steps and wall, the peak of
    ``torch.cuda.max_memory_allocated()``.  Returns the record; the
    weights are freed."""
    from repro_torch import configs
    from repro_torch.runtime.kv_pool import PagedKVConfig
    from repro_torch.runtime.server import Server, ServerConfig

    cfg = configs.get_config(arch)
    rg = arch == "recurrentgemma-9b"
    cfg = dataclasses.replace(cfg,
                              n_layers=RG_LAYERS if rg else MAMBA_LAYERS)
    max_seq = RG_MAX_SEQ if rg else MAMBA_MAX_SEQ
    want_b = RG_STATE_B if rg else MAMBA_STATE_B
    reqs, prompts = draw_requests(cfg.vocab,
                                  **(RG_STREAM if rg else MAMBA_STREAM))
    torch.cuda.reset_peak_memory_stats()
    params, n_par, n_bytes = full_width_params(torch, dev, cfg)
    problems = []
    if not rg:
        try:
            Server(cfg, ServerConfig(batch_size=4, max_seq=max_seq,
                                     kv_compress=smoke_kv_compress(),
                                     prefill_chunk=REC_CHUNK,
                                     paged=PagedKVConfig(block_size=BS)),
                   params, device=dev)
            problems.append("paged construction did not raise")
        except ValueError as e:
            if "ring-family" not in str(e):
                problems.append(f"paged construction raised {e!r}")
    modes = ("chunked", "paged", "blocking") if rg else ("chunked",
                                                         "blocking")
    recs = recurrent_serves(torch, dev, cfg, params, max_seq, reqs, prompts,
                            modes)
    steps = step_dispatches(torch, dev, cfg, params, max_seq)
    peak = torch.cuda.max_memory_allocated()
    for mode, rec in recs.items():
        st, ln = rec["stats"], rec["launches"]
        if any(ln[k] for k in ("clustered_decode", "paged_clustered_decode",
                               "bitserial_median")):
            problems.append(f"{mode}: kernels launched {ln}")
        if not (st["state_bytes_recurrent"] == want_b
                and st["kv_retired_recurrent"] == 0):
            problems.append(f"{mode}: state_bytes_recurrent "
                            f"{st['state_bytes_recurrent']} (want {want_b}),"
                            f" kv_retired_recurrent "
                            f"{st['kv_retired_recurrent']}")
        if rg and not st["kv_retired_window"] > 0:
            problems.append(f"{mode}: kv_retired_window "
                            f"{st['kv_retired_window']}")
        if "pool_blocks_end" in st and not (
                st["pool_frees"] == st["pool_allocs"]
                and st["pool_blocks_end"] == 0):
            problems.append(f"{mode}: pool allocs {st['pool_allocs']}, frees"
                            f" {st['pool_frees']}, end "
                            f"{st['pool_blocks_end']}")
    phase = "5l" if rg else "5m"
    for mode, rec in recs.items():
        st = rec["stats"]
        say(f"[{smi}] {phase} {arch} {mode}: {len(reqs)} requests (prompts "
            f"{[r.prompt_len for r in reqs]}, {int(st['gen_tokens'])} "
            f"generated) in {rec['wall_s']:.3f} s wall; "
            f"{rec['engine_steps']} engine steps, "
            f"{int(st['prefill_chunks'])} prefill chunks; kv_retired_window"
            f" {int(st['kv_retired_window'])}, kv_retired_recurrent "
            f"{int(st['kv_retired_recurrent'])}, state_bytes_recurrent "
            f"{int(st['state_bytes_recurrent'])} B a slot; kernel launches "
            f"{ {k: v for k, v in rec['launches'].items() if v} }; "
            f"{times_line(rec)}; tokens sha256 {rec['tokens_sha256']}")
    differ = compare_tokens(recs["chunked"], recs["blocking"],
                            f"{phase} blocking vs chunked")
    if not rg and differ:
        # every launch steps a recurrent column at the slot count
        # (ROADMAP Queue C 10), so 5m's serves must agree
        problems.append(f"blocking vs chunked: {len(differ)} of "
                        f"{len(reqs)} requests differ (first positions "
                        f"{differ})")
    if rg:
        compare_tokens(recs["chunked"], recs["paged"],
                       f"{phase} paged vs dense")
    say(f"[{smi}] {phase} {arch}: one mixed step (a 64-token chunk and 3 "
        f"decode rows) {steps['mixed']['dispatches']} host dispatches "
        f"(non-view aten ops) in {steps['mixed']['ms']:.1f} ms, one decode "
        f"step {steps['decode']['dispatches']} in "
        f"{steps['decode']['ms']:.1f} ms; clustered_decode, "
        f"paged_clustered_decode and bitserial_median 0 a step; peak memory"
        f" allocated {peak / 2**30:.2f} GiB")
    del params
    torch.cuda.empty_cache()
    if problems:
        raise AssertionError(f"{phase} {arch}: " + "; ".join(problems))
    return {"serves": recs, "steps": steps, "peak_bytes": peak,
            "n_params": n_par, "param_bytes": n_bytes,
            "prompt_lens": [r.prompt_len for r in reqs]}


# ---------------------------------------------------------------------------
# phase 4c: the reduced qwen2-moe, card vs CPU, and the metrics reference
# ---------------------------------------------------------------------------

# tests/test_torch_moe_serving.py's serves: batch 4, max_seq 96, 4 clusters
# over a ring of 16, refresh 8; 5 requests of 9-40 prompt tokens
MOE_TINY_CC = dict(n_clusters=4, iters=4, keep_recent=16, refresh_every=8)


def clustered_launch_problems(rec, mode, n_layers):
    """The kernel gates of a clustered serve (``run_serve`` record) over
    ``n_layers`` clustered layers: the mode's decode kernel
    (paged_clustered_decode when ``mode`` is "paged", else
    clustered_decode) launched n_layers x engine steps and the other
    never; bitserial_median >= absorbs + compress admissions +
    compactions > 0.  Returns the problems found."""
    st, ln, steps = rec["stats"], rec["launches"], rec["engine_steps"]
    kernel, other = (("paged_clustered_decode", "clustered_decode")
                     if mode == "paged" else
                     ("clustered_decode", "paged_clustered_decode"))
    problems = []
    if (ln[kernel], ln[other]) != (n_layers * steps, 0):
        problems.append(f"{mode}: {kernel} {ln[kernel]} (want {n_layers} x "
                        f"{steps}), {other} {ln[other]} (want 0)")
    need = (int(st["kv_absorbs"]) + int(st["kv_compactions"])
            + int(st.get("kv_admit_compress", 0)))
    if not ln["bitserial_median"] >= need > 0:
        problems.append(f"{mode}: bitserial_median {ln['bitserial_median']},"
                        f" want >= {need} > 0")
    return problems


def check_moe_tiny(torch, dev, smi):
    """Phase 4c: the reduced qwen2-moe-a2.7b (2 'G' layers, 4 / 4 heads of
    16, 8 routed experts top-2 and a shared expert) in f32, port weights
    from seed 0, served chunked dense (chunk 8), chunked paged (blocks of
    4) and blocking dense on the card and on the CPU.  Gates: card tokens
    == CPU tokens, request for request, in every mode; clustered_decode
    launched layers x engine steps in the dense serves and
    paged_clustered_decode in the paged one, the other never;
    bitserial_median >= absorbs + compress admissions + compactions > 0.
    Then ``telemetry.reference_registry(device="cuda")``: its table must
    equal the committed ``docs/metrics_torch.md``'s."""
    import dataclasses as dc

    from repro_torch import configs
    from repro_torch.core.kv_compress import KVCompressConfig
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime import telemetry
    from repro_torch.runtime.kv_pool import PagedKVConfig
    from repro_torch.runtime.server import Server, ServerConfig

    cfg = dc.replace(configs.get_reduced("qwen2-moe-a2.7b"), dtype="float32")
    params = tfm.init_params(0, cfg, device="cpu")
    reqs, prompts = draw_requests(cfg.vocab, **MOE_TINY_STREAM)
    base = dict(batch_size=4, max_seq=96,
                kv_compress=KVCompressConfig(**MOE_TINY_CC))
    modes = {"chunked": dict(base, prefill_chunk=8),
             "paged": dict(base, prefill_chunk=8,
                           paged=PagedKVConfig(block_size=4)),
             "blocking": base}
    problems, out = [], {}
    for mode, kw in modes.items():
        recs = {}
        for d in ("cpu", dev):
            srv = Server(cfg, ServerConfig(**kw), params, device=d)
            recs[str(d)] = run_serve(torch, srv, reqs, prompts,
                                     f"4c qwen2-moe {mode} {d}")
        card, cpu = recs[str(dev)], recs["cpu"]
        out[mode] = {"card": card, "cpu": cpu}
        if card["tokens"] != cpu["tokens"]:
            problems.append(f"{mode}: card tokens != CPU tokens")
        problems += clustered_launch_problems(card, mode, cfg.n_layers)
        ln, steps = card["launches"], card["engine_steps"]
        say(f"[{smi}] 4c reduced qwen2-moe {mode}: {steps} engine steps, "
            f"card == CPU {card['tokens'] == cpu['tokens']}, launches "
            f"{ {k: v for k, v in ln.items() if v} }, tokens sha256 "
            f"{card['tokens_sha256']}")
    t0 = time.perf_counter()
    table = telemetry.reference_registry(device=dev).reference_table()
    reg_s = time.perf_counter() - t0
    doc = (ROOT / "docs" / "metrics_torch.md").read_text(encoding="utf-8")
    committed = [ln for ln in doc.splitlines() if ln.startswith("|")]
    if table.splitlines() != committed:
        problems.append("reference_registry on the card: its table differs "
                        "from docs/metrics_torch.md")
    say(f"[{smi}] 4c reference_registry(device=cuda): {len(committed) - 2} "
        f"metric rows, equal to docs/metrics_torch.md "
        f"{table.splitlines() == committed}, in {reg_s:.1f} s")
    if problems:
        raise AssertionError("4c qwen2-moe: " + "; ".join(problems))
    out["registry_s"] = reg_s
    return out


# ---------------------------------------------------------------------------
# 5n: qwen2-moe-a2.7b at full width and depth
# ---------------------------------------------------------------------------

MOE_MAX_SEQ = 2048


def moe_kept(torch, idx, cap):
    """(T, K) bool: which of the assignments ``idx`` (T, K) their experts
    keep at capacity ``cap``: an assignment's rank among those of its
    expert, in token-then-k order, is below ``cap`` (the dispatch's rule,
    recomputed here from the routes alone)."""
    flat = idx.reshape(-1).long()
    order = torch.argsort(flat, stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(flat.numel())
    counts = torch.bincount(flat)
    starts = torch.cumsum(counts, 0) - counts
    return (rank - starts[flat] < cap).reshape(idx.shape)


def check_moe_layer(torch, dev, cfg, p):
    """One full-width MoE layer (60 experts of 1,408, top-4, the shared
    expert of 5,632) on (4, 64, 2,048) bf16 rows, on the card against the
    CPU, which computes it in f32 on the same bf16 weights and rows.

    Gates: every token's set of top-4 experts equals the CPU's, except
    near-ties (the CPU's 4th and 5th router probabilities within 1e-5).  A
    token is compared where its experts and those of them that kept it
    (capacity) equal the CPU's, at least half the tokens: there the routed experts' part
    (``_dispatch_compute``'s y, without the shared expert, which dominates
    the layer's magnitude) within 2^-5 of its own largest CPU magnitude,
    and the layer's output within 2^-5 of its own (8 bf16 ulps: the card
    rounds each stage to bf16).  With no route differing, expert loads and
    the drop fraction equal the CPU's; else the loads differ by at most
    2 x top-k per differing token.  Returns the record."""
    import dataclasses as dc

    from repro_torch.models import moe as moe_mod

    d, k = cfg.d_model, cfg.moe.top_k
    g = torch.Generator(device="cpu").manual_seed(5)
    x = torch.randn(4, 64, d, generator=g).to(torch.bfloat16)
    cfg32 = dc.replace(cfg, dtype="float32")
    p32 = {n: ({kk: vv.float().cpu() for kk, vv in v.items()}
               if isinstance(v, dict) else v.float().cpu())
           for n, v in p.items()}
    with torch.inference_mode():
        xd = x.to(dev)
        y, m = moe_mod.apply_moe(p, xd, cfg)
        yr = moe_mod._dispatch_compute(p, xd.reshape(-1, d), cfg)[0]
        _, idx, _ = moe_mod.route(p, xd.reshape(-1, d), cfg)
        torch.cuda.synchronize()
        y, yr, idx = y.float().cpu(), yr.float().cpu(), idx.cpu()
        y0, m0 = moe_mod.apply_moe(p32, x.float(), cfg32)
        yr0 = moe_mod._dispatch_compute(p32, x.float().reshape(-1, d),
                                        cfg32)[0]
        _, idx0, probs0 = moe_mod.route(p32, x.float().reshape(-1, d), cfg32)
    t = idx0.shape[0]
    top = probs0.sort(-1, descending=True).values
    near = (top[:, k - 1] - top[:, k]) < 1e-5
    # a token's expert set decides its output; the order within it only
    # the order of its combine
    differ = (idx.sort(-1).values != idx0.sort(-1).values).any(-1)
    cap = moe_mod.capacity(cfg, t)
    kept = lambda ids: torch.where(                     # noqa: E731
        moe_kept(torch, ids, cap), ids, -1).sort(-1).values
    same = ~differ & (kept(idx) == kept(idx0)).all(-1)
    rec = {"tokens": int(t), "route_differ": int(differ.sum()),
           "near_ties": int(near.sum()),
           "route_differ_not_near": int((differ & ~near).sum()),
           "tokens_compared": int(same.sum()),
           "drop_frac": float(m["drop_frac"]),
           "drop_frac_cpu": float(m0["drop_frac"])}
    if rec["route_differ_not_near"]:
        raise AssertionError(f"5n MoE layer: {rec['route_differ_not_near']}"
                             " tokens routed otherwise than on the CPU, not "
                             "near-ties")
    if 2 * rec["tokens_compared"] < t:
        raise AssertionError(f"5n MoE layer: only {rec['tokens_compared']} "
                             f"of {t} tokens routed and kept as on the CPU")
    y, y0 = y.reshape(t, d)[same], y0.reshape(t, d)[same]
    for name, a, a0 in (("routed", yr[same], yr0[same]), ("y", y, y0)):
        err = (a - a0).abs().max().item()
        scale = a0.abs().max().item()
        rec.update({f"{name}_max_abs_err": err, f"{name}_absmax": scale})
        if err > 2.0 ** -5 * scale:
            raise AssertionError(f"5n MoE layer: max |{name} - {name}_cpu| "
                                 f"{err:.3e} > 2^-5 x {scale:.3e}")
    rec.update(max_abs_err=rec["y_max_abs_err"], y_absmax=rec["y_absmax"])
    load_diff = (m["expert_load"].cpu() - m0["expert_load"]).abs().sum()
    if int(load_diff) > 2 * k * rec["route_differ"]:
        raise AssertionError("5n MoE layer: expert loads differ from the "
                             "CPU's by more than the differing routes")
    if not differ.any() and rec["drop_frac"] != rec["drop_frac_cpu"]:
        raise AssertionError("5n MoE layer: drop fraction differs from the "
                             "CPU's")
    return rec


def moe_workload():
    """5n's and 5w's model and requests: (cfg, reqs, prompts)."""
    from repro_torch import configs

    cfg = configs.get_config("qwen2-moe-a2.7b")
    return (cfg,) + draw_requests(cfg.vocab, **MOE_STREAM)


def serve_moe_full(torch, dev, smi):
    """Phase 5n: qwen2-moe-a2.7b at full width and depth (24 'G' layers,
    d_model 2,048, 16 / 16 heads of 128, MoE FFNs of 60 routed experts of
    1,408 top-4 and a shared expert of 5,632, vocab 151,936 untied; bf16
    weights from ``init_params`` seed 0, the routers f32),
    ``ServerConfig(batch_size=4, max_seq=2048, prefill_chunk=64,
    kv_compress=smoke_kv_compress())``: 4 requests from ``default_rng(7)``
    (prompts of 96-768 tokens, 24-40 new tokens) served chunked dense,
    chunked paged (blocks of 16) and blocking dense.  Gates: every request
    complete; clustered_decode launched layers x engine steps in the dense
    serves and paged_clustered_decode in the paged one, the other never;
    bitserial_median >= absorbs + compress admissions + compactions > 0 in
    every serve; the paged serve's pool_frees == pool_allocs and
    pool_blocks_end 0; ``check_moe_layer`` on layer 0.  Printed: chunked
    vs blocking and paged vs dense agreement (not gated: a MoE launch's
    capacity drops depend on its other rows), each serve's steps, wall and
    tokens sha256, the host dispatches and wall of one mixed and one
    decode step, peak memory.  Returns (record, params)."""
    from repro_torch.runtime.kv_pool import PagedKVConfig
    from repro_torch.runtime.server import Server, ServerConfig

    cfg, reqs, prompts = moe_workload()
    torch.cuda.reset_peak_memory_stats()
    params, n_par, n_bytes = full_width_params(torch, dev, cfg)
    layer = check_moe_layer(torch, dev, cfg, params["layers"][0]["moe"])
    say(f"[{smi}] 5n one MoE layer on (4, 64, {cfg.d_model}) bf16 rows: "
        f"{layer['tokens'] - layer['route_differ']} of {layer['tokens']} "
        f"tokens routed as on the CPU ({layer['near_ties']} near-ties, "
        f"{layer['tokens_compared']} compared), routed part max |err| "
        f"{layer['routed_max_abs_err']:.3e} (|y_routed| up to "
        f"{layer['routed_absmax']:.3e}), max |y - y_cpu| "
        f"{layer['max_abs_err']:.3e} (|y| up to "
        f"{layer['y_absmax']:.3e}), drop_frac {layer['drop_frac']:.4f} "
        f"(CPU {layer['drop_frac_cpu']:.4f})")
    kw = {"chunked": dict(prefill_chunk=REC_CHUNK),
          "paged": dict(prefill_chunk=REC_CHUNK,
                        paged=PagedKVConfig(block_size=BS)),
          "blocking": {}}
    recs, problems = {}, []
    for mode, extra in kw.items():
        srv = Server(cfg, ServerConfig(batch_size=4, max_seq=MOE_MAX_SEQ,
                                       kv_compress=smoke_kv_compress(),
                                       **extra), params, device=dev)
        rec = recs[mode] = run_serve(torch, srv, reqs, prompts,
                                     f"5n qwen2-moe {mode}")
        problems += clustered_launch_problems(rec, mode, cfg.n_layers)
        st, ln, steps = rec["stats"], rec["launches"], rec["engine_steps"]
        if mode == "paged" and not (st["pool_frees"] == st["pool_allocs"]
                                    and st["pool_blocks_end"] == 0):
            problems.append(f"paged: pool allocs {st['pool_allocs']}, frees"
                            f" {st['pool_frees']}, end "
                            f"{st['pool_blocks_end']}")
        say(f"[{smi}] 5n qwen2-moe-a2.7b {mode}: 4 requests (prompts "
            f"{[r.prompt_len for r in reqs]}, {int(st['gen_tokens'])} "
            f"generated) in {rec['wall_s']:.3f} s wall; {steps} engine "
            f"steps, {int(st['prefill_chunks'])} prefill chunks, "
            f"{int(st['kv_absorbs'])} absorbs, "
            f"{int(st['kv_compactions'])} compactions"
            + (f", {int(st['kv_admit_compress'])} compress + "
               f"{int(st['kv_admit_tail'])} tail-only admissions"
               if mode == "blocking" else "")
            + f"; kernel launches {({k: v for k, v in ln.items() if v})}; "
            f"{times_line(rec)}; tokens sha256 {rec['tokens_sha256']}")
    compare_tokens(recs["chunked"], recs["blocking"],
                   "5n blocking vs chunked")
    compare_tokens(recs["chunked"], recs["paged"], "5n paged vs dense")
    steps = step_dispatches(torch, dev, cfg, params, MOE_MAX_SEQ)
    peak = torch.cuda.max_memory_allocated()
    say(f"[{smi}] 5n qwen2-moe-a2.7b: one mixed step (a 64-token chunk and "
        f"3 decode rows) {steps['mixed']['dispatches']} host dispatches "
        f"(non-view aten ops) in {steps['mixed']['ms']:.1f} ms, one decode "
        f"step {steps['decode']['dispatches']} in "
        f"{steps['decode']['ms']:.1f} ms; peak memory allocated "
        f"{peak / 2**30:.2f} GiB")
    if problems:
        raise AssertionError("5n qwen2-moe-a2.7b: " + "; ".join(problems))
    out = {"serves": recs, "steps": steps, "peak_bytes": peak,
           "n_params": n_par, "param_bytes": n_bytes, "moe_layer": layer,
           "prompt_lens": [r.prompt_len for r in reqs]}
    return out, params


def expert_bank_counts(params):
    """The expert count of every routed bank a rank holds (the leading
    dim of each MoE layer's w_gate, w_up and w_down)."""
    return sorted({lp["moe"][k].shape[0] for lp in params["layers"]
                   if "moe" in lp for k in ("w_gate", "w_up", "w_down")})


def serve_moe_mesh(torch, dev, smi, params, want):
    """5w: 5n's requests on 5n's weights (qwen2-moe-a2.7b at full width
    and depth) through the mesh engine of a one-rank NCCL world, chunked
    dense at 5n's ServerConfig (its paged serve is cut for the smoke's
    time).  Gates: tokens equal 5n's chunked serve (``want``: 5n's
    serves) request for request (one data shard: 5n's capacities);
    clustered_decode launched layers x engine steps through the head
    island and paged_clustered_decode never; bitserial_median >= absorbs
    + compactions > 0; the rank holds every one of the 60 experts of
    every routed bank (1 x 1: the expert dim over ("model", "data") of
    one rank); every MoE call took the mesh's sharded dispatch (60
    experts on one rank: no a2a geometry).  Printed: the serve's wall,
    ITL p50 and MoE branch counts, the rank's parameter and expert-bank
    bytes.  Returns {"chunked": record}."""
    from repro_torch.models import moe
    from repro_torch.runtime.server import Server, ServerConfig

    cfg, reqs, prompts = moe_workload()
    t0 = time.perf_counter()
    problems, recs = [], {}
    with one_rank_mesh("5w") as mesh:
        for mode, extra in (("chunked", dict(prefill_chunk=REC_CHUNK)),):
            srv = Server(cfg, ServerConfig(
                batch_size=4, max_seq=MOE_MAX_SEQ,
                kv_compress=smoke_kv_compress(), mesh=mesh, **extra),
                params, device=dev)
            held = srv.param_bytes()
            banks = expert_bank_counts(srv.params)
            if banks != [cfg.moe.n_routed]:
                problems.append(f"{mode}: the rank's banks hold {banks} "
                                f"experts, want {cfg.moe.n_routed}")
            moe.reset_mesh_dispatches()
            rec = recs[mode] = run_serve(torch, srv, reqs, prompts,
                                         f"5w qwen2-moe mesh {mode}")
            rec["mesh_dispatches"] = dict(moe.mesh_dispatches)
            rec["param_bytes"] = held
            problems += clustered_launch_problems(rec, mode, cfg.n_layers)
            st = rec["stats"]
            md = rec["mesh_dispatches"]
            if not (md["sharded"] > 0 and md["a2a"] == md["global"] == 0):
                problems.append(f"{mode}: MoE branches {md}, want sharded "
                                f"only")
            diff = [uid for uid, t in want[mode]["tokens"].items()
                    if rec["tokens"][uid] != t]
            if diff:
                problems.append(f"{mode}: tokens of uids {diff} differ from "
                                f"5n's")
            say(f"[{smi}] 5w qwen2-moe-a2.7b mesh {mode}: wall_s "
                f"{rec['wall_s']:.3f}  itl_p50_ms {st['itl_p50_ms']:.2f}  "
                f"{rec['engine_steps']} engine steps; MoE branches {md}; "
                f"kernel launches "
                f"{({k: v for k, v in rec['launches'].items() if v})}; the "
                f"rank holds {held['total'] / 1e9:.2f} GB of parameters, "
                f"{held['experts'] / 1e9:.2f} GB of them routed experts "
                f"({banks} a bank); tokens sha256 {rec['tokens_sha256']} "
                f"(5n: {want[mode]['tokens_sha256']}); "
                f"{len(reqs) - len(diff)} of {len(reqs)} requests equal")
    say(f"5w mesh wall: {time.perf_counter() - t0:.1f} s")
    if problems:
        raise AssertionError("5w qwen2-moe mesh: " + "; ".join(problems))
    return recs


# ---------------------------------------------------------------------------
# phase 4d and 5o-5q: MLA, the frontend stub and the encoder-decoder
# ---------------------------------------------------------------------------

# tests/test_torch_mla_serving.py's clustered config over the reduced zoo
ZOO_TINY_CC = dict(n_clusters=8, iters=4, keep_recent=16, refresh_every=8)
ZOO_KERNELS = ("clustered_decode", "paged_clustered_decode",
               "bitserial_median")


def entry_point_steps(torch, tfm, cfg, params, tokens, n_steps, max_seq,
                      forced=None, shift=0, **inputs):
    """``prefill`` of ``tokens`` (B, S) (with ``inputs``: frontend_embeds
    or enc_embeds), then ``n_steps`` greedy ``decode_step``s, or steps
    that feed ``forced`` (B, >= n_steps) column by column; a nonzero
    ``shift`` plants a fault: each step runs at its position + ``shift``.
    Returns (the logits of the prefill and of every step, f32 on the CPU,
    the greedy tokens (B, n_steps + 1), the final cache)."""
    dev = tokens.device
    t0 = tokens.shape[1] + (0 if cfg.is_encdec else
                            (inputs["frontend_embeds"].shape[1]
                             if "frontend_embeds" in inputs else 0))
    with torch.inference_mode():
        lg, cache = tfm.prefill(params, cfg, tokens, max_seq=max_seq,
                                **inputs)
        logits, toks = [lg.float().cpu()], [lg.argmax(-1)]
        for i in range(n_steps):
            nxt = (toks[-1] if forced is None else forced[:, i])
            lg, cache = tfm.decode_step(params, cfg, cache,
                                        nxt.to(torch.int32)[:, None],
                                        t0 + i + shift)
            logits.append(lg.float().cpu())
            toks.append(lg.argmax(-1))
        if dev.type == "cuda":
            torch.cuda.synchronize()
    return logits, torch.stack(toks, 1).cpu(), cache


def check_zoo_tiny(torch, dev, smi):
    """Phase 4d: the reduced deepseek-v3-671b (MLA), internvl2-76b (the
    vision stub) and seamless-m4t-medium (the encoder-decoder) in f32, port
    weights from seed 0, on the card and on the CPU.  deepseek-v3 serves
    static, blocking over exact KV and blocking under ``ZOO_TINY_CC``
    (batch 2, max_seq 64, ``ZOO_TINY_STREAM``): card tokens == CPU tokens
    in each mode, blocking clustered == blocking exact, and B1, B2 and B3
    never launched (the latent stays exact).  internvl2 serves static,
    blocking and blocking clustered, card == CPU, and B1 launched layers x
    engine steps in the clustered serve; then ``prefill(frontend_embeds=)``
    and 4 ``decode_step``s, logits within 1e-4 of the CPU's.  seamless:
    ``prefill(enc_embeds=)`` and 4 ``decode_step``s within 1e-4 of the
    CPU's, greedy tokens equal.  Returns the record."""
    from repro_torch import configs
    from repro_torch.core.kv_compress import KVCompressConfig
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime.server import Server, ServerConfig, _to_device

    problems, out = [], {}
    modes = {"static": dict(engine="static"), "blocking": {},
             "clustered": dict(kv_compress=KVCompressConfig(**ZOO_TINY_CC))}
    for arch in ("deepseek-v3-671b", "internvl2-76b"):
        cfg = dataclasses.replace(configs.get_reduced(arch),
                                  dtype="float32")
        params = tfm.init_params(0, cfg, device="cpu")
        reqs, prompts = draw_requests(cfg.vocab, **ZOO_TINY_STREAM)
        rec = out[arch] = {}
        for mode, kw in modes.items():
            recs = {}
            for d in ("cpu", dev):
                srv = Server(cfg, ServerConfig(batch_size=2, max_seq=64,
                                               **kw), params, device=d)
                recs[str(d)] = run_serve(torch, srv, reqs, prompts,
                                         f"4d {arch} {mode} {d}")
            card, cpu = recs[str(dev)], recs["cpu"]
            rec[mode] = {"card": card, "cpu": cpu}
            if card["tokens"] != cpu["tokens"]:
                problems.append(f"{arch} {mode}: card tokens != CPU tokens")
            ln = card["launches"]
            want = {k: 0 for k in ZOO_KERNELS}
            if arch == "internvl2-76b" and mode == "clustered":
                problems += clustered_launch_problems(card, "blocking",
                                                      cfg.n_layers)
            elif {k: ln[k] for k in ZOO_KERNELS} != want:
                problems.append(f"{arch} {mode}: kernel launches "
                                f"{ {k: ln[k] for k in ZOO_KERNELS} }, "
                                "want none")
            say(f"[{smi}] 4d reduced {arch} {mode}: "
                f"{card['engine_steps']} engine steps, card == CPU "
                f"{card['tokens'] == cpu['tokens']}, launches "
                f"{ {k: v for k, v in ln.items() if v} }, tokens sha256 "
                f"{card['tokens_sha256']}")
        if arch == "deepseek-v3-671b" and (
                rec["clustered"]["card"]["tokens"]
                != rec["blocking"]["card"]["tokens"]):
            problems.append("deepseek-v3 blocking clustered tokens != "
                            "blocking exact tokens")
    # the model entry points: frontend patches, encoder frames
    rng = np.random.default_rng(4)
    for arch, key, n_in in (("internvl2-76b", "frontend_embeds", None),
                            ("seamless-m4t-medium", "enc_embeds", 13)):
        cfg = dataclasses.replace(configs.get_reduced(arch),
                                  dtype="float32")
        params = tfm.init_params(0, cfg, device="cpu")
        n_in = n_in or cfg.n_frontend_tokens
        emb = torch.from_numpy(rng.normal(size=(2, n_in, cfg.d_model))
                               .astype(np.float32))
        tok = torch.from_numpy(rng.integers(0, cfg.vocab, size=(2, 10))
                               .astype(np.int32))
        runs = {}
        for d in ("cpu", dev):
            runs[str(d)] = entry_point_steps(
                torch, tfm, cfg, _to_device(params, d), tok.to(d), 4, 32,
                **{key: emb.to(d)})
        (lg_g, tk_g, _), (lg_c, tk_c, _) = runs[str(dev)], runs["cpu"]
        err = max((a - b).abs().max().item() for a, b in zip(lg_g, lg_c))
        out[f"{arch} entry points"] = {"max_abs_err": err,
                                       "tokens_equal": bool(
                                           torch.equal(tk_g, tk_c))}
        if err > 1e-4:
            problems.append(f"{arch} prefill({key}=) + 4 decode_steps: max "
                            f"|card - CPU| {err:.3e} > 1e-4")
        if not torch.equal(tk_g, tk_c):
            problems.append(f"{arch} prefill({key}=) + 4 decode_steps: "
                            "greedy tokens differ from the CPU's")
        say(f"[{smi}] 4d reduced {arch} prefill({key}=(2, {n_in}, "
            f"{cfg.d_model})) + 4 decode_steps: card == CPU logits (max abs "
            f"err {err:.3e}), greedy tokens equal {torch.equal(tk_g, tk_c)}")
    if problems:
        raise AssertionError("4d reduced zoo: " + "; ".join(problems))
    return out


def no_kernel_problems(rec, what):
    ln = {k: rec["launches"][k] for k in ZOO_KERNELS}
    if any(ln.values()):
        return [f"{what}: kernel launches {ln}, want none"]
    return []


def serve_line(smi, name, mode, reqs, rec):
    st, ln = rec["stats"], rec["launches"]
    say(f"[{smi}] {name} {mode}: 4 requests (prompts "
        f"{[r.prompt_len for r in reqs]}, {int(st.get('gen_tokens', 0))} "
        f"generated) in {rec['wall_s']:.3f} s wall; "
        f"{rec['engine_steps']} engine steps, "
        f"{int(st.get('kv_absorbs', 0))} absorbs, "
        f"{int(st.get('kv_compactions', 0))} compactions"
        + (f", {int(st['kv_admit_compress'])} compress + "
           f"{int(st['kv_admit_tail'])} tail-only admissions"
           if "kv_admit_compress" in st and ln["bitserial_median"] else "")
        + f"; kernel launches {({k: v for k, v in ln.items() if v})}; "
        + (times_line(rec) if "ttft_p50_ms" in st else
           f"wall_s {rec['wall_s']:.3f}")
        + f"; tokens sha256 {rec['tokens_sha256']}")


# deepseek-v3-671b at full width (5o): 5 of its 61 layers (the 3 dense
# layers and 2 MoE layers), max_seq 4,096; internvl2-76b (5p): 36 of its
# 80 layers, max_seq 2,048; seamless-m4t-medium (5q): whole, max_seq 128
DSV3_LAYERS, DSV3_MAX_SEQ = 5, 4096
# 5x serves the first 2 of 5o's 4 requests (**Cut** for the smoke's time)
DSV3_MESH_REQUESTS = 2
IVL_MAX_SEQ, IVL_STEPS, IVL_TEXT = 2048, 16, 64
SEAM_MAX_SEQ, SEAM_STEPS, SEAM_PROMPT = 128, 32, 32
# decode_vs_prefill's bound on rms(dlogit) / rms(logit) a row, by phase
# and dtype, set between what a sound path and a planted fault read (on
# an H100 80GB HBM3 at 700 W).  In bf16 the decode and a fresh prefill
# round differently and the noise grows with depth: 5p at 36 layers
# reads up to 6.0e-2, its planted faults 1.20 (one slot off) and 1.42
# (frontend offset ignored); 5q reads 1.0e-2, its fault 0.153.  f32 (5p
# cut to IVL_F32_LAYERS layers, 5q whole) reads 8.2e-6 / 7.2e-7, the
# faults 0.69 / 0.153
DVP_MAX_RATIO = {"5p": {"bf16": 0.15, "f32": 1e-3},
                 "5q": {"bf16": 0.04, "f32": 1e-3}}
IVL_F32_LAYERS = 4


def deepseek_workload():
    """5o's and 5x's model (deepseek-v3-671b cut to ``DSV3_LAYERS``, no
    MTP module) and requests: (cfg, reqs, prompts)."""
    from repro_torch import configs

    cfg = dataclasses.replace(configs.get_config("deepseek-v3-671b"),
                              n_layers=DSV3_LAYERS, mtp_depth=0)
    return (cfg,) + draw_requests(cfg.vocab, **DSV3_STREAM)


def serve_deepseek_full(torch, dev, smi):
    """Phase 5o: deepseek-v3-671b at full width (d_model 7,168, 128 heads,
    MLA with q_lora 1,536, kv_lora 512, rope 64; 256 routed experts of
    2,048 top-8 sigmoid and a shared expert; vocab 129,280 untied), depth
    cut to ``DSV3_LAYERS`` (its 3 dense layers of d_ff 18,432, then 2 MoE
    layers; no MTP module), bf16 weights from seed 0, the routers f32.
    ``max_seq`` 4,096, batch 4, 4 requests from ``default_rng(8)``
    (prompts of 256-2,048, 24-40 new tokens): static, blocking over exact
    KV, and blocking with the smoke's KVCompressConfig.  Gates: every
    request complete; B1, B2 and B3 never launched; no absorb; blocking
    clustered tokens == blocking exact tokens (the latent stays exact:
    the same math).  Printed: each serve's steps, wall and tokens sha256,
    the host dispatches and wall of one decode step, the peak of
    ``torch.cuda.max_memory_allocated()``.  Returns (record, params)."""
    from repro_torch.runtime.server import Server, ServerConfig

    cfg, reqs, prompts = deepseek_workload()
    torch.cuda.reset_peak_memory_stats()
    params, n_par, n_bytes = full_width_params(torch, dev, cfg)
    kw = {"static": dict(engine="static"), "blocking": {},
          "clustered": dict(kv_compress=smoke_kv_compress())}
    recs, problems = {}, []
    for mode, extra in kw.items():
        srv = Server(cfg, ServerConfig(batch_size=4, max_seq=DSV3_MAX_SEQ,
                                       **extra), params, device=dev)
        rec = recs[mode] = run_serve(torch, srv, reqs, prompts,
                                     f"5o deepseek-v3 {mode}")
        problems += no_kernel_problems(rec, mode)
        if rec["stats"].get("kv_absorbs", 0):
            problems.append(f"{mode}: {rec['stats']['kv_absorbs']} absorbs")
        serve_line(smi, "5o deepseek-v3-671b", mode, reqs, rec)
    if compare_tokens(recs["blocking"], recs["clustered"],
                      "5o blocking clustered vs exact"):
        problems.append("blocking clustered tokens != blocking exact tokens")
    compare_tokens(recs["blocking"], recs["static"],
                   "5o static vs blocking")
    steps = step_dispatches(torch, dev, cfg, params, DSV3_MAX_SEQ,
                            forms=("decode",))
    peak = torch.cuda.max_memory_allocated()
    say(f"[{smi}] 5o deepseek-v3-671b ({DSV3_LAYERS} layers): one decode "
        f"step {steps['decode']['dispatches']} host dispatches (non-view "
        f"aten ops) in {steps['decode']['ms']:.1f} ms; peak memory "
        f"allocated {peak / 2**30:.2f} GiB")
    if problems:
        raise AssertionError("5o deepseek-v3-671b: " + "; ".join(problems))
    out = {"serves": recs, "steps": steps, "peak_bytes": peak,
           "n_params": n_par, "param_bytes": n_bytes,
           "n_layers": DSV3_LAYERS,
           "prompt_lens": [r.prompt_len for r in reqs]}
    return out, params


def serve_deepseek_mesh(torch, dev, smi, params, want):
    """5x: the first ``DSV3_MESH_REQUESTS`` of 5o's requests on 5o's
    weights (deepseek-v3-671b at full width,
    ``DSV3_LAYERS`` layers) through the mesh engine of a one-rank NCCL
    world, blocking under the smoke's KVCompressConfig: MLA on a mesh (the
    latent over slots only, decoded in full) and the a2a config's sharded
    fallback (256 routed experts, one rank).  Gates: tokens equal 5o's
    blocking clustered serve's (``want``: 5o's serves) request for
    request; B1, B2 and
    B3 never launched (the latent stays exact); the a2a branch never
    taken and the sharded fallback taken.  Printed: the wall, ITL p50 and
    the MoE branch counts."""
    from repro_torch.models import moe
    from repro_torch.runtime.server import Server, ServerConfig

    cfg, reqs, prompts = deepseek_workload()
    reqs = reqs[:DSV3_MESH_REQUESTS]
    prompts = {r.uid: prompts[r.uid] for r in reqs}
    t0 = time.perf_counter()
    problems = []
    with one_rank_mesh("5x") as mesh:
        srv = Server(cfg, ServerConfig(batch_size=4, max_seq=DSV3_MAX_SEQ,
                                       kv_compress=smoke_kv_compress(),
                                       mesh=mesh), params, device=dev)
        held = srv.param_bytes()
        moe.reset_mesh_dispatches()
        rec = run_serve(torch, srv, reqs, prompts, "5x deepseek-v3 mesh")
        rec["mesh_dispatches"] = md = dict(moe.mesh_dispatches)
        rec["param_bytes"] = held
    problems += no_kernel_problems(rec, "mesh clustered")
    if not (md["a2a"] == 0 and md["sharded"] > 0):
        problems.append(f"MoE branches {md}, want a2a 0 and sharded > 0")
    diff = [uid for uid, t in rec["tokens"].items()
            if want["clustered"]["tokens"][uid] != t]
    if diff or len(rec["tokens"]) != len(reqs):
        problems.append(f"tokens of uids {diff} differ from 5o's blocking "
                        f"clustered serve (served {sorted(rec['tokens'])})")
    st = rec["stats"]
    say(f"[{smi}] 5x deepseek-v3-671b mesh blocking clustered: wall_s "
        f"{rec['wall_s']:.3f}  itl_p50_ms {st['itl_p50_ms']:.2f}  "
        f"{rec['engine_steps']} engine steps; MoE branches {md}; the rank "
        f"holds {held['total'] / 1e9:.2f} GB of parameters "
        f"({held['experts'] / 1e9:.2f} GB routed experts); tokens sha256 "
        f"{rec['tokens_sha256']} (5o's 4: "
        f"{want['clustered']['tokens_sha256']}); {len(reqs) - len(diff)} "
        f"of {len(reqs)} requests equal")
    say(f"5x mesh wall: {time.perf_counter() - t0:.1f} s")
    if problems:
        raise AssertionError("5x deepseek-v3 mesh: " + "; ".join(problems))
    return rec


def decode_vs_prefill(torch, tfm, cfg, params, tokens, n_steps, max_seq,
                      max_ratio, **inputs):
    """``n_steps`` greedy ``decode_step``s after a prefill, each step's
    logits held against a fresh ``prefill``'s over the same tokens (the
    prompt and the tokens generated so far).  The two paths round
    differently (other GEMM shapes, another attention reduction order),
    so in bf16 their logits part by a noise that grows with depth.  Gates:
    every logit finite; on every row of every step rms(dlogit) /
    rms(logit) <= ``max_ratio`` (``DVP_MAX_RATIO``: between what the
    sound path and a planted fault read), the gate that finds faults; the
    greedy tokens equal, except where the prefill's top two logits lie
    within max(0.1, 5 x the row's rms(dlogit)) (in bf16 most rows lie
    within that margin, so this only catches a path that has come apart).
    Then the witness of the ratio bound:
    the same steps, fed the same tokens, with a planted fault (each new
    entry written one slot off; with ``frontend_embeds``, decode at the
    text's positions, the frontend offset ignored) must read above
    ``max_ratio`` against the same prefills.  Returns (record, problems,
    the cache after the steps)."""
    logits, toks, cache = entry_point_steps(torch, tfm, cfg, params, tokens,
                                            n_steps, max_seq, **inputs)
    problems = []
    if not all(torch.isfinite(lg).all() for lg in logits):
        problems.append("non-finite logits")
    rms = lambda a: a.pow(2).mean(-1).sqrt()                  # noqa: E731
    worst, ratio, near, differ, flips, ref = 0.0, 0.0, 0, 0, [], {}
    with torch.inference_mode():
        for i in range(1, n_steps + 1):
            seq = torch.cat([tokens, toks[:, :i].to(tokens.device,
                                                    tokens.dtype)], 1)
            lg, _ = tfm.prefill(params, cfg, seq, max_seq=max_seq, **inputs)
            lg = ref[i] = lg.float().cpu()
            d = lg - logits[i]
            worst = max(worst, d.abs().max().item())
            ratio = max(ratio, (rms(d) / rms(lg)).max().item())
            top2 = lg.topk(2, -1).values
            gap = top2[:, 0] - top2[:, 1]
            margin = torch.clamp(5 * rms(d), min=0.1)
            flip = lg.argmax(-1) != toks[:, i]
            flips += [[i, round(float(g), 4), round(float(r), 4)]
                      for g, r, f in zip(gap, rms(d), flip) if f]
            near += int((gap < margin).sum())
            differ += int((flip & (gap >= margin)).sum())
    if ratio > max_ratio:
        problems.append(f"rms(dlogit) / rms(logit) {ratio:.3e} > "
                        f"{max_ratio:g}")
    if differ:
        problems.append(f"{differ} decode tokens differ from a fresh "
                        "prefill's outside max(0.1, 5 rms(dlogit))")
    faults = {"one slot off": 1}
    if "frontend_embeds" in inputs:
        faults["frontend offset ignored"] = -inputs[
            "frontend_embeds"].shape[1]
    planted = {}
    for name, shift in faults.items():
        bad = entry_point_steps(torch, tfm, cfg, params, tokens, n_steps,
                                max_seq, forced=toks.to(tokens.device),
                                shift=shift, **inputs)[0]
        planted[name] = max((rms(bad[i] - ref[i]) / rms(ref[i])).max().item()
                            for i in ref)
        if planted[name] <= max_ratio:
            problems.append(f"planted fault ({name}) reads rms(dlogit) / "
                            f"rms(logit) {planted[name]:.3e} <= "
                            f"{max_ratio:g}: the bound misses it")
    return ({"max_abs_dlogit": worst, "max_rms_ratio": ratio,
             "near_ties": near, "flips": flips, "planted": planted,
             "logit_rms": rms(lg).mean().item(),
             "tokens": toks.tolist()}, problems, cache)


def dvp_line(rec):
    return (f"decode == fresh prefill greedy on every step but "
            f"{len(rec['flips'])} flips [step, prefill top-2 gap, rms "
            f"dlogit] {rec['flips']} (each inside its margin; "
            f"{rec['near_ties']} rows within theirs), max rms(dlogit) / "
            f"rms(logit) {rec['max_rms_ratio']:.3e} (logit rms "
            f"{rec['logit_rms']:.3f}), max |dlogit| "
            f"{rec['max_abs_dlogit']:.4f}; planted faults read "
            + ", ".join(f"{k} {v:.3e}" for k, v in rec["planted"].items()))


def serve_internvl_full(torch, dev, smi):
    """Phase 5p: internvl2-76b at full width (d_model 8,192, 64 query heads
    over 8 kv heads of 128, d_ff 28,672, vocab 128,256 untied, the vision
    stub's 8,192 x 8,192 projection), depth cut to ``IVL_LAYERS`` of 80,
    bf16 weights from seed 0.  ``max_seq`` 2,048, batch 4, the smoke's
    KVCompressConfig, 4 requests from ``default_rng(9)`` (prompts of
    96-1,536, 24-40 new tokens), text-only: blocking clustered, then
    static.  Gates: every request complete; clustered_decode launched
    layers x engine steps in the blocking serve (GQA group 8),
    paged_clustered_decode never, bitserial_median >= absorbs + compress
    admissions + compactions > 0; no kernel in the static serve.  Then the
    model entry points on an exact cache: ``prefill(frontend_embeds=(4,
    64, 8,192))`` (a fresh ``default_rng(9)``'s normal draws, then 64 text
    tokens) and ``IVL_STEPS`` greedy ``decode_step``s, every logit finite
    and each step's token that of a fresh prefill over the same tokens
    (``decode_vs_prefill``).  Returns the record; the weights are
    freed."""
    from repro_torch import configs
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime.server import Server, ServerConfig

    cfg = dataclasses.replace(configs.get_config("internvl2-76b"),
                              n_layers=IVL_LAYERS)
    reqs, prompts = draw_requests(cfg.vocab, **IVL_STREAM)
    torch.cuda.reset_peak_memory_stats()
    params, n_par, n_bytes = full_width_params(torch, dev, cfg)
    recs, problems = {}, []
    for mode, extra in (("blocking", dict(kv_compress=smoke_kv_compress())),
                        ("static", dict(engine="static"))):
        srv = Server(cfg, ServerConfig(batch_size=4, max_seq=IVL_MAX_SEQ,
                                       **extra), params, device=dev)
        rec = recs[mode] = run_serve(torch, srv, reqs, prompts,
                                     f"5p internvl2 {mode}")
        problems += (clustered_launch_problems(rec, "blocking", IVL_LAYERS)
                     if mode == "blocking" else
                     no_kernel_problems(rec, mode))
        serve_line(smi, "5p internvl2-76b", mode, reqs, rec)
    del srv                                   # it holds the weights too
    compare_tokens(recs["static"], recs["blocking"],
                   "5p blocking clustered vs static")
    rng = np.random.default_rng(9)
    fe = torch.from_numpy(rng.normal(
        size=(4, cfg.n_frontend_tokens, cfg.d_model)).astype(
            np.float32)).to(dev)
    text = torch.from_numpy(rng.integers(0, cfg.vocab, size=(4, IVL_TEXT))
                            .astype(np.int32)).to(dev)
    fr = {}
    steps = step_dispatches(torch, dev, cfg, params, IVL_MAX_SEQ)
    peak = torch.cuda.max_memory_allocated()
    say(f"[{smi}] 5p internvl2-76b ({IVL_LAYERS} layers): one mixed step "
        f"{steps['mixed']['dispatches']} host dispatches (non-view aten ops)"
        f" in {steps['mixed']['ms']:.1f} ms, one decode step "
        f"{steps['decode']['dispatches']} in {steps['decode']['ms']:.1f} ms;"
        f" peak memory allocated {peak / 2**30:.2f} GiB")
    # the entry points in bf16 at the served depth, then in f32 at
    # IVL_F32_LAYERS layers (full width: 22 GB), where the two paths must
    # agree to f32 rounding
    for name, c in (("bf16", cfg), ("f32", dataclasses.replace(
            cfg, n_layers=IVL_F32_LAYERS, dtype="float32"))):
        if name == "f32":
            del params
            torch.cuda.empty_cache()
            params = full_width_params(torch, dev, c)[0]
        t0 = time.perf_counter()
        fr[name], fprob, _ = decode_vs_prefill(
            torch, tfm, c, params, text, IVL_STEPS, 256,
            DVP_MAX_RATIO["5p"][name], frontend_embeds=fe)
        fr[name]["seconds"] = time.perf_counter() - t0
        problems += [f"frontend entry points ({name}): {p}" for p in fprob]
        say(f"[{smi}] 5p internvl2-76b {name}, {c.n_layers} layers: "
            f"prefill(frontend_embeds=(4, {c.n_frontend_tokens}, "
            f"{c.d_model})) + {IVL_TEXT} text tokens, then {IVL_STEPS} "
            f"decode_steps: every logit finite "
            f"{not any('finite' in p for p in fprob)}, {dvp_line(fr[name])}"
            f"; {fr[name]['seconds']:.1f} s")
    del params
    torch.cuda.empty_cache()
    if problems:
        raise AssertionError("5p internvl2-76b: " + "; ".join(problems))
    return {"serves": recs, "frontend": fr, "steps": steps,
            "peak_bytes": peak, "n_params": n_par, "param_bytes": n_bytes,
            "n_layers": IVL_LAYERS,
            "prompt_lens": [r.prompt_len for r in reqs]}


def run_seamless_full(torch, dev, smi):
    """Phase 5q: seamless-m4t-medium at full width and depth (a 12-layer
    encoder and a 12-layer decoder with cross-attention, d_model 1,024, 16
    heads of 64, d_ff 4,096 GeGLU, LayerNorm, sinusoidal positions, vocab
    256,206 padded to 256,256, tied), bf16 weights from seed 0, through the
    model entry points: ``prefill(enc_embeds=(4, S_enc, 1,024))`` (S_enc
    drawn from 256-1,024 by ``default_rng(10)``, then the frames' normal
    draws and 32-token decoder prompts) and ``SEAM_STEPS`` greedy
    ``decode_step``s, ``max_seq`` 128.  Gates: every logit finite; the
    cross caches bit-identical before and after the steps;
    ``decode_vs_prefill``'s gates, in bf16 and then in f32 (2.9 GB), where
    the two paths must agree to f32 rounding.  Returns the record; the
    weights are freed."""
    from repro_torch import configs
    from repro_torch.models import transformer as tfm

    cfg = configs.get_config("seamless-m4t-medium")
    torch.cuda.reset_peak_memory_stats()
    params, n_par, n_bytes = full_width_params(torch, dev, cfg)
    rng = np.random.default_rng(10)
    s_enc = int(rng.integers(256, 1025))
    enc = torch.from_numpy(rng.normal(size=(4, s_enc, cfg.d_model)).astype(
        np.float32)).to(dev)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab, size=(4, SEAM_PROMPT))
                           .astype(np.int32)).to(dev)
    problems = []
    with torch.inference_mode():
        _, c0 = tfm.prefill(params, cfg, tok, max_seq=SEAM_MAX_SEQ,
                            enc_embeds=enc)
    cross0 = [(k.clone(), v.clone()) for k, v in c0["cross"]]
    del c0
    rec = {}
    for name, c in (("bf16", cfg),
                    ("f32", dataclasses.replace(cfg, dtype="float32"))):
        if name == "f32":
            del params
            torch.cuda.empty_cache()
            params = full_width_params(torch, dev, c)[0]
        t0 = time.perf_counter()
        rec[name], sprob, cache = decode_vs_prefill(
            torch, tfm, c, params, tok, SEAM_STEPS, SEAM_MAX_SEQ,
            DVP_MAX_RATIO["5q"][name], enc_embeds=enc)
        rec[name]["seconds"] = time.perf_counter() - t0
        problems += [f"{name}: {p}" for p in sprob]
        if name == "bf16":
            same = all(torch.equal(k, k0) and torch.equal(v, v0)
                       for (k, v), (k0, v0) in zip(cache["cross"], cross0))
            if not same:
                problems.append("cross caches changed through the decode "
                                "steps")
        del cache
        say(f"[{smi}] 5q seamless-m4t-medium {name}: prefill(enc_embeds=(4, "
            f"{s_enc}, {cfg.d_model})) + {SEAM_PROMPT}-token decoder "
            f"prompts, then {SEAM_STEPS} decode_steps: every logit finite "
            f"{not any('finite' in p for p in sprob)}"
            + (f", cross caches bit-identical {same}" if name == "bf16"
               else "")
            + f", {dvp_line(rec[name])}; {rec[name]['seconds']:.1f} s")
    peak = torch.cuda.max_memory_allocated()
    say(f"[{smi}] 5q seamless-m4t-medium: peak memory allocated "
        f"{peak / 2**30:.2f} GiB")
    del params, cross0
    torch.cuda.empty_cache()
    if problems:
        raise AssertionError("5q seamless-m4t-medium: "
                             + "; ".join(problems))
    rec.update(s_enc=s_enc, cross_unchanged=same, peak_bytes=peak,
               n_params=n_par, param_bytes=n_bytes)
    return rec


# ---------------------------------------------------------------------------
# phases 5s and 5t: the serving entry points (the CLI, the example twin)
# ---------------------------------------------------------------------------

# 5s (a): the CLI in a subprocess, run as ``python -m`` runs a module
# (``runpy.run_module(..., run_name="__main__", alter_sys=True)``); the
# bootstrap records the serve's last_stats and blocking admissions and
# prints them with the kernels' launch counts of the run as one JSON line
# after the CLI's own lines
CLI_ARGS = ("--arch", "qwen3-4b", "--requests", "16")
CLI_BOOT = """
import json, runpy
from repro_torch.kernels import ops
from repro_torch.runtime.server import Server
stats, serve = {}, Server.serve
def recorded(self, *args):
    outs = serve(self, *args)
    stats.update(self.last_stats, **self.last_admission)
    return outs
Server.serve = recorded
ops.reset_launches()
runpy.run_module("repro_torch.launch.serve", run_name="__main__",
                 alter_sys=True)
print("RECORD " + json.dumps({"launches": ops.launch_counts(),
                              "stats": {k: float(v)
                                        for k, v in stats.items()}}))
"""
# the lines of a blocking clustered CLI serve, in the reference's order (a
# retention line may follow)
CLI_BLOCKING_LINES = ("[serve] padding waste: ", "[serve] clustered KV: ",
                      "[serve] 16 completions, 128 tokens in ",
                      "[serve] blocking prefill: ",
                      "[serve] bucketed launches: ")
# the example twin's line count on the CPU (tests/test_torch_serve_example.py
# GOLDEN: the reference example's lines), and its [kv] attention rel-err
# from a CPU run (``python examples/serve_clustered_kv_torch.py --device
# cpu``, weights drawn from seeds 0, 1, 2 on the CPU generator, as an int
# seed draws them on the card too), which 5t must come within
# EXAMPLE_REL_ERR_TOL of
EXAMPLE_LINES = 23
EXAMPLE_REL_ERR_CPU, EXAMPLE_REL_ERR_TOL = 0.10601958632469177, 0.005


def cli_serves(torch, argv, params):
    """``launch.serve.main(argv, params=...)`` in process, with every
    ``Server.serve`` of the run recorded: its requests, completions,
    last_stats, kernel launches (counts reset just before the serve, read
    just after) and the template pool it ends with.  Returns (server,
    printed lines, serve records)."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as serve_mod
    from repro_torch.runtime.server import Server

    serves, lines, orig = [], [], Server.serve

    def serve(self, requests, prompts):
        ops.reset_launches()
        outs = orig(self, requests, prompts)
        torch.cuda.synchronize()
        st = dict(self.last_stats)
        serves.append({"reqs": list(requests), "outs": outs, "stats": st,
                       "launches": ops.launch_counts(),
                       "engine_steps": int(st.get("decode_steps", 0)),
                       "tmpl_pool": self._tmpl_pool})
        return outs

    Server.serve = serve
    try:
        srv = serve_mod.main(list(argv), params=params, say=lines.append)
    finally:
        Server.serve = orig
    return srv, lines, serves


def serve_cli_full(torch, dev, smi, params):
    """Phase 5s: the serving CLI on qwen3-4b at full width and depth (see
    the module docstring): (a) blocking clustered in a subprocess drawing
    its own weights from ``--seed`` (on the host's CPU generator, as an
    int seed draws), (b) the priority demo traced and (c) the template
    store on phase 5's weights, in process."""
    import os

    from repro_torch import configs
    from repro_torch.runtime.telemetry import validate_chrome_file

    cfg = configs.get_config("qwen3-4b")
    rec, problems = {}, []

    # (a) the module as __main__ in a subprocess, beside this process's
    # weights (its cached blocks handed back first)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    argv = list(CLI_ARGS) + ["--kv-clusters", "32"]
    proc = subprocess.run([sys.executable, "-c", CLI_BOOT, *argv],
                          capture_output=True, text=True, env=env, cwd=ROOT,
                          timeout=600)
    wall = time.perf_counter() - t0
    lines = proc.stdout.splitlines()
    for line in lines:
        if not line.startswith("RECORD "):
            say(f"    5s (a) {line}")
    if proc.returncode != 0:
        raise AssertionError(f"5s (a): rc {proc.returncode}; stderr "
                             f"{proc.stderr[-2000:]}")
    got = json.loads(lines[-1].removeprefix("RECORD "))
    launches, st = got["launches"], got["stats"]
    steps = int(st["decode_steps"])
    need = int(st["kv_admit_compress"]) + int(st["kv_compactions"])
    served = lines[:-1]
    order = [next((i for i, p in enumerate(CLI_BLOCKING_LINES)
                   if line.startswith(p)), None) for line in served]
    if (order[:len(CLI_BLOCKING_LINES)] != list(range(len(
            CLI_BLOCKING_LINES))) or not all(
            line.startswith("[serve] retention: ")
            for line in served[len(CLI_BLOCKING_LINES):])):
        problems.append(f"(a) lines {served}")
    if not (launches["clustered_decode"] == cfg.n_layers * steps > 0
            and launches["paged_clustered_decode"] == 0
            and launches["bitserial_median"] >= need > 0):
        problems.append(f"(a) launches {launches}, want clustered_decode "
                        f"{cfg.n_layers} x {steps} engine steps, "
                        f"paged_clustered_decode 0, bitserial_median >= "
                        f"compress admissions + compactions = {need} > 0")
    rec["a"] = {"lines": served, "launches": launches, "wall_s": wall,
                "engine_steps": steps}
    say(f"[{smi}] 5s (a) python -m repro_torch.launch.serve "
        f"{' '.join(argv)}: rc 0 in {wall:.1f} s (process, weight draw and "
        f"serve); {steps} engine steps, {int(st['kv_admit_compress'])} "
        f"compress + {int(st['kv_admit_tail'])} tail-only admissions, "
        f"{int(st['kv_compactions'])} compactions; launches {launches}")

    # (b) the priority demo, traced, on phase 5's weights
    OUT.mkdir(exist_ok=True)
    trace = OUT / "serve_cli_trace.json"
    t0 = time.perf_counter()
    srv, lines, serves = cli_serves(
        torch, list(CLI_ARGS) + ["--paged", "--prefill-chunk", "16",
                                 "--priority-demo", "--trace-out",
                                 str(trace)], params)
    wall = time.perf_counter() - t0
    for line in lines:
        say(f"    5s (b) {line}")
    (sb,) = serves
    st = sb["stats"]
    try:
        paged_launch_gate(cfg, sb, "5s (b)")
    except AssertionError as e:
        problems.append(str(e))
    shed = {o.uid for o in sb["outs"] if o.shed}
    for r in sb["reqs"]:
        toks = next(o.tokens for o in sb["outs"] if o.uid == r.uid)
        if r.uid not in shed and len(toks) != r.max_new_tokens:
            problems.append(f"(b) uid {r.uid}: {len(toks)} tokens, want "
                            f"{r.max_new_tokens}")
    if st["sched_shed_high"] != 0 or st["pool_blocks_end"] != 0:
        problems.append(f"(b) sched_shed_high {st['sched_shed_high']}, "
                        f"pool_blocks_end {st['pool_blocks_end']}")
    bad = validate_chrome_file(str(trace))
    if bad:
        problems.append("(b) trace: " + "; ".join(bad[:5]))
    prio = {r.uid: r.priority for r in sb["reqs"]}
    ttft = {}
    for cls in sorted(set(prio.values())):
        v = [o.prefill_ms for o in sb["outs"]
             if prio[o.uid] == cls and not o.shed]
        ttft[cls] = float(np.percentile(v, 95)) if v else float("nan")
    rec["b"] = {"lines": lines, "launches": sb["launches"],
                "engine_steps": sb["engine_steps"], "wall_s": wall,
                "ttft_p95_ms": ttft,
                "sched": {k: int(v) for k, v in st.items()
                          if k.startswith("sched_")},
                "trace_events": len(srv.last_trace), "trace_problems": bad}
    say(f"[{smi}] 5s (b) priority demo, SLOConfig() (priority_admission="
        f"True), pool {int(st['pool_blocks_total'])} blocks: "
        f"{int(st['sched_preemptions'])} preemptions, "
        f"{int(st['sched_deferrals'])} deferrals, {int(st['sched_sheds'])} "
        f"shed ({int(st['sched_shed_high'])} protected); TTFT p95 by class "
        + ", ".join(f"{k}: {v:.1f} ms" for k, v in ttft.items())
        + f"; {sb['engine_steps']} engine steps, launches "
        f"{sb['launches']}; trace {len(srv.last_trace)} events, "
        f"{len(bad)} problems, written to chiprun_out/{trace.name}; "
        f"{wall:.1f} s")

    # (c) the template store, served twice, on the same weights
    t0 = time.perf_counter()
    srv, lines, serves = cli_serves(
        torch, list(CLI_ARGS) + ["--paged", "--prefill-chunk", "16",
                                 "--persist-templates"], params)
    wall = time.perf_counter() - t0
    for line in lines:
        say(f"    5s (c) {line}")
    if len(serves) != 2:
        raise AssertionError(f"5s (c): {len(serves)} serves, want 2")
    for i, s in enumerate(serves):
        try:
            paged_launch_gate(cfg, s, f"5s (c) serve {i + 1}")
        except AssertionError as e:
            problems.append(str(e))
    warm = serves[1]["stats"]
    if not any(line.startswith("[serve] warm re-serve: ")
               and line.endswith("tokens identical: True") for line in lines):
        problems.append("(c) the warm re-serve's tokens differ")
    if not warm.get("prefix_hits", 0) > 0:
        problems.append(f"(c) warm store hits {warm.get('prefix_hits')}")
    pool = serves[1]["tmpl_pool"]
    if pool is None or pool.allocated() != 0 or srv._tmpl_pool is not None:
        problems.append("(c) the pool is not drained by "
                        "invalidate_templates()")
    rec["c"] = {"lines": lines, "wall_s": wall,
                "launches": [s["launches"] for s in serves],
                "engine_steps": [s["engine_steps"] for s in serves],
                "prefix_hits": [s["stats"].get("prefix_hits", 0)
                                for s in serves]}
    say(f"[{smi}] 5s (c) template store: engine steps "
        f"{rec['c']['engine_steps']}, store hits {rec['c']['prefix_hits']}, "
        f"launches {rec['c']['launches']}; pool 0 after "
        f"invalidate_templates(); {wall:.1f} s")
    if problems:
        raise AssertionError("5s serving CLI: " + "; ".join(problems))
    return rec


def cli_launches(cli, name):
    """A kernel's launches in 5s: (a) blocking clustered, (b) the priority
    demo, (c) the template store's two serves."""
    return {"kv_clusters": cli["a"]["launches"][name],
            "priority_demo": cli["b"]["launches"][name],
            "persist_templates": [c[name] for c in cli["c"]["launches"]]}


def serve_example_full(torch, dev, smi):
    """Phase 5t: examples/serve_clustered_kv_torch.py's ``run("cuda")``
    at its own shapes (SMALL, GLWIN, GMREC in f32, weights from seeds 0,
    1, 2)."""
    import runpy

    from repro_torch.kernels import ops

    twin = runpy.run_path(str(ROOT / "examples"
                              / "serve_clustered_kv_torch.py"),
                          run_name="serve_clustered_kv_torch")
    lines = []
    ops.reset_launches()
    t0 = time.perf_counter()
    out = twin["run"]("cuda", say=lines.append)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    for line in lines:
        say(f"    5t {line}")
    problems = []
    if any("DIVERGED" in line for line in lines):
        problems.append("a line reads DIVERGED")
    if not any("schema problems: 0," in line for line in lines):
        problems.append("the trace has schema problems")
    if not any("(0 protected shed)" in line for line in lines):
        problems.append("a protected request was shed")
    if set(out["pool_blocks_end"].values()) != {0}:
        problems.append(f"pools at drain {out['pool_blocks_end']}")
    if len(lines) != EXAMPLE_LINES:
        problems.append(f"{len(lines)} lines, the CPU run's {EXAMPLE_LINES}")
    if abs(out["rel_err"] - EXAMPLE_REL_ERR_CPU) > EXAMPLE_REL_ERR_TOL:
        problems.append(f"[kv] rel-err {out['rel_err']:.6f}, the CPU run's "
                        f"{EXAMPLE_REL_ERR_CPU:.6f}")
    for k in ("clustered_decode", "paged_clustered_decode",
              "bitserial_median"):
        if not launches[k] > 0:
            problems.append(f"{k} launched {launches[k]} times")
    say(f"[{smi}] 5t example twin: {len(lines)} lines in {wall:.1f} s; "
        f"launches {launches}; [kv] rel-err {out['rel_err']:.6f}")
    if problems:
        raise AssertionError("5t example twin: " + "; ".join(problems))
    return {"lines": lines, "launches": launches, "wall_s": wall,
            "rel_err": out["rel_err"]}


# ---------------------------------------------------------------------------
# phase 5u: the dry run's decode cell on the card
# ---------------------------------------------------------------------------


def dryrun_cell_full(torch, dev, smi, params):
    """Phase 5u: ``launch.dryrun.run_cell`` of qwen3-4b x decode_32k in
    kv_mode "clustered" on the card at full width and depth, on phase 5's
    weights, and the count of the same cell in kv_mode "exact" on meta."""
    from repro_torch.launch import dryrun
    from repro_torch.roofline import analysis

    t0 = time.perf_counter()
    rec = dryrun.run_cell(DRY_ARCH, DRY_SHAPE, {"kv_mode": "clustered"},
                          device="cuda", params=params)
    row = analysis.analyze_record(rec)
    exact = dryrun.run_cell(DRY_ARCH, DRY_SHAPE, {"kv_mode": "exact"},
                            device="meta")
    exact_row = analysis.analyze_record(exact)
    wall = time.perf_counter() - t0
    mem = rec["memory_analysis"]
    predicted = mem["argument_bytes"] + mem["output_bytes"] \
        - mem["alias_bytes"]
    peak = mem["argument_bytes"] + mem["temp_bytes"]
    layers = len(params["layers"])
    b1 = rec["launches_per_step"]["clustered_decode"]
    problems = []
    if b1 != layers:
        problems.append(f"clustered_decode launched {b1} times a step, not "
                        f"{layers}")
    if rec["op_stats"]["kernels"]["clustered_decode"]["launches"] != layers:
        problems.append("the meta count does not hold one clustered_decode "
                        "a layer")
    if row["measured_s"] < row["ideal_s"]:
        problems.append(f"measured step {row['measured_s']} s below the "
                        f"ideal {row['ideal_s']} s")
    if peak > DRY_PEAK_SLACK * predicted:
        problems.append(f"peak {peak} B over {DRY_PEAK_SLACK} x the "
                        f"predicted {predicted} B")
    if not rec["logits_finite"]:
        problems.append("a logit is not finite")
    if exact_row["fits_80gb"]:
        problems.append("exact KV reads fits_80gb true")
    t = row["terms_s"]
    prof = rec["profile"]
    busy = prof["device_busy_s"]
    say(f"[{smi}] 5u dry run {DRY_ARCH} x {DRY_SHAPE} (clustered, "
        f"{layers} layers): terms compute {t['compute'] * 1e3:.4f} ms, "
        f"memory {t['memory'] * 1e3:.4f} ms, collective "
        f"{t['collective'] * 1e3:.4f} ms (spec constants); ideal "
        f"{row['ideal_s'] * 1e3:.4f} ms; measured step "
        f"{row['measured_s'] * 1e3:.4f} ms (median of "
        f"{len(rec['measured_step_ms'])}); fraction "
        f"{row['measured_fraction']}; peak {peak / 1e9:.3f} GB against "
        f"{predicted / 1e9:.3f} GB predicted; clustered_decode {b1} a step; "
        f"{rec['op_stats']['aten_ops']} aten ops a step; profiled step "
        f"{prof['profiled_step_s'] * 1e3:.3f} ms, host enqueue "
        f"{prof['host_enqueue_s'] * 1e3:.3f} ms, device busy "
        f"{'not measured' if busy is None else f'{busy * 1e3:.3f} ms'}, "
        f"idle share {prof['idle_share']}; exact KV "
        f"{exact_row['device_bytes'] / 1e9:.1f} GB, fits 80 GB "
        f"{exact_row['fits_80gb']}; {wall:.1f} s")
    if problems:
        raise AssertionError("5u dry run: " + "; ".join(problems))
    keep = ("info", "memory_analysis", "measured_step_ms", "first_step_s",
            "launches_per_step", "logits_finite", "profile", "card")
    return {"record": {k: rec[k] for k in keep},
            "op_stats": {k: v for k, v in rec["op_stats"].items()
                         if k != "by_op"},
            "card_op_stats": {k: v for k, v in rec["card_op_stats"].items()
                              if k != "by_op"},
            "row": row, "exact_row": exact_row, "peak_bytes": peak,
            "predicted_bytes": predicted, "wall_s": wall}


# ---------------------------------------------------------------------------
# phases 4e and 5r: training
# ---------------------------------------------------------------------------

# 4e: one make_train_step step of each reduced architecture in f32 on a
# SyntheticLM batch of 2 x TRAIN_SEQ, AdamW at TRAIN_AW (no warmup, so the
# first step moves every element by about lr = 1e-2, a thousand times
# TRAIN_P_TOL: a skipped, reversed or mis-scaled update cannot pass); then
# the TINY Trainer (tests/test_system.py's model, data and optimizer)
TRAIN_ARCHS = ("qwen3-4b", "gemma2-27b", "gemma3-4b", "mamba2-2.7b",
               "recurrentgemma-9b", "deepseek-v3-671b", "qwen2-moe-a2.7b",
               "internvl2-76b", "seamless-m4t-medium")
TRAIN_SEQ = 64
TRAIN_AW = dict(lr=1e-2, warmup_steps=0)
# card against CPU, f32: the loss and each metric, and the gradient norm,
# relative; each clipped gradient leaf within TRAIN_GRAD_RTOL of its
# largest CPU entry; an updated parameter within TRAIN_P_TOL, except where
# the two gradients are too close to 0 to fix the update's sign (AdamW's
# first step moves an element by lr g / (|g| + eps), so such an element
# may move the other way on the other device: those move 2 lr apart at
# most, and must be few)
TRAIN_LOSS_RTOL, TRAIN_GNORM_RTOL, TRAIN_P_TOL = 1e-5, 1e-4, 1e-5
TRAIN_GRAD_RTOL, TRAIN_FLIP_FRAC = 1e-4, 1e-3
TINY_TRAIN = dict(name="tiny", family="dense", n_layers=2, d_model=64,
                  n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab=64,
                  pad_vocab_multiple=16, dtype="float32")
# 5r: qwen3-4b training at full width and depth, bf16 weights
TRAIN5R = dict(batch=2, seq=1024, steps=10, loss_chunk=256)
TRAIN5R_AW = dict(lr=3e-4, warmup_steps=2, total_steps=10)
# the loss on batch 0 must fall by at least this much over the 10 steps:
# the first chip run read 373.57 -> 167.84 (a fall of 205.73), and the
# planted lr-0 step 0.0 (on an H100 80GB HBM3 at 700 W; PERF.md §6)
TRAIN5R_MARGIN = 50.0
# 5z: 5r's steps through a one-rank mesh, each loss and gradient norm
# within this of 5r's (relative; bit for bit expected)
TRAIN5Z_RTOL = 1e-6


class _Routes:
    """Records every MoE layer's top-k experts (``moe.route`` on the
    layer's input) while the block runs, for a card-vs-CPU comparison."""

    def __init__(self, torch):
        from repro_torch.models import moe

        self.moe, self.torch, self.idx = moe, torch, []

    def __enter__(self):
        self.orig = self.moe.apply_moe

        def apply_moe(p, x, cfg):
            with self.torch.no_grad():
                _, idx, _ = self.moe.route(p, x.reshape(-1, x.shape[-1]), cfg)
            self.idx.append(self.torch.sort(idx, dim=1).values.cpu())
            return self.orig(p, x, cfg)

        self.moe.apply_moe = apply_moe
        return self

    def __exit__(self, *exc):
        self.moe.apply_moe = self.orig


def train_step_on(torch, cfg, params, batch, dev):
    """One ``make_train_step`` step of ``params`` (copied to ``dev``) on
    ``batch`` at ``TRAIN_AW``: (metrics as floats, updated params, the MoE
    routes, the clipped gradient leaves on the CPU, recorded through the
    step's ``grad_transform`` hook)."""
    from repro_torch.core import tree
    from repro_torch.launch import steps
    from repro_torch.optim import adamw

    grads = []

    def record(g):
        grads.append(g.detach().cpu())
        return g

    p = tree.map_(lambda t: t.detach().to(dev, copy=True), params)
    step = steps.make_train_step(cfg, adamw.AdamWConfig(**TRAIN_AW),
                                 steps.StepOptions(loss_chunk=16),
                                 grad_transform=record)
    with _Routes(torch) as routes:
        p, _, metrics = step(p, adamw.init(p), batch)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return ({k: float(v) for k, v in metrics.items()},
            tree.map_(lambda t: t.detach().cpu(), p), routes.idx, grads)


def train_step_problems(torch, arch, card, cpu, lr):
    """Card against CPU for one train step (see ``TRAIN_*``); returns
    (problems, the largest gradient error over its leaf's largest entry,
    the largest parameter difference, flipped elements)."""
    from repro_torch.core import tree

    (m_g, p_g, r_g, g_g), (m_c, p_c, r_c, g_c) = card, cpu
    problems = []
    if len(r_g) != len(r_c) or any(not torch.equal(a, b)
                                   for a, b in zip(r_g, r_c)):
        flips = sum(int((a != b).any(dim=1).sum()) for a, b in zip(r_g, r_c))
        problems.append(f"{arch}: {flips} tokens route to other experts on "
                        "the card")
    for k, v in m_c.items():
        tol = TRAIN_GNORM_RTOL if k == "grad_norm" else TRAIN_LOSS_RTOL
        if abs(m_g[k] - v) > tol * max(abs(v), 1e-6):
            problems.append(f"{arch} {k}: card {m_g[k]!r} != CPU {v!r}")
    g_worst, g_bad = 0.0, 0
    for a, b in zip(g_g, g_c, strict=True):
        d, top = (a - b).abs().max().item(), b.abs().max().item()
        g_worst = max(g_worst, d / top if top > 0 else d)
        g_bad += d > TRAIN_GRAD_RTOL * top
    if g_bad:
        problems.append(f"{arch}: {g_bad} gradient leaves beyond "
                        f"{TRAIN_GRAD_RTOL} of their largest entry")
    worst, flipped, total = 0.0, 0, 0
    for a, b in zip(tree.leaves(p_g), tree.leaves(p_c), strict=True):
        d = (a.float() - b.float()).abs()
        worst = max(worst, d.max().item())
        flipped += int((d > TRAIN_P_TOL).sum())
        total += d.numel()
    if worst > 2 * lr + TRAIN_P_TOL or flipped > TRAIN_FLIP_FRAC * total:
        problems.append(f"{arch}: updated params max |card - CPU| {worst:.3e}"
                        f", {flipped} of {total} beyond {TRAIN_P_TOL}")
    return problems, g_worst, worst, flipped


def planted_train_faults(torch, arch, params, card, cpu, lr):
    """The card's step with a planted fault must fail
    ``train_step_problems``: the update skipped (the initial parameters),
    or the smallest gradient leaf 1 % too large (a fault the global norm
    does not see).  Returns the problems (empty when both fail)."""
    from repro_torch.core import tree

    m_g, _, r_g, g_g = card
    skipped = tree.map_(lambda t: t.detach().cpu(), params)
    i = min(range(len(g_g)), key=lambda j: (g_g[j].abs().max().item() == 0,
                                             g_g[j].numel()))
    scaled = [g * 1.01 if j == i else g for j, g in enumerate(g_g)]
    out = []
    for what, fault in (("a skipped update", (m_g, skipped, r_g, g_g)),
                        (f"gradient leaf {i} x 1.01", (m_g, card[1], r_g,
                                                        scaled))):
        if not train_step_problems(torch, arch, fault, cpu, lr)[0]:
            out.append(f"{arch}: the gate passed {what}")
    return out


def tiny_trainer(torch, dev, ckpt_dir, n_steps=25, fail_at=None):
    """tests/test_system.py's TINY Trainer on ``dev``: batch 8 x 32 from
    seed 7, AdamW lr 1e-2, warmup 5, weight decay 0.01, a checkpoint every
    10 steps, parameters from seed 0 (made on the CPU)."""
    from repro_torch.core import tree
    from repro_torch.data import pipeline
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tfm
    from repro_torch.models.config import ModelConfig
    from repro_torch.optim import adamw
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    cfg = ModelConfig(**TINY_TRAIN)
    p0 = tfm.init_params(0, cfg, device="cpu")
    aw = adamw.AdamWConfig(lr=1e-2, warmup_steps=5, total_steps=n_steps,
                           weight_decay=0.01)
    data = pipeline.SyntheticLM(cfg, pipeline.DataConfig(
        seed=7, global_batch=8, seq_len=32))
    return Trainer(cfg, TrainerConfig(
        n_steps=n_steps, ckpt_dir=str(ckpt_dir), ckpt_every=10,
        log_every=100, fail_at_step=fail_at), aw,
        steps.make_train_step(cfg, aw, steps.StepOptions(remat=False)), data,
        init_params_fn=lambda: tree.map_(lambda t: t.to(dev, copy=True),
                                         p0),
        device=dev)


def check_training_tiny(torch, dev, smi):
    """Phase 4e: training, reduced, f32, card against the port's CPU.

    Each of ``TRAIN_ARCHS`` at ``configs.get_reduced`` in f32, parameters
    from seed 0 made on the CPU and copied to the card: one
    ``make_train_step`` step (``TRAIN_AW``, remat, loss chunks of 16) on
    the ``SyntheticLM`` batch of 2 x ``TRAIN_SEQ`` at step 0, on both
    devices.  Gates (``TRAIN_*``): every MoE layer's expert sets equal on
    both devices; the loss, every metric and the gradient norm; every
    clipped gradient leaf; the updated parameters; the planted faults of
    :func:`planted_train_faults` caught.  Then the TINY Trainer on the card: 25 steps with
    a checkpoint every 10 (B3 launched 2 x (25 - 7) = 36 times by the
    straggler median and MAD), a run that crashes at step 17 and resumes
    from step 10, the resumed parameters within 1e-5 of the uninterrupted
    run's (the reference's bound; embedding and combine backward may use
    atomics on the card, so a resumed run may differ by rounding), and
    the loss falling as tests/test_system.py asks.  Returns the record."""
    import tempfile

    from repro_torch import configs
    from repro_torch.core import tree
    from repro_torch.data import pipeline
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import adamw

    problems, out = [], {}
    lr1 = float(adamw.schedule(adamw.AdamWConfig(**TRAIN_AW),
                               torch.tensor(1)))
    for arch in TRAIN_ARCHS:
        cfg = dataclasses.replace(configs.get_reduced(arch), dtype="float32")
        params = tfm.init_params(0, cfg, device="cpu")
        batch = pipeline.SyntheticLM(cfg, pipeline.DataConfig(
            seed=0, global_batch=2, seq_len=TRAIN_SEQ)).batch_at(0)
        t0 = time.perf_counter()
        card = train_step_on(torch, cfg, params, batch, dev)
        card_s = time.perf_counter() - t0
        cpu = train_step_on(torch, cfg, params, batch, torch.device("cpu"))
        probs, g_worst, worst, flipped = train_step_problems(
            torch, arch, card, cpu, lr1)
        planted = planted_train_faults(torch, arch, params, card, cpu, lr1)
        problems += probs + planted
        out[arch] = {"card": card[0], "cpu": cpu[0], "grad_max_rel_err":
                     g_worst, "param_max_abs_err": worst,
                     "param_flipped": flipped, "card_s": card_s,
                     "moe_layers_routed": len(card[2])}
        say(f"[{smi}] 4e reduced {arch} train step: loss card "
            f"{card[0]['loss']:.6f} CPU {cpu[0]['loss']:.6f}, grad_norm card "
            f"{card[0]['grad_norm']:.6f} CPU {cpu[0]['grad_norm']:.6f}, "
            f"{len(card[3])} gradient leaves: max |card - CPU| / leaf max "
            f"{g_worst:.3e} (bound {TRAIN_GRAD_RTOL}), updated params at lr "
            f"{lr1:.3g} max |card - CPU| {worst:.3e} ({flipped} beyond "
            f"{TRAIN_P_TOL}), {len(card[2])} MoE routings equal "
            f"{not any('route' in p for p in probs)}, planted faults "
            f"caught {not planted}; card step {card_s:.2f} s")
    with tempfile.TemporaryDirectory() as d:
        ops.reset_launches()
        clean = tiny_trainer(torch, dev, f"{d}/clean")
        t0 = time.perf_counter()
        p_clean, _ = clean.run()
        clean_s = time.perf_counter() - t0
        launches = ops.launch_counts()["bitserial_median"]
        try:
            tiny_trainer(torch, dev, f"{d}/crash", fail_at=17).run()
            problems.append("4e TINY: the injected failure did not raise")
        except RuntimeError as e:
            if "injected failure" not in str(e):
                raise
        resumed = tiny_trainer(torch, dev, f"{d}/crash")
        p_res, _ = resumed.run()
    err = max((a - b).abs().max().item()
              for a, b in zip(tree.leaves(p_clean), tree.leaves(p_res)))
    first, last = np.mean(clean.losses[:5]), np.mean(clean.losses[-5:])
    out["tiny_trainer"] = {"losses": clean.losses, "resume_max_abs_err": err,
                           "bitserial_median_launches": launches,
                           "seconds": clean_s,
                           "resumed_steps": len(resumed.losses)}
    if launches != 2 * (25 - 7):
        problems.append(f"4e TINY Trainer: bitserial_median launched "
                        f"{launches} times, want {2 * (25 - 7)}")
    if err > 1e-5:
        problems.append(f"4e TINY resume: max |resumed - uninterrupted| "
                        f"{err:.3e} > 1e-5")
    if not last < first - 0.2:
        problems.append(f"4e TINY: loss {first:.4f} -> {last:.4f}, want a "
                        "fall of 0.2")
    say(f"[{smi}] 4e TINY Trainer on the card: 25 steps in {clean_s:.2f} s "
        f"(loss {first:.4f} -> {last:.4f} over the first and last 5), "
        f"bitserial_median {launches} launches (want {2 * (25 - 7)}); crash "
        f"at 17, resume from 10 for {len(resumed.losses)} steps: max "
        f"|resumed - uninterrupted| {err:.3e} (bound 1e-5)")
    if problems:
        raise AssertionError("4e training: " + "; ".join(problems))
    return out


def train_qwen3_full(torch, dev, smi, params):
    """Phase 5r: qwen3-4b training at full width and depth on phase 5's
    bf16 weights (seed 0), which it trains in place (they are freed
    after).  ``SyntheticLM(DataConfig(seed=0, global_batch=2,
    seq_len=1,024))``, ``AdamWConfig(lr=3e-4, warmup_steps=2,
    total_steps=10)``, remat, loss chunks of 256: the port's ``Trainer``
    for 10 steps, its checkpoint directory a fresh temporary directory
    (removed at the end), then 2 steps through ``make_train_step`` with
    ``make_grad_transform(CompressConfig())``.

    Gates: every loss and gradient norm finite; the loss of batch 0 falls
    by ``TRAIN5R_MARGIN`` over the Trainer's 10 steps (a planted fault,
    one step at lr 0 first, must leave it where it was: the gate would
    fail it); ``bitserial_median`` launched 2 x (10 - 7) = 6 times by the
    straggler median and MAD; the checkpoint's ``latest_step`` is 10 and
    its meta.json lists every parameter and moment leaf.  If the
    temporary directory's disk cannot hold the checkpoint (40.2 GB at full
    depth), the depth is cut to what fits, never the save.  Printed:
    seconds a step, the launches, the peak memory, the checkpoint's bytes
    and seconds.  Returns the record."""
    import json
    import os
    import shutil
    import tempfile

    from repro_torch import bridge, configs
    from repro_torch.checkpoint import ckpt
    from repro_torch.core import grad_compress, tree
    from repro_torch.data import pipeline
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import adamw
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    cfg = configs.get_config("qwen3-4b")
    # checkpoint bytes: the parameters in their dtypes, two f32 moments
    nbytes = lambda ts: sum(t.numel() * (t.element_size() + 8)  # noqa: E731
                            for ts_ in ts for t in tree.leaves(ts_))
    fixed = nbytes([params["embed"], params["final_norm"]])
    per_layer = nbytes([params["layers"][0]])
    free = shutil.disk_usage(tempfile.gettempdir()).free
    n_layers = full = cfg.n_layers
    if fixed + n_layers * per_layer > 0.9 * free:
        n_layers = int((0.9 * free - fixed) // per_layer)
        if n_layers < 1:
            raise AssertionError(f"5r: {free / 1e9:.1f} GB free, the "
                                 "checkpoint cannot fit one layer")
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
        params = dict(params, layers=params["layers"][:n_layers])
    ck_pred = fixed + n_layers * per_layer
    say(f"[{smi}] 5r qwen3-4b training: {n_layers} of {full} layers "
        f"({'full depth' if n_layers == full else 'depth cut to fit the disk'}"
        f"), {free / 1e9:.1f} GB free for a {ck_pred / 1e9:.1f} GB "
        "checkpoint")
    data = pipeline.SyntheticLM(cfg, pipeline.DataConfig(
        seed=0, global_batch=TRAIN5R["batch"], seq_len=TRAIN5R["seq"]))
    aw = adamw.AdamWConfig(**TRAIN5R_AW)
    opts = steps.StepOptions(remat=True, loss_chunk=TRAIN5R["loss_chunk"])
    b0 = steps.batch_to(data.batch_at(0), dev)

    def eval_loss():
        with torch.no_grad():
            return float(tfm.train_loss(params, cfg, b0,
                                        loss_chunk=opts.loss_chunk)[0])

    problems, rec = [], {"n_layers": n_layers}
    torch.cuda.empty_cache()
    say(f"[{smi}] 5r start: {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
        "allocated (the weights)")
    torch.cuda.reset_peak_memory_stats()
    loss0 = eval_loss()
    # the planted fault: a step at lr 0 leaves every parameter as it was
    steps.make_train_step(cfg, dataclasses.replace(aw, lr=0.0), opts)(
        params, adamw.init(params), data.batch_at(0))
    fault_fall = loss0 - eval_loss()
    if fault_fall >= TRAIN5R_MARGIN:
        problems.append(f"planted fault (lr 0): the loss fell {fault_fall}")
    ckdir = tempfile.mkdtemp(prefix="repro_torch_5r_")
    try:
        tr = Trainer(cfg, TrainerConfig(n_steps=TRAIN5R["steps"],
                                        ckpt_dir=ckdir, ckpt_every=1000,
                                        log_every=1), aw,
                     steps.make_train_step(cfg, aw, opts), data,
                     init_params_fn=lambda: params, device=dev)
        save_s = []
        save = tr._save

        def timed_save(*a, **kw):
            t0 = time.perf_counter()
            out = save(*a, **kw)
            save_s.append(time.perf_counter() - t0)
            return out

        tr._save = timed_save
        ops.reset_launches()
        t0 = time.perf_counter()
        params, opt_state = tr.run()
        run_s = time.perf_counter() - t0
        launches = {k: v for k, v in ops.launch_counts().items() if v}
        loss10 = eval_loss()
        fall = loss0 - loss10
        step_dir = os.path.join(ckdir, "step_00000010")
        ck_bytes = sum(os.path.getsize(os.path.join(step_dir, f))
                       for f in os.listdir(step_dir))
        with open(os.path.join(step_dir, "meta.json")) as f:
            meta_keys = set(json.load(f)["leaves"])
        want_keys = set(ckpt.leaf_keys({
            "params": bridge.params_to_meta(params, cfg),
            "opt": adamw.OptState(bridge.params_to_meta(opt_state.m, cfg),
                                  bridge.params_to_meta(opt_state.v, cfg),
                                  opt_state.step)}))
        latest = ckpt.latest_step(ckdir)
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    if latest != TRAIN5R["steps"]:
        problems.append(f"checkpoint latest_step {latest}, want 10")
    if meta_keys != want_keys:
        problems.append(f"meta.json lists {len(meta_keys)} leaves, want "
                        f"{len(want_keys)} (missing "
                        f"{sorted(want_keys - meta_keys)[:3]})")
    if launches.get("bitserial_median", 0) != 2 * (TRAIN5R["steps"] - 7):
        problems.append(f"bitserial_median launched "
                        f"{launches.get('bitserial_median', 0)} times in "
                        "the Trainer, want 6")
    if not fall >= TRAIN5R_MARGIN:
        problems.append(f"batch 0's loss fell {fall:.4f} over 10 steps, "
                        f"want >= {TRAIN5R_MARGIN}")
    # 2 steps with k-means codebook gradient compression
    step_c = steps.make_train_step(cfg, aw, opts, grad_transform=(
        grad_compress.make_grad_transform(grad_compress.CompressConfig())))
    comp = []
    for s in (10, 11):
        t0 = time.perf_counter()
        params, opt_state, m = step_c(params, opt_state, data.batch_at(s))
        torch.cuda.synchronize()
        comp.append({"loss": float(m["loss"]),
                     "grad_norm": float(m["grad_norm"]),
                     "s": time.perf_counter() - t0})
    vals = tr.losses + [c["loss"] for c in comp] + [c["grad_norm"]
                                                    for c in comp]
    if not all(np.isfinite(v) for v in vals):
        problems.append(f"non-finite loss or gradient norm: {vals}")
    peak = torch.cuda.max_memory_allocated()
    med_s = float(np.median(tr.step_times))
    rec.update(losses=tr.losses, grad_norms=tr.grad_norms,
               step_s=tr.step_times, run_s=run_s,
               loss0=loss0, loss10=loss10, fall=fall, fault_fall=fault_fall,
               launches=launches, ckpt_bytes=ck_bytes, ckpt_s=save_s,
               peak_bytes=peak, compressed=comp,
               stragglers=tr.stragglers)
    say(f"[{smi}] 5r qwen3-4b Trainer: {TRAIN5R['steps']} steps of "
        f"{TRAIN5R['batch']} x {TRAIN5R['seq']:,} tokens, "
        f"{med_s:.3f} s a step (median; first {tr.step_times[0]:.3f} s), "
        f"losses {[round(x, 3) for x in tr.losses]}; batch 0's loss "
        f"{loss0:.4f} -> {loss10:.4f} (fall {fall:.4f}, gate >= "
        f"{TRAIN5R_MARGIN}; the lr-0 planted fault fell {fault_fall:.4f}); "
        f"launches {launches} (bitserial_median want 6); peak memory "
        f"allocated {peak / 2**30:.2f} GiB")
    say(f"[{smi}] 5r checkpoint of step 10: {ck_bytes / 1e9:.2f} GB "
        f"(predicted {ck_pred / 1e9:.2f}) in {save_s[-1]:.1f} s "
        f"({ck_bytes / save_s[-1] / 1e9:.2f} GB/s), latest_step {latest}, "
        f"meta.json {len(meta_keys)} leaves (want {len(want_keys)})")
    say(f"[{smi}] 5r 2 steps with gradient compression: "
        + ", ".join(f"loss {c['loss']:.4f} grad_norm {c['grad_norm']:.4f} "
                    f"in {c['s']:.2f} s" for c in comp))
    del params, opt_state, tr
    torch.cuda.empty_cache()
    if problems:
        raise AssertionError("5r qwen3-4b training: " + "; ".join(problems))
    return rec


def train_mesh_qwen3_full(torch, dev, smi, want):
    """Phase 5z: 5r's training through the mesh Trainer of a one-rank
    NCCL world (the module docstring), against ``want``, 5r's record.
    Returns the record."""
    import json
    import os
    import shutil
    import tempfile

    from repro_torch import bridge, configs
    from repro_torch.checkpoint import ckpt
    from repro_torch.core import tree
    from repro_torch.data import pipeline
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tfm
    from repro_torch.models.config import ShapeCell
    from repro_torch.optim import adamw
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    from repro_torch.sharding import rules as shard_rules

    full = configs.get_config("qwen3-4b")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = tfm.init_params(torch.Generator(device=dev).manual_seed(0),
                             full, device=dev)
    cfg = full
    if want["n_layers"] != full.n_layers:
        cfg = dataclasses.replace(full, n_layers=want["n_layers"])
        params = dict(params, layers=params["layers"][:want["n_layers"]])
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    data = pipeline.SyntheticLM(cfg, pipeline.DataConfig(
        seed=0, global_batch=TRAIN5R["batch"], seq_len=TRAIN5R["seq"]))
    aw = adamw.AdamWConfig(**TRAIN5R_AW)
    cell = ShapeCell("5z", TRAIN5R["seq"], TRAIN5R["batch"], "train")
    b0 = steps.batch_to(data.batch_at(0), dev)

    def eval_loss(p):
        with torch.no_grad():
            return float(tfm.train_loss(p, cfg, b0,
                                        loss_chunk=TRAIN5R["loss_chunk"])[0])

    problems, rec = [], {"n_layers": cfg.n_layers, "draw_s": draw_s}
    loss0 = eval_loss(params)
    torch.cuda.reset_peak_memory_stats()
    ckdir = tempfile.mkdtemp(prefix="repro_torch_5z_")
    try:
        with one_rank_mesh("5z") as mesh:
            opts = steps.pick_options(cfg, mesh, cell, remat=True,
                                      loss_chunk=TRAIN5R["loss_chunk"])
            if (opts.kv_repeat, opts.microbatch, opts.fsdp) != (1, 1, False):
                problems.append(f"options {opts}: want 5r's (kv_repeat 1, "
                                "microbatch 1, no fsdp)")
            step, _ = steps.lower_step(cfg, mesh, cell, opts, aw)
            tr = Trainer(cfg, TrainerConfig(n_steps=TRAIN5R["steps"],
                                            ckpt_dir=ckdir, ckpt_every=1000,
                                            log_every=1), aw, step, data,
                         init_params_fn=lambda: params, device=dev)
            save_s = []
            save = tr._save

            def timed_save(*a, **kw):
                t1 = time.perf_counter()
                out = save(*a, **kw)
                save_s.append(time.perf_counter() - t1)
                return out

            tr._save = timed_save
            issued = {}
            record = shard_rules._record

            def counting(kind, t):
                issued[kind] = issued.get(kind, 0) + 1
                record(kind, t)

            shard_rules._record = counting
            ops.reset_launches()
            t1 = time.perf_counter()
            try:
                params, opt_state = tr.run()
            finally:
                shard_rules._record = record
            run_s = time.perf_counter() - t1
            launches = {k: v for k, v in ops.launch_counts().items() if v}
            n_leaves = len(step.specs(params))
        peak = torch.cuda.max_memory_allocated()
        loss10 = eval_loss(params)
        step_dir = os.path.join(ckdir, "step_00000010")
        ck_bytes = sum(os.path.getsize(os.path.join(step_dir, f))
                       for f in os.listdir(step_dir))
        with open(os.path.join(step_dir, "meta.json")) as f:
            meta_keys = set(json.load(f)["leaves"])
        want_keys = set(ckpt.leaf_keys({
            "params": bridge.params_to_meta(params, cfg),
            "opt": adamw.OptState(bridge.params_to_meta(opt_state.m, cfg),
                                  bridge.params_to_meta(opt_state.v, cfg),
                                  opt_state.step)}))
        latest = ckpt.latest_step(ckdir)
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    rel = {k: [abs(a - b) / max(abs(b), 1e-30)
               for a, b in zip(got, want[k])]
           for k, got in (("losses", tr.losses),
                          ("grad_norms", tr.grad_norms))}
    for k, r in rel.items():
        if len(r) != TRAIN5R["steps"] or not max(r) <= TRAIN5Z_RTOL:
            problems.append(f"{k} {getattr(tr, k)} vs 5r's {want[k]}: "
                            f"relative differences {r}, want <= "
                            f"{TRAIN5Z_RTOL}")
    if launches.get("bitserial_median", 0) != 2 * (TRAIN5R["steps"] - 7):
        problems.append(f"bitserial_median launched "
                        f"{launches.get('bitserial_median', 0)} times in "
                        "the mesh Trainer, want 6")
    if latest != TRAIN5R["steps"]:
        problems.append(f"checkpoint latest_step {latest}, want 10")
    if meta_keys != want_keys:
        problems.append(f"meta.json lists {len(meta_keys)} leaves, want "
                        f"{len(want_keys)}")
    fall = loss0 - loss10
    if not fall >= TRAIN5R_MARGIN:
        problems.append(f"batch 0's loss fell {fall:.4f} over 10 steps, "
                        f"want >= {TRAIN5R_MARGIN}")
    bit = all(a == b for k in rel for a, b in zip(getattr(tr, k), want[k]))
    med_s = float(np.median(tr.step_times))
    rec.update(losses=tr.losses, grad_norms=tr.grad_norms, rel=rel,
               bit_for_bit=bit, step_s=tr.step_times, run_s=run_s,
               loss0=loss0, loss10=loss10, fall=fall, launches=launches,
               peak_bytes=peak, ckpt_bytes=ck_bytes, ckpt_s=save_s,
               leaves=n_leaves, issued=issued)
    say(f"[{smi}] 5z qwen3-4b mesh Trainer (one-rank NCCL mesh, "
        f"{cfg.n_layers} layers, weights drawn again in {draw_s:.1f} s): "
        f"{TRAIN5R['steps']} steps, {med_s:.3f} s a step (median; 5r "
        f"{float(np.median(want['step_s'])):.3f} s); losses equal to 5r's "
        f"{'bit for bit' if bit else 'within ' + str(TRAIN5Z_RTOL)} (max "
        f"relative differences: loss {max(rel['losses']):.3g}, grad_norm "
        f"{max(rel['grad_norms']):.3g}); batch 0's loss {loss0:.4f} -> "
        f"{loss10:.4f}; launches {launches} (bitserial_median want 6); "
        f"peak memory allocated {peak / 2**30:.2f} GiB (5r "
        f"{want['peak_bytes'] / 2**30:.2f} GiB)")
    say(f"[{smi}] 5z collectives a step: {n_leaves} leaves gathered "
        f"(GatherLeaf) and reduced, 3 all_reduce sites (label counts, "
        f"metrics, gradient norm), 1 for the straggler time; NCCL calls "
        f"issued in the run {issued or 0} (every mesh axis has size 1)")
    say(f"[{smi}] 5z mesh checkpoint of step 10 (save_gathered): "
        f"{ck_bytes / 1e9:.2f} GB in {save_s[-1]:.1f} s "
        f"({ck_bytes / save_s[-1] / 1e9:.2f} GB/s; 5r "
        f"{want['ckpt_bytes'] / 1e9:.2f} GB in {want['ckpt_s'][-1]:.1f} s), "
        f"latest_step {latest}, meta.json {len(meta_keys)} leaves")
    del params, opt_state, tr
    torch.cuda.empty_cache()
    if problems:
        raise AssertionError("5z qwen3-4b mesh training: "
                             + "; ".join(problems))
    return rec


# ---------------------------------------------------------------------------
# phase 6: k-medians through distance_argmin and bitserial_median, and the
# paper's pipeline
# ---------------------------------------------------------------------------


def kmedians(torch, dev):
    from repro_torch.core import clustering, prng
    from repro_torch.kernels import ops

    rng = np.random.default_rng(1)
    centers = rng.normal(size=(K_PTS, D_PTS)) * 4.0
    lab = rng.integers(0, K_PTS, size=N_PTS)
    x = (centers[lab] + rng.normal(size=(N_PTS, D_PTS))).astype(np.float32)
    x = torch.from_numpy(x).to(dev)
    cfg = clustering.ClusterConfig(k=K_PTS, metric="l1", centroid="median",
                                   bits=32, max_iters=20, seed=0)
    t0 = time.perf_counter()
    init = clustering.init_kmeanspp(prng.PRNGKey(0), x, K_PTS, "l1")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    first = clustering.fit(x, dataclasses.replace(cfg, max_iters=1), init)
    ops.reset_launches()
    t0 = time.perf_counter()
    res = clustering.fit(x, cfg, init)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = ops.launch_counts()
    n_da, n_med = counts["distance_argmin"], counts["bitserial_median"]
    inertia, inertia1 = float(res.inertia), float(first.inertia)
    if n_da <= 0 or n_med <= 0:
        raise AssertionError(f"fit launched distance_argmin {n_da} and "
                             f"bitserial_median {n_med} times: want both > 0")
    if not (np.isfinite(inertia) and inertia <= inertia1):
        raise AssertionError(f"inertia {inertia} vs first iteration "
                             f"{inertia1}")
    iters = int(res.n_iters)
    say(f"k-medians fit: threefry k-means++ start in {init_s:.2f} s; "
        f"{iters} iterations in {secs:.4f} s ({secs / iters * 1e3:.3f} ms "
        f"an iteration), {n_da} "
        f"distance_argmin and {n_med} bitserial_median launches, inertia "
        f"{inertia!r} (first iteration {inertia1!r}); assign sha256 "
        f"{sha16(res.assign)}, centroids {sha16(res.centroids)}")
    return {"launches": n_da, "median_launches": n_med,
            "iters": iters, "inertia": inertia,
            "inertia_first": inertia1, "seconds": secs, "init_s": init_s,
            "assign_sha256": sha16(res.assign),
            "centroids_sha256": sha16(res.centroids)}


def quickstart(torch, dev):
    """examples/quickstart_torch.py's pipeline on the card at the table
    generators' default sizes, held against the same pipeline on the CPU:
    the same k* (the census table's true k, 5) and recognition rates within
    half a point (assignments may differ at L1 near-ties between the
    kernel's and the CPU's distance sums)."""
    import runpy

    from repro_torch.kernels import ops

    run = runpy.run_path(str(ROOT / "examples" / "quickstart_torch.py"),
                         run_name="quickstart_torch")["run"]
    sizes = dict(wine_n=4595, census_n=5000)
    lines = []
    ops.reset_launches()
    t0 = time.perf_counter()
    card = run(dev, say=lines.append, **sizes)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = ops.launch_counts()
    for line in lines:
        say(f"quickstart: {line}")
    cpu_lines = []
    cpu = run("cpu", say=cpu_lines.append, **sizes)
    same = sum(a == b for a, b in zip(lines, cpu_lines))
    rates = {k: card[k]["rate"] for k in ("kmedians", "kmeans")}
    # one distance_argmin per Lloyd iteration of the two fits (L1 k-medians,
    # L2 k-means) and of each select_k fit (L2, at least one iteration
    # each); one bitserial_median per k-medians iteration and one for the
    # feature medians
    need_l1 = card["kmedians"]["iters"]
    need_l2 = card["kmeans"]["iters"] + len(card["scores"])
    need_bsm = card["kmedians"]["iters"] + 1
    if (counts["distance_argmin l1"] < need_l1
            or counts["distance_argmin l2"] < need_l2
            or counts["bitserial_median"] < need_bsm):
        raise AssertionError(f"quickstart launches {counts}: want "
                             f"distance_argmin L1 >= {need_l1}, L2 >= "
                             f"{need_l2} and bitserial_median >= {need_bsm}")
    if not np.isfinite(card["median"]).all():
        raise AssertionError("quickstart: non-finite medians")
    if card["k_opt"] != cpu["k_opt"] or card["k_opt"] != 5:
        raise AssertionError(f"quickstart k* {card['k_opt']} on the card, "
                             f"{cpu['k_opt']} on the CPU, want 5")
    for k, r in rates.items():
        if not (0.95 <= r <= 1.0 and abs(r - cpu[k]["rate"]) <= 0.005):
            raise AssertionError(f"quickstart {k} recognition {r} on the "
                                 f"card, {cpu[k]['rate']} on the CPU")
    say(f"quickstart on the card in {secs:.2f} s: k* {card['k_opt']}, "
        f"recognition k-medians {rates['kmedians']:.4f} / k-means "
        f"{rates['kmeans']:.4f}; {counts['bitserial_median']} "
        f"bitserial_median and {counts['distance_argmin']} distance_argmin "
        f"launches (L1 {counts['distance_argmin l1']}, L2 "
        f"{counts['distance_argmin l2']}); {same} of {len(lines)} printed "
        "lines equal the CPU run's")
    return {"seconds": secs, "k_opt": card["k_opt"], "rates": rates,
            "launches": counts, "lines": lines, "lines_equal_cpu": same}


# ---------------------------------------------------------------------------
# phase 7: times and bounds
# ---------------------------------------------------------------------------


def roofline_work():
    """``src/repro_torch/roofline/work.py`` of this checkout, the kernels'
    work models and bounds that the dry run counts with, loaded by path:
    benchmarks/time_kernels.py puts another commit's ``src`` first on the
    path to time its kernels."""
    import importlib.util

    name = "chip_smoke_roofline_work"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            name, ROOT / "src" / "repro_torch" / "roofline" / "work.py")
        sys.modules[name] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(sys.modules[name])
    return sys.modules[name]


def work_fields(w):
    """The bound columns of a kernel's work model."""
    b_ms, b_by = w.bound()
    return dict(bound_ms=b_ms, bound_by=b_by, bytes=w.nbytes,
                **{k: v for k, v in w.detail.items() if k != "worst_case"})


def sdpa_yardstick(torch, x):
    """One scaled_dot_product_attention over [centroids ⊕ ring] with a
    float mask carrying log(count) and the masks (built outside the
    timed call).  q (B, L, Hq, Dh) with chunk_len, or (B, Hq, Dh)."""
    import torch.nn.functional as F

    q = x["q"] if x["q"].dim() == 4 else x["q"][:, None]
    b, n_l, hq, _ = q.shape
    c, r = x["k_cents"].shape[1], x["k_tail"].shape[1]
    g = hq // x["k_tail"].shape[2]
    k = torch.cat([x["k_cents"], x["k_tail"]], 1).transpose(1, 2)
    v = torch.cat([x["v_cents"], x["v_tail"]], 1).transpose(1, 2)
    k = k.repeat_interleave(g, 1).contiguous()                 # (B, Hq, E, Dh)
    v = v.repeat_interleave(g, 1).contiguous()
    q = q.transpose(1, 2).contiguous()                         # (B, Hq, L, Dh)
    dev = q.device
    cnt = x["counts"].transpose(1, 2).repeat_interleave(g, 1)  # (B, Hq, C)
    bias_c = torch.where(cnt > 0, torch.log(cnt.clamp_min(1e-9)),
                         torch.full_like(cnt, -1e30))[:, :, None, :]
    cl = x["chunk_len"]
    cl = (torch.ones(b, dtype=torch.long, device=dev) if cl is None
          else cl.long())
    t = x["t"].long()[:, None]
    tw = t + cl[:, None]
    s = torch.arange(r, device=dev)[None]
    pos = torch.where(tw <= r, s, tw - r + torch.remainder(s - tw, r))
    i = torch.arange(n_l, device=dev)[None, :, None]
    ok = ((pos[:, None, :] <= t[:, :, None] + i)
          & (pos[:, None, :] >= x["cov"].long()[:, None, None]))
    bias_t = torch.where(ok, 0.0, -1e30)[:, None].expand(b, hq, n_l, r)
    mask = torch.cat([bias_c.expand(b, hq, n_l, c), bias_t], -1).to(q.dtype)
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                  scale=DH ** -0.5)


def paged_sdpa_yardstick(torch, args):
    """One scaled_dot_product_attention over each row's [centroids ⊕
    ring gathered through its block table] (gather and float mask built
    outside the timed call), every row of the bucket a batch entry."""
    import torch.nn.functional as F

    n, hq, dh = args["q"].shape
    hkv = args["k_cents"].shape[2]
    g = hq // hkv
    r = args["row_bt"].shape[1] * args["k_pool"].shape[1]
    rs = args["row_slot"].long()
    dev = args["q"].device

    def entries(cents, pool):
        ring = pool[args["row_bt"].long()].reshape(n, r, hkv, dh)
        kv = torch.cat([cents[rs], ring], 1).transpose(1, 2)   # (N, Hkv, E, Dh)
        return kv.repeat_interleave(g, 1).contiguous()

    k = entries(args["k_cents"], args["k_pool"])
    v = entries(args["v_cents"], args["v_pool"])
    q = args["q"][:, :, None].contiguous()                     # (N, Hq, 1, Dh)
    cnt = args["counts"][rs].transpose(1, 2).repeat_interleave(g, 1)
    bias_c = torch.where(cnt > 0, torch.log(cnt.clamp_min(1e-9)),
                         torch.full_like(cnt, -1e30))[:, :, None, :]
    tw = args["tw"].long()[:, None]
    s = torch.arange(r, device=dev)[None]
    pos = torch.where(tw <= r, s, tw - r + torch.remainder(s - tw, r))
    ok = ((pos < args["qpos1"].long()[:, None])
          & (pos >= args["cov"].long()[:, None]))
    bias_t = torch.where(ok, 0.0, -1e30)[:, None, None, :].expand(n, hq, 1, r)
    mask = torch.cat([bias_c, bias_t], -1).to(q.dtype)
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                  scale=dh ** -0.5)


def with_groups(torch, pcd, args):
    """``args`` with the row-group table the engine would build for its
    rows (``pcd.group_rows``); unchanged when ``pcd`` has none (an older
    kernel that scores one row per block)."""
    if not hasattr(pcd, "group_rows"):
        return args
    grp = pcd.group_rows(args["row_slot"].cpu().numpy(),
                         args["qpos1"].cpu().numpy(),
                         args["tw"].cpu().numpy(),
                         args["q"].shape[1] // args["k_cents"].shape[2])
    return dict(args, row_group=torch.from_numpy(grp).to(args["q"].device))


def time_clustered(torch, cd, x, cl, plain=False):
    """B1 at one form: kernel device time, wrapper call time, SDPA device
    time and bound; the plain version's call time when ``plain``."""
    kw = dict(scale=DH ** -0.5)
    run = lambda: cd.clustered_decode_cuda(**x, **kw)     # noqa: E731
    out = dict(ms=device_ms(torch, run, "clustered_decode_kernel"),
               call_ms=time_ms(torch, run),
               library_ms=device_ms(torch, sdpa_yardstick(torch, x)),
               chunk_len=list(cl),
               **work_fields(roofline_work().clustered_decode_work(**x)))
    out["plain_ms"] = (time_ms(torch, lambda: cd.clustered_decode_plain(
        **x, **kw)) if plain else None)
    return out


def time_paged(torch, pcd, x, cl, bucket, plain=False):
    """B2 at one shape (rows grouped as the engine groups them): kernel
    device time, wrapper call time, SDPA device time and bound; the plain
    version's call time when ``plain``."""
    args, rows, n_mapped = paged_inputs(torch, x, cl, bucket)
    args = with_groups(torch, pcd, args)
    kw = dict(scale=DH ** -0.5)
    run = lambda: pcd.paged_clustered_decode_cuda(**args, **kw)  # noqa: E731
    out = dict(ms=device_ms(torch, run, "paged_clustered_decode_kernel"),
               call_ms=time_ms(torch, run),
               library_ms=device_ms(torch,
                                    paged_sdpa_yardstick(torch, args)),
               bucket=bucket, **work_fields(
                   roofline_work().paged_clustered_decode_work(**args)))
    if (out["rows"], out["mapped_blocks"]) != (len(rows), n_mapped):
        raise AssertionError(
            f"paged work model: {out['rows']} rows over "
            f"{out['mapped_blocks']} blocks, the layout's {len(rows)} over "
            f"{n_mapped}")
    out["plain_ms"] = (time_ms(torch, lambda: (
        pcd.paged_clustered_decode_plain(**args, **kw))) if plain else None)
    return out


def time_paged_quota(torch, pcd, dev, plain=True):
    """B2 in 5h's quota layout, bf16 (``quota_inputs``' four decode rows):
    kernel device time, wrapper call time, the plain version's call time
    (unless not ``plain``), SDPA device time over each row's gathered
    entries, and the bound.  Bytes: each row's q and output once, each
    slot's centroid and count once, the blocks holding a position some
    row can see once (not the reserved blocks past it), the row vectors
    and block-table rows once; flops: each row against its visible
    positions (the count-0 centroid is masked)."""
    args, _, needed = quota_inputs(torch, dev, torch.bfloat16)
    args = with_groups(torch, pcd, args)
    kw = dict(scale=DH ** -0.5)
    run = lambda: pcd.paged_clustered_decode_cuda(**args, **kw)  # noqa: E731
    out = dict(ms=device_ms(torch, run, "paged_clustered_decode_kernel"),
               call_ms=time_ms(torch, run),
               library_ms=device_ms(torch,
                                    paged_sdpa_yardstick(torch, args)),
               needed_blocks=needed,
               shape=f"{B} decode rows at {Q_POS}, C 1 (count 0), ring "
                     f"{Q_R} in {Q_R // BS} blocks of {BS}",
               **work_fields(roofline_work().paged_clustered_decode_work(
                   **args)))
    if out["mapped_blocks"] != needed:
        raise AssertionError(f"quota work model: {out['mapped_blocks']} "
                             f"blocks, the layout's {needed}")
    out["plain_ms"] = (time_ms(torch, lambda: (
        pcd.paged_clustered_decode_plain(**args, **kw))) if plain else None)
    return out


def decode_times(torch, cd, pcd, dev, plain=True):
    """B1 in its mixed (chunk_len CL_SLOTS), serve-like mixed (CL_SERVE:
    what the engine launches while one prompt is admitted) and one-token
    forms, and B2 in its mixed (the phase-3 rows, 256-row bucket) and
    decode-only (one row per slot) forms, bf16; B1 also one-token at the
    dry run's cell (``DRY_GEO``: 128 slots, C 512).
    benchmarks/time_kernels.py runs it against another commit's
    kernels."""
    x = decode_inputs(torch, dev, torch.bfloat16)
    xs = dict(x, chunk_len=torch.tensor(CL_SERVE, dtype=torch.int32,
                                        device=dev))
    x1 = dict(x, q=x["q"][:, 0].contiguous(), chunk_len=None)
    xd = decode_inputs(torch, dev, torch.bfloat16, geo=DRY_GEO)
    xd = dict(xd, q=xd["q"][:, 0].contiguous(), chunk_len=None)
    return {
        "clustered_decode": time_clustered(torch, cd, x, CL_SLOTS, plain),
        "clustered_decode serve_mixed": time_clustered(torch, cd, xs,
                                                       CL_SERVE),
        "clustered_decode one_token": time_clustered(torch, cd, x1,
                                                     [1] * B),
        "paged_clustered_decode": time_paged(torch, pcd, x, CL_SLOTS,
                                             N_BUCKET, plain),
        "paged_clustered_decode decode_only": time_paged(
            torch, pcd, x, [1] * B, B, plain),
        "paged_clustered_decode quota": time_paged_quota(torch, pcd, dev,
                                                         plain),
        "clustered_decode dryrun": time_clustered(torch, cd, xd,
                                                  [1] * DRY_SLOTS),
    }


def time_median(torch, bsm, u, a, k, w, bits, plain_n):
    """B3 at one shape: kernel, plain (``plain_n`` calls; 0: not timed)
    and bound.  Bytes: the int32 assignments and f32 weights of every
    point read once, the int64 words of the points that can vote (weight
    not 0, cluster in [0, k): the median does not depend on the others,
    and the kernel reads no word of a point of weight 0) read once, the
    int64 medians and f32 totals written once; ``bytes_all`` counts every
    point's words.  Operations: one f32 vote add per (voting point,
    column, bit), at the f32 rate (``roofline/work.py``)."""
    run = lambda: bsm.grouped_median_bits_cuda(u, a, k, w,  # noqa: E731
                                               bits=bits)
    plain = time_ms(torch, lambda: bsm.grouped_median_bits_plain(
        u, a, k, weights=w, bits=bits), n=plain_n, warm=1) if plain_n \
        else None
    w_model = roofline_work().bitserial_median_work(u, a, k, w, bits=bits)
    return dict(ms=device_ms(torch, run, REPRO_KERNELS),
                call_ms=time_ms(torch, run), plain_ms=plain,
                library_ms=None, votes=w_model.flops,
                library="none: no PyTorch call computes a weighted "
                        "per-cluster median", **work_fields(w_model))


def time_flash_decode(torch, fd, dev, plain=True):
    """B5 in bf16 at the phase-3 shape: kernel, plain (unless not
    ``plain``), SDPA (enable_gqa, boolean mask of the positions < t) and
    bound.  Bytes: q and the output once, the keys and values of the t
    visible positions once; operations as the decode work models count them:
    the kernel runs q.k and p.v (p = hi + lo) on bf16 tensor cores, as
    B1 and B2 do."""
    import torch.nn.functional as F

    q, k, v = decode_cache(torch, dev, torch.bfloat16)
    kw = dict(scale=DH ** -0.5)
    run = lambda: fd.flash_decode_cuda(q, k, v, FD_T, **kw)  # noqa: E731
    plain_ms = time_ms(torch, lambda: fd.flash_decode_plain(
        q, k, v, FD_T, **kw)) if plain else None
    q4 = q[:, :, None].contiguous()                       # (B, Hq, 1, Dh)
    k4, v4 = (x.transpose(1, 2).contiguous() for x in (k, v))
    mask = (torch.arange(FD_S, device=dev) < FD_T)[None, None, None, :]
    lib = device_ms(torch, lambda: F.scaled_dot_product_attention(
        q4, k4, v4, attn_mask=mask, enable_gqa=True, **kw))
    return dict(ms=device_ms(torch, run, REPRO_KERNELS),
                call_ms=time_ms(torch, run), plain_ms=plain_ms,
                library_ms=lib, **work_fields(
                    roofline_work().flash_decode_work(q, k, v, FD_T)))


def time_distance(torch, da, x, c, metric, plain=True):
    """B4 in one metric: the kernel's device time, its call time, the plain
    version's (unless ``plain`` is False), the yardstick ``torch.cdist``
    then ``.min(1)`` (two calls; L2's cdist gives the root of the distance,
    the same argmin), the bound, and sha256 digests of the outputs, with
    the shape it timed."""
    n, d = x.shape
    k = c.shape[0]
    run = lambda: da.distance_argmin_cuda(x, c, metric=metric)  # noqa: E731
    p = 1.0 if metric == "l1" else 2.0
    lib = lambda: torch.cdist(x, c, p=p).min(1)                 # noqa: E731
    w_model = roofline_work().distance_argmin_work(n, d, k, metric)
    a, m = run()
    plain_ms = (time_ms(torch, lambda: da.distance_argmin_plain(
        x, c, metric=metric), n=20, warm=2) if plain else None)
    return dict(ms=device_ms(torch, run, REPRO_KERNELS),
                call_ms=time_ms(torch, run), plain_ms=plain_ms,
                library_ms=device_ms(torch, lib),
                instructions=w_model.flops, **work_fields(w_model),
                assign_sha256=sha16(a), mind_sha256=sha16(m),
                shape=f"{n} x {d}, K {k}")


def timings(torch, cd, pcd, da, bsm, fd, dev):
    tm = decode_times(torch, cd, pcd, dev)
    # the kernels line's rows: L1 at the fit's shape, L2 at the quickstart's
    # k sweep; L2 at the fit's shape as well
    for name, metric, shape in (
            ("distance_argmin l1", "l1", (N_PTS, D_PTS, K_PTS)),
            ("distance_argmin l2", "l2", DA_L2_TIMED),
            ("distance_argmin l2 (fit's shape)", "l2",
             (N_PTS, D_PTS, K_PTS))):
        x, c = da_inputs(torch, dev, *shape)
        tm[name] = time_distance(torch, da, x, c, metric)
        del x, c
    _, m, k, bits = MED_CASES[0]
    u, a, w = median_inputs(torch, dev, m, k, bits)
    tm["bitserial_median"] = time_median(torch, bsm, u, a, k, w, bits,
                                         plain_n=10)
    del u, a, w
    u, a, w = admission_inputs(torch, dev)
    tm["bitserial_median admission"] = time_median(torch, bsm, u, a, C, w,
                                                   16, plain_n=3)
    del u, a, w
    u, a = stream_inputs(torch, dev)
    tm["bitserial_median streamed"] = time_median(torch, bsm, u, a, K_PTS,
                                                  None, 32, plain_n=3)
    del u, a
    tm["flash_decode"] = time_flash_decode(torch, fd, dev)
    return tm


def main() -> int:
    import torch

    # phase 1: device
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_line()
    say(smi)
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels import bitserial_median as bsm
    from repro_torch.kernels import clustered_decode as cd
    from repro_torch.kernels import distance_argmin as da
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import paged_clustered_decode as pcd
    from repro_torch.models import attention
    from repro_torch.runtime.kv_pool import PagedKVConfig

    record = {"card": smi, "kind": torch.cuda.get_device_name(0),
              "torch": torch.__version__, "cuda": torch.version.cuda}
    t_all = time.perf_counter()
    phase_s = {}
    mark = [time.perf_counter()]

    def done(name):
        now = time.perf_counter()
        phase_s[name] = now - mark[0]
        mark[0] = now
        say(f"phase {name}: {phase_s[name]:.1f} s")

    # phase 2: build
    t0 = time.perf_counter()
    built = _build.build_all()
    say(f"build: {time.perf_counter() - t0:.1f} s "
        + ", ".join(f"{k} {v:.1f} s" for k, v in built.items()))
    record["build_s"] = built
    record["ptxas"] = dict(_build.BUILD_LOG)
    done("2 build")

    # phase 3: kernels vs plain (B1 and B2 also at gemma2's heads, at 4b's
    # TINY 'G' layer, at the serving CLI's cache and steps and in the quota
    # layout)
    cd_err = check_clustered_decode(torch, cd, dev)
    pcd_err = check_paged_decode(torch, cd, pcd, dev)
    gemma_err = check_gemma_decode(torch, cd, pcd, dev)
    tiny_err = check_rec_tiny_decode(torch, cd, pcd, dev)
    moe_err = max(check_moe_decode(torch, cd, pcd, dev),
                  check_moe_decode(torch, cd, pcd, dev, IVL_HQ, IVL_HKV,
                                   "internvl2"),
                  check_moe_decode(torch, cd, pcd, dev, HQ, HKV,
                                   "serving CLI", CLI_GEO, CLI_STEPS))
    quota_err = check_paged_quota(torch, attention, pcd, dev)
    dry_err = check_dryrun_decode(torch, cd, dev)
    cd_err = max(cd_err, gemma_err, tiny_err, moe_err, dry_err)
    pcd_err = max(pcd_err, gemma_err, tiny_err, moe_err, quota_err)
    da_err = check_distance_argmin(torch, da, dev)
    bsm_err = max(check_bitserial_median(torch, bsm, dev),
                  check_trainer_median(torch, bsm, dev))
    fd_err = check_flash_decode(torch, fd, dev)
    done("3 kernels vs plain")

    # phase 4: small model, card vs CPU
    check_small_model(torch, dev)
    done("4 small model")

    # phase 4b: TINY 'GM' / 'GR', the clustered kernels beside recurrent
    # state, card vs CPU
    rec_tiny = check_rec_tiny(torch, dev, smi)
    record["rec_tiny"] = rec_tiny
    done("4b recurrent TINY")

    # phase 4c: the reduced qwen2-moe, card vs CPU, and the metrics
    # reference's battery on the card
    record["moe_tiny"] = check_moe_tiny(torch, dev, smi)
    done("4c qwen2-moe reduced + metrics reference")

    # phase 4d: the reduced deepseek-v3 (MLA), internvl2 (frontend stub)
    # and seamless (encoder-decoder), card vs CPU
    record["zoo_tiny"] = check_zoo_tiny(torch, dev, smi)
    done("4d MLA / frontend / enc-dec reduced")

    # phase 4e: training, the reduced zoo card vs CPU, the TINY Trainer
    train_tiny = check_training_tiny(torch, dev, smi)
    record["train_tiny"] = train_tiny
    done("4e training reduced + TINY Trainer")

    # phase 5: serve
    serve, params = serve_qwen3(torch, dev, smi)
    record["serve"] = serve

    # phase 5b: the same requests through the paged engine
    paged = serve_qwen3(torch, dev, smi, PagedKVConfig(block_size=16),
                        params)[0]
    record["serve_paged"] = paged
    record["paged_vs_dense_first_diff"] = compare_tokens(serve, paged)

    # phase 5c: blocking admission, dense
    blocking = serve_qwen3(torch, dev, smi, None, params, chunk=0)[0]
    record["serve_blocking"] = blocking
    record["blocking_vs_chunked_first_diff"] = compare_tokens(
        serve, blocking, "blocking vs chunked (dense)")

    # phase 5d: blocking admission, paged
    paged_blk = serve_qwen3(torch, dev, smi, PagedKVConfig(block_size=16),
                            params, chunk=0)[0]
    record["serve_paged_blocking"] = paged_blk
    record["paged_vs_dense_blocking_first_diff"] = compare_tokens(
        blocking, paged_blk, "paged vs dense (blocking)")

    # phase 5e: the static engine over exact KV
    static = serve_static(torch, dev, smi, params)
    record["serve_static"] = static
    done("5-5e qwen3-4b serves")

    # phase 5v: the same requests through the mesh engine of a one-rank
    # NCCL world, dense (its paged serve cut: 5y serves paged on the mesh)
    mesh = serve_mesh(torch, dev, smi, params, serve)
    record["serve_mesh"] = mesh
    done("5v mesh serve")

    # phase 5h: paged exact KV under QuotaRetention, qwen3's weights still
    # resident
    quota = serve_quota(torch, dev, smi, params, static)
    record["serve_quota"] = quota
    done("5h quota serve")

    # phases 5i and 5j: templated bursts, prefix-shared and through the
    # template store, qwen3's weights still resident
    prefix = serve_prefix_share(torch, dev, smi, params)
    record["serve_prefix_share"] = prefix
    done("5i prefix sharing")
    store = serve_template_store(torch, dev, smi, params)
    record["serve_template_store"] = store
    done("5j template store")

    # phase 5k: the SLO scheduler over an oversubscribed pool, traced, and
    # the full-width swap round trip
    slo = serve_slo(torch, dev, smi, params)
    record["serve_slo"] = slo
    done("5k SLO scheduler")

    # phase 5y: 5j's store bursts and 5k's scheduled stream through the
    # one-rank NCCL mesh, tokens and counters held to 5j's and 5k's
    mesh_rt = serve_mesh_runtime(torch, dev, smi, params, store, slo)
    record["serve_mesh_runtime"] = mesh_rt
    done("5y mesh prefix sharing and SLO")

    # phases 5s and 5t: the serving CLI at full width (the subprocess draws
    # its own weights; (b) and (c) serve qwen3's), then the example twin
    cli = serve_cli_full(torch, dev, smi, params)
    record["serve_cli"] = cli
    done("5s serving CLI")
    example = serve_example_full(torch, dev, smi)
    record["serve_example"] = example
    done("5t example twin")

    # phase 5u: the dry run's qwen3-4b x decode_32k cell (clustered) on the
    # card, on the same weights, before training moves them
    dry = dryrun_cell_full(torch, dev, smi, params)
    record["dryrun"] = dry
    done("5u dry run")

    # phase 5r: qwen3-4b training at full width on the same weights
    train_full = train_qwen3_full(torch, dev, smi, params)
    record["train_qwen3"] = train_full
    done("5r qwen3-4b training")
    del params
    torch.cuda.empty_cache()

    # phase 5z: 5r's training through the mesh Trainer of a one-rank NCCL
    # world, on 5r's starting weights drawn again
    train_mesh = train_mesh_qwen3_full(torch, dev, smi, train_full)
    record["train_qwen3_mesh"] = train_mesh
    done("5z qwen3-4b mesh training")

    # phases 5f and 5g: gemma2-27b at full width and depth, dense then paged
    windowed, gparams = serve_gemma2(torch, dev, smi)
    record["serve_gemma2"] = windowed
    done("5f gemma2 dense (weights included)")
    windowed_pg = serve_gemma2(torch, dev, smi, PagedKVConfig(block_size=BS),
                               gparams)[0]
    record["serve_gemma2_paged"] = windowed_pg
    record["gemma2_paged_vs_dense_first_diff"] = compare_tokens(
        windowed, windowed_pg, "gemma2 paged vs dense")
    done("5g gemma2 paged")
    del gparams
    torch.cuda.empty_cache()

    # phases 5l and 5m: the recurrent families at full width (cut to
    # RG_LAYERS and MAMBA_LAYERS)
    record["serve_recurrentgemma"] = serve_recurrent_full(
        torch, dev, smi, "recurrentgemma-9b")
    done("5l recurrentgemma-9b (weights included)")
    record["serve_mamba2"] = serve_recurrent_full(torch, dev, smi,
                                                  "mamba2-2.7b")
    done("5m mamba2-2.7b (weights included)")

    # phases 5n and 5w: qwen2-moe-a2.7b at full width and depth, then its
    # requests on its weights through a one-rank NCCL mesh
    moe, mparams = serve_moe_full(torch, dev, smi)
    record["serve_qwen2_moe"] = moe
    done("5n qwen2-moe-a2.7b (weights included)")
    moe["mesh"] = serve_moe_mesh(torch, dev, smi, mparams, moe["serves"])
    done("5w qwen2-moe-a2.7b mesh")
    del mparams
    torch.cuda.empty_cache()

    # phases 5o-5q: MLA, the frontend stub and the encoder-decoder at full
    # width (deepseek-v3 and internvl2 with their depth cut to fit), 5x
    # after 5o: deepseek-v3 on its weights through a one-rank NCCL mesh
    dsv3, dparams = serve_deepseek_full(torch, dev, smi)
    record["serve_deepseek_v3"] = dsv3
    done("5o deepseek-v3-671b (weights included)")
    dsv3["mesh"] = serve_deepseek_mesh(torch, dev, smi, dparams,
                                       dsv3["serves"])
    done("5x deepseek-v3-671b mesh")
    del dparams
    torch.cuda.empty_cache()
    ivl = serve_internvl_full(torch, dev, smi)
    record["serve_internvl2"] = ivl
    done("5p internvl2-76b (weights included)")
    record["seamless"] = run_seamless_full(torch, dev, smi)
    done("5q seamless-m4t-medium (weights included)")

    # phase 6: k-medians through both clustering kernels, the pipeline
    km = kmedians(torch, dev)
    record["kmedians"] = km
    qs = quickstart(torch, dev)
    record["quickstart"] = qs
    done("6 clustering")

    # phase 7: times
    tm = timings(torch, cd, pcd, da, bsm, fd, dev)
    record["times"] = tm
    done("7 times")
    fmt = lambda v: "None" if v is None else f"{v:.4f}"    # noqa: E731
    for name, v in tm.items():
        say(f"[{smi}] {name}: kernel_ms {v['ms']:.4f} (device) call_ms "
            f"{v['call_ms']:.4f} plain_ms {fmt(v['plain_ms'])} library_ms "
            f"{fmt(v['library_ms'])} (device) bound_ms {v['bound_ms']:.4f} "
            f"({v['bound_by']})"
            + (f" at {v['shape']}" if "shape" in v else ""))
    per_step = {mode: rec["launches"]["bitserial_median"]
                / rec["engine_steps"]
                for mode, rec in (("dense", serve), ("paged", paged),
                                  ("dense blocking", blocking),
                                  ("paged blocking", paged_blk))}
    say(f"launches per engine step: clustered_decode (dense) and "
        f"paged_clustered_decode (paged) {serve['n_layers']}; "
        f"bitserial_median "
        + ", ".join(f"{v:.3f} {k}" for k, v in per_step.items())
        + " (the memory manager's k-medians); "
        f"distance_argmin {serve['launches']['distance_argmin']} in the "
        f"dense serve (the memory manager assigns with the plain distance, "
        f"as the reference does) and {km['launches']} in the k-medians fit, "
        f"which launched bitserial_median {km['median_launches']} times; "
        f"flash_decode {serve['launches']['flash_decode']} in the dense "
        "serve (no model calls it, as in the reference)")
    b4_ms = km["launches"] * tm["distance_argmin l1"]["ms"]
    say(f"[{smi}] k-medians fit: {km['seconds']:.4f} s for {km['iters']} "
        f"iterations, {km['seconds'] / km['iters'] * 1e3:.3f} ms an "
        f"iteration; distance_argmin {km['launches']} x "
        f"{tm['distance_argmin l1']['ms']:.4f} ms = {b4_ms:.3f} ms of device "
        f"time, {b4_ms / (km['seconds'] * 1e3) * 100:.2f} % of the fit")
    record["seconds"] = time.perf_counter() - t_all
    record["phase_s"] = phase_s
    say("phase seconds: " + ", ".join(f"{k} {v:.1f}"
                                      for k, v in phase_s.items())
        + f"; total {record['seconds']:.1f}")
    tq = tm["paged_clustered_decode quota"]

    kernels = [
        dict(name="clustered_decode", route="cuda",
             source="src/repro_torch/csrc/clustered_decode.cu",
             replaces="src/repro/kernels/clustered_decode.py:107",
             launches=serve["launches"]["clustered_decode"],
             launches_blocking=blocking["launches"]["clustered_decode"],
             launches_windowed=windowed["launches"]["clustered_decode"],
             launches_recurrent={p: r["card"]["chunked"]["launches"][
                 "clustered_decode"] for p, r in rec_tiny.items()},
             launches_moe={m: moe["serves"][m]["launches"][
                 "clustered_decode"] for m in ("chunked", "blocking")},
             launches_frontend=ivl["serves"]["blocking"]["launches"][
                 "clustered_decode"],
             launches_cli=cli["a"]["launches"]["clustered_decode"],
             launches_example=example["launches"]["clustered_decode"],
             launches_mesh=mesh["dense"]["launches"]["clustered_decode"],
             launches_mesh_moe=moe["mesh"]["chunked"]["launches"][
                 "clustered_decode"],
             launches_dryrun_per_step=dry["record"]["launches_per_step"][
                 "clustered_decode"],
             dryrun={k: tm["clustered_decode dryrun"][k] for k in
                     ("ms", "bound_ms", "bound_by", "library_ms")},
             max_abs_err=cd_err, ms=tm["clustered_decode"]["ms"],
             plain_ms=tm["clustered_decode"]["plain_ms"],
             bound_ms=tm["clustered_decode"]["bound_ms"],
             bound_by=tm["clustered_decode"]["bound_by"],
             library_ms=tm["clustered_decode"]["library_ms"]),
        dict(name="paged_clustered_decode", route="cuda",
             source="src/repro_torch/csrc/paged_clustered_decode.cu",
             replaces="src/repro/kernels/paged_clustered_decode.py:53",
             launches=paged["launches"]["paged_clustered_decode"],
             launches_blocking=paged_blk["launches"][
                 "paged_clustered_decode"],
             launches_windowed=windowed_pg["launches"][
                 "paged_clustered_decode"],
             launches_quota=quota["launches"]["paged_clustered_decode"],
             launches_prefix_share=prefix["shared"]["launches"][
                 "paged_clustered_decode"],
             launches_template_store=[r["launches"]["paged_clustered_decode"]
                                      for r in store["serves"]],
             launches_slo=slo["scheduled"]["launches"][
                 "paged_clustered_decode"],
             launches_recurrent={p: r["card"]["paged"]["launches"][
                 "paged_clustered_decode"] for p, r in rec_tiny.items()},
             launches_moe=moe["serves"]["paged"]["launches"][
                 "paged_clustered_decode"],
             launches_cli=cli_launches(cli, "paged_clustered_decode"),
             launches_example=example["launches"]["paged_clustered_decode"],
             launches_mesh_store=[r["launches"]["paged_clustered_decode"]
                                  for r in mesh_rt["store"]],
             launches_mesh_slo=mesh_rt["slo"]["launches"][
                 "paged_clustered_decode"],
             max_abs_err=pcd_err, ms=tm["paged_clustered_decode"]["ms"],
             plain_ms=tm["paged_clustered_decode"]["plain_ms"],
             bound_ms=tm["paged_clustered_decode"]["bound_ms"],
             bound_by=tm["paged_clustered_decode"]["bound_by"],
             library_ms=tm["paged_clustered_decode"]["library_ms"],
             # 5h's quota layout (time_paged_quota)
             quota={k: tq[k] for k in ("ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms")}),
        *(dict(name=f"distance_argmin {metric}", route="cuda",
               source="src/repro_torch/csrc/distance_argmin.cu",
               replaces=f"src/repro/kernels/distance_argmin.py:{line}",
               launches=launches, max_abs_err=da_err[metric],
               ms=tm[f"distance_argmin {metric}"]["ms"],
               plain_ms=tm[f"distance_argmin {metric}"]["plain_ms"],
               bound_ms=tm[f"distance_argmin {metric}"]["bound_ms"],
               bound_by=tm[f"distance_argmin {metric}"]["bound_by"],
               library_ms=tm[f"distance_argmin {metric}"]["library_ms"],
               shape=tm[f"distance_argmin {metric}"]["shape"])
          # L1 (_kernel_l1) in the k-medians fit, L2 (_kernel_l2) in the
          # quickstart's k-means fit and k sweep
          for metric, line, launches in (
              ("l1", 36, km["launches"]),
              ("l2", 24, qs["launches"]["distance_argmin l2"]))),
        dict(name="bitserial_median", route="cuda",
             source="src/repro_torch/csrc/bitserial_median.cu",
             replaces="src/repro/kernels/bitserial_median.py:35",
             launches=serve["launches"]["bitserial_median"],
             launches_blocking=blocking["launches"]["bitserial_median"],
             launches_prefix_share=prefix["shared"]["launches"][
                 "bitserial_median"],
             launches_template_store=[r["launches"]["bitserial_median"]
                                      for r in store["serves"]],
             launches_slo=slo["scheduled"]["launches"]["bitserial_median"],
             launches_recurrent={p: r["card"]["chunked"]["launches"][
                 "bitserial_median"] for p, r in rec_tiny.items()},
             launches_moe={m: r["launches"]["bitserial_median"]
                           for m, r in moe["serves"].items()},
             launches_frontend=ivl["serves"]["blocking"]["launches"][
                 "bitserial_median"],
             launches_cli=cli_launches(cli, "bitserial_median"),
             launches_example=example["launches"]["bitserial_median"],
             launches_mesh=mesh["dense"]["launches"]["bitserial_median"],
             launches_mesh_store=[r["launches"]["bitserial_median"]
                                  for r in mesh_rt["store"]],
             launches_mesh_slo=mesh_rt["slo"]["launches"][
                 "bitserial_median"],
             launches_mesh_moe={m: r["launches"]["bitserial_median"]
                                for m, r in moe["mesh"].items()},
             # the Trainer's straggler median and MAD: 4e's TINY run, 5r
             launches_train={
                 "4e tiny": train_tiny["tiny_trainer"][
                     "bitserial_median_launches"],
                 "5r qwen3-4b": train_full["launches"].get(
                     "bitserial_median", 0),
                 "5z qwen3-4b mesh": train_mesh["launches"].get(
                     "bitserial_median", 0)},
             max_abs_err=bsm_err, ms=tm["bitserial_median"]["ms"],
             plain_ms=tm["bitserial_median"]["plain_ms"],
             bound_ms=tm["bitserial_median"]["bound_ms"],
             bound_by=tm["bitserial_median"]["bound_by"],
             library_ms=None,
             # the blocking serve's admission shape (admission_inputs)
             admission={k: tm["bitserial_median admission"][k] for k in
                        ("ms", "plain_ms", "bound_ms", "bound_by")}),
        dict(name="flash_decode", route="cuda",
             source="src/repro_torch/csrc/flash_decode.cu",
             replaces="src/repro/kernels/flash_decode.py:29",
             launches=serve["launches"]["flash_decode"], max_abs_err=fd_err,
             ms=tm["flash_decode"]["ms"],
             plain_ms=tm["flash_decode"]["plain_ms"],
             bound_ms=tm["flash_decode"]["bound_ms"],
             bound_by=tm["flash_decode"]["bound_by"],
             library_ms=tm["flash_decode"]["library_ms"]),
    ]
    record["kernels"] = {k["name"]: k for k in kernels}
    OUT.mkdir(exist_ok=True)
    (OUT / "chip_smoke.json").write_text(json.dumps(record, indent=1,
                                                    default=float))
    say(smi)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
