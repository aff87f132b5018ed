#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

1. Device: the card's name and power limit; build the CUDA kernels from
   ``src/repro_torch/csrc`` (one ``nvcc`` per source, all started at once)
   and print each source's build seconds.
2. Paged attention kernels against their plain PyTorch versions on the card,
   at qwen2.5-3b shapes (H=16, KVH=2, hd=128, bs=16, B=8, ~300 packed
   tokens, contexts up to 2048, RAW -1 holes, pad tokens, segmented spans)
   for float32, bfloat16 and int8 pools (bf16 also against the plain version
   on the same values in float32, int8 also with bf16 q; tolerances in
   ``TOL``), and the split decode's edges (a row of length 1, -1 holes at
   the table entries that start splits); then times (CUDA events, L2 flushed between launches, median
   of 30) of the kernel, its plain version and one PyTorch SDPA call on the
   gathered view, beside the bound the card could reach, and the kernel's
   device time alone (calls queued behind a spin kernel, timed back to back
   with CUDA events; every timed kernel has one). The chunk kernel again,
   checked and timed the same way, at the engine's mixed step: one row
   prefills 256 plain-causal tokens at slots 1024-1279, seven rows decode one
   token each at lengths 301-337, one pad (264 packed tokens).
2b. The dense backend's kernels against their plain versions on the card at
   qwen2.5-3b shapes: flash attention (B=1, H=16, KVH=2, hd=128, S in {16,
   64, 65, 200, 1100, 2048}, causal and not; bf16 runs on the tensor cores)
   and dense decode attention (B=8, Sc=2048, the lengths of phase 2, again
   with the shortest row at length 1, and the mixed step's lengths 1280 and
   301-337), float32 and bfloat16 (bf16 also against the plain version in
   float32); then the times of the kernel, its plain version and one SDPA
   call (flash: S=2048 causal; decode: phase 2's and the mixed step's
   lengths) beside the bound.
3. The top-k retrieval kernel against its plain version at B=32 queries,
   N=2^21 docs, d=768, k in {10, 100}: float32 docs (the corpus the index is
   built from), bfloat16 docs, and integer-valued docs with duplicated rows
   (exact ties; tolerances in ``TOPK_TOL``); then the kernel's, the plain
   version's and ``torch.topk(q @ docs.T, k)``'s times (bf16 docs: on the
   f32 upcast) beside the bound of the kernel's route (the split-tf32
   products counted at the tf32 tensor-core rate).
4. Engine parity at smoke width: the same greedy RAG workload on the CPU
   (plain versions) and on the GPU (kernels) gives identical tokens; then
   the same seeded open-loop pipeline trace (vrag + crag, sessions) gives
   identical pipeline records and tokens on both. The dense backend gives
   identical greedy tokens on the CPU and on the GPU, and on the GPU the
   same tokens as the paged backend.
5. Serve qwen2.5-3b at full width in bfloat16: 10 requests, 128-1536-token
   prompts, half sharing a 512-token document prefix, one segmented prompt,
   32 new tokens each, with every ported kernel's launch count read around
   the run (the dense and top-k kernels' must be 0).
5b. Serve the same 10 prompts (the segmented one flattened) on the dense
   backend of qwen2.5-3b bf16 (``max_batch=8``, ``max_seq=2048``): flash
   attention launches must be 36 x the prefills and dense decode launches
   36 x the decode steps, and the paged and top-k kernels' 0; greedy
   agreement with phase 5's paged run on the unsegmented requests is
   reported (bf16 sums differ in order between the two backends, so it is
   not required).
6. RAG requests at full width: a ``VectorIndex`` of 2^21 synthetic 768-d
   passages with 1024 clusters built on the card; recall@10 at n_probe 1,
   8 and 32 (the exact side runs the top-k kernel); 8 queries through
   Retriever -> Reranker -> Augmenter -> the qwen2.5-3b engine, half of
   them repeating an earlier query's text, with every ported kernel's
   launch count read around the phase (the dense kernels' must be 0).
5c. Serve phase 5's ten prompts with phase 5's settings on int8 pools
   (``kv_dtype="int8"``, bf16 weights): both paged kernels take their int8
   route from the engine's running-max scales (launches 36 a step, none of
   the dense, scan or top-k kernels); tokens/s, TTFT, TPOT, steps, peak
   memory, the pool's bytes against phase 5's bf16 pool, greedy agreement
   with phase 5's tokens (reported; the 0.75 floor holds at smoke width
   only), and a step profile of a mixed and a decode-only step.
5e. The paged engine's oracle paths and the KV sanitizer at full width,
   phase 5's settings and prompts with 8 new tokens each: (a) the packed
   kernel path (``kernel="pallas"``) against the padded oracle
   (``ragged=False, kernel="reference"``: fused steps over the gathered
   views, decode plans through the gather oracle and the dense decode
   kernel): plans identical step for step (the packed plans unpacked give
   the padded rows, starts and n_valid), each request's first-token logits
   within ``logit_bound`` as max |d| / max |logit|, and two controls (the
   padded oracle with a deliberate fault, ``oracle_fault``) above it;
   greedy agreement reported; the oracle run launches no paged kernel and
   one dense decode a layer and decode plan. (b) The sequential path (``interleave=False``):
   one paged decode a layer and step, no chunk kernel, the pool drained to
   its scratch block. (c) Phase 5d's swap schedule with ``sanitize=True``,
   bf16 then int8 pools: no violation, every lifecycle hook exercised, the
   shadow equal to the pool and the host store at the drain, phase 5d's
   steps and swaps; the op counts and the step wall with and without.
5d. The host tier and swap at full width: phase 5's prompts in two waves
   (each prompt asked for again in the second) on a 256-block pool (phase
   5: 1033) with a 1024-block host tier, under ``preempt="recompute"``,
   ``"swap"`` and ``"cost"`` and once on int8 pools with swap: demotions,
   promotions and (swap) swap-outs > 0, every swap set restored, the pool
   clean, and swap's prefill tokens below recompute's; steps, tokens/s,
   prefill tokens, bytes swapped, and the device<->host rate of a swap
   chain's pinned copies (CUDA events).
4d. int8 pools and swap/cost preemption at smoke width in float32, CPU
   against the card: the RAG workload on an int8 pool, and the invariant
   harness's long-decode workload on a 6-block pool under swap (float and
   int8) and cost (the per-token step time pinned to 6e-7 s on both):
   identical greedy tokens and counters, int8 payloads within one code and
   scales within 1e-5 relative (the float K/V they quantize differ by the
   devices' summation orders); and the quantized scatter itself equal bit
   for bit on identical inputs, .5 ties included.
7. The open-loop pipelines at full width: ``serve_pipelines`` on
   qwen2.5-3b bfloat16 replays a Poisson trace (4 requests/s for 5
   trace-seconds, 30% sessions) of vrag/crag/srag/planrag with EDF-slack
   priorities and the reference launcher's 128-block host tier; every
   event must complete.
7b. The control plane on the card, on phase 5's qwen2.5-3b bf16 weights:
   ``calibrate_generator_from_engine(prefill_len=1024, decode_tokens=32,
   long_ctx=1536)`` against the paged engine (``max_batch=8``,
   ``max_seq=2048``, 16-token blocks, 256-token chunks) on bf16 and on
   int8 pools, each coefficient printed beside the Generator class default,
   ``kv_bytes_per_token`` exactly 36864 and 18468 and ``kv_capacity_scale``
   1.99610 on int8 pools; ``profile_components(real_execution=True)`` of
   vrag's generator on the bf16 engine (8 draws) beside the calibrated cost
   model on the same draws; both paged kernels launch in the phase and no
   other kernel does. Then, host work only, for vrag/crag/srag/arag with
   32 GPUs, 256 CPUs and 1024 GB: the LP plan under the default and the
   card's coefficients (status ``optimal``), the SLO as benchmarks/common.py
   sets it (2x the mean latency at 0.1x the card plan's throughput), and
   the Patchwork, monolithic and Ray-like runtimes at 0.8x that throughput
   for 30 trace-seconds, each run until it completes all it was offered.
2c. The RWKV-6 WKV kernel against its plain version on the card at
   rwkv6-7b shapes (H=64, hd=64) with a nonzero ``state0``: prefill B=1 at
   S=2048 and S=37, decode B=8 at S=1, the adversarial decay w=0.45 and
   decays near 0 (w=1e-6), and B=1 at the lengths about the kernel's
   segment edges (S in {1, 33, 255, 257, 1519}), r/k/v in float32 and
   bfloat16 (tolerance ``WKV_TOL``), each with the (n_seg, seg_len) the
   kernel ran; then the kernel's and the plain version's times beside the
   bound (prefill S=2048 and decode). No single PyTorch call computes the
   recurrence, so there is no library time.
4b. The RWKV-6 engine at smoke width in float32: identical greedy tokens on
   the CPU (plain versions) and on the GPU (the kernel), with 2 WKV
   launches (one per layer) per prefill and per decode step.
8. Serve rwkv6-7b at full width in bfloat16 on ``GenerationEngine(backend=
   "paged")``, which falls back to the dense backend: ``max_batch=8``,
   ``max_seq=2048``, phase 5's ten prompts (the segmented one flattened,
   tokens taken modulo the 65536-token vocab), 32 new tokens each. The WKV
   launches must be 32 x (prefills + decode steps) and every other kernel's
   0 (the earlier phases must show 0 WKV launches). The qwen2.5-3b weights
   are freed first.
2d. The selective-scan kernel against its plain version on the card at
   hymba-1.5b shapes (Di=1600, N=16) with a nonzero ``h0``: prefill B=1 at
   S=1664 (128 meta + 1536 text tokens) and S=37, decode B=8 at S=1, and
   dt = softplus of extreme values (dt * A down to about -50) at S=1664,
   and B=1 at the lengths about the kernel's segment edges (S in {1, 17,
   129, 1647}), dt/x/B/C in float32 and bfloat16 (bf16 also against the
   plain version in float32; tolerance ``SSM_TOL``), each with the (n_seg,
   seg_len) the kernel ran; then the kernel's, its device and the
   plain version's times beside the bound (prefill S=1664 and decode). No
   single PyTorch call computes the scan, so there is no library time.
2e. The flash kernel with a sliding window at hymba-1.5b's heads (H=25,
   KVH=5, hd=64): S=1664 with window 1024 and S=300 with window 64, float32
   and bfloat16, against the plain version; then its times at S=1664 beside
   the bound and one SDPA call with the windowed causal mask.
2f. The dense decode kernel at the hymba serve phase's shapes (B=8, H=25
   over KVH=5, hd=64, a 1024-slot ring) with lengths that mix full rings
   with rows of 1, 37 and 300 slots, and with the mixed step's lengths on
   the ring, float32 and bfloat16 (bf16 also against the plain version in
   float32; tolerances of phase 2b); then its times beside the bound and
   one SDPA call with the length mask.
2g. The same two kernels at the shapes of phases 10 and 11: flash with
   window 4096 at hd 128, S 6000 and 4097 (past the window and no multiple
   of the tile), H 48 over KVH 8 (mixtral-8x22b: G = 6) and H 16 over KVH 2
   (qwen2.5-3b-swa: G = 8); dense decode at H 48 over KVH 8 on a 4096-slot
   ring whose lengths saturate at the ring beside short rows; float32 and
   bfloat16 against the plain versions, then times beside the bound and an
   SDPA call with the mask (flash timed at S 6000).
4c. The hymba engine at smoke width in float32: identical greedy tokens on
   the CPU (plain versions) and on the GPU (kernels), with 2 scan and 2
   flash launches per prefill and 2 scan and 2 dense decode launches per
   decode step.
9. Serve hymba-1.5b at full width in bfloat16 on ``GenerationEngine(
   backend="paged")``, which falls back to the dense backend: ``max_batch=8``,
   ``max_seq=2048``, phase 5's ten prompts (flattened, tokens modulo the
   32001-token vocab), 32 new tokens each. The scan launches must be 32 x
   (prefills + decode steps), flash 32 x the prefills, dense decode 32 x the
   decode steps, and the paged, top-k and WKV kernels' 0; every earlier phase
   must show 0 scan launches. The rwkv6-7b weights are freed first.
4e. The qwen2.5-3b-swa and mixtral-8x22b smoke engines in float32 (window
   64; 4 experts, top-2) on the CPU and on the GPU: identical greedy tokens
   for prompts short of, at and past the window (phase 11's check (c)), one
   flash a layer and prefill, one dense decode a layer and step.
10. qwen2.5-3b-swa at full width and depth in bfloat16 (phase 5's weights:
   the variant changes the mask, not the widths) on the dense backend,
   ``max_batch=8``, ``max_seq=8192``: prompts of 4090, 4096, 4097, 5000 and
   6000 tokens and two of phase 5's, 32 new tokens each. Every sampled
   token's logits (the prefill's and each dense decode step's) against the
   no-cache oracle (``forward`` on the prompt plus the engine's tokens so
   far) within ``logit_bound(36)``; the oracle with the window dropped must
   read above the bound on the 5000- and 6000-token prompts; the
   reference's linear ring order is run and reported, not asserted; flash
   launches 36 x the prefills and dense decode 36 x the steps; tokens/s,
   TTFT, TPOT, and a decode step's wall against its device busy.
11. mixtral-8x22b at full width with its depth cut to 8 of 56 layers (~41
   GB of bf16 weights drawn on the card; 56 layers would take ~282 GB):
   (a) one layer's ``apply_moe`` at T = 8 and 2048 against a per-route
   float32 formulation with the same routing (``MOE_TOL``), drops equal to
   the count of ``keep``; (b) phase 5's ten prompts and prompts of 4500 and
   6000 tokens, 32 new tokens each, flash 8 x the prefills and dense decode
   8 x the steps; (c) is phase 4e. Reported: routes dropped per prefill,
   tokens/s, TTFT, TPOT, peak memory, a decode step's device busy against
   its wall and its bound, greedy agreement with the no-cache oracle on
   the two long prompts. Phase 5's weights are freed first; rwkv6-7b's are
   drawn after mixtral's are freed.

2h. The flash kernel with a chunk at llama4-scout's heads (H 40 over KVH 8,
   hd 128): S 12500 with chunk 8192 (phase 12's longest prefill, bf16,
   timed) and S 1000 with chunk 200 (query tiles straddling chunk
   boundaries, f32 and bf16); the flash kernel at minicpm3's split head
   dims (40 heads, query/key 96, value 64): S 6000 (bf16, timed) and 2048
   (f32 and bf16); each against its plain version one group of KV heads at
   a time (40 heads of 12500^2 f32 scores would take 25 GB), with the time
   beside the bound and an SDPA call with the mask. Then dense decode at
   llama4's heads on an 8192-slot chunk ring (lengths pos % 8192 + 1) and
   a 16384-slot global cache, f32 and bf16, timed.
4f. The llama4-scout and minicpm3 smoke engines in float32 (llama4: chunk
   64, a chunked and a global layer, 4 experts top-1 with a shared expert;
   minicpm3 at MLA's real head dims 96 / 64) on the CPU and on the GPU:
   identical greedy tokens and every sampled token's logits within
   ``PARITY_LOGIT_TOL``, one flash a layer and prefill; llama4 one dense
   decode a layer and step, minicpm3's absorbed decode none.
12. llama4-scout at full width with its depth cut to 8 of 48 layers (two
   groups of three chunked-local layers and a global one; ~39 GB of bf16
   weights drawn on the card, 48 layers would take ~216 GB), dense backend,
   ``max_batch=8``, ``max_seq=16384``: phase 5's ten prompts and prompts of
   9000 and 12500 tokens (S % chunk = 808 and 4308), 32 new tokens each.
   Every sampled token's logits against the no-cache oracle, its MoE as
   served (the calls cut as the engine's, each token at the expert the
   engine chose: ``moe_as_served``, ``moe_replayed``), within
   ``logit_bound(8)``, and the routes the oracle's own router would have
   chosen otherwise near-tie noise (``route_flips_ok``: at most 1 % of a
   prompt's routes, each gap within 2 x the bound), which a faulted replay
   (each decode step's routes from another request's row) must fail; two
   faulted controls above the bound on the long prompts (the chunk mask
   dropped; the reference's linear ring order); flash 8 x the prefills,
   dense decode 8 x the steps; routes dropped per prefill, tokens/s, TTFT,
   TPOT, peak memory, a decode step's device busy against its wall and its
   bytes bound (all 16 experts run at C = 8). The mixtral-8x22b weights
   are freed first.
13. minicpm3 at full width and depth (62 MLA layers, ~8.5 GB of bf16
   weights), dense backend, ``max_batch=8``, ``max_seq=8192``: phase 5's
   ten prompts and one of 6000 tokens, 32 new tokens each, prefilled padded
   to their buckets as in JAX: every sampled token's logits against the
   no-cache oracle within ``logit_bound(62)``; the control (rope dropped at
   decode) above it on the long prompt; flash 62 x the prefills at head
   dims 96 / 64 and no dense decode (the absorbed decode is plain torch);
   the serve figures and a decode step's busy against its bytes bound.
   The llama4-scout weights are freed first; rwkv6-7b's are drawn after
   minicpm3's are freed.

2i. The flash kernel's cross form at whisper's heads (H 20 = KVH 20, hd
   64, B 8): S 1, 37 and 448 queries over 1500 keys, non-causal, and the
   encoder's causal S 1500, f32 and bf16, each against its plain version
   and timed beside its bound and an SDPA call; then dense decode at G 1
   over whisper's 1500-slot cross cache and at internvl2's G 7.
4g. The internvl2 (patch embeddings) and whisper (frames) smoke models
   through the model API, and the smollm smoke engine on the int8 dense
   cache, in float32 on the CPU and on the GPU: identical greedy tokens,
   logits within ``PARITY_LOGIT_TOL`` (the int8 engine's within
   ``CODE_LOGIT_TOL``), ``quantize_kv`` bit for bit across the devices,
   and the launches (flash: one a layer and prefill, one more a decoder
   layer for the cross form, one an encoder layer; dense decode: one a
   layer and step, one more a decoder layer for cross attention).
10b. qwen2.5-3b-swa on the int8 dense cache at full width on phase 10's
   weights and prompts: the rings' bytes (128 + 4) / 256 of the bf16
   rings', tokens/s, greedy agreement with phase 10, a decode step's busy
   against its bytes bound.
14. internvl2-1b at full width and depth (24 layers, bf16 weights drawn on
   the card): 8 rows of 256 patch embeddings N(0, 1) and phase 5's
   prompts through ``prefill``, then 32 greedy tokens together through
   ``decode_step`` at pos + 256; every sampled token's logits within
   ``logit_bound(24)`` of the no-cache oracle (``forward`` with the same
   patches), a control without the patch offset above it; the engine
   serves the prompts text only, held to the text-only oracle. Reported:
   tokens/s, TTFT, TPOT, a decode step's busy against its bytes bound.
15. whisper-large-v3 at full width and depth (32 + 32 layers): 8 rows of
   1500 frames N(0, 1) and decoder prompts of 4-200 tokens through
   ``prefill``, then 32 greedy tokens together; every sampled token's
   logits within ``logit_bound(64)`` of the no-cache oracle, a control
   (each row's cross attention over the next row's cross cache) above it.
   Reported: the same figures and the encoder's share of a prefill.
16. The step-program audit (``analysis.step_audit.audit_engine``) on phase
   5's qwen2.5-3b engine settings and weights at full width, bf16 pools and
   int8 pools: every program (the ragged step, the paged decode, the
   gather-oracle decode, the pool roundtrip) collective-free and free of
   host syncs under ``torch.cuda.set_sync_debug_mode("error")`` (restored
   afterwards), the int8 pools reaching both paged kernels un-upcast, the
   cache sentinel clean (only warmed packed lengths, no kernel library
   built during the audited steps). Then the four ``audit-*`` mutations on
   the same engines, each caught by its check: an all-reduce in a
   world-size-1 gloo group and an ``.item()`` inside the pool program, the
   gather-oracle decode held to the in-kernel int8 contract, and a ragged
   call one packed length past the warmed ones.
17. DP replicas on one card: ``DataParallelEngineGroup(dp=2)`` of
   qwen2.5-3b at full width on phase 5's weights (one params tree, one
   shared pool box, ``max_batch`` 8 each) serves phase 5's prompts, 12 new
   tokens each, routed least-loaded in two waves (``DP_WAVES``: the later
   shared-document prompts land on replica 1), bf16 and then int8 pools.
   (a) Without a host tier each replica is a lone engine on its share: its
   greedy tokens equal, bit for bit, those of a lone engine (phase 5's
   settings) serving the same prompts in the same waves. (b) With a shared
   1024-block host tier written through: ``cross_replica_host_hits`` > 0.
   Both: block ownership disjoint, each replica's pool drained to its
   scratch block, the paged kernels' launches 36 a step of the group;
   tokens/s, mean TTFT, p95 TPOT and the greedy agreement with phase 5's
   lone engine's first 12 tokens (reported: host promotions and other
   batch compositions change the packed lengths, and random-weight bf16
   logits have near-ties).

18. Training. (a) The flash backward kernel (``csrc/flash_backward.cu``)
   against ``ref_flash_attention_backward`` on the card in every form of
   the forward kernel (``BWD_FORMS``): causal at qwen2.5-3b's heads (H 16
   over KVH 2, hd 128: B 2 and 1 at S 2048) and smollm-135m's (H 9 over KVH
   3, hd 64: B 8 at S 256); window 1024 at hymba's heads (S 1664); window
   4096 at qwen2.5-3b-swa's (S 6000); chunk 800 at H 40 over KVH 8 (S 2048,
   tiles straddle chunk boundaries); whisper's cross attention (B 8 x S 448
   over 1500 keys, H 20 = KVH 20, hd 64, and S 1 and 37); minicpm3's MLA
   head dims (96, 64) at S 2048 (H 40 = KVH 40); each at S 1, 37 and 1000
   too, float32 and bfloat16: each gradient within ``BWD_TOL``, two calls
   equal (no atomics), and faulted controls above the bound (dv scaled by
   1 + ``BWD_FAULT``; the plain version with delta dropped, against dq and
   dk); at each form's main shape in both dtypes the kernel's, its plain
   version's and SDPA's backward's times on the same form (``is_causal``,
   a boolean mask for a window or a chunk, none for cross) beside the
   bound (``backward_work``: the pairs the form's mask leaves visible). (b)
   ``STACK_CASES`` at full width with their depth cut to 2 layers (whisper:
   2 encoder and 2 decoder layers), float32: qwen2.5-3b (B 2 x S 2048),
   qwen2.5-3b-swa (B 1 x S 6000, so the window bites), minicpm3-4b (S 2048)
   and whisper-large-v3 (B 2 x S 448 over 1500 frames), and (h)
   rwkv6-7b (S 2048), hymba-1.5b (S 1536 + 128 meta tokens, so its window
   of 1024 bites), mixtral-8x22b (S 1024) and llama4-scout (S 2048, its
   first two layers chunked-local): every leaf's gradient through the
   kernels against the same stack with the attention and the recurrences
   taken through their plain versions under autograd
   (``launch.grad_check.plain_kernels``) within ``STACK_BOUND``, a control
   (a backward's gradient scaled by 1 + 2**-7: the WKV's dv for rwkv6, the
   scan's dC for hymba, the flash dv otherwise) above it; each kernel's forward launched twice a
   layer (remat) and its backward once. (c)
   qwen2.5-3b at full width and depth (36 layers), bf16 parameters, f32
   AdamW moments, 6 steps of 2 x 2048 tokens from ``TokenDataset`` in 2
   microbatches: losses finite and falling, grad norms finite, s/step,
   tokens/s, peak memory, and the launches (flash forward 2 x 36 a
   microbatch: remat runs each layer's forward again in the backward;
   the backward 36; no other kernel). (d) smollm-135m at full width
   through ``launch.train.train`` with examples/train_smollm.py --full's
   settings (50 steps of 8 x 256, float32): loss falling, the checkpoint
   reloaded with ``like=`` gives logits equal bit for bit. (e) Every
   forward-only wrapper handed a grad-requiring CUDA input under grad mode
   raises ``RuntimeError``, and the flash forms the forward kernel does not
   take either (a window with a chunk, head dims (32, 32), cross attention
   at (128, 128)) raise ``NotImplementedError``. (f) ``FORM_TRAIN``:
   qwen2.5-3b-swa (B 1 x S 6000), minicpm3-4b (B 1 x S 2048) and
   whisper-large-v3 (B 4 x S 448 over 1500 frames) at full width and
   depth, bf16 parameters, f32 AdamW moments, 3 steps each from
   ``TokenDataset`` through ``make_train_step`` in one microbatch: losses
   and grad norms finite, s/step, tokens/s, peak memory, and the launches
   (the backward once a step for each attention call, the forward twice).
   (g) The backward kernels of the two scans
   (``csrc/rwkv6_scan_backward.cu``, ``csrc/ssm_scan_backward.cu``) against
   ``ref_rwkv6_chunked_backward`` and ``ref_ssm_scan_backward`` at
   rwkv6-7b's heads (H 64, hd 64; B 1 x S 2048) and hymba-1.5b's scan (Di
   1600, N 16; B 1 x S 2176), and at S 1, 37 and 1000 and about the edges
   of the kernels' segment rules (``scan_backward_edges``), float32 and
   bfloat16, nonzero initial states and final-state cotangents: every
   gradient within ``BWD_TOL``, two calls equal bit for bit, the first
   gradient scaled by 1 + ``BWD_FAULT`` outside the bound, strong decays (w
   = 0, exp(dt A) = 0) finite and within it; the kernel's, its device and
   its plain version's times at the main shape beside the bound
   (``scan_backward_work``), and in the text line the kernel's own work
   counted from its design beside the contract's
   (``scan_backward_design_work``; not measured). (i) ``SCAN_TRAIN`` as (f): hymba-1.5b at full
   depth (B 1 x S 2048), rwkv6-7b at 16 of 32 layers (S 2048),
   mixtral-8x22b at 2 of 56 (S 1024) and llama4-scout at 1 of 48 (S 2048),
   the depths from 12 bytes a parameter on 80 GB; the scans' kernels
   forward twice a layer and step, their backward once.
19. The dry run and tensor parallelism, last. (a) ``phase_dryrun_card``:
   ``launch.dryrun`` on meta tensors for qwen2.5-3b (bf16, world size 1) at
   phase 5's serve shape (decode, B 8 against a 2048-slot cache) and at
   18c's train shape (B 2 x S 2048, 2 microbatches): its argument bytes
   equal the bytes the same params, AdamW state, cache and inputs request
   on the card (their blocks' ``requested_size``), and what the allocator
   hands out is those blocks, each within the allocator's rules of its
   request (a check of the byte count, not of the sharding policy); its
   peak estimate beside 18c's ``max_memory_allocated``, the card's
   ``total_memory`` beside ``kernels.work.CARD_BYTES`` (within 1 %), and
   18c's step FLOPs over its s/step (a printed figure). (b)
   ``phase_tp_card``: the sharded math on the one card, ``TP`` = 2 ranks
   over gloo both on cuda:0 (``launch.mesh.run_on_ranks``; a check, not a
   speedup): qwen2.5-3b at full width, 8 query heads over 1 KV head a
   rank, ``kernel="reference"``, phase 5's prompts in chunks of
   ``TP_CHUNK`` at ``TP_MAX_NEW`` tokens. The ranks' tokens equal;
   first-token logits against a tp 1 engine on the same weights within
   ``logit_bound(36)``; each rank's
   audited step programs 72 all-reduces of the Megatron formula's bytes
   and no all-gather, the pool roundtrip none; the dense decode kernel 36
   a decode plan; a world-size-1 layout engine equal to the unsharded one
   bit for bit. (c) ``phase_dp_mesh_card``: the data axis of a serving
   mesh, a (dp 2, tp 2) mesh of 4 ranks over gloo all on cuda:0, each row
   one replica of a ``DataParallelEngineGroup`` holding only its block
   range of its KV head (``dp_blocks``), qwen2.5-3b at full width, phase
   5's prompts in ``DP_WAVES`` (256-token chunks: four ranks of the gather
   oracle at (b)'s 512 exceed the card) with a write-through host tier the
   rows exchange. Each rank's pool shard (36, 1033, 16, 1, 128); the four
   ranks' tokens equal; each row's first-token logits against (b)'s tp 1
   engine within ``logit_bound(36)``; per step program 72 all-reduces of
   the Megatron formula's bytes on the "model" group, none on the "data"
   group, the pool roundtrip none; the dense decode kernel 36 a decode
   plan of the row; cross-replica host hits.

It prints a ``{"int8_serve": ..., "host_tier": ..., "oracle_paths": ...,
"controller": ..., "swa_serve": ..., "mixtral_serve": ...,
"chunk_mla_parity_max_abs_logit_diff": ..., "llama4_serve": ...,
"minicpm3_serve": ..., "zoo_parity_max_abs_logit_diff": ...,
"swa_int8_serve": ..., "internvl2_serve": ..., "whisper_serve": ...,
"audit": ..., "dp": ..., "train": ..., "train_forms": ..., "train_scans": ...,
"train_stack_gradient": ..., "grad_guards": ..., "dryrun_card": ...,
"tp_card": ..., "dp_mesh_card": ...}`` line of phases 5c, 5d, 5e, 7b, 10, 11, 4f, 12, 13, 4g,
10b, 14, 15, 16, 17, 18 and 19's figures,
a ``{"kernels": [...]}`` line, the card's name and power limit, each
phase's seconds and the total, and last ``{"ok": true, "device":
{...}}``. Exits non-zero without a GPU.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# the H100's rates and each kernel's contract work live in the package, so
# the bounds printed here are those the dry run and the benchmark count
from repro_torch.kernels.work import (  # noqa: E402
    HBM_BYTES_S,
    PEAK_OPS_S,
    backward_work,
    decode_work,
    flash_work,
    scan_backward_work,
    ssm_work,
    topk_work,
    wkv_work,
)
# (atol, rtol) of each check, by the pools' dtype: the kernel against
# "plain", its plain version on the same inputs, and for bf16 also against
# "plain_f32", the plain version on the same values in float32 (f32
# probabilities, as the kernel keeps), and for int8 also with bf16 q
TOL = {
    "float32": {"plain": (1e-4, 1e-4)},        # summation order differs
    "bfloat16": {
        "plain": (2e-2, 2e-2),                 # the plain version's bf16 probabilities
        "plain_f32": (1e-3, 8e-3),             # bf16 output rounding only (2**-9 rel.)
    },
    "int8": {
        "plain": (1e-4, 1e-4),                 # f32 q, dequantised pools
        "plain_bf16_q": (1e-3, 8e-3),          # bf16 q: bf16 output rounding only
    },
}
REPLACES = {
    "paged_chunk_attention": "src/repro/kernels/decode_attention.py:357",
    "paged_decode_attention": "src/repro/kernels/decode_attention.py:191",
    "topk_retrieval": "src/repro/kernels/topk_retrieval.py:51",
    "flash_attention": "src/repro/kernels/flash_attention.py:69",
    "decode_attention": "src/repro/kernels/decode_attention.py:90",
    "rwkv6_chunked": "src/repro/kernels/rwkv6_scan.py:76",
    "ssm_scan": "src/repro/kernels/ssm_scan.py:55",
    # the custom_vjp backward rule of blockwise_attention (plain jnp)
    "flash_attention_backward": "src/repro/models/attention.py:211",
    # autodiff of chunked_scan (src/repro/models/layers.py:117) over the
    # plain step of each scan (no pallas_call: JAX never trains through its
    # Pallas scans)
    "rwkv6_chunked_backward": "src/repro/models/rwkv6.py:82",
    "ssm_scan_backward": "src/repro/models/ssm.py:79",
}
SOURCES = {
    "paged_chunk_attention": "src/repro_torch/csrc/paged_attention.cu",
    "paged_decode_attention": "src/repro_torch/csrc/paged_attention.cu",
    "topk_retrieval": "src/repro_torch/csrc/topk_retrieval.cu",
    "flash_attention": "src/repro_torch/csrc/dense_attention.cu",
    "decode_attention": "src/repro_torch/csrc/dense_attention.cu",
    "rwkv6_chunked": "src/repro_torch/csrc/rwkv6_scan.cu",
    "ssm_scan": "src/repro_torch/csrc/ssm_scan.cu",
    "flash_attention_backward": "src/repro_torch/csrc/flash_backward.cu",
    "rwkv6_chunked_backward": "src/repro_torch/csrc/rwkv6_scan_backward.cu",
    "ssm_scan_backward": "src/repro_torch/csrc/ssm_scan_backward.cu",
}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

H, KVH, HD, BS, B = 16, 2, 128, 16, 8
N_BLOCKS = B * (2048 // BS + 1) + 1          # the engine's pool at max_seq 2048
MB_DECODE = 2048 // BS                       # engine.max_blocks
MB_CHUNK = MB_DECODE + 256 // BS             # engine._view_blocks
LENGTHS = [2048, 1536, 1024, 777, 512, 300, 129, 33]
# prefill chunks (row: (n tokens, p_end, s_start)); other rows decode one token
CHUNKS = {2: (64, 0, 0), 4: (96, 128, 400), 5: (100, 0, 0), 7: (33, 0, 0)}
N_PAD = 3
# the split decode's edges: at these shapes each split walks 8 table entries
# (128 slots), so -1 holes at entries 8 and 16 sit on split boundaries, and
# the shortest row (length 1) leaves every split but the first empty
SPLIT_HOLES = (8, 16)
SPLIT_LENGTHS = LENGTHS[:-1] + [1]
# the engine's mixed step (max_batch 8, 256-token chunks, pack_align 4): one
# row prefills 256 plain-causal tokens at slots 1024-1279, seven rows decode
# one token each at lengths spread over 300-340, one pad: 264 packed tokens
MIXED_LENGTHS = [1280, 301, 308, 312, 319, 326, 330, 337]
MIXED_CHUNKS = {0: (256, 0, 0)}
MIXED_PAD = 1


def make_case(dtype_name, gen, lengths=LENGTHS, chunks=CHUNKS, n_pad=N_PAD):
    """Tables, pools and packed arrays at the engine's qwen2.5-3b shapes:
    rows of ``lengths`` after the step, ``chunks`` {row: (tokens, p_end,
    s_start)} prefilling (the other rows decode one token), ``n_pad`` pad
    tokens at the tail."""
    perm = torch.randperm(N_BLOCKS - 1, generator=gen) + 1   # block 0: scratch
    tables = np.full((B, MB_CHUNK), -1, np.int32)
    cur = 0
    for b, ln in enumerate(lengths):
        need = -(-ln // BS)
        tables[b, :need] = perm[cur:cur + need].numpy()
        cur += need
    for b in (2, 5):                                     # interior RAW holes
        tables[b, 3] = -1
    row_of, slots, p_end, s_start = [], [], [], []
    for b, ln in enumerate(lengths):
        c, pe, ss = chunks.get(b, (1, 0, 0))
        for s in range(ln - c, ln):
            row_of.append(b)
            slots.append(s)
            p_end.append(pe)
            s_start.append(ss)
    row_of += [-1] * n_pad
    slots += [0] * n_pad
    p_end += [0] * n_pad
    s_start += [0] * n_pad
    T = len(row_of)
    shape = (N_BLOCKS, BS, KVH, HD)
    if dtype_name == "int8":
        k = torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8)
        v = torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8)
        ks = torch.rand((N_BLOCKS, KVH), generator=gen) * 0.02 + 1e-3
        vs = torch.rand((N_BLOCKS, KVH), generator=gen) * 0.02 + 1e-3
        q_dtype = torch.float32
    else:
        dt = getattr(torch, dtype_name)
        k = torch.randn(shape, generator=gen).to(dt)
        v = torch.randn(shape, generator=gen).to(dt)
        ks = vs = None
        q_dtype = dt
    q_dec = torch.randn((B, H, HD), generator=gen).to(q_dtype)
    q_chunk = torch.randn((T, H, HD), generator=gen).to(q_dtype)
    i32 = lambda xs: torch.tensor(xs, dtype=torch.int32)
    return {
        "q_dec": q_dec, "q_chunk": q_chunk, "k": k, "v": v, "ks": ks, "vs": vs,
        "tables_chunk": torch.from_numpy(tables),
        "tables_dec": torch.from_numpy(np.ascontiguousarray(tables[:, :MB_DECODE])),
        "lengths": i32(lengths), "row_of": i32(row_of), "slots": i32(slots),
        "p_end": i32(p_end), "s_start": i32(s_start),
    }


def work(case, kernel):
    """(bytes the function must move, operations it must do) for this data:
    each K/V block the masks reach read once (all KV heads), q and the
    index arrays read once, the output written once; 4*hd flops per query
    head per valid slot (QK and PV)."""
    host = lambda name: case[name].cpu().numpy()
    tables = host("tables_chunk")
    kv_item = case["k"].element_size()
    if kernel == "paged_decode_attention":
        rows = [(b, 0, 0, ln - 1) for b, ln in enumerate(LENGTHS)]
        q = case["q_dec"]
        index_bytes = case["tables_dec"].numel() * 4 + B * 4
    else:
        rows = [(int(r), int(pe), int(ss), int(s)) for r, pe, ss, s in zip(
            host("row_of"), host("p_end"), host("s_start"), host("slots")) if r >= 0]
        q = case["q_chunk"]
        index_bytes = tables.size * 4 + 4 * 4 * q.shape[0]
    blocks, n_valid = set(), 0
    for b, pe, ss, slot in rows:
        s = np.arange(max(slot, pe - 1) + 1)
        backed = tables[b, s // BS] >= 0
        valid = backed & ((s < pe) | ((s >= ss) & (s <= slot)))
        n_valid += int(valid.sum())
        blocks.update(int(x) for x in np.unique(tables[b, s[valid] // BS]))
    block_bytes = 2 * len(blocks) * BS * KVH * HD * kv_item
    if case["ks"] is not None:
        block_bytes += 2 * len(blocks) * KVH * 4
    nbytes = block_bytes + 2 * q.numel() * q.element_size() + index_bytes
    ops = 4 * HD * H * n_valid
    return nbytes, ops


def check_close(name, got, want, valid, tol):
    atol, rtol = tol
    got, want = got.float()[valid], want.float()[valid]
    err = (got - want).abs()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite output")
    bad = err > atol + rtol * want.abs()
    if bool(bad.any()):
        raise AssertionError(f"{name}: {int(bad.sum())} elements off, max abs err "
                             f"{float(err.max()):.3e} at atol {atol}, rtol {rtol}")
    return float(err.max())


def time_ms(fn, flush, reps=30, warmup=3):
    """Median time of one call, each launch timed alone with CUDA events
    after a write of a buffer larger than the 50 MB L2 (the engine calls the
    kernels between weight-streaming matmuls, so K/V is cold). The card
    waits for the call's host side between the two events, so a short
    kernel's time includes its wrapper's launch cost (``device_ms`` does
    not)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def device_ms(fn, reps=10, spin_cycles=100_000_000):
    """Device time of one call with no host gaps: a spin kernel holds the
    stream while the host queues ``reps`` calls behind it, so the card runs
    them back to back, and CUDA events around them give the time (L2 warm:
    no flush between calls). None ("not measured") if the spin ended before
    the host had queued every call. The default spin is ~50 ms at the
    H100's 1.98 GHz boost clock."""
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(spin_cycles)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    if a.query():
        print(f"[device_ms] the spin ended before {reps} calls were queued; not measured",
              flush=True)
        b.synchronize()
        return None
    b.synchronize()
    return a.elapsed_time(b) / reps


def fmt_ms(x):
    return "not measured" if x is None else f"{x:.4f}"


def library_call(case, kernel):
    """One PyTorch SDPA call computing the same function on the gathered
    contiguous view with a boolean mask: a yardstick only, never used by
    the port."""
    import torch.nn.functional as F

    k, v = case["k"], case["v"]
    if k.dtype == torch.int8:
        return None
    if kernel == "paged_decode_attention":
        q = case["q_dec"]
        tab = case["tables_dec"].long()
        slot = torch.arange(MB_DECODE * BS, device=q.device)
        mask = (tab[:, slot // BS] >= 0) & (slot[None] < case["lengths"].long()[:, None])
    else:
        q = case["q_chunk"]
        rows = case["row_of"].long().clamp(min=0)
        tab = case["tables_chunk"].long()[rows]
        slot = torch.arange(MB_CHUNK * BS, device=q.device)
        pe, ss = case["p_end"].long()[:, None], case["s_start"].long()[:, None]
        mask = (tab[:, slot // BS] >= 0) & (
            (slot[None] < pe) | ((slot[None] >= ss) & (slot[None] <= case["slots"].long()[:, None])))
        mask[:, 0] |= case["row_of"] < 0        # pad tokens: keep one slot
    safe = tab.clamp(min=0)
    n = q.shape[0]
    kg = k[safe].reshape(n, -1, KVH, HD).transpose(1, 2).contiguous()
    vg = v[safe].reshape(n, -1, KVH, HD).transpose(1, 2).contiguous()
    qq = q[:, :, None, :]
    m = mask[:, None, None, :]
    return lambda: F.scaled_dot_product_attention(qq, kg, vg, attn_mask=m, enable_gqa=True)


def paged_calls(ka):
    """name -> (kernel call, plain call) on a case of ``make_case``."""
    return {
        "paged_decode_attention": (
            lambda c: ka.paged_decode_attention(
                c["q_dec"], c["k"], c["v"], c["tables_dec"], c["lengths"],
                k_scale=c["ks"], v_scale=c["vs"]),
            lambda c: ka.ref_paged_decode_attention(
                c["q_dec"], c["k"], c["v"], c["tables_dec"], c["lengths"],
                k_scale=c["ks"], v_scale=c["vs"])),
        "paged_chunk_attention": (
            lambda c: ka.paged_chunk_attention(
                c["q_chunk"], c["k"], c["v"], c["tables_chunk"], c["row_of"],
                c["slots"], c["p_end"], c["s_start"], k_scale=c["ks"], v_scale=c["vs"]),
            lambda c: ka.ref_paged_chunk_attention(
                c["q_chunk"], c["k"], c["v"], c["tables_chunk"], c["row_of"],
                c["slots"], c["p_end"], c["s_start"], k_scale=c["ks"], v_scale=c["vs"])),
    }


def on_card(case, dtype_name):
    """The case on the card, and the inputs of its second check: the same
    values in f32 (bf16 pools), or q in bf16 (int8 pools)."""
    case = {k: (v.cuda() if v is not None else None) for k, v in case.items()}
    other = None
    if dtype_name == "bfloat16":
        other = dict(case, **{k: case[k].float() for k in ("q_dec", "q_chunk", "k", "v")})
    elif dtype_name == "int8":
        other = dict(case, **{k: case[k].bfloat16() for k in ("q_dec", "q_chunk")})
    return case, other


def paged_row(name, kern, plain, case, other, dtype_name, flush, label=""):
    """Check one paged kernel on ``case`` against its plain version (and the
    second check on ``other``), then time it, its plain version and SDPA
    beside the bound."""
    valid = (case["row_of"] >= 0 if name == "paged_chunk_attention"
             else torch.ones(B, dtype=torch.bool, device="cuda"))
    got = kern(case)
    torch.cuda.synchronize()
    errs = {"plain": check_close(f"{name}[{dtype_name}{label}]", got, plain(case), valid,
                                 TOL[dtype_name]["plain"])}
    if name == "paged_chunk_attention" and not bool((got[~valid] == 0).all()):
        raise AssertionError("paged_chunk_attention: pad tokens must be zeros")
    if dtype_name == "bfloat16":
        errs["plain_f32"] = check_close(f"{name}[bf16 vs f32{label}]", got, plain(other),
                                        valid, TOL[dtype_name]["plain_f32"])
    elif dtype_name == "int8":
        errs["plain_bf16_q"] = check_close(
            f"{name}[int8, bf16 q{label}]", kern(other), plain(other), valid,
            TOL[dtype_name]["plain_bf16_q"])
    nbytes, ops = work(case, name)
    bytes_ms = nbytes / HBM_BYTES_S * 1e3
    ops_ms = ops / PEAK_OPS_S[dtype_name] * 1e3
    lib = library_call(case, name)
    r = {
        "name": name, "dtype": dtype_name, "errs": errs,
        "ms": time_ms(lambda: kern(case), flush),
        "device_ms": device_ms(lambda: kern(case)),
        "plain_ms": time_ms(lambda: plain(case), flush, reps=20),
        "library_ms": time_ms(lib, flush) if lib is not None else None,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "bytes": nbytes, "ops": ops,
    }
    if dtype_name == "int8":     # bf16 q over the int8 pool: the other route of the kernel
        r["device_ms_bf16_q"] = device_ms(lambda: kern(other))
    checks = ", ".join(f"vs {k} {e:.3e} (atol, rtol {TOL[dtype_name][k]})"
                       for k, e in errs.items())
    extra = (f" device_ms_bf16_q={fmt_ms(r['device_ms_bf16_q'])}"
             if "device_ms_bf16_q" in r else "")
    print(f"[kernels] {name} {dtype_name}{label}: max_abs_err {checks}; "
          f"kernel_ms={r['ms']:.4f} device_ms={fmt_ms(r['device_ms'])}{extra} "
          f"plain_ms={r['plain_ms']:.4f} library_ms={r['library_ms']} "
          f"bound_ms={r['bound_ms']:.5f} ({r['bound_by']}: {nbytes} B, {ops} flop)",
          flush=True)
    return r


def phase_kernels(ka):
    """Both paged kernels on the ragged case (``LENGTHS``, ``CHUNKS``), the
    split decode's edges, and the chunk kernel at the engine's mixed step
    (``MIXED_LENGTHS``): rows keyed (name, dtype) and, for the mixed step,
    (name, dtype, "mixed_step")."""
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    gen = torch.Generator().manual_seed(0)
    rows = {}
    calls = paged_calls(ka)
    for dtype_name in ("float32", "bfloat16", "int8"):
        case, other = on_card(make_case(dtype_name, gen), dtype_name)
        for name, (kern, plain) in calls.items():
            rows[(name, dtype_name)] = paged_row(name, kern, plain, case, other, dtype_name,
                                                 flush)
        rows[("paged_decode_attention", dtype_name)]["split_edges"] = check_split_edges(
            ka, case, other, dtype_name)
        del case, other
        case, other = on_card(make_case(dtype_name, gen, MIXED_LENGTHS, MIXED_CHUNKS,
                                        MIXED_PAD), dtype_name)
        kern, plain = calls["paged_chunk_attention"]
        rows[("paged_chunk_attention", dtype_name, "mixed_step")] = paged_row(
            "paged_chunk_attention", kern, plain, case, other, dtype_name, flush,
            label=", mixed step")
        del case, other
        torch.cuda.empty_cache()
    return rows


def check_split_edges(ka, case, other, dtype_name):
    """The decode kernel on ``SPLIT_LENGTHS`` with -1 holes at the table
    entries ``SPLIT_HOLES`` (split boundaries), against its plain version at
    the phase's tolerances; bf16 also against the plain version in f32, int8
    also with bf16 q. Returns {check: max abs err}."""
    def edged(c):
        tables = c["tables_dec"].clone()
        tables[:, list(SPLIT_HOLES)] = -1
        return dict(c, tables_dec=tables,
                    lengths=torch.tensor(SPLIT_LENGTHS, dtype=torch.int32, device="cuda"))

    def run(c, fn):
        return fn(c["q_dec"], c["k"], c["v"], c["tables_dec"], c["lengths"],
                  k_scale=c["ks"], v_scale=c["vs"])

    c, o = edged(case), edged(other) if other is not None else None
    every = torch.ones(B, dtype=torch.bool, device="cuda")
    name = f"paged_decode_attention[{dtype_name}, split edges]"
    got = run(c, ka.paged_decode_attention)
    torch.cuda.synchronize()
    errs = {"plain": check_close(name, got, run(c, ka.ref_paged_decode_attention), every,
                                 TOL[dtype_name]["plain"])}
    if dtype_name == "bfloat16":
        errs["plain_f32"] = check_close(name + " vs f32", got,
                                        run(o, ka.ref_paged_decode_attention), every,
                                        TOL[dtype_name]["plain_f32"])
    elif dtype_name == "int8":
        errs["plain_bf16_q"] = check_close(
            name + " bf16 q", run(o, ka.paged_decode_attention),
            run(o, ka.ref_paged_decode_attention), every, TOL[dtype_name]["plain_bf16_q"])
    checks = ", ".join(f"vs {k} {e:.3e} (atol, rtol {TOL[dtype_name][k]})"
                       for k, e in errs.items())
    print(f"[kernels] {name}: lengths {SPLIT_LENGTHS}, holes at entries {SPLIT_HOLES}: "
          f"max_abs_err {checks}", flush=True)
    return errs


# ---------------------------------------------------------------------------
# phase 2b: the dense backend's kernels against their plain versions
# ---------------------------------------------------------------------------

# 64 and 65: one whole 64-row tile and one row past it; 200 and 1100: no
# power-of-two tile above 8 divides them; 2048: the dense serve's largest bucket
FLASH_S = (16, 64, 65, 200, 1100, 2048)
DECODE_LENGTHS = {"lengths": LENGTHS, "shortest_1": LENGTHS[:-1] + [1],
                  "mixed_step": MIXED_LENGTHS}




def phase_dense_kernels(ka, kf):
    import torch.nn.functional as F

    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(11)
    rows = {}
    for dtype_name in ("float32", "bfloat16"):
        dt = getattr(torch, dtype_name)
        tol = TOL[dtype_name]
        for S in FLASH_S:
            q, k, v = (torch.randn((1, S, n, HD), generator=gen, device="cuda").to(dt)
                       for n in (H, KVH, KVH))
            for causal in (True, False):
                name = f"flash_attention[{dtype_name}, S={S}, causal={causal}]"
                got = kf.flash_attention(q, k, v, causal=causal)
                torch.cuda.synchronize()
                every = slice(None)
                errs = {"plain": check_close(name, got, kf.ref_flash_attention(q, k, v, causal),
                                             every, tol["plain"])}
                if dtype_name == "bfloat16":
                    want = kf.ref_flash_attention(q.float(), k.float(), v.float(), causal)
                    errs["plain_f32"] = check_close(name + " vs f32", got, want, every,
                                                    tol["plain_f32"])
                r = {"errs": errs}
                if S == FLASH_S[-1] and causal:
                    # SDPA on the (B, H, S, hd) layout, transposed outside the timing
                    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
                    lib = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                                 enable_gqa=True)
                    r.update(timed_row(flash_work(q, k, v, causal=True),
                                       dtype_name, flush,
                                       lambda: kf.flash_attention(q, k, v, causal=True),
                                       lambda: kf.ref_flash_attention(q, k, v, True), lib))
                rows[("flash_attention", dtype_name, S, causal)] = r
                print_dense_row(name, r, tol)
            del q, k, v
        for case, lengths in DECODE_LENGTHS.items():
            q = torch.randn((B, H, HD), generator=gen, device="cuda").to(dt)
            k, v = (torch.randn((B, 2048, KVH, HD), generator=gen, device="cuda").to(dt)
                    for _ in range(2))
            lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
            name = f"decode_attention[{dtype_name}, Sc=2048, {case}]"
            got = ka.decode_attention(q, k, v, lens)
            torch.cuda.synchronize()
            every = slice(None)
            errs = {"plain": check_close(name, got, ka.ref_decode_attention(q, k, v, lens),
                                         every, tol["plain"])}
            if dtype_name == "bfloat16":
                want = ka.ref_decode_attention(q.float(), k.float(), v.float(), lens)
                errs["plain_f32"] = check_close(name + " vs f32", got, want, every,
                                                tol["plain_f32"])
            r = {"errs": errs}
            if case in ("lengths", "mixed_step"):
                qt = q[:, :, None, :]
                kt, vt = (x.transpose(1, 2).contiguous() for x in (k, v))
                mask = (torch.arange(2048, device="cuda")[None] < lens.long()[:, None])
                mask = mask[:, None, None, :]
                lib = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                             enable_gqa=True)
                r.update(timed_row(decode_work(q, k, lengths),
                                   dtype_name, flush,
                                   lambda: ka.decode_attention(q, k, v, lens),
                                   lambda: ka.ref_decode_attention(q, k, v, lens), lib))
            rows[("decode_attention", dtype_name, case)] = r
            print_dense_row(name, r, tol)
            del q, k, v
        torch.cuda.empty_cache()
    return rows


def timed_row(work, dtype_name, flush, kern, plain, lib):
    nbytes, ops = work
    bytes_ms = nbytes / HBM_BYTES_S * 1e3
    ops_ms = ops / PEAK_OPS_S[dtype_name] * 1e3
    return {"ms": time_ms(kern, flush), "device_ms": device_ms(kern),
            "plain_ms": time_ms(plain, flush, reps=10),
            "library_ms": time_ms(lib, flush), "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "ops": ops}


def print_dense_row(name, r, tol):
    checks = ", ".join(f"vs {k} {e:.3e} (atol, rtol {tol[k]})" for k, e in r["errs"].items())
    times = (f"; kernel_ms={r['ms']:.4f} device_ms={fmt_ms(r['device_ms'])} "
             f"plain_ms={r['plain_ms']:.4f} library_ms={r['library_ms']:.4f} "
             f"bound_ms={r['bound_ms']:.5f} "
             f"({r['bound_by']}: {r['bytes']} B, {r['ops']} flop)") if "ms" in r else ""
    print(f"[dense kernels] {name}: max_abs_err {checks}{times}", flush=True)


# ---------------------------------------------------------------------------
# phase 2c: the RWKV-6 WKV kernel against its plain version
# ---------------------------------------------------------------------------

WKV_H, WKV_HD = 64, 64                       # rwkv6-7b: d_model 4096, head_dim 64
# (name, B, S, decay): None draws the realistic Finch decay exp(-exp(z)),
# z ~ N(0, 0.5), as tests/test_kernels.py does
WKV_CASES = (("prefill", 1, 2048, None), ("prefill", 1, 37, None), ("decode", 8, 1, None),
             ("w=0.45", 1, 2048, 0.45), ("w=1e-6", 1, 2048, 1e-6),
             # lengths about the kernel's segment edges (wkv_segments: one
             # segment up to 16 steps, then segments of >= 32 steps; 1519 is
             # the longest serve prompt)
             *(("segments", 1, S, None) for S in (1, 33, 255, 257, 1519)))
# both sides compute in f32 (bf16 r, k and v widen exactly): summation
# order only
WKV_TOL = (1e-4, 1e-4)


def wkv_inputs(gen, B, S, dtype, decay):
    shape = (B, S, WKV_H, WKV_HD)
    r, k = (0.5 * torch.randn(shape, generator=gen, device="cuda") for _ in range(2))
    v = torch.randn(shape, generator=gen, device="cuda")
    if decay is None:
        w = torch.exp(-torch.exp(0.5 * torch.randn(shape, generator=gen, device="cuda")))
    else:
        w = torch.full(shape, decay, device="cuda")
    u = 0.3 * torch.randn((WKV_H, WKV_HD), generator=gen, device="cuda")
    state0 = 0.5 * torch.randn((B, WKV_H, WKV_HD, WKV_HD), generator=gen, device="cuda")
    return r.to(dtype), k.to(dtype), v.to(dtype), w, u, state0




def phase_wkv_kernel(kw):
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(13)
    rows = {}
    for dtype_name in ("float32", "bfloat16"):
        dt = getattr(torch, dtype_name)
        for case, B, S, decay in WKV_CASES:
            r, k, v, w, u, state0 = wkv_inputs(gen, B, S, dt, decay)
            name = f"rwkv6_chunked[{dtype_name}, {case}, B={B}, S={S}]"
            y, st = kw.rwkv6_chunked(r, k, v, w, u, state0)
            torch.cuda.synchronize()
            y_ref, st_ref = kw.ref_rwkv6_chunked(r, k, v, w, u, state0)
            every = slice(None)
            err = max(check_close(name + " y", y, y_ref, every, WKV_TOL),
                      check_close(name + " state", st, st_ref, every, WKV_TOL))
            r_ = {"errs": {"plain": err},
                  "segments": kw.wkv_segments(kw.output_slots(0, dt, WKV_HD), B, WKV_H, S)}
            if case in ("prefill", "decode") and (case == "decode" or S == 2048):
                # the serve phase updates the state in place; here the
                # output goes to its own buffer, so every call sees the
                # same state0
                out = torch.empty_like(state0)
                kern = lambda: kw.rwkv6_chunked(r, k, v, w, u, state0, state_out=out)
                nbytes, ops = wkv_work(r, state0)
                bytes_ms = nbytes / HBM_BYTES_S * 1e3
                ops_ms = ops / PEAK_OPS_S["float32"] * 1e3
                r_.update({"ms": time_ms(kern, flush), "device_ms": device_ms(kern),
                           "plain_ms": time_ms(lambda: kw.ref_rwkv6_chunked(r, k, v, w, u, state0),
                                               flush, reps=5),
                           "library_ms": None, "bound_ms": max(bytes_ms, ops_ms),
                           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                           "bytes": nbytes, "ops": ops})
            rows[(dtype_name, case, S)] = r_
            times = (f"; kernel_ms={r_['ms']:.4f} device_ms={fmt_ms(r_['device_ms'])} "
                     f"plain_ms={r_['plain_ms']:.4f} library_ms=none (no single PyTorch call "
                     f"computes the recurrence) bound_ms={r_['bound_ms']:.5f} "
                     f"({r_['bound_by']}: {r_['bytes']} B, {r_['ops']} flop)") if "ms" in r_ else ""
            print(f"[wkv kernel] {name}: max_abs_err vs plain {err:.3e} (atol, rtol {WKV_TOL}), "
                  f"finite, (n_seg, seg_len) {r_['segments']}{times}", flush=True)
            del r, k, v, w, u, state0, y, st, y_ref, st_ref
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phase 2d: the selective-scan kernel against its plain version
# ---------------------------------------------------------------------------

SSM_DI, SSM_N = 1600, 16                     # hymba-1.5b: d_model 1600, ssm_state 16
# (name, B, S, extreme): dt = softplus(z), z ~ N(-2, 1) as tests/test_kernels.py
# draws it (dt * A near -0.1 .. -3), or for "extreme" z ~ N(1, 2) clipped to
# [-10, 3.1] (dt up to ~3.1: dt * A down to about -50 at A = -16)
SSM_CASES = (("prefill", 1, 1664, False), ("prefill", 1, 37, False), ("decode", 8, 1, False),
             ("extreme", 1, 1664, True),
             # lengths about the kernel's segment edges (ssm_segments; 1647 is
             # the longest hymba serve prefill: 128 meta + 1519 tokens)
             *(("segments", 1, S, False) for S in (1, 17, 129, 1647)))
# both sides compute in f32 (bf16 inputs widen exactly); the kernel's exp2 of
# dt * A * log2(e) against exp(dt * A): a few ulps a step
SSM_TOL = (1e-4, 1e-4)
SFU_PER_CLOCK = 16                           # exp2 results per clock per SM (sm_90)


def sfu_rate():
    """Exponentials per second the card can issue: SMs x 16 a clock at the
    card's maximum SM clock (nvidia-smi)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * SFU_PER_CLOCK * float(out) * 1e6, sms, float(out)


def ssm_inputs(gen, B, S, dtype, extreme):
    shape = (B, S, SSM_DI)
    z = torch.randn(shape, generator=gen, device="cuda")
    z = (2.0 * z + 1.0).clamp(-10.0, 3.1) if extreme else z - 2.0
    dt = torch.nn.functional.softplus(z)
    x = torch.randn(shape, generator=gen, device="cuda")
    bm, cm = (0.5 * torch.randn((B, S, SSM_N), generator=gen, device="cuda") for _ in range(2))
    a_log = torch.log(torch.arange(1, SSM_N + 1, dtype=torch.float32, device="cuda"))
    a_log = a_log.expand(SSM_DI, SSM_N).contiguous()
    h0 = 0.5 * torch.randn((B, SSM_DI, SSM_N), generator=gen, device="cuda")
    return dt.to(dtype), x.to(dtype), bm.to(dtype), cm.to(dtype), a_log, h0




def phase_ssm_kernel(ks):
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(17)
    exp_s, sms, clock = sfu_rate()
    print(f"[ssm kernel] SFU bound: {sms} SMs x {SFU_PER_CLOCK} exp2 a clock x {clock:.0f} MHz "
          f"(max SM clock) = {exp_s:.4e} exponentials/s", flush=True)
    rows = {}
    for dtype_name in ("float32", "bfloat16"):
        dt_ = getattr(torch, dtype_name)
        for case, B, S, extreme in SSM_CASES:
            dt, x, bm, cm, a_log, h0 = ssm_inputs(gen, B, S, dt_, extreme)
            name = f"ssm_scan[{dtype_name}, {case}, B={B}, S={S}]"
            y, h = ks.ssm_scan(dt, x, bm, cm, a_log, h0)
            torch.cuda.synchronize()
            y_ref, h_ref = ks.ref_ssm_scan(dt, x, bm, cm, a_log, h0)
            every = slice(None)
            errs = {"plain": max(check_close(name + " y", y, y_ref, every, SSM_TOL),
                                 check_close(name + " h", h, h_ref, every, SSM_TOL))}
            if dtype_name == "bfloat16":
                y32, h32 = ks.ref_ssm_scan(dt.float(), x.float(), bm.float(), cm.float(),
                                           a_log, h0)
                errs["plain_f32"] = max(check_close(name + " y vs f32", y, y32, every, SSM_TOL),
                                        check_close(name + " h vs f32", h, h32, every, SSM_TOL))
            r_ = {"errs": errs, "dA_min": float((dt.float().max() * -SSM_N)),
                  "segments": ks.ssm_segments(ks.output_slots(0, dt_, SSM_N), B, SSM_DI,
                                              SSM_N, S)}
            if case in ("prefill", "decode") and S != 37:
                # the serve phase updates h in place; here the output goes
                # to its own buffer, so every call sees the same h0
                out = torch.empty_like(h0)
                kern = lambda: ks.ssm_scan(dt, x, bm, cm, a_log, h0, h_out=out)
                nbytes, ops, exps = ssm_work(dt, bm, h0)
                parts = {"bytes": nbytes / HBM_BYTES_S * 1e3,
                         "operations": max(ops / PEAK_OPS_S["float32"], exps / exp_s) * 1e3}
                bound_by = max(parts, key=parts.get)
                r_.update({"ms": time_ms(kern, flush), "device_ms": device_ms(kern),
                           "plain_ms": time_ms(lambda: ks.ref_ssm_scan(dt, x, bm, cm, a_log, h0),
                                               flush, reps=5),
                           "library_ms": None, "bound_ms": parts[bound_by],
                           "bound_by": bound_by, "bytes": nbytes, "ops": ops, "exps": exps,
                           "exp_ms": exps / exp_s * 1e3,
                           "flop_ms": ops / PEAK_OPS_S["float32"] * 1e3})
            rows[(dtype_name, case, S)] = r_
            times = (f"; kernel_ms={r_['ms']:.4f} device_ms={fmt_ms(r_['device_ms'])} "
                     f"plain_ms={r_['plain_ms']:.4f} library_ms=none (no single PyTorch call "
                     f"computes the scan) bound_ms={r_['bound_ms']:.5f} ({r_['bound_by']}: "
                     f"{r_['bytes']} B = {r_['bytes'] / HBM_BYTES_S * 1e3:.5f} ms, "
                     f"{r_['ops']} flop = {r_['flop_ms']:.5f} ms, {r_['exps']} exp = "
                     f"{r_['exp_ms']:.5f} ms)") if "ms" in r_ else ""
            checks = ", ".join(f"vs {k} {e:.3e}" for k, e in errs.items())
            print(f"[ssm kernel] {name}: max_abs_err {checks} (atol, rtol {SSM_TOL}), finite, "
                  f"min dt*A {r_['dA_min']:.1f}, (n_seg, seg_len) {r_['segments']}{times}",
                  flush=True)
            del dt, x, bm, cm, a_log, h0, y, h, y_ref, h_ref
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phase 2e: the flash kernel with a sliding window
# ---------------------------------------------------------------------------

SWA_H, SWA_KVH, SWA_HD = 25, 5, 64           # hymba-1.5b's heads
SWA_CASES = ((1664, 1024), (300, 64))        # (S, window): full width, smoke window




def phase_swa_kernels(kf, heads=(SWA_H, SWA_KVH, SWA_HD), cases=SWA_CASES, seed=19):
    """The windowed flash kernel at ``heads`` (H, KVH, hd) on each (S,
    window) of ``cases`` against its plain version, f32 and bf16 (bf16 also
    against the plain version in f32); the first case also timed beside the
    bound and one SDPA call with the windowed causal mask."""
    import torch.nn.functional as F

    Hq, Hkv, hd = heads
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = {}
    for dtype_name in ("float32", "bfloat16"):
        dt = getattr(torch, dtype_name)
        tol = TOL[dtype_name]
        for S, window in cases:
            q, k, v = (torch.randn((1, S, n, hd), generator=gen, device="cuda").to(dt)
                       for n in (Hq, Hkv, Hkv))
            name = f"flash_attention[{dtype_name}, H={Hq}, KVH={Hkv}, S={S}, window={window}]"
            got = kf.flash_attention(q, k, v, window=window)
            torch.cuda.synchronize()
            every = slice(None)
            errs = {"plain": check_close(name, got, kf.ref_flash_attention(q, k, v, window=window),
                                         every, tol["plain"])}
            if dtype_name == "bfloat16":
                want = kf.ref_flash_attention(q.float(), k.float(), v.float(), window=window)
                errs["plain_f32"] = check_close(name + " vs f32", got, want, every,
                                                tol["plain_f32"])
            r = {"errs": errs}
            if (S, window) == cases[0]:
                qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
                i = torch.arange(S, device="cuda")
                mask = (i[None] <= i[:, None]) & (i[None] > i[:, None] - window)
                lib = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                             enable_gqa=True)
                r.update(timed_row(flash_work(q, k, v, window=window), dtype_name, flush,
                                   lambda: kf.flash_attention(q, k, v, window=window),
                                   lambda: kf.ref_flash_attention(q, k, v, window=window), lib))
                del qt, kt, vt, mask, lib
            rows[(dtype_name, S, window)] = r
            print_dense_row(name, r, tol)
            del q, k, v
            torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phase 2f: the dense decode kernel at hymba's heads
# ---------------------------------------------------------------------------

SWA_SC = 1024                                # hymba-1.5b's ring: min(max_seq + 128, window)
# full rings (every decode step past the window) beside short rows; and the
# mixed step's lengths on the ring
SWA_DECODE_CASES = {"rings": [1024, 1024, 1, 1024, 37, 1024, 300, 1024],
                    "mixed_step": [min(n, SWA_SC) for n in MIXED_LENGTHS]}


def phase_swa_decode_kernel(ka, heads=(SWA_H, SWA_KVH, SWA_HD), Sc=SWA_SC,
                            cases=SWA_DECODE_CASES, seed=23):
    """``decode_attention`` at the hymba serve phase's shapes (B 8, H 25 over
    KVH 5, hd 64, a 1024-slot ring, lengths min(pos + 1, 1024)), or at
    ``heads`` (H, KVH, hd) on an ``Sc``-slot ring, against its plain version,
    in f32 and bf16 (bf16 also against the plain version in f32), with the
    tolerances of phase 2b, on each of ``cases``; then its times beside the
    bound and a masked SDPA."""
    import torch.nn.functional as F

    Hq, Hkv, hd = heads
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = {}
    for case, lengths in cases.items():
        lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        Bd = len(lengths)
        for dtype_name in ("float32", "bfloat16"):
            dt = getattr(torch, dtype_name)
            tol = TOL[dtype_name]
            q = torch.randn((Bd, Hq, hd), generator=gen, device="cuda").to(dt)
            k, v = (torch.randn((Bd, Sc, Hkv, hd), generator=gen,
                                device="cuda").to(dt) for _ in range(2))
            name = f"decode_attention[{dtype_name}, H={Hq}, KVH={Hkv}, hd={hd}, Sc={Sc}, {case}]"
            got = ka.decode_attention(q, k, v, lens)
            torch.cuda.synchronize()
            every = slice(None)
            errs = {"plain": check_close(name, got, ka.ref_decode_attention(q, k, v, lens),
                                         every, tol["plain"])}
            if dtype_name == "bfloat16":
                want = ka.ref_decode_attention(q.float(), k.float(), v.float(), lens)
                errs["plain_f32"] = check_close(name + " vs f32", got, want, every,
                                                tol["plain_f32"])
            qt = q[:, :, None, :]
            kt, vt = (x.transpose(1, 2).contiguous() for x in (k, v))
            mask = (torch.arange(Sc, device="cuda")[None] < lens.long()[:, None])[:, None, None]
            lib = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                         enable_gqa=True)
            r = {"errs": errs}
            r.update(timed_row(decode_work(q, k, lengths),
                               dtype_name, flush, lambda: ka.decode_attention(q, k, v, lens),
                               lambda: ka.ref_decode_attention(q, k, v, lens), lib))
            rows[(dtype_name, case)] = r
            print_dense_row(name, r, tol)
            del q, k, v, qt, kt, vt
            torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phase 3: the top-k retrieval kernel against its plain version
# ---------------------------------------------------------------------------

N_DOCS, DIM, N_QUERIES, N_CLUSTERS = 1 << 21, 768, 32, 1024
TOPK_KS = (10, 100)
# scores: the kernel sums each dot product in another order than the plain
# version's matrix product (a few ulps); ids: two docs may swap places only
# where the plain version's scores of the two lie within "swap"; on exact
# ties (integer-valued docs, all products exact) the ids must be equal
TOPK_TOL = {"score_atol": 1e-4, "swap": 1e-5}


def check_topk(name, got, want, q, docs, exact_ids):
    (gs, gi), (ws, wi) = got, want
    if gs.shape != ws.shape or gi.dtype != torch.int32 or gs.dtype != torch.float32:
        raise AssertionError(f"{name}: got {gs.dtype}{tuple(gs.shape)}/{gi.dtype}, "
                             f"want {ws.dtype}{tuple(ws.shape)}/{wi.dtype}")
    if not bool(torch.isfinite(gs).all()):
        raise AssertionError(f"{name}: non-finite scores")
    err = float((gs - ws).abs().max())
    if err > TOPK_TOL["score_atol"]:
        raise AssertionError(f"{name}: max abs score err {err:.3e} > {TOPK_TOL['score_atol']}")
    diff = gi != wi
    if exact_ids:
        if bool(diff.any()):
            raise AssertionError(f"{name}: {int(diff.sum())} ids differ on exact ties")
    elif bool(diff.any()):
        full = q.float() @ docs.float().T
        gap = (full.gather(1, gi.long()) - full.gather(1, wi.long())).abs()[diff]
        if float(gap.max()) > TOPK_TOL["swap"]:
            raise AssertionError(f"{name}: {int(diff.sum())} ids differ, plain-score gap "
                                 f"up to {float(gap.max()):.3e} > {TOPK_TOL['swap']}")
    return err, int(diff.sum())




def phase_topk(tk, corpus, queries):
    """``corpus``: the (N_DOCS, DIM) float32 corpus on the card; ``queries``:
    (N_QUERIES, DIM) float32 on the card."""
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(5)
    rows = {}
    for case in ("float32", "bfloat16", "ties_float32", "ties_bfloat16"):
        if case.startswith("ties"):
            base = torch.randint(-2, 3, (4096, DIM), generator=gen, device="cuda").float()
            docs = base[torch.randint(0, 4096, (N_DOCS,), generator=gen, device="cuda")]
            q = torch.randint(-2, 3, (N_QUERIES, DIM), generator=gen, device="cuda").float()
            del base
        else:
            docs, q = corpus, queries
        if case.endswith("bfloat16"):
            docs = docs.bfloat16()
        for k in TOPK_KS:
            got = tk.topk_retrieval(q, docs, k)
            torch.cuda.synchronize()
            err, n_swapped = check_topk(f"topk_retrieval[{case}, k={k}]", got,
                                        tk.ref_topk_retrieval(q, docs, k), q, docs,
                                        exact_ids=case.startswith("ties"))
            r = {"case": case, "k": k, "max_abs_err": err, "swapped": n_swapped}
            if not case.startswith("ties"):
                nbytes, ops, products = topk_work(q, docs, k)
                bytes_ms = nbytes / HBM_BYTES_S * 1e3
                ops_ms = ops / PEAK_OPS_S["tf32"] * 1e3
                # bf16 docs: one PyTorch call on the f32 upcast (no bf16 x f32 product)
                lib = ((lambda: torch.topk(q @ docs.T, k)) if docs.dtype == torch.float32
                       else (lambda: torch.topk(q @ docs.float().T, k)))
                r.update({
                    "ms": time_ms(lambda: tk.topk_retrieval(q, docs, k), flush),
                    "device_ms": device_ms(lambda: tk.topk_retrieval(q, docs, k)),
                    "plain_ms": time_ms(lambda: tk.ref_topk_retrieval(q, docs, k), flush,
                                        reps=10),
                    "library_ms": time_ms(lib, flush, reps=10),
                    "library": ("torch.topk(q @ docs.T, k)" if docs.dtype == torch.float32
                                else "torch.topk(q @ docs.float().T, k), the upcast included"),
                    "bound_ms": max(bytes_ms, ops_ms),
                    "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                    "bytes": nbytes, "ops": ops, "products": products,
                })
            rows[(case, k)] = r
            times = (f"; kernel_ms={r['ms']:.4f} device_ms={fmt_ms(r['device_ms'])} "
                     f"plain_ms={r['plain_ms']:.4f} library_ms={r['library_ms']:.4f} "
                     f"[{r['library']}] bound_ms={r['bound_ms']:.4f} ({r['bound_by']}: "
                     f"{r['bytes']} B; {r['ops']} flop = {r['products']} split-tf32 "
                     f"products of 2BNd at 495 TFLOP/s)") if "ms" in r else ""
            print(f"[topk] {case} B={N_QUERIES} N={N_DOCS} d={DIM} k={k}: max_abs_err "
                  f"{err:.3e} (atol {TOPK_TOL['score_atol']}), {n_swapped} ids swapped "
                  f"within {TOPK_TOL['swap']}{times}", flush=True)
        del docs, q
        torch.cuda.empty_cache()
    return rows

# ---------------------------------------------------------------------------
# phase 4: engine parity at smoke width, CPU against GPU
# ---------------------------------------------------------------------------


def rag_workload(rng, vocab, doc_len, tail_range, n_shared, n_fresh, fresh_range,
                 seg_lens):
    """Prompts: ``n_shared`` with one retrieved document as a shared prefix,
    ``n_fresh`` unrelated ones, and one SegmentedPrompt of two documents."""
    from repro_torch.serving.segments import assemble_prompt

    doc = rng.integers(0, vocab, doc_len)
    prompts = [np.concatenate([doc, rng.integers(0, vocab, int(rng.integers(*tail_range)))])
               for _ in range(n_shared)]
    prompts += [rng.integers(0, vocab, int(rng.integers(*fresh_range))) for _ in range(n_fresh)]
    sysp, d1, d2, q = (rng.integers(0, vocab, n) for n in seg_lens)
    prompts.append(assemble_prompt(q, [d1, d2], [0, 1], sysp))
    return prompts


def phase_parity():
    from repro_torch.configs import get_arch, smoke_variant
    from repro_torch.models import init_params
    from repro_torch.serving.engine import GenerationEngine

    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 products
    torch.backends.cudnn.allow_tf32 = False
    cfg = smoke_variant(get_arch("smollm-135m"))
    prompts = rag_workload(np.random.default_rng(1), cfg.vocab_size, 48, (5, 40),
                           3, 2, (10, 90), (16, 48, 32, 9))
    out = {}
    for dev in ("cpu", "cuda"):
        params = init_params(cfg, torch.Generator().manual_seed(0), dev)
        eng = GenerationEngine(cfg, params=params, device=dev, max_batch=4, max_seq=256)
        reqs = [eng.submit(p, max_new=12) for p in prompts]
        eng.run_until_done()
        assert all(len(r.out_tokens) == 12 for r in reqs), dev
        out[dev] = ([r.out_tokens for r in reqs], eng.stats())
    if out["cpu"][0] != out["cuda"][0]:
        raise AssertionError(f"CPU and GPU greedy tokens differ:\n{out['cpu'][0]}\n{out['cuda'][0]}")
    assert out["cuda"][1]["kernel"] == "cuda" and out["cpu"][1]["kernel"] == "plain"
    assert out["cuda"][1]["prefix_hit_tokens"] > 0
    print(f"[parity] smoke width f32: {len(prompts)} requests, identical greedy "
          f"tokens on cpu (plain) and cuda (kernels); prefix-hit tokens "
          f"{out['cuda'][1]['prefix_hit_tokens']}", flush=True)


def phase_pipeline_parity():
    """The same seeded open-loop trace (vrag + crag at 10 requests/s for 1
    trace-second, 30% sessions) through ``serve_pipelines`` on the CPU and on
    the card: identical driver records and tokens."""
    from repro_torch.configs import get_arch, smoke_variant
    from repro_torch.launch.serve import serve_pipelines
    from repro_torch.models import init_params

    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 products
    torch.backends.cudnn.allow_tf32 = False
    cfg = smoke_variant(get_arch("smollm-135m"))
    out = {}
    for dev in ("cpu", "cuda"):
        params = init_params(cfg, torch.Generator().manual_seed(0), dev)
        drv = serve_pipelines("smollm-135m", 10.0, 1.0, smoke=True, device=dev,
                              params=params, apps=("vrag", "crag"),
                              session_fraction=0.3, seed=1)
        reqs = sorted(drv.engine.finished, key=lambda r: r.req_id)
        out[dev] = (drv.records, [r.out_tokens for r in reqs], drv.engine.stats())
    if out["cpu"][:2] != out["cuda"][:2]:
        raise AssertionError("CPU and GPU pipeline runs differ:\n"
                             f"{out['cpu'][:2]}\n{out['cuda'][:2]}")
    assert out["cuda"][2]["kernel"] == "cuda" and out["cpu"][2]["kernel"] == "plain"
    assert out["cuda"][2]["session_shared_tokens"] > 0
    print(f"[parity] pipelines at smoke width f32: {len(out['cuda'][0])} pipelines, "
          f"{len(out['cuda'][1])} engine requests, identical records and tokens on cpu "
          f"and cuda; session-shared tokens {out['cuda'][2]['session_shared_tokens']}",
          flush=True)


def phase_dense_parity(ka, kf, kw):
    """The RAG workload of ``phase_parity`` on the dense backend: identical
    greedy tokens on the CPU (plain versions) and on the GPU (kernels), and
    on the GPU identical to the paged backend's. The segmented prompt is
    submitted flat to all three (the paged backend would otherwise give its
    documents their own positions, which the dense backend does not)."""
    from repro_torch.configs import get_arch, smoke_variant
    from repro_torch.models import init_params
    from repro_torch.serving.engine import GenerationEngine
    from repro_torch.serving.segments import SegmentedPrompt

    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 products
    torch.backends.cudnn.allow_tf32 = False
    cfg = smoke_variant(get_arch("smollm-135m"))
    prompts = [p.tokens if isinstance(p, SegmentedPrompt) else p
               for p in rag_workload(np.random.default_rng(1), cfg.vocab_size, 48, (5, 40),
                                     3, 2, (10, 90), (16, 48, 32, 9))]
    out = {}
    for dev, backend in (("cpu", "dense"), ("cuda", "dense"), ("cuda", "paged")):
        params = init_params(cfg, torch.Generator().manual_seed(0), dev)
        eng = GenerationEngine(cfg, params=params, device=dev, backend=backend,
                               max_batch=4, max_seq=256)
        ka.reset_launch_counts()
        kf.reset_launch_counts()
        kw.reset_launch_counts()
        reqs = [eng.submit(p, max_new=12) for p in prompts]
        eng.run_until_done()
        assert all(len(r.out_tokens) == 12 for r in reqs), (dev, backend)
        assert eng.stats()["backend"] == backend
        out[(dev, backend)] = [r.out_tokens for r in reqs]
        if (dev, backend) == ("cuda", "dense"):
            launches = (kf.flash_attention.launches, ka.decode_attention.launches)
            assert launches == (cfg.num_layers * len(prompts),
                                cfg.num_layers * eng.stats()["steps"]), launches
            assert kw.rwkv6_chunked.launches == 0
    if out[("cpu", "dense")] != out[("cuda", "dense")]:
        raise AssertionError("dense backend: CPU and GPU greedy tokens differ:\n"
                             f"{out[('cpu', 'dense')]}\n{out[('cuda', 'dense')]}")
    if out[("cuda", "dense")] != out[("cuda", "paged")]:
        raise AssertionError("GPU dense and paged greedy tokens differ:\n"
                             f"{out[('cuda', 'dense')]}\n{out[('cuda', 'paged')]}")
    print(f"[parity] dense backend at smoke width f32: {len(prompts)} requests, identical "
          f"greedy tokens on cpu (plain) and cuda (kernels), and equal to the paged "
          f"backend's on cuda; flash/decode launches {launches}", flush=True)


def phase_rwkv_parity(kw):
    """The RWKV-6 smoke model's engine (``backend="paged"``, which falls
    back to dense) on the RAG workload of ``phase_parity``, flattened:
    identical greedy tokens on the CPU (plain versions) and on the GPU (the
    WKV kernel)."""
    from repro_torch.configs import get_arch, smoke_variant
    from repro_torch.models import init_params
    from repro_torch.serving.engine import GenerationEngine
    from repro_torch.serving.segments import SegmentedPrompt

    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 products
    torch.backends.cudnn.allow_tf32 = False
    cfg = smoke_variant(get_arch("rwkv6-7b"))
    prompts = [p.tokens if isinstance(p, SegmentedPrompt) else p
               for p in rag_workload(np.random.default_rng(1), cfg.vocab_size, 48, (5, 40),
                                     3, 2, (10, 90), (16, 48, 32, 9))]
    out = {}
    for dev in ("cpu", "cuda"):
        params = init_params(cfg, torch.Generator().manual_seed(0), dev)
        eng = GenerationEngine(cfg, params=params, device=dev, max_batch=4, max_seq=256)
        kw.reset_launch_counts()
        reqs = [eng.submit(p, max_new=12) for p in prompts]
        eng.run_until_done()
        st = eng.stats()
        assert st["backend"] == "dense" and all(len(r.out_tokens) == 12 for r in reqs), dev
        out[dev] = [r.out_tokens for r in reqs]
        if dev == "cuda":
            launches = kw.rwkv6_chunked.launches
            assert launches == cfg.num_layers * (len(prompts) + st["steps"]), (launches, st)
    if out["cpu"] != out["cuda"]:
        raise AssertionError("RWKV-6 engine: CPU and GPU greedy tokens differ:\n"
                             f"{out['cpu']}\n{out['cuda']}")
    print(f"[parity] rwkv6-7b smoke engine f32 (backend paged -> dense): {len(prompts)} "
          f"requests (prompts {min(map(len, prompts))}-{max(map(len, prompts))} tokens), "
          f"identical greedy tokens on cpu (plain) and cuda (kernel); rwkv6_chunked "
          f"launches {launches} = {cfg.num_layers} x ({len(prompts)} prefills + "
          f"{launches // cfg.num_layers - len(prompts)} decode steps)", flush=True)


def phase_hymba_parity(ka, kf, ks):
    """The hymba smoke model's engine (``backend="paged"``, which falls back
    to dense) on the RAG workload of ``phase_parity``, flattened: identical
    greedy tokens on the CPU (plain versions) and on the GPU (kernels).
    Its prompts (plus 8 meta tokens) run past the 64-token window."""
    from repro_torch.configs import get_arch, smoke_variant
    from repro_torch.models import init_params
    from repro_torch.serving.engine import GenerationEngine
    from repro_torch.serving.segments import SegmentedPrompt

    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 products
    torch.backends.cudnn.allow_tf32 = False
    cfg = smoke_variant(get_arch("hymba-1.5b"))
    prompts = [p.tokens if isinstance(p, SegmentedPrompt) else p
               for p in rag_workload(np.random.default_rng(1), cfg.vocab_size, 48, (5, 40),
                                     3, 2, (10, 90), (16, 48, 32, 9))]
    out = {}
    for dev in ("cpu", "cuda"):
        params = init_params(cfg, torch.Generator().manual_seed(0), dev)
        eng = GenerationEngine(cfg, params=params, device=dev, max_batch=4, max_seq=256)
        ka.reset_launch_counts()
        kf.reset_launch_counts()
        ks.reset_launch_counts()
        reqs = [eng.submit(p, max_new=12) for p in prompts]
        eng.run_until_done()
        st = eng.stats()
        assert st["backend"] == "dense" and all(len(r.out_tokens) == 12 for r in reqs), dev
        out[dev] = [r.out_tokens for r in reqs]
        if dev == "cuda":
            L, n_pre, n_dec = cfg.num_layers, len(prompts), st["steps"]
            launches = (ks.ssm_scan.launches, kf.flash_attention.launches,
                        ka.decode_attention.launches)
            assert launches == (L * (n_pre + n_dec), L * n_pre, L * n_dec), (launches, st)
    if out["cpu"] != out["cuda"]:
        raise AssertionError("hymba engine: CPU and GPU greedy tokens differ:\n"
                             f"{out['cpu']}\n{out['cuda']}")
    print(f"[parity] hymba-1.5b smoke engine f32 (backend paged -> dense): {len(prompts)} "
          f"requests (prompts {min(map(len, prompts))}-{max(map(len, prompts))} tokens + "
          f"{cfg.num_meta_tokens} meta, window {cfg.window}), identical greedy tokens on cpu "
          f"(plain) and cuda (kernels); ssm_scan/flash/decode launches {launches} = "
          f"{cfg.num_layers} x ({len(prompts)} prefills + {n_dec} decode steps), "
          f"{cfg.num_layers} x {len(prompts)}, {cfg.num_layers} x {n_dec}", flush=True)


# ---------------------------------------------------------------------------
# phase 4d: int8 pools and swap/cost preemption at smoke width, CPU and card
# ---------------------------------------------------------------------------

# the cost model's per-token step time, pinned on both devices (a wall-clock
# quantity otherwise); at 6e-7 s the float pool of LONG_DECODE's workload
# swaps some victims and recomputes others
PINNED_TOKEN_S = 6e-7


def long_decode_workload(eng, seed):
    """The invariant harness's long-decode workload (tests/
    test_engine_invariants.py ``_run_workload(long_decode=True)``), greedy:
    bursts of short prompts with 28-38 new tokens each, interleaved with
    engine steps, so decodes outgrow a tiny pool and preempt."""
    rng = np.random.default_rng(seed)
    reqs = []
    for _ in range(4):
        for _ in range(int(rng.integers(1, 4))):
            prompt = rng.integers(0, 90, size=int(rng.integers(3, 13)))
            reqs.append(eng.submit(prompt, max_new=int(rng.integers(28, 39)),
                                   priority=float(rng.random())))
        for _ in range(int(rng.integers(0, 4))):
            eng.step()
    eng.run_until_done(max_steps=2000)
    return reqs


def pin_token_time(eng, value):
    """Hold the runner's per-token step time at ``value`` through a run."""
    runner = eng.runner
    orig = runner.materialize

    def materialize(ex):
        out = orig(ex)
        runner.token_time_ema = value
        return out

    runner.materialize = materialize
    runner.token_time_ema = value


# the engine's int8 state, CPU against card: the K/V both quantize come
# from float32 stacks summing in different orders (cuBLAS against the CPU's
# matmuls), so payloads may sit one code apart where a value lies near a
# .5 boundary, and scales (absmax / 127) agree as the K/V do: 1e-5
# relative. On identical inputs the quantized write is exact
# (``check_scatter_exact``).
INT8_SCALE_RTOL = 1e-5


def int8_state_diff(cpu_kv, gpu_kv):
    """(max code difference of the int8 payloads, max relative scale
    difference), over every block but the null block (block 0: pad tokens
    write it and nothing reads it)."""
    codes = max(int((a[:, 1:].int() - b.cpu()[:, 1:].int()).abs().max())
                for a, b in ((cpu_kv.k, gpu_kv.k), (cpu_kv.v, gpu_kv.v)))
    rel = 0.0
    for a, b in ((cpu_kv.k_scale, gpu_kv.k_scale), (cpu_kv.v_scale, gpu_kv.v_scale)):
        a, b = a[:, 1:], b.cpu()[:, 1:]
        rel = max(rel, float(((a - b).abs() / a.abs().clamp(min=1e-30)).max()))
    return codes, rel


def check_scatter_exact():
    """The quantized scatter on the card against the CPU on identical
    inputs at qwen2.5-3b's pool geometry (one layer slice, 264 packed
    tokens): random values over partly zero scales, and values that all lie
    exactly on a .5 code (scale 2**-7), which both round half to even.
    Payloads and scales must be equal bit for bit. Returns the case count."""
    from repro_torch.serving.paged_cache import _quantized_scatter

    g = torch.Generator().manual_seed(5)
    nb, T = 64, 264
    for ties in (False, True):
        if ties:
            pool = torch.zeros((1, nb, BS, KVH, HD), dtype=torch.int8)
            sc = torch.zeros((1, nb, KVH))
            dest = torch.arange(1, nb) * BS + torch.randint(0, BS, (nb - 1,), generator=g)
            vals = (torch.randint(-127, 127, (1, nb - 1, KVH, HD), generator=g) + 0.5) / 128
            vals[..., 0] = 127.0 / 128.0
        else:
            pool = torch.randint(-127, 128, (1, nb, BS, KVH, HD), generator=g,
                                 dtype=torch.int8)
            sc = torch.rand((1, nb, KVH), generator=g) * 0.02
            sc[:, :8] = 0.0
            dest = torch.randperm(nb * BS, generator=g)[:T]
            vals = torch.randn((1, T, KVH, HD), generator=g) * 3.0
        cpu, card = (pool.clone(), sc.clone()), (pool.cuda(), sc.cuda())
        _quantized_scatter(*cpu, dest, vals)
        _quantized_scatter(*card, dest.cuda(), vals.cuda())
        if not (torch.equal(card[0].cpu(), cpu[0]) and torch.equal(card[1].cpu(), cpu[1])):
            raise AssertionError(f"quantized scatter (ties={ties}): card and CPU differ")
    return 2


def phase_int8_swap_parity():
    """int8 pools and the preemption strategies on the CPU and on the card:
    the RAG workload of ``phase_parity`` on an int8 pool (full
    provisioning), and the harness's long-decode workload on a 6-block pool
    under ``preempt="swap"`` (float and int8) and ``"cost"`` (the step time
    pinned). Identical greedy tokens and preemption/swap counts; int8
    payloads within one code and scales within ``INT8_SCALE_RTOL``; and the
    quantized scatter exact on identical inputs, .5 ties included."""
    from repro_torch.configs import get_arch, smoke_variant
    from repro_torch.models import init_params
    from repro_torch.serving.engine import GenerationEngine

    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 products
    torch.backends.cudnn.allow_tf32 = False
    n_exact = check_scatter_exact()
    print(f"[parity] quantized scatter at qwen2.5-3b's pool geometry: {n_exact} cases "
          f"(random, all .5 ties) equal bit for bit on cpu and cuda", flush=True)
    cfg = smoke_variant(get_arch("smollm-135m"))
    prompts = rag_workload(np.random.default_rng(1), cfg.vocab_size, 48, (5, 40),
                           3, 2, (10, 90), (16, 48, 32, 9))
    counters = ("steps", "preemptions", "swap_outs", "swap_ins", "cost_swap_choices",
                "cost_recompute_choices", "prefix_hit_tokens", "host_hit_tokens",
                "prefill_tokens")
    cases = {
        "int8 full pool": dict(kv_dtype="int8"),
        "swap float": dict(n_blocks=6, preempt="swap", seed=5),
        "swap int8": dict(n_blocks=6, preempt="swap", kv_dtype="int8", seed=5),
        "cost float": dict(n_blocks=6, preempt="cost", seed=6, scheduler="edf_slack"),
    }
    for name, kw in cases.items():
        kw = dict(kw)
        seed = kw.pop("seed", None)
        out = {}
        for dev in ("cpu", "cuda"):
            params = init_params(cfg, torch.Generator().manual_seed(0), dev)
            if seed is None:
                eng = GenerationEngine(cfg, params=params, device=dev, max_batch=4,
                                       max_seq=256, **kw)
                reqs = [eng.submit(p, max_new=12) for p in prompts]
                eng.run_until_done()
            else:
                eng = GenerationEngine(cfg, params=params, device=dev, max_batch=3,
                                       max_seq=96, prefill_chunk_size=16, token_budget=20,
                                       **kw)
                if kw["preempt"] == "cost":
                    pin_token_time(eng, PINNED_TOKEN_S)
                reqs = long_decode_workload(eng, seed)
            st = eng.stats()
            assert all(r.done and len(r.out_tokens) == r.max_new for r in reqs), (name, dev)
            assert pool_is_clean(eng), (name, dev)
            if eng.host_store is not None:
                assert eng.host_store.n_swapped == 0 and st["swap_ins"] == st["swap_outs"]
            out[dev] = ([r.out_tokens for r in reqs], {c: st[c] for c in counters}, eng)
        if out["cpu"][0] != out["cuda"][0]:
            raise AssertionError(f"{name}: CPU and GPU greedy tokens differ:\n"
                                 f"{out['cpu'][0]}\n{out['cuda'][0]}")
        if out["cpu"][1] != out["cuda"][1]:
            raise AssertionError(f"{name}: counters differ: {out['cpu'][1]} {out['cuda'][1]}")
        st = out["cuda"][1]
        extra = ""
        if "int8" in name:
            codes, rel = int8_state_diff(out["cpu"][2].kv, out["cuda"][2].kv)
            assert codes <= 1 and rel <= INT8_SCALE_RTOL, (name, codes, rel)
            extra = (f"; int8 payloads within {codes} code(s), scales within {rel:.3g} "
                     f"relative")
        if kw.get("preempt") in ("swap", "cost"):
            assert st["preemptions"] >= 1 and st["swap_outs"] >= 1, (name, st)
        print(f"[parity] {name} smoke width f32: {len(out['cuda'][0])} requests, identical "
              f"greedy tokens and counters on cpu (plain) and cuda (kernels): {st}{extra}",
              flush=True)


# ---------------------------------------------------------------------------
# phase 5: serve qwen2.5-3b at full width
# ---------------------------------------------------------------------------


def phase_serve(ka, kf, tk, cfg, params):
    """Serve the RAG workload on ``cfg`` (qwen2.5-3b, bf16, on the card).
    Returns the kernels' launches in the run, the prompts, the greedy tokens
    and the pool's bytes."""
    from repro_torch.models import prefill_packed
    from repro_torch.serving.engine import GenerationEngine

    t0 = time.perf_counter()
    eng = GenerationEngine(cfg, params=params, device="cuda", max_batch=8,
                           max_seq=2048, block_size=16, prefill_chunk_size=256)
    n_var = eng.warmup_step_variants()
    print(f"[serve] {cfg.name} {cfg.dtype}: pools + warmup of {n_var} "
          f"packed lengths in {time.perf_counter() - t0:.1f}s", flush=True)
    prompts = rag_workload(np.random.default_rng(0), cfg.vocab_size, 512, (64, 1025),
                           5, 4, (128, 1537), (32, 256, 384, 40))
    lens = [len(p) for p in prompts]
    assert min(lens) >= 128 and max(lens) <= 1536, lens

    reset_launches(ka, kf, tk)
    t0 = time.perf_counter()
    reqs = [eng.submit(p, max_new=32) for p in prompts]
    eng.run_until_done()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(ka, kf, tk)

    st, lat = eng.stats(), eng.latency_summary()
    assert all(len(r.out_tokens) == 32 for r in reqs), [len(r.out_tokens) for r in reqs]
    assert all(0 <= t < cfg.vocab_size for r in reqs for t in r.out_tokens)
    assert st["kernel"] == "cuda", st["kernel"]
    assert all(launches[n] > 0 for n in PAGED), launches
    assert all(launches[n] == 0 for n in (*DENSE, "topk_retrieval", "rwkv6_chunked",
                                          "ssm_scan")), launches
    n_mixed = launches["paged_chunk_attention"] // cfg.num_layers
    n_dec = launches["paged_decode_attention"] // cfg.num_layers
    assert n_mixed + n_dec == st["steps"], (launches, st["steps"])
    pool = eng.kv.pool
    assert pool.n_free == pool.n_blocks - 1, (pool.n_free, pool.n_blocks)
    assert st["prefix_hit_tokens"] > 0
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[serve] {len(reqs)} requests (prompts {min(lens)}-{max(lens)} tokens), "
          f"{st['tokens_out']} tokens out in {wall:.3f}s = {st['tokens_out'] / wall:.1f} tok/s "
          f"(prefill tokens {st['prefill_tokens']}); mean TTFT "
          f"{1e3 * lat['ttft_mean']:.1f}ms, p95 TPOT {1e3 * lat.get('tpot_p95', 0):.2f}ms; "
          f"prefix-hit tokens {st['prefix_hit_tokens']}; host gap "
          f"{1e3 * st['host_gap_s']:.1f}ms over {st['dispatches']} dispatches; "
          f"{st['steps']} steps; peak memory {peak:.2f} GiB", flush=True)
    print(f"[serve] launches per step: {cfg.num_layers} (one per layer) of "
          f"paged_chunk_attention on mixed steps, of paged_decode_attention on "
          f"decode-only steps; this run: {launches}", flush=True)

    # where a step's time goes: 8 fresh 300-token requests (~9 mixed steps
    # of prefill), six mixed steps, then six decode-only steps
    rng = np.random.default_rng(1)
    extra = [eng.submit(rng.integers(0, cfg.vocab_size, 300), max_new=40) for _ in range(8)]
    # the paged attention kernels of each step: the chunk kernel's tile plan,
    # tiles and merge on mixed steps, the split decode and its merge on
    # decode-only steps
    attention = ("paged_chunk", "chunk_plan", "paged_decode_split", "split_merge")
    mixed = step_profile(eng, 3, attention)
    while any(r.slot < 0 or r.prefilling for r in extra):
        eng.step()
    decode = step_profile(eng, 3, attention)
    eng.run_until_done()
    for name, (kinds, host_ms, dev_ms, n_launch, attn_ms) in (("mixed", mixed),
                                                               ("decode-only", decode)):
        assert set(kinds) == {"ragged" if name == "mixed" else "decode"}, kinds
        print(f"[serve] {name} step: wall {host_ms:.2f} ms (mean of 3, profiler off); "
              f"device busy {dev_ms:.2f} ms, {n_launch:.0f} kernel launches, of which "
              f"{attn_ms:.3f} ms in the paged attention kernels (torch.profiler, mean of 3)",
              flush=True)

    # the full-width stack gives finite logits of the expected shape
    n = 40
    toks = torch.as_tensor(prompts[0][:n], dtype=torch.int32, device="cuda")
    tables = torch.full((1, eng._view_blocks), -1, dtype=torch.int32, device="cuda")
    tables[0, :3] = torch.tensor([1, 2, 3], dtype=torch.int32)
    ar = torch.arange(n, dtype=torch.int32, device="cuda")
    zeros = torch.zeros(n, dtype=torch.int32, device="cuda")
    with torch.no_grad():
        logits = prefill_packed(cfg, eng.params, eng.kv.k, eng.kv.v, tables, toks,
                                zeros, ar, ar, zeros, zeros, block_size=16,
                                null_block=eng._null_block)
    assert tuple(logits.shape) == (n, cfg.padded_vocab)
    assert bool(torch.isfinite(logits.float()).all())
    return launches, prompts, [r.out_tokens for r in reqs], pool_bytes(eng)


def phase_dense_serve(ka, kf, tk, cfg, params, prompts, paged_tokens):
    """Serve phase 5's prompts on the dense backend of ``cfg`` (qwen2.5-3b
    bf16); returns the five kernels' launches in the run (the paged and
    top-k kernels' are 0: the dense path goes through neither)."""
    from repro_torch.models import prefill
    from repro_torch.serving.engine import GenerationEngine
    from repro_torch.serving.segments import SegmentedPrompt

    torch.cuda.reset_peak_memory_stats()
    eng = GenerationEngine(cfg, params=params, device="cuda", backend="dense",
                           max_batch=8, max_seq=2048)
    reset_launches(ka, kf, tk)
    t0 = time.perf_counter()
    reqs = [eng.submit(p, max_new=32) for p in prompts]
    eng.run_until_done()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(ka, kf, tk)
    st, lat = eng.stats(), eng.latency_summary()
    assert st["backend"] == "dense" and st["kernel"] == "cuda", st
    assert all(len(r.out_tokens) == 32 for r in reqs), [len(r.out_tokens) for r in reqs]
    assert all(0 <= t < cfg.vocab_size for r in reqs for t in r.out_tokens)
    assert launches == {"flash_attention": cfg.num_layers * len(reqs),
                        "decode_attention": cfg.num_layers * st["steps"],
                        "paged_chunk_attention": 0, "paged_decode_attention": 0,
                        "topk_retrieval": 0, "rwkv6_chunked": 0,
                        "ssm_scan": 0}, (launches, st)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[dense serve] {cfg.name} {cfg.dtype}: {len(reqs)} requests, {st['tokens_out']} "
          f"tokens out in {wall:.3f}s = {st['tokens_out'] / wall:.1f} tok/s (prefill tokens "
          f"{st['prefill_tokens']}); mean TTFT {1e3 * lat['ttft_mean']:.1f}ms, p95 TPOT "
          f"{1e3 * lat.get('tpot_p95', 0):.2f}ms; {st['steps']} decode steps; peak memory "
          f"{peak:.2f} GiB; launches {launches} ({cfg.num_layers} x {len(reqs)} prefills, "
          f"{cfg.num_layers} x {st['steps']} decode steps)", flush=True)
    # for information: the bf16 sums of the two backends differ in order
    pairs = [(a, r.out_tokens) for p, a, r in zip(prompts, paged_tokens, reqs)
             if not isinstance(p, SegmentedPrompt)]
    common = [next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), len(a))
              for a, b in pairs]
    print(f"[dense serve] greedy agreement with the paged run on {len(pairs)} unsegmented "
          f"requests: {sum(a == b for a, b in pairs)}/{len(pairs)} rows identical, mean "
          f"common prefix {np.mean(common):.1f} of 32 tokens", flush=True)
    # the full-width dense stack gives finite logits of the expected shape
    toks = torch.as_tensor(np.asarray(prompts[0][:40]), dtype=torch.int32, device="cuda")
    with torch.no_grad():
        last, cache = prefill(cfg, params, {"tokens": toks[None]})
    assert tuple(last.shape) == (1, cfg.padded_vocab)
    assert tuple(cache[0]["k"].shape) == (cfg.num_layers, 1, 40, cfg.num_kv_heads, cfg.head_dim)
    assert bool(torch.isfinite(last.float()).all())
    del eng
    torch.cuda.empty_cache()
    return launches


def step_profile(eng, n, kernels=None):
    """Per engine step, over ``n`` steps each: the mean wall time (profiler
    off, pipelined steps back to back), then the device-busy time and the
    kernel launches (torch.profiler). Returns the plan kinds stepped too
    ("dense" for each step of the dense backend). With ``kernels`` (a
    tuple of name fragments) it also returns the device ms per step of the
    kernels whose names hold one of them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    kind = lambda: eng.runner._last.plan.kind if eng.backend == "paged" else "dense"
    kinds = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        eng.step()
        kinds.append(kind())
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            eng.step()
            kinds.append(kind())
        torch.cuda.synchronize()
    events = prof.key_averages()
    cuda = [e for e in events if e.device_type == DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in cuda)
    launches = sum(e.count for e in events
                   if e.key in ("cudaLaunchKernel", "cuLaunchKernel", "cuLaunchKernelEx"))
    out = (kinds, wall_ms, dev_us / n / 1e3, launches / n)
    if kernels is None:
        return out
    part_us = sum(e.self_device_time_total for e in cuda if any(k in e.key for k in kernels))
    return out + (part_us / n / 1e3,)


PAGED = ("paged_chunk_attention", "paged_decode_attention")
DENSE = ("flash_attention", "decode_attention")


def read_launches(ka, kf, tk):
    """Every ported kernel's launch count since ``reset_launches``."""
    from repro_torch.kernels import rwkv6_scan as kw
    from repro_torch.kernels import ssm_scan as ks

    return {"paged_chunk_attention": ka.paged_chunk_attention.launches,
            "paged_decode_attention": ka.paged_decode_attention.launches,
            "topk_retrieval": tk.topk_retrieval.launches,
            "flash_attention": kf.flash_attention.launches,
            "decode_attention": ka.decode_attention.launches,
            "rwkv6_chunked": kw.rwkv6_chunked.launches,
            "ssm_scan": ks.ssm_scan.launches}


def reset_launches(ka, kf, tk):
    from repro_torch.kernels import rwkv6_scan as kw
    from repro_torch.kernels import ssm_scan as ks

    ka.reset_launch_counts()
    kf.reset_launch_counts()
    tk.reset_launch_counts()
    kw.reset_launch_counts()
    ks.reset_launch_counts()


def pool_is_clean(eng):
    pool = eng.kv.pool
    return pool.n_free == pool.n_blocks - 1


def pool_bytes(eng):
    """Device bytes of the engine's K/V pools (and an int8 pool's scales)."""
    kv = eng.kv
    return sum(t.numel() * t.element_size()
               for t in (kv.k, kv.v, kv.k_scale, kv.v_scale) if t is not None)


# ---------------------------------------------------------------------------
# phase 5c: serve qwen2.5-3b on int8 pools
# ---------------------------------------------------------------------------


def agreement(tokens_a, tokens_b):
    """Share of positions where two runs' greedy tokens agree."""
    pairs = [(x, y) for a, b in zip(tokens_a, tokens_b) for x, y in zip(a, b)]
    return sum(x == y for x, y in pairs) / max(len(pairs), 1)


def phase_int8_serve(ka, kf, tk, cfg, params, prompts, bf16_tokens, bf16_pool_bytes):
    """Phase 5's ten prompts and engine settings on int8 pools
    (``kv_dtype="int8"``): the two paged kernels take their int8 route from
    the engine's running-max scales. Returns the launches, the step
    profiles and the figures."""
    from repro_torch.models import prefill_packed
    from repro_torch.serving.engine import GenerationEngine

    torch.cuda.reset_peak_memory_stats()
    eng = GenerationEngine(cfg, params=params, device="cuda", max_batch=8, max_seq=2048,
                           block_size=16, prefill_chunk_size=256, kv_dtype="int8")
    eng.warmup_step_variants()
    assert eng.kv.k.dtype == torch.int8 and eng.stats()["kv_dtype"] == "int8"
    reset_launches(ka, kf, tk)
    t0 = time.perf_counter()
    reqs = [eng.submit(p, max_new=32) for p in prompts]
    eng.run_until_done()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(ka, kf, tk)
    st, lat = eng.stats(), eng.latency_summary()
    assert st["kernel"] == "cuda", st["kernel"]
    assert all(len(r.out_tokens) == 32 for r in reqs), [len(r.out_tokens) for r in reqs]
    assert all(0 <= t < cfg.vocab_size for r in reqs for t in r.out_tokens)
    assert all(launches[n] > 0 and launches[n] % cfg.num_layers == 0 for n in PAGED), launches
    assert all(launches[n] == 0 for n in (*DENSE, "topk_retrieval", "rwkv6_chunked",
                                          "ssm_scan")), launches
    n_mixed = launches["paged_chunk_attention"] // cfg.num_layers
    n_dec = launches["paged_decode_attention"] // cfg.num_layers
    assert n_mixed + n_dec == st["steps"], (launches, st["steps"])
    assert pool_is_clean(eng) and st["prefix_hit_tokens"] > 0, st
    peak = torch.cuda.max_memory_allocated() / 2**30
    nbytes = pool_bytes(eng)
    agree = agreement(bf16_tokens, [r.out_tokens for r in reqs])
    print(f"[int8 serve] {cfg.name} {cfg.dtype} weights, int8 pools: {len(reqs)} requests, "
          f"{st['tokens_out']} tokens out in {wall:.3f}s = {st['tokens_out'] / wall:.1f} tok/s "
          f"(prefill tokens {st['prefill_tokens']}); mean TTFT {1e3 * lat['ttft_mean']:.1f}ms, "
          f"p95 TPOT {1e3 * lat.get('tpot_p95', 0):.2f}ms; {st['steps']} steps ({n_mixed} mixed, "
          f"{n_dec} decode-only); peak memory {peak:.2f} GiB; pool {nbytes / 2**20:.1f} MiB "
          f"against phase 5's bf16 pool {bf16_pool_bytes / 2**20:.1f} MiB "
          f"({nbytes / bf16_pool_bytes:.4f}x); launches {launches}", flush=True)
    print(f"[int8 serve] greedy agreement with phase 5's bf16 pools: {agree:.4f} of "
          f"{sum(map(len, bf16_tokens))} tokens (random full-width weights: reported, not "
          f"held to the smoke-width floor of 0.75)", flush=True)

    rng = np.random.default_rng(1)
    extra = [eng.submit(rng.integers(0, cfg.vocab_size, 300), max_new=40) for _ in range(8)]
    attention = ("paged_chunk", "chunk_plan", "paged_decode_split", "split_merge")
    mixed = step_profile(eng, 3, attention)
    while any(r.slot < 0 or r.prefilling for r in extra):
        eng.step()
    decode = step_profile(eng, 3, attention)
    eng.run_until_done()
    profiles = {}
    for name, (kinds, host_ms, dev_ms, n_launch, attn_ms) in (("mixed", mixed),
                                                               ("decode-only", decode)):
        assert set(kinds) == {"ragged" if name == "mixed" else "decode"}, kinds
        profiles[name] = {"wall_ms": host_ms, "device_busy_ms": dev_ms,
                          "launches": n_launch, "paged_attention_ms": attn_ms}
        print(f"[int8 serve] {name} step: wall {host_ms:.2f} ms (mean of 3, profiler off); "
              f"device busy {dev_ms:.2f} ms, {n_launch:.0f} kernel launches, of which "
              f"{attn_ms:.3f} ms in the paged attention kernels (torch.profiler, mean of 3)",
              flush=True)

    # the full-width int8 stack gives finite logits of the expected shape
    n = 40
    toks = torch.as_tensor(prompts[0][:n], dtype=torch.int32, device="cuda")
    tables = torch.full((1, eng._view_blocks), -1, dtype=torch.int32, device="cuda")
    tables[0, :3] = torch.tensor([1, 2, 3], dtype=torch.int32)
    eng.kv.reset_block_scales([1, 2, 3])
    ar = torch.arange(n, dtype=torch.int32, device="cuda")
    zeros = torch.zeros(n, dtype=torch.int32, device="cuda")
    with torch.no_grad():
        logits = prefill_packed(cfg, eng.params, eng.kv.k, eng.kv.v, tables, toks,
                                zeros, ar, ar, zeros, zeros, block_size=16,
                                null_block=eng._null_block, k_scales=eng.kv.k_scale,
                                v_scales=eng.kv.v_scale)
    assert tuple(logits.shape) == (n, cfg.padded_vocab)
    assert bool(torch.isfinite(logits.float()).all())
    figures = {"tok_s": st["tokens_out"] / wall, "ttft_mean_ms": 1e3 * lat["ttft_mean"],
               "tpot_p95_ms": 1e3 * lat.get("tpot_p95", 0), "steps": st["steps"],
               "peak_gib": peak, "pool_bytes": nbytes, "bf16_pool_bytes": bf16_pool_bytes,
               "greedy_agreement": agree, "step_profile": profiles}
    del eng
    torch.cuda.empty_cache()
    return launches, figures


# ---------------------------------------------------------------------------
# phase 5d: the host tier and swap preemption at full width
# ---------------------------------------------------------------------------

# 192 blocks of 16 tokens (3072 token slots, against phase 5's 1033 blocks):
# the ten prompts (301-1519 tokens, 5946 in all) outgrow it, so admission
# evicts the first wave's finished documents from the warm LRU (demotion to
# the host tier) before the second wave asks for them again (promotion),
# and twice the running decodes run the pool dry (preemption). The plan
# sequence depends on token counts only (no eos), so a CPU run of the same
# prompts at smoke width shows the same schedule: at 256 blocks and 32 new
# tokens no decode ran the pool dry
TIGHT_POOL = 192
HOST_BLOCKS = 1024


def host_copy_rates(eng, n_blocks, reps=5):
    """Device->host and host->device rates (GB/s) of the engine's own copy
    path for an ``n_blocks`` chain: the gather plus the non-blocking copy
    into pinned memory, and the pinned staging plus the copy and scatter
    back, each between CUDA events (median of ``reps``)."""
    from repro_torch.serving.paged_cache import device_to_host

    ids = list(range(1, n_blocks + 1))
    nbytes = n_blocks * eng.host_store.block_bytes
    d2h, h2d = [], []
    for _ in range(reps):
        start, mid, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        start.record()
        host, wait = device_to_host(*eng.kv.gather_blocks(ids))
        mid.record()
        wait()
        eng.kv.write_blocks(ids, *(t for t in host if t is not None))
        end.record()
        end.synchronize()
        d2h.append(start.elapsed_time(mid))
        h2d.append(mid.elapsed_time(end))
    return (nbytes / (np.median(d2h) * 1e-3) / 1e9, nbytes / (np.median(h2d) * 1e-3) / 1e9,
            nbytes)


def phase_host_tier(ka, kf, tk, cfg, params, prompts):
    """Phase 5's prompts in two waves (every prompt's documents asked for
    again in the second) on a tight pool with a host tier, under each
    preemption strategy and once on int8 pools with swap. Returns the
    launches of the swap run and the per-strategy figures."""
    from repro_torch.serving.engine import GenerationEngine

    figures, launches = {}, None
    for name, kw in (("recompute", dict(preempt="recompute")),
                     ("swap", dict(preempt="swap")),
                     ("cost", dict(preempt="cost")),
                     ("swap int8", dict(preempt="swap", kv_dtype="int8"))):
        eng = GenerationEngine(cfg, params=params, device="cuda", max_batch=8, max_seq=2048,
                               block_size=16, prefill_chunk_size=256, n_blocks=TIGHT_POOL,
                               host_blocks=HOST_BLOCKS, **kw)
        eng.warmup_step_variants()
        reset_launches(ka, kf, tk)
        t0 = time.perf_counter()
        reqs = []
        for _wave in range(2):
            reqs += [eng.submit(p, max_new=32) for p in prompts]
            eng.run_until_done()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        run_launches = read_launches(ka, kf, tk)
        st = eng.stats()
        hs = st["host_store"]
        assert st["kernel"] == "cuda" and all(len(r.out_tokens) == 32 for r in reqs), st
        assert all(run_launches[n] == 0 for n in (*DENSE, "topk_retrieval", "rwkv6_chunked",
                                                  "ssm_scan")), run_launches
        assert pool_is_clean(eng), (name, eng.kv.pool.n_free)
        assert hs["n_swapped"] == 0 and st["swap_ins"] == st["swap_outs"], (name, st)
        assert hs["puts"] > 0 and hs["hits"] > 0, (name, hs)       # demoted, promoted
        if name.startswith("swap"):
            assert st["swap_outs"] > 0, (name, st)
        if name == "swap":
            launches = run_launches
        figures[name] = {k: st[k] for k in (
            "steps", "tokens_out", "prefill_tokens", "preemptions", "swap_outs", "swap_ins",
            "swap_out_bytes", "swap_in_bytes", "swap_reshared_blocks", "cost_swap_choices",
            "cost_recompute_choices", "prefix_hit_tokens", "host_hit_tokens")}
        figures[name].update(tok_s=st["tokens_out"] / wall, wall_s=wall, host_store=hs)
        if name == "swap int8" or name == "swap":
            n = max(1, st["swap_out_bytes"] // max(st["swap_outs"], 1)
                    // eng.host_store.block_bytes)
            d2h, h2d, nbytes = host_copy_rates(eng, n)
            figures[name].update(d2h_gb_s=d2h, h2d_gb_s=h2d, copy_chain_blocks=n,
                                 copy_chain_bytes=nbytes)
        print(f"[host tier] {cfg.name} {cfg.dtype}, pool {TIGHT_POOL} blocks, host tier "
              f"{HOST_BLOCKS} blocks, preempt={name}: 2 waves of {len(prompts)} requests, "
              f"{st['tokens_out']} tokens out in {wall:.3f}s = {st['tokens_out'] / wall:.1f} "
              f"tok/s; {st['steps']} steps; prefill tokens {st['prefill_tokens']}; "
              f"preemptions {st['preemptions']}, swap outs/ins {st['swap_outs']}/"
              f"{st['swap_ins']} ({st['swap_out_bytes'] / 2**20:.1f} MiB out, "
              f"{st['swap_in_bytes'] / 2**20:.1f} MiB in, {st['swap_reshared_blocks']} blocks "
              f"re-shared); cost choices swap/recompute {st['cost_swap_choices']}/"
              f"{st['cost_recompute_choices']}; prefix-hit tokens {st['prefix_hit_tokens']}, "
              f"host-hit tokens {st['host_hit_tokens']}; host store {hs}", flush=True)
        if "d2h_gb_s" in figures[name]:
            f = figures[name]
            print(f"[host tier] {name}: a {f['copy_chain_blocks']}-block chain "
                  f"({f['copy_chain_bytes'] / 2**20:.2f} MiB) device->host {f['d2h_gb_s']:.2f} "
                  f"GB/s (gather + pinned copy), host->device {f['h2d_gb_s']:.2f} GB/s (pinned "
                  f"staging + copy + scatter), CUDA events, median of 5", flush=True)
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    # swap repays no prefill: fewer prefill tokens than recompute on the same pool
    assert figures["swap"]["prefill_tokens"] < figures["recompute"]["prefill_tokens"], figures
    return launches, figures


# ---------------------------------------------------------------------------
# phase 5e: the oracle paths and the KV sanitizer at full width
# ---------------------------------------------------------------------------

ORACLE_MAX_NEW = 8


def logit_bound(num_layers):
    """Bound on max |d| / max |logit| between the packed kernel path's and
    the padded oracle's first-token logits. Phase 2 lets a bf16 attention
    kernel differ from its plain version by TOL["bfloat16"]["plain"] (2e-2
    relative: the plain version's bf16 probabilities) in one call. The two
    paths differ that way in each layer's attention, and independent
    per-layer differences add in quadrature through the residual stream:
    2e-2 * sqrt(num_layers), 0.12 for qwen2.5-3b's 36 layers."""
    return TOL["bfloat16"]["plain"][1] * float(np.sqrt(num_layers))


def keep_first_logits(eng):
    """Each request's first-token logits (float32, on the card), taken from
    the mixed step that samples the token (a prefill's last chunk)."""
    first, last = {}, {}
    for name in ("_ragged_step", "_fused_step"):
        def keep(*args, step=getattr(eng, name)):
            last["logits"] = out = step(*args)
            return out

        setattr(eng, name, keep)
    dispatch = eng.runner.dispatch

    def dispatch_and_keep(plan):
        ex = dispatch(plan)
        if plan.kind != "decode":
            for req, row, _ in plan.emit_rows:
                first.setdefault(req.req_id, last["logits"][row].float())
        return ex

    eng.runner.dispatch = dispatch_and_keep
    return first


ORACLE_FAULTS = ("segment spans dropped", "one layer's attention zeroed")


@contextlib.contextmanager
def oracle_fault(name, num_layers):
    """A deliberate fault in the padded oracle's prefill, for the controls
    that show the logit bound can see one: the segment spans dropped from
    the chunk mask (plain causal: the segmented request's documents attend
    each other), or the attention output of one layer (the middle one)
    zeroed in every fused step."""
    from repro_torch.models import attention, transformer

    if name == "segment spans dropped":
        module, attr = transformer, "_prefix_mask"
        mask = transformer._prefix_mask
        faulty = lambda Sc, slots, seg_prefix_end=None, seg_start=None: mask(Sc, slots)
    else:
        module, attr = attention, "chunk_decode_attention"
        chunk_attention, calls = attention.chunk_decode_attention, [0]

        def faulty(*args):
            layer = calls[0] % num_layers
            calls[0] += 1
            out = chunk_attention(*args)
            return torch.zeros_like(out) if layer == num_layers // 2 else out
    orig = getattr(module, attr)
    setattr(module, attr, faulty)
    try:
        yield
    finally:
        setattr(module, attr, orig)


def phase_oracles(ka, kf, tk, cfg, params, prompts, host_figures):
    """Phase 5's prompts and settings with ``max_new=8`` through the packed
    kernel path, the padded oracle (``ragged=False, kernel="reference"``)
    and the sequential path (``interleave=False``); then phase 5d's swap
    schedule with the KV sanitizer on, bf16 and int8 pools. Returns the
    launches of the whole phase and its figures."""
    from repro_torch.serving.control_plane import padded_plan_difference
    from repro_torch.serving.engine import GenerationEngine

    L = cfg.num_layers
    common = dict(params=params, device="cuda", max_batch=8, max_seq=2048, block_size=16,
                  prefill_chunk_size=256)
    total = {}
    runs = {}
    for name, kw in (("kernel", {}), ("padded oracle", dict(ragged=False, kernel="reference")),
                     ("sequential", dict(interleave=False))):
        eng = GenerationEngine(cfg, **common, **kw)
        eng.warmup_step_variants()
        plans = []
        if eng.interleave:
            eng.control.recorded = plans
        first = keep_first_logits(eng) if eng.interleave else {}
        reset_launches(ka, kf, tk)
        t0 = time.perf_counter()
        reqs = [eng.submit(p, max_new=ORACLE_MAX_NEW) for p in prompts]
        eng.run_until_done()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = read_launches(ka, kf, tk)
        for k, v in n.items():
            total[k] = total.get(k, 0) + v
        st = eng.stats()
        assert all(len(r.out_tokens) == ORACLE_MAX_NEW for r in reqs), name
        assert all(0 <= t < cfg.vocab_size for r in reqs for t in r.out_tokens), name
        assert pool_is_clean(eng) and eng.kv.pool.tables == {-1: [eng._null_block]}, name
        assert n["flash_attention"] == n["topk_retrieval"] == 0, (name, n)
        assert n["rwkv6_chunked"] == n["ssm_scan"] == 0, (name, n)
        n_decode = sum(p.kind == "decode" for p in plans)
        runs[name] = {"tokens": [r.out_tokens for r in reqs], "plans": plans, "first": first,
                      "launches": n, "steps": st["steps"], "wall_s": wall,
                      "decode_plans": n_decode, "mixed_plans": len(plans) - n_decode,
                      "prefill_tokens": st["prefill_tokens"], "kernel_impl": st["kernel_impl"]}
        print(f"[oracles] {name} (interleave={st['interleave']}, ragged={st['ragged']}, "
              f"kernel_impl={st['kernel_impl']}): {len(reqs)} requests x {ORACLE_MAX_NEW} "
              f"tokens in {wall:.3f}s, {st['steps']} steps ({len(plans) - n_decode} mixed, "
              f"{n_decode} decode-only plans), prefill tokens {st['prefill_tokens']}, "
              f"padded slot fraction {st['padded_token_fraction']:.3f}; launches {n}",
              flush=True)
        del eng
        gc.collect()
        torch.cuda.empty_cache()

    kern, pad, seq = runs["kernel"], runs["padded oracle"], runs["sequential"]
    # (a) the packed kernel path on the main path's kernels; the padded oracle
    # on the gather oracles: no paged kernel, one dense decode a layer and
    # decode plan
    assert kern["launches"]["paged_chunk_attention"] == L * kern["mixed_plans"] > 0, kern
    assert kern["launches"]["paged_decode_attention"] == L * kern["decode_plans"] > 0, kern
    assert kern["launches"]["decode_attention"] == 0, kern["launches"]
    assert pad["launches"]["paged_chunk_attention"] == 0, pad["launches"]
    assert pad["launches"]["paged_decode_attention"] == 0, pad["launches"]
    assert pad["launches"]["decode_attention"] == L * pad["decode_plans"] > 0, pad
    assert len(kern["plans"]) == len(pad["plans"]) == pad["steps"], (kern["steps"], pad["steps"])
    for rp, fp in zip(kern["plans"], pad["plans"]):
        diff = padded_plan_difference(rp, fp)
        assert diff is None, diff
    bound = logit_bound(L)
    assert set(kern["first"]) == set(pad["first"]) == set(range(len(prompts)))
    rel = {}
    for rid, k_logits in sorted(kern["first"].items()):
        p_logits = pad["first"][rid]
        assert bool(torch.isfinite(k_logits).all() and torch.isfinite(p_logits).all()), rid
        rel[rid] = float((k_logits - p_logits).abs().max() / k_logits.abs().max())
    worst = max(rel.values())
    print(f"[oracles] plans: {len(kern['plans'])} packed plans unpack to the padded plans' "
          f"rows, starts and n_valid, step for step; first-token logits max |d| / max "
          f"|logit| per request {[round(x, 5) for x in rel.values()]}, worst {worst:.5f} "
          f"(bound {bound:.3f} = bf16 plain tolerance x sqrt({L}))", flush=True)
    assert worst <= bound, (rel, bound)
    # controls: the padded oracle with a deliberate fault in its prefill must
    # read above the bound, or the bound could not see such a fault
    controls = {}
    for fault in ORACLE_FAULTS:
        eng = GenerationEngine(cfg, **common, ragged=False, kernel="reference")
        first = keep_first_logits(eng)
        reset_launches(ka, kf, tk)
        t0 = time.perf_counter()
        with oracle_fault(fault, L):
            for p in prompts:
                eng.submit(p, max_new=1)
            eng.run_until_done()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = read_launches(ka, kf, tk)
        assert sum(n.values()) == 0, (fault, n)
        assert set(first) == set(kern["first"]), (fault, sorted(first))
        controls[fault] = {
            rid: float((kern["first"][rid] - lg).abs().max() / kern["first"][rid].abs().max())
            for rid, lg in sorted(first.items())}
        c_worst = max(controls[fault].values())
        print(f"[oracles] control, padded oracle with {fault}: first-token logits max |d| / "
              f"max |logit| per request {[round(x, 5) for x in controls[fault].values()]}, "
              f"worst {c_worst:.5f} against the bound {bound:.3f} ({wall:.3f}s)", flush=True)
        assert c_worst > bound, (fault, controls[fault], bound)
        del eng, first
        gc.collect()
        torch.cuda.empty_cache()
    agree_pad = agreement(kern["tokens"], pad["tokens"])
    # (b) the sequential path: the paged decode kernel each step, no chunk kernel
    assert seq["launches"]["paged_decode_attention"] == L * seq["steps"] > 0, seq
    assert seq["launches"]["paged_chunk_attention"] == 0, seq["launches"]
    assert seq["launches"]["decode_attention"] == 0, seq["launches"]
    agree_seq = agreement(kern["tokens"], seq["tokens"])
    print(f"[oracles] greedy agreement with the packed kernel path (reported, not "
          f"required: bf16 near-ties): padded oracle {agree_pad:.4f}, sequential "
          f"{agree_seq:.4f}; rows identical {sum(a == b for a, b in zip(kern['tokens'], pad['tokens']))}"
          f"/{len(prompts)} and {sum(a == b for a, b in zip(kern['tokens'], seq['tokens']))}"
          f"/{len(prompts)}", flush=True)

    # (c) phase 5d's swap schedule under the sanitizer, bf16 then int8 pools
    kvsan = {}
    for name, kw in (("swap", dict(preempt="swap")),
                     ("swap int8", dict(preempt="swap", kv_dtype="int8"))):
        eng = GenerationEngine(cfg, **common, n_blocks=TIGHT_POOL, host_blocks=HOST_BLOCKS,
                               sanitize=True, **kw)
        eng.warmup_step_variants()
        reset_launches(ka, kf, tk)
        t0 = time.perf_counter()
        reqs = []
        for _wave in range(2):
            reqs += [eng.submit(p, max_new=32) for p in prompts]
            eng.run_until_done()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = read_launches(ka, kf, tk)
        for k, v in n.items():
            total[k] = total.get(k, 0) + v
        st, san = eng.stats(), eng.sanitizer
        shadow = san.stats()
        assert all(len(r.out_tokens) == 32 for r in reqs), name
        assert san.violations == 0, shadow
        for hook in ("device_alloc", "host_reserve", "host_restore", "copy_submit"):
            assert san.op_counts.get(hook, 0) >= 1, (name, hook, san.op_counts)
        assert shadow["device_allocated"] == 1, shadow
        assert shadow["device_warm"] == len(eng.kv.pool.cached), (shadow, len(eng.kv.pool.cached))
        assert shadow["copy_pending"] == 0, shadow
        san.audit_host(eng.host_store)
        assert pool_is_clean(eng) and st["host_store"]["n_swapped"] == 0, name
        # the shadow changes nothing: phase 5d's schedule, step for step
        plain = host_figures[name]
        for key in ("steps", "preemptions", "swap_outs", "swap_ins", "prefill_tokens"):
            assert st[key] == plain[key], (name, key, st[key], plain[key])
        step_ms, plain_ms = 1e3 * wall / st["steps"], 1e3 * plain["wall_s"] / plain["steps"]
        kvsan[name] = {"op_counts": dict(sorted(san.op_counts.items())), "shadow": shadow,
                       "wall_s": wall, "steps": st["steps"], "step_ms": step_ms,
                       "step_ms_without": plain_ms, "swap_outs": st["swap_outs"]}
        print(f"[oracles] kvsan on phase 5d's {name} schedule: {san.ops} ops checked, 0 "
              f"violations; ops by hook {kvsan[name]['op_counts']}; shadow at the drain "
              f"{shadow}; {st['steps']} steps in {wall:.3f}s = {step_ms:.2f} ms a step with "
              f"the sanitizer, {plain_ms:.2f} ms without (phase 5d's run), "
              f"{san.ops / st['steps']:.1f} checked ops a step", flush=True)
        del eng
        gc.collect()
        torch.cuda.empty_cache()

    figures = {"logit_bound": bound, "logit_rel_err": rel, "logit_controls": controls,
               "greedy_agreement":
               {"padded oracle": agree_pad, "sequential": agree_seq}, "kvsan": kvsan,
               "runs": {name: {k: r[k] for k in ("steps", "wall_s", "decode_plans",
                                                   "mixed_plans", "prefill_tokens", "launches",
                                                   "kernel_impl")}
                        for name, r in runs.items()}}
    return total, figures


# ---------------------------------------------------------------------------
# phase 6: RAG requests at full width
# ---------------------------------------------------------------------------


def phase_rag(ka, kf, tk, cfg, params, corpus, queries):
    """Index the (N_DOCS, DIM) ``corpus`` (numpy) on the card, read recall@10
    at three probe counts, and serve 8 retrieval-augmented requests on
    ``cfg`` (qwen2.5-3b bf16). Returns the five kernels' launches."""
    from repro_torch.core.components import Augmenter, Reranker, Retriever
    from repro_torch.serving.engine import GenerationEngine
    from repro_torch.serving.retrieval import DocTokenStore, VectorIndex, recall_at_k

    reset_launches(ka, kf, tk)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index = VectorIndex.build(corpus, n_clusters=N_CLUSTERS, seed=0, device="cuda")
    torch.cuda.synchronize()
    sizes = torch.bincount(index.cluster_of, minlength=N_CLUSTERS)
    print(f"[rag] VectorIndex.build of {index.size} x {index.embeddings.shape[1]} "
          f"float32 passages, {N_CLUSTERS} clusters (k-means, 8 Lloyd iterations) in "
          f"{time.perf_counter() - t0:.2f}s; index {index.nbytes() / 2**30:.2f} GiB on "
          f"the card; cluster sizes {int(sizes.min())}-{int(sizes.max())}", flush=True)
    recalls = {}
    for n_probe in (1, 8, 32):
        t0 = time.perf_counter()
        recalls[n_probe] = recall_at_k(index, queries, 10, n_probe)
        torch.cuda.synchronize()
        assert 0.0 <= recalls[n_probe] <= 1.0
        print(f"[rag] recall@10 over {len(queries)} queries at n_probe={n_probe}: "
              f"{recalls[n_probe]:.4f} (IVF + exact search in "
              f"{1e3 * (time.perf_counter() - t0):.1f} ms)", flush=True)
    assert recalls[32] >= recalls[1], recalls

    eng = GenerationEngine(cfg, params=params, device="cuda", max_batch=8,
                           max_seq=2048, block_size=16, prefill_chunk_size=256)
    store = DocTokenStore(vocab=cfg.vocab_size, doc_len=256)
    retriever, reranker, augmenter = Retriever(index, n_probe=8), Reranker(), Augmenter()
    rng = np.random.default_rng(3)
    system = rng.integers(0, cfg.vocab_size, 32)
    texts = [f"rag query {i}" for i in range(4)]
    text_tokens = {t: rng.integers(0, cfg.vocab_size, 24) for t in texts}
    reqs, retrieve_ms = [], []
    t_all = time.perf_counter()
    # two waves: four fresh queries, then the same four texts with other
    # user tails, whose documents' KV blocks are then in the pool
    for wave in range(2):
        for text in texts:
            t0 = time.perf_counter()
            docs = retriever.retrieve(text, k=100)
            retrieve_ms.append(1e3 * (time.perf_counter() - t0))
            assert len(docs) == 100 and len(set(docs)) == 100 and min(docs) >= 0
            top = reranker.rerank(text, docs, top_n=4)
            tail = rng.integers(0, cfg.vocab_size, int(rng.integers(4, 17)))
            prompt = augmenter.build_prompt(np.concatenate([text_tokens[text], tail]),
                                            top, store, system)
            reqs.append(eng.submit(prompt, max_new=32))
        eng.run_until_done()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_all
    launches = read_launches(ka, kf, tk)
    st = eng.stats()
    assert all(len(r.out_tokens) == 32 for r in reqs), [len(r.out_tokens) for r in reqs]
    assert all(0 <= t < cfg.vocab_size for r in reqs for t in r.out_tokens)
    assert st["prefix_hit_tokens"] > 0 and pool_is_clean(eng), st
    assert all(launches[n] > 0 for n in (*PAGED, "topk_retrieval")), launches
    assert all(launches[n] == 0 for n in (*DENSE, "rwkv6_chunked", "ssm_scan")), launches
    print(f"[rag] 8 requests (prompts {min(len(r.prompt) for r in reqs)}-"
          f"{max(len(r.prompt) for r in reqs)} tokens: system + 4 reranked docs of 256 + "
          f"query) through Retriever(n_probe=8, k=100) -> Reranker(top 4) -> Augmenter -> "
          f"{cfg.name} {cfg.dtype}: {st['tokens_out']} tokens out in {wall:.3f}s wall; "
          f"retrieve {np.mean(retrieve_ms):.1f} ms mean per query; prefix-hit tokens "
          f"{st['prefix_hit_tokens']}; {st['steps']} steps; launches {launches}", flush=True)
    del eng, index
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 7: the open-loop pipelines at full width
# ---------------------------------------------------------------------------

APP_MIX = ("vrag", "crag", "srag", "planrag")   # benchmarks/slo_violations.py


def phase_pipelines(ka, kf, tk, cfg, params):
    from repro_torch.launch.serve import serve_pipelines

    torch.cuda.reset_peak_memory_stats()
    reset_launches(ka, kf, tk)
    t0 = time.perf_counter()
    drv = serve_pipelines(cfg.name, 4.0, 5.0, arrival="poisson", session_fraction=0.3,
                          device="cuda", params=params, dtype=cfg.dtype, apps=APP_MIX,
                          max_batch=8, max_seq=2048, prefill_chunk_size=256,
                          token_budget=None, doc_len=256, seed=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(ka, kf, tk)
    eng = drv.engine
    st = eng.stats()
    summary = drv.violation_summary()
    assert len(drv.records) == len(drv.events) > 0, (len(drv.records), len(drv.events))
    assert set(summary) == set(APP_MIX), summary
    assert all(np.isfinite(c["violation_rate"]) and 0 <= c["violation_rate"] <= 1
               for c in summary.values()), summary
    assert st["session_shared_tokens"] > 0 and pool_is_clean(eng), st
    assert st["kernel"] == "cuda" and launches["paged_chunk_attention"] > 0, launches
    assert all(launches[n] == 0 for n in (*DENSE, "rwkv6_chunked", "ssm_scan")), launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[pipelines] {cfg.name} {cfg.dtype}: {len(drv.events)} events "
          f"({sum(e.session_id >= 0 for e in drv.events)} session turns) all completed; "
          f"{len(eng.finished)} engine requests, {st['tokens_out']} tokens out; "
          f"violation_summary {json.dumps(summary)}; session-shared tokens "
          f"{st['session_shared_tokens']}; prefix-hit tokens {st['prefix_hit_tokens']}; "
          f"{st['steps']} steps; {wall:.2f}s wall; peak memory {peak:.2f} GiB; "
          f"launches {launches}", flush=True)
    print(f"[pipelines] host tier ({eng.host_store.n_blocks} blocks, the reference "
          f"launcher's): host-hit tokens {st['host_hit_tokens']}, session host-hit tokens "
          f"{st['session_hit_tokens']}; host_store {json.dumps(st['host_store'])}", flush=True)
    assert eng.host_store.n_blocks == 128 and st["host_store"]["n_swapped"] == 0, st
    del drv, eng
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 7b: the control plane, calibrated against the paged engine
# ---------------------------------------------------------------------------

CONTROL_APPS = ("vrag", "crag", "srag", "arag")   # benchmarks/common.py APP_NAMES
CONTROL_BUDGETS = {"GPU": 32, "CPU": 256, "RAM": 1024}
DRAIN_S = 3600.0
COEFFS = ("prefill_per_token_s", "ttft_per_prefill_token_s", "decode_per_token_s",
          "decode_cache_per_ctx_token_s", "prefix_hit_rate")


def calibrated_app(name, coeffs):
    """``make_app(name)`` with every Generator-class component (Grader,
    Rewriter and Critic too) calibrated with ``coeffs`` (None: defaults)."""
    from repro_torch.apps import make_app
    from repro_torch.core.components import Generator

    app = make_app(name)
    for comp in app.components.values():
        if coeffs is not None and isinstance(comp, Generator):
            comp.calibrate(coeffs)
    return app


def runtime(name, coeffs, engine, slo_s=None):
    """``PatchworkRuntime`` of ``calibrated_app(name, coeffs)`` on the
    simulated cluster, seed 0. Python's ``random``, which WebSearch's jitter
    draws from (in profiling and in service times), is reseeded to 0 so the
    run repeats."""
    import random

    from repro_torch.core.controller import PatchworkRuntime

    random.seed(0)
    return PatchworkRuntime(calibrated_app(name, coeffs), CONTROL_BUDGETS, engine=engine,
                            slo_s=slo_s, seed=0)


def plan_and_serve(card):
    """For each of the paper's four apps: the LP plan under the default and
    the ``card`` coefficients, the SLO (``slo_multiplier`` x the mean
    latency of a Patchwork run at 0.1x the card plan's throughput for 15
    trace-seconds, as benchmarks/common.py sets it), and Patchwork,
    monolithic and Ray-like runs at 0.8x that throughput for 30
    trace-seconds (three re-plans at the 10 s period in the window), each
    run until all it was offered has completed. Host work only: no device.
    Returns the figures."""
    from repro_torch.core.controller import MONOLITHIC, PATCHWORK, RAY_LIKE
    from repro_torch.data.workload import make_workload

    out = {}
    for name in CONTROL_APPS:
        t0 = time.perf_counter()
        plans = {}
        for which, co in (("default", None), ("card", card)):
            p = runtime(name, co, PATCHWORK).plan
            assert p.status == "optimal", (name, which, p.status)
            plans[which] = {"instances": p.instances, "throughput": p.throughput,
                            "solve_time_s": p.solve_time_s}
            print(f"[controller] {name} plan ({which} coefficients): instances "
                  f"{p.instances}, throughput {p.throughput:.4f} req/s, solve "
                  f"{1e3 * p.solve_time_s:.2f} ms", flush=True)
        thr = plans["card"]["throughput"]
        low = runtime(name, card, PATCHWORK).run(make_workload(0.1 * thr, 15.0, seed=0))
        slo = PATCHWORK.slo_multiplier * (float(np.mean(low.latencies)) if low.latencies
                                          else 0.5)
        runs = {}
        for engine in (PATCHWORK, MONOLITHIC, RAY_LIKE):
            # the horizon runs DRAIN_S past the window (the runtime's default:
            # 120 s) so the slower engines finish what they were offered
            m = runtime(name, card, engine, slo).run(make_workload(0.8 * thr, 30.0, seed=0),
                                                     duration_s=30.0 + DRAIN_S)
            assert m.completed == m.offered > 0, (name, engine.name, m.completed, m.offered)
            r = runs[engine.name] = {
                "completed": m.completed, "offered": m.offered, "throughput": m.throughput,
                "goodput": m.goodput, "p50_s": m.latency_pct(50), "p99_s": m.latency_pct(99),
                "slo_violation_rate": m.slo_violation_rate,
                "realloc_events": m.realloc_events, "instance_counts": m.instance_counts,
                "decision_ms": 1e3 * float(np.mean(m.controller_overhead_s))}
            print(f"[controller] {name} {engine.name} at {0.8 * thr:.4f} req/s for 30 "
                  f"trace-s (SLO {slo:.3f}s): {m.completed}/{m.offered} completed, "
                  f"throughput {m.throughput:.4f}/s, goodput {m.goodput:.4f}/s, p50 "
                  f"{r['p50_s']:.3f}s, p99 {r['p99_s']:.3f}s, SLO violations "
                  f"{100 * m.slo_violation_rate:.1f}%, plan changes applied {m.realloc_events}, "
                  f"instances {m.instance_counts}, decision {r['decision_ms']:.4f} ms",
                  flush=True)
        out[name] = {"plans": plans, "slo_s": slo, "runs": runs,
                     "wall_s": time.perf_counter() - t0}
    return out


def phase_controller(ka, kf, tk, cfg, params):
    """Calibrate the Generator cost model against the paged engine on the
    card (bf16 and int8 pools), profile the vrag generator by real
    execution, then plan and serve the paper's four apps on the simulated
    cluster under the default and the card's coefficients. Returns the
    launches and the figures."""
    import scipy

    from repro_torch.apps import make_app
    from repro_torch.core.components import Generator
    from repro_torch.core.profiling import calibrate_generator_from_engine, profile_components
    from repro_torch.data.workload import sample_request_features
    from repro_torch.serving.engine import GenerationEngine

    print(f"[controller] scipy {scipy.__version__} (solve_allocation's linprog, HiGHS)",
          flush=True)
    gc.collect()                     # earlier phases' engines hold reference cycles
    reset_launches(ka, kf, tk)
    fp_bytes = 2 * cfg.num_layers * cfg.num_kv_heads * cfg.head_dim * 2
    figures = {"scipy": scipy.__version__, "calibration": {}}
    coeffs = {}
    for kv_dtype in (None, "int8"):
        label = kv_dtype or cfg.dtype
        t0 = time.perf_counter()
        eng = GenerationEngine(cfg, params=params, device="cuda", max_batch=8, max_seq=2048,
                               block_size=16, prefill_chunk_size=256, kv_dtype=kv_dtype)
        eng.warmup_step_variants()
        gen = Generator(engine=eng)
        t1 = time.perf_counter()
        c = calibrate_generator_from_engine(gen, eng, prefill_len=1024, decode_tokens=32,
                                            long_ctx=1536)
        # the fit times a host-bound step loop: its mean step wall says how
        # fast the host ran while it measured
        step_ms = 1e3 * (time.perf_counter() - t1) / eng.stats()["steps"]
        wall = time.perf_counter() - t0
        # int8: one byte a value plus the (n_blocks, KVH) f32 scales of K and
        # V amortized over a 16-token block
        want = (fp_bytes // 2 + 2 * cfg.num_layers * cfg.num_kv_heads * 4 / 16 if kv_dtype
                else fp_bytes)
        assert c["kv_bytes_per_token"] == want, (label, c["kv_bytes_per_token"], want)
        assert c["baseline_kv_bytes_per_token"] == fp_bytes, c
        scale = gen.kv_capacity_scale()
        assert scale == (fp_bytes / want), scale
        assert all(c[k] > 0 for k in ("prefill_per_token_s", "ttft_per_prefill_token_s",
                                      "decode_per_token_s")), c
        assert pool_is_clean(eng)
        for k in COEFFS:
            print(f"[controller] {label} pools: {k} {c[k]!r} (class default "
                  f"{getattr(Generator, k)!r}; x{c[k] / getattr(Generator, k):.4g})"
                  if getattr(Generator, k) else
                  f"[controller] {label} pools: {k} {c[k]!r} (class default "
                  f"{getattr(Generator, k)!r})", flush=True)
        print(f"[controller] {label} pools: kv_bytes_per_token {c['kv_bytes_per_token']!r}, "
              f"baseline_kv_bytes_per_token {c['baseline_kv_bytes_per_token']!r}, "
              f"kv_capacity_scale {scale:.5f}; {len(eng.finished)} calibration requests, "
              f"{eng.stats()['steps']} steps, {step_ms:.2f} ms a step; {wall:.1f}s wall "
              f"(engine, warmup and fit)", flush=True)
        figures["calibration"][label] = {**c, "kv_capacity_scale": scale,
                                         "step_ms": step_ms, "wall_s": wall}
        coeffs[label] = c
        if kv_dtype is None:
            bf16_eng = eng
        else:
            del eng
    assert round(figures["calibration"]["int8"]["kv_capacity_scale"], 5) == 1.99610
    card = {k: coeffs[cfg.dtype][k] for k in COEFFS}

    # real-execution profiling of vrag's generator on the bf16 engine, beside
    # the card-calibrated cost model on the same 8 feature draws (cold), on
    # the draws as drawn and as _profile_run caps them (prompt <= max_seq/2,
    # at most 64 new tokens)
    t0 = time.perf_counter()
    app = make_app("vrag", engine=bf16_eng)
    gen = app.components["VGenerator"]
    gen.calibrate(coeffs[cfg.dtype])
    rng = np.random.default_rng(0)
    draws = [sample_request_features(rng) for _ in range(8)]
    capped = []
    for f in draws:
        n = max(int(min(f["tokens_in"], bf16_eng.max_seq // 2)), 4)
        out = max(int(min(f["tokens_out"], max(bf16_eng.max_seq - n - 1, 1), 64)), 1)
        capped.append({**f, "tokens_in": float(n), "tokens_out": float(out)})
    model = float(np.mean([gen.estimate_time(f, hit_rate=0.0, host_hit_rate=0.0)
                           for f in draws]))
    model_capped = float(np.mean([gen.estimate_time(f, hit_rate=0.0, host_hit_rate=0.0)
                                  for f in capped]))
    n_before = len(bf16_eng.finished)
    profile_components({"VGenerator": gen}, n_samples=8, real_execution=True)
    meta = gen.meta
    assert len(bf16_eng.finished) == n_before + 8 and pool_is_clean(bf16_eng)
    real = {"alpha": meta.alpha, "mean_service_s": meta.mean_service_s,
            "alpha_hit_rate": meta.alpha_hit_rate, "model_mean_s": model,
            "model_capped_mean_s": model_capped,
            "real_over_model_capped": meta.mean_service_s / model_capped,
            "wall_s": time.perf_counter() - t0}
    figures["real_execution"] = real
    print(f"[controller] profile_components(real_execution) of vrag's VGenerator, 8 draws: "
          f"alpha {meta.alpha} (mean_service_s {meta.mean_service_s:.4f}, baked hit rate "
          f"{meta.alpha_hit_rate:.3f}); card-calibrated estimate_time (cold) on the same "
          f"draws {model:.4f}s, on the draws as run (capped) {model_capped:.4f}s: measured "
          f"/ model {real['real_over_model_capped']:.3f}; {real['wall_s']:.1f}s wall",
          flush=True)
    del app, gen, bf16_eng
    torch.cuda.empty_cache()
    figures["apps"] = plan_and_serve(card)
    launches = read_launches(ka, kf, tk)
    assert all(launches[n] > 0 for n in PAGED), launches
    assert all(launches[n] == 0 for n in (*DENSE, "topk_retrieval", "rwkv6_chunked",
                                          "ssm_scan")), launches
    print(f"[controller] launches in the phase: {launches}", flush=True)
    return launches, figures


# ---------------------------------------------------------------------------
# phase 2g: the windowed flash and dense decode kernels at a 4096 window
# ---------------------------------------------------------------------------

WIN = 4096                                   # qwen2.5-3b-swa's and mixtral-8x22b's window
WIN_HEADS = {"G6": (48, 8, 128), "G8": (16, 2, 128)}   # mixtral-8x22b, qwen2.5-3b(-swa)
WIN_CASES = ((6000, WIN), (4097, WIN))       # the longest prefill first (timed)
WIN_DECODE_CASES = {"rings": [WIN, WIN, 1, WIN, WIN - 1, WIN, 300, WIN]}


def phase_window_kernels(ka, kf):
    """The two dense kernels at the shapes of phases 10 and 11: flash with
    window 4096 at hd 128, S 6000 and 4097 (past the window, no multiple of
    the tile), mixtral's group of 6 and qwen's of 8; dense decode at
    mixtral's heads on a wrapped 4096-slot ring. Returns (flash rows by
    group, decode rows)."""
    flash = {g: phase_swa_kernels(kf, heads, WIN_CASES, seed=29 + i)
             for i, (g, heads) in enumerate(WIN_HEADS.items())}
    decode = phase_swa_decode_kernel(ka, WIN_HEADS["G6"], WIN, WIN_DECODE_CASES, seed=31)
    return flash, decode


# ---------------------------------------------------------------------------
# phase 2h: the flash kernel with a chunk and at MLA's split head dims; the
# dense decode kernel on llama4-scout's caches
# ---------------------------------------------------------------------------

L4_CHUNK = 8192                              # llama4-scout's chunk
L4_HEADS = (40, 8, 128)                      # llama4-scout: H, KVH, hd (G = 5)
# (S, chunk, dtypes): phase 12's longest prefill (12500 = 8192 + 4308;
# timed), and a chunk of 200 with S 1000, whose 64-row query tiles straddle
# chunk boundaries
CHUNK_FLASH_CASES = ((12500, L4_CHUNK, ("bfloat16",)), (1000, 200, ("float32", "bfloat16")))
MLA_HEADS = (40, 96, 64)                     # minicpm3: H (= KVH), query/key and value head dims
MLA_FLASH_CASES = ((6000, ("bfloat16",)), (2048, ("float32", "bfloat16")))   # 6000 timed
# dense decode at llama4's heads: an 8192-slot chunk ring (lengths pos %
# 8192 + 1: full chunks, a new chunk's first slots, the long prompts' 808
# and 4308) and a 16384-slot global cache (lengths pos + 1)
L4_DECODE_CASES = {"chunk_ring": (L4_CHUNK, [8192, 1, 808, 4308, 8192, 2, 100, 4097]),
                   "global": (16384, [12532, 9031, 1, 16384, 5000, 129, 777, 2048])}




def grouped_ref(kf, q, k, v, max_kv_heads, **kw):
    """``ref_flash_attention`` over ``max_kv_heads`` KV heads (and their
    query heads) at a time: whole (H, S, S) float32 scores would not fit
    (40 heads at S 12500: 25 GB)."""
    G, KVH = q.shape[2] // k.shape[2], k.shape[2]
    return torch.cat([kf.ref_flash_attention(q[:, :, i * G:(i + max_kv_heads) * G],
                                             k[:, :, i:i + max_kv_heads],
                                             v[:, :, i:i + max_kv_heads], **kw)
                      for i in range(0, KVH, max_kv_heads)], dim=2)


def flash_case(kf, name, dtype_name, q, k, v, timed_case, lib, work, group, **kw):
    """One flash check against its plain version (grouped by ``group`` KV
    heads), f32 and for bf16 also against the plain version in f32; timed
    beside the bound and the library call when ``timed_case``."""
    tol = TOL[dtype_name]
    got = kf.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    every = slice(None)
    errs = {"plain": check_close(name, got, grouped_ref(kf, q, k, v, group, **kw), every,
                                 tol["plain"])}
    if dtype_name == "bfloat16":
        want = grouped_ref(kf, q.float(), k.float(), v.float(), group, **kw)
        errs["plain_f32"] = check_close(name + " vs f32", got, want, every, tol["plain_f32"])
        del want
    del got
    r = {"errs": errs}
    if timed_case:
        flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
        r.update(timed_row(work, dtype_name, flush, lambda: kf.flash_attention(q, k, v, **kw),
                           lambda: grouped_ref(kf, q, k, v, group, **kw), lib))
    print_dense_row(name, r, tol)
    torch.cuda.empty_cache()
    return r


def phase_chunk_mla_kernels(ka, kf):
    """Phase 2h: flash with a chunk at llama4's heads (S 12500 with chunk
    8192, bf16, timed; S 1000 with chunk 200, f32 and bf16, query tiles
    straddling chunk boundaries), flash at minicpm3's split head dims (96,
    64; S 6000 bf16 timed, S 2048 f32 and bf16), each against its plain
    version one group of KV heads at a time; then dense decode at llama4's
    heads on an 8192-slot chunk ring and a 16384-slot global cache
    (``phase_swa_decode_kernel``). Returns (chunk rows, mla rows, decode
    rows)."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(37)
    Hq, Hkv, hd = L4_HEADS
    chunk_rows = {}
    for S, chunk, dtypes in CHUNK_FLASH_CASES:
        for dtype_name in dtypes:
            dt = getattr(torch, dtype_name)
            q, k, v = (torch.randn((1, S, n, hd), generator=gen, device="cuda").to(dt)
                       for n in (Hq, Hkv, Hkv))
            timed_case = (S, chunk) == CHUNK_FLASH_CASES[0][:2]
            i = torch.arange(S, device="cuda")
            mask = (i[None] <= i[:, None]) & (i[None] // chunk == i[:, None] // chunk)
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            lib = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                         enable_gqa=True)
            name = (f"flash_attention[{dtype_name}, H={Hq}, KVH={Hkv}, hd={hd}, S={S}, "
                    f"chunk={chunk}]")
            chunk_rows[(dtype_name, S, chunk)] = flash_case(
                kf, name, dtype_name, q, k, v, timed_case, lib,
                flash_work(q, k, v, chunk=chunk), 1, chunk=chunk)
            del q, k, v, qt, kt, vt, mask, lib
            torch.cuda.empty_cache()
    Hm, hdk, hdv = MLA_HEADS
    mla_rows = {}
    for S, dtypes in MLA_FLASH_CASES:
        for dtype_name in dtypes:
            dt = getattr(torch, dtype_name)
            q, k = (torch.randn((1, S, Hm, hdk), generator=gen, device="cuda").to(dt)
                    for _ in range(2))
            v = torch.randn((1, S, Hm, hdv), generator=gen, device="cuda").to(dt)
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            lib = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
            name = f"flash_attention[{dtype_name}, H={Hm}, hd={hdk}/{hdv}, S={S}, causal]"
            mla_rows[(dtype_name, S)] = flash_case(
                kf, name, dtype_name, q, k, v, S == MLA_FLASH_CASES[0][0], lib,
                flash_work(q, k, v), 8)
            del q, k, v, qt, kt, vt, lib
            torch.cuda.empty_cache()
    decode_rows = {}
    for i, (case, (Sc, lengths)) in enumerate(L4_DECODE_CASES.items()):
        decode_rows.update(phase_swa_decode_kernel(ka, L4_HEADS, Sc, {case: lengths},
                                                   seed=41 + i))
    return chunk_rows, mla_rows, decode_rows


# ---------------------------------------------------------------------------
# phases 10 and 11: sliding-window stacks and MoE at full width
# ---------------------------------------------------------------------------

SWA_PROMPT_LENGTHS = (4090, 4096, 4097, 5000, 6000)
LONG_MAX_NEW = 32
WINDOW_CONTROL_LENGTHS = (5000, 6000)        # 904 and 1904 keys outside the window


@contextlib.contextmanager
def keep_step_logits(eng, routes=None):
    """Each request's logits (float32, on the device) of every token the
    dense engine samples: {req_id: [logits of token 0 (its prefill), 1,
    ...]}, taken from the prefill's ``forward`` (the last position of an
    unpadded prefill, the prompt's last token of one padded to its bucket)
    and from each batched ``decode_step`` (the row of the request's slot).
    With a dict ``routes``, also the experts each request's tokens were
    routed to: routes[req_id] the (T, K) expert ids of each ``moe.route``
    call in the engine's order, the prefill's (its layers, each in
    ``moe_chunks(Lp)`` chunks) then each decode step's (its layers, the
    request's row)."""
    from repro_torch.models import moe
    from repro_torch.serving import engine as engine_mod

    assert eng.backend == "dense"
    kept, current = {}, {}
    fwd, dec, route = engine_mod.forward, engine_mod.decode_step, moe.route
    prefill_one, decode_batch = eng._prefill_one, eng._decode_batch

    def forward(*args, **kw):
        out = fwd(*args, **kw)
        req = current["req"]
        last = -1 if kw.get("logits_mode") == "last" else min(len(req.prompt), eng.max_seq) - 1
        kept[req.req_id] = [out[0][0, last].float()]
        return out

    def decode_step(*args, **kw):
        logits, caches = dec(*args, **kw)
        for r in current["active"]:
            kept[r.req_id].append(logits[r.slot].float())
        return logits, caches

    def prefill(req, slot):
        current["req"], current["active"] = req, None
        return prefill_one(req, slot)

    def decode(active):
        current["active"] = list(active)
        return decode_batch(active)

    def routed(params, xt, cfg, capacity):
        out = route(params, xt, cfg, capacity)
        if current["active"] is None:
            routes.setdefault(current["req"].req_id, []).append(out[2])
        else:
            for r in current["active"]:
                routes[r.req_id].append(out[2][r.slot:r.slot + 1])
        return out

    engine_mod.forward, engine_mod.decode_step = forward, decode_step
    eng._prefill_one, eng._decode_batch = prefill, decode
    if routes is not None:
        moe.route = routed
    try:
        yield kept
    finally:
        engine_mod.forward, engine_mod.decode_step, moe.route = fwd, dec, route
        del eng._prefill_one, eng._decode_batch


@contextlib.contextmanager
def local_mask_dropped():
    """The control of phases 10 and 12's bound: every sliding-window or
    chunked-local attention of the sequence path run as full causal
    attention."""
    from repro_torch.configs.base import ATTN_FULL
    from repro_torch.models import attention

    blockwise = attention.blockwise_attention
    attention.blockwise_attention = lambda q, k, v, **kw: blockwise(
        q, k, v, **{**kw, "attn_type": ATTN_FULL, "window": 0})
    try:
        yield
    finally:
        attention.blockwise_attention = blockwise


@contextlib.contextmanager
def linear_ring_order():
    """The reference's prefill cache (reported control): the window's last
    keys kept in linear order, ``t[:, S - Sc:]``, where the ring needs them
    rolled by S % Sc."""
    from repro_torch.models import transformer

    ring = transformer._ring
    transformer._ring = lambda t, Sc: t[:, t.shape[1] - Sc:]
    try:
        yield
    finally:
        transformer._ring = ring


def oracle_logits(cfg, params, prompt, tokens, extra=None):
    """The no-cache oracle's logits (float32) at the positions that sample
    ``tokens``: one ``forward`` of the prompt and all but the last token,
    with the batch's ``extra`` inputs (a row's patch embeddings or
    frames)."""
    from repro_torch.models import forward

    seq = torch.as_tensor(np.concatenate([np.asarray(prompt), tokens[:-1]]),
                          dtype=torch.int32, device="cuda")
    with torch.no_grad():
        logits, _ = forward(cfg, params, {**(extra or {}), "tokens": seq[None]})
    return logits[0, len(prompt) - 1:].float()


def rel_diffs(kept, want, vocab):
    """max |d| / max |logit| of each sampled token's logits against the
    oracle's at the same position, over the ``vocab`` real entries (the
    pad-vocab logits are -1e30 on both sides)."""
    return [float((k[:vocab] - w[:vocab]).abs().max() / k[:vocab].abs().max())
            for k, w in zip(kept, want)]


def serve_long(eng, prompts, max_new=LONG_MAX_NEW, routes=None):
    """Serve ``prompts`` greedily with each token's logits (and, given a
    dict ``routes``, its experts) kept; returns (requests, kept logits, wall
    s)."""
    with keep_step_logits(eng, routes) as kept:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reqs = [eng.submit(p, max_new=max_new) for p in prompts]
        eng.run_until_done()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    assert all(len(r.out_tokens) == max_new and len(kept[r.req_id]) == max_new for r in reqs)
    return reqs, kept, wall


def decode_step_times(cfg, params, cache, pos, reps=3):
    """One dense ``decode_step`` of the cache's B rows at position ``pos``:
    its wall (host clock around each call and a synchronize, as a serving
    step waits for its logits; mean of ``reps``) and its device busy by CUDA
    events. A whole step's ~600-1500 launches do not all queue behind one
    spin kernel (the launch queue fills and the host waits), so the step
    runs as its pieces (the embedding, rope tables and lengths, each layer
    group, the final norm and the unembedding), each queued behind a spin
    and timed with events (a piece the spin did not outlast runs again from
    the same state behind a spin twice as long); busy is their sum, mean of
    ``reps`` (None if a piece could not be queued within a ~0.8 s spin)."""
    from repro_torch.models import decode_step
    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import unembed
    from repro_torch.models.model import decode_embed

    B = next(iter(cache[0].values())).shape[1]
    tokens = torch.zeros((B, 1), dtype=torch.int32, device="cuda")
    pos_t = torch.full((B,), pos, dtype=torch.int32, device="cuda")
    state = {}

    def head():
        state["inputs"] = tfm.decode_inputs(cfg, cache, pos_t)
        state["x"] = decode_embed(cfg, params, tokens, pos_t)

    def group(g):
        state["x"] = tfm.apply_group_decode(cfg, params["blocks"], cache, g, state["x"], pos_t,
                                            state["inputs"])

    def tail():
        x = tfm.apply_norm(cfg, params["final_norm"], state["x"])
        state["logits"] = unembed(params["embed"], params.get("lm_head"), x,
                                  cfg.tie_embeddings)

    G = cfg.num_layers // tfm.period(cfg)
    pieces = [head] + [lambda g=g: group(g) for g in range(G)] + [tail]
    with torch.no_grad():
        decode_step(cfg, params, cache, tokens, pos_t)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            decode_step(cfg, params, cache, tokens, pos_t)
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
        busy = 0.0
        for _ in range(reps):
            for piece in pieces:
                spin, saved = 20_000_000, dict(state)       # ~10 ms
                while True:
                    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                    torch.cuda._sleep(spin)
                    a.record()
                    piece()
                    b.record()
                    early = a.query()   # the spin already over: the piece was not all queued
                    b.synchronize()
                    if not early:
                        break
                    # the spin ended before the piece was queued: again,
                    # from the same state, behind a spin twice as long
                    spin *= 2
                    state.update(saved)
                    if spin > 1_600_000_000:                # ~0.8 s
                        return wall, None
                busy += a.elapsed_time(b)
    return wall, busy / reps


def serve_figures(eng, reqs, wall):
    st, lat = eng.stats(), eng.latency_summary()
    return {"requests": len(reqs), "tokens_out": st["tokens_out"], "wall_s": wall,
            "tokens_per_s": st["tokens_out"] / wall, "ttft_mean_ms": 1e3 * lat["ttft_mean"],
            "tpot_p95_ms": 1e3 * lat.get("tpot_p95", 0.0), "steps": st["steps"],
            "prefill_tokens": st["prefill_tokens"]}


def swa_batch(cfg, prompts):
    """Phase 10's prompts: the ``SWA_PROMPT_LENGTHS`` drawn from seed 10,
    then two of phase 5's below the window."""
    from repro_torch.serving.segments import SegmentedPrompt

    rng = np.random.default_rng(10)
    short = [np.asarray(p) for p in prompts if not isinstance(p, SegmentedPrompt)][:2]
    return [rng.integers(0, cfg.vocab_size, n) for n in SWA_PROMPT_LENGTHS] + short


def phase_swa_serve(ka, kf, tk, params, prompts):
    """Phase 10: qwen2.5-3b-swa at full width and depth (36 layers, bf16,
    window 4096, phase 5's weights: the variant changes the mask, not the
    widths) on the dense backend, ``max_batch=8``, ``max_seq=8192``: prompts
    of 4090 (wraps while decoding), 4096, 4097, 5000 and 6000 tokens and two
    of phase 5's below the window, 32 new tokens each. Every sampled token's
    logits are held to the no-cache oracle's at its position (``forward``
    on the prompt plus the engine's tokens so far: the windowed flash over
    the whole sequence, no ring) within ``logit_bound``; the oracle with the
    window dropped must read above the bound on the 5000- and 6000-token
    prompts; the reference's linear ring order is run and reported. Returns
    the launches of the served run, the figures and the greedy tokens."""
    from repro_torch.configs import get_arch
    from repro_torch.serving.engine import GenerationEngine

    cfg = get_arch("qwen2.5-3b-swa").replace(dtype="bfloat16")
    L = cfg.num_layers
    batch = swa_batch(cfg, prompts)
    lens = [len(p) for p in batch]
    torch.cuda.reset_peak_memory_stats()
    eng = GenerationEngine(cfg, params=params, device="cuda", backend="dense", max_batch=8,
                           max_seq=8192)
    assert eng.cache[0]["k"].shape[2] == cfg.window
    reset_launches(ka, kf, tk)
    reqs, kept, wall = serve_long(eng, batch)
    launches = read_launches(ka, kf, tk)
    st = eng.stats()
    figures = serve_figures(eng, reqs, wall)
    assert st["backend"] == "dense" and st["kernel"] == "cuda", st
    assert st["prefill_tokens"] == sum(lens), st                    # unpadded prefills
    assert all(0 <= t < cfg.vocab_size for r in reqs for t in r.out_tokens)
    want = {n: 0 for n in launches}
    want["flash_attention"] = L * len(reqs)
    want["decode_attention"] = L * st["steps"]
    assert launches == want, (launches, want, st)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[swa serve] {cfg.name} {cfg.dtype} (window {cfg.window}, {L} layers, dense backend, "
          f"{eng.cache[0]['k'].shape[2]}-slot rings): {len(reqs)} requests (prompts {lens}), "
          f"{st['tokens_out']} tokens out in {wall:.3f}s = {figures['tokens_per_s']:.1f} tok/s; "
          f"mean TTFT {figures['ttft_mean_ms']:.1f}ms, p95 TPOT {figures['tpot_p95_ms']:.2f}ms; "
          f"{st['steps']} decode steps; peak memory {peak:.2f} GiB; launches {launches} "
          f"(flash {L} x {len(reqs)} prefills, decode {L} x {st['steps']} steps)", flush=True)

    bound = logit_bound(L)
    rel, agree = {}, {}
    for r, n in zip(reqs, lens):
        want_logits = oracle_logits(cfg, params, r.prompt, r.out_tokens)
        rel[n] = rel_diffs(kept[r.req_id], want_logits, cfg.vocab_size)
        agree[n] = float(np.mean([int(w.argmax()) == t for w, t in
                                  zip(want_logits, r.out_tokens)]))
        del want_logits
    worst = {n: max(v) for n, v in rel.items()}
    print(f"[swa serve] every sampled token's logits against the no-cache oracle's, max |d| / "
          f"max |logit|, worst per prompt {dict((n, round(x, 5)) for n, x in worst.items())} "
          f"(bound {bound:.3f}); greedy agreement with the oracle per prompt {agree}",
          flush=True)
    assert max(worst.values()) <= bound, (worst, bound)
    # control, asserted: without the window the oracle reads above the bound
    # where the window excludes keys
    control = {}
    with local_mask_dropped():
        for r, n in zip(reqs, lens):
            if n in WINDOW_CONTROL_LENGTHS:
                control[n] = max(rel_diffs(
                    kept[r.req_id], oracle_logits(cfg, params, r.prompt, r.out_tokens),
                    cfg.vocab_size))
    print(f"[swa serve] control, the oracle with the window dropped (full causal): worst per "
          f"prompt {dict((n, round(x, 5)) for n, x in control.items())} against the bound "
          f"{bound:.3f}", flush=True)
    assert all(x > bound for x in control.values()), (control, bound)
    # control, reported: the reference's linear ring order in the prefill
    eng_lin = GenerationEngine(cfg, params=params, device="cuda", backend="dense",
                               max_batch=8, max_seq=8192)
    with linear_ring_order():
        lreqs, lkept, _ = serve_long(eng_lin, batch)
    linear = {}
    for r, n in zip(lreqs, lens):
        d = rel_diffs(lkept[r.req_id], oracle_logits(cfg, params, r.prompt, r.out_tokens),
                      cfg.vocab_size)
        linear[n] = {"worst": max(d), "first": d[0], "last": d[-1]}
    print(f"[swa serve] control (reported, not asserted), the reference's linear ring order: "
          f"per prompt {{Lp: worst, first token, last token}} "
          f"{ {n: tuple(round(x, 5) for x in v.values()) for n, v in linear.items()} }",
          flush=True)
    del eng_lin, lkept
    # where a decode step's time goes: 8 rows at position 6000 of the rings
    wall_ms, busy_ms = decode_step_times(cfg, params, eng.cache, 6000)
    print(f"[swa serve] decode step (8 rows, position 6000): wall {wall_ms:.2f} ms (mean of 3); "
          f"device busy {fmt_ms(busy_ms)} ms (CUDA events: each of the step's {L + 2} pieces "
          f"queued behind a spin, summed; mean of 3)", flush=True)
    figures.update(peak_gib=peak, logit_bound=bound, worst_rel=worst, rel=rel,
                   greedy_agreement=agree, window_dropped=control, linear_order=linear,
                   decode_step_wall_ms=wall_ms, decode_step_busy_ms=busy_ms)
    tokens = [r.out_tokens for r in reqs]
    del eng, kept
    gc.collect()
    torch.cuda.empty_cache()
    return launches, figures, tokens


MIXTRAL_LAYERS = 8                           # of 56: 8 layers' bf16 weights ~41 GB of 80
MOE_CHECK_T = (8, 2048)                      # a decode step (dropless), a prefill (capacity)
# a bf16 MoE against the per-route formulation in float32: the kernel
# tolerance of phase 2 for bf16 against f32 (products rounded to bf16)
MOE_TOL = TOL["bfloat16"]["plain"][1]


def check_moe_layer(cfg, lp, T, gen):
    """Phase 11 (a): one layer's ``apply_moe`` at full width on T tokens
    against an independent per-route formulation in float32 with the same
    routing (``moe.route``): for each kept (token, k), the expert's SwiGLU on
    the token times its gate, summed. The drops must be the count of
    ``keep`` and sum(max(n_e - C, 0)) over the experts' route counts.
    Returns (max |d| / max |y|, drops, capacity)."""
    import torch.nn.functional as F

    from repro_torch.models import moe

    E, K, D = cfg.num_experts, cfg.num_experts_per_tok, cfg.d_model
    x = torch.randn((1, T, D), generator=gen, device="cuda").to(lp["router"].dtype)
    with torch.no_grad():
        y, aux = moe.apply_moe(lp, x, cfg)
        C = moe.expert_capacity(T, E, K)
        xt = x.reshape(T, D)
        _, _, idx, gates, _, keep = moe.route(lp, xt, cfg, C)
        want = torch.zeros((T, D), dtype=torch.float32, device="cuda")
        for e in range(E):
            t, k = torch.nonzero((idx == e) & keep, as_tuple=True)
            xe = xt[t].float()
            h = F.silu(xe @ lp["w_gate"][e].float()) * (xe @ lp["w_up"][e].float())
            want.index_add_(0, t, (h @ lp["w_down"][e].float()) * gates[t, k].float()[:, None])
    drops = int((~keep).sum())
    counts = torch.bincount(idx.reshape(-1), minlength=E)
    assert drops == int((counts - C).clamp(min=0).sum()), (drops, counts.tolist(), C)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(aux))
    rel = float((y.reshape(T, D).float() - want).abs().max() / want.abs().max())
    assert rel <= MOE_TOL, (T, rel, MOE_TOL)
    return rel, drops, C


@contextlib.contextmanager
def count_drops():
    """The routes each ``moe.route`` call drops, as (T, device count) pairs
    (no host sync inside the run)."""
    from repro_torch.models import moe

    route, calls = moe.route, []

    def counted(params, xt, cfg, capacity):
        out = route(params, xt, cfg, capacity)
        calls.append((xt.shape[0], (~out[-1]).sum()))
        return out

    moe.route = counted
    try:
        yield calls
    finally:
        moe.route = route


def phase_swa_moe_parity(ka, kf):
    """Phase 11 (c): the mixtral-8x22b and qwen2.5-3b-swa smoke engines in
    float32 (window 64; 4 experts, top-2) on the CPU (plain versions) and on
    the card (kernels) give identical greedy tokens, with prompts short of,
    at and past the window and decodes that wrap the ring; one flash a
    layer and prefill, one dense decode a layer and step."""
    from repro_torch.configs import get_arch, smoke_variant
    from repro_torch.models import init_params
    from repro_torch.serving.engine import GenerationEngine

    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 products
    torch.backends.cudnn.allow_tf32 = False
    for arch in ("mixtral-8x22b", "qwen2.5-3b-swa"):
        cfg = smoke_variant(get_arch(arch))
        rng = np.random.default_rng(3)
        prompts = [rng.integers(0, cfg.vocab_size, n) for n in (5, 23, 60, 64, 70, 100, 200)]
        out = {}
        for dev in ("cpu", "cuda"):
            params = init_params(cfg, torch.Generator().manual_seed(0), dev)
            eng = GenerationEngine(cfg, params=params, device=dev, max_batch=4, max_seq=256)
            ka.reset_launch_counts()
            kf.reset_launch_counts()
            reqs = [eng.submit(p, max_new=12) for p in prompts]
            eng.run_until_done()
            assert eng.backend == "dense" and all(len(r.out_tokens) == 12 for r in reqs)
            out[dev] = [r.out_tokens for r in reqs]
        launches = (kf.flash_attention.launches, ka.decode_attention.launches)
        assert launches == (cfg.num_layers * len(prompts), cfg.num_layers * eng.steps), launches
        if out["cpu"] != out["cuda"]:
            raise AssertionError(f"{arch} smoke engine: CPU and GPU greedy tokens differ:\n"
                                 f"{out['cpu']}\n{out['cuda']}")
        print(f"[parity] {cfg.name} engine f32: {len(prompts)} requests (prompts "
              f"{[len(p) for p in prompts]} tokens, window {cfg.window}), identical greedy "
              f"tokens on cpu (plain) and cuda (kernels); flash/decode launches {launches}",
              flush=True)


def phase_mixtral_serve(ka, kf, tk, prompts):
    """Phase 11: mixtral-8x22b at full width with its depth cut to 8 of 56
    layers, bf16 weights drawn on the card, dense backend, ``max_batch=8``,
    ``max_seq=8192``: (a) one layer's MoE against the per-route float32
    formulation at T = 8 and 2048; (b) phase 5's ten prompts (flattened,
    tokens modulo the vocab) and prompts of 4500 and 6000 tokens, 32 new
    tokens each, with flash and dense decode launching once a layer and
    prefill or step; (c) CPU/card parity at smoke width
    (``phase_swa_moe_parity``). Reported: routes dropped per prefill,
    tokens/s, TTFT, TPOT, peak memory, a decode step's device busy against
    its wall and its bound, greedy agreement with the no-cache oracle on the
    two long prompts. Returns the launches of the served run and the
    figures."""
    from repro_torch.configs import get_arch
    from repro_torch.models import init_params
    from repro_torch.models.transformer import layer_slice
    from repro_torch.serving.engine import GenerationEngine
    from repro_torch.serving.segments import SegmentedPrompt

    cfg = get_arch("mixtral-8x22b").replace(dtype="bfloat16", num_layers=MIXTRAL_LAYERS)
    L = cfg.num_layers
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    leaves = list(_tensors(params))
    weight_bytes = sum(x.numel() * x.element_size() for x in leaves)
    print(f"[mixtral serve] {cfg.name} {cfg.dtype}, {L} of 56 layers: "
          f"{sum(x.numel() for x in leaves) / 1e9:.3f}B parameters ({weight_bytes / 1e9:.2f} GB) "
          f"drawn on the card in {time.perf_counter() - t0:.1f}s", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(5)
    moe_check = {}
    for T in MOE_CHECK_T:
        rel, drops, C = check_moe_layer(cfg, layer_slice(params["blocks"][0], 0)["moe"], T, gen)
        moe_check[T] = {"rel_err": rel, "dropped_routes": drops, "capacity": C}
    print(f"[mixtral serve] (a) apply_moe of layer 0 against the per-route float32 formulation: "
          f"{moe_check} (max |d| / max |y|, bound {MOE_TOL})", flush=True)

    rng = np.random.default_rng(11)
    flat = [np.asarray(p.tokens if isinstance(p, SegmentedPrompt) else p) % cfg.vocab_size
            for p in prompts]
    batch = flat + [rng.integers(0, cfg.vocab_size, n) for n in (4500, 6000)]
    lens = [len(p) for p in batch]
    torch.cuda.reset_peak_memory_stats()
    eng = GenerationEngine(cfg, params=params, device="cuda", max_batch=8, max_seq=8192)
    assert eng.backend == "dense" and eng.cache[0]["k"].shape[2] == cfg.window
    reset_launches(ka, kf, tk)
    with count_drops() as routed:
        reqs, kept, wall = serve_long(eng, batch)
    launches = read_launches(ka, kf, tk)
    st = eng.stats()
    figures = serve_figures(eng, reqs, wall)
    peak = torch.cuda.max_memory_allocated() / 2**30
    assert st["kernel"] == "cuda" and st["prefill_tokens"] == sum(lens), st
    assert all(0 <= t < cfg.vocab_size for r in reqs for t in r.out_tokens)
    assert all(bool(torch.isfinite(x).all()) for v in kept.values() for x in v)
    want = {n: 0 for n in launches}
    want["flash_attention"] = L * len(reqs)
    want["decode_attention"] = L * st["steps"]
    assert launches == want, (launches, want, st)
    # the routes each prefill dropped (every layer routes once a call)
    prefill_calls = [(T, int(n)) for T, n in routed if T > 8]
    assert len(prefill_calls) == L * len(reqs), len(prefill_calls)
    decode_drops = sum(int(n) for T, n in routed if T <= 8)
    assert decode_drops == 0                                         # dropless decode
    drops = [(prefill_calls[i][0], sum(n for _, n in prefill_calls[i:i + L]))
             for i in range(0, len(prefill_calls), L)]
    print(f"[mixtral serve] (b) {len(reqs)} requests (prompts {lens}), {st['tokens_out']} "
          f"tokens out in {wall:.3f}s = {figures['tokens_per_s']:.1f} tok/s; mean TTFT "
          f"{figures['ttft_mean_ms']:.1f}ms, p95 TPOT {figures['tpot_p95_ms']:.2f}ms; "
          f"{st['steps']} decode steps; peak memory {peak:.2f} GiB; launches {launches} (flash "
          f"{L} x {len(reqs)} prefills, decode {L} x {st['steps']} steps); routes dropped per "
          f"prefill, summed over its {L} layers, as (prompt tokens, routes dropped of "
          f"{cfg.num_experts_per_tok * L} x the prompt tokens): {drops}; decode steps drop "
          f"none", flush=True)
    # reported: greedy agreement with the no-cache oracle on the two long
    # prompts (its capacity is that of Lp + 31 tokens, the prefill's of Lp)
    agree = {}
    for r, n in zip(reqs, lens):
        if n in (4500, 6000):
            w = oracle_logits(cfg, params, r.prompt, r.out_tokens)
            agree[n] = float(np.mean([int(x.argmax()) == t for x, t in zip(w, r.out_tokens)]))
            agree[f"{n}_worst_rel"] = max(rel_diffs(kept[r.req_id], w, cfg.vocab_size))
            del w
    print(f"[mixtral serve] greedy agreement with the no-cache oracle (reported: the oracle "
          f"routes Lp + 31 tokens with their own capacity): {agree}", flush=True)
    # a decode step of 8 rows at position 6000: all 8 experts of each layer
    # run (dropless, C = 8), so it reads every weight but the embedding table
    wall_ms, busy_ms = decode_step_times(cfg, params, eng.cache, 6000)
    embed = params["embed"]["table"]
    kv_bytes = sum(t.numel() * t.element_size() for t in eng.cache[0].values())
    step_bytes = weight_bytes - embed.numel() * embed.element_size() + kv_bytes
    bound_ms = step_bytes / HBM_BYTES_S * 1e3
    print(f"[mixtral serve] decode step (8 rows, position 6000): wall {wall_ms:.2f} ms (mean of "
          f"3); device busy {fmt_ms(busy_ms)} ms (CUDA events: each of the step's {L + 2} pieces "
          f"queued behind a spin, summed; mean of 3); bound {bound_ms:.2f} ms "
          f"({step_bytes / 1e9:.2f} GB: the weights but the embedding table, and the full "
          f"rings, at 3.35 TB/s)", flush=True)
    figures.update(peak_gib=peak, weight_gb=weight_bytes / 1e9, moe_check=moe_check,
                   dropped_routes_per_prefill=drops, oracle_agreement=agree,
                   decode_step_wall_ms=wall_ms, decode_step_busy_ms=busy_ms,
                   decode_step_bound_ms=bound_ms)
    del eng, kept, params, leaves, embed
    gc.collect()
    torch.cuda.empty_cache()
    return launches, figures


# ---------------------------------------------------------------------------
# phases 4f, 12 and 13: chunked-local stacks with global layers (llama4-scout)
# and multi-head latent attention (minicpm3)
# ---------------------------------------------------------------------------

PARITY_LOGIT_TOL = TOL["float32"]["plain"]   # f32 on both sides: summation order only


def phase_chunk_mla_parity(ka, kf):
    """Phase 4f: the llama4-scout (chunk 64, a chunked and a global layer,
    4 experts top-1 with a shared expert) and minicpm3 (MLA at its real
    head dims) smoke engines in float32 on the CPU (plain versions) and on
    the card (kernels): identical greedy tokens, and every sampled token's
    logits within ``PARITY_LOGIT_TOL``, for prompts short of, at and past
    the chunk; one flash a layer and prefill; llama4 one dense decode a
    layer and step, minicpm3's absorbed decode none. Returns {arch: max
    |d| of the logits}."""
    from repro_torch.configs import card_smoke_variant
    from repro_torch.models import init_params
    from repro_torch.serving.engine import GenerationEngine

    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 products
    torch.backends.cudnn.allow_tf32 = False
    worst = {}
    for arch in ("llama4-scout-17b-a16e", "minicpm3-4b"):
        cfg = card_smoke_variant(arch)
        rng = np.random.default_rng(3)
        prompts = [rng.integers(0, cfg.vocab_size, n) for n in (5, 40, 64, 100, 128, 150, 200)]
        out, logits = {}, {}
        for dev in ("cpu", "cuda"):
            params = init_params(cfg, torch.Generator().manual_seed(0), dev)
            eng = GenerationEngine(cfg, params=params, device=dev, max_batch=4, max_seq=256)
            ka.reset_launch_counts()
            kf.reset_launch_counts()
            with keep_step_logits(eng) as kept:
                reqs = [eng.submit(p, max_new=12) for p in prompts]
                eng.run_until_done()
            assert eng.backend == "dense" and all(len(r.out_tokens) == 12 for r in reqs)
            out[dev] = [r.out_tokens for r in reqs]
            logits[dev] = [torch.stack(kept[r.req_id]).cpu() for r in reqs]
        L = cfg.num_layers
        mla = arch == "minicpm3-4b"
        launches = (kf.flash_attention.launches, ka.decode_attention.launches)
        assert launches == (L * len(prompts), 0 if mla else L * eng.steps), launches
        if out["cpu"] != out["cuda"]:
            raise AssertionError(f"{arch} smoke engine: CPU and GPU greedy tokens differ:\n"
                                 f"{out['cpu']}\n{out['cuda']}")
        atol, rtol = PARITY_LOGIT_TOL
        for a, b in zip(logits["cuda"], logits["cpu"]):
            torch.testing.assert_close(a, b, atol=atol, rtol=rtol)
        worst[arch] = max(float((a - b).abs().max())
                          for a, b in zip(logits["cuda"], logits["cpu"]))
        print(f"[parity] {cfg.name} engine f32: {len(prompts)} requests (prompts "
              f"{[len(p) for p in prompts]} tokens{'' if mla else f', chunk {cfg.chunk_size}'}), "
              f"identical greedy tokens on cpu (plain) and cuda (kernels), every sampled token's "
              f"logits within max |d| {worst[arch]:.3e} (atol, rtol {PARITY_LOGIT_TOL}); "
              f"flash/decode launches {launches}", flush=True)
    return worst


LLAMA4_LAYERS = 8                            # of 48: two groups of [chunked x 3, global]
LLAMA4_MAX_SEQ = 16384
LLAMA4_LONG = (9000, 12500)                  # S % chunk = 808 and 4308


def moe_chunks(T, max_chunk_tokens=8192):
    """The chunks ``moe.apply_moe`` cuts T tokens into (one ``route`` call
    each)."""
    if T <= max_chunk_tokens:
        return 1
    n = -(-T // max_chunk_tokens)
    while T % n:
        n += 1
    return n


@contextlib.contextmanager
def moe_as_served(split):
    """The no-cache oracle's MoE calls cut as the engine's: an MoE layer's
    capacity is that of one call's tokens, and the engine routes a prompt's
    ``split`` tokens in its prefill and each sampled token in a dropless
    decode step; so the oracle's first ``split`` tokens go to one call and
    the rest (<= 256 tokens: dropless) to another."""
    from repro_torch.models import moe

    apply = moe.apply_moe

    def served(params, x, cfg, *args, **kw):
        if x.shape[1] <= split:
            return apply(params, x, cfg, *args, **kw)
        head, aux = apply(params, x[:, :split], cfg, *args, **kw)
        tail, _ = apply(params, x[:, split:], cfg, *args, **kw)
        return torch.cat([head, tail], dim=1), aux

    moe.apply_moe = served
    try:
        yield
    finally:
        moe.apply_moe = apply


@contextlib.contextmanager
def moe_replayed(routes, n_prompt, num_layers):
    """The oracle's tokens sent to the experts the engine chose for them:
    ``routes`` (one request's, from ``keep_step_logits``) replayed in the
    order ``moe_as_served`` makes the oracle's calls (each layer's prefill
    chunks, then its sampled tokens, one a decode step). A top-1 router's
    choice flips on bf16 near-ties between two paths that round
    differently, and a flip swaps a token's whole expert output; with the
    choices pinned, the logits differ by the paths' arithmetic alone.
    Yields a dict: ``n`` the routes the oracle's own router would have
    chosen otherwise, and ``gap`` the largest of their gaps, the oracle's
    router logit of its own choice less that of the engine's, over the
    token's largest |router logit| (0 without a flip). A near-tie flip's
    gap is of the size of the paths' difference; a routing fault (a wrong
    choice, another row's routes) leaves gaps of the size of the logits'
    spread."""
    from repro_torch.models import moe

    n, L = moe_chunks(n_prompt), num_layers
    prefill, steps = routes[:L * n], routes[L * n:]
    queue = []
    for layer in range(L):
        queue += prefill[layer * n:(layer + 1) * n] + [torch.cat(steps[layer::L])]
    route, flips = moe.route, {"n": 0, "gap": 0.0}

    def replayed(params, xt, cfg, capacity):
        idx = queue.pop(0)
        assert idx.shape[0] == xt.shape[0], (idx.shape, xt.shape)
        logits = (xt @ params["router"]).float()
        own = torch.sort(logits, dim=-1, descending=True, stable=True)[1][:, :idx.shape[1]]
        flip = (own != idx).any(dim=-1)
        n_flip = int(flip.sum())
        if n_flip:
            gap = (logits.gather(1, own) - logits.gather(1, idx)).abs().amax(dim=-1)
            rel = gap[flip] / logits[flip].abs().amax(dim=-1)
            flips["n"] += n_flip
            flips["gap"] = max(flips["gap"], float(rel.max()))
        return moe.assign(logits, idx, cfg, capacity, xt.dtype)

    moe.route = replayed
    try:
        yield flips
    finally:
        moe.route = route
    assert not queue, len(queue)


def served_oracle_logits(cfg, params, prompt, tokens, routes):
    """``oracle_logits`` with the MoE as served (``moe_as_served``,
    ``moe_replayed``); returns (logits, the routes the oracle would flip:
    ``moe_replayed``'s dict)."""
    with moe_as_served(len(prompt)), moe_replayed(routes, len(prompt),
                                                  cfg.num_layers) as flips:
        logits = oracle_logits(cfg, params, prompt, tokens)
    return logits, flips


ROUTE_FLIP_SHARE = 0.01   # of a prompt's routes, the most the oracle's router may choose otherwise


def route_flips_ok(flips, n_routes, bound):
    """Whether the routes the oracle's own router would have chosen
    otherwise (``moe_replayed``'s dict) are near-tie noise: at most
    ``ROUTE_FLIP_SHARE`` of the prompt's ``n_routes``, and each flip's gap
    within 2 x the logit ``bound``. The router logits differ between the
    two paths as the logits do, by at most ``bound`` of the largest, and a
    flip's gap is at most the two experts' differences together."""
    return flips["n"] <= ROUTE_FLIP_SHARE * n_routes and flips["gap"] <= 2 * bound


def decode_routes_of(routes, other, n_prompt, num_layers):
    """The faulted control of the route replay: a request's routes
    (``keep_step_logits``' list) with its decode steps' taken from
    ``other``'s row, as if each decode step read another slot's routes."""
    k = num_layers * moe_chunks(n_prompt)
    return routes[:k] + other[k - len(routes):]


def kv_read_bytes(cfg, cache, pos):
    """The K/V bytes a decode step of the cache's rows at ``pos`` reads:
    each layer's valid slots (``transformer.decode_lengths``; an int8
    cache's codes and scales), and every slot of an encoder-decoder's cross
    keys and values."""
    from repro_torch.models import transformer as tfm

    total = 0
    for kind, entry in zip(tfm._kinds(cfg), cache):
        G, B, Sc = entry["k"].shape[:3]
        n = int(tfm.decode_lengths(cfg, kind, Sc, torch.tensor(pos)))
        for name in ("k", "v", "k_scale", "v_scale"):       # the int8 cache's scales too
            if name in entry:
                t = entry[name]
                total += G * B * n * t[0, 0, 0].numel() * t.element_size()
        for name in ("ck", "cv"):                           # every cross slot
            if name in entry:
                total += entry[name].numel() * entry[name].element_size()
    return total


def phase_llama4_serve(ka, kf, tk, prompts):
    """Phase 12: llama4-scout at full width with its depth cut to 8 of 48
    layers (two groups of three chunked-local layers and a global one), bf16
    weights drawn on the card, dense backend (``backend="paged"`` falls
    back), ``max_batch=8``, ``max_seq=16384``: phase 5's ten prompts
    (flattened, tokens modulo the vocab) and prompts of 9000 and 12500 tokens
    (S % chunk = 808 and 4308), 32 new tokens each. Every sampled token's
    logits against the no-cache oracle (``forward`` on the prompt plus the
    tokens so far, its MoE as served: ``served_oracle_logits``) within
    ``logit_bound(8)``, with the oracle router's flips near-tie noise
    (``route_flips_ok``) and a replay of other rows' decode routes failing
    that check; two faulted controls above the bound on the long prompts:
    the chunk mask dropped (local layers full causal, in the oracle) and the
    reference's linear ring order (in the engine's prefill). Reported:
    routes dropped per prefill, tokens/s, TTFT, TPOT, peak memory, a decode
    step's device busy against its wall and its bytes bound. Returns the
    launches of the served run and the figures."""
    from repro_torch.configs import get_arch
    from repro_torch.models import init_params
    from repro_torch.models.transformer import period
    from repro_torch.serving.engine import GenerationEngine
    from repro_torch.serving.segments import SegmentedPrompt

    cfg = get_arch("llama4-scout-17b-a16e").replace(dtype="bfloat16", num_layers=LLAMA4_LAYERS)
    L, p = cfg.num_layers, period(cfg)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    leaves = list(_tensors(params))
    weight_bytes = sum(x.numel() * x.element_size() for x in leaves)
    print(f"[llama4 serve] {cfg.name} {cfg.dtype}, {L} of 48 layers: "
          f"{sum(x.numel() for x in leaves) / 1e9:.3f}B parameters ({weight_bytes / 1e9:.2f} GB) "
          f"drawn on the card in {time.perf_counter() - t0:.1f}s", flush=True)
    rng = np.random.default_rng(12)
    flat = [np.asarray(p.tokens if isinstance(p, SegmentedPrompt) else p) % cfg.vocab_size
            for p in prompts]
    batch = flat + [rng.integers(0, cfg.vocab_size, n) for n in LLAMA4_LONG]
    lens = [len(p) for p in batch]
    torch.cuda.reset_peak_memory_stats()
    eng = GenerationEngine(cfg, params=params, device="cuda", max_batch=8,
                           max_seq=LLAMA4_MAX_SEQ)
    rings = [e["k"].shape[2] for e in eng.cache]
    assert eng.backend == "dense" and rings == [cfg.chunk_size] * (p - 1) + [LLAMA4_MAX_SEQ]
    reset_launches(ka, kf, tk)
    routes = {}
    with count_drops() as routed:
        reqs, kept, wall = serve_long(eng, batch, routes=routes)
    launches = read_launches(ka, kf, tk)
    st = eng.stats()
    figures = serve_figures(eng, reqs, wall)
    peak = torch.cuda.max_memory_allocated() / 2**30
    assert st["kernel"] == "cuda" and st["prefill_tokens"] == sum(lens), st   # unpadded
    assert all(0 <= t < cfg.vocab_size for r in reqs for t in r.out_tokens)
    assert all(bool(torch.isfinite(x).all()) for v in kept.values() for x in v)
    want = {n: 0 for n in launches}
    want["flash_attention"] = L * len(reqs)
    want["decode_attention"] = L * st["steps"]
    assert launches == want, (launches, want, st)
    # the routes each prefill dropped: its L layers route moe_chunks(Lp)
    # times each, in admission (= submission) order; decode steps route <= 8
    prefill_calls = [(T, int(n)) for T, n in routed if T > 8]
    drops, i = [], 0
    for n in lens:
        calls = prefill_calls[i:i + L * moe_chunks(n)]
        assert sum(T for T, _ in calls) == L * n, (n, calls)
        drops.append((n, sum(d for _, d in calls)))
        i += len(calls)
    assert i == len(prefill_calls)
    assert sum(int(n) for T, n in routed if T <= 8) == 0                # dropless decode
    print(f"[llama4 serve] {len(reqs)} requests (prompts {lens}; rings {rings}), "
          f"{st['tokens_out']} tokens out in {wall:.3f}s = {figures['tokens_per_s']:.1f} tok/s; "
          f"mean TTFT {figures['ttft_mean_ms']:.1f}ms, p95 TPOT {figures['tpot_p95_ms']:.2f}ms; "
          f"{st['steps']} decode steps; peak memory {peak:.2f} GiB; launches {launches} (flash "
          f"{L} x {len(reqs)} prefills, decode {L} x {st['steps']} steps); routes dropped per "
          f"prefill, summed over its {L} layers, as (prompt tokens, routes dropped of {L} x the "
          f"prompt tokens): {drops}; decode steps drop none", flush=True)

    bound = logit_bound(L)
    rel, agree, flips = {}, {}, {}
    for r, n in zip(reqs, lens):
        w, flips[n] = served_oracle_logits(cfg, params, r.prompt, r.out_tokens,
                                           routes[r.req_id])
        rel[n] = rel_diffs(kept[r.req_id], w, cfg.vocab_size)
        agree[n] = float(np.mean([int(x.argmax()) == t for x, t in zip(w, r.out_tokens)]))
        del w
    worst = {n: max(v) for n, v in rel.items()}
    print(f"[llama4 serve] every sampled token's logits against the no-cache oracle's (its MoE "
          f"as served: the calls cut as the engine's, each token at the expert the engine "
          f"chose), max |d| / max |logit|, worst per prompt "
          f"{dict((n, round(x, 5)) for n, x in worst.items())} (bound {bound:.4f}); greedy "
          f"agreement with the oracle per prompt {agree}; routes the oracle's own router would "
          f"have chosen otherwise, of {L} x (Lp + {LONG_MAX_NEW - 1}), and their largest gap "
          f"over the token's largest |router logit|: {flips}", flush=True)
    assert max(worst.values()) <= bound, (worst, bound)
    n_routes = {n: L * (n + LONG_MAX_NEW - 1) for n in lens}
    assert all(route_flips_ok(flips[n], n_routes[n], bound) for n in lens), (flips, bound)
    # control 0: the replay fed each decode step's routes from the next
    # request's row, on the shortest and a long prompt: its flips must fail
    # the near-tie check (the count limit alone would pass the long one)
    order = sorted(range(len(reqs)), key=lambda i: lens[i])
    wrong_rows = {}
    for i in (order[0], lens.index(LLAMA4_LONG[0])):
        r, other = reqs[i], reqs[(i + 1) % len(reqs)]
        _, wrong_rows[lens[i]] = served_oracle_logits(
            cfg, params, r.prompt, r.out_tokens,
            decode_routes_of(routes[r.req_id], routes[other.req_id], lens[i], L))
    print(f"[llama4 serve] control: each decode step's routes taken from the next request's "
          f"row, flips {wrong_rows} against a limit of {ROUTE_FLIP_SHARE:.0%} of the routes and "
          f"a gap of {2 * bound:.4f}", flush=True)
    assert not any(route_flips_ok(f, n_routes[n], bound) for n, f in wrong_rows.items()), (
        wrong_rows, bound)
    assert all(f["gap"] > 2 * bound for f in wrong_rows.values()), (wrong_rows, bound)
    # control 1: the oracle without the chunk mask (local layers full causal)
    control = {}
    with local_mask_dropped():
        for r, n in zip(reqs, lens):
            if n in LLAMA4_LONG:
                w, _ = served_oracle_logits(cfg, params, r.prompt, r.out_tokens,
                                            routes[r.req_id])
                control[n] = max(rel_diffs(kept[r.req_id], w, cfg.vocab_size))
    # control 2: the reference's linear ring order in the engine's prefill
    long_prompts = [p for p in batch if len(p) in LLAMA4_LONG]
    eng_lin = GenerationEngine(cfg, params=params, device="cuda", max_batch=8,
                               max_seq=LLAMA4_MAX_SEQ)
    lroutes = {}
    with linear_ring_order():
        lreqs, lkept, _ = serve_long(eng_lin, long_prompts, routes=lroutes)
    linear = {}
    for r in lreqs:
        w, _ = served_oracle_logits(cfg, params, r.prompt, r.out_tokens, lroutes[r.req_id])
        d = rel_diffs(lkept[r.req_id], w, cfg.vocab_size)
        linear[len(r.prompt)] = {"worst": max(d), "first": d[0], "last": d[-1]}
    del eng_lin, lkept
    print(f"[llama4 serve] controls against the bound {bound:.4f}: the oracle with the chunk "
          f"mask dropped, worst per prompt {dict((n, round(x, 5)) for n, x in control.items())}; "
          f"the reference's linear ring order, {{Lp: worst, first token, last token}} "
          f"{ {n: tuple(round(x, 5) for x in v.values()) for n, v in linear.items()} }",
          flush=True)
    assert all(x > bound for x in control.values()), (control, bound)
    assert all(v["worst"] > bound for v in linear.values()), (linear, bound)
    # a decode step of 8 rows at position 12000: all 16 experts of each layer
    # run (dropless, C = 8), so it reads every weight but the embedding table
    step_pos = 12000
    wall_ms, busy_ms = decode_step_times(cfg, params, eng.cache, step_pos)
    embed = params["embed"]["table"]
    kv_bytes = kv_read_bytes(cfg, eng.cache, step_pos)
    step_bytes = weight_bytes - embed.numel() * embed.element_size() + kv_bytes
    bound_ms = step_bytes / HBM_BYTES_S * 1e3
    print(f"[llama4 serve] decode step (8 rows, position {step_pos}): wall {wall_ms:.2f} ms "
          f"(mean of 3); device busy {fmt_ms(busy_ms)} ms (CUDA events: each of the step's "
          f"{L // p + 2} pieces queued behind a spin, summed; mean of 3); bound {bound_ms:.2f} ms "
          f"({step_bytes / 1e9:.2f} GB: the weights but the embedding table, and the valid "
          f"K/V slots, {kv_bytes / 1e9:.3f} GB, at 3.35 TB/s)", flush=True)
    figures.update(peak_gib=peak, weight_gb=weight_bytes / 1e9, logit_bound=bound,
                   worst_rel=worst, rel=rel, greedy_agreement=agree, oracle_route_flips=flips,
                   oracle_route_flips_wrong_rows=wrong_rows,
                   dropped_routes_per_prefill=drops, chunk_dropped=control,
                   linear_order=linear, decode_step_wall_ms=wall_ms,
                   decode_step_busy_ms=busy_ms, decode_step_bound_ms=bound_ms)
    del eng, kept, params, leaves, embed
    gc.collect()
    torch.cuda.empty_cache()
    return launches, figures


MLA_MAX_SEQ = 8192
MLA_LONG = 6000


@contextlib.contextmanager
def rope_dropped_at_decode():
    """The control of phase 13's bound: decode steps run with identity rope
    tables, so each step's q_rope and its new k_rope go unrotated (the
    prefill's cached k_rope keep theirs)."""
    from repro_torch.models import transformer

    inputs = transformer.decode_inputs

    def unroped(cfg, caches, pos):
        out = inputs(cfg, caches, pos)
        cos, sin = out["rope"]
        return {**out, "rope": (torch.ones_like(cos), torch.zeros_like(sin))}

    transformer.decode_inputs = unroped
    try:
        yield
    finally:
        transformer.decode_inputs = inputs


def phase_minicpm3_serve(ka, kf, tk, prompts):
    """Phase 13: minicpm3 at full width and depth (62 layers of MLA, bf16
    weights drawn on the card), dense backend (``backend="paged"`` falls
    back), ``max_batch=8``, ``max_seq=8192``: phase 5's ten prompts
    (flattened, tokens modulo the vocab) and one of 6000 tokens, 32 new
    tokens each, prefilled padded to their buckets as in JAX. Every sampled
    token's logits against the no-cache oracle within ``logit_bound(62)``;
    the control (rope dropped at decode) above it on the long prompt.
    Reported: tokens/s, TTFT, TPOT, peak memory, a decode step's device
    busy against its wall and its bytes bound. Returns the launches of the
    served run and the figures."""
    from repro_torch.configs import get_arch
    from repro_torch.models import init_params
    from repro_torch.serving.engine import GenerationEngine
    from repro_torch.serving.segments import SegmentedPrompt

    cfg = get_arch("minicpm3-4b").replace(dtype="bfloat16")
    L = cfg.num_layers
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    leaves = list(_tensors(params))
    weight_bytes = sum(x.numel() * x.element_size() for x in leaves)
    print(f"[minicpm3 serve] {cfg.name} {cfg.dtype}, {L} layers: "
          f"{sum(x.numel() for x in leaves) / 1e9:.3f}B parameters ({weight_bytes / 1e9:.2f} GB) "
          f"drawn on the card in {time.perf_counter() - t0:.1f}s", flush=True)
    rng = np.random.default_rng(13)
    flat = [np.asarray(p.tokens if isinstance(p, SegmentedPrompt) else p) % cfg.vocab_size
            for p in prompts]
    batch = flat + [rng.integers(0, cfg.vocab_size, MLA_LONG)]
    lens = [len(p) for p in batch]
    torch.cuda.reset_peak_memory_stats()
    eng = GenerationEngine(cfg, params=params, device="cuda", max_batch=8, max_seq=MLA_MAX_SEQ)
    entry = eng.cache[0]
    assert eng.backend == "dense" and set(entry) == {"c_kv", "k_rope"}
    assert entry["c_kv"].shape[2] == MLA_MAX_SEQ
    reset_launches(ka, kf, tk)
    reqs, kept, wall = serve_long(eng, batch)
    launches = read_launches(ka, kf, tk)
    st = eng.stats()
    figures = serve_figures(eng, reqs, wall)
    peak = torch.cuda.max_memory_allocated() / 2**30
    assert st["kernel"] == "cuda" and st["prefill_tokens"] == sum(lens), st
    assert all(0 <= t < cfg.vocab_size for r in reqs for t in r.out_tokens)
    assert all(bool(torch.isfinite(x).all()) for v in kept.values() for x in v)
    want = {n: 0 for n in launches}
    want["flash_attention"] = L * len(reqs)          # the absorbed decode is plain torch
    assert launches == want, (launches, want, st)
    print(f"[minicpm3 serve] {len(reqs)} requests (prompts {lens}, padded to their buckets), "
          f"{st['tokens_out']} tokens out in {wall:.3f}s = {figures['tokens_per_s']:.1f} tok/s; "
          f"mean TTFT {figures['ttft_mean_ms']:.1f}ms, p95 TPOT {figures['tpot_p95_ms']:.2f}ms; "
          f"{st['steps']} decode steps; peak memory {peak:.2f} GiB; launches {launches} (flash "
          f"{L} x {len(reqs)} prefills at head dims 96 / 64)", flush=True)
    bound = logit_bound(L)
    rel, agree = {}, {}
    for r, n in zip(reqs, lens):
        w = oracle_logits(cfg, params, r.prompt, r.out_tokens)
        rel[n] = rel_diffs(kept[r.req_id], w, cfg.vocab_size)
        agree[n] = float(np.mean([int(x.argmax()) == t for x, t in zip(w, r.out_tokens)]))
        del w
    worst = {n: max(v) for n, v in rel.items()}
    print(f"[minicpm3 serve] every sampled token's logits against the no-cache oracle's, max "
          f"|d| / max |logit|, worst per prompt {dict((n, round(x, 5)) for n, x in worst.items())} "
          f"(bound {bound:.4f}); greedy agreement with the oracle per prompt {agree}", flush=True)
    assert max(worst.values()) <= bound, (worst, bound)
    # control: rope dropped at decode, on the long prompt and two short ones
    control_batch = [batch[-1]] + flat[:2]
    eng_c = GenerationEngine(cfg, params=params, device="cuda", max_batch=8,
                             max_seq=MLA_MAX_SEQ)
    with rope_dropped_at_decode():
        creqs, ckept, _ = serve_long(eng_c, control_batch)
    control = {}
    for r in creqs:
        d = rel_diffs(ckept[r.req_id], oracle_logits(cfg, params, r.prompt, r.out_tokens),
                      cfg.vocab_size)
        control[len(r.prompt)] = {"worst": max(d), "first": d[0], "last": d[-1]}
    del eng_c, ckept
    print(f"[minicpm3 serve] control against the bound {bound:.4f}, rope dropped at decode: "
          f"{{Lp: worst, first token, last token}} "
          f"{ {n: tuple(round(x, 5) for x in v.values()) for n, v in control.items()} }",
          flush=True)
    assert control[MLA_LONG]["worst"] > bound, (control, bound)
    step_pos = MLA_LONG
    wall_ms, busy_ms = decode_step_times(cfg, params, eng.cache, step_pos)
    embed = params["embed"]["table"]
    kv_bytes = sum(t[:, :, :step_pos + 1].numel() * t.element_size() for t in entry.values())
    step_bytes = weight_bytes - embed.numel() * embed.element_size() + kv_bytes
    bound_ms = step_bytes / HBM_BYTES_S * 1e3
    print(f"[minicpm3 serve] decode step (8 rows, position {step_pos}): wall {wall_ms:.2f} ms "
          f"(mean of 3); device busy {fmt_ms(busy_ms)} ms (CUDA events: each of the step's "
          f"{L + 2} pieces queued behind a spin, summed; mean of 3); bound {bound_ms:.2f} ms "
          f"({step_bytes / 1e9:.2f} GB: the weights but the embedding table, and the latents "
          f"of the valid slots, {kv_bytes / 1e9:.3f} GB, at 3.35 TB/s)", flush=True)
    figures.update(peak_gib=peak, weight_gb=weight_bytes / 1e9, logit_bound=bound,
                   worst_rel=worst, rel=rel, greedy_agreement=agree, rope_dropped=control,
                   decode_step_wall_ms=wall_ms, decode_step_busy_ms=busy_ms,
                   decode_step_bound_ms=bound_ms)
    del eng, kept, params, leaves, embed, entry
    gc.collect()
    torch.cuda.empty_cache()
    return launches, figures


# ---------------------------------------------------------------------------
# phase 8: serve rwkv6-7b at full width
# ---------------------------------------------------------------------------


def phase_rwkv_serve(ka, kf, tk, prompts):
    """Serve phase 5's prompts (flattened, tokens modulo the vocab) on
    rwkv6-7b in bfloat16 with random weights from seed 0, through
    ``backend="paged"``, which falls back to the dense backend. Returns the
    six kernels' launches in the run."""
    from repro_torch.configs import get_arch
    from repro_torch.models import init_params, prefill
    from repro_torch.serving.engine import GenerationEngine
    from repro_torch.serving.segments import SegmentedPrompt

    cfg = get_arch("rwkv6-7b").replace(dtype="bfloat16")
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    n_params = sum(x.numel() for x in _tensors(params))
    torch.cuda.synchronize()
    print(f"[rwkv serve] {cfg.name} {cfg.dtype}: {n_params / 1e9:.3f}B parameters "
          f"({sum(x.numel() * x.element_size() for x in _tensors(params)) / 2**30:.2f} GiB) "
          f"drawn on the card in {time.perf_counter() - t0:.1f}s", flush=True)
    torch.cuda.reset_peak_memory_stats()
    eng = GenerationEngine(cfg, params=params, device="cuda", backend="paged",
                           max_batch=8, max_seq=2048)
    assert eng.backend == "dense", eng.backend
    resident = torch.cuda.memory_allocated() / 2**30
    flat = [np.asarray(p.tokens if isinstance(p, SegmentedPrompt) else p) % cfg.vocab_size
            for p in prompts]
    reset_launches(ka, kf, tk)
    t0 = time.perf_counter()
    reqs = [eng.submit(p, max_new=32) for p in flat]
    eng.run_until_done()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(ka, kf, tk)
    st, lat = eng.stats(), eng.latency_summary()
    assert st["backend"] == "dense" and st["kernel"] == "cuda", st
    assert all(len(r.out_tokens) == 32 for r in reqs), [len(r.out_tokens) for r in reqs]
    assert all(0 <= t < cfg.vocab_size for r in reqs for t in r.out_tokens)
    assert st["prefill_tokens"] == sum(len(p) for p in flat), st   # unpadded prefills
    want = {n: 0 for n in launches}
    want["rwkv6_chunked"] = cfg.num_layers * (len(reqs) + st["steps"])
    assert launches == want, (launches, want, st)
    peak = torch.cuda.max_memory_allocated() / 2**30
    state = eng.cache[0]["state"]
    print(f"[rwkv serve] {len(reqs)} requests (prompts {min(map(len, flat))}-"
          f"{max(map(len, flat))} tokens), {st['tokens_out']} tokens out in {wall:.3f}s = "
          f"{st['tokens_out'] / wall:.1f} tok/s (prefill tokens {st['prefill_tokens']}, "
          f"unpadded); mean TTFT {1e3 * lat['ttft_mean']:.1f}ms, p95 TPOT "
          f"{1e3 * lat.get('tpot_p95', 0):.2f}ms; {st['steps']} decode steps; peak memory "
          f"{peak:.2f} GiB ({resident:.2f} GiB resident before serving, state cache "
          f"{state.numel() * 4 / 2**30:.3f} GiB of it); launches "
          f"{launches} ({cfg.num_layers} x ({len(reqs)} prefills + {st['steps']} decode "
          f"steps))", flush=True)
    # where a decode step's time goes: 8 fresh 300-token requests admitted
    # (and prefilled) in one step, then three decode steps of 8 rows
    rng = np.random.default_rng(1)
    for _ in range(8):
        eng.submit(rng.integers(0, cfg.vocab_size, 300), max_new=40)
    eng.step()
    kinds, wall_ms, dev_ms, n_launch = step_profile(eng, 3)
    assert set(kinds) == {"dense"} and not eng.waiting, kinds
    eng.run_until_done()
    print(f"[rwkv serve] decode step (8 rows): wall {wall_ms:.2f} ms (mean of 3, profiler off); "
          f"device busy {dev_ms:.2f} ms, {n_launch:.0f} kernel launches (torch.profiler, "
          f"mean of 3)", flush=True)
    # the full-width stack gives finite logits of the expected shape, and
    # the engine's first token is the greedy token of the unpadded prefill
    toks = torch.as_tensor(flat[0], dtype=torch.int32, device="cuda")
    with torch.no_grad():
        last, cache = prefill(cfg, params, {"tokens": toks[None]})
    hd = cfg.rwkv_head_dim
    assert tuple(last.shape) == (1, cfg.padded_vocab)
    assert tuple(cache[0]["state"].shape) == (cfg.num_layers, 1, cfg.d_model // hd, hd, hd)
    assert bool(torch.isfinite(last.float()).all())
    assert bool(torch.isfinite(cache[0]["state"]).all())
    assert int(last[0].float().argmax()) == reqs[0].out_tokens[0], (
        int(last[0].float().argmax()), reqs[0].out_tokens[0])
    del eng, params, cache
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 9: serve hymba-1.5b at full width
# ---------------------------------------------------------------------------


def phase_hymba_serve(ka, kf, tk, prompts):
    """Serve phase 5's prompts (flattened, tokens modulo the vocab) on
    hymba-1.5b in bfloat16 with random weights from seed 0, through
    ``backend="paged"``, which falls back to the dense backend. Returns the
    seven kernels' launches in the run."""
    from repro_torch.configs import get_arch
    from repro_torch.models import init_params, prefill
    from repro_torch.serving.engine import GenerationEngine
    from repro_torch.serving.segments import SegmentedPrompt

    cfg = get_arch("hymba-1.5b").replace(dtype="bfloat16")
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    n_params = sum(x.numel() for x in _tensors(params))
    torch.cuda.synchronize()
    print(f"[hymba serve] {cfg.name} {cfg.dtype}: {n_params / 1e9:.3f}B parameters "
          f"({sum(x.numel() * x.element_size() for x in _tensors(params)) / 2**30:.2f} GiB) "
          f"drawn on the card in {time.perf_counter() - t0:.1f}s", flush=True)
    torch.cuda.reset_peak_memory_stats()
    eng = GenerationEngine(cfg, params=params, device="cuda", backend="paged",
                           max_batch=8, max_seq=2048)
    assert eng.backend == "dense", eng.backend
    resident = torch.cuda.memory_allocated() / 2**30
    cache_gib = sum(x.numel() * x.element_size() for x in eng.cache[0].values()) / 2**30
    flat = [np.asarray(p.tokens if isinstance(p, SegmentedPrompt) else p) % cfg.vocab_size
            for p in prompts]
    reset_launches(ka, kf, tk)
    t0 = time.perf_counter()
    reqs = [eng.submit(p, max_new=32) for p in flat]
    eng.run_until_done()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(ka, kf, tk)
    st, lat = eng.stats(), eng.latency_summary()
    assert st["backend"] == "dense" and st["kernel"] == "cuda", st
    assert all(len(r.out_tokens) == 32 for r in reqs), [len(r.out_tokens) for r in reqs]
    assert all(0 <= t < cfg.vocab_size for r in reqs for t in r.out_tokens)
    assert st["prefill_tokens"] == sum(len(p) for p in flat), st   # unpadded prefills
    want = {n: 0 for n in launches}
    want["ssm_scan"] = cfg.num_layers * (len(reqs) + st["steps"])
    want["flash_attention"] = cfg.num_layers * len(reqs)
    want["decode_attention"] = cfg.num_layers * st["steps"]
    assert launches == want, (launches, want, st)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[hymba serve] {len(reqs)} requests (prompts {min(map(len, flat))}-"
          f"{max(map(len, flat))} tokens + {cfg.num_meta_tokens} meta), {st['tokens_out']} "
          f"tokens out in {wall:.3f}s = {st['tokens_out'] / wall:.1f} tok/s (prefill tokens "
          f"{st['prefill_tokens']}, unpadded); mean TTFT {1e3 * lat['ttft_mean']:.1f}ms, p95 "
          f"TPOT {1e3 * lat.get('tpot_p95', 0):.2f}ms; {st['steps']} decode steps; peak memory "
          f"{peak:.2f} GiB ({resident:.2f} GiB resident before serving, cache {cache_gib:.3f} "
          f"GiB of it: {eng.cache[0]['k'].shape[2]}-slot K/V rings and the SSM state); launches "
          f"{launches} (ssm_scan {cfg.num_layers} x ({len(reqs)} prefills + {st['steps']} "
          f"decode steps), flash {cfg.num_layers} x {len(reqs)}, decode {cfg.num_layers} x "
          f"{st['steps']})", flush=True)
    # where a decode step's time goes: 8 fresh 300-token requests admitted
    # (and prefilled) in one step, then three decode steps of 8 rows
    rng = np.random.default_rng(1)
    for _ in range(8):
        eng.submit(rng.integers(0, cfg.vocab_size, 300), max_new=40)
    eng.step()
    kinds, wall_ms, dev_ms, n_launch = step_profile(eng, 3)
    assert set(kinds) == {"dense"} and not eng.waiting, kinds
    eng.run_until_done()
    print(f"[hymba serve] decode step (8 rows): wall {wall_ms:.2f} ms (mean of 3, profiler off); "
          f"device busy {dev_ms:.2f} ms, {n_launch:.0f} kernel launches (torch.profiler, "
          f"mean of 3)", flush=True)
    # the full-width stack gives finite logits of the expected shape, and
    # the engine's first token is the greedy token of the unpadded prefill
    toks = torch.as_tensor(flat[0], dtype=torch.int32, device="cuda")
    with torch.no_grad():
        last, cache = prefill(cfg, params, {"tokens": toks[None]})
    total = cfg.num_meta_tokens + len(flat[0])
    assert tuple(last.shape) == (1, cfg.padded_vocab)
    assert tuple(cache[0]["k"].shape) == (cfg.num_layers, 1, min(total, cfg.window),
                                          cfg.num_kv_heads, cfg.head_dim)
    assert tuple(cache[0]["h"].shape) == (cfg.num_layers, 1, cfg.d_model, cfg.ssm_state)
    assert bool(torch.isfinite(last[:, :cfg.vocab_size].float()).all())
    assert bool(torch.isfinite(cache[0]["h"]).all())
    assert int(last[0].float().argmax()) == reqs[0].out_tokens[0], (
        int(last[0].float().argmax()), reqs[0].out_tokens[0])
    del eng, params, cache
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 2i: the flash kernel's cross form (whisper); dense decode at G 1 and 7
# ---------------------------------------------------------------------------

WHISPER_HEADS = (20, 20, 64)                 # whisper-large-v3: H = KVH (MHA), hd
ENC_SEQ = 1500                               # whisper's encoder frames
CROSS_S = (1, 37, 448)                       # decoder queries: a step, a prompt, the context
INTERNVL2_HEADS = (14, 2, 64)                # internvl2-1b: G 7
# dense decode at G 1 over whisper's cross cache (all 1500 slots valid),
# and at internvl2's G 7 over a 2048-slot cache at lengths like phase 14's
# (256 patches, a prompt, the decoded tokens)
WHISPER_DECODE_CASES = {"cross_1500": [ENC_SEQ] * B}
INTERNVL2_SC = 2048
INTERNVL2_DECODE_CASES = {"patch_prefix": [2048, 1300, 257, 300, 1, 777, 290, 1100]}


def phase_cross_kernels(ka, kf):
    """Phase 2i: flash at whisper's heads (H 20 = KVH 20, hd 64, B 8): the
    cross form, S 1, 37 and 448 queries over 1500 keys, non-causal, and the
    encoder's causal S 1500, in f32 and bf16, each against its plain
    version and timed beside its bound and an SDPA call on the same
    tensors; then dense decode at G 1 over whisper's 1500-slot cross cache
    and at internvl2's G 7 (``phase_swa_decode_kernel``). Returns (cross
    rows, encoder rows, decode rows)."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(43)
    Hq, Hkv, hd = WHISPER_HEADS
    draw = lambda S, n, dt: torch.randn((B, S, n, hd), generator=gen, device="cuda").to(dt)
    cross_rows, enc_rows = {}, {}
    for S in CROSS_S:
        for dtype_name in ("float32", "bfloat16"):
            dt = getattr(torch, dtype_name)
            q, k, v = draw(S, Hq, dt), draw(ENC_SEQ, Hkv, dt), draw(ENC_SEQ, Hkv, dt)
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            lib = lambda: F.scaled_dot_product_attention(qt, kt, vt)
            name = (f"flash_attention[{dtype_name}, cross, B={B}, H={Hq}, KVH={Hkv}, hd={hd}, "
                    f"S={S}, S_kv={ENC_SEQ}]")
            cross_rows[(dtype_name, S)] = flash_case(
                kf, name, dtype_name, q, k, v, True, lib, flash_work(q, k, v, causal=False),
                5, causal=False)
            del q, k, v, qt, kt, vt, lib
    for dtype_name in ("float32", "bfloat16"):
        dt = getattr(torch, dtype_name)
        q, k, v = draw(ENC_SEQ, Hq, dt), draw(ENC_SEQ, Hkv, dt), draw(ENC_SEQ, Hkv, dt)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        lib = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        name = (f"flash_attention[{dtype_name}, encoder, B={B}, H={Hq}, hd={hd}, S={ENC_SEQ}, "
                f"causal]")
        enc_rows[dtype_name] = flash_case(
            kf, name, dtype_name, q, k, v, True, lib,
            flash_work(q, k, v), 5)
        del q, k, v, qt, kt, vt, lib
    torch.cuda.empty_cache()
    decode_rows = phase_swa_decode_kernel(ka, WHISPER_HEADS, ENC_SEQ, WHISPER_DECODE_CASES,
                                          seed=47)
    decode_rows.update(phase_swa_decode_kernel(ka, INTERNVL2_HEADS, INTERNVL2_SC,
                                               INTERNVL2_DECODE_CASES, seed=53))
    return cross_rows, enc_rows, decode_rows


# ---------------------------------------------------------------------------
# the model API over rows of patch embeddings or frames (phases 4g, 14, 15)
# ---------------------------------------------------------------------------


def prefill_rows(cfg, params, rows, Sc):
    """Each row's batch (B = 1: tokens, with patch embeddings or frames)
    through ``prefill``, its cache written into row b of a fresh
    ``init_cache`` of Sc slots as the engine writes a prefill
    (``_merge_cache``: the self-attention entries at their first slots, the
    cross entries whole). Returns (the prefills' logits (B, V)
    float32, the cache, each prefill's seconds, host clock around it and a
    synchronize)."""
    from repro_torch.models import init_cache, prefill
    from repro_torch.serving.engine import _merge_cache

    cache = init_cache(cfg, len(rows), Sc, rows[0]["tokens"].device)
    first, secs = [], []
    with torch.no_grad():
        for b, batch in enumerate(rows):
            if rows[0]["tokens"].is_cuda:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            last, pc = prefill(cfg, params, batch)
            _merge_cache(cache, pc, b)
            if rows[0]["tokens"].is_cuda:
                torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            first.append(last[0].float())
            del pc
    return torch.stack(first), cache, secs


def decode_rows(cfg, params, cache, first, pos0, n_new, forced=None):
    """n_new - 1 batched ``decode_step`` calls after the prefills' logits
    ``first`` (B, V): step i feeds row b's token i at absolute position
    pos0[b] + i and yields the logits of token i + 1. Tokens are greedy, or
    ``forced`` (B, n_new) (teacher-forced). Returns (tokens (B, n_new) on
    the host, logits (B, n_new, V) float32, each step's seconds)."""
    from repro_torch.models import decode_step

    dev = first.device
    pick = (lambda i, lg: lg.argmax(-1)) if forced is None else \
        (lambda i, lg: forced[:, i].to(dev))
    toks, logits, secs = [pick(0, first)], [first], []
    pos0 = torch.as_tensor(pos0, dtype=torch.int32, device=dev)
    with torch.no_grad():
        for i in range(n_new - 1):
            if dev.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            step, _ = decode_step(cfg, params, cache, toks[-1][:, None].to(torch.int32),
                                  pos0 + i)
            toks.append(pick(i + 1, step))
            if dev.type == "cuda":
                torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            logits.append(step.float())
    return torch.stack(toks, 1).cpu(), torch.stack(logits, 1), secs


# ---------------------------------------------------------------------------
# phase 4g: internvl2, whisper and the int8 dense cache, CPU against card
# ---------------------------------------------------------------------------

ZOO_NEW = 12
# the int8 cache's logits: the float K/V differ by summation order between
# the CPU and the card, so a code may land one apart (one code of a V entry
# moves the smoke model's logits by ~4e-4; tests/test_torch_int8_dense.py)
CODE_LOGIT_TOL = (1e-3, 1e-3)


def phase_zoo_parity(ka, kf):
    """Phase 4g: the internvl2 (16 patch embeddings a row) and whisper (64
    frames a row) smoke models through the model API (``prefill`` of four
    37-token rows, then ``decode_step`` at absolute positions, greedy, 12
    tokens), and the smollm smoke engine on the int8 dense cache
    (``backend="dense"``, ``kv_cache_quant``), in float32 on the CPU (plain
    versions) and on the card (kernels): identical greedy tokens, every
    sampled token's logits within ``PARITY_LOGIT_TOL`` (the int8 engine's
    within ``CODE_LOGIT_TOL``), its caches' codes within one and scales
    within 1e-5; ``quantize_kv`` on the card equal to the CPU's bit for
    bit; one flash a layer and prefill, plus one a decoder layer for the
    cross form and one an encoder layer; one dense decode a layer and step,
    plus one a decoder layer for cross attention. Returns {case: max |d| of
    the logits}."""
    from repro_torch.configs import get_arch, smoke_variant
    from repro_torch.models import init_params
    from repro_torch.models.transformer import quantize_kv
    from repro_torch.serving.engine import GenerationEngine

    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 products
    torch.backends.cudnn.allow_tf32 = False
    worst = {}
    for arch in ("internvl2-1b", "whisper-large-v3"):
        cfg = smoke_variant(get_arch(arch))
        rng = np.random.default_rng(7)
        n_rows, Lp, P = 4, 37, cfg.num_patch_tokens
        batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (n_rows, Lp))
                                            .astype(np.int32))}
        extra = "patch_embeds" if P else "frames"
        n_extra = P if P else cfg.encoder_seq
        batch[extra] = torch.from_numpy(rng.standard_normal((n_rows, n_extra, cfg.d_model))
                                        .astype(np.float32))
        out = {}
        for dev in ("cpu", "cuda"):
            params = init_params(cfg, torch.Generator().manual_seed(0), dev)
            rows = [{k: t[b:b + 1].to(dev) for k, t in batch.items()} for b in range(n_rows)]
            ka.reset_launch_counts()
            kf.reset_launch_counts()
            first, cache, _ = prefill_rows(cfg, params, rows, P + Lp + ZOO_NEW)
            toks, logits, _ = decode_rows(cfg, params, cache, first, [P + Lp] * n_rows, ZOO_NEW)
            out[dev] = (toks, logits.cpu())
        L, cross = cfg.num_layers, 2 if cfg.is_encoder_decoder else 1
        launches = (kf.flash_attention.launches, ka.decode_attention.launches)
        want = ((cross * L + cfg.encoder_layers) * n_rows, cross * L * (ZOO_NEW - 1))
        assert launches == want, (arch, launches, want)
        if not torch.equal(out["cpu"][0], out["cuda"][0]):
            raise AssertionError(f"{arch} smoke model: CPU and GPU greedy tokens differ:\n"
                                 f"{out['cpu'][0]}\n{out['cuda'][0]}")
        atol, rtol = PARITY_LOGIT_TOL
        torch.testing.assert_close(out["cuda"][1], out["cpu"][1], atol=atol, rtol=rtol)
        worst[arch] = float((out["cuda"][1] - out["cpu"][1]).abs().max())
        print(f"[parity] {cfg.name} model API f32 ({n_rows} rows of {Lp} tokens behind "
              f"{n_extra} {extra}, {ZOO_NEW} greedy tokens): identical tokens on cpu (plain) and "
              f"cuda (kernels), logits within max |d| {worst[arch]:.3e} (atol, rtol "
              f"{PARITY_LOGIT_TOL}); flash/decode launches {launches}", flush=True)
    # the int8 dense cache: the quantizer bit for bit on the same K/V
    x = torch.randn((8, 300, 2, 64), generator=torch.Generator().manual_seed(9)) * 5.0
    x[0, :5] = 0.0
    qc, sc = quantize_kv(x)
    qg, sg = quantize_kv(x.cuda())
    assert torch.equal(qg.cpu(), qc) and torch.equal(sg.cpu(), sc)
    cfg = smoke_variant(get_arch("smollm-135m")).replace(kv_cache_quant=True)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (5, 40, 64, 100, 128, 150, 200)]
    out, logits, caches = {}, {}, {}
    for dev in ("cpu", "cuda"):
        params = init_params(cfg, torch.Generator().manual_seed(0), dev)
        eng = GenerationEngine(cfg, params=params, device=dev, backend="dense", max_batch=4,
                               max_seq=256)
        assert eng.cache[0]["k"].dtype == torch.int8
        ka.reset_launch_counts()
        kf.reset_launch_counts()
        with keep_step_logits(eng) as kept:
            reqs = [eng.submit(p, max_new=ZOO_NEW) for p in prompts]
            eng.run_until_done()
        assert all(len(r.out_tokens) == ZOO_NEW for r in reqs)
        out[dev] = [r.out_tokens for r in reqs]
        logits[dev] = [torch.stack(kept[r.req_id]).cpu() for r in reqs]
        caches[dev] = {n: t.cpu() for n, t in eng.cache[0].items()}
    launches = (kf.flash_attention.launches, ka.decode_attention.launches)
    L = cfg.num_layers
    assert launches == (L * len(prompts), L * eng.steps), launches
    if out["cpu"] != out["cuda"]:
        raise AssertionError(f"int8 dense smoke engine: CPU and GPU greedy tokens differ:\n"
                             f"{out['cpu']}\n{out['cuda']}")
    atol, rtol = CODE_LOGIT_TOL
    for a, b in zip(logits["cuda"], logits["cpu"]):
        torch.testing.assert_close(a, b, atol=atol, rtol=rtol)
    codes = max(int((caches["cuda"][n].int() - caches["cpu"][n].int()).abs().max())
                for n in ("k", "v"))
    assert codes <= 1, codes
    for n in ("k_scale", "v_scale"):
        torch.testing.assert_close(caches["cuda"][n], caches["cpu"][n], rtol=1e-5, atol=0)
    worst["int8_dense_engine"] = max(float((a - b).abs().max())
                                     for a, b in zip(logits["cuda"], logits["cpu"]))
    print(f"[parity] {cfg.name} int8 dense cache f32: quantize_kv bit for bit on the card and "
          f"the CPU; engine of {len(prompts)} requests: identical greedy tokens, logits within "
          f"max |d| {worst['int8_dense_engine']:.3e} (atol, rtol {CODE_LOGIT_TOL}), codes within "
          f"{codes}, scales within 1e-5 relative; flash/decode launches {launches}", flush=True)
    return worst


# ---------------------------------------------------------------------------
# phase 10b: qwen2.5-3b-swa on the int8 dense cache
# ---------------------------------------------------------------------------


def weight_bytes_read(cfg, params, leaves):
    """Bytes of the weights a decode step reads: every leaf but the
    embedding table (only B rows of it are looked up) unless the embeddings
    are tied (the unembedding then reads it whole), and no encoder weight."""
    total = sum(x.numel() * x.element_size() for x in leaves)
    skip = [] if cfg.tie_embeddings else [params["embed"]["table"]]
    if cfg.is_encoder_decoder:
        skip += list(_tensors([params["enc_blocks"], params["enc_final_norm"],
                               params["frame_proj"]]))
    return total - sum(x.numel() * x.element_size() for x in skip)


def phase_swa_int8_serve(ka, kf, tk, params, prompts, bf16_tokens, bf16_figures):
    """Phase 10b: qwen2.5-3b-swa with ``kv_cache_quant`` at full width and
    depth on phase 10's weights and prompts (rings of 4096 slots), dense
    backend: the ring's bytes (int8 codes and float32 scales) are (128 + 4)
    / 256 of the bf16 ring's; reported: tokens/s, greedy agreement with
    phase 10's bf16 run, and a decode step's busy against its bytes bound
    (the whole ring is dequantized every step, as in JAX, so the step is
    expected to cost more than the bf16 ring's). Returns the launches and
    the figures."""
    from repro_torch.configs import get_arch
    from repro_torch.serving.engine import GenerationEngine

    cfg = get_arch("qwen2.5-3b-swa").replace(dtype="bfloat16", kv_cache_quant=True)
    L = cfg.num_layers
    batch = swa_batch(cfg, prompts)
    eng = GenerationEngine(cfg, params=params, device="cuda", backend="dense", max_batch=8,
                           max_seq=8192)
    entry = eng.cache[0]
    assert entry["k"].dtype == torch.int8 and entry["k"].shape[2] == WIN
    int8_bytes = sum(t.numel() * t.element_size() for t in entry.values())
    bf16_bytes = 2 * entry["k"].numel() * 2
    ratio = int8_bytes / bf16_bytes
    assert ratio == (cfg.head_dim + 4) / (2 * cfg.head_dim) == 0.515625, ratio
    reset_launches(ka, kf, tk)
    reqs, kept, wall = serve_long(eng, batch)
    launches = read_launches(ka, kf, tk)
    st = eng.stats()
    figures = serve_figures(eng, reqs, wall)
    want = {n: 0 for n in launches}
    want["flash_attention"] = L * len(reqs)
    want["decode_attention"] = L * st["steps"]
    assert launches == want, (launches, want, st)
    assert all(0 <= t < cfg.vocab_size for r in reqs for t in r.out_tokens)
    assert all(bool(torch.isfinite(x).all()) for v in kept.values() for x in v)
    del kept
    agree = {len(p): agreement([r.out_tokens], [t])
             for p, r, t in zip(batch, reqs, bf16_tokens)}
    step_pos = 6000
    wall_ms, busy_ms = decode_step_times(cfg, params, eng.cache, step_pos)
    kv_bytes = kv_read_bytes(cfg, eng.cache, step_pos)
    step_bytes = weight_bytes_read(cfg, params, list(_tensors(params))) + kv_bytes
    bound_ms = step_bytes / HBM_BYTES_S * 1e3
    print(f"[swa int8 serve] {cfg.name} {cfg.dtype} on the int8 dense cache ({WIN}-slot rings: "
          f"{int8_bytes / 1e9:.3f} GB of codes and scales, {ratio:.6f} of the bf16 rings' "
          f"{bf16_bytes / 1e9:.3f} GB): {len(reqs)} requests, {st['tokens_out']} tokens out in "
          f"{wall:.3f}s = {figures['tokens_per_s']:.1f} tok/s (bf16 rings, phase 10: "
          f"{bf16_figures['tokens_per_s']:.1f}); mean TTFT {figures['ttft_mean_ms']:.1f}ms, "
          f"p95 TPOT {figures['tpot_p95_ms']:.2f}ms; greedy agreement with phase 10's bf16 "
          f"run per prompt {agree}; launches {launches}", flush=True)
    print(f"[swa int8 serve] decode step (8 rows, position {step_pos}): wall {wall_ms:.2f} ms "
          f"(mean of 3); device busy {fmt_ms(busy_ms)} ms (bf16 rings, phase 10: "
          f"{fmt_ms(bf16_figures['decode_step_busy_ms'])} ms); bound {bound_ms:.2f} ms "
          f"({step_bytes / 1e9:.3f} GB: the weights but the embedding table, and the codes and "
          f"scales of the valid slots, {kv_bytes / 1e9:.3f} GB, at 3.35 TB/s)", flush=True)
    figures.update(cache_bytes=int8_bytes, bf16_cache_bytes=bf16_bytes, cache_ratio=ratio,
                   greedy_agreement_with_bf16=agree, decode_step_wall_ms=wall_ms,
                   decode_step_busy_ms=busy_ms, decode_step_bound_ms=bound_ms,
                   bf16_decode_step_busy_ms=bf16_figures["decode_step_busy_ms"])
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return launches, figures


# ---------------------------------------------------------------------------
# phases 14 and 15: internvl2-1b and whisper-large-v3 at full width and depth
# ---------------------------------------------------------------------------

API_NEW = 32
API_ROWS = 8
WHISPER_PROMPT_LENGTHS = (4, 17, 37, 64, 100, 129, 150, 200)   # within the 448-token context


def draw_weights(tag, cfg):
    """``init_params`` on the card from seed 0; prints what was drawn.
    Returns (params, leaves)."""
    from repro_torch.models import init_params

    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    leaves = list(_tensors(params))
    nbytes = sum(x.numel() * x.element_size() for x in leaves)
    print(f"[{tag}] {cfg.name} {cfg.dtype}, {cfg.num_layers} layers"
          f"{f' (+{cfg.encoder_layers} encoder layers)' if cfg.encoder_layers else ''}: "
          f"{sum(x.numel() for x in leaves) / 1e9:.3f}B parameters ({nbytes / 1e9:.2f} GB) drawn "
          f"on the card in {time.perf_counter() - t0:.1f}s", flush=True)
    return params, leaves


def api_figures(ttft_s, step_s, wall, n_tokens):
    """tokens/s of the rows' whole run; TTFT as if the rows were prefilled
    one after another (each row's is the sum of the prefills up to its
    own); TPOT the mean and p95 of a batched decode step."""
    ttft = np.cumsum(ttft_s)
    return {"tokens_per_s": n_tokens / wall, "wall_s": wall,
            "prefill_ms_mean": 1e3 * float(np.mean(ttft_s)),
            "ttft_mean_ms": 1e3 * float(np.mean(ttft)),
            "tpot_mean_ms": 1e3 * float(np.mean(step_s)),
            "tpot_p95_ms": 1e3 * float(np.percentile(step_s, 95))}


def held_to_oracle(tag, cfg, params, rows, tokens, logits, bound):
    """Every sampled token's logits (max |d| / max |logit| over the real
    vocabulary) against the no-cache oracle's; returns (worst per row, the
    oracle logits per row, greedy agreement with the oracle per row)."""
    worst, want, agree = [], [], []
    for b, batch in enumerate(rows):
        extra = {k: t for k, t in batch.items() if k != "tokens"}
        w = oracle_logits(cfg, params, batch["tokens"][0].cpu().numpy(), tokens[b].numpy(),
                          extra)
        worst.append(max(rel_diffs(logits[b], w, cfg.vocab_size)))
        agree.append(float(np.mean([int(x.argmax()) == t for x, t in zip(w, tokens[b].tolist())])))
        want.append(w)
    print(f"[{tag}] every sampled token's logits against the no-cache oracle's (forward of the "
          f"row's prompt and tokens so far), max |d| / max |logit|, worst per row "
          f"{[round(x, 5) for x in worst]} (bound {bound:.4f}); greedy agreement with the oracle "
          f"per row {agree}", flush=True)
    assert max(worst) <= bound, (worst, bound)
    return worst, want, agree


def control_worst(cfg, logits, want):
    return [max(rel_diffs(logits[b], want[b], cfg.vocab_size)) for b in range(len(want))]


def phase_internvl2_serve(ka, kf, tk, prompts):
    """Phase 14: internvl2-1b at full width and depth (24 layers, bf16
    weights drawn on the card). Each of 8 rows carries 256 patch embeddings
    drawn N(0, 1) from a seeded generator and one of phase 5's prompts
    (flattened, tokens modulo the vocab), prefilled through ``prefill``; the
    rows then decode together through ``decode_step`` at pos + 256, 32
    greedy tokens each. Every sampled token's logits within
    ``logit_bound(24)`` of the no-cache oracle (``forward`` with the same
    patches); the control (decode positions without the patch offset)
    above it. The engine serves the same prompts text only on the dense
    backend, held to the text-only oracle. Reported: tokens/s, TTFT, TPOT,
    a decode step's busy against its bytes bound. Returns the launches and
    the figures."""
    from repro_torch.configs import get_arch
    from repro_torch.serving.engine import GenerationEngine
    from repro_torch.serving.segments import SegmentedPrompt

    cfg = get_arch("internvl2-1b").replace(dtype="bfloat16")
    L, P = cfg.num_layers, cfg.num_patch_tokens
    params, leaves = draw_weights("internvl2 serve", cfg)
    flat = [np.asarray(p.tokens if isinstance(p, SegmentedPrompt) else p) % cfg.vocab_size
            for p in prompts][:API_ROWS]
    lens = [len(p) for p in flat]
    gen = torch.Generator(device="cuda").manual_seed(14)
    patches = torch.randn((API_ROWS, P, cfg.d_model), generator=gen, device="cuda")
    rows = [{"tokens": torch.as_tensor(p, dtype=torch.int32, device="cuda")[None],
             "patch_embeds": patches[b:b + 1]} for b, p in enumerate(flat)]
    Sc = P + max(lens) + API_NEW
    torch.cuda.reset_peak_memory_stats()
    reset_launches(ka, kf, tk)
    t0 = time.perf_counter()
    first, cache, ttft_s = prefill_rows(cfg, params, rows, Sc)
    tokens, logits, step_s = decode_rows(cfg, params, cache, first, [P + n for n in lens],
                                         API_NEW)
    wall = time.perf_counter() - t0
    launches = read_launches(ka, kf, tk)
    want = {n: 0 for n in launches}
    want["flash_attention"] = L * API_ROWS
    want["decode_attention"] = L * (API_NEW - 1)
    assert launches == want, (launches, want)
    assert int(tokens.min()) >= 0 and int(tokens.max()) < cfg.vocab_size
    assert bool(torch.isfinite(logits[..., :cfg.vocab_size]).all())
    figures = api_figures(ttft_s, step_s, wall, API_ROWS * API_NEW)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[internvl2 serve] model API: {API_ROWS} rows of {P} patch embeddings and prompts "
          f"{lens}, {API_NEW} greedy tokens each in {wall:.3f}s = {figures['tokens_per_s']:.1f} "
          f"tok/s; mean prefill {figures['prefill_ms_mean']:.1f}ms, mean TTFT (rows prefilled "
          f"in turn) {figures['ttft_mean_ms']:.1f}ms, TPOT mean {figures['tpot_mean_ms']:.2f}ms "
          f"p95 {figures['tpot_p95_ms']:.2f}ms; peak memory {peak:.2f} GiB; launches {launches} "
          f"(flash {L} x {API_ROWS} prefills, decode {L} x {API_NEW - 1} steps)", flush=True)
    bound = logit_bound(L)
    worst, want_logits, agree = held_to_oracle("internvl2 serve", cfg, params, rows, tokens,
                                               logits, bound)
    # control: the same tokens decoded at their text positions, without the
    # patch offset (the class of the reference's meta-token fault, ROADMAP §3)
    _, cache_c, _ = prefill_rows(cfg, params, rows, Sc)
    _, logits_c, _ = decode_rows(cfg, params, cache_c, first, lens, API_NEW, forced=tokens)
    control = control_worst(cfg, logits_c, want_logits)
    del cache_c, logits_c
    print(f"[internvl2 serve] control, decode without the patch offset: worst per row "
          f"{[round(x, 5) for x in control]} against the bound {bound:.4f} "
          f"({sum(x > bound for x in control)} of {API_ROWS} rows above)", flush=True)
    assert max(control) > bound, (control, bound)
    step_pos = Sc - 1
    wall_ms, busy_ms = decode_step_times(cfg, params, cache, step_pos)
    kv_bytes = kv_read_bytes(cfg, cache, step_pos)
    step_bytes = weight_bytes_read(cfg, params, leaves) + kv_bytes
    bound_ms = step_bytes / HBM_BYTES_S * 1e3
    print(f"[internvl2 serve] decode step (8 rows, position {step_pos}): wall {wall_ms:.2f} ms "
          f"(mean of 3); device busy {fmt_ms(busy_ms)} ms (CUDA events, {L + 2} pieces behind "
          f"spins, summed; mean of 3); bound {bound_ms:.3f} ms ({step_bytes / 1e9:.3f} GB: the "
          f"weights with the tied table the unembedding reads, and the K/V of the valid slots, "
          f"{kv_bytes / 1e9:.3f} GB, at 3.35 TB/s)", flush=True)
    del cache, logits, want_logits
    # the engine: the same prompts text only, padded to their buckets
    eng = GenerationEngine(cfg, params=params, device="cuda", max_batch=8, max_seq=2048)
    assert eng.backend == "dense"
    reset_launches(ka, kf, tk)
    reqs, kept, ewall = serve_long(eng, flat)
    elaunches = read_launches(ka, kf, tk)
    st = eng.stats()
    efigures = serve_figures(eng, reqs, ewall)
    ewant = {n: 0 for n in elaunches}
    ewant["flash_attention"] = L * len(reqs)
    ewant["decode_attention"] = L * st["steps"]
    assert elaunches == ewant, (elaunches, ewant)
    text_rel = [max(rel_diffs(kept[r.req_id], oracle_logits(cfg, params, r.prompt, r.out_tokens),
                              cfg.vocab_size)) for r in reqs]
    print(f"[internvl2 serve] engine, text only (dense backend, prompts padded to their "
          f"buckets): {len(reqs)} requests, {st['tokens_out']} tokens out in {ewall:.3f}s = "
          f"{efigures['tokens_per_s']:.1f} tok/s; mean TTFT {efigures['ttft_mean_ms']:.1f}ms, "
          f"p95 TPOT {efigures['tpot_p95_ms']:.2f}ms; against the text-only oracle, worst per "
          f"request {[round(x, 5) for x in text_rel]} (bound {bound:.4f}); launches {elaunches}",
          flush=True)
    assert max(text_rel) <= bound, (text_rel, bound)
    figures.update(prompt_lengths=lens, peak_gib=peak, logit_bound=bound, worst_rel=worst,
                   greedy_agreement=agree, no_patch_offset=control,
                   decode_step_wall_ms=wall_ms, decode_step_busy_ms=busy_ms,
                   decode_step_bound_ms=bound_ms, engine_text_only=efigures,
                   engine_text_only_worst_rel=text_rel)
    del eng, kept, params, leaves, patches, rows
    gc.collect()
    torch.cuda.empty_cache()
    return {"model_api": launches, "engine": elaunches}, figures


def phase_whisper_serve(ka, kf, tk):
    """Phase 15: whisper-large-v3 at full width and depth (32 decoder and
    32 encoder layers, bf16 weights drawn on the card). Each of 8 rows
    carries 1500 frames drawn N(0, 1) and a decoder prompt of 4 to 200
    tokens, prefilled through ``prefill`` (the encoder, then the decoder
    with its cross keys and values), then decoding 32 greedy tokens
    together through ``decode_step``. Every sampled token's logits within
    ``logit_bound(2 * 32)`` of the no-cache oracle (``forward`` with the
    same frames): each decoder layer's self and cross attention run other
    kernels in the two paths (flash against dense decode), and the encoder
    runs the same kernels on the same frames in both (asserted: two runs of
    ``_encode`` agree bit for bit), so it adds nothing. The control (each
    row's cross attention reading the next row's ``ck``/``cv``) above it.
    Reported: tokens/s, TTFT, TPOT, the encoder's share of a prefill, a
    decode step's busy against its bytes bound. Returns the launches and
    the figures."""
    from repro_torch.configs import get_arch
    from repro_torch.models.model import _encode

    cfg = get_arch("whisper-large-v3").replace(dtype="bfloat16")
    L, Le = cfg.num_layers, cfg.encoder_layers
    params, leaves = draw_weights("whisper serve", cfg)
    rng = np.random.default_rng(15)
    lens = list(WHISPER_PROMPT_LENGTHS)
    gen = torch.Generator(device="cuda").manual_seed(15)
    frames = torch.randn((API_ROWS, cfg.encoder_seq, cfg.d_model), generator=gen, device="cuda")
    rows = [{"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size, n), dtype=torch.int32,
                                       device="cuda")[None],
             "frames": frames[b:b + 1]} for b, n in enumerate(lens)]
    Sc = max(lens) + API_NEW
    assert Sc <= 448                                      # whisper's text context
    torch.cuda.reset_peak_memory_stats()
    reset_launches(ka, kf, tk)
    t0 = time.perf_counter()
    first, cache, ttft_s = prefill_rows(cfg, params, rows, Sc)
    prefilled = tuple({name: t.clone() for name, t in entry.items()}   # for the control
                      for entry in cache)
    tokens, logits, step_s = decode_rows(cfg, params, cache, first, lens, API_NEW)
    wall = time.perf_counter() - t0
    launches = read_launches(ka, kf, tk)
    want = {n: 0 for n in launches}
    want["flash_attention"] = (2 * L + Le) * API_ROWS
    want["decode_attention"] = 2 * L * (API_NEW - 1)
    assert launches == want, (launches, want)
    assert int(tokens.min()) >= 0 and int(tokens.max()) < cfg.vocab_size
    assert bool(torch.isfinite(logits[..., :cfg.vocab_size]).all())
    figures = api_figures(ttft_s, step_s, wall, API_ROWS * API_NEW)
    peak = torch.cuda.max_memory_allocated() / 2**30
    with torch.no_grad():
        enc_s = []
        for b in range(API_ROWS):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            enc = _encode(cfg, params, frames[b:b + 1])
            torch.cuda.synchronize()
            enc_s.append(time.perf_counter() - t1)
        assert torch.equal(enc, _encode(cfg, params, frames[-1:]))    # deterministic
        del enc
    share = float(np.mean(enc_s) / np.mean(ttft_s))
    print(f"[whisper serve] model API: {API_ROWS} rows of {cfg.encoder_seq} frames and prompts "
          f"{lens}, {API_NEW} greedy tokens each in {wall:.3f}s = {figures['tokens_per_s']:.1f} "
          f"tok/s; mean prefill {figures['prefill_ms_mean']:.1f}ms (the encoder "
          f"{1e3 * np.mean(enc_s):.1f}ms of it, share {share:.3f}), mean TTFT (rows prefilled "
          f"in turn) {figures['ttft_mean_ms']:.1f}ms, TPOT mean {figures['tpot_mean_ms']:.2f}ms "
          f"p95 {figures['tpot_p95_ms']:.2f}ms; peak memory {peak:.2f} GiB; launches {launches} "
          f"(flash (2 x {L} + {Le}) x {API_ROWS} prefills, decode 2 x {L} x {API_NEW - 1} steps)",
          flush=True)
    bound = logit_bound(2 * L)
    worst, want_logits, agree = held_to_oracle("whisper serve", cfg, params, rows, tokens, logits,
                                               bound)
    # control: each row's cross attention reads the next row's ck/cv
    for entry in prefilled:
        for name in ("ck", "cv"):
            entry[name] = entry[name].roll(1, dims=1).contiguous()
    _, logits_c, _ = decode_rows(cfg, params, prefilled, first, lens, API_NEW, forced=tokens)
    control = control_worst(cfg, logits_c, want_logits)
    del prefilled, logits_c
    print(f"[whisper serve] control, each row's cross attention over the next row's ck/cv: "
          f"worst per row {[round(x, 5) for x in control]} against the bound {bound:.4f} "
          f"({sum(x > bound for x in control)} of {API_ROWS} rows above)", flush=True)
    assert max(control) > bound, (control, bound)
    step_pos = Sc - 1
    wall_ms, busy_ms = decode_step_times(cfg, params, cache, step_pos)
    kv_bytes = kv_read_bytes(cfg, cache, step_pos)
    step_bytes = weight_bytes_read(cfg, params, leaves) + kv_bytes
    bound_ms = step_bytes / HBM_BYTES_S * 1e3
    print(f"[whisper serve] decode step (8 rows, position {step_pos}): wall {wall_ms:.2f} ms "
          f"(mean of 3); device busy {fmt_ms(busy_ms)} ms (CUDA events, {L + 2} pieces behind "
          f"spins, summed; mean of 3); bound {bound_ms:.3f} ms ({step_bytes / 1e9:.3f} GB: the "
          f"decoder's weights but the embedding table, the self-attention K/V of the valid "
          f"slots and every cross slot, {kv_bytes / 1e9:.3f} GB, at 3.35 TB/s)", flush=True)
    figures.update(prompt_lengths=lens, peak_gib=peak, logit_bound=bound, worst_rel=worst,
                   greedy_agreement=agree, cross_of_next_row=control,
                   encoder_ms_mean=1e3 * float(np.mean(enc_s)), encoder_share_of_prefill=share,
                   decode_step_wall_ms=wall_ms, decode_step_busy_ms=busy_ms,
                   decode_step_bound_ms=bound_ms)
    del cache, logits, want_logits, params, leaves, frames, rows
    gc.collect()
    torch.cuda.empty_cache()
    return launches, figures


# ---------------------------------------------------------------------------
# phase 16: the step-program audit on the card
# ---------------------------------------------------------------------------


def serve_engine(cfg, params, **kw):
    """A paged engine with phase 5's settings on ``cfg`` and ``params``."""
    from repro_torch.serving.engine import GenerationEngine

    return GenerationEngine(cfg, params=params, device="cuda", max_batch=8, max_seq=2048,
                            block_size=16, prefill_chunk_size=256, **kw)


def phase_audit(ka, kf, tk, cfg, params):
    """Audit phase 5's engine (bf16, then int8 pools) under the sync debug
    mode "error", then catch the four seeded defects on the same engines.
    Returns the launches and the figures."""
    from repro_torch.analysis.__main__ import (
        AUDIT_ENGINE_MUTANTS,
        off_bucket_call,
        one_rank_gloo,
    )
    from repro_torch.analysis.step_audit import StepContract, audit_engine, audit_program

    mode = torch.cuda.get_sync_debug_mode()
    reset_launches(ka, kf, tk)
    figures, engines = {}, {}
    for tag, kv_dtype in (("bf16", None), ("int8", "int8")):
        eng = engines[tag] = serve_engine(cfg, params, kv_dtype=kv_dtype)
        t0 = time.perf_counter()
        report = audit_engine(eng)
        sec = time.perf_counter() - t0
        assert torch.cuda.get_sync_debug_mode() == mode
        for line in report.render().splitlines():
            print(f"[audit] {tag} pools: {line}", flush=True)
        assert report.ok, report.render()
        want = {(p, c) for p in ("fused_ragged", "decode", "decode_ref", "pool")
                for c in ("collectives", "host-sync")} | {("fused_ragged", "cache-sentinel")}
        if kv_dtype:
            want |= {("fused_ragged", "int8-flow"), ("decode", "int8-flow")}
        assert {(f.program, f.check) for f in report.findings} == want
        figures[tag] = {"audit_s": sec, "warmed_lengths": len(eng._warm_lengths),
                        "findings": [str(f) for f in report.findings]}
    launches = read_launches(ka, kf, tk)
    assert all(launches[n] > 0 for n in PAGED), launches

    caught = {}
    bf16, int8 = engines["bf16"], engines["int8"]
    pool = StepContract("pool", max_all_reduce=0)
    for mid, check in (("audit-collective", "collectives"), ("audit-host-sync", "host-sync")):
        AUDIT_ENGINE_MUTANTS[mid](bf16)
        try:
            with one_rank_gloo() if mid == "audit-collective" else contextlib.nullcontext():
                bad = [f for f in audit_program(bf16, pool) if not f.ok]
        finally:
            del bf16.step_program             # the engine's own method again
        assert {f.check for f in bad} == {check}, (mid, bad)
        caught[mid] = [str(f) for f in bad]
    bad = [f for f in audit_program(int8, StepContract(
        "decode_ref", max_all_reduce=0, require_int8_kernel_path=True)) if not f.ok]
    assert {f.check for f in bad} == {"int8-flow"}, bad
    caught["audit-int8-upcast"] = [str(f) for f in bad]
    T = off_bucket_call(bf16)
    bad = audit_engine(bf16, contracts=[]).failures()
    assert [f.check for f in bad] == ["cache-sentinel"] and str([T]) in bad[0].detail, bad
    caught["audit-cache-buckets"] = [str(f) for f in bad]
    assert torch.cuda.get_sync_debug_mode() == mode
    for mid, lines in caught.items():
        print(f"[audit] mutation {mid} caught: {' | '.join(lines)}", flush=True)
    figures["mutations_caught"] = caught
    print(f"[audit] launches in the phase (warmups, audits, mutations): {launches}", flush=True)
    del engines, bf16, int8
    gc.collect()
    torch.cuda.empty_cache()
    return launches, figures


# ---------------------------------------------------------------------------
# phase 17: DP replicas over one pool on one card
# ---------------------------------------------------------------------------


def owned_blocks(eng):
    pool = eng.kv.pool
    return set(pool.free_list) | set(pool.refcounts) | set(pool.cached)


# phase 5's prompts in two waves (indices into them): one shared-document
# prompt and one fresh one, then the rest ordered so that least-loaded
# routing, which alternates from replica 0 when both are idle, sends the
# other four shared-document prompts to replica 1, where the document's
# blocks are a host-tier hit (replica 0 prefilled them and wrote them
# through)
DP_WAVES = ((0, 5), (6, 1, 7, 2, 8, 3, 9, 4))
# new tokens a request (phase 5: 32; the first 12 are compared with its)
DP_NEW = 12


def serve_group(grp, prompts, max_new=DP_NEW):
    """Submit ``prompts`` to the group wave by wave (``DP_WAVES``, routed
    least-loaded), running it dry after each wave. Returns the requests and
    the replica each went to (in prompt order), and the wall seconds."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs, owner = [None] * len(prompts), [None] * len(prompts)
    for wave in DP_WAVES:
        for i in wave:
            reqs[i] = grp.submit(prompts[i], max_new=max_new)
            owner[i] = next(k for k, e in enumerate(grp.engines)
                            if any(x is reqs[i] for x in e.waiting))
        grp.run_until_done()
    torch.cuda.synchronize()
    return reqs, owner, time.perf_counter() - t0


def group_figures(grp, reqs, wall):
    st = grp.stats()
    ttft = [r.first_token_at - r.submitted_at for r in reqs]
    gaps = [g for r in reqs for g in r.token_gaps]
    return {"tokens_out": st["tokens_out"], "wall_s": wall, "tok_s": st["tokens_out"] / wall,
            "ttft_mean_ms": 1e3 * float(np.mean(ttft)),
            "tpot_p95_ms": 1e3 * float(np.percentile(gaps, 95)),
            "steps": [s["steps"] for s in st["replicas"]],
            "requests": [len(e.finished) for e in grp.engines],
            "prefill_tokens": st["prefill_tokens"], "host_hit_tokens": st["host_hit_tokens"],
            "prefix_hit_tokens": [s["prefix_hit_tokens"] for s in st["replicas"]],
            "cross_replica_host_hits": st.get("cross_replica_host_hits", 0)}


def check_group(grp, cfg, reqs, launches):
    """Disjoint ownership over one box and one params tree, every request
    done, each replica drained to its scratch block, 36 paged launches a
    step of the group."""
    e0, e1 = grp.engines
    assert e0.kv._arrays is e1.kv._arrays and e0.params is e1.params
    assert not owned_blocks(e0) & owned_blocks(e1)
    assert all(len(r.out_tokens) == DP_NEW for r in reqs), [len(r.out_tokens) for r in reqs]
    assert all(e.kv.pool.n_free == e.kv.pool.n_owned - 1 for e in grp.engines)
    steps = sum(e.steps for e in grp.engines)
    n = launches["paged_chunk_attention"] + launches["paged_decode_attention"]
    assert n == cfg.num_layers * steps and all(launches[k] > 0 for k in PAGED), (launches, steps)
    assert all(launches[k] == 0 for k in (*DENSE, "topk_retrieval", "rwkv6_chunked",
                                          "ssm_scan")), launches


def phase_dp(ka, kf, tk, cfg, params, prompts, paged_tokens):
    """Two replicas of phase 5's engine over one pool, bf16 then int8
    pools: (a) without a host tier, each replica's tokens against a lone
    engine replaying its share; (b) with a shared write-through host tier,
    the cross-replica host hits. Returns the launches and the figures."""
    from repro_torch.serving.engine import DataParallelEngineGroup

    settings = dict(dp=2, params=params, device="cuda", max_batch=8, max_seq=2048,
                    block_size=16, prefill_chunk_size=256)
    figures, all_launches = {}, {}
    for tag, kv_dtype in (("bf16", None), ("int8", "int8")):
        fig = figures[tag] = {}
        for part, host_blocks in (("no_host_tier", None), ("host_tier", 1024)):
            grp = DataParallelEngineGroup(cfg, kv_dtype=kv_dtype, host_blocks=host_blocks,
                                          **settings)
            reset_launches(ka, kf, tk)
            reqs, owner, wall = serve_group(grp, prompts)
            launches = all_launches[f"{tag} {part}"] = read_launches(ka, kf, tk)
            check_group(grp, cfg, reqs, launches)
            f = fig[part] = group_figures(grp, reqs, wall)
            f["launches"] = {k: launches[k] for k in PAGED}
            phase5 = [t[:DP_NEW] for t in paged_tokens]
            f["agreement_with_phase_5"] = agreement([r.out_tokens for r in reqs], phase5)
            f["rows_equal_phase_5"] = sum(r.out_tokens == t for r, t in zip(reqs, phase5))
            if host_blocks is None:
                # each replica is a lone engine on its share of the prompts
                lone_tokens = [None] * len(prompts)
                for rank in range(2):
                    lone = serve_engine(cfg, params, kv_dtype=kv_dtype)
                    for wave in DP_WAVES:
                        got = {i: lone.submit(prompts[i], max_new=DP_NEW)
                               for i in wave if owner[i] == rank}
                        lone.run_until_done()
                        for i, r in got.items():
                            lone_tokens[i] = r.out_tokens
                    del lone
                equal = [r.out_tokens == t for r, t in zip(reqs, lone_tokens)]
                assert all(equal), f"{tag}: rows {[i for i, e in enumerate(equal) if not e]} " \
                                   "differ from the lone engine's"
                f["rows_equal_lone_engine"] = len(equal)
            else:
                assert f["cross_replica_host_hits"] > 0 and f["host_hit_tokens"] > 0, f
                f["host_store"] = grp.stats()["host_store"]
            print(f"[dp] {cfg.name} {tag} pools, {part}: {len(reqs)} requests routed "
                  f"{f['requests']} (owner by request {owner}), {f['tokens_out']} tokens out in "
                  f"{wall:.3f}s = {f['tok_s']:.1f} tok/s; mean TTFT {f['ttft_mean_ms']:.1f}ms, "
                  f"p95 TPOT {f['tpot_p95_ms']:.2f}ms; steps {f['steps']}; prefill tokens "
                  f"{f['prefill_tokens']}; prefix-hit tokens {f['prefix_hit_tokens']}; "
                  f"host-hit tokens {f['host_hit_tokens']}; cross-replica host hits "
                  f"{f['cross_replica_host_hits']}; launches {f['launches']}; greedy "
                  f"agreement with phase 5's lone engine {f['agreement_with_phase_5']:.4f} "
                  f"({f['rows_equal_phase_5']}/{len(reqs)} rows identical)"
                  + (f"; every row equal to a lone engine replaying its replica's share"
                     if host_blocks is None else ""), flush=True)
            del grp
            gc.collect()
            torch.cuda.empty_cache()
    return all_launches, figures


# ---------------------------------------------------------------------------
# phase 18: training (the flash backward kernel, a full-width stack's
# gradient, qwen2.5-3b and smollm-135m trained at full width)
# ---------------------------------------------------------------------------

# the backward's forms: (heads (H, KVH, hd, hd_v), form, S_kv (None: S),
# the (B, S) cases, the timed (B, S)): qwen2.5-3b's training batch and
# microbatch and smollm-135m's training batch (causal); hymba's window 1024;
# qwen2.5-3b-swa's window 4096; a chunk of 800 at llama4-scout's G 5 (tiles
# straddle chunk boundaries); whisper's cross attention over 1500 frames;
# minicpm3's MLA head dims (96, 64); each at ragged S too
BWD_FORMS = {
    "qwen2.5-3b": ((16, 2, 128, 128), {}, None,
                   ((2, 2048), (1, 2048), (2, 1), (2, 37), (2, 1000)), (1, 2048)),
    "smollm-135m": ((9, 3, 64, 64), {}, None, ((8, 256), (2, 1), (2, 37), (2, 1000)), (8, 256)),
    "hymba window 1024": ((25, 5, 64, 64), {"window": 1024}, None,
                          ((1, 1664), (2, 1), (2, 37), (2, 1000)), (1, 1664)),
    "qwen2.5-3b-swa window 4096": ((16, 2, 128, 128), {"window": 4096}, None,
                                   ((1, 6000), (2, 1), (2, 37), (2, 1000)), (1, 6000)),
    "chunk 800": ((40, 8, 128, 128), {"chunk": 800}, None,
                  ((1, 2048), (2, 1), (2, 37), (2, 1000)), (1, 2048)),
    "whisper cross": ((20, 20, 64, 64), {"causal": False}, 1500,
                      ((8, 448), (8, 1), (8, 37), (2, 1000)), (8, 448)),
    "minicpm3 (96, 64)": ((40, 40, 96, 64), {}, None,
                          ((1, 2048), (2, 1), (2, 37), (2, 1000)), (1, 2048)),
}
# (atol as a share of max(1, max |want|), rtol) of the backward kernel
# against ref_flash_attention_backward on the same inputs: float32, the
# summation order; bfloat16, one rounding of the f32 result apart (at most
# 2**-7 of the value), both sides computing in f32
BWD_TOL = {"float32": (1e-5, 1e-4), "bfloat16": (1e-5, 2 ** -7)}
# the faulted controls: dv scaled by 1 + BWD_FAULT[dtype] (bf16 rounds
# 2**-7 to one or two ulps, inside its bound, so 2**-5 there), and the
# plain version with delta dropped against the kernel's dq and dk
BWD_FAULT = {"float32": 2 ** -7, "bfloat16": 2 ** -5}
# the stack check: each stack at full width with its depth cut to
# STACK_LAYERS (whisper: encoder and decoder), float32; each leaf's
# |g_kernel - g_plain| / max(|g_plain|, STACK_FLOOR x the global norm) (the
# key biases' gradient is zero in exact arithmetic: a bias shared by every
# key of a head shifts a row's scores by one constant). (arch, B, S): the
# window bites at S 6000; whisper's decoder takes 448 tokens over 1500 frames
# (18h) rwkv6-7b (no attention: the WKV kernels alone), hymba-1.5b at S
# 1536 (+ 128 meta tokens: the window of 1024 bites), mixtral-8x22b (S 1024)
# and llama4-scout (S 2048; its first two layers are chunked-local) join
# them; at 8 bytes a parameter (f32 parameter and gradient) mixtral's 2
# layers take ~43 GB and llama4's ~52 GB, so the plain gradients wait in
# host memory while the kernels' are compared
STACK_LAYERS = 2
STACK_CASES = (("qwen2.5-3b", 2, 2048), ("qwen2.5-3b-swa", 1, 6000), ("minicpm3-4b", 1, 2048),
               ("whisper-large-v3", 2, 448), ("rwkv6-7b", 1, 2048), ("hymba-1.5b", 1, 1536),
               ("mixtral-8x22b", 1, 1024), ("llama4-scout-17b-a16e", 1, 2048))
STACK_BOUND, STACK_FLOOR = 1e-3, 1e-3
TRAIN_STEPS, TRAIN_B, TRAIN_S, TRAIN_MB = 6, 2, 2048, 2
SMOLLM_STEPS, SMOLLM_B, SMOLLM_S = 50, 8, 256          # examples/train_smollm.py --full
# 18f and 18i: (arch, B, S, layers or None for the published depth), bf16
# parameters, f32 AdamW moments, one microbatch. 18i's depths from 12 bytes
# a parameter (bf16 parameter and gradient, two f32 moments) on 80 GB:
# hymba-1.5b whole (1.40 B parameters, ~17 GB); rwkv6-7b 16 of 32 layers
# (0.54 B embedding and head + 16 x 0.22 B, ~49 GB; all 32 would take ~91
# GB); mixtral-8x22b 2 of 56 (0.40 B + 2 x 2.50 B, ~65 GB); llama4-scout 1
# of 48 (2.07 B embedding and head + 2.20 B, ~51 GB; 2 layers ~78 GB)
FORM_TRAIN_STEPS = 3
FORM_TRAIN = (("qwen2.5-3b-swa", 1, 6000, None), ("minicpm3-4b", 1, 2048, None),
              ("whisper-large-v3", 4, 448, None))
SCAN_TRAIN = (("hymba-1.5b", 1, 2048, None), ("rwkv6-7b", 1, 2048, 16),
              ("mixtral-8x22b", 1, 1024, 2), ("llama4-scout-17b-a16e", 1, 2048, 1))
# 18g: the scans' backward kernels against their plain versions: rwkv6-7b's
# heads (H 64, hd 64) and hymba-1.5b's scan (Di 1600, N 16); (B, S) cases,
# the main shape first (timed): the training microbatch, S 2176 for hymba
# (18i's 2048 tokens + 128 meta tokens); then S 1, 37 and 1000, the edges of
# the segment rules (``scan_backward_edges``), and S 1000 with strong
# decays (w = 0 entries; exp(dt A) = 0 where dt = 80)
WKV_BWD_HEADS = (64, 64)
SCAN_BWD_CASES = {"rwkv6_chunked_backward": ((1, 2048), (1, 1), (1, 37), (1, 1000)),
                  "ssm_scan_backward": ((1, 2176), (1, 1), (1, 37), (1, 1000))}
SCAN_STRONG_S = 1000
WKV_GRADS = ("dr", "dk", "dv", "dw", "du", "dstate0")
SSM_GRADS = ("ddt", "dx", "dbm", "dcm", "da_log", "dh0")


def backward_excess(got, want, dtype_name):
    """The largest |got - want| over its BWD_TOL bound (> 1: outside)."""
    share, rtol = BWD_TOL[dtype_name]
    got, want = got.float(), want.float()
    bound = share * max(1.0, float(want.abs().max())) + rtol * want.abs()
    return float(((got - want).abs() / bound).max())




def library_backward(q, k, v, dout, form):
    """SDPA's backward on the same form, its forward run once: ``is_causal``
    (causal), a boolean mask (a window or a chunk), none (non-causal)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import hidden_mask

    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    causal, window, chunk = form.get("causal", True), form.get("window", 0), form.get("chunk", 0)
    mask = (~hidden_mask(q.shape[1], k.shape[1], causal, window, chunk, "cuda")
            if window or chunk else None)
    out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                         is_causal=causal and mask is None, enable_gqa=True)
    dout_t = dout.transpose(1, 2)
    return lambda: torch.autograd.grad(out, (qt, kt, vt), dout_t, retain_graph=True)


def phase_backward_kernel(kf):
    """The flash backward kernel against its plain version on the card in
    every form of the forward, with faulted controls; times at each form's
    main shape beside its bound, its plain version and SDPA's backward."""
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(18)
    rows = {}
    for form_name, ((Hh, KVHh, hd, hd_v), form, S_kv, cases, timed_at) in BWD_FORMS.items():
        for dtype_name in ("float32", "bfloat16"):
            dt = getattr(torch, dtype_name)
            for Bb, S in cases:
                Skv = S_kv or S
                q = torch.randn((Bb, S, Hh, hd), generator=gen, device="cuda").to(dt)
                k = torch.randn((Bb, Skv, KVHh, hd), generator=gen, device="cuda").to(dt)
                v = torch.randn((Bb, Skv, KVHh, hd_v), generator=gen, device="cuda").to(dt)
                out = kf.flash_attention(q, k, v, **form)
                dout = torch.randn(out.shape, generator=gen, device="cuda").to(dt)
                kern = lambda: kf.flash_attention_backward(q, k, v, out, dout, **form)
                got, again = kern(), kern()
                torch.cuda.synchronize()
                want = kf.ref_flash_attention_backward(q, k, v, out, dout, **form)
                name = (f"flash_attention_backward[{form_name}, {dtype_name}, B={Bb}, S={S}"
                        f"{f', S_kv={Skv}' if Skv != S else ''}]")
                r = {"max_abs_err": {}, "excess": {}}
                for g_name, a, a2, w in zip(("dq", "dk", "dv"), got, again, want):
                    assert a.dtype == dt and torch.isfinite(a.float()).all(), (name, g_name)
                    assert torch.equal(a, a2), f"{name}: {g_name} differs between two calls"
                    r["max_abs_err"][g_name] = float((a.float() - w.float()).abs().max())
                    r["excess"][g_name] = backward_excess(a, w, dtype_name)
                    assert r["excess"][g_name] <= 1.0, (name, g_name, r)
                scale = 1 + BWD_FAULT[dtype_name]
                faulted = kf.ref_flash_attention_backward(q, k, v, torch.zeros_like(out), dout,
                                                          **form)
                r["controls"] = {
                    f"dv x (1 + {BWD_FAULT[dtype_name]:g})":
                        backward_excess((got[2].float() * scale).to(dt), want[2], dtype_name),
                    "delta dropped (dq)": backward_excess(got[0], faulted[0], dtype_name),
                    "delta dropped (dk)": backward_excess(got[1], faulted[1], dtype_name)}
                if S > 1:   # at S 1, dq and dk are zero in exact arithmetic (self-attention)
                    assert all(x > 1.0 for x in r["controls"].values()), (name, r["controls"])
                if (Bb, S) == timed_at:
                    nbytes, ops = backward_work(Bb, S, Hh, KVHh, hd, q.element_size(), S_kv=Skv,
                                                hd_v=hd_v, **form)
                    bytes_ms = nbytes / HBM_BYTES_S * 1e3
                    ops_ms = ops / PEAK_OPS_S[dtype_name] * 1e3
                    r.update({"ms": time_ms(kern, flush), "device_ms": device_ms(kern),
                              "plain_ms": time_ms(
                                  lambda: kf.ref_flash_attention_backward(q, k, v, out, dout,
                                                                          **form),
                                  flush, reps=5),
                              "library_ms": time_ms(library_backward(q, k, v, dout, form), flush),
                              "bound_ms": max(bytes_ms, ops_ms),
                              "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                              "bytes": nbytes, "ops": ops})
                rows[(form_name, dtype_name, Bb, S)] = r
                times = (f"; kernel_ms={r['ms']:.4f} device_ms={fmt_ms(r['device_ms'])} "
                         f"plain_ms={r['plain_ms']:.4f} sdpa_backward_ms={r['library_ms']:.4f} "
                         f"bound_ms={r['bound_ms']:.5f} ({r['bound_by']}: {r['bytes']} B, "
                         f"{r['ops']} flop)") if "ms" in r else ""
                errs = " ".join(f"{g}={e:.3e} ({r['excess'][g]:.3f} of bound)"
                                for g, e in r["max_abs_err"].items())
                ctl = ", ".join(f"{c} {x:.1f}x" for c, x in r["controls"].items())
                print(f"[backward kernel] {name}: max_abs_err {errs} (atol share, rtol "
                      f"{BWD_TOL[dtype_name]}); controls {ctl}{times}", flush=True)
                del q, k, v, out, dout, got, again, want, faulted
            torch.cuda.empty_cache()
    return rows


def wkv_backward_inputs(gen, B, S, dtype, strong):
    """rwkv6-7b's heads: r, k (0.5 N(0, 1)), v, Finch decays w = exp(-exp(z))
    with z ~ N(0, 0.5) (``strong``: w = 0 at every third step's even keys),
    u, state0, and the cotangents dy and dstate."""
    H, hd = WKV_BWD_HEADS
    rn = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
    r, k, v = 0.5 * rn(B, S, H, hd), 0.5 * rn(B, S, H, hd), rn(B, S, H, hd)
    w = torch.exp(-torch.exp(0.5 * rn(B, S, H, hd)))
    if strong:
        w[:, ::3, :, ::2] = 0.0
    u, state0 = 0.3 * rn(H, hd), 0.5 * rn(B, H, hd, hd)
    return (r.to(dtype), k.to(dtype), v.to(dtype), w, u, state0, rn(B, S, H, hd),
            rn(B, H, hd, hd))


def ssm_backward_inputs(gen, B, S, dtype, strong):
    """hymba-1.5b's scan (``ssm_inputs``; ``strong``: dt = 80 at every fourth
    step, so exp(dt A) = 0 for every state), and the cotangents dy and dh."""
    dt, x, bm, cm, a_log, h0 = ssm_inputs(gen, B, S, dtype, False)
    if strong:
        dt[:, ::4] = 80.0
    dy = torch.randn((B, S, SSM_DI), generator=gen, device="cuda")
    return dt, x, bm, cm, a_log, h0, dy, torch.randn(h0.shape, generator=gen, device="cuda")




def scan_backward_segments(kw, ks, name, dtype, B, S):
    """(n_seg, seg_len) that the backward kernel's segment rule gives at
    (B, S) and the main shape's width on this card."""
    if name == "rwkv6_chunked_backward":
        H, hd = WKV_BWD_HEADS
        return kw.wkv_backward_segments(kw.backward_slots(0, dtype, hd), B, H, S)
    return ks.ssm_backward_segments(ks.backward_slots(0, dtype, SSM_N), B, SSM_DI, SSM_N, S)


def scan_backward_edges(kw, ks, name, dtype):
    """(B, S) lengths about the edges of the backward kernel's segment rule
    at the main shape's width on this card: one chunk plus one step, and the
    segment the rule gives at the main length less and plus one step."""
    Bm, Sm = SCAN_BWD_CASES[name][0]
    chunk = (kw if name == "rwkv6_chunked_backward" else ks).BACKWARD_CHUNK
    seg = scan_backward_segments(kw, ks, name, dtype, Bm, Sm)[1]
    return ((Bm, chunk + 1), (Bm, seg - 1), (Bm, seg + 1))


def scan_backward_design_work(name, case, segments):
    """The kernels' own work for one call, beside the contract's
    (``scan_backward_work``), from their design (csrc/*_backward.cu
    headers), an FMA counted as 2: (tensor-core multiply-adds, their tf32
    products, f32 operations on the CUDA cores, exponentials). WKV, per
    element of the state and step: the local states' and adjoints' chunk
    updates (the adjoints on all segments but the first) and the output
    pass's S_c dY^T, G_e V^T, G_e^T K^ and adjoint update on the tensor
    cores, each taken as 3 tf32 products (2 where bf16 v, exact in tf32, is
    an operand); on the CUDA cores M = V dY^T (32 / hd), the checkpoint,
    rowsum(G_e * S_c) and the adjoint's scaling (5 a chunk of 16), and per
    key and chunk the decays (64), the forward walk (1112), the backward
    walk (656), A's sums (136) and dv (272 an output column). Scan, per
    element and step: 8 operations and 1 exponential in the local pass, 4
    and 1 in the output pass's forward walk, 15 in its walk back, 1.25 in
    the shuffle sums over lanes and 2 a chunk of 8 for the checkpoint."""
    n_seg = segments[0]
    if name == "rwkv6_chunked_backward":
        B, S, H, hd = case[0].shape
        elems = B * S * H * hd * hd
        adjoint = (n_seg - 1) / n_seg
        v2 = 2 if case[2].dtype == torch.bfloat16 else 3
        macs = elems * (5 + adjoint)
        products = elems * (v2 + 3 * adjoint + 3 + v2 + 3 + 3)
        per_key_chunk = 64 + 1112 + 656 + 136 + 272
        cuda = elems * (32 / hd + 5 / 16) + B * H * hd * -(-S // 16) * per_key_chunk
        return macs, products, cuda, 0
    B, S, Di = case[0].shape
    elems = B * S * Di * case[2].shape[-1]
    return 0, 0, elems * (8 + 4 + 15 + 1.25 + 2 / 8), 2 * elems


def phase_scan_backward_kernels(kw, ks):
    """18g: the backward kernels of the WKV and of the selective scan against
    their plain versions on the card at rwkv6-7b's heads and hymba-1.5b's
    scan (``SCAN_BWD_CASES``), float32 and bfloat16, nonzero initial states
    and final-state cotangents: every gradient within ``BWD_TOL``, two calls
    equal bit for bit, the first gradient scaled by 1 + ``BWD_FAULT``
    outside the bound, strong decays finite and within it; at the main
    shape the kernel's, its device and its plain version's times beside
    the bound."""
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(29)
    exp_s, _, _ = sfu_rate()
    specs = {"rwkv6_chunked_backward": (kw.rwkv6_chunked_backward,
                                        kw.ref_rwkv6_chunked_backward, wkv_backward_inputs,
                                        WKV_GRADS),
             "ssm_scan_backward": (ks.ssm_scan_backward, ks.ref_ssm_scan_backward,
                                   ssm_backward_inputs, SSM_GRADS)}
    rows = {}
    for name, (kern_fn, ref_fn, inputs, grad_names) in specs.items():
        main = SCAN_BWD_CASES[name][0]
        for dtype_name in ("float32", "bfloat16"):
            dt_ = getattr(torch, dtype_name)
            edges = scan_backward_edges(kw, ks, name, dt_)
            for Bb, S, strong in (*((b_, s_, False) for b_, s_ in SCAN_BWD_CASES[name] + edges),
                                  (1, SCAN_STRONG_S, True)):
                case = inputs(gen, Bb, S, dt_, strong)
                kern = lambda: kern_fn(*case)
                got, again = kern(), kern()
                torch.cuda.synchronize()
                want = ref_fn(*case)
                label = (f"{name}[{dtype_name}, B={Bb}, S={S}"
                         f"{', strong decays' if strong else ''}]")
                r = {"max_abs_err": {}, "excess": {}}
                for g_name, a, a2, w in zip(grad_names, got, again, want):
                    assert a.dtype == w.dtype and a.shape == w.shape, (label, g_name)
                    assert torch.isfinite(a.float()).all(), (label, g_name, "not finite")
                    assert torch.equal(a, a2), f"{label}: {g_name} differs between two calls"
                    tol = dtype_name if a.dtype == dt_ else "float32"
                    r["max_abs_err"][g_name] = float((a.float() - w.float()).abs().max())
                    r["excess"][g_name] = backward_excess(a, w, tol)
                    assert r["excess"][g_name] <= 1.0, (label, g_name, r)
                fault = 1 + BWD_FAULT[dtype_name]
                r["controls"] = {f"{grad_names[0]} x (1 + {BWD_FAULT[dtype_name]:g})":
                                 backward_excess((got[0].float() * fault).to(dt_), want[0],
                                                 dtype_name)}
                assert all(x > 1.0 for x in r["controls"].values()), (label, r["controls"])
                r["segments"] = scan_backward_segments(kw, ks, name, dt_, Bb, S)
                if (Bb, S) == main and not strong:
                    nbytes, ops, exps = scan_backward_work(name, case)
                    macs, products, cuda_ops, kexps = scan_backward_design_work(
                        name, case, r["segments"])
                    elem_steps = exps or ops / 12   # the scan's one exp, the WKV's 12 flops
                    work = {"tensor_core_macs": macs, "tf32_products": products,
                            "cuda_core_ops": cuda_ops, "exps": kexps}
                    parts = {"bytes": nbytes / HBM_BYTES_S * 1e3,
                             "operations": max(ops / PEAK_OPS_S["float32"], exps / exp_s) * 1e3}
                    bound_by = max(parts, key=parts.get)
                    r.update({"ms": time_ms(kern, flush), "device_ms": device_ms(kern),
                              "plain_ms": time_ms(lambda: ref_fn(*case), flush, reps=2,
                                                  warmup=1),
                              "library_ms": None, "bound_ms": parts[bound_by],
                              "bound_by": bound_by, "bytes": nbytes, "ops": ops, "exps": exps,
                              "flop_ms": ops / PEAK_OPS_S["float32"] * 1e3,
                              "exp_ms": exps / exp_s * 1e3})
                    design = {k: x / elem_steps for k, x in work.items()}
                    contract = {"f32_ops": ops / elem_steps, "exps": exps / elem_steps}
                rows[(name, dtype_name, Bb, S, strong)] = r
                times = (f"; kernel_ms={r['ms']:.4f} device_ms={fmt_ms(r['device_ms'])} "
                         f"plain_ms={r['plain_ms']:.4f} library_ms=none (no PyTorch call "
                         f"computes it) bound_ms={r['bound_ms']:.5f} ({r['bound_by']}: "
                         f"{r['bytes']} B = {r['bytes'] / HBM_BYTES_S * 1e3:.5f} ms, "
                         f"{r['ops']} flop = {r['flop_ms']:.5f} ms, {r['exps']} exp = "
                         f"{r['exp_ms']:.5f} ms); an element and step, the contract "
                         f"{json.dumps(contract)}, the kernel's design count (from its "
                         f"source, not measured) {json.dumps(design)}") if "ms" in r else ""
                errs = " ".join(f"{g}={e:.3e} ({r['excess'][g]:.3f} of bound)"
                                for g, e in r["max_abs_err"].items())
                ctl = ", ".join(f"{c} {x:.1f}x" for c, x in r["controls"].items())
                print(f"[scan backward kernel] {label}: segments {r['segments']}; max_abs_err "
                      f"{errs} (atol share, rtol {BWD_TOL[dtype_name]}); finite; two calls "
                      f"equal; control {ctl}{times}", flush=True)
                del case, got, again, want
            torch.cuda.empty_cache()
    return rows


@contextlib.contextmanager
def grad_scaled(module, name, index, factor):
    """The faulted control: gradient ``index`` of the backward wrapper
    ``module.name`` scaled by ``factor``."""
    real = getattr(module, name)

    def faulted(*a, **kw):
        out = list(real(*a, **kw))
        out[index] = out[index] * factor
        return tuple(out)

    faulted.launches = real.launches     # the wrapper counts through its module name
    setattr(module, name, faulted)
    try:
        yield
    finally:
        setattr(module, name, real)


BACKWARD_OF = {"flash_attention": "flash_attention_backward",
               "rwkv6_chunked": "rwkv6_chunked_backward", "ssm_scan": "ssm_scan_backward"}


def stack_calls(cfg):
    """Each trainable kernel's forward calls in one pass of ``cfg``'s stack:
    the attention (an encoder-decoder's encoder self, decoder self and
    cross attention a layer) and the WKV or the selective scan a layer."""
    from repro_torch.configs.base import MIXER_HYBRID, MIXER_RWKV6

    L = cfg.num_layers
    if cfg.attn_type == MIXER_RWKV6:
        return {"flash_attention": 0, "rwkv6_chunked": L, "ssm_scan": 0}
    n_attn = L * 2 + cfg.encoder_layers if cfg.is_encoder_decoder else L
    return {"flash_attention": n_attn, "rwkv6_chunked": 0,
            "ssm_scan": L if cfg.attn_type == MIXER_HYBRID else 0}


def training_launches(calls, passes):
    """The launches of ``passes`` training passes (microbatches): remat runs
    each forward twice, the backward once."""
    want = {}
    for fwd, n in calls.items():
        want[fwd], want[BACKWARD_OF[fwd]] = 2 * n * passes, n * passes
    return want


def train_launches(ka, kf, tk):
    """``read_launches`` and the three backward kernels' counts."""
    from repro_torch.kernels import rwkv6_scan as kw
    from repro_torch.kernels import ssm_scan as ks

    return {**read_launches(ka, kf, tk),
            "flash_attention_backward": kf.flash_attention_backward.launches,
            "rwkv6_chunked_backward": kw.rwkv6_chunked_backward.launches,
            "ssm_scan_backward": ks.ssm_scan_backward.launches}


def stack_control(cfg, kf, kw, ks):
    """The stack's faulted control (a gradient scaled by 1 + 2**-7) in the
    kernel that the stack adds: the WKV backward's dv (rwkv6), the
    selective-scan backward's dC (hymba; its leaves reach w_x's gradient,
    where B and C are projected), else the flash backward's dv. (hymba's
    da_log, ddt and dx at 1 + 2**-7 stay under the bound: A_log's gradient
    lies under STACK_FLOOR x the global norm, and dt ~ 0.01 keeps ddt's
    and dx's share of their leaves small.)"""
    from repro_torch.configs.base import MIXER_HYBRID, MIXER_RWKV6

    factor = 1 + 2 ** -7
    if cfg.attn_type == MIXER_RWKV6:
        return "wkv dv", grad_scaled(kw, "rwkv6_chunked_backward", 2, factor)
    if cfg.attn_type == MIXER_HYBRID:
        return "scan dC", grad_scaled(ks, "ssm_scan_backward", 3, factor)
    return "flash dv", grad_scaled(kf, "flash_attention_backward", 2, factor)


def phase_train_stack(ka, kf, tk):
    """Each stack of STACK_CASES at full width with its depth cut to
    STACK_LAYERS, float32: the gradient of every leaf through the kernels
    (the flash forward and backward, the WKV's and the selective scan's)
    against the same stack with the attention and the recurrences through
    their plain versions under autograd, and a faulted control (a
    backward's gradient scaled by 1 + 2**-7) above the bound. The plain
    gradients wait in host memory while the kernels' sets are made and
    compared leaf by leaf (two sets of mixtral's or llama4's and their
    weights do not fit on the card together)."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import rwkv6_scan as kw
    from repro_torch.kernels import ssm_scan as ks
    from repro_torch.launch.grad_check import cut_depth, leaf_paths, plain_kernels
    from repro_torch.models import loss_fn

    torch.backends.cuda.matmul.allow_tf32 = False   # float32 products in float32
    figures = {}
    for arch, Bb, S in STACK_CASES:
        t0 = time.perf_counter()
        cfg = cut_depth(get_arch(arch), STACK_LAYERS)
        if cfg.is_encoder_decoder:
            cfg = cfg.replace(encoder_layers=STACK_LAYERS)
        params, leaves = draw_weights("train stack", cfg)
        for p in leaves:
            p.requires_grad_(True)
        gen = torch.Generator(device="cuda").manual_seed(5)
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (Bb, S), generator=gen,
                                         device="cuda")}
        if cfg.is_encoder_decoder:
            batch["frames"] = torch.randn((Bb, cfg.encoder_seq, cfg.d_model), generator=gen,
                                          device="cuda")

        def grads(*ctxs):
            with contextlib.ExitStack() as stack:
                for c in ctxs:
                    stack.enter_context(c)
                total, _ = loss_fn(cfg, params, batch)
                return list(torch.autograd.grad(total, leaves))

        norm = lambda t: float(torch.linalg.vector_norm(t))
        plain = grads(plain_kernels())
        want_norms = [norm(g) for g in plain]
        want = [torch.empty(g.shape, dtype=g.dtype, pin_memory=True).copy_(g) for g in plain]
        del plain
        gnorm = math.sqrt(sum(x * x for x in want_norms))
        flat = leaf_paths(params)

        def rel(got):
            """Each leaf's relative error against the plain gradient (freed as
            it goes)."""
            out = {}
            for i, (path, b, b_norm) in enumerate(zip(flat, want, want_norms)):
                out[path] = norm(got[i] - b.cuda(non_blocking=True)) / max(
                    b_norm, STACK_FLOOR * gnorm)
                got[i] = None
            return out

        reset_launches(ka, kf, tk)
        got = grads()
        everything = train_launches(ka, kf, tk)
        launches = {k: v for k, v in everything.items()
                    if k in BACKWARD_OF or k in BACKWARD_OF.values()}
        want_launches = training_launches(stack_calls(cfg), 1)
        assert launches == want_launches, (arch, launches, want_launches)
        assert not any(v for k, v in everything.items() if k not in launches), everything
        errs = rel(got)
        ctl_name, ctl_ctx = stack_control(cfg, kf, kw, ks)
        ctl = rel(grads(ctl_ctx))
        worst, worst_ctl = max(errs.values()), max(ctl.values())
        shape = (f"B {Bb} x S {S}" + (f" over {cfg.encoder_seq} frames"
                                       if cfg.is_encoder_decoder else ""))
        print(f"[train stack] {cfg.name} at full width, {STACK_LAYERS} layers"
              f"{' (+ encoder)' if cfg.is_encoder_decoder else ''}, float32, {shape}: each "
              f"leaf's |g_kernel - g_plain| / max(|g_plain|, {STACK_FLOOR} x {gnorm:.4e}): worst "
              f"{worst:.3e} of bound {STACK_BOUND} ({max(errs, key=errs.get)}); control "
              f"({ctl_name} x (1 + 2**-7)) worst {worst_ctl:.3e} ({max(ctl, key=ctl.get)}); "
              f"launches {launches}; {time.perf_counter() - t0:.1f}s", flush=True)
        print(f"[train stack] {cfg.name} per leaf: "
              + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()), flush=True)
        assert worst <= STACK_BOUND, (arch, errs)
        assert worst_ctl > STACK_BOUND, (arch, ctl)
        figures[arch] = {"batch": Bb, "seq": S, "layers": cfg.num_layers,
                         "worst_rel_err": worst, "bound": STACK_BOUND,
                         "control": ctl_name, "control_worst_rel_err": worst_ctl,
                         "launches": launches}
        del params, leaves, want, got, batch
        gc.collect()
        torch.cuda.empty_cache()
    return figures


def phase_train(ka, kf, tk):
    """qwen2.5-3b at full width and depth (36 layers), bf16 parameters,
    float32 AdamW moments: TRAIN_STEPS steps of TRAIN_B x TRAIN_S tokens in
    TRAIN_MB microbatches; then smollm-135m at full width through the
    launcher's ``train`` with examples/train_smollm.py --full's settings,
    its checkpoint saved and reloaded."""
    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.configs import get_arch
    from repro_torch.data.workload import TokenDataset
    from repro_torch.launch.train import train
    from repro_torch.models import forward, init_params, make_train_step
    from repro_torch.optim import AdamW, cosine_schedule

    figures = {}
    cfg = get_arch("qwen2.5-3b").replace(dtype="bfloat16")
    params, leaves = draw_weights("train", cfg)
    opt = AdamW(lr=cosine_schedule(3e-4, warmup=max(TRAIN_STEPS // 20, 1), total=TRAIN_STEPS))
    state = opt.init(params)
    step = make_train_step(cfg, opt, microbatches=TRAIN_MB)
    data = list(TokenDataset(cfg.vocab_size, TRAIN_S, seed=0).batches(TRAIN_B, TRAIN_STEPS))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(ka, kf, tk)
    losses, norms, walls = [], [], []
    for tokens in data:
        t0 = time.perf_counter()
        params, state, m = step(params, state, {"tokens": torch.from_numpy(tokens).cuda()})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        walls.append(time.perf_counter() - t0)
    launches = train_launches(ka, kf, tk)
    peak = torch.cuda.max_memory_allocated() / 2**30
    s_step = float(np.median(walls[1:]))
    figures["qwen2.5-3b"] = {
        "steps": TRAIN_STEPS, "batch": TRAIN_B, "seq": TRAIN_S, "microbatches": TRAIN_MB,
        "dtype": "bfloat16 params, float32 moments", "losses": losses, "grad_norms": norms,
        "step_s": walls, "s_per_step": s_step, "tokens_per_s": TRAIN_B * TRAIN_S / s_step,
        "peak_memory_gib": peak, "launches": launches}
    print(f"[train] {cfg.name} {cfg.num_layers} layers bf16, AdamW f32 moments, {TRAIN_STEPS} steps of "
          f"{TRAIN_B} x {TRAIN_S} tokens in {TRAIN_MB} microbatches: losses "
          f"{[round(x, 4) for x in losses]}, grad norms {[round(x, 3) for x in norms]}; "
          f"{s_step:.3f} s/step (median of steps 2-{TRAIN_STEPS}; first {walls[0]:.3f}), "
          f"{TRAIN_B * TRAIN_S / s_step:.1f} tokens/s, peak memory {peak:.2f} GiB; launches "
          f"{launches}", flush=True)
    assert all(np.isfinite(losses)) and all(np.isfinite(norms)), (losses, norms)
    assert losses[-1] < losses[0], losses
    # remat runs each layer's forward twice (once forward, once again in the
    # backward), per microbatch; the backward once
    want = dict.fromkeys(launches, 0)
    want.update(training_launches({"flash_attention": cfg.num_layers}, TRAIN_MB * TRAIN_STEPS))
    assert launches == want, (launches, want)
    del params, leaves, state, step, m
    gc.collect()
    torch.cuda.empty_cache()

    # smollm-135m through the launcher, then its checkpoint
    cfg = get_arch("smollm-135m")
    params, _ = draw_weights("train", cfg)
    path = str(ROOT / "build" / "chip_smoke_train" / "smollm-135m.npz")
    reset_launches(ka, kf, tk)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses = train("smollm-135m", False, SMOLLM_STEPS, SMOLLM_B, SMOLLM_S, checkpoint=path,
                   device="cuda", params=params, log_every=10)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = train_launches(ka, kf, tk)
    peak = torch.cuda.max_memory_allocated() / 2**30
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    want = dict.fromkeys(launches, 0)
    want.update(training_launches({"flash_attention": cfg.num_layers}, SMOLLM_STEPS))
    assert launches == want, (launches, want)
    like = init_params(cfg, torch.Generator(device="cuda").manual_seed(1), "cuda")
    loaded, step_no, meta = load_checkpoint(path, like=like)
    tokens = torch.from_numpy(next(TokenDataset(cfg.vocab_size, SMOLLM_S, seed=9).batches(
        SMOLLM_B, 1))).cuda()
    with torch.no_grad():
        a, _ = forward(cfg, params, {"tokens": tokens})
        b, _ = forward(cfg, loaded, {"tokens": tokens})
    assert step_no == SMOLLM_STEPS and meta["arch"] == cfg.name, (step_no, meta)
    assert torch.equal(a, b), "the reloaded checkpoint's logits differ"
    figures["smollm-135m"] = {
        "steps": SMOLLM_STEPS, "batch": SMOLLM_B, "seq": SMOLLM_S, "dtype": cfg.dtype,
        "loss_first": losses[0], "loss_last": losses[-1], "wall_s": wall,
        "s_per_step": wall / SMOLLM_STEPS,
        "tokens_per_s": SMOLLM_B * SMOLLM_S * SMOLLM_STEPS / wall, "peak_memory_gib": peak,
        "launches": launches, "checkpoint_logits_equal": True}
    print(f"[train] smollm-135m at full width ({cfg.num_layers} layers, {cfg.dtype}) through "
          f"launch.train: "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f} in {SMOLLM_STEPS} steps of {SMOLLM_B} x "
          f"{SMOLLM_S}; {wall / SMOLLM_STEPS:.3f} s/step, "
          f"{SMOLLM_B * SMOLLM_S * SMOLLM_STEPS / wall:.1f} tokens/s, peak memory {peak:.2f} GiB; "
          f"launches {launches}; checkpoint reloaded with like=: logits equal bit for bit",
          flush=True)
    del params, loaded, like
    gc.collect()
    torch.cuda.empty_cache()
    return figures


def phase_train_forms(ka, kf, tk, runs=FORM_TRAIN, tag="train forms"):
    """18f (``FORM_TRAIN``): the stacks whose attention takes the backward's
    new forms, qwen2.5-3b-swa (window 4096 at S 6000), minicpm3-4b (MLA's
    (96, 64)) and whisper-large-v3 (the encoder's causal attention, the
    decoder's causal self and non-causal cross attention over 1500 frames);
    18i (``SCAN_TRAIN``): hymba-1.5b (window 1024 beside the selective
    scan), rwkv6-7b (the WKV), mixtral-8x22b (window 4096, MoE) and
    llama4-scout (chunk 8192, MoE). Each at full width (depth as the runs
    give it), bf16 parameters, f32 AdamW moments, FORM_TRAIN_STEPS steps
    from ``TokenDataset`` through ``make_train_step`` in one microbatch:
    losses and grad norms finite, s/step, tokens/s, peak memory, and the
    launches (each kernel's forward twice a step, its backward once)."""
    from repro_torch.configs import get_arch
    from repro_torch.data.workload import TokenDataset
    from repro_torch.launch.grad_check import cut_depth
    from repro_torch.models import make_train_step
    from repro_torch.optim import AdamW, cosine_schedule

    figures = {}
    for arch, Bb, S, layers in runs:
        t0 = time.perf_counter()
        cfg = get_arch(arch).replace(dtype="bfloat16")
        if layers is not None:
            print(f"[{tag}] {arch}: depth cut from {cfg.num_layers} to {layers} layers "
                  f"(12 bytes a parameter on 80 GB)", flush=True)
            cfg = cut_depth(cfg, layers)
        params, leaves = draw_weights(tag, cfg)
        opt = AdamW(lr=cosine_schedule(3e-4, warmup=1, total=FORM_TRAIN_STEPS))
        state = opt.init(params)
        step = make_train_step(cfg, opt, microbatches=1)
        data = list(TokenDataset(cfg.vocab_size, S, seed=0).batches(Bb, FORM_TRAIN_STEPS))
        gen = torch.Generator(device="cuda").manual_seed(7)
        frames = (torch.randn((Bb, cfg.encoder_seq, cfg.d_model), generator=gen,
                              device="cuda").bfloat16() if cfg.is_encoder_decoder else None)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches(ka, kf, tk)
        losses, norms, walls = [], [], []
        for tokens in data:
            batch = {"tokens": torch.from_numpy(tokens).cuda()}
            if frames is not None:
                batch["frames"] = frames
            t1 = time.perf_counter()
            params, state, m = step(params, state, batch)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            walls.append(time.perf_counter() - t1)
        launches = train_launches(ka, kf, tk)
        peak = torch.cuda.max_memory_allocated() / 2**30
        s_step = float(np.median(walls[1:]))
        tokens_step = Bb * S
        figures[arch] = {
            "steps": FORM_TRAIN_STEPS, "batch": Bb, "seq": S, "layers": cfg.num_layers,
            "encoder_layers": cfg.encoder_layers or None, "depth_cut": layers is not None,
            "dtype": "bfloat16 params, float32 moments", "losses": losses, "grad_norms": norms,
            "step_s": walls, "s_per_step": s_step, "tokens_per_s": tokens_step / s_step,
            "peak_memory_gib": peak, "launches": launches}
        print(f"[{tag}] {cfg.name} {cfg.num_layers} layers"
              f"{f' (+{cfg.encoder_layers} encoder layers, {cfg.encoder_seq} frames)' if cfg.is_encoder_decoder else ''}"
              f" bf16, AdamW f32 moments, {FORM_TRAIN_STEPS} steps of {Bb} x {S} tokens: losses "
              f"{[round(x, 4) for x in losses]}, grad norms {[round(x, 3) for x in norms]}; "
              f"{s_step:.3f} s/step (median of steps 2-{FORM_TRAIN_STEPS}; first {walls[0]:.3f}), "
              f"{tokens_step / s_step:.1f} tokens/s, peak memory {peak:.2f} GiB; launches "
              f"{launches}; {time.perf_counter() - t0:.1f}s", flush=True)
        assert all(np.isfinite(losses)) and all(np.isfinite(norms)), (arch, losses, norms)
        want = dict.fromkeys(launches, 0)
        want.update(training_launches(stack_calls(cfg), FORM_TRAIN_STEPS))
        assert launches == want, (arch, launches, want)
        del params, leaves, state, step, m, frames
        gc.collect()
        torch.cuda.empty_cache()
    return figures


def phase_grad_guards(ka, kf, tk):
    """Each forward-only wrapper, handed a grad-requiring CUDA input under
    grad mode, raises; so does a flash form without a backward kernel."""
    from repro_torch.kernels import rwkv6_scan as kw
    from repro_torch.kernels import ssm_scan as ks

    f = lambda *s: torch.randn(*s, device="cuda")
    i32 = lambda *s: torch.zeros(*s, dtype=torch.int32, device="cuda")
    q3, pool = f(2, 4, 64).requires_grad_(), f(3, 16, 2, 64)
    calls = {
        "paged_decode_attention": lambda: ka.paged_decode_attention(
            q3, pool, pool, i32(2, 1), i32(2) + 1),
        "paged_chunk_attention": lambda: ka.paged_chunk_attention(
            q3, pool, pool, i32(2, 1), i32(2), i32(2), i32(2), i32(2)),
        "decode_attention": lambda: ka.decode_attention(q3, f(2, 16, 2, 64), f(2, 16, 2, 64),
                                                        i32(2) + 1),
        "flash_attention": lambda: kf.flash_attention(f(1, 8, 4, 64).requires_grad_(),
                                                      f(1, 8, 2, 64), f(1, 8, 2, 64)),
        "ssm_scan": lambda: ks.ssm_scan(f(1, 4, 64).requires_grad_(), f(1, 4, 64),
                                        f(1, 4, 16), f(1, 4, 16), f(64, 16)),
        "rwkv6_chunked": lambda: kw.rwkv6_chunked(f(1, 4, 2, 64).requires_grad_(),
                                                  f(1, 4, 2, 64), f(1, 4, 2, 64),
                                                  f(1, 4, 2, 64), f(2, 64)),
        "topk_retrieval": lambda: tk.topk_retrieval(f(2, 64).requires_grad_(), f(16, 64), 4),
    }
    raised = {}
    for name, call in calls.items():
        try:
            call()
        except RuntimeError as e:
            assert "forward-only" in str(e), (name, e)
            raised[name] = "RuntimeError"
        else:
            raise AssertionError(f"{name}: a grad-requiring CUDA input did not raise")
    # the flash forms the forward kernel does not take either: a window with
    # a chunk, head dims (32, 32), cross attention at (128, 128)
    for form, hd, S_kv in ((dict(window=16, chunk=16), 64, 32), ({}, 32, 32),
                           (dict(causal=False), 128, 20)):
        try:
            kf.trainable_flash_attention(f(1, 32, 4, hd).requires_grad_(), f(1, S_kv, 2, hd),
                                         f(1, S_kv, 2, hd), **form)
        except NotImplementedError:
            raised[f"trainable_flash_attention {form} hd {hd} S_kv {S_kv}"] = "NotImplementedError"
        else:
            raise AssertionError(f"trainable_flash_attention {form} hd {hd} did not raise")
    print(f"[grad guards] {raised}", flush=True)
    return raised


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    else:
        yield tree


# ---------------------------------------------------------------------------
# phase 19: the dry run against the card; tensor parallelism on the card
# ---------------------------------------------------------------------------
DRY_SHAPES = {"serve": (2048, 8, "decode"),            # phase 5: max_seq 2048, max_batch 8
              "train": (TRAIN_S, TRAIN_B, "train")}    # 18c: B 2 x S 2048, 2 microbatches
TP = 2
# phase 5's prompts in chunks of 512 (half of phase 5's steps: each step's
# 72 gloo all-reduces wait on the host) at 4 new tokens a request
TP_MAX_NEW, TP_CHUNK = 4, 512


def allocated_bytes(make):
    """(bytes the caching allocator hands out for the tensors ``make()``
    returns (``memory_allocated`` after less before), their blocks in
    ``torch.cuda.memory_snapshot()`` as (size, requested_size) pairs, that
    value)."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    out = make()
    torch.cuda.synchronize()
    allocated = torch.cuda.memory_allocated() - before
    ptrs = {t.untyped_storage().data_ptr() for t in _tensors(out) if t.is_cuda}
    blocks = [(b["size"], b["requested_size"]) for seg in torch.cuda.memory_snapshot()
              for b in seg["blocks"] if b["state"] == "active_allocated"
              and b["address"] in ptrs]
    return allocated, blocks, out


def phase_dryrun_card(train_figures):
    """19a: the dry run of qwen2.5-3b (bf16, world size 1) at phase 5's
    serve shape (decode, B 8 against a 2048-slot cache) and at 18c's train
    shape. Its argument bytes against what the card allocates for the same
    params, AdamW state, cache and inputs: equal to the bytes those tensors
    request (their blocks' ``requested_size``), and what the allocator
    hands out equal to those blocks' sizes, each block within the
    allocator's rules of its request (512 B rounding below 1 MiB; a larger
    block split only when more than 1 MiB would be left, so it may keep a
    tail of at most 1 MiB). The tensors come from ``init_params`` on both
    sides at world size 1: this holds the dry run's byte count to the card,
    not the sharding policy (the tests hold that to XLA's). Its peak
    estimate beside 18c's measured peak, and the card's memory
    (``total_memory``) beside ``kernels.work.CARD_BYTES``, which its
    ``fits`` reads; 18c's step FLOPs over its s/step (a printed
    figure)."""
    from repro_torch.configs import ShapeConfig, get_arch
    from repro_torch.launch import dryrun as D
    from repro_torch.kernels.work import CARD_BYTES
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.models import init_cache, init_params
    from repro_torch.optim import AdamW

    total = torch.cuda.get_device_properties(0).total_memory
    print(f"[dryrun card] the card's total_memory {total} B ({total / 2**30:.2f} GiB); the dry "
          f"run's fits reads CARD_BYTES {CARD_BYTES} B ({CARD_BYTES / 2**30:.2f} GiB)",
          flush=True)
    assert abs(total - CARD_BYTES) <= 0.01 * CARD_BYTES, (total, CARD_BYTES)
    cfg = get_arch("qwen2.5-3b").replace(dtype="bfloat16")
    mesh = AbstractMesh(("data", "model"), (1, 1))
    figures = {}
    for tag, (S, B, kind) in DRY_SHAPES.items():
        fn, args, specs = D.build_step(cfg, ShapeConfig(tag, S, B, kind), mesh)
        t0 = time.perf_counter()
        step = D.run_step(fn, args)
        dry_s = time.perf_counter() - t0
        meta = [t for t in _tensors(args) if t.is_meta]      # AdamW's step lives on the host
        dry = sum(t.numel() * t.element_size() for t in meta)
        per_device = D.argument_bytes(args, specs, {"data": 1, "model": 1})["total"]

        def make():
            params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
            if kind == "train":
                return (params, AdamW(momentum_dtype="float32").init(params),
                        {"tokens": torch.zeros((B, S), dtype=torch.int32, device="cuda")})
            return (params, init_cache(cfg, B, S, "cuda"),
                    torch.zeros((B, 1), dtype=torch.int32, device="cuda"),
                    torch.zeros((), dtype=torch.int32, device="cuda"))

        card, blocks, trees = allocated_bytes(make)
        n_cuda = sum(1 for t in _tensors(trees) if t.is_cuda)
        del trees
        gc.collect()
        torch.cuda.empty_cache()
        requested = sum(r for _, r in blocks)
        # the caching allocator rounds a request below 1 MiB up to 512 B, and
        # splits a larger block only when more than 1 MiB would be left over
        tails = [n - r for n, r in blocks if r >= 1 << 20 and n - r > 511]
        print(f"[dryrun card] {cfg.name} {tag} (B {B} x S {S}, {kind}): dry run argument bytes "
              f"{dry} on the card's side ({per_device} with the host's step scalar); the card's "
              f"{len(blocks)} tensors requested {requested} B (|d| {abs(requested - dry)}) and "
              f"were allocated {card} B, their blocks' sizes (+{card - requested}: "
              f"{len(tails)} large blocks keep a tail, {sum(tails)} B, the rest is 512-byte "
              f"rounding); whole step {step['flops']:.4e} FLOPs "
              f"({step['kernel_flops']:.4e} in kernels), peak estimate "
              f"{step['peak_bytes_est'] / 2**30:.2f} GiB; the dry run took {dry_s:.1f}s",
              flush=True)
        assert len(blocks) == n_cuda == len(meta), (len(blocks), n_cuda, len(meta))
        assert requested == dry, (tag, requested, dry)
        assert card == sum(n for n, _ in blocks), (tag, card, blocks)
        for n, r in blocks:
            assert 0 <= n - r <= (511 if r < 1 << 20 else (1 << 20) + 511), (tag, n, r)
        figures[tag] = {"argument_bytes": dry, "argument_bytes_with_host": per_device,
                        "requested_bytes": requested, "allocated_bytes": card,
                        "blocks_with_tails": len(tails), "total_memory": total,
                        "tensors": len(meta), "flops": step["flops"],
                        "kernel_flops": step["kernel_flops"],
                        "peak_bytes_est": step["peak_bytes_est"], "dry_run_s": dry_s,
                        "kernels": step["kernels"]}
    if train_figures is not None:
        t = train_figures["qwen2.5-3b"]
        peak = figures["train"]["peak_bytes_est"] / 2**30
        rate = figures["train"]["flops"] / t["s_per_step"]
        figures["train"].update({"measured_peak_gib": t["peak_memory_gib"],
                                 "peak_ratio": peak / t["peak_memory_gib"],
                                 "s_per_step": t["s_per_step"], "achieved_flop_s": rate})
        print(f"[dryrun card] 18c: peak estimate {peak:.2f} GiB against the measured "
              f"max_memory_allocated {t['peak_memory_gib']:.2f} GiB (ratio "
              f"{peak / t['peak_memory_gib']:.3f}); {figures['train']['flops']:.4e} FLOPs a step "
              f"over {t['s_per_step']:.3f} s/step = {rate / 1e12:.1f} TFLOP/s achieved "
              f"(a printed figure, not a claim)", flush=True)
    return figures


def tp_rank_job(rank, mesh, device, prompts, max_new):
    """19b, one rank: qwen2.5-3b at full width on this rank's shard
    (``tp`` ranks; ``kernel="reference"``), the audited step programs'
    collectives, then phase 5's prompts. Returns what the parent checks."""
    from repro_torch.analysis.step_audit import audit_program, collective_bytes, \
        default_contracts
    from repro_torch.configs import get_arch
    from repro_torch.kernels import decode_attention as ka
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.kernels import topk_retrieval as tk
    from repro_torch.models import init_params
    from repro_torch.serving.engine import GenerationEngine
    from repro_torch.serving.sharded_pool import ShardedPoolLayout

    cfg = get_arch("qwen2.5-3b").replace(dtype="bfloat16")
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0), device)
    eng = GenerationEngine(cfg, params=params, device=device, max_batch=8, max_seq=2048,
                           block_size=16, prefill_chunk_size=TP_CHUNK, kernel="reference",
                           pool_layout=ShardedPoolLayout(mesh))
    del params                       # the full tree: the engine holds this rank's shard
    gc.collect()
    torch.cuda.empty_cache()
    audit = {}
    for c in default_contracts(eng):
        traces = []
        findings = audit_program(eng, c, traces)
        audit[c.program] = {"findings": [str(f) for f in findings],
                            "ok": all(f.ok for f in findings),
                            "census": [k for k, _ in traces[0].collectives],
                            "bytes": collective_bytes(traces[0])}
    plans = []
    eng.control.recorded = plans
    first = keep_first_logits(eng)
    reset_launches(ka, kf, tk)
    t0 = time.perf_counter()
    reqs = [eng.submit(p, max_new=max_new) for p in prompts]
    eng.run_until_done()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = eng.stats()
    return {"tokens": [r.out_tokens for r in reqs],
            "first": {k: v.cpu() for k, v in first.items()},
            "audit": audit, "launches": read_launches(ka, kf, tk), "wall_s": wall,
            "steps": st["steps"], "decode_plans": sum(p.kind == "decode" for p in plans),
            "tp_degree": st["tp_degree"], "pool_shape": tuple(eng.kv.k.shape),
            "device": st["device"],
            "packed_tokens": -(-8 * TP_CHUNK // eng.pack_align) * eng.pack_align}


def phase_tp_card(ka, kf, tk):
    """19b: tensor parallelism's sharded math on the one card: ``TP`` ranks
    over gloo (``launch.mesh.run_on_ranks``) both on ``cuda:0``,
    qwen2.5-3b at full width (8 query heads over 1 KV head a rank),
    phase 5's prompts in chunks of ``TP_CHUNK`` at ``TP_MAX_NEW`` tokens
    through the gather oracles.
    Checks: the ranks' tokens equal; first-token logits against a tp 1
    engine on the same weights within ``logit_bound``; each rank's step
    programs 2 x 36 all-reduces of the Megatron formula's bytes and no
    all-gather, the pool roundtrip none; a world-size-1 layout engine equal
    to the unsharded engine bit for bit (tokens and pools)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_serving_mesh, run_on_ranks
    from repro_torch.models.shardmap_tp import megatron_collectives
    from repro_torch.serving.engine import GenerationEngine
    from repro_torch.serving.sharded_pool import ShardedPoolLayout

    print(f"[tp card] {TP} tensor-parallel ranks share the one card (cuda:0): this checks the "
          f"sharded math and its collectives, it is not a speedup", flush=True)
    cfg = get_arch_bf16("qwen2.5-3b")
    L = cfg.num_layers
    prompts = rag_workload(np.random.default_rng(0), cfg.vocab_size, 512, (64, 1025),
                           5, 4, (128, 1537), (32, 256, 384, 40))
    params, _ = draw_weights("tp card", cfg)
    common = dict(params=params, device="cuda", max_batch=8, max_seq=2048, block_size=16,
                  prefill_chunk_size=TP_CHUNK, kernel="reference")
    # the unsharded engine, then a world-size-1 layout engine on the same weights
    ref = GenerationEngine(cfg, **common)
    ref_first = keep_first_logits(ref)
    reset_launches(ka, kf, tk)
    ref_reqs = [ref.submit(p, max_new=TP_MAX_NEW) for p in prompts]
    ref.run_until_done()
    ref_tokens = [r.out_tokens for r in ref_reqs]
    ref_launches = read_launches(ka, kf, tk)
    reference = {"prompts": prompts, "tokens": ref_tokens,
                 "first": {rid: v.cpu() for rid, v in ref_first.items()}}
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        one = GenerationEngine(cfg, **common, pool_layout=ShardedPoolLayout(make_serving_mesh(1)))
        one_reqs = [one.submit(p, max_new=TP_MAX_NEW) for p in prompts]
        one.run_until_done()
        assert [r.out_tokens for r in one_reqs] == ref_tokens, "world-size-1 layout tokens differ"
        assert torch.equal(one.kv.k, ref.kv.k) and torch.equal(one.kv.v, ref.kv.v), \
            "world-size-1 layout pools differ"
        census_one = one.audit_collectives("fused")   # its pad tokens write the scratch block
    finally:
        dist.destroy_process_group()
    assert not any(v for k, v in census_one.items()), census_one
    print(f"[tp card] world-size-1 layout engine: tokens and pools equal the unsharded "
          f"engine's bit for bit, its fused step collective-free", flush=True)
    del ref, one, params, common
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ranks = run_on_ranks(tp_rank_job, TP, "cuda:0", prompts, TP_MAX_NEW)
    wall = time.perf_counter() - t0
    r0 = ranks[0]
    assert all(r["tokens"] == r0["tokens"] for r in ranks), "the ranks' tokens differ"
    assert all(r["tp_degree"] == TP for r in ranks)
    kvh = cfg.num_kv_heads // TP
    assert r0["pool_shape"][3] == kvh, r0["pool_shape"]
    agree = float(np.mean([a == b for ra, rb in zip(r0["tokens"], ref_tokens)
                           for a, b in zip(ra, rb)]))
    first_equal = sum(ra[0] == rb[0] for ra, rb in zip(r0["tokens"], ref_tokens))
    bound = logit_bound(L)
    rel = {}
    for rid, lg in sorted(r0["first"].items()):
        want = ref_first[rid].cpu()
        assert bool(torch.isfinite(lg).all()), rid
        rel[rid] = float((lg - want).abs().max() / want.abs().max())
    worst = max(rel.values())
    formula = {"fused_ragged": megatron_collectives(cfg, r0["packed_tokens"], 2, TP),
               "decode": megatron_collectives(cfg, 8, 2, TP),
               "decode_ref": megatron_collectives(cfg, 8, 2, TP),
               "pool": {"all-reduce": 0, "all-reduce_bytes": 0}}
    for i, r in enumerate(ranks):
        for prog, a in r["audit"].items():
            n_ar = sum(k == "all-reduce" for k in a["census"])
            assert n_ar == formula[prog]["all-reduce"], (i, prog, a)
            assert set(a["census"]) <= {"all-reduce"}, (i, prog, a)
            assert a["bytes"].get("all-reduce", 0) == formula[prog]["all-reduce_bytes"], \
                (i, prog, a["bytes"], formula[prog])
            assert a["ok"], (i, prog, a["findings"])
        assert r["launches"]["decode_attention"] == L * r["decode_plans"] > 0, r["launches"]
        assert r["launches"]["paged_chunk_attention"] == 0, r["launches"]
        assert r["launches"]["paged_decode_attention"] == 0, r["launches"]
    for line in r0["audit"]["fused_ragged"]["findings"] + r0["audit"]["pool"]["findings"]:
        print(f"[tp card] rank 0 audit: {line}", flush=True)
    print(f"[tp card] {TP} ranks on cuda:0, {cfg.name} at full width ({cfg.num_heads // TP} "
          f"query heads over {kvh} KV head a rank, pool shard {r0['pool_shape']}): "
          f"{len(prompts)} requests x {TP_MAX_NEW} tokens, ranks equal; greedy tokens against "
          f"the tp 1 engine {agree:.3f} equal ({first_equal}/{len(prompts)} first tokens); "
          f"first-token logits max |d| / max |logit| {[round(x, 5) for x in rel.values()]}, "
          f"worst {worst:.5f} (bound {bound:.3f}); all-reduces a step program "
          f"{ {p: formula[p]['all-reduce'] for p in formula} } with the formula's bytes, no "
          f"all-gather; launches a rank {r0['launches']} (tp 1: {ref_launches}); "
          f"{r0['steps']} steps, ranks' serve wall {r0['wall_s']:.1f}s, phase spawn-to-join "
          f"{wall:.1f}s", flush=True)
    assert worst <= bound, (rel, bound)
    return {"ranks": TP, "device": r0["device"], "token_agreement": agree,
            "first_tokens_equal": first_equal, "first_logit_rel": rel, "bound": bound,
            "all_reduce": {p: f["all-reduce"] for p, f in formula.items()},
            "all_reduce_bytes": {p: f["all-reduce_bytes"] for p, f in formula.items()},
            "launches": r0["launches"], "decode_plans": r0["decode_plans"],
            "steps": r0["steps"], "serve_wall_s": r0["wall_s"], "phase_wall_s": wall,
            "audit_rank0": r0["audit"]}, reference


# 19c: the data axis of a serving mesh, (dp, tp) ranks on the one card,
# in 256-token chunks: the gather oracle's per-token K/V view at 8 x 512
# packed tokens peaks at ~13 GB a rank (bf16 gathers and their f32
# upcasts), and four ranks of it beside their weights exceed the card
DP_MESH = (2, 2)
DP_MESH_CHUNK = 256


def dp_mesh_rank_job(rank, mesh, device, prompts, max_new):
    """19c, one rank of a (dp, tp) mesh: qwen2.5-3b at full width, its
    row's replica of a ``DataParallelEngineGroup`` over its block range of
    its heads (``dp_blocks``), with a write-through host tier; the audited
    step programs' collectives by group, then phase 5's prompts in the two
    ``DP_WAVES`` in ``DP_MESH_CHUNK``-token chunks. Returns what the parent
    checks."""
    from repro_torch.analysis.step_audit import audit_program, default_contracts, group_census
    from repro_torch.configs import get_arch
    from repro_torch.kernels import decode_attention as ka
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.kernels import topk_retrieval as tk
    from repro_torch.models import init_params
    from repro_torch.serving.engine import DataParallelEngineGroup
    from repro_torch.serving.sharded_pool import ShardedPoolLayout

    cfg = get_arch("qwen2.5-3b").replace(dtype="bfloat16")
    layout = ShardedPoolLayout(mesh, dp_blocks=True)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0), device)
    grp = DataParallelEngineGroup(cfg, dp=layout.dp_degree, params=params, device=device,
                                  max_batch=8, max_seq=2048, block_size=16,
                                  prefill_chunk_size=DP_MESH_CHUNK, kernel="reference",
                                  pool_layout=layout, host_blocks=1024)
    del params                       # the full tree: the group holds this rank's shard
    gc.collect()
    torch.cuda.empty_cache()
    eng = grp.engine
    audit = {}
    for c in default_contracts(eng):
        traces = []
        findings = audit_program(eng, c, traces)
        audit[c.program] = {"findings": [str(f) for f in findings],
                            "ok": all(f.ok for f in findings),
                            "by_group": group_census(traces[0], layout)}
    plans = []
    eng.control.recorded = plans
    first = keep_first_logits(eng)
    reset_launches(ka, kf, tk)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = [None] * len(prompts)
    for wave in DP_WAVES:
        for i in wave:
            reqs[i] = grp.submit(prompts[i], max_new=max_new)
        grp.run_until_done()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = grp.stats()
    routes = [grp.replica_of(r) for r in reqs]
    mine = {i: first[r.req_id].cpu() for i, r in enumerate(reqs) if routes[i] == layout.dp_rank}
    return {"row": layout.dp_rank, "column": layout.tp_rank,
            "tokens": [r.out_tokens for r in reqs], "routes": routes, "first": mine,
            "audit": audit, "launches": read_launches(ka, kf, tk), "wall_s": wall,
            "steps": [s["steps"] for s in st["replicas"]],
            "decode_plans": sum(p.kind == "decode" for p in plans),
            "pool_shape": tuple(eng.kv.k.shape),
            "pool_bytes": sum(t.untyped_storage().nbytes() for t in (eng.kv.k, eng.kv.v)),
            "n_blocks": eng.kv.pool.n_blocks, "block_range": (eng.kv.pool.base,
                                                              eng.kv.pool.base
                                                              + eng.kv.pool.n_owned),
            "cross_replica_host_hits": st["cross_replica_host_hits"],
            "host_hit_tokens": st["host_hit_tokens"], "exchanges": grp.exchanges,
            "device": str(eng.device),
            "packed_tokens": -(-8 * DP_MESH_CHUNK // eng.pack_align) * eng.pack_align}


def phase_dp_mesh_card(ka, kf, tk, reference):
    """19c: the data axis of a serving mesh on the one card: a (dp 2, tp 2)
    mesh of 4 ranks over gloo, all on ``cuda:0`` (``launch.mesh.
    run_on_ranks``), qwen2.5-3b at full width, each row one replica of a
    ``DataParallelEngineGroup(pool_layout=ShardedPoolLayout(mesh,
    dp_blocks=True))`` over its block range of its KV head, serving phase
    5's prompts in ``DP_WAVES`` at ``TP_MAX_NEW`` tokens, in
    ``DP_MESH_CHUNK``-token chunks.
    Checks: every rank's pool shard (36, total / 2, 16, 1, 128) and its
    storage that shape's bytes; the four ranks' tokens equal; each row's
    first-token logits against 19b's tp 1 engine within
    ``logit_bound(36)``; per step program 72 all-reduces of the Megatron
    formula's bytes on the "model" group, none on the "data" group, the
    pool roundtrip none; ``decode_attention`` 36 a decode plan of the row,
    no paged kernel; cross-replica host hits. Prints each rank's serve
    wall, each replica's steps and the host-tier exchange's bytes a group
    step."""
    from repro_torch.launch.mesh import run_on_ranks
    from repro_torch.models.shardmap_tp import megatron_collectives

    dp, tp = DP_MESH
    cfg = get_arch_bf16("qwen2.5-3b")
    L = cfg.num_layers
    prompts, ref_tokens, ref_first = (reference[k] for k in ("prompts", "tokens", "first"))
    print(f"[dp mesh] a ({dp}, {tp}) ('data', 'model') mesh of {dp * tp} ranks shares the one "
          f"card (cuda:0): this checks the rows' placement, math and exchanges, it is not a "
          f"speedup", flush=True)
    t0 = time.perf_counter()
    ranks = run_on_ranks(dp_mesh_rank_job, tp, "cuda:0", prompts, TP_MAX_NEW, dp=dp)
    wall = time.perf_counter() - t0
    r0 = ranks[0]
    assert [(r["row"], r["column"]) for r in ranks] == [(d, m) for d in range(dp)
                                                        for m in range(tp)]
    assert all(r["tokens"] == r0["tokens"] and r["routes"] == r0["routes"] for r in ranks), \
        "the ranks' tokens differ"
    per = 8 * (2048 // 16 + 1) + 1
    want_shape = (L, per, 16, cfg.num_kv_heads // tp, cfg.head_dim)
    for r in ranks:
        assert r["n_blocks"] == dp * per and r["pool_shape"] == want_shape, r["pool_shape"]
        assert r["pool_bytes"] == 2 * math.prod(want_shape) * 2, r["pool_bytes"]
        assert r["block_range"] == (r["row"] * per, (r["row"] + 1) * per), r["block_range"]
    bound = logit_bound(L)
    rel = {}
    for r in ranks:
        for i, lg in r["first"].items():
            want = ref_first[i]
            assert bool(torch.isfinite(lg).all()), i
            rel[(r["row"], r["column"], i)] = float((lg - want).abs().max() / want.abs().max())
    assert len({i for (_, _, i) in rel}) == len(prompts), sorted(rel)
    worst = max(rel.values())
    agree = agreement(r0["tokens"], ref_tokens)
    first_equal = sum(a[0] == b[0] for a, b in zip(r0["tokens"], ref_tokens))
    formula = {"fused_ragged": megatron_collectives(cfg, r0["packed_tokens"], 2, tp),
               "decode": megatron_collectives(cfg, 8, 2, tp),
               "decode_ref": megatron_collectives(cfg, 8, 2, tp),
               "pool": {"all-reduce": 0, "all-reduce_bytes": 0}}
    for r in ranks:
        for prog, a in r["audit"].items():
            model, data = a["by_group"]["model"], a["by_group"]["data"]
            assert set(a["by_group"]) == {"model", "data"}, (r["row"], prog, a["by_group"])
            assert model.get("all-reduce", 0) == formula[prog]["all-reduce"], (prog, model)
            assert model.get("all-reduce_bytes", 0) == formula[prog]["all-reduce_bytes"], \
                (prog, model, formula[prog])
            assert set(k for k in model if not k.endswith("_bytes")) <= {"all-reduce"}, model
            assert not data, (prog, data)
            assert a["ok"], (r["row"], prog, a["findings"])
        assert r["launches"]["decode_attention"] == L * r["decode_plans"] > 0, r["launches"]
        assert r["launches"]["paged_chunk_attention"] == 0, r["launches"]
        assert r["launches"]["paged_decode_attention"] == 0, r["launches"]
    assert r0["cross_replica_host_hits"] > 0 and r0["host_hit_tokens"] > 0, r0
    steps_ex = [(n, b) for n, b in r0["exchanges"] if n]
    for line in r0["audit"]["fused_ragged"]["findings"] + r0["audit"]["pool"]["findings"]:
        print(f"[dp mesh] rank 0 audit: {line}", flush=True)
    print(f"[dp mesh] {dp * tp} ranks on cuda:0, {cfg.name} at full width, rows = replicas "
          f"over block ranges ({per} of {dp * per} blocks a rank, pool shard {want_shape}, "
          f"{r0['pool_bytes']} B k+v a rank): {len(prompts)} requests x {TP_MAX_NEW} tokens "
          f"in waves {DP_WAVES} routed {r0['routes']}, ranks equal; greedy tokens against the "
          f"tp 1 engine {agree:.3f} equal ({first_equal}/{len(prompts)} first tokens); "
          f"first-token logits max |d| / max |logit| worst {worst:.5f} (bound {bound:.3f}); "
          f"all-reduces a step program on the model group "
          f"{ {p: formula[p]['all-reduce'] for p in formula} } with the formula's bytes, none "
          f"on the data group; launches a rank {r0['launches']}; replica steps {r0['steps']}; "
          f"decode plans a row {[r['decode_plans'] for r in ranks[::tp]]}; cross-replica host "
          f"hits {r0['cross_replica_host_hits']}, host-hit tokens {r0['host_hit_tokens']}; "
          f"host-tier exchange: {len(r0['exchanges'])} group steps, {len(steps_ex)} carried "
          f"blocks, {[b for _, b in steps_ex]} B (blocks {[n for n, _ in steps_ex]}); "
          f"ranks' serve wall {[round(r['wall_s'], 1) for r in ranks]} s; phase spawn-to-join "
          f"{wall:.1f}s", flush=True)
    assert worst <= bound, (rel, bound)
    return {"mesh": {"data": dp, "model": tp}, "device": r0["device"], "routes": r0["routes"],
            "token_agreement": agree, "first_tokens_equal": first_equal,
            "first_logit_rel_worst": worst, "bound": bound, "pool_shape": want_shape,
            "pool_bytes_a_rank": r0["pool_bytes"],
            "all_reduce_model_group": {p: f["all-reduce"] for p, f in formula.items()},
            "all_reduce_bytes_model_group": {p: f["all-reduce_bytes"]
                                             for p, f in formula.items()},
            "launches": r0["launches"], "decode_plans": [r["decode_plans"] for r in ranks],
            "replica_steps": r0["steps"], "serve_wall_s": [r["wall_s"] for r in ranks],
            "phase_wall_s": wall, "cross_replica_host_hits": r0["cross_replica_host_hits"],
            "host_hit_tokens": r0["host_hit_tokens"],
            "exchange_blocks_bytes": r0["exchanges"]}


def get_arch_bf16(name):
    from repro_torch.configs import get_arch

    return get_arch(name).replace(dtype="bfloat16")


def timed(name, fn, *args):
    """Run one phase and print its wall time."""
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"[phase] {name}: {time.perf_counter() - t0:.1f}s wall", flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    from repro_torch.configs import get_arch
    from repro_torch.data.workload import synthetic_corpus
    from repro_torch.kernels import decode_attention as ka
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.kernels import rwkv6_scan as kw
    from repro_torch.kernels import ssm_scan as ks
    from repro_torch.kernels import topk_retrieval as tk
    from repro_torch.kernels._build import build_all
    from repro_torch.models import init_params

    t_start = time.perf_counter()
    card = card_line()
    print(f"[device] {card} | torch.cuda.get_device_name: {torch.cuda.get_device_name(0)} "
          f"| torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    libs = build_all()
    print(f"[build] {len(libs)} sources in parallel in {time.perf_counter() - t0:.2f}s",
          flush=True)
    for lib in libs.values():
        regs = sorted({ln.strip() for ln in lib.ptxas.splitlines() if "registers" in ln})
        print(f"[build] {lib.source.relative_to(ROOT)} -> {lib.path.name} in "
              f"{lib.build_s:.2f}s; ptxas: {regs}", flush=True)

    def no_scan(name, fn, *args):
        """A phase of an earlier slice: it must launch no selective scan."""
        ks.reset_launch_counts()
        out = timed(name, fn, *args)
        assert ks.ssm_scan.launches == 0, (name, ks.ssm_scan.launches)
        return out

    rows = no_scan("paged attention kernels", phase_kernels, ka)
    dense_rows = no_scan("dense attention kernels", phase_dense_kernels, ka, kf)
    wkv_rows = no_scan("rwkv6 wkv kernel", phase_wkv_kernel, kw)
    ssm_rows = timed("ssm scan kernel", phase_ssm_kernel, ks)
    swa_rows = no_scan("windowed flash kernel", phase_swa_kernels, kf)
    swa_decode_rows = no_scan("hymba decode kernel", phase_swa_decode_kernel, ka)
    win_flash_rows, win_decode_rows = no_scan("window 4096 kernels", phase_window_kernels, ka,
                                              kf)
    chunk_rows, mla_rows, l4_decode_rows = no_scan("chunk and mla kernels",
                                                   phase_chunk_mla_kernels, ka, kf)
    cross_rows, enc_rows, zoo_decode_rows = no_scan("cross and g1/g7 kernels",
                                                    phase_cross_kernels, ka, kf)
    # the queries are drawn as benchmarks/retrieval_knob.py draws them
    corpus, queries = no_scan("synthetic_corpus on the host", lambda: (
        synthetic_corpus(N_DOCS, DIM, seed=0), synthetic_corpus(N_QUERIES, DIM, seed=7)))
    corpus_gpu, queries_gpu = torch.from_numpy(corpus).cuda(), torch.from_numpy(queries).cuda()
    topk_rows = no_scan("top-k kernel", phase_topk, tk, corpus_gpu, queries_gpu)
    del corpus_gpu
    torch.cuda.empty_cache()
    no_scan("engine parity", phase_parity)
    no_scan("pipeline parity", phase_pipeline_parity)
    no_scan("dense parity", phase_dense_parity, ka, kf, kw)
    no_scan("rwkv parity", phase_rwkv_parity, kw)
    timed("hymba parity", phase_hymba_parity, ka, kf, ks)
    no_scan("int8 and swap parity", phase_int8_swap_parity)
    no_scan("swa and moe parity", phase_swa_moe_parity, ka, kf)
    parity_logits = no_scan("chunk and mla parity", phase_chunk_mla_parity, ka, kf)
    zoo_parity = no_scan("internvl2, whisper and int8 dense parity", phase_zoo_parity, ka, kf)

    cfg = get_arch("qwen2.5-3b").replace(dtype="bfloat16")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    serve_launches, prompts, paged_tokens, bf16_pool = no_scan("serve", phase_serve, ka, kf,
                                                               tk, cfg, params)
    launches = {"serve": serve_launches}
    launches["int8 serve"], int8_figures = no_scan(
        "int8 serve", phase_int8_serve, ka, kf, tk, cfg, params, prompts, paged_tokens,
        bf16_pool)
    launches["host tier"], host_figures = no_scan("host tier", phase_host_tier, ka, kf, tk,
                                                  cfg, params, prompts)
    launches["oracles"], oracle_figures = no_scan(
        "oracle paths and kvsan", phase_oracles, ka, kf, tk, cfg, params, prompts, host_figures)
    launches["dense serve"] = no_scan("dense serve", phase_dense_serve, ka, kf, tk, cfg, params,
                                      prompts, paged_tokens)
    launches["rag"] = no_scan("rag", phase_rag, ka, kf, tk, cfg, params, corpus, queries_gpu)
    launches["pipelines"] = no_scan("pipelines", phase_pipelines, ka, kf, tk, cfg, params)
    launches["controller"], controller_figures = no_scan("controller", phase_controller, ka,
                                                         kf, tk, cfg, params)
    launches["swa serve"], swa_figures, swa_tokens = no_scan("swa serve", phase_swa_serve, ka,
                                                             kf, tk, params, prompts)
    launches["swa int8 serve"], swa_int8_figures = no_scan(
        "swa int8 serve", phase_swa_int8_serve, ka, kf, tk, params, prompts, swa_tokens,
        swa_figures)
    launches["audit"], audit_figures = no_scan("step audit", phase_audit, ka, kf, tk, cfg,
                                               params)
    dp_launches, dp_figures = no_scan("dp replicas", phase_dp, ka, kf, tk, cfg, params,
                                      prompts, paged_tokens)
    launches.update({f"dp {k}": v for k, v in dp_launches.items()})
    del params                       # room for mixtral's ~41 GB of bf16 weights
    gc.collect()                     # engines hold reference cycles
    torch.cuda.empty_cache()
    launches["mixtral serve"], mixtral_figures = no_scan("mixtral serve", phase_mixtral_serve,
                                                         ka, kf, tk, prompts)
    gc.collect()                     # mixtral's weights go before llama4-scout's
    torch.cuda.empty_cache()
    launches["llama4 serve"], llama4_figures = no_scan("llama4 serve", phase_llama4_serve, ka,
                                                       kf, tk, prompts)
    gc.collect()                     # llama4-scout's weights go before minicpm3's
    torch.cuda.empty_cache()
    launches["minicpm3 serve"], minicpm3_figures = no_scan("minicpm3 serve",
                                                           phase_minicpm3_serve, ka, kf, tk,
                                                           prompts)
    gc.collect()                     # minicpm3's weights go before rwkv6-7b's
    torch.cuda.empty_cache()
    launches["rwkv serve"] = no_scan("rwkv serve", phase_rwkv_serve, ka, kf, tk, prompts)
    gc.collect()                     # rwkv6-7b's weights go before hymba-1.5b's
    torch.cuda.empty_cache()
    launches["hymba serve"] = timed("hymba serve", phase_hymba_serve, ka, kf, tk, prompts)
    gc.collect()                     # hymba-1.5b's weights go before internvl2-1b's
    torch.cuda.empty_cache()
    internvl2_launches, internvl2_figures = no_scan("internvl2 serve", phase_internvl2_serve, ka,
                                                    kf, tk, prompts)
    launches["internvl2 serve"] = internvl2_launches["model_api"]
    launches["internvl2 engine"] = internvl2_launches["engine"]
    gc.collect()
    torch.cuda.empty_cache()
    launches["whisper serve"], whisper_figures = no_scan("whisper serve", phase_whisper_serve, ka,
                                                         kf, tk)
    gc.collect()
    torch.cuda.empty_cache()
    bwd_rows = no_scan("flash backward kernel", phase_backward_kernel, kf)
    scan_bwd_rows = timed("scan backward kernels", phase_scan_backward_kernels, kw, ks)
    stack_figures = timed("train stack gradient", phase_train_stack, ka, kf, tk)
    train_figures = no_scan("train", phase_train, ka, kf, tk)
    for arch in ("qwen2.5-3b", "smollm-135m"):
        launches[f"train {arch}"] = train_figures[arch]["launches"]
    form_train_figures = no_scan("train forms", phase_train_forms, ka, kf, tk)
    scan_train_figures = timed("train scans", phase_train_forms, ka, kf, tk, SCAN_TRAIN,
                               "train scans")
    for arch, x in {**form_train_figures, **scan_train_figures}.items():
        launches[f"train {arch}"] = x["launches"]
    guard_figures = no_scan("grad guards", phase_grad_guards, ka, kf, tk)
    dryrun_figures = no_scan("dry run on the card", phase_dryrun_card, train_figures)
    reset_launches(ka, kf, tk)
    tp_figures, tp_reference = no_scan("tensor parallel on the card", phase_tp_card, ka, kf,
                                       tk)
    launches["tp card rank 0"] = tp_figures["launches"]
    reset_launches(ka, kf, tk)
    dp_mesh_figures = no_scan("data axis of a serving mesh on the card", phase_dp_mesh_card, ka,
                              kf, tk, tp_reference)
    launches["dp mesh rank 0"] = dp_mesh_figures["launches"]

    kernels = []
    for name in ("paged_chunk_attention", "paged_decode_attention"):
        r = rows[(name, "bfloat16")]     # the dtype the serve phase runs
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches["serve"][name],
            "max_abs_err": r["errs"]["plain"], "ms": r["ms"], "device_ms": r["device_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            # every check of every dtype: {dtype: {check: max abs err}}
            "max_abs_err_by_check": {d: rows[(name, d)]["errs"]
                                     for d in ("float32", "bfloat16", "int8")},
            **({"split_edges": {d: rows[(name, d)]["split_edges"]
                                for d in ("float32", "bfloat16", "int8")}}
               if name == "paged_decode_attention" else {}),
            "launches_by_phase": {ph: n[name] for ph, n in launches.items()},
            # the kernel on the engine's int8 pools: device ms a step of
            # both paged kernels inside the int8 serve's step profile
            "int8_serve_step_ms": {
                step: int8_figures["step_profile"][step]["paged_attention_ms"]
                for step in ("mixed", "decode-only")},
        })
    # the chunk kernel at the engine's mixed step
    chunk = next(k for k in kernels if k["name"] == "paged_chunk_attention")
    chunk["mixed_step"] = {
        "shape": {"lengths": MIXED_LENGTHS, "chunks": MIXED_CHUNKS, "pads": MIXED_PAD},
        **{d: {key2: rows[("paged_chunk_attention", d, "mixed_step")].get(key2)
               for key2 in ("errs", "ms", "device_ms", "device_ms_bf16_q", "plain_ms",
                            "library_ms", "bound_ms", "bound_by")}
           for d in ("float32", "bfloat16", "int8")},
    }
    # the RAG phase's shape: float32 index, B=32, k=10 (recall_at_k)
    r = topk_rows[("float32", 10)]
    kernels.append({
        "name": "topk_retrieval", "route": "cuda", "source": SOURCES["topk_retrieval"],
        "replaces": REPLACES["topk_retrieval"], "launches": launches["rag"]["topk_retrieval"],
        "max_abs_err": max(x["max_abs_err"] for x in topk_rows.values()), "ms": r["ms"],
        "device_ms": r["device_ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"],
        "library_ms": r["library_ms"],
        "by_case": {f"{c}/k={k}": {key: x.get(key) for key in
                                   ("max_abs_err", "swapped", "ms", "device_ms", "plain_ms",
                                    "library_ms", "library", "bound_ms", "bound_by",
                                    "products")}
                    for (c, k), x in topk_rows.items()},
        "launches_by_phase": {ph: n["topk_retrieval"] for ph, n in launches.items()},
    })
    # the dense serve phase's shapes in bf16: flash at S=2048 causal (its
    # largest bucket), decode over the phase-2 lengths
    for name, key in (("flash_attention", (FLASH_S[-1], True)), ("decode_attention", ("lengths",))):
        r = dense_rows[(name, "bfloat16", *key)]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches["dense serve"][name],
            "max_abs_err": r["errs"]["plain"], "ms": r["ms"], "device_ms": r["device_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "max_abs_err_by_case": {"/".join(map(str, k[1:])): x["errs"]
                                    for k, x in dense_rows.items() if k[0] == name},
            "float32": {key2: dense_rows[(name, "float32", *key)][key2]
                        for key2 in ("ms", "device_ms", "plain_ms", "library_ms", "bound_ms")},
            **({"mixed_step": {d: {key2: dense_rows[(name, d, "mixed_step")][key2]
                                   for key2 in ("ms", "device_ms", "plain_ms", "library_ms",
                                                "bound_ms", "bound_by")}
                               for d in ("float32", "bfloat16")}}
               if name == "decode_attention" else {}),
            "launches_by_phase": {ph: n[name] for ph, n in launches.items()},
        })
    # the rwkv serve phase's shapes in bf16: prefill at S=2048 (the longest
    # prompt the engine admits), and a decode step at B=8
    r = wkv_rows[("bfloat16", "prefill", 2048)]
    kernels.append({
        "name": "rwkv6_chunked", "route": "cuda", "source": SOURCES["rwkv6_chunked"],
        "replaces": REPLACES["rwkv6_chunked"], "launches": launches["rwkv serve"]["rwkv6_chunked"],
        "max_abs_err": r["errs"]["plain"], "ms": r["ms"], "device_ms": r["device_ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
        "library_ms": None,
        "library": "none: no single PyTorch call computes the WKV recurrence",
        "segments": r["segments"],
        "max_abs_err_by_case": {f"{d}/{c}/S={S}": x["errs"]["plain"]
                                for (d, c, S), x in wkv_rows.items()},
        "decode": {key2: wkv_rows[("bfloat16", "decode", 1)][key2]
                   for key2 in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by")},
        "float32": {key2: wkv_rows[("float32", "prefill", 2048)][key2]
                    for key2 in ("ms", "device_ms", "plain_ms", "bound_ms")},
        "launches_by_phase": {ph: n["rwkv6_chunked"] for ph, n in launches.items()},
    })
    # the hymba serve phase's shapes in bf16: prefill at S=1664 (128 meta +
    # the longest prompt, 1536 tokens), and a decode step at B=8
    r = ssm_rows[("bfloat16", "prefill", 1664)]
    kernels.append({
        "name": "ssm_scan", "route": "cuda", "source": SOURCES["ssm_scan"],
        "replaces": REPLACES["ssm_scan"], "launches": launches["hymba serve"]["ssm_scan"],
        "max_abs_err": r["errs"]["plain"], "ms": r["ms"], "device_ms": r["device_ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
        "library_ms": None,
        "library": "none: no single PyTorch call computes the selective scan",
        "segments": r["segments"],
        "bound_parts_ms": {"bytes": r["bytes"] / HBM_BYTES_S * 1e3, "flops": r["flop_ms"],
                           "exponentials": r["exp_ms"]},
        "max_abs_err_by_case": {f"{d}/{c}/S={S}": x["errs"] for (d, c, S), x in ssm_rows.items()},
        "decode": {key2: ssm_rows[("bfloat16", "decode", 1)][key2]
                   for key2 in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by")},
        "float32": {key2: ssm_rows[("float32", "prefill", 1664)][key2]
                    for key2 in ("ms", "device_ms", "plain_ms", "bound_ms")},
        "launches_by_phase": {ph: n["ssm_scan"] for ph, n in launches.items()},
    })
    # the flash kernel's windowed case (hymba serve: S up to 1664, window 1024)
    flash = next(k for k in kernels if k["name"] == "flash_attention")
    flash["window"] = {
        "max_abs_err_by_case": {f"{d}/S={S}/window={w}": x["errs"]
                                for (d, S, w), x in swa_rows.items()},
        **{d: {key2: swa_rows[(d, *SWA_CASES[0])][key2]
               for key2 in ("ms", "device_ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}
           for d in ("float32", "bfloat16")},
    }
    # the decode kernel at the hymba serve phase's shapes
    dec = next(k for k in kernels if k["name"] == "decode_attention")
    dec["hymba"] = {
        "shape": {"B": B, "H": SWA_H, "KVH": SWA_KVH, "hd": SWA_HD,
                  "Sc": SWA_SC, "lengths": SWA_DECODE_CASES},
        **{f"{d}/{c}": {key2: swa_decode_rows[(d, c)][key2]
                        for key2 in ("errs", "ms", "device_ms", "plain_ms", "library_ms",
                                     "bound_ms", "bound_by")}
           for d in ("float32", "bfloat16") for c in SWA_DECODE_CASES},
    }
    # the two kernels at a 4096 window (phases 10 and 11's shapes)
    flash["window_4096"] = {
        f"{g}/{d}/S={S}": {key2: x.get(key2) for key2 in
                           ("errs", "ms", "device_ms", "plain_ms", "library_ms", "bound_ms",
                            "bound_by")}
        for g, rows_g in win_flash_rows.items() for (d, S, _), x in rows_g.items()}
    dec["mixtral"] = {
        "shape": {"B": B, "heads": WIN_HEADS["G6"], "Sc": WIN, "lengths": WIN_DECODE_CASES},
        **{f"{d}/{c}": {key2: win_decode_rows[(d, c)][key2]
                        for key2 in ("errs", "ms", "device_ms", "plain_ms", "library_ms",
                                     "bound_ms", "bound_by")}
           for d in ("float32", "bfloat16") for c in WIN_DECODE_CASES},
    }
    # the flash kernel with a chunk (phase 12's prefill) and at MLA's split
    # head dims (phase 13's); the decode kernel on llama4's caches
    phase_keys = ("errs", "ms", "device_ms", "plain_ms", "library_ms", "bound_ms", "bound_by")
    flash["chunked"] = {f"{d}/S={S}/chunk={c}": {key2: x.get(key2) for key2 in phase_keys}
                        for (d, S, c), x in chunk_rows.items()}
    flash["mla_96_64"] = {f"{d}/S={S}": {key2: x.get(key2) for key2 in phase_keys}
                          for (d, S), x in mla_rows.items()}
    dec["llama4"] = {
        "shape": {"B": B, "heads": L4_HEADS, "cases": L4_DECODE_CASES},
        **{f"{d}/{c}": {key2: l4_decode_rows[(d, c)][key2] for key2 in phase_keys}
           for d in ("float32", "bfloat16") for c in L4_DECODE_CASES},
    }
    # the flash kernel's cross form and whisper's causal encoder (phase 15's
    # shapes); the decode kernel at G 1 (whisper's cross cache) and G 7
    # (internvl2)
    flash["cross"] = {
        "shape": {"B": B, "heads": WHISPER_HEADS, "S_kv": ENC_SEQ},
        **{f"{d}/S={S}/S_kv={ENC_SEQ}": {key2: x.get(key2) for key2 in phase_keys}
           for (d, S), x in cross_rows.items()}}
    flash["whisper_encoder"] = {f"{d}/S={ENC_SEQ}/causal": {key2: x.get(key2)
                                                            for key2 in phase_keys}
                                for d, x in enc_rows.items()}
    dec["whisper_cross_g1"] = {
        "shape": {"B": B, "heads": WHISPER_HEADS, "Sc": ENC_SEQ},
        **{f"{d}/{c}": {key2: zoo_decode_rows[(d, c)][key2] for key2 in phase_keys}
           for d in ("float32", "bfloat16") for c in WHISPER_DECODE_CASES}}
    dec["internvl2_g7"] = {
        "shape": {"B": B, "heads": INTERNVL2_HEADS, "Sc": INTERNVL2_SC,
                  "lengths": INTERNVL2_DECODE_CASES},
        **{f"{d}/{c}": {key2: zoo_decode_rows[(d, c)][key2] for key2 in phase_keys}
           for d in ("float32", "bfloat16") for c in INTERNVL2_DECODE_CASES}}
    # the flash backward at qwen2.5-3b's training microbatch (bf16, B 1, S
    # 2048); every form's timed shape in both dtypes beside it
    r = bwd_rows[("qwen2.5-3b", "bfloat16", *BWD_FORMS["qwen2.5-3b"][4])]
    timed_keys = ("ms", "device_ms", "plain_ms", "library_ms", "bound_ms", "bound_by")
    kernels.append({
        "name": "flash_attention_backward", "route": "cuda",
        "source": SOURCES["flash_attention_backward"],
        "replaces": REPLACES["flash_attention_backward"],
        "launches": launches["train qwen2.5-3b"]["flash_attention_backward"],
        "max_abs_err": max(r["max_abs_err"].values()), "ms": r["ms"],
        "device_ms": r["device_ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        "library": "the backward of scaled_dot_product_attention(enable_gqa=True) on the "
                   "same form (is_causal; a boolean mask for a window or a chunk), timed apart "
                   "from its forward",
        "forms": {f"{a}/{d}/B={b_}/S={s_}": {key2: x[key2] for key2 in timed_keys}
                  for (a, d, b_, s_), x in bwd_rows.items() if "ms" in x},
        "by_case": {f"{a}/{d}/B={b_}/S={s_}": {"max_abs_err": x["max_abs_err"],
                                               "excess": x["excess"],
                                               "controls": x["controls"]}
                    for (a, d, b_, s_), x in bwd_rows.items()},
        "stack_gradient": stack_figures,
        "launches_by_phase": {ph: n.get("flash_attention_backward", 0)
                              for ph, n in launches.items()},
    })
    # the scans' backward at the training microbatch of 18i (bf16): rwkv6-7b's
    # heads at S 2048, hymba-1.5b's scan at S 2176 (128 meta tokens + 2048)
    scan_keys = ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "bytes", "ops", "exps",
                 "segments")
    for name, arch in (("rwkv6_chunked_backward", "rwkv6-7b"),
                       ("ssm_scan_backward", "hymba-1.5b")):
        Bm, Sm = SCAN_BWD_CASES[name][0]
        r = scan_bwd_rows[(name, "bfloat16", Bm, Sm, False)]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
            "launches": launches[f"train {arch}"][name],
            "max_abs_err": max(r["max_abs_err"].values()), "ms": r["ms"],
            "device_ms": r["device_ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None,
            "library": "none: no PyTorch call computes the recurrence's backward",
            "segments": r["segments"],
            "float32": {k: scan_bwd_rows[(name, "float32", Bm, Sm, False)][k] for k in scan_keys},
            "by_case": {f"{d}/B={b_}/S={s_}{'/strong' if st else ''}":
                        {"max_abs_err": x["max_abs_err"], "excess": x["excess"],
                         "controls": x["controls"]}
                        for (n_, d, b_, s_, st), x in scan_bwd_rows.items() if n_ == name},
            "launches_by_phase": {ph: n.get(name, 0) for ph, n in launches.items()},
        })
    print(json.dumps({"int8_serve": int8_figures, "host_tier": host_figures,
                      "oracle_paths": oracle_figures, "controller": controller_figures,
                      "swa_serve": swa_figures, "mixtral_serve": mixtral_figures,
                      "chunk_mla_parity_max_abs_logit_diff": parity_logits,
                      "llama4_serve": llama4_figures, "minicpm3_serve": minicpm3_figures,
                      "zoo_parity_max_abs_logit_diff": zoo_parity,
                      "swa_int8_serve": swa_int8_figures, "internvl2_serve": internvl2_figures,
                      "whisper_serve": whisper_figures, "audit": audit_figures,
                      "dp": dp_figures, "train": train_figures,
                      "train_forms": form_train_figures, "train_scans": scan_train_figures,
                      "train_stack_gradient": stack_figures, "grad_guards": guard_figures,
                      "dryrun_card": dryrun_figures, "tp_card": tp_figures,
                      "dp_mesh_card": dp_mesh_figures}))
    print(json.dumps({"kernels": kernels}))
    print(f"[done] {time.perf_counter() - t_start:.1f}s in all", flush=True)
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
