#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: ``python3 chip_smoke.py``
from the repository root.

Phases (each raises on failure; the script exits non-zero and prints no
result line):

1. build   — compile every CUDA kernel of ``src/repro_torch/csrc`` (one
             ``nvcc`` per source, in parallel): flash prefill, flash
             decode, int8-KV decode, the w8a8 GEMM and the SLS kernels
             (fp32, int8, int4); then ``cuobjdump -sass`` of the flash and
             w8a8 libraries must show ``wgmma`` (GMMA) and TMA load
             (UTMALDG) instructions.
1b. host-link — pinned host <-> device copy rates (256 MiB copies, CUDA
             events) beside the H100 spec's nominal rate, which the
             performance model prices snapshot ships with.
2. kernels — each kernel against its plain PyTorch version on the card, on
             the JAX package's kernel test cases plus the serving path's
             shapes, with the error, the kernel's time, the plain version's
             time, one PyTorch library call's time where one computes the
             same function (``scaled_dot_product_attention`` for the
             attention kernels, ``torch._int_mm`` and the two scale
             multiplies for w8a8; a yardstick only) and the least time the
             card could take (bytes at 3.35 TB/s or operations at the peak
             rate of the input type, whichever is larger); then a seeded
             sweep of random shapes, masks and types, checked only. The
             w8a8 GEMM must equal its plain version bit for bit. The
             decode-step kernels are held at their split edges: w8a8 at 1 to
             16 rows on deepseek-7b's shapes, the reduced configs' K of 64
             and 128 and K slices that end inside a step; both split-S
             decode kernels (bf16/f32 and int8-KV) with pos on and around
             64-key chunk boundaries, G 1-16, hd 16-256 and a softcap, and
             f32 at hd 128 in 128-key chunks (135 KB of shared memory; the
             sweeps draw the chunk edges half the time). The SLS
             kernels' main shape is the DLRM batch (6144 bags of at most
             128 lookups, D 96, lengths from ``dlrm_batches``) on a table
             far larger than L2; ``embedding_bag`` is the fp32 yardstick.
             Each SLS kernel is held against its plain version in its own
             summation order (the lane groups' partial sums added in group
             order), at its layout edges too: bags longer than one staged
             batch of 128 indices, L = 1, rows that are not a multiple of
             16 bytes or of more than 32 lanes, tables that start 8 or 1
             bytes past a 16-byte boundary.
             The tensor-core paths are held at their edges: bf16 flash
             with GQA at hd 128, S not a multiple of the 128-row tile, an
             empty row, a window and a softcap; w8a8 at M = 17, 65 and
             2047, a partial K and a partial N tile, and the decode
             (M <= 16) and fallback (K % 16 != 0) routes; the sweeps add
             tile-edge sizes. One ``torch.profiler`` window then reads the
             device time of flash, SDPA, bf16 decode, SDPA's decode, the
             w8a8 GEMM and ``torch._int_mm`` at M=4 and M=2048, the int8-KV
             decode, the three SLS kernels and fp32 ``embedding_bag`` at the
             main shapes.
             Flash also takes prefill chunks: queries at a per-row offset
             (``q_off``) attending rows ``kv_rows`` of a larger cache in
             place, held against the plain version at the tile edges
             (offsets off the 128-key tile, a short last chunk, a padded
             row, G 4 and 8, f32 on the CUDA cores, a window), kv rows
             outside the cache (0 for those rows only), deepseek-7b's chunk
             call (4 x 128 at offsets 384, 128, 0, 256 over a 4 x 1024
             cache; timed beside SDPA with a boolean mask) and a 24-case
             seeded sweep. gemma2-27b's shapes (bf16, G 2, hd 128, softcap
             50): flash prefill B 4, S = T = 4608 with uneven lens, once
             with window 4096 (a local layer) and once without (a global
             one); its chunk calls (4 x 512) over a ring gathered into
             position order (T 4608, query offset up to the window) and in
             place over a 5120-row cache at offsets past the window, with
             and without the window; both decode kernels on a 4096-slot ring
             (pos clamped to 4095) and a 5120-row global cache. SDPA has no
             softcap, so these have no library time. gemma-2b's shapes (bf16,
             16 padded query heads of head_dim 256 over one kv head, G 16, no
             softcap): flash prefill B 4, S = T = 4096 with uneven lens and
             its chunk call (4 x 512 at offsets 3584, 2048, 512, 0 in place
             over a 4 x 4608 cache), both timed beside SDPA, on the TMA
             kernel (the profile must name ``flash_fwd_kernel_tma<256,
             ...>``); f32 at hd 256 on the CUDA cores; the hd-256 tile edges
             (S off the tiles, an empty row, a window, a live softcap, G 8
             and 12, non-causal, chunks); both decode kernels at B 4, S 4608,
             pos (4095, 3000, 1200, 31) and at G 9, 12 and 16 around the
             chunk edges; w8a8 at gemma-2b's projections. Every G-16 case
             holds 16 different heads (``heads_distinct``). w8a8 at
             gemma2-27b's projections (K 4608 -> 4096, 2048, 36864; 4096 ->
             4608; 36864 -> 4608) at M 4 and 2048, each on the split-K or
             the TMA kernel (the device window must name it, not the
             fallback kernel), bit for bit, timed beside ``torch._int_mm``.
2a. dbrx-kernels — right after the kernel phase, in a process of its own
             (``--dbrx-kernels``; ``CHILD_PHASES``): dbrx-132b's shapes
             (bf16, 48 query heads over 8 kv heads, G 6, hd 128): flash
             prefill B 4, S = T = 4096 with uneven lens and its chunk call
             (4 x 512 in place over a 4 x 4608 cache), both on the
             tensor-core ``flash_fwd_kernel_tma`` (a 128-row tile holds 21
             positions of 6 heads and 2 pad rows; the window must name
             it), both decode kernels at B 4, S 4608 (a warp's pass of 8
             heads holds 6), w8a8 at its attention projections (K 6144 ->
             6144, 1024) at M 4 and 16384, flash at command-r-plus's 96
             heads over 8 (G 12) on the same prefill and chunk shapes and
             flash's G sweep (G 3, 5, 6, 7, 12, 24, 48, 96, 128 at hd 64,
             128 and 256; an empty row, a window, a live softcap,
             non-causal, chunks off the tile, a kv row outside the cache;
             bf16 at hd 32, G 6 on the CUDA-core ``flash_fwd_kernel``),
             each against its plain version, then their device window,
             which must name each case's kernel.
2a'. cmdr-kimi-kernels — then, in a process of its own as well
             (``--cmdr-kimi-kernels``): command-r-plus-104b's two decode
             kernels at B 4, S 4608, G 12 (96 heads over 8 of 128) and
             w8a8 at its projections (K 12288 -> 12288, 1024, 33792;
             33792 -> 12288) at M 4 and 16384; kimi-k2-1t-a32b's flash
             prefill (B 4, S = T = 4096, 64 heads over 8 of 128, G 8) and
             chunk call (4 x 512 in place over a 4 x 4608 cache) on
             ``flash_fwd_kernel_tma<128, ...>``, its decode kernels at G
             8 and w8a8 at its attention projections (K 7168 -> 8192,
             1024; 8192 -> 7168) at M 4 and 16384; each against its plain
             version and timed beside SDPA or ``torch._int_mm`` and its
             bound, then their device window, which must name each flash
             and w8a8 case's kernel.
2b. profile-mamba2 — after it, in a process of its
             own (``--profile-mamba2``: the same window taken in this
             process after the kernel phase lost a marker kernel every
             time): full-width mamba2-130m's 4 x 4096 eager prefill
             call (lens 4096, 3900, 2100, 300) and 8 replays of a graphed
             4-slot decode stage in one window, each call between two
             marker kernels (every marker must be in the trace): the
             prefill's device time and the ``ssm`` (mixers) and ``ssd``
             (scans) spans' shares, the step's device time and activities,
             each beside its bound (the prefill's products at 989 TFLOP/s,
             the step's weights and state bytes at 3.35 TB/s).
2c. profile-dbrx — then, in a process of its own as well
             (``--profile-dbrx``): dbrx-132b's first 8 layers at full
             width, a 4 x 4096 eager prefill call (lens 4096, 3900, 2100,
             300) and 8 replays of a graphed 4-slot decode stage in one
             marked window: the prefill's device time, the ``moe`` spans'
             share (and ``moe.route``, ``moe.dispatch``, ``moe.experts``,
             ``moe.combine``) and flash's, the step's device time and
             activities, each beside its bound (the experts' products over
             their whole capacity buffers at 989 TFLOP/s; every weight and
             the K/V read at 3.35 TB/s).
3. serve  — full-width deepseek-7b in bf16 (random weights from a seed)
             through ``InferenceEngine(device="cuda")``, its stages
             captured as CUDA graphs (the card's default): 8 requests, 32
             new tokens each. The kernels' launch counters are zeroed just
             before and read just after, and both attention kernels must
             have run.
3b. serve-eager — the same requests through an engine with
             ``cuda_graphs=False``, in the same run: each kernel's launches
             must equal the graphed run's and the greedy agreement reach
             0.95 (identical tokens expected; the first divergent token is
             printed otherwise); both engines print the mean decode step
             and prefill call, tok/s, TTFT p50/p99, peak and reserved
             memory and their graphs captured and replayed per stage; then
             eight decode stage calls of each engine (one replay each,
             graphed) are profiled at 4 rows: wall, device busy share,
             device activities.
4. serve (quantized) — the same weights and requests through a second
             engine with ``precision="w8a8"`` and an int8 KV cache: the §V
             build step on the card, then serving. The w8a8 and int8-KV
             decode kernels must have run and the bf16 decode kernel not;
             the greedy agreement with phase 3 is printed, not held (the
             logits of random full-width weights are near-flat).
             check-deepseek-layers then holds one full-width w8a8 +
             int8-KV decode step's final hidden state to bf16's, as
             check-gemma2b-layers does (6c).
4a. serve-eager-w8a8 — phase 3b for the quantized engine.
4b. serve-chunked, serve-chunked-w8a8 — the same weights and requests
             through ``prefill_chunk=128`` engines, bf16 and then w8a8 with
             an int8 KV cache: 8/8 requests of 32 tokens, flash launched at
             a query offset; the agreement with the monolithic engine's
             outputs is printed, not held.
5. check   — the reduced deepseek-7b config (f32, head_dim 16) and a
             bf16 head_dim-128 one (``reduce_hd128``) served on the card and
             on the host (plain versions) from the same weights must agree
             on >= 95% of the greedy tokens, each in its fp type and in w8a8
             with an int8 KV cache, and a full-width prefill must give
             finite hidden states.
5b. check-chunked — the reduced f32 config on the card, the host as
             reference: chunked == monolithic tokens (chunk 8 and 16; card vs
             host >= 0.95), prefix hits == a cold engine, snapshot ->
             restore bit for bit over f32 and int8 caches, host paging and
             mid-prefill migration token-identical, and ``reduce_hd128`` in
             w8a8 + int8 KV chunked vs monolithic >= 0.95.
5c. check-graphs — the reduced f32 config and ``reduce_hd128``, each in
             its fp type and in w8a8 + int8 KV, monolithic and chunked (8,
             16): the same requests through a graphed and an eager engine
             must give identical tokens; the final caches' max abs
             difference is printed. (check and check-chunked run graphed,
             so prefix hits, snapshot -> restore, paging and migration
             interleave with replays there.)
6. profile — one full-width prefill call, eight decode steps and one
             prefill chunk call through the model layer, fp and then w8a8
             with the int8 KV cache: wall time untraced, then the device
             time of one ``torch.profiler`` trace (busy share, the share of
             the matrix products and of each port kernel, the top kernels);
             the chunk call must touch whole cache rows only through views
             and its in-place write (no gather, copy or dequantize of whole
             rows), and over an int8 cache the prefix dequantize is timed.
6b. fleet  — the fleet layer at full width, the replicas sharing the one
             card and stepping in turn on one stream (every number is
             printed beside the card and "replicas share one card", with
             the kernel launches per replica; every engine prefills one
             request a call, the reference too, so a request's GEMM shapes
             are the same in both and its tokens can be held identical):
             fleet-router — 2 bf16 replicas (4 slots, max_len 1024 each)
             serve 12 requests x 32 tokens under count and then feedback
             routing; tokens identical to one engine's on the same trace
             (printed beside it). fleet-steal — every request hot-spotted
             onto replica 0, stealing on, replica 0 drained after two
             rounds: steals > 0, none lost, tokens identical. fleet-mixed
             — a bf16 and a w8a8 + int8-KV replica (the serve phase's one
             build step): class-0 requests only on bf16 and identical to
             one engine's, the rest >= 0.90 agreement, no downgrade.
             fleet-prefix — a hot-system-prompt trace (a 384-token shared
             prefix) over 2 chunked replicas with the fleet prefix tier:
             a hit steered to the holder and a shipped snapshot, the index
             consistent with both caches, tokens a cold engine's.
             fleet-autotune — a PerfModel fitted from this run's replayed
             chunk calls (one request per chunk bucket, each key warmed
             first) picks the chunk at its knee, which an
             ``prefill_chunk="auto"`` engine serves with; on the reduced
             f32 config the auto chunk gives chunk 16's tokens.
6c. check-gemma2b, serve-gemma2b, serve-gemma2b-chunked, serve-gemma2b-w8a8
             — with the deepseek-7b weights freed, before gemma2-27b:
             gemma-2b cut to 3 layers of d_model 256 keeping head_dim 256
             and 8 heads padded to 16 over one kv head (``reduce_gemma_2b``)
             through 6d's checks; then full width (18
             layers, d_model 2048, d_ff 16384, vocab 256000; 5.3 GB of
             random bf16 weights from seed 0), 4 slots, max_len 4608,
             graphed and warmed on the same requests: 8 prompts x 32 new
             tokens (4 of 3000-4000 tokens, 4 of 70-450) in bf16 (flash and
             bf16 decode launched; the decode stage profiled), through
             ``prefill_chunk=512`` (flash at a query offset; agreement
             printed) and in w8a8 with an int8 KV cache (the w8a8 and int8
             decode kernels launched, bf16 decode not; greedy agreement
             with the bf16 serve >= 0.90, the reference's guardrail). The
             agreement alone may pass broken layers, so check-gemma2b-layers
             then holds one full-width w8a8 + int8-KV decode step's final
             hidden state to the bf16 step's: its error over what the 18
             layers add (the hidden state less the embedded token's own)
             within 0.10, and two planted faults (every layer's ``wo``
             scale zeroed; the int8 cache's value scales negated) past it.
6c+. check-qwen2vl, serve-qwen2vl, serve-eager-qwen2vl,
             serve-qwen2vl-chunked, serve-qwen2vl-w8a8,
             check-qwen2vl-layers, check-qwen2vl-rope — after gemma-2b,
             before XLM-R (the kernel phase runs flash, both decode
             kernels and w8a8 at qwen2-vl-7b's served shapes: 28 query
             heads padded to 32 over 4 kv heads, G 8, hd 128; flash's
             prefill of a 4096 bucket and its 4 x 512 chunk call over a 4
             x 4608 cache, decode at B 4, S 4608, w8a8 at its five
             projections at M 4 and 2048; each held against its plain
             version and timed beside SDPA or ``torch._int_mm`` and its
             bound in a device window of their own, which must name
             ``flash_fwd_kernel_tma<128, ...>`` and the split-K / TMA
             w8a8 kernels; their inputs from a generator of their own).
             check-qwen2vl cuts the arch to 6 query heads padded to 8 over
             2 kv heads (f32 hd 16; bf16 hd 128 at d_model 256), every bias
             and norm drawn: modes full and prefill over patch embeddings
             at distinct (t, h, w) positions, then decode steps on tokens
             and on embeds, card vs host within 2e-3 (f32) and a relative
             2e-2 (bf16). Then full width (28 layers, d_model 3584, SwiGLU
             d_ff 18944, untied vocab 152064, M-RoPE sections (16, 24, 24)
             at theta 1e6; 7.7 B random bf16 parameters from seed 0), 4
             slots, max_len 4608, graphed and warmed on the same requests:
             4 token prompts of 4096, 3900, 2100 and 300 tokens x 32 new
             tokens at default positions (flash and bf16 decode launched;
             the decode stage's p50 and profile); its eager twin, tokens
             identical; through ``prefill_chunk=512`` (flash at a query
             offset; agreement printed); in w8a8 with an int8 KV cache
             (greedy agreement with bf16 >= 0.90, bf16 decode not
             launched), then check-qwen2vl-layers as 6c's; and
             check-qwen2vl-rope: layer 0's attention in bf16 against f32
             on the same weights, biases drawn, at distinct (t, h, w)
             positions, within 0.02, and M-RoPE replaced by RoPE, two
             sections swapped, the biases dropped and a padded head's
             ``wo`` row drawn each past it.
6c". check-xlmr, serve-xlmr, serve-eager-xlmr, check-xlmr-encoder,
             serve-xlmr-launcher — after gemma-2b, before recurrentgemma:
             the paper's XLM-R encoder. check-xlmr cuts it to
             ``reduce_for_smoke`` (f32, hd 16) and to d_model 256 with 4
             heads of 64 (bf16), every bias and norm parameter drawn
             nonzero (``draw_biases``): 24 sentences in length-sorted
             batches of 8 over buckets 32/64/128 pooled on the card
             (graphed) and on the host within 2e-3 / 2e-2, graphed ==
             eager bit for bit, and one sentence's embedding the same in
             buckets 32, 64 and 128 (and not, with ``kv_valid`` dropped).
             Then full width (24 layers, d_model 1024, 16 heads of 64,
             GELU d_ff 4096 with biases, LayerNorm, tied vocab 250002;
             558.4 M parameters in bf16 from seed 0, biases and norms
             drawn): serve-xlmr serves 256 sentences of
             ``xlmr_sentences(seed=0, max_len=512)`` in length-sorted
             batches of 8 through ``EncoderServer``, one CUDA graph per
             bucket captured in a warm-up pass, then again timed (every
             sentence served, pooled outputs finite and nonzero, every
             flash launch non-causal); prints both batchings' padding
             waste, batches per bucket, sentences/s, real tokens/s,
             p50/p99 by bucket and peak memory; then the same sentences in
             arrival order (wall time printed, not held); serve-eager-xlmr
             the sorted batches eagerly (launches equal, outputs
             identical); check-xlmr-encoder holds 8 sentences of 65-128
             tokens at bucket 128 pooled in bf16 to an f32 copy of the
             weights on the card, ||bf16 - f32|| / ||f32|| <= 0.05, with
             causal attention, the pads attended and the biases dropped
             each past it; serve-xlmr-launcher runs ``--arch xlmr-paper
             --full-config`` (one graph per bucket reached). The kernel
             phase adds flash at XLM-R's shapes (B 8, 16 heads of 64, G 1,
             non-causal, per-row lengths) at buckets 32, 128 and 512, timed
             beside SDPA with a boolean key mask (the profile must name
             ``flash_fwd_kernel_tma<64, ...>``), and a bucket-32 batch with
             empty rows, which must give exactly 0.
6c"'. check-whisper, serve-whisper, serve-eager-whisper,
             check-whisper-layers — after XLM-R: whisper-medium's
             encoder-decoder. check-whisper cuts it to ``reduce_for_smoke``
             (f32, hd 16) and to d_model 256 with 4 heads of 64 (bf16),
             biases and norms drawn nonzero, 4 rows of 1500 frames: the
             encoder's output and a prefill + 8 decode steps' hidden states
             on the card vs the host (2e-3 elementwise in f32; a relative
             error within 2e-2 in bf16), then two batches through one
             graphed ``EncDecServer``, the second's tokens and caches bit
             for bit an eager server's. Then full width (24 + 24 layers,
             d_model 1024, 16 heads of 64, 758.6 M bf16 parameters from
             seed 0, biases and norms drawn): serve-whisper serves 8 rows
             x 1500 stub frames, prompts of 4-16 tokens, 64 greedy tokens a
             row, through the graphed encoder + prefill and decode stages
             (a warm-up batch captures them, a second batch is timed): 72
             flash launches a prefill (48 non-causal), 48 decode launches a
             step; prints the prefill call, decode step p50/p99, new
             tokens/s, graphs and peak memory; serve-eager-whisper the
             same batch eagerly (launches equal, tokens identical);
             check-whisper-layers holds bf16 to an f32 copy on the card
             (the encoder's output and a decode step, with the stub frames
             through the encoder and with N(0, 1) frames standing for its
             output) within 0.02, four planted faults past it. The kernel
             phase adds flash at the encoder (B 8, S = T = 1500,
             non-causal) and the cross prefill (16 queries over 1500
             frames), decode over 1500 frames at pos 1499 and over a 448-row
             self cache, each timed beside SDPA.
6c'. check-recurrentgemma, check-recurrentgemma-block, serve-recurrentgemma,
             serve-eager-recurrentgemma, profile-recurrentgemma,
             serve-recurrentgemma-chunked — after gemma-2b: recurrentgemma-9b
             cut to 8 layers ((recurrent, recurrent, local) x 2 and the
             (recurrent, recurrent) tail) of d_model 256 and lru_width 256,
             16 heads of head_dim 256 over one kv head, window 64
             (``reduce_recurrentgemma``) through 6d's checks, the snapshot
             round trips also at max_len 48 (below the window); then full
             width (38 layers, 26 recurrent and 12 local, d_model 4096, d_ff
             12288, vocab 256000; 17.3 GB of random bf16 weights from seed
             0). check-recurrentgemma-block runs its first (recurrent,
             recurrent, local) unit on the card in bf16 and on the host in
             f32 through the plain versions, 4 rows of 256, 200, 65 and 1
             tokens then 4 decode steps: the card's error over what the
             unit adds within 0.05, and the conv taps reversed and ``h``
             zeroed between decode steps both past it. Then 4 slots,
             max_len 4608, graphed and warmed on the same requests: 8
             prompts x 32 new tokens (4 of 2100-4000 tokens, past the 2048
             window, 4 of 70-450): flash with a window and bf16 decode
             launched; its eager twin (launches equal, agreement >= 0.95;
             both decode stages profiled with the rings full); the
             RG-LRU's share of an eager prefill call and decode step, and
             of its scan, from their profiler spans; then through
             ``prefill_chunk=512`` (flash at a query offset; agreement
             printed). The kernel phase adds flash's prefill (4 x 4096,
             window 2048) and chunk (4 x 512 over a gathered 2048 + 512-key
             ring) and decode on a 2048-slot ring at G 16, hd 256, each
             timed beside SDPA with a boolean mask.
6c''. check-mamba2, check-mamba2-block, serve-mamba2, serve-eager-mamba2,
             serve-mamba2-chunked, serve-mamba2-long — after
             recurrentgemma-9b: mamba2-130m, Mamba2 SSD mixer blocks alone
             (no attention, no MLP; no kernel of the port lies on its path,
             and every kernel's launch counter must stay 0 through its
             serves). check-mamba2: ``reduce_mamba2`` in f32 (d_state 16,
             heads of 16, chunk 32) and a bf16 cut at the published SSM
             dims (2 layers of d_model 256, d_state 128, heads of 64, chunk
             256), ``A_log``, ``D``, ``dt_bias``, ``conv_b``,
             ``norm_scale`` and the norms drawn nonzero (``draw_ssm``):
             modes full and prefill and 4 decode steps card vs host (2e-3
             elementwise in f32, a relative 2e-2 in bf16), graphed ==
             eager tokens, chunked (8, 16) == monolithic, a prefix hit ==
             cold, snapshot -> restore bit for bit, paging and migration
             token-identical (f32), chunk 256 vs monolithic >= 0.95 (bf16).
             Then full width (24 layers, d_model 768, d_inner 1536 in 24
             heads of 64, d_state 128, tied vocab 50280 padded to 50432;
             129.10 M random bf16 weights from seed 0, ``draw_ssm``'s
             leaves drawn): check-mamba2-block holds the first 4 layers in
             bf16 against their f32 copy on the card (rows of 1024, 700,
             257 and 1 tokens, then 8 decode steps, monolithic and in
             chunks of 512) within ``SSM_BLOCK_TOL`` of what the layers
             add, the conv taps reversed, the state zeroed between decode
             steps, ``h0`` dropped in chunk steps and the pads' dt unmasked
             each past it. serve-mamba2: 4 slots, max_len 4608, buckets to
             4096, graphed and warmed on the same requests, 8 prompts
             (4096, 3900, 2100, 300 and 4 of 17-200) x 32 tokens: tok/s,
             TTFT, the decode stage's p50, the peak memory and the state's
             bytes; its eager twin (tokens identical); chunk 512
             (agreement printed); serve-mamba2-long: one prompt of 32,736
             tokens and three of 300 at max_len 32768, monolithic (bucket
             32768) and chunked at 2048: the state's bytes equal
             serve-mamba2's, the long prompt's TTFT and the decode p50
             printed.
             check-train, train-mamba2, train-gemma2b — then the trainer
             (``launch/train.py``: f32, Adam, no kernel on its path, every
             launch counter 0). check-train: one ``reduce_for_smoke``
             config per block kind (deepseek-7b, gemma2-27b,
             recurrentgemma-9b, mamba2-130m, dbrx-132b, whisper-medium,
             qwen2-vl-7b), zero leaves drawn and logits scaled x20, the
             same weights and 3 batches on the card and on the host: step
             1's loss and every gradient within 2e-3 relative + 1e-5, the
             losses of steps 2-3 within 1e-3 relative; attention through
             the flash kernel past its grad guard and the z-term dropped
             each past them; flash on CUDA inputs that require grad must
             raise. train-mamba2: the launcher's ``setup`` and ``train`` at
             full width, 40 steps of 8 x 128 tokens at lr 1e-3 (the
             default 3e-3 makes the loss rise at this width), a checkpoint
             at step 20; every loss finite, the mean of the last 5 at least
             ``TRAIN_MAMBA2_MARGIN`` below the first, the checkpoint holding
             every parameter; then ``--resume`` in a child process
             (``--train-resume``): the saved bits restored, steps 20-39 run,
             finite. train-gemma2b: full width (16 heads, 8 padding), 8 x
             64 tokens in 2 microbatches, 10 steps, then one more step
             whose own batch must fall ``TRAIN_GEMMA2B_DESCENT``; the
             device time a step beside a rough bound, the peak, and the
             padded heads' ``wo`` rows (trained, as the reference's).
             check-dbrx, check-dbrx-layers, serve-dbrx,
             serve-eager-dbrx, serve-dbrx-chunked, serve-dbrx-w8a8 — after
             mamba2-130m's: dbrx-132b (global attention at G 6 whose MLP
             half is a mixture of 16 experts, top 4, capacity factor 1.25,
             entries past an expert's capacity dropped first come, first
             served). check-dbrx: ``reduce_dbrx`` in f32 at factors 1.25
             (drops asserted) and 16 (none) and a bf16 cut (2 layers of
             d_model 256, 12 heads over 2 kv heads of 64, 16 experts top-4
             of 512) at 1.25, norms drawn: modes full and prefill and 4
             decode steps card vs host (2e-3 elementwise in f32, a relative
             2e-2 in bf16), graphed == eager tokens at each, and at factor
             16 chunked (8, 16) == monolithic, a prefix hit == cold,
             snapshot -> restore bit for bit, paging and migration. Then
             the first 8 of its 40 layers at full width (d_model 6144, 48
             heads over 8 kv heads of 128, d_expert 10752, untied vocab
             100352; 27.31 B random bf16 weights from seed 0, 54.6 GB; all
             40 layers take ~264 GB): check-dbrx-layers holds its first 2
             blocks against their attention plus a dense MoE written here
             (per expert the tokens that chose it in token order, the first
             C kept), the worst real token within ``MOE_LAYERS_TOL`` of
             what a layer adds, the share of entries dropped printed, and
             the top-k weights unnormalised, capacity ignored, drops taken
             last come first served and act(u)*g each past it.
             serve-dbrx: 4 slots, max_len 4608, buckets to 4096, graphed
             and warmed on the same requests, 8 prompts (4096, 3900, 2100,
             300 and 4 of 17-200) x 32 tokens: tok/s, TTFT, the decode
             stage's p50, the peak memory, a 4 x 4096 prefill's device
             time and the step's bound (``serve_bounds``), and each
             layer's share of entries dropped in a 4 x 4096 prefill of
             the long prompts
             (the model run outside the engine); its eager twin (tokens
             identical); chunk 512 (agreement printed); w8a8 + int8 KV
             (the attention projections alone are sites: 4, 32 int8
             weights; the experts stay bf16), agreement printed, and
             check-dbrx-w8a8-layers.
             check-cmdr, check-cmdr-layers, serve-cmdr, serve-eager-cmdr,
             serve-cmdr-chunked, build-cmdr-w8a8, serve-cmdr-w8a8,
             check-cmdr-w8a8-layers — after dbrx-132b's:
             command-r-plus-104b (global attention at G 12, LayerNorm
             with a scale and a bias, SwiGLU, a tied 256000-row
             embedding, theta 75000). check-cmdr: ``reduce_cmdr`` (2
             layers keeping G 12: f32 12 heads over 1 of 16; bf16 24 over
             2 of 64, whose mode 'full' must run
             ``flash_fwd_kernel_tma<64, ...>``), the LayerNorms' scales
             and biases drawn, through 6d's checks (``check_reduced``).
             Then its first 16 of 64 layers at full width (28.31 B
             random bf16 parameters from seed 0, 56.6 GB, the norms
             drawn): check-cmdr-layers holds its first 2 blocks against a
             plain formulation written here (LayerNorm by its formula,
             the projections, RoPE, attention per kv head, SwiGLU), the
             worst real token within ``CMDR_LAYERS_TOL`` of what a layer
             adds, and the LayerNorm bias dropped, query heads grouped h
             mod 8 and RoPE at theta 10000 each past it. serve-cmdr and
             its twins as serve-dbrx's (the same requests and engine
             settings), with a 4 x 4096 prefill call's device time and
             the step's bound (``serve_bounds``); then w8a8 + int8 KV
             built as gemma2-27b's (``layers_reference`` first, then the
             build at budget 1.0 with ``release_fp=True``): 7 int8
             weights a layer, 112, agreement printed, its layers check.
             check-kimi, check-kimi-layers, serve-kimi, serve-eager-kimi,
             serve-kimi-chunked, serve-kimi-w8a8, check-kimi-w8a8-layers
             — then kimi-k2-1t-a32b (global attention at G 8, 384
             experts top-8 padded to 512): dbrx's phases (``phase_moe``)
             on ``reduce_kimi`` (f32: 4 experts top-2 padded to 512;
             bf16: 16 heads over 2 of 64, 12 experts top-8 padded to 16)
             and on its first layer of 61 at full width (25.03 B
             parameters, 50.1 GB, 45.1 of them the 512 experts):
             check-kimi-layers on that one layer, over the padded experts
             (none may receive an entry), serve-kimi with its bounds, 4
             int8 weights in its w8a8 build.
6d. check-gemma2 — gemma2-27b cut to
             4 layers (local, global, local, global) of d_model 256, head_dim
             128, G 2, window 64, both softcaps (``reduce_gemma2``), in f32
             and bf16, each fp and w8a8 + int8 KV, prompts of 40-200 tokens:
             card vs host >= 0.95; chunked (8, 16) vs monolithic identical
             in f32 fp, >= 0.95 elsewhere; graphed == eager tokens
             (monolithic, chunk 16); a prefix hit over a 96-token shared
             prompt vs a cold engine (identical in f32) and snapshot ->
             restore bit for bit over fp and int8 rings.
6e. serve-gemma2 — full-width gemma2-27b in bf16 (46 layers, d_model 4608,
             32/16 heads of 128, d_ff 36864, vocab 256000; 54.5 GB of random
             weights from seed 0), 4 slots, max_len 5120, graphed and warmed
             on the same requests: 8 prompts x 32 new tokens, long and short
             in turn (4 of 4100-4600 tokens, past the 4096 window, and 4 of
             71-445). All served with 32 tokens each; flash, flash with a
             window and bf16 decode launched. Then the graphed decode stage
             is profiled with its rings full, and a 4600-token prefill must
             give finite hidden states.
6f. serve-gemma2-chunked — the same through ``prefill_chunk=512``: flash at
             a query offset and with a window; the agreement with 6d printed,
             not held. One chunk call at offsets past the window is
             profiled, and the local layers' ring gather timed alone.
6g. serve-gemma2-w8a8, check-gemma2-layers, serve-gemma2-chunked-w8a8 —
             first the bf16 side of check-gemma2-layers (one decode step
             after prompts of 4600, 4200, 300 and 1 tokens, max_len 5120:
             the rings wrap), then the §V build step with
             ``release_fp=True``: each int8 site's fp weights move to the
             host once it is quantized, so the card never holds the bf16
             model and its int8 form together (~75 GiB); its time,
             decisions, peak memory beside the card's total, and the host
             bytes it moved are printed. No leaf of the quantized model may
             be off the card. Then 6e's requests through a w8a8 engine with
             an int8 KV cache, monolithic and through ``prefill_chunk=512``
             (the same build): 8/8 requests of 32 tokens; flash with a
             window (and at a query offset, chunked), the w8a8 and int8
             decode kernels launched, bf16 decode not; the agreement with
             6e printed, not held; each decode stage profiled with its rings
             full. Between them check-gemma2-layers holds the w8a8 +
             int8-KV step to the bf16 one (6c's error, tolerance and
             planted faults). The gemma2-27b weights (and their host
             copies) are then freed.
7. serve-dlrm — with the LM weights freed: DLRM ``PAPER_COMPLEX``
             at its published widths with every table halved (one shard,
             a 58.6 GB row-wise int8 slab made on the card from a seed)
             through ``DLRMEngine(device="cuda")``: a full-trace warm-up,
             then 64 requests of batch 64 with the launch counters zeroed
             just before and read just after; the int8 SLS kernel must
             have run once a request and the other two not; one request's
             pooled output is held against the plain version on the same
             slab, and its logits against the dense stage on that output.
7b. fleet-dlrm — 2 DLRM replicas over serve-dlrm's one slab: every batch
             hot-spotted onto replica 0, stealing on, replica 0 drained
             after its first step; each batch served once, its logits
             within 2e-3 of the one engine's, the int8 SLS kernel once a
             batch.
8. profile-dlrm — one traced pipeline pass of a batch: device busy share,
             the SLS kernel's share, device activities.
9. check-dlrm — reduced ``PAPER_COMPLEX`` with an fp32, an int8 and an
             int4 slab, the same weights served on the card and on the
             host (plain versions): pooled outputs within the SLS
             tolerances, logits within 2e-3; each card run must launch its
             slab's SLS kernel once a request and the other two not.

In serve-dlrm the dense stage (graphed, one graph per batch size) is also
timed against an eager twin's on one request's inputs (a call to
completion, the logits within 2e-3), and one call of each is traced. The
sparse stage stays eager: the bags' lengths set its work.

Kernel times (``ms``) are CUDA-event times of single calls, each after an
L2 flush; the device window's times leave out the host's enqueue gap.

The line before the last is a JSON object with one entry per kernel (its
``launches`` are those of the phases whose path runs it, summed: serve,
serve-chunked, the three gemma-2b serves, the three graphed qwen2-vl
serves, serve-xlmr's timed pass, serve-whisper's timed batch, the two
graphed recurrentgemma serves and the four gemma2-27b serves for flash,
serve, the bf16 gemma-2b serves, the bf16 qwen2-vl serves,
serve-whisper's timed batch, the two graphed recurrentgemma serves and the
two bf16 gemma2 serves for bf16 decode, serve-w8a8, serve-gemma2b-w8a8,
serve-qwen2vl-w8a8 and the two w8a8 gemma2 serves for the int8 kernels,
the graphed, chunked and w8a8 serves of dbrx-132b, command-r-plus-104b and
kimi-k2-1t-a32b for the attention kernels and w8a8,
serve-dlrm, or
check-dlrm for the fp32 and int4 SLS kernels, and every fleet phase; each
phase zeroes the counters just before it and reads them just after).
Before it, a JSON line ``{"train": [...]}``: per train phase its steps,
the median device time a step, the first and last loss and the peak. The
last line is ``{"ok": true, "device": {...}}``. Needs one CUDA device and
the repository's ``src/`` beside this file; imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

from repro_torch.configs import dlrm_paper  # noqa: E402
from repro_torch.configs import get_config, reduce_for_smoke  # noqa: E402
from repro_torch.core.backend import DEFAULT_BACKEND  # noqa: E402
from repro_torch.core.metrics import token_agreement  # noqa: E402
from repro_torch.configs.xlmr_paper import SEQ_BUCKETS  # noqa: E402
from repro_torch.core.bucketing import (  # noqa: E402
    length_sorted_batches, pad_ragged_to_bucket)
from repro_torch.data.pipeline import stage  # noqa: E402
from repro_torch.data.synthetic import dlrm_batches  # noqa: E402
from repro_torch.data.synthetic import lm_token_batches  # noqa: E402
from repro_torch.data.synthetic import xlmr_sentences  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.decode_attn.ops import (  # noqa: E402
    chunk_plan, decode_attn, decode_attn_int8, int8_chunk_plan)
from repro_torch.kernels.decode_attn.ref import (  # noqa: E402
    decode_attn_int8_ref, decode_attn_ref)
from repro_torch.kernels.flash_attn.ops import flash_attn  # noqa: E402
from repro_torch.kernels.flash_attn.ref import flash_attention_ref  # noqa: E402
from repro_torch.kernels.sls.ops import (  # noqa: E402
    sls, sls_int4, sls_int8, table_plan)
from repro_torch.kernels.sls.ref import (  # noqa: E402
    sls_int4_ref, sls_int8_ref, sls_ref)
from repro_torch.kernels.w8a8.ops import w8a8_matmul  # noqa: E402
from repro_torch.kernels.w8a8.ref import w8a8_ref  # noqa: E402
from repro_torch.models import attention as attn_mod  # noqa: E402
from repro_torch.models import blocks as blk_mod  # noqa: E402
from repro_torch.models import common as common_mod  # noqa: E402
from repro_torch.models import dlrm as dlrm_mod  # noqa: E402
from repro_torch.models.common import dtype_of  # noqa: E402
from repro_torch.models import model as model_mod  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models import rglru as rglru_mod  # noqa: E402
from repro_torch.models import ssm as ssm_mod  # noqa: E402
from repro_torch.core.quantization import QuantDense  # noqa: E402
from repro_torch.models.quantize import (  # noqa: E402
    QuantizedParams, build_quantized_params)
from repro_torch.launch import serve as serve_launcher  # noqa: E402
from repro_torch.launch import train as train_launcher  # noqa: E402
from repro_torch.serving.dlrm_engine import DLRMEngine  # noqa: E402
from repro_torch.serving.dlrm_engine import (  # noqa: E402
    make_replicas as dlrm_make_replicas)
from repro_torch.serving.encdec import (  # noqa: E402
    EncDecServer, stub_batch)
from repro_torch.serving.encoder import (  # noqa: E402
    EncoderServer, arrival_batches, encode_pooled, padding_waste)
from repro_torch.serving.engine import (  # noqa: E402
    InferenceEngine, Request, make_replicas)
from repro_torch.serving.perf_model import PerfModel  # noqa: E402
from repro_torch.serving.router import ReplicaRouter  # noqa: E402
from repro_torch.sharding import vocab as vocab_mod  # noqa: E402
from repro_torch.training.optimizer import (  # noqa: E402
    OptConfig, init_opt_state)
from repro_torch.training.train_step import make_train_step  # noqa: E402

HBM_BYTES_PER_S = 3.35e12                       # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12,           # dense tensor-core bf16
              torch.float32: 67e12,             # f32 outside the tensor cores
              torch.int8: 1979e12}              # dense tensor-core int8
TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-3}
KERNELS = {
    "flash_attn": dict(source="src/repro_torch/csrc/flash.cu",
                       replaces="src/repro/kernels/flash_attn/flash.py:33"),
    "decode_attn": dict(source="src/repro_torch/csrc/decode.cu",
                        replaces="src/repro/kernels/decode_attn/decode.py:24"),
    "decode_attn_int8": dict(
        source="src/repro_torch/csrc/decode_int8.cu",
        replaces="src/repro/kernels/decode_attn/decode.py:100"),
    "w8a8_matmul": dict(source="src/repro_torch/csrc/w8a8.cu",
                        replaces="src/repro/kernels/w8a8/matmul.py:27"),
    "sls_fp": dict(source="src/repro_torch/csrc/sls.cu",
                   replaces="src/repro/kernels/sls/sls.py:21"),
    "sls_int8": dict(source="src/repro_torch/csrc/sls.cu",
                     replaces="src/repro/kernels/sls/sls.py:34"),
    "sls_int4": dict(source="src/repro_torch/csrc/sls.cu",
                     replaces="src/repro/kernels/sls/sls.py:50"),
}
LAUNCHERS = {"flash_attn": flash_attn, "decode_attn": decode_attn,
             "decode_attn_int8": decode_attn_int8,
             "w8a8_matmul": w8a8_matmul, "sls_fp": sls, "sls_int8": sls_int8,
             "sls_int4": sls_int4}
# each SLS kernel's plain version and tolerance (repro/kernels/sls/ops.py)
SLS_PLAIN = {"sls_fp": sls_ref, "sls_int8": sls_int8_ref,
             "sls_int4": sls_int4_ref}
SLS_TOL = {"sls_fp": 1e-5, "sls_int8": 1e-4, "sls_int4": 1e-4}
DEV = "cuda"
SMS = 132                                       # H100 SXM; read in main()


L2_FLUSH_BYTES = 2 * 50 * 2**20                   # twice the H100's 50 MB L2


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call of ``fn``, each call timed on its own
    after the L2 cache is flushed: on the serving path every layer finds
    its K/V cache cold (the other layers' weights stream through L2 in
    between)."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=DEV)
    for _ in range(warmup):
        fn()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for start, end in events:
        flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / iters


def bound(flops: float, nbytes: float, dtype) -> tuple:
    """(least ms, 'bytes' or 'operations')."""
    t_ops = flops / PEAK_FLOPS[dtype]
    t_mem = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_mem) * 1e3, ("operations" if t_ops > t_mem
                                     else "bytes")


def compare(name: str, got: torch.Tensor, want: torch.Tensor, dtype,
            tol: float = None, nan_ok: bool = False) -> float:
    """Max abs error; raises past ``tol``, by default the JAX package's
    tolerance for the type (|got - want| <= tol + tol * |want|), and
    unless ``got`` is finite or, with ``nan_ok``, NaN exactly where
    ``want`` is and finite elsewhere."""
    tol = TOL[dtype] if tol is None else tol
    got, want = got.float(), want.float()
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    nan = torch.isnan(want) if nan_ok else torch.zeros_like(want, dtype=bool)
    err = torch.where(nan, 0.0, got - want).abs()
    if (torch.isnan(got) != nan).any() or not torch.isfinite(got[~nan]).all() \
            or (err > tol + tol * want.abs()).any():
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version (max abs err {err.max().item():.3e}, "
                             f"tol {tol})")
    return err.max().item() if err.numel() else 0.0


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def sass_counts(lib) -> dict:
    """Lines of ``cuobjdump -sass`` of a built library that hold a
    ``wgmma`` (GMMA) or a TMA tile load (UTMALDG)."""
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    lines = sass.splitlines()
    return {op: sum(op in line for line in lines) for op in ("GMMA", "UTMALDG")}


def phase_build():
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"build: {len(libs)} kernel libraries ({', '.join(sorted(libs))}) "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
    for name in ("flash", "w8a8"):
        counts = sass_counts(libs[name])
        print(f"build: {name} SASS holds {counts['GMMA']} GMMA and "
              f"{counts['UTMALDG']} UTMALDG instructions", flush=True)
        if not all(counts.values()):
            raise AssertionError(f"{name}: no wgmma or no TMA load in its "
                                 f"library ({counts})")


# ---- kernels ------------------------------------------------------------

def _randn(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device=DEV).to(dtype)


# gemma2-27b's softcapped cases scale q by this (a power of two: exact in
# either type), so that the logits (std ~16 against ~1 at randn's size)
# reach the softcap's nonlinear range, as gemma2's do: at std 1,
# 50*tanh(x/50) differs from x by ~x^3/7500, far below every tolerance
SOFTCAP_Q_SCALE = 16.0


def softcap_live(name: str, plain, cap: float, want: torch.Tensor,
                 dtype) -> torch.Tensor:
    """The plain version ``plain(softcap)`` with no softcap and with 0.6x
    ``cap`` must each differ from ``want`` (its output at ``cap``) past the
    case's tolerance, so that a kernel that skipped the softcap or applied
    another one would fail the case. Returns the output with no softcap
    (the reference of a softcap-free stand-in)."""
    tol = TOL[dtype]
    want = want.float()
    fracs = {}
    for other in (0.0, 0.6 * cap):
        out = plain(other)
        fracs[other] = ((out.float() - want).abs()
                        > tol + tol * want.abs()).float().mean().item()
        if other == 0.0:
            uncapped = out
    print(f"{name}: the softcap is live: share of outputs past the "
          f"tolerance with softcap 0 {fracs[0.0]:.4f}, with "
          f"{0.6 * cap:g} {fracs[0.6 * cap]:.4f}", flush=True)
    if not all(fracs.values()):
        raise AssertionError(f"{name}: the plain version gives the same "
                             f"output within the tolerance with softcap "
                             f"{cap}, 0 and {0.6 * cap:g} ({fracs}): the "
                             f"case cannot tell them apart")
    return uncapped


def heads_distinct(name: str, want: torch.Tensor, K: int, dtype) -> None:
    """A case holds G different outputs per kv head: the plain output
    ``want`` (..., H, hd) of each head differs past the case's tolerance
    from head 0 of its group and from the head 8 before it, so a kernel
    that computed only 8 heads of a group (a warp's pass), or one head per
    group, fails the case."""
    tol = TOL[dtype]
    w = want.float()
    w = w.reshape(*w.shape[:-2], K, w.shape[-2] // K, w.shape[-1])
    G = w.shape[-2]
    lim = tol + tol * w.abs().max().item()
    same = [g for g in range(1, G)
            for h in {0, g - 8} if h >= 0 and h != g
            and (w[..., g, :] - w[..., h, :]).abs().max().item() <= lim]
    if same:
        raise AssertionError(f"{name}: heads {same} of a group give the same "
                             f"output as another head within the tolerance: "
                             f"the case cannot tell a kernel that skips "
                             f"heads")


def plain_by_kv_heads(q, k, v, lens, parts: int = 1, **kw):
    """The flash plain version over ``parts`` equal slices of the kv heads
    (with their query heads), joined: the same function, with 1/parts of
    the whole score matrix (f32, B x H x S x T) alive at a time."""
    if parts == 1:
        return flash_attention_ref(q, k, v, lens, **kw)
    n = k.shape[2] // parts
    G = q.shape[2] // k.shape[2]
    return torch.cat([flash_attention_ref(
        q[:, :, i * n * G:(i + 1) * n * G], k[:, :, i * n:(i + 1) * n],
        v[:, :, i * n:(i + 1) * n], lens, **kw) for i in range(parts)], dim=2)


def flash_case(name, gen, B, S, H, K, hd, dtype, lens=None, q_scale=1.0,
               T=None, distinct=False, ref_parts=1, **kw):
    """One flash case on the card, S queries over T keys (default S);
    returns the measurement dict. With a softcap and a ``q_scale`` past 1,
    the softcap is shown live (``softcap_live``) and SDPA without it timed
    as a stand-in. G-16 cases, and others with ``distinct``, must hold
    distinct heads (``heads_distinct``); the plain version runs over
    ``ref_parts`` slices of the kv heads (``plain_by_kv_heads``)."""
    T = S if T is None else T
    q = _randn(gen, (B, S, H, hd), dtype) * q_scale
    k = _randn(gen, (B, T, K, hd), dtype)
    v = _randn(gen, (B, T, K, hd), dtype)
    lens_t = None if lens is None else torch.tensor(lens, dtype=torch.int32,
                                                    device=DEV)
    got = flash_attn(q, k, v, lens_t, **kw)
    torch.cuda.synchronize()
    want = plain_by_kv_heads(q, k, v, lens_t, ref_parts, **kw)
    err = compare(f"flash_attn[{name}]", got, want, dtype)
    if H // K == 16 or distinct:
        heads_distinct(f"flash_attn[{name}]", want, K, dtype)
    cap = kw.get("softcap", 0.0)
    uncapped = None
    if cap and q_scale != 1.0:
        uncapped = softcap_live(
            f"flash_attn[{name}]",
            lambda c: plain_by_kv_heads(q, k, v, lens_t, ref_parts,
                                        **{**kw, "softcap": c}),
            cap, want, dtype)
    # the work these inputs need: the (query, key) pairs the mask keeps
    causal, window = kw.get("causal", True), kw.get("window", 0)
    pos, kpos = torch.arange(S, device=DEV), torch.arange(T, device=DEV)
    mask = torch.ones(S, T, dtype=torch.bool, device=DEV)
    if causal:
        mask &= pos[:, None] >= kpos[None, :]
    if window:
        mask &= pos[:, None] - kpos[None, :] < window
    n_valid = torch.tensor(lens if lens is not None else [T] * B, device=DEV)
    mask = mask[None] & (kpos[None, None, :] < n_valid[:, None, None])
    pairs = mask.sum().item()
    elem = q.element_size()
    flops = 4.0 * pairs * H * hd
    nbytes = elem * (2 * q.numel() + 2 * K * hd * n_valid.sum().item())
    bound_ms, bound_by = bound(flops, nbytes, dtype)
    library = None
    if not cap or uncapped is not None:
        # SDPA, (B,heads,S,hd) layout, kv heads repeated per group, outside
        # the timed call; it has no logit softcap, so with one it is a
        # stand-in held against the plain version without it
        qt = q.transpose(1, 2).contiguous()
        kt, vt = (x.repeat_interleave(H // K, dim=2).transpose(1, 2)
                  .contiguous() for x in (k, v))
        m4 = mask[:, None]

        def library_call():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=m4)

        # held on the query rows that see a key: SDPA and the plain
        # version differ on a row the mask leaves empty
        seen = mask.any(-1)
        library = (library_call, library_call().transpose(1, 2)[seen],
                   (want if uncapped is None else uncapped)[seen])

    def call():
        return flash_attn(q, k, v, lens_t, **kw)

    return dict(max_abs_err=err, ms=time_ms(call),
                plain_ms=time_ms(lambda: plain_by_kv_heads(q, k, v, lens_t,
                                                           ref_parts, **kw)),
                bound_ms=bound_ms, bound_by=bound_by, call=call,
                **_library(library, stand_in=uncapped is not None))


def _library(library, stand_in: bool) -> dict:
    """The library keys of a measurement dict from (its timed callable, its
    output, the plain version's output it is held against) or None: a
    call that computes the same function fills ``library_*``; SDPA
    without the softcap of a softcapped case fills ``standin_*``, and
    ``library_ms`` stays None (no single call computes the function)."""
    if library is None:
        return dict(library_ms=None, library_err=None, library_call=None)
    fn, out, ref = library
    err = (out.float() - ref.float()).abs().max().item()
    ms = time_ms(fn)
    if stand_in:
        return dict(library_ms=None, library_err=None, library_call=None,
                    standin_ms=ms, standin_err=err, standin_call=fn)
    return dict(library_ms=ms, library_err=err, library_call=fn)


def chunk_mask(start, lengths, C: int, T: int, window: int = 0):
    """(P,C,T) bool on the card: key t visible to chunk query i of row j
    (t <= start[j] + i, t < start[j] + lengths[j], inside the window)."""
    start = torch.tensor(start, device=DEV)[:, None, None]
    lens = start + torch.tensor(lengths, device=DEV)[:, None, None]
    qpos = start + torch.arange(C, device=DEV)[None, :, None]
    kpos = torch.arange(T, device=DEV)[None, None, :]
    mask = (kpos <= qpos) & (kpos < lens)
    if window:
        mask &= qpos - kpos < window
    return mask


def flash_chunk_case(name, gen, Bk, T, H, K, hd, C, dtype, slots, start,
                     lengths, window=0, softcap=0.0, measure=False,
                     quiet=False, q_scale=1.0, distinct=False):
    """Prefill chunks through flash at query offsets ``start`` over rows
    ``slots`` of a (Bk, T) cache, held against the plain version on the
    same inputs; with ``measure``, timed beside its bound and SDPA (a
    boolean mask over the gathered rows, the gather outside the timed
    call) and returned as a measurement dict, else its error. A softcap
    with a ``q_scale`` past 1 is shown live, and heads held distinct, as
    in ``flash_case``."""
    P = len(slots)
    q = _randn(gen, (P, C, H, hd), dtype) * q_scale
    k, v = (_randn(gen, (Bk, T, K, hd), dtype) for _ in range(2))
    i32 = lambda a: torch.tensor(a, dtype=torch.int32, device=DEV)
    lens = i32([s + n for s, n in zip(start, lengths)])
    kw = dict(window=window, softcap=softcap, q_off=i32(start),
              kv_rows=i32(slots))
    got = flash_attn(q, k, v, lens, **kw)
    torch.cuda.synchronize()
    want = flash_attention_ref(q, k, v, lens, **kw)
    err = compare(f"flash_attn[{name}]", got, want, dtype)
    if (H // K == 16 or distinct) and not quiet:
        heads_distinct(f"flash_attn[{name}]", want, K, dtype)
    uncapped = None
    if softcap and q_scale != 1.0:
        uncapped = softcap_live(
            f"flash_attn[{name}]",
            lambda c: flash_attention_ref(q, k, v, lens,
                                          **{**kw, "softcap": c}),
            softcap, want, dtype)
    if not measure:
        if not quiet:
            print(f"flash_attn {name}: max abs err {err:.3e}", flush=True)
        return err
    mask = chunk_mask(start, lengths, C, T, window)
    elem = q.element_size()
    flops = 4.0 * mask.sum().item() * H * hd
    # q read and o written once; each row's K and V up to its lens
    nbytes = elem * (2 * q.numel() + 2 * K * hd * lens.sum().item())
    bound_ms, bound_by = bound(flops, nbytes, dtype)
    rows = i32(slots).long()

    def call():
        return flash_attn(q, k, v, lens, **kw)

    library = None
    if not softcap or uncapped is not None:   # SDPA: see flash_case
        qt = q.transpose(1, 2).contiguous()
        kt, vt = (x[rows].repeat_interleave(H // K, dim=2).transpose(1, 2)
                  .contiguous() for x in (k, v))
        m4 = mask[:, None]

        def library_call():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=m4)

        library = (library_call, library_call().transpose(1, 2),
                   want if uncapped is None else uncapped)
    return dict(max_abs_err=err, ms=time_ms(call),
                plain_ms=time_ms(lambda: flash_attention_ref(q, k, v, lens,
                                                             **kw)),
                bound_ms=bound_ms, bound_by=bound_by, call=call,
                **_library(library, stand_in=uncapped is not None))


def flash_bad_row(gen, cases=((torch.bfloat16, 128, 2),
                              (torch.float32, 32, 2))) -> list:
    """A kv row outside the cache reads no key: that row gives 0, and the
    other rows stay right, for each (dtype, head_dim, G) of ``cases`` (by
    default both routes). Returns each case's call."""
    calls = []
    for dt, hd, G in cases:
        q = _randn(gen, (3, 16, 2 * G, hd), dt)
        k, v = (_randn(gen, (3, 64, 2, hd), dt) for _ in range(2))
        lens = torch.tensor([40, 40, 40], dtype=torch.int32, device=DEV)
        rows = torch.tensor([1, 3, -1], dtype=torch.int32, device=DEV)
        off = torch.tensor([24, 24, 24], dtype=torch.int32, device=DEV)
        got = flash_attn(q, k, v, lens, q_off=off, kv_rows=rows)
        torch.cuda.synchronize()
        if got[1:].any():
            raise AssertionError(f"flash_attn: kv rows 3 and -1 of a 3-row "
                                 f"cache did not give 0 ({dt}, G {G})")
        compare("flash_attn[kv rows outside the cache]", got,
                flash_attention_ref(q, k, v, lens, q_off=off, kv_rows=rows),
                dt)
        calls.append(functools.partial(flash_attn, q, k, v, lens, q_off=off,
                                       kv_rows=rows))
    print("flash_attn: kv rows outside the cache give 0 for their rows only "
          "(" + ", ".join(f"{str(dt).split('.')[-1]} hd {hd} G {G}"
                          for dt, hd, G in cases) + ")", flush=True)
    return calls


# deepseek-7b's chunk call: 4 slots at offsets (384, 128, 0, 256) over a
# 4 x 1024 bf16 cache, one 128-token chunk each (lengths 128, 128, 77, 1)
CHUNK_MAIN = dict(slots=[0, 1, 2, 3], start=[384, 128, 0, 256],
                  lengths=[128, 128, 77, 1])


def decode_case(name, gen, B, H, K, hd, S, pos, dtype, softcap=0.0,
                q_scale=1.0):
    """One decode case on the card (a softcap with a ``q_scale`` past 1
    shown live, as in ``flash_case``); returns the measurement dict."""
    q = _randn(gen, (B, H, hd), dtype) * q_scale
    k = _randn(gen, (B, S, K, hd), dtype)
    v = _randn(gen, (B, S, K, hd), dtype)
    pos_t = torch.tensor(pos, dtype=torch.int32, device=DEV)
    got = decode_attn(q, k, v, pos_t, softcap=softcap)
    torch.cuda.synchronize()
    want = decode_attn_ref(q, k, v, pos_t, softcap=softcap)
    err = compare(f"decode_attn[{name}]", got, want, dtype)
    if H // K == 16:
        heads_distinct(f"decode_attn[{name}]", want, K, dtype)
    uncapped = None
    if softcap and q_scale != 1.0:
        uncapped = softcap_live(
            f"decode_attn[{name}]",
            lambda c: decode_attn_ref(q, k, v, pos_t, softcap=c), softcap,
            want, dtype)
    keys = sum(min(p, S - 1) + 1 for p in pos)
    elem = q.element_size()
    flops = 4.0 * H * hd * keys
    nbytes = elem * (q.numel() + 2 * K * hd * keys) + 4 * B * H * hd
    bound_ms, bound_by = bound(flops, nbytes, dtype)
    library = None
    if not softcap or uncapped is not None:   # SDPA: see flash_case
        qt = q[:, :, None].contiguous()                         # (B,H,1,hd)
        kt, vt = (x.repeat_interleave(H // K, dim=2).transpose(1, 2)
                  .contiguous() for x in (k, v))                # (B,H,S,hd)
        m4 = (torch.arange(S, device=DEV)[None, :]
              <= pos_t[:, None])[:, None, None]                 # (B,1,1,S)

        def library_call():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=m4)

        library = (library_call, library_call()[:, :, 0],
                   want if uncapped is None else uncapped)

    def call():
        return decode_attn(q, k, v, pos_t, softcap=softcap)

    return dict(max_abs_err=err, ms=time_ms(call),
                plain_ms=time_ms(lambda: decode_attn_ref(q, k, v, pos_t,
                                                         softcap=softcap)),
                bound_ms=bound_ms, bound_by=bound_by, call=call,
                **_library(library, stand_in=uncapped is not None))


def _int8(gen, shape):
    return torch.randint(-127, 128, shape, generator=gen, device=DEV,
                         dtype=torch.int8)


def _w8a8_inputs(gen, M, K, N, row_scale):
    """xq (M,K), wq (K,N) stored column-major (the kernel's layout), per-row
    or scalar activation scales, per-column weight scales."""
    xq = _int8(gen, (M, K))
    wq = _int8(gen, (N, K)).t()
    xs = (torch.rand(M, generator=gen, device=DEV) * 0.049 + 0.001
          if row_scale else torch.tensor(0.02, device=DEV))
    ws = torch.rand(N, generator=gen, device=DEV) * 0.019 + 0.001
    return xq, wq, xs, ws


def check_w8a8(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """Max abs error, which must be 0: the int32 sum is exact, so the
    kernel equals its plain version bit for bit."""
    if got.shape != want.shape:
        raise AssertionError(f"w8a8_matmul[{name}]: shape {tuple(got.shape)}"
                             f" != {tuple(want.shape)}")
    err = (got - want).abs().max().item() if got.numel() else 0.0
    if not torch.equal(got, want):
        raise AssertionError(f"w8a8_matmul[{name}]: kernel differs from its "
                             f"plain version (max abs err {err:.3e}); it "
                             f"must equal it bit for bit")
    return err


def _int_mm_yardstick(xq, wq, xs, ws):
    """``torch._int_mm`` (int8 x int8 -> int32 in cuBLASLt) followed by the
    two scale multiplies. It takes more than 16 rows, so a decode-sized xq
    is padded with zero rows outside the timed call. Returns (the timed
    callable, its (M,N) result)."""
    M = xq.shape[0]
    rows = max(M, 32)
    xp = torch.zeros(rows, xq.shape[1], dtype=torch.int8, device=DEV)
    xp[:M] = xq
    xs_col = torch.zeros(rows, 1, device=DEV)
    xs_col[:M] = xs.reshape(-1, 1)

    def fn():
        return torch._int_mm(xp, wq).float() * xs_col * ws

    return fn, fn()[:M]


def w8a8_case(name, gen, M, K, N, row_scale=True):
    xq, wq, xs, ws = _w8a8_inputs(gen, M, K, N, row_scale)
    got = w8a8_matmul(xq, wq, xs, ws)
    torch.cuda.synchronize()
    want = w8a8_ref(xq, wq, xs, ws)
    err = check_w8a8(name, got, want)
    flops = 2.0 * M * K * N
    nbytes = M * K + K * N + 4 * (M + N) + 4 * M * N
    bound_ms, bound_by = bound(flops, nbytes, torch.int8)
    library_ms = library_err = lib_fn = None
    try:
        lib_fn, lib_out = _int_mm_yardstick(xq, wq, xs, ws)
    except RuntimeError as e:           # a yardstick only: note and go on
        print(f"w8a8_matmul[{name}]: torch._int_mm yardstick not measured: "
              f"{str(e).splitlines()[0]}", flush=True)
    else:
        library_err = (lib_out - want).abs().max().item()
        library_ms = time_ms(lib_fn)
    def call():
        return w8a8_matmul(xq, wq, xs, ws)

    return dict(max_abs_err=err, library_err=library_err, ms=time_ms(call),
                plain_ms=time_ms(lambda: w8a8_ref(xq, wq, xs, ws)),
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
                call=call, library_call=lib_fn)


def _int8_cache(gen, B, S, K, hd):
    """kq, k_scale, vq, v_scale: int8 values, fp16 scales in [0.001,
    0.021) (the JAX package's int8 decode cases)."""
    kq, vq = (_int8(gen, (B, S, K, hd)) for _ in range(2))
    ks, vs = ((torch.rand((B, S, K), generator=gen, device=DEV) * 0.02
               + 0.001).half() for _ in range(2))
    return kq, ks, vq, vs


def decode_int8_case(name, gen, B, H, K, hd, S, pos, dtype, softcap=0.0,
                     q_scale=1.0):
    """One int8 decode case on the card (a softcap with a ``q_scale`` past
    1 shown live, as in ``flash_case``); returns the measurement dict."""
    q = _randn(gen, (B, H, hd), dtype) * q_scale
    cache = _int8_cache(gen, B, S, K, hd)
    pos_t = torch.tensor(pos, dtype=torch.int32, device=DEV)
    got = decode_attn_int8(q, *cache, pos_t, softcap=softcap)
    torch.cuda.synchronize()
    want = decode_attn_int8_ref(q, *cache, pos_t, softcap=softcap)
    err = compare(f"decode_attn_int8[{name}]", got, want, dtype)
    if H // K == 16:
        heads_distinct(f"decode_attn_int8[{name}]", want, K, dtype)
    if softcap and q_scale != 1.0:
        softcap_live(f"decode_attn_int8[{name}]",
                     lambda c: decode_attn_int8_ref(q, *cache, pos_t,
                                                    softcap=c),
                     softcap, want, dtype)
    keys = sum(min(p, S - 1) + 1 for p in pos)
    flops = 4.0 * H * hd * keys
    # q once, int8 K and V plus their two fp16 scales up to pos, f32 out
    nbytes = q.numel() * q.element_size() + K * keys * (2 * hd + 4) \
        + 4 * B * H * hd
    bound_ms, bound_by = bound(flops, nbytes, dtype)

    def call():
        return decode_attn_int8(q, *cache, pos_t, softcap=softcap)

    return dict(max_abs_err=err, library_err=None, ms=time_ms(call),
                plain_ms=time_ms(lambda: decode_attn_int8_ref(
                    q, *cache, pos_t, softcap=softcap)),
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                call=call)


def _show(kernel, name, r):
    lib = ("n/a" if r["library_ms"] is None else
           f"{r['library_ms']:.4f} (its max_abs_err {r['library_err']:.3e})")
    if "standin_ms" in r:
        lib += (f" (no call has the softcap); SDPA without it, a stand-in, "
                f"{r['standin_ms']:.4f} (its max_abs_err "
                f"{r['standin_err']:.3e} against the plain version without "
                f"the softcap)")
    print(f"{kernel}[{name}]: max_abs_err={r['max_abs_err']:.3e} "
          f"kernel_ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
          f"library_ms={lib} bound_us={r['bound_ms'] * 1e3:.2f} "
          f"({r['bound_by']})", flush=True)


def _sls_table(gen, kind, R, D):
    """The table of SLS kernel ``kind``: (R,D) f32, or uint8 values ((R,D)
    int8, (R,D/2) packed int4) with fp16 scale in [0.01, 0.11) and bias
    N(0, 0.1^2) per row (the JAX package's SLS cases)."""
    if kind == "sls_fp":
        return (torch.randn((R, D), generator=gen, device=DEV),)
    cols = D if kind == "sls_int8" else D // 2
    q = torch.randint(0, 256, (R, cols), generator=gen, device=DEV,
                      dtype=torch.uint8)
    scale = (torch.rand(R, generator=gen, device=DEV) * 0.1 + 0.01).half()
    bias = (torch.randn(R, generator=gen, device=DEV) * 0.1).half()
    return q, scale, bias


def _bags(gen, R, NB, L):
    idx = torch.randint(0, R, (NB, L), generator=gen, device=DEV,
                        dtype=torch.int32)
    lens = torch.randint(0, L + 1, (NB,), generator=gen, device=DEV,
                         dtype=torch.int32)
    return idx, lens


def sls_groups(kind, tables) -> int:
    """The lane groups that split a bag in SLS kernel ``kind`` over
    ``tables`` (``table_plan``), which its plain version adds in the same
    order."""
    return table_plan(f"{kind}_fwd", tables[0])[1]


def sls_check(kind, name, tables, idx, lens) -> float:
    """One SLS kernel call against its plain version in the kernel's
    summation order; max abs error."""
    got = LAUNCHERS[kind](*tables, idx, lens)
    torch.cuda.synchronize()
    want = SLS_PLAIN[kind](*tables, idx, lens,
                           groups=sls_groups(kind, tables))
    return compare(f"{kind}[{name}]", got, want, torch.float32,
                   tol=SLS_TOL[kind], nan_ok=True)


def sls_measure(kind, tables, idx, lens, err) -> dict:
    """Times of the kernel, its plain version and (fp32) ``embedding_bag``
    on one input, with the bound these bags need: each lookup reads its
    row (and 4 bytes of fp16 scale and bias when quantized) and its index
    once; the lengths are read and the (NB,D) f32 output written once."""
    fn, plain = LAUNCHERS[kind], SLS_PLAIN[kind]
    NB, L = idx.shape
    lookups = lens.clamp(0, L).sum().item()
    t = tables[0]
    D = t.shape[1] * (2 if kind == "sls_int4" else 1)
    row_bytes = t.shape[1] * t.element_size() + (0 if kind == "sls_fp" else 4)
    nbytes = lookups * (row_bytes + 4) + 4 * NB + 4 * NB * D
    flops = lookups * D * (1 if kind == "sls_fp" else 2)
    bound_ms, bound_by = bound(flops, nbytes, torch.float32)
    library_ms = library_err = None
    if kind == "sls_fp":
        # embedding_bag over the same bags: the valid indices flattened,
        # one offset per bag (made outside the timed call)
        keep = torch.arange(L, device=DEV)[None, :] < lens[:, None]
        flat = idx[keep].long()
        offsets = (torch.cumsum(lens.clamp(0, L), 0) - lens.clamp(0, L)).long()
        lib_out = F.embedding_bag(flat, t, offsets, mode="sum")
        library_err = (lib_out - plain(*tables, idx, lens)).abs().max().item()
        library_ms = time_ms(lambda: F.embedding_bag(flat, t, offsets,
                                                     mode="sum"))

    def call():
        return fn(*tables, idx, lens)

    def library_call():
        return F.embedding_bag(flat, t, offsets, mode="sum")

    return dict(max_abs_err=err, library_err=library_err, ms=time_ms(call),
                plain_ms=time_ms(lambda: plain(*tables, idx, lens)),
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
                call=call,
                library_call=None if library_ms is None else library_call)


def dlrm_main_bags(R: int):
    """The DLRM serving path's SLS input: the bags of one batch of 64
    (``dlrm_batches(PAPER_COMPLEX, 64, seed=0)``), 96 tables -> 6144 bags
    of at most 128 lookups, each table's power-law indices placed in its
    own R/96 rows of an R-row table."""
    cfg = dlrm_paper.PAPER_COMPLEX
    b = next(dlrm_batches(cfg, 64, seed=0))
    per = R // cfg.num_tables
    idx = b["indices"] % per \
        + (np.arange(cfg.num_tables) * per)[None, :, None]
    L = cfg.max_lookups_per_table
    return (torch.from_numpy(idx.reshape(-1, L).astype(np.int32)).to(DEV),
            torch.from_numpy(b["lengths"].reshape(-1)).to(DEV))


SLS_MAIN_ROWS = 1 << 23


def _shifted(t: torch.Tensor, nbytes: int) -> torch.Tensor:
    """A copy of ``t`` that starts ``nbytes`` past the start of its
    (aligned) allocation."""
    e = nbytes // t.element_size()
    buf = torch.empty(t.numel() + e, dtype=t.dtype, device=DEV)
    out = buf[e:].view(t.shape)
    out.copy_(t)
    return out


def sls_edges(gen) -> None:
    """The SLS kernels' layout edges, each against its plain version in the
    kernel's order: bags longer than one staged batch of 128 indices (L
    300), L = 1, rows that are not a multiple of 16 bytes (8-, 4- and
    2-byte lane loads), rows of more than 32 lanes (two and three passes),
    tables that start 8 and 1 bytes past a 16-byte boundary; lengths past L
    and below 0, and one index outside the table (a NaN bag) in each."""
    # (kind, R, D, NB, L, bytes the table's start is shifted by)
    cases = [(k, 3000, 96, 64, 300, 0) for k in SLS_PLAIN] \
        + [(k, 500, 96, 200, 1, 0) for k in SLS_PLAIN] \
        + [(k, 1000, D, 64, 40, 0) for k, D in (
            ("sls_fp", 50), ("sls_int8", 100), ("sls_int8", 98),
            ("sls_int4", 36), ("sls_fp", 200), ("sls_int8", 600))] \
        + [(k, 1000, 96, 64, 40, shift) for k, shift in (
            ("sls_fp", 8), ("sls_int8", 8), ("sls_int8", 1), ("sls_int4", 8),
            ("sls_int4", 1))]
    worst = {k: 0.0 for k in SLS_PLAIN}
    plans = set()
    for kind, R, D, NB, L, shift in cases:
        tables = _sls_table(gen, kind, R, D)
        tables = (_shifted(tables[0], shift), *tables[1:])
        idx, _ = _bags(gen, R, NB, L)
        lens = torch.randint(-2, L + 4, (NB,), generator=gen, device=DEV,
                             dtype=torch.int32)
        idx[0, 0], lens[0] = R, max(int(lens[0]), 1)   # bag 0 is NaN
        plans.add((kind, D, shift) + table_plan(f"{kind}_fwd", tables[0]))
        worst[kind] = max(worst[kind], sls_check(
            kind, f"edge R{R} D{D} NB{NB} L{L} shift {shift}", tables, idx,
            lens))
    print(f"sls edges: {len(cases)} cases agree with the plain versions "
          f"(kind, D, shift, vec, groups, unroll: {sorted(plans)}); max abs "
          f"err {worst}", flush=True)


def sls_cases(gen, device_fns: dict) -> dict:
    """The JAX package's SLS cases (repro/kernels/sls/ops.py), empty bags,
    then the main shape on a 2^23-row table (3.2 GB in fp32, 805 MB in
    int8, 403 MB in int4: far past the 50 MB L2); returns the main
    shape's measurements and adds each kernel's main call (and
    ``embedding_bag``'s) to ``device_fns``."""
    cases = {"sls_fp": [(64, 16, 8, 4), (1000, 64, 32, 8), (4096, 128, 16, 64),
                        (128, 256, 4, 1)],
             "sls_int8": [(64, 16, 8, 4), (1000, 64, 32, 8), (512, 128, 16, 32)],
             "sls_int4": [(64, 16, 8, 4), (1000, 64, 32, 8)]}
    main = {}
    sls_edges(gen)
    main_idx, main_lens = dlrm_main_bags(SLS_MAIN_ROWS)
    for kind, shapes in cases.items():
        worst = 0.0
        for R, D, NB, L in shapes:
            tables = _sls_table(gen, kind, R, D)
            worst = max(worst, sls_check(kind, f"R{R}_D{D}_NB{NB}_L{L}",
                                         tables, *_bags(gen, R, NB, L)))
            idx, _ = _bags(gen, R, NB, L)
            worst = max(worst, sls_check(
                kind, f"R{R}_D{D}_NB{NB}_L{L} empty", tables, idx,
                torch.zeros(NB, dtype=torch.int32, device=DEV)))
        print(f"{kind}: the JAX package's {len(shapes)} cases and their "
              f"all-empty bags agree with the plain version; max abs err "
              f"{worst:.3e}", flush=True)
        tables = _sls_table(gen, kind, SLS_MAIN_ROWS, 96)
        err = sls_check(kind, "main", tables, main_idx, main_lens)
        r = main[kind] = sls_measure(kind, tables, main_idx, main_lens, err)
        _show(kind, f"main_NB6144_L128_D96_R{SLS_MAIN_ROWS} "
              f"({main_lens.sum().item()} lookups)", r)
        device_fns[f"{kind} main_NB6144_D96"] = r["call"]
        if r["library_call"] is not None:
            device_fns["embedding_bag main_NB6144_D96"] = r["library_call"]
    return main


def sweep_sls(seed: int, n: int) -> None:
    """``n`` random cases per SLS kernel: D not a multiple of 4 and odd D
    (fp32, int8), L = 1, empty and all-empty bags, lengths past L and
    below 0, indices outside the table (NaN bags), and a table view that
    starts off 16-byte alignment; each against its plain version. No
    timing."""
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=DEV).manual_seed(seed)
    worst = {k: 0.0 for k in SLS_PLAIN}
    for i in range(n):
        for kind in SLS_PLAIN:
            step = 2 if kind == "sls_int4" else 1
            D = step * int(rng.integers(1, 160 // step))
            R, NB = int(rng.integers(1, 3000)), int(rng.integers(1, 300))
            L = int(rng.choice([1, int(rng.integers(1, 200))]))
            tables = _sls_table(gen, kind, R + 1, D)
            if rng.integers(0, 3) == 0:          # drop row 0: a shifted start
                tables = tuple(t[1:] for t in tables)
            else:
                tables = tuple(t[:R] for t in tables)
            idx, _ = _bags(gen, R, NB, L)
            if rng.integers(0, 4) == 0:          # a few indices off the table
                flat = idx.view(-1)
                at = torch.from_numpy(rng.integers(0, flat.numel(), 3)).to(DEV)
                flat[at] = torch.tensor([R, -1, 2**31 - 1], dtype=torch.int32,
                                        device=DEV)
            lens = torch.from_numpy(rng.integers(-2, L + 3, NB)
                                    .astype(np.int32)).to(DEV)
            if rng.integers(0, 4) == 0:
                lens.zero_()
            err = sls_check(kind, f"sweep {i}: R{R} D{D} NB{NB} L{L}",
                            tables, idx, lens)
            worst[kind] = max(worst[kind], err)
    torch.cuda.synchronize()
    print(f"sweep: {n} random cases per SLS kernel agree with the plain "
          f"versions; max abs err {worst}", flush=True)


def split_group_cases() -> dict:
    """Decode cases of the split-S kernels at G 1 to 8 and hd 16 to 128 in
    both query types, each row's pos on a 64-key chunk's end or past a
    boundary, a softcap at G 3 and 6: name -> (B, H, K, hd, S, pos, dtype,
    softcap)."""
    f32, bf16 = torch.float32, torch.bfloat16
    return {f"G{G}_hd{hd}_B2_K2_S300": (2, 2 * G, 2, hd, 300,
                                        [255, 64 * (G % 4) + G], dt,
                                        30.0 if G % 3 == 0 else 0.0)
            for G, hd, dt in ((1, 16, f32), (2, 32, bf16), (3, 64, f32),
                              (4, 128, bf16), (5, 16, bf16), (6, 32, f32),
                              (7, 64, bf16), (8, 128, f32))}


# gemma2-27b decode at 4 rows, G 2, softcap 50: a local layer's 4096-slot
# ring (pos clamped to 4095 once full, the model's ring rule) and a global
# layer's 5120-row cache
GEMMA2_DECODE = {
    "gemma2_ring_B4_H32_K16_hd128_S4096_cap50": (
        4, 32, 16, 128, 4096, [4095, 4095, 4095, 300], torch.bfloat16, 50.0),
    "gemma2_global_B4_H32_K16_hd128_S5120_cap50": (
        4, 32, 16, 128, 5120, [4700, 4200, 4127, 350], torch.bfloat16, 50.0),
}


def _q_scale(name: str) -> float:
    """gemma2-27b's cases (every one softcapped) scale q into the softcap's
    range; the others keep randn's size."""
    return SOFTCAP_Q_SCALE if name.startswith("gemma2") else 1.0


def _gemma2_fns(device_fns: dict, kernel: str, name: str, r: dict) -> None:
    """A gemma2-27b case's kernel call, and its SDPA stand-in if it has one,
    into the device-time window; the case keeps neither."""
    device_fns[f"{kernel} {name}"] = r.pop("call")
    if "standin_call" in r:
        device_fns[f"SDPA without the softcap (stand-in) {name}"] = \
            r.pop("standin_call")


# gemma-2b decode at 4 rows over a 4608-row cache: 16 padded query heads of
# head_dim 256 over one kv head (G 16), no softcap
GEMMA_2B_DECODE = {
    "gemma_2b_B4_S4608_H16_K1_hd256": (4, 16, 1, 256, 4608,
                                       [4095, 3000, 1200, 31],
                                       torch.bfloat16, 0.0)}


def wide_group_cases() -> dict:
    """Decode cases of both split-S kernels at G 9, 12 and 16 (a group of
    more than 8 heads takes two passes of 8 over the staged rows), hd 128
    and 256, both query types: each row's pos on a 64-key chunk's end, one
    past it, inside a chunk and at S-1; a softcap at G 12. name -> (B, H,
    K, hd, S, pos, dtype, softcap)."""
    f32, bf16 = torch.float32, torch.bfloat16
    return {f"G{G}_hd{hd}_K{K}_S700": (4, G * K, K, hd, 700,
                                       [63, 64, 127 + G, 699], dt,
                                       30.0 if G == 12 else 0.0)
            for G, hd, K, dt in ((9, 128, 2, bf16), (12, 128, 1, f32),
                                 (16, 128, 2, bf16), (9, 256, 1, f32),
                                 (12, 256, 2, bf16), (16, 256, 1, f32),
                                 (16, 256, 2, bf16))}


# a profiler trace that came back without device activities it must hold
# (an empty trace, a lost marker kernel) is taken again, this many times at
# most: one of two runs of this script on one card came back with one
# kernel-phase trace empty
TRACE_TRIES = 3


def kernel_times(fn, iters: int = 10) -> dict:
    """The device kernels a call of ``fn`` launches: name -> mean device
    microseconds a call, from one ``torch.profiler`` trace of ``iters``
    calls (an empty trace taken again, ``TRACE_TRIES`` traces at most)."""
    fn()
    torch.cuda.synchronize()
    for _ in range(TRACE_TRIES):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        out = {e.key: e.device_time_total / iters
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA}
        if out:
            break
        print("kernel_times: the trace holds no device activity; taken "
              "again", flush=True)
    return out


def _template_args(kernel: str) -> list:
    """The template arguments of a demangled kernel name (``void
    (anonymous namespace)::flash_fwd_kernel_tma<64, false>(...)`` ->
    ['64', 'false'])."""
    m = re.search(r"<([^<>]*)>\(", kernel)
    return [a.strip() for a in m.group(1).split(",")] if m else []


def require_flash_kernel(name: str, fn, tma: bool, hd: int = 256) -> None:
    """One call of ``fn`` ran flash's head_dim-``hd`` kernel on the tensor
    cores (``flash_fwd_kernel_tma<hd, ...>``) or on the CUDA cores. A trace
    that names no flash kernel at all (one that lost its activities) is
    taken again, ``TRACE_TRIES`` traces at most."""
    for _ in range(TRACE_TRIES):
        names = [n for n in kernel_times(fn, 1) if "flash_fwd_kernel" in n]
        if names:
            break
        print(f"flash_attn[{name}]: the trace names no flash kernel; taken "
              f"again", flush=True)
    ran = [n for n in names if str(hd) in _template_args(n)
           and ("flash_fwd_kernel_tma" in n) == tma]
    print(f"flash_attn[{name}]: the profile names {names}", flush=True)
    if not ran:
        raise AssertionError(f"flash_attn[{name}]: expected the "
                             f"{'TMA' if tma else 'CUDA-core'} kernel at "
                             f"hd {hd}, the profile names {names}")


def tma_route(hd: int) -> tuple:
    """A ``device_window`` route: flash's head_dim-``hd`` tensor-core
    kernel, never its CUDA-core one."""
    return (f"flash_fwd_kernel_tma<{hd}", "flash_fwd_kernel<")


# gemma2-27b's dense projections (K, N): wq, wk and wv, gate and up, wo,
# down
GEMMA2_PROJECTIONS = ((4608, 4096), (4608, 2048), (4608, 36864),
                      (4096, 4608), (36864, 4608))


def gemma_2b_decode_split(gen) -> None:
    """Where gemma-2b's decode time goes, for both decode kernels: the
    split kernel and the merge kernel (its rows' records pass 12 KB, so
    they merge in a kernel of their own) at the main decode shape, and
    with every row at pos 63 (one 64-key chunk a row: one block a row, no
    merge), which is the time of one block alone."""
    B, H, K, hd, S = 4, 16, 1, 256, 4608
    q = _randn(gen, (B, H, hd), torch.bfloat16)
    k, v = (_randn(gen, (B, S, K, hd), torch.bfloat16) for _ in range(2))
    cache = _int8_cache(gen, B, S, K, hd)
    for pos in ([4095, 3000, 1200, 31], [63] * 4):
        p = torch.tensor(pos, dtype=torch.int32, device=DEV)
        for name, fn in (("decode_attn", lambda: decode_attn(q, k, v, p)),
                         ("decode_attn_int8",
                          lambda: decode_attn_int8(q, *cache, p))):
            times = kernel_times(fn)
            print(f"{name}[gemma_2b_B4_S4608_H16_K1_hd256 at pos {pos}]: "
                  f"device us a call by kernel: " + "; ".join(
                      f"{n.split('(')[0]} {t:.2f}"
                      for n, t in times.items()), flush=True)


def gemma_2b_flash_cases(gen, device_fns: dict) -> None:
    """Flash at gemma-2b's shapes (bf16, 16 padded query heads of head_dim
    256 over one kv head: G 16, 8 query positions a 128-row tile): the
    prefill of a 4096 bucket with uneven lens and the chunk call (4 x 512
    at offsets 3584, 2048, 512, 0 in place over a 4 x 4608 cache), timed
    beside SDPA (no softcap: a true yardstick) and their bound; f32 at hd
    256 on the CUDA cores, timed; then the tile edges at hd 256: S not a
    multiple of the row or the 64-key tile, an empty row, a window, a
    softcap with q scaled x16 (live), G 8 and 12 (12 does not divide the
    128-row tile: 10 positions a tile, 8 pad rows), non-causal, and chunks
    off the tile, in f32 and with a window. The profile must name
    ``flash_fwd_kernel_tma<256, ...>`` for the bf16 prefill, the chunk
    call and G 12, and the CUDA-core kernel for f32."""
    f32, bf16 = torch.float32, torch.bfloat16
    name = "gemma_2b_B4_S4096_H16_K1_hd256"
    r = flash_case(name, gen, 4, 4096, 16, 1, 256, bf16,
                   [4096, 3900, 2100, 300])
    _show("flash_attn", name, r)
    require_flash_kernel(name, r["call"], tma=True)
    device_fns["flash_attn " + name] = r["call"]
    device_fns["SDPA " + name] = r["library_call"]
    name = "gemma_2b_chunk_P4_C512_T4608_H16_K1_hd256"
    r = flash_chunk_case(name, gen, 4, 4608, 16, 1, 256, 512, bf16,
                         slots=[0, 1, 2, 3], start=[3584, 2048, 512, 0],
                         lengths=[512] * 4, measure=True)
    _show("flash_attn", name, r)
    require_flash_kernel(name, r["call"], tma=True)
    device_fns["flash_attn " + name] = r["call"]
    device_fns["SDPA (boolean mask) " + name] = r["library_call"]
    name = "gemma_2b_f32_B2_S512_H16_K1_hd256"
    r = flash_case(name, gen, 2, 512, 16, 1, 256, f32, [512, 300])
    _show("flash_attn", name, r)
    require_flash_kernel(name, r["call"], tma=False)
    device_fns["flash_attn " + name] = r["call"]
    device_fns["SDPA " + name] = r["library_call"]
    for name, (B, S, H, K, dt, lens, kw) in {
            "hd256_G16_S300": (2, 300, 16, 1, bf16, None, {}),
            "hd256_G16_lens0": (2, 300, 16, 1, bf16, [0, 211], {}),
            "hd256_G16_window100": (2, 300, 16, 1, bf16, [300, 257],
                                    {"window": 100}),
            "hd256_G16_softcap30_q16": (2, 300, 16, 1, bf16, None,
                                        {"softcap": 30.0}),
            "hd256_G8_S300": (2, 300, 16, 2, bf16, [300, 129], {}),
            "hd256_G12_S300_tma": (2, 300, 24, 2, bf16, [300, 129], {}),
            "hd256_G16_noncausal": (1, 200, 16, 1, bf16, None,
                                    {"causal": False}),
            "hd256_G16_f32_S300": (2, 300, 16, 1, f32, [300, 77], {}),
    }.items():
        r = flash_case(name, gen, B, S, H, K, 256, dt, lens,
                       q_scale=SOFTCAP_Q_SCALE if "softcap" in kw else 1.0,
                       **kw)
        _show("flash_attn", name, r)
        if name == "hd256_G12_S300_tma":
            require_flash_kernel(name, r["call"], tma=True)
    for name, (Bk, T, H, K, C, slots, start, lengths, window, dt) in {
            "chunk_hd256_G16_off_tile_C100_T700": (
                3, 700, 16, 1, 100, [2, 0], [537, 61], [100, 77], 0, bf16),
            "chunk_hd256_G16_f32_C48_T300": (
                2, 300, 16, 1, 48, [1, 0], [200, 65], [48, 48], 0, f32),
            "chunk_hd256_G16_window64_C128_T600": (
                3, 600, 16, 1, 128, [1, 2], [472, 129], [128, 100], 64,
                bf16),
    }.items():
        flash_chunk_case(name, gen, Bk, T, H, K, 256, C, dt, slots, start,
                         lengths, window)


def recurrentgemma_kernel_cases(gen, device_fns: dict) -> None:
    """Flash and bf16 decode at recurrentgemma-9b's local layers (bf16, 16
    query heads of head_dim 256 over one kv head: G 16; window 2048; no
    softcap): the prefill of a 4096 bucket with uneven lens, a chunk call
    (4 x 512 over each ring gathered into position order, 2048 + 512 keys,
    at query offsets 2048, 2048, 1000, 0) and decode on a 2048-slot ring
    (pos clamped to 2047 once it is full, the model's ring rule); each held
    against its plain version and timed beside SDPA with a boolean mask of
    the same keys (causal, window, lengths) and its bound. The profile must
    name ``flash_fwd_kernel_tma<256, ...>`` for the prefill and the
    chunk."""
    bf16 = torch.bfloat16
    name = "recurrentgemma_local_B4_S4096_H16_K1_hd256_w2048"
    r = flash_case(name, gen, 4, 4096, 16, 1, 256, bf16,
                   [4096, 3900, 2100, 300], window=2048)
    _show("flash_attn", name, r)
    require_flash_kernel(name, r["call"], tma=True)
    device_fns["flash_attn " + name] = r["call"]
    device_fns["SDPA (boolean mask) " + name] = r["library_call"]
    name = "recurrentgemma_local_chunk_P4_C512_T2560_hd256_w2048"
    r = flash_chunk_case(name, gen, 4, 2560, 16, 1, 256, 512, bf16,
                         slots=[0, 1, 2, 3], start=[2048, 2048, 1000, 0],
                         lengths=[512, 300, 512, 77], window=2048,
                         measure=True)
    _show("flash_attn", name, r)
    require_flash_kernel(name, r["call"], tma=True)
    device_fns["flash_attn " + name] = r["call"]
    device_fns["SDPA (boolean mask) " + name] = r["library_call"]
    name = "recurrentgemma_ring_B4_H16_K1_hd256_S2048"
    r = decode_case(name, gen, 4, 16, 1, 256, 2048, [2047, 2047, 2047, 300],
                    bf16)
    _show("decode_attn", name, r)
    device_fns["decode_attn " + name] = r["call"]
    device_fns["SDPA " + name] = r["library_call"]


# XLM-R's flash calls: 8 sentences a batch in buckets 32, 128 and 512 (rows
# 1r, 1s, 1t of PERF.md), each row's length that of a sentence of the
# bucket, as length-sorted batches of ``xlmr_sentences`` hold them
XLMR_FLASH = {"1r": (32, [32, 30, 27, 25, 22, 20, 17, 12]),
              "1s": (128, [128, 119, 104, 97, 88, 77, 70, 65]),
              "1t": (512, [512, 488, 431, 390, 333, 301, 280, 257])}
# a bucket-32 batch of a short last batch's kind: empty rows (length 0),
# length 1, one short of the bucket and the whole bucket
XLMR_PADDED_LENS = [1, 0, 31, 32, 16, 0, 5, 32]


def xlmr_flash_cases(gen, device_fns: dict) -> None:
    """Flash at XLM-R's shapes (bf16, non-causal, 16 heads of head_dim 64,
    G 1, per-row lengths): a batch of 8 in buckets 32, 128 and 512, held
    against the plain version, timed beside SDPA with a boolean key-padding
    mask and the bound; the profile must name
    ``flash_fwd_kernel_tma<64, ...>``. Then a bucket-32 batch with empty
    rows, whose outputs must be exactly 0 (the plain version's too)."""
    bf16 = torch.bfloat16
    for row, (S, lens) in XLMR_FLASH.items():
        name = f"xlmr_{row}_B8_S{S}_H16_K16_hd64_noncausal"
        r = flash_case(name, gen, 8, S, 16, 16, 64, bf16, lens,
                       causal=False)
        _show("flash_attn", name, r)
        require_flash_kernel(name, r["call"], tma=True, hd=64)
        device_fns["flash_attn " + name] = r["call"]
        device_fns["SDPA (boolean mask) " + name] = r["library_call"]
    name = "xlmr_1r_B8_S32_hd64_noncausal_empty_rows"
    r = flash_case(name, gen, 8, 32, 16, 16, 64, bf16, XLMR_PADDED_LENS,
                   causal=False)
    _show("flash_attn", name, r)
    empty = [i for i, n in enumerate(XLMR_PADDED_LENS) if n == 0]
    out = r["call"]()
    if out[empty].abs().max().item() != 0.0:
        raise AssertionError(f"flash_attn[{name}]: rows {empty} have no key "
                             f"and must give 0")


# whisper-medium's attention calls, B 8 rows of 1500 frames, 16 heads of 64
# over 16 kv heads (G 1), bf16 (rows 1w, 1x, 2w, 2x of PERF.md): the
# encoder's non-causal flash (S = T = 1500 = 11 x 128 + 92), the cross
# prefill's (the 16-token prompt bucket over 1500 frames), decode's cross
# read (every frame, pos 1499) and its self read at the served steps' last
# positions in a 448-row cache
WHISPER_SELF_POS = [p + 62 for p in (16, 4, 9, 4, 12, 4, 7, 4)]
WHISPER_DECODE = {
    "whisper_2w_cross_B8_H16_K16_hd64_S1500": (8, 16, 16, 64, 1500,
                                               [1499] * 8, torch.bfloat16,
                                               0.0),
    "whisper_2x_self_B8_H16_K16_hd64_S448": (8, 16, 16, 64, 448,
                                             WHISPER_SELF_POS,
                                             torch.bfloat16, 0.0)}


def whisper_kernel_cases(device_fns: dict) -> None:
    """Flash at whisper-medium's encoder (1w) and cross prefill (1x), each
    held against the plain version and timed beside SDPA (a boolean mask
    of the same keys) and its bound, the profile naming
    ``flash_fwd_kernel_tma<64, ...>``; then decode at its cross (2w) and
    self (2x) reads, timed beside SDPA. Their inputs come from a generator
    of their own, so that every other case keeps its inputs."""
    gen = torch.Generator(device=DEV).manual_seed(30)
    for row, (S, T) in {"1w": (1500, 1500), "1x": (16, 1500)}.items():
        name = f"whisper_{row}_B8_S{S}_T{T}_H16_K16_hd64_noncausal"
        r = flash_case(name, gen, 8, S, 16, 16, 64, torch.bfloat16, T=T,
                       causal=False)
        _show("flash_attn", name, r)
        require_flash_kernel(name, r["call"], tma=True, hd=64)
        device_fns["flash_attn " + name] = r["call"]
        device_fns["SDPA (boolean mask) " + name] = r["library_call"]
    for name, (B, H, K, hd, S, pos, dt, cap) in WHISPER_DECODE.items():
        r = decode_case(name, gen, B, H, K, hd, S, pos, dt, cap)
        _show("decode_attn", name, r)
        device_fns["decode_attn " + name] = r["call"]
        device_fns["SDPA " + name] = r["library_call"]


def phase_kernels() -> dict:
    """Every case of both kernels; returns the main-path measurements."""
    gen = torch.Generator(device=DEV).manual_seed(0)
    f32, bf16 = torch.float32, torch.bfloat16
    # the JAX package's cases (repro/kernels/flash_attn/ops.py)
    flash_cases = {
        "mha_64": (2, 64, 4, 4, 32, f32, None, {}),
        "gqa_128": (2, 128, 8, 2, 64, f32, None, {}),
        "mqa_256": (1, 256, 8, 1, 64, f32, None, {}),
        "local_128": (2, 128, 4, 4, 32, f32, None, {"window": 32}),
        "softcap": (2, 64, 4, 2, 32, f32, None, {"softcap": 30.0}),
        "padded_lens": (2, 64, 4, 4, 32, f32, [38, 38], {}),
        "noncausal": (2, 64, 4, 4, 32, f32, None, {"causal": False}),
        "odd_seq_96": (1, 96, 4, 4, 32, f32, None, {}),
        "bf16": (2, 128, 8, 2, 64, bf16, None, {}),
        # the tensor-core kernel's edges: GQA at hd 128, S past the 128-row
        # tile, an empty row, a window, a softcap, hd 64, 32 heads to a kv head
        "bf16_gqa_B2_S256_H32_K8_hd128": (2, 256, 32, 8, 128, bf16, None, {}),
        "bf16_S300_hd128": (2, 300, 8, 8, 128, bf16, None, {}),
        "bf16_lens0_hd128": (2, 300, 8, 8, 128, bf16, [0, 211], {}),
        "bf16_window128_hd128": (2, 300, 8, 8, 128, bf16, None,
                                 {"window": 128}),
        "bf16_softcap30_hd128": (2, 300, 8, 4, 128, bf16, None,
                                 {"softcap": 30.0}),
        "bf16_hd64_S300_lens": (2, 300, 8, 2, 64, bf16, [300, 129], {}),
        "bf16_mqa_G32_hd128": (1, 256, 32, 1, 128, bf16, None, {}),
        # deepseek-7b prefill: 4 prompts of a 512 bucket, right-padded
        "main_B4_S512_H32_hd128": (4, 512, 32, 32, 128, bf16,
                                   [512, 300, 77, 1], {}),
        # gemma2-27b prefill, 4 prompts of a 4608 bucket, right-padded: a
        # local layer (window 4096, which starts up to 4 tiles in, with the
        # softcap: the first case that checks them together) and a global
        # one (the softcap alone)
        "gemma2_local_B4_S4608_H32_K16_hd128_w4096_cap50": (
            4, 4608, 32, 16, 128, bf16, [4608, 4400, 4100, 300],
            {"window": 4096, "softcap": 50.0}),
        "gemma2_global_B4_S4608_H32_K16_hd128_cap50": (
            4, 4608, 32, 16, 128, bf16, [4608, 4400, 4100, 300],
            {"softcap": 50.0}),
    }
    device_fns = {}
    routes = {}
    main = {}
    for name, (B, S, H, K, hd, dt, lens, kw) in flash_cases.items():
        r = flash_case(name, gen, B, S, H, K, hd, dt, lens,
                       q_scale=_q_scale(name), **kw)
        _show("flash_attn", name, r)
        if name.startswith("main"):
            main["flash_attn"] = r
            device_fns["flash_attn " + name] = r["call"]
            device_fns["SDPA " + name] = r["library_call"]
        if name.startswith("gemma2"):
            _gemma2_fns(device_fns, "flash_attn", name, r)
    # prefill chunks at query offsets over a larger cache: offsets off the
    # 128-key tile, a short last chunk and a padded row (lengths 0,
    # repeating the first slot), G 4 and 8 at hd 64 and 128, the CUDA-core
    # kernel in f32 at hd 16 and 128, a window
    chunk_cases = {
        "chunk_off_tile_C100_T400": (4, 400, 8, 8, 128, 100, [3, 1],
                                     [300, 157], [100, 100], 0, bf16),
        "chunk_short_lens_C128_T512": (3, 512, 8, 8, 128, 128, [2, 0, 1, 2],
                                       [384, 0, 200, 0], [128, 5, 77, 0], 0,
                                       bf16),
        "chunk_G4_C64_T300_hd128": (2, 300, 16, 4, 128, 64, [1, 0],
                                    [236, 10], [64, 40], 0, bf16),
        "chunk_G8_C64_T300_hd64": (2, 300, 16, 2, 64, 64, [1, 0], [236, 129],
                                   [64, 33], 0, bf16),
        "chunk_f32_hd16_C32_T128": (3, 128, 4, 2, 16, 32, [2, 1], [96, 31],
                                    [32, 20], 0, f32),
        "chunk_f32_hd128_C48_T256": (2, 256, 8, 4, 128, 48, [0, 1],
                                     [200, 65], [48, 48], 0, f32),
        "chunk_hd64_C96_T512": (4, 512, 8, 8, 64, 96, [3, 2, 1], [416, 97, 0],
                                [96, 96, 50], 0, bf16),
        "chunk_window64_C128_T600": (3, 600, 8, 8, 128, 128, [1, 2],
                                     [472, 129], [128, 100], 64, bf16),
    }
    for name, (Bk, T, H, K, hd, C, slots, start, lengths, window,
               dt) in chunk_cases.items():
        flash_chunk_case(name, gen, Bk, T, H, K, hd, C, dt, slots, start,
                         lengths, window)
    flash_bad_row(gen)
    name = "chunk_main_P4_C128_T1024_H32_hd128"
    r = flash_chunk_case(name, gen, 4, 1024, 32, 32, 128, 128, bf16,
                         measure=True, **CHUNK_MAIN)
    _show("flash_attn", name, r)
    main["flash_attn_chunk"] = r
    device_fns["flash_attn " + name] = r["call"]
    device_fns["SDPA (boolean mask) " + name] = r["library_call"]
    # gemma2-27b's chunk calls (prefill_chunk 512, 4 rows). A local layer
    # attends its ring gathered into position order with the chunk after
    # it (4096 + 512 keys) at query offset n = min(start, 4096), window
    # 4096 and softcap 50; a global layer its cache rows in place at
    # offsets past the window, softcap 50; and the same in-place read with
    # the window too (offsets past it, the kernel's domain)
    for name, (T, start, lengths, window) in {
            "gemma2_local_chunk_P4_C512_T4608_w4096_cap50": (
                4608, [4096, 4096, 2100, 0], [512, 300, 512, 77], 4096),
            "gemma2_global_chunk_P4_C512_T5120_cap50": (
                5120, [4608, 4096, 512, 0], [512, 504, 512, 71], 0),
            "gemma2_window_chunk_P4_C512_T5120_w4096_cap50": (
                5120, [4608, 4096, 4097, 0], [512, 504, 23, 71], 4096)
    }.items():
        r = flash_chunk_case(name, gen, 4, T, 32, 16, 128, 512, bf16,
                             slots=[0, 1, 2, 3], start=start,
                             lengths=lengths, window=window, softcap=50.0,
                             measure=True, q_scale=_q_scale(name))
        _show("flash_attn", name, r)
        _gemma2_fns(device_fns, "flash_attn", name, r)
    gemma_2b_flash_cases(gen, device_fns)
    recurrentgemma_kernel_cases(gen, device_fns)
    xlmr_flash_cases(gen, device_fns)
    whisper_kernel_cases(device_fns)
    qwen2vl_kernel_cases()
    # the JAX package's cases (repro/kernels/decode_attn/ops.py), scalar
    # pos broadcast to every row, then deepseek-7b decode at per-row pos
    decode_cases = {
        "B2_H8_K8_hd64_S256_p0.5": (2, 8, 8, 64, 256, [128] * 2, f32, 0.0),
        "B2_H8_K2_hd64_S256_p0.9": (2, 8, 2, 64, 256, [230] * 2, f32, 0.0),
        "B1_H8_K1_hd128_S512_p0.3": (1, 8, 1, 128, 512, [153], f32, 0.0),
        "B4_H4_K4_hd32_S64_p0.0": (4, 4, 4, 32, 64, [0] * 4, f32, 0.0),
        "softcap_B2_H8_K4_hd64_S256": (2, 8, 4, 64, 256, [179] * 2, f32,
                                       50.0),
        "main_B4_S1024_H32_hd128": (4, 32, 32, 128, 1024,
                                    [1023, 600, 31, 0], bf16, 0.0),
    }
    decode_cases.update(GEMMA2_DECODE)
    decode_cases.update(GEMMA_2B_DECODE)
    # the split-S kernel's edges (64-key chunks at these sizes): pos 0, one
    # short of a chunk's end, on it, one past it, and at and past S-1; G
    # from 1 to 16 and hd from 16 to 256 in both types; softcap; and f32 at
    # hd 128 at the main shape, whose 128-key chunks take 135 KB of shared
    # memory
    decode_cases.update({
        "edges_B4_H8_K8_hd128_S1024": (4, 8, 8, 128, 1024, [0, 62, 63, 64],
                                       bf16, 0.0),
        "edges_B4_H8_K8_hd64_S1024": (4, 8, 8, 64, 1024,
                                      [127, 128, 1023, 5000], f32, 0.0),
        "softcap_B2_H32_K8_hd128_S700": (2, 32, 8, 128, 700, [699, 191],
                                         bf16, 30.0),
        "f32_B4_S1024_H32_hd128": (4, 32, 32, 128, 1024, [1023, 600, 31, 0],
                                   f32, 0.0),
        # 128-key chunks on 8 warps a block, G 4, softcap
        "gqa_B4_H128_K32_hd128_S1024": (4, 128, 32, 128, 1024,
                                        [1023, 511, 128, 127], bf16, 30.0)})
    decode_cases.update(split_group_cases())
    decode_cases.update(wide_group_cases())
    for name, (B, H, K, hd, S, pos, dt, cap) in decode_cases.items():
        r = decode_case(name, gen, B, H, K, hd, S, pos, dt, cap,
                        q_scale=_q_scale(name))
        _show("decode_attn", name, r)
        if name.startswith("gemma_2b"):
            device_fns["decode_attn " + name] = r["call"]
            device_fns["SDPA " + name] = r["library_call"]
        if name.startswith("main"):
            main["decode_attn"] = r
            device_fns["decode_attn " + name] = r["call"]
            device_fns["SDPA " + name] = r["library_call"]
        if name.startswith("gemma2"):
            _gemma2_fns(device_fns, "decode_attn", name, r)
    # the JAX package's cases (repro/kernels/w8a8/ops.py), then deepseek-7b's
    # dense projections at decode (4 rows) and prefill (4 x 512 rows)
    w8a8_cases = {
        "128x128x128": (128, 128, 128, False),
        "256x512x128": (256, 512, 128, False),
        "128x256x384": (128, 256, 384, False),
        "512x128x256": (512, 128, 256, False),
        "96x192x320_padded": (96, 192, 320, False),
        "48x160x288_rowscale_padded": (48, 160, 288, True),
        "128x128x128_rowscale": (128, 128, 128, True),
    }
    for M in (4, 2048):
        for K, N in ((4096, 4096), (4096, 11008), (11008, 4096)):
            w8a8_cases[f"main_M{M}_K{K}_N{N}"] = (M, K, N, True)
    # gemma-2b's projections: wq (2048 -> 16 padded heads x 256), wk and wv
    # (-> 256), gate and up (-> 16384), wo (4096 -> 2048), down (16384 ->
    # 2048), at decode (4 rows) and prefill (2048 rows)
    for M in (4, 2048):
        for K, N in ((2048, 4096), (2048, 256), (2048, 16384), (4096, 2048),
                     (16384, 2048)):
            w8a8_cases[f"gemma_2b_M{M}_K{K}_N{N}"] = (M, K, N, True)
    # gemma2-27b's projections: wq (4608 -> 32 heads x 128), wk and wv (->
    # 16 x 128), gate and up (-> 36864), wo (4096 -> 4608), down (36864 ->
    # 4608), at decode (4 rows) and prefill (2048 rows)
    for M in (4, 2048):
        for K, N in GEMMA2_PROJECTIONS:
            w8a8_cases[f"gemma2_M{M}_K{K}_N{N}"] = (M, K, N, True)
    # the tensor-core kernel's edges (ragged M, a partial K tile, a partial
    # N tile) and the other two routes (M <= 16; K % 16 != 0)
    for M in (17, 65, 2047):
        w8a8_cases[f"M{M}_K4096_N11008"] = (M, 4096, 11008, True)
    w8a8_cases.update({"M300_K4112_N4096": (300, 4112, 4096, True),
                       "M300_K4096_N4104": (300, 4096, 4104, True),
                       "decode_M4_K4112_N4104": (4, 4112, 4104, True),
                       "fallback_M300_K4100_N4104": (300, 4100, 4104, True)})
    # the split-K decode-rows kernel: M from 1 to 16 at deepseek-7b's
    # shapes, the reduced configs' K of 64 and 128 (one slice), K slices
    # that end inside a 256-byte step (11024 -> 5504 + 5520 bytes, 2752 ->
    # 1376 + 1376), and the byte-wise M <= 16 route (K % 16 != 0)
    for M in (1, 8, 16):
        for K, N in ((4096, 4096), (4096, 11008), (11008, 4096)):
            w8a8_cases[f"decode_M{M}_K{K}_N{N}"] = (M, K, N, True)
    w8a8_cases.update({
        "decode_M4_K64_N192": (4, 64, 192, True),
        "decode_M4_K128_N64": (4, 128, 64, True),
        "decode_M3_K11024_N4096_midstep": (3, 11024, 4096, True),
        "decode_M16_K2752_N4104_scalar": (16, 2752, 4104, False),
        "bytewise_M4_K4100_N4104": (4, 4100, 4104, True)})
    for name, (M, K, N, row) in w8a8_cases.items():
        r = w8a8_case(name, gen, M, K, N, row)
        _show("w8a8_matmul", name, r)
        if name == "main_M4_K4096_N11008":
            main["w8a8_matmul"] = r
        if name.startswith(("main_M", "gemma_2b", "gemma2_M")):
            device_fns["w8a8_matmul " + name] = r["call"]
            device_fns["torch._int_mm + scales " + name] = r["library_call"]
        if name.startswith("gemma2_M"):
            # the split-K kernel for decode rows, the TMA kernel past 16
            # rows; never the fallback kernel (``w8a8_kernel<...>``)
            routes["w8a8_matmul " + name] = (
                "w8a8_splitk_kernel" if M <= 16 else "w8a8_kernel_tma",
                "w8a8_kernel<")
    # the JAX package's int8 cases (repro/kernels/decode_attn/ops.py),
    # scalar pos broadcast, then deepseek-7b decode over an int8 cache
    decode_int8_cases = {
        "B2_H8_K8_hd64_S256_p0.5": (2, 8, 8, 64, 256, [128] * 2, f32, 0.0),
        "B2_H8_K2_hd64_S256_p0.9": (2, 8, 2, 64, 256, [230] * 2, f32, 0.0),
        "B1_H8_K1_hd128_S512_p0.3": (1, 8, 1, 128, 512, [153], f32, 0.0),
        "main_B4_S1024_H32_hd128": (4, 32, 32, 128, 1024,
                                    [1023, 600, 31, 0], bf16, 0.0),
    }
    decode_int8_cases.update(GEMMA2_DECODE)
    decode_int8_cases.update(GEMMA_2B_DECODE)
    # the split-S kernel's edges (64-key chunks at these sizes): pos 0, one
    # short of a chunk's end, on it, one past it, and at and past S-1; G
    # from 1 to 8 and hd from 16 to 128 in both query types; softcap
    decode_int8_cases.update({
        "edges_B4_H8_K8_hd128_S1024": (4, 8, 8, 128, 1024, [0, 62, 63, 64],
                                       bf16, 0.0),
        "edges_B4_H8_K8_hd64_S1024": (4, 8, 8, 64, 1024,
                                      [127, 128, 1023, 5000], f32, 0.0),
        "softcap_B2_H32_K8_hd128_S700": (2, 32, 8, 128, 700, [699, 191],
                                         bf16, 30.0),
        # 256-key chunks on 8 warps a block (two tiles a warp), G 2
        "B8_H64_K32_hd128_S2048": (8, 64, 32, 128, 2048,
                                   [2047, 1500, 256, 255, 0, 1024, 700, 64],
                                   f32, 0.0)})
    decode_int8_cases.update(split_group_cases())
    decode_int8_cases.update(wide_group_cases())
    for name, (B, H, K, hd, S, pos, dt, cap) in decode_int8_cases.items():
        r = decode_int8_case(name, gen, B, H, K, hd, S, pos, dt, cap,
                             q_scale=_q_scale(name))
        _show("decode_attn_int8", name, r)
        if name.startswith("gemma_2b"):
            device_fns["decode_attn_int8 " + name] = r["call"]
        if name.startswith("main"):
            main["decode_attn_int8"] = r
            device_fns["decode_attn_int8 " + name] = r["call"]
        if name.startswith("gemma2"):
            _gemma2_fns(device_fns, "decode_attn_int8", name, r)
    gemma_2b_decode_split(gen)
    main.update(sls_cases(gen, device_fns))
    device_window(device_fns, routes=routes)
    for r in main.values():         # let the main shapes' tables go
        r.pop("call", None)
        r.pop("library_call", None)
    sweep(seed=1, n=32)
    sweep_chunks(seed=4, n=24)
    sweep_int8(seed=2, n=32)
    sweep_sls(seed=3, n=32)
    return main


def marked_window(calls, before=None):
    """Run ``calls`` in one ``torch.profiler`` window, each (after
    ``before()``, if given) between two marker kernels
    (``torch.cuda._sleep``'s ``spin_kernel``): kernels launched through
    ctypes or replayed from a graph carry no PyTorch op to attribute them
    to, so the markers say which call a device activity belongs to.
    A window that lost a marker is taken again, ``TRACE_TRIES`` windows at
    most. Returns (the trace, its device activities in start order, the
    (first, second) marker index of each call), the last None when every
    window lost a marker."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(TRACE_TRIES):
        with torch.profiler.profile(activities=acts) as prof:
            for fn in calls:
                if before is not None:
                    before()
                torch.cuda._sleep(100)
                fn()
                torch.cuda._sleep(100)
            torch.cuda.synchronize()
        events = sorted((e for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA
                         and not e.is_user_annotation),
                        key=lambda e: e.time_range.start)
        marks = [i for i, e in enumerate(events) if "spin_kernel" in e.name]
        if len(marks) == 2 * len(calls):
            return prof, events, list(zip(marks[::2], marks[1::2]))
        print(f"marked window: {len(marks)} marker kernels in the trace, "
              f"{2 * len(calls)} launched", flush=True)
    return prof, events, None


def device_window(fns: dict, iters: int = 10, routes=None) -> None:
    """Device time of one call of each of ``fns`` (a name -> callable; None
    is skipped), from one ``marked_window``: each call follows an L2 flush,
    and its time is the sum of the device activities between its two
    markers. ``routes``: a name of ``fns`` -> (a
    kernel name its calls must run, one they must not); the window must
    then be read, and each such call's kernels are printed."""
    routes = routes or {}
    fns = {k: f for k, f in fns.items() if f is not None}
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=DEV)
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    _, events, pairs = marked_window(
        [fn for fn in fns.values() for _ in range(iters)], flush.zero_)
    if pairs is None:
        print("device time per call: not measured (marker kernels missing "
              "from the trace)", flush=True)
        if routes:
            raise AssertionError(f"device window unread: the kernels of "
                                 f"{sorted(routes)} cannot be checked")
        return
    times = [sum(e.time_range.elapsed_us() for e in events[a + 1:b]) / 1e3
             for a, b in pairs]
    for i, name in enumerate(fns):
        if name not in routes:
            continue
        want, never = routes[name]
        ran = sorted({e.name for a, b in pairs[i * iters:(i + 1) * iters]
                      for e in events[a + 1:b]})
        print(f"{name}: device kernels {ran}", flush=True)
        if not any(want in n for n in ran) or any(never in n for n in ran):
            raise AssertionError(f"{name}: expected {want} and no "
                                 f"{never}, the window names {ran}")
    print("device time per call (one torch.profiler window, after an L2 "
          "flush each): " + "; ".join(
              f"{name} {sum(times[i * iters:(i + 1) * iters]) / iters:.4f} ms"
              for i, name in enumerate(fns)), flush=True)


def sweep(seed: int, n: int) -> None:
    """``n`` random cases per kernel, outside the JAX package's cases:
    T != S, empty rows (lens or pos 0), every head_dim and group size the
    kernels take, both input types (bf16 at hd 64 and 128 most often: the
    tensor-core path), S and T at its tile edges half the time, masks and
    softcap mixed; decode half the time over a cache of several chunks with
    each row's pos on or next to a chunk boundary (``chunk_plan``); each
    against its plain version. No timing."""
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=DEV).manual_seed(seed)

    def pick(xs):
        return xs[int(rng.integers(0, len(xs)))]

    worst = {"flash_attn": 0.0, "decode_attn": 0.0}
    for i in range(n):
        B, K = int(rng.integers(1, 4)), pick([1, 2, 4])
        G = pick([1, 2, 4, 8, 9, 12, 16])
        hd = pick([16, 32, 64, 128, 64, 128, 256])
        dt = pick([torch.float32, torch.bfloat16, torch.bfloat16])
        cap = pick([0.0, 0.0, 30.0])
        # half the sizes at the tensor-core kernel's 128-row / 128-key edges
        S, T = (pick([int(rng.integers(1, 300)),
                      pick([127, 128, 129, 255, 256, 257])]) for _ in range(2))
        kw = dict(causal=bool(rng.integers(0, 2)), window=pick([0, 0, 16, 70]),
                  softcap=cap)
        q = _randn(gen, (B, S, K * G, hd), dt)
        k, v = (_randn(gen, (B, T, K, hd), dt) for _ in range(2))
        lens = torch.tensor(rng.integers(0, T + 1, B), dtype=torch.int32,
                            device=DEV)
        err = compare(f"flash_attn[sweep {i}: B{B} S{S} T{T} K{K} G{G} hd{hd} "
                      f"{dt} {kw} lens {lens.tolist()}]",
                      flash_attn(q, k, v, lens, **kw),
                      flash_attention_ref(q, k, v, lens, **kw), dt)
        worst["flash_attn"] = max(worst["flash_attn"], err)
        qd = _randn(gen, (B, K * G, hd), dt)
        if rng.integers(0, 2):          # the split edges, on a longer cache
            T = int(rng.integers(129, 1100))
            k, v = (_randn(gen, (B, T, K, hd), dt) for _ in range(2))
            chunk = chunk_plan(B, K, T, SMS, hd, k.element_size(), G)
            edges = [c * chunk + d for c in range(T // chunk + 1)
                     for d in (-1, 0, 1)] + [T - 1, T + 3]
            pos = torch.tensor([max(0, pick(edges)) for _ in range(B)],
                               dtype=torch.int32, device=DEV)
        else:
            pos = torch.tensor(rng.integers(0, T, B), dtype=torch.int32,
                               device=DEV)
        err = compare(f"decode_attn[sweep {i}: B{B} S{T} K{K} G{G} hd{hd} "
                      f"{dt} softcap {cap} pos {pos.tolist()}]",
                      decode_attn(qd, k, v, pos, softcap=cap),
                      decode_attn_ref(qd, k, v, pos, softcap=cap), dt)
        worst["decode_attn"] = max(worst["decode_attn"], err)
    torch.cuda.synchronize()
    print(f"sweep: {n} random cases per kernel agree with the plain versions;"
          f" max abs err {worst}", flush=True)


def sweep_chunks(seed: int, n: int) -> None:
    """``n`` random prefill-chunk cases of flash: a cache of 1 to 4 rows,
    a group of 1 to 4 rows (repeats allowed), offsets anywhere in the
    cache, chunks near the 128-key tile, lengths from 0 to the chunk,
    every head_dim and group size, both types, windows and softcaps; each
    against its plain version. No timing."""
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=DEV).manual_seed(seed)

    def pick(xs):
        return xs[int(rng.integers(0, len(xs)))]

    worst = 0.0
    for i in range(n):
        Bk, P = int(rng.integers(1, 5)), int(rng.integers(1, 5))
        K, G = pick([1, 2, 4]), pick([1, 2, 4, 8, 12, 16])
        hd = pick([16, 32, 64, 128, 64, 128, 256])
        dt = pick([torch.float32, torch.bfloat16, torch.bfloat16])
        C = pick([int(rng.integers(1, 200)), pick([127, 128, 129])])
        T = C + int(rng.integers(0, 500))
        start = [int(rng.integers(0, T - C + 1)) for _ in range(P)]
        lengths = [int(rng.integers(0, C + 1)) for _ in range(P)]
        slots = [int(rng.integers(0, Bk)) for _ in range(P)]
        window, cap = pick([0, 0, 16, 70]), pick([0.0, 0.0, 30.0])
        err = flash_chunk_case(
            f"chunk sweep {i}: Bk{Bk} T{T} C{C} K{K} G{G} hd{hd} {dt} "
            f"slots {slots} start {start} lengths {lengths} window {window} "
            f"softcap {cap}", gen, Bk, T, K * G, K, hd, C, dt, slots, start,
            lengths, window, cap, quiet=True)
        worst = max(worst, err)
    torch.cuda.synchronize()
    print(f"sweep: {n} random prefill-chunk cases of flash_attn agree with "
          f"the plain version; max abs err {worst:.3e}", flush=True)


def sweep_int8(seed: int, n: int) -> None:
    """``n`` random cases per int8 kernel: w8a8 at ragged M, K and N, at
    the tensor-core kernel's 128-row, 256-column and 128-byte K tile edges
    (K not a multiple of 16 takes the fallback's byte-wise loader), M <= 16
    (the split-K kernel) about half the time, scalar and per-row scales,
    checked bit for bit; int8-KV decode at every head_dim and group size,
    both query types, empty rows and softcap mixed, half the time with S
    over several chunks and each row's pos on or next to a chunk boundary
    (``chunk_plan``). No timing."""
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=DEV).manual_seed(seed)

    def pick(xs):
        return xs[int(rng.integers(0, len(xs)))]

    worst = {"w8a8_matmul": 0.0, "decode_attn_int8": 0.0}
    for i in range(n):
        M = pick([1, 3, 4, 16, 17, 64, 127, 128, 129, 257,
                  int(rng.integers(1, 600)), int(rng.integers(1, 17)),
                  int(rng.integers(1, 17)), int(rng.integers(1, 17)),
                  int(rng.integers(1, 17)), int(rng.integers(1, 17))])
        K = pick([int(rng.integers(1, 40)) * 16,
                  pick([112, 128, 144, 256, 272]), int(rng.integers(1, 700))])
        N = pick([int(rng.integers(1, 400)), pick([255, 256, 257, 511, 513])])
        row = bool(rng.integers(0, 2))
        xq, wq, xs, ws = _w8a8_inputs(gen, M, K, N, row)
        err = check_w8a8(f"sweep {i}: M{M} K{K} N{N} per-row {row}",
                         w8a8_matmul(xq, wq, xs, ws),
                         w8a8_ref(xq, wq, xs, ws))
        worst["w8a8_matmul"] = max(worst["w8a8_matmul"], err)
        B, K = int(rng.integers(1, 4)), pick([1, 2, 4])
        G = pick([1, 2, 4, 8, 9, 12, 16])
        hd = pick([16, 32, 64, 128, 256])
        dt = pick([torch.float32, torch.bfloat16])
        cap, T = pick([0.0, 0.0, 30.0]), int(rng.integers(1, 300))
        if rng.integers(0, 2):          # the split edges
            T = int(rng.integers(129, 1100))
            chunk = int8_chunk_plan(B, K, T, SMS, hd, G)
            edges = [c * chunk + d for c in range(T // chunk + 1)
                     for d in (-1, 0, 1)] + [T - 1, T + 3]
            pos = torch.tensor([max(0, pick(edges)) for _ in range(B)],
                               dtype=torch.int32, device=DEV)
        else:
            pos = torch.tensor(rng.integers(0, T, B), dtype=torch.int32,
                               device=DEV)
        q = _randn(gen, (B, K * G, hd), dt)
        cache = _int8_cache(gen, B, T, K, hd)
        err = compare(f"decode_attn_int8[sweep {i}: B{B} S{T} K{K} G{G} "
                      f"hd{hd} {dt} softcap {cap} pos {pos.tolist()}]",
                      decode_attn_int8(q, *cache, pos, softcap=cap),
                      decode_attn_int8_ref(q, *cache, pos, softcap=cap), dt)
        worst["decode_attn_int8"] = max(worst["decode_attn_int8"], err)
    torch.cuda.synchronize()
    print(f"sweep: {n} random cases per int8 kernel agree with the plain "
          f"versions; max abs err {worst}", flush=True)


# ---- serve ----------------------------------------------------------------

def stage_ms(tel, stage: str) -> float:
    """Mean wall time of one call of an engine stage (each stage ends in a
    copy of its tokens to the host, so this is its time to completion)."""
    return 1e3 * tel.stage_dispatch_s[stage] / tel.stage_calls[stage]


def _requests(n, lo, hi, new_tokens, vocab, seed):
    rng = np.random.default_rng(seed)
    return [Request(i, rng.integers(0, vocab, int(L)).astype(np.int32),
                    max_new_tokens=new_tokens)
            for i, L in enumerate(rng.integers(lo, hi + 1, n))]


def _int8_kv(cfg):
    return dataclasses.replace(
        cfg, quant=dataclasses.replace(cfg.quant, kv_cache_dtype="int8"))


def _graph_counts(eng) -> str:
    ex = eng.executor
    if not ex.graphs:
        return "eager (cuda_graphs=False): no graph"
    secs = {k: round(v, 3) for k, v in ex.capture_s.items()}
    return (f"CUDA graphs captured per stage {dict(ex.captures)} (seconds "
            f"capturing, warm-ups apart: {secs}), replayed {dict(ex.replays)}")


def _serve(eng, cfg, label: str, base: int, trace=None, warm=None,
           model: str = "deepseek-7b"):
    """Warm the engine (by default on one request; ``warm()``: the
    requests to warm it with), then serve 8 requests x 32 tokens (by
    default 64-512 tokens long; ``trace()``: the requests) with every
    launch counter zeroed just before and read just after. Raises unless
    all 8 got 32 tokens in the vocab. ``base``: the bytes allocated on the
    card before the engine was built. Returns (launches, the requests'
    outputs)."""
    torch.cuda.reset_peak_memory_stats()
    eng.run(warm() if warm is not None
            else _requests(1, 64, 64, 4, cfg.vocab_size, seed=1))
    eng.telemetry.reset_serving_stats()
    reqs = trace() if trace is not None \
        else _requests(8, 64, 512, 32, cfg.vocab_size, seed=0)
    _zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in LAUNCHERS.items()}
    launches["flash_attn at a q_off"] = flash_attn.offset_launches
    launches["flash_attn with a window"] = flash_attn.window_launches
    tel = eng.telemetry
    prefill = ("chunk call", "chunk_prefill") if eng.prefill_chunk \
        else ("prefill call", "prefill")
    chunked = (f" ({tel.continuations} continuations, chunk "
               f"{eng.prefill_chunk})" if eng.prefill_chunk else "")
    ttft = tel.ttft_percentiles()
    n_tok = sum(len(r.output) for r in reqs)
    peak = torch.cuda.max_memory_allocated()
    prec = "w8a8 + int8 KV" if eng.precision == "w8a8" else "bf16"
    print(f"{label}: {model} full width {prec}, {cfg.num_layers} layers, "
          f"prompts {sorted(len(r.tokens) for r in reqs)}; served "
          f"{tel.served}/{len(reqs)} in {wall:.3f} s, {n_tok / wall:.1f} "
          f"tok/s, TTFT p50 {ttft['p50']:.2f} ms p99 {ttft['p99']:.2f} ms, "
          f"mean decode step {stage_ms(tel, 'decode'):.3f} ms over "
          f"{tel.steps} steps, mean {prefill[0]} "
          f"{stage_ms(tel, prefill[1]):.3f} ms over "
          f"{tel.prefill_batches} calls{chunked}; peak memory "
          f"{peak / 2**30:.2f} GiB, {(peak - base) / 2**30:.2f} GiB above "
          f"what was allocated before the engine was built (caches, stage "
          f"buffers, graph outputs, temporaries; a w8a8 engine's int8 "
          f"weights); reserved {torch.cuda.memory_reserved() / 2**30:.2f} "
          f"GiB (the graphs' pool included)", flush=True)
    if tel.served != len(reqs):
        raise AssertionError(f"served {tel.served} of {len(reqs)}")
    bad = [r.rid for r in reqs if len(r.output) != 32
           or not all(0 <= t < cfg.vocab_size for t in r.output)]
    if bad:
        raise AssertionError(f"requests {bad} did not get 32 tokens in the "
                             f"vocab")
    print(f"{label}: kernel launches {launches}", flush=True)
    print(f"{label}: {_graph_counts(eng)}", flush=True)
    return launches, [r.output for r in reqs]


def _require_launched(label: str, launches: dict, names) -> None:
    missing = [k for k in names if launches[k] == 0]
    if missing:
        raise AssertionError(f"{label}: kernels {missing} never launched "
                             f"while serving")


SERVE_KW = dict(batch_slots=4, max_len=1024,
                prefill_buckets=(64, 128, 256, 512), device=DEV)


def phase_serve(cfg, params):
    """Full-width deepseek-7b serving through the engine in bf16 (its
    stages graphed, the card's default); returns the kernels' launch counts
    of the measured run, its outputs and the engine."""
    base = torch.cuda.memory_allocated()
    eng = InferenceEngine(cfg, params, **SERVE_KW)
    launches, outputs = _serve(eng, cfg, "serve", base)
    _require_launched("serve", launches, ("flash_attn", "decode_attn"))
    return launches, outputs, eng


def phase_serve_quant(cfg, params, ref_outputs):
    """The same weights and requests through ``precision="w8a8"`` with an
    int8 KV cache; returns the launch counts, the quantized model, the
    outputs and the engine."""
    cfg_q = _int8_kv(cfg)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    eng = InferenceEngine(cfg_q, params, precision="w8a8", **SERVE_KW)
    torch.cuda.synchronize()
    q = eng.quant
    print(f"serve-w8a8: build step {time.perf_counter() - t0:.1f} s: "
          f"{q.quantized_sites} sites int8, {q.fallback_sites} fall back to "
          f"bf16 (calibration disagreement {q.result.metric_delta:.4f}, "
          f"budget 0.05, {q.result.iterations} fall-backs); {q.schemes}",
          flush=True)
    launches, outputs = _serve(eng, cfg_q, "serve-w8a8", base)
    _require_launched("serve-w8a8", launches,
                      ("flash_attn", "w8a8_matmul", "decode_attn_int8"))
    if launches["decode_attn"]:
        raise AssertionError(f"serve-w8a8: the bf16 decode kernel ran "
                             f"{launches['decode_attn']} times over an int8 "
                             f"cache")
    agree = token_agreement(zip(outputs, ref_outputs))
    print(f"serve-w8a8: greedy-token agreement with the bf16 engine "
          f"{agree:.4f} (printed, not held: random full-width weights give "
          f"near-flat logits)", flush=True)
    return launches, eng.quant, outputs, eng


def _first_divergence(got, want):
    """(request, token index, tokens) of the first token where two runs'
    outputs differ, or None."""
    for rid, (a, b) in enumerate(zip(got, want)):
        for i, (x, y) in enumerate(zip(a, b)):
            if x != y:
                return rid, i, x, y
        if len(a) != len(b):
            return rid, min(len(a), len(b)), None, None
    return None


def phase_serve_eager(label: str, graphed, launches, outputs, cfg, params,
                      engine_kw=SERVE_KW, trace=None,
                      decode_pos=(512, 300, 77, 1), identical=False,
                      **kw) -> None:
    """The serve phase's requests through an engine that runs the same
    stages eagerly (``cuda_graphs=False``), in the same run as the graphed
    ``graphed``: each kernel's launches must equal the graphed run's and
    the greedy agreement reach 0.95 (identical tokens expected: a replay
    runs the kernels the eager stage runs). Then the decode stage of each
    engine is profiled at 4 rows from ``decode_pos``. ``engine_kw`` and
    ``trace``: the graphed engine's settings and requests (by default the
    deepseek-7b serve phase's). With ``identical``, the tokens must be
    identical, not only agree."""
    base = torch.cuda.memory_allocated()
    eng = InferenceEngine(cfg, params, cuda_graphs=False, **engine_kw, **kw)
    got_launches, got = _serve(eng, cfg, label, base, trace=trace,
                               model=cfg.name)
    if got_launches != launches:
        raise AssertionError(f"{label}: kernel launches {got_launches}, the "
                             f"graphed engine's {launches}")
    agree = token_agreement(zip(got, outputs))
    div = _first_divergence(got, outputs)
    where = ("tokens identical" if div is None else
             f"first divergence: request {div[0]} token {div[1]}, eager "
             f"{div[2]} vs graphed {div[3]}")
    print(f"{label}: greedy-token agreement with the graphed engine "
          f"{agree:.4f} ({where}); kernel launches equal", flush=True)
    if agree < 0.95 or (identical and div is not None):
        need = "identical tokens" if identical else "0.95"
        raise AssertionError(f"{label}: eager vs graphed agreement {agree}"
                             f", {need} required")
    for e, tag in ((graphed, "graphed"), (eng, "eager")):
        profile_decode_stage(e, f"{label}: {tag} ", pos=decode_pos)


def phase_serve_chunked(cfg, params, mono_outputs, quant=None):
    """The serve phase's weights and requests through a chunked engine
    (``prefill_chunk=128``), in bf16 or, given the w8a8 build, in w8a8
    with an int8 KV cache. Flash must have run at a query offset; the
    agreement with the monolithic engine's outputs is printed, not held
    (near-flat logits of random full-width weights). Returns the launch
    counts."""
    label = "serve-chunked" + ("-w8a8" if quant is not None else "")
    kw = dict(SERVE_KW, prefill_chunk=128)
    if quant is not None:
        cfg = _int8_kv(cfg)
        kw.update(precision="w8a8", quantized_params=quant)
    base = torch.cuda.memory_allocated()
    launches, outputs = _serve(InferenceEngine(cfg, params, **kw), cfg, label,
                               base)
    _require_launched(label, launches, (
        "flash_attn", "flash_attn at a q_off",
        *(("w8a8_matmul", "decode_attn_int8") if quant is not None
          else ("decode_attn",))))
    agree = token_agreement(zip(outputs, mono_outputs))
    print(f"{label}: greedy-token agreement with the monolithic engine's "
          f"outputs {agree:.4f} (printed, not held: near-flat logits of "
          f"random full-width weights)", flush=True)
    return launches


def reduce_hd128(cfg):
    """deepseek-7b cut to 2 layers of d_model 256 (2 heads of head_dim 128,
    d_ff 512, vocab 256) in bf16: the full width's head_dim and type, so
    the card runs the serving path's kernels (bf16 flash on the tensor
    cores, the split-K w8a8 and split-S int8-KV decode at hd 128)."""
    return dataclasses.replace(
        reduce_for_smoke(cfg), d_model=256, num_heads=2, num_kv_heads=2,
        head_dim=128, d_ff=512, param_dtype="bfloat16",
        activation_dtype="bfloat16")


def _card_vs_host(label: str, small, host, quant=None) -> float:
    """Serve 6 requests x 8 tokens from the same weights on the card and on
    the host (plain versions); raises below 0.95 greedy-token agreement.
    ``quant``: the host's w8a8 build step result, copied to the card."""
    card = copy.deepcopy(host).to(DEV)
    runs = [(card, DEV), (host, "cpu")]
    if quant is not None:
        card_qp = QuantizedParams(copy.deepcopy(quant.params).to(DEV),
                                  quant.result, quant.quantized_sites,
                                  quant.fallback_sites)
        runs = [(card, DEV, card_qp), (host, "cpu", quant)]
    outs = []
    for run in runs:
        kw = {} if quant is None else dict(precision="w8a8",
                                           quantized_params=run[2])
        eng = InferenceEngine(small, run[0], batch_slots=3, max_len=64,
                              prefill_buckets=(8, 16, 32), device=run[1],
                              **kw)
        reqs = _requests(6, 3, 30, 8, small.vocab_size, seed=3)
        eng.run(reqs)
        outs.append([r.output for r in reqs])
    agree = token_agreement(zip(*outs))
    print(f"check: {label}, card vs host greedy-token agreement {agree:.4f} "
          f"over 6 requests", flush=True)
    if agree < 0.95:
        raise AssertionError(f"{label}: card/host token agreement {agree} < "
                             f"0.95")
    return agree


def phase_check(cfg, params):
    """The reduced config (f32, head_dim 16) and the head_dim-128 bf16 one
    (``reduce_hd128``), each in its own precision and in w8a8 with an int8
    KV cache (one build step on the host, its quantized model copied to the
    card), served on the card and on the host; then a full-width prefill."""
    for small, name in ((reduce_for_smoke(get_config("deepseek-7b")),
                         "reduced deepseek-7b"),
                        (reduce_hd128(get_config("deepseek-7b")),
                         "reduced deepseek-7b bf16 head_dim 128")):
        host = model_mod.init_params(small, seed=0, device="cpu")
        _card_vs_host(name, small, host)
        small_q = _int8_kv(small)
        qp = build_quantized_params(small_q, host)
        _card_vs_host(f"{name} w8a8 + int8 KV ({qp.quantized_sites} sites "
                      f"int8)", small_q, host, qp)
    prompt = torch.from_numpy(_requests(1, 200, 200, 1, cfg.vocab_size,
                                        seed=4)[0].tokens)[None]
    with torch.inference_mode():
        h, _ = model_mod.prefill(params, cfg, {"tokens": prompt},
                                 max_len=256)
    if h.shape != (1, cfg.d_model) or not torch.isfinite(h).all():
        raise AssertionError(f"full-width prefill hidden {tuple(h.shape)} "
                             f"is not finite")
    print(f"check: full-width prefill hidden {tuple(h.shape)} finite, "
          f"rms {h.float().pow(2).mean().sqrt().item():.4f}", flush=True)


def _outputs(eng, reqs):
    """Run ``reqs`` on ``eng``, the slot partition checked after every
    tick; their outputs."""
    for r in reqs:
        eng.submit(r)
    while eng.has_work:
        eng.step_once()
        eng.states.check_partition()
    return [r.output for r in reqs]


def _prefix_trace(vocab, n=6, shared_len=24):
    """Requests sharing a ``shared_len``-token system prompt (by default 3
    chunks of 8)."""
    shared = np.random.default_rng(0).integers(
        0, vocab, shared_len).astype(np.int32)
    rng = np.random.default_rng(3)
    return [Request(i, np.concatenate([shared, rng.integers(0, vocab, int(L))])
                    .astype(np.int32), max_new_tokens=6)
            for i, L in enumerate(rng.integers(4, 14, n))]


def _identical(label: str, what: str, got, want) -> None:
    """Raises unless two runs' outputs are token for token the same."""
    div = _first_divergence(got, want)
    if div is not None or len(got) != len(want):
        raise AssertionError(f"{label}: {what}: tokens differ: {div}")


def _check_prefix_hits(label: str, cfg, card, ckw) -> None:
    """A warm prefix cache (16 entries) over ``_prefix_trace``'s shared
    prompt: its replay must hit and be token-identical to a cold engine
    of the same settings ``ckw``."""
    cold = _outputs(InferenceEngine(cfg, card, device=DEV, **ckw),
                    _prefix_trace(cfg.vocab_size))
    warm = InferenceEngine(cfg, card, prefix_cache=16, device=DEV, **ckw)
    warm.run(_prefix_trace(cfg.vocab_size))
    warm.telemetry.reset_serving_stats()
    _identical(label, "prefix hits vs cold",
               _outputs(warm, _prefix_trace(cfg.vocab_size)), cold)
    if not warm.telemetry.prefix_hits:
        raise AssertionError(f"{label}: no prefix hit on the replay")
    print(f"{label}: prefix cache, 6 requests replayed with "
          f"{warm.telemetry.prefix_hits} hits, token-identical to a cold "
          f"engine", flush=True)


def _check_round_trip(small, card, kw, n: int = 16,
                      label: str = "check-chunked") -> None:
    """Snapshot -> restore into another slot -> snapshot, bit for bit, on
    the card, of an ``n``-token prefix (prompts of n to n + 4 tokens); a
    restored positional row past the prefix is zero (a ring moves
    whole)."""
    eng = InferenceEngine(small, card, prefill_chunk=8, device=DEV, **kw)
    eng.run(_requests(3, n, n + 4, 4, small.vocab_size, seed=6))
    src = eng.snapshot_slot(0, n)
    live = [{k: (t[0, :n] if positional else t[0]).cpu()
             for k, t in c.items()}
            for c, positional in zip(eng.caches, eng._positional)]
    eng.restore_slot(src, 2)
    back = eng.snapshot_slot(2, n)
    for a, b, c, layer, positional in zip(src.leaves, back.leaves, live,
                                          eng.caches, eng._positional):
        for k in a:
            if not (torch.equal(a[k], b[k]) and torch.equal(a[k], c[k])
                    and not (positional and layer[k][2, n:].any().item())):
                raise AssertionError(f"{label}: {k} row did not "
                                     f"round-trip bit for bit")
    st = eng.transfer_stats
    kv = [c["k"].dtype for c in eng.caches if "k" in c]
    dtype = kv[0] if kv else eng.caches[0]["conv"].dtype
    print(f"{label}: {dtype} cache, snapshot -> restore bit for bit "
          f"({src.bytes_partial} of {src.bytes_full} row bytes shipped; "
          f"{st.num_transfers_batched} batched copies for "
          f"{st.num_transfers_naive} tensors)", flush=True)


def _check_paging_and_migration(label: str, small, card, ckw) -> None:
    """On the card, chunked engines of ``ckw``: host paging (6 sessions on
    2 slots) token-identical to a 6-slot engine, every page-out faulted
    back in; mid-prefill migration (tickets exported after one chunk and
    adopted by a second engine) token-identical to an unmigrated
    engine."""
    lens = (40, 5, 9, 30, 3, 12)
    sessions = lambda: [Request(i, np.random.default_rng(9 + i).integers(
        0, small.vocab_size, n).astype(np.int32), max_new_tokens=6)
        for i, n in enumerate(lens)]
    ref = _outputs(InferenceEngine(small, card, device=DEV,
                                   **dict(ckw, batch_slots=6)), sessions())
    paged = InferenceEngine(small, card, page_host=True, device=DEV,
                            **dict(ckw, batch_slots=2))
    _identical(label, "paging vs 6 slots", _outputs(paged, sessions()),
               ref)
    tel = paged.telemetry
    if not tel.paged_out or tel.paged_in != tel.paged_out:
        raise AssertionError(f"{label}: paged out {tel.paged_out}, "
                             f"in {tel.paged_in}")
    print(f"{label}: host paging, 6 sessions on 2 slots token-identical to "
          f"6 slots ({tel.paged_out} paged out and in)", flush=True)
    ref = _outputs(InferenceEngine(small, card, device=DEV, **ckw),
                   sessions())
    victim, thief = (InferenceEngine(small, card, device=DEV, **ckw)
                     for _ in range(2))
    got = sessions()
    for r in got:
        victim.submit(r)
    victim.step_once()
    stolen = victim.scheduler.steal_pending(
        3, eligible=victim.migration_eligible, include_continuations=True)
    for t in stolen:
        thief.adopt_prefill(t, victim.export_prefill(t))
    thief.scheduler.absorb(stolen, record=False)
    while victim.has_work or thief.has_work:
        for eng in (victim, thief):
            if eng.has_work:
                eng.step_once()
    if not stolen:
        raise AssertionError(f"{label}: no mid-prefill ticket migrated")
    _identical(label, "migration", [r.output for r in got], ref)
    print(f"{label}: migration, {len(stolen)} mid-prefill tickets "
          f"exported and adopted, outputs token-identical", flush=True)


def phase_check_chunked():
    """The reduced f32 config on the card, the host's plain versions as
    reference: chunked (8, 16) token-identical to the card's monolithic
    engine and >= 0.95 greedy agreement with the host's chunked engine; a
    prefix-cache replay token-identical to a cold engine; snapshot ->
    restore bit for bit over f32 and int8 caches; host paging (6 sessions
    on 2 slots) and mid-prefill migration token-identical; then
    ``reduce_hd128`` in w8a8 + int8 KV, chunked against monolithic at >=
    0.95."""
    small = reduce_for_smoke(get_config("deepseek-7b"))
    host = model_mod.init_params(small, seed=0, device="cpu")
    card = copy.deepcopy(host).to(DEV)
    kw = dict(batch_slots=3, max_len=64, prefill_buckets=(8, 16, 32, 48))
    trace = lambda: _requests(6, 3, 40, 8, small.vocab_size, seed=3)
    mono = _outputs(InferenceEngine(small, card, device=DEV, **kw), trace())
    for chunk in (8, 16):
        eng = InferenceEngine(small, card, prefill_chunk=chunk, device=DEV,
                              **kw)
        got = _outputs(eng, trace())
        _identical("check-chunked", f"chunk {chunk} vs monolithic", got,
                   mono)
        on_host = _outputs(InferenceEngine(small, host, prefill_chunk=chunk,
                                           device="cpu", **kw), trace())
        agree = token_agreement(zip(got, on_host))
        print(f"check-chunked: chunk {chunk}, 6 requests token-identical to "
              f"monolithic ({eng.telemetry.continuations} continuations); "
              f"card vs host greedy-token agreement {agree:.4f}", flush=True)
        if agree < 0.95:
            raise AssertionError(f"check-chunked: chunk {chunk} card/host "
                                 f"agreement {agree} < 0.95")
    ckw = dict(kw, prefill_chunk=8)
    _check_prefix_hits("check-chunked", small, card, ckw)
    _check_round_trip(small, card, kw)
    _check_round_trip(_int8_kv(small), card, kw)
    _check_paging_and_migration("check-chunked", small, card, ckw)
    small = _int8_kv(reduce_hd128(get_config("deepseek-7b")))
    host = model_mod.init_params(small, seed=0, device="cpu")
    qp = build_quantized_params(small, host)
    card_qp = QuantizedParams(copy.deepcopy(qp.params).to(DEV), qp.result,
                              qp.quantized_sites, qp.fallback_sites)
    card = copy.deepcopy(host).to(DEV)
    outs, conts = [], 0
    for chunk in (None, 8):
        eng = InferenceEngine(small, card, precision="w8a8",
                              quantized_params=card_qp, prefill_chunk=chunk,
                              device=DEV, **kw)
        outs.append(_outputs(eng, trace()))
        conts += eng.telemetry.continuations
    agree = token_agreement(zip(*outs))
    print(f"check-chunked: reduced deepseek-7b bf16 head_dim 128, w8a8 + "
          f"int8 KV, chunked (8) vs monolithic greedy-token agreement "
          f"{agree:.4f} ({conts} continuations)", flush=True)
    if agree < 0.95:
        raise AssertionError(f"check-chunked: w8a8 + int8 KV chunked vs "
                             f"monolithic agreement {agree} < 0.95")


def _cache_diff(a, b) -> float:
    """Max abs difference between two engines' caches."""
    return max((x[k].float() - y[k].float()).abs().max().item()
               for x, y in zip(a.caches, b.caches) for k in x)


def phase_check_graphs():
    """The reduced f32 config and ``reduce_hd128``, each in its fp type and
    in w8a8 + int8 KV (one build step on the host, copied to the card),
    monolithic and ``prefill_chunk`` 8 and 16: the same requests through a
    graphed and an eager engine on the card must give identical tokens;
    the final caches' max abs difference is printed."""
    kw = dict(batch_slots=3, max_len=64, prefill_buckets=(8, 16, 32, 48),
              device=DEV)
    for small, name in ((reduce_for_smoke(get_config("deepseek-7b")),
                         "reduced deepseek-7b"),
                        (reduce_hd128(get_config("deepseek-7b")),
                         "reduced deepseek-7b bf16 head_dim 128")):
        host = model_mod.init_params(small, seed=0, device="cpu")
        card = copy.deepcopy(host).to(DEV)
        small_q = _int8_kv(small)
        qp = build_quantized_params(small_q, host)
        card_qp = QuantizedParams(copy.deepcopy(qp.params).to(DEV), qp.result,
                                  qp.quantized_sites, qp.fallback_sites)
        for prec, c, extra in (
                (small.param_dtype, small, {}),
                ("w8a8 + int8 KV", small_q,
                 dict(precision="w8a8", quantized_params=card_qp))):
            for chunk in (None, 8, 16):
                engs = [InferenceEngine(c, card, prefill_chunk=chunk,
                                        cuda_graphs=graphs, **kw, **extra)
                        for graphs in (True, False)]
                outs = [_outputs(e, _requests(6, 3, 40, 8, c.vocab_size,
                                              seed=3)) for e in engs]
                label = (f"{name} {prec}, "
                         f"{'chunk ' + str(chunk) if chunk else 'monolithic'}")
                div = _first_divergence(*outs)
                if div is not None:
                    raise AssertionError(f"check-graphs: {label}: graphed "
                                         f"and eager tokens differ, first at "
                                         f"request {div[0]} token {div[1]} "
                                         f"({div[2]} vs {div[3]})")
                print(f"check-graphs: {label}: 6 requests token-identical "
                      f"graphed and eager; final caches max abs difference "
                      f"{_cache_diff(*engs):.3e}; {_graph_counts(engs[0])}",
                      flush=True)


# ---- profile ----------------------------------------------------------------

MATMUL_KERNEL_NAMES = ("gemm", "gemv", "nvjet", "xmma", "cutlass")


LM_SHARES = {"matmul kernels": MATMUL_KERNEL_NAMES,
             "flash_fwd_kernel": ("flash_fwd_kernel",),
             "decode_kernel": ("decode_kernel",),
             "decode_int8_kernel": ("decode_int8_kernel",),
             # w8a8_kernel_tma (M > 16) and the byte-wise w8a8_kernel
             "w8a8_kernel": ("w8a8_kernel",),
             "w8a8_splitk_kernel (M <= 16)": ("w8a8_splitk_kernel",)}


def _device_events(prof) -> list:
    """The trace's device-side activities (kernels, copies, memsets),
    averaged by name: an aten op's own device time counts the kernels it
    launched a second time."""
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.is_user_annotation]


def profile_window(label: str, fn, steps: int, shares=LM_SHARES):
    """Device busy share of ``fn`` (which ends in a host copy or a wait): its
    wall time untraced, then its kernels' device time from one traced run,
    with the share of each group of kernel names in ``shares``. Returns
    the trace, None if it holds no device activity."""
    fn()                                                     # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    events = _device_events(prof)
    if not events:
        print(f"profile: {label}: wall {wall_ms / steps:.3f} ms per step; "
              f"device time not measured (the trace holds no device "
              f"activity)", flush=True)
        return None
    dev_ms = sum(e.self_device_time_total for e in events) / 1e3

    def share(names):
        return sum(e.self_device_time_total for e in events
                   if any(n in e.key.lower() for n in names)) / 1e3 / dev_ms

    top = sorted(events, key=lambda e: e.self_device_time_total,
                 reverse=True)[:6]
    groups = ", ".join(f"{name} {100 * share(names):.1f}%"
                       for name, names in shares.items())
    print(f"profile: {label}: wall {wall_ms / steps:.3f} ms per step "
          f"(untraced), device kernels {dev_ms / steps:.3f} ms per step, "
          f"device busy {100 * dev_ms / wall_ms:.1f}% of the wall time; "
          f"{groups} of device time; "
          f"{sum(e.count for e in events) // steps} device activities "
          f"per step", flush=True)
    for e in top:
        print(f"profile: {label}:   {e.self_device_time_total / 1e3 / steps:8.3f}"
              f" ms/step x{e.count // steps:<4d} {e.key[:90]}", flush=True)
    return prof


# what may touch a whole cache tensor (B, max_len, K, hd) in a chunk call:
# views and the in-place write of the chunk's K/V; a gather (aten::index), a
# copy or a dequantize of whole rows would show up as another op
IN_PLACE_OPS = {"aten::index_put_", "aten::_index_put_impl_", "aten::slice",
                "aten::select", "aten::as_strided", "aten::view",
                "aten::alias"}


def whole_row_ops(fn, max_len: int) -> set:
    """Names of the aten ops of one traced call of ``fn`` that take a
    tensor with ``max_len`` positions at dim 1 (a whole cache row)."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU],
            record_shapes=True) as prof:
        fn()
    return {e.name for e in prof.events()
            if any(isinstance(sh, (list, tuple)) and len(sh) >= 3
                   and all(isinstance(d, int) for d in sh)
                   and sh[1] == max_len for sh in e.input_shapes)}


def profile_chunk(cfg, params, caches, tag: str) -> None:
    """One chunk call at deepseek-7b's chunk shape (``CHUNK_MAIN``) on the
    profile's caches: device time and shares, the ops that touch whole
    cache rows (views and the in-place write only: the flash kernel reads
    the rows in place), and over an int8 cache the time of the prefix
    dequantize."""
    C, max_len = 128, caches[0]["k"].shape[1]
    slots, start, lengths = (CHUNK_MAIN[k] for k in ("slots", "start",
                                                     "lengths"))
    gen = torch.Generator(device=DEV).manual_seed(6)
    toks = torch.randint(0, cfg.vocab_size, (len(slots), C), generator=gen,
                         device=DEV, dtype=torch.int32)
    last = torch.tensor([n - 1 for n in lengths], device=DEV)

    @torch.inference_mode()
    def chunk():
        x, _ = model_mod.chunk_prefill_step(params, cfg, toks, caches, slots,
                                            start, start, lengths)
        return model_mod.greedy_next(
            params, cfg, x[torch.arange(len(slots), device=DEV), last]).cpu()

    profile_window(f"{tag}chunk call, {len(slots)}x{C} at offsets {start} "
                   f"(lengths {lengths})", chunk, 1)
    seen = whole_row_ops(chunk, max_len)
    if seen - IN_PLACE_OPS:
        raise AssertionError(f"profile: {tag}chunk call: ops that read "
                             f"whole cache rows: "
                             f"{sorted(seen - IN_PLACE_OPS)}")
    print(f"profile: {tag}chunk call: ops on whole cache rows "
          f"{sorted(seen)} (views and the in-place write; no gather, copy "
          f"or dequantize of whole rows)", flush=True)
    if "k_scale" in caches[0]:
        tile = attn_mod.DEQUANT_TILE
        n = -(-max(s + L for s, L in zip(start, lengths)) // tile) * tile
        c0, rows = caches[0], torch.tensor(slots, device=DEV)
        dt = dtype_of(cfg.activation_dtype)

        def dequant():
            return [attn_mod._kv_dequant(c0[k][rows, :n], c0[k + "_scale"]
                                         [rows, :n], dt) for k in ("k", "v")]
        ms = time_ms(dequant)
        print(f"profile: {tag}chunk call: int8 prefix dequantize ({len(slots)}"
              f" rows x {n} of {max_len} keys, K and V) {ms:.4f} ms a layer, "
              f"{ms * cfg.num_layers:.3f} ms a call over {cfg.num_layers} "
              f"layers", flush=True)


def profile_decode_stage(eng, tag: str, steps: int = 8,
                         pos=(512, 300, 77, 1)) -> None:
    """``steps`` decode stage calls of the engine (one graph replay each
    when it is graphed) at 4 rows, positions ``pos`` onward, each fed the
    last call's tokens: the step's wall time, its device busy share and
    device activities."""
    run = eng.executor.get("decode", (eng.precision,), eng._build_decode)
    B = eng.batch_slots
    pos = np.array(pos[:B], np.int32)

    def decode():
        toks = np.zeros((B, 1), np.int32)
        for i in range(steps):
            toks = run({"tokens": toks, "pos": pos + i,
                        "active": np.ones(B, bool)})[:, None]

    profile_window(f"{tag}decode stage call, {B} rows at pos "
                   f"{pos.tolist()}+", decode, steps)
    if eng.executor.graphs:
        # the graph alone, start to end on the device (its kernels and the
        # gaps between them), apart from the stage call's copies
        replay = run.variants[None].graph.replay
        events = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True)) for _ in range(steps)]
        for start, end in events:
            start.record()
            replay()
            end.record()
        torch.cuda.synchronize()
        span = sum(a.elapsed_time(b) for a, b in events) / steps
        print(f"profile: {tag}decode graph replay alone: {span:.3f} ms "
              f"start to end on the device (CUDA events)", flush=True)


def phase_profile(cfg, params, tag: str = ""):
    """Where one full-width prefill call, one decode step and one prefill
    chunk call spend their time: the model layer driven directly at the
    serve phases' shapes (``params`` may be a quantized model, ``cfg`` an
    int8-KV config)."""
    B, S, max_len = 4, 512, 1024
    lens = torch.tensor([512, 300, 77, 1], device=DEV)
    gen = torch.Generator(device=DEV).manual_seed(5)
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                         device=DEV, dtype=torch.int32)
    valid = torch.arange(S, device=DEV)[None, :] < lens[:, None]
    caches = model_mod.init_caches(cfg, B, max_len, DEV)

    @torch.inference_mode()
    def prefill():
        x, _ = model_mod.forward(params, cfg, {"tokens": toks},
                                 mode="prefill", caches=caches,
                                 kv_valid=valid)
        last = x[torch.arange(B, device=DEV), lens - 1]
        return model_mod.greedy_next(params, cfg, last).cpu()

    steps = 8

    @torch.inference_mode()
    def decode():
        pos = lens.to(torch.int32)
        nxt = prefill_tokens[:, None].to(DEV)
        for i in range(steps):
            h, _ = model_mod.decode_step(params, cfg, nxt, caches, pos + i)
            nxt = model_mod.greedy_next(params, cfg, h).cpu()[:, None] \
                .to(DEV)

    prefill_tokens = prefill()
    profile_window(f"{tag}prefill {B}x{S} (lens {lens.tolist()})", prefill, 1)
    profile_window(f"{tag}decode step, {B} rows at pos {lens.tolist()}+",
                   decode, steps)
    profile_chunk(cfg, params, caches, tag)


# ---- gemma2-27b -------------------------------------------------------------

# 4 slots of 5120 positions (the 23 global layers' K/V 3.9 GB, the 23 rings
# of 4096 slots 3.1 GB); the bucket ladder reaches the longest prompt
GEMMA2_KW = dict(batch_slots=4, max_len=5120,
                 prefill_buckets=(128, 256, 512, 1024, 2048, 4096, 4608),
                 device=DEV)


def gemma2_requests(vocab: int):
    """The gemma2 serve phases' traffic: 8 prompts x 32 new tokens, long
    and short in turn: 4 of 4100-4600 tokens (past the 4096 window, so a
    prefill wraps every ring and every decode attends a full ring) and 4
    of 71-445."""
    rng = np.random.default_rng(0)
    lens = np.stack([rng.integers(4100, 4601, 4),
                     rng.integers(71, 446, 4)], 1).reshape(-1)
    return [Request(i, rng.integers(0, vocab, int(L)).astype(np.int32),
                    max_new_tokens=32) for i, L in enumerate(lens)]


def _free_card() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def phase_serve_gemma2(cfg, params, kw=GEMMA2_KW,
                       decode_pos=(4600, 4400, 300, 100)):
    """Full-width gemma2-27b serving in bf16, graphed, warmed on the same
    requests first (so every stage key is captured before the measured
    run): flash with a window (the local layers) and the bf16 decode kernel
    must have run. Then the graphed decode stage is profiled at positions
    ``decode_pos`` (rings full), the engine is freed and one prefill of
    the longest prompt must give finite hidden states. Returns (launches,
    outputs)."""
    label = "serve-gemma2"
    trace = lambda: gemma2_requests(cfg.vocab_size)
    base = torch.cuda.memory_allocated()
    eng = InferenceEngine(cfg, params, **kw)
    launches, outputs = _serve(eng, cfg, label, base, trace=trace,
                               warm=trace, model=cfg.name)
    _require_launched(label, launches, ("flash_attn",
                                        "flash_attn with a window",
                                        "decode_attn"))
    profile_decode_stage(eng, f"{label}: graphed ", pos=decode_pos)
    del eng
    _free_card()
    prompt = max(trace(), key=lambda r: len(r.tokens)).tokens
    with torch.inference_mode():
        h, _ = model_mod.prefill(params, cfg, {"tokens": torch.from_numpy(
            prompt)[None].to(DEV)}, max_len=kw["max_len"])
    if h.shape != (1, cfg.d_model) or not torch.isfinite(h).all():
        raise AssertionError(f"{label}: prefill hidden {tuple(h.shape)} is "
                             f"not finite")
    print(f"{label}: a {len(prompt)}-token prefill's last hidden "
          f"{tuple(h.shape)} finite, rms "
          f"{h.float().pow(2).mean().sqrt().item():.4f}", flush=True)
    return launches, outputs


def phase_serve_gemma2_chunked(cfg, params, mono_outputs, kw=GEMMA2_KW,
                               chunk: int = 512):
    """The same requests through ``prefill_chunk=chunk``: chunks that cross
    the window, the local layers' flash over their gathered rings and the
    global layers' at offsets past 4096. Flash at a query offset and with
    a window must have run; the agreement with the monolithic serve is
    printed, not held (near-flat logits of random full-width weights).
    Returns the launches."""
    label = "serve-gemma2-chunked"
    trace = lambda: gemma2_requests(cfg.vocab_size)
    base = torch.cuda.memory_allocated()
    eng = InferenceEngine(cfg, params, prefill_chunk=chunk, **kw)
    launches, outputs = _serve(eng, cfg, label, base, trace=trace,
                               warm=trace, model=cfg.name)
    _require_launched(label, launches, (
        "flash_attn", "flash_attn at a q_off", "flash_attn with a window",
        "decode_attn"))
    agree = token_agreement(zip(outputs, mono_outputs))
    print(f"{label}: greedy-token agreement with the monolithic engine's "
          f"outputs {agree:.4f} (printed, not held: near-flat logits of "
          f"random full-width weights)", flush=True)
    profile_gemma2_chunk(cfg, params, eng.caches, chunk)
    return launches


# check-gemma2-layers' prompts: two past the 4096 window (every ring
# wraps), one short, one of a single token
GEMMA2_LAYERS_LENS = (4600, 4200, 300, 1)


def _host_mem_available() -> float:
    """``MemAvailable`` of ``/proc/meminfo``, GB (NaN where there is
    none)."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024 / 1e9
    except OSError:
        pass
    return float("nan")


def build_released_w8a8(label: str, cfg, params,
                        budget: float = 0.05) -> QuantizedParams:
    """The §V build step on the card at ``budget`` with ``release_fp=True``
    (each int8 site's fp weights moved to the host once it is quantized:
    gemma2-27b's bf16 model and its int8 form would need ~75 GiB together,
    command-r-plus's 16 layers ~76 GiB). Prints its time, decisions, the
    card's peak memory during it beside the card's total, and the bytes it
    moved to the host; no leaf of the quantized model may be off the
    card."""
    _free_card()
    avail = _host_mem_available()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    quant = build_quantized_params(cfg, params, budget=budget,
                                   release_fp=True)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    total = torch.cuda.mem_get_info()[1]
    host = sum(p.numel() * p.element_size() for p in params.parameters()
               if p.device.type == "cpu")
    off = model_mod.off_device(quant.params, model_mod.model_device(params))
    if off:
        raise AssertionError(f"{label}: {len(off)} leaves of the quantized "
                             f"model are off the card, e.g. {off[:3]}")
    print(f"{label}: build step {build_s:.1f} s: {quant.quantized_sites} "
          f"sites int8, {quant.fallback_sites} fall back to bf16 "
          f"(calibration disagreement {quant.result.metric_delta:.4f}, "
          f"budget {budget}, {quant.result.iterations} fall-backs); "
          f"{quant.schemes}", flush=True)
    print(f"{label}: card memory {before / 2**30:.2f} GiB allocated before "
          f"the build, peak {peak / 2**30:.2f} GiB during it, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB after (the "
          f"quantized model and what the fp model keeps on the card), of "
          f"the card's {total / 2**30:.2f} GiB (mem_get_info); the int8 "
          f"sites' fp weights moved to the host: {host / 1e9:.2f} GB "
          f"(MemAvailable before the build {avail:.2f} GB)", flush=True)
    return quant


def phase_serve_gemma2_w8a8(cfg, params, quant, bf16_outputs, chunk=None,
                            decode_pos=(4600, 4400, 300, 100)):
    """gemma2-27b's requests through a w8a8 engine with an int8 KV cache
    (``cfg``) on the released build ``quant``, graphed and warmed on the
    same requests; with ``chunk``, through ``prefill_chunk=chunk``. Flash
    with a window (and at a query offset, chunked), the w8a8 GEMM and the
    int8 decode kernel must have run and the bf16 decode kernel not; the
    agreement with the bf16 serve's outputs is printed, not held
    (near-flat logits of random full-width weights). The graphed decode
    stage is profiled at positions ``decode_pos`` (rings full). Returns
    (launches, outputs)."""
    label = "serve-gemma2-chunked-w8a8" if chunk else "serve-gemma2-w8a8"
    trace = lambda: gemma2_requests(cfg.vocab_size)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    eng = InferenceEngine(cfg, params, precision="w8a8",
                          quantized_params=quant, prefill_chunk=chunk,
                          **GEMMA2_KW)
    launches, outputs = _serve(eng, cfg, label, base, trace=trace,
                               warm=trace, model=cfg.name)
    need = ["flash_attn", "flash_attn with a window", "w8a8_matmul",
            "decode_attn_int8"]
    if chunk:
        need.append("flash_attn at a q_off")
    _require_launched(label, launches, need)
    if launches["decode_attn"]:
        raise AssertionError(f"{label}: the bf16 decode kernel ran "
                             f"{launches['decode_attn']} times over an int8 "
                             f"cache")
    peak, total = torch.cuda.max_memory_allocated(), \
        torch.cuda.mem_get_info()[1]
    print(f"{label}: peak memory {peak / 2**30:.2f} GiB of the card's "
          f"{total / 2**30:.2f} GiB (mem_get_info)", flush=True)
    agree = token_agreement(zip(outputs, bf16_outputs))
    div = _first_divergence(outputs, bf16_outputs)
    print(f"{label}: greedy-token agreement with serve-gemma2 {agree:.4f} "
          f"({'tokens identical' if div is None else div}) (printed, not "
          f"held: near-flat logits of random full-width weights; "
          f"check-gemma2-layers holds the layers)", flush=True)
    profile_decode_stage(eng, f"{label}: graphed ", pos=decode_pos)
    return launches, outputs


def _span_ms(prof, name: str):
    """(spans named ``name`` in a trace, the device time of the kernels
    their ops launched, ms)."""
    spans = [e for e in prof.events() if e.name == name
             and e.device_type == torch.autograd.DeviceType.CPU]
    return len(spans), sum(e.device_time_total for e in spans) / 1e3


def profile_gemma2_chunk(cfg, params, caches, C: int,
                         start=(4096, 4608, 2048, 512)) -> None:
    """One full-width chunk call through the model layer on a served
    engine's caches (4 rows of ``C`` at offsets ``start``, the rings
    full): its device time and shares, and from the same trace the part
    the local layers' ring gather takes (its profiler spans)."""
    slots, start = [0, 1, 2, 3], list(start)
    lengths = [C] * 4
    gen = torch.Generator(device=DEV).manual_seed(6)
    toks = torch.randint(0, cfg.vocab_size, (4, C), generator=gen,
                         device=DEV, dtype=torch.int32)

    @torch.inference_mode()
    def chunk():
        x, _ = model_mod.chunk_prefill_step(params, cfg, toks, caches, slots,
                                            start, start, lengths)
        return model_mod.greedy_next(params, cfg, x[:, -1]).cpu()

    label = "serve-gemma2-chunked"
    prof = profile_window(f"{label}: chunk call, 4x{C} at offsets {start}",
                          chunk, 1)
    if prof is None:
        return
    # the local layers' gather spans (``attention.RING_GATHER_SPAN``)
    spans, ms = _span_ms(prof, attn_mod.RING_GATHER_SPAN)
    n_local = sum(kind == "local" for kind in cfg.layer_kinds())
    if spans != n_local or not ms:
        print(f"profile: {label}: local ring gather not measured "
              f"({spans} gather spans in the trace for {n_local} local "
              f"layers, {ms:.3f} ms device time)", flush=True)
        return
    call_ms = sum(e.self_device_time_total
                  for e in _device_events(prof)) / 1e3
    print(f"profile: {label}: local ring gather, from the chunk call's "
          f"trace ({n_local} spans, one a local layer): {ms:.3f} ms of the "
          f"call's {call_ms:.3f} ms device time ({100 * ms / call_ms:.1f}%),"
          f" {ms / n_local:.4f} ms a layer", flush=True)


def reduce_gemma2(dtype: str):
    """gemma2-27b cut to 4 layers (local, global, local, global) of d_model
    256: 4 heads of head_dim 128 over 2 kv heads (gemma2's G 2), d_ff 512,
    vocab 256, window 64; both softcaps, the sandwich norms, the embedding
    multiplier and GeGLU as at full width; in ``dtype``."""
    return dataclasses.replace(
        reduce_for_smoke(get_config("gemma2-27b")), num_layers=4,
        d_model=256, num_heads=4, num_kv_heads=2, head_dim=128, d_ff=512,
        window_size=64, param_dtype=dtype, activation_dtype=dtype)


def phase_check_gemma2(kw=None):
    """``reduce_gemma2`` in f32 and bf16, each fp and w8a8 + int8 KV (one
    build step on the host, copied to the card), prompts of 40-200 tokens
    (rings of 64 wrap): see ``check_reduced``."""
    check_reduced("check-gemma2", "reduced gemma2-27b", reduce_gemma2, kw)


def check_reduced(label: str, arch: str, make, kw=None,
                  below_window=None, draw=None) -> None:
    """``make(dtype)`` in f32 and bf16, each fp and w8a8 + int8 KV (one
    build step on the host, copied to the card), prompts of 40-200 tokens:
    card vs host greedy agreement >= 0.95; chunked (8, 16) vs monolithic
    on the card identical in fp, >= 0.95 in w8a8 + int8 KV (an int8 chunk
    attends the dequantized prefix, where a monolithic prefill attends the
    exact K/V); graphed == eager tokens, monolithic and chunk 16, the
    caches' difference printed. Then, fp in each type: a prefix hit over a
    96-token shared prompt identical to a cold engine, and snapshot ->
    restore bit for bit over fp and int8 caches; with ``below_window`` (a
    max_len below the window and its buckets), over a 30-token prefix of
    engines of that max_len too (the rings clamped, positional). ``draw``
    (params -> None) sets the host weights' leaves that init leaves at
    zero before anything is copied or built."""
    kw = kw or dict(batch_slots=3, max_len=256,
                    prefill_buckets=(64, 128, 256))
    for dtype in ("float32", "bfloat16"):
        small = make(dtype)
        host = model_mod.init_params(small, seed=0, device="cpu")
        if draw is not None:
            draw(host)
        card = copy.deepcopy(host).to(DEV)
        small_q = _int8_kv(small)
        qp = build_quantized_params(small_q, host)
        card_qp = QuantizedParams(copy.deepcopy(qp.params).to(DEV),
                                  qp.result, qp.quantized_sites,
                                  qp.fallback_sites)
        legs = (("fp", small, {}, {}),
                (f"w8a8 + int8 KV ({qp.quantized_sites} sites int8)",
                 small_q, dict(precision="w8a8", quantized_params=card_qp),
                 dict(precision="w8a8", quantized_params=qp)))
        for prec, c, on_card, on_host in legs:
            name = f"{arch} {dtype} {prec}"
            trace = lambda: _requests(6, 40, 200, 8, c.vocab_size, seed=3)
            mono = _outputs(InferenceEngine(c, card, device=DEV, **kw,
                                            **on_card), trace())
            on_cpu = _outputs(InferenceEngine(c, host, device="cpu", **kw,
                                              **on_host), trace())
            agree = token_agreement(zip(mono, on_cpu))
            print(f"{label}: {name}, card vs host greedy-token agreement "
                  f"{agree:.4f} over 6 requests", flush=True)
            if agree < 0.95:
                raise AssertionError(f"{label}: {name}: card/host agreement "
                                     f"{agree} < 0.95")
            exact = not on_card
            for chunk in (8, 16):
                eng = InferenceEngine(c, card, prefill_chunk=chunk,
                                      device=DEV, **kw, **on_card)
                got = _outputs(eng, trace())
                agree = token_agreement(zip(got, mono))
                div = _first_divergence(got, mono)
                print(f"{label}: {name}, chunk {chunk} vs monolithic "
                      f"greedy-token agreement {agree:.4f} "
                      f"({'tokens identical' if div is None else div}; "
                      f"{eng.telemetry.continuations} continuations)",
                      flush=True)
                if (exact and div is not None) or agree < 0.95:
                    raise AssertionError(f"{label}: {name}: chunk {chunk} "
                                         f"vs monolithic: {div}, agreement "
                                         f"{agree}")
            for chunk in (None, 16):
                engs = [InferenceEngine(c, card, prefill_chunk=chunk,
                                        cuda_graphs=graphs, device=DEV, **kw,
                                        **on_card)
                        for graphs in (True, False)]
                div = _first_divergence(*(_outputs(e, trace())
                                          for e in engs))
                where = f"chunk {chunk}" if chunk else "monolithic"
                if div is not None:
                    raise AssertionError(f"{label}: {name}, {where}: graphed "
                                         f"and eager tokens differ: {div}")
                print(f"{label}: {name}, {where}: 6 requests token-identical "
                      f"graphed and eager; final caches max abs difference "
                      f"{_cache_diff(*engs):.3e}", flush=True)
        ckw = dict(kw, prefill_chunk=8)
        shared = lambda: _prefix_trace(small.vocab_size, shared_len=96)
        cold = _outputs(InferenceEngine(small, card, device=DEV, **ckw),
                        shared())
        warm = InferenceEngine(small, card, prefix_cache=16, device=DEV,
                               **ckw)
        warm.run(shared())
        warm.telemetry.reset_serving_stats()
        got = _outputs(warm, shared())
        agree = token_agreement(zip(got, cold))
        print(f"{label}: {arch} {dtype}, prefix cache over a "
              f"96-token shared prompt: {warm.telemetry.prefix_hits} hits, "
              f"agreement with a cold engine {agree:.4f}", flush=True)
        if not warm.telemetry.prefix_hits or got != cold:
            raise AssertionError(f"{label}: {dtype} prefix hits "
                                 f"{warm.telemetry.prefix_hits}, agreement "
                                 f"with cold {agree}")
        for c in (small, _int8_kv(small)):
            _check_round_trip(c, card, kw, n=100, label=label)
            if below_window is not None:
                _check_round_trip(c, card, dict(kw, **below_window), n=30,
                                  label=label)


# ---- gemma-2b ---------------------------------------------------------------

GEMMA_2B_KW = dict(batch_slots=4, max_len=4608,
                   prefill_buckets=(128, 256, 512, 1024, 2048, 4096),
                   device=DEV)


def reduce_gemma_2b(dtype: str):
    """gemma-2b cut to 3 layers of d_model 256, keeping what
    ``reduce_for_smoke`` drops: 8 query heads padded to 16, of head_dim 256,
    over one kv head (G 16, the padded heads' ``wo`` rows zero); d_ff 512,
    vocab 256; GeGLU, tied embeddings and the embedding multiplier as at
    full width; in ``dtype``."""
    return dataclasses.replace(
        reduce_for_smoke(get_config("gemma-2b")), num_layers=3, d_model=256,
        num_heads=8, num_padded_heads=16, num_kv_heads=1, head_dim=256,
        d_ff=512, param_dtype=dtype, activation_dtype=dtype)


def phase_check_gemma_2b(kw=None):
    """``reduce_gemma_2b`` in f32 and bf16, each fp and w8a8 + int8 KV:
    card vs host, chunked vs monolithic, graphed vs eager, prefix hit vs
    cold, snapshot round trips (``check_reduced``)."""
    check_reduced("check-gemma2b", "reduced gemma-2b", reduce_gemma_2b, kw)


def gemma_2b_requests(vocab: int):
    """The gemma-2b serve phases' traffic: 8 prompts x 32 new tokens, long
    and short in turn: 4 of 3000-4000 tokens (the 4096 prefill bucket) and
    4 of 70-450."""
    rng = np.random.default_rng(0)
    lens = np.stack([rng.integers(3000, 4001, 4),
                     rng.integers(70, 451, 4)], 1).reshape(-1)
    return [Request(i, rng.integers(0, vocab, int(L)).astype(np.int32),
                    max_new_tokens=32) for i, L in enumerate(lens)]


def phase_serve_gemma_2b(cfg, params, label: str = "serve-gemma2b",
                         mono_outputs=None, **kw):
    """Full-width gemma-2b serving (``phase_serve_padded`` on
    ``gemma_2b_requests``); returns (launches, outputs)."""
    launches, outputs, _ = phase_serve_padded(
        cfg, params, label, GEMMA_2B_KW,
        lambda: gemma_2b_requests(cfg.vocab_size), "serve-gemma2b",
        "check-gemma2b-layers", (4000, 3500, 300, 100), mono_outputs, **kw)
    return launches, outputs


def phase_serve_padded(cfg, params, label: str, engine_kw: dict, trace,
                       ref_label: str, layers_label: str, profile_pos,
                       mono_outputs=None, keep_engine: bool = False,
                       hold: bool = True, layers_ref=None, **kw):
    """Full-width serving of an arch with padded heads (bf16; or, with
    ``precision="w8a8"`` in ``kw``, w8a8 with an int8 KV cache), graphed
    and warmed on the same requests ``trace()``, so every stage key is
    captured before the measured run; with ``prefill_chunk`` in ``kw``,
    chunked. The kernels of its path must have run: flash (at a query
    offset when chunked), and bf16 decode, or the w8a8 GEMM and int8
    decode with bf16 decode not at all. A w8a8 serve's greedy agreement
    with the bf16 serve's (``ref_label``) ``mono_outputs`` must reach 0.90
    (the reference's w8a8 guardrail; printed, not held, without
    ``hold``), and its layers check (``layers_label``) follow, against
    ``layers_ref`` where given (``layers_reference`` taken before a build
    that released the bf16 weights), else against one taken here from
    ``params``; a chunked one's agreement is printed. The
    monolithic serves' graphed decode stage is then profiled at rows from
    ``profile_pos``. Returns (launches, outputs, the engine if
    ``keep_engine`` else None)."""
    quant = kw.get("precision") == "w8a8"
    base_cfg = cfg
    if quant:
        cfg = _int8_kv(cfg)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    eng = InferenceEngine(cfg, params, **engine_kw, **kw)
    if quant:
        torch.cuda.synchronize()
        q = eng.quant
        n_int8 = sum(isinstance(m, QuantDense) for m in q.params.modules())
        built = ("the build made before the engine" if "quantized_params"
                 in kw else f"build step {time.perf_counter() - t0:.1f} s")
        print(f"{label}: {built}: "
              f"{q.quantized_sites} sites int8 ({n_int8} int8 weights over "
              f"{cfg.num_layers} layers), {q.fallback_sites} fall back "
              f"to bf16 (calibration disagreement "
              f"{q.result.metric_delta:.4f}); {q.schemes}", flush=True)
    launches, outputs = _serve(eng, cfg, label, base, trace=trace,
                               warm=trace, model=cfg.name)
    need = ["flash_attn"]
    need += (["w8a8_matmul", "decode_attn_int8"] if quant
             else ["decode_attn"])
    if kw.get("prefill_chunk"):
        need.append("flash_attn at a q_off")
    _require_launched(label, launches, need)
    if quant and launches["decode_attn"]:
        raise AssertionError(f"{label}: the bf16 decode kernel ran "
                             f"{launches['decode_attn']} times over an int8 "
                             f"cache")
    if mono_outputs is not None:
        agree = token_agreement(zip(outputs, mono_outputs))
        div = _first_divergence(outputs, mono_outputs)
        print(f"{label}: greedy-token agreement with {ref_label} "
              f"{agree:.4f} ({'tokens identical' if div is None else div})"
              + ("" if quant and hold else " (printed, not held)"),
              flush=True)
        if quant and hold and agree < 0.90:
            raise AssertionError(f"{label}: agreement with the bf16 serve "
                                 f"{agree} < 0.90")
    if quant:
        check_w8a8_layers(layers_label, layers_ref or layers_reference(
            base_cfg, params, (512, 300, 77, 1), 1024), cfg,
            eng.quant.params)
    if not kw.get("prefill_chunk"):
        profile_decode_stage(eng, f"{label}: graphed ", pos=profile_pos)
    return launches, outputs, (eng if keep_engine else None)


# the full-width w8a8 + int8-KV decode step's error over the layers' share
# of the bf16 step's final hidden state
W8A8_LAYERS_TOL = 0.10


def _layers_step(ref: dict, params, cfg, fault=None) -> torch.Tensor:
    """One prefill of ``ref``'s prompts into fresh caches of ``cfg``'s
    format, ``fault(caches)`` if given, then one decode step of the next
    tokens: the final hidden state (B, d) in f32."""
    B = ref["toks"].shape[0]
    with torch.inference_mode():
        caches = model_mod.init_caches(cfg, B, ref["max_len"], DEV)
        model_mod.forward(params, cfg, {"tokens": ref["toks"]},
                          mode="prefill", caches=caches,
                          kv_valid=ref["valid"])
        if fault is not None:
            fault(caches)
        h, _ = model_mod.decode_step(params, cfg, ref["nxt"], caches,
                                     ref["pos"])
        return h.float()


def layers_reference(cfg, params, lens, max_len: int) -> dict:
    """The bf16 side of a layers check (``check_w8a8_layers``): 4 prompts
    of lengths ``lens`` (one row of max(lens) tokens each, right-padded)
    prefilled at ``max_len``, then one token each. Keeps the inputs, the
    bf16 step's final hidden state ``ref`` and what the layers add to it:
    ||ref - h_embed||, ``h_embed`` the final norm of the embedded next
    token alone; a MoE model's routes (``_routes``). Computed from the
    whole fp model, before any build step releases a leaf of it."""
    B, S = len(lens), max(lens)
    lens = torch.tensor(lens, device=DEV)
    gen = torch.Generator(device=DEV).manual_seed(7)
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                         device=DEV, dtype=torch.int32)
    nxt = torch.randint(0, cfg.vocab_size, (B, 1), generator=gen,
                        device=DEV, dtype=torch.int32)
    ref = dict(toks=toks, nxt=nxt, max_len=max_len, lens=lens.tolist(),
               valid=torch.arange(S, device=DEV)[None, :] < lens[:, None],
               pos=lens.to(torch.int32))
    with _routes() as routes:
        ref["ref"] = _layers_step(ref, params, cfg)
    ref["routes"] = routes if cfg.moe is not None else None
    with torch.inference_mode():
        h_embed = params.final_norm(
            vocab_mod.embed_lookup(params.embed, nxt, cfg),
            cfg.norm_eps)[:, -1].float()
    ref["layers"] = (ref["ref"] - h_embed).norm()
    return ref


def check_w8a8_layers(label: str, ref: dict, qcfg, qparams) -> None:
    """One full-width decode step of the w8a8 model ``qparams`` over an
    int8 KV cache (``qcfg``) against the bf16 model's (``ref``, from
    ``layers_reference`` on the same prompts). The greedy agreement of the
    serves can hold while the layers are broken, if the embedding carries
    the argmax; so the error here is ||h_w8a8 - h_bf16|| / ||h_bf16 -
    h_embed||, the final hidden state's error over what the layers add to
    it, held to ``W8A8_LAYERS_TOL``. Two planted faults must each leave
    it: every layer's ``wo`` scale zeroed (no attention reaches the
    residual) and the int8 cache's value scales negated after the prefill
    (the int8 decode kernel reads -V: each layer's decode attention flips
    sign). A MoE model's w8a8 runs take the bf16 run's routes: a route is
    a discrete choice, and one moved by the int8 error changes whole
    experts' outputs and the drops after them; the share of tokens whose
    own top-k differs is printed."""
    want, layers = ref["ref"], ref["layers"]
    routes = ref["routes"]

    def err(h) -> float:
        if not torch.isfinite(h).all():
            return float("inf")
        return ((h - want).norm() / layers).item()

    def step(fault=None):
        if routes is None:
            return _layers_step(ref, qparams, qcfg, fault), None
        with _routes(routes) as own:
            return _layers_step(ref, qparams, qcfg, fault), own

    h, own = step()
    got = err(h)
    flips = ("" if own is None else
             f"; {100 * _route_flips(routes, own):.3f}% of tokens routed "
             f"otherwise by the w8a8 model's own router (bf16's routes "
             f"taken)")
    wo = [lay.attn.wo for lay in qparams.layers]
    held = [w.scale if isinstance(w, QuantDense) else w.data for w in wo]
    saved = [t.clone() for t in held]
    for t in held:
        t.zero_()
    try:
        no_attn = err(step()[0])
    finally:
        for t, v in zip(held, saved):
            t.copy_(v)
    neg_v = err(step(lambda cs: [c["v_scale"].neg_() for c in cs])[0])
    if err(step()[0]) != got:
        raise AssertionError(f"{label}: the w8a8 step changed after the "
                             f"planted faults were undone")
    print(f"{label}: full-width decode step, {len(ref['lens'])} rows at pos "
          f"{ref['lens']} (max_len {ref['max_len']}): the layers move the "
          f"bf16 final hidden state by {(layers / want.norm()).item():.4f} "
          f"of its norm; w8a8 + int8 KV error over that {got:.4f} (tol "
          f"{W8A8_LAYERS_TOL}); planted faults: wo scales zeroed "
          f"{no_attn:.4f}, int8 value scales negated {neg_v:.4f}{flips}",
          flush=True)
    if not got <= W8A8_LAYERS_TOL:
        raise AssertionError(f"{label}: w8a8 + int8 KV error {got} > "
                             f"{W8A8_LAYERS_TOL}")
    for name, e in (("wo scales zeroed", no_attn),
                    ("int8 value scales negated", neg_v)):
        if not e > W8A8_LAYERS_TOL:
            raise AssertionError(f"{label}: the planted fault '{name}' "
                                 f"stays within the tolerance ({e} <= "
                                 f"{W8A8_LAYERS_TOL}): the check cannot see "
                                 f"it")


# ---- qwen2-vl-7b ------------------------------------------------------------

# 4 slots of 4608 positions (the 28 layers' K/V, 0.47 GB); the bucket
# ladder reaches the longest prompt
QWEN2VL_KW = dict(batch_slots=4, max_len=4608,
                  prefill_buckets=(128, 256, 512, 1024, 2048, 4096),
                  device=DEV)
# the serve phases' prompts (32 new tokens each) and the decode positions
# of the kernel cases and the decode stage profiles
QWEN2VL_PROMPTS = (4096, 3900, 2100, 300)
QWEN2VL_DECODE_POS = (4095, 3000, 1200, 31)
# qwen2-vl-7b's dense projections (K, N): wq (3584 -> 32 padded heads x
# 128), wk and wv (-> 4 x 128), gate and up (-> 18944), wo (4096 -> 3584),
# down (18944 -> 3584)
QWEN2VL_PROJECTIONS = ((3584, 4096), (3584, 512), (3584, 18944),
                       (4096, 3584), (18944, 3584))
# check-qwen2vl-rope: one full-width layer's attention in bf16 against f32,
# ||y_bf16 - y_f32|| / ||y_f32||
QWEN2VL_ROPE_TOL = 0.02


def qwen2vl_requests(vocab: int):
    """The qwen2-vl serve phases' traffic: 4 token prompts of
    ``QWEN2VL_PROMPTS`` tokens x 32 new tokens (the reference's engine
    serves token prompts at default positions)."""
    rng = np.random.default_rng(0)
    return [Request(i, rng.integers(0, vocab, L).astype(np.int32),
                    max_new_tokens=32)
            for i, L in enumerate(QWEN2VL_PROMPTS)]


def mrope_positions(B: int, S: int, device) -> torch.Tensor:
    """(3,B,S) int32 (t, h, w) position ids that differ stream from stream
    and row from row: t = 0..S-1, h and w thousands apart. At theta 1e6
    the frequencies of the h and w sections turn by 1e-3 to 6e-6 rad a
    position, so with these ids every section rotates visibly, and M-RoPE
    replaced by RoPE, or two sections swapped, changes the output."""
    i = torch.arange(S, device=device)
    pos = torch.stack([i, 3000 + 611 * i, 60000 + 4999 * i])[:, None, :]
    row = torch.arange(B, device=device)[None, :, None] \
        * torch.tensor([1, 97, 1013], device=device)[:, None, None]
    return (pos + row).to(torch.int32)


def qwen2vl_kernel_cases() -> None:
    """The kernels at qwen2-vl-7b's served shapes (bf16, 28 query heads
    padded to 32 over 4 kv heads: G 8, head_dim 128), each held against
    its plain version and timed beside its library call and its bound:
    flash's prefill of a 4096 bucket with lens ``QWEN2VL_PROMPTS`` (1v)
    and its chunk call, 4 x 512 in place over a 4 x 4608 cache at offsets
    3584, 2048, 512, 0 (1v'), beside SDPA with a boolean mask, on
    ``flash_fwd_kernel_tma<128, ...>``; both decode kernels at B 4,
    S 4608, pos ``QWEN2VL_DECODE_POS`` (2v bf16 beside SDPA, 3v int8);
    w8a8 at the five projections at M 4 (4v, the split-K kernel) and 2048
    (4v', the TMA kernel) beside ``torch._int_mm``. Then one profiler
    window of their device times, which must name the kernel each flash
    and w8a8 case ran. Their inputs come from a generator of their own,
    so that every other case keeps its inputs. They run in the kernel
    phase, before any model: in runs where they followed the serve
    phases' profiles, a trace there came back without some of the card's
    kernels (a one-kernel trace with none; 533 of 540 markers)."""
    gen = torch.Generator(device=DEV).manual_seed(31)
    bf16 = torch.bfloat16
    fns, routes = {}, {}
    name = "qwen2vl_1v_B4_S4096_H32_K4_hd128"
    r = flash_case(name, gen, 4, 4096, 32, 4, 128, bf16,
                   list(QWEN2VL_PROMPTS))
    _show("flash_attn", name, r)
    fns["flash_attn " + name] = r["call"]
    fns["SDPA (boolean mask) " + name] = r["library_call"]
    name = "qwen2vl_1v'_chunk_P4_C512_T4608_H32_K4_hd128"
    r = flash_chunk_case(name, gen, 4, 4608, 32, 4, 128, 512, bf16,
                         slots=[0, 1, 2, 3], start=[3584, 2048, 512, 0],
                         lengths=[512] * 4, measure=True)
    _show("flash_attn", name, r)
    fns["flash_attn " + name] = r["call"]
    fns["SDPA (boolean mask) " + name] = r["library_call"]
    # the device window must name the TMA kernel at hd 128 for both
    for n in ("1v_B4_S4096", "1v'_chunk_P4_C512_T4608"):
        routes[f"flash_attn qwen2vl_{n}_H32_K4_hd128"] = (
            "flash_fwd_kernel_tma<128", "flash_fwd_kernel<")
    case = (4, 32, 4, 128, 4608, list(QWEN2VL_DECODE_POS), bf16)
    name = "qwen2vl_2v_B4_S4608_H32_K4_hd128"
    r = decode_case(name, gen, *case)
    _show("decode_attn", name, r)
    fns["decode_attn " + name] = r["call"]
    fns["SDPA " + name] = r["library_call"]
    name = "qwen2vl_3v_B4_S4608_H32_K4_hd128"
    r = decode_int8_case(name, gen, *case)
    _show("decode_attn_int8", name, r)
    fns["decode_attn_int8 " + name] = r["call"]
    for M, row in ((4, "4v"), (2048, "4v'")):
        for K, N in QWEN2VL_PROJECTIONS:
            name = f"qwen2vl_{row}_M{M}_K{K}_N{N}"
            r = w8a8_case(name, gen, M, K, N)
            _show("w8a8_matmul", name, r)
            fns["w8a8_matmul " + name] = r["call"]
            fns["torch._int_mm + scales " + name] = r["library_call"]
            routes["w8a8_matmul " + name] = (
                "w8a8_splitk_kernel" if M <= 16 else "w8a8_kernel_tma",
                "w8a8_kernel<")
    device_window(fns, routes=routes)


def reduce_qwen2vl(dtype: str):
    """qwen2-vl-7b cut for the card-vs-host check, keeping what
    ``reduce_for_smoke`` drops: 6 query heads padded to 8 over 2 kv heads
    (G 4, the padding inside the last kv group, as at full width), q/k/v
    biases, untied embeddings. f32: ``reduce_for_smoke``'s 2 layers of
    d_model 64 at head_dim 16, M-RoPE sections (4, 2, 2); bf16: d_model
    256 at head_dim 128 with the full width's sections (16, 24, 24), so
    flash runs its tensor-core kernel."""
    cfg = dataclasses.replace(reduce_for_smoke(get_config("qwen2-vl-7b")),
                              num_heads=6, num_padded_heads=8,
                              num_kv_heads=2, head_dim=16)
    if dtype == "float32":
        return cfg
    return dataclasses.replace(cfg, d_model=256, head_dim=128, d_ff=512,
                               mrope_sections=(16, 24, 24),
                               param_dtype=dtype, activation_dtype=dtype)


def _qwen2vl_hidden(params, cfg, x, pos3, valid, steps, max_len: int):
    """Through the model layer: mode 'full' over the patch embeddings ``x``
    (B,S,d) at (t, h, w) positions ``pos3`` (3,B,S), ``valid`` (B,S)
    marking the real ones; a prefill of the same into fresh caches; then
    one decode step for each of ``steps`` (tokens (B,1) or embeds
    (B,1,d)) at each row's next position. Returns the real rows' hidden
    states of both passes and the decode steps' (n,B,d), f32 on the
    host."""
    dev = model_mod.model_device(params)
    valid = valid.to(dev)
    batch = {"embeds": x.to(dev), "positions": pos3.to(dev)}
    lens = valid.sum(-1).to(torch.int32)
    with torch.inference_mode():
        full, _ = model_mod.forward(params, cfg, batch, mode="full",
                                    caches=None, kv_valid=valid)
        caches = model_mod.init_caches(cfg, x.shape[0], max_len, dev)
        pre, caches = model_mod.forward(params, cfg, batch, mode="prefill",
                                        caches=caches, kv_valid=valid)
        hs = []
        for i, step in enumerate(steps):
            h, caches = model_mod.decode_step(params, cfg, step.to(dev),
                                              caches, lens + i)
            hs.append(h)
    return (full[valid].float().cpu(), pre[valid].float().cpu(),
            torch.stack(hs).float().cpu())


def phase_check_qwen2vl() -> None:
    """check-qwen2vl: ``reduce_qwen2vl`` in f32 and bf16, every bias and
    norm scale drawn nonzero: modes full and prefill over patch embeddings
    at distinct (t, h, w) positions (3 rows of 40, 27 and 5 real ones),
    then 4 decode steps, 2 on tokens and 2 on embeds, on the card against
    the host's plain versions (``_hold_hidden``: 2e-3 elementwise in f32,
    a relative 2e-2 in bf16)."""
    B, S = 3, 40
    for dtype in ("float32", "bfloat16"):
        cfg = reduce_qwen2vl(dtype)
        dt = dtype_of(dtype)
        params = model_mod.init_params(cfg, seed=1, device=DEV)
        draw_biases(params, seed=2)
        host = copy.deepcopy(params).to("cpu")
        gen = torch.Generator().manual_seed(3)
        x = torch.randn(B, S, cfg.d_model, generator=gen)
        valid = torch.arange(S)[None, :] < torch.tensor([40, 27, 5])[:, None]
        toks = [torch.randint(0, cfg.vocab_size, (B, 1), generator=gen,
                              dtype=torch.int32) for _ in range(2)]
        embs = [torch.randn(B, 1, cfg.d_model, generator=gen)
                for _ in range(2)]
        args = (x, mrope_positions(B, S, "cpu"), valid, toks + embs, 64)
        got = _qwen2vl_hidden(params, cfg, *args)
        want = _qwen2vl_hidden(host, cfg, *args)
        label = f"check-qwen2vl[{dtype} hd {cfg.head_dim}]"
        held = [_hold_hidden(f"{label} {what}", g, w, dt)
                for what, g, w in zip(("full", "prefill", "decode"), got,
                                      want)]
        print(f"{label}: {cfg.num_heads} heads padded to "
              f"{cfg.padded_heads} over {cfg.num_kv_heads}, sections "
              f"{cfg.mrope_sections}, biases and norms drawn; card vs host "
              f"over embeddings at distinct (t, h, w) positions: full "
              f"{held[0]}, prefill {held[1]}; 2 decode steps on tokens and "
              f"2 on embeds {held[2]} (tol {TOL[dt]})", flush=True)
        del params, host
        _free_card()


def decode_step_p50(label: str, eng, pos, steps: int = 32) -> float:
    """Wall time to completion (its tokens on the host) of ``steps``
    decode stage calls of ``eng`` at 4 rows from ``pos`` onward, one call
    at a time: p50 and p99 printed, the p50 returned."""
    run = eng.executor.get("decode", (eng.precision,), eng._build_decode)
    B = eng.batch_slots
    pos = np.array(pos[:B], np.int32)
    toks = np.zeros((B, 1), np.int32)
    times = []
    for i in range(steps):
        t0 = time.perf_counter()
        toks = run({"tokens": toks, "pos": pos + i,
                    "active": np.ones(B, bool)})[:, None]
        times.append((time.perf_counter() - t0) * 1e3)
    how = "graphed" if eng.executor.graphs else "eager"
    print(f"{label}: decode stage call ({how}), {B} rows at pos "
          f"{pos.tolist()}+: p50 "
          f"{np.percentile(times, 50):.3f} ms, p99 "
          f"{np.percentile(times, 99):.3f} ms over {steps} calls",
          flush=True)
    return float(np.percentile(times, 50))


def _layer_attention(attn, cfg, x, positions) -> torch.Tensor:
    with torch.inference_mode():
        y, _ = attn_mod.full_attention(attn, x, cfg, positions,
                                       kind="global")
    return y.float()


def check_qwen2vl_rope(label: str, cfg, params, B: int = 2,
                       S: int = 1024) -> None:
    """Layer 0's attention at full width (28 query heads padded to 32 over
    4 kv heads, hd 128, M-RoPE sections (16, 24, 24) at theta 1e6), with
    its q/k/v biases drawn from N(0, 0.5^2) (the padded heads' ``bq``
    too), over N(0, 1) inputs at distinct (t, h, w) positions
    (``mrope_positions``): bf16 on the card against the same weights in
    f32, ||y_bf16 - y_f32|| / ||y_f32|| within ``QWEN2VL_ROPE_TOL``. Four
    planted faults in the bf16 layer must each land past it: M-RoPE
    replaced by plain RoPE at the t stream, the t and h sections swapped,
    the q/k/v biases dropped, and padded head 28's ``wo`` row drawn like
    a real head's."""
    H = cfg.num_heads
    gen = torch.Generator(device=DEV).manual_seed(5)
    attn = copy.deepcopy(params.layers[0].attn)
    with torch.no_grad():
        for n in ("bq", "bk", "bv"):
            b = getattr(attn, n)
            b.copy_(0.5 * torch.randn(b.shape, generator=gen, device=DEV))
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                activation_dtype="float32")
    x = torch.randn(B, S, cfg.d_model, generator=gen, device=DEV)
    pos3 = mrope_positions(B, S, DEV)
    want = _layer_attention(copy.deepcopy(attn).float(), cfg32, x, pos3)
    x16 = x.to(torch.bfloat16)

    def err(a=attn, c=cfg, pos=pos3) -> float:
        y = _layer_attention(a, c, x16, pos)
        if not torch.isfinite(y).all():
            return float("inf")
        return ((y - want).norm() / want.norm()).item()

    got = err()
    no_bias = copy.deepcopy(attn)
    live = copy.deepcopy(attn)
    with torch.no_grad():
        for n in ("bq", "bk", "bv"):
            getattr(no_bias, n).zero_()
        std = live.wo[:H].float().std()
        live.wo[H] = (torch.randn(live.wo[H].shape, generator=gen,
                                  device=DEV) * std).to(live.wo.dtype)
    t, h, w = cfg.mrope_sections
    faults = {
        "M-RoPE replaced by RoPE": err(
            c=dataclasses.replace(cfg, rope_mode="standard"), pos=pos3[0]),
        "t and h sections swapped": err(
            c=dataclasses.replace(cfg, mrope_sections=(h, t, w))),
        "q/k/v biases dropped": err(a=no_bias),
        f"padded head {H}'s wo row drawn": err(a=live)}
    print(f"{label}: layer 0's attention, {B} rows x {S} at distinct "
          f"(t, h, w) positions, biases drawn: bf16 vs f32 relative error "
          f"{got:.4f} (tol {QWEN2VL_ROPE_TOL}); planted faults: "
          + ", ".join(f"{k} {v:.4f}" for k, v in faults.items()),
          flush=True)
    if not got <= QWEN2VL_ROPE_TOL:
        raise AssertionError(f"{label}: bf16 vs f32 {got} > "
                             f"{QWEN2VL_ROPE_TOL}")
    for name, e in faults.items():
        if not e > QWEN2VL_ROPE_TOL:
            raise AssertionError(f"{label}: the planted fault '{name}' "
                                 f"stays within the tolerance ({e} <= "
                                 f"{QWEN2VL_ROPE_TOL}): the check cannot "
                                 f"see it")


def phase_qwen2vl() -> dict:
    """check-qwen2vl, then full width (28 layers, d_model 3584, 28 query heads padded to 32 over 4 kv
    heads of 128, q/k/v biases, SwiGLU d_ff 18944, untied vocab 152064;
    random bf16 weights from seed 0): serve-qwen2vl (graphed, 4 token
    prompts of ``QWEN2VL_PROMPTS`` x 32 tokens, warmed on the same
    requests; its decode stage's p50 and profile), serve-eager-qwen2vl
    (tokens identical), serve-qwen2vl-chunked (chunk 512),
    serve-qwen2vl-w8a8 with an int8 KV cache (agreement with the bf16
    serve >= 0.90) and check-qwen2vl-layers, then check-qwen2vl-rope.
    Frees the weights; returns the launches of the graphed bf16, chunked
    and w8a8 serves."""
    phase_check_qwen2vl()
    cfg = get_config("qwen2-vl-7b")
    t0 = time.perf_counter()
    params = model_mod.init_params(cfg, seed=0, device=DEV)
    torch.cuda.synchronize()
    print(f"init: qwen2-vl-7b full width, "
          f"{sum(p.numel() for p in params.parameters()) / 1e9:.3f} B "
          f"params, {torch.cuda.memory_allocated() / 2**30:.2f} GiB, in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    trace = lambda: qwen2vl_requests(cfg.vocab_size)
    serve = dict(engine_kw=QWEN2VL_KW, trace=trace,
                 ref_label="serve-qwen2vl",
                 layers_label="check-qwen2vl-layers",
                 profile_pos=QWEN2VL_DECODE_POS)
    launches, outputs, eng = phase_serve_padded(
        cfg, params, "serve-qwen2vl", keep_engine=True, **serve)
    decode_step_p50("serve-qwen2vl", eng, QWEN2VL_DECODE_POS)
    phase_serve_eager("serve-eager-qwen2vl", eng, launches, outputs, cfg,
                      params, engine_kw=QWEN2VL_KW, trace=trace,
                      decode_pos=QWEN2VL_DECODE_POS, identical=True)
    del eng
    _free_card()
    chunked, _, _ = phase_serve_padded(
        cfg, params, "serve-qwen2vl-chunked", mono_outputs=outputs,
        prefill_chunk=512, **serve)
    _free_card()
    quant, _, _ = phase_serve_padded(
        cfg, params, "serve-qwen2vl-w8a8", mono_outputs=outputs,
        precision="w8a8", **serve)
    _free_card()
    check_qwen2vl_rope("check-qwen2vl-rope", cfg, params)
    del params
    _free_card()
    print(f"freed qwen2-vl-7b: {torch.cuda.memory_allocated() / 2**30:.2f} "
          f"GiB still allocated", flush=True)
    return {k: launches[k] + chunked[k] + quant[k]
            for k in ("flash_attn", "decode_attn", "w8a8_matmul",
                      "decode_attn_int8")}


# ---- recurrentgemma-9b ------------------------------------------------------

# 4 slots of 4608 positions: the 12 local layers' rings of 2048 slots (50 MB)
# and the 26 recurrent layers' state (``h`` in f32 and the conv tail, 1.2 MB);
# the bucket ladder reaches the longest prompt
RECURRENTGEMMA_KW = dict(batch_slots=4, max_len=4608,
                         prefill_buckets=(128, 256, 512, 1024, 2048, 4096),
                         device=DEV)
# the served decode stage is profiled from these positions on (rings full)
RECURRENTGEMMA_DECODE_POS = (4000, 3500, 2100, 300)


def reduce_recurrentgemma(dtype: str):
    """recurrentgemma-9b cut to 8 layers ((recurrent, recurrent, local) x 2,
    then the (recurrent, recurrent) tail) of d_model 256 and lru_width 256
    (8 gate blocks of 32), keeping 16 query heads of head_dim 256 over one
    kv head (G 16); window 64, d_ff 512, vocab 256; d_conv 4, GeGLU, tied
    embeddings and the embedding multiplier as at full width; in
    ``dtype``."""
    cfg = get_config("recurrentgemma-9b")
    return dataclasses.replace(
        reduce_for_smoke(cfg), num_layers=8, d_model=256, num_heads=16,
        num_kv_heads=1, head_dim=256, d_ff=512, window_size=64,
        recurrent=dataclasses.replace(cfg.recurrent, lru_width=256),
        param_dtype=dtype, activation_dtype=dtype)


def phase_check_recurrentgemma(kw=None):
    """``reduce_recurrentgemma`` in f32 and bf16, each fp and w8a8 + int8
    KV: card vs host, chunked vs monolithic, graphed vs eager, prefix hit
    vs cold, snapshot round trips at max_len 256 (the rings whole) and 48
    (below the window: the rings positional), the recurrent state moved
    whole in both (``check_reduced``)."""
    check_reduced("check-recurrentgemma", "reduced recurrentgemma-9b",
                  reduce_recurrentgemma, kw,
                  below_window=dict(max_len=48, prefill_buckets=(16, 32, 48)))


# check-recurrentgemma-block: the card's bf16 run of one (recurrent,
# recurrent, local) unit against the host's f32 run of the same weights,
# its error over what the three blocks add. At full width bf16 rounding
# gives 0.0204 there, ``h`` zeroed between decode steps 0.4627 and the
# reversed conv taps 1.3553 (H100 80GB HBM3, 700 W; this script)
RECURRENT_BLOCK_TOL = 0.05


def _unit_run(blocks, cfg, x0, valid, steps, fault=None):
    """A prefill of ``x0`` (B,S,d), real where ``valid`` (B,S), through
    ``blocks`` into fresh caches of ``cfg`` (whose layers are those
    blocks), then one decode step of each input of ``steps`` ((B,1,d))
    at positions lens + i. ``fault``: "taps", the recurrent layers' conv
    taps reversed for the run, or "h", every recurrent layer's ``h``
    zeroed between decode steps. Returns (the prefill's output at the real
    tokens, the decode outputs (n,B,d)), f32 on the host."""
    dev = x0.device
    B, S = valid.shape
    recs = [b.rec for b in blocks if b.kind == "recurrent"]
    saved = [r.conv_w.detach().clone() for r in recs]
    with torch.inference_mode():
        if fault == "taps":
            for r in recs:
                r.conv_w.copy_(r.conv_w.flip(0))
        try:
            caches = model_mod.init_caches(cfg, B, S + len(steps), dev)
            x = x0
            for b, c in zip(blocks, caches):
                x = blk_mod.apply_block(
                    b, x, cfg, mode="prefill", cache=c,
                    positions=torch.arange(S, device=dev).expand(B, S),
                    kv_valid=valid, rows=torch.arange(B, device=dev))
            pos = valid.sum(-1).to(torch.int32)
            outs = []
            for i, y in enumerate(steps):
                if fault == "h" and i:
                    for c in caches:
                        if "h" in c:
                            c["h"].zero_()
                for b, c in zip(blocks, caches):
                    y = blk_mod.apply_block(b, y, cfg, mode="decode",
                                            cache=c, pos=pos + i)
                outs.append(y[:, 0])
        finally:
            for r, w in zip(recs, saved):
                r.conv_w.copy_(w)
        return x[valid].float().cpu(), torch.stack(outs).float().cpu()


def check_recurrent_block(label: str, cfg, params, lens=(256, 200, 65, 1),
                          steps: int = 4) -> None:
    """The first (recurrent, recurrent, local) unit of ``params`` run two
    ways from the same weights and inputs: on ``DEV`` in the model's type
    through the kernels, and on the host in f32 through the plain
    versions. The inputs are the embedded tokens of 4 rows of ``lens``
    real tokens (right-padded), then ``steps`` decode steps of one token.
    The greedy agreement of a served model cannot show a broken recurrent
    layer, so the error here is ||out - out_host|| / ||out_host - in||,
    the unit's output error over what its three blocks add, the larger of
    the prefill's (its real tokens) and the decode steps', held to
    ``RECURRENT_BLOCK_TOL``. Two planted faults must each leave it: the
    conv taps reversed, and ``h`` zeroed between decode steps."""
    kinds = cfg.block_pattern
    ucfg = dataclasses.replace(cfg, num_layers=len(kinds))
    blocks = list(params.layers[:len(kinds)])
    if tuple(b.kind for b in blocks) != kinds:
        raise AssertionError(f"{label}: the first layers are "
                             f"{[b.kind for b in blocks]}, not {kinds}")
    B, S = len(lens), max(lens)
    gen = torch.Generator(device=DEV).manual_seed(9)
    toks = torch.randint(0, cfg.vocab_size, (B, S + steps), generator=gen,
                         device=DEV, dtype=torch.int32)
    with torch.inference_mode():
        emb = vocab_mod.embed_lookup(params.embed, toks, cfg)
    lens_t = torch.tensor(lens, device=DEV)
    valid = torch.arange(S, device=DEV)[None, :] < lens_t[:, None]
    x0, xs = emb[:, :S], [emb[:, S + i:S + i + 1] for i in range(steps)]
    hcfg = dataclasses.replace(ucfg, param_dtype="float32",
                               activation_dtype="float32")
    host = [copy.deepcopy(b).to(device="cpu", dtype=torch.float32)
            for b in blocks]
    t0 = time.perf_counter()
    want = _unit_run(host, hcfg, x0.float().cpu(), valid.cpu(),
                     [x.float().cpu() for x in xs])
    host_s = time.perf_counter() - t0
    base = (x0[valid].float().cpu(),
            torch.stack([x[:, 0] for x in xs]).float().cpu())

    def errs(fault=None) -> tuple:
        """(prefill, decode) error over what the unit adds."""
        got = _unit_run(blocks, ucfg, x0, valid, xs, fault)
        return tuple(((g - w).norm() / (w - b).norm()).item()
                     if torch.isfinite(g).all() else float("inf")
                     for g, w, b in zip(got, want, base))

    parts = errs()
    got = max(parts)
    faults = {"conv taps reversed": max(errs("taps")),
              "h zeroed between decode steps": max(errs("h"))}
    if errs() != parts:
        raise AssertionError(f"{label}: the unit's output changed after "
                             f"the planted faults were undone")
    print(f"{label}: layers {list(kinds)} of d_model {cfg.d_model}, "
          f"{B} rows of {list(lens)} tokens then {steps} decode steps; "
          f"{params.embed.dtype} on {DEV} vs f32 on the host ({host_s:.1f} "
          f"s): error over what the unit adds {got:.4f} (prefill "
          f"{parts[0]:.4f}, decode {parts[1]:.4f}; tol "
          f"{RECURRENT_BLOCK_TOL}); planted faults: " + ", ".join(
              f"{k} {v:.4f}" for k, v in faults.items()), flush=True)
    if not got <= RECURRENT_BLOCK_TOL:
        raise AssertionError(f"{label}: error {got} > {RECURRENT_BLOCK_TOL}")
    for name, e in faults.items():
        if not e > RECURRENT_BLOCK_TOL:
            raise AssertionError(f"{label}: the planted fault '{name}' "
                                 f"stays within the tolerance ({e} <= "
                                 f"{RECURRENT_BLOCK_TOL}): the check cannot "
                                 f"see it")


def recurrentgemma_requests(vocab: int):
    """The recurrentgemma serve phases' traffic: 8 prompts x 32 new tokens,
    long and short in turn: 4 of 2100-4000 tokens (past the 2048 window,
    so the rings wrap and the scan runs long) and 4 of 70-450."""
    rng = np.random.default_rng(0)
    lens = np.stack([rng.integers(2100, 4001, 4),
                     rng.integers(70, 451, 4)], 1).reshape(-1)
    return [Request(i, rng.integers(0, vocab, int(L)).astype(np.int32),
                    max_new_tokens=32) for i, L in enumerate(lens)]


def phase_serve_recurrentgemma(cfg, params, label="serve-recurrentgemma",
                               mono_outputs=None, **kw):
    """Full-width recurrentgemma-9b serving in bf16, graphed and warmed on
    the same requests, so every stage key is captured before the measured
    run; with ``prefill_chunk`` in ``kw``, chunked. Flash with a window
    (the local layers; at a query offset when chunked) and bf16 decode must
    have run. A chunked serve's greedy agreement with the monolithic
    ``mono_outputs`` is printed, not held (near-flat logits of random
    full-width weights). Returns (launches, outputs, the engine)."""
    trace = lambda: recurrentgemma_requests(cfg.vocab_size)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    eng = InferenceEngine(cfg, params, **RECURRENTGEMMA_KW, **kw)
    launches, outputs = _serve(eng, cfg, label, base, trace=trace,
                               warm=trace, model=cfg.name)
    need = ["flash_attn", "flash_attn with a window", "decode_attn"]
    if kw.get("prefill_chunk"):
        need.append("flash_attn at a q_off")
    _require_launched(label, launches, need)
    if mono_outputs is not None:
        agree = token_agreement(zip(outputs, mono_outputs))
        div = _first_divergence(outputs, mono_outputs)
        print(f"{label}: greedy-token agreement with serve-recurrentgemma "
              f"{agree:.4f} ({'tokens identical' if div is None else div}; "
              f"printed, not held)", flush=True)
    print(f"{label}: card total "
          f"{torch.cuda.get_device_properties(0).total_memory / 2**30:.2f} "
          f"GiB", flush=True)
    return launches, outputs, eng


def profile_rglru(cfg, params, caches, lens=(4096, 3900, 2100, 300),
                  pos=RECURRENTGEMMA_DECODE_POS, steps: int = 4) -> None:
    """The RG-LRU's share of a prefill call (4 rows of ``lens`` tokens) and
    of a decode step (4 rows at ``pos`` on), each through the model layer,
    eagerly, on a served engine's caches: from one trace each, the device
    time of its ``rglru.RGLRU_SPAN`` spans (one a recurrent layer and
    call; the projections, conv, gates and scan) and ``RGLRU_SCAN_SPAN``
    spans (the scan alone) against the call's."""
    B, S = len(lens), max(lens)
    gen = torch.Generator(device=DEV).manual_seed(8)
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                         device=DEV, dtype=torch.int32)
    lens_t = torch.tensor(lens, device=DEV)
    valid = torch.arange(S, device=DEV)[None, :] < lens_t[:, None]
    p0 = torch.tensor(pos, dtype=torch.int32, device=DEV)

    @torch.inference_mode()
    def prefill():
        x, _ = model_mod.forward(params, cfg, {"tokens": toks},
                                 mode="prefill", caches=caches,
                                 kv_valid=valid)
        return model_mod.greedy_next(
            params, cfg, x[torch.arange(B, device=DEV), lens_t - 1]).cpu()

    @torch.inference_mode()
    def decode():
        nxt = toks[:, :1]
        for i in range(steps):
            h, _ = model_mod.decode_step(params, cfg, nxt, caches, p0 + i)
            nxt = model_mod.greedy_next(params, cfg, h)[:, None].to(
                torch.int32)
        return nxt.cpu()

    n_rec = sum(k == "recurrent" for k in cfg.layer_kinds())
    label = "profile-recurrentgemma"
    for what, fn, n in ((f"prefill {B}x{S} (lens {list(lens)})", prefill, 1),
                        (f"decode step, {B} rows at pos {list(pos)}+",
                         decode, steps)):
        prof = profile_window(f"{label}: eager {what}", fn, n)
        if prof is None:
            continue
        call_ms = sum(e.self_device_time_total
                      for e in _device_events(prof)) / 1e3
        spans, ms = _span_ms(prof, rglru_mod.RGLRU_SPAN)
        scans, scan_ms = _span_ms(prof, rglru_mod.RGLRU_SCAN_SPAN)
        if spans != n_rec * n or not ms:
            print(f"profile: {label}: {what}: RG-LRU not measured ({spans} "
                  f"spans for {n_rec} recurrent layers x {n} calls, {ms:.3f}"
                  f" ms device time)", flush=True)
            continue
        print(f"profile: {label}: {what}: RG-LRU {ms / n:.3f} ms of "
              f"{call_ms / n:.3f} ms device time a call "
              f"({100 * ms / call_ms:.1f}%; {spans // n} recurrent layers, "
              f"{ms / spans:.4f} ms a layer), of which the scan "
              f"{scan_ms / n:.3f} ms ({100 * scan_ms / call_ms:.1f}%, "
              f"{scans // n} scans)", flush=True)


def phase_recurrentgemma() -> dict:
    """check-recurrentgemma, then full-width recurrentgemma-9b (38 layers,
    26 recurrent and 12 local; 17.3 GB of random bf16 weights from seed
    0): check-recurrentgemma-block on its first unit, serve-recurrentgemma
    and its eager twin, profile-recurrentgemma, serve-recurrentgemma-chunked.
    Frees the weights; returns the flash and bf16 decode launches of the
    graphed monolithic and chunked serves."""
    phase_check_recurrentgemma()
    cfg = get_config("recurrentgemma-9b")
    t0 = time.perf_counter()
    params = model_mod.init_params(cfg, seed=0, device=DEV)
    torch.cuda.synchronize()
    print(f"init: recurrentgemma-9b full width, "
          f"{sum(p.numel() for p in params.parameters()) / 1e9:.3f} B "
          f"params, {torch.cuda.memory_allocated() / 2**30:.2f} GiB, in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    check_recurrent_block("check-recurrentgemma-block", cfg, params)
    launches, outputs, eng = phase_serve_recurrentgemma(cfg, params)
    phase_serve_eager("serve-eager-recurrentgemma", eng, launches, outputs,
                      cfg, params, engine_kw=RECURRENTGEMMA_KW,
                      trace=lambda: recurrentgemma_requests(cfg.vocab_size),
                      decode_pos=RECURRENTGEMMA_DECODE_POS)
    profile_rglru(cfg, params, eng.caches)
    del eng
    _free_card()
    chunked, _, eng = phase_serve_recurrentgemma(
        cfg, params, "serve-recurrentgemma-chunked", outputs,
        prefill_chunk=512)
    del eng, params
    _free_card()
    print(f"freed recurrentgemma-9b: "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB still allocated",
          flush=True)
    return {k: launches[k] + chunked[k] for k in ("flash_attn",
                                                   "decode_attn")}


# ---- mamba2-130m ------------------------------------------------------------

# 4 slots of 4608 positions; a slot's state (each of the 24 layers' SSD
# ``state`` in f32 and its conv tail, 19.13 MB) does not depend on max_len;
# the bucket ladder reaches the longest prompt
MAMBA2_KW = dict(batch_slots=4, max_len=4608,
                 prefill_buckets=(128, 256, 512, 1024, 2048, 4096),
                 device=DEV)
MAMBA2_DECODE_POS = (4000, 3500, 2100, 300)
# serve-mamba2-long: one prompt of 32,736 tokens and three of 300 at
# max_len 32768 (the engine prefills min(length, max_len - 33) tokens of
# each: 32,735 of the long one, in the 32768 bucket)
MAMBA2_LONG_KW = dict(batch_slots=4, max_len=32768,
                      prefill_buckets=(512, 2048, 32768), device=DEV)
MAMBA2_LONG_LENS = (32736, 300, 300, 300)
# check-mamba2-block: the error over what the first 4 layers add, bf16 on
# the card against f32 on the card, fixed before the first run on the card
# (PERF.md: 0.0132 read, the planted faults 0.1492-1.2595; H100 80GB HBM3,
# 700 W; this script)
SSM_BLOCK_TOL = 0.05
SSM_FAULTS = {"taps": "conv taps reversed",
              "state": "state zeroed between decode steps",
              "h0": "h0 dropped in chunk steps",
              "dt": "pad tokens' dt unmasked"}


def draw_ssm(params, seed: int) -> None:
    """Draw in place, from a seeded generator on the parameters' device,
    the leaves that init leaves at 0 or 1 (where a port that dropped one
    agrees with one that keeps it): each ssm layer's ``A_log`` (A in [1,
    16]) and ``dt_bias`` (softplus of it in [0.001, 0.1], log-uniform;
    Mamba2's init ranges), ``D`` (about 1), ``conv_b`` and ``norm_scale``
    (about 0), and every norm's scale (about 0)."""
    dev = model_mod.model_device(params)
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        for name, t in params.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            u = torch.rand(t.shape, generator=gen, device=dev)
            n = torch.randn(t.shape, generator=gen, device=dev)
            if leaf == "A_log":
                v = u * float(np.log(16.0))
            elif leaf == "dt_bias":
                dt = torch.exp(float(np.log(1e-3)) + u * float(np.log(100.0)))
                v = dt + torch.log(-torch.expm1(-dt))
            elif leaf == "D":
                v = 1.0 + 0.5 * n
            elif leaf in ("conv_b", "norm_scale", "scale"):
                v = 0.3 * n
            else:
                continue
            t.copy_(v.to(t.dtype))


def reduce_mamba2(dtype: str):
    """check-mamba2's configs: in f32 ``reduce_for_smoke`` (2 layers of
    d_model 64, d_inner 128 in 8 heads of 16, d_state 16, chunk 32); in
    bf16 2 layers of d_model 256 at the published SSM dims (d_inner 512 in
    8 heads of 64, d_state 128, chunk 256). Vocab 256, tied."""
    cfg = get_config("mamba2-130m")
    small = reduce_for_smoke(cfg)
    if dtype == "float32":
        return small
    return dataclasses.replace(small, d_model=256, ssm=cfg.ssm,
                               param_dtype=dtype, activation_dtype=dtype)


def _model_hidden(params, cfg, toks, valid, steps, max_len: int):
    """Through the model layer: mode 'full' over ``toks`` (B,S), a prefill
    of the same (``valid`` (B,S) marking the real tokens) into fresh
    caches, then one decode step of each of ``steps`` ((B,1) tokens) at
    each row's next position. Returns the real tokens' hidden states of
    both passes, the decode steps' (n,B,d) and the final caches, on the
    host (f32 but the caches)."""
    dev = model_mod.model_device(params)
    valid = valid.to(dev)
    batch = {"tokens": toks.to(dev)}
    lens = valid.sum(-1).to(torch.int32)
    with torch.inference_mode():
        full, _ = model_mod.forward(params, cfg, batch, mode="full",
                                    caches=None)
        caches = model_mod.init_caches(cfg, toks.shape[0], max_len, dev)
        pre, caches = model_mod.forward(params, cfg, batch, mode="prefill",
                                        caches=caches, kv_valid=valid)
        hs = []
        for i, step in enumerate(steps):
            h, caches = model_mod.decode_step(params, cfg, step.to(dev),
                                              caches, lens + i)
            hs.append(h)
    return (full[valid].float().cpu(), pre[valid].float().cpu(),
            torch.stack(hs).float().cpu(),
            [{k: t.cpu() for k, t in c.items()} for c in caches])


def phase_check_mamba2() -> None:
    """check-mamba2 on ``reduce_mamba2`` in f32 and bf16, ``draw_ssm``'s
    leaves drawn: modes full and prefill over right-padded rows (f32: 64,
    45, 17 and 1 tokens in a bucket of 64, two SSD chunks; bf16: 600, 300,
    77 and 1 in a bucket of 768, three chunks), then 4 decode steps, card
    against host (``_hold_hidden``: 2e-3 elementwise in f32, a relative
    2e-2 in bf16; the SSD state likewise). Then engines on the card:
    graphed == eager tokens (monolithic and chunked) in both; in f32
    chunked (8, 16) == monolithic tokens, a prefix hit == a cold engine,
    snapshot -> restore bit for bit (the state moves whole), host paging
    and mid-prefill migration token-identical; in bf16 chunk 256 vs
    monolithic greedy agreement >= 0.95."""
    for dtype, lens, bucket in (("float32", (64, 45, 17, 1), 64),
                                ("bfloat16", (600, 300, 77, 1), 768)):
        cfg = reduce_mamba2(dtype)
        dt = dtype_of(dtype)
        host = model_mod.init_params(cfg, seed=1, device="cpu")
        draw_ssm(host, seed=2)
        card = copy.deepcopy(host).to(DEV)
        B = len(lens)
        gen = torch.Generator().manual_seed(3)
        toks = torch.randint(0, cfg.vocab_size, (B, bucket), generator=gen,
                             dtype=torch.int32)
        valid = torch.arange(bucket)[None, :] < torch.tensor(lens)[:, None]
        steps = [torch.randint(0, cfg.vocab_size, (B, 1), generator=gen,
                               dtype=torch.int32) for _ in range(4)]
        args = (toks, valid, steps, bucket + 8)
        got, want = (_model_hidden(m, cfg, *args) for m in (card, host))
        label = f"check-mamba2[{dtype}]"
        held = [_hold_hidden(f"{label} {what}", g, w, dt)
                for what, g, w in zip(("full", "prefill", "decode"), got,
                                      want)]
        state = _hold_hidden(f"{label} state", torch.stack(
            [c["state"] for c in got[3]]), torch.stack(
            [c["state"] for c in want[3]]), dt)
        print(f"{label}: {cfg.num_layers} ssm layers of d_model "
              f"{cfg.d_model}, {cfg.ssm.num_heads(cfg.d_model)} heads of "
              f"{cfg.ssm.head_dim}, d_state {cfg.ssm.d_state}, chunk "
              f"{cfg.ssm.chunk_size}; rows of {list(lens)} tokens in a "
              f"bucket of {bucket}, card vs host: full {held[0]}, prefill "
              f"{held[1]}, 4 decode steps {held[2]}, final state {state} "
              f"(tol {TOL[dt]})", flush=True)
        if dtype == "float32":
            kw = dict(batch_slots=3, max_len=128, prefill_buckets=(16, 32,
                                                                   64))
            trace = lambda: _requests(6, 3, 60, 8, cfg.vocab_size, seed=3)
            chunks = (8, 16)
        else:
            kw = dict(batch_slots=3, max_len=1024,
                      prefill_buckets=(256, 512, 768))
            trace = lambda: _requests(6, 40, 700, 8, cfg.vocab_size, seed=3)
            chunks = (256,)
        mono = _outputs(InferenceEngine(cfg, card, device=DEV, **kw),
                        trace())
        for chunk in chunks:
            eng = InferenceEngine(cfg, card, prefill_chunk=chunk, device=DEV,
                                  **kw)
            out = _outputs(eng, trace())
            agree = token_agreement(zip(out, mono))
            div = _first_divergence(out, mono)
            print(f"{label}: chunk {chunk} vs monolithic greedy-token "
                  f"agreement {agree:.4f} "
                  f"({'tokens identical' if div is None else div}; "
                  f"{eng.telemetry.continuations} continuations)",
                  flush=True)
            if (dtype == "float32" and div is not None) or agree < 0.95:
                raise AssertionError(f"{label}: chunk {chunk} vs monolithic:"
                                     f" {div}, agreement {agree}")
        for chunk in (None, chunks[-1]):
            engs = [InferenceEngine(cfg, card, prefill_chunk=chunk,
                                    cuda_graphs=graphs, device=DEV, **kw)
                    for graphs in (True, False)]
            where = f"chunk {chunk}" if chunk else "monolithic"
            _identical(label, f"{where} graphed vs eager",
                       *(_outputs(e, trace()) for e in engs))
            print(f"{label}: {where}: 6 requests token-identical graphed "
                  f"and eager; final caches max abs difference "
                  f"{_cache_diff(*engs):.3e}", flush=True)
        if dtype != "float32":
            continue
        ckw = dict(kw, prefill_chunk=8)
        _check_prefix_hits(label, cfg, card, ckw)
        _check_round_trip(cfg, card, kw, n=40, label=label)
        _check_paging_and_migration(label, cfg, card, ckw)
        del host, card
        _free_card()


def _ssm_run(blocks, cfg, x0, valid, steps, chunk=None, fault=None):
    """A prefill of ``x0`` (B,S,d), real where ``valid`` (B,S), through the
    ssm ``blocks`` into fresh caches of ``cfg`` (whose layers are those
    blocks): in one call, or with ``chunk`` in chunk steps of that many
    tokens; then one decode step of each input of ``steps`` ((B,1,d)).
    ``fault`` (a key of ``SSM_FAULTS``) is planted for the run: the conv
    taps reversed, the state zeroed between decode steps, the entering
    state ``h0`` zeroed before every chunk step, or the pad tokens' dt
    left unmasked. Returns (the prefill's output at the real tokens, the
    decode outputs (n,B,d)), f32 on the host."""
    dev = x0.device
    B, S = valid.shape
    lens = valid.sum(-1).to(torch.int32)
    ssms = [b.ssm for b in blocks]
    saved = [m.conv_w.detach().clone() for m in ssms]
    chunk_step, mask_pads = ssm_mod.ssm_chunk_step, ssm_mod._mask_pads

    def h0_dropped(p, x, cache, slots, start, lengths):
        cache["state"][slots.long()] = 0.0
        return chunk_step(p, x, cache, slots, start, lengths)

    with torch.inference_mode():
        try:
            if fault == "taps":
                for m in ssms:
                    m.conv_w.copy_(m.conv_w.flip(0))
            elif fault == "h0":
                ssm_mod.ssm_chunk_step = h0_dropped
            elif fault == "dt":
                ssm_mod._mask_pads = lambda dt, valid: dt
            caches = model_mod.init_caches(cfg, B, S + len(steps), dev)
            rows = torch.arange(B, device=dev)
            if chunk is None:
                x = x0
                for b, c in zip(blocks, caches):
                    x = blk_mod.apply_block(b, x, cfg, mode="prefill",
                                            cache=c, kv_valid=valid,
                                            rows=rows)
            else:
                parts = []
                for s0 in range(0, S, chunk):
                    n = (lens - s0).clamp(0, chunk)
                    cc = types.SimpleNamespace(
                        kv_rows=rows.to(torch.int32),
                        q_off=torch.full_like(lens, s0), lens=s0 + n)
                    x = x0[:, s0:s0 + chunk]
                    for b, c in zip(blocks, caches):
                        x = blk_mod.apply_block(b, x, cfg, mode="chunk",
                                                cache=c, chunk=cc)
                    parts.append(x)
                x = torch.cat(parts, dim=1)
            outs = []
            for i, y in enumerate(steps):
                if fault == "state" and i:
                    for c in caches:
                        c["state"].zero_()
                for b, c in zip(blocks, caches):
                    y = blk_mod.apply_block(b, y, cfg, mode="decode",
                                            cache=c, pos=lens + i)
                outs.append(y[:, 0])
        finally:
            ssm_mod.ssm_chunk_step, ssm_mod._mask_pads = chunk_step, \
                mask_pads
            for m, w in zip(ssms, saved):
                m.conv_w.copy_(w)
        return x[valid].float().cpu(), torch.stack(outs).float().cpu()


def check_ssm_block(label: str, cfg, params, layers: int = 4,
                    lens=(1024, 700, 257, 1), steps: int = 8,
                    chunk: int = 512) -> None:
    """The first ``layers`` ssm layers of ``params`` run two ways from the
    same weights and inputs: in the model's type, and in f32 (a copy cast
    up), both on ``DEV``. The inputs are the embedded tokens of rows of
    ``lens`` real tokens (right-padded), then ``steps`` decode steps of
    one token; the model's type runs monolithic and in chunk steps of
    ``chunk``, f32 monolithic. The greedy agreement of a served model
    cannot show a broken layer, so the error is ||out - out_f32|| /
    ||out_f32 - in||, the layers' output error over what they add, the
    largest of the prefill's (its real tokens) and the decode steps' in
    either mode, held to ``SSM_BLOCK_TOL``. Each planted fault of
    ``SSM_FAULTS`` must leave it in one mode at least."""
    ucfg = dataclasses.replace(cfg, num_layers=layers)
    blocks = list(params.layers[:layers])
    if any(b.kind != "ssm" for b in blocks):
        raise AssertionError(f"{label}: the first layers are "
                             f"{[b.kind for b in blocks]}")
    B, S = len(lens), max(lens)
    gen = torch.Generator(device=DEV).manual_seed(9)
    toks = torch.randint(0, cfg.vocab_size, (B, S + steps), generator=gen,
                         device=DEV, dtype=torch.int32)
    with torch.inference_mode():
        emb = vocab_mod.embed_lookup(params.embed, toks, cfg)
    lens_t = torch.tensor(lens, device=DEV)
    valid = torch.arange(S, device=DEV)[None, :] < lens_t[:, None]
    x0, xs = emb[:, :S], [emb[:, S + i:S + i + 1] for i in range(steps)]
    fcfg = dataclasses.replace(ucfg, param_dtype="float32",
                               activation_dtype="float32")
    f32 = [copy.deepcopy(b).to(dtype=torch.float32) for b in blocks]
    want = _ssm_run(f32, fcfg, x0.float(), valid, [x.float() for x in xs])
    del f32
    base = (x0[valid].float().cpu(),
            torch.stack([x[:, 0] for x in xs]).float().cpu())

    def errs(fault=None) -> dict:
        """{mode: (prefill, decode) error over what the layers add}."""
        out = {}
        for mode, ch in (("monolithic", None), (f"chunk {chunk}", chunk)):
            got = _ssm_run(blocks, ucfg, x0, valid, xs, ch, fault)
            out[mode] = tuple(((g - w).norm() / (w - b).norm()).item()
                              if torch.isfinite(g).all() else float("inf")
                              for g, w, b in zip(got, want, base))
        return out

    parts = errs()
    got = max(max(v) for v in parts.values())
    faults = {name: max(max(v) for v in errs(key).values())
              for key, name in SSM_FAULTS.items()}
    if errs() != parts:
        raise AssertionError(f"{label}: the layers' output changed after "
                             f"the planted faults were undone")
    print(f"{label}: {layers} ssm layers of d_model {cfg.d_model}, {B} rows "
          f"of {list(lens)} tokens then {steps} decode steps; "
          f"{params.embed.dtype} vs f32 on {DEV}: error over what the "
          f"layers add {got:.4f} (" + "; ".join(
              f"{m} prefill {p:.4f}, decode {d:.4f}"
              for m, (p, d) in parts.items())
          + f"; tol {SSM_BLOCK_TOL}); planted faults: " + ", ".join(
              f"{k} {v:.4f}" for k, v in faults.items()), flush=True)
    if not got <= SSM_BLOCK_TOL:
        raise AssertionError(f"{label}: error {got} > {SSM_BLOCK_TOL}")
    for name, e in faults.items():
        if not e > SSM_BLOCK_TOL:
            raise AssertionError(f"{label}: the planted fault '{name}' "
                                 f"stays within the tolerance ({e} <= "
                                 f"{SSM_BLOCK_TOL}): the check cannot see "
                                 f"it")


def mamba2_requests(vocab: int):
    """The mamba2 serve phases' traffic: 8 prompts x 32 new tokens, long
    and short in turn: 4096, 3900, 2100 and 300 tokens, and 4 of 17-200."""
    rng = np.random.default_rng(0)
    lens = np.stack([[4096, 3900, 2100, 300],
                     rng.integers(17, 201, 4)], 1).reshape(-1)
    return [Request(i, rng.integers(0, vocab, int(L)).astype(np.int32),
                    max_new_tokens=32) for i, L in enumerate(lens)]


def _state_bytes(eng) -> int:
    return sum(t.numel() * t.element_size() for c in eng.caches
               for t in c.values())


def _require_no_launch(label: str, launches: dict) -> None:
    """Nothing of a mamba2 path routes through attention or w8a8: every
    kernel's counter stays 0."""
    ran = {k: n for k, n in launches.items() if n}
    if ran or flash_attn.noncausal_launches:
        raise AssertionError(f"{label}: kernels launched: {ran}, non-causal "
                             f"flash {flash_attn.noncausal_launches}")


def phase_serve_mamba2(cfg, params, label="serve-mamba2", mono_outputs=None,
                       **kw):
    """Full-width mamba2-130m serving in bf16, graphed and warmed on the
    same requests (every stage key captured before the measured run); with
    ``prefill_chunk`` in ``kw``, chunked. No kernel launches. Prints the
    state's bytes and the decode stage's p50; a chunked serve's agreement
    with ``mono_outputs`` is printed, not held (near-flat logits of random
    full-width weights). Returns (launches, outputs, the engine, the
    decode stage's p50 ms)."""
    trace = lambda: mamba2_requests(cfg.vocab_size)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    eng = InferenceEngine(cfg, params, **MAMBA2_KW, **kw)
    launches, outputs = _serve(eng, cfg, label, base, trace=trace,
                               warm=trace, model=cfg.name)
    _require_no_launch(label, launches)
    nbytes = _state_bytes(eng)
    print(f"{label}: state {nbytes} bytes for {eng.batch_slots} slots "
          f"({nbytes / eng.batch_slots / 1e6:.2f} MB a slot, whatever "
          f"max_len); every kernel's launches 0", flush=True)
    p50 = decode_step_p50(label, eng, MAMBA2_DECODE_POS)
    if mono_outputs is not None:
        agree = token_agreement(zip(outputs, mono_outputs))
        div = _first_divergence(outputs, mono_outputs)
        print(f"{label}: greedy-token agreement with serve-mamba2 "
              f"{agree:.4f} ({'tokens identical' if div is None else div}; "
              f"printed, not held)", flush=True)
    return launches, outputs, eng, p50


def phase_serve_mamba2_long(cfg, params, state_bytes: int,
                            step_p50: float) -> None:
    """serve-mamba2-long: ``MAMBA2_LONG_LENS`` x 32 new tokens at max_len
    32768, monolithic (the long prompt alone in the 32768 bucket, 128 SSD
    chunks) and chunked at 2048, each graphed and warmed on the same
    requests: all served, 32 tokens each, no kernel launched, the state's
    bytes those of serve-mamba2 (the state does not grow with the
    context). Prints the long prompt's TTFT (submit to its first token
    on the host) and the decode stage's p50 beside serve-mamba2's."""
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, L).astype(np.int32)
               for L in MAMBA2_LONG_LENS]
    trace = lambda: [Request(i, p, max_new_tokens=32)
                     for i, p in enumerate(prompts)]
    for chunk in (None, 2048):
        label = "serve-mamba2-long" + (f" chunk {chunk}" if chunk else "")
        torch.cuda.reset_peak_memory_stats()
        eng = InferenceEngine(cfg, params, prefill_chunk=chunk,
                              **MAMBA2_LONG_KW)
        eng.run(trace())
        eng.telemetry.reset_serving_stats()
        reqs = trace()
        _zero_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ttft = None
        for r in reqs:
            eng.submit(r)
        while eng.has_work:
            eng.step_once()
            if ttft is None and reqs[0].output:
                ttft = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in LAUNCHERS.items()}
        _require_no_launch(label, launches)
        bad = [r.rid for r in reqs if len(r.output) != 32]
        if bad or eng.telemetry.served != len(reqs):
            raise AssertionError(f"{label}: requests {bad} did not get 32 "
                                 f"tokens ({eng.telemetry.served} served)")
        nbytes = _state_bytes(eng)
        if nbytes != state_bytes:
            raise AssertionError(f"{label}: state {nbytes} bytes at max_len "
                                 f"32768, serve-mamba2's {state_bytes}")
        p50 = decode_step_p50(label, eng, (32700, 300, 300, 300))
        print(f"{label}: prompts {[len(p) for p in prompts]} (the long one "
              f"prefilled to {eng._prefill_len(reqs[0])}); served "
              f"{eng.telemetry.served}/{len(reqs)} x 32 tokens in "
              f"{wall:.3f} s, the long prompt's TTFT {ttft:.2f} ms; state "
              f"{nbytes} bytes, equal to serve-mamba2's at max_len 4608; "
              f"decode stage p50 {p50:.3f} ms (serve-mamba2's "
              f"{step_p50:.3f}); peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
              f"{_graph_counts(eng)}", flush=True)
        del eng
        _free_card()


def init_mamba2():
    """Full-width mamba2-130m (24 ssm layers, d_model 768, tied vocab 50280
    padded to 50432; random bf16 weights from seed 0, ``draw_ssm``'s
    leaves drawn from seed 1)."""
    cfg = get_config("mamba2-130m")
    t0 = time.perf_counter()
    params = model_mod.init_params(cfg, seed=0, device=DEV)
    draw_ssm(params, seed=1)
    torch.cuda.synchronize()
    print(f"init: mamba2-130m full width, "
          f"{sum(p.numel() for p in params.parameters()) / 1e6:.2f} M "
          f"params, {torch.cuda.memory_allocated() / 2**30:.3f} GiB, in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return cfg, params


def _ssd_flops(B: int, S: int, cfg) -> float:
    """The SSD's products in a prefill of B rows of S tokens, as the port
    computes them (chunks of ``chunk_size``, or one chunk): C.B once a
    chunk (shared by the heads), the decay-weighted product with x, the
    chunk states and their readout."""
    s = cfg.ssm
    h, p, n = s.num_heads(cfg.d_model), s.head_dim, s.d_state
    ch = min(s.chunk_size, S)
    ch = ch if S % ch == 0 else S
    per_chunk = 2 * (ch * ch * n + h * ch * ch * p + 2 * h * ch * p * n)
    return float(per_chunk * (S // ch) * B * cfg.num_layers)


def profile_mamba2() -> None:
    """profile-mamba2: in one ``marked_window``, a 4 x 4096 prefill call
    (lens 4096,
    3900, 2100, 300) through the model layer, eagerly, and 8 replays of a
    graphed decode stage of 4 slots; the window must hold every marker.
    Prints the prefill's device time and the ``ssm`` (mixers) and ``ssd``
    (scans) spans' shares of it, and the decode step's device time and
    device activities, each beside its bound: the prefill's products (the
    projections and the SSD) at 989 TFLOP/s, the step's bytes (the
    weights and 4 slots' state read and written) at 3.35 TB/s."""
    cfg, params = init_mamba2()
    label = "profile-mamba2"
    lens = (4096, 3900, 2100, 300)
    B, S = len(lens), max(lens)
    gen = torch.Generator(device=DEV).manual_seed(8)
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                         device=DEV, dtype=torch.int32)
    lens_t = torch.tensor(lens, device=DEV)
    valid = torch.arange(S, device=DEV)[None, :] < lens_t[:, None]
    caches = model_mod.init_caches(cfg, B, MAMBA2_KW["max_len"], DEV)
    eng = InferenceEngine(cfg, params, **MAMBA2_KW)
    run = eng.executor.get("decode", (eng.precision,), eng._build_decode)
    step_in = {"tokens": np.zeros((B, 1), np.int32),
               "pos": np.array(MAMBA2_DECODE_POS, np.int32),
               "active": np.ones(B, bool)}
    run(step_in)                        # the eager warm-up, then the capture
    run(step_in)
    replay = run.variants[None].graph.replay

    @torch.inference_mode()
    def prefill():
        x, _ = model_mod.forward(params, cfg, {"tokens": toks},
                                 mode="prefill", caches=caches,
                                 kv_valid=valid)
        return model_mod.greedy_next(
            params, cfg, x[torch.arange(B, device=DEV), lens_t - 1])

    prefill()
    replay()
    torch.cuda.synchronize()
    steps = 8
    calls = [prefill] + [replay] * steps
    prof, events, pairs = marked_window(calls)
    if pairs is None:
        raise AssertionError(f"{label}: the window lost marker kernels, and "
                             f"with them device activities")
    ms = [sum(e.time_range.elapsed_us() for e in events[a + 1:b]) / 1e3
          for a, b in pairs]
    count = [b - a - 1 for a, b in pairs]
    spans, ssm_ms = _span_ms(prof, ssm_mod.SSM_SPAN)
    scans, ssd_ms = _span_ms(prof, ssm_mod.SSD_SPAN)
    if spans != cfg.num_layers or scans != cfg.num_layers or not ssm_ms:
        raise AssertionError(f"{label}: {spans} ssm and {scans} ssd spans "
                             f"({ssm_ms:.3f} ms) for {cfg.num_layers} layers")
    proj = sum(m.numel() for b in params.layers
               for m in (b.ssm.in_proj, b.ssm.out_proj))
    head = 2.0 * B * params.embed.numel()      # the greedy head, last tokens
    flops = 2.0 * B * S * proj + _ssd_flops(B, S, cfg) + head
    wbytes = sum(t.numel() * t.element_size() for t in params.parameters())
    pre_bound, pre_by = bound(flops, wbytes, torch.bfloat16)
    sbytes = _state_bytes(eng)
    step_bound, step_by = bound(2.0 * B * proj + head, wbytes + 2 * sbytes,
                                torch.bfloat16)
    step_ms = sum(ms[1:]) / steps
    print(f"{label}: eager prefill {B}x{S} (lens {list(lens)}): device "
          f"{ms[0]:.3f} ms over {count[0]} activities (bound "
          f"{pre_bound:.3f} ms by {pre_by}: {flops / 1e12:.3f} TFLOP, of "
          f"which the SSD {_ssd_flops(B, S, cfg) / 1e12:.3f}; "
          f"{ms[0] / pre_bound:.1f}x); the ssm spans {ssm_ms:.3f} ms "
          f"({100 * ssm_ms / ms[0]:.1f}%), the ssd spans {ssd_ms:.3f} ms "
          f"({100 * ssd_ms / ms[0]:.1f}%)", flush=True)
    print(f"{label}: graphed decode step, {B} rows: device {step_ms:.4f} ms "
          f"(min {min(ms[1:]):.4f}) over {count[1]} activities (bound "
          f"{step_bound:.4f} ms by {step_by}: {wbytes / 1e9:.4f} GB of "
          f"weights, {sbytes / 1e6:.2f} MB of state read and written; "
          f"{step_ms / step_bound:.1f}x); all {2 * len(calls)} markers in "
          f"the window", flush=True)
    del eng, caches, params
    _free_card()


def phase_mamba2() -> None:
    """check-mamba2, then full-width mamba2-130m (``init_mamba2``):
    check-mamba2-block on its first 4 layers, serve-mamba2,
    serve-eager-mamba2, serve-mamba2-chunked (512), serve-mamba2-long.
    No kernel runs on its path; frees the weights."""
    phase_check_mamba2()
    cfg, params = init_mamba2()
    check_ssm_block("check-mamba2-block", cfg, params)
    _free_card()
    launches, outputs, eng, p50 = phase_serve_mamba2(cfg, params)
    nbytes = _state_bytes(eng)
    phase_serve_eager("serve-eager-mamba2", eng, launches, outputs, cfg,
                      params, engine_kw=MAMBA2_KW,
                      trace=lambda: mamba2_requests(cfg.vocab_size),
                      decode_pos=MAMBA2_DECODE_POS, identical=True)
    del eng
    _free_card()
    _, _, eng, _ = phase_serve_mamba2(cfg, params, "serve-mamba2-chunked",
                                      outputs, prefill_chunk=512)
    del eng
    _free_card()
    phase_serve_mamba2_long(cfg, params, nbytes, p50)
    del params
    _free_card()
    print(f"freed mamba2-130m: {torch.cuda.memory_allocated() / 2**30:.2f} "
          f"GiB still allocated", flush=True)


# ---- training ---------------------------------------------------------------

# train-mamba2: the launcher at its default arch, at the published widths,
# at lr 1e-3: at the launcher's default 3e-3 the full-width loss rises
# (10.8457 -> 11.1228 over 40 steps on the H100, where 1e-3 falls to
# 10.5996 and 3e-4 to 10.6530: scripts/torch_train_lr.py)
TRAIN_MAMBA2_ARGV = ["--arch", "mamba2-130m", "--full-config", "--steps",
                     "40", "--batch", "8", "--seq", "128", "--lr", "1e-3",
                     "--ckpt-every", "20", "--log-every", "1",
                     "--device", DEV]
TRAIN_MAMBA2_CKPT = 20
# the mean of its last 5 losses must sit this many nats below its first,
# fixed before the first run (scripts/torch_train_lr.py on the host at
# d_model 128, 2 layers and the full 50280-token vocabulary: 0.4169)
TRAIN_MAMBA2_MARGIN = 0.1
# train-gemma2b: examples/train_lm.py's settings (the default lr 3e-3), no
# checkpoint
TRAIN_GEMMA2B_ARGV = ["--arch", "gemma-2b", "--full-config", "--steps",
                      "10", "--batch", "8", "--seq", "64", "--accum", "2",
                      "--ckpt-every", "1000", "--log-every", "1",
                      "--device", DEV]
# ... its loss falls where it can in 10 steps: one more step's own batch
# must lose this many nats from the step's update, fixed before the first
# run. The streamed loss cannot: every batch of a 256000-token vocabulary
# is new tokens (it stays within 0.01 of 12.48 at lr 3e-4 and rises 0.20
# at 3e-3, where a step's own batch falls 1.94: scripts/torch_train_lr.py)
TRAIN_GEMMA2B_DESCENT = 0.1
# the child process that resumes train-mamba2 from its checkpoint
TRAIN_RESUME = "--train-resume"
# check-train: one reduced f32 config per block kind, the card against the
# host; step 1's loss and gradients within the port's f32 tolerance (2e-3
# relative + 1e-5), the losses of steps 2-3 within 1e-3 relative, fixed
# before the first run
CHECK_TRAIN_ARCHS = ("deepseek-7b", "gemma2-27b", "recurrentgemma-9b",
                     "mamba2-130m", "dbrx-132b", "whisper-medium",
                     "qwen2-vl-7b")
TRAIN_RTOL, TRAIN_ATOL, TRAIN_STEPS_RTOL = 2e-3, 1e-5, 1e-3
# the final norm's multiplier in check-train: logits of ~10 standard
# deviations, where the z-term moves the loss and the head's gradients by
# more than the tolerance (at init's small logits it moves them ~1e-3)
TRAIN_LOGIT_SCALE = 20.0
TRAIN_FAULTS = ("attention through the kernel", "z-term dropped")


def _train_args(argv, ckpt_dir: str, resume: bool = False):
    return train_launcher._parser().parse_args(
        argv + ["--ckpt-dir", ckpt_dir] + (["--resume"] if resume else []))


def _train_summary(label: str, recs: list) -> dict:
    """The train line's entry of a run: steps, the median device time a
    step past the first, first and last loss, the peak."""
    later = [r["device_ms"] for r in recs[1:]] or [recs[0]["device_ms"]]
    return {"phase": label, "steps": len(recs),
            "ms_per_step": float(np.median(later)),
            "first_loss": recs[0]["loss"], "last_loss": recs[-1]["loss"],
            "peak_gib": max(r["peak_gib"] for r in recs)}


def _finite_losses(label: str, recs: list) -> None:
    bad = [(r["step"], r["loss"], r["grad_norm"]) for r in recs
           if not (math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]))]
    if bad:
        raise AssertionError(f"{label}: non-finite steps {bad}")


def _saved_leaves(ckpt_dir: str, step: int) -> dict:
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "index.json")) as f:
        index = json.load(f)["leaves"]
    return {k: np.load(os.path.join(path, m["file"])) for k, m in index.items()}


def phase_train_mamba2() -> list:
    """train-mamba2: the launcher's loop (``setup``, then ``train``) on
    full-width mamba2-130m in f32, 40 steps of 8 x 128 tokens, a
    checkpoint at step 20; then ``--resume`` in a child process, which
    must restore the saved bits and reach step 39. No kernel launches."""
    ckpt_dir = tempfile.mkdtemp(prefix="train_mamba2_")
    try:
        _zero_launches()
        args = _train_args(TRAIN_MAMBA2_ARGV, ckpt_dir)
        tr = train_launcher.setup(args)
        n = sum(p.numel() for p in tr.model.parameters())
        print(f"train-mamba2: {n / 1e6:.2f} M f32 params, "
              f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB with Adam's "
              f"state; {card_line()}", flush=True)
        recs = train_launcher.train(tr, args)
        _require_no_launch("train-mamba2", _launch_counts())
        _finite_losses("train-mamba2", recs)
        summary = _train_summary("train-mamba2", recs)
        losses = [r["loss"] for r in recs]
        tail = float(np.mean(losses[-5:]))
        print(f"train-mamba2: loss {losses[0]:.4f} -> mean of the last 5 "
              f"{tail:.4f} (must fall {TRAIN_MAMBA2_MARGIN}); "
              f"{summary['ms_per_step']:.3f} ms a step on the device, peak "
              f"{summary['peak_gib']:.2f} GiB", flush=True)
        if tail > losses[0] - TRAIN_MAMBA2_MARGIN:
            raise AssertionError(f"train-mamba2: loss did not fall: "
                                 f"{losses[0]:.4f} -> {tail:.4f}")
        if tr.mgr.all_steps() != [TRAIN_MAMBA2_CKPT]:
            raise AssertionError(f"train-mamba2: checkpoints "
                                 f"{tr.mgr.all_steps()}")
        saved = _saved_leaves(ckpt_dir, TRAIN_MAMBA2_CKPT)
        if set(saved) != set(tr.model.state_dict()):
            raise AssertionError("train-mamba2: the checkpoint's leaves are "
                                 "not the model's parameters")
        print(f"train-mamba2: step {TRAIN_MAMBA2_CKPT}'s checkpoint holds "
              f"all {len(saved)} parameters", flush=True)
        del tr
        _free_card()
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              TRAIN_RESUME, ckpt_dir], capture_output=True,
                             text=True, timeout=600)
        print(out.stdout, end="", flush=True)
        if out.returncode:
            raise AssertionError(f"train-mamba2 resume exited "
                                 f"{out.returncode}: {out.stderr[-3000:]}")
        resumed = json.loads(out.stdout.strip().splitlines()[-1])["resume"]
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    return [summary, resumed]


def train_resume(ckpt_dir: str) -> None:
    """The child of train-mamba2: ``--resume`` through the launcher's
    ``setup``, every restored parameter equal to its saved ``.npy`` bits,
    then ``train`` from step 20 (which runs again, as in the reference) to
    39, every loss finite and no kernel launched. Its last line is the
    train line's entry."""
    args = _train_args(TRAIN_MAMBA2_ARGV, ckpt_dir, resume=True)
    tr = train_launcher.setup(args)
    if tr.start != TRAIN_MAMBA2_CKPT:
        raise AssertionError(f"resumed from step {tr.start}")
    saved = _saved_leaves(ckpt_dir, tr.start)
    state = tr.model.state_dict()
    for k, arr in saved.items():
        got = state[k].cpu().numpy()
        if got.dtype != arr.dtype or not np.array_equal(
                got.view(np.uint8), arr.view(np.uint8)):
            raise AssertionError(f"resume: {k} differs from its saved bits")
    print(f"train-mamba2 resume: all {len(saved)} parameters equal the "
          f"saved bits", flush=True)
    recs = train_launcher.train(tr, args)
    _require_no_launch("train-mamba2 resume", _launch_counts())
    _finite_losses("train-mamba2 resume", recs)
    steps = [r["step"] for r in recs]
    if steps != list(range(TRAIN_MAMBA2_CKPT, args.steps)):
        raise AssertionError(f"resume ran steps {steps}")
    print(json.dumps({"resume": _train_summary("train-mamba2-resume",
                                               recs)}), flush=True)


def _padded_wo_rows(model, cfg) -> float:
    """The largest |w| of the padded heads' ``wo`` rows over the layers."""
    return max(layer.attn.wo[cfg.num_heads:].abs().max().item()
               for layer in model.layers)


def phase_train_gemma2b() -> dict:
    """train-gemma2b: full-width gemma-2b in f32 (16 heads, 8 of them
    padding) through the launcher's loop with ``examples/train_lm.py``'s
    settings (8 x 64 tokens, 2 microbatches), 10 steps, no checkpoint;
    then one more step on a new batch, whose own loss must fall by
    ``TRAIN_GEMMA2B_DESCENT``. Prints the measured step beside a rough
    bound (6 x params x tokens f32 operations at 67 TFLOP/s, and Adam's
    bytes: parameters, gradients and both moments read, three written) and
    whether the padded heads' ``wo`` rows are still zero (the reference
    masks no gradient of theirs)."""
    ckpt_dir = tempfile.mkdtemp(prefix="train_gemma2b_")
    try:
        _zero_launches()
        args = _train_args(TRAIN_GEMMA2B_ARGV, ckpt_dir)
        tr = train_launcher.setup(args)
        n = sum(p.numel() for p in tr.model.parameters())
        print(f"train-gemma2b: {n / 1e9:.3f} B f32 params, "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB with Adam's "
              f"state; {card_line()}", flush=True)
        wo0 = _padded_wo_rows(tr.model, tr.cfg)
        recs = train_launcher.train(tr, args)
        _finite_losses("train-gemma2b", recs)
        data = lm_token_batches(tr.cfg.vocab_size, args.batch, args.seq,
                                seed=train_launcher.DATA_SEED)
        for _ in range(args.steps):
            next(data)
        batch = stage(next(data), DEV)
        with torch.no_grad():
            before = model_mod.loss_fn(tr.model, tr.cfg, batch)[0].item()
        step = make_train_step(tr.cfg, tr.opt_cfg, accum_steps=args.accum,
                               remat=False)
        tr.opt_state, _ = step(tr.model, tr.opt_state, batch)
        with torch.no_grad():
            after = model_mod.loss_fn(tr.model, tr.cfg, batch)[0].item()
        _require_no_launch("train-gemma2b", _launch_counts())
        summary = _train_summary("train-gemma2b", recs)
        tokens = args.batch * args.seq
        bound_ms = (6 * n * tokens / PEAK_FLOPS[torch.float32]
                    + 7 * 4 * n / HBM_BYTES_PER_S) * 1e3
        wo = _padded_wo_rows(tr.model, tr.cfg)
        print(f"train-gemma2b: streamed loss {recs[0]['loss']:.4f} -> "
              f"{recs[-1]['loss']:.4f}; a new batch's own step "
              f"{before:.4f} -> {after:.4f} (must fall "
              f"{TRAIN_GEMMA2B_DESCENT}); {summary['ms_per_step']:.3f} ms a "
              f"step on the device against a rough {bound_ms:.1f} ms "
              f"bound; peak {summary['peak_gib']:.2f} GiB; the padded "
              f"heads' wo rows: max |w| {wo0:.3e} at init, {wo:.3e} now "
              f"({'still zero' if wo == 0 else 'trained, as the reference'})",
              flush=True)
        if before - after < TRAIN_GEMMA2B_DESCENT:
            raise AssertionError(f"train-gemma2b: a step's own loss fell "
                                 f"{before - after:.4f}")
        summary.update(bound_ms=bound_ms, own_step=[before, after])
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    del tr
    _free_card()
    return summary


def _check_train_model(cfg, device):
    """check-train's weights: seed 0, every all-zero leaf drawn N(0, 0.1),
    the final norm scaled by ``TRAIN_LOGIT_SCALE``; gradients on."""
    model = model_mod.init_params(cfg, 0, "cpu")
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in model.parameters():
            if not p.any():
                p.copy_(torch.randn(p.shape, generator=gen) * 0.1)
        model.final_norm.scale.fill_(TRAIN_LOGIT_SCALE - 1.0)
    return model.to(device).requires_grad_(True)


def _train_batch(cfg, rng, B: int = 4, S: int = 16) -> dict:
    """Tokens, or (qwen2-vl) embeddings at distinct (t, h, w) positions,
    and labels; whisper's stub frames; numpy."""
    b = {"labels": rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)}
    if cfg.encdec is not None:
        b["enc_embeds"] = (rng.standard_normal((B, 24, cfg.d_model))
                           * 0.1).astype(np.float32)
    if cfg.input_kind == "embeddings" and cfg.encdec is None:
        b["embeds"] = (rng.standard_normal((B, S, cfg.d_model))
                       * 0.1).astype(np.float32)
        t = np.arange(S)
        b["positions"] = np.stack([np.broadcast_to(p, (B, S)) for p in
                                   (t // 4, t % 4 + 3, (t * 7) % 5 + 1)]
                                  ).astype(np.int32)
    else:
        b["tokens"] = rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)
    return b


def _loss_and_grads(model, cfg, batch, device):
    tb = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    loss, _ = model_mod.loss_fn(model, cfg, tb)
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return loss.item(), {n: (torch.zeros_like(p) if g is None else g).cpu()
                         for n, p, g in zip(names, params, grads)}


def _train_run(cfg, device, batches, fault=None):
    """(step 1's loss, its gradients, the losses of 3 Adam steps) of
    check-train's model on ``device``, under ``fault``."""
    model = _check_train_model(cfg, device)
    opt_cfg = OptConfig(name="adam", lr=1e-3)
    with _train_fault(fault):
        loss, grads = _loss_and_grads(model, cfg, batches[0], device)
        step = make_train_step(cfg, opt_cfg, accum_steps=1, remat=False)
        state = init_opt_state(dict(model.named_parameters()), opt_cfg)
        losses = []
        for b in batches:
            state, m = step(model, state, b)
            losses.append(m["loss"].item())
    return loss, grads, losses


def _attention_through_kernel(p, x, cfg, positions, kv_valid=None, *, kind,
                              causal=True):
    """A fault: the training attention through the flash kernel, past its
    grad guard (under ``no_grad``), so q, k and v get no gradient."""
    q, k, v = attn_mod._project_qkv(p, x, cfg, positions)
    lens = None if kv_valid is None else kv_valid.sum(-1).to(torch.int32)
    with torch.no_grad():
        o = flash_attn(q.contiguous(), k.contiguous(), v.contiguous(), lens,
                       causal=causal,
                       window=cfg.window_size if kind == attn_mod.ATTN_LOCAL
                       else 0,
                       softcap=cfg.attn_logit_softcap or 0.0)
    return attn_mod._out_proj(p, o)


_LM_HEAD_LOSS = vocab_mod.lm_head_loss


def _lm_loss_without_z(x, table, labels, cfg, mask=None):
    """A fault: the loss's z-term dropped."""
    loss, z = _LM_HEAD_LOSS(x, table, labels, cfg, mask)
    return loss, torch.zeros_like(z)


def _train_fault(fault):
    if fault == TRAIN_FAULTS[0]:
        return _patched(attn_mod, {"dense_attention":
                                   _attention_through_kernel})
    if fault == TRAIN_FAULTS[1]:
        return _patched(vocab_mod, {"lm_head_loss": _lm_loss_without_z})
    return contextlib.nullcontext()


def _train_errors(host, card) -> tuple:
    """(step 1's loss and gradients: the worst error in units of its bound,
    2e-3 relative + 1e-5; the worst relative loss error of steps 2-3)."""
    (lh, gh, sh), (lc, gc, sc) = host, card
    worst = abs(lc - lh) / (TRAIN_RTOL * abs(lh) + TRAIN_ATOL)
    for k, g in gh.items():
        err = (gc[k] - g).abs() / (TRAIN_RTOL * g.abs() + TRAIN_ATOL)
        worst = max(worst, err.max().item())
    steps = max(abs(c - h) / abs(h) for c, h in zip(sc[1:], sh[1:]))
    return worst, steps


def phase_check_train() -> dict:
    """check-train: for one reduced f32 config per block kind, the same
    weights and 3 batches through ``loss_fn`` and 3 Adam steps on the card
    and on the host; step 1's loss and every gradient within 2e-3 relative
    + 1e-5, the losses of steps 2-3 within 1e-3 relative. Each planted
    fault (``TRAIN_FAULTS``, on deepseek-7b) must land past those bounds.
    A direct flash call on CUDA inputs that require grad must raise. No
    kernel launches on the honest runs."""
    t0 = time.perf_counter()
    _zero_launches()
    rows = []
    for arch in CHECK_TRAIN_ARCHS:
        cfg = reduce_for_smoke(get_config(arch))
        rng = np.random.default_rng(5)
        batches = [_train_batch(cfg, rng) for _ in range(3)]
        host = _train_run(cfg, "cpu", batches)
        card = _train_run(cfg, DEV, batches)
        worst, steps = _train_errors(host, card)
        rows.append((arch, host[2], worst, steps))
        print(f"check-train {arch}: losses {[round(l, 4) for l in card[2]]} "
              f"(host {[round(l, 4) for l in host[2]]}); step 1 "
              f"{worst:.3f} of its bound, steps 2-3 {steps:.2e} relative",
              flush=True)
        if worst > 1 or steps > TRAIN_STEPS_RTOL:
            raise AssertionError(f"check-train {arch}: card vs host past "
                                 f"the bounds ({worst:.3f}, {steps:.2e})")
    _require_no_launch("check-train", _launch_counts())
    cfg = reduce_for_smoke(get_config("deepseek-7b"))
    rng = np.random.default_rng(5)
    batches = [_train_batch(cfg, rng) for _ in range(3)]
    host = _train_run(cfg, "cpu", batches)
    faults = {}
    for fault in TRAIN_FAULTS:
        worst, steps = _train_errors(host, _train_run(cfg, DEV, batches,
                                                      fault))
        faults[fault] = worst
        print(f"check-train fault '{fault}': step 1 {worst:.3f} of its "
              f"bound, steps 2-3 {steps:.2e}", flush=True)
        if worst <= 1 and steps <= TRAIN_STEPS_RTOL:
            raise AssertionError(f"check-train: the fault '{fault}' held "
                                 f"within the bounds")
    q, k, v = (torch.randn(1, 8, 2, 16, device=DEV, requires_grad=True)
               for _ in range(3))
    try:
        flash_attn(q, k, v)
    except ValueError as e:
        print(f"check-train: flash_attn refuses inputs that require grad: "
              f"{e}", flush=True)
    else:
        raise AssertionError("check-train: flash_attn took inputs that "
                             "require grad")
    return {"phase": "check-train", "steps": 3 * len(CHECK_TRAIN_ARCHS),
            "archs": len(rows), "worst_step1": max(r[2] for r in rows),
            "worst_steps23": max(r[3] for r in rows), "faults": faults,
            "seconds": time.perf_counter() - t0}


def phase_train() -> list:
    """check-train, train-mamba2 (and its resume), train-gemma2b; returns
    the train line's entries."""
    out = [phase_check_train()]
    out += phase_train_mamba2()
    out.append(phase_train_gemma2b())
    return out


# ---- dbrx-132b --------------------------------------------------------------

# the served cut (the launcher's ``CARD_CUTS``): the first 8 of dbrx-132b's
# 40 layers at full width (27.31 B parameters, 54.6 GB in bf16; all 40
# take ~264 GB, past one card)
DBRX_LAYERS = serve_launcher.CARD_CUTS["dbrx-132b"][1]
# 4 slots of 4608 positions (the 8 layers' K/V, 0.60 GB); the bucket
# ladder reaches the longest prompt
DBRX_KW = dict(batch_slots=4, max_len=4608,
               prefill_buckets=(128, 256, 512, 1024, 2048, 4096), device=DEV)
# the long prompts of the serve phases and of the kernel and profile cases,
# and the decode positions of the kernel cases and the decode stage calls
DBRX_PROMPTS = (4096, 3900, 2100, 300)
DBRX_DECODE_POS = (4095, 3000, 1200, 31)
# dbrx-132b's attention projections (K, N): wq and wo (6144 -> 48 x 128 =
# 6144), wk and wv (6144 -> 8 x 128); the experts are not w8a8 sites
DBRX_PROJECTIONS = ((6144, 6144), (6144, 1024))
# check-dbrx-layers: the prompts, the longest row last (entries rank in
# token order and the pads of a right-padded row route too, so the drops
# land on the last rows' tokens: with the longest row first they fell on
# pads alone in a rehearsal on the host), and the bound on the worst real
# token's ||block - dense|| / ||dense - x|| over each layer (fixed before
# the first chip run)
DBRX_LAYERS_LENS = (1, 257, 700, 1024)
MOE_LAYERS_TOL = 0.02
# check-dbrx's bf16 leg: the share of tokens whose top-k may differ
# between the card and the host (bf16 rounding moves near-tied routes)
MOE_ROUTE_FLIPS = 0.02
MOE_FAULTS = {"renorm": "top-k weights not renormalised",
              "capacity": "capacity x4 (T at most)",
              "lcfs": "drops last come, first served",
              "act": "act(u)*g in place of act(g)*u"}


# command-r-plus's attention (ROADMAP A4's next config): 96 query heads
# over 8 kv heads (G 12: 10 positions and 8 pad rows a 128-row tile),
# head_dim 128
CMDR_HEADS = (96, 8, 128)
# flash's tensor-core kernel at every kind of G up to its 128-row tile:
# G that leave pad rows (3, 5, 6, 7, 12, 24, 48, 96) and 128 (one position
# a tile), each at head_dim 64, 128 and 256; S 131 is no multiple of a
# tile's 128 // G positions wherever a tile holds more than one
FLASH_G_SWEEP = (3, 5, 6, 7, 12, 24, 48, 96, 128)
FLASH_G_SWEEP_S = 131


def _w8a8_rows(fns: dict, routes: dict, gen, prefix: str, projections,
               rows) -> None:
    """w8a8 at ``projections`` (K, N) for each (M, row) of ``rows``, each
    held bit for bit against its plain version and timed beside
    ``torch._int_mm``; M <= 16 must run the split-K kernel, more the TMA
    one."""
    for M, row in rows:
        for K, N in projections:
            name = f"{prefix}_{row}_M{M}_K{K}_N{N}"
            r = w8a8_case(name, gen, M, K, N)
            _show("w8a8_matmul", name, r)
            fns["w8a8_matmul " + name] = r["call"]
            fns["torch._int_mm + scales " + name] = r["library_call"]
            routes["w8a8_matmul " + name] = (
                "w8a8_splitk_kernel" if M <= 16 else "w8a8_kernel_tma",
                "w8a8_kernel<")


def _decode_rows(fns: dict, gen, prefix: str, heads, row: str) -> None:
    """Both decode kernels at B 4, S 4608, pos ``DBRX_DECODE_POS`` over
    ``heads`` (H, K, hd) in bf16: rows 2``row`` (beside SDPA) and
    3``row``."""
    H, K, hd = heads
    case = (4, H, K, hd, 4608, list(DBRX_DECODE_POS), torch.bfloat16)
    name = f"{prefix}_2{row}_B4_S4608_H{H}_K{K}_hd{hd}"
    r = decode_case(name, gen, *case)
    _show("decode_attn", name, r)
    fns["decode_attn " + name] = r["call"]
    fns["SDPA " + name] = r["library_call"]
    name = f"{prefix}_3{row}_B4_S4608_H{H}_K{K}_hd{hd}"
    r = decode_int8_case(name, gen, *case)
    _show("decode_attn_int8", name, r)
    fns["decode_attn_int8 " + name] = r["call"]


def dbrx_kernel_cases() -> None:
    """The kernels at dbrx-132b's served shapes (bf16, 48 query heads over
    8 kv heads: G 6, head_dim 128), each held against its plain version
    and timed beside its library call and its bound: flash's prefill of a
    4096 bucket with lens ``DBRX_PROMPTS`` (1e) and its chunk call, 4 x
    512 in place over a 4 x 4608 cache at offsets 3584, 2048, 512, 0
    (1e'), beside SDPA with a boolean mask, both on the tensor-core
    ``flash_fwd_kernel_tma`` (21 positions, 126 real rows and 2 pad rows a
    128-row tile); both decode kernels at B 4, S 4608, pos
    ``DBRX_DECODE_POS`` (2e bf16 beside SDPA, 3e int8; a warp's pass of 8
    heads holds 6); w8a8 at the attention projections at M 4 (4e, the
    split-K kernel) and 16384, a 4 x 4096 prefill (4e', the TMA kernel),
    beside ``torch._int_mm``; flash at command-r-plus's heads
    (``CMDR_HEADS``, G 12) on the same prefill (1cr) and chunk call (1cr')
    shapes, their heads held distinct; ``flash_g_sweep``'s cases. Then one
    profiler window of their device times, which must name the kernel
    each flash and w8a8 case ran. Their inputs come from generators of
    their own, so that every other case keeps its inputs."""
    gen = torch.Generator(device=DEV).manual_seed(34)
    bf16 = torch.bfloat16
    fns, routes = {}, {}
    name = "dbrx_1e_B4_S4096_H48_K8_hd128"
    r = flash_case(name, gen, 4, 4096, 48, 8, 128, bf16, list(DBRX_PROMPTS))
    _show("flash_attn", name, r)
    fns["flash_attn " + name] = r["call"]
    fns["SDPA (boolean mask) " + name] = r["library_call"]
    routes["flash_attn " + name] = tma_route(128)
    name = "dbrx_1e'_chunk_P4_C512_T4608_H48_K8_hd128"
    r = flash_chunk_case(name, gen, 4, 4608, 48, 8, 128, 512, bf16,
                         slots=[0, 1, 2, 3], start=[3584, 2048, 512, 0],
                         lengths=[512] * 4, measure=True)
    _show("flash_attn", name, r)
    fns["flash_attn " + name] = r["call"]
    fns["SDPA (boolean mask) " + name] = r["library_call"]
    routes["flash_attn " + name] = tma_route(128)
    _decode_rows(fns, gen, "dbrx", (48, 8, 128), "e")
    _w8a8_rows(fns, routes, gen, "dbrx", DBRX_PROJECTIONS,
               rows=((4, "4e"), (16384, "4e'")))
    H, K, hd = CMDR_HEADS
    name = f"cmdr_1cr_B4_S4096_H{H}_K{K}_hd{hd}"
    # the plain version over two halves of the kv heads: its whole f32
    # score matrix, 26 GB here, is made three times over
    r = flash_case(name, gen, 4, 4096, H, K, hd, bf16, list(DBRX_PROMPTS),
                   distinct=True, ref_parts=2)
    _show("flash_attn", name, r)
    fns["flash_attn " + name] = r["call"]
    fns["SDPA (boolean mask) " + name] = r["library_call"]
    routes["flash_attn " + name] = tma_route(128)
    name = f"cmdr_1cr'_chunk_P4_C512_T4608_H{H}_K{K}_hd{hd}"
    r = flash_chunk_case(name, gen, 4, 4608, H, K, hd, 512, bf16,
                         slots=[0, 1, 2, 3], start=[3584, 2048, 512, 0],
                         lengths=[512] * 4, measure=True, distinct=True)
    _show("flash_attn", name, r)
    fns["flash_attn " + name] = r["call"]
    fns["SDPA (boolean mask) " + name] = r["library_call"]
    routes["flash_attn " + name] = tma_route(128)
    flash_g_sweep(fns, routes)
    device_window(fns, routes=routes)


def flash_g_sweep(fns: dict, routes: dict) -> None:
    """Flash's tensor-core kernel over ``FLASH_G_SWEEP`` at head_dim 64,
    128 and 256 (B 2, S ``FLASH_G_SWEEP_S``, lens (S, 77), 2 kv heads up
    to G 48, 1 past it), then at G's that leave pad rows: an empty row
    (lens 0), a window, a live softcap (q x16), non-causal, chunks at
    offsets off the tile, and a kv row outside the cache (0 for that row
    alone). Each is held against the plain version (2e-2), with every head
    of a group distinct, and added to ``fns`` with the route its window
    must name in ``routes``: ``flash_fwd_kernel_tma<hd, ...>``, and for
    bf16 at head_dim 32, G 6, the CUDA-core ``flash_fwd_kernel``. One
    window checks them all: late in a process the profiler has returned
    empty traces (2 of 35 one-case traces on an H100)."""
    gen = torch.Generator(device=DEV).manual_seed(35)
    bf16 = torch.bfloat16
    S = FLASH_G_SWEEP_S

    def add(name, call, route):
        fns["flash_attn " + name] = call
        routes["flash_attn " + name] = route
    worst = 0.0
    for G in FLASH_G_SWEEP:
        K = 2 if G <= 48 else 1
        for hd in (64, 128, 256):
            name = f"sweep_G{G}_hd{hd}_B2_S{S}_K{K}"
            r = flash_case(name, gen, 2, S, G * K, K, hd, bf16, [S, 77],
                           distinct=True)
            worst = max(worst, r["max_abs_err"])
            add(name, r["call"], tma_route(hd))
    print(f"flash_attn: G sweep {list(FLASH_G_SWEEP)} x hd (64, 128, 256), "
          f"worst max abs err {worst:.3e}", flush=True)
    for name, (Sq, G, K, hd, lens, kw) in {
            "G6_hd128_lens0": (S, 6, 2, 128, [0, 97], {}),
            "G12_hd64_window50": (300, 12, 2, 64, [300, 211],
                                  {"window": 50}),
            "G5_hd256_softcap30_q16": (S, 5, 2, 256, None,
                                       {"softcap": 30.0}),
            "G24_hd128_noncausal": (77, 24, 2, 128, [77, 40],
                                    {"causal": False}),
    }.items():
        r = flash_case(name, gen, 2, Sq, G * K, K, hd, bf16, lens,
                       q_scale=SOFTCAP_Q_SCALE if "softcap" in kw else 1.0,
                       distinct=True, **kw)
        _show("flash_attn", name, r)
        add(name, r["call"], tma_route(hd))
    for name, (Bk, T, G, K, hd, C, slots, start, lengths) in {
            "chunk_G6_hd128_off_tile_C100_T500": (
                3, 500, 6, 2, 128, 100, [2, 0], [337, 61], [100, 77]),
            "chunk_G12_hd256_off_tile_C64_T300": (
                2, 300, 12, 1, 256, 64, [1, 0], [201, 65], [64, 50]),
    }.items():
        r = flash_chunk_case(name, gen, Bk, T, G * K, K, hd, C, bf16, slots,
                             start, lengths, measure=True, distinct=True)
        _show("flash_attn", name, r)
        add(name, r["call"], tma_route(hd))
    call, = flash_bad_row(gen, cases=((bf16, 128, 6),))
    add("bad_kv_row_G6_hd128", call, tma_route(128))
    name = f"G6_hd32_B2_S{S}_cuda_cores"
    r = flash_case(name, gen, 2, S, 12, 2, 32, bf16, [S, 77], distinct=True)
    _show("flash_attn", name, r)
    add(name, r["call"], ("flash_fwd_kernel<__nv_bfloat16, 32>",
                          "flash_fwd_kernel_tma"))


def reduce_dbrx(dtype: str, factor: float = 1.25):
    """check-dbrx's configs at capacity factor ``factor``: in f32
    ``reduce_for_smoke`` (2 layers of d_model 64, 4 heads over 4 kv heads
    of 16, 4 experts top-2 of d_expert 32); in bf16 2 layers of d_model
    256, 12 heads over 2 kv heads of 64 (G 6) and dbrx's 16 experts top-4
    at d_expert 512. Vocab 256, untied."""
    cfg = get_config("dbrx-132b")
    small = reduce_for_smoke(cfg)
    if dtype != "float32":
        small = dataclasses.replace(
            small, d_model=256, num_heads=12, num_kv_heads=2, head_dim=64,
            moe=dataclasses.replace(cfg.moe, d_expert=512),
            param_dtype=dtype, activation_dtype=dtype)
    return dataclasses.replace(small, moe=dataclasses.replace(
        small.moe, capacity_factor=factor))


def draw_norms(params, seed: int, leaves=("scale",)) -> None:
    """Draw every leaf named in ``leaves`` (by default the norms' scales;
    a LayerNorm's ``bias`` too where asked) in place, N(0, 0.3^2) from a
    seeded generator on the parameters' device: at init they are 0, where
    a port that dropped one agrees with one that keeps it. The router is
    drawn at init (normal, nonzero)."""
    dev = model_mod.model_device(params)
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        for name, t in params.named_parameters():
            if name.rsplit(".", 1)[-1] in leaves:
                t.copy_((0.3 * torch.randn(t.shape, generator=gen,
                                           device=dev)).to(t.dtype))


@contextlib.contextmanager
def _patched(mod, attrs: dict):
    """Within: ``mod``'s attributes named in ``attrs`` set to its values;
    restored after."""
    saved = {k: getattr(mod, k) for k in attrs}
    for k, v in attrs.items():
        setattr(mod, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(mod, k, v)


@contextlib.contextmanager
def _counting_drops():
    """Within: every ``moe._dispatch_indices`` call appends (entries
    dropped, entries) to the list it yields."""
    real, seen = moe_mod._dispatch_indices, []

    def counting(e_flat, *args):
        slot, keep = real(e_flat, *args)
        seen.append((int((~keep).sum()), keep.numel()))
        return slot, keep
    with _patched(moe_mod, {"_dispatch_indices": counting}):
        yield seen


@contextlib.contextmanager
def _routes(replay=None):
    """Within: every ``moe._route`` call appends its own top-k ids (on the
    host) to the list it yields. With ``replay`` (such a list from another
    run of the same calls), each call routes by the ids of the same call
    there instead, its weights its own softmax's at those ids,
    renormalised."""
    real, seen = moe_mod._route, []

    def route(x, router_w, cfg):
        idx, w, aux = real(x, router_w, cfg)
        seen.append(idx.cpu())
        if replay is not None:
            idx = replay[len(seen) - 1].to(idx.device)
            w = torch.gather(torch.softmax(x.float() @ router_w, dim=-1),
                             -1, idx)
            w = w / w.sum(dim=-1, keepdim=True)
        return idx, w, aux
    with _patched(moe_mod, {"_route": route}):
        yield seen


def _route_flips(a: list, b: list) -> float:
    """The share of tokens, over every call, whose top-k sets differ
    between the route lists ``a`` and ``b``."""
    diff = sum(int((x.sort(-1).values != y.sort(-1).values).any(-1).sum())
               for x, y in zip(a, b))
    return diff / sum(x.shape[0] for x in a)


def drop_shares(params, cfg, toks, valid) -> list:
    """Each layer's share of (token, expert) entries dropped in one call
    of mode 'full' over ``toks`` (B,S) (``valid`` marking the real
    tokens; the pads route too, as in a prefill of the same rows)."""
    with torch.inference_mode(), _counting_drops() as seen:
        model_mod.forward(params, cfg, {"tokens": toks}, mode="full",
                          caches=None, kv_valid=valid)
    return [d / n for d, n in seen]


def check_moe(tag: str, reduce) -> None:
    """``tag`` on ``reduce(dtype, factor)`` in f32 at capacity factors 1.25
    (some entries dropped, asserted) and 16 (none), and in bf16 at 1.25, the
    norms drawn (``draw_norms``): modes full and prefill over right-padded
    rows (f32: 64, 45, 17 and 1 tokens in a bucket of 64; bf16: 600, 300,
    77 and 1 in a bucket of 768), then 4 decode steps, card against host
    (``_hold_hidden``: 2e-3 elementwise in f32, a relative 2e-2 in bf16;
    the K/V caches likewise). In bf16 the host takes the card's routes
    (``_routes``), and the share of tokens whose own top-k differs between
    the two is held to ``MOE_ROUTE_FLIPS``: a route is a discrete choice,
    and one moved by bf16 rounding changes whole experts' outputs; the
    bf16 config's flash (head_dim 64) must run the tensor-core
    kernel (``flash_fwd_kernel_tma<64, ...>``) in mode full. Then
    engines on the card: graphed == eager
    tokens (monolithic and chunked) at each config; at factor 16 chunked
    (8, 16) == monolithic tokens, a prefix hit == a cold engine, snapshot
    -> restore bit for bit, host paging and mid-prefill migration
    token-identical. Drops depend on the call's tokens, so these hold
    only where nothing drops."""
    for dtype, factor, lens, bucket in (
            ("float32", 1.25, (64, 45, 17, 1), 64),
            ("float32", 16.0, (64, 45, 17, 1), 64),
            ("bfloat16", 1.25, (600, 300, 77, 1), 768)):
        cfg = reduce(dtype, factor)
        dt = dtype_of(dtype)
        host = model_mod.init_params(cfg, seed=1, device="cpu")
        draw_norms(host, seed=2)
        card = copy.deepcopy(host).to(DEV)
        B = len(lens)
        gen = torch.Generator().manual_seed(3)
        toks = torch.randint(0, cfg.vocab_size, (B, bucket), generator=gen,
                             dtype=torch.int32)
        valid = torch.arange(bucket)[None, :] < torch.tensor(lens)[:, None]
        steps = [torch.randint(0, cfg.vocab_size, (B, 1), generator=gen,
                               dtype=torch.int32) for _ in range(4)]
        args = (toks, valid, steps, bucket + 8)
        label = f"{tag}[{dtype}, capacity factor {factor}]"
        with _routes() as card_routes:
            got = _model_hidden(card, cfg, *args)
        routes = ""
        if dtype == "float32":
            want = _model_hidden(host, cfg, *args)
        else:
            # a route is a discrete choice: bf16 rounding that differs on
            # the card moves a few tokens' top-k, and with them whole
            # experts' outputs and the drops after them. The host takes
            # the card's routes, so the rest is held by its tolerance; the
            # share of tokens whose own routes differ is held apart
            own = _model_hidden(host, cfg, *args)
            with _routes(card_routes) as host_routes:
                want = _model_hidden(host, cfg, *args)
            flips = _route_flips(card_routes, host_routes)
            direct = ((got[0].float() - own[0].float()).norm()
                      / own[0].float().norm()).item()
            routes = (f"; {100 * flips:.3f}% of tokens routed otherwise "
                      f"on the host (tol {100 * MOE_ROUTE_FLIPS:.0f}%), "
                      f"mode full against the host's own routes relative "
                      f"error {direct:.3e} (not held); held with the "
                      f"card's routes on the host")
            if flips > MOE_ROUTE_FLIPS:
                raise AssertionError(f"{label}: {flips} of the tokens "
                                     f"routed otherwise on the host")
            # head_dim 64: flash's tensor-core kernel
            batch = {"tokens": toks.to(DEV)}
            with torch.inference_mode():
                require_flash_kernel(label, lambda: model_mod.forward(
                    card, cfg, batch, mode="full", caches=None), tma=True,
                    hd=64)
        held = [_hold_hidden(f"{label} {what}", g, w, dt)
                for what, g, w in zip(("full", "prefill", "decode"), got,
                                      want)]
        kv = _hold_hidden(f"{label} K/V", torch.stack(
            [c[n] for c in got[3] for n in ("k", "v")]).float(), torch.stack(
            [c[n] for c in want[3] for n in ("k", "v")]).float(), dt)
        shares = drop_shares(card, cfg, toks.to(DEV), valid.to(DEV))
        padded = (f" (padded to {cfg.moe.padded_experts})"
                  if cfg.moe.padded_experts > cfg.moe.num_experts else "")
        print(f"{label}: {cfg.num_layers} layers of d_model {cfg.d_model}, "
              f"{cfg.num_heads} heads over {cfg.num_kv_heads} of "
              f"{cfg.head_dim}, {cfg.moe.num_experts} experts{padded} top-"
              f"{cfg.moe.top_k} of {cfg.moe.d_expert}; rows of {list(lens)} "
              f"tokens in a bucket of {bucket}, card vs host: full "
              f"{held[0]}, prefill {held[1]}, 4 decode steps {held[2]}, "
              f"K/V {kv} (tol {TOL[dt]}){routes}; entries dropped by "
              f"layer {[round(s, 4) for s in shares]}", flush=True)
        if (factor == 1.25) != (sum(shares) > 0):
            raise AssertionError(f"{label}: drop shares {shares}")
        kw = (dict(batch_slots=3, max_len=128, prefill_buckets=(16, 32, 64))
              if dtype == "float32" else
              dict(batch_slots=3, max_len=1024,
                   prefill_buckets=(256, 512, 768)))
        trace = (lambda: _requests(6, 3, 60, 8, cfg.vocab_size, seed=3)) \
            if dtype == "float32" else \
            (lambda: _requests(6, 40, 700, 8, cfg.vocab_size, seed=3))
        chunk = 16 if dtype == "float32" else 256
        for c in (None, chunk):
            engs = [InferenceEngine(cfg, card, prefill_chunk=c,
                                    cuda_graphs=graphs, device=DEV, **kw)
                    for graphs in (True, False)]
            where = f"chunk {c}" if c else "monolithic"
            _identical(label, f"{where} graphed vs eager",
                       *(_outputs(e, trace()) for e in engs))
            print(f"{label}: {where}: 6 requests token-identical graphed "
                  f"and eager; final caches max abs difference "
                  f"{_cache_diff(*engs):.3e}", flush=True)
        if factor == 1.25:
            continue
        mono = _outputs(InferenceEngine(cfg, card, device=DEV, **kw),
                        trace())
        for c in (8, 16):
            eng = InferenceEngine(cfg, card, prefill_chunk=c, device=DEV,
                                  **kw)
            _identical(label, f"chunk {c} vs monolithic",
                       _outputs(eng, trace()), mono)
            print(f"{label}: chunk {c}: 6 requests token-identical to "
                  f"monolithic ({eng.telemetry.continuations} "
                  f"continuations)", flush=True)
        ckw = dict(kw, prefill_chunk=8)
        _check_prefix_hits(label, cfg, card, ckw)
        _check_round_trip(cfg, card, kw, n=40, label=label)
        _check_paging_and_migration(label, cfg, card, ckw)
        del host, card
        _free_card()


def _dense_moe(p, h: torch.Tensor, cfg):
    """check-dbrx-layers' own mixture of experts over h (T,d), written
    apart from ``models/moe.py``: the router's softmax over h in f32, each
    token's top k, their weights renormalised; then per expert, padded
    ones included, the tokens that chose it in token order, the first C =
    max(ceil(T k / E * factor), min(4, T k)) of them kept (E the real
    experts), each through the expert's SwiGLU FFN in the weights' dtype,
    weighted, summed per token in f32. Returns (out (T,d) in h's dtype,
    entries dropped, entries a padded expert received)."""
    m = cfg.moe
    T = h.shape[0]
    C = max(math.ceil(T * m.top_k * m.capacity_factor / m.num_experts),
            min(4, T * m.top_k))
    probs = torch.softmax(h.float() @ p.router, dim=-1)
    w, idx = torch.topk(probs, m.top_k, dim=-1)
    w = w / w.sum(dim=-1, keepdim=True)
    out = torch.zeros(h.shape, dtype=torch.float32, device=h.device)
    kept = padded = 0
    for e in range(m.padded_experts):
        tok, j = (idx == e).nonzero(as_tuple=True)      # in token order
        if e >= m.num_experts:
            padded += tok.numel()
        tok, j = tok[:C], j[:C]
        kept += tok.numel()
        x = h[tok]
        y = (F.silu(x @ p.wg[e]) * (x @ p.wu[e])) @ p.wd[e]
        out.index_add_(0, tok, (y * w[tok, j].to(y.dtype)[:, None]).float())
    return out.to(h.dtype), T * m.top_k - kept, padded


# the capacity fault: capacities this many times the real one, the whole
# call's T at most (dbrx's layers check: T, so nothing drops); T itself
# would need kimi-k2's 512 experts' buffers at 4096 rows each (~30 GB)
CAPACITY_FAULT_X = 4


def _moe_fault(name: str) -> dict:
    """The ``models/moe.py`` functions that plant fault ``name`` of
    ``MOE_FAULTS``."""
    route, dispatch = moe_mod._route, moe_mod._dispatch_indices

    def unnormalised(x, router_w, cfg):
        idx, _, aux = route(x, router_w, cfg)
        probs = torch.softmax(x.float() @ router_w, dim=-1)
        return idx, torch.gather(probs, -1, idx), aux

    def last_first(e_flat, *args):
        slot, keep = dispatch(e_flat.flip(0), *args)
        return slot.flip(0), keep.flip(0)

    def swapped(xin, wg, wu, wd, cfg):
        return torch.bmm(F.silu(torch.bmm(xin, wu)) * torch.bmm(xin, wg), wd)

    capacity = moe_mod._capacity
    return {"renorm": {"_route": unnormalised},
            "capacity": {"_capacity": lambda T, cfg: min(
                T, CAPACITY_FAULT_X * capacity(T, cfg))},
            "lcfs": {"_dispatch_indices": last_first},
            "act": {"_expert_ffn": swapped}}[name]


def check_moe_layers(label: str, cfg, params, lens=DBRX_LAYERS_LENS,
                     layers: int = 2) -> None:
    """The first ``layers`` blocks of ``params`` (dbrx's global attention
    and MoE), each on the same input x on both sides: the port's block
    (``blocks.apply_block``, mode 'full', over right-padded rows of
    ``lens`` tokens) against its attention plus ``_dense_moe``, in the
    same dtype; the next layer's input is the dense side's output. The
    metric is per token: ||block - dense|| / ||dense - x|| at the real
    tokens, its worst over the layers held to ``MOE_LAYERS_TOL``. The
    share of entries dropped is printed, and no padded expert may receive
    one; each of ``MOE_FAULTS``, planted in ``models/moe.py``, must land
    past the bound (the capacity fault dropping fewer entries than the
    real capacity drops)."""
    if cfg.post_attn_norm or cfg.activation != "silu" or not cfg.glu:
        raise ValueError(f"{label}: a SwiGLU MoE block without post-norms")
    B, S = len(lens), max(lens)
    gen = torch.Generator(device=DEV).manual_seed(9)
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                         device=DEV, dtype=torch.int32)
    valid = torch.arange(S, device=DEV)[None, :] \
        < torch.tensor(lens, device=DEV)[:, None]
    positions = torch.arange(S, device=DEV).expand(B, S)
    worst, dropped, padded, wider = 0.0, 0, 0, 0
    faults = dict.fromkeys(MOE_FAULTS, 0.0)
    with torch.inference_mode():
        x = vocab_mod.embed_lookup(params.embed, toks, cfg)
        for layer in params.layers[:layers]:
            y, _ = attn_mod.full_attention(
                layer.attn, layer.pre_norm(x, cfg.norm_eps), cfg, positions,
                valid, kind=layer.kind)
            mid = x + y
            out, n, n_pad = _dense_moe(layer.moe, layer.pre_mlp_norm(
                mid, cfg.norm_eps).reshape(B * S, -1), cfg)
            dense = mid + out.view(B, S, -1)
            added = (dense - x).float().norm(dim=-1)[valid]

            def err() -> float:
                got = blk_mod.apply_block(layer, x, cfg, mode="full",
                                          cache=None, positions=positions,
                                          kv_valid=valid)
                e = (got - dense).float().norm(dim=-1)[valid] / added
                return float("inf") if not torch.isfinite(e).all() \
                    else e.max().item()
            worst = max(worst, err())
            for name in MOE_FAULTS:
                with _patched(moe_mod, _moe_fault(name)), \
                        _counting_drops() as seen:
                    faults[name] = max(faults[name], err())
                if name == "capacity":
                    wider += sum(d for d, _ in seen)
            dropped += n
            padded += n_pad
            x = dense
    entries = layers * B * S * cfg.moe.top_k
    print(f"{label}: the first {layers} layers at d_model {cfg.d_model}, "
          f"{cfg.moe.num_experts} experts (weights for "
          f"{cfg.moe.padded_experts}) top-{cfg.moe.top_k} of "
          f"{cfg.moe.d_expert}, capacity factor {cfg.moe.capacity_factor}, "
          f"in {cfg.param_dtype}, rows of {list(lens)} tokens: the block vs "
          f"the dense formulation, worst token {worst:.4f} of what the "
          f"layer adds (tol {MOE_LAYERS_TOL}); entries dropped "
          f"{100 * dropped / entries:.2f}% ({dropped} of {entries}, pads "
          f"included), {padded} to a padded expert, {wider} at "
          f"{CAPACITY_FAULT_X}x the capacity; planted faults: " + "; ".join(
              f"{MOE_FAULTS[k]} {v:.4f}" for k, v in faults.items()),
          flush=True)
    if not worst <= MOE_LAYERS_TOL:
        raise AssertionError(f"{label}: worst token {worst} > "
                             f"{MOE_LAYERS_TOL}")
    if not dropped:
        raise AssertionError(f"{label}: nothing dropped, so the drops are "
                             f"not checked")
    if padded:
        raise AssertionError(f"{label}: {padded} entries routed to a padded "
                             f"expert")
    if not wider < dropped:
        raise AssertionError(f"{label}: {wider} entries dropped at "
                             f"{CAPACITY_FAULT_X}x the capacity, {dropped} at "
                             f"the capacity: the fault changes no drop")
    for name, e in faults.items():
        if not e > MOE_LAYERS_TOL:
            raise AssertionError(f"{label}: the planted fault "
                                 f"'{MOE_FAULTS[name]}' stays within the "
                                 f"bound ({e} <= {MOE_LAYERS_TOL})")


def init_cut(arch: str, layers: int):
    """``arch``'s first ``layers`` layers at full width (random bf16
    weights from seed 0): dbrx-132b's d_model 6144, 48 heads over 8 kv
    heads of 128, 16 experts top-4 of 10752, untied vocab 100352;
    command-r-plus-104b's d_model 12288, 96 heads over 8 of 128, SwiGLU
    33792, LayerNorm, tied vocab 256000; kimi-k2-1t-a32b's d_model 7168,
    64 heads over 8 of 128, 384 experts (512 with the padded ones) top-8
    of 2048, untied vocab 163840."""
    full = get_config(arch)
    cfg = dataclasses.replace(full, num_layers=layers)
    t0 = time.perf_counter()
    params = model_mod.init_params(cfg, seed=0, device=DEV)
    torch.cuda.synchronize()
    nbytes = sum(p.numel() * p.element_size() for p in params.parameters())
    print(f"init: {arch} full width, {cfg.num_layers} of {full.num_layers} "
          f"layers, {sum(p.numel() for p in params.parameters()) / 1e9:.3f} "
          f"B params ({nbytes / 1e9:.2f} GB), "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB, in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return cfg, params


def dbrx_requests(vocab: int):
    """The dbrx serve phases' traffic: 8 prompts x 32 new tokens, long and
    short in turn: ``DBRX_PROMPTS`` and 4 of 17-200."""
    rng = np.random.default_rng(0)
    lens = np.stack([DBRX_PROMPTS, rng.integers(17, 201, 4)], 1).reshape(-1)
    return [Request(i, rng.integers(0, vocab, int(L)).astype(np.int32),
                    max_new_tokens=32) for i, L in enumerate(lens)]


def _long_prompts(cfg, reqs):
    """The trace's ``DBRX_PROMPTS`` requests as one right-padded batch:
    (tokens (4, 4096), valid) on the card."""
    long = [r.tokens for r in reqs if len(r.tokens) in DBRX_PROMPTS]
    S = max(len(t) for t in long)
    toks = torch.zeros(len(long), S, dtype=torch.int32)
    for i, t in enumerate(long):
        toks[i, :len(t)] = torch.from_numpy(t)
    lens = torch.tensor([len(t) for t in long])
    return toks.to(DEV), (torch.arange(S)[None, :] < lens[:, None]).to(DEV)


def phase_dbrx() -> dict:
    """dbrx-132b's phases: ``phase_moe`` on its first ``DBRX_LAYERS``
    layers."""
    return phase_moe("dbrx", "dbrx-132b", DBRX_LAYERS, reduce_dbrx)


def phase_moe(tag: str, arch: str, layers: int, reduce) -> dict:
    """check-``tag`` (``check_moe`` on ``reduce``), then ``arch``'s first
    ``layers`` layers at full width (``init_cut``): check-``tag``-layers
    on its first 2 (or its one), serve-``tag`` (graphed, ``dbrx_requests``
    warmed on the same requests; tok/s, TTFT, the decode stage's p50, the
    peak memory; a prefill's and a step's device time beside their bounds,
    ``serve_bounds``; the share of entries dropped in
    a 4 x 4096 prefill of the trace's long prompts, from a run of the
    model outside the engine), serve-eager-``tag`` (tokens identical),
    serve-``tag``-chunked (512; agreement printed), serve-``tag``-w8a8
    with an int8 KV cache (every attention projection int8, 4 weights a
    layer, the experts bf16; agreement printed) and its layers check.
    Frees the weights; returns the launches of the graphed bf16, chunked
    and w8a8 serves."""
    check_moe(f"check-{tag}", reduce)
    cfg, params = init_cut(arch, layers)
    check_moe_layers(f"check-{tag}-layers", cfg, params,
                     layers=min(2, layers))
    _free_card()
    label = f"serve-{tag}"
    trace = lambda: dbrx_requests(cfg.vocab_size)
    serve = dict(engine_kw=DBRX_KW, trace=trace, ref_label=label,
                 layers_label=f"check-{tag}-w8a8-layers",
                 profile_pos=DBRX_DECODE_POS, hold=False)
    launches, outputs, eng = phase_serve_padded(
        cfg, params, label, keep_engine=True, **serve)
    decode_step_p50(label, eng, DBRX_DECODE_POS)
    serve_bounds(label, cfg, params)
    shares = drop_shares(params, cfg, *_long_prompts(cfg, trace()))
    print(f"{label}: entries dropped in a {len(DBRX_PROMPTS)} x "
          f"{max(DBRX_PROMPTS)} prefill of the trace's long prompts (lens "
          f"{list(DBRX_PROMPTS)}, capacity factor "
          f"{cfg.moe.capacity_factor}), by layer: "
          f"{[round(100 * s, 2) for s in shares]}% (mean "
          f"{100 * sum(shares) / len(shares):.2f}%)", flush=True)
    phase_serve_eager(f"serve-eager-{tag}", eng, launches, outputs, cfg,
                      params, engine_kw=DBRX_KW, trace=trace,
                      decode_pos=DBRX_DECODE_POS, identical=True)
    del eng
    _free_card()
    chunked, _, _ = phase_serve_padded(
        cfg, params, f"serve-{tag}-chunked", mono_outputs=outputs,
        prefill_chunk=512, **serve)
    _free_card()
    # on seed-0 weights the calibration's greedy argmax is noise (near-flat
    # logits, and routes moved by any perturbation): at the default budget
    # every site fell back (a chip run: 0 of 4 int8). The build quantizes
    # every site, and check-dbrx-w8a8-layers holds the layers instead
    quant, _, eng = phase_serve_padded(
        cfg, params, f"serve-{tag}-w8a8", mono_outputs=outputs,
        precision="w8a8", quant_budget=1.0, keep_engine=True, **serve)
    n_int8 = sum(isinstance(m, QuantDense)
                 for m in eng.quant.params.modules())
    moe_int8 = [n for n, m in eng.quant.params.named_modules()
                if isinstance(m, QuantDense) and ".moe." in f".{n}."]
    if n_int8 != 4 * cfg.num_layers or moe_int8:
        raise AssertionError(f"serve-{tag}-w8a8: {n_int8} int8 weights, "
                             f"{len(moe_int8)} of them the experts'; want "
                             f"the 4 attention projections of each layer")
    del eng, params
    _free_card()
    print(f"freed {arch}: {torch.cuda.memory_allocated() / 2**30:.2f} "
          f"GiB still allocated", flush=True)
    return {k: launches[k] + chunked[k] + quant[k]
            for k in ("flash_attn", "decode_attn", "w8a8_matmul",
                      "decode_attn_int8")}


MOE_SPANS = (moe_mod.MOE_SPAN, moe_mod.ROUTE_SPAN, moe_mod.DISPATCH_SPAN,
             moe_mod.EXPERTS_SPAN, moe_mod.COMBINE_SPAN)


def _lm_flops(cfg, params, B: int, T: int, pairs: int) -> dict:
    """The products of one call of ``T`` tokens in ``B`` rows over ``pairs``
    (query, key) pairs, as the port computes them: a MoE model's experts
    over their whole capacity buffers (Ep x C slots a layer, the padded
    experts' too), the attention projections and the router or the dense
    MLP over every token of the call, attention over the pairs, and the
    greedy head at one token a row."""
    d, L = cfg.d_model, cfg.num_layers
    layer = params.layers[0]
    proj = sum(getattr(layer.attn, w).numel()
               for w in ("wq", "wk", "wv", "wo"))
    flops = {}
    if cfg.moe is not None:
        m = cfg.moe
        C = moe_mod._capacity(T, cfg)
        flops["experts"] = 2.0 * 3 * m.padded_experts * C * d * m.d_expert * L
        proj += d * m.num_experts
    else:
        proj += sum(t.numel() for t in layer.mlp.parameters())
    flops.update(projections=2.0 * T * proj * L,
                 attention=4.0 * pairs * cfg.num_heads * cfg.head_dim * L,
                 head=2.0 * B * model_mod.head_table(params, cfg).numel())
    return flops


def profile_dbrx() -> None:
    """profile-dbrx: in one ``marked_window``, a 4 x 4096 prefill call
    (lens ``DBRX_PROMPTS``) through the model layer, eagerly, and 8
    replays of a graphed decode stage of 4 slots at ``DBRX_DECODE_POS``;
    the window must hold every marker. Prints the prefill's device time,
    the ``moe`` spans' share of it (and of that, ``moe.route``,
    ``moe.dispatch``, ``moe.experts`` and ``moe.combine``) and flash's,
    and the step's device time and device activities, each beside its
    bound: the prefill's products (the experts over their capacity
    buffers) at 989 TFLOP/s, the step's bytes (every weight, since each
    expert runs over its capacity buffer, and the K/V its rows read) at
    3.35 TB/s."""
    cfg, params = init_cut("dbrx-132b", DBRX_LAYERS)
    label = "profile-dbrx"
    lens = DBRX_PROMPTS
    B, S = len(lens), max(lens)
    gen = torch.Generator(device=DEV).manual_seed(8)
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                         device=DEV, dtype=torch.int32)
    lens_t = torch.tensor(lens, device=DEV)
    valid = torch.arange(S, device=DEV)[None, :] < lens_t[:, None]
    caches = model_mod.init_caches(cfg, B, DBRX_KW["max_len"], DEV)
    eng = InferenceEngine(cfg, params, **DBRX_KW)
    run = eng.executor.get("decode", (eng.precision,), eng._build_decode)
    step_in = {"tokens": np.zeros((B, 1), np.int32),
               "pos": np.array(DBRX_DECODE_POS, np.int32),
               "active": np.ones(B, bool)}
    run(step_in)                        # the eager warm-up, then the capture
    run(step_in)
    replay = run.variants[None].graph.replay

    @torch.inference_mode()
    def prefill():
        x, _ = model_mod.forward(params, cfg, {"tokens": toks},
                                 mode="prefill", caches=caches,
                                 kv_valid=valid)
        return model_mod.greedy_next(
            params, cfg, x[torch.arange(B, device=DEV), lens_t - 1])

    prefill()
    replay()
    torch.cuda.synchronize()
    steps = 8
    calls = [prefill] + [replay] * steps
    prof, events, pairs = marked_window(calls)
    if pairs is None:
        raise AssertionError(f"{label}: the window lost marker kernels, and "
                             f"with them device activities")
    ms = [sum(e.time_range.elapsed_us() for e in events[a + 1:b]) / 1e3
          for a, b in pairs]
    count = [b - a - 1 for a, b in pairs]
    spans = {}
    for name in MOE_SPANS:
        n, t = _span_ms(prof, name)
        if n != cfg.num_layers or not t:
            raise AssertionError(f"{label}: {n} {name} spans ({t:.3f} ms) "
                                 f"for {cfg.num_layers} layers")
        spans[name] = t
    a, b = pairs[0]
    flash_ms = sum(e.time_range.elapsed_us() for e in events[a + 1:b]
                   if "flash_fwd_kernel" in e.name) / 1e3
    if not flash_ms:
        raise AssertionError(f"{label}: no flash kernel in the prefill")
    flops = _lm_flops(cfg, params, B, B * S,
                      sum(n * (n + 1) // 2 for n in lens))
    wbytes = sum(t.numel() * t.element_size() for t in params.parameters())
    pre_bound, pre_by = bound(sum(flops.values()), wbytes, torch.bfloat16)
    kv_bytes = sum(2 * (p + 1) * cfg.num_kv_heads * cfg.head_dim * 2
                   for p in DBRX_DECODE_POS) * cfg.num_layers
    step_flops = sum(_lm_flops(cfg, params, B, B, sum(
        p + 1 for p in DBRX_DECODE_POS)).values())
    step_bound, step_by = bound(step_flops, wbytes + kv_bytes,
                                torch.bfloat16)
    step_ms = sum(ms[1:]) / steps
    moe_ms = spans[moe_mod.MOE_SPAN]
    print(f"{label}: eager prefill {B}x{S} (lens {list(lens)}, capacity "
          f"{moe_mod._capacity(B * S, cfg)} a layer's expert): device "
          f"{ms[0]:.3f} ms over {count[0]} activities (bound "
          f"{pre_bound:.3f} ms by {pre_by}: " + ", ".join(
              f"{k} {v / 1e12:.3f}" for k, v in flops.items())
          + f" TFLOP; {ms[0] / pre_bound:.2f}x); the moe spans "
          f"{moe_ms:.3f} ms ({100 * moe_ms / ms[0]:.1f}%: " + ", ".join(
              f"{k} {100 * spans[k] / ms[0]:.1f}%" for k in MOE_SPANS[1:])
          + f"), flash {flash_ms:.3f} ms ({100 * flash_ms / ms[0]:.1f}%)",
          flush=True)
    print(f"{label}: graphed decode step, {B} rows at pos "
          f"{list(DBRX_DECODE_POS)}: device {step_ms:.4f} ms (min "
          f"{min(ms[1:]):.4f}) over {count[1]} activities (bound "
          f"{step_bound:.4f} ms by {step_by}: {wbytes / 1e9:.3f} GB of "
          f"weights, {kv_bytes / 1e9:.3f} GB of K/V read; "
          f"{step_ms / step_bound:.2f}x); all {2 * len(calls)} markers in "
          f"the window", flush=True)
    del eng, caches, params
    _free_card()


# ---- command-r-plus-104b and kimi-k2-1t-a32b ---------------------------------

# the served cuts (the launcher's ``CARD_CUTS``): command-r-plus-104b's first
# 16 of 64 layers at full width (28.31 B parameters with the tied
# 256000-row embedding, 56.6 GB in bf16; all 64 take ~208 GB),
# kimi-k2-1t-a32b's first 1 of 61 (25.03 B, 50.1 GB: its 512 experts' 45.1
# GB, the embedding and the head; every layer holds its padded experts, as
# the reference's does; all 61 take ~2.8 TB)
CMDR_LAYERS = serve_launcher.CARD_CUTS["command-r-plus-104b"][1]
KIMI_LAYERS = serve_launcher.CARD_CUTS["kimi-k2-1t-a32b"][1]
# command-r-plus's projections (K, N): wq and wo (12288 -> 96 x 128 =
# 12288, and back), wk and wv (-> 8 x 128), gate and up (-> 33792), down
# (33792 -> 12288)
CMDR_PROJECTIONS = ((12288, 12288), (12288, 1024), (12288, 33792),
                    (33792, 12288))
# kimi-k2's attention (64 query heads over 8 kv heads, G 8, head_dim 128)
# and its projections: wq (7168 -> 64 x 128), wk and wv (-> 8 x 128), wo
# (8192 -> 7168); the experts are not w8a8 sites
KIMI_HEADS = (64, 8, 128)
KIMI_PROJECTIONS = ((7168, 8192), (7168, 1024), (8192, 7168))
# check-cmdr-layers: the worst real token's ||block - plain|| / ||plain -
# x|| over each layer (fixed before the first chip run), and the faults
# planted in the port's block that must land past it
CMDR_LAYERS_TOL = 0.02
CMDR_FAULTS = {"bias": "LayerNorm bias dropped",
               "groups": "query head h on kv head h mod K, not h // G",
               "theta": "RoPE at theta 10000"}
CMDR_LEAVES = ("scale", "bias")         # the LayerNorm leaves drawn


def cmdr_kimi_kernel_cases() -> None:
    """The kernels at command-r-plus-104b's and kimi-k2-1t-a32b's served
    shapes (bf16, head_dim 128), each held against its plain version and
    timed beside its library call and its bound: command-r-plus's two
    decode kernels at G 12 (2cr, 3cr; its flash rows 1cr and 1cr' run in
    ``dbrx_kernel_cases``) and w8a8 at its projections
    (``CMDR_PROJECTIONS``) at M 4 (4cr, split-K) and 16384 (4cr', TMA);
    kimi-k2's flash prefill of a 4096 bucket with lens ``DBRX_PROMPTS``
    (1km) and its chunk call, 4 x 512 in place over a 4 x 4608 cache at
    offsets 3584, 2048, 512, 0 (1km'), both on ``flash_fwd_kernel_tma<128,
    ...>`` with their heads held distinct, its decode kernels at G 8 (2km,
    3km) and w8a8 at ``KIMI_PROJECTIONS`` (4km, 4km'). Then one profiler
    window of their device times, which must name the kernel each flash
    and w8a8 case ran. Their inputs come from a generator of their own."""
    gen = torch.Generator(device=DEV).manual_seed(36)
    bf16 = torch.bfloat16
    fns, routes = {}, {}
    _decode_rows(fns, gen, "cmdr", CMDR_HEADS, "cr")
    _w8a8_rows(fns, routes, gen, "cmdr", CMDR_PROJECTIONS,
               rows=((4, "4cr"), (16384, "4cr'")))
    H, K, hd = KIMI_HEADS
    name = f"kimi_1km_B4_S4096_H{H}_K{K}_hd{hd}"
    # the plain version over two halves of the kv heads, as 1cr's
    r = flash_case(name, gen, 4, 4096, H, K, hd, bf16, list(DBRX_PROMPTS),
                   distinct=True, ref_parts=2)
    _show("flash_attn", name, r)
    fns["flash_attn " + name] = r["call"]
    fns["SDPA (boolean mask) " + name] = r["library_call"]
    routes["flash_attn " + name] = tma_route(hd)
    name = f"kimi_1km'_chunk_P4_C512_T4608_H{H}_K{K}_hd{hd}"
    r = flash_chunk_case(name, gen, 4, 4608, H, K, hd, 512, bf16,
                         slots=[0, 1, 2, 3], start=[3584, 2048, 512, 0],
                         lengths=[512] * 4, measure=True, distinct=True)
    _show("flash_attn", name, r)
    fns["flash_attn " + name] = r["call"]
    fns["SDPA (boolean mask) " + name] = r["library_call"]
    routes["flash_attn " + name] = tma_route(hd)
    _decode_rows(fns, gen, "kimi", KIMI_HEADS, "km")
    _w8a8_rows(fns, routes, gen, "kimi", KIMI_PROJECTIONS,
               rows=((4, "4km"), (16384, "4km'")))
    device_window(fns, routes=routes)


def reduce_cmdr(dtype: str):
    """check-cmdr's configs, 2 layers keeping command-r-plus's G 12, which
    ``reduce_for_smoke`` drops (4 heads over 4): in f32 d_model 64, 12
    heads over 1 kv head of 16; in bf16 d_model 256, 24 heads over 2 kv
    heads of 64 (flash's tensor-core kernel at head_dim 64) and d_ff 512.
    LayerNorm, SwiGLU, the tied embedding and theta 75000 as at full
    width; vocab 256."""
    small = reduce_for_smoke(get_config("command-r-plus-104b"))
    if dtype == "float32":
        return dataclasses.replace(small, num_heads=12, num_kv_heads=1)
    return dataclasses.replace(small, d_model=256, num_heads=24,
                               num_kv_heads=2, head_dim=64, d_ff=512,
                               param_dtype=dtype, activation_dtype=dtype)


def phase_check_cmdr() -> None:
    """check-cmdr: ``check_reduced`` on ``reduce_cmdr`` (f32 and bf16, each
    fp and w8a8 + int8 KV), the LayerNorms' scales and biases drawn
    (``draw_norms``); then the bf16 cut's mode 'full' must run flash's
    tensor-core kernel at head_dim 64 (``flash_fwd_kernel_tma<64,
    ...>``)."""
    label = "check-cmdr"
    check_reduced(label, "reduced command-r-plus-104b", reduce_cmdr,
                  draw=lambda p: draw_norms(p, seed=2, leaves=CMDR_LEAVES))
    cfg = reduce_cmdr("bfloat16")
    params = model_mod.init_params(cfg, seed=0, device=DEV)
    gen = torch.Generator(device=DEV).manual_seed(3)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 300),
                                     generator=gen, device=DEV,
                                     dtype=torch.int32)}
    with torch.inference_mode():
        require_flash_kernel(f"{label}[bfloat16]", lambda: model_mod.forward(
            params, cfg, batch, mode="full", caches=None), tma=True, hd=64)
    del params
    _free_card()


def _layer_norm_plain(x: torch.Tensor, norm, eps: float) -> torch.Tensor:
    """LayerNorm by its formula, in f32: (x - mean) / sqrt(var + eps) * (1
    + scale) + bias, back in x's dtype."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).pow(2).mean(-1, keepdim=True)
    y = (xf - mu) / torch.sqrt(var + eps)
    return (y * (1.0 + norm.scale.float()) + norm.bias.float()).to(x.dtype)


def _plain_block(layer, x: torch.Tensor, cfg, positions, valid):
    """check-cmdr-layers' own global block over x (B,S,d), written apart
    from ``models/``: LayerNorm by its formula; q, k, v as products with
    the weights; RoPE at ``cfg.rope_theta`` (split halves, f32 angles);
    causal attention of each query head h over kv head h // G at the
    valid keys, an explicit product per kv head in f32 (softmax in f32);
    ``wo``; the residual; LayerNorm; SwiGLU; the residual. Products in the
    weights' dtype."""
    B, S, d = x.shape
    a = layer.attn
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    G = H // K
    h = _layer_norm_plain(x, layer.pre_norm, cfg.norm_eps)
    q = (h @ a.wq.reshape(d, -1)).view(B, S, H, hd)
    k = (h @ a.wk.reshape(d, -1)).view(B, S, K, hd)
    v = (h @ a.wv.reshape(d, -1)).view(B, S, K, hd)
    half = hd // 2
    freq = cfg.rope_theta ** (-torch.arange(half, dtype=torch.float32,
                                            device=x.device) / half)
    ang = positions[..., None].float() * freq            # (B,S,half)
    cos, sin = ang.cos()[:, :, None], ang.sin()[:, :, None]

    def rope(t):
        t1, t2 = t.float()[..., :half], t.float()[..., half:]
        return torch.cat([t1 * cos - t2 * sin, t2 * cos + t1 * sin],
                         dim=-1).to(t.dtype)

    q, k = rope(q), rope(k)
    lens = valid.sum(-1)
    qpos = torch.arange(S, device=x.device)
    keep = (qpos[None, :, None] >= qpos[None, None, :]) \
        & (qpos[None, None, :] < lens[:, None, None])    # (B,S,T)
    o = torch.empty(B, S, H, hd, dtype=torch.float32, device=x.device)
    for kv in range(K):
        qk = q[:, :, kv * G:(kv + 1) * G].float()        # (B,S,G,hd)
        s = torch.einsum("bsgd,btd->bgst", qk, k[:, :, kv].float()) \
            * hd ** -0.5
        s = s.masked_fill(~keep[:, None], float("-inf"))
        p = torch.softmax(s, dim=-1).nan_to_num(0.0)
        o[:, :, kv * G:(kv + 1) * G] = torch.einsum(
            "bgst,btd->bsgd", p, v[:, :, kv].float())
    y = o.to(x.dtype).reshape(B, S, H * hd) @ a.wo.reshape(H * hd, d)
    mid = x + y
    h = _layer_norm_plain(mid, layer.pre_mlp_norm, cfg.norm_eps)
    m = layer.mlp
    return mid + (F.silu(h @ m.w_gate) * (h @ m.w_up)) @ m.w_down


def _cmdr_fault(name: str, cfg):
    """(the attributes of ``attention`` or ``common`` to patch, or None,
    the config the block runs with) that plant fault ``name`` of
    ``CMDR_FAULTS`` in the port's block."""
    if name == "theta":
        return None, None, dataclasses.replace(cfg, rope_theta=10_000.0)
    if name == "bias":
        real = common_mod.layer_norm
        return common_mod, {"layer_norm": lambda x, scale, bias, eps: real(
            x, scale, torch.zeros_like(bias), eps)}, cfg
    real = attn_mod.flash_attn

    def regrouped(q, k, v, *args, **kw):
        # query head h placed in group h mod K, so the kernel reads kv
        # head h mod K for it; its output taken back from there
        H, K = q.shape[2], k.shape[2]
        h = torch.arange(H, device=q.device)
        place = (h % K) * (H // K) + h // K
        qp = torch.empty_like(q)
        qp[:, :, place] = q
        return real(qp, k, v, *args, **kw)[:, :, place]
    return attn_mod, {"flash_attn": regrouped}, cfg


def check_cmdr_layers(label: str, cfg, params, lens=DBRX_LAYERS_LENS,
                      layers: int = 2) -> None:
    """The first ``layers`` blocks of ``params`` (global attention at G 12,
    LayerNorm, SwiGLU), each on the same input x on both sides: the port's
    block (``blocks.apply_block``, mode 'full', so flash's tensor-core
    kernel at G 12 on the card, over right-padded rows of ``lens`` tokens)
    against ``_plain_block``, in the same dtype; the next layer's input is
    the plain side's output. The metric is per token: ||block - plain|| /
    ||plain - x|| at the real tokens, its worst over the layers held to
    ``CMDR_LAYERS_TOL``. Each of ``CMDR_FAULTS``, planted in the port's
    block, must land past the bound."""
    if cfg.norm_type != "layernorm" or cfg.moe is not None \
            or cfg.post_attn_norm or not cfg.glu or cfg.activation != "silu":
        raise ValueError(f"{label}: a LayerNorm SwiGLU block without "
                         f"post-norms")
    B, S = len(lens), max(lens)
    gen = torch.Generator(device=DEV).manual_seed(9)
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                         device=DEV, dtype=torch.int32)
    valid = torch.arange(S, device=DEV)[None, :] \
        < torch.tensor(lens, device=DEV)[:, None]
    positions = torch.arange(S, device=DEV).expand(B, S)
    worst = 0.0
    faults = dict.fromkeys(CMDR_FAULTS, 0.0)
    with torch.inference_mode():
        x = vocab_mod.embed_lookup(params.embed, toks, cfg)
        for layer in params.layers[:layers]:
            plain = _plain_block(layer, x, cfg, positions, valid)
            added = (plain - x).float().norm(dim=-1)[valid]

            def err(run_cfg=cfg) -> float:
                got = blk_mod.apply_block(layer, x, run_cfg, mode="full",
                                          cache=None, positions=positions,
                                          kv_valid=valid)
                e = (got - plain).float().norm(dim=-1)[valid] / added
                return float("inf") if not torch.isfinite(e).all() \
                    else e.max().item()
            worst = max(worst, err())
            for name in CMDR_FAULTS:
                mod, attrs, run_cfg = _cmdr_fault(name, cfg)
                with (_patched(mod, attrs) if mod is not None
                      else contextlib.nullcontext()):
                    faults[name] = max(faults[name], err(run_cfg))
            x = plain
    print(f"{label}: the first {layers} layers at d_model {cfg.d_model}, "
          f"{cfg.num_heads} heads over {cfg.num_kv_heads} of "
          f"{cfg.head_dim} (G {cfg.num_heads // cfg.num_kv_heads}), "
          f"LayerNorm, in {cfg.param_dtype}, rows of {list(lens)} tokens: "
          f"the block vs the plain formulation, worst token {worst:.4f} of "
          f"what the layer adds (tol {CMDR_LAYERS_TOL}); planted faults: "
          + "; ".join(f"{CMDR_FAULTS[k]} {v:.4f}" for k, v in faults.items()),
          flush=True)
    if not worst <= CMDR_LAYERS_TOL:
        raise AssertionError(f"{label}: worst token {worst} > "
                             f"{CMDR_LAYERS_TOL}")
    for name, e in faults.items():
        if not e > CMDR_LAYERS_TOL:
            raise AssertionError(f"{label}: the planted fault "
                                 f"'{CMDR_FAULTS[name]}' stays within the "
                                 f"bound ({e} <= {CMDR_LAYERS_TOL})")


def serve_bounds(label: str, cfg, params, lens=DBRX_PROMPTS,
                 pos=DBRX_DECODE_POS) -> None:
    """A 4 x 4096 prefill call (lens ``lens``) through the model layer,
    eagerly, into caches of ``DBRX_KW``'s max_len: its device time, start
    to end on the device by CUDA events after a warm-up call, beside its
    bound (``_lm_flops`` at 989 TFLOP/s, the weights at 3.35 TB/s); and
    the bound of a decode step at ``pos`` (every weight and the K/V its
    rows read at 3.35 TB/s), which the graphed step's device time
    (``profile_decode_stage``) stands beside."""
    B, S = len(lens), max(lens)
    gen = torch.Generator(device=DEV).manual_seed(8)
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                         device=DEV, dtype=torch.int32)
    lens_t = torch.tensor(lens, device=DEV)
    valid = torch.arange(S, device=DEV)[None, :] < lens_t[:, None]
    caches = model_mod.init_caches(cfg, B, DBRX_KW["max_len"], DEV)

    @torch.inference_mode()
    def prefill():
        x, _ = model_mod.forward(params, cfg, {"tokens": toks},
                                 mode="prefill", caches=caches,
                                 kv_valid=valid)
        return model_mod.greedy_next(
            params, cfg, x[torch.arange(B, device=DEV), lens_t - 1])

    prefill()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    prefill()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end)
    flops = _lm_flops(cfg, params, B, B * S,
                      sum(n * (n + 1) // 2 for n in lens))
    wbytes = sum(t.numel() * t.element_size() for t in params.parameters())
    pre_bound, pre_by = bound(sum(flops.values()), wbytes, torch.bfloat16)
    kv_bytes = sum(2 * (p + 1) * cfg.num_kv_heads * cfg.head_dim * 2
                   for p in pos) * cfg.num_layers
    step_flops = sum(_lm_flops(cfg, params, B, B,
                               sum(p + 1 for p in pos)).values())
    step_bound, step_by = bound(step_flops, wbytes + kv_bytes,
                                torch.bfloat16)
    print(f"{label}: eager prefill {B}x{S} (lens {list(lens)}): device "
          f"{ms:.3f} ms start to end (CUDA events; bound {pre_bound:.3f} ms "
          f"by {pre_by}: " + ", ".join(f"{k} {v / 1e12:.3f}"
                                       for k, v in flops.items())
          + f" TFLOP; {ms / pre_bound:.2f}x); a decode step of {B} rows at "
          f"pos {list(pos)}: bound {step_bound:.4f} ms by {step_by} "
          f"({wbytes / 1e9:.3f} GB of weights, {kv_bytes / 1e9:.3f} GB of "
          f"K/V read)", flush=True)
    del caches
    _free_card()


def phase_cmdr() -> dict:
    """check-cmdr, then command-r-plus-104b's first ``CMDR_LAYERS`` layers
    at full width (``init_cut``), its LayerNorms' scales and biases drawn:
    check-cmdr-layers on its first 2, serve-cmdr (graphed, ``dbrx_requests``
    warmed on the same requests; tok/s, TTFT, the decode stage's p50, the
    peak memory; a prefill's and a step's device time beside their bounds,
    ``serve_bounds``), serve-eager-cmdr (tokens identical),
    serve-cmdr-chunked (512; agreement printed), then w8a8 with an int8 KV
    cache: the layers check's bf16 side on the whole bf16 model, the build
    at budget 1.0 with ``release_fp=True`` (build-cmdr-w8a8: the bf16
    model and its int8 form would not fit together), serve-cmdr-w8a8 (7
    int8 weights a layer; agreement printed) and check-cmdr-w8a8-layers.
    Frees the weights; returns the launches of the graphed bf16, chunked
    and w8a8 serves."""
    phase_check_cmdr()
    cfg, params = init_cut("command-r-plus-104b", CMDR_LAYERS)
    draw_norms(params, seed=2, leaves=CMDR_LEAVES)
    check_cmdr_layers("check-cmdr-layers", cfg, params)
    _free_card()
    label = "serve-cmdr"
    trace = lambda: dbrx_requests(cfg.vocab_size)
    serve = dict(engine_kw=DBRX_KW, trace=trace, ref_label=label,
                 layers_label="check-cmdr-w8a8-layers",
                 profile_pos=DBRX_DECODE_POS, hold=False)
    launches, outputs, eng = phase_serve_padded(
        cfg, params, label, keep_engine=True, **serve)
    decode_step_p50(label, eng, DBRX_DECODE_POS)
    serve_bounds(label, cfg, params)
    phase_serve_eager("serve-eager-cmdr", eng, launches, outputs, cfg,
                      params, engine_kw=DBRX_KW, trace=trace,
                      decode_pos=DBRX_DECODE_POS, identical=True)
    del eng
    _free_card()
    chunked, _, _ = phase_serve_padded(
        cfg, params, "serve-cmdr-chunked", mono_outputs=outputs,
        prefill_chunk=512, **serve)
    _free_card()
    ref = layers_reference(cfg, params, (512, 300, 77, 1), 1024)
    # on seed-0 weights the calibration's greedy argmax is noise (near-flat
    # logits): build every site, as serve-dbrx-w8a8 does; the layers check
    # holds the layers
    quant = build_released_w8a8("build-cmdr-w8a8", _int8_kv(cfg), params,
                                budget=1.0)
    quant_l, _, eng = phase_serve_padded(
        cfg, params, "serve-cmdr-w8a8", mono_outputs=outputs,
        precision="w8a8", quantized_params=quant, keep_engine=True,
        layers_ref=ref, **serve)
    n_int8 = sum(isinstance(m, QuantDense)
                 for m in eng.quant.params.modules())
    if n_int8 != 7 * cfg.num_layers:
        raise AssertionError(f"serve-cmdr-w8a8: {n_int8} int8 weights; want "
                             f"the 7 projections of each of "
                             f"{cfg.num_layers} layers")
    del eng, quant, params, ref
    _free_card()
    print(f"freed command-r-plus-104b: "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB still "
          f"allocated", flush=True)
    return {k: launches[k] + chunked[k] + quant_l[k]
            for k in ("flash_attn", "decode_attn", "w8a8_matmul",
                      "decode_attn_int8")}


def reduce_kimi(dtype: str, factor: float = 1.25):
    """check-kimi's configs at capacity factor ``factor``, each with expert
    weights padded past the router's experts: in f32 ``reduce_for_smoke``
    (2 layers of d_model 64, 4 heads over 4 kv heads of 16, 4 experts
    top-2 of d_expert 32, padded to 512); in bf16 2 layers of d_model 256,
    16 heads over 2 kv heads of 64 (kimi-k2's G 8), 12 experts top-8 of
    d_expert 256, padded to 16 (kimi-k2's 3 real experts in 4). Over 48
    experts top-8 a chip run saw 2.7% of the tokens routed otherwise on
    the host than on the card, past ``MOE_ROUTE_FLIPS``: with more
    experts the 8th and 9th routes lie closer together."""
    cfg = get_config("kimi-k2-1t-a32b")
    small = reduce_for_smoke(cfg)
    if dtype != "float32":
        small = dataclasses.replace(
            small, d_model=256, num_heads=16, num_kv_heads=2, head_dim=64,
            moe=dataclasses.replace(cfg.moe, num_experts=12, d_expert=256,
                                    num_padded_experts=16),
            param_dtype=dtype, activation_dtype=dtype)
    return dataclasses.replace(small, moe=dataclasses.replace(
        small.moe, capacity_factor=factor))


def phase_kimi() -> dict:
    """kimi-k2-1t-a32b's phases: ``phase_moe`` on its first
    ``KIMI_LAYERS`` layer (check-kimi, check-kimi-layers, serve-kimi with
    its bounds, serve-eager-kimi, serve-kimi-chunked, serve-kimi-w8a8,
    check-kimi-w8a8-layers)."""
    return phase_moe("kimi", "kimi-k2-1t-a32b", KIMI_LAYERS, reduce_kimi)


# ---- XLM-R ----------------------------------------------------------------

XLMR_BATCH = 8                  # the example's batch of sentences
XLMR_SENTENCES = 256
# the leaves init_params leaves at zero: biases and norm parameters
XLMR_DRAWN = ("bq", "bk", "bv", "bo", "b_up", "b_down", "bias", "scale")
XLMR_ENCODER_TOL = 0.05


def draw_biases(params, seed: int) -> None:
    """Every bias and norm parameter of ``params`` drawn from N(0, 0.5^2)
    by a seeded ``torch.Generator`` on its device, in place: they are zeros
    at init, where a port that dropped them would still agree."""
    gen = torch.Generator(device=model_mod.model_device(params)) \
        .manual_seed(seed)
    with torch.no_grad():
        for name, p in params.named_parameters():
            if name.rsplit(".", 1)[-1] in XLMR_DRAWN:
                p.copy_(0.5 * torch.randn(p.shape, generator=gen,
                                          device=p.device))


def reduce_xlmr(dtype: str):
    """XLM-R cut for the card-vs-host checks: ``reduce_for_smoke`` (2
    layers, d_model 64, 4 heads of head_dim 16) in f32, and in bf16 at the
    flash kernel's head_dim 64 (d_model 256, 4 heads of 64, d_ff 512)."""
    cfg = reduce_for_smoke(get_config("xlmr-paper"))
    if dtype == "float32":
        return cfg
    return dataclasses.replace(cfg, d_model=256, num_heads=4,
                               num_kv_heads=4, head_dim=64, d_ff=512,
                               param_dtype=dtype, activation_dtype=dtype)


def _pooled_in(params, cfg, sent, bucket: int, kv_valid: bool = True):
    """``sent``'s pooled embedding (d,) f32 in a batch of ``bucket``
    (beside an empty row); without ``kv_valid`` the forward attends the
    pads (the pooling still takes the real tokens only)."""
    toks, mask = pad_ragged_to_bucket([sent, sent[:0]], bucket)
    toks, mask = (torch.from_numpy(a).to(model_mod.model_device(params))
                  for a in (toks, mask))
    with torch.inference_mode():
        if kv_valid:
            return encode_pooled(params, cfg, toks, mask)[0].float().cpu()
        x, _ = model_mod.forward(params, cfg, {"tokens": toks}, mode="full",
                                 caches=None)
        m = mask.float()[..., None]
        return ((x.float() * m).sum(1) / m.sum(1).clamp(min=1.0))[0].cpu()


def bucket_invariance(label: str, params, cfg, tol: float) -> float:
    """A 20-token sentence pooled in buckets 32, 64 and 128: within ``tol``
    of one another; with ``kv_valid`` dropped the 32 and 64 buckets must
    differ past it. Returns the largest difference."""
    sent = np.random.default_rng(4).integers(0, cfg.vocab_size, 20) \
        .astype(np.int32)
    ref = _pooled_in(params, cfg, sent, 32)
    diff = max((_pooled_in(params, cfg, sent, b) - ref).abs().max().item()
               for b in (64, 128))
    unmasked = [_pooled_in(params, cfg, sent, b, kv_valid=False)
                for b in (32, 64)]
    fault = (unmasked[1] - unmasked[0]).abs().max().item()
    print(f"{label}: one sentence's pooled embedding in buckets 32, 64, 128: "
          f"max difference {diff:.3e} (tol {tol}); with kv_valid dropped, "
          f"buckets 32 vs 64 differ by {fault:.3e}", flush=True)
    if not diff <= tol:
        raise AssertionError(f"{label}: the pooled embedding depends on the "
                             f"bucket ({diff} > {tol})")
    if not fault > tol:
        raise AssertionError(f"{label}: with kv_valid dropped the buckets "
                             f"still agree ({fault} <= {tol}): the check "
                             f"cannot see a dropped mask")
    return diff


def phase_check_xlmr() -> None:
    """check-xlmr: ``reduce_xlmr`` in f32 and bf16 with every bias and norm
    parameter drawn nonzero: 24 sentences of 1-128 tokens in length-sorted
    batches of 8 over buckets 32/64/128, pooled on the card (graphed) and
    on the host (plain versions) from the same weights, within 2e-3 (f32)
    and 2e-2 (bf16); the graphed server's replays identical to an eager
    server's; then bucket invariance on the card."""
    buckets = (32, 64, 128)
    for dtype in ("float32", "bfloat16"):
        cfg = reduce_xlmr(dtype)
        dt = dtype_of(dtype)
        params = model_mod.init_params(cfg, seed=1, device=DEV)
        draw_biases(params, seed=2)
        host = copy.deepcopy(params).to("cpu")
        sents = xlmr_sentences(cfg.vocab_size, 24, seed=3, min_len=1,
                               max_len=128)
        batches = length_sorted_batches([len(s) for s in sents], XLMR_BATCH)
        graphed = EncoderServer(cfg, params, batch_size=XLMR_BATCH,
                                buckets=buckets)
        graphed.serve(sents, batches)                  # warm-up, capture
        got = graphed.serve(sents, batches)            # replays
        eager = EncoderServer(cfg, params, batch_size=XLMR_BATCH,
                              buckets=buckets, cuda_graphs=False)
        want_eager = eager.serve(sents, batches)
        want = EncoderServer(cfg, host, batch_size=XLMR_BATCH,
                             buckets=buckets).serve(sents, batches)
        label = f"check-xlmr[{dtype} hd {cfg.head_dim}]"
        err = compare(label, torch.from_numpy(got.embeds),
                      torch.from_numpy(want.embeds), dt)
        gap = np.abs(got.embeds - want_eager.embeds).max()
        ex = graphed.executor
        print(f"{label}: {len(sents)} sentences in {len(batches)} batches "
              f"over buckets {sorted(set(got.buckets))}: card (graphed, "
              f"{ex.captures['encode']} graphs, {ex.replays['encode']} "
              f"replays) vs host max abs err {err:.3e} (tol {TOL[dt]}); "
              f"graphed vs eager max abs difference {gap:.3e}", flush=True)
        if gap != 0:
            raise AssertionError(f"{label}: graphed and eager pooled "
                                 f"embeddings differ (max {gap})")
        if ex.captures["encode"] != graphed.exe.compile_count:
            raise AssertionError(f"{label}: {ex.captures['encode']} graphs "
                                 f"for {graphed.exe.compile_count} buckets")
        bucket_invariance(label, params, cfg, TOL[dt])
        del params, host, graphed, eager
        _free_card()


def _xlmr_launches() -> dict:
    return {"flash_attn": flash_attn.launches,
            "flash_attn non-causal": flash_attn.noncausal_launches,
            **{k: fn.launches for k, fn in LAUNCHERS.items()
               if k != "flash_attn"}}


def _serve_xlmr(label: str, srv, sents, batches):
    """One pass of ``batches`` with every launch counter zeroed just
    before and read just after; raises unless every sentence got a finite,
    nonzero embedding. Returns (the ``EncodeRun``, launches)."""
    _zero_launches()
    torch.cuda.synchronize()
    run = srv.serve(sents, batches)
    launches = _xlmr_launches()
    served = sorted(i for b in run.batches for i in b)
    if served != list(range(len(sents))):
        raise AssertionError(f"{label}: served {len(served)} of "
                             f"{len(sents)} sentences")
    if not np.isfinite(run.embeds).all() \
            or not (np.abs(run.embeds).sum(1) > 0).all():
        raise AssertionError(f"{label}: a pooled embedding is not finite or "
                             f"is zero")
    return run, launches


def phase_serve_xlmr(cfg, params) -> tuple:
    """serve-xlmr: 256 sentences of ``xlmr_sentences(seed=0, max_len=512)``
    in length-sorted batches of 8 through the per-bucket graphs (a warm-up
    pass captures them first), then the same sentences in arrival order;
    serve-eager-xlmr: the sorted batches through a ``cuda_graphs=False``
    server, launches equal and pooled outputs identical. Returns (the
    graphed sorted pass's launches, its ``EncodeRun``)."""
    sents = xlmr_sentences(cfg.vocab_size, XLMR_SENTENCES, seed=0, min_len=4,
                           max_len=SEQ_BUCKETS[-1])
    lengths = [len(s) for s in sents]
    naive = arrival_batches(len(sents), XLMR_BATCH)
    batches = length_sorted_batches(lengths, XLMR_BATCH)
    waste = [padding_waste(lengths, b, SEQ_BUCKETS) * 100
             for b in (naive, batches)]
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    srv = EncoderServer(cfg, params, batch_size=XLMR_BATCH,
                        buckets=SEQ_BUCKETS)
    t0 = time.perf_counter()
    srv.serve(sents, batches)
    warm_s = time.perf_counter() - t0
    ex = srv.executor
    warm_replays = ex.replays["encode"]
    run, launches = _serve_xlmr("serve-xlmr", srv, sents, batches)
    replays = ex.replays["encode"] - warm_replays
    peak = torch.cuda.max_memory_allocated()
    per_bucket = {b: len(s) for b, s in run.by_bucket().items()}
    print(f"serve-xlmr: xlmr-paper full width bf16, {cfg.num_layers} "
          f"layers, {len(sents)} sentences of {min(lengths)}-{max(lengths)} "
          f"tokens ({sum(lengths)} real tokens); padding waste: naive "
          f"batching {waste[0]:.2f}%, length-sorted {waste[1]:.2f}%; "
          f"batches per bucket {per_bucket}; graphs captured "
          f"{ex.captures['encode']}, one per stage key "
          f"{sorted(k for _, k in ex.cached_keys('encode'))} "
          f"({srv.exe.compile_count} buckets built; "
          f"warm-up pass {warm_s:.3f} s, capture seconds "
          f"{ex.capture_s['encode']:.3f}), replays in the timed pass "
          f"{replays}; "
          f"peak memory {peak / 2**30:.2f} GiB, "
          f"{(peak - base) / 2**30:.3f} GiB above the weights", flush=True)
    print("serve-xlmr: " + run.report().replace("\n", "\nserve-xlmr: "),
          flush=True)
    print(f"serve-xlmr: kernel launches {launches}", flush=True)
    if ex.captures["encode"] != srv.exe.compile_count \
            or replays != len(batches):
        raise AssertionError(f"serve-xlmr: {ex.captures['encode']} graphs "
                             f"for {srv.exe.compile_count} buckets, "
                             f"{replays} replays for {len(batches)} "
                             f"batches")
    if not 0 < launches["flash_attn non-causal"] == launches["flash_attn"]:
        raise AssertionError(f"serve-xlmr: flash launches {launches}: "
                             f"expected every one non-causal, and some")
    captured = ex.captures["encode"]
    arrival, _ = _serve_xlmr("serve-xlmr arrival order", srv, sents, naive)
    print(f"serve-xlmr: arrival order: {len(naive)} batches in "
          f"{arrival.wall_s:.4f} s against length-sorted {run.wall_s:.4f} s "
          f"(graphs captured in this pass: "
          f"{ex.captures['encode'] - captured}; neither time held)",
          flush=True)
    eager = EncoderServer(cfg, params, batch_size=XLMR_BATCH,
                          buckets=SEQ_BUCKETS, cuda_graphs=False)
    erun, elaunches = _serve_xlmr("serve-eager-xlmr", eager, sents, batches)
    gap = np.abs(erun.embeds - run.embeds).max()
    print("serve-eager-xlmr: " + erun.report().replace(
        "\n", "\nserve-eager-xlmr: "), flush=True)
    print(f"serve-eager-xlmr: launches {elaunches} (graphed {launches}); "
          f"pooled outputs max abs difference {gap:.3e}", flush=True)
    if elaunches != launches:
        raise AssertionError("serve-eager-xlmr: launches differ from the "
                             "graphed run's")
    if gap != 0:
        raise AssertionError(f"serve-eager-xlmr: pooled outputs differ (max "
                             f"{gap})")
    return launches, run


def check_xlmr_encoder(label: str, cfg, params) -> None:
    """8 sentences of 65-128 tokens at bucket 128 pooled by the full-width
    bf16 model and by an f32 copy of its weights, both on the card: the
    relative error ||bf16 - f32|| / ||f32|| over the batch within
    ``XLMR_ENCODER_TOL``, and three planted faults past it: causal
    attention, the lengths dropped (the pads attended), the biases
    dropped."""
    rng = np.random.default_rng(5)
    sents = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
             for n in rng.integers(65, 129, XLMR_BATCH)]
    toks, mask = pad_ragged_to_bucket(sents, 128)
    toks, mask = (torch.from_numpy(a).to(DEV) for a in (toks, mask))
    f32cfg = dataclasses.replace(cfg, param_dtype="float32",
                                 activation_dtype="float32")
    f32 = copy.deepcopy(params).float()
    with torch.inference_mode():
        want = encode_pooled(f32, f32cfg, toks, mask)
    del f32
    _free_card()
    biases = [p for n, p in params.named_parameters()
              if n.rsplit(".", 1)[-1] in ("bq", "bk", "bv", "b_up", "b_down")]

    def rel(fault=None) -> float:
        fcfg = dataclasses.replace(cfg, family="dense") \
            if fault == "causal" else cfg
        saved = [b.detach().clone() for b in biases]
        try:
            with torch.inference_mode():
                if fault == "biases":
                    for b in biases:
                        b.zero_()
                if fault == "lens":
                    x, _ = model_mod.forward(params, cfg, {"tokens": toks},
                                             mode="full", caches=None)
                    m = mask.float()[..., None]
                    got = (x.float() * m).sum(1) / m.sum(1).clamp(min=1.0)
                else:
                    got = encode_pooled(params, fcfg, toks, mask)
        finally:
            with torch.no_grad():
                for b, s in zip(biases, saved):
                    b.copy_(s)
        if not torch.isfinite(got).all():
            return float("inf")
        return ((got - want).norm() / want.norm()).item()

    err = rel()
    faults = {"causal attention": rel("causal"),
              "lens dropped (pads attended)": rel("lens"),
              "biases dropped": rel("biases")}
    if rel() != err:
        raise AssertionError(f"{label}: the output changed after the "
                             f"planted faults were undone")
    print(f"{label}: {XLMR_BATCH} sentences of "
          f"{sorted(len(s) for s in sents)} tokens at bucket 128: bf16 vs "
          f"f32 weights on {DEV}, ||bf16 - f32|| / ||f32|| {err:.4f} (tol "
          f"{XLMR_ENCODER_TOL}); planted faults: " + ", ".join(
              f"{k} {v:.4f}" for k, v in faults.items()), flush=True)
    if not err <= XLMR_ENCODER_TOL:
        raise AssertionError(f"{label}: error {err} > {XLMR_ENCODER_TOL}")
    for name, e in faults.items():
        if not e > XLMR_ENCODER_TOL:
            raise AssertionError(f"{label}: the planted fault '{name}' stays "
                                 f"within the tolerance ({e} <= "
                                 f"{XLMR_ENCODER_TOL}): the check cannot "
                                 f"see it")


def phase_serve_xlmr_launcher() -> None:
    """The launcher's ``--arch xlmr-paper --full-config`` on the card: its
    own seed-0 weights, 256 sentences in batches of 8, one captured graph
    per bucket reached."""
    srv, run = serve_launcher.main(
        ["--arch", "xlmr-paper", "--full-config", "--requests",
         str(XLMR_SENTENCES), "--slots", str(XLMR_BATCH)])
    captures, graphs = srv.executor.captures["encode"], srv.executor.graphs
    reached = len(set(run.buckets))
    print(f"serve-xlmr-launcher: {len(run.embeds)} sentences through "
          f"{captures} graphs for {reached} buckets reached", flush=True)
    if not (graphs and captures == reached == srv.exe.compile_count):
        raise AssertionError(f"serve-xlmr-launcher: {captures} graphs for "
                             f"{reached} buckets")
    del srv, run             # the server's stages hold its weights
    _free_card()


def phase_xlmr() -> dict:
    """check-xlmr, then full-width xlmr-paper (24 layers, d_model 1024, 16
    heads of 64, d_ff 4096, vocab 250002 padded to 250112; ~1.04 GiB of
    random bf16 weights from seed 0, every bias and norm parameter drawn
    nonzero): serve-xlmr and serve-eager-xlmr, check-xlmr-encoder, then the
    launcher's own run. Frees the weights; returns the flash launches of
    the graphed sorted serve."""
    phase_check_xlmr()
    cfg = get_config("xlmr-paper")
    t0 = time.perf_counter()
    params = model_mod.init_params(cfg, seed=0, device=DEV)
    draw_biases(params, seed=1)
    torch.cuda.synchronize()
    print(f"init: xlmr-paper full width, "
          f"{sum(p.numel() for p in params.parameters()) / 1e6:.3f} M "
          f"params, {torch.cuda.memory_allocated() / 2**30:.2f} GiB, in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    launches, _ = phase_serve_xlmr(cfg, params)
    check_xlmr_encoder("check-xlmr-encoder", cfg, params)
    del params
    _free_card()
    phase_serve_xlmr_launcher()
    print(f"freed xlmr-paper: {torch.cuda.memory_allocated() / 2**30:.2f} "
          f"GiB still allocated", flush=True)
    return {"flash_attn": launches["flash_attn"]}


# ---- whisper-medium ---------------------------------------------------------

WHISPER_BATCH = 8               # rows of 30-second windows a batch
WHISPER_NEW_TOKENS = 64
# check-whisper-layers' bound: bf16 vs f32 read 0.0083-0.0089 on every
# probe at full width, the faults 0.034 (half the frames) and up
WHISPER_LAYERS_TOL = 0.02
WHISPER_LAYERS_LENS = (16, 4, 9, 4)     # check-whisper-layers' prompts


def reduce_whisper(dtype: str):
    """whisper-medium cut for the card-vs-host checks: ``reduce_for_smoke``
    (2 encoder + 2 decoder layers, d_model 64, 4 heads of head_dim 16) in
    f32, and in bf16 at the kernels' head_dim 64 (d_model 256, 4 heads of
    64, d_ff 512)."""
    cfg = reduce_for_smoke(get_config("whisper-medium"))
    if dtype == "float32":
        return cfg
    return dataclasses.replace(cfg, d_model=256, num_heads=4,
                               num_kv_heads=4, head_dim=64, d_ff=512,
                               param_dtype=dtype, activation_dtype=dtype)


def _prompt_batch(prompts, device):
    """Right-padded prompts: tokens (B, P) int32, mask (B, P), lengths
    (B,) int32, on ``device``."""
    lens = torch.tensor([len(p) for p in prompts], dtype=torch.int32)
    P = int(lens.max())
    toks = torch.zeros(len(prompts), P, dtype=torch.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = torch.from_numpy(p)
    valid = torch.arange(P)[None, :] < lens[:, None]
    return toks.to(device), valid.to(device), lens.to(device)


def _whisper_steps(params, cfg, enc, prompts, nxt):
    """Through the model layer: the encoder's output (B, T, d) and the
    hidden states after each row's prompt and after each decode step
    feeding ``nxt`` (B, n) at the row's own positions, (n + 1, B, d); both
    f32 on the host."""
    dev = model_mod.model_device(params)
    toks, valid, lens = _prompt_batch(prompts, dev)
    B, enc_t = len(prompts), torch.from_numpy(enc).to(dev)
    with torch.inference_mode():
        enc_out = model_mod.encode(params, cfg, enc_t)
        caches = model_mod.init_caches(cfg, B, cfg.encdec.max_target_len,
                                       dev, enc_len=enc.shape[1])
        x, caches = model_mod.forward(
            params, cfg, {"tokens": toks, "enc_embeds": enc_t},
            mode="prefill", caches=caches, kv_valid=valid)
        hs = [x[torch.arange(B, device=dev), lens.long() - 1]]
        for i in range(nxt.shape[1]):
            h, caches = model_mod.decode_step(
                params, cfg, torch.from_numpy(nxt[:, i:i + 1]).to(dev),
                caches, lens + i)
            hs.append(h)
    return enc_out.float().cpu(), torch.stack(hs).float().cpu()


def _hold_hidden(name: str, got: torch.Tensor, want: torch.Tensor,
                 dtype) -> str:
    """Card hidden states against the host's: elementwise within 2e-3 in
    f32 (``compare``); in bf16 ||got - want|| / ||want|| within 2e-2, as
    the CPU tests hold the port to the reference: bf16 products summed in
    another order on the card leave a few of a bf16 layer's outputs some
    ulps apart (0.0625 at most of 2 layers' encoder outputs), an
    elementwise bound with no room for them. Returns what it measured."""
    if dtype == torch.float32:
        return f"max abs err {compare(name, got, want, dtype):.3e}"
    err = (got.float() - want.float()).abs().max().item()
    rel = ((got.float() - want.float()).norm() / want.float().norm()).item()
    if not (torch.isfinite(got).all() and rel <= TOL[dtype]):
        raise AssertionError(f"{name}: card vs host relative error {rel} "
                             f"(max abs err {err:.3e}), tol {TOL[dtype]}")
    return f"relative error {rel:.3e} (max abs err {err:.3e})"


def phase_check_whisper() -> None:
    """check-whisper: ``reduce_whisper`` in f32 and bf16, every bias and
    norm parameter drawn nonzero, 4 rows of 1500 frames: the encoder's
    output and the hidden states of a prefill and 8 decode steps on the
    card against the host's plain versions (``_hold_hidden``); then two
    batches through one graphed server (its stages captured on the
    first), the second's tokens and caches bit for bit an eager server's;
    card vs host tokens printed."""
    B = 4
    for dtype in ("float32", "bfloat16"):
        cfg = reduce_whisper(dtype)
        dt = dtype_of(dtype)
        params = model_mod.init_params(cfg, seed=1, device=DEV)
        draw_biases(params, seed=2)
        host = copy.deepcopy(params).to("cpu")
        enc, prompts = stub_batch(cfg, B, seed=3)
        nxt = np.random.default_rng(4).integers(
            0, cfg.vocab_size, (B, 8)).astype(np.int32)
        label = f"check-whisper[{dtype} hd {cfg.head_dim}]"
        got = _whisper_steps(params, cfg, enc, prompts, nxt)
        want = _whisper_steps(host, cfg, enc, prompts, nxt)
        e_enc, e_dec = (_hold_hidden(f"{label} {what}", g, w, dt)
                        for what, g, w in zip(("encoder", "decoder"), got,
                                              want))
        kw = dict(batch_size=B, max_len=cfg.encdec.max_target_len)
        graphed = EncDecServer(cfg, params, **kw)
        graphed.transcribe(*stub_batch(cfg, B, seed=5), 16)
        run = graphed.transcribe(*stub_batch(cfg, B, seed=6), 16)
        eager = EncDecServer(cfg, params, cuda_graphs=False, **kw)
        erun = eager.transcribe(*stub_batch(cfg, B, seed=6), 16)
        hrun = EncDecServer(cfg, host, **kw).transcribe(
            *stub_batch(cfg, B, seed=6), 16)
        gap = _cache_diff(graphed, eager)
        ex = graphed.executor
        agree = token_agreement(list(zip(run.tokens.tolist(),
                                         hrun.tokens.tolist())))
        print(f"{label}: {B} rows x {enc.shape[1]} frames: card vs host, "
              f"encoder {e_enc}, prefill + 8 decode steps {e_dec} (tol "
              f"{TOL[dt]}); graphed (captures "
              f"{dict(ex.captures)}, replays {dict(ex.replays)}) vs eager "
              f"on the second batch: tokens identical "
              f"{np.array_equal(run.tokens, erun.tokens)}, caches max abs "
              f"difference {gap:.3e}; card vs host greedy agreement "
              f"{agree:.4f} (printed, not held)", flush=True)
        if not np.array_equal(run.tokens, erun.tokens) or gap != 0:
            raise AssertionError(f"{label}: graphed and eager differ "
                                 f"(caches {gap})")
        if dict(ex.captures) != {"encdec_prefill": 1, "encdec_decode": 1}:
            raise AssertionError(f"{label}: captures {dict(ex.captures)}")
        del params, host, graphed, eager
        _free_card()


def _whisper_launches() -> dict:
    return {"flash_attn": flash_attn.launches,
            "flash_attn non-causal": flash_attn.noncausal_launches,
            **{k: fn.launches for k, fn in LAUNCHERS.items()
               if k != "flash_attn"}}


def _serve_whisper(label: str, srv, batch):
    """One batch of ``WHISPER_NEW_TOKENS`` tokens a row with every launch
    counter zeroed just before and read just after. Returns (the
    ``TranscribeRun``, launches)."""
    _zero_launches()
    torch.cuda.synchronize()
    run = srv.transcribe(*batch, WHISPER_NEW_TOKENS)
    launches = _whisper_launches()
    if run.tokens.shape != (WHISPER_BATCH, WHISPER_NEW_TOKENS) or not (
            (run.tokens >= 0) & (run.tokens < srv.cfg.vocab_size)).all():
        raise AssertionError(f"{label}: tokens {run.tokens.shape} outside "
                             f"the vocabulary or short")
    return run, launches


def phase_serve_whisper(cfg, params) -> dict:
    """serve-whisper: batches of 8 rows x 1500 frames and 4-16 token
    prompts, 64 greedy tokens a row, through ``EncDecServer``'s graphed
    stages: a warm-up batch (seed 0) captures both, then a timed batch
    (seed 1), one prefill replay and 63 decode replays; every launch
    counted (flash: 24 encoder, 24 self and 24 cross layers a prefill, the
    encoder's and the cross ones non-causal; decode: 48 a step, self and
    cross); then ``profile_whisper``. serve-eager-whisper: the timed
    batch through a ``cuda_graphs=False`` server, launches equal and
    tokens identical. Returns the graphed batch's launches."""
    L, n = cfg.num_layers, WHISPER_NEW_TOKENS
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    srv = EncDecServer(cfg, params, batch_size=WHISPER_BATCH)
    t0 = time.perf_counter()
    srv.transcribe(*stub_batch(cfg, WHISPER_BATCH, seed=0), n)
    warm_s = time.perf_counter() - t0
    ex = srv.executor
    replays = dict(ex.replays)
    batch = stub_batch(cfg, WHISPER_BATCH, seed=1)
    run, launches = _serve_whisper("serve-whisper", srv, batch)
    replays = {k: ex.replays[k] - replays.get(k, 0) for k in ex.replays}
    peak = torch.cuda.max_memory_allocated()
    print(f"serve-whisper: whisper-medium full width bf16 "
          f"({cfg.encdec.encoder_layers} + {L} layers, d_model "
          f"{cfg.d_model}), {WHISPER_BATCH} rows x {srv.enc_frames} frames, "
          f"prompts of {sorted(len(p) for p in batch[1])} tokens, {n} new "
          f"tokens a row, on {card_line()}: " + run.report(), flush=True)
    print(f"serve-whisper: graphs captured {dict(ex.captures)} (capture "
          f"seconds {sum(ex.capture_s.values()):.3f}; warm-up batch "
          f"{warm_s:.3f} s), replays in the timed batch {replays}; peak "
          f"memory {peak / 2**30:.2f} GiB, {(peak - base) / 2**30:.3f} GiB "
          f"above the weights; kernel launches {launches}", flush=True)
    want = {"flash_attn": 3 * L, "flash_attn non-causal": 2 * L,
            "decode_attn": 2 * L * (n - 1)}
    if {k: launches[k] for k in want} != want \
            or any(launches[k] for k in ("w8a8_matmul", "decode_attn_int8")):
        raise AssertionError(f"serve-whisper: launches {launches}, expected "
                             f"{want} and no w8a8 or int8 decode")
    if replays != {"encdec_prefill": 1, "encdec_decode": n - 1} \
            or dict(ex.captures) != {"encdec_prefill": 1,
                                     "encdec_decode": 1}:
        raise AssertionError(f"serve-whisper: captures {dict(ex.captures)}, "
                             f"replays {replays}")
    profile_whisper(srv, batch)
    eager = EncDecServer(cfg, params, batch_size=WHISPER_BATCH,
                         cuda_graphs=False)
    erun, elaunches = _serve_whisper("serve-eager-whisper", eager, batch)
    print(f"serve-eager-whisper: {erun.report()}; launches {elaunches}; "
          f"tokens identical to the graphed batch's "
          f"{np.array_equal(erun.tokens, run.tokens)}", flush=True)
    if elaunches != launches:
        raise AssertionError("serve-eager-whisper: launches differ from the "
                             "graphed batch's")
    if not np.array_equal(erun.tokens, run.tokens):
        first = _first_divergence(erun.tokens.tolist(), run.tokens.tolist())
        raise AssertionError(f"serve-eager-whisper: tokens differ from the "
                             f"graphed batch's ({first})")
    del srv, eager
    _free_card()
    return launches


def profile_whisper(srv, batch) -> None:
    """profile-whisper: one encoder + prefill stage call and 8 decode stage
    calls (one graph replay each) of the graphed server on ``batch``, the
    decode rows 48 positions past their prompts: wall time, device busy
    share, the kernel groups' shares, the top kernels."""
    ex, B, P = srv.executor, srv.batch_size, srv.prompt_len
    enc, prompts = batch
    lens = np.array([len(p) for p in prompts], np.int32)
    toks = np.zeros((B, P), np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    prefill = ex.get("encdec_prefill", B, srv.prefill_stage)
    decode = ex.get("encdec_decode", B, srv.decode_stage)
    inputs = {"enc_embeds": torch.from_numpy(enc).to(torch.bfloat16),
              "tokens": toks, "kv_valid": np.arange(P)[None] < lens[:, None]}
    profile_window(f"profile-whisper: encoder + prefill stage call, {B} rows "
                   f"x {srv.enc_frames} frames", lambda: prefill(inputs), 1)

    def steps():
        t = np.zeros((B, 1), np.int32)
        for i in range(8):
            t = decode({"tokens": t, "pos": lens + 48 + i})[:, None]

    profile_window(f"profile-whisper: decode stage call, {B} rows at pos "
                   f"{(lens + 48).tolist()}+", steps, 8)


class _WhisperFault:
    """A planted fault of the enc-dec path, while the ``with`` block runs:
    "cross query rotated" (RoPE on the cross query at the positions the
    layer's self-attention uses: 0..S-1 at prefill, ``pos`` at decode),
    "causal encoder", "cross-attention dropped", "decode cross cut to
    half the frames"."""

    def __init__(self, name: str):
        self.name, self.saved = name, []

    def _set(self, mod, attr, fn):
        self.saved.append((mod, attr, getattr(mod, attr)))
        setattr(mod, attr, fn)

    def __enter__(self):
        apply, project = blk_mod.apply_block, attn_mod._project_q
        cross = attn_mod.cross_attention
        if self.name == "cross query rotated":
            where = {}

            def recording(*a, **kw):
                pos = kw.get("pos")
                where["p"] = kw["positions"] if kw.get("positions") \
                    is not None else (None if pos is None else pos[:, None])
                return apply(*a, **kw)

            def rotated(p, x, cfg, positions):
                return project(p, x, cfg, where["p"] if positions is None
                               else positions)

            self._set(blk_mod, "apply_block", recording)
            self._set(attn_mod, "_project_q", rotated)
        elif self.name == "causal encoder":
            self._set(blk_mod, "apply_block",
                      lambda *a, **kw: apply(*a, **{**kw, "causal": True}))
        elif self.name == "cross-attention dropped":
            self._set(attn_mod, "cross_attention",
                      lambda p, x, *a, **kw: torch.zeros_like(x))
        elif self.name == "decode cross cut to half the frames":
            def cut(p, x, ck, cv, cfg, *, mode, kv_valid=None):
                if mode == "decode":
                    n = ck.shape[1] // 2
                    ck, cv = ck[:, :n].contiguous(), cv[:, :n].contiguous()
                return cross(p, x, ck, cv, cfg, mode=mode, kv_valid=kv_valid)

            self._set(attn_mod, "cross_attention", cut)
        else:
            raise ValueError(self.name)
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in reversed(self.saved):
            setattr(mod, attr, fn)


WHISPER_FAULTS = ("cross query rotated", "causal encoder",
                  "cross-attention dropped",
                  "decode cross cut to half the frames")


def _whisper_layers_step(params, cfg, enc_t, toks, valid, lens, nxt):
    """The encoder's output (B, T, d) and one decode step's final hidden
    state (B, d) after a prefill of the prompts, both f32."""
    with torch.inference_mode():
        enc_out = model_mod.encode(params, cfg, enc_t).float()
        caches = model_mod.init_caches(cfg, toks.shape[0],
                                       cfg.encdec.max_target_len, DEV,
                                       enc_len=enc_t.shape[1])
        model_mod.forward(params, cfg, {"tokens": toks, "enc_embeds": enc_t},
                          mode="prefill", caches=caches, kv_valid=valid)
        h, _ = model_mod.decode_step(params, cfg, nxt, caches, lens)
    return enc_out, h.float()


class _FramesAsEncoder:
    """While the ``with`` block runs, ``model.encode`` returns its frames
    (in the activation dtype) as the encoder's output: the decoder then
    reads cross K/V built from them."""

    def __enter__(self):
        self.saved = model_mod.encode
        model_mod.encode = lambda params, cfg, x, valid=None: x.to(
            dtype_of(cfg.activation_dtype))
        return self

    def __exit__(self, *exc):
        model_mod.encode = self.saved


def _cross_spread(params, cfg, x) -> str:
    """How unevenly the last decoder layer's cross-attention reads the
    frames ``x`` (B, T, d) as the encoder's output would be, for random
    queries: the std of its logits over the frames and the frames it
    effectively averages, 1 / sum p^2 (T: a uniform read)."""
    lay = params.layers[-1]
    gen = torch.Generator(device=DEV).manual_seed(10)
    with torch.inference_mode():
        k, _ = attn_mod.cross_kv(lay.xattn, model_mod.encode(params, cfg, x),
                                 cfg)
        h = torch.randn((x.shape[0], 1, cfg.d_model), generator=gen,
                        device=DEV).to(k.dtype)
        q = attn_mod._project_q(lay.xattn, lay.xattn_norm(h, cfg.norm_eps),
                                cfg, None)
        logits = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) \
            * cfg.head_dim ** -0.5
        p = torch.softmax(logits, -1)
        return (f"logits' std over the frames "
                f"{logits.std(-1).mean().item():.4f}, effective frames "
                f"{(1 / p.square().sum(-1)).mean().item():.1f} of "
                f"{x.shape[1]}")


def check_whisper_layers(label: str, cfg, params,
                         lens=WHISPER_LAYERS_LENS) -> None:
    """The full-width bf16 model against an f32 copy of its weights, both
    on the card, 4 rows of 1500 frames and prompts of 16, 4, 9, 4 tokens,
    in two probes. "model": the stub frames through the encoder; its
    output's error ||bf16 - f32|| / ||f32||, and one decode step's final
    hidden state's error over what the decoder adds to it, ||h_bf16 -
    h_f32|| / ||h_f32 - h_embed|| (``h_embed`` the final norm of the
    embedded token alone). "frames": the same decode step with N(0, 1)
    frames standing for the encoder's output (``_FramesAsEncoder``).
    Random weights collapse the encoder's 1500 outputs to nearly one
    vector (the last layer's cross logits' std over the frames ~0.03: every
    frame read alike), under which a fault in which frames a query reads
    cannot show; N(0, 1) frames spread them (std ~1.3, ~290 frames read in
    effect; ``_cross_spread`` prints both).
    Every error within ``WHISPER_LAYERS_TOL``; each planted fault
    (``_WhisperFault``) must take a decode step's error past it in one
    probe at least (the encoder's in "model" for the causal encoder).
    Greedy tokens of random weights can agree over broken layers."""
    enc = stub_batch(cfg, len(lens), seed=7)[0]
    rng = np.random.default_rng(9)
    toks, valid, lens = _prompt_batch(
        [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in lens],
        DEV)
    nxt = torch.randint(0, cfg.vocab_size, (len(lens), 1), dtype=torch.int32,
                        generator=torch.Generator().manual_seed(8)).to(DEV)
    frames = {"model": torch.from_numpy(enc).to(DEV),
              "frames": torch.from_numpy(enc * np.float32(10.0)).to(DEV)}
    probe = {"model": contextlib.nullcontext, "frames": _FramesAsEncoder}
    f32cfg = dataclasses.replace(cfg, param_dtype="float32",
                                 activation_dtype="float32")
    f32 = copy.deepcopy(params).float()
    want = {}
    for k, x in frames.items():
        with probe[k]():
            want[k] = _whisper_layers_step(f32, f32cfg, x, toks, valid,
                                           lens, nxt)
    with torch.inference_mode():
        h_embed = f32.final_norm(vocab_mod.embed_lookup(
            f32.embed, nxt, f32cfg), cfg.norm_eps)[:, 0].float()
    del f32
    _free_card()
    dt = dtype_of(cfg.activation_dtype)

    def errs():
        """(the encoder's error, the decode step's in "model", the decode
        step's in "frames")."""
        out = []
        for k, x in frames.items():
            with probe[k]():
                got_enc, got = _whisper_layers_step(params, cfg, x.to(dt),
                                                    toks, valid, lens, nxt)
            if not (torch.isfinite(got_enc).all()
                    and torch.isfinite(got).all()):
                return (float("inf"),) * 3
            w_enc, w = want[k]
            if k == "model":
                out.append(((got_enc - w_enc).norm() / w_enc.norm()).item())
            out.append(((got - w).norm() / (w - h_embed).norm()).item())
        return tuple(out)

    err = errs()
    faults = {}
    for name in WHISPER_FAULTS:
        with _WhisperFault(name):
            faults[name] = errs()
    if errs() != err:
        raise AssertionError(f"{label}: the output changed after the "
                             f"planted faults were undone")
    for k, x in frames.items():
        with probe[k]():
            print(f"{label}: {k}: the last layer's cross-attention, "
                  f"{_cross_spread(params, cfg, x.to(dt))}", flush=True)
    moved = {k: ((w - h_embed).norm() / w.norm()).item()
             for k, (_, w) in want.items()}
    print(f"{label}: {len(lens)} rows x {enc.shape[1]} frames, prompts "
          f"{lens.tolist()}; the decoder moves the f32 decode step's hidden "
          f"state by {moved['model']:.4f} (model) and {moved['frames']:.4f} "
          f"(frames) of its norm; errors (encoder, decode step in model, "
          f"decode step in frames), bf16 vs f32 on {DEV}: "
          + ", ".join(f"{e:.4f}" for e in err)
          + f" (tol {WHISPER_LAYERS_TOL}); planted faults: " + "; ".join(
              f"{k} " + ", ".join(f"{e:.4f}" for e in v)
              for k, v in faults.items()), flush=True)
    if not max(err) <= WHISPER_LAYERS_TOL:
        raise AssertionError(f"{label}: error {err} > {WHISPER_LAYERS_TOL}")
    for name, e in faults.items():
        if not max(e) > WHISPER_LAYERS_TOL:
            raise AssertionError(f"{label}: the planted fault '{name}' stays "
                                 f"within the tolerance ({e} <= "
                                 f"{WHISPER_LAYERS_TOL}): the check cannot "
                                 f"see it")


def phase_whisper() -> dict:
    """check-whisper, then full-width whisper-medium (24 encoder and 24
    decoder layers, d_model 1024, 16 heads of 64, GELU d_ff 4096 with
    biases, LayerNorm, tied vocab 51865 padded to 51968; 758.6 M random
    bf16 parameters from seed 0, every bias and norm parameter drawn
    nonzero): serve-whisper and serve-eager-whisper, then
    check-whisper-layers. Frees the weights; returns the graphed serve's
    flash and decode launches."""
    phase_check_whisper()
    cfg = get_config("whisper-medium")
    t0 = time.perf_counter()
    params = model_mod.init_params(cfg, seed=0, device=DEV)
    draw_biases(params, seed=1)
    torch.cuda.synchronize()
    print(f"init: whisper-medium full width, "
          f"{sum(p.numel() for p in params.parameters()) / 1e6:.3f} M "
          f"params, {torch.cuda.memory_allocated() / 2**30:.2f} GiB, in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    launches = phase_serve_whisper(cfg, params)
    check_whisper_layers("check-whisper-layers", cfg, params)
    del params
    _free_card()
    print(f"freed whisper-medium: {torch.cuda.memory_allocated() / 2**30:.2f}"
          f" GiB still allocated", flush=True)
    return {k: launches[k] for k in ("flash_attn", "decode_attn")}


# ---- DLRM -------------------------------------------------------------------

DLRM_REQUESTS, DLRM_BATCH = 64, 64
DLRM_SHARES = {"matmul kernels": MATMUL_KERNEL_NAMES,
               "sls_kernel": ("sls_kernel",)}


def _zero_launches() -> None:
    for fn in LAUNCHERS.values():
        fn.launches = 0
    flash_attn.offset_launches = 0
    flash_attn.window_launches = 0
    flash_attn.noncausal_launches = 0


def _require_sls(label: str, launches: dict, kind: str, n: int) -> None:
    """``kind`` ran once a request and the other SLS kernels not at all."""
    want = {k: (n if k == kind else 0) for k in SLS_PLAIN}
    got = {k: launches[k] for k in SLS_PLAIN}
    if got != want:
        raise AssertionError(f"{label}: SLS launches {got}, expected {want}")


def phase_serve_dlrm():
    """DLRM serving at PAPER_COMPLEX's published widths on one card (every
    table halved: the int8 slab of the full table set, 117 GB, does not fit
    80 GB). Returns (int8 SLS launches, the engine, one batch)."""
    cfg = dlrm_paper.PAPER_COMPLEX_ONE_CARD
    asn = dlrm_mod.make_assignment(cfg, 1)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = dlrm_mod.init_dlrm(cfg, asn,
                                torch.Generator(device=DEV).manual_seed(0),
                                DEV, quantize=True)
    torch.cuda.synchronize()
    slab = params["slab_q"]
    slab_gb = sum(t.numel() * t.element_size() for t in slab.values()) / 1e9
    print(f"init-dlrm: {cfg.name}, {cfg.num_tables} tables, "
          f"{asn.total_rows} slab rows x {cfg.embed_dim} in int8 "
          f"({slab_gb:.2f} GB with fp16 scale and bias) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    eng = DLRMEngine(cfg, asn, params, device=DEV)
    t0 = time.perf_counter()
    batches = [next(dlrm_batches(cfg, DLRM_BATCH, seed=s))
               for s in range(DLRM_REQUESTS)]
    print(f"serve-dlrm: {DLRM_REQUESTS} batches of {DLRM_BATCH} made in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    # full-trace warm-up, excluded from latency and transfer stats, as the
    # JAX launcher does
    eng.serve(batches, pipelined=True, warm=True)
    _zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs, stats = eng.serve(batches, pipelined=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in LAUNCHERS.items()}
    tel = eng.telemetry
    lat = tel.latency_percentiles()
    print(f"serve-dlrm: served {tel.served}/{DLRM_REQUESTS} requests of "
          f"{DLRM_BATCH} in {wall:.3f} s, "
          f"{DLRM_REQUESTS * DLRM_BATCH / wall:.0f} items/s, latency p50 "
          f"{lat['p50']:.3f} ms p99 {lat['p99']:.3f} ms (all submitted at "
          f"once), transfer bytes saved "
          f"{100 * eng.transfer_stats.bytes_saved_frac:.1f}%, slab "
          f"{slab_gb:.2f} GB, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    print(f"serve-dlrm: kernel launches {launches}", flush=True)
    if tel.served != DLRM_REQUESTS:
        raise AssertionError(f"served {tel.served} of {DLRM_REQUESTS}")
    bad = [i for i, o in enumerate(outs)
           if o.shape != (DLRM_BATCH,) or not torch.isfinite(o).all()]
    if bad:
        raise AssertionError(f"serve-dlrm: requests {bad} gave no finite "
                             f"({DLRM_BATCH},) logits")
    _require_sls("serve-dlrm", launches, "sls_int8", DLRM_REQUESTS)
    # per-stage times: a measured re-run outside the counted window
    _, mstats = eng.serve(batches, pipelined=True, warm=True, measure=True)
    print("serve-dlrm: stage times (sequential, per request) " + ", ".join(
        f"{k} {1e3 * v / DLRM_REQUESTS:.3f} ms"
        for k, v in mstats.stage_time_s.items()), flush=True)
    # one request against the plain version on the same 58.6 GB slab
    x = eng.ingest(batches[0])
    idx, lens = x["sls"]
    with torch.inference_mode():
        pooled = dlrm_mod.sls_forward(params, cfg, asn, idx, lens)
        B, T, L = idx.shape
        gidx = idx + torch.tensor(asn.table_offset, dtype=torch.int32,
                                  device=DEV)[None, :, None]
        want = sls_int8_ref(slab["q8"], slab["scale"], slab["bias"],
                            gidx.reshape(B * T, L),
                            lens.reshape(-1)).reshape(B, T, -1)
        err = compare("serve-dlrm pooled", pooled, want, torch.float32,
                      tol=SLS_TOL["sls_int8"])
        logits = dlrm_mod.dense_forward(params, cfg, x["dense"], want)
        lerr = compare("serve-dlrm logits", outs[0], logits, torch.float32)
    keep = torch.arange(L, device=DEV)[None, None, :] < lens[..., None]
    top = gidx[keep].max().item()
    print(f"serve-dlrm: request 0 pooled {tuple(pooled.shape)} within "
          f"{err:.3e} of the plain version on the same slab, logits within "
          f"{lerr:.3e} of the dense stage on it; highest row read {top} "
          f"(byte offset {top * cfg.embed_dim}; 2^32 is {2**32})",
          flush=True)
    phase_dense_graphs(eng, cfg, asn, params, x["dense"], pooled)
    return launches["sls_int8"], eng, (cfg, asn, params, batches, outs)


def wall_ms(fn, iters: int = 50, warmup: int = 3) -> float:
    """Mean host wall time of one call of ``fn`` to its completion (a
    synchronise after every call)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def phase_dense_graphs(eng, cfg, asn, params, dense_x, pooled) -> None:
    """The serve engine's dense stage (one graph replay a call) against an
    eager twin's (``cuda_graphs=False``, the same parameters) on one
    request's inputs, in the same run: the time of a call to completion,
    the logits held within 2e-3 of each other, and one traced call each."""
    eager = DLRMEngine(cfg, asn, params, device=DEV, cuda_graphs=False)
    B = pooled.shape[0]
    inputs = {"pooled": pooled, "dense_x": dense_x}
    outs, ms = {}, {}
    for e, tag in ((eng, "graphed"), (eager, "eager")):
        run = e.executor.get("dense", (), e._build_dense)
        call = lambda run=run: run(inputs, variant=B)
        outs[tag] = call()
        ms[tag] = wall_ms(call)
        profile_window(f"dlrm dense stage, {tag}, batch {B}", call, 1,
                       shares=DLRM_SHARES)
    err = compare("serve-dlrm dense stage graphed vs eager", outs["graphed"],
                  outs["eager"], torch.float32)
    print(f"serve-dlrm: dense stage, batch {B}: {ms['graphed']:.4f} ms "
          f"graphed (one replay) vs {ms['eager']:.4f} ms eager, a call to "
          f"completion; logits max abs difference {err:.3e}; "
          f"{_graph_counts(eng)}", flush=True)


def phase_profile_dlrm(eng, batch) -> None:
    """One traced pipeline pass (ingest, sparse, dense, post) of a batch."""
    profile_window(f"dlrm pipeline pass, batch {DLRM_BATCH}",
                   lambda: eng.serve([batch], pipelined=True, warm=True), 1,
                   shares=DLRM_SHARES)


def phase_check_dlrm() -> dict:
    """Reduced PAPER_COMPLEX with an fp32, an int8 and an int4 slab: the
    same weights served on the card and on the host. Returns each SLS
    kernel's launches on its card run."""
    base = dlrm_paper.reduce_for_smoke(dlrm_paper.PAPER_COMPLEX)
    batches = [next(dlrm_batches(base, 16, seed=s)) for s in range(4)]
    launches = {}
    for bits, kind in ((None, "sls_fp"), (8, "sls_int8"), (4, "sls_int4")):
        cfg = dataclasses.replace(base, quant=dataclasses.replace(
            base.quant, embedding_bits=bits or 8))
        asn = dlrm_mod.make_assignment(cfg, 1)
        host = dlrm_mod.init_dlrm(cfg, asn, torch.Generator().manual_seed(0),
                                  "cpu", quantize=bits is not None)
        card = dlrm_mod.params_to(host, DEV)
        eng = DLRMEngine(cfg, asn, card, device=DEV)
        _zero_launches()
        outs, _ = eng.serve(batches)
        torch.cuda.synchronize()
        counts = {name: fn.launches for name, fn in LAUNCHERS.items()}
        _require_sls(f"check-dlrm {kind}", counts, kind, len(batches))
        launches[kind] = counts[kind]
        ref, _ = DLRMEngine(cfg, asn, host, device="cpu").serve(batches)
        lerr = max(compare(f"check-dlrm {kind} logits", o.cpu(), r,
                           torch.float32) for o, r in zip(outs, ref))
        perr = 0.0
        for b in batches:
            pooled = [dlrm_mod.sls_forward(
                p, cfg, asn, torch.from_numpy(b["indices"]).to(d),
                torch.from_numpy(b["lengths"]).to(d)).cpu()
                for p, d in ((card, DEV), (host, "cpu"))]
            perr = max(perr, compare(f"check-dlrm {kind} pooled", *pooled,
                                     torch.float32, tol=SLS_TOL[kind]))
        print(f"check-dlrm: reduced PAPER_COMPLEX, "
              f"{'fp32' if bits is None else f'int{bits}'} slab: card vs "
              f"host pooled max abs err {perr:.3e} (tol {SLS_TOL[kind]}), "
              f"logits {lerr:.3e} (tol {TOL[torch.float32]}) over "
              f"{len(batches)} requests; {kind} launched {counts[kind]} "
              f"times", flush=True)
    return launches


# ---- the fleet: replicas of one engine sharing the card -----------------

FLEET_NOTE = "replicas share one card"
AUTOTUNE_LENGTHS = (40, 100, 200, 400)    # one per chunk bucket 64..512


def phase_host_link() -> None:
    """Host <-> device copy rates through pinned memory (256 MiB copies,
    CUDA events), beside the H100 spec's nominal PCIe 5.0 x16 rate the
    performance model prices snapshot ships with."""
    n = 256 * 2**20
    host = torch.empty(n, dtype=torch.uint8, pin_memory=True)
    dev = torch.empty(n, dtype=torch.uint8, device=DEV)
    rates = {}
    for name, dst, src in (("h2d", dev, host), ("d2h", host, dev)):
        for _ in range(2):
            dst.copy_(src, non_blocking=True)
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "ab")
        start.record()
        for _ in range(5):
            dst.copy_(src, non_blocking=True)
        end.record()
        torch.cuda.synchronize()
        rates[name] = 5 * n / (start.elapsed_time(end) * 1e-3) / 1e9
    spec = DEFAULT_BACKEND
    print(f"host-link: {card_line()}: pinned 256 MiB copies, host->device "
          f"{rates['h2d']:.2f} GB/s, device->host {rates['d2h']:.2f} GB/s "
          f"(the {spec.name} spec's nominal {spec.h2d_bw / 1e9:.0f} and "
          f"{spec.d2h_bw / 1e9:.0f} GB/s)", flush=True)


def _launch_counts() -> dict:
    return {name: fn.launches for name, fn in LAUNCHERS.items()}


def _count_per_replica(router) -> list:
    """Clear each replica's serving stats and wrap its ``step_once`` so the
    kernel launches of its steps add up in a dict of its own; ``_unwrap``
    takes the wrappers off. Returns the dicts, one per replica."""
    per = [dict.fromkeys(LAUNCHERS, 0) for _ in router.replicas]
    for rep, got in zip(router.replicas, per):
        rep.telemetry.reset_serving_stats()
        def counted(step=rep.step_once, got=got):
            before = _launch_counts()
            out = step()
            for k, v in _launch_counts().items():
                got[k] += v - before[k]
            return out
        rep.step_once = counted
    return per


def _unwrap(router) -> None:
    for rep in router.replicas:
        rep.__dict__.pop("step_once", None)


def _fleet_line(label, router, reqs, wall, per, precisions) -> dict:
    """Print the fleet's numbers beside the card and the kernel launches
    per replica; returns the launches summed over the replicas."""
    tel = router.fleet_telemetry()
    lat, ttft = tel.latency_percentiles(), tel.ttft_percentiles()
    n_tok = sum(len(r.output) for r in reqs)
    print(f"{label}: {len(router.replicas)} replicas {precisions}, "
          f"{FLEET_NOTE} ({card_line()}), prefill calls of up to "
          f"{router.replicas[0].max_prefill_batch} requests, routed "
          f"{router.routed}; served "
          f"{tel.served}/{len(reqs)} in {wall:.3f} s, {n_tok / wall:.1f} "
          f"tok/s, latency p50 {lat['p50']:.2f} ms p99 {lat['p99']:.2f} ms, "
          f"TTFT p50 {ttft['p50']:.2f} ms p99 {ttft['p99']:.2f} ms (all "
          f"submitted at once); steals {router.steals_per_replica}, "
          f"drained {tel.drained}, re-homed {router.rehomed}, dead "
          f"{[i for i, d in enumerate(router.dead) if d]}", flush=True)
    print(f"{label}: kernel launches per replica {per}", flush=True)
    lost = [r.rid for r in reqs if not r.done]
    if lost or tel.served != len(reqs):
        raise AssertionError(f"{label}: lost requests {lost} (served "
                             f"{tel.served} of {len(reqs)})")
    return {k: sum(p[k] for p in per) for k in LAUNCHERS}


def _warm(reps, vocab, lengths=(64,)) -> None:
    """One request of each length through each replica, one at a time
    (their stages' first calls and captures), then clean serving
    stats."""
    for rep in reps:
        for n in lengths:
            rep.run(_requests(1, n, n, 4, vocab, seed=1))
        rep.telemetry.reset_serving_stats()


# the router, steal and mixed fleet phases' engines prefill one request a
# call, as their one-engine reference does, so a request's prefill GEMMs
# have the same shapes in both (the library picks its kernel, and its sum
# order, by the row count) and its tokens can be held identical; decode
# steps always run all 4 rows. phase_fleet_batched serves at the engines'
# default admission instead
FLEET_KW = dict(SERVE_KW, max_prefill_batch=1)


# a warm-up request per prefill bucket (64, 128, 256, 512): every prefill
# key of a one-request-a-call engine is captured before the measured runs
FLEET_WARM = (64, 128, 256, 512)


def _one_engine(label, cfg, params, reqs, warm=FLEET_WARM, **kw):
    """The reference: the same requests through one engine, warmed as the
    replicas are; its numbers are printed beside the fleet's."""
    eng = InferenceEngine(cfg, params, **dict(FLEET_KW, **kw))
    _warm([eng], cfg.vocab_size, warm)
    return _timed_one(label, eng, reqs)


def _timed_one(label, eng, reqs):
    """Serve ``reqs`` on one warmed engine, print its numbers beside the
    card and return the outputs."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tel = eng.telemetry
    lat, ttft = tel.latency_percentiles(), tel.ttft_percentiles()
    n_tok = sum(len(r.output) for r in reqs)
    print(f"{label}: one engine, the reference ({card_line()}), prefill "
          f"calls of up to {eng.max_prefill_batch} requests: served "
          f"{tel.served}/{len(reqs)} in {wall:.3f} s, {n_tok / wall:.1f} "
          f"tok/s, latency p50 {lat['p50']:.2f} ms p99 {lat['p99']:.2f} ms, "
          f"TTFT p50 {ttft['p50']:.2f} ms p99 {ttft['p99']:.2f} ms",
          flush=True)
    return [r.output for r in reqs]


def _fleet_requests(vocab, classes=False):
    reqs = _requests(12, 64, 512, 32, vocab, seed=2)
    if classes:
        for r in reqs:
            r.priority = int(r.rid % 4 != 0)    # every fourth is class 0
    return reqs


def phase_fleet_router(cfg, params, reps, want) -> dict:
    """fleet-router: two bf16 replicas behind ``ReplicaRouter`` serve the
    same 12 requests as one engine, under count and then feedback
    routing, the replicas stepping in turn on one stream (so the decode
    kernels' shared ticket counters see one launch at a time): the
    tokens must be ``want``, one engine's. Returns the launches of both
    runs."""
    total = dict.fromkeys(LAUNCHERS, 0)
    for route in ("count", "feedback"):
        label = f"fleet-router ({route})"
        router = ReplicaRouter(reps, route=route)
        reqs = _fleet_requests(cfg.vocab_size)
        per = _count_per_replica(router)
        _zero_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for r in reqs:
            router.submit(r)
        router.run_until_drained()
        wall = time.perf_counter() - t0
        _unwrap(router)
        got = _fleet_line(label, router, reqs, wall, per, router.precisions)
        _require_launched(label, got, ("flash_attn", "decode_attn"))
        _check_tokens(label, [r.output for r in reqs], want, "one engine's")
        print(f"{label}: tokens identical to one engine's; step-time EWMA "
              f"per replica {[round(e * 1e3, 3) for e in router.ewma_s]} "
              f"ms", flush=True)
        total = {k: total[k] + got[k] for k in total}
    return total


def phase_fleet_batched(cfg, params) -> dict:
    """fleet-router at the engines' default admission (a prefill call
    takes up to ``batch_slots`` requests, as in the serve phases and the
    launcher's fleet): the serve phase's 8 requests through one engine and
    then through two bf16 replicas under count routing, each side warmed
    by one pass of the same requests so the measured pass replays captured
    graphs. A request shares its prefill call with other rows in the fleet
    than in one engine, and the library's GEMMs pick their kernel, and
    their sum order, by the row count: the tokens are held by greedy
    agreement >= 0.95, the bound serve-eager holds two bf16 paths to.
    Returns the fleet's launches."""
    label = "fleet-router (count, default admission)"

    def trace():
        return _requests(8, 64, 512, 32, cfg.vocab_size, seed=0)

    one = InferenceEngine(cfg, params, **SERVE_KW)
    one.run(trace())
    one.telemetry.reset_serving_stats()
    want = _timed_one(label, one, trace())
    del one
    gc.collect()
    torch.cuda.empty_cache()
    reps = make_replicas(cfg, params, 2, **SERVE_KW)
    warm = ReplicaRouter(reps, route="count")
    for r in trace():
        warm.submit(r)
    warm.run_until_drained()
    router = ReplicaRouter(reps, route="count")
    reqs = trace()
    per = _count_per_replica(router)
    _zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in reqs:
        router.submit(r)
    router.run_until_drained()
    wall = time.perf_counter() - t0
    _unwrap(router)
    got = _fleet_line(label, router, reqs, wall, per, router.precisions)
    _require_launched(label, got, ("flash_attn", "decode_attn"))
    outs = [r.output for r in reqs]
    agree = token_agreement(zip(outs, want))
    same = sum(a == b for a, b in zip(outs, want))
    div = _first_divergence(outs, want)
    where = ("" if div is None else f"; first divergence: request {div[0]} "
             f"token {div[1]}, fleet {div[2]} vs one engine {div[3]}")
    print(f"{label}: greedy-token agreement with one engine {agree:.4f}, "
          f"{same} of {len(reqs)} requests token-identical{where}",
          flush=True)
    if agree < 0.95:
        raise AssertionError(f"{label}: agreement {agree:.4f} with one "
                             f"engine < 0.95")
    return got


def _check_tokens(label, got, want, what) -> None:
    div = _first_divergence(got, want)
    if div is not None:
        raise AssertionError(f"{label}: tokens differ from {what}: request "
                             f"{div[0]} token {div[1]}, {div[2]} vs "
                             f"{div[3]}")


def phase_fleet_steal(cfg, reps, want) -> dict:
    """fleet-steal: every request hot-spotted onto replica 0 with stealing
    on, replica 0 drained after two rounds (the launcher's
    ``--verify-steal`` drive): tickets stolen, none lost, and the tokens
    one engine's."""
    label = "fleet-steal"
    router = ReplicaRouter(reps, steal=True)
    reqs = _fleet_requests(cfg.vocab_size)
    per = _count_per_replica(router)
    _zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tel = serve_launcher.drive_steal(router, reqs)
    wall = time.perf_counter() - t0
    _unwrap(router)
    got = _fleet_line(label, router, reqs, wall, per, router.precisions)
    _require_launched(label, got, ("flash_attn", "decode_attn"))
    if tel.steals == 0 or tel.drained == 0:
        raise AssertionError(f"{label}: {tel.steals} stolen, {tel.drained} "
                             f"re-homed by the drain")
    _check_tokens(label, [r.output for r in reqs], want, "one engine's")
    print(f"{label}: {tel.steals} stolen, {tel.drained} re-homed by the "
          f"drain, 0 lost, tokens identical to one engine's", flush=True)
    return got


def phase_fleet_mixed(cfg, params, quant, bf16_rep, want) -> dict:
    """fleet-mixed: a bf16 replica and a w8a8 replica with an int8 KV cache
    (the serve phase's quantized weights: one build step for the fleet).
    Class-0 requests land only on bf16 and decode one bf16 engine's
    tokens; the others agree with it >= 0.90; none is lost and no
    precision downgrade is counted."""
    label = "fleet-mixed"
    w8 = InferenceEngine(_int8_kv(cfg), params, precision="w8a8",
                         quantized_params=quant, **FLEET_KW)
    _warm([w8], cfg.vocab_size, FLEET_WARM)
    router = ReplicaRouter([bf16_rep, w8])
    reqs = _fleet_requests(cfg.vocab_size, True)
    on_w8 = set()
    submit = w8.submit
    def recorded(r, **kw):
        on_w8.add(r.rid)
        return submit(r, **kw)
    w8.submit = recorded
    per = _count_per_replica(router)
    _zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    serve_launcher._verify_quant_fleet(router, reqs, None)
    wall = time.perf_counter() - t0
    _unwrap(router)
    del w8.submit
    got = _fleet_line(label, router, reqs, wall, per, router.precisions)
    _require_launched(label, per[0], ("flash_attn", "decode_attn"))
    _require_launched(label, per[1], ("flash_attn", "w8a8_matmul",
                                      "decode_attn_int8"))
    if per[1]["decode_attn"] or per[0]["w8a8_matmul"]:
        raise AssertionError(f"{label}: a kernel ran on the wrong replica "
                             f"{per}")
    high = [i for i, r in enumerate(reqs) if r.priority == 0]
    _check_tokens(label, [reqs[i].output for i in high],
                  [want[i] for i in high], "one bf16 engine's")
    # the guardrail holds the w8a8 replica alone: the class-1 requests the
    # bf16 replica served match one bf16 engine by construction
    low = [i for i, r in enumerate(reqs) if r.rid in on_w8]
    if not low:
        raise AssertionError(f"{label}: the w8a8 replica served nothing")
    agree = token_agreement([(reqs[i].output, want[i]) for i in low])
    if agree < serve_launcher.QUANT_AGREEMENT_THRESHOLD:
        raise AssertionError(f"{label}: agreement {agree:.4f} below "
                             f"{serve_launcher.QUANT_AGREEMENT_THRESHOLD}")
    print(f"{label}: {len(high)} class-0 requests all on bf16 and "
          f"token-identical to one bf16 engine; the {len(low)} requests "
          f"the w8a8 replica served agree {agree:.4f} with it (guardrail "
          f"{serve_launcher.QUANT_AGREEMENT_THRESHOLD}); 0 downgrades, 0 "
          f"lost", flush=True)
    del w8, router
    return got


def phase_fleet_prefix(cfg, params) -> dict:
    """fleet-prefix: a hot-system-prompt trace (a 384-token shared prefix)
    over two chunked replicas (chunk 128) with the fleet-shared prefix
    tier: a populate pass on one replica, then the rest at once. A remote
    hit must be steered to the holder and a snapshot shipped, nothing
    lost, the fleet index consistent with both caches, and the tokens a
    cold engine's."""
    label = "fleet-prefix"
    kw = dict(SERVE_KW, prefill_chunk=128)
    args = types.SimpleNamespace(prefill_chunk=128, requests=10,
                                 new_tokens=16)

    def trace():
        return serve_launcher._prefix_requests(args, cfg)

    want = _one_engine(label, cfg, params, trace(), warm=(64,),
                       prefill_chunk=128, max_prefill_batch=None)
    reps = make_replicas(cfg, params, 2, prefix_cache=8, **kw)
    _warm(reps, cfg.vocab_size)
    router = ReplicaRouter(reps, fleet_prefix=True, prefix_host_entries=32,
                           perf_model=PerfModel.for_params(params))
    reqs = trace()
    per = _count_per_replica(router)
    _zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    router.submit(reqs[0])                  # populate one replica
    router.run_until_drained()
    for r in reqs[1:]:
        router.submit(r)
    router.run_until_drained()
    wall = time.perf_counter() - t0
    _unwrap(router)
    got = _fleet_line(label, router, reqs, wall, per, router.precisions)
    _require_launched(label, got, ("flash_attn", "decode_attn"))
    router.prefix_index.check_consistent(
        [set(dict(r.export_prefix_cache())) for r in reps])
    tel = router.fleet_telemetry()
    steered = tel.prefix_remote_hits - tel.prefix_shipped \
        - tel.prefix_recomputed
    _check_tokens(label, [r.output for r in reqs], want, "a cold engine's")
    print(f"{label}: {tel.prefix_remote_hits} remote hits ({steered} "
          f"steered to the holder, {tel.prefix_shipped} shipped, "
          f"{tel.prefix_recomputed} priced-out recomputes), "
          f"{tel.prefix_host_hits} host-tier fault-ins, {tel.prefix_hits} "
          f"local hits; 0 lost, index consistent, tokens identical to a cold "
          f"engine's; snapshot and restore bytes per replica "
          f"{[r.transfer_stats.bytes_partial for r in reps]}", flush=True)
    if steered < 1 or tel.prefix_shipped < 1:
        raise AssertionError(f"{label}: {steered} steered, "
                             f"{tel.prefix_shipped} shipped")
    return got


def phase_fleet_autotune(cfg, params) -> dict:
    """fleet-autotune: a PerfModel fitted from this run's replayed chunk
    calls at full width (a chunk-512 engine, one request per chunk bucket,
    each key warmed up first) picks the chunk at its knee on the ladder;
    an engine with ``prefill_chunk="auto"`` serves with it. Then the same
    on the reduced f32 config, where the auto chunk must give chunk 16's
    tokens."""
    label = "fleet-autotune"
    t0 = time.perf_counter()
    pm, ladder = serve_launcher.autotune_model(
        cfg, params, SERVE_KW, lengths=AUTOTUNE_LENGTHS)
    knee = pm.suggest_prefill_chunk(ladder)
    # each calibration call holds one request of a ladder bucket: the
    # measured median of a cell is its overhead factor times its floor
    fit = [(n, round(1e3 * pm.predict_dispatch_s("chunk_prefill", n), 3),
            round(1e3 * pm.cell_overhead("chunk_prefill", bucket=n)
                  * pm.flop_floor_s(n), 3)) for n in ladder]
    eng = InferenceEngine(cfg, params, prefill_chunk="auto", perf_model=pm,
                          **SERVE_KW)
    print(f"{label}: deepseek-7b full width bf16 ({card_line()}), "
          f"calibration {time.perf_counter() - t0:.2f} s from replayed "
          f"calls only; fitted {pm.fitted_terms()}; (tokens, predicted ms, "
          f"measured median ms) {fit}; knee {knee} on {ladder}; auto chunk "
          f"{eng.prefill_chunk} on {eng.buckets}", flush=True)
    _warm([eng], cfg.vocab_size)
    reqs = _requests(8, 64, 512, 32, cfg.vocab_size, seed=0)
    _zero_launches()
    eng.run(reqs)
    torch.cuda.synchronize()
    got = _launch_counts()
    _require_launched(label, got, ("flash_attn", "decode_attn"))
    chunk = eng.prefill_chunk
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    hand = InferenceEngine(cfg, params, prefill_chunk=chunk, **SERVE_KW)
    _warm([hand], cfg.vocab_size)
    twin = _requests(8, 64, 512, 32, cfg.vocab_size, seed=0)
    hand.run(twin)
    _check_tokens(label, [r.output for r in reqs],
                  [r.output for r in twin],
                  f"a hand-set chunk-{chunk} engine's")
    print(f"{label}: full width, 8 requests served with the auto chunk; "
          f"tokens identical to a hand-set chunk-{chunk} engine's; kernel "
          f"launches {got}", flush=True)
    del hand
    small = reduce_for_smoke(get_config("deepseek-7b"))
    card = model_mod.init_params(small, seed=0, device=DEV)
    kw = dict(batch_slots=2, max_len=64, prefill_buckets=(8, 16, 32),
              device=DEV)
    spm, sladder = serve_launcher.autotune_model(small, card, kw,
                                                 lengths=(6, 12, 30))
    auto = InferenceEngine(small, card, prefill_chunk="auto",
                           perf_model=spm, **kw)
    ref = InferenceEngine(small, card, prefill_chunk=16, **kw)
    outs = [_outputs(e, _requests(8, 4, 40, 6, small.vocab_size, seed=9))
            for e in (auto, ref)]
    _check_tokens(label, *outs, "chunk 16's on the reduced config")
    print(f"{label}: reduced f32 config on the card, auto chunk "
          f"{auto.prefill_chunk} on {auto.buckets} (knee of "
          f"{spm.fitted_terms()} on {sladder}): 8 requests token-identical "
          f"to chunk 16", flush=True)
    return got


def phase_fleet_lm(cfg, params, quant) -> dict:
    """The LM fleet phases at full width; returns their launches summed."""
    want = _one_engine("fleet-router", cfg, params,
                       _fleet_requests(cfg.vocab_size))
    gc.collect()
    torch.cuda.empty_cache()
    reps = make_replicas(cfg, params, 2, **FLEET_KW)
    _warm(reps, cfg.vocab_size, FLEET_WARM)
    phases = [phase_fleet_router(cfg, params, reps, want),
              phase_fleet_steal(cfg, reps, want),
              phase_fleet_mixed(cfg, params, quant, reps[0], want)]
    del reps
    gc.collect()
    torch.cuda.empty_cache()
    phases.append(phase_fleet_batched(cfg, params))
    gc.collect()
    torch.cuda.empty_cache()
    phases.append(phase_fleet_prefix(cfg, params))
    gc.collect()
    torch.cuda.empty_cache()
    phases.append(phase_fleet_autotune(cfg, params))
    gc.collect()
    torch.cuda.empty_cache()
    return {k: sum(p[k] for p in phases) for k in LAUNCHERS}


def phase_fleet_dlrm(cfg, asn, params, batches, outs) -> int:
    """fleet-dlrm: two DLRM replicas over the serve phase's one slab,
    every batch hot-spotted onto replica 0, stealing on and replica 0
    drained after its first step: each batch served once, its logits
    within 2e-3 of the one engine's. Returns the int8 SLS launches."""
    label = "fleet-dlrm"
    got = {}
    reps = dlrm_make_replicas(
        cfg, asn, params, 2, device=DEV,
        on_result=lambda b, v: got.setdefault(id(b), []).append(v))
    for rep in reps:
        rep.serve(batches, pipelined=True, warm=True)
        rep.telemetry.reset_serving_stats()
    router = ReplicaRouter(reps, steal=True)
    per = _count_per_replica(router)
    _zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches:
        reps[0].submit(b)
    rounds = 0
    while router.has_work:
        router.maybe_steal()
        for i, rep in enumerate(reps):
            if not router.dead[i] and rep.has_work:
                rep.step_once()
        rounds += 1
        if rounds == 1:
            router.drain_replica(0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    _unwrap(router)
    tel = router.fleet_telemetry()
    lat = tel.latency_percentiles()
    served = [r.telemetry.served for r in reps]
    print(f"{label}: 2 replicas sharing one slab, {FLEET_NOTE} "
          f"({card_line()}): served {served} of {len(batches)} batches of "
          f"{DLRM_BATCH} in {wall:.3f} s "
          f"({len(batches) * DLRM_BATCH / wall:.0f} items/s, latency p50 "
          f"{lat['p50']:.3f} ms p99 {lat['p99']:.3f} ms), {tel.steals} "
          f"stolen, {tel.drained} re-homed by the drain; kernel launches "
          f"per replica {per}", flush=True)
    if tel.served != len(batches) or tel.steals == 0 or tel.drained == 0:
        raise AssertionError(f"{label}: served {tel.served}, {tel.steals} "
                             f"stolen, {tel.drained} drained")
    err = 0.0
    for b, want in zip(batches, outs):
        if len(got.get(id(b), ())) != 1:
            raise AssertionError(f"{label}: a batch was served "
                                 f"{len(got.get(id(b), ()))} times")
        err = max(err, compare(f"{label} logits", got[id(b)][0], want,
                               torch.float32))
    total = sum(p["sls_int8"] for p in per)
    _require_sls(label, {k: sum(p[k] for p in per) for k in LAUNCHERS},
                 "sls_int8", len(batches))
    print(f"{label}: every batch's logits within {err:.3e} of the one "
          f"engine's (tol {TOL[torch.float32]})", flush=True)
    return total


# phases that run in a process of their own (``python3 chip_smoke.py
# <arg>``), right after the kernel phase, each checked profiler window the
# first of its process: profile-mamba2's window, taken in this process
# after the kernel phase, came back with 17 of its 18 markers in each of
# four tries, and the kernel phase's main window lost one of its 2160 in 3
# of 3 tries once the G 6 cases' window ran before it here
CHILD_PHASES = {"--dbrx-kernels": dbrx_kernel_cases,
                "--cmdr-kimi-kernels": cmdr_kimi_kernel_cases,
                "--profile-mamba2": profile_mamba2,
                "--profile-dbrx": profile_dbrx}


def run_child(arg: str) -> None:
    _free_card()
    subprocess.run([sys.executable, os.path.abspath(__file__), arg],
                   check=True, timeout=900)


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is "
                 "False)")
    global SMS
    SMS = torch.cuda.get_device_properties(0).multi_processor_count
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if len(sys.argv) == 2 and sys.argv[1] in CHILD_PHASES:
        CHILD_PHASES[sys.argv[1]]()
        return
    if len(sys.argv) == 3 and sys.argv[1] == TRAIN_RESUME:
        train_resume(sys.argv[2])
        return
    print(card_line(), flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    phase_build()
    phase_host_link()
    main_path = phase_kernels()
    for arg in CHILD_PHASES:
        run_child(arg)
    cfg = get_config("deepseek-7b")
    t0 = time.perf_counter()
    params = model_mod.init_params(cfg, seed=0, device=DEV)
    torch.cuda.synchronize()
    print(f"init: deepseek-7b full width, "
          f"{sum(p.numel() for p in params.parameters()) / 1e9:.3f} B "
          f"params in {time.perf_counter() - t0:.1f} s", flush=True)
    launches, bf16_outputs, eng = phase_serve(cfg, params)
    phase_serve_eager("serve-eager", eng, launches, bf16_outputs, cfg,
                      params)
    del eng
    launches_c = phase_serve_chunked(cfg, params, bf16_outputs)
    launches_q, quant, w8a8_outputs, eng = phase_serve_quant(cfg, params,
                                                             bf16_outputs)
    check_w8a8_layers("check-deepseek-layers", layers_reference(
        cfg, params, (512, 300, 77, 1), SERVE_KW["max_len"]), _int8_kv(cfg),
        quant.params)
    phase_serve_eager("serve-eager-w8a8", eng, launches_q, w8a8_outputs,
                      _int8_kv(cfg), params, precision="w8a8",
                      quantized_params=quant)
    del eng
    phase_serve_chunked(cfg, params, w8a8_outputs, quant)
    phase_check(cfg, params)
    phase_check_chunked()
    phase_check_graphs()
    phase_profile(cfg, params)
    phase_profile(_int8_kv(cfg), quant.params, tag="w8a8+int8kv ")
    # each kernel's launches are those of the serve phases that run it
    # (flash's: the monolithic and the chunked bf16 serves') and of the
    # fleet phases
    launches.update({k: launches_q[k] for k in ("w8a8_matmul",
                                                "decode_attn_int8")})
    launches["flash_attn"] += launches_c["flash_attn"]
    fleet = phase_fleet_lm(cfg, params, quant)
    for k in ("flash_attn", "decode_attn", "w8a8_matmul", "decode_attn_int8"):
        launches[k] += fleet[k]
    # gemma2-27b needs the card: drop every deepseek-7b tensor first
    del params, quant
    _free_card()
    print(f"freed deepseek-7b: {torch.cuda.memory_allocated() / 2**30:.2f} "
          f"GiB still allocated", flush=True)
    phase_check_gemma_2b()
    g2bcfg = get_config("gemma-2b")
    t0 = time.perf_counter()
    g2b = model_mod.init_params(g2bcfg, seed=0, device=DEV)
    torch.cuda.synchronize()
    print(f"init: gemma-2b full width, "
          f"{sum(p.numel() for p in g2b.parameters()) / 1e9:.3f} B params, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB, in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    launches_2b, g2b_outputs = phase_serve_gemma_2b(g2bcfg, g2b)
    _free_card()
    launches_2bc, _ = phase_serve_gemma_2b(
        g2bcfg, g2b, "serve-gemma2b-chunked", g2b_outputs, prefill_chunk=512)
    _free_card()
    launches_2bq, _ = phase_serve_gemma_2b(
        g2bcfg, g2b, "serve-gemma2b-w8a8", g2b_outputs, precision="w8a8")
    for k in ("flash_attn", "decode_attn", "w8a8_matmul", "decode_attn_int8"):
        launches[k] += launches_2b[k] + launches_2bc[k] + launches_2bq[k]
    del g2b
    _free_card()
    print(f"freed gemma-2b: {torch.cuda.memory_allocated() / 2**30:.2f} "
          f"GiB still allocated", flush=True)
    for k, n in phase_qwen2vl().items():
        launches[k] += n
    launches["flash_attn"] += phase_xlmr()["flash_attn"]
    for k, n in phase_whisper().items():
        launches[k] += n
    for k, n in phase_recurrentgemma().items():
        launches[k] += n
    phase_mamba2()
    train = phase_train()
    for phase in (phase_dbrx, phase_cmdr, phase_kimi):
        for k, n in phase().items():
            launches[k] += n
    phase_check_gemma2()
    g2cfg = get_config("gemma2-27b")
    t0 = time.perf_counter()
    g2 = model_mod.init_params(g2cfg, seed=0, device=DEV)
    torch.cuda.synchronize()
    print(f"init: gemma2-27b full width, "
          f"{sum(p.numel() for p in g2.parameters()) / 1e9:.3f} B params, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB, in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    launches_g, g2_outputs = phase_serve_gemma2(g2cfg, g2)
    _free_card()
    launches_gc = phase_serve_gemma2_chunked(g2cfg, g2, g2_outputs)
    for k in ("flash_attn", "decode_attn"):
        launches[k] += launches_g[k] + launches_gc[k]
    # w8a8 + int8 KV: the layers check's bf16 step first, on the whole
    # bf16 model, then the build that releases the int8 sites' bf16 leaves
    _free_card()
    g2ref = layers_reference(g2cfg, g2, GEMMA2_LAYERS_LENS,
                             GEMMA2_KW["max_len"])
    g2qcfg = _int8_kv(g2cfg)
    g2q = build_released_w8a8("build-gemma2-w8a8", g2qcfg, g2)
    launches_gq, _ = phase_serve_gemma2_w8a8(g2qcfg, g2, g2q, g2_outputs)
    _free_card()
    check_w8a8_layers("check-gemma2-layers", g2ref, g2qcfg, g2q.params)
    _free_card()
    launches_gqc, _ = phase_serve_gemma2_w8a8(g2qcfg, g2, g2q, g2_outputs,
                                              chunk=512)
    for k in ("flash_attn", "decode_attn", "w8a8_matmul", "decode_attn_int8"):
        launches[k] += launches_gq[k] + launches_gqc[k]
    # the DLRM slab needs the card: drop the gemma2-27b weights (on the
    # card and on the host)
    del g2, g2q, g2ref
    _free_card()
    print(f"freed gemma2-27b: {torch.cuda.memory_allocated() / 2**30:.2f} "
          f"GiB still allocated", flush=True)
    launches["sls_int8"], eng, served = phase_serve_dlrm()
    launches["sls_int8"] += phase_fleet_dlrm(*served)
    phase_profile_dlrm(eng, served[3][0])
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    launches.update({k: n for k, n in phase_check_dlrm().items()
                     if k != "sls_int8"})
    print(json.dumps({"train": train}))
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    line = [dict(name=name, route="cuda", **KERNELS[name],
                 launches=launches[name],
                 **{k: main_path[name][k] for k in keys})
            for name in KERNELS]
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
