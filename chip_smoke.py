#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA GPU, the CUDA
toolkit (``nvcc``) and PyTorch built for CUDA. It imports the port
(``src/repro_torch``) and nothing of JAX or of the reference package. Each
phase prints one JSON line; any failure ends the run with a non-zero exit
and no result line:

1. ``build``: the card's name and power limit (``nvidia-smi``), then one
   ``nvcc`` build of every kernel source in the checkout.
2. ``kernels``: every kernel against its plain PyTorch version on the card,
   at the GPT-2 XL shapes of the serving and training paths (the training
   attention at B 2, S 1024, 25 heads, hd 64, bf16) and at edge shapes
   (GQA/MQA, window, softcap, fp32, hd 40 to 256, empty slots, ragged
   sizes), and the dequantize kernel on the quantize kernel's outputs (block
   256, 64, 32, int4, a ragged length, a block of 33 and an unaligned view,
   one GPT-2 XL token-table leaf) with a ragged payload that must raise;
   attention and paged decode at Qwen3-1.7B's head layout too (H 16, Hkv
   8, hd 128, bf16) and at Qwen3-14B's GQA 5:1 (H 40, Hkv 8, hd 128: the
   forward and backward at S 512 and a ragged 333, each run twice to the
   same bits on the tensor cores; decode at 4 slots over contexts
   128-512), timed beside Granite-8B's 4:1 and MiniCPM-2B's MHA; at
   RecurrentGemma-9B's MQA 16:1, hd 256, bf16 on the tensor-core route
   (``flash_attention_tc256.cu``): the forward at S 512 and 2304 with
   window 2048, each run twice to the same bits, timed at the serve
   phase's B 4 x 512 and at 2304 beside the CUDA-core kernel that ran it
   before and SDPA, the hd-256 forward's edges (S 1, ragged 77 and 333,
   window 64, softcap 30, non-causal, MHA, GQA 2:1) and its backward on
   the CUDA cores through ``FlashAttentionFn``, and
   decode over its dense cache viewed as a pool (4 slots at contexts
   513-544, a full ring of 2048), repeated to the bit and timed; at
   Kimi-K2's GQA 8:1, hd 112, bf16 on the tensor-core route
   (``flash_attention_tc.cu``'s hd-128 design on a tile padded to 128
   columns): the forward at S 512 and a ragged 333, each run twice to the
   same bits, its edges (S 1, ragged 77, window 64, softcap 30,
   non-causal, MHA, GQA 2:1), the store's column limit (launched into a
   sentinel-filled buffer one head row longer than the output: every
   element written, nothing past the last head's column 111), timed at one
   prompt of 512 and at 4 beside the CUDA-core kernel that ran it before
   and SDPA, and decode at 4 slots over contexts
   513-544 with bf16 and int8 pools; the bf16 backward (the CUDA-core
   kernel) timed at its training shape, B 2 x 1024, beside SDPA's forward +
   backward and the bound; quantize at its KV rows (block 112,
   14 vectors: the scalar kernel), bit for bit and timed; at
   Whisper-large-v3's 20 heads of hd 64: the encoder's non-causal forward
   at S 1 500 (B 4 in bf16, and fp32), keys of another length than the
   queries without a mask (Sq 64, 77, 1 and 200 over Skv 1 500, 300 and
   333; bf16 on the tensor cores at hd 64, 112, 128 and 256, fp32 on the
   CUDA cores), the encoder's and the cross-attention's bf16 shapes each
   run twice to the same bits, and a causal forward over such keys
   refused before any launch; timed at the
   encoder's and the cross-attention's prefill shapes beside the CUDA-core
   kernel and SDPA; and decode over the cross cache (4 slots, context
   1 500 of 1 504 rows viewed as a pool, bf16 and fp32), timed beside SDPA
   on a contiguous copy; the flash backward at the training shapes of
   Whisper (the cross-attention, 448 queries over 1 500 keys without a
   mask, and the encoder, S 1 500 non-causal: the tensor cores) and of
   RecurrentGemma-9B (MQA 16:1 at hd 256, window 2048, S 1 024 and 2 304:
   the CUDA cores, D from P and dP for bf16), each in fp32 too, with
   ragged, one-query and fewer-keys-than-queries edges over keys of
   another length, timed beside the CUDA-core kernel, SDPA forward +
   backward and the bound, and a causal backward over such keys refused
   before any launch; the dequantize kernel beside one ``torch.mul``;
   quantize at its KV rows (block 128, a prefill layer's
   and a decode step's, bit for bit, the prefill one timed) and at n ending
   mid-vector at each block size, bf16 at block 256, an unaligned view and
   block 96 (the scalar kernel), each case run twice to the same bits and
   on the route its rule gives (``torch.profiler`` names the kernel); the
   quantize times beside the scalar kernel's and a same-bytes cast to int8;
   and the RMSNorm forward and backward kernels
   (``check_rmsnorm``) at Qwen3's shapes (block norms at D 2048, qk-norm at
   D 128 and eps 1e-6, training, prefill and decode rows) and edge shapes
   (D 40, 41 and 5000, one row, fp32, ragged sets of 32 vectors at D 1600
   and 1000, an unaligned view): the forward on the route its rule gives,
   the register-path kernel's y and rstd bit for bit those of the
   block-a-row kernel wherever it takes the rows (both timed, beside a
   same-bytes ``y.copy_(x)``); output, rstd and dx within 2e-6 of
   the largest |value| in fp32, one bf16 ulp in bf16 (dx plus 2e-6 of its
   largest |value|), dscale within 1e-5; the outputs of the autograd path
   bitwise those of the direct launches, and the backward's dx and dscale
   the same bits when run again. Paged decode (split over the context in
   spans of 64 or more, then merged) also at contexts on split boundaries,
   a window across splits, 32 slots and a context of 4096 at Qwen3's heads;
   every case must repeat to the bit. Decode is timed at the serve phase's
   4 slots and at two bandwidth-bound shapes (16 slots: GPT-2 XL at
   contexts 256-1024, Qwen3 at 1024-4096) beside SDPA on a contiguous copy
   of the same K/V; the two stages of the decode kernels and of the RMSNorm
   backward are timed apart once (``torch.profiler``), and the backward
   beside ``torch.add`` moving the same bytes.
   Attention takes two routes: the forward of bf16 at head_dim 64, 112,
   128 and 256 the tensor-core kernels (``flash_attention_tc.cu``, at 256
   ``flash_attention_tc256.cu``), the backward of bf16 at 64 and 128
   ``flash_attention_bwd_tc.cu``, every other case the CUDA-core ones;
   each case's line names the route its launches took (from the
   ``tc_launches`` counters) and the run fails if it is not the routing
   rule's. The tensor-core cases cover GQA 2:1 and 4:1, MQA, window 64,
   softcap 30, non-causal and ragged S (1, 77, 200, 257, 300, 700) at both
   head_dims; every backward is run twice and must give the same bits.
   Tolerances: quantize, dequantize and pier update bit for bit; attention
   forward and backward 1e-4 in fp32; the forward's log-sum-exp 1e-4
   against ``flash_attention_fwd_ref``, and its output bitwise the same
   with or without it. In bf16 the forward within 2e-2 absolute at
   unit-scale outputs (one bf16 rounding of the output, about 4e-3 there,
   plus another summation order), and each of dq, dk and dv on its own:
   max error within 2% of its own max |value| (about two bf16 roundings)
   and ||error|| / ||value|| within 1e-2 (one rounding is about 1e-3; D is
   taken from the bf16 output); the forward's output meets the same 1e-2.
   Device times (CUDA events, median of 25 runs, L2 flushed and the launch
   queued behind a sleep kernel so host overhead is not counted) beside the
   plain version's and, for attention, ``F.scaled_dot_product_attention``
   as a yardstick the port never calls: its forward at the prefill and
   the training shapes (the training forward with its log-sum-exp), and
   for the backward SDPA's backward alone and its forward + backward. The
   CUDA-core attention kernels are timed at the same bf16 shapes through
   their C entry points, beside the tensor-core ones.
2b. ``check_ring``: the two wire kernels (ring all-gather, shard scatter)
   between ranks spawned through the port's launcher on the one card (2 and
   4 ranks, gloo, CUDA-IPC-mapped symmetric buffers), byte for byte against
   their plain versions on host copies of the same bytes: buffers of 1 B and
   ragged lengths, the int4 nibble wire, the GPT-2 medium token table's int8
   payload through the quantized all-reduce, reduce-scatter and all-gather,
   and every GPT-2 medium leaf's wire packed into one buffer. Times there
   at 2 ranks, the main path's (CUDA events, median of 25) beside the
   plain version's and gloo's
   ``all_gather_into_tensor`` on host copies; a broken peer (one rank skips
   the launch) must raise at the kernel's 2 s deadline.
2c. ``adamw``: the inner AdamW update (``optim/adamw.py``, plain PyTorch,
   in place through two fp32 temporaries) bit for bit its out-of-place form
   over three steps at the GPT-2 XL token table (50304 x 1600, fp32 and
   bf16 moments), and both timed there.
3. ``e2e_vs_cpu``: GPT-2 XL width at 4 layers in fp32, the same seeded
   weights on the card (kernels) and on the CPU (plain versions): a
   teacher-forced paged rollout (prompt 200, 16 decode steps) must agree
   within 1e-3 on every logit; the card's int8-KV rollout must lie within
   2% of max |logit| of its fp32 rollout (the reference's int8 tolerance).
4. ``serve``: full GPT-2 XL (48 layers, bf16, random seeded weights)
   through ``ServeEngine`` as the launcher builds it: 8 requests (prompts
   128/256/384/512, twice), 32 new tokens each, 4 slots, block 16, greedy,
   once with bf16 KV and once with int8 KV. The launch counters are set to
   0 just before each run and must show every kernel of the path ran:
   flash = prefills x 48, decode = decode steps x 48, quantize = 2 x 48 x
   (prefills + decode steps) with int8 KV and 0 without.
4b. ``serve_qwen3``: the same two runs with full Qwen3-1.7B (28 layers),
   where rmsnorm = 113 x (prefills + decode steps) as well; then
   ``serve_qwen3_int8_kv``: teacher-forced rollouts (prompt 200, 16 decode
   steps) with int8 KV blocks: at 4 layers in fp32 against the fp32-KV
   rollout, every logit within 2% of max |logit|; at full depth in bf16
   against the bf16-KV rollout, reported.
4c. ``serve_families``: the same traffic with bf16 KV through MiniCPM-2B
   (MHA, a tied table of 122 753 rows), Granite-8B (GQA 4:1, untied) and
   Qwen3-14B (GQA 5:1, qk-norm, untied) at full width with 8 layers each
   (for the time limit), each made on the card in serving storage and
   freed before the next: launches exact at each depth (``--families``
   runs all three at full depth, 40, 36 and 40 layers, with bf16 and int8
   KV).
4d. ``serve_recurrent``: full RecurrentGemma-9B (38 layers: RG-LRU and
   local MQA attention, 16 heads over 1 at hd 256, window 2048) and
   xLSTM-1.3B at full width with one 7:1 cycle of 8 layers (mLSTM and
   sLSTM; all 48 in ``--recurrent``, for the time limit), bf16, random seeded
   weights made on the card in serving storage, one model freed before
   the next: 4 prompts of 512 tokens, 32 new tokens, greedy, through
   ``generate``'s dense path (``build_serve_steps``: one prefill, 31 decode
   steps, the local-attention caches viewed as pools for the paged decode
   kernel). Tokens/s, TTFT, decode-step p50/p99, peak memory; launches
   exact: rmsnorm 77 (9 at 8 layers, 49 at 48) x 32 forwards, flash 12 (the hd-256 tensor-core
   kernel, ``flash_attention_tc256``), decode 12 x 31. Then one decode step's device time beside
   its wall time (``torch.profiler``), RecurrentGemma's prefill too (not
   xLSTM's: its 90 000 kernels take the profiler longer than the run), and
   one layer's RG-LRU scan and prefill, or one sLSTM and one mLSTM
   layer's prefill, the same way.
4e. ``serve_moe``: DeepSeek-V2-236B through ``generate``'s dense path
   (MLA's latent cache; 2 of its 60 layers: 1 dense + 1 MoE; 8 layers, 1
   dense + 7 MoE, 60.7 GB, in ``--moe``) and Kimi-K2 through its paged
   path (GQA 8:1 at hd 112; 2 of 61 layers: 1 dense + 1 MoE, 44.6 GB),
   each at full width, bf16, random seeded weights made on the card in
   serving storage (the experts a slab at a time), one freed before the
   next: 4 prompts of 512, 32 new tokens,
   greedy. Tokens/s, TTFT, decode-step p50/p99, peak memory, parameter and
   expert bytes; a prefill's and a decode step's device vs wall time
   (``torch.profiler``), the step beside the bytes of the expert weights
   it reads (the capacity formulation runs every expert). Launches exact:
   rmsnorm 4 x layers + 1 a forward (DeepSeek: norm1, norm2, q_norm,
   kv_norm) and no attention kernel; Kimi: flash layers a prefill (the
   hd-112 tensor-core forward, ``flash_attention_tc112``), paged decode
   layers x 31, rmsnorm 2 x layers + 1 a forward.
4f. ``serve_whisper``: full Whisper-large-v3 (32 encoder and 32 decoder
   layers, d_model 1 280, MHA 20 x 64, LayerNorm, 1.68 B parameters), bf16,
   random seeded weights made on the card in serving storage: 4 prompts of
   64 tokens over 4 x 1 500 seeded frame embeddings, 32 new tokens, greedy,
   through ``generate``'s dense path (one prefill that encodes the frames
   once and builds each decoder layer's cross K/V once, 31 decode steps).
   Tokens/s, TTFT (the encoder included), decode-step p50/p99, peak
   memory; a prefill's and a decode step's device vs wall time, the step
   beside the bytes it must read. Launches exact: flash 96 a prefill on the
   tensor cores (32 encoder, non-causal; 32 decoder, causal; 32 cross, over
   keys of another length, counted by ``flash_attention.cross_launches``),
   paged decode 64 a step (the self cache and the cross cache of 1 504 rows
   viewed as a pool), no RMSNorm.
5. The CPU halves of phases 6, 6b, 6c and 6h run ahead, from right after
   the build, in a process of their own at the lowest CPU priority
   (``CpuHalvesAhead``: their inputs are made on the CPU from seeds), on
   the cores this process leaves idle; each phase's card half runs after
   4f and its comparison after 8e, on the same numbers and bounds as
   before; then, with that process ended, 6e-6g. ``--breakdowns`` runs the
   reported-only profiles (``breakdown``: device time by kernel group
   beside the host's wall time for a 512-token prefill and decode steps of
   the bf16 serve path, bf16 and int8 KV; ``train_breakdown``,
   ``train_qwen3_breakdown``, ``train_moe_breakdown`` and the two dispatch
   breakdowns), which the whole script no longer runs.
6. ``train_vs_cpu``: ``SimulatedRun`` at GPT-2 XL width, 4 layers, fp32,
   G = 2, per-group batch 2 x 128 tokens, the same seeded parameters and
   batches on the card (kernels) and on the CPU (plain versions), 12 steps
   of a 40-step schedule with sync interval 2: lazy start, two warmup
   accumulates, the switch to groups and four outer syncs at mu 0.99 /
   0.95 / 0.9. Run at sync_delay 0 and 1. Every step's loss must agree
   within 1e-3 and every final parameter within 1e-3 (fp32 on both sides;
   only summation orders differ, which AdamW's normalized first steps
   amplify up to about lr per step); delay 1 must differ from delay 0.
6b. ``train_compressed_vs_cpu``: the same comparison with the compressed
   and hierarchical outer syncs, at GPT-2 XL width, 2 layers, fp32, seq 64,
   per-group batch 1, 8 steps (two outer syncs): quantize int8/256 at
   delay 0 and 1, quantize int4/64, int8-wire, rs-ag at G = 2,
   hierarchical[int8-wire] at G = 4 in 2 pods, chunked(2)[quantize]. Loss
   and final parameters within 1e-3; the quantize and dequantize launches
   exactly what the strategy's code path makes per leaf and sync.
6c. ``qwen3_vs_cpu``: Qwen3-1.7B width at 2 layers in fp32, the same
   seeded parameters on the card and on the CPU: one 128-token prefill's
   logits, one batch's loss and gradients, and 8 steps of ``SimulatedRun``
   (G = 2, per-group batch 2 x 128, flat sync), all within 1e-3; rmsnorm =
   rmsnorm_bwd = 9 per forward and backward, every launch count exact.
   The fp32 phases 3, 6, 6b, 6c, 6e, 6f and 8c take the CUDA-core
   attention kernels: no tensor-core launch.
6d. ``flash_tc_vs_plain``: GPT-2 XL width at 4 layers and Qwen3-1.7B width
   at 2 layers, bf16 compute, training storage: one batch's (2 x 1024)
   loss and every gradient leaf through the tensor-core attention kernels
   against the same step through the plain attention's autograd. Loss
   within 1e-3 relative; each leaf's max error within 2% of its max
   |value| and its relative RMS error within 1e-2; layers flash forward
   and backward launches, all on the tensor cores. Reported beside it, not
   checked: the same distance for the plain attention with its keys
   summed in another fp32 order, the comparison's floor.
6d'. ``flash_tc256_vs_plain``: RecurrentGemma-9B at full width, 3 layers
   (one rglru / rglru / local_attn cycle), bf16, serving storage: a prefill
   of 4 x 512 and one of 1 x 2304 (the window of 2048 active) through the
   hd-256 tensor-core kernel against the same prefills through the plain
   attention; every position's logits within 2% of max |logit| and 1%
   relative RMS; one flash launch a prefill, on that kernel, none in the
   plain run; the plain attention in another fp32 order reported as the
   floor.
6d''. ``flash_tc112_vs_plain``: the same check of the hd-112 tensor-core
   forward with Kimi-K2 at full width and 1 layer, its leading dense one
   (GQA 64 / 8 at hd 112, the 18 432-wide SwiGLU; 2.86 B parameters), at
   4 x 512 and 1 x 512. The MoE layer is left out: a bf16 near-tie in the
   top-8 of 384 experts could route two correct attentions apart.
6e. ``families_vs_cpu``: the four families (the three above and
   Chameleon-34B: GQA 64 / 8 at hd 128, qk-norm, a 65 536-row untied
   table) at full width, 2 layers, fp32, the same seeded weights on the card and on the CPU: 4 prompts of
   64 tokens, their prefills and 8 decode steps over the 4 slots; every
   logit within 1e-3, int8 KV within 2% of max |logit| of fp32 KV,
   launches exact.
6f. ``recurrent_vs_cpu``: the dense path card vs CPU in fp32, the same
   seeded weights, a prefill and 16 teacher-forced decode steps through
   ``registry.prefill`` / ``decode_step``: RecurrentGemma-9B at full width
   with 3 layers (one rglru / rglru / local_attn cycle), 2 prompts of 200,
   at its window of 2048 and at 128 (the ring wraps on the card); xLSTM-
   1.3B at full width with 8 layers (one 7:1 cycle), a prompt of 192 (the
   chunkwise form) and one of 50 (the parallel form). Every logit within
   1e-3; every launch count exact.
6g. ``moe_vs_cpu``: DeepSeek-V2-236B and Kimi-K2 at full width with 2
   layers (the dense one and one MoE layer), fp32, ``num_experts`` cut to
   32 (top-k 6 and 8 kept: 384 fp32 experts would be 67.6 GB of host
   memory, and at 32 experts the router's near-ties round the same way on
   both devices), the same seeded weights on the card and on the CPU: 2
   prompts of 64 and 8 teacher-forced decode steps, each model through its
   own path (dense / paged). Every logit within 1e-3; the share of top-k
   assignments the same on both sides (``routing_agree``) reported; every
   launch count exact. Then ``moe_train_vs_cpu`` on the same weights: one
   ``loss_fn`` forward and backward on 2 x 64 tokens (a quarter of the
   labels masked) on the card and on the CPU; the loss within 1e-5
   relative, every gradient leaf's max error within 1e-3 of that leaf's
   max |g|, ``routing_agree`` reported, launches exact (rmsnorm =
   rmsnorm_bwd = 9 for DeepSeek, 5 for Kimi; Kimi's flash forward and
   backward 2 each on the fp32 CUDA-core route at hd 112).
6h. ``whisper_vs_cpu``: Whisper-large-v3 at full width with 2 encoder and
   2 decoder layers, fp32, the same seeded weights and frames on the card
   and on the CPU: a prefill of 2 prompts of 64 over 1 500 frames and 8
   teacher-forced decode steps through ``registry.prefill`` /
   ``decode_step``; every logit within 1e-3; launches exact (flash 6 a
   prefill, 2 of them cross; paged decode 4 a step).
   Then ``whisper_train_vs_cpu`` on those weights: one ``loss_fn`` forward
   and backward on 2 x 64 tokens, a quarter masked; the loss within 1e-5
   relative, every gradient leaf within 1e-3 of its max |g|; flash 6
   forwards and 6 backwards, 2 of each over keys of another length.
6i. ``whisper_tc_vs_plain``: the same model in bf16 serving storage, a
   prefill of 4 x 64 over 4 x 1 500 frames through the tensor-core flash
   kernel (the cross-attention's keys of another length included) against
   the plain attention, as 6d'; 6 flash launches, 2 of them cross.
6j. ``train_tc_vs_plain``: one bf16 training step of RecurrentGemma-9B (3
   layers, 2 x 1 024; its hd-256 backward on the CUDA cores) and of Whisper
   (2 + 2, 2 x 448 over 2 x 1 500 frames; every backward on the tensor
   cores, 2 over keys of another length) against the plain attention's
   autograd, as 6d'. Whisper's leaves whose floor (the plain attention
   reordered) reaches 80% of the 1% RMS limit are held to 1.25 times that
   floor. ``train_tc_floor_rule`` (``--train-recurrent``) reports what that
   rule lets through: Whisper's step with hand-written backwards, a
   correct one, one taking D from the bf16 output and one dropping the
   last key tile's dK and dV.
6k. ``recurrent_train_vs_cpu`` (after 6f, on every core): RecurrentGemma-9B
   (3 layers) and xLSTM-1.3B (8) at full width, fp32, weights made on the
   card and copied: one ``loss_fn`` forward and backward on 2 x 128 tokens
   against the CPU (loss 1e-5 relative, leaves 1e-3 of their max), then
   xLSTM's 6-step ``SimulatedRun`` at G = 2 against the CPU (1e-3) at
   AdamW eps 1e-6, every leaf; launches exact. ``--train-recurrent`` runs
   it at the default eps 1e-8 too (every leaf but the untied token table
   and output head, whose gaps are reported).
7. ``train``: full GPT-2 XL (bf16 compute, fp32 parameters and state),
   G = 2, sync_delay 0, per-group batch 2 x 1024 tokens, 10 steps of the
   same schedule shape (inner LR 5e-5, warmed up over the lazy start).
   The counters are set to 0 just before the run and must show flash
   forward = flash backward = 48 x (G x inner steps + warmup steps), all
   on the tensor cores (as in every bf16 serve and train phase), and
   pier_update = 484 leaves x outer syncs. Step and outer-dispatch times,
   tokens/s, peak memory, the loss history (finite), and the loss on one
   fixed validation batch, which must fall from before the run to after.
8a. ``train_qwen3``: the ``train`` run with full Qwen3-1.7B (1.72 B parameters, 310 leaves),
   where rmsnorm = rmsnorm_bwd = 113 x forwards as well.
8a'. ``train_minicpm``: MiniCPM-2B at full width and 4 layers in the
   ``train`` run, under the WSD schedule over 20 steps run to its end
   (warmup, stable, decay): the LR of every step is ``lr_at``'s, the
   validation loss falls, launches exact.
8a''. ``train_moe``: DeepSeek-V2-236B at full
   width, 2 layers, 8 of its 160 experts (top-6 and the 2 shared kept;
   1.772 B parameters, about 70 GB of the card) in the ``train`` run at
   per-group batch 2 x 512, 8 steps (lazy start, two outer applies): finite
   losses, the validation loss (on 4 x 512 tokens) falls, rmsnorm =
   rmsnorm_bwd = 9 x forwards, pier_update = 35 leaves x outer syncs, no
   flash (MLA's attention is plain); ``train_moe_breakdown`` (in
   ``--breakdowns`` and ``--moe-train``) groups one inner step's device
   time into AdamW and elementwise, bf16 and fp32 products, softmax, the
   MoE dispatch and RMSNorm, and lists the ten longest kernels.
8j. ``train_recurrent``: RecurrentGemma-9B at full width and 3 layers
   (2.60 B parameters) on the simulator's AdamW baseline (Pier's G = 2
   state does not fit one card) and xLSTM-1.3B at 8 layers on Pier at G =
   2, 2 x 512 a step, 8 steps: the validation loss falls, launches exact;
   ``train_recurrent_breakdown``: one inner step's device time by kernel
   group beside its wall time (the sLSTM loop is host-issued).
   ``train_whisper``: Whisper-large-v3 at full depth, 6 ``loss_fn`` +
   AdamW steps on one batch of 2 x 448 over 2 x 1 500 frames: the loss
   falls, 96 flash forwards and backwards a step on the tensor cores (32
   of each cross), a profiled step's device time and the flash backward's
   share of it.
8b. ``train_compressed``: the ``train`` run again after it is freed, with
   the quantized outer sync (int8, block 256, error feedback; the residual
   adds 2 x 6.25 GB): the same checks, and quantize = dequantize = 2 x 484
   leaves x outer syncs. (``--breakdowns``: after each of the two runs a
   ``*_dispatch_breakdown`` line, device time by kernel group of one more
   outer dispatch beside its wall time, and the idle share.)
8c. (8c, 8d, 8g and 8h run after 8f, their 2-rank jobs in one spawned
   world, ``two_rank_world``, which saves three worlds' start.)
   ``train_dist_vs_sim``: the multi-process Trainer (ranks sharing the
   card) against ``SimulatedRun`` on the card, GPT-2 medium width, 2 layers,
   fp32, per-group batch 2 x 256, 8 steps without lazy start (four outer
   syncs): flat, int8-wire and rs-ag at 2 ranks, delay 0 and 1, and
   Hierarchical over int8-wire at 4 ranks in 2 pods, Qwen3-1.7B width
   with int8-wire at 2 ranks (bit for bit, its rmsnorm launches counted),
   and DeepSeek-V2's reduced config (MLA + MoE) with int8-wire at delay 1
   (bit for bit).
   Losses and parameters within 1e-5 (the wire strategies bit for bit);
   every rank's launches exactly what its strategy's code path makes (ring,
   scatter and RMSNorm included).
8d. ``train_dist``: full GPT-2 medium (24 layers, 355 M parameters) on 2
   ranks sharing the card (G = 2, per-group batch 2 x 1024), 10 steps of the
   ``train`` schedule, once with int8-wire and once with rs-ag: finite loss,
   the validation loss falls, launches exact; tokens/s over both ranks,
   step, dispatch and apply times, ring and scatter times per sync, peak
   memory per rank. Two ranks share one card, so the rate is not a two-GPU
   rate.
8e. ``train_elastic``: full GPT-2 XL through ``SimulatedRun`` (G = 2, 10
   steps, quantized int8/256 sync) with ``drop:1@1,rejoin:1@2``: group 1's
   parameters (a strided sample of every leaf) untouched by event 1's
   apply, equal to the anchor with fresh AdamW state after its bootstrap;
   the validation loss falls; launches exact; step, dispatch and apply ms,
   peak memory.
8f. ``elastic_vs_cpu`` (GPT-2 XL width, 2 layers, fp32, G = 3, 12 steps,
   ``drop:1@1,rejoin:1@3,straggle:2@2+2`` with max_staleness 1: flat at
   delay 1, quantized int8/256 at delay 0, int8-wire at delay 1; each
   event's weights, live mask and bootstraps; card vs CPU within 1e-3,
   launches exact) and ``switch_vs_cpu`` (G = 2, 14 steps, a scripted
   controller: flat -> quantized(8, 256) at window 2, delay 0 -> 1 at 3,
   -> int4 wire at 4, -> flat at 5; the residual present exactly at windows
   2-4; card vs CPU within 1e-3, launches exact). Their card halves run
   first; their CPU halves then run in a thread on all but two of the
   host's cores while the 2-rank world of 8d, 8g and 8h runs, since the
   script's own process would otherwise wait for the ranks (the checks
   are the same).
8g. ``train_dist_elastic_vs_sim``: the Trainer on 2 ranks against
   ``SimulatedRun`` on the card, GPT-2 XL width, 2 layers, fp32, 8 steps
   with no lazy start: int8-wire and rs-ag at delay 0 and 1 with
   ``drop:1@1,rejoin:1@2`` (bit for bit), and a scripted flat -> int8-wire
   switch (within 1e-5, or three int8 quantization steps of its residual
   scale where larger: the flat windows mean Δθ in the Trainer and θ in the
   simulator); every rank's launches exact, ring and scatter included.
8h. ``train_dist_auto``: GPT-2 medium's width at 12 of its 24 layers (for
   the time limit) on 2 ranks, ``sync_delay="auto"``,
   14 steps, once with the measured controller and once with the adaptive
   ladder: per window t_inner, t_comm, d*, the rung and every switch (no
   bound on the decisions: they follow the card's timings; a measured
   warmup window times a world exchange of the parameters); the ladder
   must dispatch a window on a new rung, and every rank's quantize and
   dequantize launches must be those of the strategies its windows took;
   finite loss, the validation loss falls.
8i. ``train_dist_ckpt``: GPT-2 medium width at 4 layers (the checkpoint's
   bytes set the phase's time) on 2 ranks, int8-wire: 10 steps with
   outer-state offload; 6 steps without it and a save (about 2.6 GB a rank
   under ``build/ckpt_smoke``, deleted after); a fresh run whose
   ``rejoin_bootstrap="checkpoint"`` rejoin takes the saved anchor bit for
   bit; a fresh world restores and runs to step 10 with offload, bit for
   bit the uninterrupted run; save and restore seconds, peak and resident
   memory per rank with and without offload. ``--ckpt-depth`` runs it at
   all 24 layers (14.3 GB of checkpoint). The checkpoint is one
   ``step_*`` directory of both ranks in the reference Trainer's layout.
8j. ``handoff``: a ``ServeEngine`` at that width serves the ``serve``
   traffic with a ``CheckpointPoller`` on group 0 of an empty directory,
   into which the 8i checkpoint is moved after decode step 4: exactly one
   swap, at that step boundary; the served leaves the saved parameters cast
   to serving storage, bit for bit; the requests admitted after the swap a
   fresh engine's greedy tokens, logits within 1e-3 of max |logit|; the
   pool drained; launches exact.
9. a ``{"kernels": [...]}`` line: per kernel its launches on the main-path
   runs (serve, serve_qwen3, serve_families, serve_recurrent, serve_moe,
   serve_whisper and handoff, train,
   train_compressed, train_qwen3, train_minicpm, train_moe,
   train_recurrent, train_whisper, train_elastic and, summed over ranks, train_dist and train_dist_auto;
   for the CUDA-core attention forward and backward, which those bf16
   runs no longer take, their launches in the fp32 card-vs-CPU phases and
   the Trainer's fp32 cases; the hd-112 tensor-core forward's are Kimi-K2's
   prefills in serve_moe, the hd-256 one's RecurrentGemma's prefills in
   serve_recurrent; the tensor-core and CUDA-core forwards' entries also
   count their launches over keys of another length, ``cross_launches``,
   and so do the backwards' entries),
   max error,
   kernel / plain / library times and
   the bound at the main path's shape (bytes over 3.35 TB/s and operations
   over the peak rate of the inputs' type, the larger of the two; H100 SXM
   data sheet). A kernel with no launch fails the run.
10. the last line, ``{"ok": true, "device": {...}}``.

Fourteen studies run instead of the phases above when asked for, each
after the build, and print their own JSON lines:

    python3 chip_smoke.py --witness-lr     # the train run at Table I's LR,
                                           # kernels vs plain attention
    python3 chip_smoke.py --build-times    # parallel build vs one nvcc call
    python3 chip_smoke.py --int8-kv-depth  # full-depth Qwen3: int8 KV vs
                                           # bf16 / fp32 KV, bf16 vs fp32
    python3 chip_smoke.py --flash-precision  # flash_tc_vs_plain's step through
                                             # other attentions vs the plain one
    python3 chip_smoke.py --norm-quant     # phase 2's quantize, dequantize and
                                           # RMSNorm checks and times alone
    python3 chip_smoke.py --elastic        # phases 8e-8i alone
    python3 chip_smoke.py --ckpt-depth     # phase 8i at GPT-2 medium's 24 layers
    python3 chip_smoke.py --families       # phase 4c at full depth, bf16 and int8 KV
    python3 chip_smoke.py --recurrent      # phase 2's attention and decode
                                           # checks, phases 4d, 6d' and 6f alone
    python3 chip_smoke.py --moe            # phase 2's quantize, attention and
                                           # decode checks; 4e with DeepSeek-V2
                                           # at 8 layers (60.7 GB) and Kimi-K2
                                           # with bf16 and int8 KV (the scalar
                                           # quantize route); 6d''; 6g
    python3 chip_smoke.py --moe-train      # phase 2's RMSNorm and flash
                                           # backward checks; 6g with
                                           # moe_train_vs_cpu; 8a''; 8c
    python3 chip_smoke.py --whisper        # phase 2's attention and decode
                                           # checks, phases 4f, 6i and 6h
    python3 chip_smoke.py --breakdowns     # the reported-only profiles
    python3 chip_smoke.py --train-recurrent  # phase 2's flash backward
                                           # checks, 6j with its floor
                                           # rule's reading, 8j with its
                                           # profiles, 6h with
                                           # whisper_train_vs_cpu, 6k
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import gc
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12            # H100 SXM
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}  # dense, per second
NUM_LAYERS_XL = 48
REPS = 25
SLEEP_CYCLES = 4_000_000             # ~2 ms: covers the host's enqueue time


T_START = time.perf_counter()


_EMIT_LOCK = threading.Lock()  # lines from the CPU halves' thread stay whole


def emit(obj) -> None:
    """One JSON line; a phase's line also says when it was printed, in
    seconds since the script started (``t_s``), for the time budget."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - T_START}
    with _EMIT_LOCK:
        sys.stdout.write(json.dumps(obj) + "\n")
        sys.stdout.flush()


@contextlib.contextmanager
def large_allocations_on_the_heap():
    """Around the ``*_vs_cpu`` phases: their CPU halves allocate and free
    temporaries of up to 322 MB (one GPT-2 XL token-table leaf) on nearly
    every operation. glibc serves each from a fresh ``mmap`` and unmaps it
    on free, so every one pays its page faults again, and that is most of
    the CPU halves' time. Raising the mmap and trim thresholds keeps freed
    memory in the heap for reuse; on exit the defaults (128 KiB) come back
    and the heap is trimmed, so the phases after run as before. Host memory
    only; nothing on the card changes. The CPU halves also take every core
    the process may run on. Yields whether glibc took the settings."""
    import ctypes
    import ctypes.util

    name = ctypes.util.find_library("c")
    libc = ctypes.CDLL(name) if name else None
    m_trim_threshold, m_mmap_threshold = -1, -3

    def thresholds(value: int) -> bool:
        return (bool(libc.mallopt(m_mmap_threshold, ctypes.c_int(value)))
                and bool(libc.mallopt(m_trim_threshold, ctypes.c_int(value))))

    raised = libc is not None and hasattr(libc, "mallopt") and thresholds(2 ** 31 - 1)
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(max(threads, len(os.sched_getaffinity(0))))  # every core we may use
    try:
        yield raised
    finally:
        torch.set_num_threads(threads)
        if raised:
            gc.collect()
            thresholds(128 * 1024)
            libc.malloc_trim(0)


class Timer:
    """Device time of a callable with CUDA events, host overhead excluded.

    Each run flushes L2 (a 64 MB write), queues a sleep kernel so the host
    can enqueue the timed work behind it, and records events around the
    work alone; the result is the median over the runs, in ms.
    """

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def ms(self, fn, reps: int = REPS) -> float:
        torch = self.torch
        fn()  # warm up (allocator, first-launch attribute setting)
        torch.cuda.synchronize()
        events = []
        for _ in range(reps):
            self.flush.zero_()
            torch.cuda._sleep(SLEEP_CYCLES)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            events.append((s, e))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in events)


class Counter:
    """One wrapper's launch count, ``module.<attr>``, readable and settable
    as ``.launches``."""

    def __init__(self, module, attr: str = "launches"):
        self.module, self.attr = module, attr

    @property
    def launches(self) -> int:
        return getattr(self.module, self.attr)

    @launches.setter
    def launches(self, value: int) -> None:
        setattr(self.module, self.attr, value)


def bound_ms(nbytes: float, ops: float, dtype_name: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def attention_pairs(S: int, Skv: int, causal: bool, window: int) -> int:
    """(query, key) pairs of one head that the masks leave visible: key k
    for query q where k < Skv, k <= q if causal, and q - k < window if a
    window is set (the kernels' ``visible``)."""
    n = 0
    for q in range(S):
        hi = min(q + 1, Skv) if causal else Skv
        lo = max(0, q - window + 1) if window > 0 else 0
        n += max(0, hi - lo)
    return n


def free_cuda(torch) -> None:
    """Give the card's memory back before the next phase. A train run holds
    reference cycles (its timing wrappers refer to its own methods), which
    only the collector frees."""
    gc.collect()
    torch.cuda.empty_cache()


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


# ---------------------------------------------------------------------------
# the CPU halves of four card-vs-CPU phases, computed ahead in a process
# ---------------------------------------------------------------------------

AHEAD_CORES = 6  # host cores the process of the CPU halves computes on


class CpuHalvesAhead:
    """The CPU halves of ``train_vs_cpu``, ``train_compressed_vs_cpu``,
    ``qwen3_vs_cpu`` and ``whisper_vs_cpu``, whose inputs the CPU makes from
    seeds alone, computed in a process of their own (``chip_smoke.py
    --cpu-halves DIR``, started right after the build, at the lowest CPU
    priority) on the cores this process leaves idle: while it runs the
    kernel checks, the serve runs and the card-bound training runs. Each
    result is a file under ``build/cpu_halves``; ``get`` waits for it. The
    checks are the phases' own, on the same numbers: only where the CPU
    computes them moved. The process launches no kernel and makes no CUDA
    context. (It is never stopped with SIGSTOP: in the command's orphaned
    process group a stopped member makes the kernel send SIGHUP to the
    whole group when another of its processes exits.)"""

    def __init__(self):
        self.dir = ROOT / "build" / "cpu_halves"
        shutil.rmtree(self.dir, ignore_errors=True)
        self.dir.mkdir(parents=True)
        self.started = time.perf_counter()
        self.err = open(self.dir / "stderr.txt", "w")
        self.proc = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--cpu-halves", str(self.dir)],
            stdout=subprocess.DEVNULL, stderr=self.err, cwd=ROOT)

    def get(self, key: str, timeout: float = 1800.0):
        """(the CPU half ``key``'s result, seconds waited for it)."""
        import torch

        path = self.dir / f"{key}.pt"
        t0 = time.perf_counter()
        while not path.exists():
            if self.proc.poll() is not None and not path.exists():
                self.err.flush()
                tail = (self.dir / "stderr.txt").read_text()[-4000:]
                raise RuntimeError(f"the CPU halves' process ended with code "
                                   f"{self.proc.returncode} before {key}: {tail}")
            if time.perf_counter() - t0 > timeout:
                raise TimeoutError(f"no CPU half {key} after {timeout} s")
            time.sleep(0.1)
        waited = time.perf_counter() - t0
        out = torch.load(path, weights_only=False)
        path.unlink()
        return out, waited

    def close(self, wait: float = 0.0) -> None:
        """Stop the process: give it ``wait`` seconds to end by itself (it
        does once every result is written), then kill it."""
        if self.err.closed:
            return
        if self.proc.poll() is None:
            try:
                self.proc.wait(timeout=wait)
            except subprocess.TimeoutExpired:
                self.proc.kill()
        self.proc.wait()
        self.err.close()
        emit({"phase": "cpu_halves_ahead", "returncode": self.proc.returncode,
              "seconds_since_start": time.perf_counter() - self.started})


def _cpu_run(cfg, tc, base, steps: int, **kw):
    """A ``SimulatedRun`` comparison's CPU half: ``steps`` steps from a copy
    of ``base``, flushed -> its loss history and final parameters (the
    leaves of ``eval_params``, in ``param_leaves`` order)."""
    from repro_torch.core.simulate import SimulatedRun
    from repro_torch.models.transformer import param_leaves

    run = SimulatedRun(cfg, tc, device="cpu", params=copy.deepcopy(base), **kw)
    h = run.run(steps)
    run.flush()
    return {"train_loss": h["train_loss"],
            "params": [t.detach() for _, t in param_leaves(run.eval_params())]}


def _ahead_jobs():
    """(key, function) for every CPU half ``CpuHalvesAhead`` computes, in the
    order the script reads them."""
    cfg, base, make_tc = _train_vs_cpu_inputs()
    for delay in (0, 1):
        yield f"train_vs_cpu_d{delay}", lambda d=delay: _cpu_run(
            cfg, make_tc(d), base, TRAIN_VS_CPU_STEPS, num_groups=2)
    cfg, base, tcs = _compressed_inputs()
    for name, _, G, P, _ in COMPRESSED_CONFIGS:
        yield f"train_compressed_vs_cpu_{name}", lambda n=name, g=G, p=P: _cpu_run(
            cfg, tcs[n], base, COMPRESSED_STEPS, num_groups=g, num_pods=p)
    del cfg, base
    yield "qwen3_vs_cpu", _qwen3_vs_cpu_cpu_half
    yield "whisper_vs_cpu", _whisper_vs_cpu_cpu_half


def cpu_halves_ahead(outdir: str) -> int:
    """``--cpu-halves DIR``: the process ``CpuHalvesAhead`` starts. Computes
    each job of ``_ahead_jobs`` on ``AHEAD_CORES`` threads at the lowest
    CPU priority (nice 19: the script's own process, at nice 0, keeps the
    cores it uses) and writes its result to ``DIR/<key>.pt`` (written
    whole, then renamed)."""
    import ctypes
    import signal

    import torch

    # end with the script: killed if the process that started it dies
    ctypes.CDLL(None).prctl(1, signal.SIGKILL)  # PR_SET_PDEATHSIG
    os.nice(19)
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (the port's numerics flags, as in the script)

    out = Path(outdir)
    with large_allocations_on_the_heap():
        torch.set_num_threads(min(AHEAD_CORES, len(os.sched_getaffinity(0))))
        for key, fn in _ahead_jobs():
            t0 = time.perf_counter()
            res = fn()
            res["seconds"] = time.perf_counter() - t0
            torch.save(res, out / f"{key}.tmp")
            os.replace(out / f"{key}.tmp", out / f"{key}.pt")
    return 0


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def _quant_kernels(torch, fn):
    """Names of the quantize kernels one call of ``fn`` launches
    (``torch.profiler``): the route the C entry point took."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({evt.name for evt in prof.events()
                   if evt.device_type == DeviceType.CUDA and "quantize_blockwise" in evt.name})


def check_quantize(torch, timer, results):
    """The quantize kernel bit for bit against its plain version, each case
    twice (the second run must give the same bits), on the route the rule
    gives it: a power-of-two number of 16-byte vectors a block (up to 128)
    from an aligned x takes the vector kernel, anything else the scalar one.
    Cases: the serve paths' KV rows, the outer sync's ragged leaf, int4, n
    ending mid-vector at each block size, an unaligned view, block 96."""
    from repro_torch.kernels import quantize as QK
    from repro_torch.kernels.ref import quantize_blockwise_ref

    g = torch.Generator(device="cuda").manual_seed(1)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [
        # name, n, dtype, bits, block, route
        ("decode_kv_rows_bf16", 4 * 25 * 64, bf16, 8, 64, "vec"),
        ("prefill_kv_rows_bf16", 512 * 25 * 64, bf16, 8, 64, "vec"),
        ("prefill_kv_rows_f32", 512 * 25 * 64, f32, 8, 64, "vec"),
        ("qwen3_decode_kv_rows_bf16", 4 * 8 * 128, bf16, 8, 128, "vec"),
        ("qwen3_prefill_kv_rows_bf16", 512 * 8 * 128, bf16, 8, 128, "vec"),
        ("outer_block256_ragged", 100_003, f32, 8, 256, "vec"),
        ("int4_block256", 65_536, f32, 4, 256, "vec"),
        ("block256_bf16", 256 * 400, bf16, 8, 256, "vec"),
        ("mid_vector_block64_bf16", 64 * 100 + 3, bf16, 8, 64, "vec"),
        ("mid_vector_block128_bf16", 128 * 50 + 13, bf16, 8, 128, "vec"),
        ("mid_vector_block256_bf16", 256 * 30 + 5, bf16, 8, 256, "vec"),
        ("mid_vector_block64_f32", 64 * 100 + 2, f32, 8, 64, "vec"),
        ("mid_vector_block256_f32", 256 * 40 + 6, f32, 8, 256, "vec"),
        ("unaligned_view_block64_bf16", 64 * 300, bf16, 8, 64, "scalar"),
        ("block96_bf16_scalar_path", 96 * 200 + 7, bf16, 8, 96, "scalar"),
        # Kimi-K2's KV rows (8 KV heads, hd 112: 14 vectors a block, the scalar
        # kernel): a decode step's at 4 slots and a prefill layer's
        ("kimi_k2_decode_kv_rows_block112_bf16", 4 * 8 * 112, bf16, 8, 112, "scalar"),
        ("kimi_k2_prefill_kv_rows_block112_bf16", 512 * 8 * 112, bf16, 8, 112, "scalar"),
    ]
    worst = 0.0
    for name, n, dt, bits, block, want in cases:
        x = torch.randn(n, generator=g, device="cuda").to(dt)
        if name == "outer_block256_ragged":
            x[:block * 3] = 0  # whole zero blocks: scale 0, values 0
        if name.startswith("unaligned"):  # the same values one element into a buffer
            buf = torch.empty(n + 1, dtype=dt, device="cuda")
            buf[1:].copy_(x)
            x = buf[1:]
        q, s = QK.quantize_blockwise(x, bits=bits, block=block)
        q2, s2 = QK.quantize_blockwise(x, bits=bits, block=block)
        qr, sr = quantize_blockwise_ref(x, bits=bits, block=block)
        torch.cuda.synchronize()
        same = torch.equal(q, qr) and torch.equal(s, sr)
        repeats = torch.equal(q2, q) and torch.equal(s2, s)
        kernels = _quant_kernels(torch, lambda: QK.quantize_blockwise(x, bits=bits, block=block))
        route = (("vec" if "quantize_blockwise_vec_kernel" in kernels[0] else "scalar")
                 if len(kernels) == 1 else str(kernels))
        err = max(max_err(q, qr), max_err(s, sr))
        emit({"phase": "kernels", "kernel": "quantize_blockwise", "case": name,
              "n": n, "dtype": str(dt).replace("torch.", ""), "bits": bits,
              "block": block, "route": route, "bitwise_equal": same,
              "repeats_bitwise": repeats, "max_abs_err": err})
        if not (same and repeats and route == want):
            raise AssertionError(f"quantize {name}: kernel == plain version {same} (err "
                                 f"{err}), repeats {repeats}, route {route} (rule: {want})")
        worst = max(worst, err)

    def yardsticks(x, block):
        """The kernel, the plain version, the scalar kernel on an unaligned
        copy of x and a same-bytes cast to int8, each timed; the bound."""
        n = x.numel()
        buf = torch.empty(n + 1, dtype=x.dtype, device="cuda")
        buf[1:].copy_(x)
        xu, q8 = buf[1:], torch.empty(n, dtype=torch.int8, device="cuda")
        b, by = bound_ms(n * x.element_size() + n + -(-n // block) * 4, 4 * n, "float32")
        return {"ms": timer.ms(lambda: QK.quantize_blockwise(x, bits=8, block=block)),
                "plain_ms": timer.ms(lambda: quantize_blockwise_ref(x, bits=8, block=block)),
                "scalar_kernel_ms": timer.ms(
                    lambda: QK.quantize_blockwise(xu, bits=8, block=block)),
                "same_bytes_cast_ms": timer.ms(lambda: q8.copy_(x)),
                "bound_ms": b, "bound_by": by}

    # main path's shape: one prefill layer's K rows (S=512, 25 heads, hd 64)
    kv = yardsticks(torch.randn(512 * 25 * 64, generator=g, device="cuda").to(bf16), 64)
    # Qwen3-1.7B's: one prefill layer's K rows (S=512, 8 KV heads, hd 128)
    kvq = yardsticks(torch.randn(512 * 8 * 128, generator=g, device="cuda").to(bf16), 128)
    # one decode step's K rows, GPT-2 XL's and Qwen3-1.7B's (4 slots)
    dec = {name: yardsticks(torch.randn(n, generator=g, device="cuda").to(bf16), block)
           for name, n, block in (("gpt2_xl", 4 * 25 * 64, 64), ("qwen3", 4 * 8 * 128, 128))}
    # Kimi-K2's: one prefill layer's K rows (S=512, 8 KV heads, hd 112)
    kimi = yardsticks(torch.randn(512 * 8 * 112, generator=g, device="cuda").to(bf16), 112)
    # the training path's shape: one outer sync's largest leaf, fp32, block 256
    xt = torch.randn(XL_LEAF, generator=g, device="cuda") * 1e-3
    tr = yardsticks(xt, 256)
    del xt
    scalar_note = ("the scalar kernel (a warp a block, x read twice) on an unaligned copy "
                   "of the same x")
    results["quantize_blockwise"] = {
        "name": "quantize_blockwise", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/quantize.cu",
        "replaces": "src/repro/kernels/quantize.py:35",
        "shape": "bf16 (512*25*64,) block 64 (one prefill layer's K rows)",
        "max_abs_err": worst, "ms": kv["ms"], "kernel_ms": kv["ms"],
        "plain_ms": kv["plain_ms"], "bound_ms": kv["bound_ms"], "bound_by": kv["bound_by"],
        "library_ms": None, "scalar_kernel_ms": kv["scalar_kernel_ms"],
        "same_bytes_cast_ms": kv["same_bytes_cast_ms"], "scalar_kernel": scalar_note,
        "same_bytes_cast": "q8.copy_(x): x cast to int8, the same bytes read and written, "
                           "timed the same way; a floor of the card and the timer, not the "
                           "same function",
        "qwen3_shape": "bf16 (512*8*128,) block 128 (one Qwen3-1.7B prefill layer's K rows)",
        **{f"qwen3_shape_{k}": v for k, v in kvq.items()},
        "decode_shapes_note": "one decode step's K rows at 4 slots: bf16 (4*25*64,) block "
                              "64 (GPT-2 XL), (4*8*128,) block 128 (Qwen3-1.7B)",
        "decode_shapes": {k: {m: v[m] for m in ("ms", "scalar_kernel_ms", "bound_ms")}
                          for k, v in dec.items()},
        "kimi_k2_shape": {"shape": "bf16 (512*8*112,) block 112 (one Kimi-K2 prefill layer's "
                                   "K rows with int8 KV; the scalar kernel)", **kimi},
        "train_shape": "fp32 (50304*1600,) block 256 (GPT-2 XL token table)",
        **{f"train_shape_{k}": v for k, v in tr.items()},
        "train_shape_share_of_bound": tr["bound_ms"] / tr["ms"]}


XL_LEAF = 50304 * 1600  # GPT-2 XL's token table, the largest leaf


def check_dequantize(torch, timer, results):
    """The dequantize kernel bit for bit against its plain version, on the
    quantize kernel's own outputs; a ragged payload raises."""
    from repro_torch.kernels import quantize as QK
    from repro_torch.kernels.ref import dequantize_blockwise_ref

    g = torch.Generator(device="cuda").manual_seed(9)
    cases = [
        # name, n, bits, block
        ("outer_block256_ragged", 100_003, 8, 256),
        ("block64", 65_536 + 17, 8, 64),
        ("block32", 4096 * 3 + 1, 8, 32),
        ("int4_block256", 65_536, 4, 256),
        ("int4_block64_ragged", 9_999, 4, 64),
        ("block33_scalar_path", 33 * 1000 + 2, 8, 33),
        ("block4", 4 * 1000 + 3, 8, 4),
        ("block2_scalar_path", 2 * 1000 + 1, 8, 2),
        ("unaligned_view_block256", 256 * 300, 8, 256),
        ("xl_token_table_block256", XL_LEAF, 8, 256),
    ]
    worst = 0.0
    for name, n, bits, block in cases:
        x = torch.randn(n, generator=g, device="cuda") * 1e-3
        x[:block] = 0  # a whole zero block: scale 0, values 0
        q, s = QK.quantize_blockwise(x, bits=bits, block=block)
        if name.startswith("unaligned"):  # the same payload one byte into a buffer
            buf = torch.empty(q.numel() + 1, dtype=torch.int8, device="cuda")
            buf[1:].copy_(q)
            q = buf[1:]
        out = QK.dequantize_blockwise(q, s, block=block)
        ref = dequantize_blockwise_ref(q, s, block=block)
        torch.cuda.synchronize()
        same = out.dtype == torch.float32 and torch.equal(out, ref)
        emit({"phase": "kernels", "kernel": "dequantize_blockwise", "case": name,
              "n": n, "bits": bits, "block": block, "payload": q.numel(),
              "bitwise_equal": same, "max_abs_err": max_err(out, ref)})
        if not same:
            raise AssertionError(f"dequantize {name}: kernel != plain version")
        worst = max(worst, max_err(out, ref))
        del x, q, s, out, ref
    try:
        QK.dequantize_blockwise(torch.zeros(300, dtype=torch.int8, device="cuda"),
                                torch.zeros(2, device="cuda"), block=256)
    except ValueError as e:
        emit({"phase": "kernels", "kernel": "dequantize_blockwise", "case": "ragged_raises",
              "error": str(e)})
    else:
        raise AssertionError("dequantize: a ragged payload did not raise")

    # main path's shape: one outer sync's largest leaf, int8 at block 256
    x = torch.randn(XL_LEAF, generator=g, device="cuda") * 1e-3
    q, s = QK.quantize_blockwise(x, bits=8, block=256)
    del x
    t_k = timer.ms(lambda: QK.dequantize_blockwise(q, s, block=256))
    t_p = timer.ms(lambda: dequantize_blockwise_ref(q, s, block=256))
    # one PyTorch call for the same function: int8 times fp32 promotes to fp32
    lib_same = torch.equal(torch.mul(q.view(-1, 256), s[:, None]).view(-1),
                           QK.dequantize_blockwise(q, s, block=256))
    t_l = timer.ms(lambda: torch.mul(q.view(-1, 256), s[:, None]))
    n = q.numel()
    b, by = bound_ms(n + 4 * s.numel() + 4 * n, n, "float32")
    results["dequantize_blockwise"] = {
        "name": "dequantize_blockwise", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/dequantize.cu",
        "replaces": "src/repro/kernels/quantize.py:47",
        "shape": "int8 (50304*1600,) block 256 -> fp32 (GPT-2 XL token table)",
        "max_abs_err": worst, "ms": t_k, "kernel_ms": t_k, "plain_ms": t_p,
        "bound_ms": b, "bound_by": by, "library_ms": t_l,
        "library": "torch.mul(q.view(-1, 256), scale[:, None]) (int8 x fp32 -> fp32)",
        "library_same_bits": lib_same}


def rel_rms(a, b) -> float:
    """||a - b|| / ||b||: the error of a whole tensor, which a fault in one
    tile or one row moves even where the largest elements hide it from the
    max error."""
    d, r = (a.float() - b.float()).norm(), b.float().norm()
    return float(d / r) if float(r) > 0 else float(d)


# bf16 attention: at most about two bf16 roundings of the largest element
# (one ulp is 2^-7 of it at most), and a whole-tensor error of a few
# roundings' worth (one rounding has an RMS of 2^-9 / sqrt(3) ~ 1e-3).
BF16_MAX_REL, BF16_RMS_REL = 2e-2, 1e-2
LSE_TOL = 1e-4  # fp32 on both sides (the kernel reads bf16 inputs exactly)


def _route_of(FK, tc_before: int, launches: int, what: str) -> str:
    """The route the last ``launches`` launches took, from the tensor-core
    counter ``what`` (``tc_launches`` or ``tc_bwd_launches``)."""
    tc = getattr(FK, what) - tc_before
    if tc not in (0, launches):
        raise AssertionError(f"{what}: {tc} of {launches} launches took the tensor cores")
    return "tensor_cores" if tc else "cuda_cores"


def tc_rule(dtype: str, hd: int) -> bool:
    """The flash wrapper's forward routing rule, restated so that the launch
    expectations do not read it from the code they check: bf16 at head_dim
    64, 112, 128 or 256 takes the tensor-core forward."""
    return dtype == "bfloat16" and hd in (64, 112, 128, 256)


def tc_bwd_rule(dtype: str, hd: int) -> bool:
    """The backward's rule, restated the same way: bf16 at head_dim 64 or
    128 takes the tensor-core backward (at 112 and 256 the CUDA-core one)."""
    return dtype == "bfloat16" and hd in (64, 128)


def _core_fwd(torch, q, k, v, lse=None, window=0, causal=True):
    """The CUDA-core forward kernel (causal unless asked) through its C
    entry point, for inputs that the wrapper sends to the tensor cores: its
    time beside the new route's in one call. Not a path of the port; counts
    no launch."""
    from repro_torch.kernels import _build

    B, S, H, hd = q.shape
    out = torch.empty_like(q)
    err = _build.lib().flash_attention_fwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if lse is not None else None, _build.DTYPE_CODES[q.dtype], B, S, H,
        k.shape[2], hd, k.shape[1], int(causal), window, 0.0, 1.0 / math.sqrt(hd),
        q.device.index, _build.stream_ptr(q.device))
    _build.check(err, "flash_attention (CUDA cores)")
    return out


def _core_bwd(torch, q, k, v, out, lse, do, causal=True, window=0):
    """The CUDA-core backward kernels (causal unless asked; keys of
    ``k.shape[1]``) through their C entry point (as ``_core_fwd``)."""
    from repro_torch.kernels import _build

    B, S, H, hd = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    D = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    err = _build.lib().flash_attention_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), do.data_ptr(),
        lse.data_ptr(), D.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        _build.DTYPE_CODES[q.dtype], B, S, H, k.shape[2], hd, k.shape[1], int(causal), window,
        0.0, 1.0 / math.sqrt(hd), q.device.index, _build.stream_ptr(q.device))
    _build.check(err, "flash_attention backward (CUDA cores)")
    return dq, dk, dv


# Attention cases: name, B, S, H, Hkv, hd, dtype, causal, window, softcap.
# bf16 at head_dim 64, 112, 128 and 256 takes the tensor-core forward;
# those cases run GQA 2:1, 4:1, 5:1 and 8:1, MQA, MHA, window 64, softcap
# 30, non-causal and ragged S (1, 77, 200, 257, 300, 333, 700) on it. The
# rest take the CUDA-core route, as does the backward at head_dim 112 and
# 256.
FIVE_TO_ONE = ("qwen3_14b_gqa5_s512_bf16", "qwen3_14b_gqa5_s333_bf16")
# RecurrentGemma-9B's local attention: MQA 16:1 at hd 256 in bf16 (the
# tensor-core forward of flash_attention_tc256.cu), window 2048, at a
# prompt of 512 (the window as causal) and of 2304 (the window active)
RECURRENT_FLASH = ("recurrentgemma_mqa16_hd256_s512_w2048_bf16",
                   "recurrentgemma_mqa16_hd256_s2304_w2048_bf16")
# Kimi-K2's attention: GQA 8:1 at hd 112 in bf16 (the tensor-core forward
# of flash_attention_tc.cu on a tile padded to 128 columns), at a prompt of
# 512 and a ragged one
KIMI_FLASH = ("kimi_k2_gqa8_hd112_s512_bf16", "kimi_k2_gqa8_hd112_s333_bf16")
# Whisper-large-v3's attention (20 heads of hd 64): the encoder's non-causal
# self-attention over 1 500 frames, and the cross-attention of a prefill's
# 64 queries over those 1 500 keys
WHISPER_FLASH = ("whisper_encoder_b4_s1500_bf16", "whisper_cross_b4_s64_kv1500_bf16")
REPEATED_FLASH = FIVE_TO_ONE + RECURRENT_FLASH + KIMI_FLASH + WHISPER_FLASH  # the same bits twice
WHISPER_FRAMES = 1500  # Whisper-large-v3's encoder_seq_len
WHISPER_TOKENS = 448   # the original decoder's context: train_whisper's rows
WHISPER_TC_BATCH = (2, WHISPER_TOKENS)  # train_tc_vs_plain's Whisper batch
# the backward at the training shapes of Whisper (tensor cores) and of
# RecurrentGemma-9B (CUDA cores), in check_flash_bwd
WHISPER_BWD = ("whisper_cross_bwd_b2_s448_kv1500_bf16", "whisper_encoder_bwd_b2_s1500_bf16")
RECURRENT_BWD = ("recurrentgemma_bwd_b2_s1024_w2048_bf16",
                 "recurrentgemma_bwd_b1_s2304_w2048_bf16")


def _flash_cases(torch):
    bf, f32 = torch.bfloat16, torch.float32
    # bf16 at hd 256 through FlashAttentionFn in check_flash_bwd: the
    # forward on the tensor cores, the backward on the CUDA cores
    hd256_bwd = [("hd256_gqa_bf16", 1, 77, 4, 2, 256, bf, True, 0, 0.0),
                 ("hd256_mqa16_window64_bf16", 1, 200, 16, 1, 256, bf, True, 64, 0.0)]
    return {
        "tc": [
            ("tc_gqa2_hd128_s77", 1, 77, 8, 4, 128, bf, True, 0, 0.0),
            ("tc_gqa4_hd64_s200", 2, 200, 8, 2, 64, bf, True, 0, 0.0),
            ("tc_gqa4_hd128_s300", 1, 300, 8, 2, 128, bf, True, 0, 0.0),
            ("tc_mqa_hd64_s77", 2, 77, 4, 1, 64, bf, True, 0, 0.0),
            ("tc_mqa_hd128_s700", 1, 700, 8, 1, 128, bf, True, 0, 0.0),
            ("tc_window64_hd64_s300", 1, 300, 4, 4, 64, bf, True, 64, 0.0),
            ("tc_window64_hd128_s700", 1, 700, 4, 2, 128, bf, True, 64, 0.0),
            ("tc_softcap30_hd64_s200", 2, 200, 4, 4, 64, bf, True, 0, 30.0),
            ("tc_softcap30_hd128_s257", 1, 257, 4, 2, 128, bf, True, 0, 30.0),
            ("tc_noncausal_hd64_s77", 2, 77, 4, 4, 64, bf, False, 0, 0.0),
            ("tc_noncausal_hd128_s200", 1, 200, 4, 2, 128, bf, False, 0, 0.0),
            ("tc_noncausal_window64_softcap30_hd64_s700", 1, 700, 4, 2, 64, bf, False, 64, 30.0),
            ("tc_s1_hd64", 3, 1, 4, 4, 64, bf, True, 0, 0.0),
            ("tc_s1_hd128", 2, 1, 4, 2, 128, bf, True, 0, 0.0),
        ],
        # Qwen3-14B's GQA 5:1 at hd 128 (a query group of 5, not a power of
        # two), at a prefill's S and a ragged one
        "gqa5": [
            ("qwen3_14b_gqa5_s512_bf16", 1, 512, 40, 8, 128, bf, True, 0, 0.0),
            ("qwen3_14b_gqa5_s333_bf16", 1, 333, 40, 8, 128, bf, True, 0, 0.0),
        ],
        "recurrent": [
            (RECURRENT_FLASH[0], 1, 512, 16, 1, 256, bf, True, 2048, 0.0),
            (RECURRENT_FLASH[1], 1, 2304, 16, 1, 256, bf, True, 2048, 0.0),
        ],
        "kimi": [
            (KIMI_FLASH[0], 1, 512, 64, 8, 112, bf, True, 0, 0.0),
            (KIMI_FLASH[1], 1, 333, 64, 8, 112, bf, True, 0, 0.0),
        ],
        # the hd-112 forward's edges (the padded tile): one query row, a
        # ragged S, a window across key tiles, softcap, non-causal, MHA,
        # GQA 2:1 at two prompts of 512
        "tc112": [
            ("tc112_s1", 2, 1, 4, 2, 112, bf, True, 0, 0.0),
            ("tc112_gqa8_s77", 1, 77, 16, 2, 112, bf, True, 0, 0.0),
            ("tc112_window64_s300", 1, 300, 8, 1, 112, bf, True, 64, 0.0),
            ("tc112_softcap30_s257", 1, 257, 4, 2, 112, bf, True, 0, 30.0),
            ("tc112_noncausal_s200", 2, 200, 4, 2, 112, bf, False, 0, 0.0),
            ("tc112_mha_s200", 1, 200, 4, 4, 112, bf, True, 0, 0.0),
            ("tc112_gqa2_s512", 2, 512, 8, 4, 112, bf, True, 0, 0.0),
        ],
        "hd256_bwd": hd256_bwd,
        # the backward on this slice's training paths, each tuple ending with
        # the key length where it is not S: Whisper's cross-attention (448
        # tokens over 1 500 frames, no mask) and encoder (non-causal, S 1 500:
        # 23 full 64-row tiles and one of 28) on the tensor cores,
        # RecurrentGemma-9B's local attention (MQA 16:1, hd 256, window 2048)
        # on the CUDA cores at S 1 024 and 2 304 (the window cuts); each in
        # fp32 on the CUDA cores too; and the edges of keys of another length
        # (a ragged Sq and Skv, one query, fewer keys than queries, GQA 2:1,
        # hd 128 on the tensor cores, 112 and 256 on the CUDA cores)
        "train_bwd": [
            (WHISPER_BWD[0], 2, WHISPER_TOKENS, 20, 20, 64, bf, False, 0, 0.0, WHISPER_FRAMES),
            (WHISPER_BWD[1], 2, WHISPER_FRAMES, 20, 20, 64, bf, False, 0, 0.0),
            (RECURRENT_BWD[0], 2, 1024, 16, 1, 256, bf, True, 2048, 0.0),
            (RECURRENT_BWD[1], 1, 2304, 16, 1, 256, bf, True, 2048, 0.0),
            ("whisper_cross_bwd_b2_s448_kv1500_f32", 2, WHISPER_TOKENS, 20, 20, 64, f32, False,
             0, 0.0, WHISPER_FRAMES),
            ("whisper_encoder_bwd_b2_s1500_f32", 2, WHISPER_FRAMES, 20, 20, 64, f32, False, 0,
             0.0),
            ("recurrentgemma_bwd_b2_s1024_w2048_f32", 2, 1024, 16, 1, 256, f32, True, 2048, 0.0),
            ("recurrentgemma_bwd_b1_s2304_w2048_f32", 1, 2304, 16, 1, 256, f32, True, 2048, 0.0),
            ("cross_bwd_s77_kv300_hd128_bf16", 1, 77, 8, 4, 128, bf, False, 0, 0.0, 300),
            ("cross_bwd_s1_kv300_bf16", 2, 1, 4, 4, 64, bf, False, 0, 0.0, 300),
            ("cross_bwd_gqa2_s200_kv333_bf16", 1, 200, 8, 4, 64, bf, False, 0, 0.0, 333),
            ("cross_bwd_s300_kv77_bf16", 1, 300, 4, 2, 64, bf, False, 0, 0.0, 77),
            ("cross_bwd_hd112_s77_kv300_bf16", 1, 77, 8, 4, 112, bf, False, 0, 0.0, 300),
            ("cross_bwd_hd256_s77_kv300_bf16", 1, 77, 8, 4, 256, bf, False, 0, 0.0, 300),
            ("cross_bwd_gqa2_s200_kv333_f32", 1, 200, 8, 4, 64, f32, False, 0, 0.0, 333),
            ("cross_bwd_s300_kv77_f32", 1, 300, 4, 2, 64, f32, False, 0, 0.0, 77),
            ("cross_bwd_s1_kv300_f32", 2, 1, 4, 4, 64, f32, False, 0, 0.0, 300),
        ],
        # bf16 at hd 112 (Kimi-K2's GQA 8:1) through FlashAttentionFn: the
        # forward and its log-sum-exp on the tensor cores, the backward on
        # the CUDA cores
        "hd112_bwd": [("hd112_gqa8_bf16", 1, 77, 16, 2, 112, bf, True, 0, 0.0)],
        # the hd-256 forward's edges: two heads a block where H / Hkv is
        # even, one where it is odd (MHA)
        "tc256": [
            hd256_bwd[0],
            ("tc256_s1", 2, 1, 4, 2, 256, bf, True, 0, 0.0),
            ("tc256_mqa16_s333", 1, 333, 16, 1, 256, bf, True, 0, 0.0),
            ("tc256_window64_s300", 1, 300, 8, 1, 256, bf, True, 64, 0.0),
            ("tc256_softcap30_s257", 1, 257, 4, 2, 256, bf, True, 0, 30.0),
            ("tc256_noncausal_s200", 2, 200, 4, 2, 256, bf, False, 0, 0.0),
            ("tc256_mha_s200", 1, 200, 4, 4, 256, bf, True, 0, 0.0),
            ("tc256_gqa2_s512", 2, 512, 8, 4, 256, bf, True, 0, 0.0),
        ],
        # Whisper's encoder (non-causal, S 1 500: 23 full 64-row tiles and one
        # of 28) and its keys of another length than the queries (no mask),
        # each tuple ending with the key length: the cross-attention's
        # shapes, a ragged Sq, one query, GQA 2:1, the other tensor-core
        # head_dims, and fp32 on the CUDA cores
        "whisper": [
            (WHISPER_FLASH[0], 4, 1500, 20, 20, 64, bf, False, 0, 0.0),
            ("whisper_encoder_s1500_f32", 1, 1500, 20, 20, 64, f32, False, 0, 0.0),
            (WHISPER_FLASH[1], 4, 64, 20, 20, 64, bf, False, 0, 0.0, WHISPER_FRAMES),
            ("cross_s77_kv1500_bf16", 1, 77, 20, 20, 64, bf, False, 0, 0.0, WHISPER_FRAMES),
            ("cross_s1_kv300_bf16", 2, 1, 4, 4, 64, bf, False, 0, 0.0, 300),
            ("cross_gqa2_s200_kv333_bf16", 1, 200, 8, 4, 64, bf, False, 0, 0.0, 333),
            ("cross_hd128_s77_kv300_bf16", 1, 77, 8, 4, 128, bf, False, 0, 0.0, 300),
            ("cross_hd112_s77_kv300_bf16", 1, 77, 8, 4, 112, bf, False, 0, 0.0, 300),
            ("cross_hd256_s77_kv300_bf16", 1, 77, 8, 4, 256, bf, False, 0, 0.0, 300),
            ("cross_b4_s64_kv1500_f32", 4, 64, 20, 20, 64, f32, False, 0, 0.0, WHISPER_FRAMES),
            ("cross_s77_kv1500_f32", 1, 77, 20, 20, 64, f32, False, 0, 0.0, WHISPER_FRAMES),
            ("cross_s1_kv300_f32", 2, 1, 4, 4, 64, f32, False, 0, 0.0, 300),
            ("cross_gqa2_s200_kv333_f32", 1, 200, 8, 4, 64, f32, False, 0, 0.0, 333),
        ],
        "core": [
            ("hd40_window_softcap_bf16", 1, 45, 4, 2, 40, bf, True, 16, 10.0),
            ("gqa4_f32", 2, 200, 8, 2, 64, f32, True, 0, 0.0),
            ("mqa_hd128_f32", 1, 100, 8, 1, 128, f32, True, 0, 0.0),
            ("window64_f32", 1, 300, 4, 4, 64, f32, True, 64, 0.0),
            ("softcap30_f32", 1, 257, 4, 2, 64, f32, True, 0, 30.0),
            ("noncausal_f32", 2, 77, 4, 4, 64, f32, False, 0, 0.0),
            ("hd40_s1_f32", 3, 1, 4, 4, 40, f32, True, 0, 0.0),
        ],
    }


STORE_SENTINEL = 512.0  # no attention output of randn values reaches it


def _check_padded_store(torch, FK, rand):
    """The hd-112 store's column limit. The tensor-core forward, launched
    through its C entry point into the front of a buffer one head row
    longer than the (B, S, H, 112) output and filled with a sentinel, must
    write every element of the output and nothing past it: head h + 1's
    columns begin right after head h's column 111, and the last head of the
    last row ends the tensor, so a store of the padded tile's columns
    112-127 would land in the next head or past the end. Its output must be
    the wrapper's bit for bit and within the bf16 bounds of the plain
    version. Emits one line; returns it."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.ref import flash_attention_ref

    B, S, H, Hkv, hd = 2, 77, 8, 1, 112
    bf = torch.bfloat16
    q, k, v = rand((B, S, H, hd), bf), rand((B, S, Hkv, hd), bf), rand((B, S, Hkv, hd), bf)
    n = B * S * H * hd
    buf = torch.full((n + hd,), STORE_SENTINEL, dtype=bf, device="cuda")
    out = buf[:n].view(B, S, H, hd)
    err = _build.lib().flash_attention_fwd_tc_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None, B, S, H, Hkv, hd, S, 1,
        0, 0.0, 1.0 / math.sqrt(hd), q.device.index, _build.stream_ptr(q.device))
    _build.check(err, "flash_attention (tensor cores, hd 112)")
    ref = flash_attention_ref(q, k, v, causal=True)
    line = {"phase": "kernels", "kernel": "flash_attention", "case": "tc112_store_column_limit",
            "B": B, "S": S, "H": H, "Hkv": Hkv, "hd": hd,
            "tail_untouched": bool((buf[n:] == STORE_SENTINEL).all()),
            "every_element_written": not bool((out == STORE_SENTINEL).any()),
            "equal_to_wrapper": torch.equal(out, FK.flash_attention(q, k, v)),
            "max_abs_err": max_err(out, ref), "tol": BF16_MAX_REL, "rel_rms_err": rel_rms(out, ref)}
    emit(line)
    if not (line["tail_untouched"] and line["every_element_written"] and line["equal_to_wrapper"]
            and line["max_abs_err"] <= BF16_MAX_REL and line["rel_rms_err"] <= BF16_RMS_REL):
        raise AssertionError(f"flash tc112 store: {line}")
    return line


def check_flash(torch, timer, results):
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as FK
    from repro_torch.kernels.ref import flash_attention_fwd_ref, flash_attention_ref

    g = torch.Generator(device="cuda").manual_seed(2)

    def rand(shape, dt):
        return torch.randn(shape, generator=g, device="cuda").to(dt)

    bf, f32 = torch.bfloat16, torch.float32
    groups = _flash_cases(torch)
    cases = [
        ("xl_s128_bf16", 1, 128, 25, 25, 64, bf, True, 0, 0.0),
        ("xl_s512_bf16", 1, 512, 25, 25, 64, bf, True, 0, 0.0),
        ("xl_s700_bf16", 1, 700, 25, 25, 64, bf, True, 0, 0.0),
        ("xl_train_b2_s1024_bf16", 2, 1024, 25, 25, 64, bf, True, 0, 0.0),
        ("qwen3_s512_bf16", 1, 512, 16, 8, 128, bf, True, 0, 0.0),
        ("qwen3_s200_bf16", 1, 200, 16, 8, 128, bf, True, 0, 0.0),
        ("qwen3_train_b2_s1024_bf16", 2, 1024, 16, 8, 128, bf, True, 0, 0.0),
        *groups["tc"],
        *groups["gqa5"],
        *groups["recurrent"],
        *groups["tc256"],
        *groups["kimi"],
        *groups["tc112"],
        *groups["whisper"],
        ("xl_s512_f32", 1, 512, 25, 25, 64, f32, True, 0, 0.0),
        ("hd256_f32", 1, 77, 2, 1, 256, f32, True, 0, 0.0),
        ("hd40_f32", 1, 45, 4, 2, 40, f32, True, 16, 10.0),
        *groups["core"],
    ]
    # the largest error of each kernel: tensor cores at hd 64 / 128, at hd
    # 112, at hd 256, CUDA cores
    worst = {"tensor_cores": 0.0, "tensor_cores_hd112": 0.0, "tensor_cores_hd256": 0.0,
             "cuda_cores": 0.0}
    for name, B, S, H, Hkv, hd, dt, causal, window, softcap, *kv_len in cases:
        Skv = kv_len[0] if kv_len else S  # keys of another length: no mask
        opts = dict(causal=causal, window=window, softcap=softcap)
        q = rand((B, S, H, hd), dt)
        k, v = rand((B, Skv, Hkv, hd), dt), rand((B, Skv, Hkv, hd), dt)
        tc0, tc112, tc256 = FK.tc_launches, FK.tc112_launches, FK.tc256_launches
        cross0 = FK.cross_launches
        out = FK.flash_attention(q, k, v, **opts)
        # the training forward: the same kernel, writing the log-sum-exp too
        out_t, lse = FK._launch_fwd(q, k, v, causal, window, softcap, want_lse=True)
        route = _route_of(FK, tc0, 2, "tc_launches")
        hd112, hd256 = FK.tc112_launches - tc112, FK.tc256_launches - tc256
        cross = FK.cross_launches - cross0
        ref, lse_ref = flash_attention_fwd_ref(q, k, v, **opts)
        torch.cuda.synchronize()
        err, rms = max_err(out, ref), rel_rms(out, ref)
        lse_err = max_err(lse, lse_ref)
        same_out = torch.equal(out_t, out)
        if name in REPEATED_FLASH:  # the newer head layouts: a second run gives the same bits
            same_out = same_out and torch.equal(FK.flash_attention(q, k, v, **opts), out)
        tol = 1e-4 if dt == torch.float32 else 2e-2
        emit({"phase": "kernels", "kernel": "flash_attention", "case": name, "route": route,
              "B": B, "S": S, "Skv": Skv, "H": H, "Hkv": Hkv, "hd": hd,
              "dtype": str(dt).replace("torch.", ""), "causal": causal,
              "window": window, "softcap": softcap, "max_abs_err": err, "tol": tol,
              "rel_rms_err": rms, "lse_max_abs_err": lse_err, "lse_tol": LSE_TOL,
              "out_with_lse_equal": same_out})
        ok = out.dtype == q.dtype and err <= tol and lse_err <= LSE_TOL and same_out
        if dt == torch.bfloat16:
            ok = ok and rms <= BF16_RMS_REL
        if (route == "tensor_cores") != tc_rule(str(dt).replace("torch.", ""), hd):
            raise AssertionError(f"flash {name}: took the {route} route")
        for n, at in ((hd112, 112), (hd256, 256)):
            if n != (2 if route == "tensor_cores" and hd == at else 0):
                raise AssertionError(f"flash {name}: {n} launches counted at hd {at}")
        if cross != (2 if Skv != S else 0):
            raise AssertionError(f"flash {name}: {cross} launches counted with keys of another "
                                 f"length")
        if not ok:
            raise AssertionError(f"flash {name}: max err {err} (limit {tol}), rel rms "
                                 f"{rms}, lse err {lse_err} (limit {LSE_TOL}), output "
                                 f"with lse equal: {same_out}")
        key = route + ("_hd112" if hd112 else "_hd256" if hd256 else "")
        worst[key] = max(worst[key], err)
    padded_store = _check_padded_store(torch, FK, rand)
    # keys of another length with a causal mask: refused before any launch
    q, k = rand((1, 64, 20, 64), bf), rand((1, WHISPER_FRAMES, 20, 64), bf)
    n0 = FK.launches
    try:
        FK.flash_attention(q, k, k, causal=True)
    except ValueError as e:
        emit({"phase": "kernels", "kernel": "flash_attention",
              "case": "cross_causal_raises", "error": str(e), "launched": FK.launches - n0})
    else:
        raise AssertionError("flash: causal attention over keys of another length did not raise")
    if FK.launches != n0:
        raise AssertionError("flash: the refused causal cross case launched")

    def timed(B, S, H, Hkv, hd, want_lse):
        """Tensor-core, CUDA-core, plain and SDPA times of the causal forward
        at one shape, and its bound (inputs read and outputs written once;
        QK^T and PV over the unmasked pairs). ``ms`` is the wrapper's route,
        ``cuda_cores_ms`` the CUDA-core kernel through its C entry point."""
        q = rand((B, S, H, hd), bf)
        k, v = (rand((B, S, Hkv, hd), bf) for _ in range(2))
        lse = torch.empty((B, H, S), dtype=torch.float32, device="cuda") if want_lse else None
        out = {
            "ms": timer.ms(lambda: FK._launch_fwd(q, k, v, True, 0, 0.0, want_lse=want_lse)),
            "plain_ms": timer.ms(lambda: (flash_attention_fwd_ref if want_lse else
                                          flash_attention_ref)(q, k, v, causal=True))}
        out["cuda_cores_ms"] = timer.ms(lambda: _core_fwd(torch, q, k, v, lse))
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        out["library_ms"] = timer.ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=Hkv != H))
        nbytes = 2 * B * S * (2 * H + 2 * Hkv) * hd + (4 * B * H * S if want_lse else 0)
        out["bound_ms"], out["bound_by"] = bound_ms(
            nbytes, 4 * hd * H * B * (S * (S + 1) // 2), "bfloat16")
        return out

    # main path's shapes: the longest prompt's prefill attention in one layer
    # (GPT-2 XL, Qwen3-1.7B), and one training layer's forward with its lse
    xl, q3 = timed(1, 512, 25, 25, 64, False), timed(1, 512, 16, 8, 128, False)
    xl_t, q3_t = timed(2, 1024, 25, 25, 64, True), timed(2, 1024, 16, 8, 128, True)
    # the prefill layers of Granite-8B (GQA 4:1) and Qwen3-14B (5:1)
    fam = {"granite_8b_gqa4": {"shape": "bf16 B=1 S=512 H=32 Hkv=8 hd=128 causal",
                               **timed(1, 512, 32, 8, 128, False)},
           "qwen3_14b_gqa5": {"shape": "bf16 B=1 S=512 H=40 Hkv=8 hd=128 causal",
                              **timed(1, 512, 40, 8, 128, False)}}
    # Kimi-K2's prefill layer (GQA 8:1, hd 112, the padded tile): one prompt
    # as the paged engine prefills it, and 4 prompts at once; the bound
    # counts the work at hd 112, not the padded 128
    kimi = {"shape": "bf16 B=1 S=512 H=64 Hkv=8 hd=112 causal (one prefill layer of "
                     "serve_moe)", **timed(1, 512, 64, 8, 112, False),
            "batch_4": {"shape": "bf16 B=4 S=512 H=64 Hkv=8 hd=112 causal",
                        **timed(4, 512, 64, 8, 112, False)}}
    for t in (kimi, kimi["batch_4"]):
        t["bound_share"] = t["bound_ms"] / t["ms"]
        t["cuda_cores_bound_share"] = t["bound_ms"] / t["cuda_cores_ms"]
        t["over_library"] = t["ms"] / t["library_ms"]
    def timed_noncausal(B, S, Skv, H, hd):
        """The non-causal forward over Skv keys (Whisper's encoder at Skv =
        S, its cross-attention at another Skv) through the wrapper (the
        tensor-core route), the CUDA-core kernel through its C entry point,
        the plain version and SDPA, and the bound over every pair."""
        q = rand((B, S, H, hd), bf)
        k, v = (rand((B, Skv, H, hd), bf) for _ in range(2))
        out = {"shape": f"bf16 B={B} S={S} Skv={Skv} H=Hkv={H} hd={hd} non-causal",
               "ms": timer.ms(lambda: FK.flash_attention(q, k, v, causal=False)),
               "cuda_cores_ms": timer.ms(lambda: _core_fwd(torch, q, k, v, causal=False)),
               "plain_ms": timer.ms(lambda: flash_attention_ref(q, k, v, causal=False))}
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        out["library_ms"] = timer.ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))
        out["bound_ms"], out["bound_by"] = bound_ms(
            2 * B * (2 * S + 2 * Skv) * H * hd, 4 * hd * H * B * S * Skv, "bfloat16")
        out["bound_share"] = out["bound_ms"] / out["ms"]
        out["over_library"] = out["ms"] / out["library_ms"]
        return out

    # Whisper-large-v3's prefill layers: the encoder over 4 x 1 500 frames,
    # and the cross-attention of 4 prompts of 64 over them
    whisper = {"encoder": timed_noncausal(4, WHISPER_FRAMES, WHISPER_FRAMES, 20, 64),
               "cross": timed_noncausal(4, 64, WHISPER_FRAMES, 20, 64),
               "library": "F.scaled_dot_product_attention forward, no mask"}

    def timed_window(B, S, H, Hkv, hd, window):
        """The windowed causal forward through the wrapper (the tensor-core
        route at hd 256), the CUDA-core kernel through its C entry point, the
        plain version and SDPA (``is_causal`` where the window covers the
        prompt, else a boolean band mask, with ``is_causal`` beside it as a
        yardstick over more pairs), and the bound over the pairs the window
        keeps."""
        q = rand((B, S, H, hd), bf)
        k, v = (rand((B, S, Hkv, hd), bf) for _ in range(2))
        tc0 = FK.tc256_launches
        out = {"ms": timer.ms(lambda: FK.flash_attention(q, k, v, causal=True,
                                                          window=window))}
        if FK.tc256_launches == tc0:
            raise AssertionError("bf16 at hd 256 did not take the tensor-core route")
        out["cuda_cores_ms"] = timer.ms(lambda: _core_fwd(torch, q, k, v, window=window))
        out["plain_ms"] = timer.ms(lambda: flash_attention_ref(q, k, v, causal=True,
                                                               window=window))
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))

        def causal_sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)

        if window >= S:
            out["library_ms"] = timer.ms(causal_sdpa)
        else:
            i = torch.arange(S, device="cuda")
            band = (i[None, :] <= i[:, None]) & (i[:, None] - i[None, :] < window)
            out["library_ms"] = timer.ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=band, enable_gqa=True))
            out["library_is_causal_ms"] = timer.ms(causal_sdpa)
        pairs = sum(min(i + 1, window) for i in range(S))
        out["bound_ms"], out["bound_by"] = bound_ms(
            2 * B * S * (2 * H + 2 * Hkv) * hd, 4 * hd * H * B * pairs, "bfloat16")
        out["bound_share"] = out["bound_ms"] / out["ms"]
        out["cuda_cores_bound_share"] = out["bound_ms"] / out["cuda_cores_ms"]
        return out

    # RecurrentGemma-9B's local-attention prefill layer: the serve phase's
    # 4 prompts of 512, and one prompt past the window
    rg = {"serve_prefill": {"shape": "bf16 B=4 S=512 H=16 Hkv=1 hd=256 causal window 2048 "
                                     "(one prefill layer of serve_recurrent)",
                            **timed_window(4, 512, 16, 1, 256, 2048)},
          "window_active": {"shape": "bf16 B=1 S=2304 H=16 Hkv=1 hd=256 causal window 2048",
                            **timed_window(1, 2304, 16, 1, 256, 2048)}}
    library = "F.scaled_dot_product_attention forward"
    results["flash_attention_tc"] = {
        "name": "flash_attention_tc", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_tc.cu",
        "replaces": "src/repro/kernels/flash_attention.py:42",
        "shape": "bf16 B=1 S=512 H=Hkv=25 hd=64 causal (one prefill layer)",
        "max_abs_err": worst["tensor_cores"], "ms": xl["ms"], "kernel_ms": xl["ms"],
        "plain_ms": xl["plain_ms"], "bound_ms": xl["bound_ms"], "bound_by": xl["bound_by"],
        "library_ms": xl["library_ms"], "library": library,
        "qwen3": {"shape": "bf16 B=1 S=512 H=16 Hkv=8 hd=128 causal (one prefill layer)",
                  **q3},
        "train_shape": {"shape": "bf16 B=2 S=1024 H=Hkv=25 hd=64 causal, with lse "
                                 "(one training layer)", **xl_t},
        "qwen3_train_shape": {"shape": "bf16 B=2 S=1024 H=16 Hkv=8 hd=128 causal, with "
                                       "lse (one training layer)", **q3_t},
        "families": fam, "whisper": whisper}
    results["flash_attention_tc112"] = {
        "name": "flash_attention_tc112", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_tc.cu",
        "replaces": "src/repro/kernels/flash_attention.py:42",
        "route_note": "the tensor-core forward at bf16 hd 112 (Kimi-K2's prefill): the hd-128 "
                      "design on a tile padded to 128 columns, through "
                      "flash_attention_fwd_tc_launch; cuda_cores_ms is the CUDA-core kernel "
                      "that ran this shape before, timed in the same call",
        "shape": kimi["shape"], "max_abs_err": worst["tensor_cores_hd112"],
        "ms": kimi["ms"], "kernel_ms": kimi["ms"], "plain_ms": kimi["plain_ms"],
        "bound_ms": kimi["bound_ms"], "bound_by": kimi["bound_by"],
        "bound_share": kimi["bound_share"], "cuda_cores_ms": kimi["cuda_cores_ms"],
        "library_ms": kimi["library_ms"], "library": library + " (is_causal, enable_gqa)",
        "over_library": kimi["over_library"], "batch_4": kimi["batch_4"],
        "store_column_limit": padded_store}
    main, act = rg["serve_prefill"], rg["window_active"]
    results["flash_attention_tc256"] = {
        "name": "flash_attention_tc256", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_tc256.cu",
        "replaces": "src/repro/kernels/flash_attention.py:42",
        "route_note": "the tensor-core forward at bf16 hd 256 (RecurrentGemma-9B's prefill), "
                      "through flash_attention_fwd_tc_launch; cuda_cores_ms is the CUDA-core "
                      "kernel that ran this shape before, timed in the same call",
        "shape": main["shape"], "max_abs_err": worst["tensor_cores_hd256"],
        "ms": main["ms"], "kernel_ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "bound_share": main["bound_share"], "cuda_cores_ms": main["cuda_cores_ms"],
        "library_ms": main["library_ms"], "library": library + " (is_causal)",
        "window_active": {**act, "library": library + " with a boolean band mask "
                                 "(library_ms); is_causal over every causal pair "
                                 "(library_is_causal_ms)"}}
    results["flash_attention"] = {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:42",
        "route_note": "the CUDA-core kernel: fp32 and bf16 head_dims other than 64 / 112 / "
                      "128 / 256, launched on the main path by the fp32 phases and no bf16 "
                      "run; the top-level numbers time it through its C entry point at "
                      "RecurrentGemma-9B's hd-256 prefill, which it ran until the hd-256 "
                      "tensor-core kernel, kimi_k2_hd112 at Kimi-K2's prefill, which it ran "
                      "until the hd-112 one, and the GPT-2 XL and Qwen3 entries at bf16 "
                      "shapes the tensor-core kernel takes",
        "shape": main["shape"], "max_abs_err": worst["cuda_cores"], "ms": main["cuda_cores_ms"],
        "kernel_ms": main["cuda_cores_ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": main["library_ms"], "library": library,
        "recurrentgemma_window_active": {
            "shape": act["shape"], "ms": act["cuda_cores_ms"], "plain_ms": act["plain_ms"],
            "bound_ms": act["bound_ms"], "bound_by": act["bound_by"],
            "library_ms": act["library_ms"]},
        "gpt2_xl": {"shape": "bf16 B=1 S=512 H=Hkv=25 hd=64 causal (one prefill layer)",
                    "ms": xl["cuda_cores_ms"], "plain_ms": xl["plain_ms"],
                    "bound_ms": xl["bound_ms"], "bound_by": xl["bound_by"],
                    "library_ms": xl["library_ms"]},
        "qwen3": {"shape": "bf16 B=1 S=512 H=16 Hkv=8 hd=128 causal (one prefill layer)",
                  "ms": q3["cuda_cores_ms"], "plain_ms": q3["plain_ms"],
                  "bound_ms": q3["bound_ms"], "bound_by": q3["bound_by"],
                  "library_ms": q3["library_ms"]},
        "kimi_k2_hd112": {
            k: {"shape": t["shape"], "ms": t["cuda_cores_ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "bound_share": t["cuda_cores_bound_share"], "library_ms": t["library_ms"]}
            for k, t in (("serve_prefill_b1", kimi), ("batch_4", kimi["batch_4"]))},
        "whisper": {k: {"shape": whisper[k]["shape"], "ms": whisper[k]["cuda_cores_ms"],
                        "plain_ms": whisper[k]["plain_ms"], "bound_ms": whisper[k]["bound_ms"],
                        "bound_by": whisper[k]["bound_by"],
                        "library_ms": whisper[k]["library_ms"]}
                    for k in ("encoder", "cross")}}


def _paged_inputs(torch, g, *, B, H, Hkv, hd, bs, cls, dt, quantized, T=None):
    """Random q and pools; each sequence gets distinct shuffled blocks."""
    from repro_torch.kernels import quantize as QK

    need = [-(-c // bs) for c in cls]
    T = T or max(max(need), 1)
    N = sum(need) + 3
    perm = torch.randperm(N - 1, generator=g, device="cuda") + 1
    tables = torch.full((B, T), -1, dtype=torch.int32, device="cuda")
    used = 0
    for b, n in enumerate(need):
        tables[b, :n] = perm[used:used + n].to(torch.int32)
        used += n
    context = torch.tensor(cls, dtype=torch.int32, device="cuda")
    q = torch.randn((B, H, hd), generator=g, device="cuda").to(dt)
    kf = torch.randn((N, bs, Hkv, hd), generator=g, device="cuda")
    vf = torch.randn((N, bs, Hkv, hd), generator=g, device="cuda")
    if quantized:
        def q8(x):
            qv, s = QK.quantize_blockwise(x.reshape(-1), bits=8, block=hd)
            return qv.reshape(x.shape), s.reshape(x.shape[:-1])
        (kp, ks), (vp, vs) = q8(kf), q8(vf)
        return q, kp, vp, tables, context, ks, vs
    return q, kf.to(dt), vf.to(dt), tables, context, None, None


def _dense_view_inputs(torch, g, *, B, H, Hkv, hd, size, cls, dt=None):
    """Random q and a dense (B, size, Hkv, hd) cache (bf16 unless ``dt``),
    viewed as the dense serve path views it (``models/attention.py:
    _block_view``): a pool of B * size / 16 blocks with the identity block
    table."""
    from repro_torch.models.attention import DENSE_BLOCK, _block_view

    dt = dt or torch.bfloat16
    q = torch.randn((B, H, hd), generator=g, device="cuda").to(dt)
    k, v = (torch.randn((B, size, Hkv, hd), generator=g, device="cuda").to(dt)
            for _ in range(2))
    nblk = size // DENSE_BLOCK
    tables = torch.arange(B * nblk, dtype=torch.int32, device="cuda").view(B, nblk)
    context = torch.tensor(cls, dtype=torch.int32, device="cuda")
    return q, _block_view(k), _block_view(v), tables, context, None, None


def stage_ms(torch, timer, fn, stages, reps: int = REPS):
    """Device ms of the two kernels ``fn`` launches, by ``torch.profiler``
    (L2 flushed before each call, as ``Timer`` does): ``stages`` maps a
    substring of each kernel's name to its stage, first kernel first. The
    second kernel is launched to start while the first drains, so its time
    is counted from the first kernel's end to its own. Medians over the
    calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            timer.flush.zero_()
            fn()
        torch.cuda.synchronize()
    spans = {stage: [] for stage in stages.values()}
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            for key, stage in stages.items():
                if key in evt.name:
                    spans[stage].append((evt.time_range.start, evt.time_range.end))
    (first, a), (second, b) = spans.items()
    if not (len(a) == len(b) == reps):
        return {first: "not measured", second: "not measured"}
    return {first: statistics.median(e - s for s, e in a) / 1e3,
            second: statistics.median(eb - ea for (_, ea), (_, eb) in zip(a, b)) / 1e3}


DECODE_STAGES = {"paged_decode_split": "split", "paged_decode_combine": "merge"}


FAMILY_CLS = [128, 256, 384, 512]  # the serve phase's prompt lengths
KIMI_CLS = [513, 522, 533, 544]      # serve_moe's decode contexts (4 x 512 + 32)


def check_decode(torch, timer, results):
    """The paged decode kernels against ``paged_decode_attention_ref``: every
    case within 1e-4 in fp32 and 2e-2 in bf16 (one bf16 rounding of a
    unit-scale output, plus another summation order), zeros for empty
    slots, and the same bits when run again. Timed at the serve phase's
    shape (4 slots), and at two bandwidth-bound shapes (16 slots of long
    contexts) beside SDPA on a contiguous copy of the same K/V."""
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as DK
    from repro_torch.kernels.ref import paged_decode_attention_ref

    g = torch.Generator(device="cuda").manual_seed(3)
    bf16, f32 = torch.bfloat16, torch.float32
    xl_cls = [100, 250, 400, 544]
    slots32 = [0 if i % 11 == 5 else 1 + (97 * i * i + 31 * i) % 1500 for i in range(32)]
    cases = [
        # name, B, H, Hkv, hd, bs, cls, dtype, quantized, window, softcap
        ("xl_4slots_bf16", 4, 25, 25, 64, 16, xl_cls, bf16, False, 0, 0.0),
        ("xl_4slots_int8", 4, 25, 25, 64, 16, xl_cls, bf16, True, 0, 0.0),
        ("xl_4slots_f32", 4, 25, 25, 64, 16, xl_cls, f32, False, 0, 0.0),
        ("xl_int8_f32q", 4, 25, 25, 64, 16, xl_cls, f32, True, 0, 0.0),
        ("qwen3_4slots_bf16", 4, 16, 8, 128, 16, xl_cls, bf16, False, 0, 0.0),
        ("qwen3_4slots_int8", 4, 16, 8, 128, 16, xl_cls, bf16, True, 0, 0.0),
        ("qwen3_4slots_f32", 4, 16, 8, 128, 16, xl_cls, f32, False, 0, 0.0),
        ("gqa4_f32", 3, 8, 2, 64, 16, [37, 1, 300], f32, False, 0, 0.0),
        ("mqa_f32", 2, 8, 1, 32, 8, [60, 17], f32, False, 0, 0.0),
        ("window40_f32", 2, 4, 2, 64, 16, [200, 33], f32, False, 40, 0.0),
        ("softcap30_f32", 2, 4, 2, 64, 16, [90, 129], f32, False, 0, 30.0),
        ("empty_slots_f32", 4, 4, 4, 64, 16, [0, 70, 0, 5], f32, False, 0, 0.0),
        ("bs7_hd40_f32", 2, 6, 3, 40, 7, [50, 13], f32, False, 0, 0.0),
        ("hd256_g16_f32", 1, 16, 1, 256, 16, [333], f32, False, 0, 0.0),
        # contexts on split boundaries (spans of 64), a window across three
        # splits, 32 slots (some empty), Qwen3's heads at a context of 4096
        ("xl_split_boundaries_bf16", 4, 25, 25, 64, 16, [64, 128, 192, 256], bf16, False, 0,
         0.0),
        ("window150_across_splits_f32", 3, 4, 2, 64, 16, [300, 190, 70], f32, False, 150, 0.0),
        ("xl_32slots_bf16", 32, 25, 25, 64, 16, slots32, bf16, False, 0, 0.0),
        ("qwen3_ctx4096_bf16", 2, 16, 8, 128, 16, [4096, 1000], bf16, False, 0, 0.0),
        ("qwen3_ctx4096_int8", 2, 16, 8, 128, 16, [4096, 1000], bf16, True, 0, 0.0),
        # Qwen3-14B's GQA 5:1 at hd 128, 4 slots over the serve phase's contexts
        ("qwen3_14b_gqa5_4slots_bf16", 4, 40, 8, 128, 16, FAMILY_CLS, bf16, False, 0, 0.0),
        ("qwen3_14b_gqa5_4slots_int8", 4, 40, 8, 128, 16, FAMILY_CLS, bf16, True, 0, 0.0),
        # Kimi-K2's GQA 8:1 at hd 112 (14 vectors a row: 2 of 16 lanes idle),
        # bf16 and int8 pools (scales at block 112), at serve_moe's contexts
        ("kimi_k2_gqa8_hd112_4slots_bf16", 4, 64, 8, 112, 16, KIMI_CLS, bf16, False, 0, 0.0),
        ("kimi_k2_gqa8_hd112_4slots_int8", 4, 64, 8, 112, 16, KIMI_CLS, bf16, True, 0, 0.0),
    ]
    worst = 0.0
    for name, B, H, Hkv, hd, bs, cls, dt, quant, window, softcap in cases:
        args = _paged_inputs(torch, g, B=B, H=H, Hkv=Hkv, hd=hd, bs=bs, cls=cls,
                             dt=dt, quantized=quant,
                             T=None if name != "empty_slots_f32" else 8)
        out = DK.paged_decode_attention(*args, window=window, softcap=softcap)
        again = DK.paged_decode_attention(*args, window=window, softcap=softcap)
        ref = paged_decode_attention_ref(*args, window=window, softcap=softcap)
        torch.cuda.synchronize()
        err = max_err(out, ref)
        tol = 1e-4 if dt == torch.float32 else 2e-2
        zeros_ok = all(float(out[b].abs().max()) == 0.0 for b in range(B) if cls[b] == 0)
        repeats = torch.equal(out, again)
        T = args[3].shape[1]
        emit({"phase": "kernels", "kernel": "paged_decode_attention", "case": name,
              "B": B, "H": H, "Hkv": Hkv, "hd": hd, "bs": bs, "context_lens": cls,
              "dtype": str(dt).replace("torch.", ""), "int8_pools": quant,
              "window": window, "softcap": softcap, "splits": DK.num_splits(T, bs),
              "span": DK.split_size(T, bs), "max_abs_err": err, "tol": tol,
              "empty_slots_zero": zeros_ok, "repeats_bitwise": repeats})
        if not (out.dtype == dt and err <= tol and zeros_ok and repeats):
            raise AssertionError(f"decode {name}: max err {err} > {tol}, a nonzero empty "
                                 f"slot or a second run that differs ({repeats})")
        worst = max(worst, err)

    # RecurrentGemma-9B's decode over its dense cache viewed as a pool
    # (``models/attention.py``: identity block table, bs 16, no window):
    # 4 slots of a linear cache of 544 slots (the serve phase's 512 + 32) at
    # contexts 513-544, and a full ring of 2048 (the window); Whisper's
    # cross-attention decode: 4 slots, one query over the 1 500 encoder keys
    # of a cross cache of 1 504 rows (94 blocks, the last 4 rows past the
    # context), bf16 and fp32
    whisper_cls = [WHISPER_FRAMES] * 4
    for name, B, size, cls, H, Hkv, hd, dt in (
            ("recurrentgemma_dense_view_544_bf16", 4, 544, [513, 522, 533, 544], 16, 1, 256,
             bf16),
            ("recurrentgemma_dense_ring2048_bf16", 4, 2048, [2048] * 4, 16, 1, 256, bf16),
            ("whisper_cross_4slots_ctx1500_bf16", 4, 1504, whisper_cls, 20, 20, 64, bf16),
            ("whisper_cross_4slots_ctx1500_f32", 4, 1504, whisper_cls, 20, 20, 64, f32)):
        args = _dense_view_inputs(torch, g, B=B, H=H, Hkv=Hkv, hd=hd, size=size, cls=cls, dt=dt)
        out = DK.paged_decode_attention(*args)
        again = DK.paged_decode_attention(*args)
        ref = paged_decode_attention_ref(*args)
        torch.cuda.synchronize()
        err, repeats = max_err(out, ref), torch.equal(out, again)
        tol = 1e-4 if dt == f32 else 2e-2
        emit({"phase": "kernels", "kernel": "paged_decode_attention", "case": name,
              "B": B, "H": H, "Hkv": Hkv, "hd": hd, "bs": 16, "cache_slots": size,
              "context_lens": cls, "dtype": str(dt).replace("torch.", ""),
              "dense_cache_view": True,
              "splits": DK.num_splits(size // 16, 16), "span": DK.split_size(size // 16, 16),
              "max_abs_err": err, "tol": tol, "repeats_bitwise": repeats})
        if not (out.dtype == dt and err <= tol and repeats):
            raise AssertionError(f"decode {name}: max err {err} > {tol} or a second run that "
                                 f"differs ({repeats})")
        worst = max(worst, err)

    def decode_bytes(cls, H, Hkv, hd, T):  # live K/V rows, q, out (bf16); table, lengths
        B = len(cls)
        return 2 * sum(cls) * Hkv * hd * 2 + 2 * B * H * hd * 2 + 4 * B * T + 4 * B

    def timed(cls, H, Hkv, hd, T, *, quantized=False, sdpa=False):
        args = _paged_inputs(torch, g, B=len(cls), H=H, Hkv=Hkv, hd=hd, bs=16, cls=cls,
                             dt=bf16, quantized=quantized, T=T)
        b, by = bound_ms(decode_bytes(cls, H, Hkv, hd, T), 4 * sum(cls) * H * hd, "bfloat16")
        out = {"B": len(cls), "context_lens": cls, "T": T, "splits": DK.num_splits(T, 16),
               "ms": timer.ms(lambda: DK.paged_decode_attention(*args)),
               "plain_ms": timer.ms(lambda: paged_decode_attention_ref(*args)),
               "bound_ms": b, "bound_by": by}
        out["bound_share"] = b / out["ms"]
        if sdpa:  # the same K/V gathered into a contiguous copy (not timed)
            q, kp, vp, tables, context = args[:5]
            B, S = len(cls), max(cls)
            bt = tables.long().clamp_min(0)
            kc, vc = (p[bt].reshape(B, T * 16, Hkv, hd)[:, :S].transpose(1, 2).contiguous()
                      for p in (kp, vp))
            mask = (torch.arange(S, device="cuda")[None, :] < context[:, None])[:, None, None]
            qs = q[:, :, None, :]
            out["sdpa_contiguous_ms"] = timer.ms(lambda: F.scaled_dot_product_attention(
                qs, kc, vc, attn_mask=mask, enable_gqa=Hkv != H))
        return out

    def timed_dense(B, size, cls, H=16, Hkv=1, hd=256):
        """As ``timed``, over a dense cache view (RecurrentGemma's heads
        unless given), beside SDPA on a (B, Hkv, S, hd) copy of the live
        rows (the copy not timed; no mask where every slot sees all S)."""
        args = _dense_view_inputs(torch, g, B=B, H=H, Hkv=Hkv, hd=hd, size=size, cls=cls)
        T = size // 16
        b, by = bound_ms(decode_bytes(cls, H, Hkv, hd, T), 4 * sum(cls) * H * hd, "bfloat16")
        out = {"B": B, "context_lens": cls, "T": T, "splits": DK.num_splits(T, 16),
               "ms": timer.ms(lambda: DK.paged_decode_attention(*args)),
               "plain_ms": timer.ms(lambda: paged_decode_attention_ref(*args)),
               "bound_ms": b, "bound_by": by}
        out["bound_share"] = b / out["ms"]
        q, kp, vp = args[:3]
        S = max(cls)
        kc, vc = (p.view(B, size, Hkv, hd)[:, :S].transpose(1, 2).contiguous()
                  for p in (kp, vp))
        mask = (None if min(cls) == S else
                (torch.arange(S, device="cuda")[None, :] < args[4][:, None])[:, None, None])
        out["sdpa_contiguous_ms"] = timer.ms(lambda: F.scaled_dot_product_attention(
            q[:, :, None, :], kc, vc, attn_mask=mask, enable_gqa=Hkv != H))
        return out

    def stages(cls, H, Hkv, hd, T):
        args = _paged_inputs(torch, g, B=len(cls), H=H, Hkv=Hkv, hd=hd, bs=16, cls=cls,
                             dt=bf16, quantized=False, T=T)
        return stage_ms(torch, timer, lambda: DK.paged_decode_attention(*args), DECODE_STAGES)

    # main path's shape: one decode step of one layer, 4 slots, bf16 pools
    xl = timed(xl_cls, 25, 25, 64, 34)
    xl8 = timed(xl_cls, 25, 25, 64, 34, quantized=True)
    pos, H, hd = sum(xl_cls), 25, 64
    b8, _ = bound_ms(2 * pos * H * (hd + 4) + 2 * 4 * H * hd * 2 + 4 * 34 * 4 + 4 * 4,
                     4 * pos * H * hd, "bfloat16")
    # Qwen3-1.7B's decode layer: 16 query heads over 8 KV heads, hd 128
    q3 = timed(xl_cls, 16, 8, 128, 34)
    # MiniCPM-2B's, Granite-8B's and Qwen3-14B's decode layers at the serve contexts
    fam = {name: {"shape": f"bf16 4 slots, contexts 128/256/384/512, bs 16, H={H} Hkv={Hkv} "
                           f"hd {hd} (one layer)",
                  **timed(FAMILY_CLS, H, Hkv, hd, 34)}
           for name, H, Hkv, hd in (("minicpm_2b_mha", 36, 36, 64),
                                    ("granite_8b_gqa4", 32, 8, 128),
                                    ("qwen3_14b_gqa5", 40, 8, 128))}
    fam["kimi_k2_gqa8_hd112"] = {
        "shape": "bf16 4 slots, contexts 513-544, bs 16, H=64 Hkv=8 hd 112 (one decode layer "
                 "of serve_moe)", **timed(KIMI_CLS, 64, 8, 112, 34, sdpa=True),
        "int8_pools_ms": timed(KIMI_CLS, 64, 8, 112, 34, quantized=True)["ms"]}
    fam["recurrentgemma_dense_view"] = {
        "shape": "bf16 4 slots of a dense cache of 544 viewed as a pool, contexts 513-544, "
                 "bs 16, H=16 Hkv=1 hd 256 (one decode layer of serve_recurrent)",
        **timed_dense(4, 544, [544] * 4)}
    fam["recurrentgemma_dense_ring2048"] = {
        "shape": "bf16 4 slots of a full ring of 2048 viewed as a pool, bs 16, H=16 Hkv=1 "
                 "hd 256", **timed_dense(4, 2048, [2048] * 4)}
    fam["whisper_cross"] = {
        "shape": "bf16 4 slots, one query over 1 500 encoder keys of a cross cache of 1 504 "
                 "rows viewed as a pool, bs 16, H=Hkv=20 hd 64 (one decode layer's "
                 "cross-attention of serve_whisper)",
        **timed_dense(4, 1504, whisper_cls, H=20, Hkv=20, hd=64)}
    # bandwidth-bound shapes: 16 slots of long contexts
    xl16 = timed([256 + round(i * 768 / 15) for i in range(16)], 25, 25, 64, 64, sdpa=True)
    q316 = timed([1024 + round(i * 3072 / 15) for i in range(16)], 16, 8, 128, 256, sdpa=True)
    results["paged_decode_attention"] = {
        "name": "paged_decode_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:64",
        "shape": "bf16 4 slots, contexts 100/250/400/544, bs 16, H=Hkv=25, hd 64 (one layer)",
        "max_abs_err": worst, "ms": xl["ms"], "kernel_ms": xl["ms"], "plain_ms": xl["plain_ms"],
        "bound_ms": xl["bound_ms"], "bound_by": xl["bound_by"], "library_ms": None,
        "splits": xl["splits"], "stages_ms": stages(xl_cls, 25, 25, 64, 34),
        "int8_pools_ms": xl8["ms"], "int8_pools_bound_ms": b8,
        "qwen3": {"shape": "bf16 4 slots, contexts 100/250/400/544, bs 16, H=16 Hkv=8 "
                           "hd 128 (one layer)",
                  **{k: q3[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
                  "stages_ms": stages(xl_cls, 16, 8, 128, 34)},
        "families": fam,
        "bandwidth_shapes": {
            "gpt2_xl_16slots": {"shape": "bf16 16 slots, contexts 256-1024, bs 16, H=Hkv=25, "
                                         "hd 64", **xl16},
            "qwen3_16slots": {"shape": "bf16 16 slots, contexts 1024-4096, bs 16, H=16 Hkv=8, "
                                       "hd 128", **q316},
            "sdpa_note": "F.scaled_dot_product_attention with a key-padding mask over a "
                         "contiguous copy of the same K/V (contiguous copy, gather not timed): "
                         "a yardstick of another function, never called by the port"}}


def check_pier_update(torch, timer, results):
    from repro_torch.kernels import pier_update as PK
    from repro_torch.kernels.ref import pier_update_ref

    g = torch.Generator(device="cuda").manual_seed(7)
    cases = []
    for form in ("nesterov_torch", "nesterov_classic", "sgd"):
        for mdt in (torch.float32, torch.bfloat16):
            for n in (4096 * 5 + 77, XL_LEAF):  # ragged, and one XL leaf
                cases.append((form, mdt, n))
    for form, mdt, n in cases:
        a = torch.randn(n, generator=g, device="cuda")
        m = torch.randn(n, generator=g, device="cuda").to(mdt)
        d = torch.randn(n, generator=g, device="cuda") * 1e-3
        mu, lr = 0.95, 1.1
        pr, mr = pier_update_ref(a, m, d, mu=mu, lr=lr, formulation=form)
        mr = mr.to(mdt)
        p, mm = PK.pier_update(a, m, d, mu, lr, form)
        same = torch.equal(p, pr) and torch.equal(mm, mr)
        if mdt == torch.float32:  # in place, as the outer sync runs it
            a2, m2 = a.clone(), m.clone()
            PK.pier_update(a2, m2, d, mu, lr, form, p_out=a2, m_out=m2)
            same = same and torch.equal(a2, pr) and torch.equal(m2, mr)
        torch.cuda.synchronize()
        err = max(max_err(p, pr), max_err(mm, mr))
        emit({"phase": "kernels", "kernel": "pier_update", "case": f"{form}_n{n}",
              "n": n, "momentum_dtype": str(mdt).replace("torch.", ""),
              "bitwise_equal": same, "max_abs_err": err})
        if not same:
            raise AssertionError(f"pier_update {form} {mdt} n={n}: kernel != plain "
                                 f"version (err {err})")

    # main path's shape: one XL leaf, fp32 state, updated in place
    a = torch.randn(XL_LEAF, generator=g, device="cuda")
    m = torch.randn(XL_LEAF, generator=g, device="cuda")
    d = torch.randn(XL_LEAF, generator=g, device="cuda") * 1e-3
    t_k = timer.ms(lambda: PK.pier_update(a, m, d, 0.9, 1.1, p_out=a, m_out=m))
    t_p = timer.ms(lambda: pier_update_ref(a, m, d, mu=0.9, lr=1.1))
    b, by = bound_ms(20 * XL_LEAF, 5 * XL_LEAF, "float32")  # read a, m, d; write p, m
    results["pier_update"] = {
        "name": "pier_update", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/pier_update.cu",
        "replaces": "src/repro/kernels/pier_update.py:29",
        "shape": "fp32 (50304*1600,) in place, nesterov_torch (GPT-2 XL token table)",
        "max_abs_err": 0.0, "ms": t_k, "kernel_ms": t_k, "plain_ms": t_p,
        "bound_ms": b, "bound_by": by, "library_ms": None}


# RMSNorm: fp32 outputs, rstd and dx within 2e-6 of the largest |value|
# (the mean of squares and sum_j g_j s_j x_j are summed in another order);
# bf16 outputs within one bf16 ulp of the plain version's (the fp32 values
# differ by about 1e-7 relative, so their roundings differ by one ulp at
# most), bf16 dx the same plus 2e-6 of its largest |value| (its two terms
# may cancel to near zero); dscale, a sum over every row, within 1e-5 of
# its largest |value|.
RMS_F32_REL, RMS_DSCALE_REL = 2e-6, 1e-5


def bf16_ulps(torch, a, b, atol: float = 0.0) -> float:
    """Largest (|a - b| - atol) in units of one bf16 ulp of b."""
    bf = b.float()
    ulp = torch.exp2(torch.floor(torch.log2(bf.abs().clamp_min(1e-30))) - 7)
    return float((((a.float() - bf).abs() - atol).clamp_min(0) / ulp).max())


def rel_max(a, b) -> float:
    """max |a - b| over max |b|."""
    scale = float(b.float().abs().max())
    return max_err(a, b) / scale if scale > 0 else max_err(a, b)


RMSNORM_BWD_STAGES = {"rmsnorm_bwd": "dx_and_partials", "rmsnorm_colsum": "column_sum"}


def _fwd_entry(torch, x, s, eps, want_rstd=True, *, register: bool):
    """One RMSNorm forward kernel through its C entry point, whichever the
    wrapper's route would take: the register path (``rmsnorm_fwd_launch``,
    on the wrapper's grid) or the block-a-row kernel
    (``rmsnorm_fwd_rowblock_launch``, any shape), the yardstick whose bits
    the register path must give. Both timed beside each other in one call;
    counts no launch."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import rmsnorm as RK

    D = x.shape[-1]
    rows = x.numel() // D
    out = torch.empty_like(x)
    rstd = torch.empty((rows,), dtype=torch.float32, device=x.device) if want_rstd else None
    args = (x.data_ptr(), s.data_ptr(), out.data_ptr(), rstd.data_ptr() if want_rstd else None,
            _build.DTYPE_CODES[x.dtype], rows, D, float(eps))
    card = (x.device.index, _build.stream_ptr(x.device))
    if register:
        err = _build.lib().rmsnorm_fwd_launch(*args, RK.fwd_blocks(rows, D), *card)
    else:
        err = _build.lib().rmsnorm_fwd_rowblock_launch(*args, *card)
    _build.check(err, f"rmsnorm ({'register path' if register else 'block a row'})")
    return out, rstd


def check_rmsnorm(torch, timer, results):
    """The RMSNorm forward and backward kernels against ``rmsnorm_ref`` and
    ``rmsnorm_bwd_ref`` at Qwen3-1.7B's shapes (block norms at d_model
    2048, qk-norm at head_dim 128 and eps 1e-6; training, prefill and
    decode rows), at the MoE families' widths (DeepSeek-V2's MLA latent
    norms at 1536 and 512, eps 1e-6, over a prefill's, a decode step's and
    a training group's 1024 rows, the last with the backward timed; block
    norms at 5120 and Kimi-K2's at 7168) and at edge shapes (D 40 and 41, one row, D 5000 with
    several vectors a thread, fp32, ragged sets of 32 vectors at D 1600 in
    bf16 and D 1000 in fp32, an unaligned view). The forward's route must
    be the rule's (``fwd_register_path``: aligned rows of at most 256
    vectors of 16 bytes take the register path, those of more than 32 only
    from 1024 rows up), and the register-path kernel's y and rstd must be bit
    for bit those of the block-a-row kernel (``_fwd_entry``) at every
    case its entry point takes, whichever route the wrapper picks."""
    import torch.nn.functional as F

    from repro_torch.kernels import rmsnorm as RK
    from repro_torch.kernels.ref import rmsnorm_bwd_ref, rmsnorm_ref

    g = torch.Generator(device="cuda").manual_seed(9)
    bf16, f32 = torch.bfloat16, torch.float32

    def inputs(rows, D, dt):
        x = (torch.randn((rows, D), generator=g, device="cuda") * 2 + 0.5).to(dt)
        s = 1 + 0.1 * torch.randn((D,), generator=g, device="cuda")
        dy = torch.randn((rows, D), generator=g, device="cuda").to(dt)
        return x, s, dy

    cases = [
        # name, rows, D, dtype, eps
        ("train_block_norm_2048x2048_bf16", 2048, 2048, bf16, 1e-5),
        ("train_qk_norm_32768x128_bf16", 32768, 128, bf16, 1e-6),
        ("prefill_512x2048_bf16", 512, 2048, bf16, 1e-5),
        ("decode_4x2048_bf16", 4, 2048, bf16, 1e-5),
        ("decode_qk_64x128_bf16", 64, 128, bf16, 1e-6),
        ("d40_37rows_bf16", 37, 40, bf16, 1e-5),
        ("d40_37rows_f32", 37, 40, f32, 1e-5),
        ("d41_scalar_f32", 5, 41, f32, 1e-6),
        ("one_row_2048_f32", 1, 2048, f32, 1e-5),
        ("train_block_norm_2048x2048_f32", 2048, 2048, f32, 1e-5),
        ("qk_norm_4096x128_f32", 4096, 128, f32, 1e-6),
        ("d5000_3rows_f32", 3, 5000, f32, 1e-5),
        ("d1600_ragged_sets_1100rows_bf16", 1100, 1600, bf16, 1e-5),  # 200 vectors
        ("d1000_ragged_sets_1100rows_f32", 1100, 1000, f32, 1e-5),  # 250 vectors
        ("unaligned_view_64x2048_bf16", 64, 2048, bf16, 1e-5),
        # the MoE families' widths: DeepSeek-V2's MLA q_norm (1536) over a
        # prefill's rows and kv_norm (512) over a decode step's, its block
        # norm (5120) and Kimi-K2's (7168)
        ("deepseek_q_norm_prefill_2048x1536_bf16", 2048, 1536, bf16, 1e-6),
        ("deepseek_kv_norm_decode_4x512_bf16", 4, 512, bf16, 1e-6),
        ("deepseek_block_norm_decode_4x5120_bf16", 4, 5120, bf16, 1e-5),
        ("kimi_block_norm_prefill_512x7168_bf16", 512, 7168, bf16, 1e-5),
        # DeepSeek-V2's MLA latent norms over a training group's 2 x 512 rows
        ("deepseek_train_q_norm_1024x1536_bf16", 1024, 1536, bf16, 1e-6),
        ("deepseek_train_kv_norm_1024x512_bf16", 1024, 512, bf16, 1e-6),
    ]
    worst_fwd = worst_bwd = 0.0
    for name, rows, D, dt, eps in cases:
        x, s, dy = inputs(rows, D, dt)
        if name.startswith("unaligned"):  # the same rows one element into a buffer
            buf = torch.empty(rows * D + 1, dtype=dt, device="cuda")
            buf[1:].copy_(x.reshape(-1))
            x = buf[1:].view(rows, D)
        vec = 16 // x.element_size()
        fits = D % vec == 0 and D // vec <= 256 and not name.startswith("unaligned")
        want_route = ("register" if fits and (D // vec <= 32 or rows >= 1024)
                      else "block_a_row")
        route = "register" if RK.fwd_register_path(x) else "block_a_row"
        out = RK.rmsnorm(x, s, eps=eps)
        out_t, rstd = RK._launch_fwd(x, s, eps, want_rstd=True)
        out_rb, rstd_rb = _fwd_entry(torch, x, s, eps, register=False)
        # the register path wherever its entry point takes the rows
        out_rp, rstd_rp = (_fwd_entry(torch, x, s, eps, register=True) if fits
                           else (out_rb, rstd_rb))
        dx, ds = RK._launch_bwd(x, s, rstd, dy)
        dx2, ds2 = RK._launch_bwd(x, s, rstd, dy)
        # autograd on the same rows, in place (an unaligned view stays unaligned)
        flat = (x._base if x._base is not None else x).detach().reshape(-1).clone()
        flat.requires_grad_()
        at = slice(x.storage_offset(), x.storage_offset() + x.numel())
        sg = s.clone().requires_grad_()
        RK.rmsnorm(flat[at].view(rows, D), sg, eps=eps).backward(dy)
        xg_grad = flat.grad[at].view(rows, D)
        ref = rmsnorm_ref(x, s, eps=eps)
        rstd_ref = torch.rsqrt(x.float().square().mean(-1) + eps)
        dx_ref, ds_ref = rmsnorm_bwd_ref(x, s, dy, eps=eps)
        torch.cuda.synchronize()
        errs = {"out_max_abs_err": max_err(out, ref), "rstd_rel_err": rel_max(rstd, rstd_ref),
                "dx_max_abs_err": max_err(dx, dx_ref), "dscale_rel_err": rel_max(ds, ds_ref)}
        same = (torch.equal(out_t, out) and torch.equal(xg_grad, dx)
                and torch.equal(sg.grad, ds))
        repeats = torch.equal(dx2, dx) and torch.equal(ds2, ds)
        rowblock_bits = (torch.equal(out_t, out_rb) and torch.equal(rstd, rstd_rb)
                         and torch.equal(out_rp, out_rb) and torch.equal(rstd_rp, rstd_rb))
        if dt == f32:
            errs.update(out_rel_err=rel_max(out, ref), dx_rel_err=rel_max(dx, dx_ref))
            ok = errs["out_rel_err"] <= RMS_F32_REL and errs["dx_rel_err"] <= RMS_F32_REL
            tol = {"out_rel": RMS_F32_REL, "dx_rel": RMS_F32_REL}
            worst_fwd = max(worst_fwd, errs["out_max_abs_err"])
            worst_bwd = max(worst_bwd, errs["dx_max_abs_err"])
        else:
            atol = RMS_F32_REL * float(dx_ref.float().abs().max())
            errs.update(out_bf16_ulps=bf16_ulps(torch, out, ref),
                        dx_bf16_ulps_beyond_atol=bf16_ulps(torch, dx, dx_ref, atol))
            ok = errs["out_bf16_ulps"] <= 1 and errs["dx_bf16_ulps_beyond_atol"] <= 1
            tol = {"out_bf16_ulps": 1, "dx_bf16_ulps": 1, "dx_atol_rel": RMS_F32_REL}
        ok = (ok and errs["rstd_rel_err"] <= RMS_F32_REL
              and errs["dscale_rel_err"] <= RMS_DSCALE_REL
              and same and repeats and out.dtype == dx.dtype == dt and ds.dtype == f32
              and route == want_route and rowblock_bits)
        tol.update(rstd_rel=RMS_F32_REL, dscale_rel=RMS_DSCALE_REL)
        emit({"phase": "kernels", "kernel": "rmsnorm", "case": name, "rows": rows, "D": D,
              "dtype": str(dt).replace("torch.", ""), "eps": eps, "fwd_route": route, **errs,
              "tol": tol, "with_rstd_and_autograd_bitwise_equal": same,
              "register_path_fits": fits, "fwd_y_and_rstd_bitwise_block_a_row": rowblock_bits,
              "bwd_repeats_bitwise": repeats})
        if not ok:
            raise AssertionError(f"rmsnorm {name}: errors {errs}, limits {tol}, "
                                 f"outputs of both paths equal: {same}, backward "
                                 f"repeats: {repeats}, forward route {route} (rule: "
                                 f"{want_route}), y and rstd those of the block-a-row "
                                 f"kernel: {rowblock_bits}")

    def fwd_bytes(rows, D, rstd):  # x in, y out (bf16); scale in; rstd out
        return 2 * rows * D * 2 + 4 * D + (4 * rows if rstd else 0)

    def bwd_bytes(rows, D):  # x, dy in, dx out (bf16); rstd, scale in; dscale out
        return 3 * rows * D * 2 + 4 * rows + 8 * D

    # main path's shapes, bf16: the training block norm and qk-norm (with
    # rstd, as autograd runs them, and their backward), one 512-token
    # prefill's block norm and one decode step's (4 rows)
    fwd, bwd = {}, {}
    for key, rows, D, eps, train in (("train_block", 2048, 2048, 1e-5, True),
                                     ("train_qk", 32768, 128, 1e-6, True),
                                     ("prefill", 512, 2048, 1e-5, False),
                                     ("decode", 4, 2048, 1e-5, False),
                                     ("deepseek_q_norm_prefill", 2048, 1536, 1e-6, False),
                                     ("deepseek_kv_norm_decode", 4, 512, 1e-6, False),
                                     ("kimi_block_norm_decode", 4, 7168, 1e-5, False),
                                     ("deepseek_train_q_norm", 1024, 1536, 1e-6, True),
                                     ("deepseek_train_kv_norm", 1024, 512, 1e-6, True)):
        x, s, dy = inputs(rows, D, bf16)
        b, by = bound_ms(fwd_bytes(rows, D, train), 4 * rows * D, "float32")
        y = torch.empty_like(x)
        fwd[key] = {"rows": rows, "D": D, "bound_ms": b, "bound_by": by,
                    "ms": timer.ms(lambda: RK._launch_fwd(x, s, eps, want_rstd=train)),
                    "route": "register" if RK.fwd_register_path(x) else "block_a_row",
                    "block_a_row_ms": timer.ms(
                        lambda: _fwd_entry(torch, x, s, eps, train, register=False)),
                    "same_bytes_copy_ms": timer.ms(lambda: y.copy_(x))}
        if D // 8 <= 256:  # rows the register path's entry point takes (bf16)
            fwd[key]["register_path_ms"] = timer.ms(
                lambda: _fwd_entry(torch, x, s, eps, train, register=True))
        fwd[key]["ratio_to_copy"] = fwd[key]["ms"] / fwd[key]["same_bytes_copy_ms"]
        if train:
            _, rstd = RK._launch_fwd(x, s, eps, want_rstd=True)
            b, by = bound_ms(bwd_bytes(rows, D), 8 * rows * D, "float32")
            same = torch.empty_like(x)
            bwd[key] = {"rows": rows, "D": D, "bound_ms": b, "bound_by": by,
                        "ms": timer.ms(lambda: RK._launch_bwd(x, s, rstd, dy)),
                        "stages_ms": stage_ms(torch, timer,
                                              lambda: RK._launch_bwd(x, s, rstd, dy),
                                              RMSNORM_BWD_STAGES),
                        "same_bytes_add_ms": timer.ms(lambda: torch.add(x, dy, out=same))}
        # the plain version and the library beside it (the qk-norm and the
        # MoE widths; the block norm below, with its backward)
        if key == "train_qk" or key.startswith(("deepseek", "kimi")):
            fwd[key].update(plain_ms=timer.ms(lambda: rmsnorm_ref(x, s, eps=eps)),
                            library_ms=timer.ms(
                                lambda: F.rms_norm(x.float(), (D,), s, eps).to(x.dtype)))
        if key == "train_block" or key.startswith("deepseek_train"):
            # the plain versions and the library beside it
            xf, sf = x.float().requires_grad_(), s.clone().requires_grad_()
            yl = F.rms_norm(xf, (D,), sf, eps)

            def lib_bwd():
                dxl, _ = torch.autograd.grad(yl, (xf, sf), dy.float(), retain_graph=True)
                dxl.to(x.dtype)

            fwd[key].update(plain_ms=timer.ms(lambda: rmsnorm_ref(x, s, eps=eps)),
                            library_ms=timer.ms(
                                lambda: F.rms_norm(x.float(), (D,), s, eps).to(x.dtype)))
            bwd[key].update(plain_ms=timer.ms(lambda: rmsnorm_bwd_ref(x, s, dy, eps=eps)),
                            library_ms=timer.ms(lib_bwd))
    for name, times, worst, lib, note in (
            ("rmsnorm", fwd, worst_fwd, "F.rms_norm on x.float(), cast back", None),
            ("rmsnorm_bwd", bwd, worst_bwd, "the backward of F.rms_norm on x.float()",
             "no Pallas backward exists; the gradient of the TPU kernel's function, "
             "which the reference leaves to XLA")):
        m = times["train_block"]
        results[name] = {
            "name": name, "route": "cuda", "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
            "replaces": "src/repro/kernels/rmsnorm.py:22",
            **({"replaces_note": note} if note else {}),
            "shape": "bf16 (2048, 2048), eps 1e-5: one training block norm of Qwen3-1.7B "
                     "(2 x 1024 tokens)",
            "max_abs_err": worst, "ms": m["ms"], "kernel_ms": m["ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"], "bound_by": m["bound_by"], "library_ms": m["library_ms"],
            **{k: m[k] for k in ("stages_ms", "same_bytes_add_ms", "route", "block_a_row_ms",
                                 "register_path_ms", "same_bytes_copy_ms", "ratio_to_copy")
               if k in m},
            **({"same_bytes_add": "torch.add(x, dy) into a third tensor: the backward's "
                                  "x, dy and dx bytes, timed the same way; a floor of the "
                                  "card and the timer, not the same function"}
               if "same_bytes_add_ms" in m else {}),
            **({"same_bytes_copy": "y.copy_(x): the forward's x and y bytes, timed the "
                                   "same way; a floor of the card and the timer, not the "
                                   "same function",
                "block_a_row": "rmsnorm_fwd_rowblock_launch: the block-a-row kernel at "
                               "the same shape through its C entry point",
                "register_path": "rmsnorm_fwd_launch: the register-path kernel at the same "
                                 "shape through its C entry point, whichever kernel the "
                                 "wrapper's route takes there"}
               if "same_bytes_copy_ms" in m else {}),
            "library": lib, "other_shapes": {k: v for k, v in times.items() if k != "train_block"}}


def check_flash_bwd(torch, timer, results):
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as FK
    from repro_torch.kernels.ref import (flash_attention_bwd_ref,
                                         flash_attention_ref)

    g = torch.Generator(device="cuda").manual_seed(8)

    def rand(shape, dt):
        return torch.randn(shape, generator=g, device="cuda").to(dt)

    bf, f32 = torch.bfloat16, torch.float32
    groups = _flash_cases(torch)
    cases = [
        ("xl_s256_bf16", 2, 256, 25, 25, 64, bf, True, 0, 0.0),
        ("xl_s700_bf16", 1, 700, 25, 25, 64, bf, True, 0, 0.0),
        ("xl_train_b2_s1024_bf16", 2, 1024, 25, 25, 64, bf, True, 0, 0.0),
        ("qwen3_s256_bf16", 2, 256, 16, 8, 128, bf, True, 0, 0.0),
        ("qwen3_train_b2_s1024_bf16", 2, 1024, 16, 8, 128, bf, True, 0, 0.0),
        *groups["tc"],
        *groups["gqa5"],
        *groups["hd256_bwd"],
        *groups["hd112_bwd"],
        *groups["train_bwd"],
        ("hd40_window_softcap_f32", 1, 45, 4, 2, 40, f32, True, 16, 10.0),
        ("xl_s300_f32", 1, 300, 25, 25, 64, f32, True, 0, 0.0),
        ("hd256_gqa_f32", 1, 77, 4, 2, 256, f32, True, 0, 0.0),
        ("qwen3_s300_f32", 1, 300, 16, 8, 128, f32, True, 0, 0.0),
        *groups["core"],
    ]
    # fp32 at the training shapes sums up to 16 k terms a gradient element
    # (dK / dV over 16 query heads x 1 024 rows), whose values reach ~20:
    # those cases are held to 1e-4 of each gradient's max |value|, the
    # others' absolute 1e-4 at their unit scale
    train_shapes = {c[0] for c in groups["train_bwd"]}
    worst = {"tensor_cores": 0.0, "cuda_cores": 0.0}
    for name, B, S, H, Hkv, hd, dt, causal, window, softcap, *kv_len in cases:
        Skv = kv_len[0] if kv_len else S  # keys of another length: no mask
        opts = dict(causal=causal, window=window, softcap=softcap)
        ins = [rand((B, n, h, hd), dt).requires_grad_()
               for n, h in ((S, H), (Skv, Hkv), (Skv, Hkv))]
        do = rand((B, S, H, hd), dt)
        tc0, tcf0, cross0 = FK.tc_bwd_launches, FK.tc_launches, FK.cross_bwd_launches
        FK.flash_attention(*ins, **opts).backward(do)
        got = [t.grad for t in ins]
        # determinism: the same inputs again give the same bits
        again = [t.detach().clone().requires_grad_() for t in ins]
        FK.flash_attention(*again, **opts).backward(do)
        route = _route_of(FK, tc0, 2, "tc_bwd_launches")
        fwd_route = _route_of(FK, tcf0, 2, "tc_launches")
        cross = FK.cross_bwd_launches - cross0
        refs = [t.detach().clone().requires_grad_() for t in ins]
        flash_attention_ref(*refs, **opts).backward(do)
        want = [t.grad for t in refs]
        torch.cuda.synchronize()
        bitwise = all(torch.equal(a, t.grad) for a, t in zip(got, again))
        # each of dq, dk, dv judged on its own scale
        errs = {n: max_err(a, b) for n, a, b in zip(("dq", "dk", "dv"), got, want)}
        scales = {n: float(b.float().abs().max()) for n, b in zip(("dq", "dk", "dv"), want)}
        rel = {n: errs[n] / scales[n] if scales[n] > 0 else errs[n] for n in errs}
        rms = {n: rel_rms(a, b) for n, a, b in zip(("dq", "dk", "dv"), got, want)}
        if dt == torch.float32 and name in train_shapes:
            tol = {"max_err_over_max_abs": 1e-4}
            ok = max(rel.values()) <= 1e-4
        elif dt == torch.float32:
            tol = {"max_abs_err": 1e-4}
            ok = max(errs.values()) <= 1e-4
        else:
            tol = {"max_err_over_max_abs": BF16_MAX_REL, "rel_rms_err": BF16_RMS_REL}
            ok = max(rel.values()) <= BF16_MAX_REL and max(rms.values()) <= BF16_RMS_REL
        emit({"phase": "kernels", "kernel": "flash_attention_bwd", "case": name,
              "route": route, "forward_route": fwd_route, "B": B, "S": S, "Skv": Skv, "H": H,
              "Hkv": Hkv, "hd": hd, "dtype": str(dt).replace("torch.", ""), "causal": causal,
              "window": window, "softcap": softcap, "max_abs_err": errs,
              "max_abs_grad": scales, "max_err_over_max_abs": rel, "rel_rms_err": rms,
              "tol": tol, "bitwise_repeatable": bitwise})
        dtype = str(dt).replace("torch.", "")
        if ((route == "tensor_cores") != tc_bwd_rule(dtype, hd)
                or (fwd_route == "tensor_cores") != tc_rule(dtype, hd)):
            raise AssertionError(f"flash backward {name}: took the {route} route, its "
                                 f"forward the {fwd_route} one")
        if cross != (2 if Skv != S else 0):
            raise AssertionError(f"flash backward {name}: {cross} backwards counted with keys "
                                 f"of another length")
        if not (all(a.dtype == dt for a in got) and ok and bitwise):
            raise AssertionError(f"flash backward {name}: errors {errs}, relative {rel}, "
                                 f"rel rms {rms}; limits {tol}; repeatable {bitwise}")
        # fp32: the largest error (the CUDA-core route's cases); bf16 on the
        # tensor cores: the largest error over its gradient's max |value|
        if dt == torch.float32 or route == "tensor_cores":
            worst[route] = max(worst[route], max((errs if dt == torch.float32
                                                  else rel).values()))

    def timed(B, S, H, Hkv, hd, *, Skv=None, causal=True, window=0):
        """Wrapper, CUDA-core and plain times of the backward at one shape
        (causal unless asked; keys of ``Skv``, default S), SDPA's backward
        alone and SDPA's forward + backward (a boolean band mask where a
        window cuts), and the bound (5 products over the unmasked pairs; q
        k v o dO and lse read, dq dk dv written once)."""
        Skv = S if Skv is None else Skv
        q, do = rand((B, S, H, hd), bf), rand((B, S, H, hd), bf)
        k, v = (rand((B, Skv, Hkv, hd), bf) for _ in range(2))
        out, lse = FK._launch_fwd(q, k, v, causal, window, 0.0, want_lse=True)
        res = {"ms": timer.ms(lambda: FK._launch_bwd(q, k, v, out, lse, do, causal, window,
                                                     0.0))}
        # where the wrapper takes the CUDA cores, the same kernel: not timed twice
        res["cuda_cores_ms"] = res["ms"] if not tc_bwd_rule("bfloat16", hd) else timer.ms(
            lambda: _core_bwd(torch, q, k, v, out, lse, do, causal=causal, window=window))
        res["plain_ms"] = timer.ms(lambda: flash_attention_bwd_ref(q, k, v, out, lse, do,
                                                                   causal=causal,
                                                                   window=window))
        qt, kt, vt, dot = (t.transpose(1, 2).contiguous() for t in (q, k, v, do))
        qt, kt, vt = (t.requires_grad_() for t in (qt, kt, vt))
        mask = None
        if 0 < window < S:
            i = torch.arange(S, device="cuda")
            mask = (i[None, :] <= i[:, None]) & (i[:, None] - i[None, :] < window)

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                  is_causal=causal and mask is None,
                                                  enable_gqa=Hkv != H)

        o_l = sdpa()
        res["library_bwd_ms"] = timer.ms(
            lambda: torch.autograd.grad(o_l, (qt, kt, vt), dot, retain_graph=True))
        res["library_ms"] = timer.ms(lambda: sdpa().backward(dot))
        nbytes = 2 * B * (S * 3 * H + Skv * 4 * Hkv + S * H) * hd + 4 * B * H * S
        res["bound_ms"], res["bound_by"] = bound_ms(
            nbytes, 5 * 2 * hd * B * H * attention_pairs(S, Skv, causal, window), "bfloat16")
        res["bound_share"] = res["bound_ms"] / res["ms"]
        res["over_library"] = res["ms"] / res["library_ms"]
        return res

    # main path's shapes: one training layer's attention, B 2, S 1024
    xl, q3 = timed(2, 1024, 25, 25, 64), timed(2, 1024, 16, 8, 128)
    fam = {"granite_8b_gqa4": {"shape": "bf16 B=1 S=512 H=32 Hkv=8 hd=128 causal",
                               **timed(1, 512, 32, 8, 128)},
           "qwen3_14b_gqa5": {"shape": "bf16 B=1 S=512 H=40 Hkv=8 hd=128 causal",
                              **timed(1, 512, 40, 8, 128)}}
    # Kimi-K2's training shape: the bf16 backward at hd 112 takes the
    # CUDA-core kernel (``TC_BWD_HEAD_DIMS``); "ms" and "cuda_cores_ms" are
    # then the same kernel, timed once
    kimi = {"shape": "bf16 B=2 S=1024 H=64 Hkv=8 hd=112 causal (one Kimi-K2 training "
                     "layer; the CUDA-core backward)", **timed(2, 1024, 64, 8, 112)}
    # Whisper's training layers (the tensor-core backward; "cuda_cores_ms"
    # the CUDA-core one at the same shape) and RecurrentGemma-9B's local
    # attention (the CUDA-core backward: "ms" and "cuda_cores_ms" the same
    # kernel), at train_whisper's and train_recurrent's shapes
    whisper = {
        "cross": {"shape": f"bf16 B=2 S={WHISPER_TOKENS} Skv={WHISPER_FRAMES} H=Hkv=20 hd=64 "
                           f"no mask (one Whisper decoder layer's cross-attention)",
                  **timed(2, WHISPER_TOKENS, 20, 20, 64, Skv=WHISPER_FRAMES, causal=False)},
        "encoder": {"shape": f"bf16 B=2 S={WHISPER_FRAMES} H=Hkv=20 hd=64 non-causal (one "
                             f"Whisper encoder layer)",
                    **timed(2, WHISPER_FRAMES, 20, 20, 64, causal=False)}}
    recurrent = {
        "b2_s1024": {"shape": "bf16 B=2 S=1024 H=16 Hkv=1 hd=256 causal window 2048 (one "
                              "RecurrentGemma-9B local-attention layer of train_recurrent)",
                     **timed(2, 1024, 16, 1, 256, window=2048)},
        "b1_s2304": {"shape": "bf16 B=1 S=2304 H=16 Hkv=1 hd=256 causal window 2048 (the "
                              "window cuts)",
                     **timed(1, 2304, 16, 1, 256, window=2048)}}
    # keys of another length with a causal mask: refused before any launch
    q, k = (rand((1, n, 20, 64), bf).requires_grad_() for n in (64, WHISPER_FRAMES))
    n0 = FK.launches + FK.bwd_launches
    try:
        FK.FlashAttentionFn.apply(q, k, k, True, 0, 0.0)
    except ValueError as e:
        emit({"phase": "kernels", "kernel": "flash_attention_bwd",
              "case": "cross_causal_raises", "error": str(e),
              "launched": FK.launches + FK.bwd_launches - n0})
    else:
        raise AssertionError("flash backward: causal attention over keys of another length "
                             "did not raise")
    if FK.launches + FK.bwd_launches != n0:
        raise AssertionError("flash backward: the refused causal cross case launched")
    library = ("F.scaled_dot_product_attention forward + backward (library_ms); its "
               "backward alone (library_bwd_ms)")
    note = ("no Pallas backward exists; the gradient of the TPU kernel's function, which "
            "the reference leaves to XLA")
    results["flash_attention_bwd_tc"] = {
        "name": "flash_attention_bwd_tc", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd_tc.cu",
        "replaces": "src/repro/kernels/flash_attention.py:42", "replaces_note": note,
        "shape": "bf16 B=2 S=1024 H=Hkv=25 hd=64 causal (one training layer)",
        "max_abs_err": worst["tensor_cores"],
        "max_abs_err_note": "largest max error over max |gradient| of the bf16 cases",
        "ms": xl["ms"], "kernel_ms": xl["ms"], "plain_ms": xl["plain_ms"],
        "bound_ms": xl["bound_ms"], "bound_by": xl["bound_by"],
        "library_ms": xl["library_ms"], "library_bwd_ms": xl["library_bwd_ms"],
        "library": library,
        "qwen3": {"shape": "bf16 B=2 S=1024 H=16 Hkv=8 hd=128 causal (one training layer)",
                  **q3},
        "families": fam, "whisper": whisper}
    results["flash_attention_bwd"] = {
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/kernels/flash_attention.py:42", "replaces_note": note,
        "route_note": "the CUDA-core kernels: fp32 and head_dims other than 64 / 128; "
                      "timed here through their C entry point at the bf16 shapes the "
                      "tensor-core kernels now take",
        "shape": "bf16 B=2 S=1024 H=Hkv=25 hd=64 causal (one training layer)",
        "max_abs_err": worst["cuda_cores"],
        "ms": xl["cuda_cores_ms"], "kernel_ms": xl["cuda_cores_ms"],
        "plain_ms": xl["plain_ms"], "bound_ms": xl["bound_ms"], "bound_by": xl["bound_by"],
        "library_ms": xl["library_ms"], "library_bwd_ms": xl["library_bwd_ms"],
        "library": library,
        "qwen3": {"shape": "bf16 B=2 S=1024 H=16 Hkv=8 hd=128 causal (one training layer)",
                  "ms": q3["cuda_cores_ms"], "plain_ms": q3["plain_ms"],
                  "bound_ms": q3["bound_ms"], "bound_by": q3["bound_by"],
                  "library_ms": q3["library_ms"], "library_bwd_ms": q3["library_bwd_ms"]},
        "kimi_k2_hd112": kimi, "recurrentgemma_hd256": recurrent,
        "whisper": {n: {"shape": w["shape"], "ms": w["cuda_cores_ms"], "plain_ms": w["plain_ms"],
                        "bound_ms": w["bound_ms"], "bound_by": w["bound_by"],
                        "library_ms": w["library_ms"]} for n, w in whisper.items()}}


# ---------------------------------------------------------------------------
# phase 3: card vs CPU, teacher-forced paged rollout
# ---------------------------------------------------------------------------


def rollouts(torch, params, cfg, toks, S, D, pcfg, device):
    """Teacher-forced paged rollouts of the P rows of ``toks`` (P, S + D)
    in one pool: each row's prefill, then D decode steps over all P slots
    at once -> (P, D + 1, V) logits."""
    from repro_torch.parallel.steps import build_paged_serve_steps

    P = toks.shape[0]
    bundle = build_paged_serve_steps(cfg, pcfg=pcfg, device=device)
    pools = bundle.init_pools()
    bs = pcfg.block_size
    pad = (-S) % bs
    n = pcfg.blocks_for(S + pad + D)
    tables = (1 + torch.arange(P * n, dtype=torch.int32, device=device)).view(P, n)
    out = [[] for _ in range(P)]
    for p in range(P):
        prompt = torch.zeros((1, S + pad), dtype=torch.int32, device=device)
        prompt[0, :S] = toks[p, :S].to(device)
        lg, pools = bundle.prefill_step(params, prompt, pools, tables[p, : (S + pad) // bs],
                                        S - 1)
        out[p].append(lg[0].float().cpu())
    for t in range(D):
        pos = torch.full((P,), S + t, dtype=torch.int32, device=device)
        lg, pools = bundle.decode_step(params, pools, toks[:, S + t].to(device), pos, tables,
                                       pos + 1)
        for p in range(P):
            out[p].append(lg[p].float().cpu())
    return torch.stack([torch.stack(o) for o in out])


def e2e_vs_cpu(torch, counters):
    from repro_torch.configs import get_config
    from repro_torch.models import registry as R
    from repro_torch.serve.kv_cache import PagedCacheConfig

    cfg = get_config("gpt2-xl").replace(num_layers=4, dtype="float32")
    S, D = 200, 16
    t0 = time.perf_counter()
    params_cpu = R.init_params(cfg, seed=0, device="cpu")
    params_gpu = copy.deepcopy(params_cpu).to("cuda")
    toks = torch.randint(0, cfg.vocab_size, (S + D,), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(4))
    pcfg = PagedCacheConfig(num_blocks=32, block_size=16, dtype="float32")
    for c in counters.values():
        c.launches = 0
    card = rollouts(torch, params_gpu, cfg, toks[None], S, D, pcfg, "cuda")[0]
    launches = {k: c.launches for k, c in counters.items()}
    cpu = rollouts(torch, params_cpu, cfg, toks[None], S, D, pcfg, "cpu")[0]
    err = float((card - cpu).abs().max())
    q8 = rollouts(torch, params_gpu, cfg, toks[None], S, D,
                  dataclasses.replace(pcfg, quantized=True), "cuda")[0]
    err8 = float((q8 - card).abs().max())
    lim8 = 0.02 * float(card.abs().max())
    emit({"phase": "e2e_vs_cpu", "config": "gpt2-xl width, 4 layers, float32",
          "prompt": S, "decode_steps": D, "max_abs_logit_err_card_vs_cpu": err,
          "tol": 1e-3, "max_abs_logit": float(card.abs().max()),
          "int8_vs_fp32_max_abs_err": err8, "int8_tol": lim8,
          "greedy_agree_int8": float((q8.argmax(-1) == card.argmax(-1)).float().mean()),
          "card_launches": launches, "seconds": time.perf_counter() - t0})
    if not (torch.isfinite(card).all() and card.shape == (D + 1, cfg.vocab_size)):
        raise AssertionError("card rollout: non-finite logits or wrong shape")
    if err > 1e-3:
        raise AssertionError(f"card vs cpu logits differ by {err} > 1e-3")
    if err8 > lim8:
        raise AssertionError(f"int8 KV logits differ by {err8} > {lim8}")
    L = cfg.num_layers
    if launches != {"flash_attention": L, "flash_attention_bwd": 0,
                    "flash_attention_tc": 0, "flash_attention_bwd_tc": 0,
                    "paged_decode_attention": D * L, "quantize_blockwise": 0,
                    "dequantize_blockwise": 0, "pier_update": 0, "rmsnorm": 0,
                    "rmsnorm_bwd": 0}:
        raise AssertionError(f"card rollout launches {launches}")
    return [launches]


# ---------------------------------------------------------------------------
# phase 4: full GPT-2 XL through the engine
# ---------------------------------------------------------------------------


def norm_launches(cfg) -> int:
    """RMSNorm kernel launches of one forward (a prefill, a decode step or
    a training forward): norm1 of every layer, norm2 of every layer with an
    MLP (an MoE layer's too; none in mLSTM or sLSTM blocks), in attention
    layers q- and k-norm with qk-norm and MLA's ``q_norm`` (with a low-rank
    query) and ``kv_norm``, and the final norm; 0 for a LayerNorm model.
    mLSTM's and sLSTM's per-head group norm is plain PyTorch."""
    from repro_torch.models.transformer import ATTENTION_KINDS, _layer_has_mlp

    if cfg.norm != "rmsnorm":
        return 0
    mla = (cfg.q_lora_rank > 0) + 1 if cfg.attention_kind == "mla" else 0
    attn = 2 * int(cfg.use_qk_norm) + mla
    kinds = [cfg.block_kind(i) for i in range(cfg.num_layers)]
    return sum(1 + _layer_has_mlp(cfg, k) + attn * (k in ATTENTION_KINDS) for k in kinds) + 1


def flash_layers(cfg) -> int:
    """Flash launches of one training forward, each with one backward: its
    attention layers (none with MLA, whose decompressed attention is plain
    PyTorch), and an encoder-decoder's encoder layers and decoder layers'
    cross-attention too."""
    if cfg.attention_kind == "mla":
        return 0
    n = _kind_count(cfg, "attn") + _kind_count(cfg, "local_attn")
    return n + (cfg.encoder_layers + cfg.num_layers if cfg.is_encoder_decoder else 0)


def serve(torch, params, cfg, counters, *, quantized: bool, phase: str = "serve"):
    """One run of the serve traffic through ``ServeEngine`` on ``cfg``'s
    full model; returns its line."""
    import numpy as np

    from repro_torch.parallel.steps import build_paged_serve_steps
    from repro_torch.serve import EngineConfig, PagedCacheConfig, ServeEngine

    slots, new_tokens, bs = 4, 32, 16
    lens = [128, 256, 384, 512] * 2
    need = -(-(max(lens) + new_tokens) // bs)  # blocks per sequence
    pcfg = PagedCacheConfig(num_blocks=need * slots + 1, block_size=bs,
                            quantized=quantized)
    bundle = build_paged_serve_steps(cfg, pcfg=pcfg, device="cuda")
    times = {"prefill": [], "decode": []}

    def timed(kind, fn):
        def call(*args):
            t0 = time.perf_counter()
            logits, pools = fn(*args)
            torch.cuda.synchronize()
            times[kind].append(time.perf_counter() - t0)
            if not bool(torch.isfinite(logits).all()):
                raise AssertionError(f"{kind}: non-finite logits")
            return logits, pools
        return call

    bundle = dataclasses.replace(
        bundle, prefill_step=timed("prefill", bundle.prefill_step),
        decode_step=timed("decode", bundle.decode_step))
    ecfg = EngineConfig(max_slots=slots, max_new_tokens=new_tokens, greedy=True,
                        max_blocks_per_seq=need)
    rng = np.random.default_rng(5)

    # warm-up request (cuBLAS handles, allocator); not counted
    warm = ServeEngine(params, cfg, bundle, pcfg, ecfg)
    warm.submit(rng.integers(0, cfg.vocab_size, size=16), 2)
    warm.run()
    torch.cuda.synchronize()
    times["prefill"].clear()
    times["decode"].clear()

    engine = ServeEngine(params, cfg, bundle, pcfg, ecfg)
    for n in lens:
        engine.submit(rng.integers(0, cfg.vocab_size, size=n), new_tokens, arrival=0.0)
    for c in counters.values():
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    results = engine.run()
    wall = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}

    st = engine.stats
    ttft = sorted(r.first_token_at - t0 for r in results)
    dec = sorted(1e3 * t for t in times["decode"])
    line = {
        "phase": phase, "kv": "int8" if quantized else "bf16",
        "config": f"{cfg.name} {cfg.num_layers} layers bf16", "requests": len(lens),
        "prompt_lens": lens, "new_tokens": new_tokens, "slots": slots,
        "block_size": bs, "wall_s": wall, "tokens_out": st["tokens_out"],
        "tokens_per_s": st["tokens_out"] / wall,
        "ttft_ms_p50": 1e3 * statistics.median(ttft), "ttft_ms_max": 1e3 * ttft[-1],
        "prefill_ms_p50": 1e3 * statistics.median(times["prefill"]),
        "decode_step_ms_p50": statistics.median(dec),
        "decode_step_ms_p99": dec[min(len(dec) - 1, math.ceil(0.99 * len(dec)) - 1)],
        "prefills": st["prefills"], "decode_steps": st["decode_steps"],
        "peak_blocks": st["peak_blocks"], "pool_blocks": pcfg.num_blocks - 1,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "launches": launches,
    }
    emit(line)
    L = cfg.num_layers
    calls = st["prefills"] + st["decode_steps"]
    want_q = 2 * L * calls if quantized else 0
    expect = {"flash_attention": st["prefills"] * L, "flash_attention_bwd": 0,
              "flash_attention_tc": (st["prefills"] * L
                                     if tc_rule(cfg.dtype, cfg.resolved_head_dim) else 0),
              "flash_attention_bwd_tc": 0,
              "paged_decode_attention": st["decode_steps"] * L,
              "quantize_blockwise": want_q, "dequantize_blockwise": 0, "pier_update": 0,
              "rmsnorm": norm_launches(cfg) * calls, "rmsnorm_bwd": 0}
    if launches != expect:
        raise AssertionError(f"launch counters {launches} != expected {expect}")
    if st["prefills"] != len(lens) or st["decode_steps"] == 0:
        raise AssertionError(f"engine stats {st}")
    for r in results:
        if len(r.tokens) != new_tokens or not all(0 <= t < cfg.vocab_size for t in r.tokens):
            raise AssertionError(f"request {r.uid}: bad tokens {r.tokens}")
    return line


def _kv_rollouts(torch, params, cfg):
    """Teacher-forced paged rollouts (prompt 200, 16 decode steps) with KV
    in the compute dtype and with int8 KV blocks, on the same tokens."""
    from repro_torch.serve.kv_cache import PagedCacheConfig

    S, D = 200, 16
    toks = torch.randint(0, cfg.vocab_size, (S + D,), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(12))
    pcfg = PagedCacheConfig(num_blocks=16, block_size=16)
    return (rollouts(torch, params, cfg, toks[None], S, D, pcfg, "cuda")[0],
            rollouts(torch, params, cfg, toks[None], S, D,
                     dataclasses.replace(pcfg, quantized=True), "cuda")[0])


def _rel(a, b) -> float:  # max |a - b| over max |b|
    return float((a - b).abs().max()) / float(b.abs().max())


def qwen3_int8_kv(torch, params, cfg):
    """Rollouts with int8 KV blocks against the same without. At 4 layers
    in fp32, every logit within 2% of max |logit|, the reference's int8
    tolerance, as ``e2e_vs_cpu`` holds GPT-2 XL. At full depth in bf16 the
    error of int8 against bf16 KV is reported: there the bf16 rounding of
    the model itself is larger than the bound (``--int8-kv-depth``)."""
    from repro_torch.models import registry as R

    out = dict(zip(("bf16", "bf16_int8kv"), _kv_rollouts(torch, params, cfg)))
    c = cfg.replace(num_layers=4, dtype="float32")
    p = R.init_params(c, seed=0, device="cuda")
    out.update(zip(("layers4_f32", "layers4_f32_int8kv"), _kv_rollouts(torch, p, c)))
    del p
    torch.cuda.empty_cache()

    err4, lim4 = _rel(out["layers4_f32_int8kv"], out["layers4_f32"]), 0.02
    emit({"phase": "serve_qwen3_int8_kv", "prompt": 200, "decode_steps": 16,
          "full_depth_int8_vs_bf16_kv_in_bf16": _rel(out["bf16_int8kv"], out["bf16"]),
          "greedy_agree_int8_vs_bf16_kv": float(
              (out["bf16_int8kv"].argmax(-1) == out["bf16"].argmax(-1)).float().mean()),
          "layers4_f32_int8_vs_f32_kv": err4, "tol": lim4})
    if not all(bool(torch.isfinite(t).all()) and t.shape == (17, cfg.vocab_size)
               for t in out.values()):
        raise AssertionError("serve_qwen3_int8_kv: non-finite logits or wrong shape")
    if err4 > lim4:
        raise AssertionError(f"serve_qwen3_int8_kv: int8 KV logits differ by {err4} of max "
                             f"|logit| > {lim4}")


def int8_kv_depth(torch):
    """``--int8-kv-depth``: full Qwen3-1.7B made once in bf16 and once in
    fp32 from the same seed. Reports int8 against bf16 KV in the bf16
    model, int8 against fp32 KV in the fp32 model, and the bf16 model
    against the fp32 one (both with unquantized KV): how far the int8
    blocks and how far bf16 compute alone move the logits at full depth."""
    from repro_torch.configs import get_config
    from repro_torch.models import registry as R

    out = {}
    for name, dtype in (("bf16", "bfloat16"), ("f32", "float32")):
        cfg = get_config("qwen3-1.7b").replace(dtype=dtype)
        p = R.init_params(cfg, seed=0, device="cuda")
        out[name], out[name + "_int8kv"] = _kv_rollouts(torch, p, cfg)
        del p
        torch.cuda.empty_cache()
    emit({"phase": "int8_kv_depth", "layers": cfg.num_layers,
          "int8_vs_bf16_kv_in_bf16": _rel(out["bf16_int8kv"], out["bf16"]),
          "int8_vs_f32_kv_in_f32": _rel(out["f32_int8kv"], out["f32"]),
          "bf16_vs_f32": _rel(out["bf16"], out["f32"])})
    if not all(bool(torch.isfinite(t).all()) for t in out.values()):
        raise AssertionError("int8_kv_depth: non-finite logits")


# ---------------------------------------------------------------------------
# phase 4c: MiniCPM-2B, Granite-8B and Qwen3-14B at full width
# ---------------------------------------------------------------------------

FAMILIES = ("minicpm-2b", "granite-8b", "qwen3-14b", "chameleon-34b")


# the whole script's depths for serve_families, for its time limit: each
# family at its full width with 8 layers (``--families`` serves them at
# full depth; Chameleon-34B's 48 layers hold 66 GiB in bf16)
FAMILY_SCRIPT_LAYERS = {"minicpm-2b": 8, "granite-8b": 8, "qwen3-14b": 8, "chameleon-34b": 8}


def serve_families(torch, counters, *, kvs=(False, True), layers=None):
    """``serve``'s traffic through each family's model (weights made on the
    card in serving storage, freed before the next family), with bf16 KV
    and then int8 KV (``kvs``), at full depth or at ``layers[arch]``
    layers (the whole script runs bf16 KV at ``FAMILY_SCRIPT_LAYERS``, for
    its time limit; ``--families`` runs both KV formats at full depth);
    ``serve`` checks every launch count, the RMSNorm and decode ones at the
    depth run."""
    from repro_torch.configs import get_config
    from repro_torch.models import registry as R

    lines = []
    for arch in FAMILIES:
        cfg = get_config(arch)
        if layers and arch in layers:
            cfg = cfg.replace(num_layers=layers[arch])
        t0 = time.perf_counter()
        params = R.init_params(cfg, seed=0, device="cuda")
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t0
        for q in kvs:
            line = serve(torch, params, cfg, counters, quantized=q, phase="serve_families")
            line["init_s"] = t_init
            line["run"] = f"serve_families_{arch}_{line['kv']}"
            lines.append(line)
        del params
        free_cuda(torch)
    return lines


def families_vs_cpu(torch, counters):
    """Each family at full width, 2 layers, fp32, the same seeded weights
    on the card (kernels) and on the CPU (plain versions): 4 prompts of 64
    tokens, their prefills, then 8 decode steps over the 4 slots. Every
    logit within 1e-3 card vs CPU; the card's int8-KV logits within 2% of
    max |logit| of its fp32-KV ones; every launch count exact."""
    from repro_torch.configs import get_config
    from repro_torch.models import registry as R
    from repro_torch.models.transformer import param_leaves, with_leaves
    from repro_torch.serve.kv_cache import PagedCacheConfig

    P, S, D = 4, 64, 8
    fp32_runs = []
    for arch in FAMILIES:
        cfg = get_config(arch).replace(num_layers=2, dtype="float32")
        t0 = time.perf_counter()
        params_gpu = R.init_params(cfg, seed=0, device="cuda")
        params_cpu = with_leaves(params_gpu, {n: t.cpu() for n, t in param_leaves(params_gpu)})
        toks = torch.randint(0, cfg.vocab_size, (P, S + D), dtype=torch.int32,
                             generator=torch.Generator().manual_seed(21))
        pcfg = PagedCacheConfig(num_blocks=P * 5 + 1, block_size=16, dtype="float32")
        for c in counters.values():
            c.launches = 0
        card = rollouts(torch, params_gpu, cfg, toks, S, D, pcfg, "cuda")
        launches = {k: c.launches for k, c in counters.items()}
        q8 = rollouts(torch, params_gpu, cfg, toks, S, D,
                      dataclasses.replace(pcfg, quantized=True), "cuda")
        t_card = time.perf_counter() - t0
        cpu = rollouts(torch, params_cpu, cfg, toks, S, D, pcfg, "cpu")
        err = float((card - cpu).abs().max())
        err8, lim8 = float((q8 - card).abs().max()), 0.02 * float(card.abs().max())
        L = cfg.num_layers
        expect = {"flash_attention": P * L, "flash_attention_bwd": 0, "flash_attention_tc": 0,
                  "flash_attention_bwd_tc": 0, "paged_decode_attention": D * L,
                  "quantize_blockwise": 0, "dequantize_blockwise": 0, "pier_update": 0,
                  "rmsnorm": (P + D) * norm_launches(cfg), "rmsnorm_bwd": 0}
        emit({"phase": "families_vs_cpu", "arch": arch,
              "config": f"{arch} width, {L} layers, float32", "heads": cfg.num_heads,
              "kv_heads": cfg.num_kv_heads, "head_dim": cfg.resolved_head_dim,
              "tied": cfg.tie_embeddings, "vocab": cfg.vocab_size, "prompts": P, "prompt": S,
              "decode_steps": D, "max_abs_logit_err_card_vs_cpu": err, "tol": 1e-3,
              "max_abs_logit": float(card.abs().max()), "int8_vs_fp32_max_abs_err": err8,
              "int8_tol": lim8, "greedy_agree_card_vs_cpu": float(
                  (card.argmax(-1) == cpu.argmax(-1)).float().mean()),
              "card_launches": launches, "expected_launches": expect,
              "card_seconds": t_card, "seconds": time.perf_counter() - t0})
        if not (bool(torch.isfinite(card).all()) and card.shape == (P, D + 1, cfg.vocab_size)):
            raise AssertionError(f"families_vs_cpu {arch}: non-finite logits or wrong shape")
        if err > 1e-3:
            raise AssertionError(f"families_vs_cpu {arch}: card vs cpu logits differ by {err}")
        if err8 > lim8:
            raise AssertionError(f"families_vs_cpu {arch}: int8 KV logits differ by {err8} > "
                                 f"{lim8}")
        if launches != expect:
            raise AssertionError(f"families_vs_cpu {arch}: launches {launches} != {expect}")
        fp32_runs.append(launches)
        del params_gpu, params_cpu
        free_cuda(torch)
    return fp32_runs


# ---------------------------------------------------------------------------
# phases 4d and 6f: the dense serve path with RecurrentGemma-9B and xLSTM-1.3B
# ---------------------------------------------------------------------------

RECURRENT = ("recurrentgemma-9b", "xlstm-1.3b")
# the whole script's depths for serve_recurrent, for its time limit:
# xLSTM-1.3B at full width with one 7:1 cycle of 8 layers (its prefill's
# sLSTM loop is host-bound); RecurrentGemma-9B at its full 38 layers
# (``--recurrent`` serves both at full depth)
RECURRENT_SCRIPT_LAYERS = {"xlstm-1.3b": 8}


def _kind_count(cfg, kind: str) -> int:
    return sum(cfg.block_kind(i) == kind for i in range(cfg.num_layers))


def dense_rollout(torch, params, cfg, toks, S, device, frames=None):
    """Teacher-forced dense rollout: ``registry.prefill`` of toks[:, :S]
    (the last position's logits; an encoder-decoder's over ``frames``),
    then ``decode_step`` for each later token -> (B, D + 1, V) logits on
    the host."""
    from repro_torch.models import registry as R

    D = toks.shape[1] - S
    t = toks.to(device)
    batch = {"tokens": t[:, :S]}
    if frames is not None:
        batch["frames"] = frames.to(device)
    with torch.no_grad():
        lg, state = R.prefill(params, cfg, batch, max_len=S + D, last_only=True)
        out = [lg[:, 0].float().cpu()]
        for i in range(D):
            lg, state = R.decode_step(params, cfg, state, t[:, S + i:S + i + 1])
            out.append(lg[:, 0].float().cpu())
    return torch.stack(out, 1)


def recurrent_vs_cpu(torch, counters, sim_eps=(1e-6,)):
    """RecurrentGemma-9B at full width with 3 layers (one rglru / rglru /
    local_attn cycle; 2 prompts of 200, once at its window of 2048 and once
    at 128, where the ring wraps) and xLSTM-1.3B at full width with 8 layers
    (one 7:1 cycle; a prompt of 192, the chunkwise form, and one of 50, the
    parallel form), fp32, the same seeded weights on the card (kernels) and
    on the CPU (plain versions): the prefill and 16 teacher-forced decode
    steps through ``registry.prefill`` / ``decode_step``. Every logit within
    1e-3; every launch count exact. Then ``recurrent_train_vs_cpu`` on the
    same weights (``_recurrent_train_vs_cpu``, its ``SimulatedRun`` at each
    AdamW eps of ``sim_eps``)."""
    from repro_torch.configs import get_config
    from repro_torch.models import registry as R
    from repro_torch.models.transformer import param_leaves, with_leaves

    D = 16
    # (arch, layers, prompts, [(config overrides, prompt length)], whether
    # recurrent_train_vs_cpu runs its SimulatedRun): the weights are made
    # once an arch; the window does not change them. RecurrentGemma-9B at
    # 3 layers has 2.60 B parameters (its untied 256 000-row tables hold
    # 2.10 B), whose fp32 state at G = 2, about 94 GB, fits neither the card
    # nor beside the script's host heap; xLSTM-1.3B at 8 has 0.50 B
    runs = (("recurrentgemma-9b", 3, 2, [({"local_window": 2048}, 200),
                                         ({"local_window": 128}, 200)], False),
            ("xlstm-1.3b", 8, 1, [({}, 192), ({}, 50)], True))
    fp32_runs = []
    for arch, layers, P, cases, simulated in runs:
        base = get_config(arch).replace(num_layers=layers, dtype="float32")
        params_gpu = R.init_params(base, seed=0, device="cuda")
        params_cpu = with_leaves(params_gpu, {n: t.cpu() for n, t in param_leaves(params_gpu)})
        for kw, S in cases:
            fp32_runs.append(_recurrent_case(torch, counters, base.replace(**kw), kw, params_gpu,
                                             params_cpu, P, S, D))
        # fp32 serving storage is the training storage
        fp32_runs += _recurrent_train_vs_cpu(torch, counters, base, params_gpu, params_cpu,
                                             sim_eps if simulated else ())
        del params_gpu, params_cpu
        free_cuda(torch)
    return fp32_runs


def _recurrent_case(torch, counters, cfg, kw, params_gpu, params_cpu, P, S, D):
    """One ``recurrent_vs_cpu`` comparison -> the card's launches."""
    arch, layers = cfg.name, cfg.num_layers
    t0 = time.perf_counter()
    toks = torch.randint(0, cfg.vocab_size, (P, S + D), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(23))
    for c in counters.values():
        c.launches = 0
    card = dense_rollout(torch, params_gpu, cfg, toks, S, "cuda")
    launches = {k: c.launches for k, c in counters.items()}
    t_card = time.perf_counter() - t0
    cpu = dense_rollout(torch, params_cpu, cfg, toks, S, "cpu")
    err = float((card - cpu).abs().max())
    n_attn = _kind_count(cfg, "local_attn")
    expect = {"flash_attention": n_attn, "flash_attention_bwd": 0, "flash_attention_tc": 0,
              "flash_attention_bwd_tc": 0, "paged_decode_attention": D * n_attn,
              "quantize_blockwise": 0, "dequantize_blockwise": 0, "pier_update": 0,
              "rmsnorm": (1 + D) * norm_launches(cfg), "rmsnorm_bwd": 0}
    emit({"phase": "recurrent_vs_cpu", "arch": arch,
          "config": f"{arch} width, {layers} layers, float32", "pattern": [
              cfg.block_kind(i) for i in range(layers)], "local_window": cfg.local_window,
          "prompts": P, "prompt": S, "decode_steps": D,
          "ring_wraps": n_attn > 0 and S + D > cfg.local_window,
          "mlstm_form": ("chunkwise" if S > cfg.mlstm_chunk and S % cfg.mlstm_chunk == 0
                         else "parallel") if arch.startswith("xlstm") else None,
          "max_abs_logit_err_card_vs_cpu": err, "tol": 1e-3,
          "max_abs_logit": float(card.abs().max()),
          "greedy_agree_card_vs_cpu": float(
              (card.argmax(-1) == cpu.argmax(-1)).float().mean()),
          "card_launches": launches, "expected_launches": expect,
          "card_seconds": t_card, "seconds": time.perf_counter() - t0})
    if not (bool(torch.isfinite(card).all()) and card.shape == (P, D + 1, cfg.vocab_size)):
        raise AssertionError(f"recurrent_vs_cpu {arch}: non-finite logits or wrong shape")
    if err > 1e-3:
        raise AssertionError(f"recurrent_vs_cpu {arch} {kw}: card vs cpu logits differ by "
                             f"{err}")
    if launches != expect:
        raise AssertionError(f"recurrent_vs_cpu {arch}: launches {launches} != {expect}")
    return launches


RECURRENT_TRAIN_BATCH = (2, 128)
RECURRENT_SIM_STEPS = 6


def _slstm_noise_leaves(cfg):
    """sLSTM's input-gate biases ``b_i``: a zero gradient in exact
    arithmetic (h = o c / n, and a shift of the input gate's pre-activation
    that is the same at every step scales c and n alike), so both sides'
    values are rounding noise (``tests/test_torch_recurrent.py``)."""
    return {f"layers.{i}.mix.b_i" for i in range(cfg.num_layers)
            if cfg.block_kind(i) == "slstm"}


def _recurrent_train_vs_cpu(torch, counters, cfg, params_gpu, params_cpu, sim_eps):
    """``recurrent_train_vs_cpu``: ``recurrent_vs_cpu``'s weights (fp32, so
    serving and training storage alike), made to require grad: one
    ``loss_fn`` forward and backward on 2 x 128 tokens, a quarter of the
    labels masked, on the card (kernels) and on the CPU (plain versions,
    autograd through the scans): the loss within 1e-5 relative, every
    gradient leaf's max |error| within 1e-3 of its max |g|
    (``moe_train_vs_cpu``'s limits; sLSTM's ``b_i``, whose gradient is
    rounding noise on both sides, within 1e-5 of the model's largest |g|
    on each side; ``tests/test_torch_recurrent.py`` holds 1e-6 at the
    reduced width, whose elements sum fewer and smaller terms),
    RMSNorm and flash launches exact. Then ``_recurrent_sim_vs_cpu`` from
    the same weights at each AdamW eps of ``sim_eps`` (none: no run). At
    the default eps 1e-8 AdamW's normalized step turns rounding
    differences in near-zero gradient elements into steps of their own,
    as ``tests/test_torch_untied_eps.py`` shows on the CPU, most in
    xLSTM's untied tables, so that run holds every leaf but the two
    tables and reports their gaps; the run at 1e-6 holds every leaf. The
    weights are used up. Returns the card's launches."""
    from repro_torch.models.transformer import param_leaves

    B, S = RECURRENT_TRAIN_BATCH
    loss_tol, grad_tol, noise_tol = 1e-5, 1e-3, 1e-5
    arch, layers = cfg.name, cfg.num_layers
    t0 = time.perf_counter()
    names = [n for n, _ in param_leaves(params_gpu)]
    toks = torch.randint(0, cfg.vocab_size, (B, S + 1), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(28))
    labels = toks[:, 1:].clone()
    labels[:, :S // 4] = -1  # masked positions
    batch = {"tokens": toks[:, :-1], "labels": labels}
    for c in counters.values():
        c.launches = 0
    loss_card, g_card = _loss_and_leaf_grads(cfg, params_gpu, batch, "cuda")
    launches = {k: c.launches for k, c in counters.items()}
    t_card = time.perf_counter() - t0
    loss_cpu, g_cpu = _loss_and_leaf_grads(cfg, params_cpu, batch, "cpu")
    loss_rel = abs(loss_card - loss_cpu) / abs(loss_cpu)
    noise = _slstm_noise_leaves(cfg)
    tops = [max(float(g.abs().max()) for n, g in zip(names, gs) if n not in noise)
            for gs in (g_card, g_cpu)]
    noise_max = {n: [float(gs[names.index(n)].abs().max()) / top
                     for gs, top in zip((g_card, g_cpu), tops)] for n in noise}
    keep = [i for i, n in enumerate(names) if n not in noise]
    worst, worst_leaf, by_leaf = _leaf_grad_errs([names[i] for i in keep],
                                                 (g_card[i] for i in keep),
                                                 (g_cpu[i] for i in keep))
    del g_card, g_cpu
    n, fl = norm_launches(cfg), flash_layers(cfg)
    expect = {k: 0 for k in counters}
    expect.update(rmsnorm=n, rmsnorm_bwd=n, flash_attention=fl, flash_attention_bwd=fl)
    emit({"phase": "recurrent_train_vs_cpu", "arch": arch,
          "config": f"{arch} width, {layers} layers, float32 (recurrent_vs_cpu's weights)",
          "pattern": [cfg.block_kind(i) for i in range(layers)],
          "batch": [B, S], "masked_labels": B * (S // 4),
          "loss_card": loss_card, "loss_cpu": loss_cpu, "loss_rel_err": loss_rel,
          "loss_tol_rel": loss_tol, "max_grad_err_over_leaf_max": worst,
          "worst_leaf": worst_leaf, "grad_tol_over_leaf_max": grad_tol,
          "grad_err_over_leaf_max_by_leaf": by_leaf,
          "noise_leaves_max_over_model_max": noise_max, "noise_tol": noise_tol,
          "card_launches": launches, "expected_launches": expect, "card_seconds": t_card,
          "seconds": time.perf_counter() - t0})
    if not math.isfinite(loss_card) or loss_rel > loss_tol:
        raise AssertionError(f"recurrent_train_vs_cpu {arch}: loss {loss_card} vs "
                             f"{loss_cpu} (relative {loss_rel}, limit {loss_tol})")
    if worst > grad_tol or any(max(v) > noise_tol for v in noise_max.values()):
        raise AssertionError(f"recurrent_train_vs_cpu {arch}: gradient of {worst_leaf} off "
                             f"by {worst} of its max (limit {grad_tol}); sLSTM b_i {noise_max}")
    if launches != expect:
        raise AssertionError(f"recurrent_train_vs_cpu {arch}: launches {launches} != {expect}")
    fp32_runs = [launches]
    for eps in sim_eps:  # the last run takes the weights themselves
        params = params_gpu if eps == sim_eps[-1] else copy.deepcopy(params_gpu)
        fp32_runs.append(_recurrent_sim_vs_cpu(torch, counters, cfg, params, params_cpu,
                                               names, eps))
        del params
    return fp32_runs


# recurrent_train_vs_cpu's SimulatedRun in --train-recurrent, at AdamW's
# default eps and at 1e-6 (the whole script runs the one at 1e-6), and the
# untied tables, the leaves the default eps does not hold (on an H100
# after 6 steps: embed.tokens 2.04e-3, embed.lm_head 1.26e-3, the next
# leaf 7.5e-4; at 1e-6 every leaf within 1.5e-4)
RECURRENT_SIM_EPS = (1e-8, 1e-6)
UNTIED_TABLES = ("embed.tokens", "embed.lm_head")


def _recurrent_sim_vs_cpu(torch, counters, cfg, params_gpu, params_cpu, names, eps):
    """``recurrent_train_vs_cpu``'s ``SimulatedRun``: 6 steps at G = 2
    (global batch 2 x 128, flat sync: 4 lazy-start steps and an outer sync)
    at AdamW eps ``eps`` from the same weights on the card (``params_gpu``,
    used up) and on the CPU (a copy of ``params_cpu``): every step's loss
    and every final parameter within 1e-3 (``train_vs_cpu``'s limit), at
    the default eps every parameter but UNTIED_TABLES', whose gaps are
    reported beside the five largest; RMSNorm, flash and ``pier_update``
    launches exact. Returns the card's launches."""
    from repro_torch.config import TrainConfig
    from repro_torch.core.simulate import SimulatedRun
    from repro_torch.models.transformer import param_leaves

    B, S = RECURRENT_TRAIN_BATCH
    sim_tol = 1e-3
    arch, layers = cfg.name, cfg.num_layers
    t0 = time.perf_counter()
    tc = TrainConfig(**TRAIN_TC, global_batch_size=B, seq_len=S, sync_delay=0, adam_eps=eps)
    steps = RECURRENT_SIM_STEPS
    card_run = SimulatedRun(cfg, tc, num_groups=2, device="cuda", params=params_gpu)
    for c in counters.values():
        c.launches = 0
    h_card = card_run.run(steps)
    card_run.flush()
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    expect, warm, syncs = _train_expect(card_run, steps, len(names))
    p_card = [t.detach().cpu() for _, t in param_leaves(card_run.eval_params())]
    del card_run
    free_cuda(torch)
    t_card = time.perf_counter() - t0
    cpu = _cpu_run(cfg, tc, params_cpu, steps, num_groups=2)
    loss_err = max(abs(a - b) for a, b in zip(h_card["train_loss"], cpu["train_loss"]))
    p_errs = {n: max_err(a, b) for n, a, b in zip(names, p_card, cpu["params"])}
    worst_param = max(p_errs, key=p_errs.get)
    exempt = set(UNTIED_TABLES) & set(names) if eps < 1e-6 else set()
    held = {n: e for n, e in p_errs.items() if n not in exempt}
    worst_held = max(held, key=held.get)
    p_err = held[worst_held]
    emit({"phase": "recurrent_train_vs_cpu", "arch": arch, "run": "simulated_run",
          "config": f"{arch} width, {layers} layers, float32", "groups": 2,
          "sync_delay": 0, "steps": steps, "warmup_steps": warm, "outer_syncs": syncs,
          "per_group_batch": B // 2, "seq_len": S,
          "loss_card": h_card["train_loss"], "loss_cpu": cpu["train_loss"],
          "adam_eps": eps, "max_abs_loss_err": loss_err,
          "max_abs_param_err_held": p_err, "worst_held_leaf": worst_held,
          "max_abs_param_err": p_errs[worst_param], "worst_param_leaf": worst_param,
          "not_held": {n: p_errs[n] for n in sorted(exempt)},
          "largest_param_errs": dict(sorted(p_errs.items(), key=lambda kv: -kv[1])[:5]),
          "tol": sim_tol, "card_launches": launches, "expected_launches": expect,
          "card_seconds": t_card, "seconds": time.perf_counter() - t0})
    if not (all(math.isfinite(x) for x in h_card["train_loss"]) and syncs > 0):
        raise AssertionError(f"recurrent_train_vs_cpu {arch}: loss {h_card['train_loss']}, "
                             f"{syncs} outer syncs")
    if loss_err > sim_tol or p_err > sim_tol:
        raise AssertionError(f"recurrent_train_vs_cpu {arch} eps {eps}: SimulatedRun loss "
                             f"err {loss_err}, {worst_held} err {p_err} (limit {sim_tol})")
    if launches != expect:
        raise AssertionError(f"recurrent_train_vs_cpu {arch}: SimulatedRun launches "
                             f"{launches} != {expect}")
    return launches


def _profiled(torch, fn):
    """(wall ms of one call, its device ms, kernels, device ms by kernel
    group) from an unprofiled call and a profiled one after it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    groups, n = {}, 0
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            grp = _kernel_group(evt.name)
            groups[grp] = groups.get(grp, 0.0) + evt.time_range.elapsed_us() / 1e3
            n += 1
    busy = sum(groups.values())
    return {"wall_ms": wall, "device_ms": busy if n else "not measured",
            "device_idle_share": 1 - busy / wall if n else "not measured",
            "kernels": n, "device_ms_by_group": groups}


def serve_recurrent(torch, counters, arch: str, layers=None):
    """RecurrentGemma-9B (38 layers) or xLSTM-1.3B (48) at full width and
    full depth or ``layers`` layers, bf16, random seeded weights made on the
    card in serving storage: 4 prompts of 512
    tokens and 32 new tokens, greedy, through ``generate`` (the dense path:
    ``build_serve_steps``, one prefill, 31 decode steps). Tokens/s, TTFT,
    decode-step p50 / p99, peak memory; every launch count exact, and
    RecurrentGemma's 12 flash launches a prefill those of the hd-256
    tensor-core kernel (``flash_attention_tc256``). Then
    where the time goes: one decode step's device time beside its wall
    time (``torch.profiler``), RecurrentGemma's prefill the same way, and
    the recurrences that the host drives: one layer's RG-LRU scan over the
    prompts (log-depth, 9 rounds) and prefill, or one sLSTM layer's
    prefill (a step a position) and one mLSTM layer's."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as FK
    from repro_torch.models import registry as R
    from repro_torch.models import rglru as RG
    from repro_torch.models import ssm as SSM
    from repro_torch.serve import generate

    B, S, N = 4, 512, 32
    cfg = get_config(arch)
    if layers:
        cfg = cfg.replace(num_layers=layers)
    t0 = time.perf_counter()
    params = R.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = sum(t.numel() for t in params.parameters())
    n_bytes = sum(t.numel() * t.element_size() for t in params.parameters())
    prompts = np.random.default_rng(24).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    generate(params, cfg, prompts[:, :16], 2)  # warm-up (cuBLAS handles, allocator)
    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
    FK.tc256_launches = 0
    torch.cuda.reset_peak_memory_stats()
    out, info = generate(params, cfg, prompts, N)
    launches = {k: c.launches for k, c in counters.items()}
    launches["flash_attention_tc256"] = FK.tc256_launches
    times = info["token_times"]
    wall = times[-1] - times[0]
    dec = sorted(1e3 * (b - a) for a, b in zip(times[1:], times[2:]))
    n_attn = _kind_count(cfg, "local_attn")
    expect = {"flash_attention": n_attn, "flash_attention_bwd": 0,
              "flash_attention_tc": n_attn if tc_rule(cfg.dtype, cfg.resolved_head_dim) else 0,
              "flash_attention_bwd_tc": 0, "paged_decode_attention": (N - 1) * n_attn,
              "quantize_blockwise": 0, "dequantize_blockwise": 0, "pier_update": 0,
              "rmsnorm": N * norm_launches(cfg), "rmsnorm_bwd": 0,
              "flash_attention_tc256": n_attn if tc_rule(cfg.dtype, cfg.resolved_head_dim)
              and cfg.resolved_head_dim == 256 else 0}
    line = {"phase": "serve_recurrent", "run": f"serve_recurrent_{arch}", "path": info["path"],
            "config": f"{cfg.name} {cfg.num_layers} layers bf16", "params": n_params,
            "param_bytes_serving_storage": n_bytes, "init_s": t_init, "batch": B,
            "prompt_len": S, "new_tokens": N, "wall_s": wall, "tokens_out": int(out.size),
            "tokens_per_s": out.size / wall, "ttft_ms": 1e3 * (times[1] - times[0]),
            "decode_step_ms_p50": statistics.median(dec),
            "decode_step_ms_p99": dec[min(len(dec) - 1, math.ceil(0.99 * len(dec)) - 1)],
            "decode_steps": len(dec), "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "launches": launches, "expected_launches": expect}

    # where the time goes: one prefill and one decode step of the same bundle
    bundle = info["bundle"]
    tok = torch.from_numpy(prompts).cuda()
    state = {}

    def prefill():
        state["logits"], state["s"] = bundle.prefill_step(params, {"tokens": tok})

    def decode():
        state["step_logits"] = bundle.serve_step(params, state["s"], step_tok)[0]

    if arch.startswith("recurrentgemma"):
        line["prefill_profile"] = _profiled(torch, prefill)
    else:
        # xLSTM's prefill launches about 90 000 kernels (the sLSTM loop): the
        # profiler's trace of it takes longer than the run, so its wall time
        # is the TTFT and its device time is read from one layer of each kind
        prefill()
    step_tok = tok[:, :1].contiguous()
    line["decode_step_profile"] = _profiled(torch, decode)
    finite = all(bool(torch.isfinite(state[k]).all()) for k in ("logits", "step_logits"))
    x = torch.randn((B, S, cfg.d_model), device="cuda").to(torch.bfloat16)
    if arch.startswith("recurrentgemma"):
        W = cfg.resolved_lru_width
        log_a = -torch.rand((B, S, W), device="cuda")
        x0 = torch.randn((B, S, W), device="cuda")
        line["rglru_scan_log_depth_profile"] = _profiled(
            torch, lambda: RG._linear_scan(log_a, x0, None))
        line["rglru_layer_prefill_profile"] = _profiled(
            torch, lambda: RG.apply_rglru(params["layers"][0]["mix"], x, cfg))
    else:
        i = next(i for i in range(cfg.num_layers) if cfg.block_kind(i) == "slstm")
        line["slstm_layer_prefill_profile"] = _profiled(
            torch, lambda: SSM.apply_slstm(params["layers"][i]["mix"], x, cfg))
        line["mlstm_layer_prefill_profile"] = _profiled(
            torch, lambda: SSM.apply_mlstm(params["layers"][0]["mix"], x, cfg,
                                           return_state=True))
    emit(line)
    if info["path"] != "dense" or out.shape != (B, N):
        raise AssertionError(f"serve_recurrent {arch}: path {info['path']}, shape {out.shape}")
    if not finite or not ((out >= 0) & (out < cfg.vocab_size)).all():
        raise AssertionError(f"serve_recurrent {arch}: non-finite logits or token ids out "
                             f"of range")
    if launches != expect:
        raise AssertionError(f"serve_recurrent {arch}: launches {launches} != {expect}")
    del params, bundle, state, info
    free_cuda(torch)
    return line


# ---------------------------------------------------------------------------
# phases 4f and 6h: Whisper-large-v3 (encoder-decoder) through the dense path
# ---------------------------------------------------------------------------

WHISPER = "whisper-large-v3"


def whisper_counters(counters):
    """``counters`` and the flash wrapper's counts of the forwards and the
    backwards whose keys are of another length than the queries (the
    cross-attention's)."""
    from repro_torch.kernels import flash_attention as FK

    return {**counters, "flash_attention_cross": Counter(FK, "cross_launches"),
            "flash_attention_cross_bwd": Counter(FK, "cross_bwd_launches")}


def whisper_launches(cfg, *, prefills: int, steps: int, tc: bool):
    """Every launch of ``prefills`` prefills and ``steps`` decode steps: a
    prefill runs the flash forward once an encoder layer (non-causal) and
    twice a decoder layer (causal self-attention, and cross-attention over
    the encoder's keys); a decode step the paged decode kernels twice a
    decoder layer (its cache, and the cross cache viewed as a pool); the
    norms are LayerNorm (plain PyTorch), so no RMSNorm launch."""
    L, E = cfg.num_layers, cfg.encoder_layers
    flash = prefills * (E + 2 * L)
    return {"flash_attention": flash, "flash_attention_bwd": 0,
            "flash_attention_tc": flash if tc else 0, "flash_attention_bwd_tc": 0,
            "paged_decode_attention": steps * 2 * L, "quantize_blockwise": 0,
            "dequantize_blockwise": 0, "pier_update": 0, "rmsnorm": 0, "rmsnorm_bwd": 0,
            "flash_attention_cross": prefills * L, "flash_attention_cross_bwd": 0}


def whisper_train_launches(cfg, *, steps: int, tc: bool):
    """Every launch of ``steps`` ``loss_fn`` forwards and backwards: the
    flash forward and backward once an encoder layer and twice a decoder
    layer (``flash_layers``), the decoder's cross-attention over keys of
    another length; LayerNorm, so no RMSNorm launch."""
    n, L = steps * flash_layers(cfg), steps * cfg.num_layers
    return {"flash_attention": n, "flash_attention_bwd": n,
            "flash_attention_tc": n if tc else 0, "flash_attention_bwd_tc": n if tc else 0,
            "paged_decode_attention": 0, "quantize_blockwise": 0, "dequantize_blockwise": 0,
            "pier_update": 0, "rmsnorm": 0, "rmsnorm_bwd": 0, "flash_attention_cross": L,
            "flash_attention_cross_bwd": L}


def whisper_frames(torch, cfg, B: int, device, seed: int):
    """Seeded fp32 frame embeddings (B, encoder_seq_len, d_model): the
    stubbed audio frontend's output, made on ``device``."""
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn((B, cfg.encoder_seq_len, cfg.d_model), generator=g, device=device)


WHISPER_VS_CPU = dict(prompts=2, prompt=64, steps=8)


def _whisper_vs_cpu_inputs():
    """``whisper_vs_cpu``'s model (full width, 2 encoder and 2 decoder
    layers, fp32), its parameters, prompts and frames, all made on the CPU
    from seeds."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import registry as R

    P, S, D = (WHISPER_VS_CPU[k] for k in ("prompts", "prompt", "steps"))
    cfg = get_config(WHISPER).replace(num_layers=2, encoder_layers=2, dtype="float32")
    params = R.init_params(cfg, seed=0, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (P, S + D), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(25))
    return cfg, params, toks, whisper_frames(torch, cfg, P, "cpu", 26)


def _whisper_train_batch(toks, frames):
    """``whisper_train_vs_cpu``'s batch: the first 64 tokens of each
    prompt, the next token their labels with the first quarter masked, and
    the frames."""
    S = WHISPER_VS_CPU["prompt"]
    labels = toks[:, 1:S + 1].clone()
    labels[:, :S // 4] = -1
    return {"tokens": toks[:, :S], "labels": labels, "frames": frames}


def _loss_and_leaf_grads(cfg, params, batch, dev):
    """One ``loss_fn`` forward and backward of ``params`` (made to require
    grad) on ``batch`` moved to ``dev`` -> (loss, [gradient of each leaf,
    on the CPU, in ``param_leaves`` order]); the gradients are cleared."""
    from repro_torch.models.transformer import param_leaves

    leaves = param_leaves(params)
    for _, t in leaves:
        t.requires_grad_(True)
    loss = float(_loss_and_grads(cfg, params, batch, dev).detach())
    grads = [t.grad.cpu() for _, t in leaves]
    for _, t in leaves:
        t.grad = None
    return loss, grads


def _leaf_grad_errs(names, got, want):
    """(largest max |error| over the leaf's max |g|, its leaf, that ratio by
    leaf) of two sequences of gradients, read one leaf at a time."""
    by_leaf = {}
    for name, a, b in zip(names, got, want, strict=True):
        scale = float(b.abs().max())
        err = max_err(a, b)
        by_leaf[name] = err / scale if scale > 0 else err
    worst = max(by_leaf, key=by_leaf.get)
    return by_leaf[worst], worst, by_leaf


def _whisper_vs_cpu_cpu_half():
    import torch

    cfg, params, toks, frames = _whisper_vs_cpu_inputs()
    logits = dense_rollout(torch, params, cfg, toks, WHISPER_VS_CPU["prompt"], "cpu",
                           frames=frames)
    loss, grads = _loss_and_leaf_grads(cfg, params, _whisper_train_batch(toks, frames), "cpu")
    return {"logits": logits, "train_loss": loss, "train_grads": grads}


def whisper_vs_cpu(torch, counters, ahead):
    """Whisper-large-v3 at full width with 2 encoder and 2 decoder layers,
    fp32, the same seeded weights and frames on the card (kernels) and on
    the CPU (plain versions): a prefill of 2 prompts of 64 tokens over
    1 500 frames, then 8 teacher-forced decode steps through
    ``registry.prefill`` / ``decode_step``. Every logit within 1e-3 (as
    ``e2e_vs_cpu``); every launch count exact: the flash forward 6 times a
    prefill (2 of them over keys of another length), paged decode 4 a
    step. Then ``whisper_train_vs_cpu`` on the same weights and frames: one
    ``loss_fn`` forward and backward on 2 x 64 tokens, a quarter of the
    labels masked; the loss within 1e-5 relative, every gradient leaf's
    max |error| within 1e-3 of its max |g| (``moe_train_vs_cpu``'s
    limits); the flash forward and backward 6 times each, 2 of each over
    keys of another length, on the CUDA cores (fp32). Runs the card halves
    (launches checked at once) and returns the function that holds them
    against the CPU halves, which ``ahead`` computes in a process of its
    own."""
    from repro_torch.models.transformer import param_leaves

    t0 = time.perf_counter()
    cfg, params, toks, frames = _whisper_vs_cpu_inputs()
    P, S, D = (WHISPER_VS_CPU[k] for k in ("prompts", "prompt", "steps"))
    params = params.to("cuda")
    wc = whisper_counters(counters)
    for c in wc.values():
        c.launches = 0
    card = dense_rollout(torch, params, cfg, toks, S, "cuda", frames=frames)
    launches = {k: c.launches for k, c in wc.items()}
    t_card = time.perf_counter() - t0
    batch = _whisper_train_batch(toks, frames)
    for c in wc.values():
        c.launches = 0
    t1 = time.perf_counter()
    train_loss, train_grads = _loss_and_leaf_grads(cfg, params, batch, "cuda")
    train_launches = {k: c.launches for k, c in wc.items()}
    t_train = time.perf_counter() - t1
    names = [n for n, _ in param_leaves(params)]
    del params
    free_cuda(torch)
    expect = whisper_launches(cfg, prefills=1, steps=D, tc=False)
    train_expect = whisper_train_launches(cfg, steps=1, tc=False)
    if not (bool(torch.isfinite(card).all()) and card.shape == (P, D + 1, cfg.vocab_size)):
        raise AssertionError("whisper_vs_cpu: non-finite logits or wrong shape")
    if launches != expect:
        raise AssertionError(f"whisper_vs_cpu: launches {launches} != {expect}")
    if train_launches != train_expect:
        raise AssertionError(f"whisper_train_vs_cpu: launches {train_launches} != "
                             f"{train_expect}")

    def finish():
        cpu, waited = ahead.get("whisper_vs_cpu")
        err = float((card - cpu["logits"]).abs().max())
        emit({"phase": "whisper_vs_cpu",
              "config": f"{WHISPER} width, {cfg.encoder_layers} encoder and "
                        f"{cfg.num_layers} decoder layers, float32", "prompts": P,
              "prompt": S, "frames": cfg.encoder_seq_len, "decode_steps": D,
              "max_abs_logit_err_card_vs_cpu": err, "tol": 1e-3,
              "max_abs_logit": float(card.abs().max()),
              "greedy_agree_card_vs_cpu": float(
                  (card.argmax(-1) == cpu["logits"].argmax(-1)).float().mean()),
              "card_launches": launches, "expected_launches": expect,
              "card_seconds": t_card, "cpu_seconds_ahead": cpu["seconds"],
              "waited_s": waited})
        if err > 1e-3:
            raise AssertionError(f"whisper_vs_cpu: card vs cpu logits differ by {err}")
        loss_tol, grad_tol = 1e-5, 1e-3
        loss_rel = abs(train_loss - cpu["train_loss"]) / abs(cpu["train_loss"])
        worst, worst_leaf, by_leaf = _leaf_grad_errs(names, train_grads, cpu["train_grads"])
        emit({"phase": "whisper_train_vs_cpu",
              "config": f"{WHISPER} width, {cfg.encoder_layers} encoder and "
                        f"{cfg.num_layers} decoder layers, float32 (whisper_vs_cpu's weights)",
              "batch": [P, S], "masked_labels": P * (S // 4), "frames": cfg.encoder_seq_len,
              "loss_card": train_loss, "loss_cpu": cpu["train_loss"],
              "loss_rel_err": loss_rel, "loss_tol_rel": loss_tol,
              "max_grad_err_over_leaf_max": worst, "worst_leaf": worst_leaf,
              "grad_tol_over_leaf_max": grad_tol, "grad_err_over_leaf_max_by_leaf": by_leaf,
              "card_launches": train_launches, "expected_launches": train_expect,
              "card_seconds": t_train})
        if not math.isfinite(train_loss) or loss_rel > loss_tol:
            raise AssertionError(f"whisper_train_vs_cpu: loss {train_loss} vs "
                                 f"{cpu['train_loss']} (relative {loss_rel}, limit {loss_tol})")
        if worst > grad_tol:
            raise AssertionError(f"whisper_train_vs_cpu: gradient of {worst_leaf} off by "
                                 f"{worst} of its max (limit {grad_tol})")
        return [launches, train_launches]

    return finish


def serve_whisper(torch, counters):
    """Whisper-large-v3 at full width and full depth (32 encoder and 32
    decoder layers, 1.68 B parameters), bf16, random seeded weights made on
    the card in serving storage: 4 prompts of 64 tokens over 4 x 1 500
    seeded frames, 32 new tokens, greedy, through ``generate`` (the dense
    path: ``build_serve_steps``, one prefill that encodes the frames once,
    31 decode steps). Tokens/s, TTFT (the encoder included), decode-step
    p50 / p99, peak memory; one prefill's and one decode step's device vs
    wall time (``torch.profiler``) and the step beside the bytes it must
    read; every launch count exact (96 tensor-core flash forwards a
    prefill, 32 of them cross, 64 paged decode launches a step)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import registry as R
    from repro_torch.models.transformer import param_leaves
    from repro_torch.serve import generate

    B, S, N = 4, 64, 32
    cfg = get_config(WHISPER)
    t0 = time.perf_counter()
    params = R.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    leaves = param_leaves(params)
    n_params = sum(t.numel() for _, t in leaves)
    n_bytes = sum(t.numel() * t.element_size() for _, t in leaves)
    prompts = np.random.default_rng(28).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    frames = whisper_frames(torch, cfg, B, "cuda", 29)
    # warm-up at the run's shapes (cuBLAS's first use of each, the allocator)
    generate(params, cfg, prompts, 2, frames=frames)
    torch.cuda.synchronize()
    wc = whisper_counters(counters)
    for c in wc.values():
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    out, info = generate(params, cfg, prompts, N, frames=frames)
    launches = {k: c.launches for k, c in wc.items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    times = info["token_times"]
    wall = times[-1] - times[0]
    dec = sorted(1e3 * (b - a) for a, b in zip(times[1:], times[2:]))
    expect = whisper_launches(cfg, prefills=1, steps=N - 1,
                              tc=tc_rule(cfg.dtype, cfg.resolved_head_dim))
    # what one decode step must read: the decoder's weights but the cross
    # K / V projections (their output is cached), the fp32 lm_head, the
    # cross caches' live rows (the self caches' are a few MB)
    step_bytes = sum(t.numel() * t.element_size() for n, t in leaves
                     if n.startswith("layers.") and ".cross.wk" not in n
                     and ".cross.wv" not in n)
    step_bytes += params["embed"]["lm_head"].numel() * params["embed"]["lm_head"].element_size()
    cross_bytes = (cfg.num_layers * 2 * B * cfg.encoder_seq_len * cfg.num_kv_heads
                   * cfg.resolved_head_dim * 2)
    line = {"phase": "serve_whisper", "run": "serve_whisper", "path": info["path"],
            "config": f"{cfg.name} {cfg.encoder_layers} encoder + {cfg.num_layers} decoder "
                      f"layers bf16", "params": n_params, "param_bytes_serving_storage": n_bytes,
            "init_s": t_init, "batch": B, "prompt_len": S, "frames": cfg.encoder_seq_len,
            "new_tokens": N, "wall_s": wall, "tokens_out": int(out.size),
            "tokens_per_s": out.size / wall, "ttft_ms": 1e3 * (times[1] - times[0]),
            "decode_step_ms_p50": statistics.median(dec),
            "decode_step_ms_p99": dec[min(len(dec) - 1, math.ceil(0.99 * len(dec)) - 1)],
            "decode_steps": len(dec), "peak_mem_gib": peak,
            "decode_step_bytes": {"decoder_weights_and_lm_head": step_bytes,
                                  "cross_kv": cross_bytes},
            "decode_step_bound_ms": (step_bytes + cross_bytes) / HBM_BYTES_PER_S * 1e3,
            "launches": launches, "expected_launches": expect}

    # where the time goes: one prefill and one decode step of the same bundle
    bundle = info["bundle"]
    tok = torch.from_numpy(prompts).cuda()
    step_tok = tok[:, :1].contiguous()
    state = {}

    def prefill():
        state["logits"], state["s"] = bundle.prefill_step(params, {"tokens": tok,
                                                                   "frames": frames})

    def decode():
        state["step_logits"] = bundle.serve_step(params, state["s"], step_tok)[0]

    line["prefill_profile"] = _profiled(torch, prefill)
    line["decode_step_profile"] = _profiled(torch, decode)
    finite = all(bool(torch.isfinite(state[k]).all()) for k in ("logits", "step_logits"))
    emit(line)
    if info["path"] != "dense" or out.shape != (B, N):
        raise AssertionError(f"serve_whisper: path {info['path']}, shape {out.shape}")
    if not finite or not ((out >= 0) & (out < cfg.vocab_size)).all():
        raise AssertionError("serve_whisper: non-finite logits or token ids out of range")
    if launches != expect:
        raise AssertionError(f"serve_whisper: launches {launches} != {expect}")
    del params, bundle, state, info
    free_cuda(torch)
    return line


# ---------------------------------------------------------------------------
# phases 4e and 6g: the MoE families, DeepSeek-V2-236B (MLA, the dense path)
# and Kimi-K2 (GQA 8:1 at hd 112, the paged path)
# ---------------------------------------------------------------------------

MOE_ARCHS = ("deepseek-v2-236b", "kimi-k2-1t-a32b")

# full width at reduced depth (neither model fits one card at full depth;
# serving storage), 1 dense + 1 MoE layer each in the whole script:
# DeepSeek-V2's bf16 dense path (MLA's absorbed decode) with its launch
# counts, and Kimi-K2's paged path (a second MoE layer would need 78 GB),
# whose prefill is the hd-112 tensor-core forward's main path. ``--moe``
# runs DeepSeek-V2 at 1 dense + 7 MoE layers, 60.7 GB
MOE_SCRIPT_LAYERS = {"deepseek-v2-236b": 2, "kimi-k2-1t-a32b": 2}
MOE_STUDY_LAYERS = {"deepseek-v2-236b": 8, "kimi-k2-1t-a32b": 2}
EXPERT_LEAVES = ("w_gate", "w_up", "w_down")


def _expert_bytes(params) -> int:
    """Bytes of the routed experts' weights ((E, a, b) tensors)."""
    from repro_torch.models.transformer import param_leaves

    return sum(t.numel() * t.element_size() for n, t in param_leaves(params)
               if n.rsplit(".", 1)[-1] in EXPERT_LEAVES and t.dim() == 3)


def serve_moe(torch, counters, arch: str, layers: int, *, int8_kv: bool = False):
    """DeepSeek-V2-236B (through ``generate``'s dense path: MLA's latent
    cache) or Kimi-K2 (its paged path) at full width and ``layers`` layers,
    bf16, random seeded weights made on the card in serving storage (the
    experts a slab at a time): 4 prompts of 512 tokens and 32 new tokens,
    greedy. Tokens/s, TTFT, decode-step p50 / p99, peak memory; every launch
    count exact. Then one prefill's and one decode step's device time
    beside their wall time (``torch.profiler``), and the decode step beside
    the bytes of the expert weights it reads: at 4 tokens the capacity
    formulation runs every expert (capacity 8), though at most 4 x top-k are
    routed."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as FK
    from repro_torch.models import registry as R
    from repro_torch.serve import PagedCacheConfig, generate, paged_supported

    B, S, N, bs = 4, 512, 32, 16
    cfg = get_config(arch).replace(num_layers=layers)
    paged = paged_supported(cfg)[0]
    if int8_kv and not paged:
        raise ValueError(f"{arch}: int8 KV is an option of the paged path")

    def pcfg(prompt: int, new: int):
        if not paged:
            return None
        need = -(-(-(-prompt // bs) * bs + new) // bs)
        return PagedCacheConfig(num_blocks=need * B + 1, block_size=bs, quantized=int8_kv)

    t0 = time.perf_counter()
    params = R.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = sum(t.numel() for t in params.parameters())
    n_bytes = sum(t.numel() * t.element_size() for t in params.parameters())
    expert_bytes = _expert_bytes(params)
    prompts = np.random.default_rng(25).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    generate(params, cfg, prompts[:, :16], 2, pcfg=pcfg(16, 2))  # warm-up
    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
    FK.tc112_launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out, info = generate(params, cfg, prompts, N, pcfg=pcfg(S, N))
    t_end = time.perf_counter()
    launches = {k: c.launches for k, c in counters.items()}
    launches["flash_attention_tc112"] = FK.tc112_launches
    L = cfg.num_layers
    hd = cfg.resolved_head_dim
    tc = tc_rule(cfg.dtype, hd)
    if paged:
        eng = info["engine"]
        res = sorted(eng.finished, key=lambda r: r.uid)
        ttft = sorted(1e3 * (r.first_token_at - t0) for r in res)
        last = res[-1].token_times  # the last prompt's prefill, then every decode step
        dec = sorted(1e3 * (b - a) for a, b in zip(last, last[1:]))
        prefills, steps = eng.stats["prefills"], eng.stats["decode_steps"]
        forwards = prefills + steps
        expect = {"flash_attention": prefills * L, "paged_decode_attention": steps * L,
                  "quantize_blockwise": 2 * L * forwards if int8_kv else 0,
                  "flash_attention_tc": prefills * L if tc else 0,
                  "flash_attention_tc112": prefills * L if tc and hd == 112 else 0}
        ttft_line = {"ttft_ms": ttft[-1], "ttft_ms_first": ttft[0]}
    else:
        times = info["token_times"]
        dec = sorted(1e3 * (b - a) for a, b in zip(times[1:], times[2:]))
        prefills, steps, forwards = 1, len(dec), N
        expect = {"flash_attention": 0, "paged_decode_attention": 0, "quantize_blockwise": 0,
                  "flash_attention_tc": 0, "flash_attention_tc112": 0}
        ttft_line = {"ttft_ms": 1e3 * (times[1] - times[0])}
    expect.update({"flash_attention_bwd": 0,
                   "flash_attention_bwd_tc": 0, "dequantize_blockwise": 0, "pier_update": 0,
                   "rmsnorm": forwards * norm_launches(cfg), "rmsnorm_bwd": 0})
    expect = {k: expect[k] for k in launches}
    line = {"phase": "serve_moe", "run": f"serve_moe_{arch}" + ("_int8kv" if int8_kv else ""),
            "path": info["path"], "kv": "int8" if int8_kv else "bf16",
            "config": f"{cfg.name} full width, {L} of {get_config(arch).num_layers} layers, "
                      f"bf16", "experts": cfg.num_experts, "top_k": cfg.num_experts_per_tok,
            "params": n_params, "param_bytes_serving_storage": n_bytes,
            "expert_bytes": expert_bytes, "init_s": t_init, "batch": B, "prompt_len": S,
            "new_tokens": N, "wall_s": t_end - t0, "tokens_out": int(out.size),
            "tokens_per_s": out.size / (t_end - t0), **ttft_line,
            "decode_step_ms_p50": statistics.median(dec),
            "decode_step_ms_p99": dec[min(len(dec) - 1, math.ceil(0.99 * len(dec)) - 1)],
            "prefills": prefills, "decode_steps": steps,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "launches": launches, "expected_launches": expect}

    # where the time goes: one prefill and one decode step of the same bundle
    tok = torch.from_numpy(prompts).cuda()
    state = {}
    if paged:
        bundle, pools = eng.bundle, eng.pools
        need = pcfg(S, N).blocks_for(S + N)
        tables = (1 + torch.arange(B * need, dtype=torch.int32, device="cuda")).view(B, need)
        pos = torch.full((B,), S + N - 1, dtype=torch.int32, device="cuda")

        def prefill():  # one prompt (the engine prefills them one at a time)
            state["logits"] = bundle.prefill_step(params, tok[:1], pools,
                                                  tables[0, :S // bs], S - 1)[0]

        def decode():
            state["step_logits"] = bundle.decode_step(params, pools, tok[:, 0], pos, tables,
                                                      pos + 1)[0]
    else:
        bundle = info["bundle"]

        def prefill():
            state["logits"], state["s"] = bundle.prefill_step(params, {"tokens": tok})

        def decode():
            state["step_logits"] = bundle.serve_step(params, state["s"],
                                                     tok[:, :1].contiguous())[0]

    line["prefill_profile"] = _profiled(torch, prefill)
    line["decode_step_profile"] = prof = _profiled(torch, decode)
    b_ms = expert_bytes / HBM_BYTES_PER_S * 1e3
    line["decode_expert_bytes_bound_ms"] = b_ms
    line["decode_device_over_expert_bound"] = (prof["device_ms"] / b_ms
                                               if prof["kernels"] else "not measured")
    line["experts_routed_at_most"] = min(cfg.num_experts, B * cfg.num_experts_per_tok)
    finite = all(bool(torch.isfinite(state[k]).all()) for k in ("logits", "step_logits"))
    emit(line)
    want_path = "paged" if paged else "dense"
    if info["path"] != want_path or out.shape != (B, N) or steps != N - 1:
        raise AssertionError(f"serve_moe {arch}: path {info['path']}, shape {out.shape}, "
                             f"{steps} decode steps")
    if not finite or not ((out >= 0) & (out < cfg.vocab_size)).all():
        raise AssertionError(f"serve_moe {arch}: non-finite logits or token ids out of range")
    if launches != expect:
        raise AssertionError(f"serve_moe {arch}: launches {launches} != {expect}")
    del params, bundle, state, info
    free_cuda(torch)
    return line


@contextlib.contextmanager
def recorded_routes(sink: list):
    """Record the top-k expert ids of every ``moe.route`` call (on the
    host) into ``sink``."""
    from repro_torch.models import moe as MOE

    route = MOE.route

    def recording(logits, k):
        out = route(logits, k)
        sink.append(out[2].cpu())
        return out

    MOE.route = recording
    try:
        yield
    finally:
        MOE.route = route


def routing_agree(card, cpu) -> float:
    """The share of the card's top-k assignments that the CPU made too
    (per token, as sets)."""
    same = total = 0
    for a, b in zip(card, cpu, strict=True):
        same += int((a[:, :, None] == b[:, None, :]).any(-1).sum())
        total += a.numel()
    return same / total


# the moe_vs_cpu cut: host memory (384 fp32 Kimi experts are 67.6 GB) and
# router near-ties (the gap between the k-th and the next logit shrinks
# with the expert count; at 32 experts about 1 token in 50 000 would route
# differently under fp32 rounding)
MOE_VS_CPU_EXPERTS = 32


def moe_vs_cpu(torch, counters):
    """DeepSeek-V2-236B and Kimi-K2 at full width with 2 layers (the dense
    layer and one MoE layer), fp32, ``num_experts`` cut to 32 (top-k kept),
    the same seeded weights on the card (kernels) and on the CPU (plain
    versions): 2 prompts of 64 tokens, then 8 teacher-forced decode steps,
    each model through its own path (DeepSeek's dense ``registry.prefill``
    / ``decode_step``, Kimi's paged prefill and decode). Every logit within
    1e-3; every launch count exact; the share of top-k assignments the same
    on both sides reported. Then ``moe_train_vs_cpu`` on the same weights
    (``_moe_train_vs_cpu``)."""
    from repro_torch.configs import get_config
    from repro_torch.models import registry as R
    from repro_torch.models.transformer import param_leaves, with_leaves
    from repro_torch.serve import PagedCacheConfig, paged_supported

    P, S, D = 2, 64, 8
    fp32_runs = []
    for arch in MOE_ARCHS:
        full = get_config(arch)
        cfg = full.replace(num_layers=2, dtype="float32", num_experts=MOE_VS_CPU_EXPERTS)
        t0 = time.perf_counter()
        params_gpu = R.init_params(cfg, seed=0, device="cuda")
        params_cpu = with_leaves(params_gpu, {n: t.cpu() for n, t in param_leaves(params_gpu)})
        toks = torch.randint(0, cfg.vocab_size, (P, S + D), dtype=torch.int32,
                             generator=torch.Generator().manual_seed(26))
        paged = paged_supported(cfg)[0]
        pcfg = PagedCacheConfig(num_blocks=P * 5 + 1, block_size=16, dtype="float32")

        def rollout(params, device):
            if paged:
                return rollouts(torch, params, cfg, toks, S, D, pcfg, device)
            return dense_rollout(torch, params, cfg, toks, S, device)

        routes_card, routes_cpu = [], []
        for c in counters.values():
            c.launches = 0
        with recorded_routes(routes_card):
            card = rollout(params_gpu, "cuda")
        launches = {k: c.launches for k, c in counters.items()}
        t_card = time.perf_counter() - t0
        with recorded_routes(routes_cpu):
            cpu = rollout(params_cpu, "cpu")
        err = float((card - cpu).abs().max())
        L = cfg.num_layers
        forwards = P + D if paged else 1 + D
        expect = {"flash_attention": P * L if paged else 0, "flash_attention_bwd": 0,
                  "flash_attention_tc": 0, "flash_attention_bwd_tc": 0,
                  "paged_decode_attention": D * L if paged else 0, "quantize_blockwise": 0,
                  "dequantize_blockwise": 0, "pier_update": 0,
                  "rmsnorm": forwards * norm_launches(cfg), "rmsnorm_bwd": 0}
        agree = routing_agree(routes_card, routes_cpu)
        emit({"phase": "moe_vs_cpu", "arch": arch, "path": "paged" if paged else "dense",
              "config": f"{arch} width, {L} layers (1 dense, 1 MoE), float32",
              "cut": f"num_experts {full.num_experts} -> {cfg.num_experts}, top-k "
                     f"{cfg.num_experts_per_tok} kept (host memory; router near-ties)",
              "prompts": P, "prompt": S, "decode_steps": D,
              "max_abs_logit_err_card_vs_cpu": err, "tol": 1e-3,
              "max_abs_logit": float(card.abs().max()),
              "greedy_agree_card_vs_cpu": float(
                  (card.argmax(-1) == cpu.argmax(-1)).float().mean()),
              "routing_agree": agree, "route_calls": len(routes_card),
              "routed_tokens": sum(r.shape[0] for r in routes_card),
              "card_launches": launches, "expected_launches": expect,
              "card_seconds": t_card, "seconds": time.perf_counter() - t0})
        if not (bool(torch.isfinite(card).all()) and card.shape == (P, D + 1, cfg.vocab_size)):
            raise AssertionError(f"moe_vs_cpu {arch}: non-finite logits or wrong shape")
        if err > 1e-3:
            raise AssertionError(f"moe_vs_cpu {arch}: card vs cpu logits differ by {err} "
                                 f"(routing agree {agree})")
        if launches != expect:
            raise AssertionError(f"moe_vs_cpu {arch}: launches {launches} != {expect}")
        fp32_runs.append(launches)
        fp32_runs.append(_moe_train_vs_cpu(torch, counters, arch, full, cfg, params_gpu,
                                           params_cpu))
        del params_gpu, params_cpu
        free_cuda(torch)
    return fp32_runs


def _moe_train_vs_cpu(torch, counters, arch, full, cfg, params_gpu, params_cpu):
    """``moe_train_vs_cpu``: ``moe_vs_cpu``'s weights (fp32, so serving and
    training storage alike), made to require grad, through one ``loss_fn``
    forward and backward on the card (kernels) and on the CPU (plain
    versions) on 2 x 64 tokens with labels, a quarter of them masked. The
    loss within 1e-5 relative; every gradient leaf's max |error| within 1e-3
    of that leaf's max |g|; the routes of both reported; launches exact
    (RMSNorm forward and backward; for Kimi-K2 the flash forward and
    backward on the fp32 CUDA-core route at hd 112). The only full-width
    gradient check of MoE and MLA: the experts, the router through the aux
    and z losses, MLA's latent norms through the RMSNorm backward at 1536
    and 512."""
    from repro_torch.models import registry as R
    from repro_torch.models.transformer import param_leaves

    t0 = time.perf_counter()
    B, S, loss_tol, grad_tol = 2, 64, 1e-5, 1e-3
    toks = torch.randint(0, cfg.vocab_size, (B, S + 1), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(27))
    labels = toks[:, 1:].clone()
    labels[:, :S // 4] = -1  # masked positions
    batch = {"tokens": toks[:, :-1], "labels": labels}
    for p in (params_gpu, params_cpu):
        for _, t in param_leaves(p):
            t.requires_grad_(True)
    routes_card, routes_cpu = [], []
    for c in counters.values():
        c.launches = 0
    with recorded_routes(routes_card):
        loss_card, m_card = R.loss_fn(params_gpu, cfg, {k: v.cuda() for k, v in batch.items()})
        loss_card.backward()
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    t_card = time.perf_counter() - t0
    with recorded_routes(routes_cpu):
        loss_cpu, m_cpu = R.loss_fn(params_cpu, cfg, batch)
        loss_cpu.backward()
    lc, lp = float(loss_card.detach()), float(loss_cpu.detach())
    loss_rel = abs(lc - lp) / abs(lp)
    card, cpu = param_leaves(params_gpu), param_leaves(params_cpu)
    worst, worst_leaf, by_leaf = _leaf_grad_errs(  # a leaf at a time on the host
        [name for name, _ in card], (a.grad.cpu() for _, a in card), (b.grad for _, b in cpu))
    for _, t in card + cpu:
        t.grad = None
    L, n = cfg.num_layers, norm_launches(cfg)
    fl = flash_layers(cfg)
    expect = {k: 0 for k in counters}
    expect.update(rmsnorm=n, rmsnorm_bwd=n, flash_attention=fl, flash_attention_bwd=fl)
    agree = routing_agree(routes_card, routes_cpu)
    emit({"phase": "moe_train_vs_cpu", "arch": arch,
          "config": f"{arch} width, {L} layers (1 dense, 1 MoE), float32",
          "cut": f"num_experts {full.num_experts} -> {cfg.num_experts}, top-k "
                 f"{cfg.num_experts_per_tok} kept (moe_vs_cpu's weights)",
          "batch": [B, S], "masked_labels": B * (S // 4),
          "loss_card": lc, "loss_cpu": lp, "loss_rel_err": loss_rel, "loss_tol_rel": loss_tol,
          **{f"{k}_{side}": float(m[k].detach()) for k in ("moe_aux", "moe_z")
             for side, m in (("card", m_card), ("cpu", m_cpu))},
          "max_grad_err_over_leaf_max": worst, "worst_leaf": worst_leaf,
          "grad_tol_over_leaf_max": grad_tol, "grad_err_over_leaf_max_by_leaf": by_leaf,
          "routing_agree": agree, "route_calls": len(routes_card),
          "card_launches": launches, "expected_launches": expect,
          "card_seconds": t_card, "seconds": time.perf_counter() - t0})
    if not math.isfinite(lc) or loss_rel > loss_tol:
        raise AssertionError(f"moe_train_vs_cpu {arch}: loss {lc} vs {lp} (relative "
                             f"{loss_rel}, limit {loss_tol})")
    if worst > grad_tol:
        raise AssertionError(f"moe_train_vs_cpu {arch}: gradient of {worst_leaf} off by "
                             f"{worst} of its max (limit {grad_tol}; routing agree {agree})")
    if launches != expect:
        raise AssertionError(f"moe_train_vs_cpu {arch}: launches {launches} != {expect}")
    return launches


# ---------------------------------------------------------------------------
# phase 5: where the device time of one prefill and one decode step goes
# ---------------------------------------------------------------------------


def _kernel_group(name: str) -> str:
    for key, group in (("flash_fwd", "flash_attention"),
                       ("paged_decode", "paged_decode_attention"),
                       ("quantize_blockwise", "quantize_blockwise")):
        if key in name:
            return group
    if any(k in name.lower() for k in ("gemm", "gemv", "nvjet", "xmma", "cutlass")):
        return "matmul"
    return "other"


def breakdown(torch, params, cfg):
    """Device time by kernel group (``torch.profiler``) beside the host's
    wall time, for the serve path at the serve phase's shapes: one
    512-token prefill and decode steps over 4 slots at contexts
    128/256/384/512 with bf16 KV, and the same decode steps with int8 KV
    (each step quantizes every layer's K and V rows). Wall times come from
    a separate unprofiled run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.parallel.steps import build_paged_serve_steps
    from repro_torch.serve import PagedCacheConfig

    lens, steps, bs = [128, 256, 384, 512], 8, 16
    need = -(-(max(lens) + steps) // bs)
    g = torch.Generator(device="cuda").manual_seed(6)
    tables = (1 + torch.arange(len(lens) * need, device="cuda", dtype=torch.int32)
              ).reshape(len(lens), need)
    prompts = [torch.randint(0, cfg.vocab_size, (1, n), generator=g, device="cuda",
                             dtype=torch.int32) for n in lens]
    tok = torch.zeros(len(lens), dtype=torch.int32, device="cuda")
    start = torch.tensor(lens, dtype=torch.int32, device="cuda")
    bundles = {}
    for quantized in (False, True):
        pcfg = PagedCacheConfig(num_blocks=need * len(lens) + 1, block_size=bs,
                                quantized=quantized)
        bundle = build_paged_serve_steps(cfg, pcfg=pcfg, device="cuda")
        bundles[quantized] = (bundle, bundle.init_pools())

    def prefill_all(quantized):
        bundle, pools = bundles[quantized]
        for i, n in enumerate(lens):
            bundle.prefill_step(params, prompts[i], pools, tables[i, :n // bs], n - 1)

    def decode_all(quantized):
        bundle, pools = bundles[quantized]
        pos = start.clone()
        for _ in range(steps):
            bundle.decode_step(params, pools, tok, pos, tables, pos + 1)
            pos += 1

    def wall_ms(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0)

    bundle, pools = bundles[False]
    out = {}
    for kind, quantized, fn, count in (
            ("prefill_512", False, lambda: bundle.prefill_step(
                params, prompts[-1], pools, tables[-1, :512 // bs], 511), 1),
            ("decode_step", False, lambda: decode_all(False), steps),
            ("decode_step_int8_kv", True, lambda: decode_all(True), steps)):
        prefill_all(quantized)  # the pools hold every prompt before any timing
        wall = wall_ms(fn) / count
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        groups, n_kernels, quant = {}, 0, {}
        for evt in prof.events():
            if evt.device_type == DeviceType.CUDA:
                grp = _kernel_group(evt.name)
                groups[grp] = groups.get(grp, 0.0) + evt.time_range.elapsed_us() / 1e3 / count
                n_kernels += 1
                if grp == "quantize_blockwise":
                    route = "vec" if "quantize_blockwise_vec_kernel" in evt.name else "scalar"
                    quant[route] = quant.get(route, 0) + 1
        busy = sum(groups.values())
        out[kind] = {"wall_ms": wall,
                     "device_ms": busy if n_kernels else "not measured",
                     "device_idle_share": 1 - busy / wall if n_kernels else "not measured",
                     "kernels_per_call": n_kernels / count,
                     "device_ms_by_group": groups,
                     **({"quantize_launches_by_route": quant} if quantized else {})}
    emit({"phase": "breakdown", "config": "gpt2-xl 48 layers bf16, bf16 KV (int8 KV where "
                                          "named)",
          "decode_slots": len(lens), "decode_contexts": lens, **out})


# ---------------------------------------------------------------------------
# phases 6-8: training through SimulatedRun
# ---------------------------------------------------------------------------

TRAIN_TC = dict(total_steps=40, sync_interval=2, warmup_frac=0.1)
# Table I's inner LR (4e-4) with the 40-step schedule leaves under one step
# of LR warmup, and the loss of the 48-layer model rose after the second
# outer sync (``--witness-lr`` shows it without the attention kernels too);
# a run this short takes a gentler LR, warmed up over the 4 lazy-start steps.
TRAIN_LR = dict(inner_lr=5e-5, inner_min_lr=5e-6, lr_warmup_frac=0.1)
# MiniCPM's WSD inner schedule over a 20-step run taken to its end: LR
# warmup over steps 0-2, stable to step 14, the linear decay over 15-19
MINICPM_SCHEDULE = dict(total_steps=20, sync_interval=2, warmup_frac=0.1, inner_lr=5e-5,
                        inner_min_lr=5e-6, lr_schedule="wsd", lr_warmup_frac=0.15,
                        wsd_decay_frac=0.25)


def _quant_launches(strategy, G: int, P: int):
    """(quantize, dequantize) launches per leaf per outer sync, as the
    strategy's code path in ``sync/strategies.py`` makes them."""
    from repro_torch.sync import Chunked, Hierarchical, Int8Wire, Quantized

    pods = False
    if isinstance(strategy, Chunked):  # numerically its inner strategy
        strategy = strategy.inner
    if isinstance(strategy, Hierarchical):  # the pods are the endpoints
        strategy, pods = strategy.inner, True
    if isinstance(strategy, Quantized):  # compress_leaf per group
        return G, G
    if isinstance(strategy, Int8Wire):
        E = P if pods else G
        if strategy.reduce_scatter:
            # per group: quantize and dequantize its payload; per slot: the
            # reduce-scatter dequantizes E sources, the endpoint re-quantizes
            # and dequantizes its slot for its residual, the all-gather
            # dequantizes it once more
            return G + E, G + E * E + E + E
        # per group: quantize and dequantize; the ring dequantizes E sources
        return G, G + E
    return 0, 0


def _train_expect(run, steps: int, num_leaves: int):
    """Launches the main path must show after ``steps`` steps from 0."""
    sched = run.sched
    warm = sum(1 for s in range(steps) if sched.phase(s) == "warmup")
    syncs = sum(1 for s in range(steps) for ev in sched.events(s)
                if ev.kind == "dispatch" and ev.op == "outer")
    forwards = warm + run.G * (steps - warm)  # each with one backward
    fwd = flash_layers(run.mc) * forwards
    norms = norm_launches(run.mc) * forwards
    nq, ndq = _quant_launches(run.strategy, run.G, run.P)
    tc = fwd if tc_rule(run.mc.dtype, run.mc.resolved_head_dim) else 0
    tc_bwd = fwd if tc_bwd_rule(run.mc.dtype, run.mc.resolved_head_dim) else 0
    expect = {"flash_attention": fwd, "flash_attention_bwd": fwd,
              "flash_attention_tc": tc, "flash_attention_bwd_tc": tc_bwd,
              "pier_update": num_leaves * syncs, "paged_decode_attention": 0,
              "quantize_blockwise": nq * num_leaves * syncs,
              "dequantize_blockwise": ndq * num_leaves * syncs,
              "rmsnorm": norms, "rmsnorm_bwd": norms}
    if tc and run.mc.resolved_head_dim == 256:  # the hd-256 forward's own counter
        expect["flash_attention_tc256"] = tc
    return expect, warm, syncs


TRAIN_VS_CPU_STEPS = 12


def _train_vs_cpu_inputs():
    """``train_vs_cpu``'s model (GPT-2 XL width, 4 layers, fp32), its
    parameters made on the CPU from a seed, and its config at a delay."""
    from repro_torch.config import TrainConfig
    from repro_torch.configs import get_config
    from repro_torch.models import registry as R

    cfg = get_config("gpt2-xl").replace(num_layers=4, dtype="float32")
    base = R.init_params(cfg, seed=0, device="cpu", training=True)
    return cfg, base, lambda delay: TrainConfig(**TRAIN_TC, global_batch_size=4, seq_len=128,
                                                sync_delay=delay)


def train_vs_cpu(torch, counters, ahead):
    """The same 12 steps on the card and on the CPU, at sync_delay 0 and 1.
    Runs the card halves (launches checked at once) and returns the
    function that holds them against the CPU halves, which ``ahead``
    computes in a process of its own; it returns the card's launches."""
    from repro_torch.core.simulate import SimulatedRun
    from repro_torch.models.transformer import param_leaves

    steps, loss_tol, param_tol = TRAIN_VS_CPU_STEPS, 1e-3, 1e-3
    cfg, base, make_tc = _train_vs_cpu_inputs()
    cards, seen = {}, []
    for delay in (0, 1):
        t0 = time.perf_counter()
        run = SimulatedRun(cfg, make_tc(delay), num_groups=2, device="cuda",
                           params=copy.deepcopy(base))
        for c in counters.values():
            c.launches = 0
        h_card = run.run(steps)
        run.flush()
        torch.cuda.synchronize()
        launches = {k: c.launches for k, c in counters.items()}
        pc = [t.detach().cpu() for _, t in param_leaves(run.eval_params())]
        expect, warm, syncs = _train_expect(run, steps, len(pc))
        cards[delay] = dict(h=h_card, pc=pc, launches=launches, warm=warm, syncs=syncs,
                            t_card=time.perf_counter() - t0)
        if not all(math.isfinite(x) for x in h_card["train_loss"]):
            raise AssertionError(f"train_vs_cpu delay {delay}: non-finite card loss")
        if launches != expect:
            raise AssertionError(f"train_vs_cpu launches {launches} != {expect}")
        seen.append(launches)
        del run
    del base

    def finish():
        for delay, card in cards.items():
            cpu, waited = ahead.get(f"train_vs_cpu_d{delay}")
            loss_err = max(abs(a - b) for a, b in zip(card["h"]["train_loss"],
                                                      cpu["train_loss"]))
            p_err = max(float((a - b).abs().max()) for a, b in zip(card["pc"], cpu["params"]))
            emit({"phase": "train_vs_cpu", "config": "gpt2-xl width, 4 layers, float32",
                  "groups": 2, "sync_delay": delay, "steps": steps,
                  "warmup_steps": card["warm"], "outer_syncs": card["syncs"],
                  "per_group_batch": 2, "seq_len": 128,
                  "loss_card": card["h"]["train_loss"], "loss_cpu": cpu["train_loss"],
                  "max_abs_loss_err": loss_err, "loss_tol": loss_tol,
                  "max_abs_param_err": p_err, "param_tol": param_tol,
                  "card_launches": card["launches"], "card_seconds": card["t_card"],
                  "cpu_seconds_ahead": cpu["seconds"], "waited_s": waited})
            if loss_err > loss_tol or p_err > param_tol:
                raise AssertionError(f"train_vs_cpu delay {delay}: loss err {loss_err} "
                                     f"(limit {loss_tol}), param err {p_err} (limit "
                                     f"{param_tol})")
        diff = max(float((a - b).abs().max()) for a, b in zip(cards[0]["pc"], cards[1]["pc"]))
        emit({"phase": "train_vs_cpu", "delay1_vs_delay0_max_abs_param_diff": diff})
        if not diff > 1e-6:
            raise AssertionError(f"delayed sync equals eager (max diff {diff}): the "
                                 f"in-flight snapshot is not held")
        return seen

    return finish


QWEN3_VS_CPU_STEPS = 8


def _qwen3_vs_cpu_inputs():
    """``qwen3_vs_cpu``'s model (Qwen3-1.7B width, 2 layers, fp32), its
    parameters made on the CPU from a seed, its batch and its run's config."""
    from repro_torch.config import TrainConfig
    from repro_torch.configs import get_config
    from repro_torch.models import registry as R

    import torch

    cfg = get_config("qwen3-1.7b").replace(num_layers=2, dtype="float32")
    base = R.init_params(cfg, seed=0, device="cpu", training=True)
    toks = torch.randint(0, cfg.vocab_size, (2, 129), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(11))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    tc = TrainConfig(**TRAIN_TC, global_batch_size=4, seq_len=128, sync_delay=0)
    return cfg, base, batch, tc


def _loss_and_grads(cfg, params, batch, dev):
    from repro_torch.models import registry as R

    loss, _ = R.loss_fn(params, cfg, {k: v.to(dev) for k, v in batch.items()})
    loss.backward()
    return loss


def _qwen3_vs_cpu_cpu_half():
    """``qwen3_vs_cpu``'s CPU half: the prefill's logits, the batch's loss
    and gradients, then the 8-step run from the same parameters."""
    import torch

    from repro_torch.models import registry as R
    from repro_torch.models.transformer import param_leaves

    cfg, base, batch, tc = _qwen3_vs_cpu_inputs()
    with torch.no_grad():
        logits = R.forward(base, cfg, {"tokens": batch["tokens"][:1]})[0]
    loss = float(_loss_and_grads(cfg, base, batch, "cpu").detach())
    grads = [t.grad for _, t in param_leaves(base)]
    for _, t in param_leaves(base):
        t.grad = None
    return {"logits": logits, "loss": loss, "grads": grads,
            **_cpu_run(cfg, tc, base, QWEN3_VS_CPU_STEPS, num_groups=2)}


def qwen3_vs_cpu(torch, counters, ahead):
    """Qwen3-1.7B width at 2 layers, fp32, the same seeded parameters on the
    card (kernels) and on the CPU (plain versions): one 128-token prefill's
    logits, one batch's loss and gradients, then 8 steps of ``SimulatedRun``
    (G = 2, per-group batch 2 x 128, flat sync; 4 warmup steps and two outer
    syncs). Everything within 1e-3; launches exact. Runs the card half
    (launches checked at once) and returns the function that holds it
    against the CPU half, which ``ahead`` computes in a process of its
    own."""
    from repro_torch.core.simulate import SimulatedRun
    from repro_torch.models import registry as R
    from repro_torch.models.transformer import param_leaves

    steps, tol = QWEN3_VS_CPU_STEPS, 1e-3
    t0 = time.perf_counter()
    cfg, base, batch, tc = _qwen3_vs_cpu_inputs()
    card = copy.deepcopy(base).to("cuda")
    L, n = cfg.num_layers, norm_launches(cfg)
    zero = {k: 0 for k in counters}

    def launches_of(fn):
        for c in counters.values():
            c.launches = 0
        out = fn()
        torch.cuda.synchronize()
        return out, {k: c.launches for k, c in counters.items()}

    with torch.no_grad():
        lg_card, l_prefill = launches_of(
            lambda: R.forward(card, cfg, {"tokens": batch["tokens"][:1].cuda()})[0])
    lg_card = lg_card.cpu()
    loss_card, l_grad = launches_of(lambda: _loss_and_grads(cfg, card, batch, "cuda"))
    loss_card = float(loss_card.detach())
    g_card = [t.grad.cpu() for _, t in param_leaves(card)]
    del card
    run = SimulatedRun(cfg, tc, num_groups=2, device="cuda", params=copy.deepcopy(base))
    del base
    h_card, l_run = launches_of(lambda: run.run(steps))
    run.flush()
    pc = [t.detach().cpu() for _, t in param_leaves(run.eval_params())]
    expect_run, warm, syncs = _train_expect(run, steps, len(pc))
    del run
    expect = {
        "prefill": dict(zero, flash_attention=L, rmsnorm=n),
        "loss_and_grads": dict(zero, flash_attention=L, flash_attention_bwd=L, rmsnorm=n,
                               rmsnorm_bwd=n),
        "simulated_run": expect_run}
    got = {"prefill": l_prefill, "loss_and_grads": l_grad, "simulated_run": l_run}
    if not (torch.isfinite(lg_card).all() and lg_card.shape == (1, 128, cfg.vocab_size)):
        raise AssertionError("qwen3_vs_cpu: non-finite logits or wrong shape")
    if got != expect:
        raise AssertionError(f"qwen3_vs_cpu launches {got} != {expect}")
    t_card = time.perf_counter() - t0

    def finish():
        cpu, waited = ahead.get("qwen3_vs_cpu")
        errs = {"prefill_max_abs_logit_err": max_err(lg_card, cpu["logits"]),
                "loss_abs_err": abs(loss_card - cpu["loss"]),
                "max_abs_grad_err": max(max_err(a, b) for a, b in zip(g_card, cpu["grads"])),
                "run_max_abs_loss_err": max(abs(a - b) for a, b in zip(h_card["train_loss"],
                                                                       cpu["train_loss"])),
                "run_max_abs_param_err": max(float((a - b).abs().max())
                                             for a, b in zip(pc, cpu["params"]))}
        emit({"phase": "qwen3_vs_cpu", "config": "qwen3-1.7b width, 2 layers, float32",
              "leaves": len(pc), "prefill_tokens": 128, "batch": [2, 128], "groups": 2,
              "steps": steps, "warmup_steps": warm, "outer_syncs": syncs,
              "per_group_batch": 2, "seq_len": 128, "loss_card": h_card["train_loss"],
              "loss_cpu": cpu["train_loss"], **errs, "tol": tol, "launches": got,
              "expected_launches": expect, "card_seconds": t_card,
              "cpu_seconds_ahead": cpu["seconds"], "waited_s": waited})
        if not all(math.isfinite(x) for x in h_card["train_loss"]) or max(errs.values()) > tol:
            raise AssertionError(f"qwen3_vs_cpu: errors {errs} (limit {tol})")
        return list(got.values())

    return finish


# (name, OuterCommConfig kwargs, groups, pods, sync_delay)
COMPRESSED_CONFIGS = [
    ("quantize_int8_b256_d0", {"compression": "quantize"}, 2, 1, 0),
    ("quantize_int8_b256_d1", {"compression": "quantize"}, 2, 1, 1),
    ("quantize_int4_b64", {"compression": "quantize", "bits": 4, "block": 64}, 2, 1, 0),
    ("int8_wire", {"compression": "int8-wire"}, 2, 1, 0),
    ("rs_ag", {"compression": "rs-ag"}, 2, 1, 0),
    ("hierarchical_int8_wire_g4_p2", {"compression": "int8-wire", "hierarchical": True},
     4, 2, 0),
    ("chunked2_quantize", {"compression": "quantize", "chunks": 2}, 2, 1, 0),
]


COMPRESSED_STEPS = 8


def _compressed_inputs():
    """``train_compressed_vs_cpu``'s model (GPT-2 XL width, 2 layers, fp32),
    its parameters made on the CPU from a seed, and each case's config."""
    from repro_torch.config import OuterCommConfig, TrainConfig
    from repro_torch.configs import get_config
    from repro_torch.models import registry as R

    cfg = get_config("gpt2-xl").replace(num_layers=2, dtype="float32")
    base = R.init_params(cfg, seed=0, device="cpu", training=True)
    tcs = {name: TrainConfig(**TRAIN_TC, global_batch_size=G, seq_len=64, sync_delay=delay,
                             outer_comm=OuterCommConfig(**comm))
           for name, comm, G, P, delay in COMPRESSED_CONFIGS}
    return cfg, base, tcs


def train_compressed_vs_cpu(torch, counters, ahead):
    """The compressed and hierarchical outer syncs on the card and on the
    CPU from the same parameters and batches: 8 steps (4 warmup, 4 inner,
    outer syncs after steps 5 and 7) at GPT-2 XL width, 2 layers, fp32.
    Runs the card halves (launches and the residual checked at once) and
    returns the function that holds them against the CPU halves, which
    ``ahead`` computes in a process of its own."""
    from repro_torch.core.simulate import SimulatedRun
    from repro_torch.models.transformer import param_leaves

    steps, per, loss_tol, param_tol = COMPRESSED_STEPS, 1, 1e-3, 1e-3
    cfg, base, tcs = _compressed_inputs()
    cards, seen = [], []
    for name, comm, G, P, delay in COMPRESSED_CONFIGS:
        t0 = time.perf_counter()
        run = SimulatedRun(cfg, tcs[name], num_groups=G, num_pods=P, device="cuda",
                           params=copy.deepcopy(base))
        for c in counters.values():
            c.launches = 0
        h_card = run.run(steps)
        run.flush()
        torch.cuda.synchronize()
        launches = {k: c.launches for k, c in counters.items()}
        pc = [t.detach().cpu() for _, t in param_leaves(run.eval_params())]
        res_max = max(float(r.abs().max()) for r in run.state.outer.residual)
        expect, warm, syncs = _train_expect(run, steps, len(pc))
        cards.append(dict(name=name, G=G, P=P, delay=delay, strategy=run.strategy.name,
                          h=h_card, pc=pc, launches=launches, expect=expect, warm=warm,
                          syncs=syncs, res_max=res_max, t_card=time.perf_counter() - t0))
        if not all(math.isfinite(x) for x in h_card["train_loss"]):
            raise AssertionError(f"train_compressed_vs_cpu {name}: non-finite card loss")
        if not (math.isfinite(res_max) and res_max > 0):
            raise AssertionError(f"train_compressed_vs_cpu {name}: residual {res_max}")
        if launches != expect:
            raise AssertionError(f"train_compressed_vs_cpu {name}: launches {launches} "
                                 f"!= {expect}")
        seen.append(launches)
        del run
    del base

    def finish():
        for card in cards:
            name = card["name"]
            cpu, waited = ahead.get(f"train_compressed_vs_cpu_{name}")
            loss_err = max(abs(a - b) for a, b in zip(card["h"]["train_loss"],
                                                      cpu["train_loss"]))
            p_err = max(float((a - b).abs().max()) for a, b in zip(card["pc"], cpu["params"]))
            emit({"phase": "train_compressed_vs_cpu", "case": name,
                  "strategy": card["strategy"], "config": "gpt2-xl width, 2 layers, float32",
                  "groups": card["G"], "pods": card["P"], "sync_delay": card["delay"],
                  "steps": steps, "warmup_steps": card["warm"],
                  "outer_syncs": card["syncs"], "per_group_batch": per, "seq_len": 64,
                  "loss_card": card["h"]["train_loss"], "loss_cpu": cpu["train_loss"],
                  "max_abs_loss_err": loss_err, "loss_tol": loss_tol,
                  "max_abs_param_err": p_err, "param_tol": param_tol,
                  "max_abs_residual": card["res_max"], "card_launches": card["launches"],
                  "expected_launches": card["expect"], "card_seconds": card["t_card"],
                  "cpu_seconds_ahead": cpu["seconds"], "waited_s": waited})
            if loss_err > loss_tol or p_err > param_tol:
                raise AssertionError(f"train_compressed_vs_cpu {name}: loss err {loss_err} "
                                     f"(limit {loss_tol}), param err {p_err} (limit "
                                     f"{param_tol})")
        return seen

    return finish


def _plain_reordered(q, k, v, *, causal=True, window=0, softcap=0.0):
    """The plain attention with P V summed over the two halves of the keys
    apart: the same function in another fp32 order, whose distance from
    ``flash_attention_ref`` is the floor of ``flash_tc_vs_plain``'s
    comparison."""
    import torch

    from repro_torch.kernels import ref as RF

    B, S, H, hd = q.shape
    s, mask = RF._scores_and_mask(q, k, causal=causal, window=window, softcap=softcap)
    probs = torch.softmax(torch.where(mask, s, RF.NEG_INF), dim=-1)
    vf, h = v.float(), k.shape[1] // 2
    out = (torch.einsum("bhgqk,bkhd->bqhgd", probs[..., :h], vf[:, :h])
           + torch.einsum("bhgqk,bkhd->bqhgd", probs[..., h:], vf[:, h:]))
    return out.reshape(B, S, H, hd).to(q.dtype)


def _leaf_errors(got, want):
    """Per gradient leaf: max error over max |value|, and relative RMS."""
    rel_max, rms = {}, {}
    for name, w in want.items():
        scale = float(w.float().abs().max())
        err = max_err(got[name], w)
        rel_max[name] = err / scale if scale > 0 else err
        rms[name] = rel_rms(got[name], w)
    return rel_max, rms


# the models of the one-step gradient comparisons, (arch, layers)
FLASH_STEP_MODELS = (("gpt2-xl", 4), ("qwen3-1.7b", 2))


def _flash_step_inputs(torch, arch: str, layers: int):
    """``arch`` at ``layers`` layers in bf16 compute and training storage,
    seeded parameters, and one seeded batch of 2 x 1024 tokens."""
    from repro_torch.configs import get_config
    from repro_torch.models import registry as R

    cfg = get_config(arch).replace(num_layers=layers)  # bf16 compute
    params = R.init_params(cfg, seed=0, device="cuda", training=True)
    toks = torch.randint(0, cfg.vocab_size, (2, 1025), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(13))
    return cfg, params, {"tokens": toks[:, :-1].cuda(), "labels": toks[:, 1:].cuda()}


def _step_grads(torch, counters, cfg, params, batch, attention):
    """One loss and backward with ``attention`` in place of
    ``kops.flash_attention`` (as ``witness_lr`` swaps it) -> (loss, {leaf:
    gradient}, launches)."""
    from repro_torch.kernels import ops as kops
    from repro_torch.models import registry as R
    from repro_torch.models.transformer import param_leaves

    kernel_attention = kops.flash_attention
    kops.flash_attention = attention
    try:
        for c in counters.values():
            c.launches = 0
        loss, _ = R.loss_fn(params, cfg, batch)
        loss.backward()
        torch.cuda.synchronize()
    finally:
        kops.flash_attention = kernel_attention
    launches = {k: c.launches for k, c in counters.items()}
    grads = {name: t.grad for name, t in param_leaves(params)}
    for _, t in param_leaves(params):
        t.grad = None
    return float(loss.detach()), grads, launches


def flash_tc_vs_plain(torch, counters):
    """GPT-2 XL width at 4 layers and Qwen3-1.7B width at 2 layers, bf16
    compute, training storage, on the card: one batch's (2 x 1024 tokens)
    loss and every gradient leaf through the tensor-core flash kernels,
    against the same step with ``kops.flash_attention`` swapped for the
    plain attention (``flash_attention_ref``, autograd). The fp32
    ``*_vs_cpu`` phases take the CUDA-core route, so this is the end-to-end
    check of the tensor-core one. Loss within 1e-3 relative; each leaf's max
    error over its max |value| within BF16_MAX_REL and its relative RMS
    within BF16_RMS_REL; every flash launch of the kernel run a tensor-core
    one, none in the plain run. The same step through ``_plain_reordered``
    is reported beside it: at initialization the query and key
    projections' gradients are small differences of near-uniform attention,
    and a one-ulp change of a few attention outputs moves them by about 1%
    (RMS), so that is the floor of this comparison (``--flash-precision``)."""
    flash = ("flash_attention", "flash_attention_bwd", "flash_attention_tc",
             "flash_attention_bwd_tc")
    for arch, layers in FLASH_STEP_MODELS:
        t0 = time.perf_counter()
        cfg, params, batch = _flash_step_inputs(torch, arch, layers)
        _step_vs_plain(torch, counters, "flash_tc_vs_plain", cfg, params, batch,
                       {k: layers for k in flash}, t0)
        del params
        free_cuda(torch)


# train_tc_vs_plain's leaves at the comparison's floor: where the plain
# attention against itself summed in another order (``_plain_reordered``)
# already differs by FLOOR_SHARE of BF16_RMS_REL or more, the kernels'
# relative RMS is held to FLOOR_MARGIN times that floor instead (Whisper's
# decoder query and key projections at initialization: floor 0.999%)
FLOOR_SHARE, FLOOR_MARGIN = 0.8, 1.25


def _rms_limits(floor_rms, at_floor):
    """Each leaf's relative RMS limit: BF16_RMS_REL, or with ``at_floor``
    FLOOR_MARGIN times the leaf's floor where that floor reaches
    FLOOR_SHARE of BF16_RMS_REL."""
    return {n: (max(BF16_RMS_REL, FLOOR_MARGIN * f)
                if at_floor and f >= FLOOR_SHARE * BF16_RMS_REL else BF16_RMS_REL)
            for n, f in floor_rms.items()}


def _step_vs_plain(torch, counters, phase, cfg, params, batch, want, t0, *,
                   at_floor=False):
    """One bf16 step's loss and every gradient leaf of ``params`` on
    ``batch`` through the flash kernels against the same step through the
    plain attention's autograd, and through ``_plain_reordered`` (the
    floor), held to ``flash_tc_vs_plain``'s limits (with ``at_floor``, a
    leaf whose floor reaches FLOOR_SHARE of the RMS limit to FLOOR_MARGIN
    times its floor); the kernel run's launches of the counters in
    ``want`` exactly those, the plain runs' none."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.ref import flash_attention_ref

    loss_tol = 1e-3
    loss_k, g_k, l_k = _step_grads(torch, counters, cfg, params, batch, kops.flash_attention)
    loss_p, g_p, l_p = _step_grads(torch, counters, cfg, params, batch, flash_attention_ref)
    _, g_r, _ = _step_grads(torch, counters, cfg, params, batch, _plain_reordered)
    rel_max, rms = _leaf_errors(g_k, g_p)
    floor_max, floor_rms = _leaf_errors(g_r, g_p)
    del g_k, g_p, g_r
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    rms_limit = _rms_limits(floor_rms, at_floor)
    at_floor_leaves = {n: {"rel_rms_err": rms[n], "floor": floor_rms[n], "limit": rms_limit[n]}
                       for n in rms if rms_limit[n] > BF16_RMS_REL}
    worst_max = max(rel_max, key=rel_max.get)
    worst_rms = max(rms, key=lambda n: rms[n] / rms_limit[n])
    L = cfg.num_layers
    layers = f"{cfg.encoder_layers} + {L}" if cfg.is_encoder_decoder else str(L)
    emit({"phase": phase,
          "config": f"{cfg.name} width, {layers} layers, bf16 compute, fp32 params",
          "batch": list(batch["tokens"].shape), "loss_kernels": loss_k, "loss_plain": loss_p,
          "loss_rel_err": loss_rel, "loss_tol": loss_tol, "leaves": len(rms),
          "max_err_over_max_abs": rel_max[worst_max], "worst_leaf_max": worst_max,
          "rel_rms_err": rms[worst_rms], "worst_leaf_rms": worst_rms,
          "tol": {"max_err_over_max_abs": BF16_MAX_REL, "rel_rms_err": BF16_RMS_REL},
          "floor_plain_reordered": {"max_err_over_max_abs": max(floor_max.values()),
                                    "rel_rms_err": max(floor_rms.values()),
                                    "worst_leaf_rms": max(floor_rms, key=floor_rms.get)},
          "rel_rms_err_by_leaf": {n: round(r, 6) for n, r in rms.items()},
          "floor_rel_rms_by_leaf": {n: round(r, 6) for n, r in floor_rms.items()},
          **({"leaves_held_to_their_floor": at_floor_leaves,
              "floor_rule": {"share": FLOOR_SHARE, "margin": FLOOR_MARGIN}}
             if at_floor else {}),
          "launches_kernels": {k: l_k[k] for k in want},
          "launches_plain": {k: l_p[k] for k in want},
          "seconds": time.perf_counter() - t0})
    if not (math.isfinite(loss_k) and loss_rel <= loss_tol):
        raise AssertionError(f"{phase} {cfg.name}: loss {loss_k} vs {loss_p}")
    if rel_max[worst_max] > BF16_MAX_REL or rms[worst_rms] > rms_limit[worst_rms]:
        raise AssertionError(f"{phase} {cfg.name}: gradient {worst_max} "
                             f"{rel_max[worst_max]}, {worst_rms} rms {rms[worst_rms]}")
    if {k: l_k[k] for k in want} != want or any(l_p[k] for k in want):
        raise AssertionError(f"{phase} {cfg.name}: launches {l_k} / {l_p}")
    return l_k


def train_tc_vs_plain(torch, counters):
    """One bf16 training step of RecurrentGemma-9B at full width with 3
    layers (2 x 1024 tokens; its local attention through the hd-256
    tensor-core forward and the CUDA-core backward) and of Whisper-large-v3
    with 2 + 2 layers (2 x 448 tokens over 2 x 1 500 frames; the encoder,
    the decoder and the cross-attention over keys of another length
    through the tensor-core forward and backward), each against the same
    step through the plain attention's autograd (``_step_vs_plain``,
    ``flash_tc_vs_plain``'s limits): the only bf16 check of the cross
    backward and of the hd-256 backward. Whisper's decoder query and key
    projections sit at the comparison's floor at initialization (the plain
    attention against itself reordered: 0.999% RMS on an H100, against a
    limit of 1%), so its leaves are held to their floor where it reaches
    80% of the limit (``FLOOR_SHARE``). Returns the kernel runs'
    launches."""
    from repro_torch.configs import get_config
    from repro_torch.models import registry as R

    runs = []
    t0 = time.perf_counter()
    cfg, params, batch = _flash_step_inputs(torch, "recurrentgemma-9b", 3)
    runs.append(_step_vs_plain(torch, counters, "train_tc_vs_plain", cfg, params, batch,
                               {"flash_attention": 1, "flash_attention_bwd": 1,
                                "flash_attention_tc": 1, "flash_attention_bwd_tc": 0}, t0))
    del params, batch
    free_cuda(torch)
    t0 = time.perf_counter()
    cfg = get_config(WHISPER).replace(num_layers=2, encoder_layers=2)  # bf16 compute
    params = R.init_params(cfg, seed=0, device="cuda", training=True)
    batch = _whisper_train_inputs(torch, cfg, WHISPER_TC_BATCH)
    want = {k: n for k, n in whisper_train_launches(cfg, steps=1, tc=True).items()
            if k.startswith("flash")}
    runs.append(_step_vs_plain(torch, whisper_counters(counters), "train_tc_vs_plain", cfg,
                               params, batch, want, t0, at_floor=True))
    del params, batch
    free_cuda(torch)
    return runs


def _hand_backward(fault: str):
    """The plain attention forward with a backward written out by hand
    (``flash_attention_bwd_ref``, the FlashAttention-2 algebra in fp32):
    ``"none"`` takes D = rowsum(dO O) from the unrounded fp32 output (a
    correct backward), ``"d_from_o"`` from the bf16 output the forward
    returns (the D that the tensor-core backward's header rejects), and
    ``"drop_tile"`` also drops dK and dV of the last 64-key tile (a
    backward whose key grid stops one tile short). A function to put in
    place of ``kops.flash_attention``."""
    import torch

    from repro_torch.kernels import ref as RF

    class Fn(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, causal, window, softcap):
            out32 = RF.flash_attention_ref(q.float(), k.float(), v.float(), causal=causal,
                                           window=window, softcap=softcap)
            _, lse = RF.flash_attention_fwd_ref(q, k, v, causal=causal, window=window,
                                                softcap=softcap)
            out = out32.to(q.dtype)
            ctx.save_for_backward(q, k, v, out if fault == "d_from_o" else out32, lse)
            ctx.mask = (causal, window, softcap)
            return out

        @staticmethod
        def backward(ctx, dout):
            q, k, v, out, lse = ctx.saved_tensors
            causal, window, softcap = ctx.mask
            dq, dk, dv = RF.flash_attention_bwd_ref(q, k, v, out, lse, dout, causal=causal,
                                                    window=window, softcap=softcap)
            if fault == "drop_tile":
                last = (k.shape[1] - 1) // 64 * 64
                dk[:, last:] = 0
                dv[:, last:] = 0
            return dq, dk, dv, None, None, None

    def attention(q, k, v, *, causal=True, window=0, softcap=0.0):
        return Fn.apply(q, k, v, causal, window, softcap)

    return attention


HAND_BACKWARDS = ("none", "d_from_o", "drop_tile")


def train_tc_floor_rule(torch, counters):
    """What ``train_tc_vs_plain``'s floor rule (FLOOR_SHARE, FLOOR_MARGIN)
    lets through, on its Whisper step (2 + 2 layers, bf16 compute, 2 x 448
    tokens over 2 x 1 500 frames): the plain attention's autograd, its
    reordered floor, and each of HAND_BACKWARDS (``_hand_backward``) in
    place of the kernels. For each: the loss error, the leaves past
    BF16_MAX_REL, and those past their RMS limit under the rule and under
    the fixed BF16_RMS_REL. Reported, not held."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.ref import flash_attention_ref
    from repro_torch.models import registry as R

    t0 = time.perf_counter()
    cfg = get_config(WHISPER).replace(num_layers=2, encoder_layers=2)  # bf16 compute
    params = R.init_params(cfg, seed=0, device="cuda", training=True)
    batch = _whisper_train_inputs(torch, cfg, WHISPER_TC_BATCH)
    cnt = whisper_counters(counters)
    loss_p, g_p, _ = _step_grads(torch, cnt, cfg, params, batch, flash_attention_ref)
    _, g_r, _ = _step_grads(torch, cnt, cfg, params, batch, _plain_reordered)
    _, floor_rms = _leaf_errors(g_r, g_p)
    del g_r
    limit = _rms_limits(floor_rms, True)
    readings = {}
    for fault in HAND_BACKWARDS:
        loss_m, g_m, _ = _step_grads(torch, cnt, cfg, params, batch, _hand_backward(fault))
        rel_max, rms = _leaf_errors(g_m, g_p)
        del g_m
        worst = max(rms, key=lambda n: rms[n] / limit[n])
        readings[fault] = {
            "loss_rel_err": abs(loss_m - loss_p) / abs(loss_p),
            "max_err_over_max_abs": max(rel_max.values()),
            "worst_leaf_rms": worst, "rel_rms_err": rms[worst], "its_limit": limit[worst],
            "its_floor": floor_rms[worst],
            "leaves_past_max": sorted(n for n in rel_max if rel_max[n] > BF16_MAX_REL),
            "leaves_past_rule": sorted(n for n in rms if rms[n] > limit[n]),
            "leaves_past_fixed_limit": sorted(n for n in rms if rms[n] > BF16_RMS_REL),
            "caught": any(rel_max[n] > BF16_MAX_REL or rms[n] > limit[n] for n in rms)}
    emit({"phase": "train_tc_floor_rule",
          "config": f"{cfg.name} width, {cfg.encoder_layers} + {cfg.num_layers} layers, "
                    f"bf16 compute, fp32 params",
          "batch": list(batch["tokens"].shape),
          "floor_rule": {"share": FLOOR_SHARE, "margin": FLOOR_MARGIN},
          "leaves_held_to_their_floor": sorted(n for n in limit if limit[n] > BF16_RMS_REL),
          "hand_backwards": readings, "seconds": time.perf_counter() - t0})
    del params, batch, g_p
    free_cuda(torch)


def _prefill_vs_plain(torch, counters, phase: str, cfg, shapes, kernel: str, **extra):
    """``cfg`` in bf16 serving storage, random seeded weights: one prefill
    (``registry.prefill``) of each (B, S) in ``shapes`` through the flash
    kernel, against the same prefill with ``kops.flash_attention`` swapped
    for the plain attention (``flash_attention_ref``), as
    ``flash_tc_vs_plain`` swaps it. Every position's logits within
    BF16_MAX_REL of max |logit| and within a relative RMS of BF16_RMS_REL;
    one flash launch an attention layer, each on the tensor-core kernel
    whose counter is ``FK.<kernel>_launches``, and none in the plain run
    (an encoder-decoder's prefill, over seeded frames, launches once an
    encoder layer and twice a decoder layer, its cross-attention's counted
    by ``cross``). Reported beside it, not checked: the same distance for
    the plain attention in another fp32 order (``_plain_reordered``), the
    floor. One line per shape, ``extra`` added to it."""
    from repro_torch.kernels import flash_attention as FK
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.ref import flash_attention_ref
    from repro_torch.models import registry as R

    t0 = time.perf_counter()
    params = R.init_params(cfg, seed=0, device="cuda")
    layers = _kind_count(cfg, "attn") + _kind_count(cfg, "local_attn")
    want_launches = [layers] * 3
    if cfg.is_encoder_decoder:
        flash = cfg.encoder_layers + 2 * layers
        want_launches = [flash, flash, layers]
    batch = {}

    def prefill(tokens, attention):
        kernel_attention = kops.flash_attention
        kops.flash_attention = attention
        try:
            for c in counters.values():
                c.launches = 0
            setattr(FK, kernel + "_launches", 0)
            with torch.no_grad():
                logits, _ = R.prefill(params, cfg, {**batch, "tokens": tokens},
                                      max_len=tokens.shape[1])
            torch.cuda.synchronize()
        finally:
            kops.flash_attention = kernel_attention
        launches = {k: counters[k].launches for k in ("flash_attention", "flash_attention_tc")}
        launches["flash_attention_" + kernel] = getattr(FK, kernel + "_launches")
        return logits, launches

    for B, S in shapes:
        toks = torch.randint(0, cfg.vocab_size, (B, S), dtype=torch.int32,
                             generator=torch.Generator().manual_seed(31)).cuda()
        if cfg.is_encoder_decoder:
            batch["frames"] = whisper_frames(torch, cfg, B, "cuda", 32)
        got, l_k = prefill(toks, kops.flash_attention)
        want, l_p = prefill(toks, flash_attention_ref)
        scale = float(want.abs().max())
        rel_max, rms = max_err(got, want) / scale, rel_rms(got, want)
        finite = bool(torch.isfinite(got).all()) and got.shape == (B, S, cfg.vocab_size)
        del got
        floor, _ = prefill(toks, _plain_reordered)
        emit({"phase": phase,
              "config": f"{cfg.name} width, {cfg.num_layers} layers "
                        f"{[cfg.block_kind(i) for i in range(cfg.num_layers)]}, bf16",
              "batch": [B, S], **extra, "max_abs_logit": scale,
              "max_err_over_max_abs": rel_max, "rel_rms_err": rms,
              "tol": {"max_err_over_max_abs": BF16_MAX_REL, "rel_rms_err": BF16_RMS_REL},
              "floor_plain_reordered": {"max_err_over_max_abs": max_err(floor, want) / scale,
                                        "rel_rms_err": rel_rms(floor, want)},
              "launches_kernels": l_k, "launches_plain": l_p,
              "t_phase_s": time.perf_counter() - t0})
        del want, floor
        if not (finite and rel_max <= BF16_MAX_REL and rms <= BF16_RMS_REL):
            raise AssertionError(f"{phase} {B}x{S}: logits {rel_max} of max, "
                                 f"rel rms {rms}, finite and shaped: {finite}")
        if list(l_k.values()) != want_launches or any(l_p.values()):
            raise AssertionError(f"{phase} {B}x{S}: launches {l_k} / {l_p}")
    del params
    free_cuda(torch)


def flash_tc256_vs_plain(torch, counters):
    """RecurrentGemma-9B at full width with 3 layers (one rglru / rglru /
    local_attn cycle), bf16: prefills of 4 x 512 and 1 x 2304 (its window of
    2048 active) through the hd-256 tensor-core flash kernel against the
    plain attention (``_prefill_vs_plain``): the bf16 end-to-end check of
    that kernel, which the fp32 ``recurrent_vs_cpu`` does not take."""
    from repro_torch.configs import get_config

    cfg = get_config("recurrentgemma-9b").replace(num_layers=3)
    _prefill_vs_plain(torch, counters, "flash_tc256_vs_plain", cfg, ((4, 512), (1, 2304)),
                      "tc256", local_window=cfg.local_window)


def flash_tc112_vs_plain(torch, counters):
    """Kimi-K2 at full width with 1 layer, its leading dense layer (GQA 64 /
    8 at hd 112 and the 18 432-wide SwiGLU; untied, 2.86 B parameters,
    5.7 GB in bf16 serving storage), bf16: prefills of 4 x 512 and 1 x 512
    (one ``serve_moe`` prefill) through the hd-112 tensor-core flash kernel
    against the plain attention (``_prefill_vs_plain``): the bf16
    end-to-end check of that kernel, which the fp32 ``moe_vs_cpu`` does not
    take. The MoE layer is left out: with 384 experts a bf16 near-tie in the
    top-8 routing can flip between two correct attentions, and the
    comparison would then measure the router, not the kernel."""
    from repro_torch.configs import get_config

    cfg = get_config("kimi-k2-1t-a32b").replace(num_layers=1)
    _prefill_vs_plain(torch, counters, "flash_tc112_vs_plain", cfg, ((4, 512), (1, 512)),
                      "tc112")


def whisper_tc_vs_plain(torch, counters):
    """Whisper-large-v3 at full width with 2 encoder and 2 decoder layers,
    bf16: a prefill of 4 prompts of 64 over 4 x 1 500 frames through the
    tensor-core flash kernel (the encoder non-causal, the decoder causal,
    the cross-attention over keys of another length) against the plain
    attention (``_prefill_vs_plain``): the bf16 end-to-end check of the
    cross route, which the fp32 ``whisper_vs_cpu`` does not take."""
    from repro_torch.configs import get_config

    cfg = get_config(WHISPER).replace(num_layers=2, encoder_layers=2)
    _prefill_vs_plain(torch, counters, "whisper_tc_vs_plain", cfg, ((4, 64),), "cross",
                      frames=cfg.encoder_seq_len)


def flash_precision(torch, counters):
    """``--flash-precision``: ``flash_tc_vs_plain``'s step through other
    attentions, each against the plain attention: the plain one in another
    fp32 order (the floor), the tensor-core kernels, their forward with the
    plain backward and the plain forward with their backward, the CUDA-core
    kernels, and F.scaled_dot_product_attention (a yardstick the port never
    calls). One line per model and attention: the worst leaf's relative RMS
    and max error over max |value|."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as FK
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.ref import flash_attention_fwd_ref, flash_attention_ref

    class TcForwardPlainBackward(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v):
            ctx.save_for_backward(q, k, v)
            return FK._launch_fwd(q, k, v, True, 0, 0.0, want_lse=False)[0]

        @staticmethod
        def backward(ctx, do):
            ins = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            with torch.enable_grad():
                return torch.autograd.grad(flash_attention_ref(*ins, causal=True), ins, do)

    class PlainForwardTcBackward(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v):
            out, lse = flash_attention_fwd_ref(q, k, v, causal=True)
            out = out.contiguous()
            ctx.save_for_backward(q, k, v, out, lse.contiguous())
            return out

        @staticmethod
        def backward(ctx, do):
            return FK._launch_bwd(*ctx.saved_tensors, do.contiguous(), True, 0, 0.0)

    class CudaCores(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v):
            B, S, H, _ = q.shape
            lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
            out = _core_fwd(torch, q, k, v, lse)
            ctx.save_for_backward(q, k, v, out, lse)
            return out

        @staticmethod
        def backward(ctx, do):
            return _core_bwd(torch, *ctx.saved_tensors, do.contiguous())

    def sdpa(q, k, v, causal=True, window=0, softcap=0.0):
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=True,
            enable_gqa=q.shape[2] != k.shape[2]).transpose(1, 2)

    def fn(cls):
        return lambda q, k, v, causal=True, window=0, softcap=0.0: cls.apply(q, k, v)

    attentions = {"plain_reordered": _plain_reordered, "tensor_cores": kops.flash_attention,
                  "tc_forward_plain_backward": fn(TcForwardPlainBackward),
                  "plain_forward_tc_backward": fn(PlainForwardTcBackward),
                  "cuda_cores": fn(CudaCores), "sdpa": sdpa}
    for arch, layers in FLASH_STEP_MODELS:
        cfg, params, batch = _flash_step_inputs(torch, arch, layers)
        _, plain, _ = _step_grads(torch, counters, cfg, params, batch, flash_attention_ref)
        for name, attention in attentions.items():
            _, grads, _ = _step_grads(torch, counters, cfg, params, batch, attention)
            rel_max, rms = _leaf_errors(grads, plain)
            worst = max(rms, key=rms.get)
            emit({"phase": "flash_precision", "config": f"{cfg.name} width, {layers} layers, "
                  "bf16 compute", "attention": name, "worst_leaf_rms": worst,
                  "rel_rms_err": rms[worst], "max_err_over_max_abs": max(rel_max.values())})
            del grads
        del params, plain
        free_cuda(torch)


def _timed(torch, times, kind, fn):
    def call(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        times.setdefault(kind, []).append(1e3 * (time.perf_counter() - t0))
        return out
    return call


def train(torch, counters, *, phase: str = "train", outer_comm=None,
          arch: str = "gpt2-xl", cut=None, steps: int = 10, schedule=None,
          seq: int = 1024, val_rows: int = 16, groups: int = 2):
    """Full ``arch`` (GPT-2 XL by default; ``cut``, a dict of config fields
    such as ``num_layers``, cuts it) through SimulatedRun on the card at
    per-group batch 2 x ``seq``; returns the run and its line.
    ``outer_comm`` (an ``OuterCommConfig``) picks the outer strategy; the
    default is the flat fp32 mean. ``schedule``: TrainConfig fields in
    place of ``TRAIN_TC`` and ``TRAIN_LR``. The LR each step took must be
    the schedule's ``lr_at``. The validation loss is taken on the
    simulator's fixed batch of ``val_rows`` sequences. ``groups``: G (with
    ``optimizer="adamw"`` in ``schedule``, the reference's AdamW baseline,
    one replica on the global batch of ``groups`` x 2 sequences)."""
    from repro_torch.config import OuterCommConfig, TrainConfig
    from repro_torch.configs import get_config
    from repro_torch.core.simulate import SimulatedRun
    from repro_torch.models.transformer import param_leaves
    from repro_torch.optim.schedules import lr_at

    cfg = get_config(arch).replace(**(cut or {}))  # bf16 compute, fp32 parameters
    G, per = groups, 2
    tc = TrainConfig(**(schedule or {**TRAIN_TC, **TRAIN_LR}), global_batch_size=G * per,
                     seq_len=seq, sync_delay=0, outer_comm=outer_comm or OuterCommConfig())
    t0 = time.perf_counter()
    mem_at_start = torch.cuda.memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    run = SimulatedRun(cfg, tc, num_groups=G, seed=0, device="cuda", val_rows=val_rows)
    n_leaves = len(param_leaves(run.state.params))
    n_params = sum(t.numel() for _, t in param_leaves(run.state.params))
    t_init = time.perf_counter() - t0
    val_before = run.val_loss(run.state.params)  # fixed batch: val_rows x seq tokens
    times = {}
    for name, kind in (("_warmup_step", "warmup_step"), ("_inner_step", "inner_step"),
                       ("_accumulate", "accumulate"), ("_dispatch", "outer_dispatch"),
                       ("_apply", "outer_apply")):
        setattr(run, name, _timed(torch, times, kind, getattr(run, name)))
    for c in counters.values():
        c.launches = 0
    t1 = time.perf_counter()
    hist = run.run(steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = {k: c.launches for k, c in counters.items()}
    val_after = run.val_loss(run.state.params)
    expect, warm, syncs = _train_expect(run, steps, n_leaves)
    tokens_warm, tokens_inner = G * per * seq, G * per * seq
    # steady inner step: skip the first (allocator and cuBLAS warm-up)
    inner = times.get("inner_step", [])
    inner_ss = inner[1:] if len(inner) > 1 else inner
    line = {
        "phase": phase,
        "config": f"{cfg.name} {cfg.num_layers} layers, bf16 compute, fp32 params",
        **({"cut": cut} if cut else {}), "val_rows": val_rows,
        "strategy": run.strategy.name, "params": n_params, "leaves": n_leaves, "groups": G,
        "optimizer": tc.optimizer,
        "per_group_batch": per,
        "seq_len": seq, "sync_delay": 0, "steps": steps, "warmup_steps": warm,
        "outer_syncs": syncs, "init_s": t_init, "wall_s": wall,
        "warmup_step_ms": times.get("warmup_step", []), "inner_step_ms": inner,
        "inner_step_ms_p50": statistics.median(inner_ss) if inner_ss else None,
        "accumulate_ms": times.get("accumulate", []),
        "outer_dispatch_ms": times.get("outer_dispatch", []),
        "outer_apply_ms": times.get("outer_apply", []),
        "tokens_per_s_inner": (tokens_inner / (statistics.median(inner_ss) / 1e3)
                               if inner_ss else None),
        "tokens_per_s_run": (warm * tokens_warm + (steps - warm) * tokens_inner) / wall,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "mem_at_start_gib": mem_at_start,
        "inner_lr": tc.inner_lr, "lr_schedule": tc.lr_schedule, "lr": hist["lr"],
        "loss": hist["train_loss"],
        "val_loss_before": val_before, "val_loss_after": val_after,
        "launches": launches, "expected_launches": expect,
    }
    emit(line)
    want_lr = [float(lr_at(tc, s)) for s in range(steps)]
    if hist["lr"] != want_lr:
        raise AssertionError(f"{phase}: the run's LR {hist['lr']} != lr_at's {want_lr}")
    loss = hist["train_loss"] + [val_before, val_after]
    if not all(math.isfinite(x) for x in loss):
        raise AssertionError(f"{phase}: non-finite loss {loss}")
    if not val_after < val_before:  # on one fixed batch, so no batch noise
        raise AssertionError(f"{phase}: validation loss did not fall: {val_before} -> "
                             f"{val_after}")
    if launches != expect:
        raise AssertionError(f"{phase} launch counters {launches} != expected {expect}")
    return run, line


# train_moe's cut: DeepSeek-V2-236B at full width with 2 layers (the dense
# one and one MoE layer) and 8 of its 160 experts (top-6 and the 2 shared
# kept): 1.772 B parameters, about 64 GB of fp32 parameters, one group's
# gradients, two groups' AdamW moments and the outer anchor and momentum
# at G = 2 (16 experts would need about 71 GB before the activations)
MOE_TRAIN_CUT = {"num_layers": 2, "num_experts": 8}


def train_moe(torch, counters, *, profile: bool = False):
    """DeepSeek-V2-236B through ``SimulatedRun`` on the card (``train`` at
    G = 2, per-group batch 2 x 512, 8 steps of the ``train`` schedule: lazy
    start, then the flat sync's outer applies), bf16 compute and fp32
    parameters and state, and with ``profile`` one inner step's device time
    by kernel group (``train_moe_breakdown``); the validation loss on 4
    sequences (16 of 512 with MLA's (16, 128, 512, 512) fp32 scores would
    not fit beside the state). Returns the train line."""
    run, line = train(torch, counters, phase="train_moe", arch="deepseek-v2-236b", steps=8,
                      seq=512, cut=MOE_TRAIN_CUT, val_rows=4)
    if profile:
        train_breakdown(torch, run, phase="train_moe_breakdown",
                        group_of=_moe_train_kernel_group)
    del run
    free_cuda(torch)
    return line


# train_recurrent: (arch, cut, TrainConfig fields beside the train schedule,
# G) at full width. RecurrentGemma-9B at 3 layers has 2.60 B parameters (its
# untied 256 000-row tables hold 2.10 B): Pier's state at G = 2 would take
# about 94 GB in fp32, and with bf16 moments and outer state (65 GB) the
# outer dispatch's fp32 targets and per-leaf stacks outgrow the card, so
# it runs the simulator's AdamW baseline (the reference's
# ``optimizer="adamw"``: one replica, 2 x 512 a step; 50 GB of parameters,
# moments and the unused outer state); Pier at G = 2 waits for sharding, as
# Kimi-K2's training does. xLSTM-1.3B at 8 layers (one 7:1 cycle, 0.50 B)
# runs Pier at G = 2.
RECURRENT_TRAIN_CUTS = (("recurrentgemma-9b", {"num_layers": 3}, {"optimizer": "adamw"}, 1),
                        ("xlstm-1.3b", {"num_layers": 8}, {}, 2))


def train_recurrent(torch, counters, *, profile: bool = False):
    """RecurrentGemma-9B and xLSTM-1.3B through ``SimulatedRun`` on the card
    (``train``, per-group batch 2 x 512, 8 steps of the ``train`` schedule;
    xLSTM at G = 2: 4 lazy-start steps, then two outer syncs; RecurrentGemma
    on the AdamW baseline, RECURRENT_TRAIN_CUTS says why), bf16 compute and
    fp32 parameters and state: the validation loss must fall, launches
    exact (RecurrentGemma's flash forward on the hd-256 tensor-core kernel,
    its backward on the CUDA cores). With ``profile``, one inner step's
    device time by kernel group beside its wall time (``train_breakdown``):
    the RG-LRU scan and the sLSTM loop are plain PyTorch issued by the
    host, step by step in sLSTM's forward and backward, so the idle share
    says how far the host holds the card back (xLSTM's 113 000 kernels a
    step take the profiler about 30 s). RecurrentGemma's validation loss
    is taken on 4 sequences (its 256 000-row logits). Returns the train
    lines."""
    from repro_torch.kernels import flash_attention as FK

    lines = []
    for arch, cut, fields, groups in RECURRENT_TRAIN_CUTS:
        cnt = counters
        if arch.startswith("recurrentgemma"):  # its bf16 hd-256 forward's own counter
            cnt = {**counters, "flash_attention_tc256": Counter(FK, "tc256_launches")}
        run, line = train(torch, cnt, phase="train_recurrent", arch=arch, cut=cut, steps=8,
                          seq=512, val_rows=4 if arch.startswith("recurrentgemma") else 16,
                          schedule={**TRAIN_TC, **TRAIN_LR, **fields}, groups=groups)
        line["run"] = f"train_recurrent_{arch}"  # its key in the kernels line's counts
        if profile:
            train_breakdown(torch, run, phase="train_recurrent_breakdown")
        del run
        free_cuda(torch)
        lines.append(line)
    return lines


WHISPER_TRAIN_STEPS = 6
WHISPER_TRAIN_LR = 1e-4


def _whisper_train_inputs(torch, cfg, shape):
    """One seeded batch of ``shape`` = (B, S) tokens, their next tokens as
    labels, and B seeded frame sequences, on the card."""
    B, S = shape
    toks = torch.randint(0, cfg.vocab_size, (B, S + 1), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(29))
    return {"tokens": toks[:, :-1].cuda(), "labels": toks[:, 1:].cuda(),
            "frames": whisper_frames(torch, cfg, B, "cuda", 30)}


def train_whisper(torch, counters):
    """Whisper-large-v3 at full width and depth (32 encoder + 32 decoder
    layers, 1.68 B parameters), bf16 compute, fp32 parameters and AdamW
    moments (about 27 GB): 6 steps of ``loss_fn``'s gradient and an AdamW
    update (the reference's smoke step, ``tests/test_models_smoke.py``; its
    batches carry frames, which the simulator's and the Trainer's do not)
    on one fixed batch of 2 x 448 tokens over 2 x 1 500 frames, at a
    constant LR of 1e-4. The loss must fall; launches exact (96 flash
    forwards and backwards a step on the tensor cores, 32 of each over keys
    of another length). Then one more step profiled: device ms by kernel
    group beside its wall ms, and the flash backward's share of the device
    time. Returns the line."""
    from repro_torch.config import TrainConfig
    from repro_torch.configs import get_config
    from repro_torch.models import registry as R
    from repro_torch.models.transformer import param_leaves
    from repro_torch.optim.adamw import adamw_init, adamw_update
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    steps = WHISPER_TRAIN_STEPS
    cfg = get_config(WHISPER)  # bf16 compute, fp32 parameters
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = R.init_params(cfg, seed=0, device="cuda", training=True)
    leaves = param_leaves(params)
    tc = TrainConfig(total_steps=steps, inner_lr=WHISPER_TRAIN_LR)
    opt = adamw_init(leaves, tc)
    batch = _whisper_train_inputs(torch, cfg, (2, WHISPER_TOKENS))
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0

    def step():
        loss, _ = R.loss_fn(params, cfg, batch)
        loss.backward()
        adamw_update([t.grad for _, t in leaves], opt, leaves, tc, WHISPER_TRAIN_LR)
        for _, t in leaves:
            t.grad = None
        return loss.detach()

    wc = whisper_counters(counters)
    for c in wc.values():
        c.launches = 0
    losses, step_ms = [], []
    for _ in range(steps):
        t1 = time.perf_counter()
        losses.append(float(step()))
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t1))
    launches = {k: c.launches for k, c in wc.items()}
    expect = whisper_train_launches(cfg, steps=steps, tc=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        losses.append(float(step()))
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t1)
    groups, n_kernels = {}, 0
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            grp = _train_kernel_group(evt.name)
            groups[grp] = groups.get(grp, 0.0) + evt.time_range.elapsed_us() / 1e3
            n_kernels += 1
    busy = sum(groups.values())
    n_params = sum(t.numel() for _, t in leaves)
    p50 = statistics.median(step_ms[1:])
    line = {"phase": "train_whisper",
            "config": f"{cfg.name} {cfg.encoder_layers} + {cfg.num_layers} layers, bf16 "
                      f"compute, fp32 params and AdamW moments",
            "params": n_params, "leaves": len(leaves), "batch": [2, WHISPER_TOKENS],
            "frames": cfg.encoder_seq_len, "lr": WHISPER_TRAIN_LR, "steps": steps,
            "init_s": t_init, "step_ms": step_ms, "step_ms_p50": p50,
            "tokens_per_s": 2 * WHISPER_TOKENS / (p50 / 1e3),
            "frames_per_s": 2 * cfg.encoder_seq_len / (p50 / 1e3),
            "loss": losses, "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "profiled_step": {
                "wall_ms": wall, "device_ms": busy if n_kernels else "not measured",
                "device_idle_share": 1 - busy / wall if n_kernels else "not measured",
                "device_ms_by_group": groups,
                "flash_bwd_share_of_device": (groups.get("flash_attention_bwd", 0.0) / busy
                                              if n_kernels else "not measured")},
            "launches": launches, "expected_launches": expect}
    emit(line)
    del params, opt, leaves, batch
    free_cuda(torch)
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train_whisper: non-finite loss {losses}")
    if not losses[steps - 1] < losses[0]:  # one fixed batch, so no batch noise
        raise AssertionError(f"train_whisper: the loss did not fall: {losses}")
    if launches != expect:
        raise AssertionError(f"train_whisper: launches {launches} != {expect}")
    return line


def _train_kernel_group(name: str) -> str:
    for key, group in (("flash_bwd", "flash_attention_bwd"), ("flash_fwd", "flash_attention"),
                       ("pier_update", "pier_update"), ("rmsnorm_fwd", "rmsnorm"),
                       ("rmsnorm_bwd", "rmsnorm_bwd"), ("rmsnorm_colsum", "rmsnorm_bwd")):
        if key in name:
            return group
    if any(k in name.lower() for k in ("gemm", "gemv", "nvjet", "xmma", "cutlass")):
        return "matmul"
    return "adamw_and_other"


def _moe_train_kernel_group(name: str) -> str:
    """``train_moe_breakdown``'s groups: the dispatch's sort, scatter and
    gather (the embedding's gather and its backward stay with the
    elementwise work), the fp32 products (the lm_head's fp32 logits, MLA's
    einsums, the router) apart from the bf16 ones, the softmax kernels
    (MLA's scores, the router's)."""
    low = name.lower()
    if "embedding" in low:
        return "adamw_and_elementwise"
    for key, group in (("rmsnorm_fwd", "rmsnorm"), ("rmsnorm_bwd", "rmsnorm_bwd"),
                       ("rmsnorm_colsum", "rmsnorm_bwd"), ("pier_update", "pier_update"),
                       ("softmax", "softmax"), ("sort", "moe_dispatch"),
                       ("scatter", "moe_dispatch"), ("gather", "moe_dispatch"),
                       ("index", "moe_dispatch"), ("searchsorted", "moe_dispatch")):
        if key in low:
            return group
    if any(k in low for k in ("gemm", "gemv", "nvjet", "xmma", "cutlass")):
        fp32 = any(k in low for k in ("sgemm", "f32f32", "simt"))
        return "matmul_fp32" if fp32 else "matmul"
    return "adamw_and_elementwise"


def train_breakdown(torch, run, phase: str = "train_breakdown", group_of=None):
    """Device time by kernel group (``group_of``, by default
    ``_train_kernel_group``) for one inner step of a train run (both
    groups' forward, backward, clip and AdamW; on the AdamW baseline the
    one replica's step), beside the wall time of another, unprofiled one;
    the idle share is one minus their ratio. The ten kernels that took the
    most time are listed by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step = run.state.step
    if run.state.group_params is None:  # the AdamW baseline: one replica
        batch = run._to_device(run._global_batch(step))

        def inner():
            run._warmup_step(batch, step)
    else:
        batches = [run._to_device(b) for b in run._group_batches(step)]

        def inner():
            run._inner_step(batches, step)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    inner()
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        inner()
        torch.cuda.synchronize()
    group_of = group_of or _train_kernel_group
    groups, by_name, n_kernels = {}, {}, 0
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            grp = group_of(evt.name)
            ms = evt.time_range.elapsed_us() / 1e3
            groups[grp] = groups.get(grp, 0.0) + ms
            by_name[evt.name] = by_name.get(evt.name, 0.0) + ms
            n_kernels += 1
    busy = sum(groups.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    mc = run.mc
    emit({"phase": phase,
          "config": f"{mc.name} {mc.num_layers} layers, G={run.G}, per-group batch "
                    f"{run.tc.global_batch_size // run.G} x {run.tc.seq_len}, one inner step",
          "wall_ms": wall, "device_ms": busy if n_kernels else "not measured",
          "device_idle_share": 1 - busy / wall if n_kernels else "not measured",
          "kernels_per_step": n_kernels, "device_ms_by_group": groups,
          "top_kernels_ms": [[name[:120], ms, group_of(name)] for name, ms in top]})


def _dispatch_kernel_group(name: str) -> str:
    for key, group in (("dequantize", "dequantize_blockwise"),
                       ("quantize_blockwise", "quantize_blockwise"),
                       ("pier_update", "pier_update")):
        if key in name:
            return group
    return "elementwise_and_copies"


def dispatch_breakdown(torch, run, phase: str):
    """Device time by kernel group of one more outer dispatch of a finished
    train run, beside the wall time of another, unprofiled one; the idle
    share is one minus their ratio. Each dispatch advances the run's outer
    state in place, as the run's own do."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models.transformer import param_leaves

    st = run.state
    groups = [[t for _, t in param_leaves(g)] for g in st.group_params]

    def once():
        _, st.outer = run.strategy.sim_dispatch(groups, st.outer, run.tc, mu=0.9, lr=0.7,
                                                num_pods=run.P, inplace=run._inplace_outer)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    once()
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        once()
        torch.cuda.synchronize()
    by_group, n_kernels = {}, 0
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            grp = _dispatch_kernel_group(evt.name)
            by_group[grp] = by_group.get(grp, 0.0) + evt.time_range.elapsed_us() / 1e3
            n_kernels += 1
    busy = sum(by_group.values())
    emit({"phase": f"{phase}_dispatch_breakdown", "strategy": run.strategy.name,
          "config": "gpt2-xl 48 layers, G=2, one outer dispatch (484 leaves)",
          "wall_ms": wall, "device_ms": busy if n_kernels else "not measured",
          "device_idle_share": 1 - busy / wall if n_kernels else "not measured",
          "kernels_per_dispatch": n_kernels, "device_ms_by_group": by_group})


# ---------------------------------------------------------------------------
# studies, run only when asked for by an argument
# ---------------------------------------------------------------------------


def witness_lr(torch, counters):
    """``--witness-lr``: the ``train`` phase's run, at ``TrainConfig``'s
    default inner LR (Table I's 4e-4, 2% LR warmup) and at the phase's own
    (``TRAIN_LR``), each twice from the same seed and batches: once through
    the attention kernels, once through autograd of the plain attention
    (``flash_attention_ref`` on the card, about 17 GB more of saved
    activations). A loss that rises without the kernels too is the LR's; two
    runs that part only where the loss rises differ by rounding that an
    unstable step amplifies, not by a kernel fault."""
    from repro_torch.config import TrainConfig
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.ref import flash_attention_ref

    cfg = get_config("gpt2-xl")
    G, per, seq, steps = 2, 2, 1024, 10
    kernel_attention = kops.flash_attention
    try:
        for lr in ({}, TRAIN_LR):
            tc = TrainConfig(**TRAIN_TC, **lr, global_batch_size=G * per, seq_len=seq,
                             sync_delay=0)
            _witness_pair(torch, counters, cfg, tc, G, per, seq, steps,
                          {"kernels": kernel_attention, "plain": flash_attention_ref})
    finally:
        kops.flash_attention = kernel_attention


def _witness_pair(torch, counters, cfg, tc, G, per, seq, steps, attentions):
    from repro_torch.core.simulate import SimulatedRun
    from repro_torch.kernels import ops as kops

    losses = {}
    for attention, fn in attentions.items():
        kops.flash_attention = fn
        torch.cuda.reset_peak_memory_stats()
        run = SimulatedRun(cfg, tc, num_groups=G, seed=0, device="cuda")
        val_before = run.val_loss(run.state.params)
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        hist = run.run(steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: c.launches for k, c in counters.items()}
        val_after = run.val_loss(run.state.params)
        losses[attention] = hist["train_loss"]
        emit({"phase": "witness_lr", "attention": attention,
              "config": "gpt2-xl 48 layers, bf16 compute, fp32 params",
              "groups": G, "per_group_batch": per, "seq_len": seq, "steps": steps,
              "inner_lr": tc.inner_lr, "lr_warmup_frac": tc.lr_warmup_frac,
              "loss": hist["train_loss"], "val_loss_before": val_before,
              "val_loss_after": val_after, "wall_s": wall,
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
              "launches": launches})
        flash = launches["flash_attention"] + launches["flash_attention_bwd"]
        if (flash == 0) != (attention == "plain"):
            raise AssertionError(f"witness_lr {attention}: flash launches {launches}")
        del run
        torch.cuda.empty_cache()
    diff = [abs(a - b) for a, b in zip(losses["kernels"], losses["plain"])]
    emit({"phase": "witness_lr", "inner_lr": tc.inner_lr,
          "abs_loss_diff_kernels_vs_plain": diff, "max_abs_loss_diff": max(diff)})


def build_times(torch):
    """``--build-times``: the kernels' build as ``_build.py`` runs it (one
    ``nvcc`` per source, all started together, then a link) beside one
    ``nvcc`` call over every source, each into an empty directory."""
    from repro_torch.kernels import _build

    base = ROOT / "build" / "build_times"
    shutil.rmtree(base, ignore_errors=True)
    srcs = [str(x) for x in sorted(_build.CSRC.glob("*.cu"))]
    one_call = base / "one_call" / "librepro_torch_kernels.so"
    one_call.parent.mkdir(parents=True)
    t0 = time.perf_counter()
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(one_call),
                    *srcs], check=True, capture_output=True)
    t_one = time.perf_counter() - t0
    _build.BUILD_ROOT = base / "parallel"
    t0 = time.perf_counter()
    _build.build()
    t_par = time.perf_counter() - t0
    emit({"phase": "build_times", "sources": len(srcs), "one_nvcc_call_s": t_one,
          "parallel_build_s": t_par, "cpu_count": os.cpu_count()})
    shutil.rmtree(base, ignore_errors=True)


# ---------------------------------------------------------------------------
# phases 9-11: the multi-process Trainer and the wire kernels, ranks on the card
# ---------------------------------------------------------------------------

DIST_DEADLINE_S = 600   # a spawned world; every rank is killed past it
WORLD_CORES = 2         # host cores left to a 2-rank world's processes
BROKEN_TIMEOUT_S = 2.0  # the broken-peer case's in-kernel deadline


def _medium_leaf_sizes(torch, bits: int = 8, block: int = 256):
    """Per GPT-2 medium leaf: (wire bytes, scale count) of its quantized
    payload, from the shapes of seeded parameters made on the card."""
    from repro_torch.configs import get_config
    from repro_torch.models import registry as R
    from repro_torch.models.transformer import param_leaves

    p = R.init_params(get_config("gpt2-medium"), seed=0, device="cuda", training=True)
    out = []
    for _, t in param_leaves(p):
        nb = -(-t.numel() // block)
        out.append((nb * block if bits >= 8 else (nb * block + 1) // 2, nb))
    del p
    torch.cuda.empty_cache()
    return out


def _ring_worker(info):
    """check_ring on one rank: every kernel case against its plain version
    on host copies of the same bytes (gloo), kernel and plain times, and
    the broken peer (E = 2). Returns this rank's lines."""
    import torch
    import torch.distributed as dist

    from repro_torch.kernels import quantize as QK
    from repro_torch.kernels import ring_allreduce as RA
    from repro_torch.kernels.symm import Exchange, SymmBuffer
    from repro_torch.kernels.wire import pack_wire

    E, r, dev = info.world, info.rank, info.device
    ranks = list(range(E))
    pg = dist.new_group(ranks)
    ex = Exchange(group=pg, ranks=ranks, index=r)
    cpu_ex = Exchange(group=pg, ranks=ranks, index=r)
    sizes = _medium_leaf_sizes(torch)
    layout = RA.WireLayout(sizes)
    slot_layout = RA.WireLayout([(-(-nw // E), -(-nb // E)) for nw, nb in sizes])
    cap = E * max(layout.nbytes, slot_layout.nbytes + 16)
    ex.symm = SymmBuffer(pg, E, r, cap, dev)
    g = torch.Generator(device=dev).manual_seed(1000 + r)
    lines = []

    def same(name, kernel, plain, **extra):
        eq = torch.equal(kernel.cpu(), plain.cpu())
        err = 0.0 if eq else float((kernel.cpu().double() - plain.cpu().double()).abs().max())
        lines.append({"case": name, "E": E, "rank": r, "bitwise_equal": eq,
                      "max_abs_err": err, **extra})

    def rand_bytes(n):
        return torch.randint(0, 256, (n,), generator=g, device=dev, dtype=torch.uint8)

    # raw buffers: one byte, ragged lengths (byte path), 16-byte multiples
    for n in (1, 1_000_003, 65_552):
        x = rand_bytes(n)
        same(f"ring_bytes_{n}", RA.ring_allgather(x, ex), RA.ring_allgather(x.cpu(), cpu_ex))
        s = rand_bytes(E * (n // E + 1)).reshape(E, -1)
        same(f"scatter_bytes_{s.shape[1]}", RA.shard_scatter(s, ex),
             RA.shard_scatter(s.cpu(), cpu_ex))
    # the int4 nibble wire and the GPT-2 medium token table's int8 payload
    for name, n, bits, block in (("int4_b64", 300_001, 4, 64),
                                 ("token_table_int8_b256", 50304 * 1024, 8, 256)):
        x = torch.randn(n, generator=g, device=dev) * 1e-3
        q, s = QK.quantize_blockwise(x, bits=bits, block=block)
        qc, sc = q.cpu(), s.cpu()
        kw = dict(bits=bits, block=block)
        got = RA.gather_wire([(pack_wire(q, bits), s)], ex, bits=bits)[0]
        ref = RA.gather_wire([(pack_wire(qc, bits), sc)], cpu_ex, bits=bits)[0]
        same(f"gather_{name}", got[0], ref[0])
        same(f"gather_scales_{name}", got[1], ref[1])
        same(f"allreduce_{name}", RA.ring_allreduce_quantized(q, s, ex, **kw),
             RA.ring_allreduce_quantized(qc, sc, cpu_ex, **kw))
        red = RA.reduce_scatter_qs(q, s, ex, **kw)
        same(f"reduce_scatter_{name}", red, RA.reduce_scatter_qs(qc, sc, cpu_ex, **kw))
        q2, s2 = QK.quantize_blockwise(red, bits=bits, block=block)
        same(f"allgather_{name}", RA.allgather_qs(q2, s2, ex, **kw),
             RA.allgather_qs(q2.cpu(), s2.cpu(), cpu_ex, **kw))
        del x, q, s, red, q2, s2, got
    # the whole model packed: the main path's shapes (one launch per stage),
    # checked at every E and timed at E = 2, the main path's
    timings = {}
    xs = {"ring_allgather": rand_bytes(layout.nbytes),
          "shard_scatter": rand_bytes(E * slot_layout.nbytes).reshape(E, -1)}
    for kname, x in xs.items():
        fn = RA.ring_allgather if kname == "ring_allgather" else RA.shard_scatter
        xc = x.cpu()
        same(f"{kname}_whole_model", fn(x, ex), fn(xc, cpu_ex), nbytes=x.numel())
        if E != 2:
            continue
        torch.cuda.synchronize()
        dist.barrier(group=pg)
        evs = []
        for _ in range(REPS):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn(x, ex)
            b.record()
            evs.append((a, b))
        torch.cuda.synchronize()
        ms = statistics.median(a.elapsed_time(b) for a, b in evs)
        plain, lib = [], []
        for _ in range(3):
            dist.barrier(group=pg)
            t0 = time.perf_counter()
            fn(xc, cpu_ex)
            plain.append(1e3 * (time.perf_counter() - t0))
            flat = xc.reshape(-1)
            outl = torch.empty(E * flat.numel(), dtype=torch.uint8)
            dist.barrier(group=pg)
            t0 = time.perf_counter()
            dist.all_gather_into_tensor(outl, flat, group=pg)
            if kname == "shard_scatter":  # the all-gather and this member's column
                outl = outl.reshape(E, E, -1)[:, r].contiguous()
            lib.append(1e3 * (time.perf_counter() - t0))
        timings[kname] = {"ms": ms, "plain_ms": statistics.median(plain),
                          "library_ms": statistics.median(lib), "nbytes_per_rank": x.numel()}
    ex.symm.check("check_ring")
    broken = None
    if E == 2:
        # a broken peer: rank 1 never launches; rank 0's kernel must give up
        # at its deadline and the flag must raise, not hang
        dist.barrier(group=pg)
        if r == 0:
            x = rand_bytes(4096)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            RA.ring_allgather(x, ex, timeout_s=BROKEN_TIMEOUT_S)
            torch.cuda.synchronize()
            elapsed = time.perf_counter() - t0
            try:
                ex.symm.check("broken peer")
                raised = None
            except RuntimeError as e:
                raised = str(e)
            broken = {"seconds": elapsed, "deadline_s": BROKEN_TIMEOUT_S, "raised": raised}
        dist.barrier(group=pg)
    ex.symm.close()
    return {"lines": lines, "timings": timings, "broken": broken,
            "launches": {"ring_allgather": RA.ring_launches,
                         "shard_scatter": RA.scatter_launches}}


def _adamw_out_of_place(torch, grads, state, leaves, tc, lr):
    """The AdamW update as fresh fp32 tensors stored at the end: the form
    ``optim/adamw.py:adamw_update`` writes in place."""
    import numpy as np

    from repro_torch.optim.adamw import decay_mask

    dev = state.count.device
    f32 = lambda x: torch.tensor(np.float32(x), device=dev)  # noqa: E731
    b1, b2 = f32(tc.adam_beta1), f32(tc.adam_beta2)
    omb1, omb2 = f32(1.0 - tc.adam_beta1), f32(1.0 - tc.adam_beta2)
    eps, wd, lr_t, one = f32(tc.adam_eps), f32(tc.weight_decay), f32(lr), f32(1.0)
    state.count.add_(1)
    cf = state.count.float()
    c1, c2 = one - torch.pow(b1, cf), one - torch.pow(b2, cf)
    for (name, p), g, m, v in zip(leaves, grads, state.mu, state.nu):
        gf = g.float()
        mf = b1 * m.float() + omb1 * gf
        vf = b2 * v.float() + omb2 * (gf * gf)
        m.copy_(mf)
        v.copy_(vf)
        step = (mf / c1) / (torch.sqrt(vf / c2) + eps)
        if decay_mask(name):
            step = step + wd * p.float()
        p.copy_(p.float() - lr_t * step)


def check_adamw(torch, timer):
    """``adamw_update`` against its out-of-place form on the card: three
    steps at the GPT-2 XL token table with fp32 and bf16 moments must give
    the same bits; one step of each timed there."""
    from repro_torch.config import TrainConfig
    from repro_torch.optim.adamw import adamw_init, adamw_update

    shape = (50304, 1600)
    gen = torch.Generator(device="cuda").manual_seed(0)
    p0 = torch.randn(shape, device="cuda", generator=gen) * 0.02
    grads = [torch.randn(shape, device="cuda", generator=gen) * 0.01 for _ in range(3)]

    def out_of_place(*args):
        _adamw_out_of_place(torch, *args)

    for state_dtype in ("float32", "bfloat16"):
        tc = TrainConfig(opt_state_dtype=state_dtype)
        sides = []
        for fn in (adamw_update, out_of_place):
            leaves = [("embed.tokens", p0.clone())]
            state = adamw_init(leaves, tc)
            for g in grads:
                fn([g], state, leaves, tc, 1e-3)
            sides.append((fn, leaves, state))
        torch.cuda.synchronize()
        (_, la, sa), (_, lb, sb) = sides
        equal = (torch.equal(la[0][1], lb[0][1]) and torch.equal(sa.mu[0], sb.mu[0])
                 and torch.equal(sa.nu[0], sb.nu[0]))
        ms = [timer.ms(lambda: fn([grads[0]], st, lv, tc, 1e-3)) for fn, lv, st in sides]
        state_bytes = 4 if state_dtype == "float32" else 2
        # the gradient read; the parameter and both moments read and written
        moved = p0.numel() * (4 + 2 * 4 + 2 * 2 * state_bytes)
        emit({"phase": "adamw", "shape": list(shape), "state_dtype": state_dtype,
              "steps": len(grads), "bitwise_equal": equal, "in_place_ms": ms[0],
              "out_of_place_ms": ms[1], "bound_ms": moved / HBM_BYTES_PER_S * 1e3,
              "bound_by": "bytes"})
        if not equal:
            raise AssertionError(f"adamw ({state_dtype} moments): the in-place update is "
                                 f"not its out-of-place form bit for bit")
        del sides, la, lb, sa, sb
    del p0, grads
    torch.cuda.empty_cache()


def check_ring(torch, results):
    """Both wire kernels against their plain versions, at E = 2 and 4 ranks
    sharing the card, and their times at the main path's shapes (E = 2)."""
    from repro_torch.launch.train import spawn

    for E in (2, 4):
        t0 = time.perf_counter()
        outs = spawn(_ring_worker, nproc=E, device="cuda", timeout=DIST_DEADLINE_S)
        bad = [ln for o in outs for ln in o["lines"] if not ln["bitwise_equal"]]
        for ln in outs[0]["lines"]:
            emit({"phase": "check_ring", **ln})
        tm = outs[0]["timings"]
        emit({"phase": "check_ring", "E": E, "timings_rank0": tm,
              "broken_peer": outs[0]["broken"], "seconds": time.perf_counter() - t0})
        if bad:
            raise AssertionError(f"check_ring E={E}: kernel != plain version: {bad[:3]}")
        if E == 2:
            br = outs[0]["broken"]
            if br is None or br["raised"] is None or br["seconds"] > BROKEN_TIMEOUT_S + 5:
                raise AssertionError(f"check_ring: the broken peer did not raise within the "
                                     f"deadline: {br}")
            for kname, row, src in (("ring_allgather", 300, "ring_allgather.cu"),
                                    ("shard_scatter", 386, "shard_scatter.cu")):
                n = tm[kname]["nbytes_per_rank"]
                # each member's input read once and its (E, n) output written
                # once; the ring also moves about 2 E (E - 1) n through the
                # one HBM that the ranks share
                moved = E * n + E * n * (E if kname == "ring_allgather" else 1)
                b, by = bound_ms(moved, 0, "float32")
                results[kname] = {
                    "name": kname, "route": "cuda",
                    "source": f"src/repro_torch/kernels/csrc/{src}",
                    "replaces": f"src/repro/kernels/ring_allreduce.py:{row}",
                    "shape": (f"GPT-2 medium, every leaf's int8 wire and scales packed, "
                              f"{n} B a rank" + (", as (E, n/E) slots"
                                                 if kname == "shard_scatter" else "")
                              + f", E = {E} ranks on one card"),
                    "max_abs_err": 0.0, "ms": tm[kname]["ms"], "kernel_ms": tm[kname]["ms"],
                    "plain_ms": tm[kname]["plain_ms"], "bound_ms": b, "bound_by": by,
                    "traffic_bound_ms": 2 * E * (E - 1) * n / HBM_BYTES_PER_S * 1e3,
                    "library_ms": tm[kname]["library_ms"],
                    "library": ("gloo all_gather_into_tensor on host copies"
                                + (" and this rank's column"
                                   if kname == "shard_scatter" else ""))}


def _dist_expect(strategy, E: int, leaves: int, cfg, steps: int, syncs: int):
    """Launches of one rank's main path: its one replica's attention (on
    the tensor cores by ``tc_rule`` and ``tc_bwd_rule``) and norms, the
    outer update, and the exchange's kernels per leaf and sync as
    ``sync/strategies.py`` makes them (``E`` the wire's endpoints)."""
    from repro_torch.sync import Hierarchical, Int8Wire, Quantized

    inner = strategy.inner if isinstance(strategy, Hierarchical) else strategy
    nq = ndq = ring = scatter = 0
    if isinstance(inner, Int8Wire) and E > 1:
        if inner.reduce_scatter:
            # q, dq of the payload; E dq for the slot's sum; q2, dq of the
            # second residual; E dq for the concatenation
            nq, ndq, ring, scatter = 2, 1 + E + 1 + E, 1, 1
        else:
            nq, ndq, ring = 1, 1 + E, 1
    elif isinstance(inner, Quantized):  # compress_leaf: one of each a leaf
        nq, ndq = 1, 1
    fwd = flash_layers(cfg) * steps
    tc = fwd if tc_rule(cfg.dtype, cfg.resolved_head_dim) else 0
    tc_bwd = fwd if tc_bwd_rule(cfg.dtype, cfg.resolved_head_dim) else 0
    return {"flash_attention": fwd, "flash_attention_bwd": fwd,
            "flash_attention_tc": tc, "flash_attention_bwd_tc": tc_bwd,
            "pier_update": leaves * syncs, "quantize_blockwise": nq * leaves * syncs,
            "dequantize_blockwise": ndq * leaves * syncs, "ring_allgather": ring * syncs,
            "shard_scatter": scatter * syncs, "rmsnorm": norm_launches(cfg) * steps,
            "rmsnorm_bwd": norm_launches(cfg) * steps}


def _syncs(tc, steps):
    from repro_torch.core.pier import PierSchedule

    sched = PierSchedule(tc)
    return (sum(1 for s in range(steps) for ev in sched.events(s)
                if ev.kind == "dispatch" and ev.op == "outer"),
            sum(1 for s in range(steps) if sched.phase(s) == "warmup"))


# (name, OuterCommConfig kwargs, ranks, pods, sync_delay)
DIST_VS_SIM = [("flat_d0", {}, 2, 1, 0), ("flat_d1", {}, 2, 1, 1),
               ("int8_wire_d0", {"compression": "int8-wire"}, 2, 1, 0),
               ("int8_wire_d1", {"compression": "int8-wire"}, 2, 1, 1),
               ("rs_ag_d0", {"compression": "rs-ag"}, 2, 1, 0),
               ("rs_ag_d1", {"compression": "rs-ag"}, 2, 1, 1),
               ("hier_int8_wire_g4_p2", {"compression": "int8-wire", "hierarchical": True},
                4, 2, 1),
               # an RMSNorm family through the Trainer (its rmsnorm counters)
               ("qwen3_int8_wire_d0", {"compression": "int8-wire"}, 2, 1, 0),
               # MLA and MoE through the Trainer (DeepSeek-V2's reduced config)
               ("deepseek_int8_wire_d1", {"compression": "int8-wire"}, 2, 1, 1)]
DIST_VS_SIM_ARCH = {"qwen3_int8_wire_d0": "qwen3-1.7b",
                    "deepseek_int8_wire_d1": "deepseek-v2-236b-reduced"}  # else gpt2-medium
DIST_VS_SIM_BITWISE = ("qwen3_int8_wire_d0", "deepseek_int8_wire_d1")


def two_rank_world(torch, phases):
    """Run the Trainer jobs of several phases in one spawned world of two
    ranks sharing the card: each world pays its ranks' start (about 15 s),
    so the phases share one. Each phase is a generator that yields its
    jobs once, is sent (every rank's outputs of its own jobs, the world's
    seconds), and returns its result, which this returns in order."""
    from repro_torch.launch.train import spawn, train_jobs

    lists = [next(p) for p in phases]
    t0 = time.perf_counter()
    outs = spawn(train_jobs, ([job for jobs in lists for job in jobs],), nproc=2,
                 device="cuda", timeout=DIST_DEADLINE_S)
    wall = time.perf_counter() - t0
    results, k = [], 0
    for p, jobs in zip(phases, lists):
        try:
            p.send(([o[k:k + len(jobs)] for o in outs], wall))
        except StopIteration as done:
            results.append(done.value)
        else:
            raise RuntimeError("a phase of two_rank_world yielded twice")
        k += len(jobs)
    return results


def train_dist_vs_sim(torch):
    """The Trainer (ranks on the card) against ``SimulatedRun`` on the card:
    GPT-2 medium width (Qwen3-1.7B width for the RMSNorm case; DeepSeek-V2's
    reduced config, MLA and an MoE layer, for the MoE case), 2 layers,
    fp32, per-group batch 2 x 256, 8 steps of the 40-step schedule with no
    lazy start (four outer syncs). A phase of ``two_rank_world``: it yields
    its 2-rank jobs and spawns its 4-rank world itself."""
    from repro_torch.config import OuterCommConfig, ParallelConfig, TrainConfig
    from repro_torch.configs import get_config, get_reduced_config
    from repro_torch.core.simulate import SimulatedRun
    from repro_torch.launch.train import spawn, train_jobs
    from repro_torch.models import registry as R
    from repro_torch.models.transformer import param_leaves
    from repro_torch.sync import resolve_strategy

    steps, per, seq, tol = 8, 2, 256, 1e-5
    cfgs, bases, sds = {}, {}, {}
    for arch in ("gpt2-medium", "qwen3-1.7b", "deepseek-v2-236b-reduced"):
        cfgs[arch] = (get_reduced_config(arch.removesuffix("-reduced"))
                      if arch.endswith("-reduced") else get_config(arch)).replace(
            num_layers=2, dtype="float32")
        bases[arch] = R.init_params(cfgs[arch], seed=0, device="cpu", training=True)
        sds[arch] = {k: v.detach().clone() for k, v in bases[arch].state_dict().items()}
    seen = []
    for E in (2, 4):
        cases = [c for c in DIST_VS_SIM if c[2] == E]
        jobs, tcs = [], []
        for name, comm, ranks, P, delay in cases:
            tc = TrainConfig(**TRAIN_TC, global_batch_size=ranks * per, seq_len=seq,
                             sync_delay=delay, outer_comm=OuterCommConfig(**comm))
            tc = tc.replace(warmup_frac=0.0)
            pc = ParallelConfig(data_axis_size=ranks // P, data_outer=ranks // P, num_pods=P)
            tcs.append(tc)
            arch = DIST_VS_SIM_ARCH.get(name, "gpt2-medium")
            jobs.append(((cfgs[arch], tc, pc, steps), {"params": sds[arch], "keep_params": True}))
        if E == 2:  # run in the shared world of two ranks (``two_rank_world``)
            outs, t_dist = yield jobs
        else:
            t0 = time.perf_counter()
            outs = spawn(train_jobs, (jobs,), nproc=E, device="cuda", timeout=DIST_DEADLINE_S)
            t_dist = time.perf_counter() - t0
        for i, (name, comm, ranks, P, delay) in enumerate(cases):
            tc = tcs[i]
            arch = DIST_VS_SIM_ARCH.get(name, "gpt2-medium")
            cfg = cfgs[arch]
            run = SimulatedRun(cfg, tc, num_groups=ranks, num_pods=P, device="cuda",
                               params=copy.deepcopy(bases[arch]))
            hist = run.run(steps)
            run.flush()
            torch.cuda.synchronize()
            loss = [h["loss"] for h in outs[0][i]["history"]]
            loss_err = max(abs(a - b) for a, b in zip(loss, hist["train_loss"]))
            p_err, bitwise = 0.0, True
            for g in range(ranks):
                mine = outs[g][i]["params"]
                sim = [t.detach().cpu() for _, t in param_leaves(run.state.group_params[g])]
                p_err = max(p_err, max(float((a - b).abs().max()) for a, b in zip(mine, sim)))
                bitwise = bitwise and all(torch.equal(a, b) for a, b in zip(mine, sim))
            bitwise = bitwise and loss == hist["train_loss"]
            syncs, _ = _syncs(tc, steps)
            E_wire = P if comm.get("hierarchical") else ranks
            expect = _dist_expect(resolve_strategy(tc), E_wire, len(sds[arch]), cfg, steps,
                                  syncs)
            launches = [o[i]["launches"] for o in outs]
            emit({"phase": "train_dist_vs_sim", "case": name, "strategy": outs[0][i]["strategy"],
                  "config": (f"{arch}, float32" if arch.endswith("-reduced")
                             else f"{arch} width, 2 layers, float32"), "ranks": ranks, "pods": P,
                  "sync_delay": delay, "steps": steps, "outer_syncs": syncs,
                  "per_group_batch": per, "seq_len": seq, "loss_dist": loss,
                  "loss_sim": hist["train_loss"], "max_abs_loss_err": loss_err,
                  "max_abs_param_err": p_err, "tol": tol, "bitwise_equal": bitwise,
                  "bitwise_required": name in DIST_VS_SIM_BITWISE,
                  "launches_rank0": launches[0], "expected_launches_per_rank": expect,
                  "backend": outs[0][i]["backend"], "world_seconds": t_dist})
            if loss_err > tol or p_err > tol:
                raise AssertionError(f"train_dist_vs_sim {name}: loss err {loss_err}, param "
                                     f"err {p_err} (limit {tol})")
            if name in DIST_VS_SIM_BITWISE and not bitwise:
                raise AssertionError(f"train_dist_vs_sim {name}: not bit for bit the simulator")
            if any(ln != expect for ln in launches):
                raise AssertionError(f"train_dist_vs_sim {name}: launches {launches} != "
                                     f"{expect} per rank")
            seen.extend(launches)
            del run
            free_cuda(torch)
    return seen


def _gpt2_medium_val(torch, cfg, seq):
    """The fixed validation batch of the GPT-2 medium Trainer phases."""
    from repro_torch.data.synthetic import MarkovLM, make_train_batch

    gen = torch.Generator().manual_seed(99991)
    return make_train_batch(MarkovLM(cfg.vocab_size, seed=1234), gen, 16, seq)


def train_dist(torch):
    """Full GPT-2 medium, 2 ranks sharing the card (G = 2), 10 steps, with
    int8-wire and with rs-ag; returns the runs' lines. A phase of
    ``two_rank_world``."""
    from repro_torch.config import OuterCommConfig, ParallelConfig, TrainConfig
    from repro_torch.configs import get_config
    from repro_torch.sync import resolve_strategy

    cfg = get_config("gpt2-medium")
    G, per, seq, steps = 2, 2, 1024, 10
    pc = ParallelConfig(data_axis_size=G, data_outer=G)
    val = _gpt2_medium_val(torch, cfg, seq)
    tcs = [TrainConfig(**TRAIN_TC, **TRAIN_LR, global_batch_size=G * per, seq_len=seq,
                       outer_comm=OuterCommConfig(compression=c)) for c in ("int8-wire", "rs-ag")]
    jobs = [((cfg, tc, pc, steps), {"val_batch": val, "timed": True}) for tc in tcs]
    outs, wall = yield jobs  # in the shared world of two ranks (``two_rank_world``)
    lines = []
    for i, tc in enumerate(tcs):
        r0 = outs[0][i]
        syncs, warm = _syncs(tc, steps)
        n_leaves = r0["leaves"]
        expect = _dist_expect(resolve_strategy(tc), G, n_leaves, cfg, steps, syncs)
        launches = [o[i]["launches"] for o in outs]
        tm = r0["times_ms"]
        inner = tm.get("inner_step", [])
        inner_ss = inner[1:] if len(inner) > 1 else inner
        p50 = statistics.median(inner_ss) if inner_ss else None
        per_sync = {k: tm.get(k + "_device", []) for k in ("ring_allgather", "shard_scatter")}
        line = {
            "phase": "train_dist", "config": "gpt2-medium 24 layers, bf16 compute, fp32 params",
            "strategy": r0["strategy"], "ranks": G, "groups": G,
            "note": "2 ranks share one card: time-sliced contexts, not a two-GPU rate",
            "backend": r0["backend"], "per_group_batch": per, "seq_len": seq,
            "steps": steps, "warmup_steps": warm, "outer_syncs": syncs,
            "init_s": r0["init_s"], "wall_s": r0["wall_s"],
            "warmup_step_ms": tm.get("warmup_step", []), "inner_step_ms": inner,
            "inner_step_ms_p50": p50,
            "tokens_per_s_both_ranks": (G * per * seq / (p50 / 1e3)) if p50 else None,
            "tokens_per_s_run": steps * G * per * seq / r0["wall_s"],
            "accumulate_ms": tm.get("accumulate_step", []),
            "outer_step_ms": tm.get("outer_step", []),
            "dispatch_ms": tm.get("dispatch_step", []), "apply_ms": tm.get("apply_step", []),
            "metric_mean_ms": tm.get("metric_mean", []),
            "ring_device_ms_per_sync": per_sync["ring_allgather"],
            "scatter_device_ms_per_sync": per_sync["shard_scatter"],
            "peak_mem_gb_per_rank": [o[i]["peak_mem_bytes"] / 1e9 for o in outs],
            "loss": [h["loss"] for h in r0["history"]],
            "val_loss_before": r0["val_loss_before"], "val_loss_after": r0["val_loss_after"],
            "launches_per_rank": launches, "expected_launches_per_rank": expect,
            "world_seconds": wall}
        emit(line)
        lines.append(line)
        loss = line["loss"] + [line["val_loss_before"], line["val_loss_after"]]
        if not all(math.isfinite(x) for x in loss):
            raise AssertionError(f"train_dist {tc.outer_comm.compression}: non-finite loss")
        if not line["val_loss_after"] < line["val_loss_before"]:
            raise AssertionError(f"train_dist {tc.outer_comm.compression}: validation loss "
                                 f"did not fall: {line['val_loss_before']} -> "
                                 f"{line['val_loss_after']}")
        if any(ln != expect for ln in launches):
            raise AssertionError(f"train_dist {tc.outer_comm.compression}: launches "
                                 f"{launches} != {expect} per rank")
    return lines


# ---------------------------------------------------------------------------
# phases 8e-8j: sync controllers, elastic membership, checkpoints, offload
# ---------------------------------------------------------------------------

ELASTIC_SPEC = "drop:1@1,rejoin:1@3,straggle:2@2+2"
# (name, OuterCommConfig kwargs, sync_delay)
ELASTIC_CONFIGS = [("flat_d1", {}, 1), ("quantize_int8_b256_d0", {"compression": "quantize"}, 0),
                   ("int8_wire_d1", {"compression": "int8-wire"}, 1)]


def _membership_lines(ctrl, events: int):
    return [{"event": k, "weights": list(ctrl.at(k).weights),
             "apply_live": list(ctrl.at(k).apply_live),
             "bootstrap_after_apply": list(ctrl.at(k).bootstrap_after_apply)}
            for k in range(events)]


def _card_half(torch, counters, make_run, steps: int):
    """The card's run of a card-vs-CPU comparison: (run, history, launches,
    its groups' final parameters on the host)."""
    from repro_torch.models.transformer import param_leaves

    run = make_run("cuda")
    for ctr in counters.values():
        ctr.launches = 0
    hist = run.run(steps)
    run.flush()
    torch.cuda.synchronize()
    launches = {k: ctr.launches for k, ctr in counters.items()}
    params = [[t.detach().cpu() for _, t in param_leaves(g)] for g in run.state.group_params]
    return run, hist, launches, params


def _cpu_half(make_run, steps: int, card_hist, card_params):
    """The CPU's run of the same comparison: (loss error, parameter error)."""
    from repro_torch.models.transformer import param_leaves

    run = make_run("cpu")
    hist = run.run(steps)
    run.flush()
    loss_err = max(abs(a - b) for a, b in zip(card_hist["train_loss"], hist["train_loss"]))
    p_err = max(float((a - b.detach()).abs().max())
                for gc_, gp in zip(card_params, run.state.group_params)
                for a, (_, b) in zip(gc_, param_leaves(gp)))
    return hist, loss_err, p_err


def _window_expect(run, strategies, steps: int, num_leaves: int):
    """Launches of a run whose outer windows took ``strategies`` (one per
    window, in order): the flash and norm launches of ``_train_expect``,
    the outer update per leaf and window, and each window's quantize and
    dequantize per its strategy."""
    expect, warm, syncs = _train_expect(run, steps, num_leaves)
    nq = ndq = 0
    for s in strategies:
        q, dq = _quant_launches(s, run.G, run.P)
        nq, ndq = nq + q, ndq + dq
    expect["quantize_blockwise"] = nq * num_leaves
    expect["dequantize_blockwise"] = ndq * num_leaves
    expect["pier_update"] = num_leaves * len(strategies)
    return expect, warm, syncs


def elastic_vs_cpu(torch, counters):
    """Elastic membership on the card and on the CPU: GPT-2 XL width, 2
    layers, fp32, G = 3, 12 steps (outer events after steps 5, 7, 9, 11),
    churn ``drop:1@1,rejoin:1@3,straggle:2@2+2`` with max_staleness 1
    (group 2 evicted after event 3 and bootstrapped there). Runs the card
    halves now and returns, per case, its launches and the CPU half to run
    (which checks and reports)."""
    from repro_torch.config import MembershipConfig, OuterCommConfig, TrainConfig
    from repro_torch.configs import get_config
    from repro_torch.core.simulate import SimulatedRun
    from repro_torch.models import registry as R
    from repro_torch.models.transformer import param_leaves
    from repro_torch.sync import ChurnSchedule, MembershipController

    cfg = get_config("gpt2-xl").replace(num_layers=2, dtype="float32")
    G, steps, seq, per, tol = 3, 12, 64, 1, 1e-3
    base = R.init_params(cfg, seed=0, device="cpu", training=True)
    n_leaves = len(param_leaves(base))
    out = []
    for name, comm, delay in ELASTIC_CONFIGS:
        tc = TrainConfig(**TRAIN_TC, global_batch_size=G * per, seq_len=seq, sync_delay=delay,
                         outer_comm=OuterCommConfig(**comm),
                         membership=MembershipConfig(max_staleness=1))
        t0 = time.perf_counter()

        def make(dev, tc=tc):
            return SimulatedRun(cfg, tc, num_groups=G, device=dev, params=copy.deepcopy(base),
                                membership=MembershipController(
                                    G, cfg=tc.membership,
                                    schedule=ChurnSchedule.parse(ELASTIC_SPEC)))
        card, h_card, launches, params = _card_half(torch, counters, make, steps)
        expect, warm, syncs = _train_expect(card, steps, n_leaves)
        res = card.state.outer.residual
        line = {"phase": "elastic_vs_cpu", "case": name, "strategy": card.strategy.name,
                "config": "gpt2-xl width, 2 layers, float32", "groups": G,
                "sync_delay": delay, "churn": ELASTIC_SPEC, "max_staleness": 1,
                "steps": steps, "warmup_steps": warm, "outer_syncs": syncs,
                "per_group_batch": per, "seq_len": seq,
                "events": _membership_lines(card.membership, syncs),
                "bootstrapped_residual_rows_zero": (
                    None if res is None else all(float(r[2].abs().max()) == 0 for r in res)),
                "card_launches": launches, "expected_launches": expect,
                "card_seconds": time.perf_counter() - t0}
        del card, res
        free_cuda(torch)
        if launches != expect:
            raise AssertionError(f"elastic_vs_cpu {name}: launches {launches} != {expect}")

        def finish(make=make, line=line, h_card=h_card, params=params, name=name):
            t0 = time.perf_counter()
            h_cpu, loss_err, p_err = _cpu_half(make, steps, h_card, params)
            emit({**line, "loss_card": h_card["train_loss"], "loss_cpu": h_cpu["train_loss"],
                  "max_abs_loss_err": loss_err, "max_abs_param_err": p_err, "tol": tol,
                  "cpu_seconds": time.perf_counter() - t0})
            if not all(math.isfinite(x) for x in h_card["train_loss"]):
                raise AssertionError(f"elastic_vs_cpu {name}: non-finite card loss")
            if loss_err > tol or p_err > tol:
                raise AssertionError(f"elastic_vs_cpu {name}: loss err {loss_err}, param err "
                                     f"{p_err} (limit {tol})")
        out.append((launches, finish))
    return out


def switch_vs_cpu(torch, counters):
    """A scripted controller on the card and on the CPU: GPT-2 XL width, 2
    layers, fp32, G = 2, 14 steps (outer windows after steps 5, 7, 9, 11,
    13): FlatFP32 -> Quantized(8, 256) at window 2, the delay 0 -> 1 at
    window 3, -> Int8Wire(4) at window 4, -> FlatFP32 at window 5 (the
    residual goes). Runs the card half now; returns its launches and the
    CPU half to run (which checks and reports)."""
    from repro_torch.config import TrainConfig
    from repro_torch.configs import get_config
    from repro_torch.core.simulate import SimulatedRun
    from repro_torch.models import registry as R
    from repro_torch.models.transformer import param_leaves
    from repro_torch.sync import (FlatFP32, Int8Wire, Quantized, ScriptedSyncController,
                                  SyncDecision)

    cfg = get_config("gpt2-xl").replace(num_layers=2, dtype="float32")
    G, steps, seq, per, tol = 2, 14, 64, 1, 1e-3
    base = R.init_params(cfg, seed=0, device="cpu", training=True)
    n_leaves = len(param_leaves(base))
    tc = TrainConfig(**TRAIN_TC, global_batch_size=G * per, seq_len=seq)
    script = {2: Quantized(8, 256), 3: SyncDecision(1, None), 4: Int8Wire(bits=4),
              5: FlatFP32()}
    t0 = time.perf_counter()
    trace = {}

    def make(dev):
        run = SimulatedRun(cfg, tc, num_groups=G, device=dev, params=copy.deepcopy(base),
                           sync_controller=ScriptedSyncController(0, script))
        consult, log = run._consult_controller, trace.setdefault(dev, [])

        def recorded():
            consult()
            o = run.state.outer
            log.append({"window": run.sync_controller.windows, "strategy": run.strategy.name,
                        "sync_delay": run.tc.sync_delay, "residual": o.residual is not None,
                        "residual2": o.residual2 is not None})
        run._consult_controller = recorded
        return run
    card, h_card, launches, params = _card_half(torch, counters, make, steps)
    # the strategy each window's dispatch ran: the one standing before its
    # decision (window 1 runs the configured flat mean)
    strategies, cur = [], FlatFP32()
    for w in range(1, len(trace["cuda"]) + 1):
        strategies.append(cur)
        entry = script.get(w)
        nxt = entry.strategy if isinstance(entry, SyncDecision) else entry
        cur = nxt if nxt is not None else cur
    expect, warm, syncs = _window_expect(card, strategies, steps, n_leaves)
    del card
    free_cuda(torch)
    residuals = [(t["window"], t["residual"], t["residual2"]) for t in trace["cuda"]]
    want_res = [(1, False, False), (2, True, False), (3, True, False), (4, True, False),
                (5, False, False)]
    line = {"phase": "switch_vs_cpu", "config": "gpt2-xl width, 2 layers, float32",
            "groups": G, "steps": steps, "warmup_steps": warm, "outer_syncs": syncs,
            "windows": trace["cuda"], "window_strategies": [s.name for s in strategies],
            "card_launches": launches, "expected_launches": expect,
            "card_seconds": time.perf_counter() - t0}
    if residuals != want_res:
        raise AssertionError(f"switch_vs_cpu: windows {trace['cuda']} (residuals want "
                             f"{want_res})")
    if launches != expect:
        raise AssertionError(f"switch_vs_cpu: launches {launches} != {expect}")

    def finish():
        t1 = time.perf_counter()
        h_cpu, loss_err, p_err = _cpu_half(make, steps, h_card, params)
        emit({**line, "cpu_windows": trace["cpu"], "loss_card": h_card["train_loss"],
              "loss_cpu": h_cpu["train_loss"], "max_abs_loss_err": loss_err,
              "max_abs_param_err": p_err, "tol": tol, "cpu_seconds": time.perf_counter() - t1})
        if trace["cuda"] != trace["cpu"]:
            raise AssertionError(f"switch_vs_cpu: card windows {trace['cuda']} != CPU "
                                 f"windows {trace['cpu']}")
        if loss_err > tol or p_err > tol:
            raise AssertionError(f"switch_vs_cpu: loss err {loss_err}, param err {p_err} "
                                 f"(limit {tol})")
    return [(launches, finish)]


def _probe(leaves):
    """A strided sample of every leaf, compared before and after an apply
    (a full copy of a GPT-2 XL replica would not fit beside the run)."""
    return [t.detach().reshape(-1)[::997].clone() for t in leaves]


def train_elastic(torch, counters):
    """Full GPT-2 XL through SimulatedRun, G = 2, 10 steps, quantized int8
    outer sync, churn ``drop:1@1,rejoin:1@2``: group 1 sits out event 1
    (step 7; its parameters untouched by that apply) and bootstraps onto
    the anchor right after it."""
    from repro_torch.config import MembershipConfig, OuterCommConfig, TrainConfig
    from repro_torch.configs import get_config
    from repro_torch.core.simulate import SimulatedRun
    from repro_torch.models.transformer import param_leaves
    from repro_torch.sync import ChurnSchedule, MembershipController

    cfg = get_config("gpt2-xl")
    G, per, seq, steps, spec = 2, 2, 1024, 10, "drop:1@1,rejoin:1@2"
    tc = TrainConfig(**TRAIN_TC, **TRAIN_LR, global_batch_size=G * per, seq_len=seq,
                     outer_comm=OuterCommConfig(compression="quantize", bits=8, block=256),
                     membership=MembershipConfig())
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    run = SimulatedRun(cfg, tc, num_groups=G, seed=0, device="cuda",
                       membership=MembershipController(G, cfg=tc.membership,
                                                       schedule=ChurnSchedule.parse(spec)))
    n_leaves = len(param_leaves(run.state.params))
    t_init = time.perf_counter() - t0
    val_before = run.val_loss(run.state.params)
    times, probes = {}, []
    apply = run._apply

    def watched(target, snapshots, live=None):
        leaves = [t for _, t in param_leaves(run.state.group_params[1])]
        before = _probe(leaves)
        apply(target, snapshots, live)
        after = _probe(leaves)
        probes.append({"live": None if live is None else list(live),
                       "group1_unchanged": all(torch.equal(a, b)
                                               for a, b in zip(before, after))})
    run._apply = watched
    for name, kind in (("_inner_step", "inner_step"), ("_dispatch", "outer_dispatch"),
                       ("_apply", "outer_apply")):
        setattr(run, name, _timed(torch, times, kind, getattr(run, name)))
    boot = {}
    bootstrap = run._bootstrap_group

    def bootstrapped(g):
        bootstrap(g)
        leaves = [t for _, t in param_leaves(run.state.group_params[g])]
        boot[g] = all(torch.equal(p, a) for p, a in zip(leaves, run.state.outer.anchor))
        boot[f"{g}_fresh_adamw"] = int(run.state.opt[g].count) == 0
    run._bootstrap_group = bootstrapped
    for c in counters.values():
        c.launches = 0
    t1 = time.perf_counter()
    hist = run.run(steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = {k: c.launches for k, c in counters.items()}
    val_after = run.val_loss(run.state.params)
    expect, warm, syncs = _train_expect(run, steps, n_leaves)
    inner = times.get("inner_step", [])
    line = {"phase": "train_elastic", "config": f"{cfg.name} {cfg.num_layers} layers, bf16 "
                                                f"compute, fp32 params",
            "strategy": run.strategy.name, "churn": spec, "groups": G, "per_group_batch": per,
            "seq_len": seq, "steps": steps, "warmup_steps": warm, "outer_syncs": syncs,
            "events": _membership_lines(run.membership, syncs), "applies": probes,
            "bootstrap_equals_anchor": boot, "init_s": t_init, "wall_s": wall,
            "inner_step_ms": inner,
            "inner_step_ms_p50": statistics.median(inner[1:]) if len(inner) > 1 else None,
            "outer_dispatch_ms": times.get("outer_dispatch", []),
            "outer_apply_ms": times.get("outer_apply", []),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "loss": hist["train_loss"], "val_loss_before": val_before,
            "val_loss_after": val_after, "launches": launches, "expected_launches": expect}
    emit(line)
    if not all(math.isfinite(x) for x in hist["train_loss"] + [val_before, val_after]):
        raise AssertionError("train_elastic: non-finite loss")
    if not val_after < val_before:
        raise AssertionError(f"train_elastic: validation loss did not fall: {val_before} -> "
                             f"{val_after}")
    if launches != expect:
        raise AssertionError(f"train_elastic: launches {launches} != {expect}")
    event1 = [p for p in probes if p["live"] == [True, False]]
    if len(event1) != 1 or not event1[0]["group1_unchanged"]:
        raise AssertionError(f"train_elastic: event 1's apply touched group 1: {probes}")
    if boot != {1: True, "1_fresh_adamw": True}:
        raise AssertionError(f"train_elastic: bootstrap {boot}")
    del run
    return line


def _dist_window_expect(strategies, E: int, leaves: int, cfg, steps: int):
    """Per-rank launches of a Trainer run whose outer windows took
    ``strategies`` (``_dist_expect`` summed window by window)."""
    total = None
    for s in strategies:
        one = _dist_expect(s, E, leaves, cfg, steps, 1)
        if total is None:
            total = one
        else:
            for k in ("pier_update", "quantize_blockwise", "dequantize_blockwise",
                      "ring_allgather", "shard_scatter"):
                total[k] += one[k]
    return total


# (name, OuterCommConfig kwargs, sync_delay, churn, scripted switch)
DIST_ELASTIC = [("int8_wire_d0_churn", {"compression": "int8-wire"}, 0, "drop:1@1,rejoin:1@2",
                 False),
                ("int8_wire_d1_churn", {"compression": "int8-wire"}, 1, "drop:1@1,rejoin:1@2",
                 False),
                ("rs_ag_d0_churn", {"compression": "rs-ag"}, 0, "drop:1@1,rejoin:1@2", False),
                ("rs_ag_d1_churn", {"compression": "rs-ag"}, 1, "drop:1@1,rejoin:1@2", False),
                ("flat_to_int8_wire_switch", {}, 0, "", True)]


def train_dist_elastic_vs_sim(torch):
    """The Trainer (2 ranks on the card) against ``SimulatedRun`` on the
    card with churn and a scripted switch: GPT-2 XL width, 2 layers, fp32,
    per-group batch 2 x 256, 8 steps with no lazy start (outer windows
    after steps 1, 3, 5, 7). A phase of ``two_rank_world``."""
    from repro_torch.config import (MembershipConfig, OuterCommConfig, ParallelConfig,
                                    TrainConfig)
    from repro_torch.configs import get_config
    from repro_torch.core.simulate import SimulatedRun
    from repro_torch.models import registry as R
    from repro_torch.models.transformer import param_leaves
    from repro_torch.sync import (ChurnSchedule, FlatFP32, Int8Wire, MembershipController,
                                  ScriptedSyncController, resolve_strategy)

    cfg = get_config("gpt2-xl").replace(num_layers=2, dtype="float32")
    ranks, steps, per, seq, tol = 2, 8, 2, 256, 1e-5
    base = R.init_params(cfg, seed=0, device="cpu", training=True)
    sd = {k: v.detach().clone() for k, v in base.state_dict().items()}
    pc = ParallelConfig(data_axis_size=ranks, data_outer=ranks)
    switch = {2: Int8Wire(8, 256)}
    jobs, tcs = [], []
    for name, comm, delay, churn, scripted in DIST_ELASTIC:
        tc = TrainConfig(**TRAIN_TC, global_batch_size=ranks * per, seq_len=seq,
                         sync_delay=delay, outer_comm=OuterCommConfig(**comm),
                         membership=MembershipConfig() if churn else None)
        tc = tc.replace(warmup_frac=0.0)
        tcs.append(tc)
        kw = {"params": sd, "keep_params": True, "churn": churn}
        if scripted:
            kw["sync_controller"] = ScriptedSyncController(0, switch)
        jobs.append(((cfg, tc, pc, steps), kw))
    outs, t_dist = yield jobs  # in the shared world of two ranks (``two_rank_world``)
    seen = []
    for i, (name, comm, delay, churn, scripted) in enumerate(DIST_ELASTIC):
        tc = tcs[i]
        kw = {}
        if churn:
            kw["membership"] = MembershipController(ranks, cfg=tc.membership,
                                                    schedule=ChurnSchedule.parse(churn))
        if scripted:
            kw["sync_controller"] = ScriptedSyncController(0, switch)
        run = SimulatedRun(cfg, tc, num_groups=ranks, device="cuda",
                           params=copy.deepcopy(base), **kw)
        hist = run.run(steps)
        run.flush()
        torch.cuda.synchronize()
        loss = [h["loss"] for h in outs[0][i]["history"]]
        loss_err = max(abs(a - b) for a, b in zip(loss, hist["train_loss"]))
        p_err, bitwise = 0.0, True
        for g in range(ranks):
            mine = outs[g][i]["params"]
            sim = [t.detach().cpu() for _, t in param_leaves(run.state.group_params[g])]
            p_err = max(p_err, max(float((a - b).abs().max()) for a, b in zip(mine, sim)))
            bitwise = bitwise and all(torch.equal(a, b) for a, b in zip(mine, sim))
        syncs, _ = _syncs(tc, steps)
        strategies = ([FlatFP32()] * 2 + [Int8Wire(8, 256)] * (syncs - 2) if scripted
                      else [resolve_strategy(tc)] * syncs)
        expect = _dist_window_expect(strategies, ranks, len(sd), cfg, steps)
        launches = [o[i]["launches"] for o in outs]
        # the flat windows mean Δθ in the Trainer and θ in the simulator (the
        # reference's two orders), so a switched run is held to three int8
        # quantization steps of its own residual scale where that is larger
        res_max = (max(float(r.abs().max()) for r in run.state.outer.residual)
                   if run.state.outer.residual is not None else 0.0)
        limit = max(tol, 6 * res_max) if scripted else tol
        line = {"phase": "train_dist_elastic_vs_sim", "case": name,
                "strategy": outs[0][i]["strategy"], "config": "gpt2-xl width, 2 layers, "
                                                              "float32",
                "ranks": ranks, "sync_delay": delay, "churn": churn, "steps": steps,
                "outer_syncs": syncs, "per_group_batch": per, "seq_len": seq,
                "events": (_membership_lines(run.membership, syncs) if churn else None),
                "decisions_rank0": outs[0][i]["decisions"], "loss_dist": loss,
                "loss_sim": hist["train_loss"], "max_abs_loss_err": loss_err,
                "max_abs_param_err": p_err, "limit": limit, "bitwise_equal": bitwise,
                "launches_per_rank": launches, "expected_launches_per_rank": expect,
                "backend": outs[0][i]["backend"], "world_seconds": t_dist}
        emit(line)
        if not scripted and not bitwise:
            raise AssertionError(f"train_dist_elastic_vs_sim {name}: not bit for bit "
                                 f"(loss err {loss_err}, param err {p_err})")
        if loss_err > limit or p_err > limit:
            raise AssertionError(f"train_dist_elastic_vs_sim {name}: loss err {loss_err}, "
                                 f"param err {p_err} (limit {limit})")
        if any(ln != expect for ln in launches):
            raise AssertionError(f"train_dist_elastic_vs_sim {name}: launches {launches} != "
                                 f"{expect} per rank")
        seen.extend(launches)
        del run
        free_cuda(torch)
    return seen


AUTO_LAYERS = 12  # train_dist_auto's depth at GPT-2 medium's width (of 24)


def train_dist_auto(torch):
    """GPT-2 medium's width at ``AUTO_LAYERS`` layers (half its depth, for
    the script's time limit: the measured t_comm, about 3.5 s of gloo
    staging at full depth, stays many times t_inner, so the decisions do
    not turn on it), 2 ranks sharing the card, ``sync_delay="auto"``:
    the measured controller, then the adaptive ladder, 14 steps of the
    40-step schedule (accumulates after steps 1, 3; outer windows after
    steps 5, 7, 9, 11, 13: the sixth window closes the first measurement,
    and a ladder that switches there dispatches the window after step 13
    on its new rung, whose quantize and dequantize launches must be
    exactly that strategy's for one window). A phase of ``two_rank_world``."""
    from repro_torch.config import ParallelConfig, TrainConfig
    from repro_torch.configs import get_config
    from repro_torch.sync import default_ladder, resolve_strategy

    cfg = get_config("gpt2-medium").replace(num_layers=AUTO_LAYERS)
    G, per, seq, steps = 2, 2, 1024, 14
    pc = ParallelConfig(data_axis_size=G, data_outer=G)
    tc = TrainConfig(**TRAIN_TC, **TRAIN_LR, global_batch_size=G * per, seq_len=seq,
                     sync_delay="auto")
    val = _gpt2_medium_val(torch, cfg, seq)
    jobs = [((cfg, tc, pc, steps), {"val_batch": val, "adaptive_sync": adaptive})
            for adaptive in (False, True)]
    outs, wall = yield jobs  # in the shared world of two ranks (``two_rank_world``)
    lines = []
    for i, adaptive in enumerate((False, True)):
        r0 = outs[0][i]
        line = {"phase": "train_dist_auto",
                "controller": "adaptive ladder" if adaptive else "measured",
                "strategy": f"auto ({'adaptive' if adaptive else 'measured'}) -> "
                            f"{r0['strategy']}",
                "config": f"gpt2-medium width, {cfg.num_layers} layers, bf16 compute, fp32 "
                          f"params", "ranks": G,
                "note": "2 ranks share one card: time-sliced contexts, not a two-GPU rate",
                "steps": steps, "windows": r0["windows"], "final": r0["controller"],
                "decisions": r0["decisions"], "final_strategy": r0["strategy"],
                "final_sync_delay": r0["sync_delay"],
                "loss": [h["loss"] for h in r0["history"]],
                "val_loss_before": r0["val_loss_before"], "val_loss_after": r0["val_loss_after"],
                "launches_per_rank": [o[i]["launches"] for o in outs],
                "peak_mem_gb_per_rank": [o[i]["peak_mem_bytes"] / 1e9 for o in outs],
                "wall_s": r0["wall_s"], "world_seconds": wall}
        # the strategy each outer window dispatched on: the configured one,
        # then whatever the decision after the window before left in place
        used = [resolve_strategy(tc).name] + [w["strategy"] for w in r0["windows"][:-1]]
        ladder = {x.name: x for x in default_ladder(resolve_strategy(tc))}
        expect = _dist_window_expect([ladder[n] for n in used], G, r0["leaves"], cfg, steps)
        line["windows_by_strategy"] = {n: used.count(n) for n in dict.fromkeys(used)}
        line["quantize_launches_per_rank"] = [o[i]["launches"]["quantize_blockwise"]
                                              for o in outs]
        line["dequantize_launches_per_rank"] = [o[i]["launches"]["dequantize_blockwise"]
                                                for o in outs]
        line["expected_quantize_dequantize"] = [expect["quantize_blockwise"],
                                                expect["dequantize_blockwise"]]
        emit(line)
        lines.append(line)
        loss = line["loss"] + [line["val_loss_before"], line["val_loss_after"]]
        if not all(math.isfinite(x) for x in loss):
            raise AssertionError(f"train_dist_auto {line['controller']}: non-finite loss")
        if adaptive and len(line["windows_by_strategy"]) < 2:
            raise AssertionError(f"train_dist_auto adaptive: no window ran on a new rung "
                                 f"(decisions {r0['decisions']})")
        got = list(zip(line["quantize_launches_per_rank"],
                       line["dequantize_launches_per_rank"]))
        if any(list(g) != line["expected_quantize_dequantize"] for g in got):
            raise AssertionError(f"train_dist_auto {line['controller']}: quantize / dequantize "
                                 f"launches {got} != {line['expected_quantize_dequantize']} "
                                 f"per rank (windows {line['windows_by_strategy']})")
        if not line["val_loss_after"] < line["val_loss_before"]:
            raise AssertionError(f"train_dist_auto {line['controller']}: validation loss did "
                                 f"not fall: {line['val_loss_before']} -> "
                                 f"{line['val_loss_after']}")
    return lines


def train_dist_ckpt(torch, layers: int = 4, counters=None):
    """GPT-2 medium width at ``layers`` layers, 2 ranks sharing the card, int8-wire:
    10 steps with outer-state offload; 6 steps without it and a save (one
    checkpoint of both ranks, in the reference's layout); a fresh run whose
    ``rejoin_bootstrap="checkpoint"`` rejoin takes the saved step's anchor;
    then a fresh world restores the checkpoint and runs to step 10 with
    offload (bit for bit the uninterrupted run, which also shows that
    offload changes no bit). With ``counters``, then the ``handoff`` phase
    on the saved checkpoint."""
    import numpy as np

    from repro_torch.config import MembershipConfig, OuterCommConfig, ParallelConfig, TrainConfig
    from repro_torch.configs import get_config
    from repro_torch.launch.train import spawn, train_jobs

    # full width; by default 4 of 24 layers: the checkpoint's bytes (2.6 GB a
    # rank, not 8.6) are what takes the time, and the whole script has a
    # time limit (``--ckpt-depth`` runs all 24)
    cfg = get_config("gpt2-medium").replace(num_layers=layers)
    G, per, seq, steps, at = 2, 2, 1024, 10, 6
    pc = ParallelConfig(data_axis_size=G, data_outer=G)
    tc = TrainConfig(**TRAIN_TC, **TRAIN_LR, global_batch_size=G * per, seq_len=seq,
                     outer_comm=OuterCommConfig(compression="int8-wire"))
    off = tc.replace(offload_outer_state=True)
    donor_tc = off.replace(membership=MembershipConfig(rejoin_bootstrap="checkpoint"))
    ck = ROOT / "build" / "ckpt_smoke"
    shutil.rmtree(ck, ignore_errors=True)
    free = shutil.disk_usage(ROOT).free
    try:
        t0 = time.perf_counter()
        # the donor run starts afresh: group 1 sits out event 0 (step 5) and
        # bootstraps right after its apply from the checkpoint saved before
        first = spawn(train_jobs, ([((cfg, off, pc, steps), {"keep_params": True}),
                                    ((cfg, tc, pc, at), {"checkpoint_dir": str(ck),
                                                         "save": True, "keep_params": True}),
                                    ((cfg, donor_tc, pc, 6),
                                     {"keep_params": True, "checkpoint_dir": str(ck),
                                      "churn": "drop:1@0,rejoin:1@1"})],),
                      nproc=G, device="cuda", timeout=DIST_DEADLINE_S)
        second = spawn(train_jobs, ([((cfg, off, pc, steps - at),
                                      {"keep_params": True, "checkpoint_dir": str(ck),
                                       "restore": True})],),
                       nproc=G, device="cuda", timeout=DIST_DEADLINE_S)
        wall = time.perf_counter() - t0
        step_dir = ck / f"step_{at:08d}"
        with np.load(str(step_dir / "outer.npz")) as data:
            saved = {k[len("anchor/"):]: torch.from_numpy(data[k])
                     for k in data.files if k.startswith("anchor/")}
        disk = sum(f.stat().st_size for f in ck.rglob("*") if f.is_file())
        handoff_line = (handoff(torch, counters, cfg, ck, at, first[0][1])
                        if counters is not None else None)
    finally:
        shutil.rmtree(ck, ignore_errors=True)
        shutil.rmtree(ck.parent / "handoff_watch", ignore_errors=True)
    full, part, donor = ([o[i] for o in first] for i in range(3))
    rest = [o[0] for o in second]
    same = all(all(torch.equal(a, b) for a, b in zip(f["params"], r["params"]))
               and all(torch.equal(a, b) for a, b in zip(f["residual"], r["residual"]))
               for f, r in zip(full, rest))
    loss_full = [h["loss"] for h in full[0]["history"]]
    loss_resumed = [h["loss"] for h in part[0]["history"] + rest[0]["history"]]
    names = [n.replace(".", "/") for n in donor[1]["param_names"]]
    donor_ok = sorted(names) == sorted(saved) and all(
        torch.equal(a, saved[n]) for a, n in zip(donor[1]["params"], names))
    gb = 1e9
    line = {"phase": "train_dist_ckpt",
            "config": f"gpt2-medium width, {layers} layers, bf16 compute, fp32 params", "strategy": full[0]["strategy"],
            "ranks": G, "steps": steps, "saved_at": at, "checkpoint_bytes_both_ranks": disk,
            "disk_free_bytes_before": free,
            "save_s_per_rank": [p["save_s"] for p in part],
            "restore_s_per_rank": [r["restore_s"] for r in rest],
            "peak_mem_gb_per_rank_offload": [f["peak_mem_bytes"] / gb for f in full],
            "peak_mem_gb_per_rank_no_offload": [p["peak_mem_bytes"] / gb for p in part],
            "resident_gb_per_rank_offload": [f["resident_bytes"] / gb for f in full],
            "resident_gb_per_rank_no_offload": [p["resident_bytes"] / gb for p in part],
            "resumed_with_offload_equals_uninterrupted": same,
            "loss_uninterrupted": loss_full, "loss_resumed": loss_resumed,
            "checkpoint_donor_bootstrap_equals_saved_anchor": donor_ok,
            "wall_s_offload_10_steps": full[0]["wall_s"],
            "wall_s_no_offload_6_steps": part[0]["wall_s"], "world_seconds": wall}
    emit(line)
    if not (same and loss_full == loss_resumed):
        raise AssertionError("train_dist_ckpt: the resumed run is not the uninterrupted one")
    if not donor_ok:
        raise AssertionError("train_dist_ckpt: the checkpoint donor is not the saved anchor")
    return line, handoff_line


def handoff(torch, counters, cfg, ck, step: int, saved):
    """The train -> serve handoff: a ``ServeEngine`` (``cfg`` in serving
    storage, other seeded weights) serves ``serve``'s traffic with a
    ``CheckpointPoller`` on group 0 of a directory that is empty until
    decode step ``K``, when ``train_dist_ckpt``'s checkpoint (rank 0's
    parameters ``saved``) appears in it. Exactly one swap, at that step
    boundary; the served leaves are the saved parameters cast to serving
    storage, bit for bit; the requests admitted after the swap give a
    fresh engine's greedy tokens on those parameters, with every logit
    within 1e-3 of max |logit|; the pool drains to empty; launches exact."""
    import numpy as np

    from repro_torch.models import registry as R
    from repro_torch.models.transformer import param_leaves, with_leaves
    from repro_torch.parallel.steps import build_paged_serve_steps
    from repro_torch.serve import CheckpointPoller, EngineConfig, PagedCacheConfig, ServeEngine

    K = 4
    watched = ck.parent / "handoff_watch"
    shutil.rmtree(watched, ignore_errors=True)
    watched.mkdir()
    slots, new_tokens, bs = 4, 32, 16
    lens = [128, 256, 384, 512] * 2
    need = -(-(max(lens) + new_tokens) // bs)
    pcfg = PagedCacheConfig(num_blocks=need * slots + 1, block_size=bs)
    ecfg = EngineConfig(max_slots=slots, max_new_tokens=new_tokens, greedy=True,
                        max_blocks_per_seq=need)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in lens]

    def engine_on(params):
        """An engine with every request submitted, keeping each request's
        logits (prefills run in submission order)."""
        eng = ServeEngine(params, cfg, build_paged_serve_steps(cfg, pcfg=pcfg, device="cuda"),
                          pcfg, ecfg)
        logits, b, order = {}, eng.bundle, iter(range(1, len(lens) + 1))

        def prefill(*args):
            lg, pools = b.prefill_step(*args)
            logits[next(order)] = [lg[0].float().cpu()]
            return lg, pools

        def decode(*args):
            lg, pools = b.decode_step(*args)
            for i, sq in enumerate(eng.slots):
                if sq is not None:
                    logits[sq.req.uid].append(lg[i].float().cpu())
            return lg, pools

        eng.bundle = dataclasses.replace(b, prefill_step=prefill, decode_step=decode)
        for p in prompts:
            eng.submit(p, new_tokens)
        return eng, logits

    serving = R.init_params(cfg, seed=1, device="cuda")
    eng, logits = engine_on(serving)
    poller = CheckpointPoller(str(watched), serving, group=0)
    swaps = []

    def on_step(e):
        if e.stats["decode_steps"] == K and not any(watched.iterdir()):
            os.rename(ck / f"step_{step:08d}", watched / f"step_{step:08d}")
        n = len(poller.swapped_steps)
        poller.on_step(e)
        if len(poller.swapped_steps) > n:
            swaps.append(e.stats["decode_steps"])

    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    results = eng.run(on_step=on_step)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}
    served = dict(param_leaves(eng.params))
    cast = {n: t.to("cuda", served[n].dtype) for n, t in zip(saved["param_names"],
                                                              saved["params"])}
    exact = sorted(cast) == sorted(served) and all(torch.equal(served[n], cast[n])
                                                   for n in served)
    fresh, fresh_logits = engine_on(with_leaves(serving, cast))
    fresh.run()
    late = [r.uid for r in results if r.uid > slots]  # admitted when the first wave drained
    tokens = {r.uid: r.tokens for r in fresh.finished}
    same_tokens = all(tokens[r.uid] == r.tokens for r in results if r.uid in late)
    err = max(_rel(torch.stack(logits[u]), torch.stack(fresh_logits[u])) for u in late)
    st = eng.stats
    L = cfg.num_layers
    expect = {"flash_attention": st["prefills"] * L, "flash_attention_bwd": 0,
              "flash_attention_tc": (st["prefills"] * L
                                     if tc_rule(cfg.dtype, cfg.resolved_head_dim) else 0),
              "flash_attention_bwd_tc": 0, "paged_decode_attention": st["decode_steps"] * L,
              "quantize_blockwise": 0, "dequantize_blockwise": 0, "pier_update": 0,
              "rmsnorm": norm_launches(cfg) * (st["prefills"] + st["decode_steps"]),
              "rmsnorm_bwd": 0}
    drained = eng.alloc.num_free == pcfg.num_blocks - 1
    line = {"phase": "handoff", "config": f"{cfg.name} {L} layers, bf16 serving storage",
            "checkpoint": f"train_dist_ckpt's step {step} (2 ranks, int8-wire), group 0",
            "appears_after_decode_step": K, "swapped_steps": poller.swapped_steps,
            "swapped_at_decode_step": swaps, "served_equal_saved_cast": exact,
            "requests_after_swap": late, "greedy_equal_fresh_engine": same_tokens,
            "max_logit_err_over_max_abs": err, "tol": 1e-3, "pool_drained": drained,
            "tokens_out": st["tokens_out"], "wall_s": wall, "launches": launches,
            "expected_launches": expect}
    emit(line)
    if poller.swapped_steps != [step] or swaps != [K]:
        raise AssertionError(f"handoff: swaps {poller.swapped_steps} at decode steps {swaps}, "
                             f"not one of step {step} at {K}")
    if not (exact and same_tokens and err <= 1e-3 and drained and late):
        raise AssertionError(f"handoff: served leaves equal {exact}, tokens equal "
                             f"{same_tokens}, logit err {err}, drained {drained}, late {late}")
    if launches != expect:
        raise AssertionError(f"handoff: launches {launches} != {expect}")
    return line


def elastic_phases(torch, counters, beside):
    """``elastic_vs_cpu`` and ``switch_vs_cpu``: each card half, then the
    CPU halves in a thread, on all but ``WORLD_CORES`` of the host's
    cores, while ``beside`` runs (a function of no arguments that runs the
    ranks of a spawned world, each a process of its own, and then checks
    their results): the checks are the same, and the CPU halves use cores
    the script's own process would leave idle while it waits for the
    ranks. Returns the card runs' launches and ``beside``'s result."""
    from concurrent.futures import ThreadPoolExecutor

    threads = torch.get_num_threads()

    def cpu_halves():
        cores = max(1, len(os.sched_getaffinity(0)) - WORLD_CORES)
        torch.set_num_threads(min(threads, cores))  # this thread's pool
        for _, finish in cases:
            finish()

    with large_allocations_on_the_heap():
        cases = elastic_vs_cpu(torch, counters) + switch_vs_cpu(torch, counters)
        free_cuda(torch)
        with ThreadPoolExecutor(max_workers=1) as pool:
            halves = pool.submit(cpu_halves)
            try:
                out = beside()
            finally:
                halves.result()  # its failure, if any, is raised here
    torch.set_num_threads(threads)
    free_cuda(torch)
    return [ln for ln, _ in cases], out


# the CUDA-core flash kernels' entries of the kernels line (their counters
# count the tensor-core launches too)
CUDA_CORE_FLASH = ("flash_attention", "flash_attention_bwd")


class _CpuHalvesHere:
    """``CpuHalvesAhead``'s ``get`` for a study flag: each CPU half computed
    in this process when asked for."""

    def __init__(self, **jobs):
        self.jobs = jobs

    def get(self, key: str):
        t0 = time.perf_counter()
        out = self.jobs[key]()
        out["seconds"] = time.perf_counter() - t0
        return out, 0.0


def breakdowns(torch, counters):
    """``--breakdowns``: the reported-only profiles of the device time by
    kernel group, each on the run it profiled in the whole script before
    (``breakdown``: GPT-2 XL's prefills and decode steps; ``train_breakdown``
    and the dispatch breakdowns of ``train`` and ``train_compressed``;
    ``train_qwen3_breakdown``; ``train_moe_breakdown``)."""
    from repro_torch.config import OuterCommConfig
    from repro_torch.configs import get_config
    from repro_torch.models import registry as R

    cfg = get_config("gpt2-xl")
    params = R.init_params(cfg, seed=0, device="cuda")
    breakdown(torch, params, cfg)
    del params
    free_cuda(torch)
    run, _ = train(torch, counters)
    train_breakdown(torch, run)
    dispatch_breakdown(torch, run, "train")
    del run
    free_cuda(torch)
    run, _ = train(torch, counters, phase="train_compressed",
                   outer_comm=OuterCommConfig(compression="quantize", bits=8, block=256))
    dispatch_breakdown(torch, run, "train_compressed")
    del run
    free_cuda(torch)
    run, _ = train(torch, counters, phase="train_qwen3", arch="qwen3-1.7b")
    train_breakdown(torch, run, phase="train_qwen3_breakdown")
    del run
    free_cuda(torch)
    train_moe(torch, counters, profile=True)


def main(argv) -> int:
    if len(argv) == 2 and argv[0] == "--cpu-halves":  # the process CpuHalvesAhead starts
        return cpu_halves_ahead(argv[1])
    studies = {"--witness-lr", "--build-times", "--int8-kv-depth", "--flash-precision",
               "--norm-quant", "--elastic", "--ckpt-depth", "--families", "--recurrent",
               "--moe", "--moe-train", "--whisper", "--breakdowns", "--train-recurrent"}
    if len(argv) > 1 or not set(argv) <= studies:
        print(f"usage: chip_smoke.py [{' | '.join(sorted(studies))}]", file=sys.stderr)
        return 2
    # The full-width training phases hold ~61-73 GB of state on an 80 GB card;
    # expandable segments keep the caching allocator from fragmenting it.
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (sets full-fp32 matmul flags)
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as DK
    from repro_torch.kernels import flash_attention as FK
    from repro_torch.kernels import pier_update as PK
    from repro_torch.kernels import quantize as QK
    from repro_torch.kernels import rmsnorm as RK

    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    _build.lib()
    emit({"phase": "build", "seconds": _build.build_seconds,
          "library": str(_build.library_path().relative_to(ROOT)),
          "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "host_threads": {"torch": torch.get_num_threads(),
                           "cores_usable": len(os.sched_getaffinity(0))}})

    counters = {"flash_attention": Counter(FK), "flash_attention_bwd": Counter(FK, "bwd_launches"),
                "flash_attention_tc": Counter(FK, "tc_launches"),
                "flash_attention_bwd_tc": Counter(FK, "tc_bwd_launches"),
                "paged_decode_attention": Counter(DK), "quantize_blockwise": Counter(QK),
                "dequantize_blockwise": Counter(QK, "dequantize_launches"),
                "pier_update": Counter(PK), "rmsnorm": Counter(RK),
                "rmsnorm_bwd": Counter(RK, "bwd_launches")}
    if argv == ["--build-times"]:
        build_times(torch)
        return 0
    if argv == ["--witness-lr"]:
        witness_lr(torch, counters)
        return 0
    if argv == ["--int8-kv-depth"]:
        int8_kv_depth(torch)
        return 0
    if argv == ["--flash-precision"]:
        flash_precision(torch, counters)
        return 0
    if argv == ["--elastic"]:
        train_elastic(torch, counters)
        free_cuda(torch)
        elastic_phases(torch, counters, beside=lambda: two_rank_world(
            torch, [train_dist_elastic_vs_sim(torch), train_dist_auto(torch)]))
        free_cuda(torch)
        train_dist_ckpt(torch)
        return 0
    if argv == ["--ckpt-depth"]:
        train_dist_ckpt(torch, layers=24)
        return 0
    if argv == ["--families"]:
        serve_families(torch, counters)
        return 0
    if argv == ["--breakdowns"]:
        breakdowns(torch, counters)
        return 0
    results = {}
    timer = Timer(torch)
    if argv == ["--recurrent"]:
        check_flash(torch, timer, results)
        check_decode(torch, timer, results)
        del timer
        emit({"recurrent_kernels": [results["flash_attention_tc256"],
                                    results["flash_attention"],
                                    results["paged_decode_attention"]]})
        for arch in RECURRENT:
            serve_recurrent(torch, counters, arch)
        flash_tc256_vs_plain(torch, counters)
        with large_allocations_on_the_heap():
            recurrent_vs_cpu(torch, counters)
        return 0
    if argv == ["--moe"]:
        check_quantize(torch, timer, results)
        check_flash(torch, timer, results)
        check_decode(torch, timer, results)
        del timer
        emit({"moe_kernels": {
            "flash_attention_tc112": results["flash_attention_tc112"],
            "flash_attention": results["flash_attention"]["kimi_k2_hd112"],
            "paged_decode_attention":
                results["paged_decode_attention"]["families"]["kimi_k2_gqa8_hd112"],
            "quantize_blockwise": results["quantize_blockwise"]["kimi_k2_shape"]}})
        for arch in MOE_ARCHS:
            serve_moe(torch, counters, arch, MOE_STUDY_LAYERS[arch])
        serve_moe(torch, counters, "kimi-k2-1t-a32b", MOE_STUDY_LAYERS["kimi-k2-1t-a32b"],
                  int8_kv=True)
        flash_tc112_vs_plain(torch, counters)
        with large_allocations_on_the_heap():
            moe_vs_cpu(torch, counters)
        return 0
    if argv == ["--whisper"]:
        check_flash(torch, timer, results)
        check_decode(torch, timer, results)
        del timer
        emit({"whisper_kernels": {
            "flash_attention_tc": results["flash_attention_tc"]["whisper"],
            "flash_attention": results["flash_attention"]["whisper"],
            "paged_decode_attention":
                results["paged_decode_attention"]["families"]["whisper_cross"]}})
        serve_whisper(torch, counters)
        whisper_tc_vs_plain(torch, counters)
        with large_allocations_on_the_heap():
            whisper_vs_cpu(torch, counters,
                           _CpuHalvesHere(whisper_vs_cpu=_whisper_vs_cpu_cpu_half))()
        return 0
    if argv == ["--moe-train"]:
        check_rmsnorm(torch, timer, results)
        check_flash_bwd(torch, timer, results)
        del timer
        emit({"moe_train_kernels": {
            "rmsnorm_bwd": {k: results["rmsnorm_bwd"]["other_shapes"][k]
                            for k in ("deepseek_train_q_norm", "deepseek_train_kv_norm")},
            "flash_attention_bwd": results["flash_attention_bwd"]["kimi_k2_hd112"]}})
        with large_allocations_on_the_heap():
            moe_vs_cpu(torch, counters)
        free_cuda(torch)
        train_moe(torch, counters, profile=True)
        two_rank_world(torch, [train_dist_vs_sim(torch)])
        return 0
    if argv == ["--train-recurrent"]:
        check_flash_bwd(torch, timer, results)
        del timer
        emit({"train_recurrent_kernels": {
            "flash_attention_bwd_tc": results["flash_attention_bwd_tc"]["whisper"],
            "flash_attention_bwd": {
                k: results["flash_attention_bwd"][k]
                for k in ("recurrentgemma_hd256", "whisper")}}})
        train_tc_vs_plain(torch, counters)
        train_tc_floor_rule(torch, counters)
        train_recurrent(torch, counters, profile=True)
        train_whisper(torch, counters)
        with large_allocations_on_the_heap():
            whisper_vs_cpu(torch, counters,
                           _CpuHalvesHere(whisper_vs_cpu=_whisper_vs_cpu_cpu_half))()
            recurrent_vs_cpu(torch, counters, sim_eps=RECURRENT_SIM_EPS)
        return 0
    if argv == ["--norm-quant"]:
        check_quantize(torch, timer, results)
        check_dequantize(torch, timer, results)
        check_rmsnorm(torch, timer, results)
        emit({"norm_quant": list(results.values())})
        return 0
    # the CPU halves of four card-vs-CPU phases, ahead, in a process of
    # their own on the cores this process leaves idle
    ahead = CpuHalvesAhead()
    try:
        return _whole_script(torch, counters, timer, results, ahead, smi, t_start)
    finally:
        ahead.close()


def _whole_script(torch, counters, timer, results, ahead, smi, t_start) -> int:
    """Every phase of ``python3 chip_smoke.py`` after the build."""
    check_quantize(torch, timer, results)
    check_dequantize(torch, timer, results)
    check_flash(torch, timer, results)
    check_decode(torch, timer, results)
    check_pier_update(torch, timer, results)
    check_flash_bwd(torch, timer, results)
    check_rmsnorm(torch, timer, results)
    check_adamw(torch, timer)
    del timer
    torch.cuda.empty_cache()
    check_ring(torch, results)

    fp32_runs = e2e_vs_cpu(torch, counters)

    from repro_torch.configs import get_config
    from repro_torch.models import registry as R

    cfg = get_config("gpt2-xl")
    params = R.init_params(cfg, seed=0, device="cuda")
    serves = [serve(torch, params, cfg, counters, quantized=q) for q in (False, True)]
    del params
    torch.cuda.empty_cache()
    cfg = get_config("qwen3-1.7b")
    params = R.init_params(cfg, seed=0, device="cuda")
    serves += [serve(torch, params, cfg, counters, quantized=q, phase="serve_qwen3")
               for q in (False, True)]
    qwen3_int8_kv(torch, params, cfg)
    del params
    torch.cuda.empty_cache()
    # int8 KV and full depth: --families
    serves += serve_families(torch, counters, kvs=(False,), layers=FAMILY_SCRIPT_LAYERS)
    serves += [serve_recurrent(torch, counters, arch, RECURRENT_SCRIPT_LAYERS.get(arch))
               for arch in RECURRENT]
    serves += [serve_moe(torch, counters, arch, layers)
               for arch, layers in MOE_SCRIPT_LAYERS.items()]
    serves.append(serve_whisper(torch, counters))

    # the card halves of the phases whose CPU halves run ahead; they are
    # held against them after the training runs
    finishes = [train_vs_cpu(torch, counters, ahead),
                train_compressed_vs_cpu(torch, counters, ahead)]
    free_cuda(torch)
    finishes.append(qwen3_vs_cpu(torch, counters, ahead))
    free_cuda(torch)
    finishes.append(whisper_vs_cpu(torch, counters, ahead))
    free_cuda(torch)
    flash_tc_vs_plain(torch, counters)
    free_cuda(torch)
    flash_tc256_vs_plain(torch, counters)
    flash_tc112_vs_plain(torch, counters)
    whisper_tc_vs_plain(torch, counters)
    train_tc_vs_plain(torch, counters)
    run, train_line = train(torch, counters)
    del run
    free_cuda(torch)
    from repro_torch.config import OuterCommConfig

    run, compressed_line = train(torch, counters, phase="train_compressed",
                                 outer_comm=OuterCommConfig(compression="quantize", bits=8,
                                                            block=256))
    del run
    free_cuda(torch)
    run, qwen3_line = train(torch, counters, phase="train_qwen3", arch="qwen3-1.7b")
    del run
    free_cuda(torch)
    run, minicpm_line = train(torch, counters, phase="train_minicpm", arch="minicpm-2b",
                              cut={"num_layers": 4}, steps=20, schedule=MINICPM_SCHEDULE)
    del run
    free_cuda(torch)
    moe_line = train_moe(torch, counters)
    recurrent_lines = train_recurrent(torch, counters)
    whisper_line = train_whisper(torch, counters)
    elastic_line = train_elastic(torch, counters)
    free_cuda(torch)
    # the CPU halves computed ahead, against the card halves; then, with
    # that process ended (its heap keeps what its halves allocated), the
    # card-vs-CPU phases whose CPU halves this process computes itself, on
    # every core: the two processes' peaks together outgrow a 96 GiB host
    with large_allocations_on_the_heap() as raised:
        emit({"phase": "host_malloc", "thresholds_raised": raised})
        while finishes:  # each card half's host copies freed once compared
            fp32_runs += finishes.pop(0)()
        ahead.close(wait=60.0)
        fp32_runs += families_vs_cpu(torch, counters)
        fp32_runs += recurrent_vs_cpu(torch, counters)
        fp32_runs += moe_vs_cpu(torch, counters)
    free_cuda(torch)
    trains = [train_line, compressed_line, qwen3_line, minicpm_line, moe_line,
              *recurrent_lines, whisper_line, elastic_line]
    runs = serves + trains
    elastic_runs, (vs_sim, dists, elastic_vs_sim, auto) = elastic_phases(
        torch, counters, beside=lambda: two_rank_world(
            torch, [train_dist_vs_sim(torch), train_dist(torch),
                    train_dist_elastic_vs_sim(torch), train_dist_auto(torch)]))
    fp32_runs += elastic_runs + vs_sim + elastic_vs_sim
    dists += auto
    free_cuda(torch)
    _, handoff_line = train_dist_ckpt(torch, counters=counters)

    def count(launches, name):  # one run's launches of kernel `name`
        n = launches.get(name, 0)
        if name in CUDA_CORE_FLASH:  # the counter counts both routes
            n -= launches.get(name + "_tc", 0)
        if name == "flash_attention_tc":  # and the hd-112 and hd-256 forwards
            n -= sum(launches.get(f"flash_attention_tc{hd}", 0) for hd in (112, 256))
        return n

    def dist_launches(line, name):  # every rank's count
        return sum(count(ln, name) for ln in line["launches_per_rank"])

    kernels = []
    for name in ("flash_attention_tc", "flash_attention_tc112", "flash_attention_tc256",
                 "flash_attention_bwd_tc",
                 "paged_decode_attention",
                 "quantize_blockwise", "pier_update", "dequantize_blockwise",
                 "ring_allgather", "shard_scatter", "rmsnorm", "rmsnorm_bwd",
                 *CUDA_CORE_FLASH):
        entry = dict(results[name])
        single = sum(count(r["launches"], name) for r in runs + [handoff_line])
        main_path = single + sum(dist_launches(d, name) for d in dists)
        fp32 = sum(count(ln, name) for ln in fp32_runs)
        # the bf16 main paths run the tensor-core flash kernels only (at hd
        # 112, Kimi-K2's prefill, counted in serve_moe's line; at hd 256,
        # RecurrentGemma's prefill, the forward of flash_attention_tc256.cu,
        # counted in serve_recurrent's); the CUDA-core forward and backward
        # run in the fp32 card-vs-CPU phases and the Trainer's fp32 cases,
        # counted with them
        entry["launches"] = main_path + fp32 if name in CUDA_CORE_FLASH else main_path
        entry["launches_by_path"] = {
            "serve": sum(count(r["launches"], name) for r in serves),
            "serve_by_run": {r["run"] if "run" in r else f"{r['phase']}_{r['kv']}":
                             count(r["launches"], name) for r in serves},
            "handoff": count(handoff_line["launches"], name),
            "train": sum(count(r["launches"], name) for r in trains),
            "train_by_run": {r.get("run", r["phase"]): count(r["launches"], name)
                             for r in trains},
            "train_dist_by_strategy": {d["strategy"]: dist_launches(d, name) for d in dists},
            "fp32_vs_cpu_phases": fp32}
        if name in ("flash_attention_tc", "flash_attention", "flash_attention_bwd_tc",
                    "flash_attention_bwd"):
            # the forwards or backwards whose keys are of another length than
            # the queries (Whisper's cross-attention), a share of the
            # launches above: bf16 on the tensor cores, fp32 on the CUDA ones
            cross = "flash_attention_cross" + ("_bwd" if "bwd" in name else "")
            entry["cross_launches"] = (
                sum(count(r["launches"], cross) for r in runs) if name.endswith("_tc") else
                sum(count(ln, cross) for ln in fp32_runs))
        if entry["launches"] == 0:
            raise AssertionError(f"kernel {name} was not launched: {entry['launches_by_path']}")
        kernels.append(entry)
    emit({"phase": "done", "card": smi, "seconds": time.perf_counter() - t_start})
    emit({"kernels": kernels})
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
