"""On-card smoke test of the PyTorch / CUDA port (``src/repro_torch``).

Run from the repository root on a host with one NVIDIA GPU:

    python3 chip_smoke.py

``python3 chip_smoke.py --step-times N`` only builds the kernels and times
N full-width VGG-16 AdamW steps and the weight-gradient kernel at the
step's shapes (one JSON line): copied into another checkout, it measures
that checkout's package the same way, for a comparison in one call.

Every phase runs on a fresh, empty autotune cache in a temporary
directory (``REPRO_TORCH_CONVTUNE_CACHE``, removed at exit), so no run
reads a cache an earlier run left or leaves one for a later run; the
earlier phases' engines prewarm it with model-ranked records, which are
the planner's default plans, so their numbers stay comparable across
runs.

Phases, each raising on failure (each prints its seconds):

1. device — the card's name and power limit (``nvidia-smi``);
2. build  — a fresh ``nvcc`` build of every kernel source for sm_90a, one
   process per source, all started together; the flash-attention
   library's SASS (``cuobjdump``) must show TF32 tensor-core instructions
   in each narrow-route instance;
3. kernel check — each conv kernel (carry, halo) against its plain PyTorch
   version at the shapes of full-width VGG-16 (all 13 layers), plus one
   stride-2 and one depthwise case, at batch 8 and again at batch 1:
   max-abs error within 1e-4 * max(1, max|plain|) (sums of up to 4,608
   f32 terms taken in another order), carry == halo bitwise, and each
   one's time and TFLOP/s and the plan's blocks beside the plain
   version's and ``F.conv2d``'s (TF32 off) times and the card's bound;
4. int8 kernel check — the int8 kernel (``csrc/trim_conv2d_q8.cu``,
   carry and halo) at the same 15 shapes at batch 8 and 1, on int8 data
   with a nonzero zero point as the 'same' padding: bitwise equal to its
   plain version and carry == halo bitwise, the quantize pass of an f32
   input on the card bitwise equal to the CPU's; the int8 library's
   ptxas registers and spill by instance and its SASS, where every
   tensor-core instance must issue ``IMMA``; each layer's route, warps,
   weight stages, blocks and instance registers, each dataflow's device
   time from CUDA graphs (the ``__dp4a`` design's in brackets), carry
   through the wrapper eagerly, TOPS, the plain version's time,
   ``torch._int_mm`` on the layer's im2col GEMM shape and ``F.conv2d``
   in f32 (TF32 off; context only: no PyTorch call computes the int8
   function) and the bound (operations at 1,979 TOPS, int8 in and f32
   out at 3.35 TB/s);
   every VGG-16 layer on a tensor-core route;
5. backward kernel check — at the same 15 shapes: the weight-gradient
   kernel against its plain version within 1e-4 * max|plain| (see
   ``WGRAD_TOLERANCE``), two launches bitwise equal, and its time beside
   the plain version's, ``torch.nn.grad.conv2d_weight``'s (TF32 off) and
   the bound; the card's resident blocks an SM of each GEMM tile equal
   to the plan's ``WGRAD_BLOCKS_PER_SM``; the input gradient (the carry
   kernel on the dilated cotangent) against the plain forward on the
   same padded cotangent, within the forward's tolerance; then the bf16
   entry (``trim_conv2d_wgrad_bf16``, PR 31) at VGG-16's 13 layers, the
   112^2 depthwise case, AlexNet conv1's sub-kernels and ResNet-18's
   7x7/2 Cin-3 stem at batch 8, each case's route printed (PR 33: VGG-16
   conv2-13 must run ``mma`` on the bf16 tensor cores, the others keep
   gemm or depthwise): on routes gemm / depthwise its f32 sums bitwise
   the f32 entry's on the widened operands, on route mma within
   (positions a chunk + chunks) 2^-22 sum|x dz| of the float64 sums;
   repeatable, and within ``WGRAD_TOLERANCE`` of its plain version; the
   13 VGG-16 layers faster than the f32 entry's on the same values; device
   ms from CUDA graphs beside the f32 entry's, ``conv2d_weight`` on bf16,
   the plain version's, the bound (989 TFLOP/s of bf16 or 2 bytes an
   element at 3.35 TB/s) and the FFMA ceiling (67 TFLOP/s);
6. fused kernel check — full-width VGG-16's two-layer groups
   conv1..conv2 (tile 8 x 16) and conv3..conv4 (4 x 8) at fixed tiles, every
   group the plan picks for full-width VGG-16 (its description is
   printed) and for VGG-16 at 1/16 width (``fused_topo``; at least one
   at each batch), each at batch 8 and 1, and the small geometry chains
   of the CPU tests (a 'valid' strided stage with an overlapping 3/2
   pool, a pool-free chain) at several tiles: the fused kernel against
   its plain version within the forward tolerance and bitwise equal to
   the per-layer carry chain (``reference_chain``); each group's tile,
   blocks, shared memory and per-stage C_out tiles and passes; for the
   full-width groups also its time and TFLOP/s beside the chain's, the
   plain version's, the ``F.conv2d`` + ``F.max_pool2d`` chain's (TF32
   off; no single PyTorch call computes a group) and the bound, with the
   plan's executed and per-layer bytes; the fused kernel's registers and
   spill as ptxas reports them;
7. rectangular kernel check — AlexNet conv1's four sub-kernel shapes of
   the kernel tiling (3x3, 3x2, 2x3, 2x2; stride 4, Cin 3, Cout 96, the
   full-width 'valid' slices of a 227x227 input) at batch 8 and 1: carry
   and halo against the plain version within ``TOLERANCE`` and bitwise
   equal to each other, the weight-gradient kernel against its plain
   version within ``WGRAD_TOLERANCE`` and two launches bitwise equal;
   each one's time;
8. K > 8 check — ``ops.conv2d``'s adder tree against the plain K x K
   conv: AlexNet conv1 (K 11, stride 4, batch 8), K 9 'same', a depthwise
   K 9, and the P = 14 patch stem on a 336x336 tile at D 1024 (25
   sub-kernels); one carry launch a sub-kernel; K 11 and K 9 under
   autograd (gelu), dx, dw and db against autograd of ``impl="ref"``
   (``GRAD_TOLERANCE``);
9. AlexNet per-layer table at batch 8 and 1 — each conv's carry and halo
   device time (CUDA graphs), conv1 as the adder tree's total with its
   sub-kernels, its adds + epilogue and its slices timed apart,
   ``F.conv2d`` (TF32 off) as a yardstick, the bound and the launches;
10. serve — full-width VGG-16 (1000 classes, seeded random weights) served
   through ``ServingEngine`` on buckets (1, 2, 4, 8): a seeded Poisson
   trace on the carry kernel, then part of it on the halo kernel and
   with ``fused=True`` (the plan's fused groups, the rest per layer);
   then VGG-16/16 on the carry kernel and with ``fused=True``
   (serve[fused]); every served row must bit-match ``forward_one`` (halo
   and fused rows: the carry rows too); a per-layer forward must launch
   its kernel 13 times, a fused one the fused kernel once per fused
   group of its bucket's plan and the carry kernel for the other
   layers; one image's logits must agree with the ``impl="ref"``
   oracle;
11. serve[int8] — the same full-width VGG-16, each conv calibrated to int8
   (``layers.calibrate_conv2d``) on its input in the f32 forward over 8
   seeded images, served through ``ServingEngine`` on buckets (1, 2, 4,
   8) on the int8 kernel: the carry trace, then part of it on halo;
   every row bit-matches ``forward_one`` (halo rows the carry rows too),
   a forward launches the int8 kernel 13 times and no f32 conv kernel,
   one image's logits equal the ``impl="ref"`` int8 chain
   (``conv2d_quantized`` a layer) bitwise; the logits' max deviation
   from the f32 model's and the top-1 agreement are printed;
12. serve[AlexNet] — full-width AlexNet (227x227, 1000 classes, seeded
   random weights) served on buckets (1, 2, 4, 8): 48 seeded Poisson
   requests on the carry kernel and on the halo kernel, 16 with
   ``fused=True`` (the plan gives single-stage groups: per layer); every
   row bit-matches ``forward_one`` (halo and fused rows the carry rows
   too), a forward launches the kernel 20 times (conv1's 16 sub-kernels
   and one a layer for the other four), one image's logits agree with
   the ``impl="ref"`` chain; p50 and p99;
13. graph — the DAG topologies (``models.layers.cnn_apply_from_graph``):
   first the geometries they bring to the kernels (ResNet-18's 7x7/2
   'same' stem at Cin 3, batch 8 and 1; its 1x1/2 'valid'
   down-projection; U-Net's 1x1 head): carry and halo against the plain
   version and bitwise equal, wgrad against its plain version and
   repeatable, dx against ``ref``; then full-width ResNet-18 (1000
   classes, seeded random weights) at batch 8 and 1, per node on carry
   and halo and ``fused=True`` (layer1's two pairs fused), halo and
   fused bitwise equal to carry, the logits against ``impl="ref"``
   (``TOLERANCE``), ms a forward (eager, and device only from CUDA
   graphs) beside every conv as ``F.conv2d`` (TF32 off), each fused
   group's time beside its per-layer chain's, launches and peak memory,
   and a per-node table (ms, TFLOP/s, blocks, ``F.conv2d``, bound);
   d/dx and d/dparams of a loss through ``TrimCNN(trainable=True)``
   (gelu, batch 8) against ``impl="ref"`` on the kernels' pool picks
   (``GRAD_TOLERANCE``); U-Net at the JAX defaults (batch 8) per node
   and fused (bitwise), against ``impl="ref"``, ms a forward, its groups
   and each fused one's time beside its chain's (the last ends in the
   1x1 head); ``autotune.tune_graph`` of ResNet-18 at batch 8: model
   records move no plan, the packed tree gives the per-node output
   bitwise, and after a measured sweep the forward on its records is
   still bitwise equal (its ms printed);
14. train — full-width VGG-16 (224x224, 1000 classes, seeded weights and
   data, batch 8): the step-1 gradient of every leaf against autograd of
   ``impl="ref"`` on the kernels' branch (``branch_matched_oracle``)
   within ``GRAD_TOLERANCE``, then 6 AdamW steps of
   ``launch.train_cnn.train_step``, each with exactly 25 carry launches
   (13 forward, 12 input gradients: conv1's input needs none) and 13
   weight-gradient calls, a finite loss, and step 1 run again from the
   same state giving bitwise equal parameters; ms per step and peak
   device memory;
15. train[fused] — one VGG-16/16 AdamW step (batch 8) with ``fused=True``
   and the same step per layer from the same state: gradients and the
   parameters after it bitwise equal, with 25 carry, 13 weight-gradient
   and one fused launch per fused group (the backward recomputes each
   group per layer);
16. trainer — ``launch.train_cnn.train`` at the example's settings (50
   steps, batch 16): the mean of the last five losses below the first
   five's minus 0.1;
17. autotune — on an autotune cache of its own: a measured
   ``autotune.tune_network`` (the leading candidates timed from CUDA
   graphs on the card) of full-width VGG-16 in f32 and int8
   (``conv2d_q8:``) and of AlexNet (conv1, K 11, skipped), each at batch
   8 and 1; per layer the default plan and the tuned one (strip, band,
   C_out tile, dataflow, segments) and their device ms, timed in turns in
   this call, and the sums; every tuned output through ``ops.conv2d``
   (which must launch the record's dataflow once) bitwise equal to the
   default plan's; ``tune_backward_shapes`` of the trainer (measured)
   and its AdamW step with the records against without, gradients within
   ``GRAD_TOLERANCE``, two steps with the records bitwise equal; then
   full-width VGG-16 served after ``prewarm(tune=True)`` with
   ``tune_kwargs={"measure": True}`` on buckets (1, 2, 4, 8): 48 seeded
   Poisson requests at 200 req/s, no cold tune, each layer launching its
   record's kernel, every row bitwise equal to ``forward_one``; p50, p99,
   the launches and the tuner's seconds;
18. attention kernel check — the flash-attention kernel against its plain
   version (``ATTN_TOLERANCE``) at (a) the LM prefill's shape, B=2,
   L=4096, Hq=16, Hkv=2, D=128, causal; (b) a 17-query continuation of
   4096 keys; (c) recurrentgemma-2b's geometry, Hq=10, Hkv=1, D=256,
   window 2048, soft cap 30; (d) (a) without the causal mask; (e) ragged
   Lq=17 / Lk=47; (f) head_dim 320 and (g) 512 with a 512 window, the
   wide-head route (B=1, L=2048, Hq=8, Hkv=2); seamless-m4t-large-v2's
   calls (MHA, Hq=Hkv=16, D=64, B=2): its encoder's non-causal 4096 x
   4096 (the prefill's cross call too), its decoder's causal one, and
   cross calls of 1024 queries onto 4096 keys and 4096 onto 1024; each
   one's time beside
   the plain version's and two bounds, its route's (3xTF32 on the tensor
   cores for D <= 256, f32 FFMA above) and the FFMA one, and for (a)
   ``F.scaled_dot_product_attention`` (the yardstick; the port never
   calls it);
19. LM prefill — full-width qwen2.5-3b (36 layers, 3.4 B parameters drawn
   on the card) through ``steps.make_prefill_step`` on 2 x 4096 seeded
   tokens, reduced from the JAX ``prefill_32k`` plan (32 x 32768, whose
   f32 logits alone would take 637 GB): with ``attn_impl="flash"``
   exactly 36 kernel launches a forward, finite logits, ms per forward and
   peak memory; with ``"ref"`` none.  Under the JAX initialiser the
   36-layer function is chaotic (f32 summation differences grow ~10x a
   layer, PERF.md §6), so the whole-depth flash-vs-ref difference is
   printed, and what is checked is (i) every layer's attention, flash
   against ref on the flash forward's own activations
   (``LM_LAYER_TOLERANCE``), (ii) every layer's attention against a
   float64 oracle, the kernel's error at most ``F64_FACTOR`` times the
   f32 ref's (the f32 error both carry at logits of |s| ~ 2000), and
   (iii) the logits and next tokens of the depth-1 cut of the same model
   (``LM_TOLERANCE``);
20. LM serve — ``launch.serve.serve_batch`` at full width, batch 4, prompt
   16, gen 32: tokens/s; the decode path (KV caches, ``decode_attention``,
   no kernel) against the flash prefill, position by position, on a
   256-token prompt at the depth-1 cut (checked, ``LM_TOLERANCE``) and at
   the serve prompt's last position at full depth (printed);
21. conv1d kernel check — the causal depthwise conv1d kernel against its
   plain version and the ``ref`` oracle, bit for bit, at falcon-mamba-7b's
   prefill shape (B 2, L 2048, D 8192, K 4), contiguous and as the mixer's
   strided half of the in-projection, and at edge cases (runs that do not
   divide L, L < K-1, D = 5 and 24, K = 2 and 3, B = 3, L = 1) and K = 9
   (at the prefill's shape) and 16 (the runtime-K instance), and at
   recurrentgemma-2b's prefill shape (B 2, L 4096, D 2560, K 4); at the
   prefills' shapes its device ms from CUDA graphs over input copies that
   outgrow the L2 (``rotating_ms``) beside the plain version's,
   ``F.conv1d``'s on input laid out (B, D, L) (TF32 off, timed the same
   way), the plan's bound and the share of it, the wrapper's host us a
   call and the plan's runs, channel warps and halo share;
22. mamba prefill — full-width falcon-mamba-7b (64 layers, 7.27 B
   parameters drawn on the card, after qwen2.5-3b's are freed) through
   ``steps.make_prefill_step`` on 2 x 2048 seeded tokens: exactly 64
   ``trim_conv1d`` launches a forward, finite logits, ms per forward, peak
   memory, and the shares of one layer's conv and selective scan (x 64) in
   the forward; the residual stream after every layer, full-sequence
   mixer against the stepped one, at full depth on a 64-token prompt
   (printed); prefill (``make_prefill_step``) against token-by-token
   decode (``api.decode``), the logits at every position (checked,
   ``MAMBA_TOLERANCE``), at the depth-1 and depth-2 cuts on a 128-token
   prompt and at full depth on the 64-token one;
23. mamba serve — ``serve_batch`` at full width, batch 4, prompt 16, gen
   32, through the conv windows and SSM states: tokens/s, ms per decode
   step and the step's device-busy share (``torch.profiler``);
24. recurrentgemma prefill — full-width recurrentgemma-2b (26 layers, 18
   rec + 8 local attention, 2.89 B parameters drawn on the card after
   falcon-mamba-7b's are freed) through ``steps.make_prefill_step`` on
   2 x 4096 seeded tokens (twice the 2048 window, so the window binds):
   exactly 18 ``trim_conv1d`` and 8 ``flash_attention`` launches a
   forward, finite logits, ms per forward and peak memory; the
   whole-depth flash-vs-ref difference (printed); every att layer's
   attention, flash against ref on the flash forward's own activations
   (``LM_LAYER_TOLERANCE``), and the free-running streams' distance
   after every layer (printed); the shares of one rec layer's RG-LRU scan
   (plain PyTorch) and conv (x 18) and one att layer's kernel launch and
   sublayer (x 8) in the forward; the logits and next tokens of the
   depth-3 cut (one (rec, rec, att) period), flash against ref
   (``LM_TOLERANCE``);
25. recurrentgemma ring wrap — at the depth-3 cut, batch 1, a prompt of
   window + 64 = 2112 tokens: prefill against token-by-token decode
   through the 2048-slot ring caches, the logits at every position
   (checked, ``RGEMMA_TOLERANCE``), before and after the wrap;
26. recurrentgemma serve — ``serve_batch`` at full width, batch 4, prompt
   16, gen 32, through the ring caches, conv windows and LRU states:
   tokens/s, ms per decode step and the step's device-busy share;
27. flash backward check — the backward kernels (dQ with the rows'
   statistics, the query heads' partial dK / dV, their sum) against their
   plain version on the same lse (``BWD_TOLERANCE``; the sum bitwise),
   two calls bitwise equal, the forward's o bitwise the same with and
   without its lse output and that lse against the plain forward's, at
   (t) the LM training shape (B 2, L 1024, Hq 16, Hkv 2, D 128, causal),
   (c) recurrentgemma-2b's (B 1, L 4096, Hq 10, Hkv 1, D 256, window
   2048, cap 30), a GQA group of 7 at D 64, Lq 256 < Lk 1024 and
   seamless-m4t-large-v2's training calls (B 2, Hq = Hkv = 16, D 64:
   1024 x 1024 causal and non-causal, 1024 queries onto 512 keys); each
   case's ms (the whole backward and each kernel), TFLOP/s and blocks
   beside the forward's, the plain backward's, the 3xTF32 and FFMA
   bounds and, for (t) and the G=7 case, SDPA's forward + backward and
   backward (f32, TF32 off; the yardstick, never called by the port);
28. LM train — full-width qwen2.5-3b (36 layers, 3.40 B parameters, f32,
   remat, flash) through ``launch.train.main``: 4 AdamW steps at batch 2
   x 1024 tokens of the copy task, each loss finite, exactly 72 flash
   forward (36 + 36 in the recompute), 36 dQ, 36 dK/dV and 36 partial-sum
   launches a step, ms a step, peak memory and each step's grad norm;
   then the
   first-step gradients (1 x 256 tokens): at the depth-2 cut the backward
   kernels against the plain backward in float64 under the same forward
   (``BWD_TOLERANCE``, and at most the f32 plain backward's distance
   from it) and flash against ref (``LM_GRAD_TOLERANCE``),
   chunked against ref beside them; at full depth flash against ref
   (printed), the gradient finite and its float64 norm; every layer's
   attention backward on the flash forward's activations against
   float64, the kernels' error at most ``F64_FACTOR`` times the f32 ref
   oracle's;
29. LM resume — qwen2.5-3b SMOKE widths on the kernels (flash, remat): 2
   steps, a checkpoint (``repro_torch.checkpoint``), a restore into a
   fresh state and 2 more steps, bitwise equal to 4 straight steps;
30. conv1d backward check — the input-gradient launch (the forward
   kernel on the reversed cotangent) and the weight-gradient kernel
   against their plain versions bit for bit, two calls bit for bit, and
   against float64 autograd of ``ref.depthwise_conv1d``
   (``CONV1D_BWD_TOLERANCE``), at recurrentgemma-2b's training row (B 1,
   L 4096, D 2560, K 4), falcon-mamba-7b's training batch as the mixer's
   strided view (2, 1024, 8192, 4), K 9, an L no run length divides and
   L < K; at the two training shapes each one's time beside the forward
   kernel's, the plain version's, ``torch.nn.grad.conv1d_input`` /
   ``conv1d_weight``'s (TF32 off) and the bound (the forward, dx and
   ``conv1d_input`` from CUDA graphs over input copies past the L2, dx
   with its share of the bound, host us a call and plan geometry);
31. recurrentgemma train — full-width recurrentgemma-2b (26 layers, 2.89 B
   parameters, f32, remat, flash) through ``launch.train.main``: 3 AdamW
   steps at 1 x 4096 tokens of the copy task (the window binds), each
   loss finite, exactly 36 conv1d forwards (18 + 18 in the recompute), 18
   dx and 18 dw, 16 flash forwards and 8 of each flash backward kernel a
   step, ms a step, peak memory and the clip state; 3 steps of the
   depth-3 cut with a finite grad norm whose update reaches params, mu
   and nu; at that cut (1 x 2560 tokens) the first-step gradient of
   every leaf on the kernels (i) against the same step on ``impl="ref"``
   conv1d and ``attn_impl="ref"`` in float64, at most ``F64_FACTOR``
   times the f32 ref step's distance from it (both f32 steps read ~3e-4
   at tok/embed: the f32 arithmetic they share, not the kernels), and
   (ii) against the same kernel forward with the backward kernels
   swapped for their plain versions in float64 (the conv1d's dx and dw,
   the flash backward), within ``BWD_TOLERANCE`` and
   max(``F64_FACTOR`` x the f32 plain versions', ``ATTN_TOLERANCE``);
32. mamba train — falcon-mamba-7b at full width cut to
   ``MAMBA_TRAIN_LAYERS`` layers (its 64 layers' f32 state is 116 GB)
   through ``steps.make_train_step``: 3 AdamW steps at 2 x 1024 tokens,
   exactly 2 conv1d forwards, one dx and one dw a layer a step, ms a step,
   peak memory and the clip state; at the depth-2 cut the first-step
   gradients on the kernels against the f32 step on ``impl="ref"``
   (``MAMBA_GRAD_TOLERANCE``);
33. bf16 — the bf16 routes of the conv kernels: first the SASS of the
   conv, fused, weight-gradient and flash libraries (``cuobjdump``),
   where every instance of the tensor-core kernel (route mma), the fused
   kernel's bf16 instance, the weight gradient's route-mma instances and
   the flash kernel's bf16 narrow instances (PR 33; no TF32 HMMA there)
   must issue ``HMMA.16816.F32.BF16`` and the bf16 ffma, f32, other wgrad
   and flash f32 / wide instances none;
   then the carry and halo entries (``trim_conv2d_carry_bf16`` /
   ``_halo_bf16``) at full-width VGG-16's 13 layers at batch 8 and 1 and
   at AlexNet's five convs (conv1 the K 11 adder tree of bf16 parts) at
   batch 8 and 1, each layer's route printed (VGG-16's conv2-13 must run
   ``mma``): carry == halo bitwise; route ffma within ``BF16_ULPS`` of
   the plain version (the kernels' own fmaf chain); route mma within one
   bf16 ulp plus n 2^-22 sum|x w| of the float64 oracle rounded to bf16,
   its distance from the plain version in ulps printed; the fused entry
   (``trim_conv2d_fused_bf16``) on the groups of full-width VGG-16's and
   AlexNet's bf16 plans at batch 8 and 1, each bitwise equal to its bf16
   per-layer chain (a group all on route ffma also within ``BF16_ULPS``
   of its plain version); each one's device ms from CUDA graphs beside
   the f32 route's on the same values, ``F.conv2d`` on bf16 (cuDNN,
   TF32 off; the yardstick), the plain version's, the bound (2 bytes an
   element at 3.35 TB/s or 989 TFLOP/s of bf16) and the FFMA ceiling (67
   TFLOP/s); then full-width VGG-16 and AlexNet (seeded weights drawn in
   f32 and cast to bf16) served in bf16 on buckets (1, 2, 4, 8): 48
   Poisson requests at 200 req/s on carry and with ``fused=True``, 16 on
   halo, every row bit-matching ``forward_one`` (halo and fused rows the
   carry rows too), each forward launching only bf16 entries, and each
   bf16 row within ``BF16_F32_TOLERANCE`` of max|f32 row| of the f32
   serving of the same params; p50, p99 and throughput beside the f32
   serve phases' of this call;
34. lm_bf16 — the bf16 routes of the conv1d and flash kernels and bf16
   LM inference: ``trim_conv1d_bf16`` at every case of
   ``conv1d_cases`` bitwise equal to its plain version (f32 sums of
   exact products, one rounding), ``flash_attention_bf16`` at cases (a),
   (b), (c), (f) and seamless's s_enc, s_cross_short and s_cross_long of
   ``attention_cases`` within
   ``FLASH_BF16_TOLERANCE`` of max|o| of its plain version (the
   deviation printed), within half an ulp of bf16 plus
   ``FLASH_BF16_F64_EXCESS`` of max|o| of the float64 plain version (f32
   inside, which one bf16 P would not be) and repeatable bitwise; device
   ms from CUDA graphs beside the plain versions', ``F.conv1d`` and SDPA on bf16 ((a), (b)),
   the bound (989 TFLOP/s of bf16 or 2 bytes an element at 3.35 TB/s)
   and the flash route's ceiling (PR 33: bf16 mma, 1.5 x FLOPs at 989
   TFLOP/s); then full-width qwen2.5-3b (2 x 4096), recurrentgemma-2b (2 x
   4096) and falcon-mamba-7b (2 x 2048), each drawn in bf16 on the card
   by the port's ``init_params`` (norm scales and scan states f32, as in
   JAX) after its f32 twin of the earlier phases is freed: two timed
   prefills through ``make_prefill_step`` launching only the bf16 routes
   (36 flash; 18 conv1d and 8 flash; 64 conv1d a forward), ms a
   forward beside this call's f32 figure, peak memory, finite bf16
   logits and their distance from the f32 twin (the same weights
   widened; printed: the full-width stacks are chaotic under the JAX
   initialiser); the first ``LM_BF16_CUT`` layers sublayer by sublayer
   in bf16 and f32 on the same bf16 input (MLPs and mixers within
   ``LM_BF16_TOLERANCE``, the attention core's bf16 kernel against the
   f32 kernel on the same q, k, v within ``FLASH_BF16_TOLERANCE``); and
   ``BF16_REQUESTS`` greedy requests through ``make_decode_step`` on a
   bf16 state (ms a step, the tokens; no kernel runs in decode);
35. conv1d wgrad check — the redesigned weight-gradient kernel
   (16-byte rows, 4 f32 or 8 bf16 channels a lane, runs of 64 / 32
   steps, two load batches in flight) in f32 and bf16 at recurrentgemma-2b's and
   falcon-mamba-7b's training rows: bitwise its plain version and over
   two calls; device ms from CUDA graphs over input copies that outgrow
   the L2 (and events around the wrapper, the earlier PRs' timing, with
   the wrapper's host us a call, which bounds them) beside the plain
   version's, the byte bound,
   ``torch.nn.grad.conv1d_weight`` on the same dtype (TF32 off), the
   bytes moved and the rate; in bf16 also dx (``trim_conv1d_bf16`` on
   the reversed cotangent) bitwise plain, its time (CUDA graphs over
   input copies past the L2), bound, ``conv1d_input``'s, host us a call
   and plan geometry;
36. bf16 flash backward check — ``flash_attention_bwd_{dq,dkdv,sum}_bf16``
   at the cases of ``flash_bwd_cases`` ((t), (c), GQA 7, Lq < Lk and
   seamless's three): dq,
   dk, dv bf16, each no farther from the float64 plain backward than the
   plain bf16 backward (f32 math, one rounding) plus one bf16 ulp of
   max|grad|, and past half a bf16 ulp within
   ``FLASH_BWD_BF16_F64_EXCESS`` of max|grad| of it (at (t) and (c) the
   emulated P / dS split passes that gate and one bf16 P or dS fails it
   by 4x); repeatable bitwise; the bf16 forward's o bitwise with and
   without lse; each kernel's launches; CUDA-graph ms of the backward and
   each kernel beside the plain backward's (the sum over partials that
   outgrow the L2), the bound at 989 TFLOP/s and, at (t), SDPA's bf16
   backward and forward + backward;
37. train_lm_bf16 — qwen2.5-3b (36 layers, 2 x 1024), recurrentgemma-2b
   (26 layers, 1 x 4096) and falcon-mamba-7b cut to
   ``MAMBA_TRAIN_LAYERS`` (2 x 1024), all at published widths, drawn in
   bf16 by the port's ``init_params`` (norm scales f32) with f32 AdamW
   moments, trained through ``steps.make_train_step``: first, at each
   family's gradient cut (depth 2, 3 and 2), the step-1 gradients on the
   kernels, on the plain routes (every conv1d and flash wrapper, forward
   and backward, swapped for its plain version) and on the f32 kernels
   for the same values widened: every leaf and the loss of the kernels'
   step no farther from the plain step than twice the plain step's
   distance from the f32 step, plus 2^-8; only bf16 routes launched, each once a
   layer (forwards twice: remat); ``BF16_LM_CUT_STEPS`` steps at the
   cut, where mu and nu must move; then ``LM_BF16_TRAIN_STEPS`` timed
   steps at the f32 phases' shapes: ms, peak GiB and every bf16
   kernel's launches a step, beside the f32 phase's ms and peak of this
   call, every loss and leaf finite (``train_clip_state``);
38. train_bf16 — full-width VGG-16 (224x224, 1000 classes, the train
   phase's seeded weights drawn in f32 and cast to bf16, its first
   batches rounded to bf16, batch 8): the step-1 gradients on the
   kernels (25 ``carry_bf16`` and 13 ``wgrad_bf16`` launches, no f32
   conv kernel), the same step with ``kernels.ops``' three kernel
   wrappers swapped for their plain versions (the fmaf chain) and the
   same step on the f32 kernels for the same values widened: every leaf
   and the loss of the kernels' step within twice the plain step's
   distance from the f32 step plus 2^-8 of the leaf's max (the tensor
   cores add in their own order, so no leaf is bitwise the plain step's;
   each leaf's three distances printed); then ``BF16_TRAIN_STEPS`` AdamW
   steps of ``launch.train_cnn.train_step``, each with exactly 25
   ``carry_bf16`` and 13 ``wgrad_bf16`` launches and a finite loss, step
   1 run again from the same state bitwise equal; ms a step (steps 2-4)
   and peak memory beside the train phase's f32 figures of this call;
39. encdec — full-width seamless-m4t-large-v2 (24 encoder + 24 decoder
   layers, d_model 1024, 16 heads of 64, d_ff 8192, vocab 256206; 1.63 B
   parameters drawn on the card from seed 0; the speech frontend a stub,
   ``src`` frames unit-normal from a numpy seed), the encoder-decoder
   family on the flash kernel's non-causal and cross-attention calls:
   first the flash kernel's device ms from CUDA graphs at seamless's
   calls (forward: encoder 4096 x 4096 non-causal, decoder causal, cross
   4096 onto 1024; backward: the training rows 1024 x 1024 causal and
   non-causal), f32 and bf16, beside SDPA on the same call and the
   bound; then two timed f32 prefills through ``make_prefill_step`` at 2
   x 4096 tokens over 4096 frames, exactly 72 flash launches a forward
   (24 encoder, 24 decoder self, 24 cross), finite logits, ms and peak,
   the ref prefill's distance printed; every attention sublayer along
   the flash forward on the kernel against ref (``LM_LAYER_TOLERANCE``)
   and its core against the float64 plain version (``F64_FACTOR``);
   the depth-1 cut over 1024 frames (its cross call has Lq > Lk), flash
   and ref each against the float64 oracle (``repro_torch.testing.
   float64``): flash within max(``F64_FACTOR`` x ref's, ``LM_TOLERANCE``),
   the oracle's next token; ``serve_batch``
   at batch 4, prompt 16, gen 32 (over JAX's zero cross caches); then
   drawn in bf16: two bf16 prefills with a bf16 ``src`` (72 bf16 flash
   launches a forward), the f32 twin's distance printed, every sublayer
   bf16 against f32 on the same bf16 input (MLPs ``LM_BF16_TOLERANCE``,
   kernel cores ``FLASH_BF16_TOLERANCE``), 4 requests through bf16
   decode steps; then training through ``steps.make_train_step`` (the
   trainer's entry point refuses the family: no ``src`` stream): the
   depth-1 cut's first-step gradients (the backward kernels against the
   float64 plain backward, ``BWD_TOLERANCE``; flash against ref,
   ``LM_GRAD_TOLERANCE``), every attention sublayer's backward against
   float64 autograd at 1 x 512, and 3 timed AdamW steps at 2 x 1024 over
   1024 frames in f32 and in bf16 (f32 moments): every loss and grad
   norm finite, each step launching the forward 144 times (72 calls,
   remat) and the dQ and dK/dV kernels 72 times each (MHA: no partial
   sum), ms a step and peak;
40. moe — the MoE family on the flash kernel's GQA calls: first the
   kernel at qwen3-moe-30b-a3b's prefill call (B 2, L 4096, Hq 32, Hkv 4,
   D 128, causal), f32 and bf16, against its plain version (and the bf16
   route against float64), device ms from CUDA graphs beside SDPA on the
   same call and the bound; then full-width qwen3-moe-30b-a3b (48 layers,
   128 experts top 8, 30.53 B parameters) drawn in bf16 on the card, the
   expert leaves a layer at a time: two timed bf16 prefills through
   ``make_prefill_step`` at 2 x 4096 (48 bf16 flash launches a forward,
   none f32), the choices dropped a layer and the aux; along the bf16
   forward of 512 tokens, the depth-1 and depth-2 cuts sublayer by
   sublayer: attention on the kernel against ref (printed), its core bf16
   against the f32 kernel (``FLASH_BF16_TOLERANCE``) and float64
   (``FLASH_BF16_F64_EXCESS``), the MoE sublayer against the float64
   oracle on its own routing (bf16 ``LM_BF16_TOLERANCE``, the f32 twin
   ``LM_LAYER_TOLERANCE``), each block bitwise ``block_apply``, each
   cut's residual stream against the float64 oracle (printed); 4 greedy
   requests through bf16 decode steps and the decode step's device-busy
   share; then in f32 at the full-width 8-layer cut, ``serve_batch`` and,
   at its first 2 layers, 6 decode steps of batch 4 against the float64
   oracle's decode on the same routing (``LM_TOLERANCE``); then the
   full-width 4-layer cut trained through ``make_train_step`` in f32 and
   bf16 at 2 x 1024: the gradient taken twice bitwise equal, in f32 the
   depth-1 cut's first-step gradients (the backward kernels against the
   float64 plain backward, ``BWD_TOLERANCE``), 3 timed AdamW steps each
   launching 8 forwards (remat) and 4 each of dQ, dK/dV and the heads'
   sum (G 8), the gradient reaching mu and nu; last phi3.5-moe-42b-a6.6b
   at the full-width 16-layer cut in bf16 (LayerNorm, G 4): two prefills
   at 2 x 2048, the depth-1 sublayer check, 4 requests through bf16
   decode steps;
41. paper — the paper's own results and the card's roofline, from the
   port's analytical modules (``core/model.py``, ``dataflow.py``,
   ``netplan.py``, ``roofline.py``, ``configs/registry.model_flops``),
   beside the card's name and power limit, with no new full-width timing
   run: (a) Fig. 1, Fig. 6 for VGG-16 and AlexNet and the §V network
   comparison of VGG-16, AlexNet, ResNet-18 and U-Net, raising unless
   VGG-16's improvement lies in (3.0, 3.6), every VGG-16 and AlexNet
   layer's stays under 3.6 and ResNet-18's exceeds 2.0 (README's gates);
   (b) full-width VGG-16 and AlexNet at batch 8 and 1 through
   ``NetworkPlan``: per layer the bytes in "3dtrim", "trim" and the
   plan's own schedule, T_comp and T_mem, the kernel check's and the
   AlexNet table's carry and halo ms, the roofline time over each, and
   the measured halo / carry ratio beside the modelled trim / 3dtrim
   bytes; the network's roofline beside the summed carry times; (c) the
   paper's core (``core_conv``, 8 slices, K 3, one ifmap channel) at
   16x16 and 15x23 against the carry and halo kernels (Cin 1, Cout 8,
   'valid') within ``TOLERANCE``, its reads against the access model,
   the 4 launches counted in the kernel line (``paper_launches``); (d)
   model FLOPs over measured seconds x the peak (f32 67 TFLOP/s with
   TF32 off, bf16 989) of qwen2.5-3b's f32 and bf16 prefill and training
   step and qwen3-moe-30b-a3b's bf16 prefill, from the earlier phases'
   times; a share above 1 raises;
42. the kernel JSON line (twenty-four kernels; the launches of trim_conv1d
   and flash_attention include the prefills' and the training phases',
   the flash backward kernels' and conv1d backward kernels' the training
   steps', the bf16 conv entries' the bf16 serving phase's and the
   train_bf16 phase's timed steps', the bf16 conv1d and flash entries'
   the lm_bf16 prefills', the bf16 backward entries' the train_lm_bf16
   phase's timed steps'; the flash entries also the encdec phase's
   prefills and steps, counted apart as ``encdec_launches``, and its
   times at seamless's calls as ``s_*``; the moe phase's prefills and
   steps likewise as ``moe_launches``, the times at qwen3-moe's prefill
   call as ``q3_*``), then ``{"ok": true,
   "device": ...}`` last.

Exits non-zero without a result when no GPU is visible.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
# Before torch is imported (the import of the peaks below imports it):
# growable segments.  The mamba train phase's full-width cut fills the
# card, and fixed-size cached segments left 18.5 GiB of holes beside its
# 8 GiB gradient-norm temporary (out of memory at 58 GiB in use).
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
# The H100 SXM's peaks, from the port's one source of them: f32 outside
# the tensor cores, the TF32, bf16 and int8 tensor cores (dense), __dp4a
# on the integer pipes (the int8 kernel's own ceiling, printed beside the
# bound) and HBM3
from repro_torch.core.roofline import (PEAK_BF16_FLOPS,  # noqa: E402
                                       PEAK_BYTES_PER_S, PEAK_DP4A_OPS,
                                       PEAK_F32_FLOPS, PEAK_INT8_OPS,
                                       PEAK_TF32_FLOPS)
TOLERANCE = 1e-4            # of max(1, max|plain|); see the docstring
# Weight gradient: of max|plain|.  Each dw element sums N*H_out*W_out
# products (up to 8 * 224^2 = 401,408 at conv2); the kernel takes them as
# one fmaf chain per chunk (>= 256 positions) and then one chain over the
# chunks, the plain version as cuBLAS's blocked f32 GEMM.  For zero-mean
# data the rounding error of either grows like eps * sqrt(terms) relative
# to the sum (6e-8 * 634 = 3.8e-5 for one 401 k-term chain, about ten
# times less for the chunked one), so 1e-4 of the largest element holds
# with margin, and a wrong tap, chunk or padding row breaks it by orders.
WGRAD_TOLERANCE = 1e-4
# Whole-network gradients against impl="ref": of each leaf's max|ref|.
# The oracle takes the branch the kernels took at every ReLU and max-pool
# (``branch_matched_oracle``): both then differentiate the same
# piecewise-linear function and differ only by f32 summation order, which
# leaves ~1e-7-1e-6 of max|ref| per leaf after 13 layers (1.9e-6 measured
# on the card).  Without it, the few dozen pre-activations and pool
# windows that lie within rounding (<1e-6) of a tie take the other branch
# in one of the two forwards, each moving one cotangent entry by O(|g|);
# that reads 1e-4-1e-3 of max|ref| per leaf and is printed, not checked.
GRAD_TOLERANCE = 1e-4
# Attention kernel vs its plain version: of max|plain|.  Both run the
# online softmax over 64-key tiles (32 at D 256) in f32 and differ in the
# order of the 128/256-term dot products and the row sums, and on the
# narrow route in the 3xTF32 products (~2^-22 of each; a few ulp of each
# score; outputs of N(0, 1) inputs are averages of <= 4096 values).
ATTN_TOLERANCE = 1e-5
# One layer's attention output, flash vs ref on the same input: of
# max|ref|.  This catches wiring faults (a wrong head, group, position or
# mask reads O(1)), not small numeric ones: with the JAX initialiser's
# peaked logits (|s| up to ~2000 at full width) an f32 score carries ~1e-4
# of rounding, which moves p by ~1e-4 where keys nearly tie, so both f32
# paths sit ~1e-4 from float64 and their difference reads up to 9.4e-5
# with the 3xTF32 kernel (3e-7 with the FFMA kernel it replaced, which
# rounded its sums like cuBLAS).  The kernel's numerics are held at 1e-5
# by the attention kernel check (N(0, 1) inputs) and, at these logits, by
# the float64 check below.
LM_LAYER_TOLERANCE = 1e-4
# Every layer's attention (batch row 0, the first F64_POSITIONS positions,
# before the output projection) against ref in float64: the kernel's error
# must be at most F64_FACTOR times the f32 ref oracle's own error (both are
# f32 paths with the same score rounding, so a correct kernel is of the
# same order; it read 0.38 of ref's at layer 0), or ATTN_TOLERANCE where
# both are smaller than that.
F64_FACTOR = 2.0
F64_POSITIONS = 2048        # the float64 attention oracle's query rows
# Logits of the depth-1 cut, flash vs ref and decode vs prefill: of
# max|logits|; one layer's attention difference through the MLP and head.
LM_TOLERANCE = 1e-4
# Mamba: prefill logits against token-by-token decode logits, of
# max|logits|, at the depth-1 and depth-2 cuts and at full depth.  The two
# paths share weights and inputs and differ in GEMM shapes (M = B x L
# against M = B) and the scan's association (the chunked odd/even tree
# against one step at a time); their convs are bitwise equal (the kernel
# and the step's window sum, see kernels/trim_conv1d.py).  The mamba init
# is well conditioned (2-D parameters per layer) and the scan decays
# (a_bar <= 1), so the difference grows slowly with depth: 3.2e-6,
# 3.7e-6 and 1.3e-5 at depths 1, 2 and 64 on an NVIDIA H100 80GB HBM3,
# 700.00 W (PERF.md §6); a wrong tap, state or layer reads O(1).
MAMBA_TOLERANCE = 1e-4
MAMBA_BATCH, MAMBA_SEQ = 2, 2048
MAMBA_CROSS_PROMPT = 128    # prefill-vs-decode prompt at the depth cuts
MAMBA_DRIFT_PROMPT = 64     # ... at full depth, and its per-layer drift
PREFILL_BATCH, PREFILL_SEQ = 2, 4096
RGEMMA_BATCH, RGEMMA_SEQ = 2, 4096   # twice the window: the window binds
RGEMMA_WRAP_EXTRA = 64      # decode-vs-prefill prompt: window + this
# recurrentgemma-2b: prefill logits against token-by-token decode logits
# across the ring's wrap, of max|logits|, at the depth-3 cut.  The two
# paths share weights and inputs and differ in GEMM shapes, the scan's
# association (one odd/even tree over the prompt against one step at a
# time) and attention (the flash kernel's 3xTF32 tiles against the plain
# decode softmax); their convs are bitwise equal.  The soft cap bounds
# the attention scores at 30, so the softmax is far less peaked than
# qwen2.5-3b's (|s| ~ 2000); a wrong ring slot, mask or valid length
# reads O(1) once the ring has wrapped.
RGEMMA_TOLERANCE = 1e-4
# Flash backward kernels against their plain version on the same lse:
# of each gradient's max|plain|.  The kernels form S, dP and the
# gradients in 3xTF32 on the tensor cores (each product within ~2^-21 of
# f32's, fresh accumulators against the tensor cores' truncation), the
# plain version as f32 einsums over the dQ kernel's 16-key tiles (PR 25's
# FFMA kernels read 2e-7 to 8.8e-6 at the training and recurrentgemma-2b
# shapes on an NVIDIA H100 80GB HBM3).
BWD_TOLERANCE = 1e-4
# First-step gradients of the depth-2 cut of full-width qwen2.5-3b, of
# each leaf's max|ref|.  (i) The backward kernels against their plain
# version in float64 under the same forward (the kernel forward, the
# plain backward swapped in, its f32 inputs and lse in float64):
# BWD_TOLERANCE, and no farther from it than the plain version in f32
# is.  The plain version in f32 is no oracle at these logits:
# |y| ~ 2000 has an f32 ulp of 2.4e-4, so p = exp(y - lse') carries ~1e-4
# in any f32 arithmetic, and the f32 plain backward reads 2.39e-4 from the
# float64 one, the 3xTF32 kernels 8.2e-5: BWD_TOLERANCE is only 1.22x
# that, the f32 plain's distance 2.9x (PR 25's FFMA kernels read 5.6e-7
# from the f32 plain: their dot products rounded as cuBLAS's do; NVIDIA
# H100 80GB HBM3, 700.00 W, PR 26).  (ii) The kernels against
# attn_impl="ref", a wiring check: a wrong head, mask, layer or
# statistic reads O(1).  The gradient at this init is ill-conditioned in
# the forward's rounding: with the backward kernels swapped for the plain
# backward it moves by 5.6e-7, with the forward kernel (3xTF32) swapped
# for its plain version (cuBLAS f32) by 9.4e-3 at blocks/att/wq, while the
# kernel's own forward error is 0.2-0.6x ref's against float64 (the LM
# prefill's float64 check); two cuBLAS f32 paths (chunked, ref) part by
# 3.3e-4 (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md §6).
LM_GRAD_TOLERANCE = 3e-2
BWD_F64_POSITIONS = 512     # the float64 backward oracle's query rows
TRAIN_LM_STEPS, TRAIN_LM_BATCH = 4, 2
TRAIN_LM_SEQ = 1025         # make_batch drops one: 1024 tokens a sequence
GRAD_LM_LAYERS, GRAD_LM_TOKENS = 2, 256
# conv1d backward kernels against float64 autograd of ref.depthwise_conv1d,
# of max|grad|: dx sums K rounded products, dw B x L of them (in runs,
# groups of runs and the groups in order); f32 rounding leaves ~1e-7 (the
# CPU tests read 1.6e-7), and a wrong tap, run or halo reads O(1).
CONV1D_BWD_TOLERANCE = 1e-5
# recurrentgemma-2b trained at full width through launch.train.main: one
# row of the JAX train_4k plan's 4096 tokens (256 rows, n_micro 4), twice
# the 2048 window, so the window mask binds in the backward
RGEMMA_TRAIN_STEPS, RGEMMA_TRAIN_BATCH, RGEMMA_TRAIN_SEQ = 3, 1, 4097
RGEMMA_GRAD_LAYERS = 3      # one (rec, rec, att) period
RGEMMA_GRAD_TOKENS = 2560   # the float64 step's row: above the window
# falcon-mamba-7b (116 GB of f32 state at full depth) trained at full
# width on a depth cut, 2 x 1024 tokens (the JAX train_4k plan's rows cut
# to fit one card): the deepest cut whose step peaks under ~72 GiB of the
# 80 GB card (30 layers: 71.0 GiB; 32: 74.2; NVIDIA H100 80GB HBM3)
MAMBA_TRAIN_LAYERS = 30
MAMBA_TRAIN_STEPS, MAMBA_TRAIN_BATCH, MAMBA_TRAIN_SEQ = 3, 2, 1025
MAMBA_GRAD_LAYERS = 2
# mamba's depth-2 gradients on the kernels against the f32 step on
# impl="ref", of each leaf's max: the conv forward is bitwise the
# oracle, and the backward kernels sum the same products in another
# order (dw over 2 x 1024 positions), ~1e-7 through two layers.
MAMBA_GRAD_TOLERANCE = 1e-5
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 16, 32
# lm_bf16 (phase 34): bf16 against f32 per sublayer on the same bf16
# input, of max|f32 out| (DESIGN.md §5's bf16 tolerance); the bf16 flash
# kernel against its plain version (and the f32 kernel), of max|o|: both
# f32 inside, one rounding to bf16 (2^-8 of a value) apart at most
LM_BF16_TOLERANCE = 3e-2
FLASH_BF16_TOLERANCE = 1e-2
# the bf16 flash kernel against the float64 plain version, past half an
# ulp of bf16 at its output, of max|o|: f32 inside (P split hi / lo on
# the tensor cores) leaves ~1e-6; one bf16 P would leave 2^-9 of each
# weight, ~7e-4 (tests/test_torch_bf16_wgrad_flash.py emulates both)
FLASH_BF16_F64_EXCESS = 2.0 ** -14
# the bf16 flash backward's dq, dk and dv against the float64 plain
# backward, past half an ulp of bf16 at each element, of max|grad|: the P
# and dS splits leave ~1e-6, one bf16 P (dv) or dS (dk, dq) ~1e-3
# (flash_bwd_bf16_emulated, here at (t) and (c) and in
# tests/test_torch_bf16_wgrad_flash.py)
FLASH_BWD_BF16_F64_EXCESS = 2.0 ** -14
ROTATE_BYTES = 150_000_000  # rotating(): inputs held, 3x the L2
LM_BF16_CUT = 3             # layers held per sublayer (one rec, rec, att)
BF16_REQUESTS, BF16_PROMPT, BF16_GEN = 4, 16, 8
CROSS_PROMPT = 256          # decode-vs-prefill prompt at the depth-1 cut
TRAIN_BATCH = 8
TRAIN_STEPS = 6
BF16_TRAIN_STEPS = 4        # the train_bf16 phase's AdamW steps
LM_BF16_TRAIN_STEPS = 4     # the train_lm_bf16 phase's timed steps a model
BF16_LM_CUT_STEPS = 2       # its steps at each depth cut (mu, nu move)
REQUESTS = 48               # carry- and fused-kernel serving traces
HALO_REQUESTS = 16          # halo-kernel serving trace (a prefix of it)
FUSED_SCALE = 16            # channel divisor of the fused phases' VGG-16
ARRIVAL_RATE = 200.0        # requests per second (Poisson)


class Phases:
    """Seconds of each phase, printed as it ends."""

    def __init__(self):
        self.t0 = self.last = time.perf_counter()

    def done(self, name: str) -> None:
        now = time.perf_counter()
        print(f"phase {name}: {now - self.last:.2f} s")
        self.last = now

    def total(self) -> None:
        print(f"phases total: {time.perf_counter() - self.t0:.2f} s")


def launch_counts(**nonzero) -> dict:
    """Every key of the conv kernels' ``LAUNCHES``, 0 unless given."""
    from repro_torch.kernels import trim_conv2d as tc
    return {**dict.fromkeys(tc.LAUNCHES, 0), **nonzero}


def route_counts(counts: dict, bf16: bool) -> dict:
    """The launches of one route in a launch-count dict (the bf16 route's
    keys end in ``_bf16``); raises if the other route launched."""
    other = {k: v for k, v in counts.items()
             if k.endswith("_bf16") != bf16 and v}
    if other:
        raise AssertionError(f"the {'f32' if bf16 else 'bf16'} route "
                             f"launched on a {'bf16' if bf16 else 'f32'} "
                             f"path: {other}")
    return {k: v for k, v in counts.items() if k.endswith("_bf16") == bf16}


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def flash_sass_check() -> dict:
    """Disassemble the built flash-attention libraries (``cuobjdump
    -sass``) and count, in each kernel instance, the tensor-core
    instructions on TF32 operands (``HMMA.1688.F32.TF32``): every f32
    narrow-route forward instance (D <= 256 at Dp 64, 128, 256) and every
    f32 backward instance (dQ and dK/dV at Dp 64, 128, 256) must issue
    them, the bf16 narrow instances (on the bf16 tensor cores:
    :func:`bf16_sass_check`), the bf16 backward instances (dQ at three
    Dp, dK/dV at three Dp for f32 partials and for bf16 outputs) and the
    wide route (f32 and bf16) none."""
    import shutil
    from repro_torch.kernels import build
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    counts, fn = {}, None
    for lib in ("flash_attention", "flash_attention_bwd"):
        sass = subprocess.run([tool, "-sass", build.library(lib)._name],
                              capture_output=True, text=True, check=True,
                              timeout=300).stdout
        for line in sass.splitlines():
            if "Function :" in line:
                fn = line.split("Function :")[1].strip()
                counts[fn] = 0
            elif fn is not None and "HMMA" in line and "TF32" in line:
                counts[fn] += 1

    def of(name):
        return {f: n for f, n in counts.items() if name in f}
    narrow, wide = of("flash_attention_kernel"), of("flash_attention_wide")
    n32 = {f: n for f, n in narrow.items() if "bfloat16" not in f}
    n16 = {f: n for f, n in narrow.items() if "bfloat16" in f}
    bwd_all = {**of("flash_attention_bwd_dq_kernel"),
               **of("flash_attention_bwd_dkdv_kernel")}
    bwd = {f: n for f, n in bwd_all.items() if "bfloat16" not in f}
    bwd16 = {f: n for f, n in bwd_all.items() if "bfloat16" in f}
    if len(n32) != 3 or min(n32.values()) == 0 or len(n16) != 3 \
            or any(n16.values()) or len(wide) != 2 or any(wide.values()) \
            or len(bwd) != 6 or min(bwd.values()) == 0 or len(bwd16) != 9 \
            or any(bwd16.values()):
        raise AssertionError(f"flash SASS: TF32 HMMA counts {counts}")
    print("flash SASS: HMMA.1688.F32.TF32 instructions per narrow "
          "instance, f32 " + ", ".join(str(n) for n in n32.values())
          + ", bf16 " + ", ".join(str(n) for n in n16.values())
          + f" (none); wide route {sum(wide.values())}; backward dQ / "
          "dK/dV instances, f32 " + ", ".join(str(n) for n in bwd.values())
          + ", bf16 " + ", ".join(str(n) for n in bwd16.values())
          + " (none)")
    return counts


def time_ms(torch, fn, reps: int = 10) -> float:
    """Mean device time of ``fn`` over ``reps`` launches after a warm-up
    (CUDA events; L2 not flushed between launches)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_cases(n: int = 8):
    """(name, x_shape, w_shape, stride, groups): VGG-16 at batch ``n``,
    then the extra stride-2 and depthwise cases."""
    from repro_torch.core.model import vgg16_layers
    cases = [(l.name, (n, l.ifmap, l.ifmap, l.in_channels),
              (3, 3, l.in_channels, l.out_channels), 1, 1)
             for l in vgg16_layers()]
    cases.append(("s2_56x128", (n, 56, 56, 128), (3, 3, 128, 256), 2, 1))
    cases.append(("dw_112x32", (n, 112, 112, 32), (3, 3, 1, 32), 1, 32))
    return cases


def check_kernels(torch, n: int = 8):
    """Carry and halo against the plain version at VGG-16's shapes at
    batch ``n`` (plus the stride-2 and depthwise cases); each one's time,
    TFLOP/s and the plan's blocks beside the plain version's and
    ``F.conv2d``'s times and the bound."""
    import torch.nn.functional as F
    from repro_torch.core.conv_plan import ConvPlan
    from repro_torch.kernels.ref import conv_pads, pad_nhwc
    from repro_torch.kernels.trim_conv2d import (trim_conv2d,
                                                 trim_conv2d_plain)

    gen = torch.Generator(device="cuda").manual_seed(0 if n == 8 else n)
    rows = []
    print(f"kernel check, batch {n} (relu, bias, 'same'; times in ms, "
          "device events; blocks carry/halo; tile T x W x C_out):")
    print(f"  {'case':10s} {'max_err':>9s} {'tol':>8s} {'c==h':>5s} "
          f"{'carry':>8s} {'halo':>8s} {'plain':>8s} {'F.conv':>8s} "
          f"{'bound':>8s} by         {'TF/s c':>6s} {'TF/s h':>6s} "
          f"{'blocks':>10s} tile")
    for name, xs, wsh, stride, groups in kernel_cases(n):
        k = wsh[0]
        x = torch.randn(xs, generator=gen, device="cuda")
        w = torch.randn(wsh, generator=gen, device="cuda") \
            / float(np.sqrt(k * k * wsh[2]))
        b = torch.randn((wsh[3],), generator=gen, device="cuda")
        pads = conv_pads(xs[1], xs[2], k, stride, "same")
        kw = dict(stride=stride, pad=pads, groups=groups, activation="relu")
        plain = trim_conv2d_plain(x, w, b, **kw)
        carry = trim_conv2d(x, w, b, dataflow="carry", **kw)
        halo = trim_conv2d(x, w, b, dataflow="halo", **kw)
        torch.cuda.synchronize()
        scale = max(1.0, plain.abs().max().item())
        err = max((carry - plain).abs().max().item(),
                  (halo - plain).abs().max().item())
        same = torch.equal(carry, halo)
        if not np.isfinite(err) or err > TOLERANCE * scale:
            raise AssertionError(f"{name} n={n}: max|kernel - plain| = "
                                 f"{err} > {TOLERANCE} * {scale}")
        if not same:
            raise AssertionError(f"{name} n={n}: carry and halo differ "
                                 "bitwise")
        xp = pad_nhwc(x, pads).permute(0, 3, 1, 2)
        wl = w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        t = {
            "carry": time_ms(torch, lambda: trim_conv2d(
                x, w, b, dataflow="carry", **kw)),
            "halo": time_ms(torch, lambda: trim_conv2d(
                x, w, b, dataflow="halo", **kw)),
            "plain": time_ms(torch, lambda: trim_conv2d_plain(x, w, b, **kw)),
            # one library call: conv + bias (the relu is not in it)
            "library": time_ms(torch, lambda: F.conv2d(
                xp, wl, b, stride=stride, groups=groups)),
        }
        plan = ConvPlan.build(xs, wsh, stride=stride, pad=pads,
                              groups=groups)
        halo_plan = ConvPlan.build(xs, wsh, stride=stride, pad=pads,
                                   groups=groups, dataflow="halo")
        ops_ms = plan.flops / PEAK_F32_FLOPS * 1e3
        bytes_ms = plan.min_bytes() / PEAK_BYTES_PER_S * 1e3
        bound = max(ops_ms, bytes_ms)
        by = "operations" if ops_ms >= bytes_ms else "bytes"
        rows.append(dict(name=name, err=err, bound=bound, by=by,
                         ops_ms=ops_ms, bytes_ms=bytes_ms,
                         vgg=name.startswith("conv"), **t))
        blocks = f"{plan.blocks}/{halo_plan.blocks}"
        print(f"  {name:10s} {err:9.2e} {TOLERANCE * scale:8.1e} "
              f"{str(same):>5s} {t['carry']:8.3f} {t['halo']:8.3f} "
              f"{t['plain']:8.3f} {t['library']:8.3f} {bound:8.3f} "
              f"{by:10s} {plan.flops / t['carry'] / 1e9:6.2f} "
              f"{plan.flops / t['halo'] / 1e9:6.2f} {blocks:>10s} "
              f"{plan.th_out}x{plan.tile_w}x{plan.tile_cout}")
        del x, w, b, plain, carry, halo, xp, wl
    torch.cuda.empty_cache()
    vgg = [r for r in rows if r["vgg"]]
    print(f"kernel check, batch {n}, sum of the 13 VGG-16 layers: carry "
          f"{sum(r['carry'] for r in vgg):.3f} ms, halo "
          f"{sum(r['halo'] for r in vgg):.3f} ms, plain "
          f"{sum(r['plain'] for r in vgg):.3f} ms, F.conv2d "
          f"{sum(r['library'] for r in vgg):.3f} ms, bound "
          f"{sum(r['bound'] for r in vgg):.3f} ms")
    return rows


# The int8 kernel's previous design (__dp4a on the integer pipes) at the
# int8 kernel check's shapes, carry ms a launch: NVIDIA H100 80GB HBM3,
# 700.00 W, PERF.md section 5 (printed in brackets beside this run's times)
DP4A_Q8_CARRY_MS = {
    8: dict(conv1=0.383, conv2=0.558, conv3=0.292, conv4=0.440, conv5=0.238,
            conv6=0.393, conv7=0.395, conv8=0.260, conv9=0.466, conv10=0.461,
            conv11=0.149, conv12=0.149, conv13=0.149, s2_56x128=0.090,
            dw_112x32=0.231),
    1: dict(conv1=0.138, conv2=0.147, conv3=0.064, conv4=0.085, conv5=0.069,
            conv6=0.089, conv7=0.092, conv8=0.085, conv9=0.145, conv10=0.145,
            conv11=0.144, conv12=0.145, conv13=0.146, s2_56x128=0.078,
            dw_112x32=0.083),
}
DP4A_Q8_SUMS = {8: (4.333, 4.218), 1: (1.493, 1.301)}   # carry, halo


def time_graph_ms(torch, fn, reps: int = 10) -> float:
    """Device time of ``fn`` a launch: ``reps`` launches captured in one
    CUDA graph and replayed between CUDA events, so that the wrapper's
    host time (which exceeds a small kernel's) is not in it.  ``fn`` may
    be a list of calls on copies of the same inputs (:func:`rotating`),
    captured in turn, so that a memory-bound kernel does not find its
    inputs in L2 from the launch before."""
    fns = fn if isinstance(fn, (list, tuple)) else [fn]
    for f in fns:
        f()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for f in fns:
            f()
    torch.cuda.current_stream().wait_stream(side)
    reps = max(reps, len(fns))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            fns[i % len(fns)]()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / reps
    del graph
    return ms


def rotating(make, nbytes: int) -> list:
    """Calls ``make()`` (each making its own copies of a kernel's inputs
    and returning the call on them) until the copies hold
    ``ROTATE_BYTES``, three times the H100's 50 MB L2, for
    :func:`time_graph_ms`: a launch then finds nothing of its inputs
    left in L2 by the one before.  ``nbytes``: one copy's bytes."""
    return [make() for _ in range(max(1, -(-ROTATE_BYTES // nbytes)))]


def rotating_ms(torch, call, inputs, out_bytes: int = 0,
                reps: int = 20) -> float:
    """Device ms of ``call(*inputs)`` from CUDA graphs
    (:func:`time_graph_ms`) over copies of ``inputs`` that outgrow the L2
    (:func:`rotating`), each copy with its original's strides (a strided
    view stays a strided view); ``out_bytes``: what a call writes,
    counted with the inputs toward the bytes held."""
    def copy():
        c = [torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                                 device=t.device).copy_(t) for t in inputs]
        return lambda: call(*c)
    held = out_bytes + sum(
        t.element_size() * (1 + sum((n - 1) * st for n, st in
                                    zip(t.shape, t.stride())))
        for t in inputs)
    return time_graph_ms(torch, rotating(copy, held), reps=reps)


def conv1d_timed(torch, plan, kernel, library, inputs, lib_inputs) -> dict:
    """A conv1d launch's timings at one row: the kernel's (``kernel(*
    inputs)``) and the library call's (``library(*lib_inputs)``) device
    ms from CUDA graphs over input copies past the L2
    (:func:`rotating_ms`), the wrapper's host us a call
    (:func:`host_us`), the share of the byte bound and the plan's
    geometry."""
    out = plan.b * plan.length * plan.d * plan.dtype_bytes
    ms = rotating_ms(torch, kernel, inputs, out)
    return dict(kernel=ms, library=rotating_ms(torch, library, lib_inputs,
                                               out),
                host_us=host_us(torch, lambda: kernel(*inputs)),
                of_bound=plan.bound()[0] / ms, runs=plan.runs,
                tile_l=plan.tile_l, d_warps=plan.d_warps, vec=plan.vec,
                halo_share=plan.halo_share,
                geometry=f"vec {plan.vec}, runs of {plan.tile_l} x "
                         f"{plan.runs}, {plan.d_warps} channel warps, "
                         f"{plan.blocks} warps, halo {plan.halo_share:.1%}")


def conv1d_kernel_times(rows) -> dict:
    """The kernel line's times of a conv1d route from its check's rows:
    row (a), the falcon-mamba-7b mixer's strided view, as the kernel's
    own, row (b), recurrentgemma-2b's prefill, under ``rgemma_``, the
    contiguous mamba input under ``contiguous_`` (device ms from CUDA
    graphs over input copies past the L2)."""
    by = {r["name"]: r for r in rows}
    out = {}
    for prefix, name in (("", "b_mixer_view"), ("rgemma_", "k_rgemma"),
                         ("contiguous_", "a_prefill")):
        r = by[name]
        out.update({f"{prefix}ms": r["kernel"],
                    f"{prefix}plain_ms": r["plain"],
                    f"{prefix}bound_ms": r["bound"],
                    f"{prefix}bound_by": r["by"],
                    f"{prefix}library_ms": r["library"],
                    f"{prefix}host_us": r["host_us"],
                    f"{prefix}tile_l": r["tile_l"],
                    f"{prefix}vec": r["vec"]})
    return out


def q8_build_check() -> dict:
    """The int8 library's instances: ptxas registers and spill bytes, and
    the tensor-core instructions (``IMMA``) in each one's SASS
    (``cuobjdump -sass``): every instance of the tensor-core routes must
    issue them.  Returns {(kernel, im2col, m16 fragments, min blocks):
    (registers, spill stores, spill loads, IMMA count)}."""
    import re
    import shutil
    from repro_torch.kernels import build
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", build.library(
        "trim_conv2d_q8")._name], capture_output=True, text=True,
        check=True, timeout=300).stdout
    imma, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            imma[fn] = 0
        elif fn is not None and "IMMA" in line:
            imma[fn] += 1

    def key(name):
        m = re.search(r"trim_conv2d_q8_(mma|dp4a)_kernelI(?:Lb([01])E"
                      r"Li(\d)E)?Li([12])E", name)
        if m is None:
            raise AssertionError(f"q8: unknown kernel instance {name}")
        return (m.group(1), m.group(2) == "1", int(m.group(3) or 0),
                int(m.group(4)))

    out, cur = {}, None
    for line in build.build_log.get("trim_conv2d_q8", {}).get("ptxas", []):
        if "entry function" in line:
            cur = key(line)
            out[cur] = [0, 0, 0, 0]
        elif cur is not None and "spill stores" in line:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            out[cur][1:3] = [int(m.group(1)), int(m.group(2))]
        elif cur is not None and "Used" in line and "registers" in line:
            out[cur][0] = int(re.search(r"Used (\d+) registers",
                                        line).group(1))
    for f, count in imma.items():
        k = key(f)
        if k is not None:
            out.setdefault(k, [0, 0, 0, 0])[3] = count
    mma = {k: v for k, v in out.items() if k[0] == "mma"}
    if len(mma) != 6 or min(v[3] for v in mma.values()) == 0:
        raise AssertionError(f"q8 SASS: IMMA counts by instance {out}")
    print("int8 library: " + "; ".join(
        f"{k[0]}{'/im2col' if k[1] else ''}{f' {k[2]} frags' if k[2] else ''}"
        f" x{k[3]}: {v[0]} registers, "
        f"spill {v[1]}/{v[2]} B, {v[3]} IMMA" for k, v in sorted(out.items())))
    return {k: tuple(v) for k, v in out.items()}


def check_q8_kernels(torch, n: int = 8, build_info: dict | None = None):
    """The int8 kernel (carry and halo) against its plain version at the
    kernel check's 15 shapes at batch ``n``: bitwise equal (exact int32
    sums, one int32 add and one f32 multiply in both), carry == halo
    bitwise, and the quantize pass of an f32 input of the same shape on
    the card equal to the CPU's bit for bit.  Per layer: the plan's route,
    warps (m x n x k, m16 fragments a warp), weight stages a strip and
    blocks, the instance's ptxas registers and spill; each dataflow's
    device time (:func:`time_graph_ms`) with the ``__dp4a`` design's in
    brackets, carry
    through the wrapper eagerly (host time included), TOPS, the plain
    version's time, ``torch._int_mm`` on the layer's im2col GEMM shape
    and ``F.conv2d`` in f32 (TF32 off; both context only: GEMM only, not
    the same function, which no PyTorch call computes) and the bound
    (operations at the int8 tensor-core rate, bytes int8 in and f32
    out)."""
    import torch.nn.functional as F
    from repro_torch.core.conv_plan import ConvPlan
    from repro_torch.kernels.ref import conv_pads, pad_nhwc, quantize_int8
    from repro_torch.kernels.trim_conv2d import (pack_q8_weights,
                                                 trim_conv2d_q8,
                                                 trim_conv2d_q8_plain)

    gen = torch.Generator(device="cuda").manual_seed(100 + n)
    rows = []
    old = DP4A_Q8_CARRY_MS[n]
    print(f"int8 kernel check, batch {n} (relu, int32 bias, 'same' padded "
          "with the zero point; device ms a launch from CUDA graphs, the "
          "__dp4a design's carry in brackets; eager: carry through the "
          "wrapper; "
          "int_mm: torch._int_mm on the im2col GEMM shape, GEMM only, not "
          "the same function; warps m x n x k / m16 fragments; blocks "
          "carry/halo; tile T x W x C_out; registers/spill B):")
    print(f"  {'case':10s} {'c==h':>5s} {'carry (dp4a)':>15s} "
          f"{'halo':>7s} {'eager':>7s} {'plain':>7s} {'int_mm':>7s} "
          f"{'F.c f32':>7s} {'bound':>7s} by    {'TOPS':>6s} route  "
          f"{'warps':>8s} st {'blocks':>10s} {'tile':>9s} regs")
    for name, xs, wsh, stride, groups in kernel_cases(n):
        k, cout = wsh[0], wsh[3]
        xf = torch.randn(xs, generator=gen, device="cuda")
        x_scale = torch.tensor(float(xf.abs().max()) / 127.0, device="cuda")
        zp = int(torch.randint(-20, 21, (), generator=gen, device="cuda"))
        x = quantize_int8(xf, x_scale, zp)
        if not torch.equal(x.cpu(), quantize_int8(xf.cpu(), x_scale.cpu(),
                                                  zp)):
            raise AssertionError(f"q8 {name} n={n}: the quantize pass on "
                                 "the card differs from the CPU's")
        w = torch.randint(-127, 128, wsh, generator=gen, device="cuda",
                          dtype=torch.int8)
        bias_q = torch.randint(-2 ** 20, 2 ** 20, (cout,), generator=gen,
                               device="cuda", dtype=torch.int32)
        scale = torch.rand((cout,), generator=gen, device="cuda") * 1e-3
        wp = pack_q8_weights(w)
        pads = conv_pads(xs[1], xs[2], k, stride, "same")
        kw = dict(zero_point=zp, stride=stride, pad=pads, groups=groups,
                  activation="relu")
        plain = trim_conv2d_q8_plain(x, w, bias_q, scale, **kw)
        carry = trim_conv2d_q8(x, w, bias_q, scale, w_packed=wp, **kw)
        halo = trim_conv2d_q8(x, w, bias_q, scale, w_packed=wp,
                              dataflow="halo", **kw)
        torch.cuda.synchronize()
        err = max((carry - plain).abs().max().item(),
                  (halo - plain).abs().max().item())
        if not torch.equal(carry, plain):
            raise AssertionError(f"q8 {name} n={n}: carry differs from the "
                                 f"plain version (max|diff| {err})")
        if not torch.equal(carry, halo):
            raise AssertionError(f"q8 {name} n={n}: carry and halo differ "
                                 "bitwise")
        del plain, carry, halo
        plan = ConvPlan.build(xs, wsh, stride=stride, pad=pads,
                              groups=groups, dtype_bytes=1)
        halo_plan = ConvPlan.build(xs, wsh, stride=stride, pad=pads,
                                   groups=groups, dataflow="halo",
                                   dtype_bytes=1)
        # context only: the im2col GEMM of the same shape on cuBLASLt, and
        # the f32 conv, one call each
        gk = -(-k * k * wsh[2] // 8) * 8
        ga = torch.randint(-127, 128, (n * plan.h_out * plan.w_out, gk),
                           generator=gen, device="cuda", dtype=torch.int8)
        gb = torch.randint(-127, 128, (cout, gk), generator=gen,
                           device="cuda", dtype=torch.int8).t()
        xp = pad_nhwc(xf, pads).permute(0, 3, 1, 2)
        wl = torch.randn(wsh, generator=gen, device="cuda").permute(
            3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        bf = torch.randn((cout,), generator=gen, device="cuda")
        t = {
            "carry": time_graph_ms(torch, lambda: trim_conv2d_q8(
                x, w, bias_q, scale, w_packed=wp, **kw)),
            "halo": time_graph_ms(torch, lambda: trim_conv2d_q8(
                x, w, bias_q, scale, w_packed=wp, dataflow="halo", **kw)),
            "eager": time_ms(torch, lambda: trim_conv2d_q8(
                x, w, bias_q, scale, w_packed=wp, **kw)),
            "plain": time_ms(torch, lambda: trim_conv2d_q8_plain(
                x, w, bias_q, scale, **kw), reps=3),
            "int_mm": time_graph_ms(torch, lambda: torch._int_mm(ga, gb)),
            "f32_library": time_ms(torch, lambda: F.conv2d(
                xp, wl, bf, stride=stride, groups=groups)),
        }
        ops_ms = plan.flops / PEAK_INT8_OPS * 1e3
        bytes_ms = plan.min_bytes() / PEAK_BYTES_PER_S * 1e3
        bound = max(ops_ms, bytes_ms)
        by = "operations" if ops_ms >= bytes_ms else "bytes"
        inst = ("dp4a", False, 0, plan.blocks_per_sm) \
            if plan.route == "dp4a" else \
            ("mma", plan.route == "im2col",
             4 if plan.m_frags > 2 else 2, plan.blocks_per_sm)
        regs = (build_info or {}).get(inst)
        rows.append(dict(name=name, err=err, bound=bound, by=by,
                         ops_ms=ops_ms, bytes_ms=bytes_ms, ops=plan.flops,
                         vgg=name.startswith("conv"), route=plan.route, **t))
        warps = (f"{plan.warps_m}x{plan.warps_n}x{plan.warps_k}/"
                 f"{plan.m_frags}" if plan.tensor_cores else "-")
        stages = plan.weight_stages if plan.tensor_cores else "-"
        print(f"  {name:10s} {'True':>5s} {t['carry']:7.4f} "
              f"({old[name]:.3f}) {t['halo']:7.4f} {t['eager']:7.4f} "
              f"{t['plain']:7.3f} {t['int_mm']:7.4f} "
              f"{t['f32_library']:7.4f} {bound:7.4f} {by[:5]:5s} "
              f"{plan.flops / t['carry'] / 1e9:6.1f} {plan.route:6s} "
              f"{warps:>8s} {stages!s:>2s} "
              f"{plan.blocks:>5d}/{halo_plan.blocks:<4d} "
              f"{plan.th_out:>3d}x{plan.tile_w}x{plan.tile_cout:<3d} "
              f"{'?' if regs is None else f'{regs[0]}/{regs[1]}'}")
        del xf, x, w, wp, xp, wl, ga, gb
    torch.cuda.empty_cache()
    vgg = [r for r in rows if r["vgg"]]
    ops = sum(r["ops"] for r in vgg)
    c_sum = sum(r["carry"] for r in vgg)
    old_c, old_h = DP4A_Q8_SUMS[n]
    print(f"int8 kernel check, batch {n}, sum of the 13 VGG-16 layers: "
          f"carry {c_sum:.4f} ms (dp4a: {old_c:.3f}; {ops / c_sum / 1e9:.1f}"
          f" TOPS), halo {sum(r['halo'] for r in vgg):.4f} ms (dp4a: "
          f"{old_h:.3f}), eager carry {sum(r['eager'] for r in vgg):.4f} "
          f"ms, plain {sum(r['plain'] for r in vgg):.3f} ms, torch._int_mm "
          f"{sum(r['int_mm'] for r in vgg):.4f} ms (GEMM only), F.conv2d "
          f"f32 {sum(r['f32_library'] for r in vgg):.3f} ms, bound "
          f"{sum(r['bound'] for r in vgg):.4f} ms ({ops / 1e9:.1f} GOP; at "
          f"the __dp4a peak {ops / PEAK_DP4A_OPS * 1e3:.3f} ms); routes "
          f"{', '.join(sorted({r['route'] for r in vgg}))}")
    if any(r["route"] == "dp4a" for r in vgg):
        raise AssertionError("q8: a VGG-16 layer took the dp4a route")
    return rows


def check_backward_kernels(torch):
    import ctypes
    from repro_torch.core import conv_plan as cp
    from repro_torch.core.conv_plan import WeightGradPlan, input_grad_geometry
    from repro_torch.kernels import build
    from repro_torch.kernels import trim_conv2d as tc
    from repro_torch.kernels.ref import conv_pads, pad_nhwc

    # the plan's time model assumes WGRAD_BLOCKS_PER_SM resident GEMM
    # blocks an SM (route mma: WGRAD_MMA_BLOCKS_PER_SM): the card must
    # agree
    lib = build.library("trim_conv2d_wgrad")
    for tile in (cp.WGRAD_NARROW_TILE_COUT, cp.WGRAD_TILE_COUT):
        for query, want in ((lib.trim_conv2d_wgrad_resident_blocks,
                             cp.WGRAD_BLOCKS_PER_SM),
                            (lib.trim_conv2d_wgrad_mma_resident_blocks,
                             cp.WGRAD_MMA_BLOCKS_PER_SM)):
            got = ctypes.c_int(0)
            err = query(tile, ctypes.byref(got))
            if err != 0 or got.value != want:
                raise AssertionError(
                    f"wgrad {tile}-column tile ({query.__name__}): "
                    f"{got.value} resident blocks an SM (CUDA error "
                    f"{err}), the plan assumes {want}")
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    print("backward kernel check (times in ms, device events):")
    print(f"  {'case':10s} {'dw_err':>9s} {'tol':>8s} {'rep':>5s} "
          f"{'dx_err':>9s} {'tol':>8s} {'wgrad':>8s} {'plain':>8s} "
          f"{'cw_lib':>8s} {'bound':>8s} by         {'TF/s w':>6s} "
          f"{'dx':>8s} route     chunks blocks")
    for name, xs, wsh, stride, groups in kernel_cases():
        k = wsh[0]
        pads = conv_pads(xs[1], xs[2], k, stride, "same")
        plan = WeightGradPlan.build(xs, wsh, stride=stride, pad=pads,
                                    groups=groups)
        x = torch.randn(xs, generator=gen, device="cuda")
        g = torch.randn((plan.n, plan.h_out, plan.w_out, plan.cout),
                        generator=gen, device="cuda")
        w = torch.randn(wsh, generator=gen, device="cuda") \
            / float(np.sqrt(k * k * wsh[2]))
        kw = dict(kernel_size=k, stride=stride, pad=pads, groups=groups)
        plain = tc.trim_conv2d_weight_grad_plain(x, g, **kw)
        one = tc.trim_conv2d_weight_grad(x, g, **kw)
        two = tc.trim_conv2d_weight_grad(x, g, **kw)
        geo = input_grad_geometry(xs, wsh, stride=stride, pad=pads,
                                  groups=groups)
        dx = tc.trim_conv2d_input_grad(g, w, x_shape=xs, stride=stride,
                                       pad=pads, groups=groups)
        dx_plain = tc.trim_conv2d_plain(
            tc.dilate_cotangent(g, stride),
            tc.transpose_conv_weights(w, groups),
            pad=(geo["pad_h"], geo["pad_w"]), groups=groups)
        torch.cuda.synchronize()
        err = (one - plain).abs().max().item()
        tol = WGRAD_TOLERANCE * plain.abs().max().item()
        rep = torch.equal(one, two)
        dx_err = (dx - dx_plain).abs().max().item()
        dx_tol = TOLERANCE * max(1.0, dx_plain.abs().max().item())
        if not np.isfinite(err) or err > tol:
            raise AssertionError(f"{name}: max|wgrad - plain| = {err} > "
                                 f"{tol}")
        if not rep:
            raise AssertionError(f"{name}: two wgrad launches differ")
        if not np.isfinite(dx_err) or dx_err > dx_tol or \
                dx.shape != x.shape:
            raise AssertionError(f"{name}: max|input grad - plain| = "
                                 f"{dx_err} > {dx_tol}")
        xp = pad_nhwc(x, pads).permute(0, 3, 1, 2)
        gl = g.permute(0, 3, 1, 2)
        wsize = (wsh[3], wsh[2], k, k)
        t = {
            "wgrad": time_ms(torch, lambda: tc.trim_conv2d_weight_grad(
                x, g, **kw)),
            "plain": time_ms(torch, lambda: tc.trim_conv2d_weight_grad_plain(
                x, g, **kw)),
            # one library call: cuDNN's weight gradient (TF32 off)
            "library": time_ms(torch, lambda: torch.nn.grad.conv2d_weight(
                xp, wsize, gl, stride=stride, groups=groups)),
            "dx": time_ms(torch, lambda: tc.trim_conv2d_input_grad(
                g, w, x_shape=xs, stride=stride, pad=pads, groups=groups)),
        }
        ops_ms = plan.flops / PEAK_F32_FLOPS * 1e3
        bytes_ms = plan.min_bytes() / PEAK_BYTES_PER_S * 1e3
        bound = max(ops_ms, bytes_ms)
        by = "operations" if ops_ms >= bytes_ms else "bytes"
        rows.append(dict(name=name, err=err, dx_err=dx_err, bound=bound,
                         by=by, ops_ms=ops_ms, bytes_ms=bytes_ms,
                         vgg=name.startswith("conv"), **t))
        print(f"  {name:10s} {err:9.2e} {tol:8.1e} {str(rep):>5s} "
              f"{dx_err:9.2e} {dx_tol:8.1e} {t['wgrad']:8.3f} "
              f"{t['plain']:8.3f} {t['library']:8.3f} {bound:8.3f} "
              f"{by:10s} {plan.flops / t['wgrad'] / 1e9:6.2f} "
              f"{t['dx']:8.3f} {plan.route:9s} {plan.chunks:6d} "
              f"{plan.blocks:6d}")
        rows[-1]["flops"] = plan.flops
        del x, g, w, plain, one, two, dx, dx_plain, xp, gl
    torch.cuda.empty_cache()
    vgg = [r for r in rows if r["vgg"]]
    wgrad_ms = sum(r["wgrad"] for r in vgg)
    print(f"backward kernel check, sum of the 13 VGG-16 layers: wgrad "
          f"{wgrad_ms:.3f} ms ({sum(r['flops'] for r in vgg) / wgrad_ms / 1e9:.2f}"
          f" TFLOP/s), conv2d_weight {sum(r['library'] for r in vgg):.3f} "
          f"ms, bound {sum(r['bound'] for r in vgg):.3f} ms, dx "
          f"{sum(r['dx'] for r in vgg):.3f} ms")
    return rows, check_wgrad_bf16(torch)


def wgrad_bf16_cases(n: int = TRAIN_BATCH):
    """(name, x_shape, (KH, KW, Cout), stride, groups, pads) of the bf16
    weight-gradient check at batch ``n``: VGG-16's 13 layers, the 112^2
    depthwise case of :func:`kernel_cases`, AlexNet conv1's sub-kernel
    shapes (the 'valid' slices of its 227x227 input at stride 4, as
    :func:`alexnet_conv1_parts` cuts them) and ResNet-18's 7x7/2 'same'
    stem at Cin 3."""
    from repro_torch.core.model import vgg16_layers
    from repro_torch.core.tiling import subkernel_decomposition
    from repro_torch.kernels.ref import conv_pads
    cases = [(l.name, (n, l.ifmap, l.ifmap, l.in_channels),
              (3, 3, l.out_channels), 1, 1,
              conv_pads(l.ifmap, l.ifmap, 3, 1, "same"))
             for l in vgg16_layers()]
    cases.append(("dw_112x32", (n, 112, 112, 32), (3, 3, 32), 1, 32,
                  conv_pads(112, 112, 3, 1, "same")))
    shapes = []
    for _, _, kh, kw in subkernel_decomposition(11):
        if (kh, kw) not in shapes:
            shapes.append((kh, kw))
            cases.append((f"alex1_{kh}x{kw}", (n, 54 * 4 + kh, 54 * 4 + kw, 3),
                          (kh, kw, 96), 4, 1, ((0, 0), (0, 0))))
    cases.append(("stem_7x7s2", (n, 224, 224, 3), (7, 7, 64), 2, 1,
                  conv_pads(224, 224, 7, 2, "same")))
    return cases


def wgrad_f64_excess(torch, dw, x, gy, plan) -> float:
    """How far the f32 sums ``dw`` of a weight gradient lie beyond their
    float64 bound (<= 0: within): |dw - dw64| <= (P + C) 2^-22
    sum|x dz|, P a chunk's positions and C its chunks (each position's
    product enters one tensor-core accumulator, which truncates as it
    adds: at most ~2^-23 of its running sum a k-step of 16; the ordered
    sum of the chunks' partials rounds C times).  A worst case that
    grows with P while the error grows as its root: at VGG-16's conv2
    (N=8, P 7840) it allows ~473 against errors of ~0.02, so on route
    mma ``WGRAD_TOLERANCE`` of max|plain| (~0.29 there) is the binding
    check; this one refuses a sum that left the float64 value wholesale
    (a lost or doubled k-step, a wrong tap)."""
    (pt, pb), (pl, pr) = plan.pads
    wsize = (plan.cout, plan.cin_per_group, plan.kh, plan.kw)
    xd = torch.nn.functional.pad(x.double().permute(0, 3, 1, 2),
                                 (pl, pr, pt, pb))
    gd = gy.double().permute(0, 3, 1, 2)
    want = torch.nn.grad.conv2d_weight(xd, wsize, gd, stride=plan.stride,
                                       groups=plan.groups)
    # the bound's scale in f32 (bf16 products exact; its own rounding
    # moves the bound by a few 2^-24 of itself)
    mass = torch.nn.grad.conv2d_weight(
        xd.abs().float(), wsize, gd.abs().float(), stride=plan.stride,
        groups=plan.groups).double()
    n = plan.tile_go * plan.w_out + plan.chunks
    excess = ((dw.double().permute(3, 2, 0, 1) - want).abs()
              - n * 2.0 ** -22 * mass).max().item()
    del xd, gd, want, mass
    return excess


def check_wgrad_bf16(torch) -> list:
    """The weight-gradient kernel's bf16 entry (``trim_conv2d_wgrad_bf16``)
    at :func:`wgrad_bf16_cases`, each case's route printed (VGG-16's
    conv2-13 must take ``mma``, conv1, the depthwise case, AlexNet
    conv1's sub-kernels and the stem keep theirs): on routes gemm and
    depthwise its f32 sums bitwise the f32 entry's on the widened
    operands; on route mma (the bf16 tensor cores, whose sum the plain
    version's einsum does not repeat) within :func:`wgrad_f64_excess`'s
    float64 bound; bitwise repeatable and within ``WGRAD_TOLERANCE`` of
    max|plain| of the plain version everywhere; device ms from CUDA
    graphs beside the f32 entry's on the widened operands,
    ``torch.nn.grad.conv2d_weight`` on bf16 (cuDNN, TF32 off; the
    yardstick) and the plain version's (eager), the bound (operations at
    989 TFLOP/s of bf16, or 2 bytes an element at 3.35 TB/s) and the FFMA
    ceiling (67 TFLOP/s)."""
    from repro_torch.core.conv_plan import WeightGradPlan
    from repro_torch.kernels import trim_conv2d as tc
    from repro_torch.kernels.ref import pad_nhwc

    gen = torch.Generator(device="cuda").manual_seed(31)
    bf, f32 = torch.bfloat16, torch.float32
    rows = []
    print(f"bf16 weight-gradient check at batch {TRAIN_BATCH} (device ms "
          "from CUDA graphs, plain eager; routes gemm / depthwise: f32 "
          "sums == the f32 entry on the widened operands, bitwise; route "
          "mma: f64 excess over its bound, <= 0):")
    print(f"  {'case':11s} {'err':>9s} {'tol':>8s} {'==f32':>5s} "
          f"{'f64_exc':>9s} {'bf16':>8s} {'f32':>8s} {'cw_lib':>8s} "
          f"{'plain':>8s} {'bound':>8s} by         {'FFMA':>8s} "
          f"{'TF/s':>6s} route     chunks blocks pos/chunk")
    for name, xs, (kh, kw, cout), s, g, pads in wgrad_bf16_cases():
        plan = WeightGradPlan.build(xs, (kh, kw, xs[3] // g, cout),
                                    stride=s, pad=pads, groups=g,
                                    dtype_bytes=2)
        if name.startswith("conv") and name != "conv1" \
                and plan.route != "mma":
            raise AssertionError(f"wgrad bf16 {name}: route {plan.route}, "
                                 "not mma")
        if (name == "conv1" or not name.startswith("conv")) \
                and plan.route == "mma":
            raise AssertionError(f"wgrad bf16 {name}: route mma")
        x = torch.randn(xs, generator=gen, device="cuda").to(bf)
        gy = torch.randn((plan.n, plan.h_out, plan.w_out, cout),
                         generator=gen, device="cuda").to(bf)
        xf, gf = x.float(), gy.float()
        kw_ = dict(kernel_size=(kh, kw), stride=s, pad=pads, groups=g)
        sums = tc.trim_conv2d_weight_grad(x, gy, **kw_)
        again = tc.trim_conv2d_weight_grad(x, gy, **kw_)
        wide = tc.trim_conv2d_weight_grad(xf, gf, **kw_)
        plain = tc.trim_conv2d_weight_grad_plain(x, gy, **kw_)
        torch.cuda.synchronize()
        err = (sums - plain).abs().max().item()
        tol = WGRAD_TOLERANCE * plain.abs().max().item()
        same = torch.equal(sums, wide)
        if sums.dtype != f32 or (plan.route != "mma" and not same):
            raise AssertionError(f"wgrad bf16 {name}: the f32 sums differ "
                                 "from the f32 entry on the widened "
                                 "operands")
        excess = float("nan")
        if plan.route == "mma":
            excess = wgrad_f64_excess(torch, sums, x, gy, plan)
            if not excess <= 0:
                raise AssertionError(f"wgrad bf16 {name}: {excess:.3e} "
                                     "beyond the float64 bound")
        if not torch.equal(sums, again):
            raise AssertionError(f"wgrad bf16 {name}: two launches differ")
        if not np.isfinite(err) or err > tol:
            raise AssertionError(f"wgrad bf16 {name}: max|kernel - plain| "
                                 f"= {err} > {tol}")
        xp = pad_nhwc(x, pads).permute(0, 3, 1, 2)
        gl = gy.permute(0, 3, 1, 2)
        wsize = (cout, xs[3] // g, kh, kw)
        t = {"kernel": time_graph_ms(torch, lambda: tc.trim_conv2d_weight_grad(
                 x, gy, **kw_)),
             "f32": time_graph_ms(torch, lambda: tc.trim_conv2d_weight_grad(
                 xf, gf, **kw_)),
             # one library call: cuDNN's bf16 weight gradient (TF32 off)
             "library": time_graph_ms(
                 torch, lambda: torch.nn.grad.conv2d_weight(
                     xp, wsize, gl, stride=s, groups=g)),
             "plain": time_ms(torch, lambda: tc.trim_conv2d_weight_grad_plain(
                 x, gy, **kw_), reps=3)}
        row = dict(name=name, vgg=name.startswith("conv"), err=err,
                   flops=plan.flops, route=plan.route, excess=excess, **t,
                   **bf16_bound(plan.flops, plan.min_bytes()))
        rows.append(row)
        print(f"  {name:11s} {err:9.2e} {tol:8.1e} {str(same):>5s} "
              f"{excess:9.2e} {t['kernel']:8.3f} {t['f32']:8.3f} "
              f"{t['library']:8.3f} {t['plain']:8.3f} {row['bound']:8.4f} "
              f"{row['by']:10s} {row['ffma']:8.3f} "
              f"{plan.flops / t['kernel'] / 1e9:6.2f} {plan.route:9s} "
              f"{plan.chunks:6d} {plan.blocks:6d} "
              f"{plan.tile_go * plan.w_out:9d}")
        del x, gy, xf, gf, sums, again, wide, plain, xp, gl
    torch.cuda.empty_cache()
    vgg = [r for r in rows if r["vgg"]]
    ms = sum(r["kernel"] for r in vgg)
    f32_ms = sum(r["f32"] for r in vgg)
    print(f"bf16 weight-gradient check, sums over the 13 VGG-16 layers: "
          f"bf16 {ms:.3f} ms ({sum(r['flops'] for r in vgg) / ms / 1e9:.2f} "
          f"TFLOP/s; route mma on conv2-13 "
          f"{sum(r['kernel'] for r in vgg if r['route'] == 'mma'):.3f}), "
          f"f32 entry {f32_ms:.3f} ms, conv2d_weight bf16 "
          f"{sum(r['library'] for r in vgg):.3f} ms, plain "
          f"{sum(r['plain'] for r in vgg):.3f} ms, bound "
          f"{sum(r['bound'] for r in vgg):.4f} ms (FFMA ceiling "
          f"{sum(r['ffma'] for r in vgg):.3f} ms)")
    if not ms < f32_ms:
        raise AssertionError(f"wgrad bf16: VGG-16's 13 layers {ms:.3f} ms, "
                             f"not below the f32 entry's {f32_ms:.3f}")
    return rows


ALEXNET_BATCHES = (8, 1)


def alexnet_conv1_parts(torch, n: int, gen):
    """AlexNet conv1's input (n, 227, 227, 3), weights (11, 11, 3, 96) and
    bias, and for each distinct sub-kernel shape of its kernel tiling
    (3x3, 3x2, 2x3, 2x2 at stride 4) the full-width 'valid' input slice
    and weight slice ``ops.conv2d`` gives the first sub-kernel of that
    shape."""
    from repro_torch.core.tiling import subkernel_decomposition
    x = torch.randn((n, 227, 227, 3), generator=gen, device="cuda")
    w = torch.randn((11, 11, 3, 96), generator=gen, device="cuda") \
        / float(np.sqrt(11 * 11 * 3))
    b = torch.randn((96,), generator=gen, device="cuda")
    parts = {}
    for r0, c0, kh, kw in subkernel_decomposition(11):
        if (kh, kw) not in parts:
            parts[(kh, kw)] = (
                x[:, r0:r0 + 54 * 4 + kh, c0:c0 + 54 * 4 + kw].contiguous(),
                w[r0:r0 + kh, c0:c0 + kw].contiguous())
    return x, w, b, parts


def check_rect_kernels(torch):
    """The rectangular sub-kernels of AlexNet conv1 at batch 8 and 1:
    carry and halo against the plain version (``TOLERANCE``) and against
    each other bitwise; the weight gradient of each against its plain
    version (``WGRAD_TOLERANCE``) and two launches bitwise equal."""
    from repro_torch.kernels import trim_conv2d as tc
    rows = []
    print("rectangular kernel check: AlexNet conv1's sub-kernels, stride "
          "4, Cin 3, Cout 96, 'valid' slices of the 227x227 input (device "
          "ms a launch, from CUDA graphs):")
    print(f"  {'n':>2s} {'kh x kw':8s} {'x slice':>16s} {'err':>9s} "
          f"{'tol':>8s} {'c==h':>5s} {'dw_err':>9s} {'tol':>8s} "
          f"{'rep':>5s} {'carry':>8s} {'halo':>8s} {'wgrad':>8s} "
          f"{'plain':>8s}")
    for n in ALEXNET_BATCHES:
        gen = torch.Generator(device="cuda").manual_seed(20 + n)
        _, _, b, parts = alexnet_conv1_parts(torch, n, gen)
        for (kh, kw), (xs, ws) in parts.items():
            kwargs = dict(stride=4, pad=0, activation="relu")
            plain = tc.trim_conv2d_plain(xs, ws, b, **kwargs)
            carry = tc.trim_conv2d(xs, ws, b, **kwargs)
            halo = tc.trim_conv2d(xs, ws, b, dataflow="halo", **kwargs)
            g = torch.randn(plain.shape, generator=gen, device="cuda")
            wkw = dict(kernel_size=(kh, kw), stride=4, pad=0)
            dw_plain = tc.trim_conv2d_weight_grad_plain(xs, g, **wkw)
            dw1 = tc.trim_conv2d_weight_grad(xs, g, **wkw)
            dw2 = tc.trim_conv2d_weight_grad(xs, g, **wkw)
            torch.cuda.synchronize()
            tol = TOLERANCE * max(1.0, plain.abs().max().item())
            err = max((carry - plain).abs().max().item(),
                      (halo - plain).abs().max().item())
            same = torch.equal(carry, halo)
            dw_tol = WGRAD_TOLERANCE * dw_plain.abs().max().item()
            dw_err = (dw1 - dw_plain).abs().max().item()
            rep = torch.equal(dw1, dw2)
            label = f"{kh}x{kw} n={n}"
            if not np.isfinite(err) or err > tol:
                raise AssertionError(f"rect {label}: max|kernel - plain| = "
                                     f"{err} > {tol}")
            if not same:
                raise AssertionError(f"rect {label}: carry and halo differ "
                                     "bitwise")
            if not np.isfinite(dw_err) or dw_err > dw_tol:
                raise AssertionError(f"rect {label}: max|wgrad - plain| = "
                                     f"{dw_err} > {dw_tol}")
            if not rep:
                raise AssertionError(f"rect {label}: two wgrad launches "
                                     "differ")
            t = {
                "carry": time_graph_ms(torch, lambda: tc.trim_conv2d(
                    xs, ws, b, **kwargs)),
                "halo": time_graph_ms(torch, lambda: tc.trim_conv2d(
                    xs, ws, b, dataflow="halo", **kwargs)),
                "wgrad": time_graph_ms(
                    torch, lambda: tc.trim_conv2d_weight_grad(xs, g, **wkw)),
                "plain": time_graph_ms(torch, lambda: tc.trim_conv2d_plain(
                    xs, ws, b, **kwargs)),
            }
            rows.append(dict(n=n, shape=(kh, kw), err=err, dw_err=dw_err,
                             **t))
            print(f"  {n:2d} {kh}x{kw:<6d} {str(tuple(xs.shape[1:3])):>16s} "
                  f"{err:9.2e} {tol:8.1e} {str(same):>5s} {dw_err:9.2e} "
                  f"{dw_tol:8.1e} {str(rep):>5s} {t['carry']:8.3f} "
                  f"{t['halo']:8.3f} {t['wgrad']:8.3f} {t['plain']:8.3f}")
            del plain, carry, halo, g, dw_plain, dw1, dw2
        del parts
    torch.cuda.empty_cache()
    return rows


def check_large_k(torch):
    """``ops.conv2d`` for K > 8 (the kernel tiling's adder tree) against
    the plain version of the whole K x K conv: AlexNet conv1 (K 11, stride
    4, 'valid', batch 8), K 9 'same' at stride 1, a depthwise K 9, and the
    P = 14 patch stem (``models.frontends.reference_vision_stem``) on a
    336x336 tile at D 1024; each forward launches the carry kernel once a
    sub-kernel.  Then K 11 and K 9 under autograd, with gelu: dx, dw and
    db against autograd of ``impl="ref"`` (``GRAD_TOLERANCE`` of each
    one's max|ref|).  Not with relu: among AlexNet conv1's 2.3 M outputs
    some pre-activations lie within rounding of 0, and the two forwards
    then take different sides of the kink (a dx difference of O(|w g|),
    0.14 read on the card), as ``branch_matched_oracle`` explains."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import trim_conv2d as tc
    from repro_torch.kernels.ref import conv_pads
    from repro_torch.models.frontends import reference_vision_stem

    gen = torch.Generator(device="cuda").manual_seed(31)
    # (name, x shape, w shape, stride, groups, padding, activation)
    cases = [("k11_s4", (8, 227, 227, 3), (11, 11, 3, 96), 4, 1, "valid",
              "relu"),
             ("k9_same", (4, 56, 56, 32), (9, 9, 32, 64), 1, 1, "same",
              "gelu"),
             ("k9_dw", (8, 56, 56, 64), (9, 9, 1, 64), 1, 64, "same",
              None),
             ("stem_p14", (1, 336, 336, 3), (14, 14, 3, 1024), 14, 1,
              "valid", None)]
    rows = []
    print("K > 8 check (ops.conv2d's adder tree against the plain K x K "
          "conv; gradients against autograd of impl='ref'):")
    for name, xs, wsh, s, g, padding, act in cases:
        k = wsh[0]
        x = torch.randn(xs, generator=gen, device="cuda")
        w = torch.randn(wsh, generator=gen, device="cuda") \
            / float(np.sqrt(k * k * wsh[2]))
        b = None if name.startswith("stem") else \
            torch.randn((wsh[3],), generator=gen, device="cuda")
        before = tc.LAUNCHES["carry"]
        if name.startswith("stem"):
            y = reference_vision_stem(x, w)
        else:
            y = ops.conv2d(x, w, stride=s, padding=padding,
                           feature_group_count=g, bias=b, activation=act)
        torch.cuda.synchronize()
        launches = tc.LAUNCHES["carry"] - before
        plain = tc.trim_conv2d_plain(
            x, w, b, stride=s, pad=conv_pads(xs[1], xs[2], k, s, padding),
            groups=g, activation=act)
        plain = plain.reshape(y.shape)
        err = (y - plain).abs().max().item()
        tol = TOLERANCE * max(1.0, plain.abs().max().item())
        if not np.isfinite(err) or err > tol or y.shape != plain.shape:
            raise AssertionError(f"{name}: max|adder tree - plain| = {err} "
                                 f"> {tol}")
        if launches != ops.conv_launches(k):
            raise AssertionError(f"{name}: {launches} carry launches, want "
                                 f"{ops.conv_launches(k)}")
        line = (f"  {name:9s} x {xs} w {wsh}: max_err {err:.2e} <= "
                f"{tol:.1e}, {launches} carry launches, out "
                f"{tuple(y.shape)}")
        row = dict(name=name, err=err)
        if name in ("k11_s4", "k9_same"):
            def grads(impl):
                leaves = [t.clone().requires_grad_() for t in (x, w, b)]
                out = ops.conv2d(leaves[0], leaves[1], stride=s,
                                 padding=padding, feature_group_count=g,
                                 bias=leaves[2], activation="gelu",
                                 impl=impl)
                return torch.autograd.grad(
                    (out * torch.linspace(-1, 1, out.shape[-1],
                                          device="cuda")).sum(), leaves)
            got, want = grads("trim"), grads("ref")
            errs = []
            for leaf, a, c in zip(("dx", "dw", "db"), got, want):
                e = (a - c).abs().max().item()
                lim = GRAD_TOLERANCE * c.abs().max().item()
                if not np.isfinite(e) or e > lim:
                    raise AssertionError(f"{name} {leaf}: max|trim - ref| = "
                                         f"{e} > {lim}")
                errs.append(f"{leaf} {e:.2e} <= {lim:.1e}")
            row["grad_err"] = errs
            line += "; grads " + ", ".join(errs)
        print(line)
        rows.append(row)
        del x, w, b, y, plain
    torch.cuda.empty_cache()
    return rows


def alexnet_table(torch, n: int):
    """AlexNet's five convs at batch ``n``: carry and halo device times
    (CUDA graphs), conv1 as the adder tree's total through ``ops.conv2d``
    with its sub-kernels' launches, the adds (and epilogue) and the input
    and weight slices' copies timed apart; ``F.conv2d`` (TF32 off) as a
    yardstick; the bound max(FLOPs / 67 TFLOP/s, bytes / 3.35 TB/s) of the
    whole K x K conv; launches a forward."""
    import torch.nn.functional as F
    from repro_torch.core.conv_plan import ConvPlan
    from repro_torch.core.model import alexnet_layers
    from repro_torch.core.tiling import subkernel_decomposition
    from repro_torch.kernels import ops
    from repro_torch.kernels import trim_conv2d as tc
    from repro_torch.kernels.ref import conv_pads, epilogue, pad_nhwc

    gen = torch.Generator(device="cuda").manual_seed(40 + n)
    rows = []
    print(f"AlexNet per layer, batch {n} (relu, bias; device ms from CUDA "
          "graphs; F.conv2d TF32 off, a yardstick):")
    print(f"  {'layer':6s} {'K/s':>5s} {'carry':>8s} {'halo':>8s} "
          f"{'F.conv':>8s} {'bound':>8s} by         {'x bound':>7s} "
          f"{'GFLOP':>7s} launches")
    for l in alexnet_layers():
        k, s = l.kernel, l.stride
        padding = "same" if l.padding else "valid"
        xs = (n, l.ifmap, l.ifmap, l.in_channels)
        wsh = (k, k, l.in_channels, l.out_channels)
        x = torch.randn(xs, generator=gen, device="cuda")
        w = torch.randn(wsh, generator=gen, device="cuda") \
            / float(np.sqrt(k * k * wsh[2]))
        b = torch.randn((wsh[3],), generator=gen, device="cuda")
        pads = conv_pads(l.ifmap, l.ifmap, k, s, padding)
        kw = dict(stride=s, padding=padding, bias=b, activation="relu")
        t = {df: time_graph_ms(torch, lambda df=df: ops.conv2d(
            x, w, dataflow=df, **kw)) for df in ("carry", "halo")}
        xp = pad_nhwc(x, pads).permute(0, 3, 1, 2)
        wl = w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        t["library"] = time_graph_ms(
            torch, lambda: F.conv2d(xp, wl, b, stride=s))
        plan = ConvPlan.build(xs, wsh, stride=s, pad=pads)
        ops_ms = plan.flops / PEAK_F32_FLOPS * 1e3
        bytes_ms = plan.min_bytes() / PEAK_BYTES_PER_S * 1e3
        bound = max(ops_ms, bytes_ms)
        by = "operations" if ops_ms >= bytes_ms else "bytes"
        row = dict(name=l.name, n=n, bound=bound, by=by, ops_ms=ops_ms,
                   bytes_ms=bytes_ms, flops=plan.flops,
                   launches=ops.conv_launches(k), **t)
        print(f"  {l.name:6s} {k:2d}/{s:<2d} {t['carry']:8.4f} "
              f"{t['halo']:8.4f} {t['library']:8.4f} {bound:8.4f} "
              f"{by:10s} {t['carry'] / bound:7.1f} "
              f"{plan.flops / 1e9:7.3f} {ops.conv_launches(k):8d}")
        if k > ops.MAX_NATIVE_K:
            subs = subkernel_decomposition(k)
            h_out = (l.ifmap - k) // s + 1
            ext = (h_out - 1) * s
            sl = [(x[:, r0:r0 + ext + kh, c0:c0 + ext + kc].contiguous(),
                   w[r0:r0 + kh, c0:c0 + kc].contiguous())
                  for r0, c0, kh, kc in subs]
            parts = [tc.trim_conv2d(a, c, stride=s) for a, c in sl]

            def slices():
                for r0, c0, kh, kc in subs:
                    x[:, r0:r0 + ext + kh, c0:c0 + ext + kc].contiguous()
                    w[r0:r0 + kh, c0:c0 + kc].contiguous()

            def adds():
                out = parts[0]
                for p_ in parts[1:]:
                    out = out + p_
                return epilogue(out, b, "relu")

            for df in ("carry", "halo"):
                row[f"sub_{df}"] = time_graph_ms(torch, lambda df=df: [
                    tc.trim_conv2d(a, c, stride=s, dataflow=df)
                    for a, c in sl])
            row["adds"] = time_graph_ms(torch, adds)
            row["slices"] = time_graph_ms(torch, slices)
            # the adds read two tensors and write one, the epilogue reads
            # and writes one: the bytes they must move
            part_bytes = 4 * parts[0].numel()
            row["tree_bytes"] = part_bytes * (3 * (len(parts) - 1) + 2)
            print(f"    {l.name}'s adder tree: {len(subs)} sub-kernel "
                  f"launches {row['sub_carry']:.4f} ms carry / "
                  f"{row['sub_halo']:.4f} ms halo, {len(parts) - 1} adds + "
                  f"the epilogue {row['adds']:.4f} ms (they move "
                  f"{row['tree_bytes'] / 1e6:.1f} MB: "
                  f"{row['tree_bytes'] / PEAK_BYTES_PER_S * 1e3:.4f} ms at "
                  f"3.35 TB/s), input and weight slices "
                  f"{row['slices']:.4f} ms")
            del sl, parts
        rows.append(row)
        del x, w, b, xp, wl
    torch.cuda.empty_cache()
    print(f"AlexNet, batch {n}, sum of the 5 convs: carry "
          f"{sum(r['carry'] for r in rows):.4f} ms, halo "
          f"{sum(r['halo'] for r in rows):.4f} ms, F.conv2d "
          f"{sum(r['library'] for r in rows):.4f} ms, bound "
          f"{sum(r['bound'] for r in rows):.4f} ms "
          f"({sum(r['flops'] for r in rows) / n / 1e9:.3f} GFLOP an image)")
    return rows


def serve_alexnet(torch):
    """Full-width AlexNet (227x227, 1000 classes, seeded random weights)
    served through ``ServingEngine`` on buckets (1, 2, 4, 8): the seeded
    Poisson trace on the carry kernel, on the halo kernel and with
    ``fused=True`` (single-stage groups: per layer); every row bit-matches
    ``forward_one`` (halo and fused rows the carry rows too), a forward
    launches 20 carry (or halo) kernels (16 sub-kernels of conv1 and one
    for each other layer), and one image's logits agree with the
    ``impl="ref"`` chain within ``TOLERANCE`` of max(1, max|ref|)."""
    from repro_torch.core.fuse_plan import FusedGroupPlan
    from repro_torch.core.model import alexnet_layers
    from repro_torch.kernels.ops import conv_launches
    from repro_torch.models.layers import TrimCNN

    topo = alexnet_layers()
    per_forward = sum(conv_launches(l.kernel) for l in topo)
    if per_forward != 20:
        raise AssertionError(f"AlexNet: {per_forward} launches a forward, "
                             "want 20 (16 + 4)")
    for b in (1, 2, 4, 8):
        if FusedGroupPlan.build(topo, n=b).fused_groups:
            raise AssertionError(f"AlexNet at batch {b}: the plan fuses "
                                 "a group")
    rng = np.random.default_rng(1)
    xs = rng.standard_normal((REQUESTS, 227, 227, 3)).astype(np.float32)
    model = TrimCNN.random(topo, n_classes=1000, seed=0, device="cuda")
    out = {}
    carry_rows, out["carry"], out["carry_fw"], s = serve(
        REQUESTS, "carry", model, xs, label="carry, AlexNet")
    out["carry_s"] = s
    _, out["halo"], out["halo_fw"], sh = serve(
        REQUESTS, "halo", model, xs, expect=carry_rows,
        label="halo, AlexNet")
    _, out["fused"], out["fused_fw"], _ = serve(
        HALO_REQUESTS, "carry", model, xs, expect=carry_rows, fused=True,
        label="fused, AlexNet")
    for key, fw in (("carry", out["carry_fw"]), ("halo", out["halo_fw"])):
        if out[key][key] != per_forward * fw:
            raise AssertionError(f"AlexNet {key}: {out[key]} for {fw} "
                                 f"forwards, want {per_forward} each")
    with torch.inference_mode():
        oracle = TrimCNN(topo, model.tree(), impl="ref")(
            torch.from_numpy(xs[:1]).cuda()).cpu().numpy()[0]
    diff = float(np.abs(oracle - carry_rows[0]).max())
    lim = TOLERANCE * max(1.0, float(np.abs(oracle).max()))
    if not diff <= lim:
        raise AssertionError(f"AlexNet logits vs impl='ref': {diff} > {lim}")
    print(f"serve[AlexNet]: request 0 logits vs impl='ref' oracle: max|diff| "
          f"{diff:.3e} <= {lim:.1e}; {per_forward} launches a forward; "
          f"carry p50 {s['p50_s'] * 1e3:.3f} ms p99 {s['p99_s'] * 1e3:.3f} "
          f"ms, halo p50 {sh['p50_s'] * 1e3:.3f} ms p99 "
          f"{sh['p99_s'] * 1e3:.3f} ms")
    del model
    torch.cuda.empty_cache()
    return out


GRAPH_BATCHES = (8, 1)       # ResNet-18's forwards; gradients at the first


def graph_walk(torch, nodes, x, conv, pool):
    """A DAG forward written against the ``GraphNode`` spec, apart from
    ``models.layers.cnn_apply_from_graph``: ``conv(node, h)`` and
    ``pool(stride, window, h)`` are the caller's, the joins are the
    spec's (add in input order, concat on channels, nearest upsample).
    Returns the last node's activation."""
    outs = {}
    for nd in nodes:
        if nd.op == "conv":
            h = conv(nd, outs[nd.inputs[0]] if nd.inputs else x)
            if nd.pool > 1 or nd.pool_window > 1:
                h = pool(nd.pool, nd.pool_window, h)
        elif nd.op == "pool":
            h = pool(nd.pool, nd.pool_window, outs[nd.inputs[0]])
        elif nd.op == "add":
            h = outs[nd.inputs[0]]
            for s in nd.inputs[1:]:
                h = h + outs[s]
        elif nd.op == "concat":
            h = torch.cat([outs[s] for s in nd.inputs], dim=-1)
        else:
            h = outs[nd.inputs[0]].repeat_interleave(nd.scale, dim=1) \
                .repeat_interleave(nd.scale, dim=2)
        outs[nd.name] = h
    return outs[nodes[-1].name]


def library_graph(torch, nodes, tree):
    """The graph's forward with every conv as one ``F.conv2d`` (channels-
    last views of NHWC tensors, 'same' pads as a pad, then bias in the
    call and the relu after it) and the per-row head: the library
    yardstick of a forward (TF32 off)."""
    import torch.nn.functional as F
    from repro_torch.kernels.ref import conv_pads, maxpool2d, pad_nhwc
    from repro_torch.models.layers import cnn_head_apply
    wl = {nd.name: tree[nd.name]["w"].permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last) for nd in nodes if nd.op == "conv"}

    def conv(nd, h):
        l = nd.layer
        pads = conv_pads(h.shape[1], h.shape[2], l.kernel, l.stride,
                         "same" if l.padding else "valid")
        y = F.conv2d(pad_nhwc(h, pads).permute(0, 3, 1, 2), wl[nd.name],
                     tree[nd.name]["b"], stride=l.stride)
        return F.relu(y).permute(0, 2, 3, 1)

    def forward(x):
        y = graph_walk(torch, nodes, x, conv,
                       lambda s, w, h: maxpool2d(h, s, w))
        return cnn_head_apply(tree["head"], y) if "head" in tree else y
    return forward


def graph_oracle(torch, nodes, x, params):
    """The ``impl="ref"`` forward of a graph with gelu convs, its max
    pools taking the windows' picks of the same forward on the TrIM
    kernels at ``(params, x)``: autograd through it is the oracle's
    gradient on the branch the kernels took (``branch_matched_oracle``
    for graphs; gelu has no branch).  Returns ``(apply_fn, flips)``, the
    pool windows where the plain ``impl="ref"`` forward picks otherwise."""
    import torch.nn.functional as F
    from repro_torch.core.netplan import layer_kernel_problem
    from repro_torch.kernels import ops
    from repro_torch.models.layers import cnn_head_apply

    def run(p, h, impl, picks=None, rec=None):
        def conv(nd, v):
            l = nd.layer
            _, _, _, padding = layer_kernel_problem(l, n=v.shape[0])
            return ops.conv2d(v, p[nd.name]["w"], bias=p[nd.name]["b"],
                              stride=l.stride, padding=padding,
                              feature_group_count=l.groups,
                              activation="gelu", impl=impl)
        it = iter(picks or ())

        def pool(s, w, v):
            vn = v.permute(0, 3, 1, 2)
            if picks is None:
                vn, ind = F.max_pool2d(vn, w, s, return_indices=True)
                rec.append(ind)
            else:
                ind = next(it)
                vn = vn.flatten(2).gather(2, ind.flatten(2)).view_as(ind)
            return vn.permute(0, 2, 3, 1).contiguous()
        return cnn_head_apply(p["head"], graph_walk(torch, nodes, h, conv,
                                                    pool))

    trim, plain = [], []
    with torch.no_grad():
        run(params, x, "trim", rec=trim)
        run(params, x, "ref", rec=plain)
    flips = sum(int((a != b).sum()) for a, b in zip(trim, plain))
    return (lambda p, h: run(p, h, "ref", picks=trim)), flips


def graph_node_table(torch, nodes, n):
    """Each conv node of a graph at batch ``n`` on its own (relu, bias,
    random input of the node's shape): ``ops.conv2d``'s device ms (CUDA
    graphs), TFLOP/s and the plan's blocks, ``F.conv2d``'s ms (TF32 off)
    and the bound."""
    import torch.nn.functional as F
    from repro_torch.core.conv_plan import ConvPlan
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import conv_pads, pad_nhwc

    gen = torch.Generator(device="cuda").manual_seed(60 + n)
    rows = []
    print(f"ResNet-18 per node, batch {n} (relu, bias; device ms from CUDA "
          "graphs; F.conv2d TF32 off, a yardstick):")
    print(f"  {'node':11s} {'geometry':22s} {'carry':>8s} {'TF/s':>6s} "
          f"{'blocks':>6s} {'F.conv':>8s} {'bound':>8s} by")
    for nd in nodes:
        if nd.op != "conv":
            continue
        l = nd.layer
        k, s = l.kernel, l.stride
        padding = "same" if l.padding else "valid"
        xs = (n, l.ifmap, l.ifmap, l.in_channels)
        wsh = (k, k, l.in_channels, l.out_channels)
        x = torch.randn(xs, generator=gen, device="cuda")
        w = torch.randn(wsh, generator=gen, device="cuda") \
            / float(np.sqrt(k * k * wsh[2]))
        b = torch.randn((wsh[3],), generator=gen, device="cuda")
        pads = conv_pads(l.ifmap, l.ifmap, k, s, padding)
        ms = time_graph_ms(torch, lambda: ops.conv2d(
            x, w, stride=s, padding=padding, bias=b, activation="relu"))
        xp = pad_nhwc(x, pads).permute(0, 3, 1, 2)
        wl = w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        lib = time_graph_ms(torch, lambda: F.conv2d(xp, wl, b, stride=s))
        plan = ConvPlan.build(xs, wsh, stride=s, pad=pads)
        ops_ms = plan.flops / PEAK_F32_FLOPS * 1e3
        bytes_ms = plan.min_bytes() / PEAK_BYTES_PER_S * 1e3
        bound = max(ops_ms, bytes_ms)
        by = "operations" if ops_ms >= bytes_ms else "bytes"
        rows.append(dict(name=nd.name, n=n, carry=ms, library=lib,
                         bound=bound, by=by, ops_ms=ops_ms,
                         bytes_ms=bytes_ms, flops=plan.flops,
                         blocks=plan.blocks))
        geo = f"{l.ifmap}² {l.in_channels}->{l.out_channels} {k}/{s}"
        print(f"  {nd.name:11s} {geo:22s} {ms:8.4f} "
              f"{plan.flops / ms / 1e9:6.2f} {plan.blocks:6d} {lib:8.4f} "
              f"{bound:8.4f} {by}")
        del x, w, b, xp, wl
    torch.cuda.empty_cache()
    print(f"ResNet-18, batch {n}, sum of the 20 convs: carry "
          f"{sum(r['carry'] for r in rows):.4f} ms, F.conv2d "
          f"{sum(r['library'] for r in rows):.4f} ms, bound "
          f"{sum(r['bound'] for r in rows):.4f} ms "
          f"({sum(r['flops'] for r in rows) / n / 1e9:.3f} GFLOP an image)")
    return rows


# The geometries the DAG topologies bring to the carry, halo and wgrad
# kernels: (name, n, h, cin, cout, k, stride, padding)
GRAPH_KERNEL_CASES = [
    ("stem_n8", 8, 224, 3, 64, 7, 2, "same"),       # ResNet-18's stem
    ("stem_n1", 1, 224, 3, 64, 7, 2, "same"),
    ("down_1x1s2", 8, 56, 64, 128, 1, 2, "valid"),  # l2b0_down
    ("head_1x1", 8, 64, 16, 4, 1, 1, "valid"),      # U-Net's out
]


def check_graph_kernels(torch):
    """The new geometries against the plain versions: carry and halo
    within ``TOLERANCE`` and bitwise equal, the weight gradient within
    ``WGRAD_TOLERANCE`` and two launches bitwise equal, the input
    gradient (the forward kernel on the stride-dilated cotangent) against
    ``ref.conv2d_input_grad`` within ``TOLERANCE``; device ms a launch
    (CUDA graphs)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import trim_conv2d as tc
    from repro_torch.kernels.ref import conv_pads

    gen = torch.Generator(device="cuda").manual_seed(50)
    rows = []
    print("graph kernel check: the DAG topologies' new geometries (relu, "
          "bias; device ms a launch from CUDA graphs):")
    print(f"  {'case':10s} {'err':>9s} {'tol':>8s} {'c==h':>5s} "
          f"{'dw_err':>9s} {'tol':>8s} {'rep':>5s} {'dx_err':>9s} "
          f"{'carry':>8s} {'halo':>8s} {'wgrad':>8s} {'plain':>8s}")
    for name, n, h, cin, cout, k, s, padding in GRAPH_KERNEL_CASES:
        x = torch.randn((n, h, h, cin), generator=gen, device="cuda")
        w = torch.randn((k, k, cin, cout), generator=gen, device="cuda") \
            / float(np.sqrt(k * k * cin))
        b = torch.randn((cout,), generator=gen, device="cuda")
        pads = conv_pads(h, h, k, s, padding)
        kw = dict(stride=s, pad=pads, activation="relu")
        plain = tc.trim_conv2d_plain(x, w, b, **kw)
        carry = tc.trim_conv2d(x, w, b, **kw)
        halo = tc.trim_conv2d(x, w, b, dataflow="halo", **kw)
        g = torch.randn(plain.shape, generator=gen, device="cuda")
        wkw = dict(kernel_size=k, stride=s, pad=pads)
        dw_plain = tc.trim_conv2d_weight_grad_plain(x, g, **wkw)
        dw1 = tc.trim_conv2d_weight_grad(x, g, **wkw)
        dw2 = tc.trim_conv2d_weight_grad(x, g, **wkw)
        dx = tc.trim_conv2d_input_grad(g, w, x_shape=tuple(x.shape),
                                       stride=s, pad=pads)
        dx_ref = ref.conv2d_input_grad(x, w, g, stride=s, padding=padding)
        torch.cuda.synchronize()
        tol = TOLERANCE * max(1.0, plain.abs().max().item())
        err = max((carry - plain).abs().max().item(),
                  (halo - plain).abs().max().item())
        same = torch.equal(carry, halo)
        dw_tol = WGRAD_TOLERANCE * dw_plain.abs().max().item()
        dw_err = (dw1 - dw_plain).abs().max().item()
        rep = torch.equal(dw1, dw2)
        dx_tol = TOLERANCE * max(1.0, dx_ref.abs().max().item())
        dx_err = (dx - dx_ref).abs().max().item()
        if not np.isfinite(err) or err > tol:
            raise AssertionError(f"graph kernels {name}: max|kernel - "
                                 f"plain| = {err} > {tol}")
        if not same:
            raise AssertionError(f"graph kernels {name}: carry and halo "
                                 "differ bitwise")
        if not np.isfinite(dw_err) or dw_err > dw_tol or not rep:
            raise AssertionError(f"graph kernels {name}: max|wgrad - plain| "
                                 f"= {dw_err} > {dw_tol} or two launches "
                                 f"differ ({rep})")
        if not np.isfinite(dx_err) or dx_err > dx_tol:
            raise AssertionError(f"graph kernels {name}: max|dx - ref| = "
                                 f"{dx_err} > {dx_tol}")
        t = {
            "carry": time_graph_ms(torch, lambda: tc.trim_conv2d(
                x, w, b, **kw)),
            "halo": time_graph_ms(torch, lambda: tc.trim_conv2d(
                x, w, b, dataflow="halo", **kw)),
            "wgrad": time_graph_ms(
                torch, lambda: tc.trim_conv2d_weight_grad(x, g, **wkw)),
            "plain": time_graph_ms(torch, lambda: tc.trim_conv2d_plain(
                x, w, b, **kw)),
        }
        rows.append(dict(name=name, err=err, dw_err=dw_err, dx_err=dx_err,
                         **t))
        print(f"  {name:10s} {err:9.2e} {tol:8.1e} {str(same):>5s} "
              f"{dw_err:9.2e} {dw_tol:8.1e} {str(rep):>5s} {dx_err:9.2e} "
              f"{t['carry']:8.4f} {t['halo']:8.4f} {t['wgrad']:8.4f} "
              f"{t['plain']:8.4f}")
        del x, w, b, plain, carry, halo, g, dw_plain, dw1, dw2, dx, dx_ref
    torch.cuda.empty_cache()
    return rows


def time_plan_groups(torch, label, plan):
    """Every fused group of a ``GraphFusePlan`` on random inputs of its
    shapes: the fused kernel against its plain version (``TOLERANCE``)
    and bitwise against its per-layer chain; device ms of each (CUDA
    graphs) beside the bound."""
    from repro_torch.kernels import trim_conv2d_fused as tfu

    gen = torch.Generator(device="cuda").manual_seed(95 + plan.n)
    rows = []
    for g in (g for g in plan.groups if g.fused):
        s0 = g.stages[0]
        x = torch.randn((g.n, s0.h_in, s0.w_in, s0.cin), generator=gen,
                        device="cuda")
        ws = [torch.randn(st.weight_shape, generator=gen, device="cuda")
              / float(np.sqrt(st.kernel ** 2 * st.cin)) for st in g.stages]
        bs = [torch.randn((st.cout,), generator=gen, device="cuda")
              for st in g.stages]
        one = tfu.trim_conv2d_fused(x, ws, bs, group=g)
        plain = tfu.trim_conv2d_fused_plain(x, ws, bs, group=g)
        chain = tfu.reference_chain(x, ws, bs, group=g)
        err = (one - plain).abs().max().item()
        tol = TOLERANCE * max(1.0, plain.abs().max().item())
        if not err <= tol or not torch.equal(one, chain):
            raise AssertionError(f"{label} {g.label}: fused vs plain {err} "
                                 f"> {tol}, or it differs from its chain")
        t = {"fused": time_graph_ms(torch, lambda: tfu.trim_conv2d_fused(
                 x, ws, bs, group=g)),
             "chain": time_graph_ms(torch, lambda: tfu.reference_chain(
                 x, ws, bs, group=g))}
        ops_ms = g.flops / PEAK_F32_FLOPS * 1e3
        bytes_ms = g.min_bytes() / PEAK_BYTES_PER_S * 1e3
        rows.append(dict(label=g.label, n=g.n, err=err,
                         bound=max(ops_ms, bytes_ms), **t))
        print(f"{label} group {g.label}, batch {g.n} (T={g.strip_rows}, "
              f"B={g.band_cols}, {g.n_tiles} blocks): fused {t['fused']:.4f} "
              f"ms, its per-layer chain {t['chain']:.4f} (bitwise equal), "
              f"bound {max(ops_ms, bytes_ms):.4f} "
              f"({'operations' if ops_ms >= bytes_ms else 'bytes'}); max|fused "
              f"- plain| {err:.2e}")
        del x, ws, bs, one, plain, chain
    return rows


def drive(torch, fn, want: dict, label: str):
    """Run ``fn`` (a main path) with every launch count set to 0 just
    before and read just after; the counts must be ``want`` (the other
    keys 0).  Returns (output, counts)."""
    from repro_torch.kernels import trim_conv2d as tc
    tc.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    got = dict(tc.LAUNCHES)
    if got != launch_counts(**want):
        raise AssertionError(f"{label}: launches {got}, want {want}")
    return out, got


def add_counts(total: dict, counts: dict) -> None:
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def resnet_forward(torch, model, n, totals):
    """Full-width ResNet-18 at batch ``n``: per node on carry and on halo,
    and ``fused=True``, each equal to carry bitwise, the logits against
    ``impl="ref"``; ms a forward, eager (CUDA events, mean of 10 after a
    warm-up) and device only (CUDA graphs), beside the ``F.conv2d``
    yardstick's; launches, peak memory, the fused groups' times."""
    from repro_torch.core.fuse_plan import GraphFusePlan
    from repro_torch.models.layers import TrimCNN

    src = model.graph[0].layer
    rng = np.random.default_rng(70 + n)
    x = torch.from_numpy(rng.standard_normal(
        (n, src.ifmap, src.ifmap, src.in_channels)).astype(np.float32)).cuda()
    tree = model.tree()
    plan = GraphFusePlan.build("resnet18", n=n)
    fused_groups = [g for g in plan.groups if g.fused]
    inside = sum(g.depth for g in fused_groups)
    variants = {
        "carry": (model, dict(carry=20)),
        "halo": (TrimCNN("resnet18", tree, dataflow="halo"), dict(halo=20)),
        "fused": (TrimCNN("resnet18", tree, fused=True),
                  dict(carry=20 - inside, fused=len(fused_groups))),
    }
    out, ms = {}, {}
    with torch.inference_mode():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for name, (m, want) in variants.items():
            out[name], counts = drive(torch, lambda: m(x), want,
                                      f"ResNet-18 {name} n={n}")
            add_counts(totals, counts)
        peak = torch.cuda.max_memory_allocated() / 2**30
        for name in ("halo", "fused"):
            if not torch.equal(out[name], out["carry"]):
                raise AssertionError(f"ResNet-18 n={n}: {name} differs from "
                                     "carry bitwise")
        oracle = TrimCNN("resnet18", tree, impl="ref")(x)
        diff = (out["carry"] - oracle).abs().max().item()
        lim = TOLERANCE * max(1.0, oracle.abs().max().item())
        if not diff <= lim or out["carry"].shape != (n, 1000):
            raise AssertionError(f"ResNet-18 n={n} logits vs impl='ref': "
                                 f"{diff} > {lim}")
        lib = library_graph(torch, model.graph, tree)
        fns = {**{name: (lambda m=m: m(x)) for name, (m, _) in
                  variants.items()}, "library": lambda: lib(x)}
        ms = {name: time_ms(torch, fn) for name, fn in fns.items()}
        graph_ms = {name: time_graph_ms(torch, fn)
                    for name, fn in fns.items()}
    groups = time_plan_groups(torch, "ResNet-18", plan)
    print(f"graph[ResNet-18] batch {n}: halo and fused (groups "
          f"{[g.label for g in fused_groups]}) equal carry bitwise; logits "
          f"vs impl='ref' max|diff| {diff:.3e} <= {lim:.1e}; ms a forward, "
          f"eager (CUDA events, mean of 10 after a warm-up) / device (the "
          f"10 captured in a CUDA graph): carry {ms['carry']:.4f} / "
          f"{graph_ms['carry']:.4f}, halo {ms['halo']:.4f} / "
          f"{graph_ms['halo']:.4f}, fused {ms['fused']:.4f} / "
          f"{graph_ms['fused']:.4f}, every conv as F.conv2d "
          f"{ms['library']:.4f} / {graph_ms['library']:.4f}; launches a "
          f"forward carry 20 / halo 20 / fused {len(fused_groups)} + carry "
          f"{20 - inside}; peak device memory {peak:.3f} GiB (tensors of "
          f"earlier phases included)")
    return dict(n=n, ms=ms, graph_ms=graph_ms, groups=groups, diff=diff,
                peak=peak, out=out["carry"], x=x)


def resnet_grads(torch, model, totals):
    """d/dx and d/dparams of ``nll_loss`` through full-width ResNet-18 at
    batch 8 on the TrIM backward kernels (``TrimCNN(trainable=True)``,
    gelu), against autograd of the same loss through ``impl="ref"`` on
    the kernels' pool picks (:func:`graph_oracle`), each within
    ``GRAD_TOLERANCE`` of its max|ref|; the plain ``impl="ref"``
    gradient's worst deviation and its pool flips are printed."""
    from repro_torch.launch.train_cnn import nll_loss
    from repro_torch.models.layers import TrimCNN
    from repro_torch.optim import adamw

    n = GRAPH_BATCHES[0]
    src = model.graph[0].layer
    rng = np.random.default_rng(80)
    x = torch.from_numpy(rng.standard_normal(
        (n, src.ifmap, src.ifmap, src.in_channels)).astype(np.float32)).cuda()
    y = torch.from_numpy(rng.integers(0, 1000, n)).cuda()
    params = {k: {m: t.detach() for m, t in v.items()}
              for k, v in model.tree().items()}
    trainable = TrimCNN("resnet18", params, activation="gelu",
                        trainable=True)
    leaves = adamw.tree_leaves(trainable.tree())
    names = ["x"] + [f"{k}.{m}" for k in sorted(params)
                     for m in sorted(params[k])]

    def trim_grads():
        xl = x.clone().requires_grad_()
        loss = nll_loss(trainable(xl), y)
        return loss, torch.autograd.grad(loss, [xl] + leaves)
    # the convs' forward, their 20 input gradients (the stem's too: x
    # requires grad) and 20 weight gradients
    (loss_t, g_trim), counts = drive(torch, trim_grads,
                                     dict(carry=40, wgrad=20),
                                     "ResNet-18 gradients")
    add_counts(totals, counts)

    def oracle_grads(apply_fn):
        xl = x.clone().requires_grad_()
        live = [t.clone().requires_grad_() for t in
                adamw.tree_leaves(params)]
        loss = nll_loss(apply_fn(adamw.tree_unflatten(params, live), xl), y)
        return loss, torch.autograd.grad(loss, [xl] + live)
    matched, flips = graph_oracle(torch, trainable.graph, x, params)
    loss_m, g_match = oracle_grads(matched)
    _, g_ref = oracle_grads(TrimCNN("resnet18", params, activation="gelu",
                                    impl="ref").apply_tree)
    worst, worst_ref = ("", 0.0), 0.0
    for name, a, b, r in zip(names, g_trim, g_match, g_ref):
        scale = b.abs().max().item()
        rel = (a - b).abs().max().item() / scale
        if not np.isfinite(rel) or rel > GRAD_TOLERANCE:
            raise AssertionError(f"ResNet-18: gradient of {name} differs "
                                 f"from the pick-matched impl='ref' by "
                                 f"{rel:.3e} of max|ref| {scale:.3e}")
        worst = max(worst, (name, rel), key=lambda t: t[1])
        worst_ref = max(worst_ref, (a - r).abs().max().item()
                        / r.abs().max().item())
    print(f"graph[ResNet-18] gradients, batch {n} (gelu): loss "
          f"{loss_t.item():.6f} (pick-matched ref {loss_m.item():.6f}); "
          f"d/dx and all {len(names) - 1} parameter leaves vs the "
          f"pick-matched impl='ref' within {GRAD_TOLERANCE:g} of max|ref| "
          f"(worst {worst[0]}: {worst[1]:.2e}); vs plain impl='ref' worst "
          f"{worst_ref:.2e}, its forward picking otherwise in {flips} pool "
          f"windows; launches {counts}")
    del g_trim, g_match, g_ref, trainable
    torch.cuda.empty_cache()
    return dict(worst=worst, worst_ref=worst_ref, flips=flips)


def unet_phase(torch, totals):
    """U-Net at the JAX defaults (64 x 64, base 16, depth 2), batch 8
    (``GRAPH_BATCHES[0]``): per node and ``fused=True`` (fused equal per
    node bitwise), against ``impl="ref"``; ms a forward; the plan's
    groups, each fused one (the last ends in the 1x1 head) timed beside
    its per-layer chain and its bound."""
    from repro_torch.core.fuse_plan import GraphFusePlan
    from repro_torch.models.layers import TrimCNN

    n = GRAPH_BATCHES[0]
    model = TrimCNN.random("unet", seed=0, device="cuda")
    tree = model.tree()
    src = model.graph[0].layer
    x = torch.from_numpy(np.random.default_rng(90).standard_normal(
        (n, src.ifmap, src.ifmap, src.in_channels)).astype(np.float32)).cuda()
    plan = GraphFusePlan.build("unet", n=n)
    fused_groups = [g for g in plan.groups if g.fused]
    inside = sum(g.depth for g in fused_groups)
    fused = TrimCNN("unet", tree, fused=True)
    with torch.inference_mode():
        per_node, counts = drive(torch, lambda: model(x), dict(carry=13),
                                 "U-Net per node")
        add_counts(totals, counts)
        out, counts = drive(torch, lambda: fused(x),
                            dict(carry=13 - inside, fused=len(fused_groups)),
                            "U-Net fused")
        add_counts(totals, counts)
        if not torch.equal(out, per_node):
            raise AssertionError("U-Net: fused differs from per node "
                                 "bitwise")
        oracle = TrimCNN("unet", tree, impl="ref")(x)
        diff = (per_node - oracle).abs().max().item()
        lim = TOLERANCE * max(1.0, oracle.abs().max().item())
        if not diff <= lim or per_node.shape != (n, src.ifmap, src.ifmap,
                                                 model.graph[-1].layer
                                                 .out_channels):
            raise AssertionError(f"U-Net vs impl='ref': {diff} > {lim}")
        fns = {"per node": lambda: model(x), "fused": lambda: fused(x)}
        ms = {name: time_ms(torch, fn) for name, fn in fns.items()}
        graph_ms = {name: time_graph_ms(torch, fn)
                    for name, fn in fns.items()}
    desc = "; ".join(
        f"{g.label} (depth {g.depth}, "
        + (f"fused, T={g.strip_rows}, B={g.band_cols}" if g.fused
           else "per layer") + ")" for g in plan.groups)
    print(f"graph[U-Net] batch {n}: groups {desc}")
    groups = time_plan_groups(torch, "U-Net", plan)
    head = next(r for r, g in zip(groups, fused_groups)
                if g.last.kernel == 1)
    print(f"graph[U-Net]: fused equals per node bitwise; vs impl='ref' "
          f"max|diff| {diff:.3e} <= {lim:.1e}; ms a forward, eager (CUDA "
          f"events) / device (CUDA graph): per node {ms['per node']:.4f} / "
          f"{graph_ms['per node']:.4f}, fused {ms['fused']:.4f} / "
          f"{graph_ms['fused']:.4f}; the group ending in the 1x1 head, "
          f"{head['label']}: {head['fused']:.4f} ms against its chain's "
          f"{head['chain']:.4f}")
    del model, fused
    torch.cuda.empty_cache()
    return dict(ms=ms, graph_ms=graph_ms, groups=groups, diff=diff)


def graph_tune(torch, model, base, cache_dir, totals):
    """``tune_graph`` of ResNet-18 at batch 8 on a cache of its own:
    model records (with the fused groups') move no plan, and the packed
    tree (``cnn_pack_params_from_graph``) gives the per-node output
    bitwise; then a measured sweep, after which the per-node forward
    (each conv on its record's plan and dataflow) is still bitwise equal
    to the default's.  ``base`` is :func:`resnet_forward`'s batch-8
    result."""
    from repro_torch.core import autotune
    from repro_torch.core.conv_plan import ConvPlan
    from repro_torch.core.fuse_plan import FusedGroupPlan, graph_segments
    from repro_torch.models.layers import TrimCNN, cnn_pack_params_from_graph

    n, x = base["n"], base["x"]
    outer = os.environ.get(autotune.CACHE_ENV)
    os.environ[autotune.CACHE_ENV] = os.path.join(cache_dir,
                                                  "graph_phase.json")
    autotune.reset_memory_cache()
    try:
        t0 = time.perf_counter()
        recs = autotune.tune_graph("resnet18", n=n, fused=True)
        t_model = time.perf_counter() - t0
        default = {}
        for nd in model.graph:
            if nd.op != "conv":
                continue
            xs, pads, ws = autotune.layer_problem(nd.layer, n=n)
            plan = ConvPlan.build(xs, ws, stride=nd.layer.stride, pad=pads)
            default[nd.name] = (plan.tile_h, plan.tile_cout, "carry")
            rec = recs["layers"][nd.name]
            if (rec["tile_h"], rec["tile_cout"], rec["dataflow"]) \
                    != default[nd.name]:
                raise AssertionError(f"tune_graph: the model record of "
                                     f"{nd.name} moves its plan: {rec}")
        for _, seg in graph_segments(model.graph):
            if len(seg) > 1 and FusedGroupPlan.build(
                    list(seg), n=n, use_autotune_cache=True) \
                    != FusedGroupPlan.build(list(seg), n=n):
                raise AssertionError("tune_graph: a fused record moves a "
                                     "group's tile")
        packed = TrimCNN("resnet18", cnn_pack_params_from_graph(
            model.tree(), "resnet18", n=n))
        with torch.inference_mode():
            out, counts = drive(torch, lambda: packed(x), dict(carry=20),
                                "ResNet-18 packed")
            add_counts(totals, counts)
            if not torch.equal(out, base["out"]):
                raise AssertionError("ResNet-18: the packed forward differs "
                                     "from per node bitwise")
            t0 = time.perf_counter()
            recs = autotune.tune_graph("resnet18", n=n, measure=True)
            t_measure = time.perf_counter() - t0
            flows = [recs["layers"][nd.name]["dataflow"]
                     for nd in model.graph if nd.op == "conv"]
            want = {df: flows.count(df) for df in ("carry", "halo")
                    if flows.count(df)}
            out, counts = drive(torch, lambda: model(x), want,
                                "ResNet-18 on measured records")
            add_counts(totals, counts)
            if not torch.equal(out, base["out"]):
                raise AssertionError("ResNet-18: the forward on measured "
                                     "records differs from the default's "
                                     "bitwise")
            tuned_ms = time_ms(torch, lambda: model(x))
    finally:
        if outer is None:
            os.environ.pop(autotune.CACHE_ENV, None)
        else:
            os.environ[autotune.CACHE_ENV] = outer
        autotune.reset_memory_cache()
    moved = sorted(nm for nm, knobs in default.items() if knobs != tuple(
        recs["layers"][nm][k] for k in ("tile_h", "tile_cout", "dataflow")))
    print(f"graph[tune]: tune_graph('resnet18', n={n}, fused=True) model "
          f"records in {t_model:.2f} s, {len(recs['layers'])} nodes on "
          f"{len({r['key'] for r in recs['layers'].values()})} problems, no "
          f"plan moved, packed forward bitwise; measured sweep "
          f"{t_measure:.2f} s (plans moved at {len(moved)} nodes {moved}; "
          f"dataflows {want}); the forward on the measured records bitwise "
          f"equal to the default, {tuned_ms:.4f} ms a forward (default "
          f"{base['ms']['carry']:.4f})")
    return dict(t_model=t_model, t_measure=t_measure, ms=tuned_ms,
                moved=moved)


def graph_phase(torch, cache_dir):
    """The DAG topologies on the card (module docstring, phase 13)."""
    from repro_torch.models.layers import TrimCNN

    krows = check_graph_kernels(torch)
    totals = launch_counts()
    model = TrimCNN.random("resnet18", n_classes=1000, seed=0,
                           device="cuda")
    fw = {n: resnet_forward(torch, model, n, totals) for n in GRAPH_BATCHES}
    tables = {n: graph_node_table(torch, model.graph, n)
              for n in GRAPH_BATCHES}
    grads_ = resnet_grads(torch, model, totals)
    unet = unet_phase(torch, totals)
    tune = graph_tune(torch, model, fw[GRAPH_BATCHES[0]], cache_dir, totals)
    for r in fw.values():
        del r["x"], r["out"]
    del model
    torch.cuda.empty_cache()
    print(f"graph: launches of the phase's main paths {totals}")
    return dict(kernels=krows, forward=fw, tables=tables, grads=grads_,
                unet=unet, tune=tune, launches=totals)


def small_chains():
    """The CPU tests' geometry chains (``tests/test_torch_fused.py``) with
    the tiles (strip_rows, band_cols) to run: a 'valid' strided stage with
    an overlapping 3/2 pool and a pointwise stage; a pool-free chain."""
    from repro_torch.core.model import ConvLayer
    return {
        "strided_valid": ([ConvLayer("s0", 17, 3, 4, 5, 2, 0),
                           ConvLayer("s1", 3, 4, 8, 1, 1, 0),
                           ConvLayer("s2", 3, 8, 8, 3, 1, 1)],
                          [(1, 1), (2, 3), (3, 2)]),
        "nopool": ([ConvLayer("p0", 9, 2, 4, 3, 1, 1),
                    ConvLayer("p1", 9, 4, 4, 3, 1, 1),
                    ConvLayer("p2", 9, 4, 6, 3, 1, 1)],
                   [(1, 1), (2, 4), (9, 9)]),
    }


def library_chain(torch, x, weights, biases, group):
    """The group as ``F.conv2d`` + ReLU + ``F.max_pool2d`` calls on an
    NCHW input (TF32 off): the library yardstick, since no single
    PyTorch call computes a group."""
    import torch.nn.functional as F
    for st, w, b in zip(group.stages, weights, biases):
        x = F.pad(x, (st.pad_lo, st.pad_hi, st.pad_lo, st.pad_hi))
        x = torch.relu(F.conv2d(x, w, b, stride=st.stride))
        if st.pooled:
            x = F.max_pool2d(x, st.pool_window, st.pool_stride)
    return x


def time_fused(torch, g, x, ws, bs, exec_bytes):
    """Device times of one fused group: the kernel, the per-layer carry
    chain, the plain version and the ``F.conv2d`` chain, with the bound
    and the plan's executed and per-layer bytes."""
    from repro_torch.kernels import trim_conv2d_fused as tf
    kw = dict(group=g, activation="relu")
    xl = x.permute(0, 3, 1, 2).contiguous()
    wl = [w.permute(3, 2, 0, 1).contiguous() for w in ws]
    with torch.inference_mode():
        t = {
            "fused": time_ms(torch, lambda: tf.trim_conv2d_fused(
                x, ws, bs, **kw)),
            "chain": time_ms(torch, lambda: tf.reference_chain(
                x, ws, bs, **kw)),
            "plain": time_ms(torch, lambda: tf.trim_conv2d_fused_plain(
                x, ws, bs, **kw), reps=3),
            "library": time_ms(torch, lambda: library_chain(
                torch, xl, wl, bs, g)),
        }
    ops_ms = g.flops / PEAK_F32_FLOPS * 1e3
    bytes_ms = g.min_bytes() / PEAK_BYTES_PER_S * 1e3
    return dict(t, bound=max(ops_ms, bytes_ms), ops_ms=ops_ms,
                bytes_ms=bytes_ms,
                by="operations" if ops_ms >= bytes_ms else "bytes",
                exec_mb=g.hbm_bytes()["total"] / 1e6,
                layer_mb=sum(exec_bytes[g.start + i]["total"]
                             for i in range(g.depth)) / 1e6)


def fused_topo():
    """VGG-16 at 1/16 width, the JAX fused parity tests' model: the
    network the fused training phase runs and the second fused serving
    trace."""
    from repro_torch.core.model import vgg16_layers
    from repro_torch.core.netplan import scale_layers
    return scale_layers(vgg16_layers(), FUSED_SCALE)


def vgg16_pair_groups(n):
    """Full-width VGG-16's two-layer groups at fixed tiles (the pair the
    fused kernel has been timed on since it was first ported):
    conv1..conv2 (8 x 16) and conv3..conv4 (4 x 8)."""
    from repro_torch.core.fuse_plan import build_group
    from repro_torch.core.model import vgg16_layers
    from repro_torch.core.netplan import infer_pools
    topo, pools = vgg16_layers(), infer_pools(vgg16_layers())
    return [build_group(topo[s:s + 2], s, n=n, strip_rows=t, band_cols=b,
                        pools=pools[s:s + 2])
            for s, t, b in ((0, 8, 16), (2, 4, 8))]


def fused_ptxas():
    """The fused kernel's ptxas lines of this run's build: (registers,
    spill bytes stored, spill bytes loaded) of each instance."""
    import re
    from repro_torch.kernels import build
    out, fn = [], None
    for line in build.build_log["trim_conv2d_fused"]["ptxas"]:
        if "entry function" in line:
            fn = line
        elif "spill" in line and fn is not None:
            st, ld = (int(v) for v in re.findall(r"(\d+) bytes spill", line))
            out.append([None, st, ld])
        elif "registers" in line and out:
            out[-1][0] = int(re.search(r"Used (\d+) registers", line)[1])
    return [tuple(r) for r in out]


def check_fused(torch):
    """Fused kernel against its plain version and the per-layer carry
    chain on full-width VGG-16's groups (the fixed-tile pair and the plan's;
    batch 8 and 1, timed), on every group the plan picks for VGG-16 at
    1/16 width (batch 8 and 1) and on the small chains; returns one row
    per group."""
    from repro_torch.core.fuse_plan import (FusedGroupPlan, build_group,
                                            per_layer_exec_bytes)
    from repro_torch.core.netplan import infer_pools
    from repro_torch.kernels import trim_conv2d_fused as tf

    regs = fused_ptxas()
    print("fused kernel, ptxas (registers, spill stores, spill loads) per "
          f"instance: {regs}")
    cases = []
    for n in (8, 1):
        full = FusedGroupPlan.build("vgg16", n=n)
        sm = full.summary()
        print(f"fused plan, VGG-16 batch {n}: {full.describe()}; executed "
              f"{sm['executed_bytes'] / 1e6:.1f} MB vs per-layer "
              f"{sm['per_layer_bytes'] / 1e6:.1f} MB, FLOPs x"
              f"{sm['executed_flops'] / sm['flops']:.4f}")
        cases += [(f"vgg16 n={n}", g, full.layer_exec_bytes)
                  for g in vgg16_pair_groups(n)]
        cases += [(f"vgg16 plan n={n}", g, full.layer_exec_bytes)
                  for g in full.fused_groups]
        plan = FusedGroupPlan.build(fused_topo(), n=n)
        if not plan.fused_groups:
            raise AssertionError(f"the VGG-16/{FUSED_SCALE} plan at batch "
                                 f"{n} has no fused group")
        sm = plan.summary()
        print(f"fused plan, VGG-16/{FUSED_SCALE} batch {n}: "
              f"{plan.describe()}; executed "
              f"{sm['executed_bytes'] / 1e6:.1f} MB vs per-layer "
              f"{sm['per_layer_bytes'] / 1e6:.1f} MB, FLOPs x"
              f"{sm['executed_flops'] / sm['flops']:.4f}")
        cases += [(f"vgg16/{FUSED_SCALE} n={n}", g, plan.layer_exec_bytes)
                  for g in plan.fused_groups]
    for name, (topo, tiles) in small_chains().items():
        exec_bytes = per_layer_exec_bytes(topo, infer_pools(topo), n=2)
        cases += [(name, build_group(topo, 0, n=2, strip_rows=t,
                                     band_cols=b), exec_bytes)
                  for t, b in tiles]
    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = []
    print("fused kernel check (relu, bias; times in ms, device events; "
          "tile_cout and passes per stage; smem in bytes):")
    print(f"  {'case':16s} {'group':13s} {'T':>3s} {'B':>3s} "
          f"{'max_err':>9s} {'tol':>8s} {'==chain':>7s} {'blocks':>6s} "
          f"{'smem':>6s} {'tile_cout':>10s} {'passes':>7s} {'fused':>8s} "
          f"{'chain':>8s} {'plain':>8s} {'F.chain':>8s} {'bound':>8s} by"
          f"         {'TF/s f':>6s} {'TF/s c':>6s} {'MB exec':>8s} "
          f"{'MB layer':>8s} {'FLOPx':>6s}")
    for case, g, exec_bytes in cases:
        s0 = g.stages[0]
        x = torch.randn((g.n, s0.h_in, s0.w_in, s0.cin), generator=gen,
                        device="cuda")
        ws = [torch.randn(st.weight_shape, generator=gen, device="cuda")
              / float(np.sqrt(st.kernel ** 2 * st.cin)) for st in g.stages]
        bs = [0.1 * torch.randn((st.cout,), generator=gen, device="cuda")
              for st in g.stages]
        kw = dict(group=g, activation="relu")
        with torch.inference_mode():
            fused = tf.trim_conv2d_fused(x, ws, bs, **kw)
            plain = tf.trim_conv2d_fused_plain(x, ws, bs, **kw)
            chain = tf.reference_chain(x, ws, bs, **kw)
        torch.cuda.synchronize()
        scale = max(1.0, plain.abs().max().item())
        err = (fused - plain).abs().max().item()
        same = torch.equal(fused, chain)
        if fused.shape != plain.shape or not np.isfinite(err) or \
                err > TOLERANCE * scale:
            raise AssertionError(f"{case} {g.label}: max|fused - plain| = "
                                 f"{err} > {TOLERANCE} * {scale}")
        if not same:
            raise AssertionError(f"{case} {g.label}: the fused kernel and "
                                 "the per-layer carry chain differ bitwise")
        row = dict(case=case, group=g.label, err=err,
                   vgg8=case == "vgg16 n=8", plan8=case == "vgg16 plan n=8",
                   strip_rows=g.strip_rows,
                   band_cols=g.band_cols, blocks=g.n_tiles,
                   smem=g.smem_bytes,
                   tile_cout=[st.tile_cout for st in g.stages],
                   passes=[st.passes for st in g.stages])
        line = (f"  {case:16s} {g.label:13s} {g.strip_rows:3d} "
                f"{g.band_cols:3d} {err:9.2e} {TOLERANCE * scale:8.1e} "
                f"{str(same):>7s} {g.n_tiles:6d} {g.smem_bytes:6d} "
                f"{'/'.join(map(str, row['tile_cout'])):>10s} "
                f"{'/'.join(map(str, row['passes'])):>7s}")
        if case.startswith("vgg16 "):
            row.update(time_fused(torch, g, x, ws, bs, exec_bytes))
            line += (f" {row['fused']:8.3f} {row['chain']:8.3f} "
                     f"{row['plain']:8.3f} {row['library']:8.3f} "
                     f"{row['bound']:8.3f} {row['by']:10s} "
                     f"{g.flops / row['fused'] / 1e9:6.2f} "
                     f"{g.flops / row['chain'] / 1e9:6.2f} "
                     f"{row['exec_mb']:8.2f} {row['layer_mb']:8.2f} "
                     f"{g.recompute:6.3f}")
        rows.append(row)
        print(line)
        del x, ws, bs, fused, plain, chain
    torch.cuda.empty_cache()
    for what, key in (("the fixed-tile full-width pair", "vgg8"),
                      ("the full-width plan's groups", "plan8")):
        sel = [r for r in rows if r[key]]
        print(f"fused kernel check, {what} at batch 8: fused "
              f"{sum(r['fused'] for r in sel):.3f} ms, per-layer chain "
              f"{sum(r['chain'] for r in sel):.3f} ms, F.conv2d chain "
              f"{sum(r['library'] for r in sel):.3f} ms, bound "
              f"{sum(r['bound'] for r in sel):.3f} ms")
    return rows


def branch_matched_oracle(topo, params, x):
    """The ``impl="ref"`` forward of ``topo`` with every ReLU mask and
    max-pool choice taken from a no-grad forward on the TrIM kernels at
    ``(params, x)``: autograd through it is the oracle's gradient on the
    branch the kernels took.  Returns ``(apply_fn, flips)``, ``flips``
    counting where the plain ``impl="ref"`` forward branches otherwise."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core.netplan import infer_pools, layer_kernel_problem
    from repro_torch.kernels import ops
    from repro_torch.models.layers import cnn_head_apply

    def run(p, h, impl, masks=None, picks=None, rec=None):
        j = 0
        for i, (l, (ps, pw)) in enumerate(zip(topo, infer_pools(topo))):
            _, _, _, padding = layer_kernel_problem(l, n=h.shape[0])
            z = ops.conv2d(h, p[f"conv{i}"]["w"], bias=p[f"conv{i}"]["b"],
                           stride=l.stride, padding=padding,
                           feature_group_count=l.groups, impl=impl)
            if masks is None:
                rec["relu"].append(z > 0)
                h = torch.relu(z)
            else:
                h = z * masks[i]
            if ps > 1 or pw > 1:
                hn = h.permute(0, 3, 1, 2)
                if picks is None:
                    hn, ind = F.max_pool2d(hn, pw, ps, return_indices=True)
                    rec["pool"].append(ind)
                else:
                    ind = picks[j]
                    hn = hn.flatten(2).gather(2, ind.flatten(2)).view_as(ind)
                j += 1
                h = hn.permute(0, 2, 3, 1).contiguous()
        return cnn_head_apply(p["head"], h)

    trim, plain = {"relu": [], "pool": []}, {"relu": [], "pool": []}
    with torch.no_grad():
        run(params, x, "trim", rec=trim)
        run(params, x, "ref", rec=plain)
    masks = [m.float() for m in trim["relu"]]
    flips = {k: sum(int((a != b).sum()) for a, b in zip(trim[k], plain[k]))
             for k in trim}
    return (lambda p, h: run(p, h, "ref", masks, trim["pool"])), flips


def grads(apply_fn, params, x, y):
    """(loss, gradient of every leaf) of ``nll_loss(apply_fn(params, x),
    y)``, leaves in ``adamw.tree_leaves`` order."""
    import torch
    from repro_torch.launch.train_cnn import nll_loss
    from repro_torch.optim import adamw
    live = [t.detach().requires_grad_() for t in adamw.tree_leaves(params)]
    loss = nll_loss(apply_fn(adamw.tree_unflatten(params, live), x), y)
    return loss, torch.autograd.grad(loss, live)


def train_vgg16(torch):
    """Full-width VGG-16 training steps; returns the wgrad and carry launch
    counts of the steps and ``{"times", "peak"}``: each step's ms and the
    peak device memory (GiB) of the timed steps."""
    from repro_torch.core.model import vgg16_layers
    from repro_torch.launch.train_cnn import train_step
    from repro_torch.models.layers import TrimCNN
    from repro_torch.optim import AdamWConfig, adamw

    topo = vgg16_layers()
    model = TrimCNN.random(topo, n_classes=1000, seed=0, device="cuda",
                           trainable=True)
    cfg = AdamWConfig()
    rng = np.random.default_rng(1)
    batches = [
        (torch.from_numpy(rng.standard_normal(
            (TRAIN_BATCH, 224, 224, 3)).astype(np.float32)).cuda(),
         torch.from_numpy(rng.integers(0, 1000, TRAIN_BATCH)).cuda())
        for _ in range(TRAIN_STEPS)]

    params = {k: {n: t.detach() for n, t in v.items()}
              for k, v in model.tree().items()}
    names = [f"{k}.{n}" for k in sorted(params) for n in sorted(params[k])]
    x0, y0 = batches[0]
    loss_t, g_trim = grads(model.apply_tree, params, x0, y0)
    matched, flips = branch_matched_oracle(topo, params, x0)
    loss_m, g_match = grads(matched, params, x0, y0)
    _, g_ref = grads(TrimCNN(topo, params, impl="ref").apply_tree, params,
                     x0, y0)
    worst, worst_ref = ("", 0.0), 0.0
    for name, a, b, r in zip(names, g_trim, g_match, g_ref):
        scale = b.abs().max().item()
        rel = (a - b).abs().max().item() / scale
        if not np.isfinite(rel) or rel > GRAD_TOLERANCE:
            raise AssertionError(f"train: step-1 gradient of {name} differs "
                                 f"from the branch-matched impl='ref' by "
                                 f"{rel:.3e} of max|ref| {scale:.3e}")
        worst = max(worst, (name, rel), key=lambda t: t[1])
        worst_ref = max(worst_ref, (a - r).abs().max().item()
                        / r.abs().max().item())
    print(f"train: step-1 loss {loss_t.item():.6f} (branch-matched ref "
          f"{loss_m.item():.6f}); gradients of all {len(names)} leaves vs "
          f"the branch-matched impl='ref' within {GRAD_TOLERANCE:g} of "
          f"max|ref| (worst {worst[0]}: {worst[1]:.2e}); vs plain "
          f"impl='ref' worst {worst_ref:.2e}, its forward taking another "
          f"branch at {flips['relu']} ReLUs and {flips['pool']} pool "
          "windows")
    del g_match, g_ref, matched
    torch.cuda.empty_cache()

    moments = adamw.init_moments(params, cfg)
    state0 = (params, moments)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, launches, step1 = timed_train_steps(torch, model, state0, cfg,
                                               batches, log=True)
    peak = torch.cuda.max_memory_allocated() / 2**30
    again, _, _, _ = train_step(*state0, 0, *batches[0],
                                apply_fn=model.apply_tree, cfg=cfg)
    same = all(torch.equal(a, b) for a, b in zip(
        adamw.tree_leaves(again), adamw.tree_leaves(step1)))
    if not same:
        raise AssertionError("train: step 1 from the same state gave "
                             "different parameters")
    print(f"train: VGG-16 full width, batch {TRAIN_BATCH}: "
          f"{np.mean(times[2:]):.1f} ms per step (mean of steps "
          f"3-{TRAIN_STEPS}, host clock to synchronize; min "
          f"{min(times[2:]):.1f}; mean of steps 2-3, the window of a 3-step "
          f"run, {np.mean(times[1:3]):.1f}; step 1 {times[0]:.1f} ms), "
          f"peak device memory {peak:.2f} GiB; step 1 repeated from the "
          "same state is bitwise equal")
    return launches, {"times": times, "peak": peak}


def timed_train_steps(torch, model, state, cfg, batches, log=False,
                      suffix=""):
    """``launch.train_cnn.train_step`` on each batch from ``state``:
    each step's ms (host clock to synchronize), every step holding
    exactly 25 carry launches (13 forward, 12 input gradients) and 13
    weight-gradient calls (under the keys of ``suffix``'s entries:
    ``"_bf16"`` for a bf16 model) and no other conv launch, and a finite
    loss.  Returns the times, the summed launch counts and the parameters
    after step 1."""
    from repro_torch.kernels import trim_conv2d as tc
    from repro_torch.launch.train_cnn import train_step
    params, moments = state
    want = launch_counts(**{"carry" + suffix: 25, "wgrad" + suffix: 13})
    launches, times = launch_counts(), []
    for i, (x, y) in enumerate(batches):
        tc.reset_launch_counts()
        t0 = time.perf_counter()
        params, moments, loss, met = train_step(
            params, moments, i, x, y, apply_fn=model.apply_tree, cfg=cfg)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        step = dict(tc.LAUNCHES)
        if step != want:
            raise AssertionError(f"train step {i}: launches {step}, want "
                                 f"25 carry{suffix} (13 forward + 12 input "
                                 f"gradients) and 13 wgrad{suffix}")
        if not np.isfinite(loss.item()):
            raise AssertionError(f"train step {i}: loss {loss.item()}")
        for key in launches:
            launches[key] += step[key]
        if i == 0:
            step1 = params
        if log:
            print(f"train{suffix}: step {i} loss {loss.item():.6f} |g| "
                  f"{met['grad_norm'].item():.4f} lr "
                  f"{met['lr'].item():.3e} {times[-1]:.1f} ms; launches "
                  f"{step}")
    return times, launches, step1


def step_times(torch, steps: int) -> dict:
    """``--step-times N``: N full-width VGG-16 AdamW steps at batch
    ``TRAIN_BATCH`` (the train phase's model, data and checks), each
    step's ms, and the weight-gradient kernel's device time summed over
    the 13 layers at the step's shapes.  The same measurement on two
    checkouts, in one call on one card, compares them."""
    from repro_torch.core.model import vgg16_layers
    from repro_torch.kernels import trim_conv2d as tc
    from repro_torch.models.layers import TrimCNN
    from repro_torch.optim import AdamWConfig, adamw
    model = TrimCNN.random(vgg16_layers(), n_classes=1000, seed=0,
                           device="cuda", trainable=True)
    cfg = AdamWConfig()
    rng = np.random.default_rng(1)
    batches = [
        (torch.from_numpy(rng.standard_normal(
            (TRAIN_BATCH, 224, 224, 3)).astype(np.float32)).cuda(),
         torch.from_numpy(rng.integers(0, 1000, TRAIN_BATCH)).cuda())
        for _ in range(steps)]
    params = {k: {n: t.detach() for n, t in v.items()}
              for k, v in model.tree().items()}
    times, _, _ = timed_train_steps(
        torch, model, (params, adamw.init_moments(params, cfg)), cfg,
        batches)
    gen = torch.Generator(device="cuda").manual_seed(2)
    wgrad = 0.0
    for layer in vgg16_layers():
        size = layer.ifmap
        x = torch.randn((TRAIN_BATCH, size, size, layer.in_channels),
                        generator=gen, device="cuda")
        g = torch.randn((TRAIN_BATCH, size, size, layer.out_channels),
                        generator=gen, device="cuda")
        wgrad += time_ms(torch, lambda: tc.trim_conv2d_weight_grad(
            x, g, kernel_size=3, pad=1))
        del x, g
    return {"step_ms": times, "mean_steps_3_on": float(np.mean(times[2:])),
            "median_steps_3_on": float(np.median(times[2:])),
            "mean_steps_2_3": float(np.mean(times[1:3])),
            "wgrad_ms_13_layers": wgrad}


def train_fused(torch):
    """One AdamW step of VGG-16/16 (``fused_topo``) with ``fused=True``
    against the same step per layer, from the same state: gradients and
    parameters bitwise equal.  Returns the fused step's launch counts."""
    from repro_torch.core.fuse_plan import FusedGroupPlan
    from repro_torch.kernels import trim_conv2d as tc
    from repro_torch.launch.train_cnn import train_step
    from repro_torch.models.layers import TrimCNN, cnn_apply_from_layers
    from repro_torch.optim import AdamWConfig, adamw

    topo = fused_topo()
    plan = FusedGroupPlan.build(topo, n=TRAIN_BATCH)
    model = TrimCNN.random(topo, n_classes=1000, seed=0, device="cuda",
                           trainable=True)
    params = {k: {n: t.detach() for n, t in v.items()}
              for k, v in model.tree().items()}
    cfg = AdamWConfig()
    moments = adamw.init_moments(params, cfg)
    rng = np.random.default_rng(4)
    x0 = torch.from_numpy(rng.standard_normal(
        (TRAIN_BATCH, 224, 224, 3)).astype(np.float32)).cuda()
    y0 = torch.from_numpy(rng.integers(0, 1000, TRAIN_BATCH)).cuda()

    def fused_fn(p, x):
        return cnn_apply_from_layers(p, topo, x, fused=True)

    _, g_layer = grads(model.apply_tree, params, x0, y0)
    _, g_fused = grads(fused_fn, params, x0, y0)
    diff = [i for i, (a, b) in enumerate(zip(g_fused, g_layer))
            if not torch.equal(a, b)]
    if diff:
        raise AssertionError(f"train[fused]: gradients of leaves {diff} "
                             "differ from the per-layer step's")
    want_params, _, _, _ = train_step(params, moments, 0, x0, y0,
                                      apply_fn=model.apply_tree, cfg=cfg)
    tc.reset_launch_counts()
    t0 = time.perf_counter()
    new, _, loss, _ = train_step(params, moments, 0, x0, y0,
                                 apply_fn=fused_fn, cfg=cfg)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = dict(tc.LAUNCHES)
    want = launch_counts(carry=25, wgrad=13, fused=len(plan.fused_groups))
    if launches != want:
        raise AssertionError(f"train[fused]: launches {launches}, want "
                             f"{want} (fused forward, per-layer recompute "
                             "of each group in the backward)")
    same = all(torch.equal(a, b) for a, b in zip(
        adamw.tree_leaves(new), adamw.tree_leaves(want_params)))
    if not same:
        raise AssertionError("train[fused]: parameters after the step "
                             "differ from the per-layer step's")
    print(f"train[fused]: VGG-16/{FUSED_SCALE}, batch {TRAIN_BATCH}, groups "
          f"{plan.describe()}; step-1 gradients of all {len(g_layer)} "
          f"leaves and the parameters after the AdamW step bitwise equal "
          f"to the per-layer step's; loss {loss.item():.6f}, {ms:.1f} ms "
          f"(host clock, first fused step), launches {launches}")
    return launches


def serve(n_requests, dataflow, model, xs, expect=None, fused=False,
          label=None):
    """Replay a seeded Poisson trace through the serving engine on one
    dataflow (or fused groups); return (results, launch counts, forwards,
    latency summary).  Rows are held against ``forward_one`` (unless ``expect``
    is given and the run is not fused) and against ``expect``.  A model
    with calibrated layers counts its per-layer launches under the int8
    kernel's key (``q8_carry`` / ``q8_halo``), a bf16 model under the bf16
    entries' (``carry_bf16``, ``halo_bf16``, ``fused_bf16``, its groups
    planned at 2 bytes an element); a layer of K > 8 launches once a
    sub-kernel of the kernel tiling."""
    from repro_torch.core.fuse_plan import FusedGroupPlan
    from repro_torch.core.serving import ServingEngine, replay
    from repro_torch.kernels.ops import conv_launches
    from repro_torch.kernels import trim_conv2d as tc
    from repro_torch.models.layers import TrimCNN
    from repro_torch.testing.load import poisson_arrivals

    topo = model.layers_list
    label = label or ("fused" if fused else dataflow)
    tree = model.tree()
    served = TrimCNN(topo, tree, dataflow=dataflow)
    # a bf16 model launches the bf16 entries (and plans bf16 groups)
    bf16 = str(served.dtype) == "torch.bfloat16"
    suffix, dtype_bytes = ("_bf16", 2) if bf16 else ("", 4)
    key = ("q8_" if "packed" in tree["conv0"] else "") + dataflow + suffix
    engine = ServingEngine.for_topology(topo, served, buckets=(1, 2, 4, 8),
                                        device="cuda", fused=fused)
    t0 = time.perf_counter()
    warm = engine.prewarm()
    print(f"serve[{label}]: prewarm {time.perf_counter() - t0:.3f} s "
          f"(model-ranked tune + first forward per bucket, s: "
          f"{ {b: round(r['seconds'], 4) for b, r in warm.items()} })")
    trace = [(t, i, xs[i]) for i, t in enumerate(
        poisson_arrivals(ARRIVAL_RATE, n_requests, seed=0))]
    tc.reset_launch_counts()
    results, rejected = replay(engine, trace)
    launches = dict(tc.LAUNCHES)
    st = engine.stats()
    forwards = sum(st["bucket_batches"].values())
    if rejected or len(results) != n_requests:
        raise AssertionError(f"served {len(results)}/{n_requests}, "
                             f"rejected {rejected}")
    want = launch_counts()
    for bucket, count in st["bucket_batches"].items():
        groups = (FusedGroupPlan.build(topo, n=bucket,
                                       dtype_bytes=dtype_bytes).fused_groups
                  if fused else ())
        inside = {i for g in groups for i in range(g.start, g.start + g.depth)}
        want["fused" + suffix] += count * len(groups)
        want[key] += count * sum(conv_launches(l.kernel)
                                 for i, l in enumerate(topo)
                                 if i not in inside)
    if launches != want:
        raise AssertionError(f"serve[{label}]: launches {launches} for "
                             f"{forwards} forwards, want {want}")
    s = engine.recorder.summary()
    print(f"serve[{label}]: {len(results)} requests, rejected 0, "
          f"bucket batches {st['bucket_batches']}, {forwards} forwards, "
          f"launches {launches}; p50 "
          f"{s['p50_s'] * 1e3:.3f} ms, p99 {s['p99_s'] * 1e3:.3f} ms, "
          f"throughput {s['throughput_rps']:.1f} req/s "
          f"(measured service times on an arrival trace at "
          f"{ARRIVAL_RATE:g} req/s)")
    against_one = expect is None or fused
    for i in range(n_requests):
        row = results[i]
        if row.shape != (1000,) or not np.isfinite(row).all():
            raise AssertionError(f"request {i}: bad logits {row.shape}")
        if against_one and not np.array_equal(row,
                                               engine.forward_one(xs[i])):
            raise AssertionError(f"serve[{label}] request {i}: served row "
                                 "differs from the single-request forward")
        if expect is not None and not np.array_equal(row, expect[i]):
            raise AssertionError(f"serve[{label}] request {i}: served row "
                                 "differs from the carry-served row")
    print(f"serve[{label}]: all {n_requests} served rows bit-match "
          + " and ".join(w for w, on in (("forward_one", against_one),
                                         ("the carry rows",
                                          expect is not None)) if on))
    return results, launches, forwards, s


def calibrate_vgg16(torch, model, images):
    """Calibrate every conv layer of ``model`` (f32, on the card) on its
    input in the f32 network's forward over ``images``, layer by layer
    (``layers.calibrate_conv2d``, as a user of the JAX package would);
    returns the tree with ``{"packed"}`` conv entries and the f32 head."""
    from repro_torch.core.netplan import infer_pools
    from repro_torch.models.layers import _apply_layer_range, calibrate_conv2d
    topo, tree = model.layers_list, model.tree()
    pools = list(infer_pools(topo))
    q8 = {"head": tree["head"]}
    h = torch.from_numpy(images).cuda()
    with torch.no_grad():
        for i, layer in enumerate(topo):
            q8[f"conv{i}"] = calibrate_conv2d(tree[f"conv{i}"], h,
                                              groups=layer.groups)
            h = _apply_layer_range(tree, topo, pools, h, i, i + 1,
                                   activation="relu", impl="trim",
                                   dataflow=None)
    return q8


def serve_q8(torch, model, xs, f32_rows):
    """Full-width VGG-16 calibrated to int8 (8 seeded images), served on
    the int8 kernel: the carry trace and part of it on halo (rows bitwise
    equal to ``forward_one`` and halo's to carry's, 13 int8 launches a
    forward and no f32 conv launch), one image's logits bitwise equal to
    the ``impl="ref"`` int8 chain (``conv2d_quantized`` a layer); prints
    the logits' deviation from the f32 model and the top-1 agreement.
    Returns the launch counts and forwards of both runs."""
    from repro_torch.core.model import vgg16_layers
    from repro_torch.models.layers import TrimCNN

    calib = np.random.default_rng(7).standard_normal(
        (8, 224, 224, 3)).astype(np.float32)
    t0 = time.perf_counter()
    qmodel = TrimCNN(vgg16_layers(), calibrate_vgg16(torch, model, calib))
    pk = qmodel.tree()["conv1"]["packed"]
    print(f"serve[int8]: calibrated 13 layers on 8 images in "
          f"{time.perf_counter() - t0:.2f} s (conv1: input scale "
          f"{float(pk.input_scale):.6g}, zero point {pk.zp})")
    rows, launches, fw, _ = serve(REQUESTS, "carry", qmodel, xs,
                                  label="int8 carry")
    _, halo_launches, halo_fw, _ = serve(HALO_REQUESTS, "halo", qmodel, xs,
                                         expect=rows, label="int8 halo")
    with torch.inference_mode():
        oracle = TrimCNN(vgg16_layers(), qmodel.tree(), impl="ref")(
            torch.from_numpy(xs[:1]).cuda()).cpu().numpy()[0]
    if not np.array_equal(oracle, rows[0]):
        raise AssertionError("serve[int8]: request 0 logits differ from "
                             "the impl='ref' int8 chain: max|diff| "
                             f"{np.abs(oracle - rows[0]).max()}")
    q8 = np.stack([rows[i] for i in range(REQUESTS)])
    f32 = np.stack([f32_rows[i] for i in range(REQUESTS)])
    if not np.isfinite(q8).all():
        raise AssertionError("serve[int8]: non-finite logits")
    dev = float(np.abs(q8 - f32).max() / np.abs(f32).max())
    top1 = float(np.mean(q8.argmax(1) == f32.argmax(1)))
    print(f"serve[int8]: request 0 logits bitwise equal to the "
          f"impl='ref' int8 chain; logits vs the f32 model over "
          f"{REQUESTS} requests: max|q8 - f32| / max|f32| = {dev:.4e}, "
          f"top-1 agreement {top1:.3f}")
    return launches, fw, halo_launches, halo_fw


def attention_cases():
    """(name, b, lq, lk, hq, hkv, d, causal, soft_cap, window); the s_*
    cases are seamless-m4t-large-v2's calls (MHA, D 64): its encoder's
    non-causal self-attention (and the prefill's cross call, the same
    shape at 4096 source frames), its decoder's causal self-attention,
    and cross calls with a target shorter and longer than the source."""
    return [("a_prefill", 2, 4096, 4096, 16, 2, 128, True, None, None),
            ("b_continue", 2, 17, 4096, 16, 2, 128, True, None, None),
            ("c_rgemma", 2, 4096, 4096, 10, 1, 256, True, 30.0, 2048),
            ("d_noncausal", 2, 4096, 4096, 16, 2, 128, False, None, None),
            ("e_ragged", 2, 17, 47, 16, 2, 128, True, None, None),
            ("f_d320", 1, 2048, 2048, 8, 2, 320, True, None, None),
            ("g_d512_win", 1, 2048, 2048, 8, 2, 512, True, None, 512),
            ("s_enc", 2, 4096, 4096, 16, 16, 64, False, None, None),
            ("s_dec", 2, 4096, 4096, 16, 16, 64, True, None, None),
            ("s_cross_short", 2, 1024, 4096, 16, 16, 64, False, None, None),
            ("s_cross_long", 2, 4096, 1024, 16, 16, 64, False, None, None)]


def attention_bound(b, lq, lk, hq, hkv, d, causal, window):
    """(ms, bound_by, flops, bytes, ffma_ms): 4 D FLOPs per unmasked
    (query, key) pair against q, k, v read once and o written once over
    3.35 TB/s.  The operations are timed at the rate of the route the
    kernel takes: D <= 256 runs 3xTF32 on the tensor cores (three TF32
    products a product: 3 x FLOPs over 495 TFLOP/s), D > 256 f32 FMAs (67
    TFLOP/s).  ``ffma_ms`` is the f32 FFMA bound of the same work, printed
    beside it."""
    q_pos = np.arange(lq) + lk - lq
    hi = np.minimum(q_pos + 1, lk) if causal else np.full(lq, lk)
    lo = np.maximum(q_pos - window + 1, 0) if window else np.zeros(lq)
    pairs = int(np.maximum(hi - lo, 0).sum())
    flops = 4 * d * pairs * b * hq
    nbytes = 4 * d * b * (2 * lq * hq + 2 * lk * hkv)
    ffma_ms = flops / PEAK_F32_FLOPS * 1e3
    ops_ms = 3 * flops / PEAK_TF32_FLOPS * 1e3 if d <= 256 else ffma_ms
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    return (max(ops_ms, bytes_ms),
            "operations" if ops_ms >= bytes_ms else "bytes", flops, nbytes,
            max(ffma_ms, bytes_ms))


def check_attention(torch):
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(3)
    rows = []
    print("attention kernel check (times in ms, device events):")
    print("  bound: the kernel's route, 3xTF32 (3 x FLOPs / 495 TFLOP/s) "
          "for D <= 256, f32 FFMA (FLOPs / 67 TFLOP/s) above; ffma_b: the "
          "FFMA bound of the same work")
    print(f"  {'case':12s} {'max_err':>9s} {'tol':>8s} {'kernel':>9s} "
          f"{'plain':>9s} {'sdpa':>9s} {'bound':>8s} by         "
          f"{'ffma_b':>8s} TFLOP/s")
    for name, b, lq, lk, hq, hkv, d, causal, cap, win in attention_cases():
        q = torch.randn((b, lq, hq, d), generator=gen, device="cuda")
        k = torch.randn((b, lk, hkv, d), generator=gen, device="cuda")
        v = torch.randn((b, lk, hkv, d), generator=gen, device="cuda")
        kw = dict(causal=causal, soft_cap=cap, window=win)
        out = fa.flash_attention(q, k, v, **kw)
        plain = fa.flash_attention_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        err = (out - plain).abs().max().item()
        tol = ATTN_TOLERANCE * plain.abs().max().item()
        if out.shape != plain.shape or not np.isfinite(err) or err > tol:
            raise AssertionError(f"attention {name}: max|kernel - plain| = "
                                 f"{err} > {tol}")
        t = {"kernel": time_ms(torch, lambda: fa.flash_attention(
                q, k, v, **kw)),
             "plain": time_ms(torch, lambda: fa.flash_attention_plain(
                 q, k, v, **kw), reps=3),
             "library": None}
        if name in ("a_prefill", "f_d320"):   # one PyTorch call computes
            # it (at D 320 SDPA's math backend)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            sdpa = F.scaled_dot_product_attention
            t["library"] = time_ms(torch, lambda: sdpa(
                qt, kt, vt, is_causal=True, enable_gqa=True))
        bound, by, flops, _, ffma = attention_bound(b, lq, lk, hq, hkv, d,
                                                    causal, win)
        rows.append(dict(name=name, err=err, bound=bound, by=by,
                         ffma_bound=ffma, **t))
        lib = "-" if t["library"] is None else f"{t['library']:9.3f}"
        print(f"  {name:12s} {err:9.2e} {tol:8.1e} {t['kernel']:9.3f} "
              f"{t['plain']:9.3f} {lib:>9s} {bound:8.3f} {by:10s} "
              f"{ffma:8.3f} {flops / t['kernel'] / 1e9:7.2f}")
        del q, k, v, out, plain
    torch.cuda.empty_cache()
    return rows


def same_tokens(picked, want, ref_logits, tol) -> bool:
    """Greedy tokens equal, except where the reference's top two logits
    lie within ``2 * tol`` (a tie the tolerance cannot resolve)."""
    got = ref_logits.gather(1, picked[:, None])[:, 0]
    return bool(((picked == want)
                 | (ref_logits.amax(1) - got <= 2 * tol)).all())


def depth_cut(params, n):
    """The first ``n`` layers of a stacked LM parameter tree (views)."""
    def cut(tree):
        if isinstance(tree, dict):
            return {k: cut(v) for k, v in tree.items()}
        return tree[:n]
    return {**params, "blocks": cut(params["blocks"])}


def lm_layer_check(torch, cfg, params, tokens):
    """Along the flash forward: each layer's attention on the kernel and
    on the ref oracle, both on that layer's input in the flash stream
    (checked); and the free-running ref stream's distance (printed)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    cref = cfg.replace(attn_impl="ref")
    pos = torch.arange(tokens.shape[1], device="cuda")[None]
    worst, drift, f64 = 0.0, [], []
    with torch.no_grad():
        xf = L.embed_apply(params["tok"], tokens, cfg)
        xr = xf.clone()
        for i in range(cfg.n_layers):
            pi = T.layer_slice(params["blocks"], i)
            h = L.norm_apply(pi["ln_att"], xf, cfg)
            e64 = attention_vs_f64(torch, fa, ref, L, pi["att"], h, cfg,
                                   pos)
            lim = max(F64_FACTOR * e64["ref"], ATTN_TOLERANCE)
            if not e64["kernel"] <= lim:
                raise AssertionError(
                    f"LM layer {i}: attention on the kernel is "
                    f"{e64['kernel']:.3e} of max|f64| from the float64 "
                    f"oracle, ref {e64['ref']:.3e}: above {lim:.3e}")
            f64.append(e64)
            af = L.attention_apply(pi["att"], h, cfg, positions=pos)
            ar = L.attention_apply(pi["att"], h, cref, positions=pos)
            err = ((af - ar).abs().max() / ar.abs().max()).item()
            if not np.isfinite(err) or err > LM_LAYER_TOLERANCE:
                raise AssertionError(f"LM layer {i}: attention on the kernel "
                                     f"vs ref = {err:.3e} of max|ref| > "
                                     f"{LM_LAYER_TOLERANCE}")
            worst = max(worst, err)
            del h, af, ar
            xf, _ = T.block_apply(pi, xf, cfg, positions=pos)
            xr, _ = T.block_apply(pi, xr, cref, positions=pos)
            drift.append(((xf - xr).abs().max() / xr.abs().max()).item())
    print(f"LM layer check: every layer's attention, kernel vs ref on the "
          f"flash forward's activations, within {worst:.2e} of max|ref| "
          f"(tol {LM_LAYER_TOLERANCE:g}); free-running flash vs ref residual "
          f"stream, max|diff| / max|ref| after layers 1, 2, 4, 8, 16, 36: "
          + ", ".join(f"{drift[i - 1]:.1e}" for i in (1, 2, 4, 8, 16, 36)))
    ratio = [e["kernel"] / e["ref"] for e in f64]
    top = int(np.argmax([e["kernel"] for e in f64]))
    print(f"LM float64 check, every layer (batch row 0, first "
          f"{F64_POSITIONS} positions, before the output projection): "
          f"kernel error <= max({F64_FACTOR:g} x ref's, "
          f"{ATTN_TOLERANCE:g}) of max|f64|; kernel / ref error ratio "
          f"{min(ratio):.2f}..{max(ratio):.2f}; largest kernel error "
          f"{f64[top]['kernel']:.2e} (ref {f64[top]['ref']:.2e}) at layer "
          f"{top}; layer 0 kernel {f64[0]['kernel']:.2e}, ref "
          f"{f64[0]['ref']:.2e}, max|s| {f64[0]['max_s']:.0f}; max|s| over "
          f"layers {max(e['max_s'] for e in f64):.0f}")
    return worst


def attention_vs_f64(torch, fa, ref, L, p, h, cfg, pos):
    """One layer's attention, the kernel and the f32 ``ref`` oracle each
    against ``ref`` in float64, on the layer's own q, k, v (formed as
    ``layers.attention_apply`` forms them), each of max|f64|; and the
    largest scaled score.  Checked against ``F64_FACTOR``."""
    x = h[:1, :F64_POSITIONS]
    q, k, v = (torch.einsum("bld,dhk->blhk", x, p[w])
               for w in ("wq", "wk", "wv"))
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = L.rope(q, pos[:, :F64_POSITIONS], cfg.rope_theta)
    k = L.rope(k, pos[:, :F64_POSITIONS], cfg.rope_theta)
    o64 = ref.attention(q.double(), k.double(), v.double(), causal=True)
    scale = o64.abs().max().item()
    err = {name: ((o.double() - o64).abs().max() / scale).item()
           for name, o in (("kernel", fa.flash_attention(q, k, v)),
                           ("ref", ref.attention(q, k, v, causal=True)))}
    group = cfg.n_heads // cfg.n_kv_heads
    s = torch.einsum("bqhd,bkhd->bhqk", q, k.repeat_interleave(group, 2))
    err["max_s"] = s.abs().max().item() / np.sqrt(q.shape[-1])
    return err


def lm_prefill(torch):
    """Full-width qwen2.5-3b prefill (the LM main path) and its checks.
    Returns what lm_serve and the kernel line need."""
    from repro_torch.configs import registry
    from repro_torch.distributed import steps
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import api
    from repro_torch.models.base import init_params

    cfg = registry.get("qwen2.5-3b").CONFIG
    assert cfg.attn_impl == "flash"
    t0 = time.perf_counter()
    params = init_params(api.params(cfg), torch.Generator(device="cuda")
                         .manual_seed(0), device="cuda")
    torch.cuda.synchronize()
    print(f"LM: {cfg.name} full width, {registry.count_params(cfg):,} "
          f"parameters drawn on the card in "
          f"{time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(3)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab, (PREFILL_BATCH, PREFILL_SEQ))).cuda()
    batch = {"tokens": tokens}
    prefill = steps.make_prefill_step(cfg)

    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        logits, nxt = prefill(params, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = fa.LAUNCHES["flash_attention"]
    if launches != 2 * cfg.n_layers:
        raise AssertionError(f"LM prefill: {launches} flash launches in 2 "
                             f"forwards, want {cfg.n_layers} each")
    peak = torch.cuda.max_memory_allocated() / 2**30
    if tuple(logits.shape) != (PREFILL_BATCH, PREFILL_SEQ, cfg.vocab) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"LM prefill: logits {tuple(logits.shape)} "
                             "not finite or of the wrong shape")
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    ref_logits, ref_nxt = steps.make_prefill_step(
        cfg.replace(attn_impl="ref"))(params, batch)
    torch.cuda.synchronize()
    ref_ms = (time.perf_counter() - t0) * 1e3
    if fa.LAUNCHES["flash_attention"] != 0:
        raise AssertionError("LM prefill: the ref forward launched the kernel")
    drift = ((logits - ref_logits).abs().max()
             / ref_logits.abs().max()).item()
    print(f"LM prefill: {PREFILL_BATCH} x {PREFILL_SEQ} tokens, flash "
          f"{times[1]:.1f} ms per forward (first {times[0]:.1f} ms), "
          f"{cfg.n_layers} kernel launches each; ref {ref_ms:.1f} ms, 0 "
          f"launches; peak device memory {peak:.2f} GiB (flash forwards); "
          f"whole-depth logits flash vs ref max|diff| / max|ref| "
          f"{drift:.2e}, next tokens {nxt.tolist()} vs {ref_nxt.tolist()} "
          "(printed: the 36-layer function is chaotic under this init)")
    del logits, ref_logits
    torch.cuda.empty_cache()

    layer_err = lm_layer_check(torch, cfg, params, tokens)

    c1, p1 = cfg.replace(n_layers=1), depth_cut(params, 1)
    l1, n1 = steps.make_prefill_step(c1)(p1, batch)
    r1, m1 = steps.make_prefill_step(c1.replace(attn_impl="ref"))(p1, batch)
    scale = r1.abs().max().item()
    err1 = (l1 - r1).abs().max().item() / scale
    if not np.isfinite(err1) or err1 > LM_TOLERANCE or not same_tokens(
            n1, m1, r1[:, -1], LM_TOLERANCE * scale):
        raise AssertionError(f"LM prefill, depth-1 cut: flash vs ref "
                             f"{err1:.3e} of max|logits| (tol "
                             f"{LM_TOLERANCE}), tokens {n1.tolist()} vs "
                             f"{m1.tolist()}")
    print(f"LM prefill, depth-1 cut of the same weights and tokens: flash vs "
          f"ref logits within {err1:.2e} of max|logits| (tol "
          f"{LM_TOLERANCE:g}), next tokens {n1.tolist()} == {m1.tolist()}")
    del l1, r1
    torch.cuda.empty_cache()
    return dict(cfg=cfg, params=params, tokens=tokens, launches=launches,
                ms=times[1], ref_ms=ref_ms, peak=peak, layer_err=layer_err,
                err1=err1)


def decode_logits(torch, cfg, params, tokens):
    """Logits of every position, fed token by token through ``api.decode``
    (the body of ``steps.make_decode_step``, which keeps only the token)."""
    from repro_torch.models import api
    from repro_torch.models.base import init_params
    b, n = tokens.shape
    state = init_params(api.decode_state(cfg, b, n), torch.Generator(),
                        device="cuda")
    out = []
    with torch.no_grad():
        for t in range(n):
            lg, state = api.decode(params, {
                "tokens": tokens[:, t:t + 1],
                "cache_len": torch.full((b,), t + 1, dtype=torch.int32,
                                        device="cuda")}, state, cfg)
            out.append(lg[:, 0])
    return torch.stack(out, dim=1)


def decode_device_share(torch, cfg, params, prompts, n=8):
    """(device ms, wall ms, kernels) per decode step, from torch.profiler
    over ``n`` steps after a warm-up: the kernels' summed device time
    against the host clock."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.distributed import steps
    from repro_torch.models import api
    from repro_torch.models.base import init_params
    b = prompts.shape[0]
    state = init_params(api.decode_state(cfg, b, n + 2), torch.Generator(),
                        device="cuda")
    decode = steps.make_decode_step(cfg)

    def step(t):
        return decode(params, state, {
            "tokens": prompts[:, t:t + 1],
            "cache_len": torch.full((b,), t + 1, dtype=torch.int32,
                                    device="cuda")})
    step(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for t in range(1, n + 1):
            step(t)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device = sum(e.device_time for e in kernels) / 1e3
    return device / n, wall / n, len(kernels) / n


def family_serve(torch, label, cfg, params, seed):
    """``serve_batch`` at full width through a family's decode state:
    tokens/s, ms per decode step and the step's device-busy share."""
    from repro_torch.launch.serve import serve_batch
    rng = np.random.default_rng(seed)
    prompts = torch.from_numpy(rng.integers(
        2, cfg.vocab, (SERVE_BATCH, SERVE_PROMPT))).cuda()
    serve_batch(cfg, params, prompts, 2)              # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = serve_batch(cfg, params, prompts, SERVE_GEN)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    steps_run = SERVE_PROMPT + SERVE_GEN - 1
    if tuple(out.shape) != (SERVE_BATCH, SERVE_PROMPT + SERVE_GEN) or \
            not torch.equal(out[:, :SERVE_PROMPT], prompts) or \
            int(out.min()) < 0 or int(out.max()) >= cfg.vocab:
        raise AssertionError(f"{label} serve: bad output {tuple(out.shape)}")
    tok_s = SERVE_BATCH * SERVE_GEN / dt
    print(f"{label} serve: serve_batch batch {SERVE_BATCH}, prompt "
          f"{SERVE_PROMPT}, gen {SERVE_GEN}: {dt * 1e3:.1f} ms for "
          f"{steps_run} decode steps ({dt * 1e3 / steps_run:.2f} ms a step), "
          f"{tok_s:.1f} tok/s batch-aggregate; sample "
          f"{out[0, SERVE_PROMPT:SERVE_PROMPT + 8].tolist()}")
    busy = decode_device_share(torch, cfg, params, prompts)
    print(f"{label} serve: decode step at batch {SERVE_BATCH}, "
          f"torch.profiler over 8 steps: device busy {busy[0]:.2f} ms of "
          f"{busy[1]:.2f} ms a step ({busy[0] / busy[1]:.1%}), "
          f"{busy[2]:.0f} kernels a step"
          if busy[0] > 0 else f"{label} serve: decode device share not "
          "measured (the profiler recorded no kernel)")
    return dict(tok_s=tok_s, step_ms=dt * 1e3 / steps_run, busy=busy,
                prompts=prompts)


def lm_serve(torch, lm):
    """``serve_batch`` at full width and the decode-vs-prefill checks."""
    from repro_torch.distributed import steps

    cfg, params = lm["cfg"], lm["params"]
    served = family_serve(torch, "LM", cfg, params, 4)
    prompts = served["prompts"]

    # full depth, serve prompt, last position: printed
    flash, _ = steps.make_prefill_step(cfg)(params, {"tokens": prompts})
    dec = decode_logits(torch, cfg, params, prompts)
    full = ((dec[:, -1] - flash[:, -1]).abs().max()
            / flash[:, -1].abs().max()).item()
    # depth-1 cut, 256-token prompt, every position: checked
    c1 = cfg.replace(n_layers=1)
    p1 = depth_cut(params, 1)
    toks = lm["tokens"][:, :CROSS_PROMPT]
    flash1, _ = steps.make_prefill_step(c1)(p1, {"tokens": toks})
    dec1 = decode_logits(torch, c1, p1, toks)
    err = ((dec1 - flash1).abs().max() / flash1.abs().max()).item()
    if not np.isfinite(err) or err > LM_TOLERANCE:
        raise AssertionError(f"LM decode vs flash prefill (depth-1 cut, "
                             f"{CROSS_PROMPT} tokens): {err:.3e} of "
                             f"max|logits| > {LM_TOLERANCE}")
    print(f"LM decode vs flash prefill: depth-1 cut, {CROSS_PROMPT}-token "
          f"prompt, every position within {err:.2e} of max|logits| (tol "
          f"{LM_TOLERANCE:g}); full depth, serve prompt, last position "
          f"{full:.2e} (printed)")
    return dict(served, cross_err=err, cross_full=full)


def conv1d_cases():
    """(name, b, length, d, k, tile_l, strided): the falcon-mamba-7b
    prefill's shape (contiguous, and the mixer's strided half of the
    in-projection), then the edge cases, then recurrentgemma-2b's prefill
    shape (the rec mixer's contiguous (B, L, lru_width))."""
    return [("a_prefill", 2, 2048, 8192, 4, None, False),
            ("b_mixer_view", 2, 2048, 8192, 4, None, True),
            ("c_ragged_runs", 2, 1000, 256, 4, 64, False),
            ("d_l_below_k", 2, 2, 64, 4, None, False),
            ("e_d5_k2_b3", 3, 7, 5, 2, None, False),
            ("f_d24", 1, 100, 24, 4, None, False),
            ("g_k3_view", 2, 33, 16, 3, 5, True),
            ("h_decode_len", 4, 1, 8192, 4, None, True),
            ("i_k9", 2, 2048, 8192, 9, None, False),
            ("j_k16_view", 2, 300, 96, 16, 7, True),
            ("k_rgemma", 2, 4096, 2560, 4, None, False)]


def check_conv1d(torch):
    """The conv1d kernel against its plain version and the oracle, bit
    for bit, at every case; at the prefills' rows (the mixer's view, row
    (a); recurrentgemma-2b's, row (b); also the contiguous mamba input and
    K 9) device ms from CUDA graphs over input copies past the L2 beside
    the plain version's (events), ``F.conv1d``'s (TF32 off) and the
    bound, the wrapper's host us a call and the plan's geometry."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels import trim_conv1d as tc1

    gen = torch.Generator(device="cuda").manual_seed(5)
    rows = []
    print("conv1d kernel check (bitwise; ms: kernel and F.conv1d from CUDA "
          "graphs over input copies past the L2, plain device events; "
          "host: the wrapper's us a call):")
    print(f"  {'case':14s} {'shape':>22s} {'T_l':>4s} {'grid':>12s} "
          f"{'max_err':>8s} {'kernel':>8s} {'plain':>8s} {'F.conv1d':>8s} "
          f"{'bound':>8s} {'of bnd':>6s} {'host':>5s}  geometry")
    for name, b, length, d, k, tile_l, strided in conv1d_cases():
        xz = torch.randn((b, length, 2 * d if strided else d),
                         generator=gen, device="cuda")
        x = xz[..., :d]
        w = 0.5 * torch.randn((k, d), generator=gen, device="cuda")
        out = tc1.trim_conv1d(x, w, tile_l=tile_l)
        plain = tc1.trim_conv1d_plain(x, w, tile_l=tile_l)
        oracle = ref.depthwise_conv1d(x, w)
        torch.cuda.synchronize()
        err = (out - plain).abs().max().item()
        if not (torch.equal(out, plain) and torch.equal(out, oracle)):
            raise AssertionError(f"conv1d {name}: the kernel differs from "
                                 f"its plain version (max|diff| {err}) or "
                                 "the oracle")
        plan = tc1.plan_for(x, w, tile_l)
        bound, by = plan.bound()
        row = dict(name=name, err=err, bound=bound, by=by, kernel=None,
                   plain=None, library=None)
        line = (f"  {name:14s} {str((b, length, d, k)):>22s} "
                f"{plan.tile_l:4d} {str(plan.grid):>12s} {err:8.1e}")
        if length * d >= 4096 * 2560:       # the prefills' shapes: timed
            xt = x.transpose(1, 2).contiguous()     # (B, D, L) for cuDNN
            wt = w.t()[:, None, :].contiguous()     # (D, 1, K)
            lib = F.conv1d(xt, wt, padding=k - 1, groups=d)[..., :length]
            lib_err = (lib.transpose(1, 2) - plain).abs().max().item()
            row.update(conv1d_timed(
                torch, plan, lambda a, b: tc1.trim_conv1d(a, b),
                lambda a, b: F.conv1d(a, b, padding=k - 1,
                                      groups=d)[..., :length],
                [x, w], [xt, wt]),
                plain=time_ms(torch, lambda: tc1.trim_conv1d_plain(x, w)),
                lib_err=lib_err)
            line += (f" {row['kernel']:8.4f} {row['plain']:8.4f} "
                     f"{row['library']:8.4f} {bound:8.4f} "
                     f"{row['of_bound']:6.1%} {row['host_us']:5.1f}  "
                     f"{row['geometry']} (F.conv1d vs plain {lib_err:.1e})")
            del xt, wt, lib
        rows.append(row)
        print(line)
        del xz, x, w, out, plain, oracle
    torch.cuda.empty_cache()
    return rows


def mamba_streams(torch, cfg, params, tokens):
    """Residual stream after every layer, full-sequence prefill against
    token-by-token decode (the mixer's two modes): [max|diff| /
    max|prefill| per layer], printed to show where the two paths part.
    The logits are checked through the entry points (mamba_prefill)."""
    from repro_torch.models import layers as L
    from repro_torch.models import mamba as M
    from repro_torch.models.base import init_params
    from repro_torch.models.transformer import layer_slice
    b, n = tokens.shape
    drift = []
    with torch.no_grad():
        x = L.embed_apply(params["tok"], tokens, cfg)
        pre = []
        for i in range(cfg.n_layers):
            pi = layer_slice(params["blocks"], i)
            x = x + M.mixer_apply(pi["mixer"], L.norm_apply(pi["ln"], x, cfg),
                                  cfg)
            pre.append(x)
        state = init_params(M.make_state(cfg, b), torch.Generator(),
                            device="cuda")
        dec = [torch.empty_like(x) for _ in range(cfg.n_layers)]
        for t in range(n):
            xt = L.embed_apply(params["tok"], tokens[:, t:t + 1], cfg)
            for i in range(cfg.n_layers):
                pi = layer_slice(params["blocks"], i)
                xt = xt + M.mixer_apply(
                    pi["mixer"], L.norm_apply(pi["ln"], xt, cfg), cfg,
                    state=(state["conv"][i], state["ssm"][i]))
                dec[i][:, t:t + 1] = xt
        for a, d in zip(pre, dec):
            drift.append(((a - d).abs().max() / a.abs().max()).item())
    return drift


def mamba_prefill(torch):
    """Full-width falcon-mamba-7b prefill (the ssm main path) and its
    checks.  Returns what mamba's serve phase and the kernel line need."""
    from repro_torch.configs import registry
    from repro_torch.distributed import steps
    from repro_torch.kernels import ops
    from repro_torch.kernels import trim_conv1d as tc1
    from repro_torch.models import api
    from repro_torch.models import layers as L
    from repro_torch.models import mamba as M
    from repro_torch.models.base import init_params
    from repro_torch.models.transformer import layer_slice

    cfg = registry.get("falcon-mamba-7b").CONFIG
    n_params = registry.count_params(cfg)
    if n_params != 7_272_665_088:
        raise AssertionError(f"falcon-mamba-7b: {n_params:,} parameters")
    t0 = time.perf_counter()
    params = init_params(api.params(cfg), torch.Generator(device="cuda")
                         .manual_seed(0), device="cuda")
    torch.cuda.synchronize()
    print(f"mamba: {cfg.name} full width ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, d_inner {cfg.d_inner}), {n_params:,} parameters "
          f"drawn on the card in {time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(6)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab, (MAMBA_BATCH, MAMBA_SEQ))).cuda()
    batch = {"tokens": tokens}
    prefill = steps.make_prefill_step(cfg)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tc1.reset_launch_counts()
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        logits, nxt = prefill(params, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = tc1.LAUNCHES["trim_conv1d"]
    peak = torch.cuda.max_memory_allocated() / 2**30
    if launches != 2 * cfg.n_layers:
        raise AssertionError(f"mamba prefill: {launches} trim_conv1d "
                             f"launches in 2 forwards, want {cfg.n_layers} "
                             "each")
    if tuple(logits.shape) != (MAMBA_BATCH, MAMBA_SEQ, cfg.vocab) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"mamba prefill: logits {tuple(logits.shape)} "
                             "not finite or of the wrong shape")
    std = logits.std().item()
    del logits
    torch.cuda.empty_cache()

    # one layer's conv and scan on its real input (every layer has the
    # same shapes, so 64 x these is their share of a forward)
    with torch.no_grad():
        p0 = layer_slice(params["blocks"], 0)
        h = L.norm_apply(p0["ln"], L.embed_apply(params["tok"], tokens, cfg),
                         cfg)
        xin = (h @ p0["mixer"]["w_in"])[..., :cfg.d_inner]
        w = p0["mixer"]["conv_w"]
        conv_ms = time_ms(torch, lambda: ops.depthwise_conv1d(xin, w))
        xc = torch.nn.functional.silu(ops.depthwise_conv1d(xin, w)
                                      + p0["mixer"]["conv_b"])
        scan_ms = time_ms(torch, lambda: M.ssm_apply(p0["mixer"], xc, cfg),
                          reps=3)
        del h, xin, xc
    torch.cuda.empty_cache()
    fwd = times[1]
    print(f"mamba prefill: {MAMBA_BATCH} x {MAMBA_SEQ} tokens, "
          f"{fwd:.1f} ms per forward (first {times[0]:.1f} ms), "
          f"{cfg.n_layers} trim_conv1d launches each; peak device memory "
          f"{peak:.2f} GiB; logits std {std:.3f}, next tokens "
          f"{nxt.tolist()}; one layer: conv {conv_ms:.4f} ms (the strided "
          f"in-projection view), selective scan (ssm_apply) {scan_ms:.2f} "
          f"ms; x {cfg.n_layers}: conv {cfg.n_layers * conv_ms / fwd:.2%}, "
          f"scan {cfg.n_layers * scan_ms / fwd:.2%} of the forward")

    drift = mamba_streams(torch, cfg, params,
                          tokens[:, :MAMBA_DRIFT_PROMPT])
    at = [i for i in (1, 2, 4, 8, 16, 32, 64) if i <= len(drift)]
    print(f"mamba divergence, full depth, {MAMBA_DRIFT_PROMPT}-token "
          f"prompt: prefill vs decode residual stream, max|diff| / "
          f"max|prefill| after layers {', '.join(map(str, at))}: "
          + ", ".join(f"{drift[i - 1]:.1e}" for i in at))

    # prefill (make_prefill_step) against decode (api.decode, token by
    # token) at every position: at the depth-1 and depth-2 cuts and at
    # full depth, on the shorter prompt there
    cut_errs = {}
    for depth, n in ((1, MAMBA_CROSS_PROMPT), (2, MAMBA_CROSS_PROMPT),
                     (cfg.n_layers, MAMBA_DRIFT_PROMPT)):
        toks = tokens[:, :n]
        cd, pd = cfg.replace(n_layers=depth), depth_cut(params, depth)
        full, nxt_d = steps.make_prefill_step(cd)(pd, {"tokens": toks})
        dec = decode_logits(torch, cd, pd, toks)
        scale = full.abs().max().item()
        err = (dec - full).abs().max().item() / scale
        if not np.isfinite(err) or err > MAMBA_TOLERANCE or not same_tokens(
                dec[:, -1].argmax(-1), nxt_d, full[:, -1],
                MAMBA_TOLERANCE * scale):
            raise AssertionError(f"mamba decode vs prefill, depth "
                                 f"{depth}: {err:.3e} of max|logits| (tol "
                                 f"{MAMBA_TOLERANCE})")
        cut_errs[depth] = err
        del full, dec
    print(f"mamba decode vs prefill, every position: "
          f"{MAMBA_CROSS_PROMPT}-token prompt, depth-1 cut "
          f"{cut_errs[1]:.2e}, depth-2 cut {cut_errs[2]:.2e}; "
          f"{MAMBA_DRIFT_PROMPT}-token prompt, full depth "
          f"{cut_errs[cfg.n_layers]:.2e} of max|logits| (tol "
          f"{MAMBA_TOLERANCE:g}), same last tokens")
    torch.cuda.empty_cache()
    return dict(cfg=cfg, params=params, launches=launches, ms=fwd,
                peak=peak, conv_ms=conv_ms, scan_ms=scan_ms, drift=drift,
                cut_errs=cut_errs)


def hybrid_cut(params, n):
    """The first ``n`` layers of a hybrid parameter tree (per-layer
    dicts; views)."""
    return {**params, "blocks": {f"layer_{i}": params["blocks"][f"layer_{i}"]
                                 for i in range(n)}}


def rgemma_layer_check(torch, cfg, params, tokens):
    """Along the flash forward: each att layer's attention on the kernel
    and on the ref oracle, on that layer's input in the flash stream
    (checked, ``LM_LAYER_TOLERANCE``); the free-running ref stream's
    distance after every layer (printed); and one rec layer's RG-LRU scan
    and temporal conv and one att layer's kernel launch timed on their
    real inputs.  Returns (worst attention error, drift, times)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models import layers as L
    from repro_torch.models import rglru as R
    cref = cfg.replace(attn_impl="ref")
    pos = torch.arange(tokens.shape[1], device="cuda")[None]
    worst, drift, times = 0.0, [], {}
    with torch.no_grad():
        xf = L.embed_apply(params["tok"], tokens, cfg)
        xr = xf.clone()
        for i in range(cfg.n_layers):
            pi = params["blocks"][f"layer_{i}"]
            h = L.norm_apply(pi["ln_mix"], xf, cfg)
            if "att" in pi:
                kw = dict(positions=pos, window=cfg.window)
                af = L.attention_apply(pi["att"], h, cfg, **kw)
                ar = L.attention_apply(pi["att"], h, cref, **kw)
                err = ((af - ar).abs().max() / ar.abs().max()).item()
                if not np.isfinite(err) or err > LM_LAYER_TOLERANCE:
                    raise AssertionError(
                        f"recurrentgemma layer {i}: attention on the kernel "
                        f"vs ref = {err:.3e} of max|ref| > "
                        f"{LM_LAYER_TOLERANCE}")
                worst = max(worst, err)
                if "attention" not in times:
                    p = pi["att"]
                    q = L.rope(torch.einsum("bld,dhk->blhk", h, p["wq"]),
                               pos, cfg.rope_theta)
                    k = L.rope(torch.einsum("bld,dhk->blhk", h, p["wk"]),
                               pos, cfg.rope_theta)
                    v = torch.einsum("bld,dhk->blhk", h, p["wv"])
                    times["attention"] = time_ms(
                        torch, lambda: fa.flash_attention(
                            q, k, v, causal=True,
                            soft_cap=cfg.logits_soft_cap,
                            window=cfg.window))
                    times["attention_layer"] = time_ms(
                        torch, lambda: L.attention_apply(p, h, cfg, **kw))
                    del q, k, v
                del af, ar
            elif "scan" not in times:
                p = pi["rec"]
                xb = h @ p["w_x"]
                times["conv"] = time_ms(
                    torch, lambda: ops.depthwise_conv1d(xb, p["conv_w"]))
                xc = ops.depthwise_conv1d(xb, p["conv_w"]) + p["conv_b"]
                r = torch.sigmoid(xc @ p["w_a"] + p["b_a"])
                ig = torch.sigmoid(xc @ p["w_i"] + p["b_i"])
                times["scan"] = time_ms(
                    torch, lambda: R._rg_lru(xc, r, ig, p["lam"]), reps=3)
                times["rec_layer"] = time_ms(
                    torch, lambda: R.rec_mixer_apply(p, h, cfg), reps=3)
                del xb, xc, r, ig
            del h
            xf = R.block_apply(pi, xf, cfg, positions=pos)
            xr = R.block_apply(pi, xr, cref, positions=pos)
            drift.append(((xf - xr).abs().max() / xr.abs().max()).item())
    torch.cuda.empty_cache()
    return worst, drift, times


def rgemma_prefill(torch):
    """Full-width recurrentgemma-2b prefill (the hybrid main path) and its
    checks.  Returns what the later phases and the kernel line need."""
    from repro_torch.configs import registry
    from repro_torch.distributed import steps
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import trim_conv1d as tc1
    from repro_torch.models import api
    from repro_torch.models.base import init_params

    cfg = registry.get("recurrentgemma-2b").CONFIG
    assert cfg.attn_impl == "flash"
    n_params = registry.count_params(cfg)
    if n_params != 2_894_574_080:
        raise AssertionError(f"recurrentgemma-2b: {n_params:,} parameters")
    n_att = sum(cfg.pattern_at(i) == "att" for i in range(cfg.n_layers))
    n_rec = cfg.n_layers - n_att
    t0 = time.perf_counter()
    params = init_params(api.params(cfg), torch.Generator(device="cuda")
                         .manual_seed(0), device="cuda")
    torch.cuda.synchronize()
    print(f"recurrentgemma: {cfg.name} full width ({cfg.n_layers} layers, "
          f"{n_rec} rec + {n_att} att, d_model {cfg.d_model}, window "
          f"{cfg.window}, soft cap {cfg.logits_soft_cap}), {n_params:,} "
          f"parameters drawn on the card in {time.perf_counter() - t0:.2f} "
          f"s; device memory {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    rng = np.random.default_rng(8)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab, (RGEMMA_BATCH, RGEMMA_SEQ))).cuda()
    batch = {"tokens": tokens}
    prefill = steps.make_prefill_step(cfg)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tc1.reset_launch_counts()
    fa.reset_launch_counts()
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        logits, nxt = prefill(params, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = {"trim_conv1d": tc1.LAUNCHES["trim_conv1d"],
                "flash_attention": fa.LAUNCHES["flash_attention"]}
    peak = torch.cuda.max_memory_allocated() / 2**30
    if launches != {"trim_conv1d": 2 * n_rec, "flash_attention": 2 * n_att}:
        raise AssertionError(f"recurrentgemma prefill: launches {launches} "
                             f"in 2 forwards, want {n_rec} trim_conv1d and "
                             f"{n_att} flash_attention each")
    if tuple(logits.shape) != (RGEMMA_BATCH, RGEMMA_SEQ, cfg.vocab) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"recurrentgemma prefill: logits "
                             f"{tuple(logits.shape)} not finite or of the "
                             "wrong shape")
    fwd = times[1]
    std = logits.std().item()
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    ref_logits, ref_nxt = steps.make_prefill_step(
        cfg.replace(attn_impl="ref"))(params, batch)
    torch.cuda.synchronize()
    ref_ms = (time.perf_counter() - t0) * 1e3
    if fa.LAUNCHES["flash_attention"] != 0:
        raise AssertionError("recurrentgemma prefill: the ref forward "
                             "launched the flash kernel")
    full_drift = ((logits - ref_logits).abs().max()
                  / ref_logits.abs().max()).item()
    del logits, ref_logits
    torch.cuda.empty_cache()
    print(f"recurrentgemma prefill: {RGEMMA_BATCH} x {RGEMMA_SEQ} tokens, "
          f"{fwd:.1f} ms per forward (first {times[0]:.1f} ms), {n_rec} "
          f"trim_conv1d and {n_att} flash_attention launches each; ref "
          f"{ref_ms:.1f} ms; peak device memory {peak:.2f} GiB (flash "
          f"forwards); logits std {std:.4f}; whole-depth logits flash vs "
          f"ref max|diff| / max|ref| {full_drift:.2e}, next tokens "
          f"{nxt.tolist()} vs {ref_nxt.tolist()} (printed)")

    worst, drift, t = rgemma_layer_check(torch, cfg, params, tokens)
    at = [i for i in (1, 2, 3, 6, 12, 18, 26) if i <= len(drift)]
    shares = {"scan": n_rec * t["scan"] / fwd, "conv": n_rec * t["conv"] / fwd,
              "rec_layer": n_rec * t["rec_layer"] / fwd,
              "attention": n_att * t["attention"] / fwd,
              "attention_layer": n_att * t["attention_layer"] / fwd}
    print(f"recurrentgemma layer check: every att layer's attention, kernel "
          f"vs ref on the flash forward's activations, within {worst:.2e} "
          f"of max|ref| (tol {LM_LAYER_TOLERANCE:g}); free-running flash vs "
          f"ref residual stream, max|diff| / max|ref| after layers "
          f"{', '.join(map(str, at))}: "
          + ", ".join(f"{drift[i - 1]:.1e}" for i in at))
    print(f"recurrentgemma prefill, where the time goes (one layer's part on "
          f"its real input, x {n_rec} rec / x {n_att} att, of the "
          f"{fwd:.1f} ms forward): RG-LRU scan (plain) {t['scan']:.3f} ms "
          f"({shares['scan']:.1%}); temporal conv (trim_conv1d) "
          f"{t['conv']:.4f} ms ({shares['conv']:.2%}); the whole rec mixer "
          f"{t['rec_layer']:.3f} ms ({shares['rec_layer']:.1%}); attention "
          f"kernel {t['attention']:.3f} ms ({shares['attention']:.1%}); the "
          f"whole attention sublayer {t['attention_layer']:.3f} ms "
          f"({shares['attention_layer']:.1%})")

    c3, p3 = cfg.replace(n_layers=3), hybrid_cut(params, 3)
    l3, n3 = steps.make_prefill_step(c3)(p3, batch)
    r3, m3 = steps.make_prefill_step(c3.replace(attn_impl="ref"))(p3, batch)
    scale = r3.abs().max().item()
    err3 = (l3 - r3).abs().max().item() / scale
    if not np.isfinite(err3) or err3 > LM_TOLERANCE or not same_tokens(
            n3, m3, r3[:, -1], LM_TOLERANCE * scale):
        raise AssertionError(f"recurrentgemma prefill, depth-3 cut: flash vs "
                             f"ref {err3:.3e} of max|logits| (tol "
                             f"{LM_TOLERANCE}), tokens {n3.tolist()} vs "
                             f"{m3.tolist()}")
    print(f"recurrentgemma prefill, depth-3 cut (rec, rec, att) of the same "
          f"weights and tokens: flash vs ref logits within {err3:.2e} of "
          f"max|logits| (tol {LM_TOLERANCE:g}), next tokens {n3.tolist()} == "
          f"{m3.tolist()}")
    del l3, r3
    torch.cuda.empty_cache()
    return dict(cfg=cfg, params=params, launches=launches, ms=fwd,
                ref_ms=ref_ms, peak=peak, times=t, shares=shares,
                layer_err=worst, drift=drift, full_drift=full_drift,
                err3=err3)


def rgemma_wrap(torch, rg):
    """Prefill against token-by-token decode across the ring's wrap, at
    the published widths and window: the depth-3 cut, batch 1, a prompt
    of window + ``RGEMMA_WRAP_EXTRA`` tokens, the logits at every
    position (checked, ``RGEMMA_TOLERANCE``)."""
    from repro_torch.distributed import steps
    cfg = rg["cfg"].replace(n_layers=3)
    params = hybrid_cut(rg["params"], 3)
    n = cfg.window + RGEMMA_WRAP_EXTRA
    toks = torch.from_numpy(np.random.default_rng(9).integers(
        0, cfg.vocab, (1, n))).cuda()
    full, _ = steps.make_prefill_step(cfg)(params, {"tokens": toks})
    t0 = time.perf_counter()
    dec = decode_logits(torch, cfg, params, toks)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / n
    scale = full.abs().max().item()
    per_pos = ((dec - full).abs().amax(dim=(0, 2)) / scale).cpu().numpy()
    err = float(per_pos.max())
    if not np.isfinite(err) or err > RGEMMA_TOLERANCE:
        raise AssertionError(f"recurrentgemma decode vs prefill across the "
                             f"ring wrap: {err:.3e} of max|logits| at "
                             f"position {int(per_pos.argmax())} (tol "
                             f"{RGEMMA_TOLERANCE})")
    print(f"recurrentgemma decode vs prefill across the ring wrap: depth-3 "
          f"cut, batch 1, {n}-token prompt ({cfg.window}-slot ring, "
          f"wrapped at position {cfg.window}), every position within "
          f"{err:.2e} of max|logits| (tol {RGEMMA_TOLERANCE:g}; before the "
          f"wrap {per_pos[:cfg.window].max():.2e}, after "
          f"{per_pos[cfg.window:].max():.2e}); {step_ms:.2f} ms a decode "
          f"step")
    del full, dec
    torch.cuda.empty_cache()
    return dict(err=err, before=float(per_pos[:cfg.window].max()),
                after=float(per_pos[cfg.window:].max()), step_ms=step_ms)


# ---------------------------------------------------------------------------
# The autotune phase
# ---------------------------------------------------------------------------

TUNE_TURNS = 3              # alternating graph timings of default / tuned


def flash_bwd_cases():
    """(name, b, lq, lk, hq, hkv, d, causal, soft_cap, window): (t) the
    LM training shape; (c) recurrentgemma-2b's attention; a GQA group of
    7 at D 64; queries right-aligned to more keys; seamless-m4t-large-v2's
    training calls (MHA, D 64, G = 1: no partial sum), its decoder's
    causal and its encoder's non-causal self-attention, and a cross call
    with more queries than keys."""
    return [("t_train", 2, 1024, 1024, 16, 2, 128, True, None, None),
            ("c_rgemma", 1, 4096, 4096, 10, 1, 256, True, 30.0, 2048),
            ("g7_d64", 2, 1024, 1024, 14, 2, 64, True, None, None),
            ("lq_lt_lk", 2, 256, 1024, 16, 2, 128, True, None, None),
            ("s_train", 2, 1024, 1024, 16, 16, 64, True, None, None),
            ("s_train_nc", 2, 1024, 1024, 16, 16, 64, False, None, None),
            ("s_cross_bwd", 2, 1024, 512, 16, 16, 64, False, None, None)]


def flash_bwd_bounds(b, lq, lk, hq, hkv, d, causal, window) -> dict:
    """{part: {route: (ms, bound_by), "flops": FLOPs}}: the FLOPs a part's
    function needs per valid (query, key) pair (the whole backward 10 D,
    2.5 x the forward's 4 D: S, dP, dV, dK, dQ; the dK/dV kernel 8 D: S,
    dP, dV, dK; the dQ kernel, the rows' statistics and dQ, 6 D: S, dP,
    dQ) at the rate of each f32-accurate route, against its bytes (each
    input read once, each output written once) over 3.35 TB/s.  Routes:
    ``tf32x3``, 3xTF32 on the tensor cores (three TF32 products a
    product, 3 x FLOPs over 495 TFLOP/s; the kernels' route), the least
    time the card could take; ``ffma``, f32 FFMA at 67 TFLOP/s.  ``sum``,
    the G heads' partials added: (G - 1) adds an element of dK and dV at
    half the FFMA FLOP rate, against 2 G reads and 2 writes an element."""
    q_pos = np.arange(lq) + lk - lq
    hi = np.minimum(q_pos + 1, lk) if causal else np.full(lq, lk)
    lo = np.maximum(q_pos - window + 1, 0) if window else np.zeros(lq)
    pairs = int(np.maximum(hi - lo, 0).sum()) * b * hq
    rows, keys, stats = b * lq * hq * d, b * lk * hkv * d, b * hq * lq
    # words: backward q, dO, dQ, k, v, dK, dV, lse; dkdv q, dO, k, v, dK,
    # dV, the two stats; dq q, dO, dQ, k, v, lse, the two stats
    parts = {"backward": (10, 3 * rows + 4 * keys + stats),
             "dkdv": (8, 2 * rows + 4 * keys + 2 * stats),
             "dq": (6, 3 * rows + 2 * keys + 3 * stats)}
    out = {}
    for part, (per_pair, words) in parts.items():
        flops = per_pair * d * pairs
        bytes_ms = 4 * words / PEAK_BYTES_PER_S * 1e3
        out[part] = {
            route: (max(ops_ms, bytes_ms),
                    "operations" if ops_ms >= bytes_ms else "bytes")
            for route, ops_ms in (
                ("ffma", flops / PEAK_F32_FLOPS * 1e3),
                ("tf32x3", 3 * flops / PEAK_TF32_FLOPS * 1e3))}
        out[part]["flops"] = flops
    g = hq // hkv
    adds_ms = 2 * (g - 1) * keys / (PEAK_F32_FLOPS / 2) * 1e3
    bytes_ms = 4 * (2 * g + 2) * keys / PEAK_BYTES_PER_S * 1e3
    out["sum"] = (max(adds_ms, bytes_ms),
                  "operations" if adds_ms >= bytes_ms else "bytes")
    return out


def check_flash_backward(torch):
    """The backward kernels against their plain version, two calls
    bitwise equal, the forward's o bitwise the same with and without lse
    and its lse against the plain forward's, the partials' sum kernel
    bitwise against its plain version; times beside the plain version's,
    the 3xTF32 and FFMA bounds, each kernel's TFLOP/s (of its function's
    FLOPs) and blocks and, where one PyTorch call computes the same
    function, SDPA's forward + backward and backward (f32, TF32 off) and
    ``torch.sum`` over the partials."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(11)
    rows = []
    print("flash backward check (ms, device events; errors of each "
          "gradient's max|plain|; bounds 3xTF32, the kernels' route (3 x "
          "FLOPs / 495 TFLOP/s), of 10 D FLOPs a valid pair for the whole "
          "backward, 8 D dK/dV, 6 D dQ; bndF: the whole backward's FFMA "
          "bound; TFLOP/s of those FLOPs; blocks dQ / dK/dV / sum):")
    print(f"  {'case':9s} {'dq_err':>8s} {'dk_err':>8s} {'dv_err':>8s} "
          f"{'bwd':>7s} {'dkdv':>7s} {'dq':>7s} {'sum':>6s} {'fwd':>6s} "
          f"{'plain':>8s} {'sdpa_fb':>7s} {'sdpa_b':>7s} {'bound':>6s} "
          f"{'dkdv_b':>6s} {'dq_b':>6s} {'bndF':>6s} {'TF/s':>5s} "
          f"{'dkdv':>5s} {'dq':>5s}  blocks")
    for name, b, lq, lk, hq, hkv, d, causal, cap, win in flash_bwd_cases():
        q, do = (torch.randn((b, lq, hq, d), generator=gen, device="cuda")
                 for _ in range(2))
        k, v = (torch.randn((b, lk, hkv, d), generator=gen, device="cuda")
                for _ in range(2))
        kw = dict(causal=causal, soft_cap=cap, window=win)
        plan = fa.bwd_plan(b, lq, lk, hq, hkv, d)
        lse = torch.empty((b, hq, lq), device="cuda")
        o = fa._launch_forward(q, k, v, causal, cap, win, lse)
        same_o = torch.equal(o, fa.flash_attention(q, k, v, **kw))
        _, plain_lse = fa._plain_forward(q, k, v, block_k=fa.BLOCK_K, **kw)
        got = fa.flash_attention_backward(q, k, v, lse, do, **kw)
        again = fa.flash_attention_backward(q, k, v, lse, do, **kw)
        plain = fa.flash_attention_backward_plain(q, k, v, lse, do, **kw)
        torch.cuda.synchronize()
        repeat = all(torch.equal(x, y) for x, y in zip(got, again))
        errs = [((g - p).abs().max() / p.abs().max()).item()
                for g, p in zip(got, plain)]
        abs_err = max((g - p).abs().max().item() for g, p in zip(got, plain))
        lse_err = ((lse - plain_lse).abs().max()
                   / plain_lse.abs().max()).item()
        stats = torch.empty((2, b, hq, lq), device="cuda")
        dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
        part = torch.empty((2, plan.group, *k.shape), device="cuda")
        outs = (dk, dv) if plan.group == 1 else (part[0], part[1])
        fa._launch_backward("dq", q, k, v, do, lse, stats, (dq,), **kw)
        fa._launch_backward("dkdv", q, k, v, do, lse, stats, outs, **kw)
        sum_ok, sum_err = True, None
        if plan.group > 1:
            fa._launch_sum(part, dk, dv, plan)
            want = fa.sum_partials_plain(part)
            sum_ok = all(torch.equal(x, y) for x, y in zip((dk, dv), want))
            sum_err = max((x - y).abs().max().item()
                          for x, y in zip((dk, dv), want))
        torch.cuda.synchronize()
        if not (same_o and repeat and sum_ok and np.isfinite(errs).all()
                and max(errs) <= BWD_TOLERANCE
                and lse_err <= ATTN_TOLERANCE):
            raise AssertionError(
                f"flash backward {name}: o with lse == without {same_o}, "
                f"two calls bitwise {repeat}, sum kernel == plain sum "
                f"{sum_ok}, dq/dk/dv of max|plain| {errs} (tol "
                f"{BWD_TOLERANCE}), lse {lse_err:.2e}")
        t = {"backward": time_ms(torch, lambda: fa.flash_attention_backward(
                q, k, v, lse, do, **kw)),
             "dq": time_ms(torch, lambda: fa._launch_backward(
                 "dq", q, k, v, do, lse, stats, (dq,), **kw)),
             "dkdv": time_ms(torch, lambda: fa._launch_backward(
                 "dkdv", q, k, v, do, lse, stats, outs, **kw)),
             "forward": time_ms(torch, lambda: fa.flash_attention(
                 q, k, v, **kw)),
             "plain": time_ms(torch, lambda: fa.flash_attention_backward_plain(
                 q, k, v, lse, do, **kw), reps=2),
             "sum": None, "sum_plain": None, "sum_library": None,
             "sdpa_fwd_bwd": None, "sdpa_bwd": None}
        if plan.group > 1:
            t["sum"] = time_ms(torch, lambda: fa._launch_sum(part, dk, dv,
                                                             plan))
            t["sum_plain"] = time_ms(torch, lambda: fa.sum_partials_plain(
                part))
            t["sum_library"] = time_ms(torch, lambda: torch.sum(part, 1))
        if cap is None and win is None and lq == lk:
            # one PyTorch call computes it (no cap, no window; causal
            # top-left is the kernels' right-aligned mask at Lq == Lk)
            qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                          for x in (q, k, v))
            dot = do.transpose(1, 2)
            sdpa = F.scaled_dot_product_attention

            def fwd_bwd():
                out = sdpa(qt, kt, vt, is_causal=causal, enable_gqa=True)
                return torch.autograd.grad(out, (qt, kt, vt), dot)
            t["sdpa_fwd_bwd"] = time_ms(torch, fwd_bwd)
            out = sdpa(qt, kt, vt, is_causal=causal, enable_gqa=True)
            t["sdpa_bwd"] = time_ms(torch, lambda: torch.autograd.grad(
                out, (qt, kt, vt), dot, retain_graph=True))
            del out, qt, kt, vt
        bounds = flash_bwd_bounds(b, lq, lk, hq, hkv, d, causal, win)
        tflops = {p: bounds[p]["flops"] / t[p] / 1e9
                  for p in ("backward", "dkdv", "dq")}
        rows.append(dict(name=name, errs=errs, abs_err=abs_err,
                         lse_err=lse_err, sum_err=sum_err, bounds=bounds,
                         plan=plan, tflops=tflops, **t))
        fmt = (lambda x, w=7: "-".rjust(w) if x is None else f"{x:{w}.3f}")
        print(f"  {name:9s} {errs[0]:8.1e} {errs[1]:8.1e} {errs[2]:8.1e} "
              f"{t['backward']:7.3f} {t['dkdv']:7.3f} {t['dq']:7.3f} "
              f"{fmt(t['sum'], 6)} {t['forward']:6.3f} {t['plain']:8.3f} "
              f"{fmt(t['sdpa_fwd_bwd'])} {fmt(t['sdpa_bwd'])} "
              f"{bounds['backward']['tf32x3'][0]:6.3f} "
              f"{bounds['dkdv']['tf32x3'][0]:6.3f} "
              f"{bounds['dq']['tf32x3'][0]:6.3f} "
              f"{bounds['backward']['ffma'][0]:6.3f} "
              f"{tflops['backward']:5.1f} {tflops['dkdv']:5.1f} "
              f"{tflops['dq']:5.1f}  {plan.dq_blocks} / {plan.dkdv_blocks}"
              f" / {plan.sum_blocks}")
        del q, k, v, o, do, lse, got, again, plain, stats, dq, dk, dv, part
    print("  o bitwise equal with and without lse, two backward calls "
          "bitwise equal, the sum kernel bitwise equal to its plain version, "
          "the kernel's lse within "
          f"{max(r['lse_err'] for r in rows):.1e} of the plain forward's in "
          "every case; the partials' sum kernel: "
          + ", ".join(f"{r['name']} {r['sum']:.4f} ms (plain "
                      f"{r['sum_plain']:.4f}, torch.sum "
                      f"{r['sum_library']:.4f}, bound "
                      f"{r['bounds']['sum'][0]:.4f})"
                      for r in rows if r["sum"] is not None))
    torch.cuda.empty_cache()
    return rows


def plain_backward_f64(q, k, v, lse, do, **kw):
    """The plain backward in float64 from the same f32 inputs and lse,
    its gradients rounded to f32: the oracle of check (i)."""
    from repro_torch.kernels import flash_attention as fa
    return tuple(g.float() for g in fa.flash_attention_backward_plain(
        q.double(), k.double(), v.double(), lse.double(), do.double(), **kw))


def lm_grads(torch, cfg, params, batch, plain_bwd: bool) -> dict:
    """Per-leaf gradients of the loss on ``attn_impl`` flash (the
    kernels), ref and chunked (the flash schedule in plain PyTorch, its
    softmax differentiated by autograd), and with ``plain_bwd`` on flash
    with the plain backward swapped in for the backward kernels (the same
    forward), in float64 (``plain_bwd``) and in f32 (``plain_bwd32``):
    for each compared pair, (max over leaves of max|a - b| / max|b|, that
    leaf); and the flash gradient's float64 global norm and whether every
    element is finite."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import api
    from repro_torch.optim import adamw

    def grads_of(impl):
        live = [t.detach().requires_grad_()
                for t in adamw.tree_leaves(params)]
        logits, aux = api.forward(adamw.tree_unflatten(params, live), batch,
                                  cfg.replace(attn_impl=impl))
        return torch.autograd.grad(api.loss_fn(logits, batch["labels"], aux),
                                   live)

    grads = {impl: grads_of(impl) for impl in ("flash", "ref", "chunked")}
    pairs = [("flash", "ref"), ("chunked", "ref")]
    if plain_bwd:
        kernels = fa.flash_attention_backward
        try:
            for name, fn in (("plain_bwd", plain_backward_f64),
                             ("plain_bwd32",
                              fa.flash_attention_backward_plain)):
                fa.flash_attention_backward = fn
                grads[name] = grads_of("flash")
        finally:
            fa.flash_attention_backward = kernels
        pairs += [("flash", "plain_bwd"), ("plain_bwd32", "plain_bwd"),
                  ("flash", "plain_bwd32")]
    names = leaf_names(params)
    out = {}
    for a, b in pairs:
        errs = [((x - y).abs().max() / y.abs().max()).item()
                for x, y in zip(grads[a], grads[b])]
        worst = int(np.nanargmax(errs))
        out[f"{a}_{b}"] = (errs[worst] if np.isfinite(errs).all()
                           else float("nan"), names[worst])
    out["finite"] = all(bool(torch.isfinite(g).all())
                        for g in grads["flash"])
    out["norm64"] = float(sum(torch.sum(torch.square(g.double())).item()
                              for g in grads["flash"]) ** 0.5)
    del grads
    torch.cuda.empty_cache()
    return out


def lm_bwd_layer_check(torch, cfg, params, tokens):
    """Along the flash forward (batch row 0, the first BWD_F64_POSITIONS
    positions): each layer's attention backward at its own q, k, v and a
    seeded cotangent, on the kernels, on autograd of the f32 ``ref``
    oracle and on autograd of float64 attention; the kernels' error of
    max|float64 grad| at most max(F64_FACTOR x ref's, ATTN_TOLERANCE).
    Returns (worst kernel error, worst ref error, worst ratio)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.testing import float64
    toks = tokens[:1, :BWD_F64_POSITIONS]
    pos = torch.arange(toks.shape[1], device="cuda")[None]
    gen = torch.Generator(device="cuda").manual_seed(13)
    worst = {"kernel": 0.0, "ref": 0.0, "ratio": 0.0}
    with torch.no_grad():
        x = L.embed_apply(params["tok"], toks, cfg)
        for i in range(cfg.n_layers):
            pi = T.layer_slice(params["blocks"], i)
            h = L.norm_apply(pi["ln_att"], x, cfg)
            p = pi["att"]
            q, k, v = (torch.einsum("bld,dhk->blhk", h, p[w]) + p["b" + w[1]]
                       for w in ("wq", "wk", "wv"))
            q = L.rope(q, pos, cfg.rope_theta)
            k = L.rope(k, pos, cfg.rope_theta)
            do = torch.randn(q.shape, generator=gen, device="cuda")
            grads = {}
            with torch.enable_grad():
                for name, fn, dt in (
                        ("kernel", fa.flash_attention, torch.float32),
                        ("ref", lambda a, b, c: ref.attention(
                            a, b, c, causal=True), torch.float32),
                        ("f64", float64.attention, torch.float64)):
                    lv = [t.to(dt).requires_grad_() for t in (q, k, v)]
                    grads[name] = torch.autograd.grad(fn(*lv), lv,
                                                      do.to(dt))
            for g64, gk, gr in zip(grads["f64"], grads["kernel"],
                                   grads["ref"]):
                scale = g64.abs().max().item()
                ek = (gk.double() - g64).abs().max().item() / scale
                er = (gr.double() - g64).abs().max().item() / scale
                lim = max(F64_FACTOR * er, ATTN_TOLERANCE)
                if not ek <= lim:
                    raise AssertionError(
                        f"LM train layer {i}: the attention backward on the "
                        f"kernels is {ek:.3e} of max|f64 grad| from float64, "
                        f"ref {er:.3e}: above {lim:.3e}")
                worst["kernel"] = max(worst["kernel"], ek)
                worst["ref"] = max(worst["ref"], er)
                worst["ratio"] = max(worst["ratio"], ek / er)
            del grads, q, k, v, do, h
            x, _ = T.block_apply(pi, x, cfg, positions=pos)
    return worst


def leaf_names(tree, prefix="") -> list:
    """"a/b/c" paths of a nested dict's leaves in sorted-key order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in leaf_names(tree[k], f"{prefix}{k}/")]
    return [prefix[:-1]]


def lm_train(torch):
    """Full-width qwen2.5-3b trained through ``launch.train.main`` (remat,
    flash forward and backward kernels) for TRAIN_LM_STEPS steps; then the
    first-step gradients flash vs ref at the depth cut (checked) and at
    full depth (printed)."""
    from repro_torch.configs import registry
    from repro_torch.data import DataConfig, make_batch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import train
    from repro_torch.models import api
    from repro_torch.models.base import init_params

    cfg = registry.get("qwen2.5-3b").CONFIG
    assert cfg.attn_impl == "flash" and cfg.remat
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    out = train.main(["--arch", "qwen2.5-3b", "--steps", str(TRAIN_LM_STEPS),
                      "--batch", str(TRAIN_LM_BATCH), "--seq",
                      str(TRAIN_LM_SEQ), "--task", "copy", "--log-every",
                      "1", "--device", "cuda"])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = {"flash_attention": fa.LAUNCHES["flash_attention"],
                **route_counts(fa.BWD_LAUNCHES, bf16=False)}
    clip = train_clip_state(torch, out.pop("state"), out["grad_norms"],
                            "full width")
    torch.cuda.empty_cache()
    n, layers = TRAIN_LM_STEPS, cfg.n_layers
    want = {"flash_attention": 2 * layers * n,
            "flash_attention_bwd_dkdv": layers * n,
            "flash_attention_bwd_dq": layers * n,
            "flash_attention_bwd_sum": layers * n}
    losses = np.asarray(out["losses"])
    if launches != want or losses.shape != (n,) or \
            not np.isfinite(losses).all():
        raise AssertionError(f"LM train: launches {launches}, want {want}; "
                             f"losses {out['losses']}")
    steady = float(np.mean(out["step_ms"][1:]))
    print(f"LM train: {cfg.name} full width ({layers} layers, remat, flash "
          f"forward and backward kernels), batch {TRAIN_LM_BATCH} x "
          f"{TRAIN_LM_SEQ - 1} tokens, {n} AdamW steps: losses "
          f"{[round(x, 4) for x in out['losses']]}, ms a step "
          f"{[round(x, 1) for x in out['step_ms']]} (steady {steady:.1f}); "
          f"peak device memory {peak:.2f} GiB; a step launches "
          f"{launches['flash_attention'] // n} flash forwards ({layers} + "
          f"{layers} in the remat recompute), "
          f"{launches['flash_attention_bwd_dq'] // n} dQ, "
          f"{launches['flash_attention_bwd_dkdv'] // n} dK/dV and "
          f"{launches['flash_attention_bwd_sum'] // n} partial-sum kernels")

    params = init_params(api.params(cfg), torch.Generator(device="cuda")
                         .manual_seed(0), device="cuda")
    nb = make_batch(DataConfig(batch=1, seq=GRAD_LM_TOKENS + 1,
                               vocab=cfg.vocab, task="copy"), 0)
    batch = {k: torch.from_numpy(v).cuda() for k, v in nb.items()}
    cut = lm_grads(torch, cfg.replace(n_layers=GRAD_LM_LAYERS),
                   depth_cut(params, GRAD_LM_LAYERS), batch, plain_bwd=True)
    cut_err, cut_leaf = cut["flash_ref"]
    bwd_err, bwd_leaf = cut["flash_plain_bwd"]
    plain32_err = cut["plain_bwd32_plain_bwd"][0]
    if not (bwd_err <= BWD_TOLERANCE and bwd_err <= plain32_err
            and cut_err <= LM_GRAD_TOLERANCE):
        raise AssertionError(
            f"LM train: depth-{GRAD_LM_LAYERS} gradients, backward kernels "
            f"vs the float64 plain backward {bwd_err:.3e} at {bwd_leaf} (tol "
            f"{BWD_TOLERANCE}, and at most the f32 plain backward's "
            f"{plain32_err:.3e}), "
            f"flash vs ref {cut_err:.3e} at {cut_leaf} (tol "
            f"{LM_GRAD_TOLERANCE})")
    full = lm_grads(torch, cfg, params, batch, plain_bwd=False)
    if not full["finite"]:
        raise AssertionError("LM train: a full-depth gradient element on "
                             "the kernels is not finite")
    print(f"LM train: first-step gradients, 1 x {GRAD_LM_TOKENS} tokens, "
          f"of each leaf's max|ref| (largest leaf named): depth-"
          f"{GRAD_LM_LAYERS} cut, the backward kernels vs the float64 plain "
          f"backward on the same forward {bwd_err:.2e} ({bwd_leaf}; tol "
          f"{BWD_TOLERANCE:g}, and at most the f32 plain backward vs it: "
          f"{cut['plain_bwd32_plain_bwd'][0]:.2e} "
          f"({cut['plain_bwd32_plain_bwd'][1]}), the kernels vs the f32 "
          f"plain {cut['flash_plain_bwd32'][0]:.2e}), flash vs ref "
          f"{cut_err:.2e} ({cut_leaf}; "
          f"tol {LM_GRAD_TOLERANCE:g}), chunked vs ref "
          f"{cut['chunked_ref'][0]:.2e}; full depth flash vs ref "
          f"{full['flash_ref'][0]:.2e} ({full['flash_ref'][1]}), chunked "
          f"vs ref {full['chunked_ref'][0]:.2e} (printed: the 36-layer "
          f"function is chaotic under this init); the flash gradient is "
          f"finite, its float64 global norm {full['norm64']:.3e} (f32 "
          f"overflows above 3.4e38: the steps' gnorm "
          f"{out['grad_norms']})")
    f64 = lm_bwd_layer_check(torch, cfg, params, batch["tokens"])
    del params, batch
    torch.cuda.empty_cache()
    cut_steps = lm_train_cut(torch, cfg.replace(n_layers=GRAD_LM_LAYERS))
    print(f"LM train: every layer's attention backward (1 x "
          f"{BWD_F64_POSITIONS} positions of the flash forward, a seeded "
          f"cotangent) against float64: the kernels' worst error "
          f"{f64['kernel']:.2e} of max|f64 grad|, the f32 ref oracle's "
          f"{f64['ref']:.2e}, worst ratio {f64['ratio']:.1f} (limit "
          f"max({F64_FACTOR:g} x ref's, {ATTN_TOLERANCE:g}))")
    torch.cuda.empty_cache()
    return dict(out, peak=peak, launches=launches, steady_ms=steady,
                cut_err=cut_err, bwd_err=bwd_err,
                full_err=full["flash_ref"][0], bwd_f64=f64, clip=clip,
                cut_steps=cut_steps)


def train_clip_state(torch, state, grad_norms, label) -> dict:
    """What the steps' gradient clipping let through: every leaf of
    params, mu and nu must be finite, and mu and nu must be exactly 0 if
    and only if every step's clip scale ``min(1, clip / (gnorm + 1e-9))``
    was 0 (an inf grad norm: AdamW then applies weight decay only, and a
    NaN from inf x 0 would show here).  Prints the state; returns the
    scales and the count of leaves whose mu is not all 0."""
    from repro_torch.optim import AdamWConfig, adamw

    clip = AdamWConfig().grad_clip
    scales = [min(1.0, clip / (g + 1e-9)) for g in grad_norms]
    leaves = {name: adamw.tree_leaves(tree) for name, tree in (
        ("params", state["params"]), ("mu", state["opt"]["mu"]),
        ("nu", state["opt"]["nu"]))}
    finite = all(bool(torch.isfinite(t).all())
                 for ts in leaves.values() for t in ts)
    moved = {name: sum(bool(t.any()) for t in leaves[name])
             for name in ("mu", "nu")}
    n = len(leaves["mu"])
    reached = any(x > 0 for x in scales)
    if not finite or (moved["mu"] > 0) != reached or \
            (moved["nu"] > 0) != reached:
        raise AssertionError(
            f"LM train ({label}): params, mu and nu finite {finite}; clip "
            f"scales {scales} (grad norms {grad_norms}); leaves with mu / "
            f"nu not all 0: {moved['mu']} / {moved['nu']} of {n}")
    if reached:
        print(f"LM train ({label}): grad norms {grad_norms}, clip scales "
              f"{scales}: the gradient reaches params, mu and nu (mu not "
              f"all 0 in {moved['mu']} of {n} leaves); every leaf finite")
    else:
        print(f"LM train ({label}): GRAD NORM INF on every step "
              f"{grad_norms}: clip scale 0, so no gradient reaches params, "
              f"mu or nu, and the steps apply weight decay only (mu and nu "
              f"exactly 0 in all {n} leaves, every leaf finite); the "
              f"reference's f32 norm overflows the same way (ROADMAP "
              f"Queue 3)")
    return dict(scales=scales, mu_leaves_moved=moved["mu"], leaves=n)


def lm_train_cut(torch, cfg, batch: int = TRAIN_LM_BATCH,
                 seq: int = TRAIN_LM_SEQ, n: int = TRAIN_LM_STEPS) -> dict:
    """``n`` train steps of the full-width depth cut ``cfg`` (its own
    seeded init, the trainer's optimiser settings, ``batch`` x ``seq``)
    through ``steps.make_train_step``: at this depth the grad norm is
    finite, so the update at full width runs with a gradient that reaches
    params, mu and nu (``train_clip_state`` must find it so)."""
    from repro_torch.data import DataConfig, SyntheticStream
    from repro_torch.distributed import steps
    from repro_torch.optim import AdamWConfig

    opt = AdamWConfig(lr=3e-3, warmup_steps=10, decay_steps=n)
    state = steps.init_train_state(
        cfg, opt, torch.Generator(device="cuda").manual_seed(0))
    stream = SyntheticStream(DataConfig(batch=batch, seq=seq,
                                        vocab=cfg.vocab, task="copy"))
    step_fn = steps.make_train_step(cfg, opt)
    losses, norms = [], []
    for _ in range(n):
        state, metrics = step_fn(state, {k: torch.from_numpy(v).cuda()
                                         for k, v in next(stream).items()})
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    clip = train_clip_state(torch, state, norms,
                            f"depth-{cfg.n_layers} full-width cut")
    del state
    torch.cuda.empty_cache()
    if not (np.isfinite(losses).all() and min(clip["scales"]) > 0):
        raise AssertionError(f"LM train (depth-{cfg.n_layers} cut): losses "
                             f"{losses}, grad norms {norms}: the gradient "
                             f"must reach the params at this depth")
    print(f"LM train ({cfg.name} depth-{cfg.n_layers} full-width cut, "
          f"batch {batch} x {seq - 1}): losses "
          f"{[round(x, 4) for x in losses]}")
    return dict(losses=losses, grad_norms=norms, **clip)


def lm_resume(torch):
    """Resume at SMOKE widths on the kernels (flash, remat): 2 steps, a
    checkpoint, a restore into a fresh state and 2 more steps against 4
    uninterrupted steps, bitwise (the contract of
    ``tests/test_checkpoint.py::test_crash_resume_training_is_exact``)."""
    import shutil
    import tempfile
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import registry
    from repro_torch.data import DataConfig, SyntheticStream
    from repro_torch.distributed import steps
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.optim import AdamWConfig, adamw

    cfg = registry.get("qwen2.5-3b").SMOKE.replace(attn_impl="flash",
                                                   remat=True)
    opt = AdamWConfig(lr=3e-3, warmup_steps=10, decay_steps=4)
    dc = DataConfig(batch=8, seq=65, vocab=cfg.vocab, task="copy", seed=5)
    step_fn = steps.make_train_step(cfg, opt)

    def fresh(seed):
        return steps.init_train_state(
            cfg, opt, torch.Generator(device="cuda").manual_seed(seed))

    def run(state, stream, n):
        for _ in range(n):
            state, _ = step_fn(state, {k: torch.from_numpy(v).cuda()
                                       for k, v in next(stream).items()})
        return state

    fa.reset_launch_counts()
    full = run(fresh(0), SyntheticStream(dc), 4)
    directory = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        mgr = CheckpointManager(directory)
        stream = SyntheticStream(dc)
        mgr.save(2, run(fresh(0), stream, 2),
                 meta={"data_state": stream.state()})
        resumed, manifest = mgr.restore(fresh(1))
        resumed = run(resumed, SyntheticStream.from_state(
            dc, manifest["data_state"]), 2)
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    torch.cuda.synchronize()
    pairs = list(zip(adamw.tree_leaves(full), adamw.tree_leaves(resumed)))
    diff = max((x.double() - y.double()).abs().max().item()
               for x, y in pairs)
    launched = fa.LAUNCHES["flash_attention"] > 0 and \
        min(route_counts(fa.BWD_LAUNCHES, bf16=False).values()) > 0
    if not launched or not all(torch.equal(x, y) for x, y in pairs):
        raise AssertionError(f"LM resume: resumed state vs 4 straight "
                             f"steps max|diff| {diff} (launches "
                             f"{fa.LAUNCHES} {fa.BWD_LAUNCHES})")
    print(f"LM resume: {cfg.name} SMOKE widths on the kernels (flash, "
          f"remat), 2 steps + checkpoint + restore into a fresh state + 2 "
          f"steps bitwise equal to 4 straight steps ({len(pairs)} leaves, "
          f"max|diff| {diff})")
    return diff


def conv1d_bwd_cases():
    """(name, b, length, d, k, tile_l, strided): recurrentgemma-2b's
    training row (the rec mixer's (B, L, lru_width)), falcon-mamba-7b's
    training batch as the mixer's strided half of the in-projection, K 9
    (the runtime-K instances), an L that no run length divides, L < K."""
    return [("rg_train", 1, 4096, 2560, 4, None, False),
            ("mamba_view", 2, 1024, 8192, 4, None, True),
            ("k9", 2, 1024, 2048, 9, None, False),
            ("ragged", 2, 1001, 264, 4, None, True),
            ("l_below_k", 2, 2, 64, 4, None, False)]


def check_conv1d_backward(torch):
    """The conv1d backward kernels (dx: the forward kernel on the
    reversed cotangent; dw: the weight-gradient kernel) against their
    plain versions bit for bit, over two calls bit for bit, and against
    float64 autograd of ``ref.depthwise_conv1d`` (``CONV1D_BWD_TOLERANCE``);
    at the training shapes each one's time beside the forward kernel's,
    the plain version's, ``torch.nn.grad.conv1d_input`` /
    ``conv1d_weight``'s (TF32 off) and the bound: the forward, dx and
    conv1d_input from CUDA graphs over input copies past the L2 (dx with
    its host us a call and its plan's geometry), dw and conv1d_weight
    from device events (``check_conv1d_wgrad`` times dw from graphs)."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels import trim_conv1d as tc1

    gen = torch.Generator(device="cuda").manual_seed(27)
    rows = []
    print("conv1d backward check (bitwise vs plain; of max|grad| vs "
          "float64 autograd; times in ms: fwd, dx and dx lib from CUDA "
          "graphs over input copies past the L2, the rest device events):")
    print(f"  {'case':11s} {'shape':>22s} {'dx f64':>8s} {'dw f64':>8s} "
          f"{'fwd':>8s} {'dx':>8s} {'dx pl':>8s} {'dx lib':>8s} "
          f"{'dx bnd':>8s} {'dw':>8s} {'dw pl':>8s} {'dw lib':>8s} "
          f"{'dw bnd':>8s} T_l groups")
    for name, b, length, d, k, tile_l, strided in conv1d_bwd_cases():
        xz = torch.randn((b, length, 2 * d if strided else d),
                         generator=gen, device="cuda")
        x = xz[..., :d]
        w = 0.5 * torch.randn((k, d), generator=gen, device="cuda")
        dy = torch.randn((b, length, d), generator=gen, device="cuda")
        dx = tc1.trim_conv1d_input_grad(dy, w, tile_l=tile_l)
        dw = tc1.trim_conv1d_weight_grad(x, dy, k, tile_l=tile_l)
        dx2 = tc1.trim_conv1d_input_grad(dy, w, tile_l=tile_l)
        dw2 = tc1.trim_conv1d_weight_grad(x, dy, k, tile_l=tile_l)
        pdx = tc1.trim_conv1d_input_grad_plain(dy, w, tile_l=tile_l)
        pdw = tc1.trim_conv1d_wgrad_plain(x, dy, k, tile_l=tile_l)
        torch.cuda.synchronize()
        if not (torch.equal(dx, pdx) and torch.equal(dw, pdw)
                and torch.equal(dx, dx2) and torch.equal(dw, dw2)):
            raise AssertionError(
                f"conv1d backward {name}: dx vs plain "
                f"{(dx - pdx).abs().max().item()}, dw vs plain "
                f"{(dw - pdw).abs().max().item()}, repeats equal "
                f"{torch.equal(dx, dx2)} / {torch.equal(dw, dw2)}")
        x64 = x.double().requires_grad_()
        w64 = w.double().requires_grad_()
        want = torch.autograd.grad(ref.depthwise_conv1d(x64, w64),
                                   (x64, w64), dy.double())
        errs = [((g.double() - t).abs().max() / t.abs().max()).item()
                for g, t in zip((dx, dw), want)]
        del x64, w64, want
        if not max(errs) <= CONV1D_BWD_TOLERANCE:
            raise AssertionError(f"conv1d backward {name}: dx / dw vs "
                                 f"float64 autograd {errs} > "
                                 f"{CONV1D_BWD_TOLERANCE}")
        plan = tc1.plan_for(dy, w, tile_l)
        wplan = tc1._wgrad_plan(x, dy, k, tile_l)
        row = dict(name=name, shape=(b, length, d, k), dx_err=errs[0],
                   dw_err=errs[1], tile_l=wplan.tile_l,
                   groups=wplan.groups, dx_bound=plan.bound(),
                   dw_bound=wplan.bound(),
                   dw_hbm=wplan.hbm_bytes()["total"])
        line = (f"  {name:11s} {str((b, length, d, k)):>22s} "
                f"{errs[0]:8.1e} {errs[1]:8.1e}")
        if name in ("rg_train", "mamba_view"):       # the training shapes
            xt = x.transpose(1, 2).contiguous()      # (B, D, L) for cuDNN
            wt = w.t()[:, None, :].contiguous()      # (D, 1, K)
            gt = F.pad(dy.transpose(1, 2), (0, k - 1)).contiguous()
            lib_dx = torch.nn.grad.conv1d_input(xt.shape, wt, gt,
                                                padding=k - 1, groups=d)
            lib_dw = torch.nn.grad.conv1d_weight(xt, wt.shape, gt,
                                                 padding=k - 1, groups=d)
            lib_err = max((lib_dx.transpose(1, 2) - pdx).abs().max().item(),
                          (lib_dw[:, 0].t() - pdw).abs().max().item())
            dxt = conv1d_timed(
                torch, plan, lambda g, v: tc1.trim_conv1d_input_grad(g, v),
                lambda g, v: torch.nn.grad.conv1d_input(
                    xt.shape, v, g, padding=k - 1, groups=d), [dy, w],
                [gt, wt])
            row.update(
                fwd=rotating_ms(torch, lambda a, v: tc1.trim_conv1d(a, v),
                                [x, w], dy.numel() * dy.element_size()),
                dx=dxt["kernel"], dx_library=dxt["library"],
                dx_host_us=dxt["host_us"], dx_of_bound=dxt["of_bound"],
                dx_geometry=dxt["geometry"],
                dx_plain=time_ms(torch, lambda:
                                 tc1.trim_conv1d_input_grad_plain(dy, w)),
                dw=time_ms(torch, lambda: tc1.trim_conv1d_weight_grad(
                    x, dy, k)),
                dw_plain=time_ms(torch, lambda: tc1.trim_conv1d_wgrad_plain(
                    x, dy, k), reps=3),
                dw_library=time_ms(torch, lambda: torch.nn.grad.conv1d_weight(
                    xt, wt.shape, gt, padding=k - 1, groups=d)),
                lib_err=lib_err)
            line += (f" {row['fwd']:8.4f} {row['dx']:8.4f} "
                     f"{row['dx_plain']:8.4f} {row['dx_library']:8.4f} "
                     f"{plan.bound()[0]:8.4f} {row['dw']:8.4f} "
                     f"{row['dw_plain']:8.3f} {row['dw_library']:8.4f} "
                     f"{wplan.bound()[0]:8.4f} {wplan.tile_l:3d} "
                     f"{wplan.groups:4d}  (library vs plain {lib_err:.1e}; "
                     f"dw moves {row['dw_hbm'] / 1e6:.1f} MB, least "
                     f"{wplan.min_bytes() / 1e6:.1f}; dx "
                     f"{row['dx_of_bound']:.1%} of its bound, host "
                     f"{row['dx_host_us']:.1f} us, {row['dx_geometry']})")
            del xt, wt, gt, lib_dx, lib_dw
        rows.append(row)
        print(line)
        del xz, x, w, dy, dx, dw, dx2, dw2, pdx, pdw
    torch.cuda.empty_cache()
    return rows


@contextlib.contextmanager
def float64_reference(torch):
    """Evaluate the f32 model in float64: while open, ``Tensor.float()``
    (the port's norms, RoPE, RG-LRU, attention scores and loss upcast
    with it) keeps a float64 tensor float64, so a step on float64 params
    runs in float64 throughout."""
    narrow = torch.Tensor.float

    def widening(self, *args, **kwargs):
        if self.dtype == torch.float64:
            return self
        return narrow(self, *args, **kwargs)
    torch.Tensor.float = widening
    try:
        yield
    finally:
        torch.Tensor.float = narrow


@contextlib.contextmanager
def swapped(module, **fns):
    """``module``'s functions of these names replaced while open (the
    autograd Functions' backwards look them up at call time)."""
    saved = {name: getattr(module, name) for name in fns}
    for name, fn in fns.items():
        setattr(module, name, fn)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(module, name, fn)


def conv1d_backward_f64(torch) -> dict:
    """The conv1d backward's oracle for :func:`swapped`: dx and dw of the
    causal depthwise conv computed in float64 from the f32 inputs, rounded
    to f32."""
    import torch.nn.functional as F

    def input_grad(dy, w, *, tile_l=None):
        k, length = w.shape[0], dy.shape[1]
        gp = F.pad(dy.double(), (0, 0, 0, k - 1))
        return sum(gp[:, k - 1 - i:k - 1 - i + length] * w[i].double()
                   for i in range(k)).float()

    def weight_grad(x, dy, k, *, tile_l=None):
        length = x.shape[1]
        xp = F.pad(x.double(), (0, 0, k - 1, 0))
        return torch.stack([(xp[:, i:i + length] * dy.double()).sum((0, 1))
                            for i in range(k)]).float()
    return {"trim_conv1d_input_grad": input_grad,
            "trim_conv1d_weight_grad": weight_grad}


def loss_grads(torch, cfg, params, batch, *, conv_impl: str = "trim",
               dtype=None) -> list:
    """The loss's gradient of every leaf (sorted-key order) at ``params``,
    the temporal conv on ``conv_impl`` (``"ref"``: plain autograd of the
    oracle; the models call ``ops.depthwise_conv1d``'s default
    ``"trim"``), in ``dtype`` (float64 through
    :func:`float64_reference`)."""
    from repro_torch.kernels import ops
    from repro_torch.models import api
    from repro_torch.optim import adamw
    dtype = dtype or torch.float32
    live = [t.detach().to(dtype).requires_grad_()
            for t in adamw.tree_leaves(params)]
    conv = ops.depthwise_conv1d
    ops.depthwise_conv1d = functools.partial(conv, impl=conv_impl)
    wide = float64_reference(torch) if dtype == torch.float64 \
        else contextlib.nullcontext()
    try:
        with wide:
            logits, aux = api.forward(adamw.tree_unflatten(params, live),
                                      batch, cfg)
            loss = api.loss_fn(logits, batch["labels"], aux)
            del logits
            return list(torch.autograd.grad(loss, live))
    finally:
        ops.depthwise_conv1d = conv


def leaf_errs(grads, want) -> list:
    """max|g - want| / max|want| of each leaf."""
    return [((g.double() - w.double()).abs().max()
             / w.double().abs().max()).item() for g, w in zip(grads, want)]


def family_counts(tc1, fa, bf16: bool = False) -> dict:
    """The conv1d and flash launches of a training path on one route
    (f32, or bf16): raises if the other route launched."""
    return {**route_counts(tc1.LAUNCHES, bf16),
            **route_counts(tc1.BWD_LAUNCHES, bf16),
            **route_counts(fa.LAUNCHES, bf16),
            **route_counts(fa.BWD_LAUNCHES, bf16)}


def rgemma_train(torch):
    """Full-width recurrentgemma-2b trained through ``launch.train.main``
    (remat; the conv1d and flash kernels forward and backward) at
    RGEMMA_TRAIN_BATCH x RGEMMA_TRAIN_SEQ - 1 tokens; each step's
    launches, the clip state, a depth-3 cut's steps with a finite norm,
    and at that cut the first-step gradients on the kernels against the
    same step on impl="ref" conv1d and attn_impl="ref" in float64 and
    against the kernel forward with the backward kernels' plain versions
    in float64 (module docstring, phase 31)."""
    from repro_torch.configs import registry
    from repro_torch.data import DataConfig, make_batch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import trim_conv1d as tc1
    from repro_torch.launch import train
    from repro_torch.models import api
    from repro_torch.models.base import init_params
    from repro_torch.optim import adamw

    cfg = registry.get("recurrentgemma-2b").CONFIG
    assert cfg.attn_impl == "flash" and cfg.remat
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tc1.reset_launch_counts()
    fa.reset_launch_counts()
    out = train.main(["--arch", "recurrentgemma-2b", "--steps",
                      str(RGEMMA_TRAIN_STEPS), "--batch",
                      str(RGEMMA_TRAIN_BATCH), "--seq", str(RGEMMA_TRAIN_SEQ),
                      "--task", "copy", "--log-every", "1", "--device",
                      "cuda"])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = family_counts(tc1, fa)
    clip = train_clip_state(torch, out.pop("state"), out["grad_norms"],
                            "recurrentgemma-2b full width")
    torch.cuda.empty_cache()
    n = RGEMMA_TRAIN_STEPS
    rec = sum(cfg.pattern_at(i) == "rec" for i in range(cfg.n_layers))
    att = cfg.n_layers - rec
    want = {"trim_conv1d": 2 * rec * n, "trim_conv1d_dx": rec * n,
            "trim_conv1d_wgrad": rec * n, "flash_attention": 2 * att * n,
            "flash_attention_bwd_dkdv": att * n,
            "flash_attention_bwd_dq": att * n,
            "flash_attention_bwd_sum": att * n}
    losses = np.asarray(out["losses"])
    if launches != want or losses.shape != (n,) or \
            not np.isfinite(losses).all():
        raise AssertionError(f"recurrentgemma train: launches {launches}, "
                             f"want {want}; losses {out['losses']}")
    steady = float(np.mean(out["step_ms"][1:]))
    print(f"recurrentgemma train: full width ({cfg.n_layers} layers: {rec} "
          f"rec + {att} att, remat), batch {RGEMMA_TRAIN_BATCH} x "
          f"{RGEMMA_TRAIN_SEQ - 1} tokens, {n} AdamW steps: losses "
          f"{[round(x, 4) for x in out['losses']]}, ms a step "
          f"{[round(x, 1) for x in out['step_ms']]} (steady {steady:.1f}); "
          f"peak device memory {peak:.2f} GiB; a step launches "
          + ", ".join(f"{k} {v // n}" for k, v in launches.items()))
    cut = lm_train_cut(torch, cfg.replace(n_layers=RGEMMA_GRAD_LAYERS),
                       RGEMMA_TRAIN_BATCH, RGEMMA_TRAIN_SEQ,
                       RGEMMA_TRAIN_STEPS)

    gcfg = cfg.replace(n_layers=RGEMMA_GRAD_LAYERS)
    params = init_params(api.params(gcfg), torch.Generator(device="cuda")
                         .manual_seed(0), device="cuda")
    nb = make_batch(DataConfig(batch=1, seq=RGEMMA_GRAD_TOKENS + 1,
                               vocab=cfg.vocab, task="copy"), 0)
    batch = {k: torch.from_numpy(v).cuda() for k, v in nb.items()}
    names = leaf_names(params)
    ref_cfg = gcfg.replace(attn_impl="ref")
    want64 = loss_grads(torch, ref_cfg, params, batch, conv_impl="ref",
                        dtype=torch.float64)
    tc1.reset_launch_counts()
    fa.reset_launch_counts()
    kern = loss_grads(torch, gcfg, params, batch)
    grad_launches = family_counts(tc1, fa)
    step = {"kernels": leaf_errs(kern, want64),
            "f32 ref": leaf_errs(loss_grads(torch, ref_cfg, params, batch,
                                            conv_impl="ref"), want64)}
    del want64
    # the same kernel forward, the backward kernels swapped for their
    # plain versions in float64 (the oracle) and in f32
    with swapped(fa, flash_attention_backward=plain_backward_f64), \
            swapped(tc1, **conv1d_backward_f64(torch)):
        bwd64 = loss_grads(torch, gcfg, params, batch)
    with swapped(fa, flash_attention_backward=(
            fa.flash_attention_backward_plain)), \
            swapped(tc1, trim_conv1d_input_grad=(
                tc1.trim_conv1d_input_grad_plain),
                trim_conv1d_weight_grad=tc1.trim_conv1d_wgrad_plain):
        bwd32 = loss_grads(torch, gcfg, params, batch)
    bwd = {"kernels": leaf_errs(kern, bwd64),
           "f32 plain": leaf_errs(bwd32, bwd64)}
    del kern, bwd64, bwd32, params, batch
    torch.cuda.empty_cache()

    def worst(errs):
        i = int(np.argmax(errs))
        return f"{errs[i]:.2e} ({names[i]})"
    step_ok = max(step["kernels"]) <= F64_FACTOR * max(step["f32 ref"])
    bwd_lim = max(F64_FACTOR * max(bwd["f32 plain"]), ATTN_TOLERANCE)
    bwd_ok = max(bwd["kernels"]) <= min(BWD_TOLERANCE, bwd_lim)
    line = (f"depth-{RGEMMA_GRAD_LAYERS} cut, 1 x {RGEMMA_GRAD_TOKENS} "
            f"tokens, of each leaf's max: the whole step on the kernels "
            f"from the same step on impl='ref' conv1d and attn_impl='ref' "
            f"in float64 {worst(step['kernels'])}, the f32 ref step "
            f"{worst(step['f32 ref'])} (limit {F64_FACTOR:g} x the f32 ref "
            f"step's); the backward kernels from their plain versions in "
            f"float64 under the same kernel forward "
            f"{worst(bwd['kernels'])}, the f32 plain versions "
            f"{worst(bwd['f32 plain'])} (limit min({BWD_TOLERANCE:g}, "
            f"max({F64_FACTOR:g} x the f32 plain's, {ATTN_TOLERANCE:g}))); "
            f"launches {grad_launches}")
    if not (step_ok and bwd_ok and min(grad_launches.values()) > 0):
        raise AssertionError(f"recurrentgemma train: first-step gradients "
                             f"at the {line}")
    print(f"recurrentgemma train: first-step gradients at the {line}; "
          "leaves above 1e-4 from the float64 ref step: "
          + ", ".join(f"{names[i]} {e:.2e} (f32 ref "
                      f"{step['f32 ref'][i]:.2e})"
                      for i, e in enumerate(step["kernels"]) if e > 1e-4))
    return dict(out, peak=peak, launches=launches, steady_ms=steady,
                clip=clip, cut=cut, step_err=max(step["kernels"]),
                step_ref_err=max(step["f32 ref"]),
                bwd_err=max(bwd["kernels"]),
                bwd_plain_err=max(bwd["f32 plain"]))


def mamba_train(torch):
    """The full-width falcon-mamba-7b depth cut (MAMBA_TRAIN_LAYERS layers,
    remat) trained through ``steps.make_train_step``: each step's loss and
    launches, ms a step, the peak, the clip state; at a depth-2 cut the
    first-step gradients on the kernels against the f32 step on
    impl="ref" (``MAMBA_GRAD_TOLERANCE``)."""
    from repro_torch.configs import registry
    from repro_torch.data import DataConfig, SyntheticStream, make_batch
    from repro_torch.distributed import steps
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import trim_conv1d as tc1
    from repro_torch.models import api
    from repro_torch.models.base import init_params
    from repro_torch.optim import AdamWConfig

    cfg = registry.get("falcon-mamba-7b").CONFIG.replace(
        n_layers=MAMBA_TRAIN_LAYERS)
    assert cfg.remat
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    n, layers = MAMBA_TRAIN_STEPS, cfg.n_layers
    opt = AdamWConfig(lr=3e-3, warmup_steps=10, decay_steps=n)
    state = steps.init_train_state(
        cfg, opt, torch.Generator(device="cuda").manual_seed(0))
    stream = SyntheticStream(DataConfig(batch=MAMBA_TRAIN_BATCH,
                                        seq=MAMBA_TRAIN_SEQ, vocab=cfg.vocab,
                                        task="copy"))
    step_fn = steps.make_train_step(cfg, opt)
    tc1.reset_launch_counts()
    fa.reset_launch_counts()
    losses, norms, step_ms = [], [], []
    for _ in range(n):
        t0 = time.perf_counter()
        state, metrics = step_fn(state, {k: torch.from_numpy(v).cuda()
                                         for k, v in next(stream).items()})
        losses.append(float(metrics["loss"]))
        step_ms.append((time.perf_counter() - t0) * 1e3)
        norms.append(float(metrics["grad_norm"]))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = family_counts(tc1, fa)
    clip = train_clip_state(torch, state, norms,
                            f"falcon-mamba-7b depth-{layers} full-width cut")
    del state
    torch.cuda.empty_cache()
    want = {"trim_conv1d": 2 * layers * n, "trim_conv1d_dx": layers * n,
            "trim_conv1d_wgrad": layers * n}
    got = {k: launches[k] for k in want}
    if got != want or any(launches[k] for k in launches if k not in want) \
            or not np.isfinite(losses).all():
        raise AssertionError(f"mamba train: launches {launches}, want "
                             f"{want}; losses {losses}")
    steady = float(np.mean(step_ms[1:]))
    print(f"mamba train: falcon-mamba-7b full width cut to {layers} of 64 "
          f"layers (remat, scan chunks checkpointed), batch "
          f"{MAMBA_TRAIN_BATCH} x {MAMBA_TRAIN_SEQ - 1} tokens, {n} AdamW "
          f"steps: losses {[round(x, 4) for x in losses]}, grad norms "
          f"{norms}, ms a step {[round(x, 1) for x in step_ms]} (steady "
          f"{steady:.1f}); peak device memory {peak:.2f} GiB; a step "
          f"launches " + ", ".join(f"{k} {v // n}" for k, v in got.items()))

    gcfg = cfg.replace(n_layers=MAMBA_GRAD_LAYERS)
    params = init_params(api.params(gcfg), torch.Generator(device="cuda")
                         .manual_seed(0), device="cuda")
    nb = make_batch(DataConfig(batch=MAMBA_TRAIN_BATCH, seq=MAMBA_TRAIN_SEQ,
                               vocab=cfg.vocab, task="copy"), 0)
    batch = {k: torch.from_numpy(v).cuda() for k, v in nb.items()}
    want_g = loss_grads(torch, gcfg, params, batch, conv_impl="ref")
    tc1.reset_launch_counts()
    errs = leaf_errs(loss_grads(torch, gcfg, params, batch), want_g)
    names = leaf_names(params)
    grad_launches = route_counts(tc1.BWD_LAUNCHES, bf16=False)
    del want_g, params, batch
    torch.cuda.empty_cache()
    worst = int(np.argmax(errs))
    if not (max(errs) <= MAMBA_GRAD_TOLERANCE
            and min(grad_launches.values()) > 0):
        raise AssertionError(
            f"mamba train: depth-{MAMBA_GRAD_LAYERS} gradients on the "
            f"kernels {max(errs):.3e} of a leaf's max from the f32 step on "
            f"impl='ref' at {names[worst]} (tol {MAMBA_GRAD_TOLERANCE}); "
            f"backward launches {grad_launches}")
    print(f"mamba train: first-step gradients at the depth-"
          f"{MAMBA_GRAD_LAYERS} cut ({MAMBA_TRAIN_BATCH} x "
          f"{MAMBA_TRAIN_SEQ - 1} tokens) on the kernels against the f32 "
          f"step on impl='ref': {max(errs):.2e} of a leaf's max "
          f"({names[worst]}; tol {MAMBA_GRAD_TOLERANCE:g})")
    return dict(losses=losses, grad_norms=norms, step_ms=step_ms,
                steady_ms=steady, peak=peak, launches=launches, clip=clip,
                grad_err=max(errs))


def time_turns_ms(torch, fns, turns: int = TUNE_TURNS) -> list:
    """Device ms a launch of each of ``fns`` (``time_graph_ms``), timed in
    ``turns`` alternating rounds in this call; the median of each."""
    times = [[] for _ in fns]
    for _ in range(turns):
        for i, fn in enumerate(fns):
            times[i].append(time_graph_ms(torch, fn))
    return [float(np.median(t)) for t in times]


def plan_label(plan) -> str:
    return (f"{plan.th_out}x{plan.tile_w}x{plan.tile_cout} {plan.dataflow} "
            f"s{plan.segments}")


def tune_table(torch, label, topo, n, dtype):
    """Measured ``tune_network`` of ``topo`` at batch ``n`` (``dtype``
    "float32" or "int8"), then per tuned layer: the default plan's and
    the tuned plan's output through ``ops.conv2d`` (the tuned one read
    from the cache, its dataflow's kernel launched once) bitwise equal,
    and both plans' device ms through the kernel wrapper, in turns.
    Returns the rows and the sweep's seconds."""
    from repro_torch.core import autotune
    from repro_torch.core.conv_plan import ConvPlan
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import trim_conv2d as tc

    t0 = time.perf_counter()
    recs = autotune.tune_network(topo, n=n, dtype=dtype, measure=True,
                                 device="cuda")
    sweep_s = time.perf_counter() - t0
    gen = torch.Generator(device="cuda").manual_seed(n)
    rows = []
    print(f"autotune[{label}, N={n}]: measured tune of {len(recs)} layers "
          f"in {sweep_s:.2f} s (plan: strip x band x C_out tile, "
          "dataflow, segments; device ms from CUDA graphs, "
          f"{TUNE_TURNS} alternating turns, median):")
    for layer in topo:
        rec = recs[layer.name]
        if "skipped" in rec:
            print(f"  {layer.name:7s} skipped: {rec['skipped']}")
            continue
        xs, pads, ws = autotune.layer_problem(layer, n=n)
        padding = "same" if layer.padding else "valid"
        common = dict(stride=layer.stride, pad=pads, groups=layer.groups,
                      dtype_bytes=autotune.DTYPE_BYTES[dtype])
        knobs = {k: rec[k] for k in ("tile_h", "tile_cout", "dataflow")}
        default = ConvPlan.build(xs, ws, **common)
        tuned = ConvPlan.build(xs, ws, **common, **knobs)
        kw = dict(stride=layer.stride, pad=pads, groups=layer.groups,
                  activation="relu")
        if dtype == "int8":
            x = torch.randint(-128, 128, xs, generator=gen, device="cuda",
                              dtype=torch.int8)
            w = torch.randint(-128, 128, ws, generator=gen, device="cuda",
                              dtype=torch.int8)
            pk = ops.QuantizedConv2dWeights(
                w=w, bias=torch.randn((ws[3],), generator=gen,
                                      device="cuda"),
                scale=torch.full((ws[3],), 1e-3, device="cuda"),
                zero_point=torch.tensor(3, dtype=torch.int32,
                                        device="cuda"),
                input_scale=torch.tensor(0.05, device="cuda"),
                groups=layer.groups, cout=ws[3])
            scale, bias_q = ref.dequant_params(pk.w, pk.scale,
                                               pk.input_scale,
                                               pk.zero_point, pk.bias)

            def op(**o):
                return ops.conv2d(x, pk, stride=layer.stride,
                                  padding=padding, activation="relu", **o)

            def wrap(k):
                return lambda: tc.trim_conv2d_q8(
                    x, w, bias_q, scale, zero_point=pk.zp,
                    w_packed=pk.w_kernel, **k, **kw)
            key = f"q8_{tuned.dataflow}"
        else:
            x = torch.randn(xs, generator=gen, device="cuda")
            w = torch.randn(ws, generator=gen, device="cuda") \
                / float(np.sqrt(ws[0] * ws[1] * ws[2]))
            b = torch.randn((ws[3],), generator=gen, device="cuda")

            def op(**o):
                return ops.conv2d(x, w, stride=layer.stride,
                                  padding=padding, bias=b,
                                  feature_group_count=layer.groups,
                                  activation="relu", **o)

            def wrap(k):
                return lambda: tc.trim_conv2d(x, w, b, **k, **kw)
            key = tuned.dataflow
        want = op(use_autotune_cache=False)
        tc.reset_launch_counts()
        got = op()
        torch.cuda.synchronize()
        if dict(tc.LAUNCHES) != launch_counts(**{key: 1}):
            raise AssertionError(f"autotune[{label}] {layer.name}: "
                                 f"ops.conv2d launched {tc.LAUNCHES}, want "
                                 f"one {key} (the record's dataflow)")
        if not torch.equal(got, want):
            raise AssertionError(
                f"autotune[{label}, N={n}] {layer.name}: the tuned plan's "
                f"output differs from the default's bitwise: max|diff| "
                f"{(got - want).abs().max().item()}")
        # the default by no knobs: an int8 default strip need not replay
        # as an explicit tile_h (the planner picks it with the warps)
        ms_d, ms_t = time_turns_ms(torch, [wrap(dict(dataflow="carry")),
                                           wrap(knobs)])
        rows.append(dict(name=layer.name, default=ms_d, tuned=ms_t,
                         moved=tuned != default,
                         measured_us=rec["measured_us"]))
        print(f"  {layer.name:7s} default {plan_label(default):22s} "
              f"{ms_d:8.4f} ms | tuned {plan_label(tuned):22s} "
              f"{ms_t:8.4f} ms ({rec['source']}, {rec['measured_us']:.1f} "
              f"us in the tune){'' if tuned != default else ' = default'}")
        del x, w
    torch.cuda.empty_cache()
    sd, st = sum(r["default"] for r in rows), sum(r["tuned"] for r in rows)
    print(f"autotune[{label}, N={n}]: sum of {len(rows)} layers: default "
          f"{sd:.4f} ms, tuned {st:.4f} ms ({(st / sd - 1) * 100:+.2f}%); "
          f"{sum(r['moved'] for r in rows)} plans moved; every tuned output "
          "bitwise equal to the default's")
    return rows, sweep_s


def tune_trainer(torch):
    """``launch.train_cnn.tune_backward_shapes`` (measured input-gradient
    convs) for the trainer's batch, then the trainer's AdamW step with the
    records against the step without (``REPRO_TORCH_CONV_AUTOTUNE=0``),
    timed in turns from one state: gradients within ``GRAD_TOLERANCE`` of
    each leaf's max|g| (dW is not bitwise across chunk heights), two steps
    with the records bitwise equal.  Returns the tuner's seconds."""
    from repro_torch.core import autotune
    from repro_torch.launch import train_cnn
    from repro_torch.models import layers
    from repro_torch.models.base import init_params
    from repro_torch.optim import adamw

    batch = 16
    t0 = time.perf_counter()
    recs = train_cnn.tune_backward_shapes(batch, device="cuda",
                                          measure=True)
    sweep_s = time.perf_counter() - t0
    params = init_params(
        layers.simple_cnn_params(cin=train_cnn.CIN,
                                 channels=train_cnn.CHANNELS,
                                 n_classes=train_cnn.N_CLASSES),
        torch.Generator().manual_seed(0), device="cuda")
    moments = adamw.init_moments(params, train_cnn.OPT)
    rng = np.random.default_rng(0)
    templates = rng.standard_normal((train_cnn.N_CLASSES, train_cnn.IMAGE,
                                     train_cnn.IMAGE, train_cnn.CIN))
    x, y = train_cnn.make_batch(rng, templates, batch, "cuda")

    def step():
        out = train_cnn.train_step(params, moments, 0, x, y,
                                   apply_fn=layers.simple_cnn_apply,
                                   cfg=train_cnn.OPT)
        torch.cuda.synchronize()
        return out

    def with_records(on):
        if on:
            os.environ.pop(autotune.AUTOTUNE_ENV, None)
        else:
            os.environ[autotune.AUTOTUNE_ENV] = "0"

    try:
        with_records(True)
        g_on = grads(layers.simple_cnn_apply, params, x, y)[1]
        p1, p2 = step()[0], step()[0]
        with_records(False)
        g_off = grads(layers.simple_cnn_apply, params, x, y)[1]
        for a, b in zip(adamw.tree_leaves(p1), adamw.tree_leaves(p2)):
            if not torch.equal(a, b):
                raise AssertionError("autotune[trainer]: two steps with the "
                                     "records differ bitwise")
        worst = 0.0
        for a, b in zip(g_on, g_off):
            rel = (a - b).abs().max().item() / max(b.abs().max().item(),
                                                   1e-30)
            worst = max(worst, rel)
        if not worst <= GRAD_TOLERANCE:
            raise AssertionError(f"autotune[trainer]: gradients with the "
                                 f"records differ by {worst:.3e} of max|g|")
        times = {True: [], False: []}
        for _ in range(5):
            for on in (True, False):
                with_records(on)
                t = time.perf_counter()
                step()
                times[on].append((time.perf_counter() - t) * 1e3)
    finally:
        with_records(True)
    moved = sum(r["input_grad"]["tile_h"] is not None
                or r["input_grad"]["dataflow"] != "carry"
                for r in recs.values())
    print(f"autotune[trainer]: tune_backward_shapes(batch {batch}, "
          f"measured) {sweep_s:.2f} s, {len(recs)} convs, "
          f"{2 * len(recs)} records; step with the records "
          f"{np.median(times[True]):.2f} ms, without "
          f"{np.median(times[False]):.2f} ms (medians of 5 alternating "
          f"steps, host clock to synchronize); gradients within "
          f"{worst:.2e} of max|g| (<= {GRAD_TOLERANCE:g}); two steps with "
          f"the records bitwise equal ({moved} input-gradient records "
          "with non-default knobs)")
    return sweep_s


def serve_tuned(torch):
    """Full-width VGG-16 served after ``prewarm(tune=True)`` with
    ``tune_kwargs={"measure": True}`` on buckets (1, 2, 4, 8): 48 seeded
    Poisson requests, no cold tune, each forward launching per layer the
    kernel of its bucket's record (carry or halo), every row bitwise
    equal to ``forward_one``.  Returns (launch counts, forwards, prewarm
    seconds)."""
    from repro_torch.core.model import vgg16_layers
    from repro_torch.core.serving import ServingEngine, replay
    from repro_torch.kernels import trim_conv2d as tc
    from repro_torch.models.layers import TrimCNN
    from repro_torch.testing.load import poisson_arrivals

    topo = vgg16_layers()
    model = TrimCNN.random(topo, n_classes=1000, seed=0, device="cuda")
    engine = ServingEngine.for_topology(topo, model, buckets=(1, 2, 4, 8),
                                        device="cuda",
                                        tune_kwargs={"measure": True})
    t0 = time.perf_counter()
    recs = engine.prewarm()
    warm_s = time.perf_counter() - t0
    for b, per in recs.items():
        halo = sum(r["dataflow"] == "halo" for r in per["layers"].values())
        print(f"serve[tuned]: bucket {b}: {len(per['layers'])} measured "
              f"records ({halo} halo), first forward "
              f"{per['seconds']:.4f} s")
    rng = np.random.default_rng(0)
    xs = rng.standard_normal((REQUESTS, 224, 224, 3)).astype(np.float32)
    trace = [(t, i, xs[i]) for i, t in enumerate(
        poisson_arrivals(ARRIVAL_RATE, REQUESTS, seed=0))]
    tc.reset_launch_counts()
    results, rejected = replay(engine, trace)
    launches = dict(tc.LAUNCHES)
    st = engine.stats()
    if rejected or len(results) != REQUESTS:
        raise AssertionError(f"serve[tuned]: served {len(results)}, "
                             f"rejected {rejected}")
    if st["cold_tunes"] != 0:
        raise AssertionError(f"serve[tuned]: {st['cold_tunes']} cold tunes "
                             "after prewarm")
    want = launch_counts()
    for bucket, count in st["bucket_batches"].items():
        for r in recs[bucket]["layers"].values():
            want[r["dataflow"]] += count
    if launches != want:
        raise AssertionError(f"serve[tuned]: launches {launches}, want "
                             f"{want} from the records")
    s = engine.recorder.summary()
    for i in range(REQUESTS):
        row = results[i]
        if row.shape != (1000,) or not np.isfinite(row).all():
            raise AssertionError(f"serve[tuned] request {i}: bad logits")
        if not np.array_equal(row, engine.forward_one(xs[i])):
            raise AssertionError(f"serve[tuned] request {i}: served row "
                                 "differs from the single-request forward")
    forwards = sum(st["bucket_batches"].values())
    print(f"serve[tuned]: prewarm (measured tune of 13 layers x 4 buckets "
          f"+ first forwards) {warm_s:.2f} s; {REQUESTS} requests, bucket "
          f"batches {st['bucket_batches']}, {forwards} forwards, launches "
          f"{launches}, cold tunes {st['cold_tunes']}; p50 "
          f"{s['p50_s'] * 1e3:.3f} ms, p99 {s['p99_s'] * 1e3:.3f} ms, "
          f"throughput {s['throughput_rps']:.1f} req/s; all rows bit-match "
          "forward_one")
    del model, engine
    torch.cuda.empty_cache()
    return launches, forwards, warm_s


def autotune_phase(torch, cache_dir: str) -> dict:
    """The tuner on the card, on a cache of its own (reset before and
    after): the per-layer tables (VGG-16 f32 and int8, AlexNet conv2-5,
    N=8 and 1), the trainer's backward shapes and VGG-16 served after a
    measured prewarm.  Returns the tables, the serving launches and the
    tuner's seconds."""
    from repro_torch.core import autotune
    from repro_torch.core.model import alexnet_layers, vgg16_layers

    outer = os.environ.get(autotune.CACHE_ENV)
    os.environ[autotune.CACHE_ENV] = os.path.join(cache_dir,
                                                  "autotune_phase.json")
    autotune.reset_memory_cache()
    try:
        tables, sweep = {}, {}
        for label, topo, dtype in (("VGG-16 f32", vgg16_layers(), "float32"),
                                   ("VGG-16 int8", vgg16_layers(), "int8"),
                                   ("AlexNet f32", alexnet_layers(),
                                    "float32")):
            for n in (8, 1):
                tables[label, n], sweep[f"{label} N={n}"] = tune_table(
                    torch, label, topo, n, dtype)
        sweep["trainer backward"] = tune_trainer(torch)
        launches, forwards, sweep["serving prewarm"] = serve_tuned(torch)
    finally:
        if outer is None:
            os.environ.pop(autotune.CACHE_ENV, None)
        else:
            os.environ[autotune.CACHE_ENV] = outer
        autotune.reset_memory_cache()
    print(f"autotune: launches of tuned serving {launches} in {forwards} "
          f"forwards; the tuner's own seconds "
          + ", ".join(f"{k} {v:.2f}" for k, v in sweep.items())
          + f"; total {sum(sweep.values()):.2f} s")
    return dict(tables=tables, launches=launches, sweep=sweep)


# ---------------------------------------------------------------------------
# The bf16 routes (phase 33)
# ---------------------------------------------------------------------------

# Each bf16 kernel on route ffma against its plain version: the plain
# version takes the kernel's own fmaf chain (a bf16 x bf16 product is
# exact in f32, so a multiply then an add is the kernel's fmaf), so the
# two agree bit for bit under relu; one bf16 ulp is the limit (an
# activation's tanh / exp may differ in the last f32 bit between CUDA and
# PyTorch).  Route mma (the bf16 tensor cores, csrc/bf16_mma.cuh) adds in
# the tensor core's order, which the plain version cannot repeat: it is
# held to the float64 oracle (bf16_f64_excess) and its distance from the
# plain version is printed.
BF16_ULPS = 1.0
# bf16 serving's logits against the f32 serving of the same
# (bf16-representable) params and inputs, of max|f32 logits| a request:
# DESIGN.md section 5's bf16 tolerance, as tests/test_kernels.py holds
# the JAX bf16 conv to its f32 oracle
BF16_F32_TOLERANCE = 3e-2


def bf16_ulps(torch, a, b) -> float:
    """max |a - b| in bf16 ulps at max(|a|, |b|) (of the normal range)."""
    a, b = a.double(), b.double()
    m = torch.maximum(a.abs(), b.abs()).clamp_min(2.0 ** -126)
    ulp = torch.pow(2.0, torch.floor(torch.log2(m)) - 7)
    return ((a - b).abs() / ulp).max().item()


def bf16_bound(flops: int, min_bytes: int) -> dict:
    """The least time of a bf16 conv on the card: its bytes (2 an element,
    each input read once, the output written once) at 3.35 TB/s or its
    FLOPs on the dense bf16 tensor cores, the larger; ``ffma`` is the
    kernels' own route's ceiling, the FLOPs at 67 TFLOP/s of f32 FFMA."""
    ops_ms = flops / PEAK_BF16_FLOPS * 1e3
    bytes_ms = min_bytes / PEAK_BYTES_PER_S * 1e3
    return dict(bound=max(ops_ms, bytes_ms), ops_ms=ops_ms,
                bytes_ms=bytes_ms, ffma=flops / PEAK_F32_FLOPS * 1e3,
                by="operations" if ops_ms >= bytes_ms else "bytes")


def bf16_plain_conv(torch, x, w, b, *, stride, padding):
    """The plain version of ``ops.conv2d`` on bf16 (relu): the carry
    kernel's plain version, or for K > 8 the adder tree over its bf16
    parts (summed in bf16 in order, then the bf16 epilogue)."""
    from repro_torch.core.tiling import subkernel_decomposition
    from repro_torch.kernels import ref
    from repro_torch.kernels.ops import MAX_NATIVE_K
    from repro_torch.kernels.trim_conv2d import trim_conv2d_plain
    k = w.shape[0]
    pads = ref.conv_pads(x.shape[1], x.shape[2], k, stride, padding)
    if k <= MAX_NATIVE_K:
        return trim_conv2d_plain(x, w, b, stride=stride, pad=pads,
                                 activation="relu")
    xp = ref.pad_nhwc(x, pads)
    ho = (xp.shape[1] - k) // stride + 1
    wo = (xp.shape[2] - k) // stride + 1
    out = None
    for r0, c0, kh, kw in subkernel_decomposition(k, native_k=3):
        part = trim_conv2d_plain(
            xp[:, r0:r0 + (ho - 1) * stride + kh,
               c0:c0 + (wo - 1) * stride + kw].contiguous(),
            w[r0:r0 + kh, c0:c0 + kw].contiguous(), stride=stride)
        out = part if out is None else out + part
    return ref.epilogue(out, b, "relu")


def bf16_f64_excess(torch, y, x, w, b, *, stride, pads) -> float:
    """How far a bf16 conv output (relu) lies beyond its bound from the
    float64 oracle rounded to bf16 (<= 0: within): one bf16 ulp of the
    oracle plus n 2^-22 sum|x w| (n = KH KW Cin/g products: the f32
    chain's n 2^-24 bound of tests/test_torch_bf16.py, doubled twice for
    the tensor core's truncating additions)."""
    import torch.nn.functional as F
    (pt, pb), (pl, pr) = pads
    xd = F.pad(x.double().permute(0, 3, 1, 2), (pl, pr, pt, pb))
    wd = w.double().permute(3, 2, 0, 1)
    acc = F.conv2d(xd, wd, b.double(), stride=stride)
    want = torch.relu(acc).bfloat16().double()
    del acc
    mass = F.conv2d(xd.abs(), wd.abs(), stride=stride)
    n = w.shape[0] * w.shape[1] * w.shape[2]
    ulp = torch.pow(2.0, torch.floor(torch.log2(
        want.abs().clamp_min(2.0 ** -126))) - 7)
    excess = ((y.permute(0, 3, 1, 2).double() - want).abs() - ulp
              - n * 2.0 ** -22 * mass).max().item()
    del xd, want, mass, ulp
    return excess


def bf16_sass_check() -> dict:
    """The bf16 instances' tensor-core instructions (``cuobjdump -sass``,
    as the int8 check reads them): every instance of the per-layer mma
    kernel and the fused kernel's bf16 instance (whose stages on route
    mma run the shared k-loop) must issue ``HMMA.16816.F32.BF16``; the
    per-layer kernel's bf16 ffma instances and every f32 instance none.
    PR 33: every instance of the weight gradient's route mma
    (``wgrad_mma_kernel``) and the flash kernel's bf16 narrow instances
    must issue it, the flash bf16 narrow instances no TF32 HMMA, and the
    wgrad's other instances and the flash kernel's f32 and wide ones no
    bf16 HMMA.  Every bf16 instance of the flash backward's dQ and dK/dV
    kernels must issue it and no TF32 HMMA, its f32 instances and sum
    kernels none.  Returns {instance: HMMA.16816.F32.BF16 count}."""
    import shutil
    from repro_torch.kernels import build
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out, tf32 = {}, {}
    for lib_name in ("trim_conv2d", "trim_conv2d_fused", "trim_conv2d_wgrad",
                     "flash_attention", "flash_attention_bwd"):
        sass = subprocess.run([tool, "-sass", build.library(lib_name)._name],
                              capture_output=True, text=True, check=True,
                              timeout=300).stdout
        fn = None
        for line in sass.splitlines():
            if "Function :" in line:
                fn = line.split("Function :")[1].strip()
                out[fn] = tf32[fn] = 0
            elif fn is not None and "HMMA.16816.F32.BF16" in line:
                out[fn] += 1
            elif fn is not None and "HMMA" in line and "TF32" in line:
                tf32[fn] += 1
    named = {}
    for f, count in out.items():
        if "trim_conv2d_mma_kernel" in f:
            kind = "mma"
        elif "trim_conv2d_kernelI13__nv_bfloat16" in f:
            kind = "ffma"
        elif "trim_conv2d_fused_kernelI13__nv_bfloat16" in f:
            kind = "fused_bf16"
        elif "wgrad_mma_kernel" in f:
            kind = "wgrad_mma"
        elif "wgrad" in f:
            kind = "wgrad_other"
        elif "flash_attention_kernelI13__nv_bfloat16" in f:
            kind = "flash_bf16"
        elif ("flash_attention_bwd_dq_kernelI13__nv_bfloat16" in f
              or "flash_attention_bwd_dkdv_kernelI13__nv_bfloat16" in f):
            kind = "flash_bwd_bf16"
        elif "flash_attention" in f:
            kind = "flash_other"
        else:
            kind = "f32"
        named.setdefault(kind, []).append(count)
    flash_tf32 = [tf32[f] for f in out
                  if "flash_attention_kernelI13__nv_bfloat16" in f
                  or ("flash_attention_bwd" in f
                      and "_kernelI13__nv_bfloat16" in f)]
    if (len(named.get("mma", [])) != 3 or min(named["mma"]) == 0
            or len(named.get("fused_bf16", [])) != 1
            or named["fused_bf16"][0] == 0
            or any(named.get("ffma", [1])) or len(named["ffma"]) != 4
            or any(named.get("f32", [1]))
            or len(named.get("wgrad_mma", [])) != 2
            or min(named["wgrad_mma"]) == 0
            or any(named.get("wgrad_other", [1]))
            or len(named.get("flash_bf16", [])) != 3
            or min(named["flash_bf16"]) == 0 or any(flash_tf32)
            or len(named.get("flash_bwd_bf16", [])) != 9
            or min(named["flash_bwd_bf16"]) == 0
            or any(named.get("flash_other", [1]))):
        raise AssertionError(f"bf16 SASS: HMMA.16816.F32.BF16 by instance "
                             f"{out}; TF32 HMMA {tf32}")
    print("bf16 SASS: HMMA.16816.F32.BF16 a kernel instance: mma "
          f"{named['mma']}, fused bf16 {named['fused_bf16']}, wgrad mma "
          f"{named['wgrad_mma']}, flash bf16 narrow {named['flash_bf16']}, "
          f"flash bf16 backward {named['flash_bwd_bf16']} (TF32 HMMA there "
          f"{flash_tf32}); bf16 ffma {named['ffma']}, "
          f"f32 {named['f32']}, wgrad gemm / depthwise / reduce "
          f"{named['wgrad_other']}, flash f32 / wide / f32 backward / sums "
          f"{named['flash_other']} (none)")
    return out


def check_bf16_convs(torch, net: str, n: int) -> list:
    """The bf16 carry and halo entries at a network's convs at batch ``n``
    (VGG-16's 13, or AlexNet's 5 through ``ops.conv2d``: conv1 is the
    K 11 adder tree of bf16 parts), each layer's route printed (VGG-16's
    conv2-13 must take ``mma``): carry == halo bitwise; route ffma within
    ``BF16_ULPS`` of the plain version (under relu: bitwise); route mma
    within the float64 oracle's bound (``bf16_f64_excess``), its distance
    from the plain version in ulps printed; device ms of each from CUDA
    graphs beside the f32 route's on the same values (widened), ``F.conv2d``
    on bf16 (cuDNN on the bf16 tensor cores; the yardstick) and the plain
    version's (eager, CUDA events), the bound and the FFMA ceiling."""
    import torch.nn.functional as F
    from repro_torch.core.conv_plan import ConvPlan, bf16_route
    from repro_torch.core.model import alexnet_layers, vgg16_layers
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import conv_pads, pad_nhwc

    topo = vgg16_layers() if net == "VGG-16" else alexnet_layers()
    gen = torch.Generator(device="cuda").manual_seed(28 + n)
    bf = torch.bfloat16
    rows = []
    print(f"bf16 kernel check, {net} at batch {n} (relu, bias; device ms "
          "from CUDA graphs, plain eager; ulps against the plain version, "
          "f64: the excess over the float64 bound, <= 0; tile T x W x "
          "C_out, blocks of the bf16 plan; mma: warps_n x m16 fragments):")
    print(f"  {'layer':7s} {'route':5s} {'ulps':>6s} {'f64':>9s} "
          f"{'c==h':>5s} {'carry':>8s} {'halo':>8s} {'f32':>8s} "
          f"{'plain':>9s} {'F.conv':>8s} {'bound':>7s} by         "
          f"{'FFMA':>7s} {'TF/s':>6s} tile")
    for l in topo:
        k, s = l.kernel, l.stride
        padding = "same" if l.padding else "valid"
        xs = (n, l.ifmap, l.ifmap, l.in_channels)
        wsh = (k, k, l.in_channels // l.groups, l.out_channels)
        route = bf16_route(wsh[2], l.groups)
        if net == "VGG-16" and l.name != "conv1" and route != "mma":
            raise AssertionError(f"bf16 VGG-16 {l.name}: route {route}")
        x = torch.randn(xs, generator=gen, device="cuda").to(bf)
        w = (torch.randn(wsh, generator=gen, device="cuda")
             / float(np.sqrt(k * k * wsh[2]))).to(bf)
        b = (0.1 * torch.randn((l.out_channels,), generator=gen,
                               device="cuda")).to(bf)
        kw = dict(stride=s, padding=padding, bias=b, activation="relu",
                  use_autotune_cache=False)

        def conv(df, x=x, w=w, kw=kw):
            return ops.conv2d(x, w, dataflow=df, **kw)
        with torch.inference_mode():
            plain = bf16_plain_conv(torch, x, w, b, stride=s,
                                    padding=padding)
            carry, halo = conv("carry"), conv("halo")
        torch.cuda.synchronize()
        ulps = max(bf16_ulps(torch, carry, plain),
                   bf16_ulps(torch, halo, plain))
        err = (carry.float() - plain.float()).abs().max().item()
        pads = conv_pads(l.ifmap, l.ifmap, k, s, padding)
        excess = None
        if carry.dtype != bf or carry.shape != plain.shape:
            raise AssertionError(f"bf16 {net} {l.name} n={n}: "
                                 f"{carry.dtype} {tuple(carry.shape)}")
        if route == "mma":
            excess = bf16_f64_excess(torch, carry, x, w, b, stride=s,
                                     pads=pads)
            if not excess <= 0:
                raise AssertionError(
                    f"bf16 {net} {l.name} n={n}: {excess} beyond the "
                    "float64 oracle's bound (one ulp + n 2^-22 sum|x w|)")
        elif not (ulps <= BF16_ULPS and torch.equal(carry, plain)):
            raise AssertionError(f"bf16 {net} {l.name} n={n}: {ulps} ulps "
                                 f"from the plain version (route ffma: "
                                 "bitwise under relu)")
        if not torch.equal(carry, halo):
            raise AssertionError(f"bf16 {net} {l.name} n={n}: carry and "
                                 "halo differ bitwise")
        del plain
        xp = pad_nhwc(x, pads).permute(0, 3, 1, 2)
        wl = w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        x32, w32, b32 = x.float(), w.float(), b.float()
        with torch.inference_mode():
            t = {"carry": time_graph_ms(torch, lambda: conv("carry")),
                 "halo": time_graph_ms(torch, lambda: conv("halo")),
                 "f32": time_graph_ms(torch, lambda: ops.conv2d(
                     x32, w32, dataflow="carry", **dict(kw, bias=b32))),
                 "library": time_graph_ms(torch, lambda: F.conv2d(
                     xp, wl, b, stride=s)),
                 "plain": time_ms(torch, lambda: bf16_plain_conv(
                     torch, x, w, b, stride=s, padding=padding), reps=1)}
        flops = 2 * carry.numel() * k * k * wsh[2]
        min_bytes = 2 * (x.numel() + w.numel() + b.numel() + carry.numel())
        row = dict(name=l.name, route=route, err=err, ulps=ulps,
                   excess=excess, **t, **bf16_bound(flops, min_bytes))
        tile = "tree"
        if k <= ops.MAX_NATIVE_K:
            plan = ConvPlan.build(xs, wsh, stride=s, pad=pads,
                                  groups=l.groups, dtype_bytes=2)
            tile = (f"{plan.th_out}x{plan.tile_w}x{plan.tile_cout}, "
                    f"{plan.blocks}")
            if route == "mma":
                tile += f", {plan.warps_n}x{plan.m_frags}"
        rows.append(row)
        f64 = "-" if excess is None else f"{excess:.2e}"
        print(f"  {l.name:7s} {route:5s} {ulps:6.1f} {f64:>9s} {'True':>5s} "
              f"{t['carry']:8.4f} {t['halo']:8.4f} {t['f32']:8.4f} "
              f"{t['plain']:9.3f} {t['library']:8.4f} {row['bound']:7.4f} "
              f"{row['by']:10s} {row['ffma']:7.4f} "
              f"{flops / t['carry'] / 1e9:6.2f} {tile}")
        del x, w, b, carry, halo, xp, wl, x32, w32, b32
    torch.cuda.empty_cache()
    print(f"bf16 kernel check, {net} at batch {n}, sums: carry "
          f"{sum(r['carry'] for r in rows):.4f} ms, halo "
          f"{sum(r['halo'] for r in rows):.4f} ms, the f32 route "
          f"{sum(r['f32'] for r in rows):.4f} ms, plain "
          f"{sum(r['plain'] for r in rows):.3f} ms, F.conv2d bf16 "
          f"{sum(r['library'] for r in rows):.4f} ms, bound "
          f"{sum(r['bound'] for r in rows):.4f} ms (FFMA ceiling "
          f"{sum(r['ffma'] for r in rows):.4f} ms); route mma "
          f"{sum(r['route'] == 'mma' for r in rows)} of {len(rows)} layers")
    return rows


def check_bf16_fused(torch, net: str = "VGG-16", n: int = 8) -> list:
    """The bf16 fused entry on the groups of a network's bf16 plan at
    batch ``n`` (the groups fused bf16 serving runs at that bucket; each
    stage's route printed; AlexNet's conv3..conv4 at T=4, B=13 too):
    bitwise equal to its bf16 per-layer chain (the
    carry entry and a separate max-pool a stage); a group all on route
    ffma within ``BF16_ULPS`` of its plain version, one with a stage on
    route mma its distance printed (the chain's layers are held to float64
    by ``check_bf16_convs``); device ms of the group and its chain from
    CUDA graphs beside the ``F.conv2d`` + relu + ``F.max_pool2d`` chain's
    on bf16, the plain version's (batch 8), the bound and the FFMA
    ceiling."""
    from repro_torch.core.fuse_plan import FusedGroupPlan, _group_at
    from repro_torch.core.netplan import network_layers
    from repro_torch.kernels import trim_conv2d_fused as tf

    name = "vgg16" if net == "VGG-16" else "alexnet"
    plan = FusedGroupPlan.build(name, n=n, dtype_bytes=2)
    print(f"bf16 fused plan, {net} batch {n}: {plan.describe()}")
    if not plan.fused_groups:
        raise AssertionError(f"the bf16 {net} plan fuses no group")
    groups = list(plan.fused_groups)
    if net == "AlexNet" and not any(g.start == 2 for g in groups):
        # conv3..conv4, the group bf16 AlexNet serving ran before PR 32's
        # plan (at its tile then), held to its chain as well
        groups.append(_group_at(tuple(network_layers(name)), 2, 2, n, 4,
                                13, 2))
    gen = torch.Generator(device="cuda").manual_seed(280 + n)
    bf = torch.bfloat16
    rows = []
    for g in groups:
        s0 = g.stages[0]
        routes = [lay.route for lay in g.layouts]
        x = torch.randn((n, s0.h_in, s0.w_in, s0.cin), generator=gen,
                        device="cuda").to(bf)
        ws = [(torch.randn(st.weight_shape, generator=gen, device="cuda")
               / float(np.sqrt(st.kernel ** 2 * st.cin))).to(bf)
              for st in g.stages]
        bs = [(0.1 * torch.randn((st.cout,), generator=gen,
                                 device="cuda")).to(bf) for st in g.stages]
        kw = dict(group=g, activation="relu")
        with torch.inference_mode():
            fused = tf.trim_conv2d_fused(x, ws, bs, **kw)
            chain = tf.reference_chain(x, ws, bs, **kw)
            plain = tf.trim_conv2d_fused_plain(x, ws, bs, **kw)
        torch.cuda.synchronize()
        ulps = bf16_ulps(torch, fused, plain)
        if fused.dtype != bf or not torch.equal(fused, chain):
            raise AssertionError(f"bf16 fused {net} {g.label}: the group and "
                                 "its bf16 per-layer chain differ bitwise")
        if "mma" not in routes and not ulps <= BF16_ULPS:
            raise AssertionError(f"bf16 fused {net} {g.label}: {ulps} ulps "
                                 "from the plain version")
        xl = x.permute(0, 3, 1, 2).contiguous()
        wl = [w.permute(3, 2, 0, 1).contiguous() for w in ws]
        with torch.inference_mode():
            t = {"fused": time_graph_ms(
                     torch, lambda: tf.trim_conv2d_fused(x, ws, bs, **kw)),
                 "chain": time_graph_ms(
                     torch, lambda: tf.reference_chain(x, ws, bs, **kw)),
                 "library": time_graph_ms(
                     torch, lambda: library_chain(torch, xl, wl, bs, g))}
            t["plain"] = time_ms(torch, lambda: tf.trim_conv2d_fused_plain(
                x, ws, bs, **kw), reps=1) if n == 8 else None
        row = dict(group=g.label, routes=routes, ulps=ulps,
                   err=(fused.float() - plain.float()).abs().max().item(),
                   tiles=g.n_tiles, **t,
                   **bf16_bound(g.flops, g.min_bytes()))
        rows.append(row)
        plain_ms = "-" if t["plain"] is None else f"{t['plain']:.3f}"
        print(f"  bf16 fused {g.label:14s} {'/'.join(routes):14s} "
              f"T={g.strip_rows} B={g.band_cols} blocks {g.n_tiles} smem "
              f"{g.smem_bytes}: == chain True, {ulps:.1f} ulps from plain; "
              f"fused {t['fused']:.4f} ms, chain {t['chain']:.4f}, plain "
              f"{plain_ms}, F.conv2d chain {t['library']:.4f}, bound "
              f"{row['bound']:.4f} ({row['by']}), FFMA ceiling "
              f"{row['ffma']:.4f}")
        del x, ws, bs, fused, chain, plain, xl, wl
    torch.cuda.empty_cache()
    print(f"bf16 fused, {net} batch {n}, sums: fused "
          f"{sum(r['fused'] for r in rows):.4f} ms, chains "
          f"{sum(r['chain'] for r in rows):.4f} ms, F.conv2d chains "
          f"{sum(r['library'] for r in rows):.4f} ms, bound "
          f"{sum(r['bound'] for r in rows):.4f} ms")
    return rows


def serve_bf16(torch, net: str) -> dict:
    """Full-width VGG-16 or AlexNet (1000 classes, seeded random weights
    drawn in f32 and cast to bf16 once) served in bf16 through
    ``ServingEngine`` on buckets (1, 2, 4, 8): the 48-request Poisson trace
    at 200 req/s per layer on the carry entry, its first 16 on halo, the
    48 with ``fused=True`` (the bf16 plan's groups), every row bit-matching
    ``forward_one`` (halo and fused rows the carry rows too); then the
    f32 serving of the same params (bf16 values in f32) on the first 16
    requests, each bf16 row within ``BF16_F32_TOLERANCE`` of max|f32
    row|.  Inputs are rounded to bf16, so both see the same values."""
    from repro_torch.core.model import alexnet_layers, vgg16_layers
    from repro_torch.models.layers import TrimCNN

    topo, size = ((vgg16_layers(), 224) if net == "VGG-16"
                  else (alexnet_layers(), 227))
    rng = np.random.default_rng(28)
    xs = torch.from_numpy(rng.standard_normal(
        (REQUESTS, size, size, 3)).astype(np.float32)).bfloat16() \
        .float().numpy()
    model = TrimCNN.random(topo, n_classes=1000, seed=0, device="cuda",
                           dtype=torch.bfloat16)
    if model.dtype != torch.bfloat16:
        raise AssertionError(f"bf16 {net}: the model is {model.dtype}")
    out = {}
    rows, out["carry"], out["carry_fw"], out["carry_s"] = serve(
        REQUESTS, "carry", model, xs, label=f"bf16 carry, {net}")
    _, out["halo"], out["halo_fw"], out["halo_s"] = serve(
        HALO_REQUESTS, "halo", model, xs, expect=rows,
        label=f"bf16 halo, {net}")
    _, out["fused"], out["fused_fw"], out["fused_s"] = serve(
        REQUESTS, "carry", model, xs, expect=rows, fused=True,
        label=f"bf16 fused, {net}")
    twin = TrimCNN(topo, {k: {p: t.float() for p, t in v.items()}
                          for k, v in model.tree().items()})
    f32_rows, *_ = serve(HALO_REQUESTS, "carry", twin, xs,
                         label=f"f32 twin, {net}")
    devs = [float(np.abs(rows[i] - f32_rows[i]).max()
                  / np.abs(f32_rows[i]).max()) for i in range(HALO_REQUESTS)]
    top1 = np.mean([rows[i].argmax() == f32_rows[i].argmax()
                    for i in range(HALO_REQUESTS)])
    if not max(devs) <= BF16_F32_TOLERANCE:
        raise AssertionError(f"bf16 {net}: logits {max(devs)} of max|f32| "
                             f"from the f32 serving > {BF16_F32_TOLERANCE}")
    out["dev"], out["top1"] = max(devs), float(top1)
    print(f"serve[bf16, {net}]: bf16 logits against the f32 serving of the "
          f"same params: max|diff| / max|f32| {max(devs):.3e} (mean "
          f"{np.mean(devs):.3e}) <= {BF16_F32_TOLERANCE}; top-1 agreement "
          f"{top1:.3f} over {HALO_REQUESTS} requests")
    del model, twin
    torch.cuda.empty_cache()
    return out


def bf16_phase(torch) -> dict:
    """Phase 33 (module docstring): the bf16 SASS check, the bf16 kernel
    checks and tables, then bf16 serving of full-width VGG-16 and AlexNet;
    the launches of the three bf16 entries on the serving paths."""
    out = {"sass": bf16_sass_check(),
           "rows": {n: check_bf16_convs(torch, "VGG-16", n) for n in (8, 1)},
           "alex": {n: check_bf16_convs(torch, "AlexNet", n)
                    for n in (8, 1)},
           "fused": check_bf16_fused(torch, "VGG-16", 8),
           "fused1": check_bf16_fused(torch, "VGG-16", 1),
           "alex_fused": {n: check_bf16_fused(torch, "AlexNet", n)
                          for n in (8, 1)}}
    launches = dict.fromkeys(("carry_bf16", "halo_bf16", "fused_bf16"), 0)
    for net in ("VGG-16", "AlexNet"):
        sv = out[net] = serve_bf16(torch, net)
        for key in ("carry", "halo", "fused"):
            for k in launches:
                launches[k] += sv[key][k]
            if any(sv[key][k] for k in ("carry", "halo", "fused")):
                raise AssertionError(f"bf16 {net} {key}: f32 launches "
                                     f"{sv[key]}")
    out["launches"] = launches
    print(f"bf16: launches of the bf16 entries on the serving paths "
          f"{launches}")
    return out


def check_bf16_conv1d(torch) -> list:
    """The conv1d kernel's bf16 route (``trim_conv1d_bf16``) against its
    plain version, bit for bit, at every case of :func:`conv1d_cases`;
    at the prefills' rows its device ms from CUDA graphs over input
    copies past the L2 beside the plain version's (eager), ``F.conv1d``
    on bf16 (timed the same way), the bound (2 bytes an element at 3.35
    TB/s), the wrapper's host us a call and the plan's geometry."""
    import torch.nn.functional as F
    from repro_torch.kernels import trim_conv1d as tc1

    gen = torch.Generator(device="cuda").manual_seed(30)
    bf = torch.bfloat16
    rows = []
    print("bf16 conv1d kernel check (bitwise vs plain; kernel and F.conv1d "
          "ms from CUDA graphs over input copies past the L2, plain "
          "eager):")
    print(f"  {'case':14s} {'shape':>22s} {'vec':>3s} {'T_l':>4s} "
          f"{'grid':>12s} {'kernel':>8s} {'plain':>8s} {'F.conv1d':>8s} "
          f"{'bound':>8s} {'of bnd':>6s} {'host':>5s}  geometry")
    for name, b, length, d, k, tile_l, strided in conv1d_cases():
        xz = torch.randn((b, length, 2 * d if strided else d),
                         generator=gen, device="cuda").to(bf)
        x = xz[..., :d]
        w = (0.5 * torch.randn((k, d), generator=gen, device="cuda")).to(bf)
        out = tc1.trim_conv1d(x, w, tile_l=tile_l)
        plain = tc1.trim_conv1d_plain(x, w, tile_l=tile_l)
        torch.cuda.synchronize()
        if out.dtype != bf or not torch.equal(out, plain):
            raise AssertionError(
                f"bf16 conv1d {name}: the kernel differs from its plain "
                f"version (max|diff| "
                f"{(out.float() - plain.float()).abs().max().item()})")
        plan = tc1.plan_for(x, w, tile_l)
        bound, by = plan.bound()
        row = dict(name=name, err=0.0, bound=bound, by=by, kernel=None,
                   plain=None, library=None)
        line = (f"  {name:14s} {str((b, length, d, k)):>22s} {plan.vec:3d} "
                f"{plan.tile_l:4d} {str(plan.grid):>12s}")
        if length * d >= 4096 * 2560:       # the prefills' shapes: timed
            xt = x.transpose(1, 2).contiguous()     # (B, D, L) for cuDNN
            wt = w.t()[:, None, :].contiguous()     # (D, 1, K)
            row.update(conv1d_timed(
                torch, plan, lambda a, b: tc1.trim_conv1d(a, b),
                lambda a, b: F.conv1d(a, b, padding=k - 1,
                                      groups=d)[..., :length],
                [x, w], [xt, wt]),
                plain=time_ms(torch, lambda: tc1.trim_conv1d_plain(x, w),
                              reps=3))
            line += (f" {row['kernel']:8.4f} {row['plain']:8.4f} "
                     f"{row['library']:8.4f} {bound:8.4f} "
                     f"{row['of_bound']:6.1%} {row['host_us']:5.1f}  "
                     f"{row['geometry']}")
            del xt, wt
        rows.append(row)
        print(line)
        del xz, x, w, out, plain
    torch.cuda.empty_cache()
    return rows


BF16_ATTENTION_CASES = ("a_prefill", "b_continue", "c_rgemma", "f_d320",
                        "s_enc", "s_cross_short", "s_cross_long")


def half_ulp_excess(torch, out, want) -> float:
    """How far a bf16 result lies from its float64 oracle ``want`` beyond
    the half ulp of bf16 that its one rounding may add, of max|want|:
    what the f32 arithmetic before that rounding lost."""
    of = out.float()
    _, e = torch.frexp(of)
    half = torch.where(of == 0, torch.zeros_like(of),
                       torch.ldexp(torch.ones_like(of), e - 9))
    excess = ((of.double() - want).abs() - half.double()).max().item()
    scale = want.abs().max().item()
    del of, e, half
    return excess / scale


def flash_bf16_f64_excess(torch, out, q, k, v, kw) -> float:
    """:func:`half_ulp_excess` of a bf16 attention output against the
    float64 plain version."""
    from repro_torch.kernels import flash_attention as fa
    want = fa.flash_attention_plain(q.double(), k.double(), v.double(),
                                    **kw)
    excess = half_ulp_excess(torch, out, want)
    del want
    return excess


def flash_bwd_bf16_emulated(torch, q, k, v, do, kw, *, p_terms: int = 2,
                            ds_terms: int = 2):
    """The bf16 backward kernels' arithmetic in f32 (one softmax over all
    keys, cuBLAS products without TF32) -> (dq, dk, dv) bf16: S and dP of
    the exact bf16 operands, P = softmax, delta = sum P dP, dS = P (dP -
    delta) (times 1 - tanh^2 under a soft cap), dV = P^T dO, dK = dS^T Q
    scale, dQ = dS K scale, with P and dS each taken as its hi and lo bf16
    halves (``p_terms`` / ``ds_terms`` 2, the kernels' split) or as hi
    alone (1: one bf16 rounding), each gradient rounded once.  The float64
    gate (``FLASH_BWD_BF16_F64_EXCESS``) must pass the split and refuse
    one rounding."""
    import math
    from repro_torch.kernels import flash_attention as fa
    b, lq, hq, d = q.shape
    lk, hkv = k.shape[1], k.shape[2]
    scale = 1.0 / math.sqrt(d)
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        qg = q.float().reshape(b, lq, hkv, hq // hkv, d)
        dog = do.float().reshape(b, lq, hkv, hq // hkv, d)
        y = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
        chain = None
        if kw["soft_cap"] is not None:
            th = torch.tanh(y / kw["soft_cap"])
            y, chain = kw["soft_cap"] * th, 1.0 - th * th
        mask = fa._mask(torch.arange(lq, device=q.device) + lk - lq, 0, lk,
                        kw["causal"], kw["window"])
        p = torch.softmax(torch.where(mask, y, float("-inf")), dim=-1)
        del y
        dp = torch.einsum("bqhgd,bkhd->bhgqk", dog, v.float())
        ds = p * (dp - (p * dp).sum(-1, keepdim=True))
        del dp
        if chain is not None:
            ds = ds * chain
            del chain

        def halves(t, n):
            hi = t.bfloat16().float()
            return [hi, (t - hi).bfloat16().float()][:n]
        dv = sum(torch.einsum("bhgqk,bqhgd->bkhd", t, dog)
                 for t in halves(p, p_terms))
        del p
        dk = sum(torch.einsum("bhgqk,bqhgd->bkhd", t, qg)
                 for t in halves(ds, ds_terms)) * scale
        dq = sum(torch.einsum("bhgqk,bkhd->bqhgd", t, k.float())
                 for t in halves(ds, ds_terms)) * scale
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow
    return (dq.reshape(b, lq, hq, d).bfloat16(), dk.bfloat16(),
            dv.bfloat16())


def check_bf16_flash(torch) -> list:
    """The flash kernel's bf16 route (``flash_attention_bf16``) at cases
    (a), (b), (c) and (f) of :func:`attention_cases` against its plain
    version within ``FLASH_BF16_TOLERANCE`` of max|o| (the deviation
    printed), against the float64 plain version within half an ulp of
    bf16 plus ``FLASH_BF16_F64_EXCESS`` of max|o| (f32 inside: the P
    split; one bf16 P fails it), repeatable bitwise; device ms from CUDA
    graphs beside the
    plain version's (eager), ``F.scaled_dot_product_attention`` on bf16
    at (a), (b) and (f) (queries right-aligned: (b) through an explicit
    mask; (f), D 320, on SDPA's math backend; none at (c), soft cap), the
    bound at 989 TFLOP/s or 2 bytes
    an element at 3.35 TB/s, and the kernel's own route's ceiling (its
    bf16 mma since PR 33, Q K^T once and P's two halves against V: 1.5 x
    FLOPs at 989 TFLOP/s for D <= 256; f32 FFMA above)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(31)
    bf = torch.bfloat16
    rows = []
    print("bf16 attention kernel check (ms: kernel and SDPA from CUDA "
          "graphs, plain eager):")
    print(f"  {'case':12s} {'max_err':>9s} {'of max|o|':>9s} "
          f"{'f64_exc':>9s} {'kernel':>9s} {'plain':>9s} {'sdpa':>9s} "
          f"{'bound':>8s} by    {'route_b':>8s} TFLOP/s")
    for name, b, lq, lk, hq, hkv, d, causal, cap, win in attention_cases():
        if name not in BF16_ATTENTION_CASES:
            continue
        q = torch.randn((b, lq, hq, d), generator=gen, device="cuda").to(bf)
        k = torch.randn((b, lk, hkv, d), generator=gen, device="cuda").to(bf)
        v = torch.randn((b, lk, hkv, d), generator=gen, device="cuda").to(bf)
        kw = dict(causal=causal, soft_cap=cap, window=win)
        out = fa.flash_attention(q, k, v, **kw)
        again = fa.flash_attention(q, k, v, **kw)
        plain = fa.flash_attention_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        err = (out.float() - plain.float()).abs().max().item()
        rel = err / plain.float().abs().max().item()
        if out.dtype != bf or not np.isfinite(err) or \
                rel > FLASH_BF16_TOLERANCE or not torch.equal(out, again):
            raise AssertionError(f"bf16 attention {name}: {rel:.3e} of "
                                 f"max|o| from the plain version (tol "
                                 f"{FLASH_BF16_TOLERANCE}), or not "
                                 "repeatable")
        excess = flash_bf16_f64_excess(torch, out, q, k, v, kw)
        if not excess <= FLASH_BF16_F64_EXCESS:
            raise AssertionError(f"bf16 attention {name}: {excess:.3e} of "
                                 "max|o| from the float64 plain version "
                                 "past half an ulp (tol "
                                 f"{FLASH_BF16_F64_EXCESS:.3e})")
        t = {"kernel": time_graph_ms(torch, lambda: fa.flash_attention(
                q, k, v, **kw), reps=5),
             "plain": time_ms(torch, lambda: fa.flash_attention_plain(
                 q, k, v, **kw), reps=2),
             "library": None}
        if name in ("a_prefill", "b_continue", "f_d320"):
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            q_pos = torch.arange(lq, device="cuda")[:, None] + lk - lq
            mask = None if lq == lk else \
                q_pos >= torch.arange(lk, device="cuda")[None, :]
            t["library"] = time_graph_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, is_causal=mask is None,
                enable_gqa=True), reps=5)
        _, _, flops, nbytes, ffma = attention_bound(b, lq, lk, hq, hkv, d,
                                                    causal, win)
        bd = bf16_bound(flops, nbytes // 2)
        route = (1.5 * flops / PEAK_BF16_FLOPS * 1e3 if d <= 256 else ffma)
        rows.append(dict(name=name, err=err, rel=rel, excess=excess,
                         bound=bd["bound"], by=bd["by"], route_bound=route,
                         **t))
        lib = "-" if t["library"] is None else f"{t['library']:9.3f}"
        print(f"  {name:12s} {err:9.2e} {rel:9.2e} {excess:9.2e} "
              f"{t['kernel']:9.3f} "
              f"{t['plain']:9.3f} {lib:>9s} {bd['bound']:8.3f} "
              f"{bd['by']:5s} {route:8.3f} {flops / t['kernel'] / 1e9:7.2f}")
        del q, k, v, out, again, plain
    torch.cuda.empty_cache()
    return rows


def widened(tree):
    """A parameter tree's f32 twin: every leaf ``.float()`` (exact)."""
    if isinstance(tree, dict):
        return {k: widened(v) for k, v in tree.items()}
    return tree.float()


def bf16_layer_check(torch, cfg, params, tokens) -> list:
    """The first ``LM_BF16_CUT`` layers along the bf16 forward: each
    sublayer (attention, MLP, the rec or mamba mixer) run in bf16 and in
    f32 (the layer's params widened) on the same bf16 input.  Checked:
    the MLPs and mixers within ``LM_BF16_TOLERANCE`` of max|f32 out|; an
    attention sublayer's core, the bf16 flash kernel against the f32
    kernel on the same bf16-rounded q, k and v, within
    ``FLASH_BF16_TOLERANCE`` of max|o|.  Printed: the attention
    sublayer's whole bf16 vs f32 distance, where bf16's rounding of q
    and k (~2^-8 of scores of ~2000 under the JAX initialiser, PERF.md
    §6) reorders near-tied softmax rows.  Returns [(layer, name, error,
    checked)]."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import layers as L
    from repro_torch.models import mamba as M
    from repro_torch.models import rglru as R
    from repro_torch.models import transformer as T
    c32 = cfg.replace(dtype="float32")
    pos = torch.arange(tokens.shape[1], device="cuda")[None]
    out = []

    def rel(a, b):
        return ((a.float() - b.float()).abs().max()
                / b.float().abs().max()).item()

    def check(i, name, fn, pb, pf, h):
        yb, yf = fn(pb, h, cfg), fn(pf, h.float(), c32)
        err = rel(yb, yf)
        if yb.dtype != torch.bfloat16 or not np.isfinite(err) or \
                err > LM_BF16_TOLERANCE:
            raise AssertionError(f"{cfg.name} bf16 layer {i} {name}: "
                                 f"{err:.3e} of max|f32| (tol "
                                 f"{LM_BF16_TOLERANCE})")
        out.append((i, name, err, True))
        return yb

    def attention(i, pb, pf, h, window):
        ab = L.attention_apply(pb, h, cfg, positions=pos, window=window)
        af = L.attention_apply(pf, h.float(), c32, positions=pos,
                               window=window)
        out.append((i, "attention sublayer", rel(ab, af), False))
        q = L.rope(torch.einsum("bld,dhk->blhk", h, pb["wq"]), pos,
                   cfg.rope_theta)
        k = L.rope(torch.einsum("bld,dhk->blhk", h, pb["wk"]), pos,
                   cfg.rope_theta)
        v = torch.einsum("bld,dhk->blhk", h, pb["wv"])
        kw = dict(causal=True, soft_cap=cfg.logits_soft_cap, window=window)
        ob = fa.flash_attention(q, k, v, **kw)
        of = fa.flash_attention(q.float(), k.float(), v.float(), **kw)
        err = rel(ob, of)
        if not np.isfinite(err) or err > FLASH_BF16_TOLERANCE:
            raise AssertionError(f"{cfg.name} bf16 layer {i}: the bf16 "
                                 f"flash kernel {err:.3e} of max|o| from "
                                 "the f32 kernel on the same q, k, v (tol "
                                 f"{FLASH_BF16_TOLERANCE})")
        out.append((i, "flash bf16 vs f32 kernel", err, True))
        return ab

    with torch.no_grad():
        x = L.embed_apply(params["tok"], tokens, cfg)
        if cfg.family == "hybrid":
            blocks = [params["blocks"][f"layer_{i}"]
                      for i in range(LM_BF16_CUT)]
        else:
            blocks = T.layer_list(params["blocks"],
                                  cfg.n_layers)[:LM_BF16_CUT]
        for i, pb in enumerate(blocks):
            pf = widened(pb)
            if cfg.family == "ssm":
                check(i, "mamba mixer", M.mixer_apply, pb["mixer"],
                      pf["mixer"], L.norm_apply(pb["ln"], x, cfg))
                x = M.block_apply(pb, x, cfg)
                continue
            ln = "ln_att" if cfg.family == "dense" else "ln_mix"
            h = L.norm_apply(pb[ln], x, cfg)
            if "rec" in pb:
                y = check(i, "rec mixer", R.rec_mixer_apply, pb["rec"],
                          pf["rec"], h)
            else:
                y = attention(i, pb["att"], pf["att"], h, cfg.window)
            z = L.norm_apply(pb["ln_mlp"], x + y, cfg)
            check(i, "MLP", L.mlp_apply, pb["mlp"], pf["mlp"], z)
            x = (T.block_apply(pb, x, cfg, positions=pos)[0]
                 if cfg.family == "dense"
                 else R.block_apply(pb, x, cfg, positions=pos))
            del pf, h, y, z
    torch.cuda.empty_cache()
    return out


def bf16_requests(torch, cfg, params) -> dict:
    """``BF16_REQUESTS`` prompts of ``BF16_PROMPT`` tokens, then
    ``BF16_GEN`` greedy tokens, one token a step through
    ``steps.make_decode_step`` on a bf16 decode state (the f32 scan
    states pinned); ms a step (host clock, synchronised at the end)."""
    from repro_torch.distributed import steps
    from repro_torch.models import api
    from repro_torch.models.base import init_params
    rng = np.random.default_rng(30)
    b, n = BF16_REQUESTS, BF16_PROMPT + BF16_GEN
    prompts = torch.from_numpy(rng.integers(
        2, cfg.vocab, (b, BF16_PROMPT))).cuda()
    state = init_params(api.decode_state(cfg, b, n), torch.Generator(),
                        device="cuda", dtype=torch.bfloat16)
    decode = steps.make_decode_step(cfg)
    toks = [prompts[:, 0]]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(n - 1):
        tok = prompts[:, t] if t < BF16_PROMPT else toks[-1]
        nxt, state = decode(params, state, {
            "tokens": tok[:, None],
            "cache_len": torch.full((b,), t + 1, dtype=torch.int32,
                                    device="cuda")})
        toks.append(prompts[:, t + 1] if t + 1 < BF16_PROMPT else nxt)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / (n - 1)
    gen = torch.stack(toks[BF16_PROMPT:], dim=1)
    if tuple(gen.shape) != (b, BF16_GEN) or int(gen.min()) < 0 or \
            int(gen.max()) >= cfg.vocab:
        raise AssertionError(f"{cfg.name} bf16 requests: bad tokens "
                             f"{tuple(gen.shape)}")
    def leaves(tree):
        if isinstance(tree, dict):
            for v in tree.values():
                yield from leaves(v)
        else:
            yield tree
    if not all(bool(torch.isfinite(t.float()).all()) for t in leaves(state)):
        raise AssertionError(f"{cfg.name} bf16 requests: a state leaf is "
                             "not finite")
    return dict(ms_step=ms, tokens=gen.tolist())


def lm_bf16_model(torch, arch, batch, seq, f32) -> dict:
    """One model of the lm_bf16 phase (module docstring): full-width
    params drawn in bf16 on the card, two timed bf16 prefills through
    ``make_prefill_step`` (the launches of each route counted from 0),
    the f32 twin's logits distance (printed), the per-layer check at the
    depth cut and a few greedy requests through bf16 decode steps."""
    from repro_torch.configs import registry
    from repro_torch.distributed import steps
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import trim_conv1d as tc1
    from repro_torch.models import api
    from repro_torch.models.base import init_params

    cfg = registry.get(arch).CONFIG.replace(dtype="bfloat16")
    t0 = time.perf_counter()
    params = init_params(api.params(cfg), torch.Generator(device="cuda")
                         .manual_seed(0), device="cuda",
                         dtype=torch.bfloat16)
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    rng = np.random.default_rng(30)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab,
                                           (batch, seq))).cuda()
    prefill = steps.make_prefill_step(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tc1.reset_launch_counts()
    fa.reset_launch_counts()
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        logits, nxt = prefill(params, {"tokens": tokens})
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = {**tc1.LAUNCHES, **fa.LAUNCHES}
    peak = torch.cuda.max_memory_allocated() / 2**30
    n_att = sum(cfg.pattern_at(i) == "att" for i in range(cfg.n_layers)) \
        if cfg.family != "ssm" else 0
    want = {"trim_conv1d": 0, "flash_attention": 0,
            "trim_conv1d_bf16": 2 * (cfg.n_layers - n_att),
            "flash_attention_bf16": 2 * n_att}
    if launches != want:
        raise AssertionError(f"{arch} bf16 prefill: launches {launches} in "
                             f"2 forwards, want {want}")
    if logits.dtype != torch.bfloat16 or \
            tuple(logits.shape) != (batch, seq, cfg.vocab) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{arch} bf16 prefill: logits "
                             f"{tuple(logits.shape)} {logits.dtype}, not "
                             "finite or of the wrong shape or type")
    last = logits[:, -1].float()
    del logits
    torch.cuda.empty_cache()
    twin = widened(params)
    with torch.no_grad():
        f32_logits, f32_nxt = steps.make_prefill_step(
            cfg.replace(dtype="float32"))(twin, {"tokens": tokens})
    f32_last = f32_logits[:, -1]
    del twin, f32_logits
    torch.cuda.empty_cache()
    dist = ((last - f32_last).abs().max() / f32_last.abs().max()).item()
    layers = bf16_layer_check(torch, cfg, params, tokens)
    req = bf16_requests(torch, cfg, params)
    print(f"lm_bf16 {arch}: {registry.count_params(cfg):,} parameters drawn "
          f"in bf16 on the card in {draw_s:.2f} s; prefill {batch} x {seq} "
          f"{times[1]:.1f} ms a forward (first {times[0]:.1f} ms; f32 "
          f"{f32['ms']:.1f} ms, peak {f32['peak']:.2f} GiB, this call), peak "
          f"{peak:.2f} GiB; launches in 2 forwards {launches}; last-position "
          f"logits vs the f32 twin (the same bf16 weights widened) "
          f"{dist:.3e} of max|f32| (printed), next tokens {nxt.tolist()} vs "
          f"{f32_nxt.tolist()}")
    print(f"lm_bf16 {arch}: first {LM_BF16_CUT} layers, bf16 vs f32 on the "
          "same bf16 input (checked *): " + ", ".join(
              f"{i}:{name} {err:.2e}{'*' if chk else ''}"
              for i, name, err, chk in layers))
    print(f"lm_bf16 {arch}: {BF16_REQUESTS} requests, {BF16_PROMPT}-token "
          f"prompts, {BF16_GEN} greedy tokens through bf16 decode steps: "
          f"{req['ms_step']:.2f} ms a step (f32 serve_batch {f32['step_ms']:.2f} "
          f"ms a step at batch {SERVE_BATCH}, this call); tokens "
          f"{req['tokens']}")
    del params, last, f32_last
    torch.cuda.empty_cache()
    return dict(ms=times[1], first_ms=times[0], peak=peak,
                launches=launches, dist=dist, layers=layers, **req)


def lm_bf16_phase(torch, f32: dict) -> dict:
    """Phase 34 (module docstring): the bf16 routes of the conv1d and
    flash kernels against their plain versions, then full-width
    qwen2.5-3b, recurrentgemma-2b and falcon-mamba-7b prefilled and
    decoded in bf16.  ``f32``: each model's f32 figures of this call."""
    out = {"conv1d": check_bf16_conv1d(torch),
           "flash": check_bf16_flash(torch)}
    for arch, batch, seq in (("qwen2.5-3b", PREFILL_BATCH, PREFILL_SEQ),
                             ("recurrentgemma-2b", RGEMMA_BATCH,
                              RGEMMA_SEQ),
                             ("falcon-mamba-7b", MAMBA_BATCH, MAMBA_SEQ)):
        out[arch] = lm_bf16_model(torch, arch, batch, seq, f32[arch])
    out["launches"] = {
        key: sum(out[a]["launches"][key] for a in f32)
        for key in ("trim_conv1d_bf16", "flash_attention_bf16")}
    print(f"lm_bf16: launches of the bf16 routes on the three prefills "
          f"{out['launches']}")
    return out


def device_share(torch, fn, n: int = 2) -> dict:
    """``fn``'s device time against its host time, over ``n`` calls
    after a warm-up (``torch.profiler``): device ms and wall ms a call
    (host clock to synchronize), kernels a call, and the five kernels of
    most device time (ms a call)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time / 1e3 / n
    top = sorted(by_name.items(), key=lambda t: -t[1])[:5]
    return dict(device_ms=sum(e.device_time for e in kernels) / 1e3 / n,
                wall_ms=wall / n, kernels=len(kernels) / n, top=top)


def train_bf16(torch, f32: dict) -> dict:
    """Phase 38 (module docstring): full-width VGG-16 drawn in bf16 and
    trained through ``launch.train_cnn.train_step``; ``f32`` is the train
    phase's ``{"times", "peak"}`` of this call.  Returns the launches of
    the timed steps, ms a step, the peak and each step-1 leaf's distance
    from the f32 step on the same values (on the kernels, on the plain
    versions)."""
    from repro_torch.core.model import vgg16_layers
    from repro_torch.kernels import ops
    from repro_torch.kernels import trim_conv2d as tc
    from repro_torch.launch.train_cnn import train_step
    from repro_torch.models.layers import TrimCNN
    from repro_torch.optim import AdamWConfig, adamw

    topo = vgg16_layers()
    model = TrimCNN.random(topo, n_classes=1000, seed=0, device="cuda",
                           dtype=torch.bfloat16, trainable=True)
    if model.dtype != torch.bfloat16:
        raise AssertionError(f"train_bf16: the model is {model.dtype}")
    cfg = AdamWConfig()
    # the train phase's draws: the same seed, its first steps' batches
    rng = np.random.default_rng(1)
    batches = [
        (torch.from_numpy(rng.standard_normal(
            (TRAIN_BATCH, 224, 224, 3)).astype(np.float32)).cuda(),
         torch.from_numpy(rng.integers(0, 1000, TRAIN_BATCH)).cuda())
        for _ in range(BF16_TRAIN_STEPS)]
    bf_batches = [(x.bfloat16(), y) for x, y in batches]
    params = {k: {n: t.detach() for n, t in v.items()}
              for k, v in model.tree().items()}
    names = [f"{k}.{n}" for k in sorted(params) for n in sorted(params[k])]

    # step 1's gradients on the kernels, on the plain versions (every conv
    # kernel swapped out: the fmaf chain) and on the f32 kernels for the
    # same values widened.  VGG-16's conv2-13 and their input gradients
    # run on the bf16 tensor cores (route mma), whose additions the fmaf
    # chain does not repeat, so no leaf is bitwise the plain step's; each
    # leaf of the kernels' step (and the loss) lies at most twice as far
    # from the f32 step as the plain step's does, plus one bf16 ulp of the
    # leaf's max: the plain step's distance is the bf16 arithmetic's own
    x0, y0 = bf_batches[0]
    tc.reset_launch_counts()
    loss_k, g_k = grads(model.apply_tree, params, x0, y0)
    torch.cuda.synchronize()
    if dict(tc.LAUNCHES) != launch_counts(carry_bf16=25, wgrad_bf16=13):
        raise AssertionError(f"train_bf16: step-1 gradients launched "
                             f"{dict(tc.LAUNCHES)}")
    t0 = time.perf_counter()
    with swapped(ops, **tc.plain_versions()):
        tc.reset_launch_counts()
        loss_p, g_p = grads(model.apply_tree, params, x0, y0)
        torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    if any(tc.LAUNCHES.values()):
        raise AssertionError(f"train_bf16: the plain step launched "
                             f"{dict(tc.LAUNCHES)}")
    p32 = {k: {n: t.float() for n, t in v.items()}
           for k, v in params.items()}
    loss32, g32 = grads(model.apply_tree, p32, x0.float(), y0)
    torch.cuda.synchronize()

    def dist(a, b):
        return (a.float() - b).abs().max().item() / max(
            b.abs().max().item(), 2.0 ** -126)
    rows = [("loss", loss_k, loss_p, loss32)] + list(zip(names, g_k, g_p,
                                                         g32))
    dist_k, dist_p, dist_kp = {}, {}, {}
    for name, a, b, f in rows:
        if name != "loss" and a.dtype != torch.bfloat16:
            raise AssertionError(f"train_bf16: {name}'s gradient is "
                                 f"{a.dtype}")
        dist_k[name], dist_p[name] = dist(a, f), dist(b, f)
        dist_kp[name] = dist(a, b.float())
        if not dist_k[name] <= 2 * dist_p[name] + 2.0 ** -8:
            raise AssertionError(
                f"train_bf16: {name} lies {dist_k[name]:.3e} of its max from "
                f"the f32 step, the plain step {dist_p[name]:.3e}: beyond "
                "twice that plus one bf16 ulp")
    worst = sorted(dist_k, key=lambda n: -dist_k[n])
    print(f"train_bf16: step-1 loss {loss_k.item():.6f} (plain "
          f"{loss_p.item():.6f}, f32 on the same values "
          f"{loss32.item():.6f}); launches "
          f"{launch_counts(carry_bf16=25, wgrad_bf16=13)}; each leaf's "
          "max|diff| / max|f32 step's| on the kernels (on the plain "
          f"versions, {plain_s:.1f} s; kernels against plain): " + ", ".join(
              f"{n} {dist_k[n]:.2e} ({dist_p[n]:.2e}; {dist_kp[n]:.2e})"
              for n in worst) + " -- each within twice the plain step's "
          "distance plus 2^-8")
    del g_p, g32, p32, g_k
    torch.cuda.empty_cache()

    moments = adamw.init_moments(params, cfg)
    state0 = (params, moments)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, launches, step1 = timed_train_steps(
        torch, model, state0, cfg, bf_batches, log=True, suffix="_bf16")
    peak = torch.cuda.max_memory_allocated() / 2**30
    again, _, _, _ = train_step(*state0, 0, *bf_batches[0],
                                apply_fn=model.apply_tree, cfg=cfg)
    if not all(torch.equal(a, b) for a, b in zip(
            adamw.tree_leaves(again), adamw.tree_leaves(step1))):
        raise AssertionError("train_bf16: step 1 from the same state gave "
                             "different parameters")
    ms = float(np.mean(times[1:]))
    f32_ms = float(np.mean(f32["times"][1:BF16_TRAIN_STEPS]))
    # where a step's time goes: its kernels' device time against the host
    share = device_share(torch, lambda: train_step(
        *state0, 0, *bf_batches[0], apply_fn=model.apply_tree, cfg=cfg))
    print(f"train_bf16: a profiled step (torch.profiler, 2 steps): device "
          f"{share['device_ms']:.2f} ms of {share['wall_ms']:.2f} ms wall "
          f"({100 * share['device_ms'] / share['wall_ms']:.1f}% busy), "
          f"{share['kernels']:.0f} kernels a step; most device time: "
          + "; ".join(f"{n[:60]} {t:.3f} ms" for n, t in share["top"]))
    print(f"train_bf16: VGG-16 full width in bf16, batch {TRAIN_BATCH}: "
          f"{ms:.1f} ms per step (mean of steps 2-{BF16_TRAIN_STEPS}, host "
          f"clock to synchronize; step 1 {times[0]:.1f} ms), peak device "
          f"memory {peak:.2f} GiB; the f32 train phase of this call "
          f"{f32_ms:.1f} ms over the same steps, peak {f32['peak']:.2f} "
          "GiB; step 1 repeated from the same state is bitwise equal")
    del model, params, moments, state0, step1, again
    torch.cuda.empty_cache()
    return {"launches": launches, "ms": ms, "times": times, "peak": peak,
            "f32_ms": f32_ms, "dist": dist_k, "plain_dist": dist_p,
            "share": share}


def conv1d_fwd_rows():
    """(name, b, length, d, k, strided): the rows the conv1d forward
    kernel is timed at, (a) falcon-mamba-7b's prefill (the mixer's strided
    half of the in-projection) and (b) recurrentgemma-2b's prefill (the
    rec mixer's contiguous (B, L, lru_width))."""
    return [("a_mamba_prefill", 2, 2048, 8192, 4, True),
            ("b_rgemma_prefill", 2, 4096, 2560, 4, False)]


def conv1d_wgrad_rows():
    """(name, b, length, d, k, strided): the two training rows of the
    conv1d weight gradient, recurrentgemma-2b's (the rec mixer's (B, L,
    lru_width)) and falcon-mamba-7b's (the mixer's strided half of the
    in-projection)."""
    return [("rg_train", 1, 4096, 2560, 4, False),
            ("mamba_view", 2, 1024, 8192, 4, True)]


def host_us(torch, fn, calls: int = 200) -> float:
    """The host's microseconds a call of ``fn`` (a kernel wrapper): calls
    issued back to back, timed on the host's clock before the card
    catches up (the launch queue holds them), then synchronized."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def check_conv1d_wgrad(torch) -> list:
    """The redesigned weight-gradient kernel (``trim_conv1d_wgrad_f32``
    and ``_bf16``) at both training rows: bitwise its plain
    version (the plan's runs and groups replayed) and over two calls;
    device ms from CUDA graphs over input copies that outgrow the L2
    (:func:`rotating`) and from events around the wrapper (the earlier
    PRs' timing, which the wrapper's host time bounds: its host us a
    call printed), the plain version's (eager), the byte bound,
    ``torch.nn.grad.conv1d_weight``'s on the same dtype (TF32 off), the
    bytes the schedule moves and the achieved rate; in bf16 also the
    input gradient's route (``trim_conv1d_bf16`` on the reversed
    cotangent) bitwise its plain version, its time, bound and
    ``torch.nn.grad.conv1d_input``'s."""
    import torch.nn.functional as F
    from repro_torch.kernels import trim_conv1d as tc1

    gen = torch.Generator(device="cuda").manual_seed(34)
    rows = []
    print("conv1d wgrad check (bitwise vs plain and over two calls; ms: "
          "graph = CUDA graph device time over input copies that outgrow "
          "the L2, events = around the wrapper, host = the wrapper's host "
          "us a call; bound: the least bytes at 3.35 TB/s):")
    print(f"  {'case':11s} {'dtype':8s} {'vec':>3s} {'T_l':>4s} "
          f"{'blocks':>6s} {'graph':>8s} {'events':>8s} {'host':>6s} "
          f"{'plain':>8s} "
          f"{'library':>8s} {'bound':>8s} {'of bnd':>6s} {'MB moved':>8s} "
          f"{'TB/s':>5s}")
    allow = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for name, b, length, d, k, strided in conv1d_wgrad_rows():
            for dt in (torch.float32, torch.bfloat16):
                xz = torch.randn((b, length, 2 * d if strided else d),
                                 generator=gen, device="cuda").to(dt)
                x = xz[..., :d]
                dy = torch.randn((b, length, d), generator=gen,
                                 device="cuda").to(dt)
                w = (0.5 * torch.randn((k, d), generator=gen,
                                       device="cuda")).to(dt)
                plan = tc1._wgrad_plan(x, dy, k, None)
                tc1.reset_launch_counts()
                dw = tc1.trim_conv1d_weight_grad(x, dy, k)
                dw2 = tc1.trim_conv1d_weight_grad(x, dy, k)
                pdw = tc1.trim_conv1d_wgrad_plain(x, dy, k,
                                                  tile_l=plan.tile_l)
                torch.cuda.synchronize()
                key = "trim_conv1d_wgrad" + (
                    "_bf16" if dt == torch.bfloat16 else "")
                counts = dict(tc1.BWD_LAUNCHES)
                if not (torch.equal(dw, pdw) and torch.equal(dw, dw2)
                        and dw.dtype == dt and counts[key] == 2):
                    raise AssertionError(
                        f"conv1d wgrad {name} {dt}: vs plain "
                        f"{(dw.float() - pdw.float()).abs().max().item()}, "
                        f"repeat {torch.equal(dw, dw2)}, launches {counts}")
                xt = x.transpose(1, 2).contiguous()      # (B, D, L)
                wt = w.t()[:, None, :].contiguous()      # (D, 1, K)
                gt = F.pad(dy.transpose(1, 2), (0, k - 1)).contiguous()
                one = 2 * x.numel() * x.element_size()

                def kernel_copy():
                    cx, cy = xz.clone()[..., :d], dy.clone()
                    return lambda: tc1.trim_conv1d_weight_grad(cx, cy, k)

                def library_copy():
                    cx, cg = xt.clone(), gt.clone()
                    return lambda: torch.nn.grad.conv1d_weight(
                        cx, wt.shape, cg, padding=k - 1, groups=d)
                row = dict(
                    name=name, dtype=str(dt).split(".")[1], vec=plan.vec,
                    tile_l=plan.tile_l, blocks=plan.blocks,
                    groups=plan.groups, bound=plan.bound(),
                    hbm=plan.hbm_bytes()["total"], least=plan.min_bytes(),
                    err=0.0,
                    ms=time_graph_ms(torch, rotating(kernel_copy, one),
                                     reps=20),
                    events=time_ms(torch, lambda: tc1.trim_conv1d_weight_grad(
                        x, dy, k), reps=20),
                    host_us=host_us(torch, lambda: tc1.
                                    trim_conv1d_weight_grad(x, dy, k)),
                    plain=time_ms(torch, lambda: tc1.trim_conv1d_wgrad_plain(
                        x, dy, k), reps=2),
                    library=time_graph_ms(torch, rotating(library_copy, one),
                                          reps=20))
                if dt == torch.bfloat16:
                    dplan = tc1.plan_for(dy, w)
                    dx = tc1.trim_conv1d_input_grad(dy, w)
                    pdx = tc1.trim_conv1d_input_grad_plain(dy, w)
                    torch.cuda.synchronize()
                    if not (torch.equal(dx, pdx) and dx.dtype == dt and
                            tc1.BWD_LAUNCHES["trim_conv1d_dx_bf16"]
                            == 1):
                        raise AssertionError(
                            f"conv1d dx bf16 {name}: vs plain "
                            f"{(dx.float() - pdx.float()).abs().max().item()}"
                            f", launches {tc1.BWD_LAUNCHES}")
                    dxt = conv1d_timed(
                        torch, dplan,
                        lambda g, v: tc1.trim_conv1d_input_grad(g, v),
                        lambda g, v: torch.nn.grad.conv1d_input(
                            xt.shape, v, g, padding=k - 1, groups=d),
                        [dy, w], [gt, wt])
                    row.update(
                        dx=dxt["kernel"], dx_library=dxt["library"],
                        dx_host_us=dxt["host_us"],
                        dx_geometry=dxt["geometry"],
                        dx_plain=time_ms(torch, lambda: tc1.
                                         trim_conv1d_input_grad_plain(dy, w),
                                         reps=2),
                        dx_bound=dplan.bound(), dx_vec=dplan.vec)
                    del dx, pdx
                rows.append(row)
                rate = row["least"] / (row["ms"] * 1e-3) / 1e12
                print(f"  {name:11s} {row['dtype']:8s} {plan.vec:3d} "
                      f"{plan.tile_l:4d} {plan.blocks:6d} {row['ms']:8.4f} "
                      f"{row['events']:8.4f} {row['host_us']:6.1f} "
                      f"{row['plain']:8.3f} "
                      f"{row['library']:8.4f} {row['bound'][0]:8.4f} "
                      f"{row['bound'][0] / row['ms']:6.1%} "
                      f"{row['hbm'] / 1e6:8.1f} {rate:5.2f}"
                      + (f"  dx: {row['dx']:.4f} ms (plain "
                         f"{row['dx_plain']:.3f}, conv1d_input "
                         f"{row['dx_library']:.4f}, bound "
                         f"{row['dx_bound'][0]:.4f}, "
                         f"{row['dx_bound'][0] / row['dx']:.1%} of it, host "
                         f"{row['dx_host_us']:.1f} us, "
                         f"{row['dx_geometry']})"
                         if "dx" in row else ""))
                del xz, x, dy, w, dw, dw2, pdw, xt, wt, gt
    finally:
        torch.backends.cudnn.allow_tf32 = allow
    torch.cuda.empty_cache()
    return rows


def flash_bwd_bounds_bf16(b, lq, lk, hq, hkv, d, causal, window) -> dict:
    """{part: (ms, bound_by)} of the bf16 backward: the FLOPs of
    :func:`flash_bwd_bounds` (10 D a valid pair for the whole backward,
    8 D dK/dV, 6 D dQ) over 989 TFLOP/s of the dense bf16 tensor cores,
    against the bytes (2 an element of q, k, v, dO and the gradients, 4 of
    lse and the statistics) over 3.35 TB/s; ``sum``: the G heads' f32
    partials read once and bf16 dK and dV written once."""
    q_pos = np.arange(lq) + lk - lq
    hi = np.minimum(q_pos + 1, lk) if causal else np.full(lq, lk)
    lo = np.maximum(q_pos - window + 1, 0) if window else np.zeros(lq)
    pairs = int(np.maximum(hi - lo, 0).sum()) * b * hq
    rows, keys, stats = b * lq * hq * d, b * lk * hkv * d, b * hq * lq
    parts = {"backward": (10, 2 * (3 * rows + 4 * keys) + 4 * stats),
             # dK / dV: f32 partials of the G heads, or bf16 for G = 1
             "dkdv": (8, 2 * (2 * rows + 2 * keys) + 4 * 2 * stats
                      + (2 * 2 * keys if hq == hkv
                         else 4 * 2 * keys * (hq // hkv))),
             "dq": (6, 2 * (3 * rows + 2 * keys) + 4 * 3 * stats)}
    out = {}
    for part, (per_pair, nbytes) in parts.items():
        flops = per_pair * d * pairs
        ops_ms = flops / PEAK_BF16_FLOPS * 1e3
        bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
        out[part] = (max(ops_ms, bytes_ms),
                     "operations" if ops_ms >= bytes_ms else "bytes")
        out[f"{part}_flops"] = flops
    g = hq // hkv
    bytes_ms = (4 * 2 * g + 2 * 2) * keys / PEAK_BYTES_PER_S * 1e3
    out["sum"] = (bytes_ms, "bytes")
    return out


def check_bf16_flash_bwd(torch) -> list:
    """The flash backward's bf16 route (``flash_attention_bwd_dq_bf16``,
    ``_dkdv_bf16``, ``_sum_bf16``) at cases (t) and (c) of
    :func:`flash_bwd_cases` (and the GQA-7 and Lq < Lk cases): dq, dk and
    dv of bf16, each no farther from the float64 plain backward than the
    plain bf16 backward (f32 math on the widened values, rounded once) is
    plus one bf16 ulp of max|grad|, and within half an ulp of bf16 plus
    ``FLASH_BWD_BF16_F64_EXCESS`` of max|grad| of it (at (t) and (c) the
    emulated split passes that gate and one bf16 P or dS fails it, on
    the same inputs: :func:`flash_bwd_bf16_emulated`); two calls bitwise
    equal; the bf16
    forward's o bitwise the same with and without lse; the launches of
    each kernel; device ms (CUDA graphs; the sum over copies of its
    partials that outgrow the L2, :func:`rotating`) of the whole backward
    and of each kernel beside the plain backward's (eager), the bound at
    989 TFLOP/s and, at (t), SDPA's bf16 backward and forward +
    backward."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(34)
    bf = torch.bfloat16
    rows = []
    print("bf16 flash backward check (errors of max|float64 grad|: kernels "
          "/ plain bf16; ms: CUDA graphs, plain eager; bound: 10 D FLOPs a "
          "valid pair at 989 TFLOP/s, dK/dV 8 D, dQ 6 D):")
    for name, b, lq, lk, hq, hkv, d, causal, cap, win in flash_bwd_cases():
        q, do = (torch.randn((b, lq, hq, d), generator=gen,
                             device="cuda").to(bf) for _ in range(2))
        k, v = (torch.randn((b, lk, hkv, d), generator=gen,
                            device="cuda").to(bf) for _ in range(2))
        kw = dict(causal=causal, soft_cap=cap, window=win)
        plan = fa.bwd_plan(b, lq, lk, hq, hkv, d)
        lse = torch.empty((b, hq, lq), device="cuda")
        fa.reset_launch_counts()
        o = fa._launch_forward(q, k, v, causal, cap, win, lse)
        same_o = torch.equal(o, fa.flash_attention(q, k, v, **kw))
        got = fa.flash_attention_backward(q, k, v, lse, do, **kw)
        again = fa.flash_attention_backward(q, k, v, lse, do, **kw)
        counts = route_counts(fa.BWD_LAUNCHES, bf16=True)
        plain = fa.flash_attention_backward_plain(q, k, v, lse, do, **kw)
        want = fa.flash_attention_backward_plain(
            q.double(), k.double(), v.double(), lse.double(), do.double(),
            **kw)
        torch.cuda.synchronize()
        repeat = all(torch.equal(x, y) for x, y in zip(got, again))
        f64_exc = [half_ulp_excess(torch, g, w) for g, w in zip(got, want)]
        emulated = {}
        if name in ("t_train", "c_rgemma"):
            for key, terms in (("split", (2, 2)), ("one_p", (1, 2)),
                               ("one_ds", (2, 1))):
                emu = flash_bwd_bf16_emulated(torch, q, k, v, do, kw,
                                              p_terms=terms[0],
                                              ds_terms=terms[1])
                emulated[key] = [half_ulp_excess(torch, g, w)
                                 for g, w in zip(emu, want)]
                del emu
            gate = FLASH_BWD_BF16_F64_EXCESS
            if not (max(emulated["split"]) <= gate
                    and emulated["one_p"][2] > 4 * gate
                    and min(emulated["one_ds"][:2]) > 4 * gate):
                raise AssertionError(
                    f"bf16 flash backward {name}: the float64 gate {gate} "
                    f"does not tell the emulated P / dS split (dq, dk, dv "
                    f"{emulated['split']}) from one bf16 P (dv "
                    f"{emulated['one_p'][2]}) or dS (dq, dk "
                    f"{emulated['one_ds'][:2]}) by 4x")
        errs, perrs, excess = [], [], []
        for g, p, w in zip(got, plain, want):
            scale = w.abs().max().item()
            ulp = 2.0 ** (np.floor(np.log2(scale)) - 7)
            ek = (g.double() - w).abs().max().item()
            ep = (p.double() - w).abs().max().item()
            errs.append(ek / scale)
            perrs.append(ep / scale)
            excess.append((ek - ep - ulp) / scale)
        n_sum = 2 if plan.group > 1 else 0
        want_counts = {"flash_attention_bwd_dq_bf16": 2,
                       "flash_attention_bwd_dkdv_bf16": 2,
                       "flash_attention_bwd_sum_bf16": n_sum}
        if not (same_o and repeat and counts == want_counts
                and all(g.dtype == bf for g in got)
                and np.isfinite(errs).all() and max(excess) <= 0
                and max(f64_exc) <= FLASH_BWD_BF16_F64_EXCESS):
            raise AssertionError(
                f"bf16 flash backward {name}: o with lse == without "
                f"{same_o}, two calls bitwise {repeat}, launches {counts}, "
                f"dq/dk/dv of max|f64| {errs} against the plain bf16 "
                f"backward's {perrs} (limit: plus one bf16 ulp); past half "
                f"a bf16 ulp {f64_exc} (limit "
                f"{FLASH_BWD_BF16_F64_EXCESS})")
        stats = torch.empty((2, b, hq, lq), device="cuda")
        dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
        part = torch.empty((2, plan.group, *k.shape), device="cuda")
        outs = (dk, dv) if plan.group == 1 else (part[0], part[1])
        t = {"backward": time_graph_ms(torch, lambda: fa.
                                       flash_attention_backward(
                                           q, k, v, lse, do, **kw), reps=5),
             "dq": time_graph_ms(torch, lambda: fa._launch_backward(
                 "dq", q, k, v, do, lse, stats, (dq,), **kw), reps=5),
             "dkdv": time_graph_ms(torch, lambda: fa._launch_backward(
                 "dkdv", q, k, v, do, lse, stats, outs, **kw), reps=5),
             "sum": None, "sum_plain": None, "sum_library": None,
             "plain": time_ms(torch, lambda: fa.flash_attention_backward_plain(
                 q, k, v, lse, do, **kw), reps=2),
             "sdpa_bwd": None, "sdpa_fwd_bwd": None,
             "sdpa_bwd_device": None, "backward_device": None}
        if plan.group > 1:
            def copies(call):
                def make():
                    c = part.clone()
                    return lambda: call(c)
                return rotating(make, part.numel() * 4)
            t["sum"] = time_graph_ms(torch, copies(
                lambda c: fa._launch_sum(c, dk, dv, plan)), reps=10)
            # the plain sum (in head order, f32) rounded once, and one
            # PyTorch call over the heads
            t["sum_plain"] = time_ms(torch, lambda: [
                x.to(bf) for x in fa.sum_partials_plain(part)])
            t["sum_library"] = time_graph_ms(torch, copies(
                lambda c: torch.sum(c, 1).to(bf)), reps=10)
        if cap is None and win is None and lq == lk:
            qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                          for x in (q, k, v))
            dot = do.transpose(1, 2)
            sdpa = F.scaled_dot_product_attention

            def fwd_bwd():
                out = sdpa(qt, kt, vt, is_causal=causal, enable_gqa=True)
                return torch.autograd.grad(out, (qt, kt, vt), dot)
            t["sdpa_fwd_bwd"] = time_ms(torch, fwd_bwd)
            out = sdpa(qt, kt, vt, is_causal=causal, enable_gqa=True)

            def sdpa_bwd():
                return torch.autograd.grad(out, (qt, kt, vt), dot,
                                           retain_graph=True)
            t["sdpa_bwd"] = time_ms(torch, sdpa_bwd)
            # the device time alone (torch.profiler), of SDPA's backward
            # and of the kernels': events around autograd include its host
            # work (SDPA's events have read 0.17-0.68 ms across calls)
            share = device_share(torch, sdpa_bwd, n=5)
            t["sdpa_bwd_device"] = share["device_ms"]
            t["sdpa_bwd_top"] = share["top"][:2]
            t["backward_device"] = device_share(
                torch, lambda: fa.flash_attention_backward(
                    q, k, v, lse, do, **kw), n=5)["device_ms"]
            del out, qt, kt, vt
        bounds = flash_bwd_bounds_bf16(b, lq, lk, hq, hkv, d, causal, win)
        rows.append(dict(name=name, errs=errs, plain_errs=perrs,
                         excess=max(excess), f64_excess=max(f64_exc),
                         emulated=emulated, bounds=bounds, plan=plan,
                         abs_err=max((g.float() - p.float()).abs().max()
                                     .item() for g, p in zip(got, plain)),
                         **t))
        fmt = (lambda x: "-" if x is None else f"{x:.3f}")
        print(f"  {name:9s} dq/dk/dv {errs[0]:.2e} {errs[1]:.2e} "
              f"{errs[2]:.2e} (plain bf16 {perrs[0]:.2e} {perrs[1]:.2e} "
              f"{perrs[2]:.2e}); past half a bf16 ulp of float64 "
              + " ".join(f"{x:.2e}" for x in f64_exc)
              + "".join(f", emulated {key} " + " ".join(
                  f"{x:.2e}" for x in vals)
                  for key, vals in emulated.items())
              + f"; ms backward {t['backward']:.3f} (dq "
              f"{t['dq']:.3f}, dkdv {t['dkdv']:.3f}, sum {fmt(t['sum'])}), "
              f"plain {t['plain']:.3f}, bound {bounds['backward'][0]:.3f} "
              f"({bounds['backward'][1]}; dkdv {bounds['dkdv'][0]:.3f}, dq "
              f"{bounds['dq'][0]:.3f}), SDPA bf16 backward "
              f"{fmt(t['sdpa_bwd'])}, fwd+bwd {fmt(t['sdpa_fwd_bwd'])} "
              f"(profiler device ms: SDPA backward "
              f"{fmt(t['sdpa_bwd_device'])}, the kernels' "
              f"{fmt(t['backward_device'])}"
              + (f"; SDPA's kernels {t['sdpa_bwd_top']}"
                 if t["sdpa_bwd_device"] is not None else "") + "); "
              f"{bounds['backward_flops'] / t['backward'] / 1e9:.1f} TFLOP/s;"
              f" blocks {plan.dq_blocks} / {plan.dkdv_blocks} / "
              f"{plan.sum_blocks}")
        del q, k, v, o, do, lse, got, again, plain, want, stats, dq, dk, dv
        del part
    torch.cuda.empty_cache()
    return rows


def bf16_plain_routes(torch):
    """Every conv1d and flash kernel wrapper of a training step swapped
    for its plain version (the forwards too: the kernels' functions in
    plain PyTorch on the CUDA tensors)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import trim_conv1d as tc1

    def conv_forward(x, w, tile_l):
        with torch.no_grad():
            return tc1.trim_conv1d_plain(x, w.contiguous(), tile_l=tile_l)

    def attn_forward(q, k, v, causal, soft_cap, window, lse=None):
        o, plain_lse = fa._plain_forward(q, k, v, causal=causal,
                                         soft_cap=soft_cap, window=window,
                                         block_k=fa.BLOCK_K)
        if lse is not None:
            lse.copy_(plain_lse)
        return o
    stack = contextlib.ExitStack()
    stack.enter_context(swapped(
        tc1, _forward=conv_forward,
        trim_conv1d_input_grad=tc1.trim_conv1d_input_grad_plain,
        trim_conv1d_weight_grad=tc1.trim_conv1d_wgrad_plain))
    stack.enter_context(swapped(
        fa, _launch_forward=attn_forward,
        flash_attention_backward=fa.flash_attention_backward_plain))
    return stack


def bf16_step_launches(cfg) -> dict:
    """The bf16 kernels' launches of one remat train step of ``cfg``:
    each conv1d and flash forward twice a layer (remat recomputes it),
    each backward kernel once (the flash sum where G > 1)."""
    rec = sum(cfg.pattern_at(i) == "rec" for i in range(cfg.n_layers)) \
        if cfg.family == "hybrid" else (
            cfg.n_layers if cfg.family == "ssm" else 0)
    att = cfg.n_layers - rec
    sums = att if cfg.n_heads > cfg.n_kv_heads else 0
    return {"trim_conv1d_bf16": 2 * rec, "trim_conv1d_dx_bf16": rec,
            "trim_conv1d_wgrad_bf16": rec, "flash_attention_bf16": 2 * att,
            "flash_attention_bwd_dkdv_bf16": att,
            "flash_attention_bwd_dq_bf16": att,
            "flash_attention_bwd_sum_bf16": sums}


def train_lm_bf16_rows():
    """(arch, layers or None for full depth, batch, seq, f32 phase key,
    gradient cut layers, gradient tokens): the f32 training phases'
    shapes."""
    return [("qwen2.5-3b", None, TRAIN_LM_BATCH, TRAIN_LM_SEQ,
             GRAD_LM_LAYERS, 1, GRAD_LM_TOKENS),
            ("recurrentgemma-2b", None, RGEMMA_TRAIN_BATCH,
             RGEMMA_TRAIN_SEQ, RGEMMA_GRAD_LAYERS, 1, RGEMMA_GRAD_TOKENS),
            ("falcon-mamba-7b", MAMBA_TRAIN_LAYERS, MAMBA_TRAIN_BATCH,
             MAMBA_TRAIN_SEQ, MAMBA_GRAD_LAYERS, MAMBA_TRAIN_BATCH,
             MAMBA_TRAIN_SEQ - 1)]


def train_lm_bf16(torch, f32: dict) -> dict:
    """Phase 37 (module docstring): full-width qwen2.5-3b and
    recurrentgemma-2b and the falcon-mamba-7b depth cut trained in bf16
    through ``steps.make_train_step`` (params drawn in bf16, f32
    moments); ``f32``: each family's f32 training phase's result of this
    call.  Per family: step-1 gradients at the depth cut on the kernels,
    on the plain routes and on the f32 kernels for the same values
    widened (each leaf of the kernels' step no farther from the plain
    step than twice the plain step's distance from the f32 step, plus
    2^-8);
    BF16_LM_TRAIN_STEPS steps at the cut (the gradient reaches mu and
    nu); then LM_BF16_TRAIN_STEPS timed steps at the f32 phase's shape:
    ms and peak a step, launches a step of each bf16 kernel, every loss
    and leaf finite, beside the f32 phase's figures."""
    from repro_torch.configs import registry
    from repro_torch.data import DataConfig, SyntheticStream, make_batch
    from repro_torch.distributed import steps
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import trim_conv1d as tc1
    from repro_torch.models import api
    from repro_torch.models.base import init_params
    from repro_torch.optim import AdamWConfig, adamw

    out = {"launches": {}}
    for arch, layers, batch, seq, cut, gb, gtok in train_lm_bf16_rows():
        cfg = registry.get(arch).CONFIG
        if layers is not None:
            cfg = cfg.replace(n_layers=layers)
        assert cfg.remat
        opt = AdamWConfig(lr=3e-3, warmup_steps=10,
                          decay_steps=LM_BF16_TRAIN_STEPS)

        # step-1 gradients at the depth cut: kernels, plain routes, f32
        gcfg = cfg.replace(n_layers=cut)
        params = init_params(api.params(gcfg), torch.Generator(
            device="cuda").manual_seed(0), device="cuda",
            dtype=torch.bfloat16)
        nb = make_batch(DataConfig(batch=gb, seq=gtok + 1, vocab=cfg.vocab,
                                   task="copy"), 0)
        gbatch = {k: torch.from_numpy(v).cuda() for k, v in nb.items()}
        names = leaf_names(params)

        def grads(p):
            live = [t.detach().requires_grad_()
                    for t in adamw.tree_leaves(p)]
            logits, aux = api.forward(adamw.tree_unflatten(p, live), gbatch,
                                      gcfg)
            loss = api.loss_fn(logits, gbatch["labels"], aux)
            return [loss] + list(torch.autograd.grad(loss, live))
        tc1.reset_launch_counts()
        fa.reset_launch_counts()
        g_k = grads(params)
        torch.cuda.synchronize()
        g_launches = family_counts(tc1, fa, bf16=True)
        with bf16_plain_routes(torch):
            tc1.reset_launch_counts()
            fa.reset_launch_counts()
            g_p = grads(params)
            torch.cuda.synchronize()
            plain_launches = {**tc1.LAUNCHES, **tc1.BWD_LAUNCHES,
                              **fa.LAUNCHES, **fa.BWD_LAUNCHES}
        g_32 = grads(widened(params))
        torch.cuda.synchronize()

        def dist(a, b):
            return (a.float() - b.float()).abs().max().item() / max(
                b.float().abs().max().item(), 2.0 ** -126)
        want = bf16_step_launches(gcfg)
        if any(plain_launches.values()):
            raise AssertionError(f"train_lm_bf16 {arch}: the plain step "
                                 f"launched {plain_launches}")
        bad, table = [], []
        for name, a, p, f in zip(["loss"] + names, g_k, g_p, g_32):
            if name != "loss" and a.dtype != p.dtype:
                bad.append(f"{name} dtype {a.dtype} / {p.dtype}")
            dk, dp = dist(a, p), dist(p, f)
            table.append((name, dk, dp, dist(a, f)))
            if not (np.isfinite(dk) and dk <= 2 * dp + 2.0 ** -8):
                bad.append(f"{name} {dk:.3e} from the plain step, which "
                           f"lies {dp:.3e} from f32")
        if bad or g_launches != want:
            raise AssertionError(f"train_lm_bf16 {arch}: step-1 gradients "
                                 f"at the depth-{cut} cut: {bad}; launches "
                                 f"{g_launches}, want {want}")
        table.sort(key=lambda r: -r[1] / max(r[2], 1e-30))
        print(f"train_lm_bf16 {arch}: step-1 gradients at the depth-{cut} "
              f"full-width cut ({gb} x {gtok} tokens), each leaf's max|diff| "
              f"/ max: kernels vs plain routes (plain vs f32 on the same "
              f"values; kernels vs f32), worst ratio first: " + ", ".join(
                  f"{n} {dk:.2e} ({dp:.2e}; {df:.2e})"
                  for n, dk, dp, df in table[:6])
              + f" -- every leaf within 2x plus 2^-8; launches {g_launches}")
        del g_k, g_p, g_32, gbatch

        # steps at the cut: the gradient reaches mu and nu
        state = {"params": params,
                 "opt": adamw.init_moments(params, opt),
                 "step": torch.zeros((), dtype=torch.int32, device="cuda")}
        stream = SyntheticStream(DataConfig(batch=gb, seq=gtok + 1,
                                            vocab=cfg.vocab, task="copy"))
        step_fn = steps.make_train_step(gcfg, opt)
        norms, cut_losses = [], []
        for _ in range(BF16_LM_CUT_STEPS):
            state, metrics = step_fn(state, {
                k: torch.from_numpy(v).cuda()
                for k, v in next(stream).items()})
            norms.append(float(metrics["grad_norm"]))
            cut_losses.append(float(metrics["loss"]))
        clip = train_clip_state(torch, state, norms,
                                f"{arch} bf16 depth-{cut} full-width cut")
        if not (clip["mu_leaves_moved"] > 0 and np.isfinite(cut_losses).all()
                and all(t.dtype == p.dtype for t, p in zip(
                    adamw.tree_leaves(state["params"]),
                    adamw.tree_leaves(params)))):
            raise AssertionError(f"train_lm_bf16 {arch}: the depth-{cut} "
                                 f"cut's steps: losses {cut_losses}, grad "
                                 f"norms {norms}, {clip}")
        del state, params, step_fn
        torch.cuda.empty_cache()

        # the timed steps at the f32 phase's shape
        torch.cuda.reset_peak_memory_stats()
        state = {"params": init_params(api.params(cfg), torch.Generator(
                     device="cuda").manual_seed(0), device="cuda",
                     dtype=torch.bfloat16),
                 "step": torch.zeros((), dtype=torch.int32, device="cuda")}
        state["opt"] = adamw.init_moments(state["params"], opt)
        stream = SyntheticStream(DataConfig(batch=batch, seq=seq,
                                            vocab=cfg.vocab, task="copy"))
        step_fn = steps.make_train_step(cfg, opt)
        losses, norms, step_ms, peaks, per_step = [], [], [], [], []
        for _ in range(LM_BF16_TRAIN_STEPS):
            b_ = {k: torch.from_numpy(v).cuda()
                  for k, v in next(stream).items()}
            torch.cuda.synchronize()
            tc1.reset_launch_counts()
            fa.reset_launch_counts()
            t0 = time.perf_counter()
            state, metrics = step_fn(state, b_)
            losses.append(float(metrics["loss"]))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            per_step.append(family_counts(tc1, fa, bf16=True))
            norms.append(float(metrics["grad_norm"]))
            peaks.append(torch.cuda.max_memory_allocated() / 2**30)
        clip = train_clip_state(torch, state, norms,
                                f"{arch} bf16 full width"
                                + (f" cut to {layers}" if layers else ""))
        leaves_bf16 = sum(t.dtype == torch.bfloat16
                          for t in adamw.tree_leaves(state["params"]))
        del state, step_fn
        torch.cuda.empty_cache()
        want = bf16_step_launches(cfg)
        if any(c != want for c in per_step) or \
                not np.isfinite(losses).all() or leaves_bf16 == 0:
            raise AssertionError(f"train_lm_bf16 {arch}: launches a step "
                                 f"{per_step}, want {want}; losses "
                                 f"{losses}")
        for key in per_step[0]:
            out["launches"][key] = out["launches"].get(key, 0) + sum(
                c[key] for c in per_step)
        ref = f32[arch]
        f_ms = ref["step_ms"]
        print(f"train_lm_bf16 {arch}: {cfg.n_layers} layers at full width "
              f"(remat), batch {batch} x {seq - 1} tokens, "
              f"{LM_BF16_TRAIN_STEPS} AdamW steps in bf16: losses "
              f"{[round(x, 4) for x in losses]}, grad norms {norms}")
        for i in range(LM_BF16_TRAIN_STEPS):
            fm = f"{f_ms[i]:.1f}" if i < len(f_ms) else "-"
            print(f"  step {i + 1}: {step_ms[i]:.1f} ms (f32 phase "
                  f"{fm} ms), peak {peaks[i]:.2f} GiB (f32 phase peak "
                  f"{ref['peak']:.2f} GiB over its steps), launches "
                  f"{per_step[i]}")
        steady = float(np.mean(step_ms[1:]))
        f_steady = float(np.mean(f_ms[1:]))
        print(f"  steady {steady:.1f} ms a step (steps 2-"
              f"{LM_BF16_TRAIN_STEPS}) against the f32 phase's "
              f"{f_steady:.1f} ms (steps 2-{len(f_ms)}): "
              f"{f_steady / steady:.2f}x; peak {max(peaks):.2f} GiB "
              f"against {ref['peak']:.2f}")
        out[arch] = dict(losses=losses, grad_norms=norms, step_ms=step_ms,
                         steady_ms=steady, f32_steady_ms=f_steady,
                         peak=max(peaks), f32_peak=ref["peak"],
                         per_step=per_step[0], clip=clip,
                         worst=table[0], cut_losses=cut_losses)
    print(f"train_lm_bf16: launches of the bf16 routes over the three "
          f"families' timed steps {out['launches']}")
    return out


# ---------------------------------------------------------------------------
# encdec: seamless-m4t-large-v2, the encoder-decoder family (phase 39)
# ---------------------------------------------------------------------------

ENCDEC_ARCH = "seamless-m4t-large-v2"
# prefill: 4096 target tokens over 4096 source frames a row
ENCDEC_BATCH, ENCDEC_SEQ = 2, 4096
# the depth-1 cut's source: its cross call has more queries than keys
ENCDEC_CUT_SRC = 1024
# training: 2 x 1024 tokens (make_batch drops one) over 1024 frames a row
ENCDEC_TRAIN_STEPS, ENCDEC_TRAIN_BATCH = 3, 2
ENCDEC_TRAIN_SEQ, ENCDEC_TRAIN_SRC = 1025, 1024
# the depth-1 cut's first-step gradients: 1 x 256 tokens over 384 frames
ENCDEC_GRAD_TOKENS, ENCDEC_GRAD_SRC = 256, 384
# a full-width cut trained beside full depth: at full depth the f32 sum
# of squares of the gradient overflows (ROADMAP Queue 3), at this cut it
# must not, and the gradient must reach mu and nu
ENCDEC_TRAIN_CUT = 2
# the flash kernel timed at seamless's calls: forward (name, lq, lk,
# causal) at batch 2 and backward at the training rows
ENCDEC_FWD_TIMES = (("s_enc", 4096, 4096, False), ("s_dec", 4096, 4096, True),
                    ("s_cross_long", 4096, 1024, False))
ENCDEC_BWD_TIMES = (("s_train", 1024, 1024, True),
                    ("s_train_nc", 1024, 1024, False))


def encdec_inputs(torch, cfg, batch, tgt, src_len, seed, dtype):
    """(tokens (B, tgt), src (B, src_len, d_model) of ``dtype``): tokens
    and unit-normal frames from ``np.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab,
                                           (batch, tgt))).cuda()
    src = torch.from_numpy(rng.standard_normal(
        (batch, src_len, cfg.d_model)).astype(np.float32)).cuda()
    return tokens, src.to(dtype)


def encdec_cut(params, n):
    """The first ``n`` encoder and ``n`` decoder blocks of a seamless
    parameter tree (views)."""
    def cut(tree):
        if isinstance(tree, dict):
            return {k: cut(v) for k, v in tree.items()}
        return tree[:n]
    return {**params, "enc_blocks": cut(params["enc_blocks"]),
            "dec_blocks": cut(params["dec_blocks"])}


def encdec_walk(torch, cfg, params, src, tokens):
    """The forward of ``cfg`` step by step, as ``transformer.encdec_apply``
    takes it: yields (stack, layer, kind, sublayer params, normed input,
    causal, encoder output or None, positions or None) before each
    sublayer (kind "self", "cross" or "mlp") and then adds the sublayer's
    output to the residual stream; the encoder's output is held bitwise
    against ``transformer._run_blocks``."""
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    ps = torch.arange(src.shape[1], device="cuda")[None]
    x = src
    for i, pi in enumerate(T.layer_list(params["enc_blocks"],
                                        cfg.enc_layers)):
        h = L.norm_apply(pi["ln_att"], x, cfg)
        yield "enc", i, "self", pi["att"], h, False, None, ps
        x = x + L.attention_apply(pi["att"], h, cfg, positions=ps,
                                  causal=False)
        z = L.norm_apply(pi["ln_mlp"], x, cfg)
        yield "enc", i, "mlp", pi["mlp"], z, None, None, None
        x = x + L.mlp_apply(pi["mlp"], z, cfg)
    if not torch.equal(x, T._run_blocks(params["enc_blocks"], src, cfg,
                                        positions=ps,
                                        n_layers=cfg.enc_layers,
                                        causal=False)[0]):
        raise AssertionError("encdec walk: the encoder stream is not "
                             "transformer._run_blocks's")
    enc = L.norm_apply(params["enc_ln"], x, cfg)
    x = L.embed_apply(params["tok"], tokens, cfg)
    pt = torch.arange(tokens.shape[1], device="cuda")[None]
    for i, pi in enumerate(T.layer_list(params["dec_blocks"],
                                        cfg.dec_layers)):
        h = L.norm_apply(pi["ln_att"], x, cfg)
        yield "dec", i, "self", pi["att"], h, True, None, pt
        x = x + L.attention_apply(pi["att"], h, cfg, positions=pt)
        h = L.norm_apply(pi["ln_cross"], x, cfg)
        yield "dec", i, "cross", pi["cross"], h, False, enc, None
        x = x + L.attention_apply(pi["cross"], h, cfg, encoder_out=enc,
                                  is_cross=True, causal=False,
                                  use_rope=False)
        z = L.norm_apply(pi["ln_mlp"], x, cfg)
        yield "dec", i, "mlp", pi["mlp"], z, None, None, None
        x = x + L.mlp_apply(pi["mlp"], z, cfg)


def encdec_sublayer(L, p, h, cfg, causal, enc, pos):
    """One attention sublayer of the walk on ``cfg``'s attn_impl."""
    if enc is not None:
        return L.attention_apply(p, h, cfg, encoder_out=enc, is_cross=True,
                                 causal=False, use_rope=False)
    return L.attention_apply(p, h, cfg, positions=pos, causal=causal)


def encdec_qkv(torch, L, p, h, cfg, enc, pos):
    """q, k, v of one attention sublayer as ``attention_apply`` forms them
    (self: RoPE over ``pos``; cross: k, v from ``enc``, no RoPE)."""
    src = h if enc is None else enc
    q, k, v = (torch.einsum("bld,dhk->blhk", a, p[w])
               for a, w in ((h, "wq"), (src, "wk"), (src, "wv")))
    if enc is None:
        q = L.rope(q, pos[:, :q.shape[1]], cfg.rope_theta)
        k = L.rope(k, pos[:, :k.shape[1]], cfg.rope_theta)
    return q, k, v


def encdec_layer_check(torch, cfg, params, src, tokens) -> dict:
    """Along the f32 flash forward, each of the 72 attention sublayers
    (24 encoder self, 24 decoder self, 24 cross) on the kernel and on the
    ref oracle on the same input, within LM_LAYER_TOLERANCE of max|ref|;
    and its core (batch row 0, the first F64_POSITIONS queries against
    every key they see, before the output projection) against the float64
    plain version: the kernel's error at most max(F64_FACTOR x the f32
    ref oracle's, ATTN_TOLERANCE) of max|f64|."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.models import layers as L
    cref = cfg.replace(attn_impl="ref")
    worst, rows = {}, []
    with torch.no_grad():
        for stack, i, kind, p, h, causal, enc, pos in encdec_walk(
                torch, cfg, params, src, tokens):
            if kind == "mlp":
                continue
            af = encdec_sublayer(L, p, h, cfg, causal, enc, pos)
            ar = encdec_sublayer(L, p, h, cref, causal, enc, pos)
            err = ((af - ar).abs().max() / ar.abs().max()).item()
            q, k, v = encdec_qkv(torch, L, p, h[:1], cfg,
                                 None if enc is None else enc[:1], pos)
            q = q[:, :F64_POSITIONS]
            if causal:
                k, v = k[:, :F64_POSITIONS], v[:, :F64_POSITIONS]
            o64 = fa.flash_attention_plain(q.double(), k.double(),
                                           v.double(), causal=causal)
            scale = o64.abs().max().item()
            ek = ((fa.flash_attention(q, k, v, causal=causal).double()
                   - o64).abs().max() / scale).item()
            er = ((ref.attention(q, k, v, causal=causal).double()
                   - o64).abs().max() / scale).item()
            lim = max(F64_FACTOR * er, ATTN_TOLERANCE)
            if not (np.isfinite(err) and err <= LM_LAYER_TOLERANCE
                    and ek <= lim):
                raise AssertionError(
                    f"encdec {stack} layer {i} {kind}: kernel vs ref "
                    f"{err:.3e} of max|ref| (tol {LM_LAYER_TOLERANCE}); "
                    f"vs float64 {ek:.3e}, ref {er:.3e} (limit {lim:.3e})")
            key = f"{stack}_{kind}"
            w = worst.setdefault(key, [0.0, 0.0, 0.0])
            w[0], w[1] = max(w[0], err), max(w[1], ek)
            w[2] = max(w[2], ek / max(er, 1e-30))
            rows.append((stack, i, kind, err, ek, er))
            del af, ar, q, k, v, o64
    print("encdec layer check (f32, flash forward, every attention "
          "sublayer; worst kernel-vs-ref of max|ref| (tol "
          f"{LM_LAYER_TOLERANCE:g}), worst kernel-vs-float64 of max|f64| "
          f"(first {F64_POSITIONS} queries of row 0), worst kernel / ref "
          "float64 error ratio): " + "; ".join(
              f"{k} {v[0]:.2e} {v[1]:.2e} {v[2]:.2f}"
              for k, v in worst.items()) + f" -- {len(rows)} sublayers")
    return worst


def encdec_prefill(torch) -> dict:
    """Full-width seamless-m4t-large-v2 drawn on the card in f32: two
    timed prefills through ``make_prefill_step`` at 2 x 4096 over 4096
    source frames (72 flash launches a forward: 24 encoder, 24 decoder
    self, 24 cross), the ref prefill's distance printed, the per-layer
    check, and the depth-1 cut over 1024 frames (a cross call with Lq
    4096 > Lk 1024): the flash logits no farther from the float64 oracle
    (``repro_torch.testing.float64``) than max(F64_FACTOR x ref's,
    LM_TOLERANCE), the oracle's next token."""
    from repro_torch.configs import registry
    from repro_torch.distributed import steps
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import api
    from repro_torch.models.base import init_params
    from repro_torch.testing import float64

    cfg = registry.get(ENCDEC_ARCH).CONFIG
    assert cfg.attn_impl == "flash" and cfg.family == "encdec"
    n_att = cfg.enc_layers + 2 * cfg.dec_layers
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = init_params(api.params(cfg), torch.Generator(device="cuda")
                         .manual_seed(0), device="cuda")
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    tokens, src = encdec_inputs(torch, cfg, ENCDEC_BATCH, ENCDEC_SEQ,
                                ENCDEC_SEQ, 39, torch.float32)
    batch = {"tokens": tokens, "src": src}
    prefill = steps.make_prefill_step(cfg)
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        logits, nxt = prefill(params, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = dict(fa.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    if launches != {"flash_attention": 2 * n_att,
                    "flash_attention_bf16": 0}:
        raise AssertionError(f"encdec prefill: launches {launches} in 2 "
                             f"forwards, want {n_att} f32 each")
    if tuple(logits.shape) != (ENCDEC_BATCH, ENCDEC_SEQ, cfg.vocab) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"encdec prefill: logits {tuple(logits.shape)}"
                             " not finite or of the wrong shape")
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    ref_logits, ref_nxt = steps.make_prefill_step(
        cfg.replace(attn_impl="ref"))(params, batch)
    torch.cuda.synchronize()
    ref_ms = (time.perf_counter() - t0) * 1e3
    if fa.LAUNCHES["flash_attention"]:
        raise AssertionError("encdec prefill: the ref forward launched the "
                             "kernel")
    drift = ((logits - ref_logits).abs().max()
             / ref_logits.abs().max()).item()
    print(f"encdec: {cfg.name} full width ({cfg.enc_layers} + "
          f"{cfg.dec_layers} layers), {registry.count_params(cfg):,} "
          f"parameters drawn on the card in {draw_s:.2f} s; prefill "
          f"{ENCDEC_BATCH} x {ENCDEC_SEQ} tokens over {ENCDEC_SEQ} frames, "
          f"flash {times[1]:.1f} ms a forward (first {times[0]:.1f} ms), "
          f"{n_att} launches each; ref {ref_ms:.1f} ms; peak "
          f"{peak:.2f} GiB (flash forwards); whole-depth logits flash vs "
          f"ref {drift:.2e} of max|ref|, next tokens {nxt.tolist()} vs "
          f"{ref_nxt.tolist()} (printed)")
    del logits, ref_logits
    torch.cuda.empty_cache()
    worst = encdec_layer_check(torch, cfg, params, src, tokens)

    # the depth-1 cut: three attention calls in series, each f32 path
    # held against the float64 oracle (row 0), not against the other
    c1, p1 = cfg.replace(enc_layers=1, dec_layers=1, n_layers=2), \
        encdec_cut(params, 1)
    b1 = {"tokens": tokens[:1],
          "src": src[:1, :ENCDEC_CUT_SRC].contiguous()}
    fa.reset_launch_counts()
    l1, n1 = steps.make_prefill_step(c1)(p1, b1)
    cut_launches = fa.LAUNCHES["flash_attention"]
    r1, _ = steps.make_prefill_step(c1.replace(attn_impl="ref"))(p1, b1)
    with float64.float64(), torch.no_grad():
        l64, _ = api.forward(float64.widen(p1), {
            "tokens": b1["tokens"], "src": b1["src"].double()},
            c1.replace(attn_impl="ref"))
    scale = l64.abs().max().item()
    err1, ref1 = ((x.double() - l64).abs().max().item() / scale
                  for x in (l1, r1))
    lim = max(F64_FACTOR * ref1, LM_TOLERANCE)
    want1 = l64[:, -1].argmax(-1)
    if cut_launches != 3 or not np.isfinite(err1) or err1 > lim or \
            not same_tokens(n1, want1, l64[:, -1], lim * scale):
        raise AssertionError(f"encdec depth-1 cut: {cut_launches} launches, "
                             f"flash {err1:.3e} of max|f64 logits| from the "
                             f"float64 oracle, ref {ref1:.3e} (limit "
                             f"{lim:.3e}), tokens {n1.tolist()} vs "
                             f"{want1.tolist()}")
    print(f"encdec depth-1 cut ({ENCDEC_SEQ} tokens over {ENCDEC_CUT_SRC} "
          f"frames: the cross call has Lq > Lk; row 0): logits of max|f64| "
          f"from the float64 oracle flash {err1:.2e}, ref {ref1:.2e} (limit "
          f"max({F64_FACTOR:g} x ref's, {LM_TOLERANCE:g})), flash vs ref "
          f"{(l1 - r1).abs().max().item() / r1.abs().max().item():.2e}; "
          f"next token {n1.tolist()} == {want1.tolist()}")
    del l1, r1, l64, p1
    torch.cuda.empty_cache()
    return dict(cfg=cfg, params=params, ms=times[1], ref_ms=ref_ms,
                peak=peak, launches=launches["flash_attention"],
                worst=worst, err1=err1)


def encdec_bf16_layers(torch, cfg, params, src, tokens) -> list:
    """Along the bf16 forward, every sublayer run in bf16 and in f32 (its
    params widened) on the same bf16 input: each MLP within
    LM_BF16_TOLERANCE of max|f32 out|; each attention sublayer's core, the
    bf16 kernel against the f32 kernel on the same bf16 q, k, v, within
    FLASH_BF16_TOLERANCE of max|o| (the whole sublayer's distance
    printed, as bf16_layer_check does).  Returns the worst of each."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import layers as L
    c32 = cfg.replace(dtype="float32")
    worst = {}

    def note(key, err, lim):
        if not np.isfinite(err) or (lim is not None and err > lim):
            raise AssertionError(f"encdec bf16 {key}: {err:.3e} (tol "
                                 f"{lim})")
        worst[key] = max(worst.get(key, 0.0), err)

    def rel(a, b):
        return ((a.float() - b.float()).abs().max()
                / b.float().abs().max()).item()
    with torch.no_grad():
        for stack, i, kind, p, h, causal, enc, pos in encdec_walk(
                torch, cfg, params, src, tokens):
            pf = widened(p)
            if kind == "mlp":
                yb, yf = L.mlp_apply(p, h, cfg), L.mlp_apply(pf, h.float(),
                                                             c32)
                if yb.dtype != torch.bfloat16:
                    raise AssertionError(f"encdec bf16 MLP is {yb.dtype}")
                note(f"{stack}_mlp", rel(yb, yf), LM_BF16_TOLERANCE)
                continue
            yb = encdec_sublayer(L, p, h, cfg, causal, enc, pos)
            yf = encdec_sublayer(L, pf, h.float(), c32, causal,
                                 None if enc is None else enc.float(), pos)
            note(f"{stack}_{kind}_sublayer", rel(yb, yf), None)
            q, k, v = encdec_qkv(torch, L, p, h, cfg, enc, pos)
            ob = fa.flash_attention(q, k, v, causal=causal)
            of = fa.flash_attention(q.float(), k.float(), v.float(),
                                    causal=causal)
            note(f"{stack}_{kind}_kernel", rel(ob, of), FLASH_BF16_TOLERANCE)
            del pf, yb, yf, q, k, v, ob, of
    torch.cuda.empty_cache()
    return worst


def encdec_bf16(torch, cfg, f32: dict) -> dict:
    """seamless-m4t-large-v2 drawn in bf16 (the same seed; norm scales
    f32): two timed bf16 prefills with a bf16 ``src`` (72 bf16 flash
    launches a forward, no f32 one), logits bf16, finite; the f32 twin's
    (the same weights widened) last-position distance printed; the bf16
    per-sublayer check along the forward; 4 greedy requests through bf16
    decode steps.  ``cfg``: the f32 config; ``f32``: the f32 prefill's
    figures of this call."""
    from repro_torch.distributed import steps
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import api
    from repro_torch.models.base import init_params

    cfg = cfg.replace(dtype="bfloat16")
    n_att = cfg.enc_layers + 2 * cfg.dec_layers
    params = init_params(api.params(cfg), torch.Generator(device="cuda")
                         .manual_seed(0), device="cuda",
                         dtype=torch.bfloat16)
    tokens, src = encdec_inputs(torch, cfg, ENCDEC_BATCH, ENCDEC_SEQ,
                                ENCDEC_SEQ, 39, torch.bfloat16)
    prefill = steps.make_prefill_step(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        logits, nxt = prefill(params, {"tokens": tokens, "src": src})
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = dict(fa.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    if launches != {"flash_attention": 0,
                    "flash_attention_bf16": 2 * n_att}:
        raise AssertionError(f"encdec bf16 prefill: launches {launches}")
    if logits.dtype != torch.bfloat16 or not bool(
            torch.isfinite(logits).all()) or tuple(logits.shape) != (
            ENCDEC_BATCH, ENCDEC_SEQ, cfg.vocab):
        raise AssertionError(f"encdec bf16 prefill: logits "
                             f"{tuple(logits.shape)} {logits.dtype}")
    last = logits[:, -1].float()
    del logits
    torch.cuda.empty_cache()
    with torch.no_grad():
        f32_logits, f32_nxt = steps.make_prefill_step(
            cfg.replace(dtype="float32"))(widened(params), {
                "tokens": tokens, "src": src.float()})
    f32_last = f32_logits[:, -1]
    del f32_logits
    torch.cuda.empty_cache()
    dist = ((last - f32_last).abs().max() / f32_last.abs().max()).item()
    worst = encdec_bf16_layers(torch, cfg, params, src, tokens)
    req = bf16_requests(torch, cfg, params)
    print(f"encdec bf16: prefill {ENCDEC_BATCH} x {ENCDEC_SEQ} over "
          f"{ENCDEC_SEQ} bf16 frames {times[1]:.1f} ms a forward (first "
          f"{times[0]:.1f} ms; f32 {f32['ms']:.1f} ms, peak "
          f"{f32['peak']:.2f} GiB), peak {peak:.2f} GiB; launches in 2 "
          f"forwards {launches}; last-position logits vs the f32 twin "
          f"{dist:.3e} of max|f32| (printed), next tokens {nxt.tolist()} "
          f"vs {f32_nxt.tolist()}")
    print("encdec bf16 sublayers along the bf16 forward, bf16 vs f32 on the "
          "same bf16 input, worst of each kind (checked: MLPs "
          f"{LM_BF16_TOLERANCE:g}, kernel cores {FLASH_BF16_TOLERANCE:g}; "
          "whole attention sublayers printed): " + ", ".join(
              f"{k} {v:.2e}" for k, v in worst.items()))
    print(f"encdec bf16: {BF16_REQUESTS} requests, {BF16_PROMPT}-token "
          f"prompts, {BF16_GEN} greedy tokens through bf16 decode steps: "
          f"{req['ms_step']:.2f} ms a step; tokens {req['tokens']}")
    del params
    torch.cuda.empty_cache()
    return dict(ms=times[1], first_ms=times[0], peak=peak, dist=dist,
                worst=worst, launches=launches["flash_attention_bf16"],
                **req)


def encdec_bwd_layer_check(torch, cfg, params) -> dict:
    """Along the f32 flash forward of one row of BWD_F64_POSITIONS tokens
    over as many frames, each of the 72 attention sublayers' backward at
    its own q, k, v and a seeded cotangent: on the kernels, on autograd
    of the f32 ref oracle and of float64 attention; the kernels' error of
    max|f64 grad| at most max(F64_FACTOR x ref's, ATTN_TOLERANCE)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.models import layers as L
    from repro_torch.testing import float64
    tokens, src = encdec_inputs(torch, cfg, 1, BWD_F64_POSITIONS,
                                BWD_F64_POSITIONS, 40, torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(13)
    worst = {"kernel": 0.0, "ref": 0.0, "ratio": 0.0}
    n = 0
    with torch.no_grad():
        for stack, i, kind, p, h, causal, enc, pos in encdec_walk(
                torch, cfg, params, src, tokens):
            if kind == "mlp":
                continue
            q, k, v = encdec_qkv(torch, L, p, h, cfg, enc, pos)
            do = torch.randn(q.shape, generator=gen, device="cuda")
            grads = {}
            with torch.enable_grad():
                for name, fn, dt in (
                        ("kernel", lambda a, b, c: fa.flash_attention(
                            a, b, c, causal=causal), torch.float32),
                        ("ref", lambda a, b, c: ref.attention(
                            a, b, c, causal=causal), torch.float32),
                        ("f64", lambda a, b, c: float64.attention(
                            a, b, c, causal=causal), torch.float64)):
                    lv = [t.to(dt).requires_grad_() for t in (q, k, v)]
                    grads[name] = torch.autograd.grad(fn(*lv), lv,
                                                      do.to(dt))
            for g64, gk, gr in zip(grads["f64"], grads["kernel"],
                                   grads["ref"]):
                scale = g64.abs().max().item()
                ek = (gk.double() - g64).abs().max().item() / scale
                er = (gr.double() - g64).abs().max().item() / scale
                lim = max(F64_FACTOR * er, ATTN_TOLERANCE)
                if not ek <= lim:
                    raise AssertionError(
                        f"encdec train {stack} layer {i} {kind}: the "
                        f"backward on the kernels is {ek:.3e} of max|f64 "
                        f"grad| from float64, ref {er:.3e}: above {lim:.3e}")
                worst["kernel"] = max(worst["kernel"], ek)
                worst["ref"] = max(worst["ref"], er)
                worst["ratio"] = max(worst["ratio"], ek / max(er, 1e-30))
            n += 1
            del grads, q, k, v, do
    worst["sublayers"] = n
    return worst


def encdec_steps(torch, cfg, state, opt, dtype, n) -> dict:
    """``n`` timed AdamW steps of ``steps.make_train_step`` on ``state``
    (ENCDEC_TRAIN_BATCH x ENCDEC_TRAIN_SEQ - 1 copy-task tokens over
    ENCDEC_TRAIN_SRC frames of ``dtype`` a row): losses, grad norms, ms a
    step (host clock, synchronised), peak, launches a step of the route's
    flash kernels."""
    from repro_torch.data import DataConfig, SyntheticStream
    from repro_torch.distributed import steps
    from repro_torch.kernels import flash_attention as fa
    bf16 = dtype == torch.bfloat16
    stream = SyntheticStream(DataConfig(batch=ENCDEC_TRAIN_BATCH,
                                        seq=ENCDEC_TRAIN_SEQ,
                                        vocab=cfg.vocab, task="copy"))
    rng = np.random.default_rng(41)
    step_fn = steps.make_train_step(cfg, opt)
    out = {"losses": [], "grad_norms": [], "step_ms": [], "per_step": []}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(n):
        b_ = {k: torch.from_numpy(v).cuda() for k, v in next(stream).items()}
        b_["src"] = torch.from_numpy(rng.standard_normal(
            (ENCDEC_TRAIN_BATCH, ENCDEC_TRAIN_SRC, cfg.d_model)).astype(
            np.float32)).cuda().to(dtype)
        torch.cuda.synchronize()
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, b_)
        out["losses"].append(float(metrics["loss"]))
        torch.cuda.synchronize()
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        out["grad_norms"].append(float(metrics["grad_norm"]))
        out["per_step"].append({
            **route_counts(fa.LAUNCHES, bf16),
            **route_counts(fa.BWD_LAUNCHES, bf16)})
    out["peak"] = torch.cuda.max_memory_allocated() / 2**30
    out["steady_ms"] = float(np.mean(out["step_ms"][1:]))
    return out


def encdec_train(torch, cfg) -> dict:
    """Full-width seamless-m4t-large-v2 trained through
    ``steps.make_train_step`` (remat, flash forward and backward kernels;
    the trainer's entry point refuses the family: its stream feeds no
    ``src``), f32 then bf16 (params drawn in bf16, f32 moments):
    ENCDEC_TRAIN_STEPS timed steps each, every loss and every leaf
    finite, a step launching the forward 144 times (72 calls, remat) and
    the dQ and dK/dV kernels 72 times each (MHA: no partial sum); the
    grad norm as the reference computes it (an f32 sum of squares, inf
    at this depth under the JAX initialiser: ``train_clip_state``); then
    the same at the ENCDEC_TRAIN_CUT + ENCDEC_TRAIN_CUT-layer full-width
    cut, where every grad norm must be finite and the gradient reach mu
    and nu.  Before the
    f32 steps, on their initial params: the depth-1 cut's first-step
    gradients (the backward kernels against the plain backward in
    float64 on the same forward, flash against ref) and every attention
    sublayer's backward against float64 (:func:`encdec_bwd_layer_check`)."""
    from repro_torch.distributed import steps
    from repro_torch.models import api
    from repro_torch.models.base import init_params
    from repro_torch.optim import AdamWConfig, adamw

    assert cfg.remat
    n_att = cfg.enc_layers + 2 * cfg.dec_layers
    opt = AdamWConfig(lr=3e-3, warmup_steps=10,
                      decay_steps=ENCDEC_TRAIN_STEPS)
    torch.cuda.empty_cache()
    state = steps.init_train_state(
        cfg, opt, torch.Generator(device="cuda").manual_seed(0))

    c1 = cfg.replace(enc_layers=1, dec_layers=1, n_layers=2)
    tokens, src = encdec_inputs(torch, cfg, 1, ENCDEC_GRAD_TOKENS + 1,
                                ENCDEC_GRAD_SRC, 42, torch.float32)
    gbatch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:],
              "src": src}
    cut = lm_grads(torch, c1, encdec_cut(state["params"], 1), gbatch,
                   plain_bwd=True)
    cut_err, cut_leaf = cut["flash_ref"]
    bwd_err, bwd_leaf = cut["flash_plain_bwd"]
    plain32 = cut["plain_bwd32_plain_bwd"][0]
    if not (cut["finite"] and bwd_err <= BWD_TOLERANCE
            and bwd_err <= plain32 and cut_err <= LM_GRAD_TOLERANCE):
        raise AssertionError(
            f"encdec train: depth-1 gradients, backward kernels vs the "
            f"float64 plain backward {bwd_err:.3e} at {bwd_leaf} (tol "
            f"{BWD_TOLERANCE}, and at most the f32 plain's {plain32:.3e}), "
            f"flash vs ref {cut_err:.3e} at {cut_leaf} (tol "
            f"{LM_GRAD_TOLERANCE})")
    f64 = encdec_bwd_layer_check(torch, cfg, state["params"])
    print(f"encdec train: depth-1 cut first-step gradients (1 x "
          f"{ENCDEC_GRAD_TOKENS} tokens over {ENCDEC_GRAD_SRC} frames), of "
          f"each leaf's max: the backward kernels vs the float64 plain "
          f"backward {bwd_err:.2e} ({bwd_leaf}; tol {BWD_TOLERANCE:g}, f32 "
          f"plain vs it {plain32:.2e}), flash vs ref {cut_err:.2e} "
          f"({cut_leaf}; tol {LM_GRAD_TOLERANCE:g}), chunked vs ref "
          f"{cut['chunked_ref'][0]:.2e}; every attention sublayer's "
          f"backward ({f64['sublayers']}, 1 x {BWD_F64_POSITIONS} over as "
          f"many frames) vs float64: kernels' worst {f64['kernel']:.2e} of "
          f"max|f64 grad|, the f32 ref's {f64['ref']:.2e}, worst ratio "
          f"{f64['ratio']:.1f}")
    del gbatch, cut

    def fresh(c, dtype):
        """A train state of ``c`` from seed 0: params of ``dtype`` (norm
        scales f32), f32 moments."""
        params = init_params(api.params(c), torch.Generator(
            device="cuda").manual_seed(0), device="cuda", dtype=dtype)
        return {"params": params, "opt": adamw.init_moments(params, opt),
                "step": torch.zeros((), dtype=torch.int32, device="cuda")}

    def want(c, bf16):
        n = c.enc_layers + 2 * c.dec_layers
        w = {"flash_attention": 2 * n, "flash_attention_bwd_dkdv": n,
             "flash_attention_bwd_dq": n, "flash_attention_bwd_sum": 0}
        return {f"{k}_bf16": v for k, v in w.items()} if bf16 else w

    ccfg = cfg.replace(enc_layers=ENCDEC_TRAIN_CUT,
                       dec_layers=ENCDEC_TRAIN_CUT,
                       n_layers=2 * ENCDEC_TRAIN_CUT)
    out = {}
    for label, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        bf16 = dtype == torch.bfloat16
        for depth, c in (("full", cfg), ("cut", ccfg)):
            if state is None:
                state = fresh(c, dtype)
            r = encdec_steps(torch, c, state, opt, dtype, ENCDEC_TRAIN_STEPS)
            where = f"encdec {label} " + (
                "full width" if depth == "full" else
                f"{ENCDEC_TRAIN_CUT} + {ENCDEC_TRAIN_CUT}-layer full-width "
                "cut")
            # at full depth the f32 sum of squares may overflow (ROADMAP
            # Queue 3: the reference's arithmetic, kept); the cut's must
            # not, and its gradient must reach mu and nu
            clip = train_clip_state(torch, state, r["grad_norms"], where)
            n_bf16 = sum(t.dtype == torch.bfloat16
                         for t in adamw.tree_leaves(state["params"]))
            state = None
            torch.cuda.empty_cache()
            if any(x != want(c, bf16) for x in r["per_step"]) or \
                    not np.isfinite(r["losses"]).all() or \
                    (n_bf16 > 0) != bf16 or (depth == "cut" and not (
                        np.isfinite(r["grad_norms"]).all()
                        and min(clip["scales"]) > 0)):
                raise AssertionError(
                    f"{where}: launches a step {r['per_step']}, want "
                    f"{want(c, bf16)}; losses {r['losses']}, grad norms "
                    f"{r['grad_norms']}, clip scales {clip['scales']}")
            print(f"{where} (remat), batch {ENCDEC_TRAIN_BATCH} x "
                  f"{ENCDEC_TRAIN_SEQ - 1} tokens over {ENCDEC_TRAIN_SRC} "
                  f"frames, {ENCDEC_TRAIN_STEPS} AdamW steps: losses "
                  f"{[round(x, 4) for x in r['losses']]}, grad norms "
                  f"{r['grad_norms']}, ms a step "
                  f"{[round(x, 1) for x in r['step_ms']]} (steady "
                  f"{r['steady_ms']:.1f}), peak {r['peak']:.2f} GiB; "
                  f"launches a step {r['per_step'][0]}")
            out[f"{label}_{depth}" if depth == "cut" else label] = dict(
                r, clip=clip, launches={
                    k: sum(x[k] for x in r["per_step"])
                    for k in want(c, bf16)})
    out.update(cut_err=cut_err, bwd_err=bwd_err, bwd_f64=f64)
    return out


def encdec_flash_times(torch) -> dict:
    """The flash kernel at seamless-m4t-large-v2's calls (batch 2, MHA 16
    heads, D 64), f32 and bf16, device ms from CUDA graphs: the forward
    at ENCDEC_FWD_TIMES beside SDPA on the same call (CUDA graphs) and
    the bound (f32: the 3xTF32 route's, :func:`attention_bound`; bf16: 989
    TFLOP/s or 2 bytes an element); the backward (dQ and dK/dV launches,
    each and together) at ENCDEC_BWD_TIMES beside SDPA's backward on the
    same call (events) and the bound of :func:`flash_bwd_bounds` (3xTF32)
    / :func:`flash_bwd_bounds_bf16`.  Correctness at these shapes is the
    attention and flash backward checks' (the s_* cases)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(39)
    sdpa = F.scaled_dot_product_attention
    b, h, d = 2, 16, 64
    rows = {}
    print("encdec flash times (seamless calls, batch 2, 16 x 16 heads, D 64;"
          " ms: kernel and SDPA forward from CUDA graphs, SDPA backward "
          "events):")
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        for name, lq, lk, causal in ENCDEC_FWD_TIMES:
            q = torch.randn((b, lq, h, d), generator=gen,
                            device="cuda").to(dtype)
            k, v = (torch.randn((b, lk, h, d), generator=gen,
                                device="cuda").to(dtype) for _ in range(2))
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            kernel = time_graph_ms(torch, lambda: fa.flash_attention(
                q, k, v, causal=causal), reps=5)
            library = time_graph_ms(torch, lambda: sdpa(
                qt, kt, vt, is_causal=causal), reps=5)
            bound, by, flops, nbytes, _ = attention_bound(b, lq, lk, h, h, d,
                                                          causal, None)
            if dtype == torch.bfloat16:
                bd = bf16_bound(flops, nbytes // 2)
                bound, by = bd["bound"], bd["by"]
            rows[(tag, name)] = dict(ms=kernel, library=library,
                                     bound=bound, by=by)
            print(f"  {tag:4s} fwd {name:12s} Lq {lq} Lk {lk} "
                  f"{'causal' if causal else 'non-causal':10s} kernel "
                  f"{kernel:.3f} SDPA {library:.3f} bound {bound:.3f} ({by})"
                  f" {flops / kernel / 1e9:.1f} TFLOP/s")
            del q, k, v, qt, kt, vt
        for name, lq, lk, causal in ENCDEC_BWD_TIMES:
            q, do = (torch.randn((b, lq, h, d), generator=gen,
                                 device="cuda").to(dtype) for _ in range(2))
            k, v = (torch.randn((b, lk, h, d), generator=gen,
                                device="cuda").to(dtype) for _ in range(2))
            kw = dict(causal=causal, soft_cap=None, window=None)
            lse = torch.empty((b, h, lq), device="cuda")
            fa._launch_forward(q, k, v, causal, None, None, lse)
            stats = torch.empty((2, b, h, lq), device="cuda")
            dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
            t = {"backward": time_graph_ms(torch, lambda: fa.
                                           flash_attention_backward(
                                               q, k, v, lse, do, **kw),
                                           reps=5),
                 "dq": time_graph_ms(torch, lambda: fa._launch_backward(
                     "dq", q, k, v, do, lse, stats, (dq,), **kw), reps=5),
                 "dkdv": time_graph_ms(torch, lambda: fa._launch_backward(
                     "dkdv", q, k, v, do, lse, stats, (dk, dv), **kw),
                     reps=5)}
            qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                          for x in (q, k, v))
            out = sdpa(qt, kt, vt, is_causal=causal)
            t["library"] = time_ms(torch, lambda: torch.autograd.grad(
                out, (qt, kt, vt), do.transpose(1, 2), retain_graph=True))
            if dtype == torch.bfloat16:
                bb = flash_bwd_bounds_bf16(b, lq, lk, h, h, d, causal, None)
                bounds = {p: bb[p] for p in ("backward", "dq", "dkdv")}
            else:
                bb = flash_bwd_bounds(b, lq, lk, h, h, d, causal, None)
                bounds = {p: bb[p]["tf32x3"] for p in ("backward", "dq",
                                                       "dkdv")}
            rows[(tag, name)] = dict(t, bounds=bounds)
            print(f"  {tag:4s} bwd {name:12s} Lq {lq} Lk {lk} "
                  f"{'causal' if causal else 'non-causal':10s} backward "
                  f"{t['backward']:.3f} (dq {t['dq']:.3f}, dkdv "
                  f"{t['dkdv']:.3f}) SDPA backward {t['library']:.3f} bound "
                  f"{bounds['backward'][0]:.3f} (dq "
                  f"{bounds['dq'][0]:.3f}, dkdv {bounds['dkdv'][0]:.3f}; "
                  f"{bounds['backward'][1]})")
            del q, k, v, do, lse, stats, dq, dk, dv, out, qt, kt, vt
    torch.cuda.empty_cache()
    return rows


def encdec_phase(torch) -> dict:
    """Phase 39 (module docstring)."""
    torch.cuda.empty_cache()
    out = {"times": encdec_flash_times(torch)}
    pre = encdec_prefill(torch)
    served = family_serve(torch, "encdec", pre["cfg"], pre["params"], 39)
    cfg = pre.pop("cfg")
    del pre["params"]
    torch.cuda.empty_cache()
    bf = encdec_bf16(torch, cfg, pre)
    tr = encdec_train(torch, cfg)
    out.update(prefill=pre, served=served, bf16=bf, train=tr)
    launches = {"flash_attention": pre["launches"],
                "flash_attention_bf16": bf["launches"]}
    for run in ("f32", "f32_cut", "bf16", "bf16_cut"):
        for k, v in tr[run]["launches"].items():
            launches[k] = launches.get(k, 0) + v
    out["launches"] = launches
    print(f"encdec: launches of the phase's main paths {launches} (two f32 "
          f"and two bf16 prefills; {ENCDEC_TRAIN_STEPS} training steps at "
          f"full depth and at the cut, in f32 and in bf16)")
    return out


# ---------------------------------------------------------------------------
# moe: qwen3-moe-30b-a3b and phi3.5-moe-42b-a6.6b, the MoE family (phase 40)
# ---------------------------------------------------------------------------

MOE_ARCH, MOE_PHI = "qwen3-moe-30b-a3b", "phi3.5-moe-42b-a6.6b"
# the bf16 prefill at full width: 2 x 4096 tokens
MOE_BATCH, MOE_SEQ = 2, 4096
# the depth cuts held sublayer by sublayer against the float64 oracle, on
# batch row 0's first MOE_CHECK_TOKENS tokens
MOE_CUTS = (1, 2)
MOE_CHECK_TOKENS = 512
# serve_batch in f32 at a full-width cut: 8 of 48 layers (5.6 B, 22.4 GB)
MOE_F32_CUT = 8
# decode steps of batch 4 held against the float64 oracle's decode (the
# f32 cut's first MOE_DECODE_CUT layers)
MOE_DECODE_STEPS, MOE_DECODE_CUT = 6, 2
# training: 4 of 48 layers at full width (3.11 B), 2 x 1024 tokens
MOE_TRAIN_CUT, MOE_TRAIN_BATCH, MOE_TRAIN_STEPS = 4, 2, 3
# the depth-1 cut's first-step gradients: 1 x 256 tokens
MOE_GRAD_TOKENS = 256
# phi3.5-moe-42b-a6.6b in bf16: 16 of 32 layers (21.1 B), 2 x 2048
MOE_PHI_CUT, MOE_PHI_BATCH, MOE_PHI_SEQ = 16, 2, 2048
# the flash kernel at qwen3-moe-30b-a3b's prefill call (B, L, Hq, Hkv, D)
MOE_FLASH_CALL = (2, 4096, 32, 4, 128)


def moe_tokens(torch, cfg, batch, seq, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, cfg.vocab, (batch, seq))).cuda()


def moe_capacity(cfg, tg) -> int:
    """``moe_apply``'s buffer rows an expert for a group of ``tg``
    tokens."""
    import math
    return max(int(math.ceil(tg * cfg.top_k / cfg.n_experts
                             * cfg.capacity_factor)), 1)


def moe_drops(torch, cfg, routes, tg) -> list:
    """The choices dropped at capacity in each recorded layer's routing
    (``layers.moe_dispatch`` on the recorded experts)."""
    from repro_torch.models import layers as L
    cap = moe_capacity(cfg, tg)
    return [int((L.moe_dispatch(r, cfg.n_experts, cap)[0]
                 == cfg.n_experts * cap).sum()) for r in routes]


def moe_flash_times(torch) -> dict:
    """The flash kernel at qwen3-moe-30b-a3b's prefill call (B 2, L 4096,
    Hq 32, Hkv 4, D 128, causal), f32 and bf16: the f32 kernel against its
    plain version within ``ATTN_TOLERANCE`` of max|plain|, the bf16 one
    within ``FLASH_BF16_TOLERANCE`` of its plain version and past half a
    bf16 ulp of the float64 plain version by at most
    ``FLASH_BF16_F64_EXCESS``; device ms from CUDA graphs beside SDPA on
    the same call (GQA, CUDA graphs), the plain version's (eager) and the
    bound (f32: the 3xTF32 route's; bf16: 989 TFLOP/s)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    b, length, hq, hkv, d = MOE_FLASH_CALL
    gen = torch.Generator(device="cuda").manual_seed(40)
    kw = dict(causal=True, soft_cap=None, window=None)
    rows = {}
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        q = torch.randn((b, length, hq, d), generator=gen,
                        device="cuda").to(dtype)
        k, v = (torch.randn((b, length, hkv, d), generator=gen,
                            device="cuda").to(dtype) for _ in range(2))
        out = fa.flash_attention(q, k, v, **kw)
        plain = fa.flash_attention_plain(q, k, v, **kw)
        err = ((out.float() - plain.float()).abs().max()
               / plain.float().abs().max()).item()
        tol = ATTN_TOLERANCE if tag == "f32" else FLASH_BF16_TOLERANCE
        excess = None
        if tag == "bf16":
            excess = flash_bf16_f64_excess(torch, out, q, k, v, kw)
        if not np.isfinite(err) or err > tol or (
                excess is not None and not excess <= FLASH_BF16_F64_EXCESS):
            raise AssertionError(f"moe flash {tag}: {err:.3e} of max|plain| "
                                 f"from the plain version (tol {tol}), past "
                                 f"half a bf16 ulp of float64 {excess}")
        del out, plain
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        t = {"ms": time_graph_ms(torch, lambda: fa.flash_attention(
                q, k, v, **kw), reps=5),
             "library": time_graph_ms(torch, lambda: F.
                                      scaled_dot_product_attention(
                                          qt, kt, vt, is_causal=True,
                                          enable_gqa=True), reps=5),
             "plain": time_ms(torch, lambda: fa.flash_attention_plain(
                 q, k, v, **kw), reps=2)}
        bound, by, flops, nbytes, _ = attention_bound(b, length, length, hq,
                                                      hkv, d, True, None)
        if tag == "bf16":
            bd = bf16_bound(flops, nbytes // 2)
            bound, by = bd["bound"], bd["by"]
        rows[tag] = dict(t, bound=bound, by=by, err=err, excess=excess,
                         tflops=flops / t["ms"] / 1e9)
        print(f"moe flash {tag} at qwen3-moe's prefill call (B {b}, L "
              f"{length}, Hq {hq}, Hkv {hkv}, D {d}, causal): kernel "
              f"{t['ms']:.3f} ms (CUDA graphs), SDPA {t['library']:.3f}, "
              f"plain {t['plain']:.3f}, bound {bound:.3f} ({by}); "
              f"{flops / t['ms'] / 1e9:.1f} TFLOP/s; {err:.2e} of max|plain|"
              f" from the plain version" + ("" if excess is None else
                                           f", past half a bf16 ulp of "
                                           f"float64 {excess:.2e}"))
        del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    return rows


def moe_layer_check(torch, cfg, params, tokens, cuts=MOE_CUTS) -> dict:
    """Along the bf16 forward of batch row 0's first MOE_CHECK_TOKENS
    tokens, each of the first max(``cuts``) layers' sublayers: attention
    on the flash kernel against ``attn_impl="ref"`` (printed) and its
    core, the bf16 kernel on the sublayer's own q, k, v, against the f32
    kernel (``FLASH_BF16_TOLERANCE``) and past half a bf16 ulp of the
    float64 plain version (``FLASH_BF16_F64_EXCESS``); the MoE sublayer
    against the float64 oracle on its own routing (bf16 within
    ``LM_BF16_TOLERANCE``, the f32 twin on the same bf16 input and routing
    within ``LM_LAYER_TOLERANCE``; the routes the f32 twin would pick
    printed); each block bitwise ``transformer.block_apply``.  At each
    cut the residual stream against the float64 oracle's on the same
    routing (printed, finite)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.testing import float64
    c32, cref = cfg.replace(dtype="float32"), cfg.replace(attn_impl="ref")
    toks = tokens[:1, :MOE_CHECK_TOKENS]
    pos = torch.arange(toks.shape[1], device="cuda")[None]
    kw = dict(causal=True, soft_cap=None, window=None)
    rows, streams = [], {}

    def rel(a, b):
        return ((a.double() - b.double()).abs().max()
                / b.double().abs().max()).item()
    with torch.no_grad():
        x0 = x = L.embed_apply(params["tok"], toks, cfg)
        blocks = T.layer_list(params["blocks"], cfg.n_layers)
        for i, pb in enumerate(blocks[:max(cuts)]):
            h = L.norm_apply(pb["ln_att"], x, cfg)
            ab = L.attention_apply(pb["att"], h, cfg, positions=pos)
            ar = L.attention_apply(pb["att"], h, cref, positions=pos)
            q, k = (L.rope(torch.einsum("bld,dhk->blhk", h, pb["att"][w]),
                           pos, cfg.rope_theta) for w in ("wq", "wk"))
            v = torch.einsum("bld,dhk->blhk", h, pb["att"]["wv"])
            ob = fa.flash_attention(q, k, v, **kw)
            e32 = rel(ob, fa.flash_attention(q.float(), k.float(),
                                             v.float(), **kw))
            excess = flash_bf16_f64_excess(torch, ob, q, k, v, kw)
            x1 = x + ab
            z = L.norm_apply(pb["ln_mlp"], x1, cfg)
            with float64.routes() as rec:
                yb, auxb = L.moe_apply(pb["moe"], z, cfg)
            wide = float64.widen(pb["moe"])
            with float64.float64(routes=rec):
                y64, aux64 = L.moe_apply(wide, z.double(), cfg)
            del wide
            with float64.float64(routes=rec):
                yf, _ = L.moe_apply(widened(pb["moe"]), z.float(), c32)
            with float64.routes() as rec32:
                L.moe_apply(widened(pb["moe"]), z.float(), c32)
            flips = int((rec[0] != rec32[0]).any(-1).sum())
            eb, ef = rel(yb, y64), rel(yf, y64)
            xb, _ = T.block_apply(pb, x, cfg, positions=pos)
            x = x1 + yb
            if not torch.equal(x, xb):
                raise AssertionError(f"moe layer check: layer {i}'s walk is "
                                     "not transformer.block_apply's")
            row = dict(layer=i, attn_vs_ref=rel(ab, ar), kernel_vs_f32=e32,
                       excess=excess, moe_bf16=eb, moe_f32=ef, flips=flips,
                       aux=auxb.item(), aux64=aux64.item(),
                       drops=moe_drops(torch, cfg, rec, toks.shape[1])[0])
            rows.append(row)
            if not (np.isfinite(eb) and e32 <= FLASH_BF16_TOLERANCE
                    and excess <= FLASH_BF16_F64_EXCESS
                    and eb <= LM_BF16_TOLERANCE
                    and ef <= LM_LAYER_TOLERANCE):
                raise AssertionError(f"moe layer check {cfg.name}: {row}")
            del h, ab, ar, q, k, v, ob, z, yb, y64, yf
            if i + 1 in cuts:
                cut = depth_cut(params, i + 1)["blocks"]
                with float64.routes() as rc:
                    xs, _ = T._run_blocks(cut, x0, cfg, positions=pos,
                                          n_layers=i + 1)
                if not torch.equal(xs, x):
                    raise AssertionError(f"moe layer check: the walk's "
                                         f"stream after {i + 1} layers is "
                                         "not transformer._run_blocks's")
                wide = float64.widen(cut)
                with float64.float64(routes=rc):
                    x64, _ = T._run_blocks(wide, x0.double(), cref,
                                           positions=pos, n_layers=i + 1)
                del wide
                streams[i + 1] = rel(xs, x64)
                if not np.isfinite(streams[i + 1]):
                    raise AssertionError(f"moe depth-{i + 1} cut: stream "
                                         "not finite")
                del xs, x64
                torch.cuda.empty_cache()
    print(f"moe layer check {cfg.name} (bf16, batch row 0, "
          f"{toks.shape[1]} tokens; of max|ref| or max|f64|): " + "; ".join(
              f"layer {r['layer']}: attention flash vs ref "
              f"{r['attn_vs_ref']:.2e}, kernel bf16 vs f32 "
              f"{r['kernel_vs_f32']:.2e} (tol {FLASH_BF16_TOLERANCE:g}), past "
              f"half a bf16 ulp of f64 {r['excess']:.2e} (tol "
              f"{FLASH_BF16_F64_EXCESS:.1e}); MoE bf16 vs f64 "
              f"{r['moe_bf16']:.2e} (tol {LM_BF16_TOLERANCE:g}), f32 twin "
              f"vs f64 {r['moe_f32']:.2e} (tol {LM_LAYER_TOLERANCE:g}), "
              f"{r['flips']} of {toks.shape[1]} tokens routed otherwise by "
              f"the f32 twin, {r['drops']} choices dropped, aux "
              f"{r['aux']:.6f} (f64 {r['aux64']:.6f})" for r in rows)
          + "; the residual stream vs the float64 oracle on the same "
          "routing: " + ", ".join(f"depth-{n} cut {e:.2e}"
                                  for n, e in streams.items()))
    return dict(rows=rows, streams=streams)


def moe_bf16_requests(torch, cfg, params) -> dict:
    """``bf16_requests`` (BF16_REQUESTS greedy requests through bf16
    decode steps) and the decode step's device-busy share
    (``device_share``: torch.profiler over 2 steps after a warm-up, each
    step one group of BF16_REQUESTS tokens through every layer)."""
    from repro_torch.distributed import steps
    from repro_torch.models import api
    from repro_torch.models.base import init_params
    req = bf16_requests(torch, cfg, params)
    b = BF16_REQUESTS
    state = init_params(api.decode_state(cfg, b, 8), torch.Generator(),
                        device="cuda", dtype=torch.bfloat16)
    decode = steps.make_decode_step(cfg)
    toks = moe_tokens(torch, cfg, b, 8, 41)
    t = [0]

    def step():
        t[0] = t[0] % 7 + 1
        decode(params, state, {
            "tokens": toks[:, t[0] - 1:t[0]],
            "cache_len": torch.full((b,), t[0], dtype=torch.int32,
                                    device="cuda")})
    busy = device_share(torch, step)
    del state
    return dict(req, busy=busy)


def moe_prefill(torch) -> dict:
    """Full-width qwen3-moe-30b-a3b drawn in bf16 on the card (the expert
    leaves a layer slice at a time): two timed bf16 prefills through
    ``make_prefill_step`` at MOE_BATCH x MOE_SEQ (48 ``flash_attention_bf16``
    launches a forward, none of the f32 route), finite bf16 logits, ms and
    peak; a third forward through ``api.forward`` recording each layer's
    routing: the choices dropped a layer and the aux; the sublayer check
    at MOE_CUTS; BF16_REQUESTS greedy requests through bf16 decode steps
    and the decode step's device-busy share."""
    from repro_torch.configs import registry
    from repro_torch.distributed import steps
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import api
    from repro_torch.models.base import init_params
    from repro_torch.testing import float64

    cfg = registry.get(MOE_ARCH).CONFIG.replace(dtype="bfloat16")
    assert cfg.attn_impl == "flash" and cfg.family == "moe"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(api.params(cfg), torch.Generator(device="cuda")
                         .manual_seed(0), device="cuda",
                         dtype=torch.bfloat16)
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    draw_peak = torch.cuda.max_memory_allocated() / 2**30
    tokens = moe_tokens(torch, cfg, MOE_BATCH, MOE_SEQ, 40)
    prefill = steps.make_prefill_step(cfg)
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        logits, nxt = prefill(params, {"tokens": tokens})
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = dict(fa.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    if launches != {"flash_attention": 0,
                    "flash_attention_bf16": 2 * cfg.n_layers}:
        raise AssertionError(f"moe prefill: launches {launches} in 2 "
                             f"forwards, want {cfg.n_layers} bf16 each")
    if logits.dtype != torch.bfloat16 or tuple(logits.shape) != (
            MOE_BATCH, MOE_SEQ, cfg.vocab) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"moe prefill: logits {tuple(logits.shape)} "
                             f"{logits.dtype}, not finite or of the wrong "
                             "shape or type")
    del logits
    torch.cuda.empty_cache()
    with float64.routes() as rec, torch.no_grad():
        logits, aux = api.forward(params, {"tokens": tokens}, cfg)
    del logits
    drops = moe_drops(torch, cfg, rec, MOE_SEQ)
    cap = moe_capacity(cfg, MOE_SEQ)
    del rec
    torch.cuda.empty_cache()
    if len(drops) != cfg.n_layers or not np.isfinite(aux.item()):
        raise AssertionError(f"moe prefill: {len(drops)} routed layers, aux "
                             f"{aux.item()}")
    print(f"moe: {cfg.name} full width ({cfg.n_layers} layers, "
          f"{cfg.n_experts} experts top {cfg.top_k}), "
          f"{registry.count_params(cfg):,} parameters drawn in bf16 on the "
          f"card in {draw_s:.2f} s (peak {draw_peak:.2f} GiB); bf16 prefill "
          f"{MOE_BATCH} x {MOE_SEQ} {times[1]:.1f} ms a forward (first "
          f"{times[0]:.1f} ms), peak {peak:.2f} GiB; launches in 2 forwards "
          f"{launches}; next tokens {nxt.tolist()}; capacity {cap} rows an "
          f"expert a sequence; choices dropped a layer (of "
          f"{MOE_BATCH * MOE_SEQ * cfg.top_k}) {drops}; aux summed over "
          f"the layers {aux.item():.6f}")
    check = moe_layer_check(torch, cfg, params, tokens)
    req = moe_bf16_requests(torch, cfg, params)
    busy = req["busy"]
    print(f"moe: {BF16_REQUESTS} requests, {BF16_PROMPT}-token prompts, "
          f"{BF16_GEN} greedy tokens through bf16 decode steps (one group "
          f"of {BF16_REQUESTS} tokens a layer, capacity "
          f"{moe_capacity(cfg, BF16_REQUESTS)}): {req['ms_step']:.2f} ms a "
          f"step; profiled step {busy['device_ms']:.2f} ms of device time in "
          f"{busy['wall_ms']:.2f} ms ({busy['device_ms'] / busy['wall_ms']:.1%}"
          f" busy, {busy['kernels']:.0f} kernels; top "
          f"{[(n[:40], round(t, 3)) for n, t in busy['top'][:3]]}); tokens "
          f"{req['tokens']}")
    del params
    torch.cuda.empty_cache()
    return dict(ms=times[1], first_ms=times[0], peak=peak, draw_s=draw_s,
                draw_peak=draw_peak, launches=launches["flash_attention_bf16"],
                drops=drops, aux=aux.item(), check=check, **req)


def moe_f32_cut(torch) -> dict:
    """qwen3-moe-30b-a3b in f32 at the full-width MOE_F32_CUT-layer cut:
    ``serve_batch`` (``family_serve``: f32, as JAX's entry point forces);
    then MOE_DECODE_STEPS decode steps of batch 4 at its first
    MOE_DECODE_CUT layers, each step's logits against the float64
    oracle's decode on the same routing (``LM_TOLERANCE``), the greedy
    tokens the oracle's unless its top two lie within twice that."""
    from repro_torch.configs import registry
    from repro_torch.models import api
    from repro_torch.models.base import init_params
    from repro_torch.testing import float64

    cfg = registry.get(MOE_ARCH).CONFIG.replace(n_layers=MOE_F32_CUT)
    torch.cuda.empty_cache()
    params = init_params(api.params(cfg), torch.Generator(device="cuda")
                         .manual_seed(0), device="cuda")
    served = family_serve(torch, f"moe f32 {MOE_F32_CUT}-layer cut", cfg,
                          params, 40)
    c2 = cfg.replace(n_layers=MOE_DECODE_CUT)
    p2 = depth_cut(params, MOE_DECODE_CUT)
    b = 4
    toks = moe_tokens(torch, cfg, b, MOE_DECODE_STEPS, 42)
    state = init_params(api.decode_state(c2, b, MOE_DECODE_STEPS),
                        torch.Generator(), device="cuda")
    wide = float64.widen(p2)
    s64 = float64.widen(init_params(api.decode_state(c2, b, MOE_DECODE_STEPS),
                                    torch.Generator(), device="cuda"))
    worst, drops = 0.0, 0
    with torch.no_grad():
        for t in range(MOE_DECODE_STEPS):
            batch = {"tokens": toks[:, t:t + 1],
                     "cache_len": torch.full((b,), t + 1, dtype=torch.int32,
                                             device="cuda")}
            with float64.routes() as rec:
                lg, state = api.decode(p2, batch, state, c2)
            drops += sum(moe_drops(torch, c2, rec, b))
            # float64_reference: decode_attention's .float() keeps float64
            with float64_reference(torch), float64.float64(routes=rec):
                l64, s64 = api.decode(wide, batch, s64,
                                      c2.replace(attn_impl="ref"))
            err = ((lg.double() - l64).abs().max()
                   / l64.abs().max()).item()
            worst = max(worst, err)
            lim = LM_TOLERANCE * l64.abs().max().item()
            if not np.isfinite(err) or err > LM_TOLERANCE or \
                    not same_tokens(lg[:, 0].argmax(-1), l64[:, 0].argmax(-1),
                                    l64[:, 0], lim):
                raise AssertionError(f"moe f32 decode step {t}: logits "
                                     f"{err:.3e} of max|f64| from the float64"
                                     f" oracle (tol {LM_TOLERANCE})")
    print(f"moe f32 decode ({MOE_DECODE_CUT}-layer full-width cut, batch "
          f"{b}: one group of {b} tokens a layer, capacity "
          f"{moe_capacity(c2, b)}, {drops} choices dropped over "
          f"{MOE_DECODE_STEPS} steps): logits vs the float64 oracle's decode"
          f" on the same routing, worst {worst:.2e} of max|f64| (tol "
          f"{LM_TOLERANCE:g}); greedy tokens the oracle's")
    del params, p2, wide, state, s64
    torch.cuda.empty_cache()
    return dict(served, decode_err=worst)


def moe_grads(torch, cfg, params, batch) -> list:
    """The loss's gradient of every leaf at ``params`` (flash, remat)."""
    from repro_torch.models import api
    from repro_torch.optim import adamw
    live = [t.detach().requires_grad_() for t in adamw.tree_leaves(params)]
    logits, aux = api.forward(adamw.tree_unflatten(params, live), batch, cfg)
    loss = api.loss_fn(logits, batch["labels"], aux)
    del logits
    return list(torch.autograd.grad(loss, live))


def moe_train(torch) -> dict:
    """qwen3-moe-30b-a3b at the full-width MOE_TRAIN_CUT-layer cut trained
    through ``steps.make_train_step`` (remat; flash forward and backward
    kernels), f32 then bf16 (params drawn in bf16, f32 moments): the
    gradient at 2 x 1024 taken twice, bitwise equal (no float atomics in
    the dispatch or combine); in f32 the depth-1 cut's first-step
    gradients (1 x MOE_GRAD_TOKENS; ``lm_grads``: the backward kernels
    against the float64 plain backward on the same forward,
    ``BWD_TOLERANCE``; flash vs ref printed: a route may flip between two
    forwards); MOE_TRAIN_STEPS timed AdamW steps, each launching the
    forward 8 times (4 calls, remat) and dQ, dK/dV and the heads' sum 4
    times each (G 8); every loss finite, the gradient reaching mu and nu."""
    from repro_torch.configs import registry
    from repro_torch.data import DataConfig, SyntheticStream
    from repro_torch.distributed import steps
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import api
    from repro_torch.models.base import init_params
    from repro_torch.optim import AdamWConfig, adamw

    cfg = registry.get(MOE_ARCH).CONFIG.replace(n_layers=MOE_TRAIN_CUT)
    assert cfg.remat
    opt = AdamWConfig(lr=3e-3, warmup_steps=10, decay_steps=MOE_TRAIN_STEPS)
    n = cfg.n_layers
    out = {}
    for label, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        bf16 = dtype == torch.bfloat16
        c = cfg.replace(dtype="bfloat16") if bf16 else cfg
        torch.cuda.empty_cache()
        params = init_params(api.params(c), torch.Generator(device="cuda")
                             .manual_seed(0), device="cuda", dtype=dtype)
        stream = SyntheticStream(DataConfig(batch=MOE_TRAIN_BATCH,
                                            seq=TRAIN_LM_SEQ,
                                            vocab=cfg.vocab, task="copy"))
        batches = [{k: torch.from_numpy(v).cuda()
                    for k, v in next(stream).items()}
                   for _ in range(MOE_TRAIN_STEPS)]
        g1 = moe_grads(torch, c, params, batches[0])
        g2 = moe_grads(torch, c, params, batches[0])
        repeat = all(torch.equal(a, b) for a, b in zip(g1, g2))
        finite = all(bool(torch.isfinite(g).all()) for g in g1)
        del g1, g2
        torch.cuda.empty_cache()
        if not (repeat and finite):
            raise AssertionError(f"moe train {label}: the gradient taken "
                                 f"twice bitwise equal {repeat}, finite "
                                 f"{finite}")
        cut = None
        if not bf16:
            c1 = cfg.replace(n_layers=1)
            toks = moe_tokens(torch, cfg, 1, MOE_GRAD_TOKENS + 1, 43)
            cut = lm_grads(torch, c1, depth_cut(params, 1),
                           {"tokens": toks[:, :-1], "labels": toks[:, 1:]},
                           plain_bwd=True)
            bwd_err, bwd_leaf = cut["flash_plain_bwd"]
            plain32 = cut["plain_bwd32_plain_bwd"][0]
            if not (cut["finite"] and bwd_err <= BWD_TOLERANCE
                    and bwd_err <= plain32):
                raise AssertionError(
                    f"moe train: depth-1 gradients, backward kernels vs the "
                    f"float64 plain backward {bwd_err:.3e} at {bwd_leaf} "
                    f"(tol {BWD_TOLERANCE}, and at most the f32 plain's "
                    f"{plain32:.3e})")
            print(f"moe train: depth-1 cut first-step gradients (1 x "
                  f"{MOE_GRAD_TOKENS} tokens), of each leaf's max: the "
                  f"backward kernels vs the float64 plain backward "
                  f"{bwd_err:.2e} ({bwd_leaf}; tol {BWD_TOLERANCE:g}, f32 "
                  f"plain vs it {plain32:.2e}); flash vs ref "
                  f"{cut['flash_ref'][0]:.2e} ({cut['flash_ref'][1]}), "
                  f"chunked vs ref {cut['chunked_ref'][0]:.2e} (printed: "
                  "two forwards may route a near-tied token apart)")
        state = {"params": params, "opt": adamw.init_moments(params, opt),
                 "step": torch.zeros((), dtype=torch.int32, device="cuda")}
        step_fn = steps.make_train_step(c, opt)
        want = {"flash_attention": 2 * n, "flash_attention_bwd_dkdv": n,
                "flash_attention_bwd_dq": n, "flash_attention_bwd_sum": n}
        if bf16:
            want = {f"{k}_bf16": v for k, v in want.items()}
        r = {"losses": [], "grad_norms": [], "step_ms": [], "per_step": []}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for b_ in batches:
            torch.cuda.synchronize()
            fa.reset_launch_counts()
            t0 = time.perf_counter()
            state, metrics = step_fn(state, b_)
            r["losses"].append(float(metrics["loss"]))
            torch.cuda.synchronize()
            r["step_ms"].append((time.perf_counter() - t0) * 1e3)
            r["grad_norms"].append(float(metrics["grad_norm"]))
            r["per_step"].append({**route_counts(fa.LAUNCHES, bf16),
                                  **route_counts(fa.BWD_LAUNCHES, bf16)})
        r["peak"] = torch.cuda.max_memory_allocated() / 2**30
        r["steady_ms"] = float(np.mean(r["step_ms"][1:]))
        where = f"moe {label} {MOE_TRAIN_CUT}-layer full-width cut"
        clip = train_clip_state(torch, state, r["grad_norms"], where)
        n_bf16 = sum(t.dtype == torch.bfloat16
                     for t in adamw.tree_leaves(state["params"]))
        del state, params, batches
        torch.cuda.empty_cache()
        if any(x != want for x in r["per_step"]) or \
                not np.isfinite(r["losses"]).all() or \
                not np.isfinite(r["grad_norms"]).all() or \
                min(clip["scales"]) <= 0 or (n_bf16 > 0) != bf16:
            raise AssertionError(
                f"{where}: launches a step {r['per_step']}, want {want}; "
                f"losses {r['losses']}, grad norms {r['grad_norms']}, clip "
                f"scales {clip['scales']}")
        print(f"{where} (remat), batch {MOE_TRAIN_BATCH} x "
              f"{TRAIN_LM_SEQ - 1}, {MOE_TRAIN_STEPS} AdamW steps: losses "
              f"{[round(x, 4) for x in r['losses']]}, grad norms "
              f"{r['grad_norms']}, ms a step "
              f"{[round(x, 1) for x in r['step_ms']]} (steady "
              f"{r['steady_ms']:.1f}), peak {r['peak']:.2f} GiB; launches a "
              f"step {r['per_step'][0]}; the gradient taken twice bitwise "
              "equal")
        out[label] = dict(r, clip=clip, cut=cut, launches={
            k: sum(x[k] for x in r["per_step"]) for k in want})
    return out


def moe_phi(torch) -> dict:
    """phi3.5-moe-42b-a6.6b (LayerNorm, 16 experts top 2, GQA 32 / 8) at
    the full-width MOE_PHI_CUT-layer cut in bf16: two timed prefills at
    MOE_PHI_BATCH x MOE_PHI_SEQ (MOE_PHI_CUT ``flash_attention_bf16``
    launches a forward), finite bf16 logits, ms and peak; the depth-1
    sublayer check; BF16_REQUESTS greedy requests through bf16 decode
    steps."""
    from repro_torch.configs import registry
    from repro_torch.distributed import steps
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import api
    from repro_torch.models.base import init_params

    cfg = registry.get(MOE_PHI).CONFIG.replace(dtype="bfloat16",
                                               n_layers=MOE_PHI_CUT)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = init_params(api.params(cfg), torch.Generator(device="cuda")
                         .manual_seed(0), device="cuda",
                         dtype=torch.bfloat16)
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    tokens = moe_tokens(torch, cfg, MOE_PHI_BATCH, MOE_PHI_SEQ, 44)
    prefill = steps.make_prefill_step(cfg)
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        logits, nxt = prefill(params, {"tokens": tokens})
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = dict(fa.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    if launches != {"flash_attention": 0,
                    "flash_attention_bf16": 2 * cfg.n_layers} or \
            logits.dtype != torch.bfloat16 or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"moe {cfg.name} prefill: launches {launches},"
                             f" logits {logits.dtype} finite "
                             f"{bool(torch.isfinite(logits).all())}")
    del logits
    torch.cuda.empty_cache()
    print(f"moe: {cfg.name} {MOE_PHI_CUT}-layer full-width cut, "
          f"{registry.count_params(cfg):,} parameters drawn in bf16 in "
          f"{draw_s:.2f} s; bf16 prefill {MOE_PHI_BATCH} x {MOE_PHI_SEQ} "
          f"{times[1]:.1f} ms a forward (first {times[0]:.1f} ms), peak "
          f"{peak:.2f} GiB; launches in 2 forwards {launches}; next tokens "
          f"{nxt.tolist()}")
    check = moe_layer_check(torch, cfg, params, tokens, cuts=(1,))
    req = bf16_requests(torch, cfg, params)
    print(f"moe: {cfg.name} cut, {BF16_REQUESTS} requests through bf16 "
          f"decode steps: {req['ms_step']:.2f} ms a step; tokens "
          f"{req['tokens']}")
    del params
    torch.cuda.empty_cache()
    return dict(ms=times[1], first_ms=times[0], peak=peak,
                launches=launches["flash_attention_bf16"], check=check, **req)


def moe_phase(torch) -> dict:
    """Phase 40 (module docstring)."""
    torch.cuda.empty_cache()
    out = {"times": moe_flash_times(torch)}
    out["prefill"] = moe_prefill(torch)
    out["f32"] = moe_f32_cut(torch)
    out["train"] = moe_train(torch)
    out["phi"] = moe_phi(torch)
    launches = {"flash_attention_bf16": out["prefill"]["launches"]
                + out["phi"]["launches"]}
    for run in ("f32", "bf16"):
        for k, v in out["train"][run]["launches"].items():
            launches[k] = launches.get(k, 0) + v
    out["launches"] = launches
    print(f"moe: launches of the phase's main paths {launches} (two bf16 "
          f"qwen3-moe and two phi3.5-moe prefills; {MOE_TRAIN_STEPS} "
          f"training steps each in f32 and bf16)")
    return out


# The paper phase (module docstring): the README's gates on the paper's
# §V comparison (3D-TrIM over TrIM in Ops/MAcc a slice), the slice
# simulator's ifmaps against the carry and halo kernels (P_O 8 slices of
# one core, K 3, one ifmap channel), and the whole-step shares' rows
PAPER_VGG_IMPROVEMENT = (3.0, 3.6)   # VGG-16's network improvement
PAPER_LAYER_LIMIT = 3.6              # no VGG-16 or AlexNet layer reaches it
PAPER_RESNET_FLOOR = 2.0             # ResNet-18's network improvement
PAPER_SIM_SHAPES = ((16, 16), (15, 23))
PAPER_SIM_FILTERS = 8


def paper_figures(where: str) -> dict:
    """(a) Fig. 1, Fig. 6 for VGG-16 and AlexNet and the §V network
    comparison of VGG-16, AlexNet, ResNet-18 and U-Net on the port's
    access model (``core/model.py``, ``core/netplan.py``; CPU
    arithmetic), with the README's gates."""
    from repro_torch.core import model as pm
    from repro_torch.core.netplan import NetworkGraph, NetworkPlan

    curve = pm.fig1_curve()
    print("paper: Fig. 1, TrIM's ifmap reads past one a pixel (K 3): "
          + ", ".join(f"{k}x{k} {v:.2f}%" for k, v in curve.items()))
    for net in ("vgg16", "alexnet"):
        print(f"paper: Fig. 6, {net}, Ops/access/slice 3D-TrIM | TrIM | "
              "improvement:")
        for row in pm.fig6(net):
            print(f"  {row['layer']:>18s} {row['3d-trim']:7.3f} "
                  f"{row['trim']:7.3f} {row['improvement']:6.3f}")
    arch = {net: NetworkPlan.build(net).arch_compare()
            for net in ("vgg16", "alexnet")}
    arch.update({net: NetworkGraph.build(net).arch_compare()
                 for net in ("resnet18", "unet")})
    for net, a in arch.items():
        best = max(r["improvement"] for r in a["layers"])
        print(f"paper: §V {net}: Ops/MAcc a slice 3D-TrIM "
              f"{a['ops_per_macc_per_slice']['3d-trim']:.4f}, TrIM "
              f"{a['ops_per_macc_per_slice']['trim']:.4f}: network "
              f"{a['improvement']:.4f}x, best layer {best:.4f}x "
              f"({len(a['layers'])} convs; CPU arithmetic, {where})")
    lo, hi = PAPER_VGG_IMPROVEMENT
    if not lo < arch["vgg16"]["improvement"] < hi:
        raise AssertionError(f"paper: VGG-16's improvement "
                             f"{arch['vgg16']['improvement']} outside "
                             f"({lo}, {hi})")
    for net in ("vgg16", "alexnet"):
        best = max(r["improvement"] for r in arch[net]["layers"])
        if not best < PAPER_LAYER_LIMIT:
            raise AssertionError(f"paper: a {net} layer reaches {best} >= "
                                 f"{PAPER_LAYER_LIMIT}")
    if not arch["resnet18"]["improvement"] > PAPER_RESNET_FLOOR:
        raise AssertionError(f"paper: ResNet-18's improvement "
                             f"{arch['resnet18']['improvement']} <= "
                             f"{PAPER_RESNET_FLOOR}")
    print(f"paper: gates held: VGG-16 {arch['vgg16']['improvement']:.4f} in "
          f"({lo}, {hi}), VGG-16 and AlexNet layers < {PAPER_LAYER_LIMIT}, "
          f"ResNet-18 {arch['resnet18']['improvement']:.4f} > "
          f"{PAPER_RESNET_FLOOR}")
    return {net: a["improvement"] for net, a in arch.items()}


def paper_roofline(tables: dict, where: str) -> list:
    """(b) Full-width VGG-16 and AlexNet through the port's
    ``NetworkPlan`` at each batch of ``tables`` (``{(net, n): rows}``:
    the kernel check's and the AlexNet table's rows, with ``carry`` and
    ``halo`` ms): per layer the bytes of ``"3dtrim"``, ``"trim"`` and
    the plan's own schedule, T_comp and T_mem (``core/roofline.py``), the
    measured carry and halo times, the roofline time over each, and the
    measured halo / carry ratio beside the modelled trim / 3dtrim bytes;
    then the network sums."""
    from repro_torch.core.netplan import NetworkPlan
    from repro_torch.core.roofline import conv_plan_roofline, \
        network_roofline

    out = []
    for (net, n), rows in tables.items():
        kw = dict(n=n, residency="never", fold_pooling=False)
        plan = NetworkPlan.build(net, **kw)
        halo = NetworkPlan.build(net, dataflow="halo", **kw)
        rows = [r for r in rows if r["name"] in {s.name for s in plan.steps}]
        if len(rows) != plan.n_layers:
            raise AssertionError(f"paper: {len(rows)} measured rows for "
                                 f"{plan.n_layers} layers of {net}")
        print(f"paper: {net} at batch {n}, per layer (MB; ms; roofline ms "
              f"over measured ms; {where}):")
        print(f"  {'layer':6s} {'3dtrim':>8s} {'trim':>8s} {'plan':>8s} "
              f"{'T_comp':>7s} {'T_mem':>7s} {'carry':>8s} {'halo':>8s} "
              f"{'roof/c':>6s} {'roof/h':>6s} {'h/c':>6s} {'trim/3d':>7s}")
        for st, hs, row in zip(plan.steps, halo.steps, rows):
            assert row["name"] == st.name, (row["name"], st.name)
            b = {m: st.plan.hbm_bytes(m)["total"]
                 for m in ("3dtrim", "trim", None)}
            t = conv_plan_roofline(st.name, st.plan)
            th = conv_plan_roofline(st.name, hs.plan)
            r = dict(net=net, n=n, layer=st.name, bytes_3dtrim=b["3dtrim"],
                     bytes_trim=b["trim"], bytes_plan=b[None],
                     t_comp_ms=t.t_compute * 1e3, t_mem_ms=t.t_memory * 1e3,
                     carry_ms=row["carry"], halo_ms=row["halo"],
                     carry_share=t.step_time_s * 1e3 / row["carry"],
                     halo_share=th.step_time_s * 1e3 / row["halo"],
                     ratio=row["halo"] / row["carry"],
                     model_ratio=b["trim"] / b["3dtrim"])
            out.append(r)
            print(f"  {st.name:6s} {b['3dtrim'] / 1e6:8.2f} "
                  f"{b['trim'] / 1e6:8.2f} {b[None] / 1e6:8.2f} "
                  f"{r['t_comp_ms']:7.4f} {r['t_mem_ms']:7.4f} "
                  f"{r['carry_ms']:8.4f} {r['halo_ms']:8.4f} "
                  f"{r['carry_share']:6.3f} {r['halo_share']:6.3f} "
                  f"{r['ratio']:6.3f} {r['model_ratio']:7.4f}")
        terms = network_roofline(net, plan)
        auto = network_roofline(net, NetworkPlan.build(net, n=n))
        carry = sum(r["carry"] for r in rows)
        print(f"paper: {net} at batch {n}, network: roofline (per layer, "
              f"every activation through device memory) "
              f"{terms.step_time_s * 1e3:.4f} ms (T_comp "
              f"{terms.t_compute * 1e3:.4f}, T_mem "
              f"{terms.t_memory * 1e3:.4f}), with the fused groups' "
              f"interiors on chip {auto.step_time_s * 1e3:.4f} ms; the "
              f"carry kernels' sum {carry:.4f} ms: "
              f"{terms.step_time_s * 1e3 / carry:.3f} of it")
    return out


def paper_slice_check(torch) -> dict:
    """(c) The paper's core (``dataflow.core_conv``: P_O slices over one
    ifmap channel, K 3, shared IRB) against ``trim_conv2d``'s carry and
    halo kernels on the same ifmap (Cin 1, Cout P_O, 'valid') within the
    f32 tolerance, and its reads against the access model; the kernels'
    launches counted from 0."""
    from repro_torch.core.conv_plan import slice_reads_per_channel
    from repro_torch.core.dataflow import core_conv
    from repro_torch.kernels import trim_conv2d as tc

    rng = np.random.default_rng(38)
    tc.reset_launch_counts()
    worst = 0.0
    for h, w in PAPER_SIM_SHAPES:
        ifmap = rng.standard_normal((h, w)).astype(np.float32)
        stack = rng.standard_normal((PAPER_SIM_FILTERS, 3, 3)).astype(
            np.float32)
        sim, reads = core_conv(ifmap.astype(np.float64),
                               stack.astype(np.float64), "3dtrim")
        _, reads_trim = core_conv(ifmap.astype(np.float64),
                                  stack.astype(np.float64), "trim")
        if reads != h * w or reads_trim != PAPER_SIM_FILTERS * \
                slice_reads_per_channel(h, w, 3, shadow=False):
            raise AssertionError(f"paper: core reads {reads} / "
                                 f"{reads_trim} at {h}x{w}")
        x = torch.from_numpy(ifmap).reshape(1, h, w, 1).cuda()
        wt = torch.from_numpy(np.ascontiguousarray(
            stack.transpose(1, 2, 0))).reshape(3, 3, 1, -1).cuda()
        want = sim.transpose(1, 2, 0)
        lim = TOLERANCE * max(1.0, float(np.abs(want).max()))
        err = 0.0
        for df in ("carry", "halo"):
            got = tc.trim_conv2d(x, wt, None, dataflow=df).cpu().numpy()[0]
            err_df = float(np.abs(got - want).max())
            if not err_df <= lim:
                raise AssertionError(f"paper: {df} kernel vs the slice "
                                     f"simulator at {h}x{w}: {err_df} > "
                                     f"{lim}")
            err = max(err, err_df)
        worst = max(worst, err)
        print(f"paper: core_conv {h}x{w}, P_O {PAPER_SIM_FILTERS}, K 3: "
              f"carry and halo kernels vs the simulator max|diff| "
              f"{err:.2e} <= {lim:.1e}; reads 3D-TrIM {reads} (shared "
              f"IRB, one a pixel), TrIM {reads_trim}")
    launches = {df: tc.LAUNCHES[df] for df in ("carry", "halo")}
    if launches != {"carry": 2, "halo": 2}:
        raise AssertionError(f"paper: kernel launches {launches}")
    return dict(err=worst, launches=launches)


def paper_shares(torch, rows: list, where: str) -> list:
    """(d) Model FLOPs (``registry.model_flops``) over the measured
    seconds times the peak of the path's type: f32 at 67 TFLOP/s (TF32
    off on the path), bf16 at 989.  Printed; a share above 1 means a
    wrong peak or count and raises."""
    from repro_torch.configs import registry

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("paper: the f32 shares assume TF32 off")
    out = []
    for label, arch, dtype, kind, batch, seq, ms in rows:
        flops = registry.model_flops(registry.get(arch).CONFIG, kind, batch,
                                     seq)
        peak = PEAK_BF16_FLOPS if dtype == "bf16" else PEAK_F32_FLOPS
        share = flops / (ms / 1e3 * peak)
        print(f"paper: {label} ({batch} x {seq}): {flops / 1e12:.2f} model "
              f"TFLOP in {ms:.1f} ms = {flops / (ms / 1e3) / 1e12:.1f} "
              f"TFLOP/s, {share:.3f} of {peak / 1e12:.0f} TFLOP/s "
              f"({where})")
        if not 0 < share <= 1:
            raise AssertionError(f"paper: {label} share {share}")
        out.append(dict(label=label, flops=flops, ms=ms, share=share))
    return out


def paper_phase(torch, tables: dict, shares: list) -> dict:
    """The paper phase (module docstring): (a) to (d) beside the card's
    name and power limit; no new full-width timing run."""
    where = card()
    return dict(improvement=paper_figures(where),
                roofline=paper_roofline(tables, where),
                slice=paper_slice_check(torch),
                shares=paper_shares(torch, shares, where))


def main() -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--step-times", type=int, metavar="N",
                    help="only build the kernels and time N full-width "
                         "VGG-16 AdamW steps and the weight-gradient "
                         "kernel (printed as one JSON line); no checks "
                         "beyond the train phase's launch counts")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # every phase on a fresh, empty autotune cache of this run's own: none
    # reads a cache an earlier run left, none leaves one for a later run
    import shutil
    import tempfile
    from repro_torch.core import autotune
    cache_dir = tempfile.mkdtemp(prefix="chip_smoke_convtune_")
    os.environ[autotune.CACHE_ENV] = os.path.join(cache_dir,
                                                  "convtune.json")
    os.environ.pop(autotune.AUTOTUNE_ENV, None)
    autotune.reset_memory_cache()
    try:
        return run(torch, args, cache_dir)
    finally:
        shutil.rmtree(cache_dir, ignore_errors=True)


def run(torch, args, cache_dir: str) -> int:
    """The phases (module docstring), on the autotune cache that
    :func:`main` set up."""
    from repro_torch.core.model import vgg16_layers
    from repro_torch.kernels import build
    from repro_torch.models.layers import TrimCNN

    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s)")
    print(card())
    phase = Phases()

    build.build_all(rebuild=True)
    phase.done("build")
    for src, log in build.build_log.items():
        print(f"  {src}: {log['command']}")
        for line in log["ptxas"]:
            print(f"    {line.strip()}")
    if args.step_times:
        print(json.dumps({"card": card(), **step_times(
            torch, max(args.step_times, 3))}))
        return 0
    flash_sass_check()

    rows = check_kernels(torch, 8)
    rows1 = check_kernels(torch, 1)
    phase.done("kernel check")
    q8_build = q8_build_check()
    qrows = check_q8_kernels(torch, 8, q8_build)
    qrows1 = check_q8_kernels(torch, 1, q8_build)
    phase.done("int8 kernel check")
    brows, wrows16 = check_backward_kernels(torch)
    phase.done("backward kernel check")
    frows = check_fused(torch)
    phase.done("fused kernel check")
    rect_rows = check_rect_kernels(torch)
    phase.done("rectangular kernel check")
    krows = check_large_k(torch)
    phase.done("K > 8 check")
    alex_rows = {n: alexnet_table(torch, n) for n in ALEXNET_BATCHES}
    phase.done("AlexNet per-layer table")

    rng = np.random.default_rng(0)
    xs = rng.standard_normal((REQUESTS, 224, 224, 3)).astype(np.float32)
    torch.cuda.reset_peak_memory_stats()
    model = TrimCNN.random(vgg16_layers(), n_classes=1000, seed=0,
                           device="cuda")
    carry_rows, carry_launches, carry_fw, carry_s = serve(REQUESTS, "carry",
                                                          model, xs)
    _, halo_launches, halo_fw, _ = serve(HALO_REQUESTS, "halo", model, xs,
                                         expect=carry_rows)
    # fused=True serves the plan's full-width groups, the rest per layer
    _, full_fused_launches, full_fused_fw, _ = serve(
        HALO_REQUESTS, "carry", model, xs, expect=carry_rows, fused=True)
    small = TrimCNN.random(fused_topo(), n_classes=1000, seed=0,
                           device="cuda")
    small_label = f"VGG-16/{FUSED_SCALE}"
    small_rows, small_launches, _, _ = serve(
        REQUESTS, "carry", small, xs, label=f"carry, {small_label}")
    _, fused_launches, fused_fw, _ = serve(
        REQUESTS, "carry", small, xs, expect=small_rows, fused=True,
        label=f"fused, {small_label}")
    del small
    with torch.inference_mode():
        oracle = TrimCNN(vgg16_layers(), model.tree(), impl="ref")(
            torch.from_numpy(xs[:1]).cuda()).cpu().numpy()[0]
    diff = float(np.abs(oracle - carry_rows[0]).max())
    lim = TOLERANCE * max(1.0, float(np.abs(oracle).max()))
    if not diff <= lim:
        raise AssertionError(f"logits vs impl='ref': {diff} > {lim}")
    print(f"serve: request 0 logits vs impl='ref' oracle: max|diff| "
          f"{diff:.3e} <= {lim:.1e}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    phase.done("serve")
    q8_launches, q8_fw, q8_halo_launches, q8_halo_fw = serve_q8(
        torch, model, xs, carry_rows)
    del model
    torch.cuda.empty_cache()
    phase.done("serve[int8]")
    alex = serve_alexnet(torch)
    phase.done("serve[AlexNet]")
    graph = graph_phase(torch, cache_dir)
    phase.done("graph")

    train_launches, train_stats = train_vgg16(torch)
    phase.done("train")
    train_fused_launches = train_fused(torch)
    torch.cuda.empty_cache()
    phase.done("train[fused]")

    from repro_torch.kernels import trim_conv2d as tc
    from repro_torch.launch.train_cnn import train
    tc.reset_launch_counts()
    out = train(steps=50, batch=16, device="cuda",
                log=lambda line: print(f"trainer: {line}"))
    print(f"trainer: OK, loss {out['first']:.4f} -> {out['last']:.4f}; "
          f"launches {dict(tc.LAUNCHES)}")
    phase.done("trainer")
    tuned = autotune_phase(torch, cache_dir)
    phase.done("autotune")

    arows = check_attention(torch)
    phase.done("attention kernel check")
    lm = lm_prefill(torch)
    phase.done("LM prefill")
    served = lm_serve(torch, lm)
    del lm["params"], lm["tokens"]
    torch.cuda.empty_cache()
    phase.done("LM serve")
    crows = check_conv1d(torch)
    phase.done("conv1d kernel check")
    mb = mamba_prefill(torch)
    phase.done("mamba prefill")
    mserved = family_serve(torch, "mamba", mb["cfg"], mb["params"], 7)
    del mb["params"]
    torch.cuda.empty_cache()
    phase.done("mamba serve")
    rg = rgemma_prefill(torch)
    phase.done("recurrentgemma prefill")
    rwrap = rgemma_wrap(torch, rg)
    phase.done("recurrentgemma ring wrap")
    rserved = family_serve(torch, "recurrentgemma", rg["cfg"], rg["params"],
                           10)
    del rg["params"]
    torch.cuda.empty_cache()
    phase.done("recurrentgemma serve")
    fbrows = check_flash_backward(torch)
    phase.done("flash backward check")
    lmt = lm_train(torch)
    phase.done("LM train")
    lm_resume(torch)
    phase.done("LM resume")
    c1b = check_conv1d_backward(torch)
    phase.done("conv1d backward check")
    rgt = rgemma_train(torch)
    phase.done("recurrentgemma train")
    mbt = mamba_train(torch)
    phase.done("mamba train")
    torch.cuda.empty_cache()
    bf = bf16_phase(torch)
    phase.done("bf16")
    lmb = lm_bf16_phase(torch, {
        "qwen2.5-3b": dict(ms=lm["ms"], peak=lm["peak"],
                           step_ms=served["step_ms"]),
        "recurrentgemma-2b": dict(ms=rg["ms"], peak=rg["peak"],
                                  step_ms=rserved["step_ms"]),
        "falcon-mamba-7b": dict(ms=mb["ms"], peak=mb["peak"],
                                step_ms=mserved["step_ms"])})
    phase.done("lm_bf16")
    c1w = check_conv1d_wgrad(torch)
    phase.done("conv1d wgrad check")
    fb16 = check_bf16_flash_bwd(torch)
    phase.done("bf16 flash backward check")
    tlb = train_lm_bf16(torch, {"qwen2.5-3b": lmt, "recurrentgemma-2b": rgt,
                                "falcon-mamba-7b": mbt})
    phase.done("train_lm_bf16")
    tb = train_bf16(torch, train_stats)
    phase.done("train_bf16")
    ed = encdec_phase(torch)
    phase.done("encdec")
    et, el = ed["times"], ed["launches"]
    md = moe_phase(torch)
    phase.done("moe")
    mt, ml = md["times"], md["launches"]
    paper = paper_phase(torch, {
        ("vgg16", 8): rows, ("vgg16", 1): rows1,
        **{("alexnet", n): alex_rows[n] for n in ALEXNET_BATCHES}}, [
        ("qwen2.5-3b f32 prefill", "qwen2.5-3b", "f32", "prefill",
         PREFILL_BATCH, PREFILL_SEQ, lm["ms"]),
        ("qwen2.5-3b bf16 prefill", "qwen2.5-3b", "bf16", "prefill",
         PREFILL_BATCH, PREFILL_SEQ, lmb["qwen2.5-3b"]["ms"]),
        ("qwen2.5-3b f32 training step", "qwen2.5-3b", "f32", "train",
         TRAIN_LM_BATCH, TRAIN_LM_SEQ - 1, lmt["steady_ms"]),
        ("qwen2.5-3b bf16 training step", "qwen2.5-3b", "bf16", "train",
         TRAIN_LM_BATCH, TRAIN_LM_SEQ - 1, tlb["qwen2.5-3b"]["steady_ms"]),
        (f"{MOE_ARCH} bf16 prefill", MOE_ARCH, "bf16", "prefill",
         MOE_BATCH, MOE_SEQ, md["prefill"]["ms"])])
    phase.done("paper")

    vgg = [r for r in rows if r["vgg"]]
    kernels = []
    carry_total = (carry_launches["carry"] + full_fused_launches["carry"]
                   + small_launches["carry"] + fused_launches["carry"]
                   + train_launches["carry"] + train_fused_launches["carry"]
                   + alex["carry"]["carry"] + alex["fused"]["carry"])
    carry_total += (tuned["launches"]["carry"] + graph["launches"]["carry"]
                    + paper["slice"]["launches"]["carry"])
    halo_total = (halo_launches["halo"] + alex["halo"]["halo"]
                  + tuned["launches"]["halo"] + graph["launches"]["halo"]
                  + paper["slice"]["launches"]["halo"])
    rect_err = max(max(r["err"] for r in rect_rows),
                   max(r["err"] for r in krows),
                   max(r["err"] for r in graph["kernels"]))
    for df, launches, src_line in (
            ("carry", carry_total, 127),
            ("halo", halo_total, 162)):
        ops_ms = sum(r["ops_ms"] for r in vgg if r["by"] == "operations")
        bytes_ms = sum(r["bytes_ms"] for r in vgg if r["by"] == "bytes")
        kernels.append({
            "name": f"trim_conv2d_{df}",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/trim_conv2d.cu",
            "replaces": f"src/repro/kernels/trim_conv2d.py:{src_line}",
            "launches": launches,
            "max_abs_err": max(max(r["err"] for r in rows), rect_err),
            # the paper phase's slice check (in "launches" too): its
            # error against the simulator
            "paper_launches": paper["slice"]["launches"][df],
            "paper_max_abs_err": paper["slice"]["err"],
            "ms": sum(r[df] for r in vgg),
            "plain_ms": sum(r["plain"] for r in vgg),
            "bound_ms": sum(r["bound"] for r in vgg),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": sum(r["library"] for r in vgg),
        })
    qvgg = [r for r in qrows if r["vgg"]]
    ops_ms = sum(r["ops_ms"] for r in qvgg if r["by"] == "operations")
    bytes_ms = sum(r["bytes_ms"] for r in qvgg if r["by"] == "bytes")
    for df, launches, src_line in (
            ("carry", q8_launches["q8_carry"], 127),
            ("halo", q8_halo_launches["q8_halo"], 162)):
        kernels.append({
            "name": f"trim_conv2d_q8_{df}",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/trim_conv2d_q8.cu",
            "replaces": f"src/repro/kernels/trim_conv2d.py:{src_line}",
            "launches": launches,
            "max_abs_err": max(r["err"] for r in qrows + qrows1),
            "ms": sum(r[df] for r in qvgg),
            "plain_ms": sum(r["plain"] for r in qvgg),
            "bound_ms": sum(r["bound"] for r in qvgg),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            # no PyTorch call computes an int8 conv with int32
            # accumulation; F.conv2d in f32 is printed as context
            "library_ms": None,
        })
    bvgg = [r for r in brows if r["vgg"]]
    ops_ms = sum(r["ops_ms"] for r in bvgg if r["by"] == "operations")
    bytes_ms = sum(r["bytes_ms"] for r in bvgg if r["by"] == "bytes")
    kernels.append({
        "name": "trim_conv2d_wgrad",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/trim_conv2d_wgrad.cu",
        "replaces": "src/repro/kernels/trim_conv2d.py:429",
        "launches": (train_launches["wgrad"] + train_fused_launches["wgrad"]
                     + graph["launches"]["wgrad"]),
        "max_abs_err": max(max(r["err"] for r in brows),
                           max(r["dw_err"] for r in rect_rows),
                           max(r["dw_err"] for r in graph["kernels"])),
        "ms": sum(r["wgrad"] for r in bvgg),
        "plain_ms": sum(r["plain"] for r in bvgg),
        "bound_ms": sum(r["bound"] for r in bvgg),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": sum(r["library"] for r in bvgg),
    })
    fvgg = [r for r in frows if r["vgg8"]]
    fplan = [r for r in frows if r["plan8"]]
    ops_ms = sum(r["ops_ms"] for r in fvgg if r["by"] == "operations")
    bytes_ms = sum(r["bytes_ms"] for r in fvgg if r["by"] == "bytes")
    kernels.append({
        "name": "trim_conv2d_fused",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/trim_conv2d_fused.cu",
        "replaces": "src/repro/kernels/trim_conv2d_fused.py:102",
        "launches": (full_fused_launches["fused"] + fused_launches["fused"]
                     + train_fused_launches["fused"]
                     + graph["launches"]["fused"]),
        "max_abs_err": max(r["err"] for r in frows),
        "ms": sum(r["fused"] for r in fvgg),
        "plain_ms": sum(r["plain"] for r in fvgg),
        "bound_ms": sum(r["bound"] for r in fvgg),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        # no single PyTorch call computes a group; the F.conv2d +
        # F.max_pool2d chain's time is printed in the fused kernel check
        "library_ms": None,
        # the groups that full-width fused serving runs (the plan's at
        # batch 8), beside the fixed-tile pair above
        "plan_ms": sum(r["fused"] for r in fplan),
        "plan_chain_ms": sum(r["chain"] for r in fplan),
        "plan_bound_ms": sum(r["bound"] for r in fplan),
    })
    b8, b1, ba8, ba1 = (bf["rows"][8], bf["rows"][1], bf["alex"][8],
                        bf["alex"][1])
    ops_ms = sum(r["ops_ms"] for r in b8 if r["by"] == "operations")
    bytes_ms = sum(r["bytes_ms"] for r in b8 if r["by"] == "bytes")
    for df, src_line in (("carry", 127), ("halo", 162)):
        kernels.append({
            "name": f"trim_conv2d_{df}_bf16",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/trim_conv2d.cu",
            "replaces": f"src/repro/kernels/trim_conv2d.py:{src_line}",
            # bf16 serving's and the train_bf16 phase's timed steps'
            "launches": (bf["launches"][f"{df}_bf16"]
                         + tb["launches"][f"{df}_bf16"]),
            # against the plain version (the fmaf chain): route mma adds
            # on the tensor cores in its own order (held to float64:
            # max_f64_excess <= 0)
            "max_abs_err": max(r["err"] for r in b8 + b1 + ba8 + ba1),
            "max_ulps": max(r["ulps"] for r in b8 + b1 + ba8 + ba1),
            "max_f64_excess": max(r["excess"] for r in b8 + b1 + ba8 + ba1
                                  if r["excess"] is not None),
            "mma_layers": sum(r["route"] == "mma" for r in b8),
            # sums over VGG-16's 13 layers at batch 8, CUDA graphs
            "ms": sum(r[df] for r in b8),
            "f32_route_ms": sum(r["f32"] for r in b8),
            "plain_ms": sum(r["plain"] for r in b8),
            "bound_ms": sum(r["bound"] for r in b8),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "ffma_bound_ms": sum(r["ffma"] for r in b8),
            "library_ms": sum(r["library"] for r in b8),   # F.conv2d bf16
            "n1_ms": sum(r[df] for r in b1),
            "n1_f32_route_ms": sum(r["f32"] for r in b1),
            "n1_bound_ms": sum(r["bound"] for r in b1),
            "n1_library_ms": sum(r["library"] for r in b1),
            # AlexNet's five convs at batch 8 (conv1: the K 11 tree)
            "alexnet_ms": sum(r[df] for r in ba8),
            "alexnet_f32_route_ms": sum(r["f32"] for r in ba8),
            "alexnet_bound_ms": sum(r["bound"] for r in ba8),
            "alexnet_library_ms": sum(r["library"] for r in ba8),
        })
    w16 = [r for r in wrows16 if r["vgg"]]
    w16x = {r["name"]: r for r in wrows16}
    ops_ms = sum(r["ops_ms"] for r in w16 if r["by"] == "operations")
    bytes_ms = sum(r["bytes_ms"] for r in w16 if r["by"] == "bytes")
    kernels.append({
        "name": "trim_conv2d_wgrad_bf16",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/trim_conv2d_wgrad.cu",
        "replaces": "src/repro/kernels/trim_conv2d.py:429",
        # the train_bf16 phase's timed steps
        "launches": tb["launches"]["wgrad_bf16"],
        # its f32 sums against the plain version (before the rounding)
        "max_abs_err": max(r["err"] for r in wrows16),
        # sums over VGG-16's 13 layers at batch 8, CUDA graphs
        "ms": sum(r["kernel"] for r in w16),
        "plain_ms": sum(r["plain"] for r in w16),
        "bound_ms": sum(r["bound"] for r in w16),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "ffma_bound_ms": sum(r["ffma"] for r in w16),
        # VGG-16 conv2-13 on route mma (the bf16 tensor cores)
        "mma_ms": sum(r["kernel"] for r in w16 if r["route"] == "mma"),
        "library_ms": sum(r["library"] for r in w16),  # conv2d_weight bf16
        "f32_entry_ms": sum(r["f32"] for r in w16),
        "depthwise_ms": w16x["dw_112x32"]["kernel"],
        "depthwise_library_ms": w16x["dw_112x32"]["library"],
        "alex1_3x2_ms": w16x["alex1_3x2"]["kernel"],
        "alex1_3x2_library_ms": w16x["alex1_3x2"]["library"],
        "stem_ms": w16x["stem_7x7s2"]["kernel"],
        "stem_library_ms": w16x["stem_7x7s2"]["library"],
    })
    bfu = bf["fused"]
    ops_ms = sum(r["ops_ms"] for r in bfu if r["by"] == "operations")
    bytes_ms = sum(r["bytes_ms"] for r in bfu if r["by"] == "bytes")
    kernels.append({
        "name": "trim_conv2d_fused_bf16",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/trim_conv2d_fused.cu",
        "replaces": "src/repro/kernels/trim_conv2d_fused.py:102",
        "launches": bf["launches"]["fused_bf16"],
        # against the plain version (the fmaf chain; equal to the bf16
        # per-layer chain bitwise)
        "max_abs_err": max(r["err"] for r in bfu),
        "max_ulps": max(r["ulps"] for r in bfu),
        # the bf16 plan's groups of full-width VGG-16 at batch 8
        "ms": sum(r["fused"] for r in bfu),
        "plain_ms": sum(r["plain"] for r in bfu),
        "bound_ms": sum(r["bound"] for r in bfu),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "ffma_bound_ms": sum(r["ffma"] for r in bfu),
        # no single PyTorch call computes a group
        "library_ms": None,
        "chain_ms": sum(r["chain"] for r in bfu),
        "library_chain_ms": sum(r["library"] for r in bfu),
        "groups": len(bfu),
        # the plan's groups at batch 1
        "n1_ms": sum(r["fused"] for r in bf["fused1"]),
        "n1_chain_ms": sum(r["chain"] for r in bf["fused1"]),
        # AlexNet's bf16 plan's groups at batch 8
        "alexnet_ms": sum(r["fused"] for r in bf["alex_fused"][8]),
        "alexnet_chain_ms": sum(r["chain"] for r in bf["alex_fused"][8]),
    })
    a = next(r for r in arows if r["name"] == "a_prefill")
    ac = next(r for r in arows if r["name"] == "c_rgemma")
    af32 = next(r for r in arows if r["name"] == "f_d320")
    kernels.append({
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:31",
        "launches": (lm["launches"] + rg["launches"]["flash_attention"]
                     + lmt["launches"]["flash_attention"]
                     + rgt["launches"]["flash_attention"]
                     + el["flash_attention"] + ml["flash_attention"]),
        "max_abs_err": max(r["err"] for r in arows),
        "ms": a["kernel"],
        "plain_ms": a["plain"],
        "bound_ms": a["bound"],
        "bound_by": a["by"],
        "library_ms": a["library"],
        # case (c), recurrentgemma-2b's local attention (soft cap 30: no
        # single PyTorch call computes it)
        "rgemma_ms": ac["kernel"],
        "rgemma_plain_ms": ac["plain"],
        "rgemma_bound_ms": ac["bound"],
        "rgemma_bound_by": ac["by"],
        # case (f), D 320: the wide route; SDPA (its math backend)
        "d320_ms": af32["kernel"],
        "d320_bound_ms": af32["bound"],
        "d320_library_ms": af32["library"],
        # seamless-m4t-large-v2's calls (MHA, D 64; CUDA graphs; SDPA on
        # the same call): its encoder's non-causal self-attention and its
        # decoder's causal one at 2 x 4096, a cross call of 4096 queries
        # onto 1024 keys
        **{f"{n}_{k}": et[("f32", n)][v]
           for n in ("s_enc", "s_dec", "s_cross_long")
           for k, v in (("ms", "ms"), ("bound_ms", "bound"),
                        ("library_ms", "library"))},
        "encdec_launches": el["flash_attention"],
        # qwen3-moe-30b-a3b's prefill call (B 2, L 4096, Hq 32, Hkv 4, D
        # 128, causal; CUDA graphs; SDPA with GQA on the same call) and the
        # moe phase's launches (its f32 training steps)
        **{f"q3_{k}": mt["f32"][v] for k, v in (
            ("ms", "ms"), ("bound_ms", "bound"), ("library_ms", "library"),
            ("plain_ms", "plain"))},
        "moe_launches": ml["flash_attention"],
    })
    bt = next(r for r in fbrows if r["name"] == "t_train")
    bc = next(r for r in fbrows if r["name"] == "c_rgemma")
    for part, err_of in (("dkdv", lambda r: max(r["errs"][1:])),
                         ("dq", lambda r: r["errs"][0])):
        kernels.append({
            "name": f"flash_attention_bwd_{part}",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
            # the backward of row 6's kernel, which the JAX package leaves
            # to XLA's autodiff of ops.attention(impl="chunked")
            "replaces": "src/repro/kernels/flash_attention.py:31",
            "launches": (lmt["launches"][f"flash_attention_bwd_{part}"]
                         + rgt["launches"][f"flash_attention_bwd_{part}"]
                         + el[f"flash_attention_bwd_{part}"]
                         + ml[f"flash_attention_bwd_{part}"]),
            "max_abs_err": max(r["abs_err"] for r in fbrows),
            "max_rel_err": max(err_of(r) for r in fbrows),
            "ms": bt[part],
            # the plain backward computes both kernels' outputs at once
            "plain_ms": bt["plain"],
            # the kernels' route, 3xTF32 on the tensor cores; FFMA beside
            "bound_ms": bt["bounds"][part]["tf32x3"][0],
            "bound_by": bt["bounds"][part]["tf32x3"][1],
            "ffma_bound_ms": bt["bounds"][part]["ffma"][0],
            "tflops": bt["tflops"][part],
            "blocks": getattr(bt["plan"], f"{part}_blocks"),
            # no single PyTorch call computes one kernel's half; SDPA's
            # backward (both halves) and forward + backward are beside it
            "library_ms": None,
            "backward_ms": bt["backward"],
            "backward_bound_ms": bt["bounds"]["backward"]["tf32x3"][0],
            "backward_ffma_bound_ms": bt["bounds"]["backward"]["ffma"][0],
            "sdpa_bwd_ms": bt["sdpa_bwd"],
            "sdpa_fwd_bwd_ms": bt["sdpa_fwd_bwd"],
            "rgemma_ms": bc[part],
            "rgemma_bound_ms": bc["bounds"][part]["tf32x3"][0],
            "rgemma_backward_ms": bc["backward"],
            # seamless-m4t-large-v2's training calls (2 x 1024, MHA, D
            # 64; CUDA graphs): causal (decoder) and non-causal (encoder,
            # cross); SDPA's backward on the same call beside them
            **{f"{n}_{k}": v for n in ("s_train", "s_train_nc")
               for k, v in (
                   ("ms", et[("f32", n)][part]),
                   ("bound_ms", et[("f32", n)]["bounds"][part][0]),
                   ("backward_ms", et[("f32", n)]["backward"]),
                   ("sdpa_bwd_ms", et[("f32", n)]["library"]))},
            "encdec_launches": el[f"flash_attention_bwd_{part}"],
            "moe_launches": ml[f"flash_attention_bwd_{part}"],
        })
    kernels.append({
        "name": "flash_attention_bwd_sum",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        # part of the same backward: the G query heads' partial dK and dV
        "replaces": "src/repro/kernels/flash_attention.py:31",
        "launches": (lmt["launches"]["flash_attention_bwd_sum"]
                     + rgt["launches"]["flash_attention_bwd_sum"]
                     + ml["flash_attention_bwd_sum"]),
        "max_abs_err": max(r["sum_err"] for r in fbrows
                           if r["sum_err"] is not None),
        "ms": bt["sum"],
        "plain_ms": bt["sum_plain"],
        "bound_ms": bt["bounds"]["sum"][0],
        "bound_by": bt["bounds"]["sum"][1],
        "library_ms": bt["sum_library"],   # torch.sum over the heads
        "blocks": bt["plan"].sum_blocks,
        "rgemma_ms": bc["sum"],
        "rgemma_bound_ms": bc["bounds"]["sum"][0],
        "moe_launches": ml["flash_attention_bwd_sum"],
    })
    kernels.append({
        "name": "trim_conv1d",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/trim_conv1d.cu",
        "replaces": "src/repro/kernels/trim_conv1d.py:29",
        "launches": (mb["launches"] + rg["launches"]["trim_conv1d"]
                     + rgt["launches"]["trim_conv1d"]
                     + mbt["launches"]["trim_conv1d"]),
        "max_abs_err": max(r["err"] for r in crows),
        **conv1d_kernel_times(crows),
    })
    cb = next(r for r in c1b if r["name"] == "rg_train")
    cm = next(r for r in c1b if r["name"] == "mamba_view")
    c1w_rows = {(r["name"], r["dtype"]): r for r in c1w}
    for part, key, src in (("dx", "trim_conv1d_dx", "trim_conv1d.cu"),
                           ("dw", "trim_conv1d_wgrad",
                            "trim_conv1d_wgrad.cu")):
        kernels.append({
            "name": key,
            "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            # the backward of row 5's kernel, which the JAX package leaves
            # to XLA's autodiff of ref.depthwise_conv1d
            "replaces": "src/repro/kernels/trim_conv1d.py:29",
            "launches": rgt["launches"][key] + mbt["launches"][key],
            "max_abs_err": 0.0,          # bitwise its plain version
            "max_rel_err_f64": max(r[f"{part}_err"] for r in c1b),
            "ms": cb[part],
            "plain_ms": cb[f"{part}_plain"],
            "bound_ms": cb[f"{part}_bound"][0],
            "bound_by": cb[f"{part}_bound"][1],
            "library_ms": cb[f"{part}_library"],
            "forward_ms": cb["fwd"],
            # falcon-mamba-7b's training batch, the mixer's strided view
            "mamba_ms": cm[part],
            "mamba_bound_ms": cm[f"{part}_bound"][0],
            "mamba_library_ms": cm[f"{part}_library"],
            "mamba_forward_ms": cm["fwd"],
        })
        if part == "dw":
            # the redesigned kernel: device ms from CUDA graphs over input
            # copies that outgrow the L2; the events around the wrapper
            # above (its host time bounds them) are kept as events_ms
            wr, wm = (c1w_rows[(n, "float32")]
                      for n in ("rg_train", "mamba_view"))
            kernels[-1].update(
                ms=wr["ms"], events_ms=cb["dw"], host_us=wr["host_us"],
                library_ms=wr["library"],
                mamba_ms=wm["ms"], mamba_events_ms=cm["dw"],
                mamba_library_ms=wm["library"], tile_l=wr["tile_l"],
                vec=wr["vec"], blocks=wr["blocks"])
    print(f"recurrentgemma train: {rgt['steady_ms']:.1f} ms a full-width "
          f"step ({RGEMMA_TRAIN_BATCH} x {RGEMMA_TRAIN_SEQ - 1}; clip scales "
          f"{rgt['clip']['scales']}), peak {rgt['peak']:.2f} GiB; mamba "
          f"train: {mbt['steady_ms']:.1f} ms a step of the depth-"
          f"{MAMBA_TRAIN_LAYERS} full-width cut ({MAMBA_TRAIN_BATCH} x "
          f"{MAMBA_TRAIN_SEQ - 1}), peak {mbt['peak']:.2f} GiB; "
          f"trim_conv1d_dx / _wgrad times are one launch at case rg_train "
          f"(recurrentgemma-2b's training row), mamba_* at case mamba_view; "
          f"their launches, and {rgt['launches']['trim_conv1d']} + "
          f"{mbt['launches']['trim_conv1d']} of trim_conv1d's and "
          f"{rgt['launches']['flash_attention']} of flash_attention's, are "
          f"the two training phases' steps")
    print(f"mamba: prefill {mb['ms']:.1f} ms a forward (2 x {MAMBA_SEQ}), "
          f"serve {mserved['tok_s']:.1f} tok/s; trim_conv1d times are one "
          f"launch at case b_mixer_view, the prefill's strided view (one "
          f"layer; contiguous_*: a_prefill, rgemma_*: k_rgemma); its "
          f"launches are the {mb['launches']} of the two timed full-width "
          f"prefill forwards")
    print(f"recurrentgemma: prefill {rg['ms']:.1f} ms a forward (2 x "
          f"{RGEMMA_SEQ}), peak {rg['peak']:.2f} GiB, RG-LRU scan "
          f"{rg['shares']['scan']:.1%} and attention kernel "
          f"{rg['shares']['attention']:.1%} of it; ring-wrap decode vs "
          f"prefill {rwrap['err']:.2e}; serve {rserved['tok_s']:.1f} tok/s, "
          f"{rserved['step_ms']:.2f} ms a step; its launches "
          f"{rg['launches']} (two timed full-width prefill forwards) are "
          f"counted in the kernel line; rgemma_*: one launch at its "
          f"prefill's shape (conv1d case k_rgemma, attention case "
          f"c_rgemma)")
    print(f"LM train: {lmt['steady_ms']:.1f} ms a full-width qwen2.5-3b "
          f"step (batch {TRAIN_LM_BATCH} x {TRAIN_LM_SEQ - 1}; clip scales "
          f"{lmt['clip']['scales']}: the same operations at any scale), "
          f"peak {lmt['peak']:.2f} GiB; flash_attention_bwd_* times are one "
          f"launch at case t_train (one layer of that step), rgemma_* at "
          f"case c_rgemma; their launches, and "
          f"{lmt['launches']['flash_attention']} of flash_attention's, are "
          f"the {TRAIN_LM_STEPS} training steps'")
    print(f"LM: prefill {lm['ms']:.1f} ms a forward (2 x {PREFILL_SEQ}), "
          f"serve {served['tok_s']:.1f} tok/s; flash_attention times are "
          f"one launch at case (a), the prefill's shape (one layer); its "
          f"launches are the {lm['launches']} of the two timed full-width "
          f"prefill forwards")
    for net, f32_s in (("VGG-16", carry_s), ("AlexNet", alex["carry_s"])):
        sv = bf[net]
        print(f"bf16 serving, {net}: f32 (the serve phases of this call) "
              f"carry p50 {f32_s['p50_s'] * 1e3:.3f} ms p99 "
              f"{f32_s['p99_s'] * 1e3:.3f} ms; bf16 carry p50 "
              f"{sv['carry_s']['p50_s'] * 1e3:.3f} ms p99 "
              f"{sv['carry_s']['p99_s'] * 1e3:.3f} ms "
              f"{sv['carry_s']['throughput_rps']:.1f} req/s; fused p50 "
              f"{sv['fused_s']['p50_s'] * 1e3:.3f} ms p99 "
              f"{sv['fused_s']['p99_s'] * 1e3:.3f} ms; halo p50 "
              f"{sv['halo_s']['p50_s'] * 1e3:.3f} ms; logits "
              f"{sv['dev']:.3e} of max|f32| from f32 serving, top-1 "
              f"{sv['top1']:.3f}; launches carry {sv['carry']['carry_bf16']}"
              f" in {sv['carry_fw']} forwards, halo {sv['halo']['halo_bf16']}"
              f" in {sv['halo_fw']}, fused {sv['fused']['fused_bf16']} + "
              f"carry {sv['fused']['carry_bf16']} in {sv['fused_fw']}")
    print("bf16 kernel times (trim_conv2d_*_bf16: sums over the 13 VGG-16 "
          "layers at batch 8, f32_route_ms the f32 entry on the same "
          "values, n1_*: at batch 1, alexnet_*: AlexNet's five convs at "
          "batch 8; trim_conv2d_fused_bf16: the bf16 plan's groups at batch "
          "8, chain_ms their bf16 per-layer chains, n1_*: the plan's groups "
          "at batch 1, alexnet_*: AlexNet's at batch 8); bounds at 989 "
          "TFLOP/s bf16 or 3.35 TB/s, ffma_bound_ms at 67 TFLOP/s; "
          "launches from bf16 serving of full-width VGG-16 and AlexNet")
    qvgg1 = [r for r in qrows1 if r["vgg"]]
    print(f"int8 kernel times: sums over the 13 VGG-16 layers at batch 8 "
          f"(batch 1: carry {sum(r['carry'] for r in qvgg1):.3f} ms, halo "
          f"{sum(r['halo'] for r in qvgg1):.3f} ms); F.conv2d in f32 "
          f"{sum(r['f32_library'] for r in qvgg):.3f} ms at batch 8 "
          f"(context, not the same function); launches from int8 serving "
          f"({q8_fw} carry forwards, {q8_halo_fw} halo forwards)")
    vgg1 = [r for r in rows1 if r["vgg"]]
    print(f"kernel times at batch 1, sums over the 13 VGG-16 layers: carry "
          f"{sum(r['carry'] for r in vgg1):.3f} ms, halo "
          f"{sum(r['halo'] for r in vgg1):.3f} ms, F.conv2d "
          f"{sum(r['library'] for r in vgg1):.3f} ms")
    for n in ALEXNET_BATCHES:
        ar = alex_rows[n]
        print(f"AlexNet at batch {n}: carry "
              f"{sum(r['carry'] for r in ar):.4f} ms, halo "
              f"{sum(r['halo'] for r in ar):.4f} ms, F.conv2d "
              f"{sum(r['library'] for r in ar):.4f} ms, bound "
              f"{sum(r['bound'] for r in ar):.4f} ms over the 5 convs "
              f"(conv1 {ar[0]['carry']:.4f} ms against its bound "
              f"{ar[0]['bound']:.4f})")
    print(f"launches of AlexNet serving: carry {alex['carry']} in "
          f"{alex['carry_fw']} forwards, halo {alex['halo']} in "
          f"{alex['halo_fw']}, fused=True {alex['fused']} in "
          f"{alex['fused_fw']} (counted in the kernel line's carry and "
          f"halo launches)")
    for n in GRAPH_BATCHES:
        fw, tab = graph["forward"][n], graph["tables"][n]
        gm = fw["graph_ms"]
        print(f"ResNet-18 at batch {n}: forward carry {fw['ms']['carry']:.4f} "
              f"ms, halo {fw['ms']['halo']:.4f}, fused "
              f"{fw['ms']['fused']:.4f}, every conv as F.conv2d "
              f"{fw['ms']['library']:.4f} (from CUDA graphs: "
              f"{gm['carry']:.4f}, {gm['halo']:.4f}, {gm['fused']:.4f}, "
              f"{gm['library']:.4f}); fused groups "
              + ", ".join(f"{r['label']} {r['fused']:.4f} (chain "
                          f"{r['chain']:.4f})" for r in fw["groups"])
              + f"; the 20 convs alone: carry "
              f"{sum(r['carry'] for r in tab):.4f} ms, F.conv2d "
              f"{sum(r['library'] for r in tab):.4f}, bound "
              f"{sum(r['bound'] for r in tab):.4f} (stem "
              f"{tab[0]['carry']:.4f} against its bound "
              f"{tab[0]['bound']:.4f}); peak {fw['peak']:.3f} GiB")
    print(f"launches of the graph phase: {graph['launches']} (ResNet-18 "
          f"forwards at batch {GRAPH_BATCHES}, per node, halo and fused, its "
          f"gradients, the packed and measured-record forwards, U-Net per "
          f"node and fused; counted in the kernel line)")
    print("kernel times: sums over the 13 VGG-16 conv layers at batch 8 "
          "(trim_conv2d_fused: over full-width VGG-16's fixed-tile "
          "two-layer pair at batch 8, "
          f"per-layer carry chain of the same layers "
          f"{sum(r['chain'] for r in fvgg):.3f} ms, F.conv2d + "
          f"F.max_pool2d chain {sum(r['library'] for r in fvgg):.3f} ms; "
          "plan_*: over the groups the full-width plan fuses at batch 8, "
          f"F.conv2d chain {sum(r['library'] for r in fplan):.3f} ms); "
          f"launches from the main paths: serving ({carry_fw} carry "
          f"forwards, {halo_fw} halo forwards, {full_fused_fw} fused "
          f"forwards of VGG-16: {full_fused_launches}, {fused_fw} of "
          f"VGG-16/{FUSED_SCALE}: {fused_launches}) and the "
          f"{TRAIN_STEPS} VGG-16 training steps (per layer, "
          f"{train_launches}), one VGG-16/{FUSED_SCALE} fused step "
          f"({train_fused_launches}) and VGG-16 served on measured "
          f"records ({tuned['launches']})")
    kernels.append({
        "name": "trim_conv1d_bf16",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/trim_conv1d.cu",
        "replaces": "src/repro/kernels/trim_conv1d.py:29",
        "launches": lmb["launches"]["trim_conv1d_bf16"],
        "max_abs_err": max(r["err"] for r in lmb["conv1d"]),  # bitwise
        **conv1d_kernel_times(lmb["conv1d"]),   # library: F.conv1d on bf16
    })
    fr = {r["name"]: r for r in lmb["flash"]}
    a, ac, af = fr["a_prefill"], fr["c_rgemma"], fr["f_d320"]
    kernels.append({
        "name": "flash_attention_bf16",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:31",
        "launches": (lmb["launches"]["flash_attention_bf16"]
                     + el["flash_attention_bf16"]
                     + ml["flash_attention_bf16"]),
        "max_abs_err": max(r["err"] for r in lmb["flash"]),
        "max_rel_err": max(r["rel"] for r in lmb["flash"]),
        "max_f64_excess": max(r["excess"] for r in lmb["flash"]),
        # case (a), the qwen2.5-3b prefill's shape, CUDA graphs
        "ms": a["kernel"],
        "plain_ms": a["plain"],
        "bound_ms": a["bound"],
        "bound_by": a["by"],
        "library_ms": a["library"],       # SDPA on bf16
        "route_bound_ms": a["route_bound"],
        "continue_ms": fr["b_continue"]["kernel"],
        "continue_library_ms": fr["b_continue"]["library"],
        # case (c), recurrentgemma-2b's local attention (soft cap 30: no
        # single PyTorch call computes it)
        "rgemma_ms": ac["kernel"],
        "rgemma_plain_ms": ac["plain"],
        "rgemma_bound_ms": ac["bound"],
        # case (f), D 320: the wide route; SDPA (its math backend) on
        # bf16 computes the same function
        "d320_ms": af["kernel"],
        "d320_bound_ms": af["bound"],
        "d320_route_bound_ms": af["route_bound"],
        "d320_library_ms": af["library"],
        # seamless-m4t-large-v2's calls in bf16 (CUDA graphs, SDPA bf16)
        **{f"{n}_{k}": et[("bf16", n)][v]
           for n in ("s_enc", "s_dec", "s_cross_long")
           for k, v in (("ms", "ms"), ("bound_ms", "bound"),
                        ("library_ms", "library"))},
        "encdec_launches": el["flash_attention_bf16"],
        # qwen3-moe-30b-a3b's prefill call in bf16 (CUDA graphs, SDPA bf16
        # with GQA); the moe phase's bf16 prefills and training steps
        **{f"q3_{k}": mt["bf16"][v] for k, v in (
            ("ms", "ms"), ("bound_ms", "bound"), ("library_ms", "library"),
            ("plain_ms", "plain"))},
        "moe_launches": ml["flash_attention_bf16"],
    })
    wr, wm = (c1w_rows[(n, "bfloat16")] for n in ("rg_train", "mamba_view"))
    kernels.append({
        "name": "trim_conv1d_wgrad_bf16",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/trim_conv1d_wgrad.cu",
        # the backward of row 5's kernel, which the JAX package leaves to
        # XLA's autodiff of ref.depthwise_conv1d
        "replaces": "src/repro/kernels/trim_conv1d.py:29",
        "launches": tlb["launches"]["trim_conv1d_wgrad_bf16"],
        "max_abs_err": 0.0,          # bitwise its plain version
        # recurrentgemma-2b's training row, CUDA graphs
        "ms": wr["ms"],
        "events_ms": wr["events"],
        "host_us": wr["host_us"],
        "plain_ms": wr["plain"],
        "bound_ms": wr["bound"][0],
        "bound_by": wr["bound"][1],
        "library_ms": wr["library"],      # conv1d_weight on bf16
        "tile_l": wr["tile_l"],
        "vec": wr["vec"],
        "mamba_ms": wm["ms"],
        "mamba_bound_ms": wm["bound"][0],
        "mamba_library_ms": wm["library"],
    })
    kernels.append({
        "name": "trim_conv1d_dx_bf16",
        "route": "cuda",
        # trim_conv1d_bf16 launched on the reversed cotangent
        "source": "src/repro_torch/kernels/csrc/trim_conv1d.cu",
        "replaces": "src/repro/kernels/trim_conv1d.py:29",
        "launches": tlb["launches"]["trim_conv1d_dx_bf16"],
        "max_abs_err": 0.0,          # bitwise its plain version
        "ms": wr["dx"],
        "plain_ms": wr["dx_plain"],
        "bound_ms": wr["dx_bound"][0],
        "bound_by": wr["dx_bound"][1],
        "library_ms": wr["dx_library"],   # conv1d_input on bf16
        "mamba_ms": wm["dx"],
        "mamba_bound_ms": wm["dx_bound"][0],
        "mamba_library_ms": wm["dx_library"],
    })
    ft, fc = (next(r for r in fb16 if r["name"] == n)
              for n in ("t_train", "c_rgemma"))
    for part in ("dq", "dkdv"):
        kernels.append({
            "name": f"flash_attention_bwd_{part}_bf16",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
            "replaces": "src/repro/kernels/flash_attention.py:31",
            "launches": (tlb["launches"][f"flash_attention_bwd_{part}_bf16"]
                         + el[f"flash_attention_bwd_{part}_bf16"]
                         + ml[f"flash_attention_bwd_{part}_bf16"]),
            # against the plain bf16 backward (f32 math, one rounding)
            "max_abs_err": max(r["abs_err"] for r in fb16),
            # past the plain bf16 backward's distance from float64 plus
            # one bf16 ulp, of max|grad| (<= 0: the gate)
            "max_plain_excess": max(r["excess"] for r in fb16),
            # past half a bf16 ulp of the float64 plain backward, of
            # max|grad| (<= FLASH_BWD_BF16_F64_EXCESS: the gate)
            "max_f64_excess": max(r["f64_excess"] for r in fb16),
            # case (t), one layer of the qwen2.5-3b step, CUDA graphs
            "ms": ft[part],
            "plain_ms": ft["plain"],
            "bound_ms": ft["bounds"][part][0],
            "bound_by": ft["bounds"][part][1],
            # no single PyTorch call computes one kernel's half; SDPA's
            # bf16 backward (both halves) is beside it
            "library_ms": None,
            "backward_ms": ft["backward"],
            "backward_bound_ms": ft["bounds"]["backward"][0],
            "sdpa_bwd_ms": ft["sdpa_bwd"],
            "sdpa_fwd_bwd_ms": ft["sdpa_fwd_bwd"],
            # torch.profiler device time of each backward, at (t)
            "sdpa_bwd_device_ms": ft["sdpa_bwd_device"],
            "backward_device_ms": ft["backward_device"],
            "rgemma_ms": fc[part],
            "rgemma_bound_ms": fc["bounds"][part][0],
            "rgemma_backward_ms": fc["backward"],
            # seamless-m4t-large-v2's training calls in bf16
            **{f"{n}_{k}": v for n in ("s_train", "s_train_nc")
               for k, v in (
                   ("ms", et[("bf16", n)][part]),
                   ("bound_ms", et[("bf16", n)]["bounds"][part][0]),
                   ("backward_ms", et[("bf16", n)]["backward"]),
                   ("sdpa_bwd_ms", et[("bf16", n)]["library"]))},
            "encdec_launches": el[f"flash_attention_bwd_{part}_bf16"],
            "moe_launches": ml[f"flash_attention_bwd_{part}_bf16"],
        })
    kernels.append({
        "name": "flash_attention_bwd_sum_bf16",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/kernels/flash_attention.py:31",
        "launches": (tlb["launches"]["flash_attention_bwd_sum_bf16"]
                     + ml["flash_attention_bwd_sum_bf16"]),
        "max_abs_err": max(r["abs_err"] for r in fb16),
        "ms": ft["sum"],
        "plain_ms": ft["sum_plain"],
        "bound_ms": ft["bounds"]["sum"][0],
        "bound_by": ft["bounds"]["sum"][1],
        "library_ms": ft["sum_library"],   # torch.sum over the heads
        "rgemma_ms": fc["sum"],
        "rgemma_bound_ms": fc["bounds"]["sum"][0],
        "moe_launches": ml["flash_attention_bwd_sum_bf16"],
    })
    print("lm_bf16 (bf16 prefill ms a forward, f32 of this call in "
          "brackets; peak GiB; ms a bf16 decode step): " + "; ".join(
              f"{arch} {lmb[arch]['ms']:.1f} ({f:.1f}), "
              f"{lmb[arch]['peak']:.2f} GiB, {lmb[arch]['ms_step']:.2f}"
              for arch, f in (("qwen2.5-3b", lm["ms"]),
                              ("recurrentgemma-2b", rg["ms"]),
                              ("falcon-mamba-7b", mb["ms"])))
          + "; trim_conv1d_bf16 times are one launch at case b_mixer_view "
          "(contiguous_*: a_prefill, rgemma_*: k_rgemma), "
          "flash_attention_bf16 at case (a) "
          "(rgemma_*: (c), d320_*: (f)); their launches are the bf16 "
          "prefills' (2 forwards a model)")
    print(f"train_bf16: {tb['ms']:.1f} ms a full-width VGG-16 step in bf16 "
          f"(batch {TRAIN_BATCH}; f32 {tb['f32_ms']:.1f} ms over the same "
          f"steps), peak {tb['peak']:.2f} GiB; trim_conv2d_wgrad_bf16 times "
          "are sums over the 13 VGG-16 layers at batch 8 (f32_entry_ms: the "
          "f32 entry on the widened operands; depthwise_*, alex1_3x2_*, "
          "stem_*: one launch at those cases), its launches the "
          f"{BF16_TRAIN_STEPS} timed steps'; the bf16 carry launches include "
          f"them ({tb['launches']['carry_bf16']})")
    ep, etr = ed["prefill"], ed["train"]
    print(f"encdec ({ENCDEC_ARCH}): prefill {ep['ms']:.1f} ms a forward "
          f"(2 x {ENCDEC_SEQ} over {ENCDEC_SEQ} frames; bf16 "
          f"{ed['bf16']['ms']:.1f}), peak {ep['peak']:.2f} GiB (bf16 "
          f"{ed['bf16']['peak']:.2f}); serve {ed['served']['tok_s']:.1f} "
          f"tok/s, {ed['served']['step_ms']:.2f} ms a step (bf16 decode "
          f"{ed['bf16']['ms_step']:.2f} ms a step); train "
          f"{etr['f32']['steady_ms']:.1f} ms a step f32, "
          f"{etr['bf16']['steady_ms']:.1f} bf16 (2 x 1024 over 1024 frames),"
          f" peak {etr['f32']['peak']:.2f} / {etr['bf16']['peak']:.2f} GiB; "
          f"the flash entries' s_* times are one launch at seamless's "
          f"calls, encdec_launches the phase's share of their launches")
    mp, mtr = md["prefill"], md["train"]
    print(f"moe ({MOE_ARCH}): bf16 prefill {mp['ms']:.1f} ms a forward (2 x "
          f"{MOE_SEQ}, full width), peak {mp['peak']:.2f} GiB; bf16 decode "
          f"{mp['ms_step']:.2f} ms a step; f32 serve at the "
          f"{MOE_F32_CUT}-layer cut {md['f32']['tok_s']:.1f} tok/s, "
          f"{md['f32']['step_ms']:.2f} ms a step; train at the "
          f"{MOE_TRAIN_CUT}-layer cut {mtr['f32']['steady_ms']:.1f} ms a "
          f"step f32, {mtr['bf16']['steady_ms']:.1f} bf16 (2 x 1024), peak "
          f"{mtr['f32']['peak']:.2f} / {mtr['bf16']['peak']:.2f} GiB; "
          f"{MOE_PHI} {MOE_PHI_CUT}-layer cut bf16 prefill "
          f"{md['phi']['ms']:.1f} ms (2 x {MOE_PHI_SEQ}); the flash entries' "
          f"q3_* times are one launch at qwen3-moe's prefill call, "
          f"moe_launches the phase's share of their launches")
    phase.total()
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
