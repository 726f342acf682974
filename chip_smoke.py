#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py            # every phase; needs one sm_90 card
    python3 chip_smoke.py --kernels  # environment, build and kernel phases
    python3 chip_smoke.py --drift 0,1,2  # environment, build and the drift
                                         # measurement only
    python3 chip_smoke.py --parent DIR   # every phase; phases 3j, 3f,
                                         # 3k and 3l also time the bf16
                                         # conv kernels, the SSD kernel,
                                         # the flash prefill, gemma-7b's
                                         # served prefill, the conv1d and
                                         # the fp32 matmul of the checkout
                                         # at DIR (the parent commit's)

Phases (any failure exits non-zero and prints no result line):

1. environment: CUDA available, compute capability (9, 0), the card's
   name and power limit from ``nvidia-smi``;
2. build: compile the six CUDA kernel libraries (the TrIM conv, its
   weight gradient, the causal conv1d, flash attention, the matmul and
   the SSD scan) from the sources in the checkout (``repro_torch/csrc``),
   one ``nvcc`` each, started together, and load them; log every
   kernel's registers and spills, the SSD kernel's per stage and lane (a
   spill fails), and the conv kernel's per path (fp32
   K=3 and K=5 slide, generic, split merge; u8s8 window and gather
   paths, int32 and uint8 out, and their merges; the bf16 wgmma window
   path at 64 and 128 filters a block and the gather path); the count of
   ``IMMA`` (tensor-core integer MMA) instructions in each u8s8 entry's
   SASS, of ``HGMMA`` (wgmma) in each bf16 window entry's and the weight
   gradient's bf16 window entry's, of ``HMMA`` (mma.sync) in the bf16
   gather entry's and the weight gradient's bf16 GEMM entry's
   (``cuobjdump -sass`` on the built library), which fails if an entry is
   missing, spills (the bf16 entries) or has none; the flash kernel's
   registers and spills per path (bf16 prefill, bf16 split decode, fp32
   prefill, fp32 split decode at each rows bucket) and head dim (8, 16,
   32, 64, 128, 256), failing where an entry is missing or an fp32 entry
   spills, and the ``HGMMA`` count of each bf16 prefill entry
   (``flash_prefill_wg_kernel`` at D = 64, ``flash_prefill_kernel`` at
   the others), failing where one spills, has its wgmma serialized by
   ptxas or runs none;
3. kernels: the TrIM conv kernel against its plain PyTorch version on the
   card, at the 13 VGG-16 conv shapes on the float lane (bias+ReLU) at
   batch 1 and at the train phase's batch 8 (image 0 of the batch also
   bit-equal to the image alone), plus AlexNet CL1 (K=11, S=4, p=0) and
   CL2 (K=5, groups=2), and CL3-CL5 at batch 1; the int8 lane (ReLU+requant; ReLU into raw int32
   on each network's last conv) at every VGG-16 and AlexNet conv at
   batch 1 and 8.  Float within rtol 1e-4 / atol 1e-4 * max|plain|, int8
   bit for bit; the int5 MSR lane (the u8 x s8 kernel on the operands
   ``w5`` of random int8 weights, |w5| <= 31, with requant pairs
   calibrated on ``psum5 << e`` and the exponent folded in) at every
   VGG-16 conv at batch 1 and 8 and every AlexNet conv at batch 1, bit
   for bit.  Per shape: kernel ms,
   plain ms, ``F.conv2d`` ms (cuDNN,
   TF32 off, float shapes only, a yardstick the port never calls) and the
   bound max(operations / peak, bytes / 3.35 TB/s), the kernel's device
   time under ``torch.profiler`` and the host's issue time a call (at
   batch 1 the small shapes' event times read the host); per lane and
   batch, the sums over the 13 VGG-16 convs;
3b. backward kernels: at the same 15 shapes, at batch 1 and at the train
   phase's batch 8 (TF32 off), dw from the weight-gradient kernel against
   its plain per-tap version and dx from ``trim_conv2d_input_grad`` (the
   conv kernel at stride 1 on the flipped weights) against
   ``torch.nn.grad.conv2d_input`` (cuDNN), both within rtol 1e-3 / atol
   1e-3 * max|plain|.  Per shape: kernel ms, plain ms (dw),
   ``conv2d_weight`` / ``conv2d_input`` ms (yardsticks the port never
   calls), the bound and ms / bound, and for dw the host's issue time a
   call (where it is not below the kernel's ms, that reading measures
   the host); per batch, the sums of dw over the 13 VGG-16 convs and of
   dx over the 12 the train step computes (CL2-CL13); once,
   the weight-gradient kernel's registers and spills from its
   ``-Xptxas -v`` build log;
3c. conv1d kernel: the causal depthwise conv1d kernel against its plain
   version on the card, bit for bit: at the full-width Mamba shape x
   (4, 4096, 1792), w (4, 1792) in bf16 and fp32 (as the column slice
   ``proj[..., 1536:3328]`` of in_proj's output, which is what the path
   passes, and contiguous), the smoke shape (D = 160), L in
   {1, 2, 3, 257} x K in {1, 4, 6}, the training shape (4, 1024, 1792)
   (the slice, and a slice 3 elements further in whose rows are not
   16-byte aligned) and a rank's shape (4, 4096, 896).  At full width
   per dtype, and in bf16 at the training and rank shapes: kernel ms by
   events, its device time under ``torch.profiler``, the host's issue
   time a call (where it is not below the device time, the events time
   measures the host, and the log says so), the event and device times
   with x cold in L2 (calls rotating over copies of x laid out as x is),
   plain ms, ``F.conv1d`` ms (cuDNN, groups = D, on an input already in
   (B, D, L); a yardstick the port never calls) and the bound;
3d. flash attention: the flash kernel against its plain version on the
   card (TF32 off), fp32 within rtol = atol = 2e-5 and bf16 within 2e-2
   and, per output row, within 4 x 2^-7 of the row's max|plain| (2-4 bf16
   ulps; a kernel that drops one 64-key tile at decode must fail it),
   keys past kv_length holding NaN for the kernel: ``tests/test_kernels.py``
   FLASH_CASES at head dim 64, causal and not; GQA G = 4; a per-row
   kv_length with a row at 0; Sq < Sk with q_offset; D = 128; and
   granite-3-2b's full-width prefill, q (4, 4096, 8, 4, 64) causal, and
   decode, q (4, 1, 8, 4, 64) over a (4, 4128, 8, 64) cache with
   kv_length 4097 (each lane's two paths: the prefill kernel, warpgroup
   MMA with TMA in bf16 and register-tiled FMAs in fp32, and the split
   decode in one launch at the decode).  At the two full-width shapes,
   per dtype: kernel ms, plain ms, ``F.scaled_dot_product_attention`` ms
   (KV heads repeated; a yardstick the port never calls) and the bound;
   also the kernel's and SDPA's device time under ``torch.profiler``,
   SDPA with ``enable_gqa`` on the unrepeated k/v, the wrapper's host
   issue time per call, and at the decode all of these with the k/v
   cache cold in L2 (calls rotating over 4 caches of 33.8 MB in bf16,
   67.6 MB in fp32);
3e. matmul: ``ops.trim_matmul`` (the entry point) at granite-3-2b's
   full-width projections at a 4 x 4096 prefill, (16384, 2048) @ (2048,
   8192), (16384, 8192) @ (8192, 2048) and (16384, 2048) @ (2048, 2048),
   and the decode-shaped (4, 2048) @ (2048, 8192), then at 1 and 16
   rows, in bf16, fp32 and int8, its launches counted from 0 around each
   part, in total and per path: the projections on ``wgmma`` in bf16
   (``fma`` in fp32, ``mma`` in int8), every decode-shaped call on
   ``stream``, or the phase fails; the kernel's registers and spills per
   entry; then the kernel against its plain version there and at ragged
   shapes: int8 bit for bit (int32 out), fp32 within rtol 1e-4 / atol
   1e-4 x max|plain|, bf16 within 2 x 2^-7 of each row's max|plain|;
   the stream path bit-equal over two calls.  At full width: kernel ms,
   plain ms, ``torch.matmul`` (cuBLAS, TF32 off) / ``torch._int_mm`` ms
   (yardsticks the port never calls; none for int8 at M <= 16), the
   bound and the host's issue time per call (at q/o also on the ``mma``
   path: the tensor maps' cost); at the decode shapes also with b cold in
   L2 (calls rotating over copies of b past 150 MB: events and profiler
   device time, kernel and ``torch.matmul``); a bf16 sweep at gate/up's
   K and N over 1-256 rows, each path that takes the operands (stream up
   to 16 rows) checked and timed beside ``torch.matmul``: where stream
   and wgmma cross;
3f. SSD scan: ``trim_ssd`` (the entry point) at mamba2-130m's full-width
   prefill, x (4, 4096, 24, 64), dt (4, 4096, 24), B/C (4, 4096, 1, 128)
   expanded over the 24 heads, and at jamba-1.5-large's, x (4, 4096, 128,
   128), B/C (4, 4096, 128, 128) repeated from 8 groups (two P tiles,
   C.B^T once a head), chunk 256, in fp32 and bf16 (x/B/C), its
   launches counted from 0 around each call; then the kernel against
   its plain version: ``SSD_SMOKE_CASES`` (the JAX tests' CASES, P up to
   200 and S up to 256, jamba's smoke dims) on four seeds, B/C per head
   and one group expanded, in fp32 within 2e-5, full width and the first mixer's real inputs (a full-width fp32
   prefill's ``ssd_chunked`` arguments) in fp32 within 1e-4 x max|plain|,
   bf16 within 5e-2 of the plain version on the same inputs and (but at
   jamba's width, where the bf16 plain's own distance from the fp32 one
   is logged beside the kernel's) of the fp32 one; with ``--parent DIR``
   the mamba2-130m shape timed in the parent checkout and here in turns
   (parent, this, this, parent; ``tools/ssd_times.py`` on each).  At
   full width: kernel ms, plain ms and two bounds: the
   least work that computes y (chunk 1) at the inputs' peak (the fp32
   FMA's, the bf16 tensor cores') or the bytes, whichever is longer (in
   the kernels line), and the same work as the tensor-core passes the lane
   needs (3xTF32, or bf16 with a second pass for an fp32 operand) at the
   tensor cores' peak (logged only); no PyTorch call computes the scan
   (no yardstick); in the build phase each of its four
   stages' registers and spills per lane (a spill fails);
3g. flash at G = 12: the flash kernel in bf16 at starcoder2-3b's
   full-width serving shapes, the prefill q (4, 4096, 2, 12, 128) causal
   (warpgroup path) and the decode q (4, 1, 2, 12, 128) over a (4, 4128,
   2, 128) cache with kv_length 4097 (split path), against its plain
   version (2e-2 and 4 x 2^-7 per row) and timed beside it, SDPA and the
   bound;
3h. flash at the head dims this slice added: gemma-7b's full-width
   serving shapes at D = 256, G = 1, the prefill q (4, 4096, 16, 1, 256)
   causal and the decode q (4, 1, 16, 1, 256) over a (4, 4128, 16, 256)
   cache with kv_length 4097 (NaN past it for the kernel), in bf16 (2e-2
   and 4 x 2^-7 per row) and fp32 (2e-5), each timed beside the plain
   version, SDPA (TF32 off) and the bound; llama4-maverick's (G = 5, D =
   128) in bf16; and D = 8, 16 and 32 at small prefill and decode shapes
   on both dtypes against the plain version;
3i. flash at the encdec and vlm families' full-width serving shapes, in
   bf16 and fp32, each timed beside the plain version, SDPA (TF32 off)
   and the bound: seamless-m4t-large-v2's encoder prefill q (4, 4096,
   16, 1, 64) over its own 4096 keys, non-causal, and its cross row q
   (4, 1, 16, 1, 64) over the 4096-key cross-KV with no kv_length;
   llava-next-34b's (G = 7, D = 128) prefill q (4, 4096, 8, 7, 128)
   causal and decode q (4, 1, 8, 7, 128) over a (4, 4128, 8, 128) cache
   with kv_length 4097;
3k. with ``--parent DIR``: the flash kernel's bf16 prefill at the rows
   of phases 3d, 3g, 3h and 3i (gemma-7b, llava-next-34b, starcoder2-3b,
   llama4-maverick, granite-3-2b, seamless's encoder) and gemma-7b's
   decode, and its fp32 lane's prefill (granite-3-2b, gemma-7b,
   llava-next-34b, seamless's encoder), granite-3-2b's decode and the
   partial entry at phase 23's shape, timed by ``tools/flash_times.py``
   in DIR's checkout and in this one in turns (parent, this, this,
   parent; SDPA, TF32 off, logged beside each row): the row
   FLASH_TURNS_FASTER names (if any) must be faster than the parent's,
   every other row within FLASH_TURNS_SLACK of it; then gemma-7b's served prefill (phase 15's)
   in turns, its wall and the flash kernel's device time in it
   (``tools/serve_prefill_times.py``);
3l. with ``--parent DIR``: kernel 3 at its bf16 path shapes (full
   width, the training batch, a rank's channels) and fp32 at full width,
   and kernel 6's fp32 projections (the ``fma`` path) at granite-3-2b's
   prefill, timed by ``tools/conv1d_matmul_times.py`` in DIR's checkout
   and in this one in turns (parent, this, this, parent; events and
   profiler device time; ``F.conv1d`` and ``torch.matmul``, TF32 off,
   from the first turn here): per row this / parent and this / library;
   the fp32 projections' sum against 0.8 x the parent's and against
   cuBLAS's, and conv1d against the parent at every shape, each target
   logged as met or missed;
3j. the bf16 lanes: kernel 1 in bf16 (bias + ReLU in fp32, one rounding)
   at VGG-16's 13 convs at batch 1 and 8 and AlexNet's 5 at batch 1, as
   dx at VGG-16's CL2-CL13 at batch 1 and 8, and kernel 2 in bf16 at
   VGG-16's 13 convs at batch 1 and 8.  Kernel 1 against its plain
   version within one bf16 ulp of the larger magnitude plus
   BF16_SUM_SLACK x n x 2^-24 x sum|terms| (the share of outputs past one
   ulp logged), at batch 8 every image bit-equal to a call of it alone;
   kernel 2 against its fp32 lane on the upcast operands (rtol 1e-3 /
   atol 1e-3 x max) and bit-equal over two calls.  Per shape: kernel ms,
   plain ms, cuDNN in bf16 (``F.conv2d``, ``conv2d_input``,
   ``conv2d_weight``: yardsticks the port never calls) and the bound at
   the bf16 peak; per part and batch the sums and the profiler's device
   time of the 13 (12) calls (not measured where the profiler saw fewer
   of the port's kernels run than the calls launched); with ``--parent
   DIR``, each VGG-16 row at batch 8 and each batch-8 sum also carries
   the parent checkout's time from the same run
   (``tools/bf16_conv_times.py`` on DIR); the build phase logs each bf16
   entry's registers and spills and its ``HGMMA`` (window) or ``HMMA``
   (gather, GEMM) count (a spill, a missing entry or none fails);
4. serve float: full-width VGG-16 (224x224x3, 13 convs, 4096-4096-1000
   head, seeded random weights) through ``repro_torch.serve.Server`` with
   buckets 1,4,8 on a bursts stream: conservation, build-once, every conv
   of every flush launched on the kernel (the launches counted in the run
   and, around each flush, per bucket), bucketed == unbatched bit for
   bit, logits close to the oracle substrate on the card; every bucket's
   executable is a CUDA graph captured once (``capture_counts`` 1 a key),
   and each bucket's replay equals its eager executable bit for bit on
   served images, with its ms by events beside the eager call's and its
   device time (``serve float: bucket 1: replay bit-equal ...`` lines);
   on bucket 1 the launches its capture recorded are held against the
   conv kernels ``torch.profiler`` sees in replays (no weight pre-pass);
5. serve int8: the same on the calibrated int8 lane; features bit-equal
   to the oracle substrate on the card;
5b. serve int5: the same on the int5 MSR lane (``quantize_int5``,
   ``calibrate_requant_int5``): 13 launches of the u8 x s8 kernel a
   flush, features bit-equal to the oracle substrate's ``forward_int5``,
   and ``forward_int5`` on the kernels bit-equal to ``forward_int8`` on
   the decompressed weights ``w5 << e`` with the exponent on the shift;
5g. AlexNet serve: full-width AlexNet (227x227x3, 5 convs, CL2, CL4
   and CL5 in 2 groups, seed-0 weights) built by
   ``serve_cnn.build_server`` on the float, int8 and int5 lanes with
   buckets 1, 4 and 8: one capture per key; no u8 x s8 weight pre-pass
   and no cut of a grouped layer's weights (``execute.group_parts``)
   recorded into any capture (``graphs.capture`` refuses either), so 0
   of either per replay; 8 kernel
   launches a replay (one per conv group); each bucket's replay bit-equal
   to its eager executable, timed, and held against the kernels
   ``torch.profiler`` sees in replays (no weight pre-pass kernel);
5c. f32exact and emulate_hw: at every VGG-16 conv and AlexNet's CL1,
   CL2, CL4 and CL5, batch 1, ``w_bits`` 8 and 5, the f32exact
   substrate bit-equal to the oracle at worst-case magnitudes (all-255
   x, each filter at +-127 or +-31) and on random inputs, with one launch
   of the conv kernel's fp32 lane a channel chunk (57 or 235 channels at
   K = 3; counted) and ``F.conv2d`` refused (no cuDNN, no float64
   oracle); its ms beside the u8 x s8 lane's; full-width VGG-16's
   ``forward_int8`` and ``forward_int5`` on f32exact at batch 1 bit-equal
   to the oracle substrate's, their fp32 launches counted from 0 (71 and
   26 chunks); AlexNet CL1 (stride 4) under ``emulate_hw`` (the stride-1
   sweep, decimated, unfused requant) bit-equal to the strided path on
   the int8 lane, on the kernel and on f32exact, at batch 1 and 8;
5d. chaos serve: full-width VGG-16 through ``serve_cnn.build_server``
   with the fault plane armed (``CHAOS_RUNS``), buckets 1,4,8, the serve
   phases' stream (bursts 1 s apart): the launcher's chaos spec
   ``seed=3,worker=1,stage=2,bitflip=1,exec=2`` at breaker threshold 1
   with 4 producer threads on the int5 lane (its ladder: the
   checksummed ``PackedWire`` and an int8 fallback lane), a lone bit-flip
   on the int5 lane (restored before serving), ``exec=2`` at threshold 1
   on the int8 lane (fallback ``int8-f32exact``) and ``nonfinite=1`` on
   the float lane: ``check_run`` passes; degradations, worker restarts,
   restores and retries counted where the spec plants them; every
   recorded failure injected; every degradation from the primary lane
   and within the fired budgets; 13 kernel launches a bucket run on the
   kernel lanes (the chunk count on ``int8-f32exact``), no ``F.conv2d``;
   the u8 x s8 weight pre-pass once per (weight tensor, layout), only for
   weights the wire re-materialized in the run; every served result
   bit-equal to the fault-free answer of the lane that served it; flushes
   and p50 per lane logged; one capture per key at warmup, and during the
   run captures only of the int5 lane's buckets after a wire restore (at
   least one per new wire, at most one a bucket; their warm calls'
   launches counted apart from the bucket runs'); then every lane x
   bucket's replay against its eager executable, bit for bit and timed
   (``int8-f32exact`` among them);
5e. wire: one bit flipped in each of the 13 layers of full-width VGG-16's
   ``PackedWire``: all 13 caught and restored by ``qparams()``, the
   restored ``kernel``/``shift`` equal to ``plan.quantize_int5``'s and the
   int5 features after the restore equal to those before the flip, bit
   for bit; the bucket captured once and again after each of the two
   restores, built once;
5f. emulator: the paper's Slice/Core/Engine emulator
   (``core.engine.TrimEngine``, ``PAPER_ENGINE``, numpy on the host)
   against kernel 1's u8 x s8 lane (int32 out, no epilogue) bit for bit
   on one seeded image: VGG-16 CL1 and AlexNet CL1 at full size and
   VGG-16 CL9 at 28x28 with its channels cut to 192 -> 224
   (``EMULATOR_LAYERS``); the emulator's fetch counters logged beside
   ``trim_memory_accesses``;
6. train: full-width VGG-16, batch 8, 4 AdamW steps from a seed-0 init
   on the ``SyntheticImageDataset`` stream through ``make_train_step`` on
   the default substrate, with the oracle substrate's step run on the
   same state and batch at every step: every loss and grad_norm finite,
   conv-kernel launches == steps x (13 forward + 12 dx; the first conv's
   dx is never computed), weight-gradient launches == steps x 13, step-0
   loss within rtol 1e-4 of the oracle's, every grad_norm and later loss
   within rtol 1e-3.
   A free-running oracle run from the same init is logged beside it; ms
   per step and images/s; one more step under ``torch.profiler``: device
   busy time and idle share, split by op (conv forward, dx, dw, the rest
   of the conv backward, pools, FC head, AdamW, other) and by our kernel;
6b. autotune: full-width VGG-16 on the int8 and float lanes at buckets 1
   and 8, every layer planned under ``tuning="auto"`` into a temporary
   cache directory (``engine/autotune.py``: the launch schedules of the
   conv kernel searched one knob at a time, f32exact and oracle on the
   int8 lane, each candidate bit-equal to the default's or dropped, a
   winner only past MIN_GAIN on a paired re-measure); per layer and
   bucket the default's geometry, the winner and both paired times
   (``autotune int8 bucket 8 CL5: ...``); then ``tuning="cached"`` plans
   the same model with no measurement, and each bucket's captured graph
   of the tuned plan replays bit-equal to the default plan's;
6c. bf16 forward: full-width VGG-16 at batch 1 and 8 and AlexNet at
   batch 1 through ``cnn_forward`` with bf16 params
   (``init_cnn(dtype=torch.bfloat16)``) and bf16 images: kernel 1's
   launches by lane counted from 0 around each forward (13, 13 and 8, all
   on bf16), bf16 logits, finite; the batch-1 logits against the same
   forward on CPU copies (the plain versions) within BF16_LOGIT_TOL x
   max|logit| (the fp32 kernels' logits on the same values logged beside
   it); VGG-16's conv stack at batch 8 bit-equal image by image to
   batch-1 calls;
6d. bf16 train: full-width VGG-16, batch 8, 4 AdamW steps (fp32 moments)
   from bf16 params on bf16 images: losses and grad norms finite, no step
   skipped, 100 launches on kernel 1's bf16 lane and 52 on kernel 2's and
   none on fp32, ms a step, peak device memory, one step profiled by op;
   each leaf's gradient against float64 on GRAD_CHECK_BATCH images
   through the bf16 kernels, the same bf16 function on CPU copies (the
   plain versions) and the fp32 kernels: per leaf max|diff| / max|leaf|,
   and the whole gradient's relative L2 error through the bf16 kernels
   within BF16_GRAD_RATIO x the plain versions';
7. LM serve: full-width mamba2-130m (24 layers, d_model 768, vocab
   50280, bf16, seed-0 random weights) through the functions of
   ``repro_torch.launch.serve``: one prefill of 4 x 4096 tokens, then 31
   greedy decode steps (32 generated tokens), first with the eager decode
   step, then through the decode step captured once as a CUDA graph, each
   after its own prefill: prefill ms, decode ms per step and tok/s of
   both, peak device memory of both and what the capture holds, a
   ``torch.profiler`` split of the prefill (with the flash kernels' device
   time in it beside the prefill's wall time, in every LM serve phase), of
   4 eager steps and of 4 replays (device busy time, idle share); conv1d launches exactly 24
   (one per layer) in the prefill and 0 in decode, flash launches 0; the
   graph's tokens equal the eager run's, and from a third prefill its
   logits equal the eager step's at each of the 31 steps, bit for bit
   (``... replayed decode steps bit-equal ...``); every logit finite;
8. LM checks, full width in fp32 (TF32 off): at batch 2 and S = 512,
   prefill(t[:S-1]) + decode_step(t[S-1]) equal the last row of
   prefill(t) within rtol = atol = 3e-4 (the JAX package's own serve
   tolerance), and prefill(t)'s logits through the kernel and through the
   oracle substrate (the plain conv) agree within 1e-6 of the largest
   |logit| (logged: bit-equal or not);
9. dense LM serve: phase 7 for full-width granite-3-2b (40 layers,
   d_model 2048, 32 q / 8 kv heads of 64, vocab 49155, bf16, seed-0
   random weights); flash launches exactly 40 in the prefill and 40 per
   decode step (1240 over 31 steps, counted per replay and held against
   the flash kernels ``torch.profiler`` sees in replays), conv1d
   launches 0;
10. dense LM checks: phase 8 for granite-3-2b, the kernels' logits
   within 1e-4 of the largest |logit| of the plain attention's;
11. LM train, mamba2-130m at full width in bf16 (fp32 AdamW moments),
   batch 4 x 1024 tokens of the ``SyntheticLMDataset`` stream, 4 steps
   of ``make_train_step`` at the launcher's lr under its config's
   ``remat="dots"``: the conv1d kernel launched exactly 48 times in each
   step (the forward and the backward's recompute; the backward is the
   plain version's VJP), every loss and grad_norm finite; ms per
   step, peak device memory, one more step's device busy time and idle
   share under ``torch.profiler``; the kernel timed at the training
   shape.  Checkpointed resume: the state after 2 steps (about 1.3 GB)
   saved through ``CheckpointManager`` (bytes, host copy and write
   seconds logged), restored by ``restore_latest`` into a seed-1 state
   (bit-equal, timed), and steps 2-3 taken from it give the
   uninterrupted run's losses bit for bit.  Then a first step in fp32 (TF32 off):
   each leaf's gradient through the kernels within 1e-4 (relative norm)
   of the oracle substrate's;
12. LM train, granite-3-2b at full width in bf16, batch 1 x 1024, 2
   steps, under its config's ``remat="dots"`` (each period's projections
   saved, the rest recomputed in the backward): flash launched exactly
   80 times in each step (40 forward, 40 in the recompute); then the
   same 2 steps from the same init at ``remat="none"`` (40 a step), and
   the losses bit-equal to the "dots" run's, or no further from them
   than a second "none" run is from the first; ms per step and peak
   device memory of each; then one loss and gradient without the
   optimizer at "dots", "none" and "full", twice in turns: launches 80 /
   40 / 80, losses bit-equal, the bytes the backward keeps at "dots"
   below "none"'s, the pass's peak (at this size the gradients' own, and
   the step's peak is AdamW's functional update: no remat moves either)
   and ms each (no profiled step: cut for the run's time); flash
   timed at the training shape (phase 11 does the same for mamba2-130m,
   whose full config is "dots" too: conv1d 48 a step);
13. code LM serve: phase 7 for full-width starcoder2-3b (30 layers,
   d_model 3072, 24 q / 2 kv heads of 128: G = 12, layernorm, tanh-gelu
   MLP, vocab 49152, bf16, seed-0 weights): flash launches exactly 30 in
   the prefill and per decode step, the replay bit-equal to eager;
14. code LM checks: phase 8 for starcoder2-3b, the kernels' logits
   within 1e-4 of the largest |logit| of the plain attention's;
15. gemma-7b serve: phase 7 for full-width gemma-7b (28 layers, d_model
   3072, 16 heads of 256, geglu, vocab 256000, the embedding scaled by
   sqrt(d_model) rounded to bf16, bf16, seed-0 weights): flash launches
   exactly 28 in the prefill and per decode step (868 over 31 steps), the
   replay bit-equal to eager;
16. gemma-7b checks: phase 8 for gemma-7b (fp32, TF32 off, batch 2, S =
   512), the kernels' logits within 1e-4 of the largest |logit| of the
   plain attention's;
17. MoE serve: phase 7 for llama4-maverick-400b-a17b at full width with
   its depth cut to one period of its schedule, 2 layers (a dense layer,
   then a 128-expert top-1 MoE layer with the shared expert; untied
   lm_head, vocab 202048, bf16, about 18.5 B parameters; the cut logged):
   flash launches exactly 2 in the prefill and per decode step; a second
   eager run from its own prefill gives the first's prefill logits and
   greedy tokens bit for bit, and the (token, choice) slots the MoE layer
   drops past capacity in a prefill and a decode step are logged; the
   replay bit-equal to eager;
18. encdec serve: phase 7 for full-width seamless-m4t-large-v2 (a
   24-layer non-causal encoder and a 24-layer decoder with
   cross-attention, d_model 1024, 16 heads of 64, gelu, layernorm, vocab
   256206 padded to 256256 and tied, bf16, seed-0 weights) on the
   launcher's encdec inputs: a seeded source of 4 x 4096 frames, a bos
   prefill, 31 greedy steps from position 1: flash launches exactly 72 in
   the prefill (24 encoder, 24 decoder self, 24 cross) and 48 per decode
   step (self under kv_length, cross over the cached cross-KV), each
   role's launches read around its attention calls, the
   replay bit-equal to eager (the cross-KV adopted from the third
   prefill), the prefill's device time split into the encoder and the
   rest;
19. encdec checks, full width in fp32 (TF32 off), batch 2, 512 source
   frames and 64 target tokens: prefill(t[:S-1]) + decode_step(t[S-1])
   equal the forward's last two rows within rtol = atol = 2e-4, the
   kernels' forward logits within 1e-4 of the largest |logit| of the
   plain attention's;
20. vlm serve: phase 7 for full-width llava-next-34b (60 layers, d_model
   7168, 56 q / 8 kv heads of 128, swiglu, untied lm_head, vocab 64000,
   64.05 GiB of bf16 seed-0 weights) on 576 seeded patch embeddings and
   3520 text tokens at batch 4 through ``make_prefill_step``, 31 greedy
   steps from position 4096: flash launches exactly 60 in the prefill and
   per decode step; where a second cache does not fit in the free
   memory, one cache alive at a time, the replay held bit-equal to the
   eager step on it (logits and the K/V row each writes, the row zeroed
   before each);
21. vlm checks: phase 19 for llava-next-34b at full width with its depth
   cut to 8 layers (fp32 at full depth is 128 GiB; the cut logged), 576
   patch embeddings + 512 text tokens, prefill + decode within 3e-4.

22. the mesh arm at world 1: NCCL, a (1, 1) ("data", "model")
   ``DeviceMesh`` on cuda, the state as DTensors placed by
   ``state_pspec``: full-width VGG-16 at batch 8, 4 steps through kernels
   1 and 2 on one device, on the mesh and on the mesh with int8 gradients
   (error feedback on): launches 25 conv + 13 wgrad a step on each; the
   mesh's losses and grad_norms equal the one-device step's bit for bit,
   the compressed step's first loss equal and its first grad_norm within
   2%; ms per step of each.  Then full-width mamba2-130m in bf16, batch 4
   x 1024, 4 steps with int8 gradients and error feedback, under its
   config's ``remat="dots"`` (DTensor state in the checkpointed
   periods): conv1d 48 launches a step, every loss finite; ms per step, peak device memory,
   the EF tree's bytes and norm, the collectives' bytes a step beside a
   plain fp32 all-reduce's;
23. the sequence-sharded decode across 2 ranks on the one card: two
   spawned processes over gloo (NCCL refuses two ranks on one device),
   each holding half of one llava-next-34b attention layer's unrepeated
   decode cache (q 56 heads, 8 KV heads of 128, batch 4, 4128 positions
   as 2 x 2064, a kv_length per row), each launching kernel 5's partial
   entry once on its half (the split decode writing each row's max and
   sum) and merging over gloo: bf16 within 2e-2 and 4 x 2^-7 of each
   row's max of the one-device split decode, fp32 within 2e-5 of the
   plain oracle, the cache halves bit-equal to the reference's; the
   entry timed on a half against its plain version and its bound; a
   collective gloo refuses fails the phase by name;
24. the launcher: ``torchrun --nproc-per-node 1 -m
   repro_torch.launch.train --arch mamba2-130m --compress-grads --steps
   4`` run from the script ends with finite losses (exit 0);
25. the encdec and moe mesh arms at world 1 (NCCL, a (1, 1) mesh, the
   params and caches as DTensors by ``serve_shardings``, through the
   serve launcher's ``MeshStep``): full-width seamless-m4t-large-v2 (4 x
   4096 source frames + bos, the dry-run cell's cache) and
   llama4-maverick's one period (18.5 B params; one device's logits
   copied to the host first, the same params then placed), a prefill and
   3 decode steps each, every logit bit-equal to one device's; flash
   launched 72 times a prefill and 48 a step (seamless), once a layer
   (llama4);
26. the Mamba slot with its heads cut, across 2 ranks on the one card
   over gloo, a (1, 2) mesh: full-width mamba2-130m (4 x 4096, 3 decode
   steps) with the cache's heads and conv channels cut by
   ``cache_pspec``, the weights whole on each rank, every collective a
   c10d call; kernel 3 launched 24 times a prefill on each rank's
   channels and none in decode; logits (in units of 2^-7 x each row's
   max) no farther from the one-device bf16 serve than it lies from the
   fp32 serve of the same params; kernel 3 timed at a rank's shape;
27. the dry-run held against the card: ``run_cell`` for
   seamless-m4t-large-v2 at a 4 x 4096 prefill cell on a fake world of 1
   (fake CPU tensors): its argument bytes within 1% of the device memory
   phase 25's params, cache and batch took; its flops over the measured
   prefill as a share of the bf16 peak, logged;
28. the port's examples: ``examples/torch/{quickstart,serve_lm,
   train_cnn,train_lm}.py`` each run on the card as a subprocess at its
   defaults (``train_lm`` into a fresh checkpoint directory): exit 0,
   their key lines printed and matched, and the kernel launches each
   prints as its path gives them (kernels 1 and 2 in train_cnn, kernel 3
   in serve_lm's prefill and train_lm's steps, kernels 1 and 5 in
   quickstart).

Phases 22-28 each log their time.

``--distributed`` runs only phases 1-2 and then phases 22-24 (no result
line).  ``--cards N`` runs only phases 1-2 and then the mesh arm across N
cards of one host, one process a card over NCCL (no result line): the
smoke configs' (N/2, 2) train steps (granite-3-2b at tp=2, mamba2-130m,
VGG-16; the kernels under ``local_map``) within JAX's bounds (loss
1e-4, params 5e-3) of one card's step; full-width VGG-16 at batch 8 and
mamba2-130m at 4 x 1024 (plain and int8 gradients) on (N, 1), ms per
step and wire bytes; llava-next-34b's decode layer with its cache cut N
ways, within the bf16 row limit of the one-card split decode and timed
against it.

``--family-mesh`` runs only phases 1-2 and then phases 25-27 (no result
line).  ``--cards N`` also serves llama4-maverick's one period with its
128 experts cut over the "model" axis of the (N/2, 2) mesh (every param
by ``param_pspec``), a prefill and 3 decode steps fed rank 0's one-card
tokens: each row whose last position takes one card's top-1 expert
within BF16_ROW_ULPS x 2^-7 of its max in rank 0's one-card logits, a
row routed elsewhere only where one card's router had its top two
experts within MOE_FLIP_MARGIN.

``--probe-families N`` runs only phases 1-2 and then phases 3i and 3e,
N times over, each row logged as it ends (to place an intermittent
launch fault; no result line).

``--drift SEEDS`` runs only phases 1-2 and then, at the train phase's
size and at peak lr 1e-3 and 1e-4, for each seed: the kernels' run
twice, the oracle's twice and the oracle with its batch as two
microbatches, logging each run's loss and grad_norm per step relative to
the first oracle run, and each leaf's gradient error against a float64
reference for the kernels and for the oracle.

Then a line of the captures per key of every engine the script built
(``captures per key (CUDA graphs; ...``), a ``{"kernels": [...]}`` JSON
line, the ``nvidia-smi`` name/power line, and last ``{"ok": true,
"device": {...}}``.
"""
import argparse
import contextlib
import gc
import itertools
import json
import os
import pathlib
import re
import subprocess
import sys
import time

#: when the script started: each log line carries the seconds since
T_START = time.perf_counter()
ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

#: H100 SXM peaks (NVIDIA data sheet, dense): fp32 on the CUDA cores,
#: int8 on the tensor cores, and HBM3 bandwidth.
PEAK_FP32 = 67e12
PEAK_INT8 = 1979e12
PEAK_BYTES = 3.35e12
KERNEL_SOURCE = "src/repro_torch/csrc/trim_conv2d.cu"
REPLACES = "src/repro/kernels/trim_conv2d.py:283"
#: The train phase: steps per run, batch, and the launcher's peak lr.
TRAIN_STEPS, TRAIN_BATCH, TRAIN_LR = 4, 8, 1e-3
WGRAD_SOURCE = "src/repro_torch/csrc/trim_conv2d_wgrad.cu"
WGRAD_REPLACES = "src/repro/kernels/trim_conv2d_vjp.py:92"
CONV1D_SOURCE = "src/repro_torch/csrc/trim_conv1d.cu"
CONV1D_REPLACES = "src/repro/kernels/trim_conv1d.py:24"
FLASH_SOURCE = "src/repro_torch/csrc/flash_attention.cu"
FLASH_REPLACES = "src/repro/kernels/flash_attention.py:38"
MATMUL_SOURCE = "src/repro_torch/csrc/trim_matmul.cu"
MATMUL_REPLACES = "src/repro/kernels/trim_matmul.py:27"
SSD_SOURCE = "src/repro_torch/csrc/trim_ssd.cu"
SSD_REPLACES = "src/repro/kernels/trim_ssd.py:39"
#: H100 SXM bf16 and TF32 dense tensor-core peaks (NVIDIA data sheet)
PEAK_BF16 = 989e12
PEAK_TF32 = 495e12
#: the bf16 conv lanes against their plain versions: one bf16 ulp of the
#: larger magnitude plus BF16_SUM_SLACK x n x 2^-24 x sum|terms| (two fp32
#: sums of n exact products, in other orders, part by at most about 2 n
#: 2^-24 sum|terms| each where they cancel)
BF16_SUM_SLACK = 4
#: the bf16 forward's logits against the same forward on the plain
#: versions: within BF16_LOGIT_TOL x max|logit| (the reference's bf16
#: conv tolerance, tests/test_kernels.py:64)
BF16_LOGIT_TOL = 2e-2
#: the bf16 train step's gradients against float64, on GRAD_CHECK_BATCH
#: images: the whole gradient's relative L2 error through the bf16
#: kernels within BF16_GRAD_RATIO x that of the same bf16 function on the
#: plain versions (two bf16 computations that differ in their fp32 sums'
#: order part by about sqrt(2) x the error of each where they are right)
BF16_GRAD_RATIO = 2.0
GRAD_CHECK_BATCH = 2
#: The LM serve phases: mamba2-130m (ssm) and granite-3-2b (dense) at
#: batch 4, a 4096-token prompt, 32 generated tokens; the fp32 checks at
#: batch 2 and 512 tokens.
LM_ARCH, DENSE_ARCH = "mamba2-130m", "granite-3-2b"
#: the dense arch served at G = n_q / n_kv = 12 and head dim 128
CODE_ARCH = "starcoder2-3b"
#: the dense arch served at head dim 256 (MHA, G = 1, geglu, the scaled
#: embedding), and the MoE arch served at full width with its depth cut to
#: one period of its schedule (a dense layer, then a 128-expert top-1 MoE
#: layer with the shared expert)
GEMMA_ARCH = "gemma-7b"
MOE_ARCH, MOE_LAYERS = "llama4-maverick-400b-a17b", 2
LM_BATCH, LM_PROMPT, LM_GEN = 4, 4096, 32
LM_CHECK_BATCH, LM_CHECK_LEN = 2, 512
#: the encdec arch (a 24-layer non-causal encoder over LM_PROMPT source
#: frames, a 24-layer decoder with cross-attention, decoding from a bos)
#: and the vlm arch (576 patch embeddings before LM_PROMPT - 576 text
#: tokens, 64.05 GiB of bf16 weights), both served at full width; the
#: encdec fp32 check's source and target lengths; the vlm fp32 check's
#: depth (full width in fp32 is 128 GiB)
ENCDEC_ARCH, VLM_ARCH = "seamless-m4t-large-v2", "llava-next-34b"
ENCDEC_CHECK_SRC, ENCDEC_CHECK_TGT = 512, 64
VLM_CHECK_LAYERS = 8
#: memory left free beyond a second LM cache and a prefill's transients
#: before phase_lm_serve holds the replay against the eager step on two
#: caches (allocator rounding, the eager step's own transients)
CACHE_HEADROOM = 2 * 2**30
#: max|kernel - plain| of the fp32 check's prefill logits, as a share of
#: max|logit|: the conv1d kernel is bit-equal to its plain version (1e-6
#: leaves room for nothing but reordered matmuls); the flash kernel sums
#: each score and output in another order than the plain einsums, through
#: 40 (granite) or 30 (starcoder2) layers (1e-4, about 800 fp32 ulps of
#: the largest logit)
LM_KERNEL_TOL = {LM_ARCH: 1e-6, DENSE_ARCH: 1e-4, CODE_ARCH: 1e-4,
                 GEMMA_ARCH: 1e-4, ENCDEC_ARCH: 1e-4, VLM_ARCH: 1e-4}
#: the encdec and vlm families' fp32 checks: prefill + decode against the
#: forward's last two rows within the JAX package's own serve tolerance
#: of the family (``tests/test_arch_smokes.py:73-78, 103-108``)
EXTRA_SERVE_TOL = {"encdec": 2e-4, "vlm": 3e-4}
#: the bf16 flash lane's row check: max|kernel - plain| over a row of D
#: outputs within BF16_ROW_ULPS x 2^-7 x the row's max|plain| (2^-7 x is
#: one to two bf16 ulps).  The kernel rounds P to bf16 for P.V and its
#: output once, the plain version only its output; a flat atol of 2e-2 is
#: most of a typical |out| at decode (about 0.026 over 4097 keys), where
#: this limit is about 2e-3.
BF16_ROW_ULPS = 4
#: the planted fault the row check must see: one 64-key tile dropped from
#: the full-width decode's keys, at key DROP_TILE
DROP_TILE = 1024
#: the bf16 matmul lane's row check: max|kernel - plain| over a row within
#: MATMUL_ROW_ULPS x 2^-7 x the row's max|plain| (both sum exact bf16
#: products in fp32, in another order, and round once to bf16)
MATMUL_ROW_ULPS = 2
#: the SSD kernel at full width (mamba2-130m's shape, random and real
#: inputs, and jamba-1.5-large's) against its plain version in fp32:
#: max|kernel - plain| within SSD_FULL_TOL x max|plain| (the kernel's chunk
#: of 128 against the plain version's 256, sums in another order and
#: 3xTF32 products: rounding only)
SSD_FULL_TOL = 1e-4
#: phase 3f's small SSD cases (B, L, H, P, S, chunk), each on every seed:
#: ``tests/test_ssd_kernel.py``'s CASES, then past one P tile (64) or S
#: tile (128), whole and ragged, and jamba-1.5-large's smoke dims
SSD_SMOKE_CASES = ((2, 37, 3, 8, 16, 8), (1, 64, 2, 4, 8, 16),
                   (2, 16, 1, 8, 8, 16), (1, 128, 2, 16, 32, 32),
                   (1, 300, 2, 128, 128, 256), (1, 130, 3, 96, 192, 64),
                   (2, 65, 2, 200, 256, 64), (2, 100, 4, 16, 16, 32))
SSD_SMOKE_SEEDS = (6, 16, 26, 36)
#: the hybrid arch whose Mamba2 mixer phase 3f runs at full width: 128
#: heads of P = 128, S = 128, B/C of 8 groups repeated over the heads
HYBRID_ARCH = "jamba-1.5-large-398b"


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    """Print ``msg`` with the seconds since the script started."""
    print(f"[chip_smoke {time.perf_counter() - T_START:7.1f} s] {msg}",
          flush=True)


def phase_environment(torch):
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a GPU")
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        fail(f"compute capability {cap}: the kernels are built for sm_90a")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, capability {cap}")
    log(f"card: {card}")
    return card


def phase_build():
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import trim_conv1d as k1d
    from repro_torch.kernels import trim_conv2d as kern
    from repro_torch.kernels import trim_conv2d_vjp as vjp
    from repro_torch.kernels import trim_matmul as mm
    from repro_torch.kernels import trim_ssd as ks

    mods = (kern, vjp, k1d, fa, mm, ks)
    libs = [(m._LIB_NAME, m._SOURCES) for m in mods]
    t0 = time.perf_counter()
    _build.build_all(libs)
    for m in mods:
        m.load_library()
    log(f"built+loaded {[name for name, _ in libs]} in "
        f"{time.perf_counter() - t0:.1f} s (nvcc, in parallel: "
        + ", ".join(f"{name} {_build.BUILD_SECONDS.get(name, 0.0):.1f} s"
                    for name, _ in libs) + ")")
    for name, sources in libs:
        for line in (_build.build_log(name, sources) or "").splitlines():
            if "registers" in line or "spill" in line.lower():
                log(f"ptxas {name}: {line.strip()}")
    _log_conv_build()
    _log_ssd_build()
    _log_flash_build()


def _ptxas_by_entry(log_text: str, entries: dict) -> dict:
    """{label: "N registers ...; spills ..."} for each kernel entry of a
    ``-Xptxas -v`` build log whose mangled name holds a key of
    ``entries`` (key -> label)."""
    lines = log_text.splitlines()
    out = {}
    for i, line in enumerate(lines):
        if "Compiling entry function" not in line:
            continue
        label = next((v for k, v in entries.items() if k in line), None)
        if label is not None:
            out[label] = " ".join(
                x.split("ptxas info    :")[-1].strip()
                for x in lines[i + 1:i + 4]
                if "registers" in x or "spill" in x)
    return out


#: The u8 x s8 lane's kernel entries: mangled-name fragment -> label.
U8_ENTRIES = {
    "trim_conv2d_u8s8_slide_kernelIiE": "u8s8 slide (K=3) int32 out",
    "trim_conv2d_u8s8_slide_kernelIhE": "u8s8 slide (K=3) uint8 out",
    "trim_conv2d_u8s8_kernelILi0EiE": "u8s8 window int32 out",
    "trim_conv2d_u8s8_kernelILi0EhE": "u8s8 window uint8 out",
    "trim_conv2d_u8s8_kernelILi1EiE": "u8s8 gather int32 out",
    "trim_conv2d_u8s8_kernelILi1EhE": "u8s8 gather uint8 out"}


#: The bf16 lane's kernel entries: mangled-name fragment -> (label, the
#: tensor-core instruction its SASS must hold): the wgmma window path at 64
#: and 128 filters a block (HGMMA), the gather path (mma.sync: HMMA).
BF16_ENTRIES = {
    "trim_conv2d_bf16_wgmma_kernelILi64EE": ("bf16 wgmma window fb=64",
                                             "HGMMA"),
    "trim_conv2d_bf16_wgmma_kernelILi128EE": ("bf16 wgmma window fb=128",
                                              "HGMMA"),
    "trim_conv2d_bf16_kernelILi1EE": ("bf16 gather", "HMMA")}


def _sass_counts(lib_path, entries: dict) -> tuple:
    """({label: the count of its instruction in the entry's SASS} for each
    entry of ``entries`` (mangled-name fragment -> (label, instruction))
    found in the library's ``cuobjdump -sass``, the process)."""
    from repro_torch.kernels import _build

    cuobjdump = pathlib.Path(_build.find_nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib_path)],
                          capture_output=True, text=True, timeout=300)
    counts, cur = {}, None
    for line in sass.stdout.splitlines():
        if "Function :" in line:
            cur = next((v for k, v in entries.items() if k in line), None)
            if cur is not None:
                counts[cur[0]] = 0
        elif cur is not None and re.search(rf"\b{cur[1]}\b", line):
            counts[cur[0]] += 1
    return counts, sass


def _log_conv_build() -> None:
    """The conv kernel's registers and spills per path from its
    ``-Xptxas -v`` build log (the fp32 and u8 x s8 lanes are built for two
    blocks an SM: at most 128 registers a thread; the bf16 wgmma window
    path for two blocks of 288 threads: at most 112), and the tensor-core
    instruction count of each u8s8 (``IMMA``) and bf16 entry's SASS (the
    wgmma window path's ``HGMMA``, the gather path's ``HMMA``); fails
    where a bf16 entry is missing, spills or runs none of its instruction,
    or a u8s8 entry runs no ``IMMA``."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import trim_conv2d as kern

    bf16 = {k: v[0] for k, v in BF16_ENTRIES.items()}
    entries = {"trim_conv2d_f32_kernelILi3E": "fp32 K=3 slide",
               "trim_conv2d_f32_kernelILi5E": "fp32 K=5 slide",
               "trim_conv2d_f32_kernelILi0E": "fp32 generic",
               "trim_conv2d_f32_merge": "fp32 split merge",
               **U8_ENTRIES,
               "trim_conv2d_u8s8_wprep": "u8s8 weight transposition",
               "trim_conv2d_u8s8_mergeIiE": "u8s8 split merge int32 out",
               "trim_conv2d_u8s8_mergeIhE": "u8s8 split merge uint8 out",
               **bf16,
               "trim_conv2d_bf16_merge": "bf16 gather split merge"}
    found = _ptxas_by_entry(
        _build.build_log(kern._LIB_NAME, kern._SOURCES) or "", entries)
    for label in entries.values():
        log(f"conv kernel, {label} path: {found.get(label, 'not in the log')}")
    for label in bf16.values():
        info = found.get(label)
        if info is None or any(int(v) for v in re.findall(
                r"(\d+) bytes spill", info)):
            fail(f"conv kernel {label}: not built, or spills ({info})")
    tc = {**{k: (v, "IMMA") for k, v in U8_ENTRIES.items()}, **BF16_ENTRIES}
    mma, sass = _sass_counts(
        _build.library_path(kern._LIB_NAME, kern._SOURCES), tc)
    for label, op in tc.values():
        n = mma.get(label)
        log(f"conv kernel, {label}: "
            + ("not in the SASS" if n is None else f"{n} {op} instructions"))
        if not n:
            fail(f"conv kernel {label}: no {op} in its SASS (cuobjdump rc "
                 f"{sass.returncode}: {sass.stderr.strip()[:200]})")


#: The flash kernel's entries, one per path and head dim: mangled-name
#: fragment -> label; the bf16 prefill's is ``flash_prefill_wg_kernel`` at
#: D <= 64, ``flash_prefill_kernel`` at D = 128 and 256; the fp32 split
#: decode's one per rows bucket (1, 4, 8, 16).
FLASH_HEAD_DIMS = (8, 16, 32, 64, 128, 256)
FLASH_PREFILL_ENTRIES = {
    f"flash_prefill_{'wg_' if D <= 64 else ''}kernelILi{D}EE":
        f"bf16 prefill D={D}" for D in FLASH_HEAD_DIMS}
FLASH_F32_ENTRIES = {
    **{f"flash_prefill_f32_kernelILi{D}EE": f"fp32 prefill D={D}"
       for D in FLASH_HEAD_DIMS},
    **{f"flash_decode_split_f32_kernelILi{D}ELi{R}EE":
       f"fp32 split decode D={D} rows {R}"
       for D in FLASH_HEAD_DIMS for R in (1, 4, 8, 16)}}
FLASH_ENTRIES = {**FLASH_PREFILL_ENTRIES, **FLASH_F32_ENTRIES,
                 **{f"flash_decode_split_kernelILi{D}EE":
                    f"bf16 split decode D={D}" for D in FLASH_HEAD_DIMS}}


def _log_flash_build() -> None:
    """The flash kernel's registers and spills per path and head dim from
    its ``-Xptxas -v`` build log, and the ``HGMMA`` (wgmma) count of each
    bf16 prefill entry's SASS; fails where an entry is missing, where a
    bf16 prefill or fp32 entry spills, where a bf16 prefill entry has its
    wgmma serialized by ptxas ("Potential Performance Loss" in the log) or
    runs no ``HGMMA``."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa

    text = _build.build_log(fa._LIB_NAME, fa._SOURCES) or ""
    found = _ptxas_by_entry(text, FLASH_ENTRIES)
    for label in FLASH_ENTRIES.values():
        info = found.get(label)
        log(f"flash kernel, {label}: {info or 'not in the log'}")
        if info is None:
            fail(f"flash kernel {label}: not in the build log")
    for key, label in FLASH_PREFILL_ENTRIES.items():
        serial = [line for line in text.splitlines()
                  if "serialized" in line and key in line]
        if any(int(v) for v in re.findall(r"(\d+) bytes spill",
                                          found[label])) or serial:
            fail(f"flash kernel {label}: spills or serialized wgmma "
                 f"({found[label]}; {serial[:1]})")
    for label in FLASH_F32_ENTRIES.values():
        if any(int(v) for v in re.findall(r"(\d+) bytes spill",
                                          found[label])):
            fail(f"flash kernel {label}: spills ({found[label]})")
    hg, sass = _sass_counts(
        _build.library_path(fa._LIB_NAME, fa._SOURCES),
        {k: (v, "HGMMA") for k, v in FLASH_PREFILL_ENTRIES.items()})
    for label in FLASH_PREFILL_ENTRIES.values():
        n = hg.get(label)
        log(f"flash kernel, {label}: "
            + ("not in the SASS" if n is None else f"{n} HGMMA instructions"))
        if not n:
            fail(f"flash kernel {label}: no HGMMA in its SASS (cuobjdump rc "
                 f"{sass.returncode}: {sass.stderr.strip()[:200]})")


#: The SSD kernel's stages per lane: mangled-name fragment -> label.
SSD_ENTRIES = {f"ssd_{stage}_kernelINS_{lane}": f"{stage} {name}"
               for stage in ("cb", "state", "out")
               for lane, name in (("7F32Lane", "fp32"), ("8Bf16Lane", "bf16"))}
SSD_ENTRIES["ssd_pass_kernel"] = "pass"


def _log_ssd_build() -> None:
    """The SSD kernel's registers and spills per stage and lane from its
    ``-Xptxas -v`` build log; fails where a stage is missing or spills."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import trim_ssd as ks

    found = _ptxas_by_entry(
        _build.build_log(ks._LIB_NAME, ks._SOURCES) or "", SSD_ENTRIES)
    for label in SSD_ENTRIES.values():
        info = found.get(label)
        log(f"ssd kernel, {label} stage: {info or 'not in the log'}")
        spills = re.findall(r"(\d+) bytes spill", info or "")
        if info is None or any(int(v) for v in spills):
            fail(f"ssd kernel {label} stage: not built, or spills ({info})")


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls (CUDA
    events, after one warm call; inputs stay L2-resident when they fit)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def issue_ms(torch, fn, reps: int) -> float:
    """Host time per call of ``fn`` over ``reps`` calls issued back to
    back without waiting for the device (after one warm call).  Where it
    is not below ``cuda_ms``'s time, that time measures the host."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / reps * 1e3


def device_ms(torch, fn, calls: int, by=None, kernels=None):
    """Device (kernel) time per call of ``fn`` over ``calls`` calls under
    ``torch.profiler``, after one warm call and one profiled warm-up round
    of the calls: every kernel the calls launched, summed; None (not measured) where the profiler saw no
    device time.  With ``by`` (a kernel's name -> a group or None): a
    dict of the time per call of each group, {} where none was seen.
    With ``kernels`` (a name fragment, the kernels of that name one call
    launches): None (not measured) unless the profiler saw exactly
    ``calls`` times as many such kernels run -- a sum over fewer kernels
    than ran is no time of the calls."""
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    # one profiled round of the calls as warm-up, then the one that is
    # read: CUPTI dropped the first kernels of a window (3 of 65 in 3j)
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(2):
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            prof.step()
    groups, seen = {}, 0
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", 0)
        group = by(e.key) if by else "all"
        if not str(e.device_type).endswith("CUDA"):
            continue
        if kernels is not None and kernels[0] in e.key:
            seen += e.count
        if group and t > 0:
            groups[group] = groups.get(group, 0.0) + t / 1e3 / calls
    if kernels is not None and seen != kernels[1] * calls:
        log(f"profiler: {seen} kernels named {kernels[0]!r} ran in "
            f"{calls} calls, not the {kernels[1] * calls} launched: the "
            "sum is not measured")
        return {} if by else None
    return groups if by else groups.get("all")


def _fmt(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f}"


def bound(macs: int, nbytes: int, integer: bool, peak: float = 0.0) -> dict:
    """The least time for one call: operations over the peak rate (int8,
    fp32 or ``peak``) and bytes (each input read once, each output
    written once) over HBM."""
    peak = peak or (PEAK_INT8 if integer else PEAK_FP32)
    ops_ms = 2.0 * macs / peak * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "ops_ms": ops_ms, "bytes_ms": bytes_ms}


def phase_kernels(torch, reps: int):
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for arch, i, l, groups in _conv_cases():
        rows.append(_f32_row(torch, gen, arch, l, groups, 1, reps))
    # the int8 lane at every VGG-16 and AlexNet conv, batch 1 and 8
    for N in (1, TRAIN_BATCH):
        for arch, i, l, groups, last in _u8_cases():
            rows.append(_u8_row(torch, gen, arch, l, groups, last, N, reps))
    # the int5 lane (the u8 x s8 kernel on MSR operands, folded pairs) at
    # every VGG-16 conv, batch 1 and 8, and every AlexNet conv at batch 1
    for N in (1, TRAIN_BATCH):
        for arch, i, l, groups, last in _u8_cases():
            if arch == "vgg16" or N == 1:
                rows.append(_u8_row(torch, gen, arch, l, groups, last, N,
                                    reps, int5=True))
    # the float lane at AlexNet's CL3-CL5 (CL1 and CL2 are in
    # _conv_cases), batch 1: with them the AlexNet serve phase's replays
    # have a row for every conv on each lane
    for arch, i, l, groups, last in _u8_cases():
        if arch == "alexnet" and i >= 2:
            rows.append(_f32_row(torch, gen, arch, l, groups, 1, reps))
    # the float lane at the train phase's batch (its forward convs)
    for arch, i, l, groups in _conv_cases():
        rows.append(_f32_row(torch, gen, arch, l, groups, TRAIN_BATCH, reps))
    for r in rows:
        lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        dev_ms = ("" if "issue_ms" not in r else
                  f"; device_ms {_fmt(r['device_ms'])} host issue ms "
                  f"{r['issue_ms']:.4f}")
        log(f"kernel {r['arch']:7s} {r['layer']:4s} {r['lane']:4s} batch "
            f"{r['batch']} {r['epilogue']:12s} ms {r['ms']:.4f} plain_ms "
            f"{r['plain_ms']:.4f} library_ms {lib} bound_ms "
            f"{r['bound_ms']:.4f} ({r['bound_by']}) err "
            f"{r['max_abs_err']:.3g}{dev_ms}")
    for lane, N in (("f32", 1), ("u8s8", 1), ("int5", 1),
                    ("f32", TRAIN_BATCH), ("u8s8", TRAIN_BATCH),
                    ("int5", TRAIN_BATCH)):
        sel = [r for r in rows if r["lane"] == lane and r["batch"] == N
               and r["arch"] == "vgg16"]
        lib = ("null" if sel[0]["library_ms"] is None else
               f"{sum(r['library_ms'] for r in sel):.4f}")
        dev_ms = ("" if None in [r["device_ms"] for r in sel]
                  else f" device_ms {sum(r['device_ms'] for r in sel):.4f}")
        log(f"kernel vgg16 {lane} batch {N}, sum of {len(sel)} convs: ms "
            f"{sum(r['ms'] for r in sel):.4f}{dev_ms} plain_ms "
            f"{sum(r['plain_ms'] for r in sel):.4f} library_ms {lib} "
            f"bound_ms {sum(r['bound_ms'] for r in sel):.4f}")
    return rows


def _f32_row(torch, gen, arch, l, groups, N, reps) -> dict:
    """The float lane (bias + ReLU) at one conv shape and batch ``N``:
    the kernel against its plain version (rtol 1e-4 / atol 1e-4 *
    max|plain|; at N > 1 also image 0 bit-equal to a call on it alone),
    and its timings beside the plain version's, cuDNN's and the bound."""
    import torch.nn.functional as F

    from repro_torch.engine import ExecutionPolicy
    from repro_torch.kernels import ops

    dev = torch.device("cuda", 0)
    kernel_pol = ExecutionPolicy(substrate="kernel")
    oracle_pol = ExecutionPolicy(substrate="oracle")
    C, Cg = l.M * groups, l.M
    K, Fo, S, p = l.K, l.N, l.stride, l.padding
    macs = N * l.H_O * l.W_O * Fo * K * K * Cg
    x = torch.randn((N, l.H_I, l.W_I, C), generator=gen, device=dev)
    w = torch.randn((K, K, Cg, Fo), generator=gen, device=dev) \
        * (2.0 / (K * K * Cg)) ** 0.5
    b = torch.randn((Fo,), generator=gen, device=dev) * 0.1

    def run(pol, x=x):
        return ops.trim_conv2d(x, w, b, stride=S, padding=p, groups=groups,
                               relu=True, policy=pol)

    got, want = run(kernel_pol), run(oracle_pol)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    if got.shape != want.shape or not torch.allclose(
            got, want, rtol=1e-4, atol=1e-4 * scale):
        fail(f"{arch} {l.name} float batch {N}: max|kernel-plain| = "
             f"{err:.3g} (max|plain| {scale:.3g})")
    if N > 1 and not torch.equal(got[:1], run(kernel_pol, x[:1])):
        fail(f"{arch} {l.name} float: image 0 of a batch of {N} differs "
             "from the same image alone")
    x_nchw = x.permute(0, 3, 1, 2)          # channels-last view
    w_oihw = w.permute(3, 2, 0, 1).contiguous()
    nbytes = 4 * (x.numel() + w.numel() + b.numel() + got.numel())
    return {
        "arch": arch, "layer": l.name, "lane": "f32", "batch": N,
        "epilogue": "bias+relu", "launches": groups,
        "ms": cuda_ms(torch, lambda: run(kernel_pol), reps),
        "device_ms": device_ms(torch, lambda: run(kernel_pol), 10),
        "issue_ms": issue_ms(torch, lambda: run(kernel_pol), reps),
        "plain_ms": cuda_ms(torch, lambda: run(oracle_pol), reps),
        "library_ms": cuda_ms(torch, lambda: F.conv2d(
            x_nchw, w_oihw, b, stride=S, padding=p, groups=groups), reps),
        "max_abs_err": err, **bound(macs, nbytes, integer=False)}


def _conv_cases():
    from repro_torch.core.model import ALEXNET_LAYERS, VGG16_LAYERS

    cases = [("vgg16", i, l, 1) for i, l in enumerate(VGG16_LAYERS)]
    return cases + [("alexnet", 0, ALEXNET_LAYERS[0], 1),
                    ("alexnet", 1, ALEXNET_LAYERS[1], 2)]


def _u8_cases():
    """(arch, index, layer, groups, last) of every conv of both networks:
    the int8 lane's shapes (each network's last conv writes raw int32)."""
    from repro_torch.core.model import ALEXNET_LAYERS, VGG16_LAYERS

    out = []
    for arch, layers in (("vgg16", VGG16_LAYERS), ("alexnet", ALEXNET_LAYERS)):
        c = 3
        for i, l in enumerate(layers):
            out.append((arch, i, l, c // l.M, i == len(layers) - 1))
            c = l.N
    return out


def _u8_row(torch, gen, arch, l, groups, last, N, reps, int5=False) -> dict:
    """The int8 lane (ReLU + per-channel requant; ReLU into raw int32 on
    a network's last conv) at one conv shape and batch ``N``: the kernel
    bit for bit against its plain version, and its timings (events,
    profiler device time, host issue time) beside the plain version's and
    the bound.  No PyTorch call computes this function: no yardstick.
    ``int5``: the int5 MSR lane's call instead, the kernel on the MSR
    operands ``w5`` (|w5| <= 31) of random int8 weights, with the
    requant pairs calibrated on ``psum5 << e`` and ``e`` folded in."""
    import numpy as np

    from repro_torch.core.quant import (fold_shift_into_requant,
                                        msr_compress, msr_operand)
    from repro_torch.engine import ExecutionPolicy
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.requant import scale_to_mult_shift
    from repro_torch.kernels.trim_conv2d import apply_epilogue

    dev = torch.device("cuda", 0)
    kernel_pol = ExecutionPolicy(substrate="kernel")
    oracle_pol = ExecutionPolicy(substrate="oracle")
    C, Cg = l.M * groups, l.M
    K, Fo, S, p = l.K, l.N, l.stride, l.padding
    macs = N * l.H_O * l.W_O * Fo * K * K * Cg
    xq = torch.randint(0, 256, (N, l.H_I, l.W_I, C), generator=gen,
                       device=dev, dtype=torch.uint8)
    wq = torch.randint(-127, 128, (K, K, Cg, Fo), generator=gen,
                       device=dev, dtype=torch.int8)
    e = np.zeros((Fo,), np.int32)
    if int5:
        w5, e = msr_operand(*msr_compress(wq.cpu().numpy()))
        wq = torch.from_numpy(w5).to(dev)
    rq = None
    if not last:
        psum = apply_epilogue(
            ref.conv2d(xq, wq, stride=S, padding=p, groups=groups),
            None, True, None)
        psum = torch.bitwise_left_shift(psum, torch.from_numpy(e).to(dev))
        amax = psum.amax(dim=(0, 1, 2)).cpu().numpy().astype("float64")
        m, s = scale_to_mult_shift(255.0 / amax.clip(min=1.0))
        if int5:
            m, s = fold_shift_into_requant(m, s, e)
        rq = (torch.as_tensor(m, device=dev), torch.as_tensor(s, device=dev))

    def runq(pol):
        return ops.trim_conv2d(xq, wq, None, rq, stride=S, padding=p,
                               groups=groups, relu=True, policy=pol)

    got, want = runq(kernel_pol), runq(oracle_pol)
    torch.cuda.synchronize()
    if got.dtype != want.dtype or not torch.equal(got, want):
        diff = (got.to(torch.int64) - want.to(torch.int64)).abs().max()
        fail(f"{arch} {l.name} {'int5' if int5 else 'int8'} batch {N}: "
             f"kernel != plain (max diff {diff})")
    nbytes = (xq.numel() + wq.numel() + got.numel() * got.element_size()
              + (0 if rq is None else 8 * Fo))
    return {
        "arch": arch, "layer": l.name, "lane": "int5" if int5 else "u8s8",
        "batch": N,
        "epilogue": "relu" if last else "relu+requant",
        "launches": groups,
        "ms": cuda_ms(torch, lambda: runq(kernel_pol), reps),
        "device_ms": device_ms(torch, lambda: runq(kernel_pol), 10),
        "issue_ms": issue_ms(torch, lambda: runq(kernel_pol), reps),
        "plain_ms": cuda_ms(torch, lambda: runq(oracle_pol),
                            max(1, reps // 4)),
        "library_ms": None, "max_abs_err": 0.0,
        **bound(macs, nbytes, integer=True)}


def _close(got, want, what: str) -> float:
    """Max |got - want|; fails unless within rtol 1e-3 / atol 1e-3 *
    max|want| (fp32 sums over up to 224^2 terms in another order)."""
    import torch

    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    if got.shape != want.shape or not torch.allclose(
            got, want, rtol=1e-3, atol=1e-3 * scale):
        fail(f"{what}: max|kernel-plain| = {err:.3g} (max|plain| "
             f"{scale:.3g})")
    return err


def phase_backward(torch, reps: int, batches):
    """The weight-gradient kernel and the input gradient (through the
    conv kernel) against their plain versions at the model's shapes, at
    each batch of ``batches`` (one image, and the train phase's batch)."""
    from torch.nn.grad import conv2d_input, conv2d_weight

    from repro_torch.kernels.trim_conv2d_vjp import (
        trim_conv2d_input_grad, trim_conv2d_wgrad, trim_conv2d_wgrad_plain)

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(1)
    rows = []
    for N, (arch, i, l, groups) in ((n, c) for n in batches
                                    for c in _conv_cases()):
        Cg, Fg = l.M, l.N // groups
        K, S, p = l.K, l.stride, l.padding
        H_O, W_O = l.H_O, l.W_O
        macs = N * H_O * W_O * Fg * K * K * Cg * groups
        x = torch.randn((N, l.H_I, l.W_I, Cg * groups), generator=gen,
                        device=dev)
        g = torch.randn((N, H_O, W_O, l.N), generator=gen, device=dev)
        w = torch.randn((K, K, Cg, l.N), generator=gen, device=dev) \
            * (2.0 / (K * K * Cg)) ** 0.5
        xs = [x[..., j * Cg:(j + 1) * Cg].contiguous() for j in range(groups)]
        gs = [g[..., j * Fg:(j + 1) * Fg].contiguous() for j in range(groups)]
        ws = [w[..., j * Fg:(j + 1) * Fg].contiguous() for j in range(groups)]
        # NCHW views and OIHW weights for cuDNN
        xn = [t.permute(0, 3, 1, 2) for t in xs]
        gn = [t.permute(0, 3, 1, 2) for t in gs]
        wn = [t.permute(3, 2, 0, 1).contiguous() for t in ws]

        def dw(fn=trim_conv2d_wgrad, xs=xs, gs=gs, K=K, S=S, p=p):
            return [fn(a, b, K=K, stride=S, padding=p)
                    for a, b in zip(xs, gs)]

        def dx(gs=gs, ws=ws, l=l, S=S, p=p):
            return [trim_conv2d_input_grad(b, c, x_hw=(l.H_I, l.W_I),
                                           stride=S, padding=p)
                    for b, c in zip(gs, ws)]

        def dw_lib(xn=xn, gn=gn, wn=wn, S=S, p=p):
            return [conv2d_weight(a, c.shape, b, stride=S, padding=p)
                    for a, b, c in zip(xn, gn, wn)]

        def dx_lib(xn=xn, gn=gn, wn=wn, S=S, p=p):
            return [conv2d_input(a.shape, c, b, stride=S, padding=p)
                    for a, b, c in zip(xn, gn, wn)]

        # dw against the per-tap plain version; dx against cuDNN's input
        # gradient (F.conv2d's own backward, independent of the zero
        # stuffing and padding that feed the conv kernel)
        name = f"{arch} {l.name} batch {N}"
        err_w = max(_close(a, b, f"{name} dw")
                    for a, b in zip(dw(), dw(trim_conv2d_wgrad_plain)))
        err_x = max(_close(a, b.permute(0, 2, 3, 1), f"{name} dx")
                    for a, b in zip(dx(), dx_lib()))
        # each fp32 result's error against cuDNN in float64, relative to
        # the largest float64 value: how accurate the kernel is next to
        # cuDNN (logged, not checked)
        x64, g64, w64 = ([t.double() for t in ts] for ts in (xn, gn, wn))
        dw64 = [conv2d_weight(a, c.shape, b, stride=S, padding=p)
                for a, b, c in zip(x64, g64, w64)]
        dx64 = [conv2d_input(a.shape, c, b, stride=S, padding=p)
                .permute(0, 2, 3, 1) for a, b, c in zip(x64, g64, w64)]
        f64 = {
            "dw": (_f64_err(dw(), dw64, lambda t: t.permute(3, 2, 0, 1)),
                   _f64_err(dw_lib(), dw64)),
            "dx": (_f64_err(dx(), dx64),
                   _f64_err([t.permute(0, 2, 3, 1) for t in dx_lib()],
                            dx64))}
        nbytes = 4 * (x.numel() + g.numel() + w.numel())
        common = {"arch": arch, "layer": l.name, "batch": N,
                  "launches": groups, **bound(macs, nbytes, integer=False)}
        rows.append({
            **common, "kind": "dw", "max_abs_err": err_w,
            "f64_err": f64["dw"],
            "ms": cuda_ms(torch, dw, reps),
            "issue_ms": issue_ms(torch, dw, reps),
            "plain_ms": cuda_ms(torch, lambda: dw(trim_conv2d_wgrad_plain),
                                reps),
            "library_ms": cuda_ms(torch, dw_lib, reps)})
        rows.append({
            **common, "kind": "dx", "max_abs_err": err_x,
            "f64_err": f64["dx"],
            "ms": cuda_ms(torch, dx, reps), "plain_ms": None,
            "library_ms": cuda_ms(torch, dx_lib, reps)})
    for r in rows:
        plain = ("-" if r["plain_ms"] is None else f"{r['plain_ms']:.4f}")
        log(f"backward {r['arch']:7s} {r['layer']:4s} batch {r['batch']} "
            f"{r['kind']} ms {r['ms']:.4f} plain_ms {plain} library_ms "
            f"{r['library_ms']:.4f} bound_ms {r['bound_ms']:.4f} "
            f"({r['bound_by']}) ms/bound {r['ms'] / r['bound_ms']:.2f} "
            f"err {r['max_abs_err']:.3g}; vs float64 "
            f"kernel {r['f64_err'][0]:.3g} cuDNN {r['f64_err'][1]:.3g}"
            + (f"; host issue ms {r['issue_ms']:.4f}" if "issue_ms" in r
               else ""))
    for N in batches:
        dws = [r for r in rows if r["kind"] == "dw" and r["batch"] == N
               and r["arch"] == "vgg16"]
        ms, bnd = sum(r["ms"] for r in dws), sum(r["bound_ms"] for r in dws)
        log(f"backward vgg16 dw batch {N}, sum of {len(dws)} convs: ms "
            f"{ms:.4f} bound_ms {bnd:.4f} (bound/ms {bnd / ms:.3f}) "
            f"library_ms {sum(r['library_ms'] for r in dws):.4f}")
        # the train step's dx: every VGG-16 conv but the first
        dxs = [r for r in rows if r["kind"] == "dx" and r["batch"] == N
               and r["arch"] == "vgg16" and r["layer"] != "CL1"]
        log(f"backward vgg16 dx batch {N}, sum of {len(dxs)} convs (the "
            f"train step's): ms {sum(r['ms'] for r in dxs):.4f} bound_ms "
            f"{sum(r['bound_ms'] for r in dxs):.4f} library_ms "
            f"{sum(r['library_ms'] for r in dxs):.4f}")
    _log_wgrad_build()
    return rows


#: The weight-gradient kernel's bf16 entries: mangled-name fragment ->
#: (label, the tensor-core instruction its SASS must hold).
WGRAD_BF16_ENTRIES = {
    "wgrad_bf16_window_kernel": ("bf16 window (wgmma)", "HGMMA"),
    "wgrad_bf16_kernel": ("bf16 GEMM (C % 8 != 0)", "HMMA")}


def _log_wgrad_build() -> None:
    """The weight-gradient kernel's registers and spills per thread from
    its ``-Xptxas -v`` build log, beside the registers its fp32 split
    assumes (``WGRAD_REGS``: above it, fewer blocks fit an SM than it
    plans for), and each bf16 entry's tensor-core instruction count in its
    SASS (the window path's ``HGMMA``, the GEMM path's ``HMMA``); fails
    where a bf16 entry is missing, spills or runs none of its
    instruction."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import trim_conv2d_vjp as vjp

    paths = {"k3_kernel": vjp.PATH_K3, "kernelILb1E": vjp.PATH_VEC,
             "kernelILb0E": vjp.PATH_SCALAR}
    names = {vjp.PATH_K3: "K=3 taps", vjp.PATH_VEC: "16-byte rows",
             vjp.PATH_SCALAR: "scalar rows"}
    text = _build.build_log(vjp._LIB_NAME, vjp._SOURCES) or ""
    found = _ptxas_by_entry(text, paths)
    for path, info in found.items():
        log(f"wgrad kernel, {names[path]} path: {info}; the split assumes "
            f"{vjp.WGRAD_REGS[path]} registers")
    bf = _ptxas_by_entry(text, {k: v[0] for k, v in
                                WGRAD_BF16_ENTRIES.items()})
    mma, sass = _sass_counts(
        _build.library_path(vjp._LIB_NAME, vjp._SOURCES), WGRAD_BF16_ENTRIES)
    for label, op in WGRAD_BF16_ENTRIES.values():
        info = bf.get(label)
        n = mma.get(label)
        log(f"wgrad kernel, {label}: {info or 'not in the log'}; "
            + ("not in the SASS" if n is None else f"{n} {op} instructions"))
        if info is None or any(int(v) for v in re.findall(
                r"(\d+) bytes spill", info)) or not n:
            fail(f"wgrad kernel {label}: not built, spills or no {op} "
                 f"({info}; cuobjdump rc {sass.returncode})")


def _bf16_gate(torch, got, want, slack, what: str):
    """Fail unless every output of the bf16 ``got`` is within one bf16 ulp
    of the larger magnitude of it and the plain ``want``, plus ``slack``
    (BF16_SUM_SLACK x n x 2^-24 x sum|terms| of the output's fp32 sum:
    the two sums, in other orders, part by at most that where they
    cancel).  Returns (max|got - want|, the share of outputs more than one
    ulp apart)."""
    if got.dtype != want.dtype or got.shape != want.shape:
        fail(f"{what}: {got.dtype} {tuple(got.shape)} vs plain "
             f"{want.dtype} {tuple(want.shape)}")
    g, e = got.float(), want.float()
    mag = torch.maximum(g.abs(), e.abs()).clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    diff = (g - e).abs()
    if not bool((diff <= ulp + slack).all()):
        fail(f"{what}: max|kernel - plain| - (ulp + slack) = "
             f"{float((diff - ulp - slack).max()):.3g}")
    return float(diff.max()), float((diff > ulp).float().mean())


def _abs_slack(torch, a, b, n: int, **kw):
    """BF16_SUM_SLACK x n x 2^-24 x the fp32 conv of |a| with |b|."""
    from repro_torch.kernels import ref

    return BF16_SUM_SLACK * n * 2.0 ** -24 * ref.conv2d(
        a.float().abs(), b.float().abs(), **kw)


def _bf16_cases():
    """(arch, layer, groups) of the bf16 rows: VGG-16's 13 convs, then
    AlexNet's 5 (per group: CL2, CL4 and CL5 in two)."""
    return [(a, l, g) for a, i, l, g, _ in _u8_cases()]


def _conv_kernels(kern, x_hw, C, K, F, S, p) -> int:
    """Kernels one bf16 kernel-1 call launches: one on the wgmma window
    path, and the merge of a split gather path."""
    t = kern.bf16_tile(tuple(x_hw), C, K, F, stride=S, padding=p)
    return 1 if t.path == kern.U8_WINDOW else 1 + (t.n_split > 1)


def _timing_tool(tool: str, checkout, *args) -> dict:
    """``tools/<tool> --src <checkout>/src ARGS``, one of the timing tools
    (each imports the port from ``--src`` and builds its kernels in that
    checkout): the JSON object it prints."""
    src = pathlib.Path(checkout).resolve() / "src"
    if not (src / "repro_torch" / "kernels").is_dir():
        fail(f"{checkout}: no checkout of the port there")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tools" / tool), "--src", str(src),
         *map(str, args)], capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        fail(f"tools/{tool} on {checkout} failed: {proc.stderr[-2000:]}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    log(f"tools/{tool} on {checkout}: {time.perf_counter() - t0:.1f} s "
        f"(its build included) on {out['card']}")
    return out


def _parent_times(parent, reps: int):
    """``tools/bf16_conv_times.py`` on the checkout at ``parent``, batch
    TRAIN_BATCH: {"<kind> <layer>": ms}, or None without ``--parent``."""
    if parent is None:
        return None
    return _timing_tool("bf16_conv_times.py", parent, "--batch",
                        TRAIN_BATCH, "--reps", reps)["rows"]


def phase_bf16_kernels(torch, reps: int, parent=None):
    """3j. The bf16 lanes: kernel 1 forward (bias+ReLU) at VGG-16's 13
    convs at batch 1 and 8 and AlexNet's 5 at batch 1, kernel 1 as dx at
    VGG-16's CL2-CL13 at batch 1 and 8, kernel 2 at VGG-16's 13 convs at
    batch 1 and 8; each against its plain version, timed beside it, cuDNN
    in bf16 and the bound at the bf16 peak; per (part, batch) the sums and
    the device time of the 13 (12) calls under ``torch.profiler`` (not
    measured where it saw fewer of the port's kernels run than the calls
    launched); with ``parent`` (a checkout of the parent commit), the
    parent's kernels timed at batch 8 in the same run beside each row."""
    import torch.nn.functional as F
    from torch.nn.grad import conv2d_input, conv2d_weight

    from repro_torch.kernels import trim_conv2d as kern
    from repro_torch.kernels import trim_conv2d_vjp as vjp

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(2)
    bf = torch.bfloat16
    rows, calls = [], {}

    def randn(shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(bf)

    for N in (1, TRAIN_BATCH):
        for arch, l, groups in _bf16_cases():
            if arch == "alexnet" and N > 1:
                continue
            C, Cg, Fo = l.M * groups, l.M, l.N
            Fg, K, S, p = Fo // groups, l.K, l.stride, l.padding
            pp = K // 2 if p is None else p
            name = f"{arch} {l.name} batch {N}"
            macs = N * l.H_O * l.W_O * Fo * K * K * Cg
            x = randn((N, l.H_I, l.W_I, C))
            w = randn((K, K, Cg, Fo), (2.0 / (K * K * Cg)) ** 0.5)
            b = randn((Fo,), 0.1)
            cut = [(x[..., j * Cg:(j + 1) * Cg].contiguous(),
                    w[..., j * Fg:(j + 1) * Fg].contiguous(),
                    b[j * Fg:(j + 1) * Fg].contiguous())
                   for j in range(groups)]

            def fwd(fn=kern.trim_conv2d, cut=cut, S=S, p=p):
                return [fn(a, c, stride=S, padding=p, bias=d, relu=True)
                        for a, c, d in cut]

            got, want = fwd(), fwd(kern.trim_conv2d_plain)
            gates = [_bf16_gate(torch, a, e, _abs_slack(
                torch, c[0], c[1], K * K * Cg, stride=S, padding=p),
                f"{name} bf16 forward") for a, e, c in zip(got, want, cut)]
            if N > 1:       # the batch of N equals N calls of one image
                for j, (a, c, d) in enumerate(cut):
                    for i in range(N):
                        one = kern.trim_conv2d(a[i:i + 1].contiguous(), c,
                                               stride=S, padding=p, bias=d,
                                               relu=True)
                        if not torch.equal(got[j][i:i + 1], one):
                            fail(f"{name} bf16 forward: image {i} of the "
                                 f"batch differs from the image alone")
            x_nchw = x.permute(0, 3, 1, 2)
            w_oihw = w.permute(3, 2, 0, 1).contiguous()
            nbytes = 2 * (x.numel() + w.numel() + b.numel()
                          + N * l.H_O * l.W_O * Fo)
            calls[("fwd", arch, N)] = calls.get(("fwd", arch, N), []) + [fwd]
            rows.append({
                "arch": arch, "layer": l.name, "batch": N, "kind": "fwd",
                "kernels": groups * _conv_kernels(
                    kern, (l.H_I, l.W_I), Cg, K, Fg, S, p),
                "launches": groups, "max_abs_err": max(g[0] for g in gates),
                "past_ulp": max(g[1] for g in gates),
                "ms": cuda_ms(torch, fwd, reps),
                "plain_ms": cuda_ms(torch, lambda: fwd(kern.trim_conv2d_plain),
                                    max(1, reps // 5)),
                "library_ms": cuda_ms(torch, lambda: F.conv2d(
                    x_nchw, w_oihw, b, stride=S, padding=pp, groups=groups),
                    reps),
                **bound(macs, nbytes, False, PEAK_BF16)})
            if arch != "vgg16":
                continue
            # dw (every conv) and dx (CL2-CL13: the train step's)
            g = randn((N, l.H_O, l.W_O, Fo))
            xn, gn = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)

            def dw(x=x, g=g, K=K, S=S, p=p):
                return vjp.trim_conv2d_wgrad(x, g, K=K, stride=S, padding=p)

            got_w = dw()
            want_w = vjp.trim_conv2d_wgrad(x.float(), g.float(), K=K,
                                           stride=S, padding=p)
            err_w = _close(got_w, want_w, f"{name} bf16 dw against the fp32 "
                           "lane")
            if not torch.equal(got_w, dw()):
                fail(f"{name} bf16 dw: two calls differ")
            nb = 2 * (x.numel() + g.numel()) + 4 * w.numel()
            nb_dx = 2 * (g.numel() + w.numel() + x.numel())
            calls[("dw", arch, N)] = calls.get(("dw", arch, N), []) + [dw]
            tw = vjp.wgrad_bf16_tile(tuple(x.shape), K, Fo, stride=S,
                                     padding=p)
            rows.append({
                "arch": arch, "layer": l.name, "batch": N, "kind": "dw",
                "kernels": 1 + (tw.n_part > 1),
                "launches": 1, "max_abs_err": err_w,
                "ms": cuda_ms(torch, dw, reps),
                "plain_ms": cuda_ms(torch, lambda: vjp.trim_conv2d_wgrad_plain(
                    x, g, K=K, stride=S, padding=p), max(1, reps // 5)),
                "library_ms": cuda_ms(torch, lambda: conv2d_weight(
                    xn, w_oihw.shape, gn, stride=S, padding=pp), reps),
                **bound(macs, nb, False, PEAK_BF16)})
            if l.name == "CL1":
                continue

            def dx(g=g, w=w, l=l, S=S, p=p):
                return vjp.trim_conv2d_input_grad(g, w, x_hw=(l.H_I, l.W_I),
                                                  stride=S, padding=p)

            def dx_plain(g=g, w=w, K=K, pp=pp):
                w_t = w.flip(0, 1).permute(0, 1, 3, 2).contiguous()
                return kern.trim_conv2d_plain(g, w_t, stride=1,
                                              padding=K - 1 - pp)

            w_t = w.flip(0, 1).permute(0, 1, 3, 2).contiguous()
            err_x, past_x = _bf16_gate(
                torch, dx(), dx_plain(), _abs_slack(
                    torch, g, w_t, K * K * Fo, stride=1, padding=K - 1 - pp),
                f"{name} bf16 dx")
            calls[("dx", arch, N)] = calls.get(("dx", arch, N), []) + [dx]
            rows.append({
                "arch": arch, "layer": l.name, "batch": N, "kind": "dx",
                "kernels": _conv_kernels(kern, (l.H_O, l.W_O), Fo, K, C, 1,
                                         K - 1 - pp),
                "launches": 1, "max_abs_err": err_x, "past_ulp": past_x,
                "ms": cuda_ms(torch, dx, reps),
                "plain_ms": cuda_ms(torch, dx_plain, max(1, reps // 5)),
                "library_ms": cuda_ms(torch, lambda: conv2d_input(
                    xn.shape, w_oihw, gn, stride=S, padding=pp), reps),
                **bound(macs, nb_dx, False, PEAK_BF16)})
    before = _parent_times(parent, reps)
    for r in rows:
        past = (f"; past one ulp {r['past_ulp']:.2e}" if "past_ulp" in r
                else "")
        if r["arch"] == "vgg16" and r["batch"] == TRAIN_BATCH:
            r["parent_ms"] = (None if before is None
                              else before[f"{r['kind']} {r['layer']}"])
        old = ("" if "parent_ms" not in r else
               f" parent_ms {_fmt(r['parent_ms'])}")
        log(f"bf16 {r['kind']} {r['arch']:7s} {r['layer']:4s} batch "
            f"{r['batch']} ms {r['ms']:.4f}{old} plain_ms "
            f"{r['plain_ms']:.4f} library_ms {r['library_ms']:.4f} bound_ms "
            f"{r['bound_ms']:.4f} ({r['bound_by']}) err "
            f"{r['max_abs_err']:.3g}{past}")
    if before is None:
        log(f"bf16 rows at batch {TRAIN_BATCH}: the parent's times not "
            "measured (run with --parent DIR, a checkout of the parent "
            "commit)")
    for (kind, arch, N), fns in calls.items():
        sel = [r for r in rows if (r["kind"], r["arch"], r["batch"])
               == (kind, arch, N)]
        dms = device_ms(torch, lambda: [f() for f in fns], 5,
                        kernels=("trim_conv2d",
                                 sum(r["kernels"] for r in sel)))
        ms, bnd = sum(r["ms"] for r in sel), sum(r["bound_ms"] for r in sel)
        old = ("" if before is None or "parent_ms" not in sel[0] else
               f" parent_ms {sum(r['parent_ms'] for r in sel):.4f}")
        log(f"bf16 {kind} {arch} batch {N}, sum of {len(sel)} convs: ms "
            f"{ms:.4f}{old} device_ms {_fmt(dms)} plain_ms "
            f"{sum(r['plain_ms'] for r in sel):.4f} library_ms "
            f"{sum(r['library_ms'] for r in sel):.4f} bound_ms {bnd:.4f} "
            f"(bound/ms {bnd / ms:.3f}, bound/library "
            f"{bnd / sum(r['library_ms'] for r in sel):.3f})")
        for r in sel:
            r["sum_device_ms"] = dms
    return rows


def _cpu_tree(torch, tree):
    from repro_torch.core.tree import tree_map

    return tree_map(lambda t: t.detach().cpu(), tree)


def phase_bf16_forward(torch) -> dict:
    """6c. Full-width VGG-16 (batch 1 and 8) and AlexNet (batch 1)
    forward in bf16 (bf16 params from ``init_cnn(dtype=torch.bfloat16)``,
    bf16 images) through ``cnn_forward``: kernel 1's bf16 launches
    counted around each (13, 13, 8), bf16 logits, finite; the batch-1
    logits against the same forward on CPU copies (the plain versions)
    within BF16_LOGIT_TOL x max|logit|; VGG-16's conv stack at batch 8
    bit-equal image by image to batch-1 calls.  Returns the launches."""
    from repro_torch.configs import CNN_REGISTRY
    from repro_torch.engine import ExecutionPolicy, execute, plan_model
    from repro_torch.kernels import trim_conv2d as kern
    from repro_torch.nn.conv import cnn_forward, init_cnn

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(3)
    out = {}
    for arch, batches in (("vgg16", (1, TRAIN_BATCH)), ("alexnet", (1,))):
        cfg = CNN_REGISTRY[arch]
        params = init_cnn(0, cfg, dev, dtype=torch.bfloat16)
        images = torch.randn((max(batches),) + cfg.input_hw
                             + (cfg.layers[0].M,), generator=gen,
                             device=dev).to(torch.bfloat16)
        for N in batches:
            x = images[:N].contiguous()
            cnn_forward(params, x, cfg)                 # warm
            torch.cuda.synchronize()
            kern.LAUNCHES_BY_LANE.update(dict.fromkeys(kern.LAUNCHES_BY_LANE,
                                                       0))
            t0 = time.perf_counter()
            logits = cnn_forward(params, x, cfg)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            lanes = dict(kern.LAUNCHES_BY_LANE)
            want = {"vgg16": 13, "alexnet": 8}[arch]
            if lanes != {"f32": 0, "bf16": want, "u8": 0}:
                fail(f"bf16 forward {arch} batch {N}: launches by lane "
                     f"{lanes}, expected {want} on bf16")
            if logits.dtype != torch.bfloat16 or logits.shape != (
                    N, cfg.n_classes) or not bool(
                    torch.isfinite(logits).all()):
                fail(f"bf16 forward {arch} batch {N}: {logits.dtype} "
                     f"{tuple(logits.shape)}, finite "
                     f"{bool(torch.isfinite(logits).all())}")
            out[(arch, N)] = lanes["bf16"]
            msg = (f"bf16 forward {arch} batch {N}: {ms:.3f} ms (host "
                   f"clock), {lanes['bf16']} launches on kernel 1's bf16 "
                   "lane")
            if N == 1:
                ref = cnn_forward(_cpu_tree(torch, params), x.cpu(), cfg,
                                  policy=ExecutionPolicy("kernel"))
                f32 = cnn_forward({k: [{n: t.float() for n, t in e.items()}
                                       for e in v] for k, v in
                                   params.items()}, x.float(), cfg)
                scale = float(ref.float().abs().max())
                err = float((logits.cpu().float() - ref.float()).abs().max())
                err32 = float((logits.float() - f32).abs().max())
                msg += (f"; logits against the plain versions' (CPU) "
                        f"{err:.4g} of max|logit| {scale:.4g} (limit "
                        f"{BF16_LOGIT_TOL} x), against the fp32 kernels' "
                        f"{err32:.4g}")
                if not err <= BF16_LOGIT_TOL * scale:
                    fail(f"bf16 forward {arch}: logits {err:.4g} from the "
                         f"plain versions' (limit {BF16_LOGIT_TOL} x "
                         f"{scale:.4g})")
            log(msg)
        if arch == "vgg16":
            plan = plan_model(cfg, ExecutionPolicy())
            feats = execute._conv_stack(plan, params, images)
            for i in range(images.shape[0]):
                one = execute._conv_stack(plan, params,
                                          images[i:i + 1].contiguous())
                if not torch.equal(feats[i:i + 1], one):
                    fail(f"bf16 forward vgg16: image {i}'s conv features in "
                         "the batch differ from the image alone")
            log(f"bf16 forward vgg16: the conv stack at batch "
                f"{images.shape[0]} bit-equal to {images.shape[0]} calls of "
                "one image")
    return out


def phase_train_bf16(torch, steps: int, batch: int, lr: float) -> dict:
    """6d. Full-width VGG-16 trained in bf16: bf16 params
    (``init_cnn(dtype=torch.bfloat16)``), bf16 images, fp32 AdamW moments,
    ``steps`` steps at ``batch`` through ``make_train_step``: losses and
    grad norms finite, no step skipped, launches by lane (25 a step on
    kernel 1's bf16 lane, 13 on kernel 2's, none on fp32), ms a step,
    peak device memory, a profiled step by op; each leaf's gradient on
    the first step's params and GRAD_CHECK_BATCH images against float64:
    through the bf16 kernels, the same bf16 function on CPU copies (the
    plain versions) and the fp32 kernels; the bf16 kernels' relative L2
    error within BF16_GRAD_RATIO x the plain versions'.  Returns the
    launches."""
    import math

    from repro_torch.configs import CNN_REGISTRY
    from repro_torch.core.tree import tree_leaves_with_path
    from repro_torch.data.pipeline import SyntheticImageDataset
    from repro_torch.distributed import StepConfig, make_train_step
    from repro_torch.engine import ExecutionPolicy, plan_model
    from repro_torch.kernels import trim_conv2d as kern
    from repro_torch.kernels import trim_conv2d_vjp as vjp
    from repro_torch.nn.conv import init_cnn
    from repro_torch.optim import adamw_init

    dev = torch.device("cuda", 0)
    cfg = CNN_REGISTRY["vgg16"]
    n_conv = len(cfg.layers)
    plan = plan_model(cfg, ExecutionPolicy())
    ds = SyntheticImageDataset(hw=cfg.input_hw, channels=cfg.layers[0].M,
                               n_classes=cfg.n_classes, global_batch=batch,
                               seed=0)
    raw = [ds.batch_at(i) for i in range(steps)]
    batches = [{"images": torch.as_tensor(b["images"], device=dev).to(
                    torch.bfloat16),
                "labels": torch.as_tensor(b["labels"], device=dev)}
               for b in raw]                             # data set-up
    params = init_cnn(0, cfg, dev, dtype=torch.bfloat16)
    state = state0 = {"params": params, "opt": adamw_init(params)}
    scfg = StepConfig(peak_lr=lr, warmup_steps=5, total_steps=steps)
    step_fn = make_train_step(plan, scfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    kern.LAUNCHES_BY_LANE.update(dict.fromkeys(kern.LAUNCHES_BY_LANE, 0))
    vjp.WGRAD_LAUNCHES_BY_LANE.update(
        dict.fromkeys(vjp.WGRAD_LAUNCHES_BY_LANE, 0))
    hist = []
    for i, b in enumerate(batches):
        t0 = time.perf_counter()
        state, m = step_fn(state, b)
        torch.cuda.synchronize()
        hist.append(_row(i, (time.perf_counter() - t0) * 1e3, m))
    lanes, wlanes = (dict(kern.LAUNCHES_BY_LANE),
                     dict(vjp.WGRAD_LAUNCHES_BY_LANE))
    peak = torch.cuda.max_memory_allocated(dev)
    for h in hist:
        log(f"train bf16 step {h['step']}: loss {h['loss']!r} grad_norm "
            f"{h['grad_norm']!r} ({h['ms']:.3f} ms)")
        if not (math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])):
            fail(f"train bf16: non-finite loss/grad_norm at step "
                 f"{h['step']}: {h}")
        if h["skipped"]:
            fail(f"train bf16: step {h['step']} was skipped")
    steady = hist[1:] or hist
    ms = sum(h["ms"] for h in steady) / len(steady)
    log(f"train bf16 vgg16 batch {batch}: {ms:.3f} ms per step, "
        f"{batch * 1e3 / ms:.3f} images/s (steps 1-{steps - 1}); peak "
        f"{peak / 2**30:.3f} GiB ({(peak - base) / 2**30:.3f} above the "
        f"state); launches by lane: conv {lanes}, weight gradient {wlanes}")
    want = {"f32": 0, "bf16": steps * (2 * n_conv - 1), "u8": 0}
    if lanes != want:
        fail(f"train bf16: conv launches {lanes}, expected {want} ({steps} "
             f"x ({n_conv} forward + {n_conv - 1} dx) on bf16)")
    if wlanes != {"f32": 0, "bf16": steps * n_conv}:
        fail(f"train bf16: weight-gradient launches {wlanes}, expected "
             f"{steps} x {n_conv} on bf16")
    _train_profile(torch, plan, scfg, state, batches[-1], ms,
                   label="train bf16 profile")
    # each leaf's gradient against float64 on the first step's params:
    # the bf16 kernels, the bf16 plain versions (CPU), the fp32 kernels
    sub = {k: v[:GRAD_CHECK_BATCH] for k, v in raw[0].items()}
    want64 = _leaf_grads(torch, lambda p, b: _loss_f64(torch, plan, p, b),
                         state0["params"], sub, torch.float64)
    cpu_plan = plan_model(cfg, ExecutionPolicy("kernel"))
    grads = {
        "bf16 kernels": _leaf_grads(torch, lambda p, b: plan.loss(p, b)[0],
                                    state0["params"], sub, torch.bfloat16),
        "bf16 plain": [g.to(dev) for g in _leaf_grads(
            torch, lambda p, b: cpu_plan.loss(p, b)[0],
            _cpu_tree(torch, state0["params"]), sub, torch.bfloat16)],
        "fp32 kernels": _leaf_grads(torch, lambda p, b: plan.loss(p, b)[0],
                                    state0["params"], sub, torch.float32)}
    norm64 = sum(float((d * d).sum()) for d in want64) ** 0.5
    rel = {k: sum(float(((a - d) ** 2).sum()) for a, d in zip(v, want64))
           ** 0.5 / norm64 for k, v in grads.items()}
    paths = [p for p, _ in tree_leaves_with_path(state0["params"])]
    log(f"train bf16 gradients against float64 on {GRAD_CHECK_BATCH} "
        "images, relative L2 over every leaf: " + ", ".join(
            f"{k} {v:.4g}" for k, v in rel.items()))

    def leaf_err(g, d):
        return (g - d).abs().max().item() / max(d.abs().max().item(), 1e-30)

    log("train bf16 gradients against float64, max|diff| / max|leaf| ("
        + ", ".join(grads) + "): " + "; ".join(
            f"{p} " + ", ".join(f"{leaf_err(v[i], d):.3g}"
                                for v in grads.values())
            for i, (p, d) in enumerate(zip(paths, want64))))
    if not rel["bf16 kernels"] <= BF16_GRAD_RATIO * rel["bf16 plain"]:
        fail(f"train bf16: the kernels' gradient is {rel['bf16 kernels']:.4g}"
             f" from float64, past {BF16_GRAD_RATIO} x the plain versions' "
             f"{rel['bf16 plain']:.4g}")
    return {"conv": lanes["bf16"], "wgrad": wlanes["bf16"], "ms": ms,
            "peak_gib": peak / 2**30}


def _f64_err(got, want, to_want=lambda t: t) -> float:
    """max over groups of max|got - want| / max|want| (``to_want`` lays a
    result out as ``want``)."""
    return max(((to_want(a).double() - b).abs().max()
                / b.abs().max().clamp_min(1e-30)).item()
               for a, b in zip(got, want))


def _row(i, ms, m) -> dict:
    return {"step": i, "ms": ms, **{k: float(v) for k, v in m.items()}}


def _train_run(torch, plan, state, batches, scfg, shadow=None):
    """Train ``plan`` over ``batches``; with ``shadow`` (a second plan),
    also run its step on the same state and batch at every step (its
    result is discarded).  Returns (history, shadow history, last state)."""
    from repro_torch.distributed import make_train_step

    step_fn = make_train_step(plan, scfg)
    shadow_fn = shadow and make_train_step(shadow, scfg)
    hist, shadow_hist = [], []
    for i, batch in enumerate(batches):
        t0 = time.perf_counter()
        new, m = step_fn(state, batch)
        torch.cuda.synchronize()
        hist.append(_row(i, (time.perf_counter() - t0) * 1e3, m))
        if shadow_fn:
            shadow_hist.append(_row(i, 0.0, shadow_fn(state, batch)[1]))
        state = new
    return hist, shadow_hist, state


def _rel(a, b, key) -> float:
    return abs(a[key] - b[key]) / abs(b[key])


def _loss_f64(torch, plan, params, batch):
    """The model's mean cross-entropy through plain PyTorch ops in the
    params' dtype (``F.conv2d`` + bias + ReLU, the 2x2 max pool, the FC
    head): the float64 reference for the fp32 gradients."""
    import torch.nn.functional as F

    x = batch["images"]
    for lp, p in zip(plan.layers, params["conv"]):
        pad = lp.k // 2 if lp.padding is None else lp.padding
        x = F.conv2d(x.permute(0, 3, 1, 2), p["kernel"].permute(3, 2, 0, 1),
                     p.get("bias"), stride=lp.stride, padding=pad,
                     groups=lp.groups).permute(0, 2, 3, 1)
        if lp.relu:
            x = torch.relu(x)
        if lp.pool:
            B, H, W, C = x.shape
            x = x[:, :H // 2 * 2, :W // 2 * 2].reshape(
                B, H // 2, 2, W // 2, 2, C).amax(dim=(2, 4))
    x = x.reshape(x.shape[0], -1)
    for j, fc in enumerate(params["fc"]):
        x = x @ fc["kernel"] + fc["bias"]
        if j < len(params["fc"]) - 1:
            x = torch.relu(x)
    return F.cross_entropy(x, batch["labels"].long())


def _leaf_grads(torch, loss_fn, params, batch, dtype):
    """Every leaf's gradient of ``loss_fn(params, batch)`` with the params
    and images cast to ``dtype``; returned in float64."""
    from repro_torch.core.tree import tree_leaves, tree_unflatten

    dev = tree_leaves(params)[0].device
    batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    batch["images"] = batch["images"].to(dtype)
    live = [p.detach().to(dtype).requires_grad_(True)
            for p in tree_leaves(params)]
    loss = loss_fn(tree_unflatten(params, live), batch)
    return [g.double() for g in torch.autograd.grad(loss, live)]


def _leaf_errors(torch, plan, oracle, params, batch):
    """Each leaf's gradient through the kernels and through the oracle
    (cuDNN), both fp32, against :func:`_loss_f64`'s on the same params and
    batch: [(path, kernel error, oracle error)], an error being max|diff|
    / max|float64 leaf|."""
    from repro_torch.core.tree import tree_leaves_with_path

    paths = [path for path, _ in tree_leaves_with_path(params)]
    want = _leaf_grads(torch, lambda p, b: _loss_f64(torch, plan, p, b),
                       params, batch, torch.float64)
    got, base = (_leaf_grads(torch, lambda p, b: m.loss(p, b)[0], params,
                             batch, torch.float32) for m in (plan, oracle))
    out = []
    for path, k, o, d in zip(paths, got, base, want):
        scale = max(d.abs().max().item(), 1e-30)
        out.append((path, (k - d).abs().max().item() / scale,
                    (o - d).abs().max().item() / scale))
    return out


def phase_train(torch, steps: int, batch: int, lr: float):
    """Full-width VGG-16 trained a few steps on the kernels and, from the
    same init, on the oracle; returns (conv-kernel launches,
    weight-gradient launches).

    The checks hold the kernels' step against the oracle's step on the
    same state and batch at every step (the oracle shadows the kernels'
    trajectory).  The free-running oracle run is logged
    beside them: two free-running trajectories part further as fp32
    rounding grows along the way (``--drift`` measures how far)."""
    import math

    from repro_torch.configs import CNN_REGISTRY
    from repro_torch.data.pipeline import SyntheticImageDataset
    from repro_torch.distributed import StepConfig, make_train_state
    from repro_torch.engine import ExecutionPolicy, plan_model
    from repro_torch.kernels import trim_conv2d as kern
    from repro_torch.kernels import trim_conv2d_vjp as vjp

    dev = torch.device("cuda", 0)
    cfg = CNN_REGISTRY["vgg16"]
    n_conv = len(cfg.layers)
    plan = plan_model(cfg, ExecutionPolicy())
    oracle = plan_model(cfg, ExecutionPolicy(substrate="oracle"))
    ds = SyntheticImageDataset(hw=cfg.input_hw, channels=cfg.layers[0].M,
                               n_classes=cfg.n_classes, global_batch=batch,
                               seed=0)
    batches = [ds.batch_at(i) for i in range(steps)]   # data set-up
    scfg = StepConfig(peak_lr=lr, warmup_steps=5, total_steps=steps)
    state0 = make_train_state(plan, 0, dev)
    torch.cuda.synchronize()
    kern.LAUNCHES = vjp.WGRAD_LAUNCHES = 0
    got, shadow, last = _train_run(torch, plan, state0, batches, scfg,
                                   shadow=oracle)
    launches, wlaunches = kern.LAUNCHES, vjp.WGRAD_LAUNCHES
    free, _, _ = _train_run(torch, oracle, state0, batches, scfg)

    for a, s_, f in zip(got, shadow, free):
        log(f"train step {a['step']}: kernels loss {a['loss']!r} grad_norm "
            f"{a['grad_norm']!r} ({a['ms']:.3f} ms); oracle on the same "
            f"state loss {s_['loss']!r} grad_norm {s_['grad_norm']!r} (rel "
            f"{_rel(a, s_, 'loss'):.3g}, {_rel(a, s_, 'grad_norm'):.3g}); "
            f"free-running oracle loss {f['loss']!r} grad_norm "
            f"{f['grad_norm']!r} ({f['ms']:.3f} ms; kernels vs it rel "
            f"{_rel(a, f, 'loss'):.3g}, {_rel(a, f, 'grad_norm'):.3g})")
    steady = got[1:] or got
    ms = sum(h["ms"] for h in steady) / len(steady)
    steady_o = free[1:] or free
    ms_o = sum(h["ms"] for h in steady_o) / len(steady_o)
    log(f"train vgg16 batch {batch}: {ms:.3f} ms per step, "
        f"{batch * 1e3 / ms:.3f} images/s on the kernels (oracle "
        f"{ms_o:.3f} ms, {batch * 1e3 / ms_o:.3f} images/s; steps 1-"
        f"{steps - 1}); {launches} conv-kernel and {wlaunches} "
        f"weight-gradient launches in {steps} steps")
    _train_profile(torch, plan, scfg, last, batches[-1], ms)
    for h in got + shadow + free:
        if not (math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])):
            fail(f"train: non-finite loss/grad_norm at step {h['step']}: {h}")
        if h["skipped"]:
            fail(f"train: step {h['step']} was skipped")
    if launches != steps * (2 * n_conv - 1):
        fail(f"train: {launches} conv-kernel launches, expected {steps} x "
             f"({n_conv} forward + {n_conv - 1} dx)")
    if wlaunches != steps * n_conv:
        fail(f"train: {wlaunches} weight-gradient launches, expected "
             f"{steps} x {n_conv}")
    if (free[0]["loss"], free[0]["grad_norm"]) != \
            (shadow[0]["loss"], shadow[0]["grad_norm"]):
        fail("train: the oracle's first step differs between two runs "
             "from the same init")
    for a, b in zip(got, shadow):
        for key in ("loss", "grad_norm"):
            rtol = 1e-4 if (a["step"], key) == (0, "loss") else 1e-3
            if not math.isclose(a[key], b[key], rel_tol=rtol):
                fail(f"train: step {a['step']} {key} {a[key]!r} vs the "
                     f"oracle on the same state {b[key]!r} (rtol {rtol})")
    return launches, wlaunches


#: The train profile's parts: (module path, function, label); each
#: function runs inside a ``record_function`` range of its label while the
#: step is profiled.
TRAIN_PARTS = (("repro_torch.engine.execute", "_kernel_call", "conv forward"),
               ("repro_torch.engine.execute", "max_pool2x2", "pool forward"),
               ("repro_torch.engine.execute", "_head", "head forward"),
               ("repro_torch.kernels.trim_conv2d_vjp",
                "trim_conv2d_input_grad", "dx"),
               ("repro_torch.kernels.trim_conv2d_vjp", "trim_conv2d_wgrad",
                "dw"),
               ("repro_torch.distributed.steps", "adamw_update", "AdamW"))


def _train_profile(torch, plan, scfg, state, batch, wall_ms: float,
                   label: str = "train profile") -> None:
    """Log where one train step's device time goes, by op, under
    ``torch.profiler``: the conv forward, dx, dw, the rest of the conv
    backward (ReLU mask, bias gradient, weight flip), the pools and the
    FC head (forward ranges, and their backward nodes), AdamW, and the
    rest (loss, casts); set against ``wall_ms``, the unprofiled step."""
    import importlib
    import re

    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.distributed import make_train_step

    def labelled(fn, name):
        def run(*a, **k):
            with record_function(name):
                return fn(*a, **k)
        return run

    saved = [(importlib.import_module(m), f) for m, f, _ in TRAIN_PARTS]
    originals = [getattr(m, f) for m, f in saved]
    step_fn = make_train_step(plan, scfg)
    step_fn(state, batch)               # warm: nothing is built in the window
    torch.cuda.synchronize()
    try:
        for (m, f), fn, (_, _, name) in zip(saved, originals, TRAIN_PARTS):
            setattr(m, f, labelled(fn, name))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step_fn(state, batch)
            torch.cuda.synchronize()
    finally:
        for (m, f), fn in zip(saved, originals):
            setattr(m, f, fn)
    names = {name for _, _, name in TRAIN_PARTS}
    node = "autograd::engine::evaluate_function: "
    # kernels are matched to the range open on the launching thread when
    # they were launched (the innermost): the profiler's own op tree gives
    # the conv kernels launched from autograd's thread to its backward node
    trace_path = ROOT / "build" / "train_profile_trace.json"
    trace_path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(trace_path))
    xs = [e for e in json.loads(trace_path.read_text())["traceEvents"]
          if e.get("ph") == "X"]
    device = [e for e in xs
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    if not device:
        log(f"{label}: the profiler saw no device time (not measured)")
        return
    launch = {e["args"]["correlation"]: (e["tid"], e["ts"]) for e in xs
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}
    ranges = [(e["tid"], e["ts"], e["ts"] + e["dur"], e["name"]) for e in xs
              if e.get("cat") in ("user_annotation", "cpu_op")
              and (e["name"] in names or e["name"].startswith(node))]

    def part(kernel) -> str:
        tid, ts = launch.get(kernel.get("args", {}).get("correlation"),
                             (None, None))
        if ts is None:
            return "other"
        inside = ([r for r in ranges if r[0] == tid and r[1] <= ts <= r[2]]
                  or [r for r in ranges if r[1] <= ts <= r[2]])
        if not inside:
            return "other"
        name = max(inside, key=lambda r: r[1])[3]
        if not name.startswith(node):
            return name
        if "TrimConv2dFn" in name:
            return "conv backward rest"
        return "pool backward" if "Amax" in name else "head and loss backward"

    parts, ours = {}, {}
    for e in device:
        ms_ = e["dur"] / 1e3
        k = part(e)
        parts[k] = parts.get(k, 0.0) + ms_
        m = re.search(r"trim_\w+", e["name"])
        if m:
            ours[m.group(0)] = ours.get(m.group(0), 0.0) + ms_
    busy = sum(parts.values())
    log(f"{label} batch {len(batch['labels'])}: device busy "
        f"{busy:.3f} ms of {wall_ms:.3f} ms wall (idle share "
        f"{max(0.0, 1 - busy / wall_ms):.3f}); {len(device)} kernels; by "
        "op: " + "; ".join(f"{k} {v:.3f} ms" for k, v in sorted(
            parts.items(), key=lambda kv: -kv[1]))
        + "; our kernels: " + "; ".join(
            f"{k} {v:.3f} ms" for k, v in sorted(ours.items())))


def _branch_flips(torch, plan, params, images):
    """Per ReLU (13 conv layers, then the FC head's), the decisions of the
    fp32 forward through ``plan`` that differ from the float64 forward's,
    each fed its own previous layer: [(name, ReLU flips, max-pool window
    flips, decisions)]."""
    import torch.nn.functional as F

    from repro_torch.engine.execute import max_pool2x2, run_conv2d

    def windows(y):                     # (B, H/2, W/2, C, 4) pool windows
        B, H, W, C = y.shape
        return y[:, :H // 2 * 2, :W // 2 * 2].reshape(
            B, H // 2, 2, W // 2, 2, C).permute(0, 1, 3, 5, 2, 4).reshape(
            B, H // 2, W // 2, C, 4)

    x32, x64, out = images.float(), images.double(), []
    with torch.no_grad():
        for i, (lp, p) in enumerate(zip(plan.layers, params["conv"])):
            y32 = run_conv2d(lp, x32, p["kernel"], p.get("bias"))
            pad = lp.k // 2 if lp.padding is None else lp.padding
            y64 = torch.relu(F.conv2d(
                x64.permute(0, 3, 1, 2),
                p["kernel"].double().permute(3, 2, 0, 1),
                p["bias"].double(), stride=lp.stride, padding=pad,
                groups=lp.groups).permute(0, 2, 3, 1))
            relu, pool = int(((y32 > 0) != (y64 > 0)).sum()), 0
            if lp.pool:
                pool = int((windows(y32).argmax(-1)
                            != windows(y64).argmax(-1)).sum())
            out.append((f"CL{i + 1}", relu, pool, y32.numel()))
            if lp.pool:
                y32, y64 = max_pool2x2(y32), max_pool2x2(y64)
            x32, x64 = y32, y64
        x32, x64 = x32.reshape(x32.shape[0], -1), x64.reshape(x64.shape[0], -1)
        for j, fc in enumerate(params["fc"][:-1]):
            x32 = torch.relu(x32 @ fc["kernel"] + fc["bias"])
            x64 = torch.relu(x64 @ fc["kernel"].double() + fc["bias"].double())
            out.append((f"FC{j + 1}", int(((x32 > 0) != (x64 > 0)).sum()), 0,
                        x32.numel()))
    return out


def phase_drift(torch, seeds, steps: int, batch: int, lrs):
    """How far free-running fp32 trajectories of full-width VGG-16 part.

    For each peak lr and seed (the init's and the data's): the kernels'
    run twice (K, K2), the oracle's twice (O, O2) and the oracle with its
    batch summed as two microbatches (R, ``accum=2``: the same function,
    its sums in another order).  Per step, each run's loss and grad_norm
    relative to O's.  Then, on the init and on K's last state, each
    leaf's gradient error (max|diff| / max|leaf|) through the kernels and
    through the oracle against :func:`_loss_f64` in float64, and how many
    ReLU and max-pool decisions of each fp32 forward differ from the
    float64 forward's.  Nothing is asserted: this measures the spread."""
    import dataclasses

    from repro_torch.configs import CNN_REGISTRY
    from repro_torch.data.pipeline import SyntheticImageDataset
    from repro_torch.distributed import StepConfig, make_train_state
    from repro_torch.engine import ExecutionPolicy, plan_model

    dev = torch.device("cuda", 0)
    cfg = CNN_REGISTRY["vgg16"]
    plan = plan_model(cfg, ExecutionPolicy())
    oracle = plan_model(cfg, ExecutionPolicy(substrate="oracle"))
    for lr in lrs:
        scfg = StepConfig(peak_lr=lr, warmup_steps=5, total_steps=steps)
        for seed in seeds:
            ds = SyntheticImageDataset(
                hw=cfg.input_hw, channels=cfg.layers[0].M,
                n_classes=cfg.n_classes, global_batch=batch, seed=seed)
            batches = [ds.batch_at(i) for i in range(steps)]
            state0 = make_train_state(plan, seed, dev)
            runs, last = {}, {}
            for name, p, c in (
                    ("K", plan, scfg), ("K2", plan, scfg),
                    ("O", oracle, scfg), ("O2", oracle, scfg),
                    ("R", oracle, dataclasses.replace(scfg, accum=2))):
                runs[name], _, last[name] = _train_run(torch, p, state0,
                                                       batches, c)
            for i, o in enumerate(runs["O"]):
                rel = "; ".join(
                    f"{n}-O {_rel(runs[n][i], o, 'loss'):.3g}, "
                    f"{_rel(runs[n][i], o, 'grad_norm'):.3g}"
                    for n in ("K", "K2", "R", "O2"))
                log(f"drift lr {lr:g} seed {seed} step {i}: O loss "
                    f"{o['loss']!r} grad_norm {o['grad_norm']!r}; K loss "
                    f"{runs['K'][i]['loss']!r} grad_norm "
                    f"{runs['K'][i]['grad_norm']!r}; rel loss, grad_norm: "
                    f"{rel}")
            for what, state, b in (
                    ("init", state0, batches[0]),
                    (f"after {steps} kernel steps", last["K"], batches[-1])):
                if what == "init" and lr != lrs[0]:
                    continue            # the same init and batch as before
                imgs = torch.as_tensor(b["images"], device=dev)
                log(f"drift lr {lr:g} seed {seed} {what}: ReLU/max-pool "
                    f"decisions that differ from float64, kernels; oracle: "
                    + "; ".join(
                        f"{a[0]} {a[1]}/{a[2]}, {o[1]}/{o[2]} of {a[3]}"
                        for a, o in zip(
                            *(_branch_flips(torch, m, state["params"], imgs)
                              for m in (plan, oracle)))))
                log(f"drift lr {lr:g} seed {seed} {what}: per-leaf gradient "
                    f"error against float64, kernels/oracle: " + ", ".join(
                        f"{path} {ek:.3g}/{eo:.3g}" for path, ek, eo in
                        _leaf_errors(torch, plan, oracle, state["params"],
                                     b)))


def _replay_vs_eager(torch, what: str, eng, bucket: int, images,
                     lane_idx: int = 0, reps: int = 20,
                     hold: bool = False) -> dict:
    """The bucket's captured graphs (on lane ``lane_idx``) against its
    eager executable on one padded host batch ``images``: bit for bit.
    Times a replay and an eager call by CUDA events over ``reps`` calls on
    the same device-resident images, and a replay's device time under
    ``torch.profiler``; with ``hold``, holds the launches its capture
    recorded against the kernels the profiler sees in replays."""
    g = eng.bucket_graphs(bucket, lane_idx)
    lane = eng.lanes[lane_idx]
    params = eng._lane_params(lane_idx, lane)
    x = torch.from_numpy(images).to(eng.device)
    got = g(x).clone()
    want = g.ex.forward(params, x, lane.requant)
    if got.dtype != want.dtype or not torch.equal(got, want):
        fail(f"{what}: bucket {bucket}: the replay differs from the eager "
             "executable")
    ms = cuda_ms(torch, lambda: g(x), reps)
    eager = cuda_ms(torch, lambda: g.ex.forward(params, x, lane.requant),
                    reps)
    dev_ms = device_ms(torch, lambda: g(x), 4)
    if hold:
        _hold_replay_launches(torch, f"{what} bucket {bucket}",
                              lambda: [g(x) for _ in range(4)], 4,
                              g.launches)
    log(f"{what}: bucket {bucket}: replay bit-equal to the eager "
        f"executable; {g.launches.get('trim_conv2d', 0)} conv launches a "
        f"replay; {ms:.4f} ms a replay (device {_fmt(dev_ms)}), eager "
        f"{eager:.4f} ms (CUDA events, {reps} calls)")
    return {"bucket": bucket, "ms": ms, "eager_ms": eager,
            "device_ms": dev_ms, "launches": g.launches}


def _served_inputs(server):
    return [r for r in server.requests if r.status == "served"]


def phase_serve(torch, datapath: str, n_requests: int):
    """Full-width VGG-16 through the port's Server on one lane; returns
    the kernel launches counted while the stream was served, split into
    those of the flushes of the smaller buckets and those of the largest
    bucket's flushes (each counted around its flush)."""
    import numpy as np

    from repro_torch.configs import CNN_REGISTRY
    from repro_torch.data.pipeline import SyntheticRequestStream
    from repro_torch.engine import ExecutionPolicy, execute, plan_model
    from repro_torch.kernels import trim_conv2d as kern
    from repro_torch.launch.serve_cnn import check_run
    from repro_torch.serve import ServeConfig, Server

    dev = torch.device("cuda", 0)
    cfg = CNN_REGISTRY["vgg16"]
    plan = plan_model(cfg, ExecutionPolicy())
    oracle = plan_model(cfg, ExecutionPolicy(substrate="oracle"))
    buckets = (1, 4, 8)
    conf = ServeConfig(buckets=buckets, max_delay_ms=5.0, datapath=datapath)
    dtype = "float32" if datapath == "float" else "uint8"
    stream = SyntheticRequestStream(
        hw=cfg.input_hw, channels=3, n_classes=cfg.n_classes,
        n_requests=n_requests, seed=0, process="bursts",
        burst_sizes=buckets, gap_s=0.05, dtype=dtype)
    t0 = time.perf_counter()
    params = plan.init(0, dev)
    requant = None
    if datapath != "float":
        sample = torch.from_numpy(stream.sample_batch(4)).to(dev)
    if datapath == "int8":
        params, _ = plan.quantize(params)
        requant = plan.calibrate_requant(params, sample)
    elif datapath == "int5":
        params, _ = plan.quantize_int5(params)
        requant = plan.calibrate_requant_int5(params, sample)
    server = Server.from_plan(plan, params, conf, requant=requant,
                              device=dev)
    log(f"serve {datapath}: params + warm build of buckets {buckets} in "
        f"{time.perf_counter() - t0:.1f} s")
    # the images are made before serving starts: at full width making one
    # takes longer than the flush deadline, which would split every burst
    items = list(stream)
    # the launches of each flush, counted around the engine's run of its
    # bucket (the one call a flush makes into the kernels)
    per_bucket = dict.fromkeys(buckets, 0)
    run_bucket = server.engine.run_bucket

    def counted(bucket, images):
        before = kern.LAUNCHES
        out = run_bucket(bucket, images)
        per_bucket[int(bucket)] += kern.LAUNCHES - before
        return out

    server.engine.run_bucket = counted
    kern.LAUNCHES = 0
    t0 = time.perf_counter()
    metrics = server.run_stream(items)
    server.close()
    wall = time.perf_counter() - t0
    launches = kern.LAUNCHES
    server.engine.run_bucket = run_bucket
    fails = check_run(server, metrics, n_requests, expect_all_buckets=True)
    if fails:
        fail(f"serve {datapath}: " + "; ".join(fails))
    snap = metrics.snapshot()
    flushes = snap["totals"]["flushes"]
    # fault-free: one lane, no armed plane, no resilience counter
    if [ln.name for ln in server.engine.lanes] != [datapath] \
            or server.engine.injector is not None \
            or RESILIENCE_KEYS & set(snap["totals"]) \
            or "degraded_lanes" in snap:
        fail(f"serve {datapath}: the fault-free server carries lanes "
             f"{[ln.name for ln in server.engine.lanes]} or resilience "
             f"counters {sorted(RESILIENCE_KEYS & set(snap['totals']))}")
    if launches != flushes * len(cfg.layers):
        fail(f"serve {datapath}: {launches} kernel launches for {flushes} "
             f"flushes of {len(cfg.layers)} convs")
    for b in buckets:
        n = snap["per_bucket"].get(str(b), {}).get("flushes", 0)
        if per_bucket[b] != n * len(cfg.layers):
            fail(f"serve {datapath}: bucket {b}: {per_bucket[b]} kernel "
                 f"launches counted in its {n} flushes of "
                 f"{len(cfg.layers)} convs")
    if sum(per_bucket.values()) != launches:
        fail(f"serve {datapath}: {sum(per_bucket.values())} launches in "
             f"the flushes, {launches} in the run")
    served = _served_inputs(server)
    last = plan.layers[-1]  # int8: the last conv's psums, before its pool
    shape = ((cfg.n_classes,) if datapath == "float"
             else (last.tile.H_O, last.tile.W_O, last.c_out))
    for r in served:
        if r.result.shape != shape:
            fail(f"serve {datapath}: result shape {r.result.shape}")
        if datapath == "float" and not np.isfinite(r.result).all():
            fail(f"serve {datapath}: non-finite logits")
    # bucketed == unbatched, bit for bit
    for r in served:
        single = server.engine.infer(r.payload[None])[0]
        if not np.array_equal(single, r.result):
            fail(f"serve {datapath}: request {r.rid} bucketed != unbatched")
    # each bucket's replay against its eager executable, on served images
    eng = server.engine
    for b in buckets:
        imgs = np.stack([r.payload for r in (served * b)[:b]])
        _replay_vs_eager(torch, f"serve {datapath}", eng, b, imgs,
                         hold=b == buckets[0])
    if set(eng.capture_counts.values()) != {1} \
            or set(eng.capture_counts) != set(eng.compile_counts):
        fail(f"serve {datapath}: captures per key {eng.capture_counts}")
    CAPTURES[f"serve {datapath}"] = dict(eng.capture_counts)
    # against the oracle substrate on the card
    first = served[:4]
    imgs = torch.from_numpy(np.stack([r.payload for r in first])).to(dev)
    got = np.stack([r.result for r in first])
    if datapath == "float":
        want = execute.serve_forward(oracle, params, imgs).cpu().numpy()
        err = float(np.abs(got - want).max())
        scale = float(np.abs(want).max())
        if not np.allclose(got, want, rtol=1e-3, atol=1e-3 * scale):
            fail(f"serve float: logits vs oracle max err {err:.3g} "
                 f"(max|logit| {scale:.3g})")
        log(f"serve float: logits vs oracle max|err| {err:.3g} "
            f"(max|logit| {scale:.3g}, tolerance rtol 1e-3, atol 1e-3*max)")
    else:
        fwd = (execute.forward_int5 if datapath == "int5"
               else execute.forward_int8)
        want = fwd(oracle, params, imgs, requant=requant).cpu().numpy()
        if not np.array_equal(got, want):
            fail(f"serve {datapath}: features differ from the oracle "
                 "substrate")
        log(f"serve {datapath}: features bit-equal to the oracle substrate")
    if datapath == "int5":
        # tests/test_int5.py:181's contract on the card: the int5 lane
        # equals the int8 lane on the decompressed weights w5 << e with
        # the exponent left on the requant shift
        q8 = {"conv": [{"kernel": torch.bitwise_left_shift(
            p["kernel"].to(torch.int32), p["shift"]).to(torch.int8)}
            for p in params["conv"]]}
        pairs8 = [(m, s + params["conv"][i]["shift"])
                  for i, (m, s) in enumerate(requant)]
        with torch.inference_mode():
            out5 = execute.forward_int5(plan, params, imgs, requant=requant)
            out8 = execute.forward_int8(plan, q8, imgs, requant=pairs8)
        if not torch.equal(out5, out8):
            fail("serve int5: forward_int5 differs from forward_int8 on the "
                 "decompressed weights")
        log("serve int5: forward_int5 bit-equal to forward_int8 on the "
            "decompressed weights (kernel substrate)")
    log(f"serve {datapath}: {snap['totals']['images']}/{n_requests} served "
        f"in {flushes} flushes ({wall:.2f} s wall, p99 "
        f"{snap['totals']['p99_ms']} ms), {launches} kernel launches, "
        f"builds {sorted(set(server.engine.compile_counts.values()))}, "
        f"captures {sorted(set(server.engine.capture_counts.values()))}")
    for b, rec in snap["per_bucket"].items():
        log(f"serve {datapath}: bucket {b}: {rec['flushes']} flushes, "
            f"{per_bucket[int(b)]} kernel launches, p50 {rec['p50_ms']} ms, "
            f"p99 {rec['p99_ms']} ms")
    return launches - per_bucket[buckets[-1]], per_bucket[buckets[-1]]


#: the chaos serve phases: (label, datapath, fault spec, breaker
#: threshold, producer threads).  The launcher's chaos spec runs threaded
#: (a worker crash needs the flush worker); at threshold 1 its three
#: batch failures degrade every bucket to int8.  "int5-flip" serves the
#: int5 lane through a restore (the flip fires before the first flush), so
#: its weight pre-pass count reads the wire's re-materialization.  int8
#: and float run inline; threshold None keeps ServeConfig's 3.
CHAOS_RUNS = (
    ("int5", "int5", "seed=3,worker=1,stage=2,bitflip=1,exec=2", 1, 4),
    ("int5-flip", "int5", "seed=8,bitflip=1", None, 0),
    ("int8", "int8", "seed=3,exec=2", 1, 0),
    ("float", "float", "seed=3,nonfinite=1", None, 0))
#: the chaos streams' gap between bursts, the fault-free serve phases'
CHAOS_GAP_S = 0.05
#: the counters a fault-free snapshot must not carry
RESILIENCE_KEYS = {"failed", "retried", "degraded", "worker_restarts",
                   "integrity_restored"}


def _p50(vals) -> float:
    return float(sorted(vals)[len(vals) // 2] * 1e3) if vals else 0.0


def phase_chaos(torch, label: str, datapath: str, spec: str, threshold,
                producers: int, n_requests: int):
    """Full-width VGG-16 through ``serve_cnn.build_server`` with the fault
    plane armed (``spec``) and its ladder, on buckets 1, 4, 8, the stream
    of the fault-free serve phases with :data:`CHAOS_GAP_S` between its
    bursts.  Fails unless ``check_run`` passes;
    each recorded failure is an injected one (``InjectedFault`` or the
    injected ``NonFiniteOutput``); every degradation runs from the
    primary lane to the next and follows from the fired budgets; every
    run of a bucket launches 13 convs on a kernel lane (the chunk count on
    ``int8-f32exact``) and no library conv; the u8 x s8 weight pre-pass
    runs once per (weight tensor, layout), and only for weights the wire
    materialized during the run; every served result equals, bit for
    bit, the fault-free answer of the lane that served it.  Logs flushes
    and p50 per lane and the resilience totals.  Returns the launches of
    the run's bucket runs by lane."""
    import numpy as np

    from repro_torch.configs import CNN_REGISTRY
    from repro_torch.data.pipeline import SyntheticRequestStream
    from repro_torch.engine import ExecutionPolicy, execute, plan_model
    from repro_torch.kernels import trim_conv2d as kern
    from repro_torch.launch.serve_cnn import build_server, check_run
    from repro_torch.serve import (FaultPlan, InjectedFault, NonFiniteOutput,
                                   ServeConfig)

    what = f"chaos {label}"
    dev = torch.device("cuda", 0)
    cfg = CNN_REGISTRY["vgg16"]
    buckets = (1, 4, 8)
    kw = {} if threshold is None else {"breaker_threshold": threshold}
    conf = ServeConfig(buckets=buckets, max_delay_ms=5.0, datapath=datapath,
                       faults=FaultPlan.parse(spec), **kw)
    stream = SyntheticRequestStream(
        hw=cfg.input_hw, channels=3, n_classes=cfg.n_classes,
        n_requests=n_requests, seed=0, process="bursts",
        burst_sizes=buckets, gap_s=CHAOS_GAP_S,
        dtype="float32" if datapath == "float" else "uint8")
    t0 = time.perf_counter()
    server = build_server(cfg, ExecutionPolicy(), conf, seed=0, device=dev)
    eng = server.engine
    names = [ln.name for ln in eng.lanes]
    log(f"{what}: {spec}, breaker threshold {eng.breaker.threshold}, "
        f"lanes {names}, {producers or 'no'} producer threads; params + "
        f"warm build of {len(names)} lanes x buckets {buckets} in "
        f"{time.perf_counter() - t0:.1f} s")
    if any(ln.substrate == "oracle" for ln in eng.lanes):
        fail(f"{what}: a lane on the library conv armed on the card: "
             f"{names}")
    items = list(stream)

    # -- instruments: failures, lanes, launches, flush latency, pre-passes
    errors, lane_of_rid, lane_of_batch = [], {}, {}
    runs, prepass, wire_sets = [], [], []
    lat, flushes = {n: [] for n in names}, dict.fromkeys(names, 0)
    record_failure = server._record_batch_failure
    record_death = server._record_worker_death
    dispatch, finalize = server._dispatch, server._finalize
    run_bucket, stage = eng.run_bucket, eng.stage
    u8_weights = kern.u8_weights

    def on_failure(bucket, err):
        errors.append(err)
        return record_failure(bucket, err)

    def on_death(err):
        errors.append(err)
        return record_death(err)

    def on_stage(images):
        try:
            return stage(images)
        except Exception as err:
            errors.append(err)
            raise

    def on_dispatch(bucket, reqs):
        name = eng.lane_of(bucket).name
        for r in reqs:
            lane_of_rid[r.rid] = name
        lane_of_batch[id(reqs)] = name
        return dispatch(bucket, reqs)

    def on_finalize(dispatched):
        finalize(dispatched)
        name = lane_of_batch[id(dispatched[1])]
        now = time.monotonic()
        flushes[name] += 1
        lat[name] += [now - r.t_submit for r in dispatched[1]]

    def on_run(bucket, images):
        # a run that captures again (after a wire restore) also makes the
        # capture's warm call: its launches are counted apart
        idx = eng.active_lane(bucket)
        before, warm = kern.LAUNCHES, eng.capture_launches
        out = run_bucket(bucket, images)
        runs.append((eng.lanes[idx].name, kern.LAUNCHES - before
                     - (eng.capture_launches - warm)))
        if idx == 0 and eng.wire is not None \
                and (not wire_sets or wire_sets[-1] is not eng._wire_params):
            wire_sets.append(eng._wire_params)
        return out

    def on_weights(w, key, nbytes):
        wt, ready = u8_weights(w, key, nbytes)
        if not ready:
            prepass.append((w, key))
        return wt, ready

    server._record_batch_failure, server._record_worker_death = \
        on_failure, on_death
    server._dispatch, server._finalize = on_dispatch, on_finalize
    eng.run_bucket, eng.stage = on_run, on_stage
    kern.u8_weights = on_weights
    first_wire = eng._wire_params
    library = []
    captured = dict(eng.capture_counts)
    warm0 = eng.capture_launches
    kern.LAUNCHES = 0
    t0 = time.perf_counter()
    try:
        with _no_library_conv(library):
            metrics = server.run_stream(items, producers=producers)
        server.close()
    finally:
        kern.u8_weights = u8_weights
    wall = time.perf_counter() - t0
    recapture_launches = eng.capture_launches - warm0
    launches = kern.LAUNCHES - recapture_launches
    snap = metrics.snapshot()
    tot = snap["totals"]
    fired = dict(eng.injector.fired)

    # -- the run's contract
    fails = check_run(server, metrics, n_requests,
                      expect_all_buckets=producers == 0)
    if fails:
        fail(f"{what}: " + "; ".join(fails))
    if library:
        fail(f"{what}: {len(library)} library conv calls on the served path")
    foreign = [f"{type(e).__name__}: {e}" for e in errors
               if not isinstance(e, (InjectedFault, NonFiniteOutput))]
    if foreign:
        fail(f"{what}: failures that were not injected: {foreign}")
    want = {"int5": ("degraded", "worker_restarts", "integrity_restored",
                     "retried"),
            "int5-flip": ("integrity_restored",),
            "int8": ("degraded", "retried"),
            "float": ("retried",)}[label]
    low = [k for k in want if tot.get(k, 0) < 1]
    if low:
        fail(f"{what}: {low} not counted (totals {tot})")
    degs = eng.degradations
    if len(degs) != tot.get("degraded", 0) or any(
            (d["from"], d["to"]) != tuple(names[:2]) for d in degs):
        fail(f"{what}: degradations {degs} against totals {tot}")
    budget = fired["exec"] + fired["worker"] + fired["nonfinite"]
    if len(degs) > budget or (threshold is None and degs):
        fail(f"{what}: {len(degs)} degradations from {budget} injected "
             f"batch failures at threshold {eng.breaker.threshold}")
    chunks = None
    if "int8-f32exact" in names:
        # the f32exact lane's launches a run: its chunk count, counted
        # around one fault-free forward at batch 1
        xplan = plan_model(cfg, ExecutionPolicy(substrate="f32exact"))
        img = torch.from_numpy(items[0][1][None]).to(dev)
        before = kern.LAUNCHES
        with torch.inference_mode():
            execute.forward_int8(xplan, eng.lanes[1].params, img,
                                 requant=eng.lanes[1].requant)
        chunks = kern.LAUNCHES - before
    bad = [(n, k) for n, k in runs
           if k != (chunks if n == "int8-f32exact" else len(cfg.layers))]
    if bad:
        fail(f"{what}: bucket runs with unexpected launches (lane, "
             f"launches): {bad}")
    if sum(k for _, k in runs) != launches:
        fail(f"{what}: {launches} launches in the run, "
             f"{sum(k for _, k in runs)} in its bucket runs")
    keys = [(id(w), key) for w, key in prepass]
    if len(set(keys)) != len(keys):
        fail(f"{what}: a weight pre-pass ran twice for one weight tensor")
    # tensors the wire decoded anew during the run: a restored layer's
    first_ids = {id(t["kernel"]) for t in first_wire["conv"]} \
        if first_wire is not None else set()
    served_wire = {id(t["kernel"]) for ws in wire_sets
                   if ws is not first_wire
                   for t in ws["conv"]} - first_ids
    stray = [w for w, _ in prepass if id(w) not in served_wire]
    if stray:
        fail(f"{what}: {len(stray)} weight pre-passes for weights that "
             "were not re-decoded from the wire during the run")
    if eng.wire is not None and eng.wire.verify():
        fail(f"{what}: the wire still fails its checksums after the run")
    remade = sum(ws is not first_wire for ws in wire_sets)
    if label == "int5-flip" and not (
            remade >= 1 and 0 < len(prepass)
            <= eng.wire.restored * len(buckets)):
        fail(f"{what}: {len(prepass)} weight pre-passes for "
             f"{eng.wire.restored} restored layers over {remade} wire "
             "materializations")
    # one capture per key at warmup; during the run the int5 lane's
    # buckets again after a wire restore (each new set of params at most
    # once a bucket, at least once), every other key never
    if captured != {k: 1 for k in eng.compile_counts}:
        fail(f"{what}: captures per key after warmup {captured}")
    wire_keys = {k for k in eng.capture_counts if eng.wire is not None
                 and f" {names[0]} " in k}
    again = sum(eng.capture_counts[k] - 1 for k in wire_keys)
    if any(eng.capture_counts[k] != 1 for k in eng.capture_counts
           if k not in wire_keys) or not (
            remade <= again <= remade * len(buckets)):
        fail(f"{what}: captures per key {eng.capture_counts} for {remade} "
             "wire materializations in the run")
    CAPTURES[what] = dict(eng.capture_counts)

    # -- every served result is the fault-free answer of its lane
    served = [r for r in server.requests if r.status == "served"]
    by_lane = {}
    for r in served:
        by_lane.setdefault(lane_of_rid[r.rid], []).append(r)
    plan = eng.plan
    master = eng.wire.master if eng.wire is not None else None

    q5 = plan.quantize_int5(master)[0] if master is not None else None

    def answer(name, imgs):
        lane = eng.lanes[names.index(name)]
        if name == "int5":
            return execute.forward_int5(plan, q5, imgs, requant=lane.requant)
        if lane.datapath == "int8":  # int8, and int8-f32exact's claim
            return execute.forward_int8(plan, lane.params, imgs,
                                        requant=lane.requant)
        return execute.serve_forward(plan, lane.params, imgs)

    for name, reqs in by_lane.items():
        for i in range(0, len(reqs), 8):
            part = reqs[i:i + 8]
            imgs = torch.from_numpy(
                np.stack([r.payload for r in part])).to(dev)
            with torch.inference_mode():
                ref_out = answer(name, imgs).cpu().numpy()
            got = np.stack([r.result for r in part])
            if not np.array_equal(got, ref_out):
                fail(f"{what}: requests served on lane {name} differ from "
                     "its fault-free answer")

    # every lane x bucket's replay against its eager executable, on
    # served images (the int5 lane's graphs of the final wire)
    for i, name in enumerate(names):
        for b in buckets:
            imgs = np.stack([r.payload for r in (served * b)[:b]])
            _replay_vs_eager(torch, f"{what} lane {name}", eng, b, imgs,
                             lane_idx=i)

    res = {k: tot[k] for k in sorted(RESILIENCE_KEYS) if k in tot}
    log(f"{what}: {tot['images']}/{n_requests} served, {tot.get('failed', 0)}"
        f" failed, in {tot['flushes']} flushes ({wall:.2f} s wall); "
        f"fired {fired}; totals {res}; degraded {snap.get('degraded_lanes')}")
    log(f"{what}: {len(errors)} recorded failures, all injected "
        f"({sorted({type(e).__name__ for e in errors})}); every served "
        f"result bit-equal to its lane's fault-free answer")
    for name in names:
        log(f"{what}: lane {name}: {flushes[name]} flushes, "
            f"{len(by_lane.get(name, []))} served, p50 "
            f"{_p50(lat[name]):.3f} ms, "
            f"{sum(k for n, k in runs if n == name)} kernel launches in "
            f"{sum(1 for n, _ in runs if n == name)} bucket runs")
    if eng.wire is not None:
        log(f"{what}: {len(prepass)} weight pre-passes over "
            f"{remade} wire "
            f"materializations in the run (restored layers "
            f"{eng.wire.restored}, each pre-passed anew alone), not one a "
            "flush "
            f"({sum(1 for n, _ in runs if n == 'int5')} int5 bucket runs)")
    if chunks is not None:
        log(f"{what}: int8-f32exact: {chunks} fp32 chunk launches a bucket "
            "run, no library conv")
    log(f"{what}: captures per key after the run {CAPTURES[what]} "
        f"({again} again after {remade} wire materializations, their warm "
        f"calls {recapture_launches} launches)")
    return {n: sum(k for m, k in runs if m == n) for n in names}


def phase_wire(torch):
    """Full-width VGG-16's ``PackedWire`` on the card: one bit flipped in
    each of its 13 layers; the next materialization restores all 13 and
    its ``kernel``/``shift`` tensors equal ``plan.quantize_int5``'s bit for
    bit; the int5 features served after the restore equal those served
    before the flip; then one flip in the largest layer restores and
    decodes that layer alone."""
    import numpy as np

    from repro_torch.configs import CNN_REGISTRY
    from repro_torch.data.pipeline import SyntheticRequestStream
    from repro_torch.engine import ExecutionPolicy, plan_model
    from repro_torch.serve import PackedWire, ServeEngine

    dev = torch.device("cuda", 0)
    cfg = CNN_REGISTRY["vgg16"]
    plan = plan_model(cfg, ExecutionPolicy())
    params = plan.init(0, dev)
    q5, _ = plan.quantize_int5(params)
    stream = SyntheticRequestStream(hw=cfg.input_hw, channels=3,
                                    n_classes=cfg.n_classes, seed=1,
                                    dtype="uint8")
    imgs = stream.sample_batch(4)
    requant = plan.calibrate_requant_int5(q5, torch.from_numpy(imgs).to(dev))
    t0 = time.perf_counter()
    wire = PackedWire(cfg, params)
    t_build = time.perf_counter() - t0
    eng = ServeEngine.build_for_plan(plan, q5, buckets=(4,), datapath="int5",
                                     requant=requant, wire=wire, device=dev)
    before = eng.infer(imgs)
    n = wire.n_layers
    rng = np.random.default_rng(0)
    for i in range(n):
        wire.flip_bit(i, int(rng.integers(0, wire._packed[i].size * 8)))
    if wire.verify() != list(range(n)):
        fail(f"wire: the checksums caught {wire.verify()} of {n} flips")
    t0 = time.perf_counter()
    got = wire.qparams()
    t_restore = time.perf_counter() - t0
    if wire.restored != n or len(got["conv"]) != n:
        fail(f"wire: restored {wire.restored} of {n} flipped layers")
    for i, (g, q) in enumerate(zip(got["conv"], q5["conv"])):
        if not (g["kernel"].device == dev and torch.equal(g["kernel"],
                                                          q["kernel"])
                and torch.equal(g["shift"], q["shift"])):
            fail(f"wire: layer {i}'s restored kernel/shift differ from "
                 "plan.quantize_int5's")
    after = eng.infer(imgs)
    if not np.array_equal(before, after):
        fail("wire: the int5 features after the restore differ from those "
             "before the flip")
    # one flip in the largest layer: that layer alone is restored and
    # decoded anew, the others keep their tensors
    big = max(range(n), key=lambda i: wire._packed[i].size)
    wire.flip_bit(big, 8 * big + 5)
    t0 = time.perf_counter()
    one = wire.qparams()
    t_one = time.perf_counter() - t0
    kept = [a is b for a, b in zip(got["conv"], one["conv"])]
    if wire.restored != n + 1 or kept != [i != big for i in range(n)]:
        fail(f"wire: one flip in layer {big} restored "
             f"{wire.restored - n} layers, kept tensors {kept}")
    if not np.array_equal(before, eng.infer(imgs)):
        fail("wire: the int5 features after a one-layer restore differ")
    # the bucket captured once at warmup and again after each restore,
    # the compile-once ledger untouched
    if list(eng.capture_counts.values()) != [3] or \
            list(eng.compile_counts.values()) != [1]:
        fail(f"wire: captured {eng.capture_counts}, built "
             f"{eng.compile_counts} over two restores")
    CAPTURES["wire"] = dict(eng.capture_counts)
    int8_bytes = sum(int(q["kernel"].numel()) for q in q5["conv"])
    log(f"wire: VGG-16 PackedWire {wire.nbytes()} bytes for {int8_bytes} "
        f"weights ({wire.nbytes() / int8_bytes:.4f} of int8), built in "
        f"{t_build:.2f} s; one bit flipped in each of {n} layers, all "
        f"caught and restored in {t_restore:.2f} s (host); restored "
        "kernel/shift bit-equal to plan.quantize_int5, int5 features after "
        "the restore bit-equal to those before the flip; one flip in the "
        f"largest layer ({big}, {wire._packed[big].size} bytes) restored "
        f"alone in {t_one:.3f} s (host); the bucket captured "
        f"{list(eng.capture_counts.values())[0]} times (once, then after "
        "each restore), built once")


#: the emulator phase's layers: (label, ConvLayerSpec arguments); the
#: third is VGG-16's CL9 at its full 28x28 with its 512 -> 512 channels
#: cut to 192 -> 224 (8 channel steps of P_M = 24 over 32 filter groups
#: of P_N = 7), which keeps the numpy emulator near 5 s
EMULATOR_LAYERS = (
    ("VGG-16 CL1", ("CL1", 224, 224, 3, 3, 64)),
    ("AlexNet CL1", ("CL1", 227, 227, 11, 3, 96, 4, 0)),
    ("VGG-16 CL9 cut to 192->224 channels", ("CL9", 28, 28, 3, 192, 224)),
)


def phase_emulator(torch):
    """The paper's bit-faithful engine emulator (``core.engine.TrimEngine``
    on ``PAPER_ENGINE``) against kernel 1's u8 x s8 lane (no epilogue,
    int32 out), bit for bit, on one seeded image per layer of
    :data:`EMULATOR_LAYERS`; the layouts are transposed here, in neither
    module.  Logs the emulator's fetch counters beside
    ``trim_memory_accesses``."""
    import numpy as np

    from repro_torch.core.engine import TrimEngine
    from repro_torch.core.model import (PAPER_ENGINE, ConvLayerSpec,
                                        trim_memory_accesses)
    from repro_torch.kernels import trim_conv2d as kern

    dev = torch.device("cuda", 0)
    for label, args in EMULATOR_LAYERS:
        l = ConvLayerSpec(*args)
        rng = np.random.default_rng(len(label))
        x = rng.integers(0, 256, (l.M, l.H_I, l.W_I), dtype=np.uint8)
        w = rng.integers(-128, 128, (l.N, l.M, l.K, l.K)).astype(np.int8)
        t0 = time.perf_counter()
        want, trace = TrimEngine(PAPER_ENGINE).run_layer(x, w, l)
        t_emu = time.perf_counter() - t0
        xd = torch.from_numpy(np.ascontiguousarray(
            x.transpose(1, 2, 0))[None]).to(dev)
        wd = torch.from_numpy(np.ascontiguousarray(
            w.transpose(2, 3, 1, 0))).to(dev)
        got = kern.trim_conv2d(xd, wd, stride=l.stride, padding=l.padding)
        ms = cuda_ms(torch, lambda: kern.trim_conv2d(
            xd, wd, stride=l.stride, padding=l.padding), 10)
        got = got[0].permute(2, 0, 1).cpu().numpy()
        if got.dtype != np.int32 or not np.array_equal(got, want):
            fail(f"emulator: {label}: kernel 1's u8s8 output differs from "
                 f"the TrimEngine emulator's (max diff "
                 f"{np.abs(got.astype(np.int64) - want).max()})")
        acc = trim_memory_accesses(l, PAPER_ENGINE)
        log(f"emulator: {label} ({l.H_I}x{l.W_I}, K={l.K}, S={l.stride}, "
            f"{l.M}->{l.N}): kernel 1 bit-equal to the emulator "
            f"({want.shape[0]}x{want.shape[1]}x{want.shape[2]} int32); "
            f"emulator {t_emu:.2f} s (host numpy), kernel {ms:.4f} ms; "
            f"{trace.steps} engine steps, max|psum| {trace.max_abs_psum}; "
            f"fetches: ifmap {trace.ifmap_fetches} (model "
            f"{acc.ifmap_reads * 1e6:.0f}), weight {trace.weight_fetches} "
            f"({acc.weight_reads * 1e6:.0f}), ofmap "
            f"{trace.ofmap_writebacks} ({acc.ofmap_writes * 1e6:.0f}), "
            f"psum buffer {trace.psum_buffer_accesses} "
            f"({acc.onchip_raw * 1e6:.0f})")


def _f32exact_cases():
    """(arch, index, layer, groups, last) of every VGG-16 conv and
    AlexNet's strided (CL1) and grouped (CL2, CL4, CL5) convs."""
    return [c for c in _u8_cases()
            if c[0] == "vgg16" or c[1] in (0, 1, 3, 4)]


@contextlib.contextmanager
def _no_library_conv(seen=None):
    """A context in which any call of ``F.conv2d`` (cuDNN, and the float64
    oracle through it) fails the phase; with a list ``seen``, the call is
    recorded there and raises instead (a serving thread cannot end the
    process: the caller checks ``seen``)."""
    import torch.nn.functional as F

    real = F.conv2d

    def refused(*a, **k):
        if seen is not None:
            seen.append("F.conv2d")
            raise RuntimeError("a library conv ran on a refused path")
        fail("f32exact: a library conv (cuDNN / the float64 oracle) ran on "
             "the f32exact path")

    F.conv2d = refused
    try:
        yield
    finally:
        F.conv2d = real


def phase_f32exact(torch, reps: int, rows):
    """The f32exact substrate and the emulate_hw replay on the card.

    Per conv (every VGG-16 conv, AlexNet CL1/CL2/CL4/CL5), batch 1, with
    ``w_bits`` 8 and 5: ``run_conv2d`` on an f32exact plan equals the
    oracle bit for bit at worst-case magnitudes (all-255 x, every filter's
    weights at +-127 or +-31) and on random inputs; its fp32-wrapper
    launches, counted around the call with ``F.conv2d`` refused, equal the
    chunk count; its time beside the u8 x s8 lane's from ``rows``.  Then
    full-width VGG-16's ``forward_int8`` and ``forward_int5`` on the
    f32exact substrate at batch 1 (launches counted from 0 around each
    run) against the oracle substrate's, and AlexNet CL1 (stride 4) under
    ``emulate_hw`` against the strided path on the int8 lane (kernel and
    f32exact).  Returns (rows, launches of the model runs by w_bits)."""
    import numpy as np

    from repro_torch.configs import CNN_REGISTRY
    from repro_torch.core.model import ALEXNET_LAYERS
    from repro_torch.engine import ExecutionPolicy, execute, plan_model
    from repro_torch.engine.plan import plan_conv_layer
    from repro_torch.kernels import ref
    from repro_torch.kernels import trim_conv2d as kern
    from repro_torch.kernels.requant import scale_to_mult_shift

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(2)
    u8ms = {(r["arch"], r["layer"]): r["ms"] for r in rows
            if r["lane"] == "u8s8" and r["batch"] == 1}
    out = []
    for w_bits in (8, 5):
        hi = 127 if w_bits == 8 else 31
        for arch, i, l, groups, last in _f32exact_cases():
            C, Cg, K, Fo = l.M * groups, l.M, l.K, l.N
            kw = dict(stride=l.stride, padding=l.padding, groups=groups,
                      relu=True, w_bits=w_bits)
            plan = plan_conv_layer((l.H_I, l.W_I), C, K, Fo,
                                   policy=ExecutionPolicy("f32exact"), **kw)
            oplan = plan_conv_layer((l.H_I, l.W_I), C, K, Fo,
                                    policy=ExecutionPolicy("oracle"), **kw)
            chunk = ref.exact_f32_chunk(torch.uint8, torch.int8, K,
                                        31 if w_bits == 5 else None)
            chunks = groups * -(-Cg // chunk)
            worst_x = torch.full((1, l.H_I, l.W_I, C), 255, dtype=torch.uint8,
                                 device=dev)
            sign = torch.where(torch.arange(Fo, device=dev) % 2 == 0, -1, 1)
            worst_w = (sign * hi).to(torch.int8).expand(K, K, Cg, Fo)
            rand_x = torch.randint(0, 256, (1, l.H_I, l.W_I, C), generator=gen,
                                   device=dev, dtype=torch.uint8)
            rand_w = torch.randint(-hi - (w_bits == 8), hi + 1,
                                   (K, K, Cg, Fo), generator=gen, device=dev,
                                   dtype=torch.int8)
            for what, x, w in (("worst-case", worst_x, worst_w.contiguous()),
                               ("random", rand_x, rand_w)):
                with _no_library_conv():
                    before = kern.LAUNCHES
                    got = execute.run_conv2d(plan, x, w)
                    n = kern.LAUNCHES - before
                want = execute.run_conv2d(oplan, x, w)
                torch.cuda.synchronize()
                if n != chunks:
                    fail(f"f32exact {arch} {l.name} w{w_bits}: {n} fp32 "
                         f"launches for {chunks} chunks")
                if got.dtype != want.dtype or not torch.equal(got, want):
                    diff = (got.double() - want.double()).abs().max()
                    fail(f"f32exact {arch} {l.name} w{w_bits} {what}: != "
                         f"oracle (max diff {diff})")
            macs = l.H_O * l.W_O * Fo * K * K * Cg
            nbytes = rand_x.numel() + rand_w.numel() + 4 * got.numel()

            def run(plan=plan, x=rand_x, w=rand_w):
                return execute.run_conv2d(plan, x, w)

            r = {"arch": arch, "layer": l.name, "lane": "f32exact",
                 "w_bits": w_bits, "batch": 1, "launches": chunks,
                 "ms": cuda_ms(torch, run, max(1, reps // 5)),
                 "device_ms": device_ms(torch, run, 5),
                 "issue_ms": issue_ms(torch, run, max(1, reps // 5)),
                 "plain_ms": cuda_ms(torch, lambda: execute.run_conv2d(
                     oplan, rand_x, rand_w), max(1, reps // 10)),
                 "library_ms": None, "max_abs_err": 0.0,
                 **bound(macs, nbytes, integer=True)}
            out.append(r)
            log(f"f32exact {arch:7s} {l.name:4s} w{w_bits} batch 1: bit-equal "
                f"to the oracle (worst-case and random), {chunks} fp32 "
                f"launches ({groups} group(s) x {-(-Cg // chunk)} chunks of "
                f"<= {chunk} channels); ms {r['ms']:.4f} device_ms "
                f"{_fmt(r['device_ms'])} host issue ms {r['issue_ms']:.4f} "
                f"plain_ms {r['plain_ms']:.4f} bound_ms {r['bound_ms']:.4f}; "
                f"u8s8 lane ms {_fmt(u8ms.get((arch, l.name)))}")
    for w_bits in (8, 5):
        sel = [r for r in out if r["w_bits"] == w_bits
               and r["arch"] == "vgg16"]
        dev_ms = ("" if None in [r["device_ms"] for r in sel]
                  else f" device_ms {sum(r['device_ms'] for r in sel):.4f}")
        log(f"f32exact vgg16 w{w_bits} batch 1, sum of {len(sel)} convs: ms "
            f"{sum(r['ms'] for r in sel):.4f}{dev_ms} issue_ms "
            f"{sum(r['issue_ms'] for r in sel):.4f} plain_ms "
            f"{sum(r['plain_ms'] for r in sel):.4f} bound_ms "
            f"{sum(r['bound_ms'] for r in sel):.4f}, "
            f"{sum(r['launches'] for r in sel)} fp32 launches")

    # the model path: full-width VGG-16 on the f32exact substrate
    cfg = CNN_REGISTRY["vgg16"]
    fplan = plan_model(cfg, ExecutionPolicy("f32exact"))
    oplan = plan_model(cfg, ExecutionPolicy("oracle"))
    params = fplan.init(0, dev)
    imgs = torch.randint(0, 256, (1, 224, 224, 3), generator=gen, device=dev,
                         dtype=torch.uint8)
    model_launches = {}
    for w_bits in (8, 5):
        if w_bits == 8:
            qp, _ = fplan.quantize(params)
            rq = oplan.calibrate_requant(qp, imgs)
            fwd = execute.forward_int8
        else:
            qp, _ = fplan.quantize_int5(params)
            rq = oplan.calibrate_requant_int5(qp, imgs)
            fwd = execute.forward_int5
        with torch.inference_mode(), _no_library_conv():
            kern.LAUNCHES = 0
            t0 = time.perf_counter()
            got = fwd(fplan, qp, imgs, requant=rq)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            n = kern.LAUNCHES
        with torch.inference_mode():
            want = fwd(oplan, qp, imgs, requant=rq)
        if not torch.equal(got, want):
            fail(f"f32exact: VGG-16 int{w_bits} features differ from the "
                 "oracle substrate's")
        chunk = ref.exact_f32_chunk(torch.uint8, torch.int8, 3,
                                    31 if w_bits == 5 else None)
        expect = sum(-(-lp.c_in // chunk) for lp in fplan.layers)
        if n != expect:
            fail(f"f32exact: VGG-16 int{w_bits}: {n} fp32 launches, "
                 f"{expect} chunks")
        model_launches[w_bits] = n
        with torch.inference_mode():
            ms = cuda_ms(torch, lambda: fwd(fplan, qp, imgs, requant=rq), 5)
            kplan = plan_model(cfg, ExecutionPolicy("kernel"))
            kms = cuda_ms(torch, lambda: fwd(kplan, qp, imgs, requant=rq), 5)
        log(f"f32exact: VGG-16 forward_int{w_bits} at batch 1 bit-equal to "
            f"the oracle substrate; {n} fp32 launches (the chunks), "
            f"{wall:.1f} ms wall (first call), {ms:.4f} ms a call after it "
            f"(events; on the u8 x s8 kernel: {kms:.4f} ms)")

    # emulate_hw: AlexNet CL1 (stride 4) decimated == strided, int8 lane
    l = ALEXNET_LAYERS[0]
    for N in (1, TRAIN_BATCH):
        x = torch.randint(0, 256, (N, l.H_I, l.W_I, l.M), generator=gen,
                          device=dev, dtype=torch.uint8)
        w = torch.randint(-127, 128, (l.K, l.K, l.M, l.N), generator=gen,
                          device=dev, dtype=torch.int8)
        psum = ref.conv2d(x, w, stride=l.stride, padding=l.padding)
        amax = psum.clamp(min=0).amax(dim=(0, 1, 2)).cpu().numpy()
        m, s = scale_to_mult_shift(255.0 / np.maximum(amax, 1.0))
        rq = (torch.as_tensor(m, device=dev), torch.as_tensor(s, device=dev))
        for sub in ("kernel", "f32exact"):
            outs = {}
            for emulate in (False, True):
                plan = plan_conv_layer(
                    (l.H_I, l.W_I), l.M, l.K, l.N, stride=l.stride,
                    padding=l.padding, relu=True, requant_kind="mult_shift",
                    policy=ExecutionPolicy(sub, emulate_hw=emulate))
                before = kern.LAUNCHES
                outs[emulate] = execute.run_conv2d(plan, x, w, None, rq)
                launches = kern.LAUNCHES - before
            if not plan.decimate or launches != 1:
                fail(f"emulate_hw: AlexNet CL1 plan decimates "
                     f"{plan.decimate}, {launches} launches")
            if not torch.equal(outs[True], outs[False]):
                fail(f"emulate_hw: AlexNet CL1 batch {N} on {sub}: the "
                     "decimated int8 output differs from the strided one")
            log(f"emulate_hw: AlexNet CL1 batch {N} on {sub}: decimated "
                f"(stride-1 sweep {plan.tile.H_O}x{plan.tile.W_O}, 1 launch) "
                f"bit-equal to the strided path {tuple(outs[False].shape)}")
    return out, model_launches


def _conv1d_cold(torch, x, w, reps):
    """The conv1d kernel's event and profiler device times a call with x
    cold in L2: calls rotating over copies of x, laid out as x is (a
    strided view keeps its row stride), enough copies that the x and out
    bytes of the calls between two reads of one copy pass
    MATMUL_COLD_BYTES."""
    from repro_torch.kernels.trim_conv1d import trim_conv1d

    B, L, D = x.shape
    touched = 2 * B * L * D * x.element_size()
    n = max(2, -(-int(MATMUL_COLD_BYTES) // touched) + 1)
    xs = [torch.empty_strided(x.shape, x.stride(), dtype=x.dtype,
                              device=x.device).copy_(x) for _ in range(n)]
    turn = [0]

    def call():
        turn[0] = (turn[0] + 1) % n
        return trim_conv1d(xs[turn[0]], w)

    calls = max(2 * n, reps)
    out = {"cold_copies": n, "ms_cold": cuda_ms(torch, call, calls),
           "device_ms_cold": device_ms(torch, call, calls)}
    del xs
    return out


def _conv1d_row(torch, x, w, reps, label="full") -> dict:
    """The conv1d kernel's times on x (B, L, D) (the path's view) and w
    (K, D) beside its plain version's, cuDNN's (``F.conv1d``, groups = D,
    on an input already (B, D, L)) and the bound: by CUDA events over
    back-to-back calls (``ms``), the profiler's device time (``device_ms``),
    the host's issue time a call (``issue_ms``; where it is not below the
    device time, ``ms`` measures the host) and with x cold in L2
    (``_conv1d_cold``)."""
    import torch.nn.functional as F

    from repro_torch.kernels.trim_conv1d import (trim_conv1d,
                                                 trim_conv1d_plain)

    (B, L, D), K = x.shape, w.shape[0]
    x_t = x.permute(0, 2, 1).contiguous()                  # (B, D, L)
    w_t = w.t().contiguous()[:, None, :]                   # (D, 1, K)
    return {
        "label": label,
        "dtype": str(x.dtype).replace("torch.", ""), "shape": (B, L, D, K),
        "launches": 1, "max_abs_err": 0.0,
        "ms": cuda_ms(torch, lambda: trim_conv1d(x, w), reps),
        "device_ms": device_ms(torch, lambda: trim_conv1d(x, w), reps,
                               kernels=("trim_conv1d_kernel", 1)),
        "issue_ms": issue_ms(torch, lambda: trim_conv1d(x, w), reps),
        **_conv1d_cold(torch, x, w, reps),
        "plain_ms": cuda_ms(torch, lambda: trim_conv1d_plain(x, w), reps),
        "library_ms": cuda_ms(torch, lambda: F.conv1d(
            x_t, w_t, groups=D, padding=K - 1)[..., :L], reps),
        **bound(K * B * L * D, (2 * B * L * D + K * D) * x.element_size(),
                integer=False)}


def _log_conv1d_row(r, what="conv1d") -> None:
    host = ("" if r["device_ms"] is None or r["issue_ms"] < r["device_ms"]
            else "; the host's issue time is not below the device time: "
            "ms measures the host")
    log(f"{what} {r['label']} {r['dtype']:8s} {tuple(r['shape'])} ms "
        f"{r['ms']:.4f} device_ms {_fmt(r['device_ms'])} issue_ms "
        f"{r['issue_ms']:.4f} cold ({r['cold_copies']} copies of x) ms "
        f"{r['ms_cold']:.4f} device_ms {_fmt(r['device_ms_cold'])} plain_ms "
        f"{r['plain_ms']:.4f} library_ms {r['library_ms']:.4f} bound_ms "
        f"{r['bound_ms']:.4f} ({r['bound_by']}); bound / device_ms "
        + ("not measured" if r["device_ms"] is None else
           f"{r['bound_ms'] / r['device_ms']:.3f}") + host)


def phase_conv1d(torch, reps: int):
    """The conv1d kernel against its plain version on the card, bit for
    bit, at the path's shapes and edge shapes; timed at full width.
    Returns one row per dtype at full width."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.trim_conv1d import (trim_conv1d,
                                                 trim_conv1d_plain)
    from repro_torch.nn.models import build_model

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(2)
    dims = build_model(get_config(LM_ARCH)).spec.dims
    # xBC: channels 1536:3328 (D = 1792) of in_proj's 3352 outputs
    d_in, D, n_proj, K = (dims.d_inner, dims.conv_channels,
                          dims.in_proj_out, dims.d_conv)

    def check(x, w, what):
        got, want = trim_conv1d(x, w), trim_conv1d_plain(x, w)
        torch.cuda.synchronize()
        if got.shape != want.shape or got.dtype != want.dtype \
                or not torch.equal(got, want):
            err = (got.float() - want.float()).abs().max().item()
            fail(f"conv1d {what}: kernel != plain (max diff {err:.3g})")
        return got

    rows, n = [], 0
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).replace("torch.", "")
        rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev
                                         ).to(dtype)
        proj = rnd(LM_BATCH, LM_PROMPT, n_proj)
        x = proj[..., d_in:d_in + D]          # the path's strided view
        w = rnd(K, D) * K ** -0.5
        check(x, w, f"{name} full width (view of in_proj's output)")
        check(x.contiguous(), w, f"{name} full width (contiguous)")
        check(rnd(LM_BATCH, LM_PROMPT, 160), rnd(K, 160), f"{name} smoke D")
        n += 3
        for L in (1, 2, 3, 257):
            for k in (1, 4, 6):
                check(rnd(2, L, D), rnd(k, D), f"{name} L={L} K={k}")
                n += 1
        # the training batch's view and a rank's channels (phase 26), and
        # rows 3 elements off 16 bytes (the element path)
        proj_t = rnd(*LM_TRAIN[LM_ARCH][:2], n_proj)
        x_t = proj_t[..., d_in:d_in + D]
        x_r = rnd(LM_BATCH, LM_PROMPT, D // SPLIT_RANKS)
        w_r = rnd(K, D // SPLIT_RANKS) * K ** -0.5
        check(x_t, w, f"{name} training shape {tuple(x_t.shape)}")
        check(x_r, w_r, f"{name} a rank's shape {tuple(x_r.shape)}")
        check(proj_t[..., d_in + 3:d_in + 3 + D], w,
              f"{name} training shape, rows not 16-byte aligned")
        n += 3
        rows.append(_conv1d_row(torch, x, w, reps))
        if dtype == torch.bfloat16:
            rows.append(_conv1d_row(torch, x_t, w, reps, "train"))
            rows.append(_conv1d_row(torch, x_r, w_r, reps, "rank"))
        del proj, proj_t, x_r
    log(f"conv1d: kernel bit-equal to plain at {n} shapes x inputs")
    for r in rows:
        _log_conv1d_row(r)
    return rows


def _flash_cases(cfg):
    """(name, B, Sq, Sk, H, G, D, causal, q_offset, kv_length or None).
    ``tests/test_kernels.py:150 FLASH_CASES`` (B, H, S, causal) at the
    kernel's head dim 64 (it is built for 64 and 128, the LM configs'),
    then GQA, per-row kv_length with a row at 0, Sq < Sk with q_offset,
    D = 128, and the full-width prefill and decode of ``cfg``."""
    H, G, D = cfg.n_kv, cfg.n_q // cfg.n_kv, cfg.head_dim
    s_max = LM_PROMPT + LM_GEN
    return [
        ("FLASH_CASES[0]", 2, 64, 64, 3, 1, 64, True, 0, None),
        ("FLASH_CASES[1]", 1, 33, 33, 2, 1, 64, True, 0, None),
        ("FLASH_CASES[2]", 2, 40, 40, 2, 1, 64, False, 0, None),
        ("FLASH_CASES[3]", 1, 128, 128, 1, 1, 64, True, 0, None),
        ("gqa", 2, 77, 77, 2, 4, 64, True, 0, None),
        ("kv_length", 3, 40, 40, 2, 4, 64, False, 0, (40, 0, 17)),
        ("kv_length decode", 3, 1, 300, 2, 4, 64, False, 0, (300, 0, 129)),
        ("q_offset", 2, 100, 300, 2, 4, 64, True, 200, None),
        ("d128", 2, 50, 130, 1, 4, 128, True, 80, None),
        ("prefill", LM_BATCH, LM_PROMPT, LM_PROMPT, H, G, D, True, 0, None),
        ("decode", LM_BATCH, 1, s_max, H, G, D, False, 0,
         (LM_PROMPT + 1,) * LM_BATCH),
    ]


def _visible_pairs(Sq, Sk, causal, q_offset, kvl, B):
    """(query row, key) pairs the inputs make visible, over the batch."""
    n = 0
    for b in range(B):
        keys = min(Sk, Sk if kvl is None else kvl[b])
        if not causal:
            n += Sq * max(keys, 0)
            continue
        for s in range(Sq):
            n += max(0, min(keys, q_offset + s + 1))
    return n


def _row_ulps(got, want) -> float:
    """The largest max|got - want| over a row of the last axis, in units
    of 2^-7 x the row's max|want| (inf where a row of zeros is missed)."""
    import torch

    err = (got.float() - want.float()).abs().amax(-1)
    unit = want.float().abs().amax(-1) * 2.0 ** -7
    ratio = torch.where(unit > 0, err / unit.clamp_min(1e-30),
                        torch.where(err > 0, float("inf"), 0.0))
    return ratio.max().item()


def _flash_times(torch, q, k, v, kw, kvl, reps, kp=None, vp=None):
    """The flash kernel's times on q, k, v under ``kw`` beside its plain
    version's (on ``kp``/``vp`` where given: the keys past ``kvl`` zeroed)
    and SDPA's (KV heads repeated), and the bound; ``kvl`` the per-row
    kv_length tuple or None.  Returns (those readings, SDPA's operands)."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    B, Sq, H, G, D = q.shape
    Sk = k.shape[1]
    causal = kw["causal"]
    keys = Sk if kvl is None else kvl[0]
    kt = k[:, :keys].repeat_interleave(G, dim=2).transpose(1, 2)
    vt = v[:, :keys].repeat_interleave(G, dim=2).transpose(1, 2)
    qt = q.reshape(B, Sq, H * G, D).transpose(1, 2)
    pairs = _visible_pairs(Sq, Sk, causal, kw.get("q_offset", 0), kvl, B)
    nbytes = (2 * q.numel() + 2 * B * keys * H * D) * q.element_size()
    kp, vp = (k, v) if kp is None else (kp, vp)
    return {
        "ms": cuda_ms(torch, lambda: fa.flash_attention(q, k, v, **kw), reps),
        "plain_ms": cuda_ms(torch, lambda: fa.flash_attention_plain(
            q, kp, vp, **kw), max(2, reps // 10)),
        "library_ms": cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal), reps),
        **bound(2 * H * G * D * pairs, nbytes, integer=False,
                peak=PEAK_BF16 if q.dtype == torch.bfloat16 else 0.0)}, \
        (qt, kt, vt)


def phase_flash(torch, reps: int):
    """The flash-attention kernel against its plain version on the card
    (TF32 off), fp32 within rtol = atol = 2e-5 and bf16 within 2e-2 and
    within BF16_ROW_ULPS per row (``_row_ulps``), with the keys past
    kv_length holding NaN for the kernel (zero for the plain version,
    which would sum them).  At the full-width decode (the split path),
    the kernel run with one 64-key tile dropped must fail the bf16 row
    check.  Timed at granite-3-2b's full-width prefill and decode shapes,
    with ``_flash_readings`` in both dtypes (the fp32 decode's device time
    with the cache cold in L2 is the split decode's target).  Returns one
    row per (shape, dtype)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(3)
    tol = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
    rows, n, worst_ulps, fault = [], 0, 0.0, None
    for name, B, Sq, Sk, H, G, D, causal, off, kvl in _flash_cases(
            get_config(DENSE_ARCH)):
        for dtype in (torch.bfloat16, torch.float32):
            rnd = lambda *shape: torch.randn(shape, generator=gen,
                                             device=dev).to(dtype)
            q = rnd(B, Sq, H, G, D)
            k, v = rnd(B, Sk, H, D), rnd(B, Sk, H, D)
            length, kp, vp = None, k, v
            if kvl is not None:
                length = torch.tensor(kvl, dtype=torch.int32, device=dev)
                stale = (torch.arange(Sk, device=dev)[None, :]
                         >= length[:, None])[..., None, None]
                kp, vp = k.masked_fill(stale, 0.0), v.masked_fill(stale, 0.0)
                k.masked_fill_(stale, float("nan"))
                v.masked_fill_(stale, float("nan"))
            kw = dict(causal=causal, q_offset=off, kv_length=length)
            got = fa.flash_attention(q, k, v, **kw)
            want = fa.flash_attention_plain(q, kp, vp, **kw)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            if got.shape != want.shape or got.dtype != want.dtype \
                    or not bool(torch.isfinite(got).all()) \
                    or not torch.allclose(got.float(), want.float(),
                                          rtol=tol[dtype], atol=tol[dtype]):
                fail(f"flash {name} {dtype}: max|kernel-plain| = {err:.3g} "
                     f"(rtol = atol = {tol[dtype]})")
            ulps = _row_ulps(got, want) if dtype == torch.bfloat16 else None
            if ulps is not None:
                worst_ulps = max(worst_ulps, ulps)
                if ulps > BF16_ROW_ULPS:
                    fail(f"flash {name} bf16: a row's max|kernel-plain| is "
                         f"{ulps:.3g} x 2^-7 of its max|plain| (limit "
                         f"{BF16_ROW_ULPS})")
            n += 1
            if name not in ("prefill", "decode"):
                continue
            if name == "decode" and dtype == torch.bfloat16:
                cut = lambda t: torch.cat([t[:, :DROP_TILE],
                                           t[:, DROP_TILE + 64:]], 1)
                bad = fa.flash_attention(q, cut(k), cut(v), causal=causal,
                                         q_offset=off, kv_length=length - 64)
                fault = ((bad.float() - want.float()).abs().max().item(),
                         _row_ulps(bad, want),
                         torch.allclose(bad.float(), want.float(),
                                        rtol=tol[dtype], atol=tol[dtype]))
                if fault[1] <= BF16_ROW_ULPS:
                    fail(f"flash decode bf16: a kernel without keys "
                         f"[{DROP_TILE}, {DROP_TILE + 64}) passes the row "
                         f"check ({fault[1]:.3g} x 2^-7)")
            times, sdpa = _flash_times(torch, q, k, v, kw, kvl, reps, kp, vp)
            row = {
                "shape": name, "dtype": str(dtype).replace("torch.", ""),
                "q": tuple(q.shape), "kv": tuple(k.shape), "kv_length": kvl,
                "max_abs_err": err, "row_ulps": ulps, **times}
            row.update(_flash_readings(torch, fa, q, k, v, kw, *sdpa, G,
                                       reps, cold=name == "decode"))
            rows.append(row)
    log(f"flash: kernel matches plain at {n} cases x dtypes (fp32 2e-5, "
        f"bf16 2e-2 and per row {BF16_ROW_ULPS} x 2^-7 of max|plain|: the "
        f"worst bf16 row at {worst_ulps:.3g})")
    log(f"flash: planted fault, keys [{DROP_TILE}, {DROP_TILE + 64}) dropped "
        f"at the bf16 decode: max|err| {fault[0]:.3g}, worst row "
        f"{fault[1]:.3g} x 2^-7 (rejected by the row check); allclose at "
        f"2e-2 alone would {'pass' if fault[2] else 'reject'} it")
    for r in rows:
        log(f"flash {r['shape']:7s} {r['dtype']:8s} q {r['q']} kv {r['kv']} "
            f"kv_length {r['kv_length']} ms {r['ms']:.4f} plain_ms "
            f"{r['plain_ms']:.4f} library_ms {r['library_ms']:.4f} "
            f"bound_ms {r['bound_ms']:.4f} ({r['bound_by']}) err "
            f"{r['max_abs_err']:.3g}"
            + (f" row_ulps {r['row_ulps']:.3g}" if r["row_ulps"] is not None
               else ""))
        extra = {k: v for k, v in r.items() if k in FLASH_READINGS}
        if extra:
            log(f"flash {r['shape']:7s} {r['dtype']:8s} " + " ".join(
                f"{k} {'none' if v is None else format(v, '.4f')}"
                for k, v in extra.items()))
    return rows


#: the flash rows' readings beyond ms / library_ms (events, warm):
#: the kernel's and SDPA's device time under ``torch.profiler`` (warm),
#: SDPA with ``enable_gqa`` on the unrepeated k/v, the wrapper's host
#: issue time per call, and at decode the same with the k/v cache cold in
#: L2 (calls rotating over FLASH_COLD_CACHES caches)
FLASH_READINGS = ("device_ms", "library_device_ms", "library_gqa_ms",
                  "library_gqa_device_ms", "issue_ms", "ms_cold",
                  "device_ms_cold", "library_ms_cold",
                  "library_device_ms_cold", "library_gqa_device_ms_cold")
#: distinct k/v caches the cold decode readings rotate over: 4 x 33.8 MB
#: at granite-3-2b's decode shape, past the H100's 50 MB L2
FLASH_COLD_CACHES = 4


def _flash_readings(torch, fa, q, k, v, kw, qt, kt, vt, G, reps, cold):
    """The flash kernel's and SDPA's readings beyond the event times
    (``FLASH_READINGS``).  With ``cold``, also over FLASH_COLD_CACHES
    fresh k/v caches of k's shape (NaN past kv_length, like k), each call
    taking the next, so each finds its cache out of L2."""
    import torch.nn.functional as F

    def sdpa(qq, kk, vv, **extra):
        return F.scaled_dot_product_attention(qq, kk, vv,
                                              is_causal=kw["causal"], **extra)

    keys = kt.shape[2]
    ku, vu = (t[:, :keys].transpose(1, 2) for t in (k, v))
    try:
        sdpa(qt, ku, vu, enable_gqa=True)
        gqa = True
    except TypeError:   # a torch without enable_gqa
        gqa = False
    calls = max(10, reps // 5)
    out = {
        "device_ms": device_ms(torch, lambda: fa.flash_attention(q, k, v,
                                                                 **kw), calls),
        "library_device_ms": device_ms(torch, lambda: sdpa(qt, kt, vt),
                                       calls),
        "library_gqa_ms": (cuda_ms(torch, lambda: sdpa(qt, ku, vu,
                                                       enable_gqa=True), reps)
                           if gqa else None),
        "library_gqa_device_ms": (device_ms(torch, lambda: sdpa(
            qt, ku, vu, enable_gqa=True), calls) if gqa else None),
        "issue_ms": issue_ms(torch, lambda: fa.flash_attention(q, k, v, **kw),
                             reps),
    }
    if not cold:
        return out
    caches = []
    for _ in range(FLASH_COLD_CACHES):
        kc, vc = torch.randn_like(k, dtype=torch.float32).to(k.dtype), \
            torch.randn_like(v, dtype=torch.float32).to(v.dtype)
        if kw["kv_length"] is not None:
            stale = (torch.arange(k.shape[1], device=k.device)[None, :]
                     >= kw["kv_length"][:, None])[..., None, None]
            kc.masked_fill_(stale, float("nan"))
            vc.masked_fill_(stale, float("nan"))
        caches.append((kc, vc, kc[:, :keys].repeat_interleave(G, 2)
                       .transpose(1, 2), vc[:, :keys].repeat_interleave(G, 2)
                       .transpose(1, 2), kc[:, :keys].transpose(1, 2),
                       vc[:, :keys].transpose(1, 2)))
    turn = [0]

    def nxt():
        turn[0] = (turn[0] + 1) % len(caches)
        return caches[turn[0]]

    def kern():
        kc, vc = nxt()[:2]
        return fa.flash_attention(q, kc, vc, **kw)

    def lib():
        return sdpa(qt, *nxt()[2:4])

    def lib_gqa():
        return sdpa(qt, *nxt()[4:6], enable_gqa=True)

    out.update({
        "ms_cold": cuda_ms(torch, kern, reps),
        # a second window where CUPTI handed back none (seen once on the
        # fp32 decode)
        "device_ms_cold": (device_ms(torch, kern, calls)
                           or device_ms(torch, kern, calls)),
        "library_ms_cold": cuda_ms(torch, lib, reps),
        "library_device_ms_cold": device_ms(torch, lib, calls),
        "library_gqa_device_ms_cold": (device_ms(torch, lib_gqa, calls)
                                       if gqa else None),
    })
    return out


#: the matmul phase: the decode-shaped rows (granite-3-2b's gate/up at M
#: rows: the batch of one decode step, one row and the stream path's
#: most), the bf16 sweep's rows at gate/up's K and N, and the bytes the
#: cold readings rotate over (three times the H100's 50 MB L2)
MATMUL_DECODE_ROWS = (LM_BATCH, 1, 16)
MATMUL_SWEEP_ROWS = (1, 4, 16, 32, 64, 128, 256)
MATMUL_COLD_BYTES = 150e6
#: each part's path on each lane (``select_path`` of the part's operands)
MATMUL_PATHS = {"prefill": {"bf16": "wgmma", "f32": "fma", "s8": "mma"},
                "decode": {"bf16": "stream", "f32": "stream",
                           "s8": "stream"}}
#: the decode rows' cold readings, also in the kernels line
MATMUL_COLD = ("ms_cold", "device_ms_cold", "library_ms_cold",
               "library_device_ms_cold")
MATMUL_ENTRIES = {"trim_matmul_wgmma_kernel": "wgmma",
                  "trim_matmul_stream_tc_kernel": "stream",
                  "trim_matmul_stream_fma_kernel": "stream",
                  "trim_matmul_stream_merge": "stream merge",
                  "trim_matmul_tc_kernel": "mma",
                  "trim_matmul_f32_kernel": "fma"}


def _log_matmul_build() -> None:
    """The matmul kernel's registers and spills per entry (demangled by
    the toolkit's ``cu++filt`` where it has one) from its ``-Xptxas -v``
    build log, and any ptxas note that it serialized wgmma."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import trim_matmul as mm

    text = _build.build_log(mm._LIB_NAME, mm._SOURCES) or ""
    lines = text.splitlines()
    names = [line.split("'")[1] for line in lines
             if "Compiling entry function" in line and "'" in line]
    filt = pathlib.Path(_build.find_nvcc()).parent / "cu++filt"
    shown = names
    if filt.is_file() and names:
        res = subprocess.run([str(filt), *names], capture_output=True,
                             text=True, timeout=60)
        if res.returncode == 0 and len(res.stdout.splitlines()) == len(names):
            # "void <unnamed>::name<args>(params)" -> "name<args>"
            shown = [n.split("::", 1)[-1].rsplit(">(", 1)[0] + (
                ">" if ">(" in n else "") for n in res.stdout.splitlines()]
    found = _ptxas_by_entry(text, dict(zip(names, shown)))
    fma = 0
    for name, show in zip(names, shown):
        path = next((v for k, v in MATMUL_ENTRIES.items() if k in name), "?")
        info = found.get(show)
        log(f"matmul kernel, {path} path, {show}: "
            f"{info or 'not in the log'}")
        if path == "fma":
            fma += 1
            if info is None or any(
                    int(v) for v in re.findall(r"(\d+) bytes spill", info)):
                fail(f"matmul kernel, fma path, {show}: not in the log, or "
                     f"spills ({info})")
    if not fma:
        fail("matmul kernel: no fma entry in the build log")
    for line in lines:
        if "wgmma" in line.lower() and "serializ" in line.lower():
            log(f"matmul kernel, ptxas: {line.strip()}")


def _matmul_cases(cfg):
    """(name, M, K, N): granite-3-2b's projections at a LM_BATCH x
    LM_PROMPT prefill (gate/up, down, q/o), its decode-shaped gate/up at
    M = LM_BATCH, then at 1 and 16 rows, then ragged shapes
    (``tests/test_kernels.py:107-128``'s ranges: M 1-200, K 1-120, N
    1-150, and its int8 (64, 96, 48))."""
    M, d, ff = LM_BATCH * LM_PROMPT, cfg.d_model, cfg.d_ff
    return ([("gate/up", M, d, ff), ("down", M, ff, d), ("q/o", M, d, d)]
            + [("decode" if m == LM_BATCH else f"decode M={m}", m, d, ff)
               for m in MATMUL_DECODE_ROWS]
            + [("ragged", 1, 1, 1), ("ragged", 7, 13, 5),
               ("ragged", 64, 96, 48), ("ragged", 200, 120, 150),
               ("ragged", 33, 7, 129), ("ragged", 129, 65, 257)])


def _matmul_part(name: str) -> str:
    return ("prefill" if not name.startswith("decode") else
            "decode" if name == "decode" else "decode rows")


def _matmul_check(torch, got, want, dtype, what: str, worst: dict, key):
    """Fail unless the kernel's ``got`` matches the plain ``want``: int8
    bit for bit, fp32 within rtol 1e-4 / atol 1e-4 x max|plain|, bf16
    within MATMUL_ROW_ULPS x 2^-7 of each row's max|plain|.  Returns
    max|got - want|."""
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{what}: {got.dtype} {tuple(got.shape)} vs plain "
             f"{want.dtype} {tuple(want.shape)}")
    err = (got.double() - want.double()).abs().max().item()
    if dtype == torch.int8:
        if not torch.equal(got, want):
            fail(f"{what}: kernel != plain (max diff {err:.3g})")
    elif dtype == torch.float32 and want.dtype == torch.float32:
        scale = want.abs().max().item()
        if not torch.allclose(got, want, rtol=1e-4, atol=1e-4 * scale):
            fail(f"{what}: max|kernel-plain| = {err:.3g} (max|plain| "
                 f"{scale:.3g}; rtol 1e-4, atol 1e-4 of it)")
    else:
        ulps = _row_ulps(got, want)
        worst[key] = max(ulps, worst.get(key, 0.0))
        if ulps > MATMUL_ROW_ULPS:
            fail(f"{what}: a row's max|kernel-plain| is {ulps:.3g} x 2^-7 "
                 f"of its max|plain| (limit {MATMUL_ROW_ULPS})")
    return err


def _matmul_cold(torch, mm, a, b, lib):
    """The decode readings with b cold in L2: calls rotating over enough
    copies of b to pass MATMUL_COLD_BYTES, each call taking the next;
    the kernel's (and ``lib``'s, where there is one) event and profiler
    device times a call."""
    n = max(2, -(-int(MATMUL_COLD_BYTES) // (b.numel() * b.element_size())))
    bs = [b.clone() for _ in range(n)]
    turn = [0]

    def nxt():
        turn[0] = (turn[0] + 1) % n
        return bs[turn[0]]

    calls = 4 * n
    out = {"cold_copies": n,
           "ms_cold": cuda_ms(torch, lambda: mm.trim_matmul(a, nxt()),
                              calls),
           "device_ms_cold": device_ms(torch, lambda: mm.trim_matmul(
               a, nxt()), calls),
           "library_ms_cold": None, "library_device_ms_cold": None}
    if lib is not None:
        out["library_ms_cold"] = cuda_ms(torch, lambda: lib(a, nxt()), calls)
        out["library_device_ms_cold"] = device_ms(
            torch, lambda: lib(a, nxt()), calls)
    del bs
    return out


def _matmul_sweep(torch, mm, b, reps: int, gen, dev, worst: dict):
    """bf16 at gate/up's K and N over MATMUL_SWEEP_ROWS rows: each path
    that takes the operands (stream up to 16 rows; wgmma and mma at every
    M), checked against the plain version and timed by its device time
    under ``torch.profiler`` (at a few rows the event times read the
    host), with ``torch.matmul`` beside it; logs where the paths cross."""
    sweep = {}
    calls = max(10, reps // 5)
    for M in MATMUL_SWEEP_ROWS:
        a = torch.randn((M, b.shape[0]), generator=gen, device=dev).to(
            torch.bfloat16)
        want = mm.trim_matmul_plain(a, b)
        row = {"auto": mm.select_path(a, b),
               "torch.matmul": device_ms(torch, lambda: torch.matmul(a, b),
                                         calls)}
        for path in ("stream", "wgmma", "mma"):
            if path == "stream" and M > mm.STREAM_ROWS:
                continue
            got = mm._launch(a, b, None, path)
            torch.cuda.synchronize()
            _matmul_check(torch, got, want, torch.bfloat16,
                          f"matmul sweep bf16 M={M} on {path}", worst,
                          ("sweep", M, path))
            row[path] = device_ms(torch, lambda: mm._launch(
                a, b, None, path), calls)
        sweep[M] = row
        log(f"matmul sweep bf16 (M, 2048) @ (2048, 8192) M={M}: auto "
            f"{row['auto']}; device ms " + ", ".join(
                f"{k} {_fmt(row[k])}" for k in ("stream", "wgmma", "mma",
                                                "torch.matmul") if k in row))

    def below(x, y):
        return [M for M in sweep if x in sweep[M] and None not in (
            sweep[M][x], sweep[M][y]) and sweep[M][x] < sweep[M][y]]

    log(f"matmul sweep: stream below wgmma at M in {below('stream', 'wgmma')}"
        f" (stream takes M <= {mm.STREAM_ROWS}); wgmma below mma at M in "
        f"{below('wgmma', 'mma')}")


def phase_matmul(torch, reps: int, prefill_reps: int):
    """The matmul kernel through ``ops.trim_matmul`` (the entry point) at
    granite-3-2b's full-width projection shapes in bf16, fp32 and int8,
    its launches counted from 0 around each part, in total and per path
    (the prefill-shaped three: wgmma in bf16, fma in fp32, mma in int8;
    the decode-shaped gate/up at LM_BATCH rows, then at 1 and 16 rows:
    the stream path on every lane); then held against its plain version
    (TF32 off) there and at ragged shapes: int8 bit for bit (int32 out),
    fp32 within rtol 1e-4 / atol 1e-4 x max|plain|, bf16 within
    MATMUL_ROW_ULPS x 2^-7 of each row's max|plain|; the stream path's
    two calls on the same inputs bit-equal.  Timed at the full-width
    shapes beside ``torch.matmul`` (cuBLAS) / ``torch._int_mm``
    (yardsticks the port never calls): ``reps`` calls each at the decode
    shapes (tens of microseconds), ``prefill_reps`` at the prefill
    projections (milliseconds); the host's issue time per call; at the
    decode shapes also with b cold in L2 (events and profiler device
    time, kernel and library); the bf16 sweep over MATMUL_SWEEP_ROWS
    rows, every path that takes each.  Returns one row per
    (shape, lane) at full width, each with the launches of its part."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels import trim_matmul as mm

    _log_matmul_build()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(4)
    cases = _matmul_cases(get_config(DENSE_ARCH))
    full = [c for c in cases if c[0] != "ragged"]
    rows, n, worst = [], 0, {}
    for lane, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32),
                        ("s8", torch.int8)):
        def rnd(*shape):
            if dtype == torch.int8:
                return torch.randint(-128, 128, shape, generator=gen,
                                     device=dev, dtype=torch.int8)
            return torch.randn(shape, generator=gen, device=dev).to(dtype)

        # the decode-shaped rows share gate/up's b, as a decode step does
        ins = {}
        for c in cases:
            b = (ins[full[0]][1] if c in full and c[0].startswith("decode")
                 else rnd(c[2], c[3]))
            ins[c] = (rnd(c[1], c[2]), b)
        outs, launches = {}, {}
        for part in ("prefill", "decode", "decode rows"):
            mine = [c for c in full if _matmul_part(c[0]) == part]
            mm.reset_launches()
            for c in mine:
                outs[c] = ops.trim_matmul(*ins[c])
            launches[part] = mm.LAUNCHES
            if launches[part] != len(mine):
                fail(f"matmul {lane} {part}: {launches[part]} launches for "
                     f"{len(mine)} entry-point calls")
            by = {k: v for k, v in mm.LAUNCHES_BY_PATH.items() if v}
            want_path = MATMUL_PATHS["prefill" if part == "prefill"
                                     else "decode"][lane]
            log(f"matmul {lane} {part}: launches by path {by}")
            if by != {want_path: len(mine)}:
                fail(f"matmul {lane} {part}: launches by path {by}, "
                     f"not {len(mine)} on {want_path}")
        torch.cuda.synchronize()
        lib_fn = (torch.matmul if dtype != torch.int8 else torch._int_mm)
        for c in cases:
            a, b = ins[c]
            got = outs[c] if c in outs else mm.trim_matmul(a, b)
            want = mm.trim_matmul_plain(a, b)
            torch.cuda.synchronize()
            what = f"matmul {lane} {c[0]} ({c[1]}, {c[2]}) @ ({c[2]}, {c[3]})"
            err = _matmul_check(torch, got, want, dtype, what, worst, c)
            n += 1
            if mm.select_path(a, b) == "stream":
                again = mm.trim_matmul(a, b)
                torch.cuda.synchronize()
                if not torch.equal(again.view(torch.uint8),
                                   got.view(torch.uint8)):
                    fail(f"{what}: two calls on the stream path differ")
            if c not in outs:
                continue
            _, M, K, N = c
            decode = c[0].startswith("decode")
            r = reps if decode else prefill_reps
            lib = None
            if dtype != torch.int8 or (M > 16 and K % 8 == 0 and N % 8 == 0):
                lib = cuda_ms(torch, lambda: lib_fn(a, b), r)
            nbytes = (M * K + K * N) * a.element_size() \
                + M * N * got.element_size()
            row = {
                "shape": c[0], "lane": lane, "mkn": (M, K, N),
                "part": _matmul_part(c[0]),
                "path": mm.select_path(a, b),
                "launches": launches[_matmul_part(c[0])],
                "max_abs_err": err, "row_ulps": worst.get(c),
                "ms": cuda_ms(torch, lambda: mm.trim_matmul(a, b), r),
                "plain_ms": cuda_ms(torch, lambda: mm.trim_matmul_plain(a, b),
                                    r),
                "library_ms": lib,
                "issue_ms": issue_ms(torch, lambda: mm.trim_matmul(a, b), r),
                "library_issue_ms": (issue_ms(torch, lambda: lib_fn(a, b), r)
                                     if lib is not None and decode else None),
                **bound(M * K * N, nbytes, integer=dtype == torch.int8,
                        peak=PEAK_BF16 if dtype == torch.bfloat16 else 0.0)}
            if c[0] == "q/o" and lane == "bf16":
                # the wgmma path's host cost beyond mma's: two tensor maps
                row["issue_ms_mma"] = issue_ms(torch, lambda: mm._launch(
                    a, b, None, "mma"), r)
            if decode:
                row.update(_matmul_cold(torch, mm, a, b, None if (
                    dtype == torch.int8) else lib_fn))
            rows.append(row)
        if lane == "bf16":
            _matmul_sweep(torch, mm, ins[full[0]][1], reps, gen, dev, worst)
        del ins, outs
        torch.cuda.empty_cache()
    log(f"matmul: kernel matches plain at {n} shapes x lanes (int8 bit for "
        f"bit, fp32 1e-4, bf16 per row {MATMUL_ROW_ULPS} x 2^-7 of "
        f"max|plain|: the worst bf16 row at {max(worst.values()):.3g})"
        + "; the stream path's two calls bit-equal")
    for r in rows:
        lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        cold = "" if "ms_cold" not in r else (
            f"; b cold in L2 ({r['cold_copies']} copies): ms "
            f"{r['ms_cold']:.4f} device_ms {_fmt(r['device_ms_cold'])}"
            + ("" if r["library_ms_cold"] is None else
               f", library ms {r['library_ms_cold']:.4f} device_ms "
               f"{_fmt(r['library_device_ms_cold'])}"))
        log(f"matmul {r['lane']:4s} {r['shape']:12s} (M, K, N) {r['mkn']} "
            f"path {r['path']} launches {r['launches']} ms {r['ms']:.4f} "
            f"plain_ms {r['plain_ms']:.4f} library_ms {lib} bound_ms "
            f"{r['bound_ms']:.4f} ({r['bound_by']}) err "
            f"{r['max_abs_err']:.3g} host issue ms {r['issue_ms']:.4f}"
            + ("" if r["library_issue_ms"] is None else
               f" (library {r['library_issue_ms']:.4f})")
            + ("" if "issue_ms_mma" not in r else
               f" (on mma {r['issue_ms_mma']:.4f})") + cold)
    for lane in ("bf16", "f32", "s8"):
        sel = [r for r in rows if r["lane"] == lane
               and r["part"] == "prefill"]
        lib = [r["library_ms"] for r in sel]
        log(f"matmul {lane} projections, sum of {len(sel)}: ms "
            f"{sum(r['ms'] for r in sel):.4f} library_ms "
            + ("null" if None in lib else f"{sum(lib):.4f}")
            + f" bound_ms {sum(r['bound_ms'] for r in sel):.4f}")
    return rows


def _ssd_macs(B, L, H, P, S, T) -> int:
    """Multiply-adds of the SSD in chunks of T rows, only on and below the
    diagonal of each (T, T) block: C.B^T and scores.x (T(T+1)/2 (S + P)
    per chunk), then C.h^T and the state update (2 T P S).  The count
    grows with T, so T = 1 (the recurrence: 2 P S + P + S per row) is the
    least work that computes y, and what the bound counts."""
    NC = -(-L // T)
    return B * H * NC * (T * (T + 1) // 2 * (S + P) + 2 * T * P * S)


def _ssd_kernel_macs(B, L, H, P, S, T, groups, tri) -> int:
    """Multiply-adds of the staged SSD kernel in chunks of T rows: C.B^T
    on and below the diagonal 16-row tiles (``tri`` elements a chunk)
    once per group, and per head the chunk's end state (T P S), C.h^T
    (T P S) and the scores times x (tri P).  Logged beside the bounds,
    never a bound: it grows with the kernel's own chunk."""
    NC = -(-L // T)
    return B * NC * (groups * tri * S + H * (2 * T * P * S + tri * P))


def _ssd_tc_macs(B, L, H, P, S, bf16: bool) -> int:
    """Tensor-core multiply-adds that the least work (``_ssd_macs`` at
    T = 1) needs in the lane's precision: every product three times in
    fp32 (3xTF32); in bf16 C.B^T (S a row and head, both operands bf16)
    once and the rest, where one operand is computed in fp32, twice."""
    least = _ssd_macs(B, L, H, P, S, 1)
    return 2 * least - B * L * H * S if bf16 else 3 * least


def _ssd_inputs(torch, gen, dev, B, L, H, P, S, groups=None,
                repeat=False):
    """fp32 inputs in ``tests/test_ssd_kernel.py``'s ranges: x, B, C, D ~
    N(0, 1), dt ~ U(1e-3, 0.1), A ~ -U(0.3, 2); B/C of ``groups`` groups
    expanded over H (stride 0) when given, else per head; with ``repeat``,
    the ``groups`` groups repeated over H // groups heads each as one
    tensor (B, L, H, S), per head (head h reads group h // (H // groups),
    as the mixer's ``ssd_chunked`` groups them)."""
    u = lambda *shape: torch.rand(shape, generator=gen, device=dev)
    nrm = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    Bm, Cm = nrm(B, L, groups or H, S), nrm(B, L, groups or H, S)
    if groups and repeat:
        Bm, Cm = (t.repeat_interleave(H // groups, dim=2) for t in (Bm, Cm))
    elif groups:
        Bm, Cm = Bm.expand(B, L, H, S), Cm.expand(B, L, H, S)
    return (nrm(B, L, H, P), 1e-3 + u(B, L, H) * (0.1 - 1e-3),
            -(0.3 + u(H) * 1.7), Bm, Cm, nrm(H))


def _ssd_bytes(args) -> int:
    """Bytes one call must move: x, B, C (one group's where expanded with
    stride 0 over the heads) and dt read once, y written once."""
    x, dt, A, Bm, Cm, D = args
    B, L, H, P = x.shape
    heads = lambda t: 1 if H > 1 and t.stride(2) == 0 else H
    bc = sum(B * L * heads(t) * t.shape[3] for t in (Bm, Cm))
    return (2 * B * L * H * P + bc) * x.element_size() + B * L * H * 4


def _ssd_bf16(args):
    """x, B and C rounded to bf16; an expanded B/C stays a stride-0 view
    of its rounded group."""
    def bf(t):
        if t.dim() == 4 and t.shape[2] > 1 and t.stride(2) == 0:
            return t[:, :, :1].bfloat16().expand(t.shape)
        return t.bfloat16()
    x, dt, A, Bm, Cm, D = args
    return bf(x), dt, A, bf(Bm), bf(Cm), D


def _ssd_stage(key: str):
    """The SSD kernel's stage that a profiled kernel name belongs to, or
    None."""
    return next((st for st in ("cb", "state", "pass", "out")
                 if f"ssd_{st}_kernel" in key), None)


def _mixer_ssd_inputs(torch, dev):
    """The (x, dt, A, B, C, D, chunk) that full-width mamba2-130m's first
    mixer passes to ``ssd_chunked`` in an fp32 prefill of a LM_BATCH x
    LM_PROMPT prompt (seed-0 weights), B/C (one group) expanded over the
    heads as views."""
    import numpy as np

    import repro_torch.nn.mamba as mamba
    from repro_torch.configs import get_config
    from repro_torch.nn.models import build_model

    cfg = get_config(LM_ARCH).with_overrides(dtype=torch.float32)
    model = build_model(cfg)
    params = model.init(0, dev)
    toks = torch.as_tensor(np.random.default_rng(5).integers(
        0, cfg.vocab, (LM_BATCH, LM_PROMPT)), device=dev)
    seen, plain = [], mamba.ssd_chunked

    def grab(*args, **kw):
        if not seen:
            seen.append((args, kw))
        return plain(*args, **kw)

    mamba.ssd_chunked = grab
    try:
        with torch.inference_mode():
            model.prefill(params, toks, model.init_cache(
                LM_BATCH, LM_PROMPT, dtype=cfg.dtype, device=dev))
    finally:
        mamba.ssd_chunked = plain
    (x, dt, A, Bm, Cm, D), kw = seen[0]
    H = x.shape[2]
    expand = lambda t: t.expand(*t.shape[:2], H, t.shape[3])
    return x, dt, A, expand(Bm), expand(Cm), D, kw["chunk"]


def _ssd_full_rows(torch, ks, f32, CS, reps, label, groups, vs32=True):
    """The entry point at one full-width shape in fp32 and bf16 (x/B/C
    rounded): launches counted from 0 around each call (one each, or the
    phase fails), then held against the plain version (fp32 within
    SSD_FULL_TOL x max|plain|; bf16 within 5e-2 of the bf16 plain version
    and, with ``vs32``, of the fp32 one), timed beside the plain version
    and both bounds, with a device-time split per stage.  The bf16 plain
    version's own distance from the fp32 one (the inputs' rounding) is
    kept beside the kernel's.  ``groups``: the C.B^T groups the kernel
    computes (1 expanded, else H).  One row per dtype."""
    x = f32[0]
    B, L, H, P = x.shape
    S = f32[3].shape[3]
    full = {torch.float32: f32, torch.bfloat16: _ssd_bf16(f32)}
    ys, launches = {}, {}
    for dt in full:
        ks.LAUNCHES = 0
        ys[dt] = ks.trim_ssd(*full[dt], chunk=CS)
        launches[dt] = ks.LAUNCHES
        if launches[dt] != 1:
            fail(f"ssd {label} {dt}: {launches[dt]} launches for one "
                 "entry-point call")
    torch.cuda.synchronize()
    w32 = ks.trim_ssd_plain(*f32, chunk=CS)
    scale = w32.abs().max().item()
    rows = []
    for dt, y in ys.items():
        name = str(dt).replace("torch.", "")
        want = w32 if dt == torch.float32 else ks.trim_ssd_plain(
            *full[dt], chunk=CS)
        err = (y.float() - want.float()).abs().max().item()
        if y.shape != w32.shape or y.dtype != dt \
                or not bool(torch.isfinite(y).all()):
            fail(f"ssd {label} {name}: {y.dtype} {tuple(y.shape)}, or not "
                 "finite")
        if dt == torch.float32 and err > SSD_FULL_TOL * scale:
            fail(f"ssd {label} fp32: max|kernel-plain| {err:.3g} > "
                 f"{SSD_FULL_TOL} x max|plain| {scale:.3g}")
        err32 = (y.float() - w32).abs().max().item()
        plain32 = (want.float() - w32).abs().max().item()
        if dt == torch.bfloat16:
            for ref_y, what in ((want, "bf16 plain"),
                                (w32, "fp32 plain"))[:1 + vs32]:
                if not torch.allclose(y.float(), ref_y.float(), rtol=5e-2,
                                      atol=5e-2):
                    fail(f"ssd {label} bf16: max|kernel - {what}| "
                         f"{(y.float() - ref_y.float()).abs().max():.3g} "
                         "(5e-2)")
        del want
        args = full[dt]
        nbytes = _ssd_bytes(args)
        rows.append({
            "dtype": name, "label": label, "shape": (B, L, H, P, S, CS),
            "launches": launches[dt], "max_abs_err": err, "err32": err32,
            "plain32": plain32,
            "rel_err": err / scale,
            "ms": cuda_ms(torch, lambda: ks.trim_ssd(*args, chunk=CS), reps),
            "plain_ms": cuda_ms(torch, lambda: ks.trim_ssd_plain(
                *args, chunk=CS), max(2, reps // 10)),
            "library_ms": None,
            **bound(_ssd_macs(B, L, H, P, S, 1), nbytes, integer=False,
                    peak=PEAK_BF16 if dt == torch.bfloat16 else 0.0)})
        bf16 = dt == torch.bfloat16
        tc = bound(_ssd_tc_macs(B, L, H, P, S, bf16), nbytes, integer=False,
                   peak=PEAK_BF16 if bf16 else PEAK_TF32)
        rows[-1].update(
            own_gflop=2.0 * _ssd_kernel_macs(
                B, L, H, P, S, ks.KERNEL_CHUNK, groups, ks.CB_FLOATS) / 1e9,
            tc_bound_ms=tc["bound_ms"], tc_bound_by=tc["bound_by"],
            stage_ms=device_ms(torch, lambda: ks.trim_ssd(*args, chunk=CS),
                               10, by=_ssd_stage))
    return rows


def _log_ssd_rows(rows) -> None:
    for r in rows:
        old = ("" if "parent_ms" not in r else
               f" parent_ms {r['parent_ms']:.4f} (this checkout "
               f"{r['cmp_ms']:.4f}, {r['cmp_ms'] / r['parent_ms']:.4f}x the "
               "parent's, same run, same inputs)")
        log(f"ssd {r['label']} {r['dtype']:8s} {r['shape']} ms "
            f"{r['ms']:.4f} plain_ms {r['plain_ms']:.4f} library_ms none "
            f"bound_ms {r['bound_ms']:.4f} ({r['bound_by']}) tc_bound_ms "
            f"{r['tc_bound_ms']:.4f} ({r['tc_bound_by']}) err "
            f"{r['max_abs_err']:.3g} (rel {r['rel_err']:.3g}); stages "
            "(profiler device ms a call): " + (", ".join(
                f"{k} {v:.4f}" for k, v in r["stage_ms"].items())
                or "not measured") + old)


def phase_ssd(torch, reps: int, parent=None):
    """The SSD scan kernel through ``trim_ssd`` (the entry point) at
    mamba2-130m's full-width prefill shape, x (4, 4096, 24, 64), B/C
    (4, 4096, 1, 128) expanded over the 24 heads, and at
    jamba-1.5-large's, x (4, 4096, 128, 128), B/C (4, 4096, 128, 128)
    repeated from 8 groups (per head: C.B^T once a head), chunk 256, in
    fp32 and bf16 (x/B/C), its launches counted from 0 around each of
    those calls; then held against its plain version (TF32 off): at
    SSD_SMOKE_CASES on every SSD_SMOKE_SEED fp32 within 2e-5, at full width
    and on the first mixer's real inputs fp32 within SSD_FULL_TOL of
    max|plain|, and bf16 within 5e-2 of the bf16 plain version and, at
    mamba2-130m's width and the small cases, of the fp32 one.  Timed at
    full width beside its two bounds, both on the least work
    (``bound_ms`` at the peak for the inputs' type, the fp32 FMA's or
    the bf16 tensor cores', or the bytes; ``tc_bound_ms``, logged only,
    as the lane's tensor-core passes at their peak); no single PyTorch
    call computes the scan (no yardstick).
    With ``parent`` (a checkout of the parent commit), the mamba2-130m
    shape timed there and here in turns (parent, this, this, parent) on
    the same inputs.  Returns one row per shape and dtype at full
    width."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import trim_ssd as ks
    from repro_torch.nn.models import build_model

    dev = torch.device("cuda", 0)
    worst = 0.0
    for case, seed, groups in itertools.product(
            SSD_SMOKE_CASES, SSD_SMOKE_SEEDS, (None, 1)):
        gen = torch.Generator(device=dev).manual_seed(seed)
        args = _ssd_inputs(torch, gen, dev, *case[:5], groups=groups)
        got = ks.trim_ssd(*args, chunk=case[5])
        want = ks.trim_ssd_plain(*args, chunk=case[5])
        bf = _ssd_bf16(args)
        got16 = ks.trim_ssd(*bf, chunk=case[5])
        want16 = ks.trim_ssd_plain(*bf, chunk=case[5])
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        worst = max(worst, err)
        if not torch.allclose(got, want, rtol=2e-5, atol=2e-5):
            fail(f"ssd {case} seed {seed} groups {groups or case[2]} fp32: "
                 f"max|kernel-plain| {err:.3g} (2e-5)")
        for ref_y, what in ((want16, "bf16 plain"), (want, "fp32 plain")):
            if not torch.allclose(got16.float(), ref_y.float(), rtol=5e-2,
                                  atol=5e-2):
                fail(f"ssd {case} seed {seed} bf16: max|kernel - {what}| "
                     f"{(got16.float() - ref_y.float()).abs().max():.3g} "
                     "(5e-2)")
    gen = torch.Generator(device=dev).manual_seed(6)

    dims = build_model(get_config(LM_ARCH)).spec.dims
    B, L, H, P, S, CS = (LM_BATCH, LM_PROMPT, dims.n_heads, dims.headdim,
                         dims.d_state, dims.chunk)
    rows = _ssd_full_rows(
        torch, ks, _ssd_inputs(torch, gen, dev, B, L, H, P, S, groups=1),
        CS, reps, LM_ARCH, 1)
    if parent is not None:
        # the same tool on each checkout, in turns
        before, *mine, after = (_timing_tool("ssd_times.py", c)["rows"]
                                for c in (parent, ROOT, ROOT, parent))
        for r in rows:
            r["parent_ms"] = (before[r["dtype"]] + after[r["dtype"]]) / 2
            r["cmp_ms"] = sum(m[r["dtype"]] for m in mine) / 2
            log(f"ssd {LM_ARCH} {r['dtype']} in turns: parent "
                f"{before[r['dtype']]:.4f}, this {mine[0][r['dtype']]:.4f}, "
                f"this {mine[1][r['dtype']]:.4f}, parent "
                f"{after[r['dtype']]:.4f} ms; within 5% of the parent's: "
                f"{r['cmp_ms'] <= 1.05 * r['parent_ms']}")
    else:
        log(f"ssd {LM_ARCH}: the parent's times not measured (run with "
            "--parent DIR, a checkout of the parent commit)")
    real = _mixer_ssd_inputs(torch, dev)
    x, CSr = real[0], real[6]
    got = ks.trim_ssd(*real[:6], chunk=CSr)
    want = ks.trim_ssd_plain(*real[:6], chunk=CSr)
    torch.cuda.synchronize()
    err, scale = (got - want).abs().max().item(), want.abs().max().item()
    if not bool(torch.isfinite(got).all()) or err > SSD_FULL_TOL * scale:
        fail(f"ssd on the first mixer's inputs: max|kernel-plain| {err:.3g} "
             f"> {SSD_FULL_TOL} x max|plain| {scale:.3g}")
    log(f"ssd: kernel matches plain at {len(SSD_SMOKE_CASES)} cases x "
        f"seeds {SSD_SMOKE_SEEDS} x B/C per head and one group expanded "
        f"(fp32 2e-5, worst max|kernel-plain| {worst:.3g}; bf16 5e-2; P "
        f"up to 200, S up to 256); "
        f"{LM_ARCH} full width "
        f"fp32 within {rows[0]['rel_err']:.3g} of max|plain| (limit "
        f"{SSD_FULL_TOL}), bf16 {rows[1]['max_abs_err']:.3g} from the bf16 "
        f"plain and {rows[1]['err32']:.3g} from the fp32 plain (the bf16 "
        f"plain {rows[1]['plain32']:.3g} from the fp32 plain); first "
        f"mixer's real inputs (x {tuple(x.shape)} strides {x.stride()}, B/C "
        f"stride over heads {real[3].stride(2)}) within {err / scale:.3g} "
        f"of max|plain| {scale:.3g}; launches on the entry-point calls "
        f"{[r['launches'] for r in rows]}")
    log(f"ssd: both bounds count the least work, "
        f"{2.0 * _ssd_macs(B, L, H, P, S, 1):.4g} flop (chunk 1) at "
        f"{LM_ARCH}'s width: bound_ms at the inputs' peak (fp32: the FMA "
        "peak; bf16: the tensor cores'), or the bytes, tc_bound_ms "
        "(logged here only) as the tensor-core passes the lane needs "
        "(3xTF32: 3 at the TF32 peak; bf16: 2 where an operand is computed "
        "in fp32, C.B^T once, at the bf16 peak); the kernel's own chunk of "
        f"{ks.KERNEL_CHUNK} with C.B^T once per group does "
        f"{rows[0]['own_gflop'] * 1e9:.4g} flop, the plain version's chunk "
        f"of {CS} {2.0 * _ssd_macs(B, L, H, P, S, CS):.4g}")
    del real, got, want

    # jamba-1.5-large's mixer: 128 heads of P = 128, S = 128, B/C of 8
    # groups repeated over the heads, per head as `trim_ssd_pallas` takes
    hd = build_model(get_config(HYBRID_ARCH)).spec.dims
    Hj, Pj, Sj, Gj = hd.n_heads, hd.headdim, hd.d_state, hd.n_groups
    p = ks.plan(B, L, Hj, Pj, Sj)
    jrows = _ssd_full_rows(
        torch, ks, _ssd_inputs(torch, gen, dev, B, L, Hj, Pj, Sj,
                               groups=Gj, repeat=True),
        hd.chunk, reps, HYBRID_ARCH, Hj, vs32=False)
    NC, tri = -(-L // ks.KERNEL_CHUNK), ks.CB_FLOATS
    cb_head = 2.0 * B * NC * Hj * tri * Sj
    log(f"ssd {HYBRID_ARCH}: x ({B}, {L}, {Hj}, {Pj}), B/C ({B}, {L}, {Hj}, "
        f"{Sj}) repeated from {Gj} groups; {p.p_tiles} P tiles x "
        f"{p.s_tiles} S tile, states {p.states} fp32 "
        f"({4 * B * NC * Hj * p.states[3] * p.states[4] / 1e9:.3f} GB), "
        f"grids (cb, state, pass, out) {p.grids}; fp32 within "
        f"{jrows[0]['rel_err']:.3g} of max|plain| (limit {SSD_FULL_TOL}), "
        f"bf16 {jrows[1]['max_abs_err']:.3g} from the bf16 plain (limit "
        f"5e-2) and {jrows[1]['err32']:.3g} from the fp32 plain, where the "
        f"bf16 plain lies {jrows[1]['plain32']:.3g} from it (the inputs' "
        f"rounding to bf16); the per-head C.B^T "
        f"costs {cb_head:.4g} flop, {Hj // Gj}x a grouped one's "
        f"{cb_head * Gj / Hj:.4g} (the kernel's own work "
        f"{jrows[0]['own_gflop'] * 1e9:.4g} flop; least work "
        f"{2.0 * _ssd_macs(B, L, Hj, Pj, Sj, 1):.4g}); cb stage "
        + ", ".join(f"{r['dtype']} {r['stage_ms'].get('cb', float('nan')):.4f} ms"
                    for r in jrows))
    rows += jrows
    _log_ssd_rows(rows)
    return rows


def _lm_counters():
    """The launch counters of the LM path's kernels, by kernel name."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import trim_conv1d as k1d

    return {"trim_conv1d": k1d, "flash_attention": fa}


def _lm_inputs(torch, model, dev):
    """The served batch of ``model``'s family, as its launcher or the JAX
    package's input specs (``repro/launch/specs.py:59-61``) shape it at
    batch LM_BATCH: LM_PROMPT seeded tokens; for the vlm family the
    config's seeded patch embeddings (``extra_embeds``) and the rest of
    the LM_PROMPT positions as text; for the encdec family the launcher's
    encdec arm: a seeded source of LM_PROMPT frames, a bos of zeros as
    the target prompt.  Returns (batch, a function making a fresh cache,
    the first decode position)."""
    import numpy as np

    cfg = model.cfg
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab, (LM_BATCH, LM_PROMPT))
    if cfg.family == "encdec":
        src = rng.normal(size=(LM_BATCH, LM_PROMPT, cfg.d_model))
        batch = {"src_embeds": torch.as_tensor(src, dtype=cfg.dtype,
                                               device=dev),
                 "tokens": torch.zeros((LM_BATCH, 1), dtype=torch.long,
                                       device=dev)}
        return batch, lambda: model.init_cache(
            LM_BATCH, LM_PROMPT + LM_GEN, cross_len=LM_PROMPT,
            dtype=cfg.dtype, device=dev), 1
    batch = {"tokens": torch.as_tensor(prompts, device=dev)}
    if cfg.family == "vlm":
        n = cfg.frontend_tokens
        extra = rng.normal(size=(LM_BATCH, n, cfg.d_model))
        batch = {"tokens": batch["tokens"][:, :LM_PROMPT - n],
                 "extra_embeds": torch.as_tensor(extra, dtype=cfg.dtype,
                                                 device=dev)}
    return batch, lambda: model.init_cache(
        LM_BATCH, LM_PROMPT + LM_GEN, dtype=cfg.dtype, device=dev), LM_PROMPT


def _lm_launches(cfg, steps: int) -> dict:
    """{kernel: (launches in one prefill, launches in ``steps`` decode
    steps)} of the LM path: the conv1d kernel once per layer in the ssm
    family's prefill; the flash kernel once per attention layer in the
    prefill and in each step, and in the encdec family once per encoder
    layer and twice per decoder layer (self and cross) in the prefill and
    twice per decoder layer in each step."""
    L = cfg.n_layers
    if cfg.family == "ssm":
        return {"trim_conv1d": (L, 0), "flash_attention": (0, 0)}
    if cfg.family == "encdec":
        return {"trim_conv1d": (0, 0),
                "flash_attention": (cfg.n_enc_layers + 2 * L, 2 * L * steps)}
    return {"trim_conv1d": (0, 0), "flash_attention": (L, L * steps)}


def _lm_roles(cfg) -> tuple:
    """The flash launches of :func:`_lm_launches` by the attention call
    that makes them, (in one prefill, in one decode step): ``encoder``
    (the encdec family's non-causal stack), ``self`` (a causal stack's
    self-attention) and ``cross`` (a decoder layer's cross-attention);
    roles with no launch left out."""
    L = cfg.n_layers
    if cfg.family == "ssm":
        return {}, {}
    if cfg.family == "encdec":
        return ({"encoder": cfg.n_enc_layers, "self": L, "cross": L},
                {"self": L, "cross": L})
    return {"self": L}, {"self": L}


class FlashRoles:
    """While entered, tallies the flash launches made inside each call of
    the layer stacks' ``attention`` (``nn.blocks.attention``, wrapped for
    the time) by role: ``cross`` (a ``cross_kv`` call), ``encoder`` (mode
    "encoder") or ``self``.  Launches recorded into a CUDA graph (a call
    while the stream captures) go to ``replay``, one replay's; the rest
    to ``calls``.  The counts are the wrapper's own counter read around
    each call, so a launch outside the stacks' attention is in neither."""

    def __init__(self, torch):
        self.torch = torch
        self.calls, self.replay = {}, {}

    def __enter__(self):
        from repro_torch.kernels import flash_attention as fa
        from repro_torch.nn import blocks

        inner, capturing = blocks.attention, \
            self.torch.cuda.is_current_stream_capturing

        def attention(*args, **kw):
            role = ("cross" if kw.get("cross_kv") is not None else
                    "encoder" if kw.get("mode") == "encoder" else "self")
            before = fa.LAUNCHES
            out = inner(*args, **kw)
            into = self.replay if capturing() else self.calls
            into[role] = into.get(role, 0) + fa.LAUNCHES - before
            return out

        self._inner = inner
        blocks.attention = attention
        return self

    def __exit__(self, *exc):
        from repro_torch.nn import blocks

        blocks.attention = self._inner
        return False


#: the flash launches of each LM serve phase by role, by arch:
#: {"prefill": {role: n}, "replay": {role: n}, "steps": replays}
FLASH_ROLES: dict = {}


def phase_lm_serve(torch, arch: str, n_layers: int = 0):
    """Full-width ``arch`` served in bf16 through the launcher's functions
    (its depth cut to ``n_layers`` where given, logged as a cut) on the
    batch :func:`_lm_inputs` makes: one prefill, then greedy decode,
    twice: once with the eager decode step (the reading of the earlier
    slices) and once through the decode step captured as a CUDA graph
    (``launch.serve.decode_executable``), each after its own prefill into
    a fresh cache.  Every LM kernel's launches are counted from 0 around
    the prefill and around the graph's decode run and must be
    :func:`_lm_launches`' (per replay: the launches the capture recorded,
    held once against the flash kernels ``torch.profiler`` sees in
    replays); the flash launches by role (:class:`FlashRoles`) must be
    :func:`_lm_roles`', kept in FLASH_ROLES.  The graph's greedy tokens
    must equal the eager run's, and then, from a third prefill, its
    logits the eager step's at every step, bit for bit: on two caches
    where a second one fits in the free memory, else (llava-next-34b:
    64 GiB of bf16 weights) on the graph's cache alone
    (:func:`_replay_vs_eager_one_cache`).  The encdec family's prefill is
    split by the profiler into its encoder and the rest.  An arch with
    MoE layers is
    also served eagerly a second time from its own prefill, whose logits
    and tokens must equal the first run's bit for bit, and logs the
    (token, choice) slots its MoE layers drop past capacity in one
    prefill and one decode step.  Returns {kernel: (prefill launches,
    decode launches)}."""
    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.distributed.steps import make_decode_step
    from repro_torch.launch.serve import (decode_executable,
                                          prefill_executable, run_decode,
                                          run_prefill)
    from repro_torch.nn.models import build_model
    from repro_torch.serve import ServeEngine

    # the earlier phases' engines sit in reference cycles (engine and
    # server) with their params until the collector runs: collect them,
    # so the memory readings below are this phase's own
    gc.collect()
    torch.cuda.empty_cache()
    dev = torch.device("cuda", 0)
    cfg = get_config(arch)
    if n_layers:
        log(f"lm serve {arch}: depth cut from {cfg.n_layers} to {n_layers} "
            "layers (one period of its schedule), every width as published")
        cfg = cfg.with_overrides(n_layers=n_layers)
    model = build_model(cfg)
    steps = LM_GEN - 1
    want_launches = _lm_launches(cfg, steps)
    counters = _lm_counters()
    t0 = time.perf_counter()
    params = model.init(0, dev)
    batch0, cache, pos0 = _lm_inputs(torch, model, dev)
    shapes = {k: tuple(v.shape) for k, v in batch0.items()}

    eng = ServeEngine(name=f"lm-{cfg.name}", buckets=(LM_BATCH,), device=dev)
    prefill = prefill_executable(eng, model, params, batch0, cache())
    torch.cuda.synchronize()
    log(f"lm serve: {cfg.name} ({cfg.param_count_estimate()} params, "
        f"{cfg.active_param_count_estimate()} active a token, {cfg.dtype}) "
        f"init + warm prefill in {time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated(dev) / 2**30:.3f} GiB allocated; "
        f"prefill batch {shapes}, decode from position {pos0}")

    # -- eager decode: the earlier slices' reading, in this run
    eager_step = torch.inference_mode()(make_decode_step(model))
    torch.cuda.reset_peak_memory_stats(dev)
    logits, c_e, _ = run_prefill(prefill, params, batch0, cache(), dev)
    peak_pre = torch.cuda.max_memory_allocated(dev)
    tok = logits.argmax(-1)
    eager_step(params, tok, tree_map(torch.clone, c_e), pos0)  # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    toks_e, c_e, eager_s, finite_e = run_decode(
        eager_step, params, tok, c_e, pos0, steps, dev)
    peak_dec_e = torch.cuda.max_memory_allocated(dev)
    eager_prof = _profile(torch, f"lm {arch} eager decode step",
                          eager_s * 1e3 / steps,
                          lambda: [eager_step(params, tok, c_e, pos0)
                                   for _ in range(4)], calls=4)
    del c_e
    torch.cuda.synchronize()
    if cfg.n_experts:
        _moe_twice(torch, arch, prefill, eager_step, params, batch0, cache,
                   logits, toks_e, steps, dev)

    # -- the served path: prefill, then the captured decode step
    torch.cuda.reset_peak_memory_stats(dev)
    for m in counters.values():
        m.LAUNCHES = 0
    roles = FlashRoles(torch)
    base = torch.cuda.memory_allocated(dev)
    with roles:
        logits, c, prefill_s = run_prefill(prefill, params, batch0, cache(),
                                           dev)
    n_prefill = {k: m.LAUNCHES for k, m in counters.items()}
    pre_roles = dict(roles.calls)
    if logits.shape != (LM_BATCH, cfg.vocab) or \
            not bool(torch.isfinite(logits).all()):
        fail(f"lm serve {arch}: prefill logits {tuple(logits.shape)} not "
             "finite or of the wrong shape")
    tok = logits.argmax(-1)
    peak_pre_g = torch.cuda.max_memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    reserved = torch.cuda.memory_reserved(dev)
    t0 = time.perf_counter()
    with roles:
        decode = decode_executable(eng, model, params, tok, c, pos0)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    pool = torch.cuda.memory_reserved(dev) - reserved
    for m in counters.values():
        m.LAUNCHES = 0
    toks, c, decode_s, finite = run_decode(
        decode, params, tok, c, pos0, steps, dev)
    n_decode = {k: m.LAUNCHES for k, m in counters.items()}
    peak_dec = torch.cuda.max_memory_allocated(dev)
    peak, peak_e = max(peak_pre_g, peak_dec), max(peak_pre, peak_dec_e)
    log(f"lm serve {arch}: batch {LM_BATCH}, prompt {LM_PROMPT}: prefill "
        f"{prefill_s * 1e3:.3f} ms; decode (CUDA graph) "
        f"{LM_BATCH * steps / decode_s:.3f} tok/s "
        f"({decode_s * 1e3 / steps:.3f} ms per step, {steps} steps); eager "
        f"decode {LM_BATCH * steps / eager_s:.3f} tok/s "
        f"({eager_s * 1e3 / steps:.3f} ms per step); peak device memory "
        f"{peak / 2**30:.3f} GiB with the graph (eager "
        f"{peak_e / 2**30:.3f} GiB; the prefill's {peak_pre_g / 2**30:.3f} "
        f"and {peak_pre / 2**30:.3f}, the capture and decode's "
        f"{peak_dec / 2**30:.3f}, the eager decode's "
        f"{peak_dec_e / 2**30:.3f}), the capture in {capture_s:.3f} s "
        f"reserving {pool / 2**30:.3f} GiB more (its pool, and the warm "
        "call's copy of the cache, freed to the cache); launches in the "
        "prefill "
        f"{n_prefill}, in decode {n_decode} (per replay "
        f"{decode.launches}); sample "
        f"{torch.stack([tok] + toks, 1)[0, :8].tolist()}")
    if not (finite and finite_e):
        fail(f"lm serve {arch}: non-finite decode logits")
    for k, (pre, dec) in want_launches.items():
        if (n_prefill[k], n_decode[k]) != (pre, dec):
            fail(f"lm serve {arch}: {k} launched {n_prefill[k]} times in "
                 f"the prefill and {n_decode[k]} in {steps} decode steps "
                 f"(expected {pre} and {dec})")
    if decode.launches.get("flash_attention", 0) * steps != \
            n_decode["flash_attention"]:
        fail(f"lm serve {arch}: {decode.launches} launches per replay "
             f"against {n_decode} in {steps} replays")
    if (pre_roles, roles.replay) != _lm_roles(cfg):
        fail(f"lm serve {arch}: flash launches by role {pre_roles} in the "
             f"prefill and {roles.replay} per replay (expected "
             f"{_lm_roles(cfg)})")
    FLASH_ROLES[arch] = {"prefill": pre_roles, "replay": roles.replay,
                         "steps": steps}
    if not torch.equal(torch.stack(toks), torch.stack(toks_e)):
        fail(f"lm serve {arch}: the graph's greedy tokens differ from the "
             "eager decode's")
    if set(eng.compile_counts.values()) != {1} or \
            set(eng.capture_counts.values()) != {1}:
        fail(f"lm serve {arch}: executables built {eng.compile_counts}, "
             f"captured {eng.capture_counts}")
    CAPTURES[f"lm {arch}"] = dict(eng.capture_counts)
    # where the device time goes: one profiled prefill and 4 profiled
    # replays, their kernel time set against the unprofiled wall times
    # above (the profiler's own overhead stays out of the share)
    pre_prof = _profile(torch, f"lm {arch} prefill", prefill_s * 1e3,
                        lambda: prefill(params, batch0, c))
    if pre_prof is not None:
        flash = {k: v for k, v in pre_prof["kernel_ms"].items()
                 if "flash_" in k}
        log(f"lm serve {arch}: prefill wall {prefill_s * 1e3:.3f} ms; flash "
            f"device time {sum(flash.values()):.3f} ms in the profiled "
            f"prefill over "
            f"{sum(pre_prof['kernels'][k] for k in flash)} launches "
            f"({', '.join(sorted(set(re.findall(r'flash_[a-z_0-9]+', ' '.join(flash)))))})")
    if cfg.family == "encdec":
        _encoder_split(torch, arch, model, params, batch0, prefill_s,
                       pre_prof)
    prof = _profile(torch, f"lm {arch} decode step (replay)",
                    decode_s * 1e3 / steps,
                    lambda: [decode(params, tok, c, pos0)
                             for _ in range(4)], calls=4, tries=3)
    _hold_replay_launches(torch, f"lm serve {arch}",
                          lambda: [decode(params, tok, c, pos0)
                                   for _ in range(4)], 4, decode.launches)
    log(f"lm serve {arch}: decode step {decode_s * 1e3 / steps:.3f} ms with "
        f"the graph, {eager_s * 1e3 / steps:.3f} ms eager; device busy "
        f"{_fmt(prof and prof['busy'])} / "
        f"{_fmt(eager_prof and eager_prof['busy'])} ms, idle share "
        f"{_fmt(prof and prof['idle'])} / "
        f"{_fmt(eager_prof and eager_prof['idle'])}")

    # the replay against the eager step from one more prefill: on two
    # caches where a second cache and a prefill's transients (the served
    # prefill's peak above what was allocated before it) fit in the free
    # memory with CACHE_HEADROOM to spare, else on the graph's cache alone
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info(dev)[0]
    need = peak_pre_g - base + CACHE_HEADROOM
    log(f"lm serve {arch}: {free / 2**30:.3f} GiB free for the replay check, "
        f"{need / 2**30:.3f} GiB needed for a second cache: "
        + ("two caches" if need <= free else "one cache"))
    if need > free:
        _replay_vs_eager_one_cache(torch, arch, prefill, decode, eager_step,
                                   params, batch0, c, tok, pos0, steps, dev)
        return {k: (n_prefill[k], n_decode[k]) for k in counters}
    # two caches: the graph's takes the prefill's state, the eager step a
    # copy of it, and each runs on its own
    _, fresh, _ = run_prefill(prefill, params, batch0, cache(), dev)
    with torch.inference_mode():  # the prefill's caches are inference tensors
        for dst, src in zip(tree_leaves(c), tree_leaves(fresh)):
            dst.copy_(src)
    tok_g = tok_e = tok
    pos = torch.full((), pos0, dtype=torch.long, device=dev)
    for i in range(steps):
        got, _ = decode(params, tok_g, c, pos)
        want, fresh = eager_step(params, tok_e, fresh, pos0 + i)
        if not torch.equal(got, want):
            fail(f"lm serve {arch}: step {i}: the replay's logits differ "
                 "from the eager step's (max|diff| "
                 f"{(got - want).abs().max().item():.3g})")
        tok_g, tok_e = got.argmax(-1), want.argmax(-1)
        pos += 1
    log(f"lm serve {arch}: {steps} replayed decode steps bit-equal to the "
        "eager step's logits")
    return {k: (n_prefill[k], n_decode[k]) for k in counters}


def _encoder_split(torch, arch, model, params, batch0, prefill_s,
                   pre_prof) -> None:
    """The encdec prefill's device time split: the encoder alone, timed
    and profiled (its flash launches counted), against the whole
    prefill's profile (``pre_prof``); the rest is the decoder's bos row,
    its cross-KV projections and the readout."""
    from repro_torch.kernels import flash_attention as fa

    enc = torch.inference_mode()(model.encode)
    src = batch0["src_embeds"]
    enc(params, src)
    torch.cuda.synchronize()
    before = fa.LAUNCHES
    t0 = time.perf_counter()
    enc(params, src)
    torch.cuda.synchronize()
    enc_s = time.perf_counter() - t0
    n_enc = fa.LAUNCHES - before
    if n_enc != model.cfg.n_enc_layers:
        fail(f"lm serve {arch}: the encoder launched flash {n_enc} times "
             f"(expected {model.cfg.n_enc_layers})")
    enc_prof = _profile(torch, f"lm {arch} prefill, the encoder alone",
                        enc_s * 1e3, lambda: enc(params, src))
    busy = pre_prof and pre_prof["busy"]
    enc_busy = enc_prof and enc_prof["busy"]
    log(f"lm serve {arch}: prefill split: encoder {enc_s * 1e3:.3f} ms wall "
        f"of the prefill's {prefill_s * 1e3:.3f} ms ({n_enc} flash "
        f"launches); device busy: encoder {_fmt(enc_busy)} ms, the rest "
        f"(decoder, cross-KV, readout) "
        f"{_fmt(busy - enc_busy if busy and enc_busy else None)} ms")


def _replay_vs_eager_one_cache(torch, arch, prefill, decode, eager_step,
                               params, batch0, c, tok, pos0, steps,
                               dev) -> None:
    """The replay against the eager step with one cache alive: a third
    prefill into the graph's own cache (a KV cache is written in place).
    At each step, on the same state: row ``pos`` of every self-K/V leaf
    is zeroed and the replay writes it and attends; its rows are kept;
    the row is zeroed again and the eager step writes it and attends.
    The logits and the rows each wrote must be bit-equal, so a replay
    that writes no row, or another row, fails; the cross-KV is only read
    and stays as the prefill wrote it."""
    from repro_torch.core.tree import tree_leaves, tree_leaves_with_path
    from repro_torch.launch.serve import run_prefill

    _, again, _ = run_prefill(prefill, params, batch0, c, dev)
    if any(a is not b for a, b in zip(tree_leaves(again), tree_leaves(c))):
        fail(f"lm serve {arch}: the prefill did not write the graph's cache "
             "in place")
    kv, other = [], []
    for path, t in tree_leaves_with_path(c):
        keys = set(path.split("/"))
        (kv if keys & {"kv", "kv_seq", "kv_seq2"} else other).append(
            (path, t))
    if not kv or any("cross_kv" not in path.split("/") for path, _ in other):
        fail(f"lm serve {arch}: the one-cache replay check needs a cache of "
             f"K/V rows, not {[path for path, _ in other]}")
    kv = [t for _, t in kv]

    @torch.inference_mode()
    def zero(p):
        for t in kv:
            t[:, :, p].zero_()

    tok_g = tok_e = tok
    pos = torch.full((), pos0, dtype=torch.long, device=dev)
    for i in range(steps):
        p = pos0 + i
        zero(p)
        got, _ = decode(params, tok_g, c, pos)
        rows = [t[:, :, p].clone() for t in kv]
        zero(p)
        want, _ = eager_step(params, tok_e, c, p)
        if not torch.equal(got, want):
            fail(f"lm serve {arch}: step {i}: the replay's logits differ "
                 "from the eager step's (max|diff| "
                 f"{(got - want).abs().max().item():.3g})")
        if not all(r.any() for r in rows) or not all(
                torch.equal(r, t[:, :, p]) for r, t in zip(rows, kv)):
            fail(f"lm serve {arch}: step {i}: the replay left K/V row {p} "
                 "zero or wrote other K/V than the eager step")
        tok_g, tok_e = got.argmax(-1), want.argmax(-1)
        pos += 1
    log(f"lm serve {arch}: {steps} replayed decode steps bit-equal to the "
        "eager step's logits and K/V rows (one cache: the row zeroed before "
        "each of them, the replay first)")


def _moe_twice(torch, arch, prefill, eager_step, params, batch0, cache,
               logits0, toks0, steps, dev) -> None:
    """An MoE arch served eagerly again from its own prefill: the prefill's
    logits and the greedy tokens equal the first run's bit for bit (no
    atomic float sum decides a bit: the dispatch's counts are integers and
    the combine sums the rounds in order); the slots dropped past capacity
    in this prefill and its first decode step, per MoE layer call."""
    from repro_torch.launch.serve import run_decode, run_prefill
    from repro_torch.nn import moe

    moe.DROPPED = []
    try:
        logits, c, _ = run_prefill(prefill, params, batch0, cache(), dev)
        pre = [int(t) for t in moe.DROPPED]
        moe.DROPPED = []
        first, c, _, _ = run_decode(eager_step, params, logits.argmax(-1),
                                    c, LM_PROMPT, 1, dev)
        dec = [int(t) for t in moe.DROPPED]
    finally:
        moe.DROPPED = None
    rest, _, _, _ = run_decode(eager_step, params, first[0], c,
                               LM_PROMPT + 1, steps - 1, dev)
    if not torch.equal(logits, logits0) or not torch.equal(
            torch.stack(first + rest), torch.stack(toks0)):
        fail(f"lm serve {arch}: a second eager run's logits or tokens "
             "differ from the first's")
    log(f"lm serve {arch}: a second eager run gave the first's prefill "
        f"logits and {steps} greedy tokens bit for bit; slots dropped past "
        f"capacity per MoE layer call: prefill {pre} of "
        f"{LM_BATCH * LM_PROMPT} a call (x top_k), first decode step {dec}")


#: the kernels a wrapper launch is counted for, by counter, as the
#: profiler names them (a split's merge and the u8 x s8 weight pre-pass
#: are further kernels of one launch, not counted)
COUNTED_KERNELS = {
    "trim_conv2d": re.compile(r"trim_conv2d_(f32|u8s8|u8s8_slide)_kernel"),
    "flash_attention": re.compile(r"flash_\w+_kernel"),
}
#: captures per key of every engine the script built, by phase
CAPTURES: dict = {}


def _replay_kernels(torch, fn):
    """{kernel name: records} that ``torch.profiler`` files for one call
    of ``fn`` (which must be safe to run twice), traced after a first call
    in the same session (the schedule's warmup step, traced and dropped):
    on some machines CUPTI misses a session's first kernel record.  The
    durations are not read, since the warmup's spill into the recorded
    step's device time.  None where no kernel was seen."""
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(2):
            fn()
            torch.cuda.synchronize()
            prof.step()
    kernels = {e.key: e.count for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")
               and getattr(e, "self_device_time_total", 0) > 0}
    return kernels or None


#: profiler sessions :func:`_hold_replay_launches` takes at most
REPLAY_SESSIONS = 3


def _hold_replay_launches(torch, what: str, fn, calls: int, launches) -> None:
    """Hold the launches a graph's capture recorded per replay against the
    kernels ``torch.profiler`` sees in ``fn()``, ``calls`` replays
    (:func:`_replay_kernels`); a replay must run no u8 x s8 weight
    pre-pass.  CUPTI now and then misreads a session of graph replays on
    some machines (a kernel record filed under another name, or none at
    all), so up to REPLAY_SESSIONS sessions are taken, each miss logged,
    and the first whose counts agree passes.  The replays add the recorded
    counts to the wrappers' counters, so where no session agrees, or none
    sees a kernel, the counts stay unchecked: that fails."""
    want = {k: launches.get(k, 0) for k in COUNTED_KERNELS}
    for attempt in range(1, REPLAY_SESSIONS + 1):
        kernels = _replay_kernels(torch, fn)
        if kernels is None:
            log(f"{what}: profiler session {attempt} of {REPLAY_SESSIONS} "
                "saw no kernel")
            continue
        seen = {k: sum(n for name, n in kernels.items()
                       if pat.search(name)) // calls
                for k, pat in COUNTED_KERNELS.items()}
        prepass = sum(n for name, n in kernels.items() if "wprep" in name)
        if seen == want and not prepass:
            log(f"{what}: one replay: {seen} kernels by the profiler, as "
                "the capture recorded; no weight pre-pass")
            return
        log(f"{what}: profiler session {attempt} of {REPLAY_SESSIONS}: one "
            f"replay ran {seen} kernels and {prepass} weight pre-passes; its "
            f"capture recorded {want} launches")
    fail(f"{what}: in none of {REPLAY_SESSIONS} profiler sessions did the "
         f"kernels of a replay match the {want} launches its capture "
         "recorded")


def _profile(torch, what: str, wall_ms: float, fn, calls: int = 1,
             tries: int = 1):
    """Log the device (kernel) time per call of ``fn`` under
    ``torch.profiler``, its share of ``wall_ms`` (the unprofiled time of
    one call; the rest is the device's idle share) and the kernels that
    take the most of it.  Returns {"busy": ms a call, "idle": share,
    "kernels": {kernel name: count over the calls}}, or None where the
    profiler saw no device time in any of ``tries`` sessions (CUPTI now
    and then hands a short session of graph replays no kernel record at
    all, so a caller whose ``fn`` may run again asks for more than one)."""
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, tries + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        timed = [e for e in prof.key_averages()
                 if getattr(e, "self_device_time_total", 0) > 0]
        # kernels (device events) give the busy time; the host-side ops
        # that launched them (aten::mul, our wrappers' kernels by name)
        # the split
        kernels = [e for e in timed if str(e.device_type).endswith("CUDA")]
        if kernels:
            break
        log(f"profile {what}: session {attempt} of {tries}: the profiler "
            "saw no device time")
    ops = sorted((e for e in timed if e not in kernels),
                 key=lambda e: -e.self_device_time_total)
    if not kernels:
        log(f"profile {what}: the profiler saw no device time "
            "(device share not measured)")
        return None
    busy = sum(e.self_device_time_total for e in kernels) / 1e3 / calls
    ours = [e for e in kernels if "trim_" in e.key or "flash_" in e.key]
    top = "; ".join(
        f"{e.key[:40]} x{e.count // calls} "
        f"{e.self_device_time_total / 1e3 / calls:.3f} ms"
        for e in (ops[:8] + ours))
    idle = max(0.0, 1 - busy / wall_ms)
    log(f"profile {what}: device busy {busy:.3f} ms of {wall_ms:.3f} ms "
        f"wall (idle share {idle:.3f}); "
        f"{sum(e.count for e in kernels) // calls} kernels; by op: {top}")
    return {"busy": busy, "idle": idle,
            "kernels": {e.key: e.count for e in kernels},
            "kernel_ms": {e.key: e.self_device_time_total / 1e3 / calls
                          for e in kernels}}


def phase_lm_checks(torch, arch: str):
    """Full-width ``arch`` in fp32: prefill + decode against a longer
    prefill, and the kernels' logits against the plain versions'."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.engine import ExecutionPolicy
    from repro_torch.nn.models import build_model

    gc.collect()  # the serve phase's engine and graph hold its params
    torch.cuda.empty_cache()
    dev = torch.device("cuda", 0)
    cfg = get_config(arch).with_overrides(dtype=torch.float32)
    model = build_model(cfg)
    oracle = build_model(cfg, policy=ExecutionPolicy("oracle"))
    params = model.init(0, dev)
    B, S = LM_CHECK_BATCH, LM_CHECK_LEN
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, (B, S)), device=dev)

    def cache():
        return model.init_cache(B, S, dtype=cfg.dtype, device=dev)

    with torch.inference_mode():
        full, _ = model.prefill(params, toks, cache())
        full_o, _ = oracle.prefill(params, toks, cache())
        _, c = model.prefill(params, toks[:, :S - 1], cache())
        dec, _ = model.decode_step(params, toks[:, S - 1], c, S - 1)
    torch.cuda.synchronize()
    for name, t in (("prefill", full), ("oracle prefill", full_o),
                    ("decode", dec)):
        if not bool(torch.isfinite(t).all()):
            fail(f"lm checks {arch}: non-finite {name} logits")
    err = (dec - full).abs().max().item()
    if not torch.allclose(dec, full, rtol=3e-4, atol=3e-4):
        fail(f"lm checks {arch}: prefill(t[:S-1]) + decode(t[S-1]) vs "
             f"prefill(t): max err {err:.3g} (rtol = atol = 3e-4)")
    scale = full_o.abs().max().item()
    err_o = (full - full_o).abs().max().item()
    if err_o > LM_KERNEL_TOL[arch] * scale:
        fail(f"lm checks {arch}: kernel vs plain prefill logits max err "
             f"{err_o:.3g} > {LM_KERNEL_TOL[arch]} * {scale:.3g}")
    log(f"lm checks {arch} (fp32, batch {B}, S {S}): prefill + decode vs "
        f"prefill max|err| {err:.3g} (rtol = atol = 3e-4); kernels vs plain "
        f"max|err| {err_o:.3g} of max|logit| {scale:.3g} (limit "
        f"{LM_KERNEL_TOL[arch]} of it; bit-equal: "
        f"{bool(torch.equal(full, full_o))})")


def phase_lm_checks_extra(torch, arch: str, n_layers: int = 0) -> dict:
    """Full-width ``arch`` of the encdec or vlm family in fp32 (TF32 off;
    its depth cut to ``n_layers`` where given, logged as a cut), at batch
    LM_CHECK_BATCH: for encdec a seeded source of ENCDEC_CHECK_SRC frames
    and ENCDEC_CHECK_TGT target tokens, for vlm the config's seeded patch
    embeddings and LM_CHECK_LEN text tokens.  prefill(t[:S-1]) and then
    decode_step(t[S-1]) must equal the forward's last two rows within
    EXTRA_SERVE_TOL (the JAX package's own serve tolerance of the family,
    ``tests/test_arch_smokes.py``), and the forward's logits through the
    kernels those of the oracle substrate (the plain attention) within
    LM_KERNEL_TOL of the largest |logit|.  Returns the kernels' flash
    launches by the kind of call phase 3i times, each counted: for encdec
    those of the encoder's and the cross-attention's calls (forward,
    prefill and decode), for vlm those of the forward and the prefill,
    and of the decode step."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.engine import ExecutionPolicy
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.nn.models import build_model

    gc.collect()  # the serve phase's engine and graph hold its params
    torch.cuda.empty_cache()
    dev = torch.device("cuda", 0)
    cfg = get_config(arch).with_overrides(dtype=torch.float32)
    if n_layers:
        log(f"lm checks {arch}: depth cut from {cfg.n_layers} to "
            f"{n_layers} layers for the fp32 checks, every width as "
            "published")
        cfg = cfg.with_overrides(n_layers=n_layers)
    model = build_model(cfg)
    oracle = build_model(cfg, policy=ExecutionPolicy("oracle"))
    params = model.init(0, dev)
    B = LM_CHECK_BATCH
    rng = np.random.default_rng(1)
    encdec = cfg.family == "encdec"
    S = ENCDEC_CHECK_TGT if encdec else LM_CHECK_LEN
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (B, S)), device=dev)
    n_src = ENCDEC_CHECK_SRC if encdec else cfg.frontend_tokens
    side = torch.as_tensor(rng.normal(size=(B, n_src, cfg.d_model)),
                           dtype=torch.float32, device=dev)
    n = 0 if encdec else n_src
    cache_len = S + 1 if encdec else n + S

    def forward(m):
        if encdec:
            return m.forward(params, side, toks)
        return m.forward(params, toks, side)[0]

    def cache():
        if encdec:
            return model.init_cache(B, cache_len, cross_len=n_src,
                                    dtype=cfg.dtype, device=dev)
        return model.init_cache(B, cache_len, dtype=cfg.dtype, device=dev)

    before = fa.LAUNCHES
    roles = FlashRoles(torch)
    with torch.inference_mode():
        with roles:
            full = forward(model)
            if encdec:
                pre, c = model.prefill(params, side, toks[:, :S - 1],
                                       cache())
            else:
                pre, c = model.prefill(params, toks[:, :S - 1], cache(),
                                       extra_embeds=side)
            n_pre = fa.LAUNCHES - before
            dec, _ = model.decode_step(params, toks[:, S - 1], c, n + S - 1)
        torch.cuda.synchronize()
        launches = fa.LAUNCHES - before
        full_o = forward(oracle)
    torch.cuda.synchronize()
    if fa.LAUNCHES - before != launches:
        fail(f"lm checks {arch}: the oracle launched the flash kernel")
    L = cfg.n_layers
    if encdec:
        rows = {"encoder": roles.calls.get("encoder", 0),
                "cross": roles.calls.get("cross", 0)}
        want = {"encoder": 2 * cfg.n_enc_layers, "cross": 3 * L}
    else:
        rows = {"prefill": n_pre, "decode": launches - n_pre}
        want = {"prefill": 2 * L, "decode": L}
    if rows != want:
        fail(f"lm checks {arch}: flash launches {rows} (expected {want})")
    for name, t in (("forward", full), ("oracle forward", full_o),
                    ("prefill", pre), ("decode", dec)):
        if not bool(torch.isfinite(t).all()):
            fail(f"lm checks {arch}: non-finite {name} logits")
    tol = EXTRA_SERVE_TOL[cfg.family]
    err = max((pre - full[:, n + S - 2]).abs().max().item(),
              (dec - full[:, n + S - 1]).abs().max().item())
    if not (torch.allclose(pre, full[:, n + S - 2], rtol=tol, atol=tol)
            and torch.allclose(dec, full[:, n + S - 1], rtol=tol, atol=tol)):
        fail(f"lm checks {arch}: prefill(t[:S-1]) + decode(t[S-1]) vs the "
             f"forward's last two rows: max err {err:.3g} (rtol = atol = "
             f"{tol})")
    scale = full_o.abs().max().item()
    err_o = (full - full_o).abs().max().item()
    if err_o > LM_KERNEL_TOL[arch] * scale:
        fail(f"lm checks {arch}: kernel vs plain forward logits max err "
             f"{err_o:.3g} > {LM_KERNEL_TOL[arch]} * {scale:.3g}")
    log(f"lm checks {arch} (fp32, batch {B}, "
        + (f"source {n_src} frames, target {S} tokens" if encdec else
           f"{n_src} patch embeddings + {S} text tokens")
        + f", {cfg.n_layers} layers): prefill + decode vs the forward's last "
        f"two rows max|err| {err:.3g} (rtol = atol = {tol}); kernels vs "
        f"plain forward max|err| {err_o:.3g} of max|logit| {scale:.3g} "
        f"(limit {LM_KERNEL_TOL[arch]} of it; bit-equal: "
        f"{bool(torch.equal(full, full_o))}); {launches} flash launches, "
        f"{rows} of the timed shapes' kinds")
    return rows


#: AlexNet's serve phase: the buckets captured on each lane
ALEX_BUCKETS = (1, 4, 8)


def phase_alexnet_serve(torch):
    """Full-width AlexNet's bucket executables (seed-0 weights, buckets
    1, 4 and 8) on the float, int8 and int5 lanes, built and captured by
    ``serve_cnn.build_server``: one capture per key; no u8 x s8 weight
    pre-pass and no cut of a grouped layer's weights recorded into any
    capture (``graphs.capture`` refuses a recording that makes either,
    which would run again on every replay); the launches of one
    replay per bucket counted (a grouped layer launches once per group);
    each bucket's replay bit-equal to its eager executable on seeded
    images, timed, and held against ``torch.profiler``'s kernels (no
    weight pre-pass kernel in replays).  Returns {lane: launches of the
    counted replays}."""
    from repro_torch.configs import CNN_REGISTRY
    from repro_torch.data.pipeline import SyntheticRequestStream
    from repro_torch.engine import ExecutionPolicy, execute
    from repro_torch.kernels import trim_conv2d as kern
    from repro_torch.launch.serve_cnn import build_server
    from repro_torch.serve import ServeConfig

    gc.collect()
    cfg = CNN_REGISTRY["alexnet"]
    out = {}
    for datapath in ("float", "int8", "int5"):
        what = f"alexnet {datapath}"
        t0 = time.perf_counter()
        srv = build_server(cfg, ExecutionPolicy(),
                           ServeConfig(buckets=ALEX_BUCKETS,
                                       datapath=datapath),
                           device="cuda")
        srv.close()
        eng = srv.engine
        build_s = time.perf_counter() - t0
        if set(eng.capture_counts.values()) != {1} \
                or set(eng.capture_counts) != set(eng.compile_counts):
            fail(f"{what}: captures per key {eng.capture_counts}")
        CAPTURES[what] = dict(eng.capture_counts)
        stream = SyntheticRequestStream(
            hw=cfg.input_hw, channels=cfg.layers[0].M,
            n_classes=cfg.n_classes, seed=1,
            dtype="float32" if datapath == "float" else "uint8")
        images = stream.sample_batch(max(ALEX_BUCKETS))
        kern.LAUNCHES = 0
        per = {}
        for b in ALEX_BUCKETS:
            before = kern.LAUNCHES
            eng.run_bucket(b, images[:b])
            per[b] = kern.LAUNCHES - before
        out[datapath] = kern.LAUNCHES
        torch.cuda.synchronize()
        want = sum(lp.groups for lp in eng.plan.layers)
        if set(per.values()) != {want}:
            fail(f"{what}: kernel launches a replay {per}, expected {want} "
                 f"(one per conv group)")
        for b in ALEX_BUCKETS:
            _replay_vs_eager(torch, what, eng, b, images[:b], hold=True)
        log(f"{what}: buckets {ALEX_BUCKETS} built and captured in "
            f"{build_s:.1f} s, one capture per key; {want} kernel launches "
            f"a replay ({len(eng.plan.layers)} convs, grouped layers once "
            "per group); weight pre-passes recorded into the captures 0, "
            "weight cuts recorded 0, so 0 of either per replay")
    return out


#: The autotune phase: VGG-16's buckets tuned, the timed calls a
#: candidate (after one warm call) and the lanes
AUTOTUNE_BUCKETS = (1, 8)
AUTOTUNE_REPS = 5
AUTOTUNE_LANES = ("int8", "float")


def _schedule_text(sched) -> str:
    """A persisted schedule in a log line: its substrate where it is not
    the default's, and its overrides; "default" where it has neither."""
    parts = [f"{k}={v}" for k, v in sched.items()
             if v is not None and k != "substrate"]
    if sched["substrate"] != "auto":
        parts.insert(0, sched["substrate"])
    return " ".join(parts) or "default"


def _default_geometry(lp, batch: int) -> str:
    """The launch the default plan of one layer makes at ``batch``."""
    from repro_torch.kernels.trim_conv2d import U8_PATH_NAMES

    if lp.in_sz == 1:
        t = lp.launch(batch)
        return (f"{U8_PATH_NAMES[t.path]} {t.TH}x{t.TW} split {t.n_split} "
                f"stages {t.stages}")
    t = lp.f32()
    return (f"fp32 {t.TH}x{t.TW} Cb {t.Cb} split {t.n_split} stages "
            f"{t.stages}")


def phase_autotune(torch) -> None:
    """Full-width VGG-16 planned under ``tuning="auto"`` on the int8 and
    float lanes at buckets 1 and 8 into a temporary cache directory: each
    layer's candidates measured on the card (``engine/autotune.py``), the
    winners persisted; per layer and bucket, the default's launch, the
    winner and both times (paired where a winner differs); then
    ``tuning="cached"`` plans the same model with no measurement, and for
    each lane and bucket the tuned plan's captured graph replays
    bit-equal to the default plan's on the same images."""
    import os
    import tempfile

    from repro_torch.configs import CNN_REGISTRY
    from repro_torch.data.pipeline import SyntheticRequestStream
    from repro_torch.engine import ExecutionPolicy, autotune, plan_model
    from repro_torch.launch.serve_cnn import build_server
    from repro_torch.serve import ServeConfig

    gc.collect()
    torch.cuda.empty_cache()
    cfg = CNN_REGISTRY["vgg16"]
    tmp = tempfile.mkdtemp(prefix="tuned-plans-")
    prior = os.environ.get("REPRO_TUNED_PLANS_DIR")
    os.environ["REPRO_TUNED_PLANS_DIR"] = tmp
    measured = []
    real = autotune._measure_plan

    def counted(plan, **kw):
        measured.append(plan)
        return real(plan, **kw)

    autotune._measure_plan = counted
    try:
        autotune.reset_cache()
        pol = ExecutionPolicy(tuning="auto")
        t0 = time.perf_counter()
        tuned = {}
        for b in AUTOTUNE_BUCKETS:
            for lane in AUTOTUNE_LANES:
                res = autotune.tune_model(cfg, pol, datapath=lane, batch=b,
                                          reps=AUTOTUNE_REPS)
                tuned[(lane, b)] = res
        tune_s = time.perf_counter() - t0
        n_measured = len(measured)
        entries = autotune._load_plans(autotune.cache_path("cuda"))
        for (lane, b), res in tuned.items():
            base = plan_model(cfg, ExecutionPolicy(), batch=b)
            layers = (base.int8 if lane == "int8" else base).layers
            moved = []
            for (label, r), lp in zip(res, layers):
                name = label.split("/")[1].split(".")[0]
                e = entries[r.key]
                win = _schedule_text(r.schedule)
                if win != "default":
                    moved.append(f"{name} {win} x{e['speedup']}")
                kept = (f"{len(r.candidates)} of {e['candidates']} "
                        "candidates bit-equal to the default"
                        if not r.cached else
                        "an earlier layer's key: its tuning, cached")
                paired = ("" if e.get("ratio") is None else
                          f" (paired re-measure, median ratio "
                          f"{e['ratio']}"
                          + (")" if win != "default" else
                             ": inside MIN_GAIN, the default ships)"))
                log(f"autotune {lane} bucket {b} {name}: default "
                    f"{_default_geometry(lp, b)} {r.us_default:.1f} us; "
                    f"winner {win} {r.us:.1f} us{paired}; {kept}")
            log(f"autotune {lane} bucket {b}: {len(moved)} of "
                f"{len(layers)} layers take another schedule than the "
                f"default" + (": " + ", ".join(moved) if moved else ""))
        log(f"autotune: {n_measured} measurements of {len(entries)} layer "
            f"keys (VGG-16, lanes {AUTOTUNE_LANES}, buckets "
            f"{AUTOTUNE_BUCKETS}) in {tune_s:.1f} s")
        # a fresh process's plans from the file: no measurement at all
        autotune.reset_cache()
        cached = ExecutionPolicy(tuning="cached")
        for b in AUTOTUNE_BUCKETS:
            for lane in AUTOTUNE_LANES:
                mp = plan_model(cfg, cached, batch=b)
                mp = mp.int8 if lane == "int8" else mp
                if not all(lp.tuned for lp in mp.layers):
                    fail(f"autotune: the cached {lane} plan at bucket {b} "
                         "misses a layer's winner")
        if len(measured) != n_measured:
            fail(f"autotune: tuning='cached' measured "
                 f"{len(measured) - n_measured} times, expected none")
        log("autotune: tuning='cached' planned every layer of both lanes "
            "at both buckets from the file with no measurement")
        # the tuned plans' graphs against the default plans'
        for lane in AUTOTUNE_LANES:
            conf = ServeConfig(buckets=AUTOTUNE_BUCKETS, datapath=lane)
            srv = {}
            for name, p in (("default", ExecutionPolicy()),
                            ("tuned", cached)):
                srv[name] = build_server(cfg, p, conf, device="cuda")
                srv[name].close()
            stream = SyntheticRequestStream(
                hw=cfg.input_hw, channels=3, n_classes=cfg.n_classes,
                seed=2, dtype="float32" if lane == "float" else "uint8")
            images = stream.sample_batch(max(AUTOTUNE_BUCKETS))
            for b in AUTOTUNE_BUCKETS:
                x = torch.from_numpy(images[:b]).cuda()
                outs = {}
                for name, s in srv.items():
                    g = s.engine.bucket_graphs(b)
                    outs[name] = g(x).clone()
                    outs[f"{name}_ms"] = cuda_ms(torch, lambda: g(x), 10)
                tplan = srv["tuned"].engine._lane_key(
                    srv["tuned"].engine.lanes[0], b)[0]
                if not all(lp.tuned for lp in (
                        tplan.int8 if lane == "int8" else tplan).layers):
                    fail(f"autotune {lane} bucket {b}: the served plan is "
                         "not the tuned one")
                if not torch.equal(outs["default"], outs["tuned"]):
                    fail(f"autotune {lane} bucket {b}: the tuned plan's "
                         "replay differs from the default plan's")
                log(f"autotune {lane} bucket {b}: the tuned plan's replay "
                    f"bit-equal to the default plan's; {outs['tuned_ms']:.4f}"
                    f" ms a replay, default {outs['default_ms']:.4f} ms "
                    "(CUDA events, 10 calls)")
            CAPTURES[f"autotune {lane}"] = dict(
                srv["tuned"].engine.capture_counts)
            del srv
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        autotune._measure_plan = real
        if prior is None:
            os.environ.pop("REPRO_TUNED_PLANS_DIR", None)
        else:
            os.environ["REPRO_TUNED_PLANS_DIR"] = prior
        autotune.reset_cache()


#: The LM train phases: (batch, tokens a row, steps) at full width and in
#: bf16; the cut from the JAX package's train_4k cell (4096 tokens, global
#: batch 256) is in batch and length only
LM_TRAIN = {LM_ARCH: (4, 1024, 4), DENSE_ARCH: (1, 1024, 2)}
#: mamba2-130m's fp32 check: each leaf's gradient through the kernels
#: within this relative norm error of the oracle substrate's (the conv1d
#: kernel is bit-equal to its plain version forward, and its backward is
#: that version's VJP: only the order of atomics may differ)
LM_GRAD_TOL = 1e-4
#: the resume check: save after this many steps of the mamba2-130m run
RESUME_AT = 2


def _conv1d_train_row(torch, B, L, reps) -> dict:
    """The conv1d kernel in bf16 at mamba2-130m's xBC view of a (B, L)
    batch: bit-equal to its plain version, and timed (``_conv1d_row``)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.trim_conv1d import (trim_conv1d,
                                                 trim_conv1d_plain)
    from repro_torch.nn.models import build_model

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(5)
    dims = build_model(get_config(LM_ARCH)).spec.dims
    d_in, D, K = dims.d_inner, dims.conv_channels, dims.d_conv
    proj = torch.randn((B, L, dims.in_proj_out), generator=gen,
                       device=dev).to(torch.bfloat16)
    x = proj[..., d_in:d_in + D]
    w = (torch.randn((K, D), generator=gen, device=dev)
         * K ** -0.5).to(torch.bfloat16)
    if not torch.equal(trim_conv1d(x, w), trim_conv1d_plain(x, w)):
        fail(f"conv1d at ({B}, {L}, {D}): kernel != plain")
    return _conv1d_row(torch, x, w, reps, "train")


def _flash_row(torch, what, B, Sq, Sk, H, G, D, causal, kvl, reps,
               dtype=None, timed=True) -> dict:
    """The flash kernel at one shape (``kvl`` one kv_length for every row,
    or None; the keys past it NaN for the kernel, zero for the plain
    version) against its plain version (bf16 2e-2, and per row
    BF16_ROW_ULPS x 2^-7 of the row's max|plain|; fp32 2e-5), and, where
    ``timed``, its times (``_flash_times``).  ``dtype`` defaults to
    bf16."""
    from repro_torch.kernels import flash_attention as fa

    dtype = dtype or torch.bfloat16
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(6)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev).to(
        dtype)
    q, k, v = rnd(B, Sq, H, G, D), rnd(B, Sk, H, D), rnd(B, Sk, H, D)
    kvl = None if kvl is None else (kvl,) * B
    kw = dict(causal=causal, kv_length=None if kvl is None else
              torch.tensor(kvl, dtype=torch.int32, device=dev))
    kp, vp = k, v
    if kvl is not None:
        stale = (torch.arange(Sk, device=dev)[None, :]
                 >= kw["kv_length"][:, None])[..., None, None]
        kp, vp = k.masked_fill(stale, 0.0), v.masked_fill(stale, 0.0)
        k.masked_fill_(stale, float("nan"))
        v.masked_fill_(stale, float("nan"))
    got = fa.flash_attention(q, k, v, **kw)
    want = fa.flash_attention_plain(q, kp, vp, **kw)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    bf16 = dtype == torch.bfloat16
    ulps = _row_ulps(got, want) if bf16 else None
    tol = 2e-2 if bf16 else 2e-5
    if got.shape != want.shape or not bool(torch.isfinite(got).all()) \
            or not torch.allclose(got.float(), want.float(), rtol=tol,
                                  atol=tol) \
            or (bf16 and ulps > BF16_ROW_ULPS):
        fail(f"flash {what} {dtype}: max|kernel-plain| {err:.3g}, worst row "
             f"{ulps} x 2^-7 (limits {tol}, {BF16_ROW_ULPS})")
    row = {"shape": what, "dtype": str(dtype).replace("torch.", ""),
           "q": tuple(q.shape), "kv": tuple(k.shape), "max_abs_err": err,
           "row_ulps": ulps}
    if not timed:
        return row
    row.update(_flash_times(torch, q, k, v, kw, kvl, reps, kp, vp)[0])
    log(f"flash {what}: q {row['q']} kv {row['kv']} {row['dtype']} err "
        f"{err:.3g}" + (f" row {ulps:.3g} x 2^-7" if bf16 else "")
        + f"; ms {row['ms']:.4f} plain_ms {row['plain_ms']:.4f} library_ms "
        f"{row['library_ms']:.4f} bound_ms {row['bound_ms']:.4f} "
        f"({row['bound_by']})")
    return row


def phase_flash_code(torch, reps: int):
    """The flash kernel at starcoder2-3b's G = 12, the first G that is not
    a power of two, at its full-width serving shapes (bf16): the prefill
    q (4, 4096, 2, 12, 128) causal on the warpgroup path, the decode q
    (4, 1, 2, 12, 128) over a (4, 4128, 2, 128) cache with kv_length
    4097 on the split path.  Returns {shape: row}."""
    from repro_torch.configs import get_config

    cfg = get_config(CODE_ARCH)
    H, G, D = cfg.n_kv, cfg.n_q // cfg.n_kv, cfg.head_dim
    return {
        "prefill": _flash_row(torch, f"{CODE_ARCH} prefill", LM_BATCH,
                              LM_PROMPT, LM_PROMPT, H, G, D, True, None,
                              reps),
        "decode": _flash_row(torch, f"{CODE_ARCH} decode", LM_BATCH, 1,
                             LM_PROMPT + LM_GEN, H, G, D, False,
                             LM_PROMPT + 1, reps)}


#: the head dims below the kernel's 64-column unit, each at a small
#: prefill (warpgroup path in bf16, kv_length inside a tile) and decode
#: (split path), both dtypes, against the plain version
FLASH_SMALL_DIMS = (8, 16, 32)


def phase_flash_dims(torch, reps: int):
    """The flash kernel at the head dims this slice added.  gemma-7b's
    full-width serving shapes at D = 256, G = 1: the prefill q (4, 4096,
    16, 1, 256) causal and the decode q (4, 1, 16, 1, 256) over a (4,
    4128, 16, 256) cache with kv_length 4097, in bf16 and fp32, each
    against the plain version, timed beside it, SDPA (TF32 off) and the
    bound; llama4-maverick's (G = 5, D = 128), the MoE serve phase's
    shapes, in bf16; then D = 8, 16 and 32 at small shapes against the
    plain version.  Returns {(arch, shape, dtype): row}."""
    from repro_torch.configs import get_config

    rows = {}
    for arch, dtypes in ((GEMMA_ARCH, (torch.bfloat16, torch.float32)),
                         (MOE_ARCH, (torch.bfloat16,))):
        cfg = get_config(arch)
        H, G, D = cfg.n_kv, cfg.n_q // cfg.n_kv, cfg.head_dim
        for dtype in dtypes:
            n = reps if dtype == torch.bfloat16 else max(3, reps // 10)
            name = str(dtype).replace("torch.", "")
            rows[(arch, "prefill", name)] = _flash_row(
                torch, f"{arch} prefill", LM_BATCH, LM_PROMPT, LM_PROMPT, H,
                G, D, True, None, n, dtype=dtype)
            rows[(arch, "decode", name)] = _flash_row(
                torch, f"{arch} decode", LM_BATCH, 1, LM_PROMPT + LM_GEN, H,
                G, D, False, LM_PROMPT + 1, n, dtype=dtype)
    worst = {}
    for D in FLASH_SMALL_DIMS:
        for dtype in (torch.bfloat16, torch.float32):
            for what, args in (("prefill", (2, 300, 300, 2, 4, D, True, 277)),
                               ("decode", (2, 1, 1000, 2, 4, D, False, 777))):
                r = _flash_row(torch, f"D={D} {what}", *args, reps,
                               dtype=dtype, timed=False)
                key = f"D={D} {r['dtype']}"
                worst[key] = max(worst.get(key, 0.0), r["max_abs_err"])
    log("flash at D = 8, 16, 32 (prefill q (2, 300, 2, 4, D) causal with "
        "kv_length 277, decode q (2, 1, 2, 4, D) over 1000 keys with "
        "kv_length 777): kernel matches plain, max|err| " + ", ".join(
            f"{k} {v:.3g}" for k, v in worst.items()))
    return rows


def phase_flash_families(torch, reps: int):
    """The flash kernel at the encdec and vlm families' full-width serving
    shapes, bf16 and fp32, each against its plain version, timed beside
    it, SDPA (TF32 off) and the bound: seamless-m4t-large-v2's encoder
    prefill, q (4, 4096, 16, 1, 64) over its own 4096 keys, non-causal (the
    warpgroup path in bf16), and its cross-attention's decode row, q (4,
    1, 16, 1, 64) over the 4096-key cross-KV with no kv_length (the split
    path in bf16; the prefill's bos row has the same shape);
    llava-next-34b's prefill, q (4, 4096, 8, 7, 128) causal, and decode,
    q (4, 1, 8, 7, 128) over a (4, 4128, 8, 128) cache with kv_length
    4097.  Returns {(arch, shape, dtype): row}."""
    from repro_torch.configs import get_config

    rows = {}
    for arch, shapes in (
            (ENCDEC_ARCH, (("encoder", LM_PROMPT, LM_PROMPT, False, None),
                           ("cross", 1, LM_PROMPT, False, None))),
            (VLM_ARCH, (("prefill", LM_PROMPT, LM_PROMPT, True, None),
                        ("decode", 1, LM_PROMPT + LM_GEN, False,
                         LM_PROMPT + 1)))):
        cfg = get_config(arch)
        H, G, D = cfg.n_kv, cfg.n_q // cfg.n_kv, cfg.head_dim
        for dtype in (torch.bfloat16, torch.float32):
            n = reps if dtype == torch.bfloat16 else max(3, reps // 10)
            name = str(dtype).replace("torch.", "")
            for shape, Sq, Sk, causal, kvl in shapes:
                rows[(arch, shape, name)] = _flash_row(
                    torch, f"{arch} {shape}", LM_BATCH, Sq, Sk, H, G, D,
                    causal, kvl, n, dtype=dtype)
    return rows


#: the rows that ``tools/flash_times.py`` times (the bf16 prefills and
#: gemma-7b's decode; the fp32 prefills, granite-3-2b's fp32 decode and
#: the fp32 partial entry), held in turns against the parent checkout's:
#: the row a commit that changes the flash kernel claims faster must run
#: faster than the parent's (FLASH_TURNS_FASTER; None where the commit
#: changes no flash code), every other row at most FLASH_TURNS_SLACK times
#: the parent's time
FLASH_TURNS_SLACK = 1.03
FLASH_TURNS_FASTER = None


def phase_flash_turns(torch, parent):
    """With ``parent`` (a checkout of the parent commit): the flash
    kernel's bf16 prefill at gemma-7b's, llava-next-34b's, starcoder2-3b's,
    llama4-maverick's and granite-3-2b's full-width shapes, seamless's
    encoder and gemma-7b's decode, and the fp32 lane's prefill at
    granite-3-2b's, gemma-7b's, llava-next-34b's and seamless's encoder's,
    granite-3-2b's decode and the partial entry on llava's half cache,
    timed by ``tools/flash_times.py`` in the parent checkout and here in
    turns (parent, this, this, parent; SDPA's time, TF32 off, from the
    first turn here, logged beside each row), the rows of phases 3d, 3g,
    3h, 3i and 23, each the mean of its two turns; fails where the row
    FLASH_TURNS_FASTER names is not faster than the parent's or another
    row is more than FLASH_TURNS_SLACK times the parent's.  Then gemma-7b's
    served prefill (phase 15's) in turns, by
    ``tools/serve_prefill_times.py``: its wall and the flash kernel's
    device time in it, logged.  Does nothing without ``parent``."""
    if parent is None:
        log("flash: the parent's times not measured (run with --parent DIR, "
            "a checkout of the parent commit)")
        return
    before, *mine, after = (_timing_tool("flash_times.py", c, *sdpa)
                            for c, sdpa in ((parent, ()), (ROOT, ("--sdpa",)),
                                            (ROOT, ()), (parent, ())))
    lib = mine[0]["sdpa"]
    before, mine, after = before["rows"], [m["rows"] for m in mine], \
        after["rows"]
    slow = []
    for name in before:
        p = (before[name] + after[name]) / 2
        t = (mine[0][name] + mine[1][name]) / 2
        limit = 1.0 if name == FLASH_TURNS_FASTER else FLASH_TURNS_SLACK
        log(f"flash {name} in turns: parent {before[name]:.4f}, this "
            f"{mine[0][name]:.4f}, this {mine[1][name]:.4f}, parent "
            f"{after[name]:.4f} ms; this / parent {t / p:.4f} (below "
            f"{limit:.2f}); SDPA {lib[name]:.4f} ms, this / SDPA "
            f"{t / lib[name]:.4f}")
        if t >= limit * p:
            slow.append(f"{name} {t / p:.4f}x")
    if slow:
        fail(f"flash in turns: slower than the parent's: {slow}")
    # phase 15's model on the card alone (the earlier phases' memory freed)
    gc.collect()
    torch.cuda.empty_cache()
    before, *mine, after = (_timing_tool("serve_prefill_times.py", c)["rows"]
                            for c in (parent, ROOT, ROOT, parent))
    for name, unit in (("prefill wall", "ms"), ("flash device", "ms"),
                       ("flash launches", "")):
        turns = [t[name] for t in (before, *mine, after)]
        log(f"{GEMMA_ARCH} served prefill, {name} in turns (parent, this, "
            f"this, parent): {', '.join(f'{x:.3f}' for x in turns)} {unit}"
            + ("; not measured (the profiler saw no flash kernel)"
               if name == "flash device" and 0 in turns else ""))


#: Kernel 6's fp32 projections in turns: the rows of
#: ``tools/conv1d_matmul_times.py`` whose sum is held to the targets
MATMUL_F32_ROWS = ("matmul gate/up", "matmul down", "matmul q/o")
#: the fp32 projections' targets: at most this share of the parent's sum
#: in turns, and no slower than cuBLAS (TF32 off) in the same run
MATMUL_F32_TARGET = 0.8


def phase_conv1d_matmul_turns(torch, parent):
    """3l. With ``parent`` (a checkout of the parent commit): kernel 3 at
    its path shapes (bf16 at full width, the training batch and a rank's
    channels; fp32 at full width) and kernel 6's fp32 projections at
    granite-3-2b's prefill, timed by ``tools/conv1d_matmul_times.py`` in
    the parent checkout and here in turns (parent, this, this, parent;
    ``F.conv1d`` and ``torch.matmul`` with TF32 off from the first turn
    here, after its kernel rows): per row the event, host issue and
    profiler device times of each turn, this / parent by each and this / library; the
    fp32 projections' sum against MATMUL_F32_TARGET x the parent's and
    against cuBLAS's, each target logged as met or missed (a miss is a
    finding, not a failure).  Does nothing without ``parent``."""
    if parent is None:
        log("conv1d / fp32 matmul: the parent's times not measured (run "
            "with --parent DIR, a checkout of the parent commit)")
        return
    turns = [_timing_tool("conv1d_matmul_times.py", c, *lib)
             for c, lib in ((parent, ()), (ROOT, ("--library",)),
                            (ROOT, ()), (parent, ()))]
    lib = turns[1]["library"]

    def mean(i, j, name, key="rows"):
        got = [turns[k][key].get(name) for k in (i, j)]
        return None if None in got else sum(got) / 2

    for name in turns[0]["rows"]:
        p, t = mean(0, 3, name), mean(1, 2, name)
        pd, td = mean(0, 3, name, "device"), mean(1, 2, name, "device")
        log(f"{name} in turns (parent, this, this, parent): events "
            + ", ".join(f"{x['rows'][name]:.4f}" for x in turns)
            + " ms; host issue " + ", ".join(_fmt(x["issue"].get(name))
                                             for x in turns)
            + " ms; device " + ", ".join(_fmt(x["device"].get(name))
                                         for x in turns)
            + f" ms; this / parent {t / p:.4f} by events, "
            + ("not measured" if None in (pd, td) else f"{td / pd:.4f}")
            + f" by device time; library {lib[name]:.4f} ms, this / "
            f"library {t / lib[name]:.4f}")
    mine = sum(mean(1, 2, n) for n in MATMUL_F32_ROWS)
    old = sum(mean(0, 3, n) for n in MATMUL_F32_ROWS)
    cublas = sum(lib[n] for n in MATMUL_F32_ROWS)
    log(f"matmul fp32 projections, sum of 3 in turns: this {mine:.4f} ms, "
        f"parent {old:.4f} ({mine / old:.4f}x: target <= "
        f"{MATMUL_F32_TARGET} "
        + ("met" if mine <= MATMUL_F32_TARGET * old else "missed")
        + f"), cuBLAS (TF32 off) {cublas:.4f} ({mine / cublas:.4f}x: target "
        "<= 1 " + ("met" if mine <= cublas else "missed") + ")")
    slower = [n for n in turns[0]["rows"] if n.startswith("conv1d")
              and mean(1, 2, n) > mean(0, 3, n)]
    log("conv1d in turns: no shape slower than the parent by events: "
        + ("met" if not slower else f"missed at {slower}"))


def phase_probe_families(torch, rounds: int, reps: int) -> None:
    """Phase 3i and then phase 3e, ``rounds`` times over in one process:
    each flash row ends at a device sync (``_flash_row``'s check and
    ``cuda_ms``) and is logged with its round, so a launch that faults
    (a sticky CUDA error) surfaces at the row or matmul call after it;
    under CUDA_LAUNCH_BLOCKING=1, at the faulting launch itself."""
    for i in range(1, rounds + 1):
        log(f"probe round {i} of {rounds}: phase 3i")
        phase_flash_families(torch, reps)
        torch.cuda.synchronize()
        log(f"probe round {i} of {rounds}: phase 3e")
        phase_matmul(torch, reps, max(3, reps // 10))
        torch.cuda.synchronize()
    log(f"probe: {rounds} rounds of phases 3i and 3e without a fault")


def _leaf_grad_errors(torch, model, oracle, params, batch, counter):
    """Each leaf's gradient of ``model.loss`` (the kernels) against
    ``oracle.loss`` (the plain versions) on ``params`` and ``batch``:
    (the worst relative norm error and its leaf, the kernels' launches in
    the kernel step)."""
    from repro_torch.core.tree import tree_leaves_with_path, tree_unflatten

    def grads(m):
        live = [p.detach().requires_grad_(True)
                for _, p in tree_leaves_with_path(params)]
        loss, _ = m.loss(tree_unflatten(params, live), batch)
        return torch.autograd.grad(loss, live)

    counter.LAUNCHES = 0
    got = grads(model)
    launches = counter.LAUNCHES
    want = grads(oracle)
    worst = (0.0, "")
    for (path, _), a, b in zip(tree_leaves_with_path(params), got, want):
        rel = ((a.double() - b.double()).norm()
               / b.double().norm().clamp_min(1e-30)).item()
        worst = max(worst, (rel, path))
    return worst, launches


def _lm_train_steps(torch, model, batches, scfg, counters, kname: str,
                    per_step: int, what: str) -> dict:
    """``batches`` through ``make_train_step`` from a seed-0 state of
    ``model`` on the card, each step launching ``kname`` ``per_step``
    times (or the phase fails), every loss finite: {"losses", "ms" (per
    steady step), "peak" (bytes)}; the state is freed before it
    returns."""
    import math

    from repro_torch.distributed import make_train_state, make_train_step

    gc.collect()
    torch.cuda.empty_cache()
    dev = torch.device("cuda", 0)
    step = make_train_step(model, scfg)
    state = make_train_state(model, 0, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    losses, times = [], []
    for i, batch in enumerate(batches):
        for m in counters.values():
            m.LAUNCHES = 0
        t0 = time.perf_counter()
        state, mets = step(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        n = {k: m.LAUNCHES for k, m in counters.items()}
        losses.append(float(mets["loss"]))
        want = {k: per_step if k == kname else 0 for k in counters}
        if n != want:
            fail(f"{what}: step {i} launched {n}, expected {want}")
        if not math.isfinite(losses[-1]) or float(mets["skipped"]):
            fail(f"{what}: step {i} non-finite or skipped: {losses[-1]!r}")
    peak = torch.cuda.max_memory_allocated(dev)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    steady = times[1:] or times
    return {"losses": losses, "ms": sum(steady) / len(steady), "peak": peak}


def _grad_pass(torch, model, batch, counters, kname: str) -> dict:
    """One loss and gradient of a seed-0 ``model`` on ``batch``, no
    optimizer state: {"saved" (bytes above the params once the loss is
    computed: what the backward keeps), "peak" (bytes above the params),
    "ms", "launches" of ``kname``, "loss"}."""
    from repro_torch.core.tree import tree_leaves

    gc.collect()
    torch.cuda.empty_cache()
    dev = torch.device("cuda", 0)
    params = model.init(0, dev)
    live = [p.requires_grad_(True) for p in tree_leaves(params)]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    for m in counters.values():
        m.LAUNCHES = 0
    t0 = time.perf_counter()
    loss, _ = model.loss(params, batch)
    saved = torch.cuda.memory_allocated(dev) - base
    grads = torch.autograd.grad(loss, live)
    torch.cuda.synchronize()
    out = {"ms": (time.perf_counter() - t0) * 1e3, "saved": saved,
           "peak": torch.cuda.max_memory_allocated(dev) - base,
           "launches": counters[kname].LAUNCHES,
           "loss": float(loss.detach())}
    del grads, loss, live, params
    return out


def _remat_against_none(torch, cfg, batches, scfg, counters, kname: str,
                        dots: dict) -> None:
    """The "dots" run (``dots``: its losses, ms and peak) against the same
    steps at ``remat="none"``: losses bit-equal, or no further from the
    "dots" run's than a second "none" run is from the first.  Then one
    loss and gradient without the optimizer at each remat, twice in
    turns (``_grad_pass``): the recompute's launches, the bytes the
    backward keeps once the loss is computed, "dots" below "none", the
    pass's peak above the params (the gradients' own bytes may set it, and
    the step's peak may be AdamW's: no remat moves either), and its ms."""
    from repro_torch.nn.models import build_model

    arch = cfg.name
    none = cfg.with_overrides(remat="none")
    runs = [_lm_train_steps(torch, build_model(none), batches, scfg,
                            counters, kname, cfg.n_layers,
                            f"lm train {arch} remat none")]
    gap = max(abs(a - b) for a, b in zip(dots["losses"],
                                         runs[0]["losses"]))
    if gap:
        runs.append(_lm_train_steps(torch, build_model(none), batches, scfg,
                                    counters, kname, cfg.n_layers,
                                    f"lm train {arch} remat none (again)"))
        spread = max(abs(a - b) for a, b in zip(runs[0]["losses"],
                                                runs[1]["losses"]))
        if gap > spread:
            fail(f"lm train {arch}: the dots run's losses {dots['losses']} "
                 f"are {gap!r} from the none run's {runs[0]['losses']}, "
                 f"two none runs {spread!r} apart")
    held = ("bit-equal" if not gap else
            f"within {gap!r} (two none runs {spread!r} apart)")
    log(f"lm train {arch} remat: dots {dots['ms']:.3f} ms per step, peak "
        f"{dots['peak'] / 2**30:.3f} GiB, {2 * cfg.n_layers} {kname} "
        f"launches a step; none {runs[0]['ms']:.3f} ms per step, peak "
        f"{runs[0]['peak'] / 2**30:.3f} GiB, {cfg.n_layers} a step; losses "
        f"{held}: {dots['losses']} (dots), {runs[0]['losses']} (none)")
    batch0 = {"tokens": torch.as_tensor(batches[0]["tokens"],
                                        device="cuda")}
    models = {r: build_model(cfg.with_overrides(remat=r))
              for r in ("dots", "none", "full")}
    passes = {r: [] for r in models}
    for _ in range(2):
        for r, m in models.items():
            passes[r].append(_grad_pass(torch, m, batch0, counters, kname))
    for r, got in passes.items():
        want = cfg.n_layers * (1 if r == "none" else 2)
        if any(g["launches"] != want for g in got):
            fail(f"lm train {arch} remat {r}: the gradient pass launched "
                 f"{[g['launches'] for g in got]} {kname}, expected {want}")
        if any(g["loss"] != passes["none"][0]["loss"] for g in got):
            fail(f"lm train {arch} remat {r}: the gradient pass's loss "
                 f"{[g['loss'] for g in got]} differs from none's "
                 f"{passes['none'][0]['loss']!r}")
    peak = {r: max(g["peak"] for g in got) for r, got in passes.items()}
    saved = {r: max(g["saved"] for g in got) for r, got in passes.items()}
    if saved["dots"] >= saved["none"]:
        fail(f"lm train {arch}: at remat dots the backward keeps "
             f"{saved['dots']} bytes, not fewer than none's "
             f"{saved['none']}")
    log(f"lm train {arch} remat, one loss and gradient without the "
        "optimizer (twice in turns): kept for the backward " + ", ".join(
            f"{r} {saved[r] / 2**30:.3f} GiB" for r in passes)
        + "; peak above the params " + ", ".join(
            f"{r} {peak[r] / 2**30:.3f} GiB" for r in passes)
        + "; ms " + ", ".join(
            f"{r} " + " / ".join(f"{g['ms']:.3f}" for g in got)
            for r, got in passes.items())
        + f"; {kname} launches dots {2 * cfg.n_layers}, none "
        f"{cfg.n_layers}, full {2 * cfg.n_layers}; losses bit-equal")


def phase_lm_train(torch, arch: str, reps: int):
    """Full-width ``arch`` trained in bf16 (seed-0 params, fp32 AdamW
    moments) on the ``SyntheticLMDataset`` stream through
    ``make_train_step`` at the launcher's lr, ``LM_TRAIN[arch]`` (batch,
    tokens a row, steps): each step's forward launches the path's kernel
    once per layer (the conv1d of the ssm family, flash of the dense
    family; the backward is the plain version's VJP and launches none),
    and under the config's remat ("dots" or "full") once more per layer
    in the backward's recompute; every loss and grad_norm finite, no step
    skipped; where the config's remat is not "none", the same steps at
    "none" (``_remat_against_none``); ms per step, peak
    device memory and, for mamba2-130m under ``torch.profiler``, one more
    step's device busy time and idle share.  The kernel's forward is timed at the
    training shape (``_conv1d_train_row`` / ``_flash_row``).  For mamba2-130m
    also: a first step in fp32 (TF32 off) whose every leaf's gradient
    through the kernels is within LM_GRAD_TOL (relative norm) of the
    oracle substrate's, and the checkpoint of the run after RESUME_AT
    steps, saved and resumed (``_resume``).  Returns {"launches", "row"}."""
    import math

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLMDataset
    from repro_torch.distributed import (StepConfig, make_train_state,
                                         make_train_step)
    from repro_torch.engine import ExecutionPolicy
    from repro_torch.nn.models import build_model

    gc.collect()
    torch.cuda.empty_cache()
    dev = torch.device("cuda", 0)
    B, S, steps = LM_TRAIN[arch]
    cfg = get_config(arch)
    model = build_model(cfg)
    counters = _lm_counters()
    kname = "trim_conv1d" if cfg.family == "ssm" else "flash_attention"
    counter = counters[kname]
    ds = SyntheticLMDataset(vocab=cfg.vocab, seq_len=S + 1, global_batch=B)
    batches = [ds.batch_at(i) for i in range(steps)]       # data set-up
    scfg = StepConfig(peak_lr=TRAIN_LR, warmup_steps=max(steps // 20, 5),
                      total_steps=steps)
    step = make_train_step(model, scfg)
    t0 = time.perf_counter()
    state = make_train_state(model, 0, dev)
    torch.cuda.synchronize()
    # the recompute of a remat'd period launches its kernel again
    per_step = cfg.n_layers * (1 if cfg.remat == "none" else 2)
    log(f"lm train {arch}: {cfg.param_count_estimate()} params in "
        f"{cfg.dtype}, fp32 moments, batch {B} x {S} tokens (the train_4k "
        f"cell's 256 x 4096 cut in batch and length only), {steps} steps, "
        f"remat {cfg.remat!r}; init in {time.perf_counter() - t0:.1f} s")
    saved = None
    if arch == LM_ARCH:
        import tempfile
        ckpt_dir = tempfile.mkdtemp(prefix="lm-ckpt-")
    torch.cuda.reset_peak_memory_stats(dev)
    hist, launches = [], 0
    for i, batch in enumerate(batches):
        if arch == LM_ARCH and i == RESUME_AT:
            saved = _save(torch, CheckpointManager(ckpt_dir), state, i)
        for m in counters.values():
            m.LAUNCHES = 0
        t0 = time.perf_counter()
        state, mets = step(state, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        n = {k: m.LAUNCHES for k, m in counters.items()}
        launches += n[kname]
        h = {"step": i, "ms": ms, "loss": float(mets["loss"]),
             "grad_norm": float(mets["grad_norm"]),
             "skipped": float(mets["skipped"])}
        hist.append(h)
        log(f"lm train {arch} step {i}: loss {h['loss']!r} grad_norm "
            f"{h['grad_norm']!r} ({ms:.3f} ms); launches {n}")
        if not (math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])) \
                or h["skipped"]:
            fail(f"lm train {arch}: step {i} non-finite or skipped: {h}")
        want = {k: per_step if k == kname else 0 for k in counters}
        if n != want:
            fail(f"lm train {arch}: step {i} launched {n}, expected {want} "
                 "(the forward's kernel once per layer, and once more in "
                 f"the recompute under remat {cfg.remat!r})")
    peak = torch.cuda.max_memory_allocated(dev)
    steady = hist[1:] or hist
    ms = sum(h["ms"] for h in steady) / len(steady)
    busy = ""
    if arch == LM_ARCH:
        prof = _profile(torch, f"lm train {arch} step", ms,
                        lambda: step(state, batches[-1]))
        busy = (f"; device busy {_fmt(prof and prof['busy'])} ms a step, "
                f"idle share {_fmt(prof and prof['idle'])}")
    log(f"lm train {arch}: {ms:.3f} ms per step (steps 1-{steps - 1}), "
        f"{B * S * 1e3 / ms:.1f} tokens/s; peak device memory "
        f"{peak / 2**30:.3f} GiB{busy}; {launches} {kname} launches in "
        f"{steps} steps")
    if cfg.remat != "none":
        state = None              # its memory back before the other runs
        _remat_against_none(torch, cfg, batches, scfg, counters, kname, {
            "losses": [h["loss"] for h in hist], "ms": ms, "peak": peak})
    row = (_conv1d_train_row(torch, B, S, reps) if cfg.family == "ssm" else
           _flash_row(torch, f"{arch} train", B, S, S, cfg.n_kv,
                      cfg.n_q // cfg.n_kv, cfg.head_dim, True, None, reps))
    if arch == LM_ARCH:
        del state
        _resume(torch, model, step, ds, ckpt_dir, saved, hist)
        cfg32 = cfg.with_overrides(dtype=torch.float32)
        k32 = build_model(cfg32)
        params = k32.init(0, dev)
        batch0 = {"tokens": torch.as_tensor(batches[0]["tokens"],
                                            device=dev)}
        (rel, leaf), n = _leaf_grad_errors(
            torch, k32, build_model(cfg32, policy=ExecutionPolicy("oracle")),
            params, batch0, counter)
        if n != per_step:
            fail(f"lm train {arch} fp32: {n} {kname} launches in the "
                 f"kernel step's gradient, expected {per_step}")
        if rel > LM_GRAD_TOL:
            fail(f"lm train {arch} fp32: leaf {leaf}'s gradient through the "
                 f"kernels is {rel:.3g} (relative norm) from the oracle's "
                 f"(limit {LM_GRAD_TOL})")
        log(f"lm train {arch} fp32 (TF32 off), step 0: every leaf's gradient "
            f"through the kernels within {rel:.3g} (relative norm; worst "
            f"{leaf}) of the oracle substrate's (limit {LM_GRAD_TOL}); "
            f"{n} {kname} launches")
    return {"launches": launches, "row": row}


def _save(torch, mgr, state, step: int) -> dict:
    """Save ``state`` as ``step`` through ``mgr``: the host copy, then the
    background write, each timed; the bytes on disk."""
    import os

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mgr.save(state, step)
    copy_s = time.perf_counter() - t0
    mgr.wait()
    write_s = time.perf_counter() - t0 - copy_s
    d = os.path.join(mgr.base_dir, f"step_{step}")
    nbytes = sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))
    log(f"checkpoint: step {step} saved, {nbytes} bytes in "
        f"{len(os.listdir(d)) - 2} leaf files; host copy {copy_s:.3f} s, "
        f"write {write_s:.3f} s")
    return {"dir": d, "state": state, "bytes": nbytes}


def _resume(torch, model, step, ds, ckpt_dir, saved, hist) -> None:
    """The latest committed checkpoint under ``ckpt_dir`` restored into a
    state from another seed (``CheckpointManager.restore_latest``, as
    ``train_loop`` resumes; timed, equal to the saved state bit for bit),
    then the steps after RESUME_AT taken from it: they must give the
    uninterrupted run's losses bit for bit."""
    import shutil

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core.tree import tree_leaves
    from repro_torch.distributed import make_train_state

    dev = torch.device("cuda", 0)
    other = make_train_state(model, 1, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    at, state = CheckpointManager(ckpt_dir).restore_latest(other)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    del other
    if at != RESUME_AT or not all(
            a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(
                tree_leaves(state), tree_leaves(saved["state"]))):
        fail(f"checkpoint: the state restored from step {at} differs from "
             f"the one saved at step {RESUME_AT}")
    tail = []
    for i in range(RESUME_AT, len(hist)):
        state, mets = step(state, ds.batch_at(i))
        tail.append((i, float(mets["loss"])))
    want = [(h["step"], h["loss"]) for h in hist[RESUME_AT:]]
    if tail != want:
        fail(f"checkpoint: resumed losses {tail} against the uninterrupted "
             f"run's {want}")
    log(f"checkpoint: restored {saved['bytes']} bytes from step {at} into a "
        f"seed-1 state in {restore_s:.3f} s, bit-equal to the saved state; "
        f"steps {RESUME_AT}-{len(hist) - 1} from it gave the uninterrupted "
        f"run's losses bit for bit ({[loss for _, loss in tail]})")


#: Phase 22 (the mesh arm at world 1): VGG-16's steps and batch (phase 6's)
#: and mamba2-130m's (phase 11's), and the int8 bound of the compressed
#: step's first gradient norm against the uncompressed one's
MESH_VGG_STEPS, MESH_LM_STEPS = 4, 4
INT8_REL = 0.02
#: Phase 23 (the sequence-sharded decode across 2 ranks): one attention
#: layer of llava-next-34b in decode at full width: batch, q heads, KV
#: heads, head dim, the unrepeated cache's positions, the position written
#: and each row's kv_length (one row past the written token, one inside
#: each rank's half, one inside rank 0's only)
SEQ_B, SEQ_NQ, SEQ_NKV, SEQ_D, SEQ_S = 4, 56, 8, 128, 4128
SEQ_POS = 4100
SEQ_KVL = (4101, 3000, 2065, 100)
SEQ_RANKS = 2
#: the fp32 lane of phase 23 against the plain oracle
SEQ_F32_TOL = 2e-5
#: the partial entry's row max and sum against its plain version (relative,
#: rows with a visible key), as the card test of the entry holds them
PARTIAL_STAT_REL = 1e-5
#: Phase 24: the launcher under torchrun (its own time limit)
LAUNCHER_ARGS = ("--arch", "mamba2-130m", "--compress-grads", "--steps",
                 "4")
LAUNCHER_TIMEOUT = 300


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _mesh_run(torch, step, state, batches, counters):
    """``step`` over ``batches`` from ``state``: [(ms, metrics as floats,
    launches by counter)], the last state."""
    hist = []
    for b in batches:
        for m in counters.values():
            for k in m[1]:
                setattr(m[0], k, 0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, mets = step(state, b)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        hist.append((ms, {k: float(v) for k, v in mets.items()},
                     {name: getattr(m[0], m[1][0])
                      for name, m in counters.items()}))
    return hist, state


def phase_mesh_world1(torch) -> dict:
    """Phase 22: the mesh arm of the train step at world 1, NCCL, a (1, 1)
    ("data", "model") ``DeviceMesh`` on cuda, DTensor state.  Full-width
    VGG-16 at batch 8 trains MESH_VGG_STEPS steps through kernels 1 and 2
    from one init: on one device, on the mesh, and on the mesh with
    ``compress_grads`` (error feedback on): every loss and grad_norm
    finite, the launches the one-device step's (13 forward + 12 dx conv,
    13 wgrad a step); the mesh's losses and grad_norms equal the
    one-device step's bit for bit; the compressed step's first loss equal
    and its first grad_norm within INT8_REL.  Then full-width
    mamba2-130m in bf16, batch 4 x 1024, MESH_LM_STEPS steps with
    ``compress_grads`` and error feedback: the conv1d kernel launched
    once per layer a step, every loss finite; ms per step, peak device
    memory, the EF tree's bytes and the collectives' bytes a step.
    Returns the launches {"conv2d", "wgrad", "conv1d"} of the mesh
    runs."""
    import math

    import torch.distributed as dist

    from repro_torch.configs import CNN_REGISTRY, get_config
    from repro_torch.core.tree import tree_leaves
    from repro_torch.data.pipeline import (SyntheticImageDataset,
                                           SyntheticLMDataset)
    from repro_torch.distributed import (StepConfig, activate_mesh, add_ef,
                                         make_train_state, make_train_step,
                                         place_state, state_pspec)
    from repro_torch.distributed import compression
    from repro_torch.engine import ExecutionPolicy, plan_model
    from repro_torch.kernels import trim_conv1d as k1d
    from repro_torch.kernels import trim_conv2d as kern
    from repro_torch.kernels import trim_conv2d_vjp as vjp
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.nn.models import build_model

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    dev = torch.device("cuda", 0)
    dist.init_process_group("nccl", init_method="tcp://localhost:"
                            f"{_free_port()}", world_size=1, rank=0)
    try:
        mesh = make_host_mesh(model=1, device="cuda")
        cfg = CNN_REGISTRY["vgg16"]
        n_conv = len(cfg.layers)
        plan = plan_model(cfg, ExecutionPolicy())
        ds = SyntheticImageDataset(hw=cfg.input_hw, channels=cfg.layers[0].M,
                                   n_classes=cfg.n_classes,
                                   global_batch=TRAIN_BATCH, seed=0)
        batches = [ds.batch_at(i) for i in range(MESH_VGG_STEPS)]
        state0 = make_train_state(plan, 0, dev)
        with activate_mesh(mesh) as ctx:
            specs = state_pspec(state0, ctx)
        counters = {"conv2d": (kern, ("LAUNCHES",)),
                    "wgrad": (vjp, ("WGRAD_LAUNCHES",))}
        runs = {}
        for name, compress in (("one device", None), ("mesh", False),
                               ("mesh, int8 gradients", True)):
            scfg = StepConfig(peak_lr=TRAIN_LR, warmup_steps=5,
                              total_steps=MESH_VGG_STEPS,
                              compress_grads=bool(compress))
            if compress is None:
                state, m = state0, None
            else:
                state, m = place_state(state0, specs, mesh), mesh
                if compress:
                    state = add_ef(state, mesh)
            runs[name], _ = _mesh_run(torch, make_train_step(plan, scfg, m),
                                      state, batches, counters)
            del state
        for name, hist in runs.items():
            for i, (ms, mets, n) in enumerate(hist):
                log(f"mesh world 1, vgg16 batch {TRAIN_BATCH} ({name}) step "
                    f"{i}: loss {mets['loss']!r} grad_norm "
                    f"{mets['grad_norm']!r} ({ms:.3f} ms); launches {n}")
                if not (math.isfinite(mets["loss"])
                        and math.isfinite(mets["grad_norm"])) \
                        or mets["skipped"]:
                    fail(f"mesh world 1 ({name}): step {i} non-finite or "
                         f"skipped: {mets}")
                if n != {"conv2d": 2 * n_conv - 1, "wgrad": n_conv}:
                    fail(f"mesh world 1 ({name}): step {i} launched {n}, "
                         f"expected {2 * n_conv - 1} conv and {n_conv} "
                         "wgrad launches")
        one, mesh_u, mesh_c = (runs[k] for k in runs)
        for (_, a, _), (_, b, _) in zip(one, mesh_u):
            if (a["loss"], a["grad_norm"]) != (b["loss"], b["grad_norm"]):
                fail(f"mesh world 1: the mesh step's loss/grad_norm "
                     f"{b['loss']!r}/{b['grad_norm']!r} differ from the "
                     f"one-device step's {a['loss']!r}/{a['grad_norm']!r}")
        a, c = one[0][1], mesh_c[0][1]
        rel = abs(c["grad_norm"] - a["grad_norm"]) / a["grad_norm"]
        if c["loss"] != a["loss"] or rel > INT8_REL:
            fail(f"mesh world 1: the compressed step's first loss "
                 f"{c['loss']!r} (one device {a['loss']!r}) or grad_norm "
                 f"rel {rel:.3g} (limit {INT8_REL})")
        ms = {k: sum(h[0] for h in v[1:]) / len(v[1:])
              for k, v in runs.items()}
        log(f"mesh world 1, vgg16 batch {TRAIN_BATCH}: ms per step (steps "
            f"1-{MESH_VGG_STEPS - 1}): one device {ms['one device']:.3f}, "
            f"mesh {ms['mesh']:.3f}, mesh with int8 gradients "
            f"{ms['mesh, int8 gradients']:.3f}; the mesh's losses and "
            f"grad_norms equal the one-device step's bit for bit; the "
            f"compressed step's first grad_norm within {rel:.3g} of it")
        launches = {"conv2d": sum(h[2]["conv2d"] for k in list(runs)[1:]
                                  for h in runs[k]),
                    "wgrad": sum(h[2]["wgrad"] for k in list(runs)[1:]
                                 for h in runs[k])}
        del runs
        gc.collect()
        torch.cuda.empty_cache()

        # mamba2-130m, int8 gradients with error feedback
        lcfg = get_config(LM_ARCH)
        model = build_model(lcfg)
        B, S, _ = LM_TRAIN[LM_ARCH]
        lds = SyntheticLMDataset(vocab=lcfg.vocab, seq_len=S + 1,
                                 global_batch=B)
        lbatches = [lds.batch_at(i) for i in range(MESH_LM_STEPS)]
        scfg = StepConfig(peak_lr=TRAIN_LR, warmup_steps=5,
                          total_steps=MESH_LM_STEPS, compress_grads=True)
        state = make_train_state(model, 0, dev)
        with activate_mesh(mesh) as ctx:
            state = add_ef(place_state(state, state_pspec(state, ctx), mesh),
                           mesh)
        ef_bytes = sum(t.numel() * t.element_size()
                       for t in tree_leaves(state["ef"]))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        step = make_train_step(model, scfg, mesh)
        hist, wire = [], []
        conv1d = 0
        for i, b in enumerate(lbatches):
            compression.reset_counters()
            k1d.LAUNCHES = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, mets = step(state, b)
            torch.cuda.synchronize()
            ms_i = (time.perf_counter() - t0) * 1e3
            wire.append((compression.WIRE_BYTES, compression.PLAIN_BYTES,
                         compression.PLAIN_LEAVES))
            conv1d += k1d.LAUNCHES
            hist.append(ms_i)
            log(f"mesh world 1, {LM_ARCH} bf16 batch {B} x {S} (int8 "
                f"gradients, error feedback) step {i}: loss "
                f"{float(mets['loss'])!r} grad_norm "
                f"{float(mets['grad_norm'])!r} ({ms_i:.3f} ms); conv1d "
                f"launches {k1d.LAUNCHES}; wire {wire[-1][0]} B (a plain "
                f"fp32 all-reduce: {wire[-1][1]} B; {wire[-1][2]} leaves on "
                "the plain all-reduce)")
            if not math.isfinite(float(mets["loss"])) or float(
                    mets["skipped"]):
                fail(f"mesh world 1 {LM_ARCH}: step {i} non-finite or "
                     "skipped")
            # once per layer, and once more in the recompute under remat
            want = lcfg.n_layers * (1 if lcfg.remat == "none" else 2)
            if k1d.LAUNCHES != want:
                fail(f"mesh world 1 {LM_ARCH}: step {i} launched conv1d "
                     f"{k1d.LAUNCHES} times, expected {want} (remat "
                     f"{lcfg.remat!r})")
        ef_norm = math.sqrt(sum(float((t.float() ** 2).sum())
                                for t in tree_leaves(state["ef"])))
        peak = torch.cuda.max_memory_allocated(dev)
        ms_lm = sum(hist[1:]) / len(hist[1:])
        log(f"mesh world 1, {LM_ARCH}: {ms_lm:.3f} ms per step (steps 1-"
            f"{MESH_LM_STEPS - 1}); peak device memory {peak / 2**30:.3f} "
            f"GiB; the EF tree {ef_bytes} B fp32 (norm {ef_norm:.6g} after "
            f"{MESH_LM_STEPS} steps); {wire[-1][0]} wire bytes a step "
            f"({wire[-1][1]} for a plain fp32 all-reduce's payload)")
        if not ef_norm > 0:
            fail(f"mesh world 1 {LM_ARCH}: the error feedback is zero")
        launches["conv1d"] = conv1d
        del state
    finally:
        dist.destroy_process_group()
    log(f"phase 22 took {time.perf_counter() - t_phase:.1f} s")
    return launches


def _seqshard_rank(rank: int, d: str) -> None:
    """One of phase 23's ranks (a spawned process): gloo, the card shared;
    writes what it measured, or the failure, under ``d`` (a fatal signal
    prints the rank's Python stack)."""
    import faulthandler
    import json as _json
    import os
    import traceback

    faulthandler.enable()

    sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as dist

    out = {}
    try:
        torch.cuda.set_device(0)
        dist.init_process_group("gloo", init_method="file://" + os.path.join(
            d, "store"), rank=rank, world_size=SEQ_RANKS)
        out = _seqshard_work(torch, dist, rank)
    except Exception:                                # noqa: BLE001
        out = {"error": traceback.format_exc()}
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        with open(os.path.join(d, f"rank{rank}.json"), "w") as f:
            _json.dump(out, f)


def _seq_layer(torch, dev, mesh, dtype, tp_params: bool):
    """One llava-next-34b attention layer in decode at full width (q 56
    heads, 8 KV heads of 128, d_model 7168, batch 4), random from seed 23,
    and its unrepeated decode cache of SEQ_S positions, plain on ``dev``
    and placed on ``mesh`` as serving places them: the cache (stacked as
    the model stacks it, one period) by ``cache_pspec``, x by the batch
    rule, the params by ``param_pspec`` where ``tp_params``, else whole on
    every rank.  Returns (lay, params, {x, k, v, q: an extra q for the
    entry's own check}, the params, x and per-layer cache on the mesh,
    the layer's decode keywords)."""
    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_map
    from repro_torch.distributed import activate_mesh, cache_pspec, \
        place_state
    from repro_torch.distributed.sharding import P, logical_to_spec, \
        param_pspec
    from repro_torch.nn.attention import KVCache, attn_layout, \
        init_attention

    cfg = get_config(VLM_ARCH)
    if (cfg.n_q, cfg.n_kv, cfg.head_dim) != (SEQ_NQ, SEQ_NKV, SEQ_D):
        raise RuntimeError(f"{VLM_ARCH}'s heads are not phase 23's")
    params = {k: {"kernel": w["kernel"].to(dtype)} for k, w in init_attention(
        torch.Generator(device=dev).manual_seed(23), cfg.d_model, SEQ_NQ,
        SEQ_NKV, SEQ_D, device=dev).items()}
    gen = torch.Generator(device="cpu").manual_seed(23)
    t = {k: torch.randn(shape, generator=gen).to(dev, dtype) for k, shape in (
        ("x", (SEQ_B, 1, cfg.d_model)),
        ("k", (SEQ_B, SEQ_S, SEQ_NKV, SEQ_D)),
        ("v", (SEQ_B, SEQ_S, SEQ_NKV, SEQ_D)),
        ("q", (SEQ_B, 1, SEQ_NKV, SEQ_NQ // SEQ_NKV, SEQ_D)))}
    with activate_mesh(mesh) as ctx:
        pspec = (param_pspec(params, ctx) if tp_params
                 else tree_map(lambda _: P(), params))
        p_d = place_state(params, pspec, mesh)
        stacked = {"kv_seq": KVCache(t["k"][None].clone(),
                                     t["v"][None].clone())}
        c_d = place_state(stacked, cache_pspec(stacked, ctx), mesh)
        x_d = place_state({"x": t["x"]}, {"x": logical_to_spec(
            ["batch", None, None], t["x"].shape, ctx)}, mesh)["x"]
    kw = dict(positions=torch.full((SEQ_B, 1), SEQ_POS, device=dev),
              mode="decode", cache_pos=SEQ_POS,
              kv_length=torch.tensor(SEQ_KVL, dtype=torch.int32, device=dev),
              kv_seqshard="model")
    return (attn_layout(SEQ_NQ, SEQ_NKV, SEQ_D), params, t, p_d, x_d,
            KVCache(c_d["kv_seq"].k[0], c_d["kv_seq"].v[0]), kw)


def _seqshard_work(torch, dist, rank: int) -> dict:
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.distributed import activate_mesh
    from repro_torch.engine.policy import ExecutionPolicy, fp32_ieee
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.nn.attention import KVCache, attention

    fp32_ieee()
    dev = torch.device("cuda", 0)
    S_loc = SEQ_S // SEQ_RANKS
    lo = rank * S_loc
    mesh = init_device_mesh("cuda", (1, SEQ_RANKS),
                            mesh_dim_names=("data", "model"))
    res = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).replace("torch.", "")
        # the weights whole on each rank: with them cut (param_pspec),
        # o_proj's partial sums would be reduced by DTensor's functional
        # all_reduce, which faults over gloo on CUDA tensors (torch 2.11);
        # the --cards run places them by param_pspec over NCCL
        lay, params, t, p_d, x_d, cache, kw = _seq_layer(
            torch, dev, mesh, dtype, tp_params=False)
        kvl = kw["kv_length"]
        fa.PARTIAL_LAUNCHES = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            with activate_mesh(mesh), torch.no_grad():
                out, cache = attention(p_d, x_d, lay, cache=cache, **kw)
                out = out.full_tensor()
        except RuntimeError as e:
            raise RuntimeError(
                f"the layer's collectives on {dtype} CUDA tensors over gloo "
                f"(all_gather_into_tensor of q, all_reduce MAX and SUM of "
                f"the merge) failed: {e}") from e
        torch.cuda.synchronize()
        arm_ms = (time.perf_counter() - t0) * 1e3
        launches = fa.PARTIAL_LAUNCHES
        k_loc, v_loc = cache.k.to_local(), cache.v.to_local()
        # the one-device layer over the whole cache: kernel 5's split
        # decode in bf16, the plain oracle in fp32
        ref = KVCache(t["k"].clone(), t["v"].clone())
        pol = (None if dtype == torch.bfloat16
               else ExecutionPolicy(substrate="oracle"))
        with torch.no_grad():
            want, ref = attention(params, t["x"], lay, cache=ref,
                                  policy=pol, **kw)
        got, want = out.float(), want.float()
        diff = (got - want).abs()
        row_max = want.abs().amax(dim=-1, keepdim=True)
        # the half as it was but at the token's row, if this rank owns
        # it: there the reference's new K and V, up to the projections'
        # rounding
        own = lo <= SEQ_POS < lo + S_loc
        rest = torch.ones(S_loc, dtype=torch.bool, device=dev)
        if own:
            rest[SEQ_POS - lo] = False
        cache_ok, token_rel = True, 0.0
        for got_c, was, want_c in ((k_loc, t["k"], ref.k),
                                   (v_loc, t["v"], ref.v)):
            cache_ok &= bool(torch.equal(got_c[:, rest],
                                         was[:, lo:lo + S_loc][:, rest]))
            if own:
                row = want_c[:, SEQ_POS].float()
                token_rel = max(token_rel, float(
                    (got_c[:, SEQ_POS - lo].float() - row).abs().max()
                    / row.abs().max()))
        # the entry against its plain version on this rank's half
        loc_len = torch.clamp(kvl - lo, 0, S_loc)
        qg = t["q"]
        kp = fa.flash_attention_partial(qg, k_loc, v_loc, loc_len)
        pp = fa.flash_partial_plain(qg, k_loc, v_loc, loc_len)
        vis = pp[2] > 0
        o_diff = (kp[0].float() - pp[0].float()).abs()
        o_row = pp[0].float().abs().amax(dim=-1, keepdim=True)
        r = {"launches": launches, "arm_ms": arm_ms,
             "max_abs_err": float(diff.max()),
             "row_ulps": float((diff / (row_max * 2.0 ** -7)
                                ).nan_to_num(0.0).max()),
             "cache_ok": cache_ok, "token_rel": token_rel,
             "entry_o_err": float(o_diff.max()),
             "entry_o_row_ulps": float(((o_diff - 1e-6).clamp(min=0)
                                        / (o_row * 2.0 ** -7)
                                        ).nan_to_num(0.0).max()),
             "entry_m_rel": float(((kp[1] - pp[1]).abs() * vis).max())
             / max(float(pp[1][vis].abs().max()), 1e-30),
             "entry_l_rel": float(((kp[2] - pp[2]).abs()
                                   / pp[2].clamp(min=1e-20) * vis).max())}
        if rank == 0:
            reps = 50
            r["ms"] = cuda_ms(torch, lambda: fa.flash_attention_partial(
                qg, k_loc, v_loc, loc_len), reps)
            r["plain_ms"] = cuda_ms(torch, lambda: fa.flash_partial_plain(
                qg, k_loc, v_loc, loc_len), max(3, reps // 10))
            r.update(_partial_library(torch, qg, k_loc, v_loc, loc_len, kp,
                                      reps))
            # each input read once and each output written once: the keys
            # and values this run's kv_length leaves visible on the half
            # (the kernel skips the rest), q, the output and its two
            # statistics; the two products over the visible keys
            keys = int(loc_len.sum())
            nbytes = (2 * keys * SEQ_NKV * SEQ_D + 2 * qg.numel()
                      ) * k_loc.element_size() + 2 * qg.numel() // SEQ_D * 4
            macs = 2 * keys * SEQ_NQ * SEQ_D
            r.update(bound(macs, nbytes, integer=False,
                           peak=PEAK_BF16 if dtype == torch.bfloat16
                           else PEAK_FP32))
        res[name] = r
    return res


def _partial_library(torch, qg, k, v, length, kp, reps: int) -> dict:
    """One PyTorch call that computes the partial entry's function on the
    same half: SDPA's memory-efficient attention with its log-sum-exp
    (lse = m + log l, all the cross-rank merge needs), the KV heads
    repeated and kv_length as an additive mask.  Its ms, and how far its
    output and lse lie from the entry's (logged, not gated: it is used
    nowhere in the port)."""
    B, _, H, G, D = qg.shape
    S = k.shape[1]
    qt = qg.reshape(B, 1, H * G, D).transpose(1, 2)
    kt = k.repeat_interleave(G, dim=2).transpose(1, 2)
    vt = v.repeat_interleave(G, dim=2).transpose(1, 2)
    keep = torch.arange(S, device=k.device)[None] < length[:, None]
    bias = torch.zeros((B, S), dtype=qg.dtype, device=k.device).masked_fill(
        ~keep, float("-inf"))[:, None, None].expand(B, H * G, 1, S)
    bias = bias.contiguous()

    def lib():
        return torch.ops.aten._scaled_dot_product_efficient_attention(
            qt, kt, vt, bias, True)
    o, lse = lib()[:2]
    o = o.transpose(1, 2).reshape(kp[0].shape).float()
    lse = lse[..., :1].reshape(kp[1].shape)
    vis = kp[2] > 0
    want = kp[1] + torch.log(kp[2].clamp(min=1e-30))
    return {"library_ms": cuda_ms(torch, lib, reps),
            "library_o_diff": float((o - kp[0].float()).abs().max()),
            "library_lse_diff": float(((lse - want).abs() * vis).max())}


def phase_seqshard_ranks(torch) -> dict:
    """Phase 23: the sequence-sharded decode across SEQ_RANKS ranks on the
    one card, through the entry point serving calls: ``torch.
    multiprocessing`` spawns the ranks, which join a gloo group (NCCL
    refuses two ranks on one device) and a ("data", "model") = (1, 2)
    ``DeviceMesh`` on cuda.  Each places one llava-next-34b attention
    layer at full width (q 56 heads, 8 KV heads of 128, d_model 7168) by
    ``param_pspec``, its unrepeated decode cache (batch 4, 4128
    positions, 2 x 2064) by ``cache_pspec``, and calls ``attention(...,
    mode="decode", kv_seqshard="model")`` under ``activate_mesh`` with a
    kv_length per row: the token is written where a rank owns its
    position, each rank launches kernel 5's partial entry once on its
    half, and the partials merge over gloo.  Checked: bf16, the layer's
    output against the one-device layer over the whole cache (kernel 5's
    split decode) within 2e-2 and BF16_ROW_ULPS x 2^-7 of each row's
    max|reference|; fp32 (the entry's fp32 lane) against the one-device
    layer on the plain oracle within SEQ_F32_TOL; each rank's cache half
    unchanged but at the token's row, where the owner wrote the
    reference's new K and V (within BF16_ROW_ULPS x 2^-7 of the row's
    max in bf16, PARTIAL_STAT_REL in fp32); the entry against
    its plain version on each half at this shape (the output within
    BF16_ROW_ULPS x 2^-7 of each row's max in bf16, SEQ_F32_TOL in fp32;
    m and l within PARTIAL_STAT_REL, relative, on rows with a visible
    key).  A collective gloo refuses fails the phase by name.  Returns
    {dtype: the kernels-line numbers}."""
    import json as _json
    import tempfile

    import torch.multiprocessing as mp

    t_phase = time.perf_counter()
    d = tempfile.mkdtemp(prefix="seqshard-")
    mp.spawn(_seqshard_rank, args=(d,), nprocs=SEQ_RANKS)
    ranks = []
    for r in range(SEQ_RANKS):
        with open(f"{d}/rank{r}.json") as f:
            ranks.append(_json.load(f))
    for r, res in enumerate(ranks):
        if "error" in res:
            fail(f"seqshard across ranks: rank {r} failed:\n{res['error']}")
    out = {}
    for name in ("bfloat16", "float32"):
        rows = [res[name] for res in ranks]
        r0 = rows[0]
        worst = max(r["max_abs_err"] for r in rows)
        ulps = max(r["row_ulps"] for r in rows)
        launches = sum(r["launches"] for r in rows)
        entry = {k: max(r[k] for r in rows) for k in (
            "entry_o_err", "entry_o_row_ulps", "entry_m_rel", "entry_l_rel")}
        log(f"seqshard across {SEQ_RANKS} ranks ({name}): the layer's "
            f"output max|diff| {worst:.3g} ({ulps:.3g} x 2^-7 of a row's "
            f"max) against the one-device layer "
            f"({'split decode' if name == 'bfloat16' else 'plain oracle'}); "
            f"caches {'kept' if all(r['cache_ok'] for r in rows) else 'CHANGED'} "
            f"but the token's row, written within "
            f"{max(r['token_rel'] for r in rows):.3g} of its max; "
            f"the entry against its plain version on each half: o "
            f"{entry['entry_o_err']:.3g} ({entry['entry_o_row_ulps']:.3g} "
            f"x 2^-7 of a row's max), m {entry['entry_m_rel']:.3g} and l "
            f"{entry['entry_l_rel']:.3g} relative; {launches} partial "
            f"launches; the layer took {r0['arm_ms']:.3f} ms on rank 0 "
            f"(first call, gloo included); the entry {r0['ms']:.4f} ms on "
            f"a half, plain {r0['plain_ms']:.4f} ms, SDPA with lse "
            f"{r0['library_ms']:.4f} ms (its o {r0['library_o_diff']:.3g}, "
            f"lse {r0['library_lse_diff']:.3g} from the entry's), bound "
            f"{r0['bound_ms']:.4f} ms ({r0['bound_by']})")
        token_tol = (BF16_ROW_ULPS * 2.0 ** -7 if name == "bfloat16"
                     else PARTIAL_STAT_REL)
        if not all(r["cache_ok"] for r in rows) or max(
                r["token_rel"] for r in rows) > token_tol:
            fail(f"seqshard across ranks ({name}): a rank's cache half "
                 "changed but at the token's row, or the token's K/V lie "
                 f"more than {token_tol:.3g} of the row's max from the "
                 "reference's")
        if launches != SEQ_RANKS:
            fail(f"seqshard across ranks ({name}): {launches} partial "
                 f"launches, expected one a rank ({SEQ_RANKS})")
        if name == "bfloat16":
            if worst > 2e-2 or ulps > BF16_ROW_ULPS:
                fail(f"seqshard across ranks: bf16 layer {worst:.3g} / "
                     f"{ulps:.3g} row ulps (limits 2e-2, {BF16_ROW_ULPS})")
            if entry["entry_o_row_ulps"] > BF16_ROW_ULPS:
                fail(f"seqshard across ranks: the bf16 entry's output "
                     f"{entry['entry_o_row_ulps']:.3g} row ulps from its "
                     f"plain version (limit {BF16_ROW_ULPS})")
        else:
            if worst > SEQ_F32_TOL:
                fail(f"seqshard across ranks: fp32 layer {worst:.3g} "
                     f"(limit {SEQ_F32_TOL})")
            if entry["entry_o_err"] > SEQ_F32_TOL:
                fail(f"seqshard across ranks: the fp32 entry's output "
                     f"{entry['entry_o_err']:.3g} from its plain version "
                     f"(limit {SEQ_F32_TOL})")
        if max(entry["entry_m_rel"], entry["entry_l_rel"]) > PARTIAL_STAT_REL:
            fail(f"seqshard across ranks ({name}): the entry's m "
                 f"{entry['entry_m_rel']:.3g} / l {entry['entry_l_rel']:.3g} "
                 f"from its plain version (limit {PARTIAL_STAT_REL})")
        out[name] = {"launches": launches,
                     "max_abs_err": entry["entry_o_err"],
                     **{k: r0[k] for k in ("ms", "plain_ms", "bound_ms",
                                           "bound_by", "library_ms")}}
    log(f"phase 23 took {time.perf_counter() - t_phase:.1f} s")
    return out


def phase_launcher(torch) -> None:
    """Phase 24: ``torchrun --nproc-per-node 1 -m repro_torch.launch.train
    --arch mamba2-130m --compress-grads --steps 4`` from this script (the
    full-width model, NCCL at world 1): it exits 0, which it does only
    when every step's loss and grad_norm are finite."""
    import os

    t_phase = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(SRC))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "1", "-m", "repro_torch.launch.train",
           *LAUNCHER_ARGS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, env=env,
                              cwd=str(ROOT), timeout=LAUNCHER_TIMEOUT)
    except subprocess.TimeoutExpired:
        fail(f"launcher: {' '.join(cmd[1:])} ran past {LAUNCHER_TIMEOUT} s")
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("[tr")]
    for ln in lines:
        log(f"launcher: {ln}")
    if proc.returncode != 0 or not any(
            ln.startswith("[train] mamba2-130m on cuda") for ln in lines):
        fail(f"launcher: exit {proc.returncode}\n{proc.stdout[-3000:]}\n"
             f"{proc.stderr[-3000:]}")
    log(f"phase 24 took {time.perf_counter() - t_phase:.1f} s")


#: Phases 25-27 (the mesh arms of the moe, hybrid, vlm and encdec
#: families, and the dry-run held against the card): decode steps after
#: each prefill; the dry-run's seamless cell (name, kind, S, batch: 4 x
#: 4096 source frames, as phase 18 serves them) and how far its argument
#: bytes may lie from the card's allocation (the allocator's rounding)
FAMILY_STEPS = 3
DRYRUN_CELL = ("prefill_4k", "prefill", LM_PROMPT, LM_BATCH)
DRYRUN_ARG_REL = 0.01
#: phase 26: the ranks sharing the card over gloo on a (1, 2) mesh
SPLIT_RANKS = 2


def _family_run(torch, model, params, batch, cache, pos0, tokens=None,
                mesh=None, counter="flash_attention", warm=True):
    """A prefill and FAMILY_STEPS decode steps, one device or (``mesh``)
    through the serve launcher's ``MeshStep``: each step's logits (copied
    to the host after its timing), the greedy tokens fed (``tokens``, else
    each step's argmax), the kernel's launches in the prefill and in each
    step (``counter`` of :func:`_lm_counters`), ms of the prefill and of
    each step (host clock around work ending in ``synchronize``).  With
    ``warm``, an untimed prefill and step run first on the same cache (a
    prefill rewrites every row a later step reads)."""
    from repro_torch.distributed import make_decode_step, make_prefill_step
    from repro_torch.launch.serve import MeshStep

    kern = _lm_counters()[counter]
    prefill, decode = make_prefill_step(model), make_decode_step(model)
    if mesh is not None:
        prefill, decode = MeshStep(prefill, mesh), MeshStep(decode, mesh)
    if warm:  # a first prefill and step, untimed, on the same cache
        with torch.no_grad():
            logits, cache = prefill(params, batch, cache)
            decode(params, logits.argmax(-1), cache, pos0)
        del logits
    out = {"logits": [], "tokens": [], "launches": [], "ms": []}
    for i in range(FAMILY_STEPS + 1):
        kern.LAUNCHES = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            if i == 0:
                logits, cache = prefill(params, batch, cache)
            else:
                logits, cache = decode(params, tok, cache, pos0 + i - 1)
        torch.cuda.synchronize()
        out["ms"].append((time.perf_counter() - t0) * 1e3)
        out["launches"].append(kern.LAUNCHES)
        out["logits"].append(logits.float().cpu())
        tok = (tokens[i] if tokens is not None else logits.argmax(-1))
        out["tokens"].append(tok)
        del logits
    return out, cache


def _bit_equal(torch, one: dict, two: dict) -> tuple:
    """(every step's logits equal, the largest |difference|)."""
    pairs = list(zip(one["logits"], two["logits"]))
    return (all(torch.equal(a, b) for a, b in pairs),
            max(float((a - b).abs().max()) for a, b in pairs))


def phase_family_world1(torch) -> dict:
    """Phase 25: the encdec and moe mesh arms at world 1, NCCL, a (1, 1)
    ("data", "model") ``DeviceMesh`` on cuda, the params and caches as
    DTensors placed by ``serve_shardings`` (at world 1 every placement is
    ``Replicate()``, sharing the tensors' storage).

    - seamless-m4t-large-v2 at full width (bf16, seed-0 weights): the
      launcher's encdec inputs (LM_BATCH x LM_PROMPT seeded source frames,
      a bos) and the dry-run cell's cache (a self-KV of
      ``specs.ENCDEC_PREFILL_TGT_BUF`` rows, a cross-KV of LM_PROMPT): a
      prefill and FAMILY_STEPS decode steps on one device, then the same
      (the same tokens fed) through ``MeshStep``: every logit equal bit
      for bit; flash launched 72 times in each prefill (24 encoder, 24
      self, 24 cross) and 48 in each step.  The device memory the params,
      cache and batch took is returned for phase 27.
    - llama4-maverick-400b-a17b's one period at full width (MOE_LAYERS
      layers, 18.5 B params, the 128-expert MoE slot through the MoE mesh
      arm) on the served batch (LM_BATCH x LM_PROMPT): one device's logits
      copied to the host, the cache made anew, the same params placed (not
      copied: two 37 GB copies do not fit beside the caches), then the
      mesh run: every logit equal bit for bit; flash launched once a
      layer.

    Returns {"placed_bytes", "prefill_ms", "launches": {(arch, part):
    n}}."""
    import numpy as np
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_leaves
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.serve import _place_on_mesh
    from repro_torch.launch.specs import ENCDEC_PREFILL_TGT_BUF
    from repro_torch.nn.models import build_model

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    dev = torch.device("cuda", 0)
    dist.init_process_group("nccl", init_method="tcp://localhost:"
                            f"{_free_port()}", world_size=1, rank=0)
    res = {"launches": {}}
    try:
        mesh = make_host_mesh(model=1, device="cuda")
        cfg = get_config(ENCDEC_ARCH)
        model = build_model(cfg)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        params = model.init(0, dev)
        batch, _, pos0 = _lm_inputs(torch, model, dev)
        cache = model.init_cache(LM_BATCH, ENCDEC_PREFILL_TGT_BUF,
                                 cross_len=LM_PROMPT, dtype=torch.bfloat16,
                                 device=dev)
        torch.cuda.synchronize()
        res["placed_bytes"] = torch.cuda.memory_allocated(dev) - base
        one, cache = _family_run(torch, model, params, batch, cache, pos0)
        for t in tree_leaves(cache):
            t.zero_()
        before = torch.cuda.memory_allocated(dev)
        p2, c2 = _place_on_mesh(model, params, cache, mesh)
        grew = torch.cuda.memory_allocated(dev) - before
        two, _ = _family_run(torch, model, p2, batch, c2, pos0,
                             tokens=one["tokens"], mesh=mesh)
        same, worst = _bit_equal(torch, one, two)
        want = [cfg.n_enc_layers + 2 * cfg.n_layers] + \
            [2 * cfg.n_layers] * FAMILY_STEPS
        log(f"mesh world 1, {ENCDEC_ARCH} (encdec arm): prefill of "
            f"{LM_BATCH} x {LM_PROMPT} source frames + bos and "
            f"{FAMILY_STEPS} decode steps; logits "
            f"{'bit-equal' if same else 'DIFFERENT'} to one device's "
            f"(max |diff| {worst!r}); flash launches {two['launches']} "
            f"(one device {one['launches']}); prefill {two['ms'][0]:.3f} ms "
            f"on the mesh, {one['ms'][0]:.3f} ms on one device; decode "
            f"steps {[round(v, 3) for v in two['ms'][1:]]} ms on the mesh, "
            f"{[round(v, 3) for v in one['ms'][1:]]} on one device; the "
            f"params, cache and batch took {res['placed_bytes']} B of "
            f"device memory, placing them on the mesh {grew} B more")
        if not same:
            fail(f"mesh world 1 {ENCDEC_ARCH}: logits differ from one "
                 f"device's by up to {worst!r}")
        if two["launches"] != want or one["launches"] != want:
            fail(f"mesh world 1 {ENCDEC_ARCH}: flash launches "
                 f"{two['launches']} / {one['launches']}, expected {want}")
        res["prefill_ms"] = (two["ms"][0], one["ms"][0])
        res["launches"][(ENCDEC_ARCH, "prefill")] = two["launches"][0]
        res["launches"][(ENCDEC_ARCH, "decode")] = sum(two["launches"][1:])
        del params, cache, p2, c2, one, two
        gc.collect()
        torch.cuda.empty_cache()

        # llama4-maverick's one period: the MoE mesh arm
        mcfg = get_config(MOE_ARCH).with_overrides(n_layers=MOE_LAYERS)
        model = build_model(mcfg)
        t0 = time.perf_counter()
        params = model.init(0, dev)
        init_s = time.perf_counter() - t0
        batch, make_cache, pos0 = _lm_inputs(torch, model, dev)
        one, cache = _family_run(torch, model, params, batch, make_cache(),
                                 pos0)
        del cache
        gc.collect()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated(dev)
        p2, c2 = _place_on_mesh(model, params, make_cache(), mesh)
        grew = torch.cuda.memory_allocated(dev) - before
        torch.cuda.reset_peak_memory_stats(dev)
        two, _ = _family_run(torch, model, p2, batch, c2, pos0,
                             tokens=one["tokens"], mesh=mesh)
        peak = torch.cuda.max_memory_allocated(dev)
        same, worst = _bit_equal(torch, one, two)
        n_params = sum(t.numel() for t in tree_leaves(params))
        log(f"mesh world 1, {MOE_ARCH} (moe arm; depth cut to one period, "
            f"{MOE_LAYERS} layers, {n_params} params, init {init_s:.1f} s): "
            f"prefill of {LM_BATCH} x {LM_PROMPT} and {FAMILY_STEPS} decode "
            f"steps; logits {'bit-equal' if same else 'DIFFERENT'} to one "
            f"device's, copied to the host first (max |diff| {worst!r}); "
            f"flash launches {two['launches']}; prefill {two['ms'][0]:.3f} "
            f"ms on the mesh, {one['ms'][0]:.3f} ms on one device; decode "
            f"steps {[round(v, 3) for v in two['ms'][1:]]} ms on the mesh; "
            f"placing on the mesh took {grew} B more (the params shared); "
            f"peak {peak / 2**30:.3f} GiB in the mesh run")
        if not same:
            fail(f"mesh world 1 {MOE_ARCH}: logits differ from one device's "
                 f"by up to {worst!r}")
        want = [MOE_LAYERS] * (FAMILY_STEPS + 1)
        if two["launches"] != want:
            fail(f"mesh world 1 {MOE_ARCH}: flash launches "
                 f"{two['launches']}, expected {want}")
        res["launches"][(MOE_ARCH, "prefill")] = two["launches"][0]
        res["launches"][(MOE_ARCH, "decode")] = sum(two["launches"][1:])
        del params, p2, c2, one, two
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 25 took {time.perf_counter() - t_phase:.1f} s")
    return res


def _split_rank(rank: int, d: str) -> None:
    """One of phase 26's ranks (a spawned process): gloo, the card shared;
    writes what it measured, or the failure, under ``d``."""
    import faulthandler
    import json as _json
    import os
    import traceback

    faulthandler.enable()
    sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as dist

    out = {}
    try:
        torch.cuda.set_device(0)
        dist.init_process_group("gloo", init_method="file://" + os.path.join(
            d, "store"), rank=rank, world_size=SPLIT_RANKS)
        out = _split_work(torch, rank)
    except Exception:                                # noqa: BLE001
        out = {"error": traceback.format_exc()}
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        with open(os.path.join(d, f"rank{rank}.json"), "w") as f:
            _json.dump(out, f)


def _split_work(torch, rank: int) -> dict:
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.distributed import activate_mesh, cache_pspec, \
        place_state
    from repro_torch.distributed.sharding import P, REPLICATED_OPS
    from repro_torch.engine.policy import fp32_ieee
    from repro_torch.nn.models import build_model

    fp32_ieee()     # as the script's own process: bf16 GEMMs sum in fp32
    dev = torch.device("cuda", 0)
    mesh = init_device_mesh("cuda", (1, SPLIT_RANKS),
                            mesh_dim_names=("data", "model"))
    cfg = get_config(LM_ARCH)
    model = build_model(cfg, tp=SPLIT_RANKS)
    params = model.init(0, dev)
    batch, make_cache, pos0 = _lm_inputs(torch, model, dev)
    one, _ = _family_run(torch, model, params, batch, make_cache(), pos0,
                         counter="trim_conv1d")
    cache = make_cache()
    with activate_mesh(mesh) as ctx:
        # the weights whole on each rank (no DTensor collective runs over
        # gloo on the card); the cache cut by cache_pspec
        p2 = place_state(params, tree_map(lambda _: P(), params), mesh)
        c2 = place_state(cache, cache_pspec(cache, ctx), mesh)
    del cache
    local = {k: list(t.to_local().shape) for k, t in (
        ("ssm", c2["slot0"]["mamba"].ssm), ("conv", c2["slot0"]["mamba"].conv))}
    REPLICATED_OPS.clear()
    two, c2 = _family_run(torch, model, p2, batch, c2, pos0,
                          tokens=one["tokens"], mesh=mesh,
                          counter="trim_conv1d")
    rows = [_row_ulps(b, a) for a, b in zip(one["logits"], two["logits"])]
    res = {"row_ulps": rows,
           "max_abs": max(float((a - b).abs().max()) for a, b in zip(
               one["logits"], two["logits"])),
           "launches": two["launches"], "one_launches": one["launches"],
           "ms": two["ms"], "one_ms": one["ms"], "cache_local": local,
           "cache_global": {"ssm": list(c2["slot0"]["mamba"].ssm.shape),
                            "conv": list(c2["slot0"]["mamba"].conv.shape)},
           "replicated": sorted(REPLICATED_OPS)}
    if rank == 0:
        # the yardstick: the one-device bf16 serve against the fp32 serve
        # of the same params and tokens
        m32 = build_model(cfg.with_overrides(dtype=torch.float32),
                          tp=SPLIT_RANKS)
        b32, make32, _ = _lm_inputs(torch, m32, dev)
        f32, _ = _family_run(torch, m32, tree_map(lambda t: t.float(),
                                                  params), b32, make32(),
                             pos0, tokens=one["tokens"],
                             counter="trim_conv1d", warm=False)
        res["bf16_row_ulps"] = [_row_ulps(a, b) for a, b in zip(
            one["logits"], f32["logits"])]
        res["mesh_f32_row_ulps"] = [_row_ulps(a, b) for a, b in zip(
            two["logits"], f32["logits"])]
        del f32
        # kernel 3 at each rank's shape: half the conv channels
        dims = model.spec.dims
        CC = dims.conv_channels
        gen = torch.Generator(device=dev).manual_seed(26)
        x = torch.randn(LM_BATCH, LM_PROMPT, CC // SPLIT_RANKS,
                        generator=gen, device=dev).to(torch.bfloat16)
        w = (torch.randn(dims.d_conv, CC // SPLIT_RANKS, generator=gen,
                         device=dev) * dims.d_conv ** -0.5).to(torch.bfloat16)
        from repro_torch.kernels.trim_conv1d import (trim_conv1d,
                                                     trim_conv1d_plain)
        got, want = trim_conv1d(x, w), trim_conv1d_plain(x, w)
        row = _conv1d_row(torch, x, w, 20, "rank")
        row["max_abs_err"] = float((got.float() - want.float()).abs().max())
        row["shape"] = list(row["shape"])
        res["conv_row"] = row
    return res


def phase_split_ranks(torch) -> dict:
    """Phase 26: the Mamba slot's prefill and decode with the heads cut,
    across SPLIT_RANKS ranks on the one card: ``torch.multiprocessing``
    spawns them into a gloo group (NCCL refuses two ranks on one device)
    and a ("data", "model") = (1, 2) ``DeviceMesh`` on cuda.  Each serves
    full-width mamba2-130m (bf16, seed-0 weights, LM_BATCH x LM_PROMPT
    tokens, FAMILY_STEPS decode steps fed the one-device run's tokens)
    through ``MeshStep``, the weights whole on each rank and the cache cut
    by ``cache_pspec`` (12 of the 24 SSD heads, 896 of the 1792 conv
    channels a rank): each rank launches kernel 3 once a layer in the
    prefill on its channels, gathers them with c10d, runs the SSD on its
    heads, writes its cache shards in place and sums the row-parallel
    out_proj over gloo.  Checked: kernel 3's launches (24 a prefill on
    each rank, none in decode), the cache's local shards half the global,
    and each step's logits no farther from the one-device bf16 serve (in
    units of 2^-7 x each row's max|logit|) than that serve lies from the
    fp32 serve of the same params and tokens: the partial sums are added
    in another order, and at full width that reordering moves the
    logits as far as bf16's own rounding does.  Kernel 3 is timed on rank 0 at a rank's shape
    against its plain version and bound.  Returns rank 0's kernel row
    with the launches of both ranks."""
    import json as _json
    import tempfile

    import torch.multiprocessing as mp

    t_phase = time.perf_counter()
    d = tempfile.mkdtemp(prefix="split-")
    mp.spawn(_split_rank, args=(d,), nprocs=SPLIT_RANKS)
    ranks = []
    for r in range(SPLIT_RANKS):
        with open(f"{d}/rank{r}.json") as f:
            ranks.append(_json.load(f))
    for r, res in enumerate(ranks):
        if "error" in res:
            fail(f"split ranks: rank {r} failed:\n{res['error']}")
    r0 = ranks[0]
    ulps = max(max(r["row_ulps"]) for r in ranks)
    limit = max(r0["bf16_row_ulps"])
    log(f"{LM_ARCH} across {SPLIT_RANKS} ranks (1, {SPLIT_RANKS}) on the "
        f"card over gloo, the heads cut: logits within {ulps:.4g} x 2^-7 of "
        f"each row's max (per step {[round(v, 4) for v in r0['row_ulps']]};"
        f" max |diff| {r0['max_abs']!r}) of the one-device bf16 serve; the "
        f"one-device bf16 serve itself within "
        f"{[round(v, 4) for v in r0['bf16_row_ulps']]} of its fp32 serve, "
        f"the mesh within {[round(v, 4) for v in r0['mesh_f32_row_ulps']]};"
        f" conv1d "
        f"launches {[r['launches'] for r in ranks]} by rank (one device "
        f"{r0['one_launches']}); local cache shards {r0['cache_local']} of "
        f"{r0['cache_global']}; gathered ops {r0['replicated']}; prefill "
        f"{r0['ms'][0]:.3f} ms on rank 0 (gloo included), one device "
        f"{r0['one_ms'][0]:.3f} ms; decode steps "
        f"{[round(v, 3) for v in r0['ms'][1:]]} ms")
    row = r0["conv_row"]
    log(f"conv1d at a rank's shape {row['shape']}: ms {row['ms']:.4f} "
        f"device_ms {_fmt(row['device_ms'])} issue_ms {row['issue_ms']:.4f} "
        f"cold device_ms {_fmt(row['device_ms_cold'])} plain "
        f"{row['plain_ms']:.4f} library {row['library_ms']:.4f} bound "
        f"{row['bound_ms']:.4f} ({row['bound_by']}); max |kernel - plain| "
        f"{row['max_abs_err']!r}")
    from repro_torch.configs import get_config

    L = get_config(LM_ARCH).n_layers
    for r, res in enumerate(ranks):
        if res["launches"] != [L] + [0] * FAMILY_STEPS:
            fail(f"split ranks: rank {r} launched conv1d {res['launches']}, "
                 f"expected {L} in the prefill and none in decode")
    if ulps > limit:
        fail(f"split ranks: logits {ulps:.4g} x 2^-7 of a row's max from "
             f"the one-device bf16 serve, farther than that serve from its "
             f"fp32 serve ({limit:.4g})")
    g, loc = r0["cache_global"], r0["cache_local"]
    # (periods, B, H, P, S) and (periods, B, K - 1, channels)
    if loc["ssm"][2] * SPLIT_RANKS != g["ssm"][2] \
            or loc["conv"][3] * SPLIT_RANKS != g["conv"][3]:
        fail(f"split ranks: cache shards {loc} not half of {g}")
    if row["max_abs_err"] != 0.0:
        fail(f"split ranks: kernel 3 at a rank's shape differs from its "
             f"plain version by {row['max_abs_err']!r}")
    log(f"phase 26 took {time.perf_counter() - t_phase:.1f} s")
    return {**row, "launches": sum(r["launches"][0] for r in ranks)}


def _row_ulps(got, want) -> float:
    """max |got - want| over each row, in units of 2^-7 x the row's
    max |want| (about one to two bf16 ulps of the row's largest value)."""
    return float(((got - want).abs() / (want.abs().amax(-1, keepdim=True)
                                        * 2.0 ** -7)).max())


#: the port's examples (``examples/torch/``), each run at its defaults:
#: (script, arguments, a pattern each of whose lines must be printed)
EXAMPLES = (
    ("quickstart", (), (
        r"fifo_ok=True", r"bit-exact=True",
        r"max err vs the plain conv: (?P<conv_err>\S+); kernel launches: "
        r"(?P<conv>\d+)",
        r"\(flash-attention kernel launches: (?P<flash>\d+)\)",
        r"greedy decode: \[", r"\(int5, exactly 5/8\)")),
    ("serve_lm", (), (
        r"\[serve\] mamba2-130m on cuda\S*: prefill 4x32",
        r"kernel launches in the prefill: conv1d (?P<conv1d>\d+), flash "
        r"(?P<flash>\d+)", r"\[serve\] continuation\[0\]: \[")),
    ("train_cnn", (), (
        r"step  59  loss (?P<loss>\S+)",
        r"kernel launches in training: conv (?P<conv>\d+) \(forward and "
        r"dx\), wgrad (?P<wgrad>\d+)",
        r"int8 TrIM datapath: output", r"float/int8 agreement: cosine "
        r"(?P<cos>\S+)")),
    ("train_lm", (), (
        r"\[train_lm\] mamba2-15m-demo: .* on cuda",
        r"loss (?P<first>\S+) -> (?P<last>\S+) over 50 steps; conv1d "
        r"kernel launches (?P<conv1d>\d+)")),
)


def phase_examples() -> dict:
    """28. The port's four examples (``examples/torch/``) on the card, each
    a subprocess of its own at its defaults (``train_lm`` checkpointing into
    a fresh temporary directory): exit 0, every key line printed, and each
    one's kernels launched: kernel 1 in quickstart's conv, and 2 L - 1
    times a step in train_cnn's VGG-16 smoke (L forward convs, L - 1 dx)
    with kernel 2 L times; kernel 5 in quickstart's train step (granite's
    smoke); kernel 3 once a layer in serve_lm's prefill (24, mamba2-130m)
    and a step in train_lm's (8 layers, 50 steps).  Returns the launches
    each printed, by example."""
    import tempfile

    from repro_torch.configs import CNN_SMOKES

    t0 = time.perf_counter()
    seen = {}
    L = len(CNN_SMOKES["vgg16"].layers)
    want = {("serve_lm", "conv1d"): 24,
            ("serve_lm", "flash"): 0, ("train_cnn", "conv"): 60 * (2 * L - 1),
            ("train_cnn", "wgrad"): 60 * L, ("train_lm", "conv1d"): 50 * 8}
    for name, args, patterns in EXAMPLES:
        with tempfile.TemporaryDirectory() as tmp:
            extra = ("--ckpt-dir", tmp) if name == "train_lm" else ()
            t1 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, str(ROOT / "examples" / "torch" /
                                     f"{name}.py"), *args, *extra],
                env={**os.environ, "PYTHONPATH": str(SRC)},
                capture_output=True, text=True, timeout=600, cwd=ROOT)
        if proc.returncode != 0:
            fail(f"example {name}: exit {proc.returncode}: "
                 f"{proc.stderr[-2000:]}")
        got = {}
        for pat in patterns:
            m = re.search(pat, proc.stdout)
            if m is None:
                fail(f"example {name}: no line matching {pat!r} in "
                     f"{proc.stdout[-2000:]}")
            else:
                got.update(m.groupdict())
        seen[name] = got
        for (ex, key), n in want.items():
            if ex == name and int(got[key]) != n:
                fail(f"example {name}: {key} launched {got[key]} times, "
                     f"not {n}")
        if name == "quickstart" and min(int(got["conv"]),
                                        int(got["flash"])) < 1:
            fail(f"example quickstart: no conv or no flash kernel "
                 f"launched: {got}")
        last = [ln for ln in proc.stdout.splitlines() if ln.strip()][-2:]
        log(f"example {name}: exit 0 in {time.perf_counter() - t1:.1f} s; "
            f"{got}; last lines: {' | '.join(last)}")
    log(f"examples: the four ran on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    return seen


def phase_dryrun_card(torch, placed_bytes: int, prefill_ms) -> None:
    """Phase 27: the dry-run held against the card.  ``run_cell`` on a
    fake world of 1 (a one-process ``fake`` process group, a (1, 1) mesh
    on fake CPU tensors; nothing on the card) for seamless-m4t-large-v2 at
    DRYRUN_CELL: its ``argument_size_in_bytes`` (params, cache and batch,
    from the placements) within DRYRUN_ARG_REL of the device memory phase
    25's real params, cache and batch took; its calibrated flops over
    phase 25's measured prefills (``prefill_ms``: the mesh's, one
    device's), as a share of the bf16 peak, logged (not gated)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch import dryrun

    t_phase = time.perf_counter()
    dryrun._fake_world(1)
    try:
        mesh = init_device_mesh("cpu", (1, 1),
                                mesh_dim_names=("data", "model"))
        rec = dryrun.run_cell(ENCDEC_ARCH, ShapeCell(*DRYRUN_CELL), False,
                              mesh=mesh)
    finally:
        dist.destroy_process_group()
    args_b = rec["memory"]["argument_size_in_bytes"]
    rel = abs(args_b - placed_bytes) / placed_bytes
    flops = rec["cost_calibrated"]["flops"]
    share = [flops / (ms / 1e3) / PEAK_BF16 for ms in prefill_ms]
    r = rec["roofline"]
    log(f"dry-run {ENCDEC_ARCH} {DRYRUN_CELL[0]} on a fake world of 1: "
        f"argument bytes {args_b!r} against {placed_bytes} B placed on the "
        f"card (rel {rel:.3g}, limit {DRYRUN_ARG_REL}); peak "
        f"{rec['memory']['peak_memory_in_bytes']!r} B modelled; flops "
        f"{flops!r} (useful ratio {r['useful_flops_ratio']:.4f}, "
        f"sharding propagation excluded: {rec['sharding_prop_excluded']}) "
        f"over the measured prefill on the mesh {prefill_ms[0]:.3f} ms = "
        f"{share[0]:.4f}, on one device {prefill_ms[1]:.3f} ms = "
        f"{share[1]:.4f} of {PEAK_BF16:.3g} FLOP/s; the model's bound "
        f"{r['step_time_bound_s'] * 1e3:.3f} ms ({r['dominant']}; its bytes "
        f"are unfused, an upper bound); run "
        f"{time.perf_counter() - t_phase:.1f} s")
    if rel > DRYRUN_ARG_REL:
        fail(f"dry-run: argument bytes {args_b!r} vs the card's "
             f"{placed_bytes} (rel {rel:.3g} > {DRYRUN_ARG_REL})")
    log(f"phase 27 took {time.perf_counter() - t_phase:.1f} s")


#: ``--cards N``: the mesh arm across N cards of one host (NCCL, one
#: process a card): the smoke configs' (2, 2) steps held to one card's
#: step (JAX's bounds: loss 1e-4, params 5e-3), and the full-width
#: readings: VGG-16 at batch 8 and mamba2-130m at 4 x 1024 on (N, 1),
#: llava's decode layer with its cache cut N ways
CARDS_STEPS = 3
#: ``--cards``' MoE check: the cut model adds its partial sums in another
#: order, so a token whose router's top-1 and top-2 probabilities (of 128
#: experts) lie within this of each other on one card may take the other
#: expert; a token routed elsewhere at a wider margin fails
MOE_FLIP_MARGIN = 1e-2


def _cards_rank(rank: int, n: int, d: str, work: str = "cards") -> None:
    """One rank of ``--cards`` (``work`` "cards") or ``--trace-mesh``
    ("trace"): writes what it measured, or the failure."""
    import json as _json
    import os
    import traceback

    sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as dist

    out = {}
    try:
        torch.cuda.set_device(rank)
        dist.init_process_group("nccl", init_method="file://" + os.path.join(
            d, "store"), rank=rank, world_size=n,
            device_id=torch.device("cuda", rank))
        out = {"cards": _cards_work, "trace": _trace_work}[work](
            torch, dist, rank, n)
    except Exception:                                # noqa: BLE001
        out = {"error": traceback.format_exc()}
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        with open(os.path.join(d, f"rank{rank}.json"), "w") as f:
            _json.dump(out, f)


def _cards_work(torch, dist, rank: int, n: int) -> dict:
    import math

    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import CNN_REGISTRY, CNN_SMOKES, get_config, \
        get_smoke
    from repro_torch.core.tree import tree_leaves
    from repro_torch.data.pipeline import (SyntheticImageDataset,
                                           SyntheticLMDataset)
    from repro_torch.distributed import (StepConfig, activate_mesh, add_ef,
                                         gather_state, make_train_state,
                                         make_train_step, place_state,
                                         state_pspec)
    from repro_torch.distributed import compression
    from repro_torch.engine import ExecutionPolicy, plan_model
    from repro_torch.engine.policy import fp32_ieee
    from repro_torch.nn.attention import KVCache, attention
    from repro_torch.nn.models import build_model

    fp32_ieee()
    dev = torch.device("cuda", rank)
    res = {}
    square = init_device_mesh("cuda", (n // 2, 2),
                              mesh_dim_names=("data", "model"))
    flat = init_device_mesh("cuda", (n, 1), mesh_dim_names=("data", "model"))

    def place(state, mesh):
        with activate_mesh(mesh) as ctx:
            return place_state(state, state_pspec(state, ctx), mesh)

    # the smoke configs (fp32, the kernels) on (n/2, 2) against one card
    scfg = StepConfig(warmup_steps=1, total_steps=10)
    for arch in ("granite-3-2b", "mamba2-130m", "vgg16"):
        if arch == "vgg16":
            m1 = m2 = plan_model(CNN_SMOKES["vgg16"], ExecutionPolicy())
            g = torch.Generator().manual_seed(0)
            batch = {"images": torch.randn(4, 16, 16, 3, generator=g),
                     "labels": torch.randint(0, 10, (4,), generator=g)}
        else:
            cfg = get_smoke(arch)
            m1, m2 = build_model(cfg), build_model(cfg, tp=2)
            batch = SyntheticLMDataset(vocab=cfg.vocab, seq_len=17,
                                       global_batch=4).batch_at(0)
        state = make_train_state(m1, 0, dev)
        s1, k1 = make_train_step(m1, scfg)(state, batch)
        s2, k2 = make_train_step(m2, scfg, square)(place(state, square),
                                                   batch)
        full = gather_state(s2)
        res[f"smoke {arch}"] = {
            "loss": abs(float(k1["loss"]) - float(k2["loss"])),
            "params": max(float((a.float() - b.float()).abs().max())
                          for a, b in zip(tree_leaves(s1["params"]),
                                          tree_leaves(full["params"])))}

    # full width: VGG-16 at batch 8 and mamba2-130m at 4 x 1024 on (n, 1)
    def timed(step, state, batches):
        ms, hist = [], []
        for b in batches:
            compression.reset_counters()
            torch.cuda.synchronize(dev)
            dist.barrier()
            t0 = time.perf_counter()
            state, mets = step(state, b)
            torch.cuda.synchronize(dev)
            ms.append((time.perf_counter() - t0) * 1e3)
            hist.append(float(mets["loss"]))
        return state, ms, hist, compression.WIRE_BYTES

    cfg = CNN_REGISTRY["vgg16"]
    plan = plan_model(cfg, ExecutionPolicy())
    ds = SyntheticImageDataset(hw=cfg.input_hw, channels=cfg.layers[0].M,
                               n_classes=cfg.n_classes,
                               global_batch=TRAIN_BATCH, seed=0)
    batches = [ds.batch_at(i) for i in range(CARDS_STEPS)]
    vscfg = StepConfig(peak_lr=TRAIN_LR, warmup_steps=5,
                       total_steps=CARDS_STEPS)
    state0 = make_train_state(plan, 0, dev)
    _, one_ms, one_loss, _ = timed(make_train_step(plan, vscfg), state0,
                                   batches)
    _, dp_ms, dp_loss, _ = timed(make_train_step(plan, vscfg, flat),
                                 place(state0, flat), batches)
    res["vgg16"] = {"one_ms": one_ms, "dp_ms": dp_ms,
                    "loss0": [one_loss[0], dp_loss[0]]}
    del state0
    lcfg = get_config(LM_ARCH)
    model = build_model(lcfg)
    B, S, _ = LM_TRAIN[LM_ARCH]
    lds = SyntheticLMDataset(vocab=lcfg.vocab, seq_len=S + 1, global_batch=B)
    lbatches = [lds.batch_at(i) for i in range(CARDS_STEPS)]
    lstate = make_train_state(model, 0, dev)
    for compress in (False, True):
        lscfg = StepConfig(peak_lr=TRAIN_LR, warmup_steps=5,
                           total_steps=CARDS_STEPS, compress_grads=compress)
        st = place(lstate, flat)
        if compress:
            st = add_ef(st, flat)
        torch.cuda.reset_peak_memory_stats(dev)
        _, ms, hist, wire = timed(make_train_step(model, lscfg, flat), st,
                                  lbatches)
        res[f"{LM_ARCH} {'int8' if compress else 'plain'}"] = {
            "ms": ms, "loss": hist, "wire": wire,
            "peak_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30}
        del st
    del lstate

    # llava's decode layer through attention() on a (1, n) mesh over NCCL:
    # its params by param_pspec, its cache cut n ways by cache_pspec
    seq_mesh = init_device_mesh("cuda", (1, n),
                                mesh_dim_names=("data", "model"))
    lay, params, t, p_d, x_d, cache, kw = _seq_layer(
        torch, dev, seq_mesh, torch.bfloat16, tp_params=True)
    with activate_mesh(seq_mesh), torch.no_grad():
        def arm():
            return attention(p_d, x_d, lay, cache=cache, **kw)[0]
        o = arm().full_tensor()
        arm_ms = cuda_ms(torch, arm, 20)
    ref = KVCache(t["k"].clone(), t["v"].clone())
    with torch.no_grad():
        def one():
            return attention(params, t["x"], lay, cache=ref, **kw)[0]
        want = one().float()
        one_ms = cuda_ms(torch, one, 20)
    diff = (o.float() - want).abs()
    res["seqshard"] = {
        "max_abs": float(diff.max()),
        "row_ulps": float((diff / (want.abs().amax(-1, keepdim=True)
                                   * 2.0 ** -7)).nan_to_num(0.0).max()),
        "arm_ms": arm_ms, "one_card_ms": one_ms}
    if not all(math.isfinite(v) for v in res[f"{LM_ARCH} int8"]["loss"]):
        raise RuntimeError(f"{LM_ARCH} int8: a non-finite loss")
    del lay, params, t, p_d, x_d, cache, ref
    res["moe"] = _cards_moe(torch, dist, rank, square)
    return res


def _cards_moe(torch, dist, rank: int, mesh) -> dict:
    """llama4-maverick's one period at full width with its 128 experts cut
    over the "model" axis of ``mesh`` (the MoE mesh arm over NCCL, every
    param placed by ``param_pspec``): a prefill and FAMILY_STEPS decode
    steps fed rank 0's one-card tokens, against rank 0's one-card logits
    (made first, the card's copy of the params then placed)."""
    import gc as _gc

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import _place_on_mesh
    from repro_torch.nn.models import build_model

    dev = torch.device("cuda", rank)
    cfg = get_config(MOE_ARCH).with_overrides(n_layers=MOE_LAYERS)
    model = build_model(cfg, tp=mesh.size(1))
    params = model.init(0, dev)
    batch, make_cache, pos0 = _lm_inputs(torch, model, dev)
    toks = torch.zeros((FAMILY_STEPS + 1, LM_BATCH), dtype=torch.long,
                       device=dev)
    one = None
    routes = {"one": [], "mesh": []}
    if rank == 0:
        with _route_spy(torch, routes["one"]):
            one, _ = _family_run(torch, model, params, batch, make_cache(),
                                 pos0)
        toks.copy_(torch.stack(one["tokens"]))
    dist.broadcast(toks, src=0)
    _gc.collect()
    torch.cuda.empty_cache()
    p2, c2 = _place_on_mesh(model, params, make_cache(), mesh)
    del params
    _gc.collect()
    torch.cuda.empty_cache()
    w = p2["stack"]["slot1"]["moe"]["experts"]["w_gate"]
    dist.barrier()
    with _route_spy(torch, routes["mesh"]):
        two, _ = _family_run(torch, model, p2, batch, c2, pos0,
                             tokens=list(toks), mesh=mesh)
    out = {"experts_local": list(w.to_local().shape),
           "experts_global": list(w.shape), "ms": two["ms"],
           "launches": two["launches"],
           "peak_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30}
    if one is not None:
        # per step and row (this rank's rows: the first of the batch): the
        # row ulps, whether the last position's top-1 expert is the
        # one-card run's, and the one-card router's top-1 margin there
        steps = FAMILY_STEPS + 1

        def last(calls):     # each timed step's last MoE call
            k = len(calls) // (steps + 2)     # + the warm prefill and step
            return calls[-steps * k:][k - 1::k]
        out["rows"] = []
        for i, (a, b) in enumerate(zip(one["logits"], two["logits"])):
            (e1, m1), (e2, _) = last(routes["one"])[i], \
                last(routes["mesh"])[i]
            for r in range(e2.shape[0]):
                out["rows"].append({
                    "step": i, "row": r,
                    "ulps": _row_ulps(b[r:r + 1], a[r:r + 1]),
                    "same_expert": bool(e1[r] == e2[r]),
                    "margin": float(m1[r])})
        out["one_ms"] = one["ms"]
    return out


@contextlib.contextmanager
def _route_spy(torch, calls: list):
    """Record, for each MoE call, the last position's top-1 expert of each
    (local) batch row and its router's top-1 minus top-2 probability."""
    from repro_torch.nn import moe as moe_mod

    route = moe_mod._route

    def spy(impl):
        fn = route(impl)

        def wrapped(x, probs, **kw):
            top = torch.topk(probs[:, -1].float(), 2, dim=-1)
            calls.append((top.indices[:, 0].cpu(),
                          (top.values[:, 0] - top.values[:, 1]).cpu()))
            return fn(x, probs, **kw)
        return wrapped
    moe_mod._route = spy
    try:
        yield
    finally:
        moe_mod._route = route


def phase_cards(torch, n: int) -> None:
    """``--cards N``: the mesh arm across N cards (one process a card,
    NCCL): the smoke configs' (N/2, 2) steps (granite at tp=2, mamba2,
    VGG-16; the kernels under ``local_map``) within JAX's bounds of one
    card's step; full-width VGG-16 at batch 8 and mamba2-130m at 4 x 1024
    (plain and int8 gradients) on (N, 1), ms per step; llava's decode
    layer through ``attention()`` on a (1, N) mesh, its params by
    ``param_pspec`` and its cache cut N ways by ``cache_pspec``, within
    the bf16 row limit of the one-card layer (kernel 5's split decode),
    timed against it."""
    import json as _json
    import tempfile

    import torch.multiprocessing as mp

    if torch.cuda.device_count() < n:
        fail(f"--cards {n}: {torch.cuda.device_count()} cards visible")
    t_phase = time.perf_counter()
    d = tempfile.mkdtemp(prefix="cards-")
    mp.spawn(_cards_rank, args=(n, d, "cards"), nprocs=n)
    ranks = []
    for r in range(n):
        with open(f"{d}/rank{r}.json") as f:
            ranks.append(_json.load(f))
    for r, res in enumerate(ranks):
        if "error" in res:
            fail(f"cards: rank {r} failed:\n{res['error']}")
    r0 = ranks[0]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    log(f"cards {n}: " + "; ".join(smi[:n]))
    for k, v in r0.items():
        log(f"cards {n}, {k}: {v}")
    for arch in ("granite-3-2b", "mamba2-130m", "vgg16"):
        e = r0[f"smoke {arch}"]
        if e["loss"] > 1e-4 or e["params"] > 5e-3:
            fail(f"cards: {arch} smoke on ({n // 2}, 2) against one card: "
                 f"{e} (limits 1e-4, 5e-3)")
    sq = r0["seqshard"]
    if sq["max_abs"] > 2e-2 or sq["row_ulps"] > BF16_ROW_ULPS:
        fail(f"cards: the decode merged across {n} cards: {sq}")
    moe = r0["moe"]
    flips = [r for r in moe["rows"] if not r["same_expert"]]
    kept = [r for r in moe["rows"] if r["same_expert"]]
    log(f"cards {n}, {MOE_ARCH}'s experts over 2 cards: rows whose last "
        f"top-1 expert is one card's within "
        f"{max(r['ulps'] for r in kept):.4g} x 2^-7 of the row's max; "
        f"{len(flips)} of {len(moe['rows'])} rows routed elsewhere "
        f"(one card's top-1 margin {[round(r['margin'], 6) for r in flips]}"
        f", their logits {[round(r['ulps'], 2) for r in flips]} x 2^-7)")
    if max(r["ulps"] for r in kept) > BF16_ROW_ULPS \
            or any(r["margin"] > MOE_FLIP_MARGIN for r in flips) \
            or moe["experts_local"][1] * 2 != moe["experts_global"][1]:
        fail(f"cards: {MOE_ARCH}'s experts over 2 cards: {moe} (limits "
             f"{BF16_ROW_ULPS} x 2^-7 of a row's max where the top-1 expert "
             f"is one card's; a different expert only at a margin under "
             f"{MOE_FLIP_MARGIN})")
    log(f"cards {n} took {time.perf_counter() - t_phase:.1f} s")


#: ``--trace-mesh N``: VGG-16's train step at batch TRAIN_BATCH on one
#: card and on an (N, 1) mesh, plain and with int8 gradients: warm-up
#: steps, then TRACE_STEPS steps timed, then TRACE_STEPS under
#: ``torch.profiler``
TRACE_WARMUP, TRACE_STEPS = 2, 3
#: the host ops that are collectives (by name prefix in the trace)
TRACE_COLLECTIVES = ("c10d::", "_c10d_functional::", "nccl:", "gloo:",
                     "record_param_comms")


def _trace_split(events, steps: int) -> dict:
    """From a chrome trace's events (one process), per step: the device's
    busy ms (the union of its kernels', copies' and sets' intervals); the
    host ms in collectives (the outermost collective ops, every thread)
    and their count; and the host ms of DTensor's own work: the outermost
    ``PythonSubclass`` (DTensor's dispatch of an op) and ``Redistribute``
    spans, less the local op each dispatch runs (its child of the op's
    own name) and the collectives under them, and their count."""
    dev = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                 if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
                 and "dur" in e)
    busy, end = 0.0, None
    for a, b in dev:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b

    def coll(e):
        return e["name"].startswith(TRACE_COLLECTIVES)

    def dt(e):
        return e["name"] in ("PythonSubclass", "Redistribute")

    def local_call(e):   # the local op a DTensor dispatch runs
        p = e["_parent"]
        return (p is not None and p["name"] == "PythonSubclass"
                and p["_parent"] is not None
                and e["name"] == p["_parent"]["name"])
    by_tid: dict = {}
    for e in events:
        if e.get("cat") == "cpu_op" and "dur" in e:
            by_tid.setdefault((e.get("pid"), e.get("tid")), []).append(e)
    coll_us = dt_us = 0.0
    n_coll = n_dt = 0
    for evs in by_tid.values():
        evs.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack: list = []
        for e in evs:
            while stack and e["ts"] >= stack[-1]["ts"] + stack[-1]["dur"]:
                stack.pop()
            p = stack[-1] if stack else None
            e["_parent"] = p
            e["_in_coll"] = p is not None and (p["_in_coll"] or coll(p))
            e["_in_dt"] = p is not None and (p["_in_dt"] or dt(p))
            e["_in_local"] = p is not None and (p["_in_local"]
                                                or local_call(p))
            stack.append(e)
            if coll(e) and not e["_in_coll"]:
                coll_us += e["dur"]
                n_coll += 1
            if dt(e) and not e["_in_dt"]:
                dt_us += e["dur"]
                n_dt += 1
            elif e["_in_dt"] and not e["_in_local"] and (
                    local_call(e) or (coll(e) and not e["_in_coll"])):
                dt_us -= e["dur"]
    return {"device_busy_ms": busy / 1e3 / steps,
            "collective_ms": coll_us / 1e3 / steps,
            "collectives": n_coll / steps,
            "dtensor_ms": dt_us / 1e3 / steps,
            "dtensor_spans": n_dt / steps}


def _trace_work(torch, dist, rank: int, n: int) -> dict:
    import json as _json
    import os
    import tempfile

    from torch.distributed.device_mesh import init_device_mesh
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import CNN_REGISTRY
    from repro_torch.data.pipeline import SyntheticImageDataset
    from repro_torch.distributed import (StepConfig, activate_mesh, add_ef,
                                         make_train_state, make_train_step,
                                         place_state, state_pspec)
    from repro_torch.engine import ExecutionPolicy, plan_model
    from repro_torch.engine.policy import fp32_ieee

    fp32_ieee()
    dev = torch.device("cuda", rank)
    mesh = init_device_mesh("cuda", (n, 1), mesh_dim_names=("data", "model"))
    cfg = CNN_REGISTRY["vgg16"]
    plan = plan_model(cfg, ExecutionPolicy())
    ds = SyntheticImageDataset(hw=cfg.input_hw, channels=cfg.layers[0].M,
                               n_classes=cfg.n_classes,
                               global_batch=TRAIN_BATCH, seed=0)
    total = TRACE_WARMUP + 2 * TRACE_STEPS
    batches = [ds.batch_at(i) for i in range(total)]
    state0 = make_train_state(plan, 0, dev)
    with activate_mesh(mesh) as ctx:
        specs = state_pspec(state0, ctx)
    res = {}
    for name, compress in (("one card", None), ("mesh", False),
                           ("mesh, int8 gradients", True)):
        scfg = StepConfig(peak_lr=TRAIN_LR, warmup_steps=5,
                          total_steps=total, compress_grads=bool(compress))
        if compress is None:
            state, m = state0, None
        else:
            state, m = place_state(state0, specs, mesh), mesh
            if compress:
                state = add_ef(state, mesh)
        step = make_train_step(plan, scfg, m)
        for b in batches[:TRACE_WARMUP]:
            state, _ = step(state, b)
        torch.cuda.synchronize(dev)
        dist.barrier()
        t0 = time.perf_counter()
        for b in batches[TRACE_WARMUP:TRACE_WARMUP + TRACE_STEPS]:
            state, _ = step(state, b)
        torch.cuda.synchronize(dev)
        wall = (time.perf_counter() - t0) * 1e3 / TRACE_STEPS
        dist.barrier()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for b in batches[TRACE_WARMUP + TRACE_STEPS:]:
                state, _ = step(state, b)
            torch.cuda.synchronize(dev)
            traced = (time.perf_counter() - t0) * 1e3 / TRACE_STEPS
        path = os.path.join(tempfile.mkdtemp(prefix="trace-"), "t.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = _json.load(f)["traceEvents"]
        os.remove(path)
        split = _trace_split(events, TRACE_STEPS)
        res[name] = {"ms": wall, "traced_ms": traced, **split,
                     "idle_share": 1.0 - split["device_busy_ms"] / wall,
                     "idle_share_traced": 1.0 - split["device_busy_ms"]
                     / traced}
        del state, step
    return res


def phase_trace_mesh(torch, n: int) -> None:
    """``--trace-mesh N``: where the mesh step's time goes.  VGG-16's
    train step at batch TRAIN_BATCH (full width, kernels 1 and 2) on one
    card, on an (N, 1) ``DeviceMesh`` (NCCL, one process a card), and on
    it with int8 gradients and error feedback: ms per step untraced, then
    one ``torch.profiler`` trace of TRACE_STEPS steps: the device's busy
    ms and idle share, and the host ms in collectives and in DTensor-level
    ops (``_trace_split``), per step, on each rank."""
    import json as _json
    import tempfile

    import torch.multiprocessing as mp

    if torch.cuda.device_count() < n:
        fail(f"--trace-mesh {n}: {torch.cuda.device_count()} cards visible")
    t_phase = time.perf_counter()
    d = tempfile.mkdtemp(prefix="trace-mesh-")
    mp.spawn(_cards_rank, args=(n, d, "trace"), nprocs=n)
    for r in range(n):
        with open(f"{d}/rank{r}.json") as f:
            res = _json.load(f)
        if "error" in res:
            fail(f"trace-mesh: rank {r} failed:\n{res['error']}")
        for name, v in res.items():
            log(f"trace-mesh ({n}, 1) rank {r}, vgg16 batch {TRAIN_BATCH} "
                f"({name}): " + ", ".join(
                    f"{k} {x:.4f}" if isinstance(x, float) else f"{k} {x}"
                    for k, x in v.items()))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    log(f"trace-mesh {n}: " + "; ".join(smi[:n]))
    log(f"trace-mesh {n} took {time.perf_counter() - t_phase:.1f} s")


def kernel_entry(rows, name: str, launches: int, source: str = KERNEL_SOURCE,
                 replaces: str = REPLACES, arch: str = "vgg16") -> dict:
    """One kernel instantiation's line entry: the sums over the shapes of
    one run of its path among ``rows`` (of a conv kernel, the shapes of
    ``arch``: one batch's conv stack), the largest error over all rows."""
    timed = [r for r in rows if r.get("arch", arch) == arch]
    lib = [r["library_ms"] for r in timed]
    return {
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": sum(r["ms"] for r in timed),
        "plain_ms": sum(r["plain_ms"] for r in timed),
        "bound_ms": sum(r["bound_ms"] for r in timed),
        "bound_by": ("operations" if sum(r["ops_ms"] for r in timed)
                     >= sum(r["bytes_ms"] for r in timed) else "bytes"),
        "library_ms": None if None in lib else sum(lib),
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels", action="store_true",
                    help="stop after the kernel phase (no serving)")
    ap.add_argument("--reps", type=int, default=50,
                    help="timed launches per kernel shape")
    ap.add_argument("--requests", type=int, default=16,
                    help="requests per serve phase")
    ap.add_argument("--drift", metavar="SEEDS",
                    help="only measure how far free-running train runs "
                    "part (comma-separated seeds); no result line")
    ap.add_argument("--distributed", action="store_true",
                    help="only run phases 22-24 (the mesh arm, the "
                    "sequence-sharded decode across ranks, the launcher); "
                    "no result line")
    ap.add_argument("--cards", type=int, metavar="N",
                    help="only run the mesh arm across N cards of one host "
                    "(one process a card, NCCL); no result line")
    ap.add_argument("--trace-mesh", type=int, metavar="N",
                    help="only trace VGG-16's step on one card and on an "
                    "(N, 1) mesh (torch.profiler): device idle share, host "
                    "ms in collectives and DTensor ops; no result line")
    ap.add_argument("--family-mesh", action="store_true",
                    help="only run phases 25-27 (the family mesh arms at "
                    "world 1 and across 2 ranks, the dry-run against the "
                    "card); no result line")
    ap.add_argument("--parent", metavar="DIR",
                    help="a checkout of the parent commit: phase 3j times "
                    "its bf16 kernels at batch 8 beside this one's, phase "
                    "3f its SSD kernel at mamba2-130m's shape, after "
                    "phase 3i its flash kernel at the LM phases' bf16 and "
                    "fp32 shapes, and after phase 3e its conv1d and fp32 "
                    "matmul at their path shapes, each in turns")
    ap.add_argument("--probe-families", type=int, metavar="N",
                    help="only run phases 3i and 3e, N times over, each "
                    "row logged as it ends; no result line")
    args = ap.parse_args()
    if not (SRC / "repro_torch" / "csrc" / "trim_conv2d.cu").is_file():
        fail(f"the port's sources are not in {SRC}: run from a checkout")
    sys.path.insert(0, str(SRC))
    import torch

    t_start = time.perf_counter()
    card = phase_environment(torch)
    from repro_torch.engine.policy import fp32_ieee

    fp32_ieee()
    phase_build()
    if args.drift:
        phase_drift(torch, [int(v) for v in args.drift.split(",")],
                    TRAIN_STEPS, TRAIN_BATCH, (TRAIN_LR, TRAIN_LR / 10))
        log("stopping after the drift measurement (--drift): no result line")
        return
    if args.cards:
        phase_cards(torch, args.cards)
        log(f"stopping after the {args.cards}-card run (--cards): no result "
            "line")
        return
    if args.trace_mesh:
        phase_trace_mesh(torch, args.trace_mesh)
        log("stopping after the trace (--trace-mesh): no result line")
        return
    if args.distributed:
        phase_mesh_world1(torch)
        phase_seqshard_ranks(torch)
        phase_launcher(torch)
        log("stopping after phases 22-24 (--distributed): no result line")
        return
    if args.probe_families:
        phase_probe_families(torch, args.probe_families, args.reps)
        log("stopping after the probe (--probe-families): no result line")
        return
    if args.family_mesh:
        fam = phase_family_world1(torch)
        phase_split_ranks(torch)
        phase_dryrun_card(torch, fam["placed_bytes"], fam["prefill_ms"])
        log(f"card: {card}")
        log("stopping after phases 25-27 (--family-mesh): no result line")
        return
    rows = phase_kernels(torch, args.reps)
    brows = phase_backward(torch, args.reps, (1, TRAIN_BATCH))
    bf_rows = phase_bf16_kernels(torch, args.reps, args.parent)
    crows = phase_conv1d(torch, args.reps)
    frows = phase_flash(torch, args.reps)
    code_rows = phase_flash_code(torch, args.reps)
    dim_rows = phase_flash_dims(torch, args.reps)
    fam_rows = phase_flash_families(torch, args.reps)
    phase_flash_turns(torch, args.parent)
    mrows = phase_matmul(torch, args.reps, max(3, args.reps // 10))
    phase_conv1d_matmul_turns(torch, args.parent)
    srows = phase_ssd(torch, args.reps, args.parent)
    if args.kernels:
        log("stopping after the kernel phases (--kernels): no result line")
        return
    launches_f32 = sum(phase_serve(torch, "float", args.requests))
    launches_u8, launches_u8_b8 = phase_serve(torch, "int8", args.requests)
    launches_i5, launches_i5_b8 = phase_serve(torch, "int5", args.requests)
    alex = phase_alexnet_serve(torch)
    chaos = {run[0]: phase_chaos(torch, *run, args.requests)
             for run in CHAOS_RUNS}
    phase_wire(torch)
    phase_emulator(torch)
    xrows, xlaunches = phase_f32exact(torch, args.reps, rows)
    train_f32, train_wgrad = phase_train(torch, TRAIN_STEPS, TRAIN_BATCH,
                                         TRAIN_LR)
    bf_fwd = phase_bf16_forward(torch)
    bf_train = phase_train_bf16(torch, TRAIN_STEPS, TRAIN_BATCH, TRAIN_LR)
    phase_autotune(torch)
    lm_launches = phase_lm_serve(torch, LM_ARCH)
    phase_lm_checks(torch, LM_ARCH)
    dense_launches = phase_lm_serve(torch, DENSE_ARCH)
    phase_lm_checks(torch, DENSE_ARCH)
    lm_train = {arch: phase_lm_train(torch, arch, args.reps)
                for arch in (LM_ARCH, DENSE_ARCH)}
    code_launches = phase_lm_serve(torch, CODE_ARCH)
    phase_lm_checks(torch, CODE_ARCH)
    gemma_launches = phase_lm_serve(torch, GEMMA_ARCH)
    phase_lm_checks(torch, GEMMA_ARCH)
    moe_launches = phase_lm_serve(torch, MOE_ARCH, n_layers=MOE_LAYERS)
    phase_lm_serve(torch, ENCDEC_ARCH)
    f32_launches = {ENCDEC_ARCH: phase_lm_checks_extra(torch, ENCDEC_ARCH)}
    vlm_launches = phase_lm_serve(torch, VLM_ARCH)
    f32_launches[VLM_ARCH] = phase_lm_checks_extra(
        torch, VLM_ARCH, n_layers=VLM_CHECK_LAYERS)
    phase_mesh_world1(torch)
    seq_rows = phase_seqshard_ranks(torch)
    phase_launcher(torch)
    fam_mesh = phase_family_world1(torch)
    split_row = phase_split_ranks(torch)
    phase_dryrun_card(torch, fam_mesh["placed_bytes"], fam_mesh["prefill_ms"])
    phase_examples()
    # the launches of each timed kind of call in the served runs, each
    # counted: the encoder's and the cross-attention's by role (the cross
    # rows: the prefill's and each replay's), llava's prefill's and
    # decode's; the fp32 rows those of the fp32 check phases
    roles = FLASH_ROLES[ENCDEC_ARCH]
    fam_launches = {
        (ENCDEC_ARCH, "encoder"): roles["prefill"]["encoder"],
        (ENCDEC_ARCH, "cross"): (roles["prefill"]["cross"]
                                 + roles["replay"]["cross"] * roles["steps"]),
        (VLM_ARCH, "prefill"): vlm_launches["flash_attention"][0],
        (VLM_ARCH, "decode"): vlm_launches["flash_attention"][1]}
    launches_in = {
        ("bfloat16", ENCDEC_ARCH): "phase 18 (served, batch 4)",
        ("bfloat16", VLM_ARCH): "phase 20 (served, batch 4)",
        ("float32", ENCDEC_ARCH): "phase 19 (fp32 checks, batch 2, "
        f"{ENCDEC_CHECK_SRC} source frames, {ENCDEC_CHECK_TGT} target "
        "tokens)",
        ("float32", VLM_ARCH): "phase 21 (fp32 checks, batch 2, "
        f"{VLM_CHECK_LAYERS} layers, {LM_CHECK_LEN} text tokens)"}
    log("captures per key (CUDA graphs; the int5 lane's again after each "
        "wire restore): " + "; ".join(
            f"{phase}: " + ", ".join(f"{k.split(' ', 1)[1]} {n}"
                                     for k, n in counts.items())
            for phase, counts in CAPTURES.items()))
    log(f"every phase passed in {time.perf_counter() - t_start:.1f} s "
        "(from the environment check, the build included)")
    c1 = next(r for r in crows if r["dtype"] == "bfloat16"
              and r["label"] == "full")
    flash = {r["shape"]: r for r in frows if r["dtype"] == "bfloat16"}
    print(json.dumps({"kernels": [
        kernel_entry([r for r in rows if r["lane"] == "f32"
                      and r["batch"] == 1],
                     "trim_conv2d_f32", launches_f32 + train_f32),
        kernel_entry([r for r in rows if r["lane"] == "f32"
                      and r["batch"] == TRAIN_BATCH],
                     f"trim_conv2d_f32_batch{TRAIN_BATCH}", train_f32),
        # the int8 serve's launches: buckets 1 and 4 here, bucket 8 below
        kernel_entry([r for r in rows if r["lane"] == "u8s8"
                      and r["batch"] == 1],
                     "trim_conv2d_u8s8", launches_u8),
        kernel_entry([r for r in rows if r["lane"] == "u8s8"
                      and r["batch"] == TRAIN_BATCH],
                     f"trim_conv2d_u8s8_batch{TRAIN_BATCH}", launches_u8_b8),
        # the int5 serve's launches, split as the int8 serve's
        kernel_entry([r for r in rows if r["lane"] == "int5"
                      and r["batch"] == 1],
                     "trim_conv2d_u8s8_int5", launches_i5),
        kernel_entry([r for r in rows if r["lane"] == "int5"
                      and r["batch"] == TRAIN_BATCH],
                     f"trim_conv2d_u8s8_int5_batch{TRAIN_BATCH}",
                     launches_i5_b8),
        # the chaos serves' launches, each on its own lane's entry: the
        # int5 lane's, then the int8 lane's (the int8 run's and the int5
        # runs' int8 fallback), f32exact's chunks and float on fp32; the
        # times are the batch-1 rows, the flushes span buckets 1, 4, 8
        kernel_entry([r for r in rows if r["lane"] == "int5"
                      and r["batch"] == 1],
                     "trim_conv2d_u8s8_int5_chaos",
                     chaos["int5"]["int5"] + chaos["int5-flip"]["int5"]),
        kernel_entry([r for r in rows if r["lane"] == "u8s8"
                      and r["batch"] == 1],
                     "trim_conv2d_u8s8_chaos",
                     chaos["int8"]["int8"] + chaos["int5"]["int8"]
                     + chaos["int5-flip"]["int8"]),
        kernel_entry([r for r in rows if r["lane"] == "f32"
                      and r["batch"] == 1],
                     "trim_conv2d_f32_chaos", sum(chaos["float"].values())),
        # the fp32 lane on the f32exact substrate: VGG-16's integer convs
        # in exact channel chunks, launches from its int8 / int5 runs
        kernel_entry([r for r in xrows if r["w_bits"] == 8],
                     "trim_conv2d_f32_f32exact", xlaunches[8]),
        kernel_entry([r for r in xrows if r["w_bits"] == 5],
                     "trim_conv2d_f32_f32exact_w5", xlaunches[5]),
        kernel_entry([r for r in xrows if r["w_bits"] == 8],
                     "trim_conv2d_f32_f32exact_chaos",
                     chaos["int8"]["int8-f32exact"]),
        kernel_entry([r for r in brows if r["kind"] == "dw"
                      and r["batch"] == TRAIN_BATCH],
                     "trim_conv2d_wgrad_f32", train_wgrad,
                     source=WGRAD_SOURCE, replaces=WGRAD_REPLACES)]
        # the bf16 lanes (phase 3j's rows): VGG-16's forward at batch 1
        # and 8 (phase 6c's launches), the train step's forward + dx and
        # dw at batch 8 (phase 6d's), AlexNet's forward at batch 1
        + [kernel_entry([r for r in bf_rows if r["kind"] in kinds
                         and r["arch"] == arch and r["batch"] == N],
                        name, launches, arch=arch, **where)
           for name, kinds, arch, N, launches, where in (
               ("trim_conv2d_bf16", ("fwd",), "vgg16", 1,
                bf_fwd[("vgg16", 1)], {}),
               (f"trim_conv2d_bf16_batch{TRAIN_BATCH}", ("fwd",), "vgg16",
                TRAIN_BATCH, bf_fwd[("vgg16", TRAIN_BATCH)], {}),
               (f"trim_conv2d_bf16_train_batch{TRAIN_BATCH}", ("fwd", "dx"),
                "vgg16", TRAIN_BATCH, bf_train["conv"], {}),
               ("trim_conv2d_bf16_alexnet", ("fwd",), "alexnet", 1,
                bf_fwd[("alexnet", 1)], {}),
               (f"trim_conv2d_wgrad_bf16_train_batch{TRAIN_BATCH}", ("dw",),
                "vgg16", TRAIN_BATCH, bf_train["wgrad"],
                dict(source=WGRAD_SOURCE, replaces=WGRAD_REPLACES)))]
        # AlexNet's replays on each lane, timed by its batch-1 rows (the
        # replays span buckets 1, 4 and 8)
        + [kernel_entry([r for r in rows if r["lane"] == lane
                         and r["batch"] == 1 and r["arch"] == "alexnet"],
                        f"trim_conv2d_{name}_alexnet", alex[datapath],
                        arch="alexnet")
           for lane, name, datapath in (("f32", "f32", "float"),
                                        ("u8s8", "u8s8", "int8"),
                                        ("int5", "u8s8_int5", "int5"))]
        + [{"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": lm_train[arch]["launches"],
            **{k: lm_train[arch]["row"][k] for k in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")}}
           for name, arch, source, replaces in (
               ("trim_conv1d_bf16_train", LM_ARCH, CONV1D_SOURCE,
                CONV1D_REPLACES),
               ("flash_attention_bf16_train", DENSE_ARCH, FLASH_SOURCE,
                FLASH_REPLACES))]
        + [{"name": f"flash_attention_bf16_{CODE_ARCH}_{shape}",
            "route": "cuda", "source": FLASH_SOURCE,
            "replaces": FLASH_REPLACES,
            "launches": code_launches["flash_attention"][i],
            **{k: code_rows[shape][k] for k in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")}}
           for i, shape in enumerate(("prefill", "decode"))]
        # head dim 256 (gemma-7b) and the MoE serve's attention (G = 5)
        + [{"name": f"flash_attention_bf16_{arch}_{shape}",
            "route": "cuda", "source": FLASH_SOURCE,
            "replaces": FLASH_REPLACES,
            "launches": launches["flash_attention"][i],
            **{k: dim_rows[(arch, shape, "bfloat16")][k] for k in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")}}
           for arch, launches in ((GEMMA_ARCH, gemma_launches),
                                  (MOE_ARCH, moe_launches))
           for i, shape in enumerate(("prefill", "decode"))]
        # the encdec and vlm families' shapes, bf16 (the served runs'
        # launches) and fp32 (the fp32 check phases'), each row naming the
        # run its launches were counted in
        + [{"name": f"flash_attention_{dtype}_{arch}_{shape}",
            "route": "cuda", "source": FLASH_SOURCE,
            "replaces": FLASH_REPLACES,
            "launches": (fam_launches[(arch, shape)] if dtype == "bfloat16"
                         else f32_launches[arch][shape]),
            "launches_in": launches_in[(dtype, arch)],
            **{k: fam_rows[(arch, shape, dtype)][k] for k in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")}}
           for arch, shape in fam_launches
           for dtype in ("bfloat16", "float32")]
        + [{"name": "trim_conv1d_bf16", "route": "cuda",
            "source": CONV1D_SOURCE, "replaces": CONV1D_REPLACES,
            "launches": lm_launches["trim_conv1d"][0],
            "max_abs_err": max(r["max_abs_err"] for r in crows),
            **{k: c1[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                  "library_ms")}}]
        + [{"name": f"flash_attention_bf16_{shape}", "route": "cuda",
            "source": FLASH_SOURCE, "replaces": FLASH_REPLACES,
            "launches": dense_launches["flash_attention"][i],
            **{k: flash[shape][k] for k in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms") + FLASH_READINGS if k in flash[shape]}}
           for i, shape in enumerate(("prefill", "decode"))]
        + [{**kernel_entry(part_rows, f"trim_matmul_{lane}_{part}",
                           part_rows[0]["launches"], source=MATMUL_SOURCE,
                           replaces=MATMUL_REPLACES),
            "path": part_rows[0]["path"],
            **{k: part_rows[0][k] for k in MATMUL_COLD if part == "decode"}}
           for lane in ("bf16", "f32", "s8") for part in ("prefill", "decode")
           for part_rows in [[r for r in mrows if r["lane"] == lane
                              and r["part"] == part]]]
        + [{"name": f"trim_ssd_{r['dtype']}" + (
                "" if r["label"] == LM_ARCH else f"_{r['label']}"),
            "route": "cuda",
            "source": SSD_SOURCE, "replaces": SSD_REPLACES,
            **{k: r[k] for k in ("launches", "max_abs_err", "ms", "plain_ms",
                                 "bound_ms", "bound_by", "library_ms")}}
           for r in srows]
        # the partial entry, launched across phase 23's ranks
        + [{"name": f"flash_attention_partial_{name}", "route": "cuda",
            "source": FLASH_SOURCE, "replaces": FLASH_REPLACES,
            "launches_in": "phase 23 (2 ranks, one call each)",
            **{k: r[k] for k in ("launches", "max_abs_err", "ms", "plain_ms",
                                 "bound_ms", "bound_by", "library_ms")}}
           for name, r in seq_rows.items()]
        # the family mesh arms: kernel 5 in phase 25's mesh runs (timed by
        # phase 3i's and 3h's rows at the same shapes), kernel 3 on each
        # rank's channels in phase 26 (timed there at that shape)
        + [{"name": f"flash_attention_bf16_{arch}_mesh_{part}",
            "route": "cuda", "source": FLASH_SOURCE,
            "replaces": FLASH_REPLACES,
            "launches": fam_mesh["launches"][(arch, part)],
            "launches_in": f"phase 25 ({part}, the (1, 1) mesh)",
            **{k: row[k] for k in ("max_abs_err", "ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms")}}
           for arch, part, row in (
               (ENCDEC_ARCH, "prefill",
                fam_rows[(ENCDEC_ARCH, "encoder", "bfloat16")]),
               (ENCDEC_ARCH, "decode",
                fam_rows[(ENCDEC_ARCH, "cross", "bfloat16")]),
               (MOE_ARCH, "prefill",
                dim_rows[(MOE_ARCH, "prefill", "bfloat16")]),
               (MOE_ARCH, "decode",
                dim_rows[(MOE_ARCH, "decode", "bfloat16")]))]
        + [{"name": "trim_conv1d_bf16_split_channels", "route": "cuda",
            "source": CONV1D_SOURCE, "replaces": CONV1D_REPLACES,
            "launches_in": f"phase 26 ({SPLIT_RANKS} ranks' prefills)",
            **{k: split_row[k] for k in (
                "launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
                "bound_by", "library_ms")}}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
