#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU and check it.

Run from the root of a checkout, on a machine with one CUDA card and the
CUDA toolkit:

    python3 chip_smoke.py

It imports the port (``src/repro_torch``) and nothing of the JAX package.
Each phase prints one line; any failure raises and exits non-zero:

1. device — the card's name, and ``nvidia-smi``'s name and power limit on a
   line of its own;
2. build — the CUDA kernels built with ``nvcc`` for sm_90a, with the
   registers, shared memory and spills that ``-Xptxas -v`` reports;
3. kernels — each kernel against its plain PyTorch version at the main
   path's shape, at a ragged one and at an aligned one that is no tile
   multiple, in float32 and bfloat16, with CUDA-event times of the kernel,
   the plain version and one library call (a yardstick only: the port never
   calls it) beside the card's bound, and the device times of the kernel
   and the library call (``device_ms``, ``library_device_ms``:
   ``device_busy_ms``, which leaves out the host's share of a call); each
   check names its route, ``wgmma`` (bf16 on the tensor cores, fed by TMA;
   with the tile shape, block count and raster group that
   ``kernels/matmul.py::plan`` gave the persistent kernel) or ``simt`` (the
   CUDA cores), and its load variant (``tma``; ``vector`` or ``scalar`` for
   simt);
4. main path — the paper's Fig. 2 DAG (16 units of 4096x4096 float32) traced
   and run on the sequential oracle and on the threaded work-stealing
   executor: threaded == sequential bit for bit, each ``mul`` against the
   plain matmul of its inputs, and 16 kernel launches per run;
4b. main path on the process backend — the same DAG on
   ``make_executor("process")`` with 4 spawned worker processes, three
   times: fusion off, fusion on, and fusion on with worker 1 SIGKILLed after
   its second super-task (lineage recovery re-runs what it held).  Each run
   equals phase 4's sequential run bit for bit; its line gives the wall,
   ``/dev/shm``'s size, the data plane's transport, the fusion and
   control-plane counters, the bytes moved, the recomputed super-tasks,
   the seconds to the first completed task (spawn, torch import, CUDA
   context, kernel library) and to the last (the rest of the wall is the
   final collection), and the workers' summed seconds in super-tasks.
   Its ``mul`` launches (tasks run plus recomputed) count in the matmul
   entry's ``launches``;
4c. main path through the gateway — an in-process ``GatewayService`` over
   a resident pool of 4 spawned workers, and tenants that connect over
   localhost TCP: a cold job with every output, two tenants' jobs at once
   with ``outputs_only``, a tenant whose store quota is below one job's
   declared bytes (a typed ``QuotaExceeded``, nothing admitted), and two
   tenants across a SIGKILL of worker 1.  Every job equals phase 4's
   sequential run bit for bit; its line gives the wall as the client saw
   it, the gateway's submit-to-dispatch and submit-to-gather seconds, the
   result frame's bytes and seconds, the pool's start-up, and the job's own
   kernel launches and tasks run, which must agree (simt, vector loads);
4d. the cluster runtime's fault tolerance on the card — phase 4's DAG on 4
   spawned workers, CUDA tensors, only ``reduce`` collected, five runs:
   (a) speculation: the ``mul`` of the last ``[gen, gen, mul]`` super-task
   sleeps in its first execution (a sentinel file in a temporary
   directory), ``speculate_after`` is set, that super-task must be twinned
   and a twin must win; (b) a fault
   plan on the tcp channel (the workers' frames delayed, duplicated and
   reordered, each worker's first fetch failed, a ``RetryPolicy`` on
   fetches; unix sockets carry the values, since shared memory makes no
   fetch to fail): no death and no recompute; (c) the 16 products summed by a
   traced ``all_reduce(..., "sum", arity=2)``, worker 1 SIGKILLed once a
   tree hop is done and before the root: the collective graph's own
   sequential value (its gens and muls phase 4's), one death, fewer
   recomputed super-tasks than the lowered graph has nodes; (d) a
   ``python -m repro_torch.launch.remote`` worker dials the tcp driver and
   joins the live run, and keeps at least one product it computed on the
   card (the run log's ``done`` records); (e) the driver killed after 6
   completions (``fail_driver``), then a new driver resumed from the run
   log in ``checkpoint_dir``, the tcp workers rejoining it.  Every run's
   ``reduce`` is the sequential one bit for bit, its workers' matmul
   launches equal the ``mul`` tasks it saw run (twins, losers and
   recomputes; a frame delivered twice is not a run), all simt with vector
   loads, and this process launches none; each prints a ``runtime_path``
   line (wall, ``first_done_s``, ``last_done_s``, the run's counters);
5. ssm_scan — the selective-scan kernel against its plain version at the
   long-prefill shape (1x2048x8192, N = 16), a decode step (S = 1, with
   ``h0``) and a ragged shape (3x1000x1000, with ``h0``), in float32 and
   bfloat16, with CUDA-event times beside the card's bound; also the
   states it keeps for training (the state before every 16 steps) against
   the plain version's, and its time keeping them;
6. serve — falcon-mamba-7b at full width (64 layers, 7,272,665,088
   float32 parameters drawn on the card from a seed) served by the port's
   launcher, ``repro_torch.launch.serve.main``, with a traced request on
   the threaded executor: 4 requests, 28 decode steps, the traced tokens a
   prefix of request 0's, and 64 scan launches per forward;
6b. serve on the process backend — the launcher with ``--reduced
   --backend process --graph-workers 2``: the traced request runs on two
   spawned workers, each drawing the reduced model from the seed and
   launching the scan kernel there; the traced tokens a prefix of request
   0's;
6c. serve through the gateway — a 1-worker spawned gateway, and the
   launcher at full width with ``--gateway``: the traced request runs in
   the pool's worker (192 scan launches there), its tokens those of phase
   6's thread backend; the pool is stopped before the next model;
7. long prefill — one 2048-token prompt through the prefill step and 8
   greedy decode steps, once with the scan kernel and once with its plain
   version on the same tokens: last-position logits within ``LOGIT_TOL``;
8. flash_attention — the flash-attention kernels against their plain
   version at qwen2-7b's long prefill (q 1x28x2048x128, k, v 1x4x2048x128,
   causal), a served prefill (S = 12), the reduced qwen2-7b prefill of
   phase 9b's workers (q 1x4x12x32, 2 kv heads), a ragged shape
   (2x8x1000x64, 2 kv heads), a cross-shaped one (Sq 300, Sk 777, not
   causal), one with D = 72, and zamba2-7b's long and served prefills
   (q 1x32x2048x112 and 1x32x12x112, 32 kv heads; phase 12), and
   dbrx-132b's and llama4-maverick-400b-a17b's long and served prefills
   (q 1x48xSx128 and 1x40xSx128 over 8 kv heads; phase 13), and phase
   14's: whisper-tiny's encoder (q, k, v 16x6x1500x64, not causal),
   decoder (16x6x448x64, causal), cross-attention (q 16x6x448x64 over k, v
   16x6x1500x64) and a decode step's cross-attention (q 16x6x1x64), and
   llava-next-34b's training attention (q 2x56x2048x128 over 8 kv heads),
   and the training attention of phases 12b and 13b (q 2x32x2048x112 over
   32 kv heads; q 2x48x2048x128 over 8), and granite-20b's long prefill
   (q 1x48x2048x128 over one kv head, MQA), and phase 18's: granite-20b's
   served prefill (q 1x48x12x128 over one kv head), yi-9b's long and served
   prefills (q 1x32xSx128 over 4 kv heads) and llava-next-34b's (q
   1x56xSx128 over 8): float32
   (the simt route), bf16 (wgmma) and bf16 through the simt route (q, k,
   v one element past a 16-byte boundary), each launched twice with its
   row log-sum-exp (out and lse the same bits; lse within ``LSE_TOL`` of
   the plain version's), with CUDA-event times of the kernel, the plain version and
   ``scaled_dot_product_attention`` beside the card's bound, and the route
   of each check;
9. serve — falcon-mamba-7b's parameters freed, qwen2-7b at full width
   (28 layers, 7,615,616,512 float32 parameters drawn on the card from a
   seed) served by the same launcher and argv: 28 decode steps, the traced
   tokens a prefix of request 0's, 28 flash launches per prefill, all on
   the route that ``kernels/flash_attention.py::route`` gives the path's
   compute dtype and head dim (wgmma in bf16), and none per decode step;
9b. phase 6b for qwen2-7b (the flash kernel in the workers' prefill; the
   reduced config computes in float32, so those launches are simt);
9c. phase 6c for qwen2-7b (28 flash launches in the worker, all wgmma);
10. long prefill — phase 7 for qwen2-7b, with the flash kernel and with its
   plain version: 28 launches in the kernel run, all on the wgmma route,
   none in the plain one; then the same on the same parameters at
   ``compute_dtype="float32"``, the full-width path of the simt route: 28
   launches, all simt.  Each long-prefill line gives the prefill's seconds,
   decode ms/step, peak device memory, and the path kernel's own device time
   within the prefill (CUDA events around each launch);
11. train — qwen2-7b's serving parameters freed: (a) the flash-attention
   gradient at the training step's attention (q 2x28x2048x128, k, v
   2x4x2048x128, causal), a ragged shape (2x8x1000x64, 2 kv heads),
   whisper-tiny's encoder (16x6x1500x64, not causal), cross-attention (q
   16x6x448x64 over 1500 keys) and decoder (16x6x448x64, causal),
   llava-next-34b's training attention (q 2x56x2048x128 over 8 kv heads),
   and zamba2-7b's and dbrx-132b's (q 2x32x2048x112 over 32 kv heads, the
   wgmma backward's D > 64 layout at D = 112; q 2x48x2048x128 over 8, GQA
   6), and phase 18's: granite-20b's (q 2x48x2048x128 over one kv head,
   MQA: each dK/dV unit walks all 48 query heads) and qwen3-14b's (q
   2x40x2048x128 over 8), in float32 (simt) and bf16 (wgmma): the backward
   kernel alone (``flash_attention_backward``: the delta pre-pass, then one
   launch of the dK/dV and dQ units, heaviest first), given the forward
   kernel's out and row log-sum-exp, against the plain backward given the
   same, two launches the same bits, with the kernel's registers, shared
   memory, local (spill) bytes and resident blocks and warps an SM, and its
   unit list's makespan over the ideal when the card's resident blocks take
   it greedily (``unit_list``, computed on the host by
   ``_backward_makespan``, not measured, so kept out of the kernels line:
   4.44 on wgmma and 2.29 on simt at granite-20b's MQA, about 1
   elsewhere); then the Function (the forward
   kernel, then the backward kernel) against autograd of the plain version:
   dq, dk, dv within the forward's tolerance of the largest reference
   entry, one launch of each kernel on the row's route, with CUDA-event
   times of the backward kernel alone, the plain backward and SDPA's
   backward, and of forward + backward for the Function, the plain version
   and SDPA;
   (b) the training launcher at ``--reduced`` on the card: the
   resume check of tests/test_launchers.py (the resumed losses equal the
   uninterrupted run's at rtol 1e-4) and ``--show-graph --backend thread``
   (the traced step's loss equals the loop's step-0 loss), every flash
   launch, forward and backward, simt (float32 compute); (c) qwen2-7b at
   full width cut to 8
   layers (2,954,460,672 float32 parameters from seed 0, bf16 compute,
   selective remat) on batches of 2 x 2048 tokens: one loss-and-gradient
   with the kernel and one with the plain attention (global gradient norm
   and each leaf's cosine within TRAIN_*_TOL) and the loss with each over
   FIRST_STEP_DRAWS batches (within TRAIN_LOSS_TOL), then 4 steps of
   launch/steps.py's train step with AdamW: finite, falling losses, 16
   wgmma flash launches a step (the forward and the remat recompute) and
   8 wgmma backward launches, with the step seconds, tokens/s, peak device
   memory and the flash forwards' and backwards' device ms in each step
   (the Function's, CUDA events); then the same 4 steps from the same draw with
   the plain attention, whose losses the kernel's must meet within
   TRAIN_TRAJ_TOL at every step; then Mamba1: (d) the scan's backward
   kernel against the plain gradient (autograd of the plain scan, or
   ``ref.ssm_scan_backward`` at the training shape) at falcon-mamba-7b's
   training scan (2x2048x8192, N = 16), the long prefill's (1x2048x8192),
   a ragged shape (3x1000x1000 with h0 and dh_final), N = 1 and N = 32, S
   = 1 and the reduced config's (2x16x256): every gradient within 1e-4 of
   its largest plain entry, the kernel given the forward kernel's states
   the bits of the wrapper's standalone route, two launches the same bits,
   with CUDA-event times of the backward kernel given the states, of the
   standalone route (forward kernel, then backward kernel), of the SSMScan
   Function's forward + backward and of the plain backward beside the
   card's bounds; (e) (b) for
   falcon-mamba-7b: two scan forwards and one backward kernel launch a
   layer a step; (f) (c) for falcon-mamba-7b at full width cut to 16 of
   its 64 layers (2,217,676,800 parameters): the first-step limits, 4
   steps with finite losses and 32 forward + 16 backward scan launches a
   step (with the scan's forward and backward device ms), and the same 4
   steps with the plain scan (autograd of the step-by-step loop) within
   TRAIN_TRAJ_TOL; then the first step in float32 compute within
   SCAN_F32_*, and a control, the kernel path reading Δ rounded to bf16,
   which must break the float32 limits and TRAIN_TRAJ_TOL;
12. hybrid — the training state freed, zamba2-7b at full width (81 Mamba2
   layers and one shared transformer block applied after every 6th: 13
   sites of 32 heads of 112, 6,751,130,832 float32 parameters drawn on the
   card from a seed) served by the same launcher and argv: 28 decode steps,
   the traced tokens a prefix of request 0's, 13 flash launches per
   prefill, all on the route ``route()`` gives (wgmma in bf16), none per
   decode step; then phase 7's long prefill with the kernel (13 launches)
   and with the plain attention (none), and the parameters freed.  Its
   Mamba2 (SSD) layers are torch ops: the JAX package has no kernel for
   them; (b) zamba2-7b at full width cut to 24 of its 81 layers (4
   shared-attention sites, 2,306,381,184 float32 parameters from seed 0)
   trained as 11c at HYBRID_TRAIN_LR: every first-step gradient leaf finite
   (the SSD at its published 256-token chunks, where the JAX package's
   gradient is NaN), 8 wgmma flash launches a step (the forward and the
   remat recompute at each site) and 4 backward launches; with
   ``--profile`` the profiled step adds the SSD's forward and backward
   device time and its share of the step;
13. MoE — the hybrid freed, dbrx-132b at its published width (d_model
   6144, 48 heads of 128 over 8 kv heads, 16 experts of 10752, top-4,
   every layer MoE) cut to 4 of its 40 layers (14,269,470,720 float32
   parameters drawn on the card from a seed), served through the
   launcher's ``--layers 4`` by the same argv: 28 decode steps, the
   traced tokens a prefix of request 0's, 4 flash launches per prefill,
   all wgmma, none per decode step; then phase 7's long prefill with the
   kernel and with the plain attention, whose line adds each MoE layer's
   routing: the last position's picks that differ between the two runs,
   the rows of the prompt whose picks differ, the picks dropped by
   capacity in each run, and the smallest gap between the K-th and the
   (K+1)-th router probability at the last position.  Then the same for
   llama4-maverick-400b-a17b cut to 2 of its 48 layers, one dense layer
   and one MoE layer (128 experts of 8192, top-1, a shared expert;
   18,553,267,200 bf16 parameters): 2 flash launches per prefill.  The
   expert products are ``torch.bmm`` in bf16: the JAX package computes
   MoE outside any Pallas kernel; (b) dbrx-132b at full width cut to 1 of
   its 40 layers (4,492,216,320 float32 parameters from seed 0) trained as
   11c with ``optim.Adafactor`` at MOE_TRAIN_LR, passed to
   ``make_train_step`` by the phase (AdamW's state does not fit the card;
   ``make_optimizer`` gives Adafactor to llama4* only): 2 wgmma flash
   launches and 1 backward launch a step, top-4 routing, capacity drops and
   the aux loss in the gradient, and the (token, expert) assignments that
   flip between the kernel's and the plain attention's forwards of the
   FIRST_STEP_DRAWS batches beside the first-step gap.  llama4-maverick
   is not trained: parameters and gradients of its 2-layer cut take 74.2
   GB of bf16;
14. encoder-decoder and VLM — the MoE models freed: (b) the training
   launcher at ``--reduced`` on the card for whisper-tiny and
   llava-next-34b, as 11b (an encoder-decoder step launches flash once an
   encoder layer and twice a decoder layer: no remat); (c) whisper-tiny at
   full width and depth (4 encoder and 4 decoder layers, 6 heads of 64,
   40,199,040 float32 parameters from seed 0, bf16 compute) on batches of
   16 x 448 decoder tokens, each over 1500 frames (seed 0, the same every
   step), trained as 11c (each of the FIRST_STEP_DRAWS loss batches with
   its own frames): the first step against the plain attention, 4 AdamW
   steps with 12 wgmma flash launches each (4 encoder, 4 decoder, 4
   cross) and as many backward launches, the same steps with the plain
   attention; then a prefill of 447
   tokens (12 launches) and one decode step (4: the cross-attention, one
   query over 1500 keys), in bf16 and in float32 compute: in bf16 the
   kernel's prefill and decode logits must meet the plain attention's on
   the same cache within DECODE_REL_TOL of the largest logit, in float32
   the decode step's must meet the full pass's last position within
   LOGIT_TOL; (d) llava-next-34b at full width cut to 4 of its 60 layers
   (3,148,938,240 float32 parameters) on batches of 2 x 2048 tokens, the
   first 576 positions patch embeddings (seed 0; each loss batch its own),
   trained as 11c at VLM_LR with 8 wgmma flash launches and 4 backward
   launches a step.  Phase 14a's kernel checks run in phases 8 and 11a;
15. intra-op SPMD — a world of one NCCL rank (``parallel.mesh.init_world``
   on a fresh file store), destroyed afterwards: (a) phase 4's Fig. 2 DAG
   through ``MeshExecutor`` on a (1, 1) ("data", "model") mesh, every node
   ("batch", "d_model") under ``standard_rules("dp_tp")``, twice: each
   call's ``reduce`` phase 4's sequential value bit for bit, 16 matmul
   launches on ``route()``'s route (the kernel on each rank's local shard
   of the DTensors), no collective and the DAG's 2 x 16 x 4096^3 FLOPs
   (``launch.costs.Counter``, the rank's own); the refinement's changed
   specs and resharding bytes; (b) qwen2-7b at 11c's 8 layers (seed 0,
   bf16 compute, no grad) through ``pipelined_forward``, one stage, 4
   microbatches of 1 x 2048 embedded tokens, against ``layer_stack`` on
   the whole batch within 2e-2 of its largest entry, equal aux, 32 wgmma
   flash launches of q 1x28x2048x128; then the same pipeline at
   ``train=True`` (selective remat) under autograd, the loss sum(y · w)
   with w drawn from a seed: its gradient (every layer leaf and dx) against
   autograd of ``layer_stack`` on the whole batch, the global gradient
   norm within SPMD_GRAD_NORM_TOL and each leaf's cosine at least
   SPMD_GRAD_COSINE_MIN, 64 wgmma flash forwards (forward and remat
   recompute) and 32 wgmma backwards, all of q 1x28x2048x128, with the
   pipeline's and the whole batch's forward + backward seconds and the
   peak; (c) ``Int8BlockCompressor`` over
   that parameter tree: each block's roundtrip within half its own step,
   ``dp_gradient_sync(..., compressor=)`` over the world of one the
   roundtrip's bits, and one leaf's codes and scales the CPU's bits, with
   ms per GB, the payload and the all-reduce's wire bytes against
   ``compression_ratio(4)``, and the peak memory;
16. tensor parallelism in the launchers — a new world of one NCCL rank,
   destroyed afterwards, and the launchers' world path (``--tp 1``: a
   (1, 1) mesh, the parameters DTensors): (a) qwen2-7b at full width and
   depth (seed 0) served by phase 9's argv: phase 9's tokens, 140 flash
   launches (28 a prefill, all on phase 9's route, none a decode step),
   every one through ``kernels/sharded.py``, with the serve wall, TTFT p50
   and decode ms a step beside phase 9's; (b) 11f's cell (falcon-mamba-7b
   at 16 layers, seed 0, 4 steps of 2 x 2048 tokens) laid out by
   ``fsdp_tp`` and trained by ``make_train_step(cfg, opt, ctx)``: 11f's
   kernel losses (each within TRAIN_LOSS_TOL; bit for bit expected), 32
   forward and 16 backward scan launches a step through
   ``kernels/sharded.py``, with the median step, tokens/s and peak memory
   beside 11f's; (c) ``--tp 2`` in the world of one raises ``ValueError``
   in both launchers;
17. dry-run — beside phases 11a and 11b, ``python -m
   repro_torch.launch.dryrun`` in processes of their own (a ``fake``
   process group is one a process): (a) qwen2-7b ``train_4k`` on the
   (16, 16) mesh of 256 fake ranks, its fake tensors once on the card and
   once on the CPU, whose records must be equal in every key but time and
   device (the ``dryrun_production`` line: per-device FLOPs by dtype,
   bytes, peak memory, collectives, NVLink and InfiniBand wire bytes, the
   seconds); (b) 11c's cell and (c) 11f's on the (1, 1) mesh: step 0 of
   11c and of 11f is counted by ``launch.costs.Counter`` and must equal
   the dry-run's FLOPs by dtype to the FLOP, the steps' measured peak must
   lie within 0.8-1.2 times the predicted peak, and the roofline bound
   (the larger of the compute and memory terms at the H100's data-sheet
   rates) must not exceed the measured median step; the MFU (6 N_active D
   over the median step at the bf16 peak) is printed (``dryrun`` in the
   ``train_full`` lines); (d) 12b's and (e) 13b's cells the same, their
   FLOPs to the FLOP and their bound, with the peak's ratio printed (the
   dry-run models make_optimizer's AdamW, not 13b's Adafactor); (f) 18b's
   and (g) 18c's cells as (b);
18. the dense configurations of the pool that no earlier phase serves (run
   after 13b, before 14; the MoE models freed): each of SERVE_CELLS drawn
   on the card from a seed at its published width, served by the launcher
   through phase 9's argv (``--layers`` where cut): granite-20b at 36 of
   its 52 layers (14,251,702,272 float32 parameters; MQA, 48 heads over one
   kv head, the 2-matrix gelu MLP), yi-9b whole (48 layers, 8,829,407,232;
   GQA 8), qwen3-14b whole (40 layers, 14,768,307,200; per-head RMS
   qk_norm, a vocabulary of 151,936) and llava-next-34b's text backbone at
   23 of its 60 layers (13,748,216,832; GQA 7): 28 decode steps, the traced
   tokens a prefix of request 0's, one wgmma flash launch a layer in each
   of the 5 prefills (180, 240, 200 and 115) and none in a decode step;
   then phase 7's long prefill with the kernel and with the plain
   attention, its last-position logits within LOGIT_TOL, llava-next-34b's
   prompt with 576 patch embeddings (seed 0) in its first positions; each
   model freed before the next is drawn; (b) granite-20b at full width cut
   to 6 layers (2,878,605,312 parameters) and (c) qwen3-14b cut to 4
   (2,877,077,504), each trained as 11c at its own rate (its TRAIN_CELLS
   entry's ``lr``): 11c's first-step limits, every gradient leaf finite, 4
   falling losses, the plain attention's 4 steps within TRAIN_TRAJ_TOL, 12
   and 8 wgmma flash forwards and 6 and 4 wgmma backwards a step.

With ``--profile`` it also profiles one decode step and two prefills of
each served model (zamba2-7b's, the MoE models' and phase 18's too) and one
full-width training step of each trained one (whisper-tiny's and
llava-next-34b's too; device time by kernel,
device busy share, and the device time of the port's own kernels).

Then one JSON line of the kernels (``matmul`` counts phases 4d's and 15a's
launches too; ``flash_attention``, headed by its
wgmma kernel (its ``design`` says how it was redesigned: persistent blocks
over one heaviest-first unit list, FA3's in-warpgroup overlap), counts the
wrapper's launches on both routes, serving and
training (12b's, 13b's, 18b's and 18c's too), phase 18's serving, the
encoder-decoder's prefill and decode
steps, phase 15b's pipelines (forward only and training) and phase 16a's
world path too;
``flash_attention_simt`` is the CUDA-core kernel and its
launches; ``ssm_scan`` counts serving and training forwards, and
``ssm_scan_backward``, headed by the training shape, the backward kernel's
launches in 11e and 11f; the scan's entries phase 16b's too;
``flash_attention_backward``, headed by the wgmma backward kernel at 11c's
attention (its numbers the backward kernel's alone), the backward's
launches on both routes in 11b, 11c, 12b, 13b, 14b-d, 15b, 18b and 18c, and
``flash_attention_backward_simt``, the CUDA-core backward kernel and its
own launches; both backward entries say in ``design`` how they were
redesigned: one heaviest-first launch of their units, and on the CUDA
cores two teams that stream their tiles by cp.async), and
last
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a card, or outside a checkout, it prints no result and exits 1.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import math
import os
import re
import secrets
import statistics
import subprocess
import sys
import threading
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# tests/test_kernels.py's matmul tolerances, applied to out / sqrt(K): the
# inputs are standard normal, so the products grow like sqrt(K)
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# the flash kernels' float32 lse against the plain version's, on either
# route (tests/test_torch_gpu.py's)
LSE_TOL = 1e-5

N_TASKS, SIZE, N_WORKERS = 16, 4096, 4          # the main path's DAG
# (M, N, K): the main shape, a ragged one (bf16 keeps the CUDA cores: its
# rows are not 16-byte aligned) and an aligned one that no tile divides
KERNEL_SHAPES = [(SIZE, SIZE, SIZE), (1000, 1531, 777), (1000, 1528, 776)]
REPS = 10
# phase 4b: (fuse, fail_worker) of the three process-backend runs
PROCESS_RUNS = [("off", None), ("auto", None), ("auto", (1, 2))]
# seconds without a completed task before a run fails; the first one waits
# for spawned interpreters to import torch and open a CUDA context
PROCESS_TIMEOUT = 120.0

# the serve paths: falcon-mamba-7b, qwen2-7b and zamba2-7b (phase 12) at
# full width, the JAX launcher's defaults for prompts (4-12 tokens) and
# --max-len 64
ARCH, N_PARAMS = "falcon-mamba-7b", 7_272_665_088
DENSE_ARCH, DENSE_N_PARAMS = "qwen2-7b", 7_615_616_512
HYBRID_ARCH, HYBRID_N_PARAMS = "zamba2-7b", 6_751_130_832
# phase 13: (arch, layers served, parameters at that depth).  dbrx-132b's
# float32 parameters take 57.1 GB at 4 layers (70.1 at 5, which leaves no
# room for a layer's three 2.1 GB bf16 casts of its experts);
# llama4-maverick-400b-a17b's bf16 ones 37.1 GB at 2 layers, one block of a
# dense and an MoE layer (its 128 experts: 10.7 GB a weight)
MOE_CELLS = [("dbrx-132b", 4, 14_269_470_720),
             ("llama4-maverick-400b-a17b", 2, 18_553_267_200)]
# phase 18: the dense configurations of the pool that no earlier phase
# serves, as (arch, layers served or 0 for all, parameters at that depth),
# their float32 parameters at most about dbrx-132b's 57.1 GB at 4 layers
# (served with a peak of 60.9 GB): granite-20b (MQA, 48 heads over one kv
# head, the 2-matrix gelu MLP at d_ff 24,576) at 36 of its 52 layers, 57.0
# GB; yi-9b (GQA 8, rope theta 5e6) whole, 35.3 GB; qwen3-14b (per-head RMS
# qk_norm, a vocabulary of 151,936) whole, 59.1 GB; llava-next-34b's text
# backbone (GQA 7), as the launcher serves it, at 23 of its 60 layers, 55.0
# GB, its long prefill with 576 patch embeddings
SERVE_CELLS = [("granite-20b", 36, 14_251_702_272),
               ("yi-9b", 0, 8_829_407_232),
               ("qwen3-14b", 0, 14_768_307_200),
               ("llava-next-34b", 23, 13_748_216_832)]
SERVE_ARGS = ["--requests", "4", "--slots", "2", "--max-new", "8",
              "--show-graph", "--backend", "thread"]
SERVE_MAX_LEN = 64               # serve.py's --max-len default
SERVE_DECODE_STEPS = 28          # 4 requests x 7 decode steps each
SERVE_FORWARDS = 3 + 4 + 28      # traced request + prefills + decode steps
SERVE_PREFILLS = 1 + 4           # traced request + requests
# (Bsz, S, D, N, with h0): the long prefill, one decode step and one
# served prefill (from the cache's zero state) of falcon-mamba-7b, a
# ragged shape, and the training forwards of phases 11f (2 x 2048 tokens)
# and 11e (the reduced config: 2 x 16 tokens, d_inner 256)
SCAN_SHAPES = [(1, 2048, 8192, 16, False), (1, 1, 8192, 16, True),
               (1, 12, 8192, 16, True), (3, 1000, 1000, 16, True),
               (2, 2048, 8192, 16, False), (2, 16, 256, 16, False)]
# tests/test_kernels.py's ssm tolerances (rtol = atol)
SCAN_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
# (B, H, KH, Sq, Sk, D, causal): qwen2-7b's long prefill and a served
# prefill, the reduced qwen2-7b's prefill (phase 9b's workers, float32),
# zamba2-7b's long and served prefills (phase 12: 32 heads of 112, no
# GQA), dbrx-132b's and llama4-maverick-400b-a17b's long and served
# prefills (phase 13: GQA 6 and 5), the attention of phase 11c's training
# step and of 11b's reduced one, a ragged shape, a cross-shaped one, one
# whose D is a multiple of 8 but not of 16, and phase 14's: whisper-tiny's
# encoder self-attention, decoder self-attention, cross-attention and
# cross-attention in a decode step (6 heads of 64, batch 16, 448 tokens over
# 1500 frames) and llava-next-34b's training attention (GQA 7), and the
# training attention of phases 12b (zamba2-7b: 32 heads of 112) and 13b
# (dbrx-132b: GQA 6), and granite-20b's long prefill (MQA: 48 heads over
# one kv head, the wgmma forward's heaviest unit list of one kv head), and
# phase 18's: yi-9b's long and served prefills (GQA 8), llava-next-34b's
# (GQA 7) and granite-20b's served prefill (qwen3-14b's 40 heads over 8 are
# llama4-maverick-400b-a17b's rows)
FLASH_SHAPES = [(1, 28, 4, 2048, 2048, 128, True),
                (1, 28, 4, 12, 12, 128, True),
                (1, 32, 32, 2048, 2048, 112, True),
                (1, 32, 32, 12, 12, 112, True),
                (1, 48, 8, 2048, 2048, 128, True),
                (1, 48, 8, 12, 12, 128, True),
                (1, 40, 8, 2048, 2048, 128, True),
                (1, 40, 8, 12, 12, 128, True),
                (1, 4, 2, 12, 12, 32, True),
                (2, 28, 4, 2048, 2048, 128, True),
                (2, 4, 2, 16, 16, 32, True),
                (2, 8, 2, 1000, 1000, 64, True),
                (1, 8, 2, 300, 777, 128, False),
                (1, 4, 2, 200, 333, 72, True),
                (16, 6, 6, 1500, 1500, 64, False),
                (16, 6, 6, 448, 448, 64, True),
                (16, 6, 6, 448, 1500, 64, False),
                (16, 6, 6, 1, 1500, 64, False),
                (2, 56, 8, 2048, 2048, 128, True),
                (2, 32, 32, 2048, 2048, 112, True),
                (2, 48, 8, 2048, 2048, 128, True),
                (1, 48, 1, 2048, 2048, 128, True),
                (1, 32, 4, 2048, 2048, 128, True),
                (1, 32, 4, 12, 12, 128, True),
                (1, 56, 8, 2048, 2048, 128, True),
                (1, 56, 8, 12, 12, 128, True),
                (1, 48, 1, 12, 12, 128, True)]
# phases 6b and 9b: the serve traffic with the traced request on cluster
# worker processes (see phase_serve_process)
PROCESS_SERVE_ARGS = ["--requests", "4", "--slots", "2", "--max-new", "8",
                      "--show-graph", "--backend", "process"]
# phases 6c and 9c: the same traffic, the traced request on a gateway's pool
GATEWAY_SERVE_ARGS = ["--requests", "4", "--slots", "2", "--max-new", "8",
                      "--show-graph"]
LONG_PROMPT, LONG_DECODE = 2048, 8
LONG_MAX_LEN = LONG_PROMPT + LONG_DECODE + 1     # the long run's KV cache
# Kernel and plain version agree to the last bits of float32, but the model
# rounds each layer's scan or attention output to bf16, so a last-bit
# difference can flip a bf16 rounding and grow through the depth.  The
# logits have about unit scale (printed); a broken kernel moves them by
# whole units, this drift by a small fraction of one.
LOGIT_TOL = 0.5
# phase 11a: (B, H, KH, Sq, Sk, D, causal) of the flash gradient checks:
# the full-width training step's attention, a ragged shape, and phase 14's
# whisper-tiny encoder (not causal), cross-attention (Sq != Sk) and decoder
# (causal), llava-next-34b's training attention (GQA 7), and the training
# attention of phases 12b (zamba2-7b: D = 112, the wgmma backward's D > 64
# layout with its stores masked past D) and 13b (dbrx-132b: GQA 6), and
# phase 18's training attention: granite-20b's (MQA: one dK/dV unit a key
# tile walks all 48 query heads) and qwen3-14b's (GQA 5)
TRAIN_GRAD_SHAPES = [(2, 28, 4, 2048, 2048, 128, True),
                     (2, 8, 2, 1000, 1000, 64, True),
                     (16, 6, 6, 1500, 1500, 64, False),
                     (16, 6, 6, 448, 1500, 64, False),
                     (16, 6, 6, 448, 448, 64, True),
                     (2, 56, 8, 2048, 2048, 128, True),
                     (2, 32, 32, 2048, 2048, 112, True),
                     (2, 48, 8, 2048, 2048, 128, True),
                     (2, 48, 1, 2048, 2048, 128, True),
                     (2, 40, 8, 2048, 2048, 128, True)]
# phase 11a's times: the median of 20 calls, each between its own CUDA
# events, after 3 warm-ups (a mean of 5 moved SDPA's backward up to 2.3x
# between two runs)
GRAD_REPS, GRAD_WARMUPS = 20, 3
# phase 11b: the training launcher on the card at --reduced
TRAIN_LAUNCHER_ARGS = ["--arch", "qwen2-7b", "--reduced", "--device", "cuda",
                       "--batch", "2", "--seq", "16", "--log-every", "100"]
# phase 11c: qwen2-7b at full width cut to 8 of its 28 layers, whose
# float32 parameters, gradients and AdamW moments (16 bytes a parameter,
# 47.3 GB) fit the 80 GB card with the activations of 2 x 2048 tokens
TRAIN_LAYERS, TRAIN_N_PARAMS = 8, 2_954_460_672
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR = 2, 2048, 4, 3e-4
# the kernel's and the plain attention's first-step loss and gradients in
# bf16 compute: they differ by the wgmma route's bf16 rounding of P before
# P V, carried through 8 layers.  Each limit is 10-20 times what four runs
# on the H100 read, all alike: loss 1.31e-6 apart (relative), global
# gradient norm 4.78e-5, least leaf cosine 0.9999917.  The loss of one
# batch is the wrong witness, though: over 12 batches its gap has a
# standard deviation of 1.3e-5 to 1.8e-5 (qwen2-7b, whisper-tiny,
# llava-next-34b; train_check_causes.py gap on the H100), and the plain
# attention with its scale moved onto q, a float32 reordering and nothing
# more, reads as much (to 3.2e-5).  So the attention cells hold the loss over
# FIRST_STEP_DRAWS batches (the loss of their union) to TRAIN_LOSS_TOL,
# where that noise is about 5e-6 and a kernel that biases the loss still
# shows, and the gradient of the first of them to the other two limits.
# Each batch is SyntheticLMDataset(seed=0)'s batch at its index, with its
# own frames or patches (seed = index).  Phase 11f holds the
# scan kernels to the same limits, where they read loss 5.4e-6, norm
# 3.6e-5, least cosine 0.99979 (dt_proj); in bf16 compute they cannot tell
# a scan that reads Δ rounded to bf16 (the control: 2.5e-6, 4.1e-5,
# 0.99975), so 11f also compares the first step in float32 compute below.
TRAIN_LOSS_TOL, TRAIN_NORM_TOL, TRAIN_COSINE_MIN = 2e-5, 1e-3, 0.9995
# the kernels' and the plain versions' losses at each of the TRAIN_STEPS
# steps from the same draw, relative: about 10 times the H100's reading
# for qwen2-7b (at most 9.6e-5, on the last step); falcon-mamba-7b reads
# at most 7.8e-4 (step 2) and the control at most 3.3e-3 (step 3), alike
# in every run of the same code
TRAIN_TRAJ_TOL = 1e-3
FIRST_STEP_DRAWS = 12
# phase 11f's first step in float32 compute, kernel against plain scan:
# the H100 reads loss 8.3e-8, norm 0, least cosine 0.9999996, so the bf16
# rounding of each layer's output carries the gap in bf16 compute.  The
# control reads 2.5e-7, 4.8e-7, 0.9999978 (dt_bias); each limit lies
# between the two readings, and the control must break all three
SCAN_F32_LOSS_TOL, SCAN_F32_NORM_TOL, SCAN_F32_COSINE_MIN = \
    1.5e-7, 2e-7, 0.999999
# phase 11d: (Bsz, S, D, N, with h0 and dh_final) of the scan gradient
# checks: falcon-mamba-7b's training step (phase 11f), the long prefill's
# scan, a ragged shape, N = 1 and N = 32, S = 1, and the reduced config's
# training scan (phase 11e: 2 x 16 tokens, d_inner 256)
SCAN_GRAD_SHAPES = [(2, 2048, 8192, 16, False), (1, 2048, 8192, 16, False),
                    (3, 1000, 1000, 16, True), (2, 300, 1000, 1, True),
                    (2, 300, 1000, 32, True), (2, 1, 8192, 16, True),
                    (2, 16, 256, 16, False)]
SCAN_GRAD_TOL = SCAN_TOL["float32"]   # of each gradient's largest entry
# above this many (batch row, step, channel) cells the plain gradient is
# ref.ssm_scan_backward: autograd of the plain loop would keep GBs of
# per-step tensors
SCAN_AUTOGRAD_CELLS = 2048 * 8192
GRAD_NAMES = ("dx", "ddt", "dB", "dC", "dA", "dh0")
# phase 11f: falcon-mamba-7b at full width cut to 16 of its 64 layers:
# 35.5 GB of float32 parameters, gradients and AdamW moments (49.0 GB at 24
# layers, 116.4 GB at 64)
MAMBA_TRAIN_LAYERS, MAMBA_TRAIN_N_PARAMS = 16, 2_217_676_800
# phase 14: whisper-tiny at full width and depth (4 encoder and 4 decoder
# layers, 40,199,040 float32 parameters) on batches of 16 x 448 decoder
# tokens (Whisper's text context, arXiv:2212.04356), each over 1500 frames
ENCDEC_ARCH, ENCDEC_LAYERS, ENCDEC_N_PARAMS = "whisper-tiny", 4, 40_199_040
ENCDEC_BATCH, ENCDEC_SEQ = 16, 448
# and llava-next-34b at full width cut to 4 of its 60 layers (3,148,938,240
# float32 parameters: 50.4 GB with gradients and AdamW moments at 16 bytes
# a parameter; 5 layers would take 59.3 GB, too little room left for the
# activations of 2 x 2048 tokens and a layer's 1.1 GB of bf16 weight
# casts), each sequence's first 576 positions its patch embeddings
VLM_ARCH, VLM_LAYERS, VLM_N_PARAMS = "llava-next-34b", 4, 3_148_938_240
VLM_BATCH, VLM_SEQ = 2, 2048
# llava-next-34b's peak rate.  From the same draw its losses over the 4
# steps read (train_check_causes.py lr on the H100): at 0, 11.629, 11.637,
# 11.661, 11.646 (the batches' own spread); at 1e-5, 11.63, 10.86, 8.41,
# 7.96; at 3e-5, 11.63, 16.27, 11.28, 9.76; at 1e-4, 11.63, 19.91, 18.12,
# 14.40; at TRAIN_LR, 11.63, 22.60, 25.60, 13.75.  AdamW's first update
# moves every weight by about the rate; 1e-5 is the largest of these rates
# at which it does not overshoot at d_model 7168
VLM_LR = 1e-5
# phase 14c's bf16 prefill and decode, kernel against the plain attention
# on the same cache: the largest logit difference relative to the largest
# logit (tests/test_torch_gpu.py's limit).  The tied embedding, drawn at
# scale 1, gives logits of ±170, where one bf16 step of the final hidden
# state moves a logit by about 0.5; a wrong attention moves them by tens
DECODE_REL_TOL = 2e-2
# phase 15b: qwen2-7b at 11c's width and depth (8 of 28 layers) through the
# pipeline, one stage (the world has one rank), SPMD_MICRO microbatches of
# 1 x TRAIN_SEQ tokens, held to the bf16 limit of tests/test_torch_gpu.py
# (of the largest entry) against the same layers on the whole batch
SPMD_MICRO = 4
SPMD_PIPE_TOL = TOL["bfloat16"]
# and its gradient at train=True, the loss sum(y · w) (w drawn from
# SPMD_W_SEED), against autograd of layer_stack on the whole batch: the
# relative gap of the global gradient norm and the least leaf cosine (the
# key bias's left out, as in 11c), in the form of 11c's first-step limits.
# Both sides launch the same kernels in bf16 compute; they differ in how
# cuBLAS blocks a 2048-row and an 8192-row product and in the sum of the
# four microbatches' gradients.  Two runs on the H100 read alike: norm
# 6.45e-6, least cosine 0.9999971 (mixer/wo), the losses the same bits;
# each limit is about 10 times that reading's gap.  A gradient counted
# twice breaks the norm limit, one on the wrong layers the cosine limit
SPMD_W_SEED = 3
SPMD_GRAD_NORM_TOL, SPMD_GRAD_COSINE_MIN = 1e-4, 0.99997
# phase 15c: the leaf whose int8 codes and scales are held to the CPU's
SPMD_BITS_LEAF = "layers/mixer/wk"
# phase 17: the dry-runs' time limit, and the band the measured peak of a
# dry-run training cell must lie in (ADAFACTOR_CELLS' excepted, see
# TrainCell), as a share of the dry-run's prediction
DRYRUN_TIMEOUT = 300.0
DRYRUN_PEAK_BAND = (0.8, 1.2)
# phase 12b: zamba2-7b at full width cut to 24 of its 81 layers, 4
# shared-attention sites (after layers 6, 12, 18 and 24): 2,306,381,184
# float32 parameters, 36.9 GB with gradients and AdamW moments (51.9 GB at
# 36 layers, 108.0 GB at 81)
HYBRID_TRAIN_LAYERS, HYBRID_TRAIN_N_PARAMS = 24, 2_306_381_184
# zamba2-7b's peak rate under AdamW.  From the same draw its losses over the
# 4 steps read (train_check_causes.py lr --arch zamba2-7b on an NVIDIA H100
# 80GB HBM3 at its 700.00 W power limit): at 0, 10.962, 10.952, 10.958,
# 10.934 (the batches' own spread); at 3e-6, 10.96, 10.61, 10.37, 10.20; at
# 1e-5, 10.96, 9.82, 9.02, 8.57; at 3e-5, 10.96, 8.25, 7.48, 7.07; at 1e-4,
# 10.96, 15.38, 10.61, 8.89; and phase 12b's own steps at TRAIN_LR, 10.96,
# 22.36, 14.46, 14.59.  3e-5 is the largest of these rates at which the 4
# losses fall
HYBRID_TRAIN_LR = 3e-5
# phase 13b: dbrx-132b at full width cut to 1 of its 40 layers
# (4,492,216,320 float32 parameters, 2,114,045,952 active a token).  AdamW
# cannot hold it: parameters, gradients and two moments take 71.9 GB, and a
# layer's three 2.1 GB bf16 casts of its experts come on top.  The cell
# trains with optim.Adafactor (factored second moments, O(n + m) state for
# an (n, m) matrix): parameters and gradients take 35.9 GB.
# launch/steps.py::make_optimizer gives Adafactor to llama4* only, as the
# reference does, so the cell passes Adafactor to make_train_step itself.
# llama4-maverick-400b-a17b cannot train on one card: at 2 layers, its
# smallest cut that holds an MoE layer, its 18,553,267,200 bf16 parameters
# take 37.1 GB, and their gradients as much again before any activation
MOE_TRAIN_ARCH, MOE_TRAIN_LAYERS, MOE_TRAIN_N_PARAMS = \
    "dbrx-132b", 1, 4_492_216_320
ADAFACTOR_CELLS = (MOE_TRAIN_ARCH,)
# dbrx-132b's peak rate under Adafactor, whose update has an RMS of about the
# rate whatever the gradient's scale.  From the same draw its losses over the
# 4 steps read (train_check_causes.py lr --arch dbrx-132b on an NVIDIA H100
# 80GB HBM3 at its 700.00 W power limit): at 0, 12.192, 12.139, 12.206,
# 12.152; at 1e-5, 12.19, 11.38, 10.83, 10.45; at 3e-5, 12.19, 10.04, 9.53,
# 8.83; at 1e-4, 12.19, 13.31, 10.73, 9.03; at 3e-4, 12.19, 21.93, 13.55,
# 9.10; at 1e-3, 12.19, 27.56, 28.34, 27.04.  3e-5 is the largest of these
# rates at which the 4 losses fall
MOE_TRAIN_LR = 3e-5
# a training cell: its depth, its parameters at that depth, its batch and
# sequence, its peak rate, its phase, and the phase-17 sub-phase whose
# dry-run predicts it (None: none does).  A dry-run cell's measured peak
# must lie in DRYRUN_PEAK_BAND, as it has in every run on an NVIDIA H100
# 80GB HBM3 at 700.00 W (zamba2-7b: 1.0015, 1.0023; granite-20b 1.0019,
# qwen3-14b 1.0020), except for ADAFACTOR_CELLS: the dry-run builds
# make_optimizer's AdamW state, two float32 moments that 13b's Adafactor
# does not keep (predicted 80.3 GB, measured 48.7 GB, 0.607)
TrainCell = collections.namedtuple(
    "TrainCell", "layers n_params batch seq lr phase dryrun")
TRAIN_CELLS = {
    DENSE_ARCH: TrainCell(TRAIN_LAYERS, TRAIN_N_PARAMS, TRAIN_BATCH,
                          TRAIN_SEQ, TRAIN_LR, "11c", "17b"),
    ARCH: TrainCell(MAMBA_TRAIN_LAYERS, MAMBA_TRAIN_N_PARAMS, TRAIN_BATCH,
                    TRAIN_SEQ, TRAIN_LR, "11f", "17c"),
    ENCDEC_ARCH: TrainCell(ENCDEC_LAYERS, ENCDEC_N_PARAMS, ENCDEC_BATCH,
                           ENCDEC_SEQ, TRAIN_LR, "14c", None),
    VLM_ARCH: TrainCell(VLM_LAYERS, VLM_N_PARAMS, VLM_BATCH, VLM_SEQ, VLM_LR,
                        "14d", None),
    HYBRID_ARCH: TrainCell(HYBRID_TRAIN_LAYERS, HYBRID_TRAIN_N_PARAMS,
                           TRAIN_BATCH, TRAIN_SEQ, HYBRID_TRAIN_LR, "12b",
                           "17d"),
    MOE_TRAIN_ARCH: TrainCell(MOE_TRAIN_LAYERS, MOE_TRAIN_N_PARAMS,
                              TRAIN_BATCH, TRAIN_SEQ, MOE_TRAIN_LR, "13b",
                              "17e"),
    # granite-20b at full width cut to 6 of its 52 layers (2,878,605,312
    # float32 parameters: 46.1 GB with gradients and AdamW moments, beside
    # 11c's 47.3; 52.1 GB at 7 layers).  MQA: a step launches 12 wgmma
    # flash forwards and 6 backwards, each backward's dK/dV units walking
    # all 48 query heads of the one kv head.  Its peak rate under AdamW:
    # from the same draw its losses over the 4 steps read
    # (train_check_causes.py lr --arch granite-20b on an NVIDIA H100 80GB
    # HBM3 at its 700.00 W power limit): at 0, 11.345, 11.236, 11.372,
    # 11.280 (the batches' own spread); at 3e-7, 11.35, 10.93, 10.85,
    # 10.63; at 1e-6, 11.35, 10.23, 9.65, 9.19; at 2e-6, 11.35, 9.28, 8.40,
    # 8.10; at 3e-6, 11.35, 8.50, 8.98, 8.52; at 5e-6, 11.35, 8.88, 7.58,
    # 7.21; at 1e-5, 11.35, 12.76, 7.64, 7.20; at 3e-5, 11.35, 17.36,
    # 10.51, 10.46; at 1e-4, 11.35, 21.32, 20.27, 16.85; at TRAIN_LR,
    # 11.35, 25.24, 26.37, 19.91.  5e-6 is the largest of these rates at
    # which the 4 losses fall
    "granite-20b": TrainCell(6, 2_878_605_312, TRAIN_BATCH, TRAIN_SEQ, 5e-6,
                             "18b", "17f"),
    # qwen3-14b at full width cut to 4 of its 40 layers (2,877,077,504:
    # 46.0 GB; 51.3 GB at 5 layers), per-head RMS qk_norm in the gradient:
    # 8 wgmma flash forwards and 4 backwards a step.  Its peak rate under
    # AdamW, read as granite-20b's: at 0, 12.260, 12.248, 12.286, 12.333; at
    # 3e-6, 12.26, 11.01, 10.19, 9.87; at 1e-5, 12.26, 10.12, 8.58, 8.26; at
    # 3e-5, 12.26, 16.00, 9.16, 7.83; at 1e-4, 12.26, 22.10, 15.03, 13.39;
    # at TRAIN_LR, 12.26, 25.07, 19.41, 16.65.  1e-5 is the largest of these
    # rates at which the 4 losses fall
    "qwen3-14b": TrainCell(4, 2_877_077_504, TRAIN_BATCH, TRAIN_SEQ, 1e-5,
                           "18c", "17g")}


def _costs():
    """``repro_torch.launch.costs``: the H100's constants and the kernels'
    bounds (``bound``, ``scan_bound``, ``flash_bound``,
    ``scan_grad_bound``), one piece of arithmetic with the dry-run's
    counts."""
    from repro_torch.launch import costs
    return costs


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def line(tag: str, payload) -> None:
    print(f"{tag}: {json.dumps(payload)}", flush=True)


def phase_device(torch) -> str:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    line("device", {"kind": name, "count": torch.cuda.device_count(),
                    "capability": list(torch.cuda.get_device_capability(0)),
                    "torch": torch.__version__, "cuda": torch.version.cuda,
                    "nvidia_smi": smi})
    return name


def phase_build() -> None:
    from repro_torch.kernels import _build
    cached = (_build.build_dir() / "libkernels.so").exists()
    t0 = time.perf_counter()
    _build.library()
    seconds = time.perf_counter() - t0
    kernels, entry, source = [], None, None
    for text in _build.ptxas_report().splitlines():
        if text.startswith("== "):
            source, entry = text[3:].strip(), None
            continue
        m = re.search(r"Compiling entry function '(\S+)'", text)
        if m:
            entry = {"source": source, "entry": m.group(1)}
            kernels.append(entry)
            continue
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      text)
        if m:
            entry["spill_stores"], entry["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", text)
        if m:
            entry["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", text)
            entry["smem_bytes"] = int(m.group(1)) if m else 0
    sources = {k["source"] for k in kernels}
    if sources != {"matmul.cu", "matmul_wgmma.cu", "ssm_scan.cu",
                   "ssm_scan_bwd.cu", "flash_attention.cu",
                   "flash_attention_wgmma.cu", "flash_attention_bwd.cu",
                   "flash_attention_bwd_wgmma.cu"} or \
            any("registers" not in k for k in kernels):
        fail(f"no ptxas report for every kernel:\n{_build.ptxas_report()}")
    line("build", {"seconds": seconds, "cached": cached,
                   "dir": str(_build.build_dir().relative_to(ROOT)),
                   "ptxas": kernels})


def cuda_ms(torch, fn, reps: int = REPS) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, after one warm-up."""
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


def cuda_median_ms(torch, fn, reps: int = GRAD_REPS,
                   warmups: int = GRAD_WARMUPS) -> float:
    """Median device time of ``fn`` over ``reps`` calls, each between its
    own CUDA events, after ``warmups`` calls."""
    for _ in range(warmups):
        fn()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda.synchronize()
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def device_busy_ms(torch, fn, reps: int = GRAD_REPS) -> float:
    """Device time of one call of ``fn``: the self device times of the
    device's entries under ``torch.profiler`` over ``reps`` calls, after a
    warm-up, divided by ``reps``; unlike CUDA events it leaves out the time
    the device waits for the host.  Read only before phase 4b: after the
    phases that start worker processes the profiler's kernel durations
    shrink against CUDA events on the H100 (PERF.md §7)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3 / reps


@contextlib.contextmanager
def timed_launches(torch, module, name: str, shapes=None):
    """Within the block, every call that ``kernels/ops.py`` makes of the
    kernel wrapper ``module.<name>`` is bracketed by CUDA events on the
    current stream; yields the list of (start, end) pairs.  Only ops.py's
    reference to the module is swapped: the wrapper itself, and the launch
    counts it keeps on its own function object, are untouched.  Each
    call's first argument's shape is appended to ``shapes`` when given."""
    from repro_torch.kernels import ops
    alias = next(a for a, val in vars(ops).items() if val is module)
    inner = getattr(module, name)
    events = []

    def timed(*args, **kwargs):
        if shapes is not None:
            shapes.append(list(args[0].shape))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = inner(*args, **kwargs)
        end.record()
        events.append((start, end))
        return out

    setattr(ops, alias, types.SimpleNamespace(**{name: timed}))
    try:
        yield events
    finally:
        setattr(ops, alias, module)


def events_ms(torch, events) -> float:
    """Device milliseconds between each pair of events, summed."""
    torch.cuda.synchronize()
    return sum(start.elapsed_time(end) for start, end in events)


def close(torch, got, want, K: int, dtype: str):
    """(max abs error, max error of out/sqrt(K), within tolerance?)"""
    g, w = got.float(), want.float()
    err = (g - w).abs().max().item()
    s = math.sqrt(max(K, 1))
    ok = torch.allclose(g / s, w / s, rtol=TOL[dtype], atol=TOL[dtype])
    return err, err / s, ok


def phase_kernels(torch) -> list:
    from repro_torch.kernels import matmul as mm, ref
    gen = torch.Generator(device="cuda").manual_seed(0)
    checks = []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).removeprefix("torch.")
        for M, N, K in KERNEL_SHAPES:
            x = torch.randn(M, K, generator=gen, device="cuda").to(dtype)
            y = torch.randn(K, N, generator=gen, device="cuda").to(dtype)
            # fresh allocations: 16-byte aligned
            path = mm.route(dtype, N, K)
            loads = mm.variant(dtype, N, K)
            before = mm.matmul.route_launches[path]
            got = mm.matmul(x, y)
            want = ref.matmul(x, y)
            torch.cuda.synchronize()
            if mm.matmul.route_launches[path] != before + 1:
                fail(f"matmul {dname} {M}x{N}x{K}: no launch on the "
                     f"{path} route")
            err, norm_err, ok = close(torch, got, want, K, dname)
            if not ok:
                fail(f"matmul {dname} {M}x{N}x{K} ({path}, {loads}): kernel "
                     f"disagrees with the plain version, max "
                     f"|err|/sqrt(K) = {norm_err}")
            # the library call against the same plain version, so a zero
            # error above can be read beside one the comparison does see
            lib_err = close(torch, torch.matmul(x, y), want, K, dname)[0]
            b_ms, b_by = _costs().bound(M, N, K, dname, x.element_size())
            checks.append({
                "shape": [M, N, K], "dtype": dname, "route": path,
                "variant": loads, "max_abs_err": err,
                "max_err_over_sqrt_k": norm_err, "tol": TOL[dname],
                "library_max_abs_err": lib_err,
                "ms": cuda_ms(torch, lambda: mm.matmul(x, y)),
                "device_ms": device_busy_ms(torch, lambda: mm.matmul(x, y)),
                "plain_ms": cuda_ms(torch, lambda: ref.matmul(x, y)),
                "library_ms": cuda_ms(torch, lambda: torch.matmul(x, y)),
                "library_device_ms": device_busy_ms(
                    torch, lambda: torch.matmul(x, y)),
                "bound_ms": b_ms, "bound_by": b_by})
            c = checks[-1]
            tiles = ""
            if path == "wgmma":
                p = mm.plan(M, N, mm.resident_blocks(x.device.index))
                c.update(tile=[mm.TILE_M, p.tile_n], blocks=p.blocks,
                         raster_group=p.group)
                tiles = (f", {mm.TILE_M}x{p.tile_n} tiles on {p.blocks} "
                         f"blocks")
            print(f"matmul {dname} {M}x{N}x{K} ({path}, {loads} loads"
                  f"{tiles}): err/sqrt(K) {norm_err:.3g} (tol {TOL[dname]}) "
                  f"| kernel {c['ms']:.4f} ms, device {c['device_ms']:.4f} | "
                  f"plain {c['plain_ms']:.4f} ms | torch.matmul "
                  f"{c['library_ms']:.4f} ms, device "
                  f"{c['library_device_ms']:.4f} | bound {b_ms:.4f} ms "
                  f"({b_by})", flush=True)
            del x, y, got, want
    line("kernels_vs_plain", checks)
    return checks


def _bits(torch, t):
    return t.view(torch.int32 if t.element_size() == 4 else torch.int16)


def _same(torch, a, b) -> bool:
    """Bit for bit equal: tensors by their bits, other values by ``==``."""
    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.shape == b.shape
                and a.dtype == b.dtype and a.device == b.device
                and torch.equal(_bits(torch, a), _bits(torch, b)))
    return a == b


def phase_main_path(torch, checks: list):
    """Phase 4; returns the kernel launches, the graph and the sequential
    run's values (phase 4b's reference)."""
    import numpy as np
    from repro_torch.interop import tensor_from_numpy
    from repro_torch.kernels import matmul as mm, ref
    from repro_torch.workloads import run_matrix_dag

    torch.cuda.reset_peak_memory_stats()
    _reset(mm.matmul)
    graph, seq, rep_seq = run_matrix_dag(N_TASKS, SIZE, 1)
    seq_launches = mm.matmul.launches
    _, par, rep_par = run_matrix_dag(N_TASKS, SIZE, N_WORKERS)
    launches = mm.matmul.launches
    n_mul = sum(1 for n in graph if n.name == "mul")
    if n_mul != N_TASKS or seq_launches != n_mul \
            or launches - seq_launches != n_mul:
        fail(f"expected {n_mul} kernel launches per run, got "
             f"{seq_launches} and {launches - seq_launches}")
    if mm.matmul.route_launches != {"wgmma": 0, "simt": launches}:
        fail(f"float32 mul launches by route: {mm.matmul.route_launches}")
    if len(graph) != 3 * N_TASKS + 1 or set(seq) != set(par):
        fail("the two runs computed different node sets")
    for tid, a in seq.items():
        if not _same(torch, a, par[tid]):
            fail(f"threaded != sequential at {graph.nodes[tid].name}#{tid}")
    worst = 0.0
    for node in graph:
        if node.name != "mul":
            continue
        x, y = (seq[d] for d in node.deps)
        _, norm_err, ok = close(torch, seq[node.tid], ref.matmul(x, y),
                                SIZE, "float32")
        worst = max(worst, norm_err)
        if not ok:
            fail(f"mul#{node.tid} disagrees with the plain matmul: "
                 f"max |err|/sqrt(K) = {norm_err}")
    total = seq[graph.outputs[0]]
    if not math.isfinite(total):
        fail(f"reduce is not finite: {total}")
    peak = torch.cuda.max_memory_allocated()
    del par

    # where the time goes: one gen is a host numpy draw, then a copy to
    # the card; timed apart, one at a time, on the host's clock
    draw_s = copy_s = 0.0
    for seed in range(4):
        t0 = time.perf_counter()
        a = np.random.default_rng(seed).standard_normal((SIZE, SIZE),
                                                        dtype=np.float32)
        t1 = time.perf_counter()
        tensor_from_numpy(a, "cuda")
        torch.cuda.synchronize()
        draw_s += t1 - t0
        copy_s += time.perf_counter() - t1
    draw_ms, copy_ms = draw_s / 4 * 1e3, copy_s / 4 * 1e3
    gen_ms = draw_ms + copy_ms
    mul_ms = next(c["ms"] for c in checks
                  if c["dtype"] == "float32" and c["shape"] == [SIZE] * 3)
    seq_s = rep_seq["wall_time"]
    line("main_path", {
        "units": N_TASKS, "size": SIZE, "nodes": len(graph),
        "workers": N_WORKERS, "launches_per_run": n_mul,
        "seq_wall_s": seq_s, "threaded_wall_s": rep_par["wall_time"],
        "threaded_stats": rep_par["stats"],
        "threaded_equals_sequential": True, "reduce": total,
        "max_mul_err_over_sqrt_k": worst, "peak_device_bytes": peak,
        "gen_ms_each": gen_ms, "gen_draw_ms_each": draw_ms,
        "gen_copy_ms_each": copy_ms, "mul_kernel_ms_each": mul_ms,
        "seq_share_gen": 2 * N_TASKS * gen_ms / 1e3 / seq_s,
        "seq_share_mul": N_TASKS * mul_ms / 1e3 / seq_s})
    return launches, graph, seq


def shm_bytes():
    """Size and free bytes of ``/dev/shm`` ((0, 0) where there is none)."""
    try:
        st = os.statvfs("/dev/shm")
    except OSError:
        return 0, 0
    return st.f_blocks * st.f_frsize, st.f_bavail * st.f_frsize


def phase_process_path(torch, graph, seq) -> int:
    """Phase 4b: phase 4's traced DAG on the cluster runtime's spawned
    workers (a forked child cannot use CUDA once this process has); returns
    the matmul launches of its runs as the workers counted them.  Each
    worker reports its launches with every ``done`` and the executor sums
    them; a run fails unless they equal the ``mul`` tasks that the
    executor saw run (every ``mul`` once, plus those in recomputed
    super-tasks), all on the simt route with vector loads, and this process
    launched none.

    A ``/dev/shm`` smaller than a value passes the shared-memory probe and
    then kills the worker that writes the segment (SIGBUS).  The final
    collection publishes every value at once and a recovery publishes again
    what it recomputes, so unless ``/dev/shm`` has room for twice the run's
    values the runs name ``transport="sock"`` (unix sockets) and say so."""
    from repro_torch.cluster import serde
    from repro_torch.config import ClusterConfig
    from repro_torch.core import make_executor
    from repro_torch.core.fusion import fuse
    values = sum(n.out_bytes for n in graph)
    shm_total, shm_free = shm_bytes()
    room = serde.shm_available() and shm_free >= 2 * values
    transport = "auto" if room else "sock"
    n_mul = sum(1 for n in graph if n.name == "mul")
    driver = _counters()["matmul"]
    total = 0
    for spec, fail_worker in PROCESS_RUNS:
        _reset(driver)
        config = ClusterConfig(n_workers=N_WORKERS, start_method="spawn",
                               fuse=spec, fail_worker=fail_worker,
                               transport=transport,
                               progress_timeout=PROCESS_TIMEOUT)
        ex = make_executor("process", N_WORKERS, config=config)
        t0 = time.perf_counter()
        try:
            got = ex.run(graph)
        finally:
            ex.close()
        wall = time.perf_counter() - t0
        stats = ex.stats
        what = f"process backend, fuse={spec}, fail_worker={fail_worker}"
        if set(got) != set(seq):
            fail(f"{what}: computed another node set")
        for tid, want in seq.items():
            if not _same(torch, got[tid], want):
                fail(f"{what}: {graph.nodes[tid].name}#{tid} differs from "
                     f"the sequential run")
        plan = fuse(graph, spec)
        if plan.n_clusters != stats["n_clusters"]:
            fail(f"{what}: {stats['n_clusters']} super-tasks, the plan has "
                 f"{plan.n_clusters}")
        redo = [m for ev in ex.recovery_events for c in ev["plan"]
                for m in plan.members[c] if graph.nodes[m].name == "mul"]
        if fail_worker is None and (stats["failures"] or
                                    stats["recomputed"]):
            fail(f"{what}: {stats['failures']} worker deaths, "
                 f"{stats['recomputed']} recomputed super-tasks")
        if fail_worker is not None and (stats["failures"] != 1 or
                                        stats["recomputed"] < 1):
            fail(f"{what}: {stats['failures']} worker deaths and "
                 f"{stats['recomputed']} recomputed super-tasks, expected "
                 f"1 and at least 1")
        if stats["n_speculative"]:
            fail(f"{what}: {stats['n_speculative']} speculative runs")
        ran = stats["tasks_run"].get("mul", 0)
        if ran != n_mul + len(redo):
            fail(f"{what}: the executor saw {ran} mul tasks run, expected "
                 f"{n_mul} plus {len(redo)} recomputed")
        in_workers = stats["kernel_launches"]
        launches = in_workers.get("matmul", 0)
        want = {"matmul": ran, "matmul/simt": ran, "matmul/vector": ran}
        if in_workers != want:
            fail(f"{what}: the workers launched {in_workers}, expected "
                 f"{want}")
        if driver.launches:
            fail(f"{what}: this process launched {driver.launches} "
                 f"matmuls")
        total += launches
        line("process_path", {
            "fuse": spec, "fail_worker": fail_worker, "workers": N_WORKERS,
            "start_method": ex.start_method, "nodes": len(graph),
            "wall_s": wall,
            "first_done_s": stats["first_done_s"],
            "last_done_s": stats["last_done_s"],
            # the workers' own seconds in super-tasks (inputs resolved,
            # members run), summed over the completed ones
            "worker_task_s": sum(ex.last_trace.tasks.values()),
            "transport_requested": transport,
            "transport_used": ex.transport_used,
            "transport_note": None if room else
            f"/dev/shm cannot hold twice the run's {values} bytes of "
            f"values, so the run names transport='sock'",
            "dev_shm_bytes": shm_total, "dev_shm_free_bytes": shm_free,
            "values_bytes": values,
            **{k: stats[k] for k in (
                "n_clusters", "tasks_fused", "dispatched", "control_msgs",
                "control_frames", "dispatch_overhead_s", "bytes_direct",
                "bytes_driver", "bytes_moved", "transfers_direct",
                "transfers_driver", "recomputed", "failures")},
            "tasks_run": stats["tasks_run"], "recomputed_muls": len(redo),
            "worker_kernel_launches": in_workers,
            "equals_sequential": True, "reduce": got[graph.outputs[0]]})
        del got
    return total


def _wait_all(futs: dict, submitted: dict, timeout: float) -> dict:
    """Waits for every future; returns each one's seconds from its submit
    to its result in this process (the client's wall)."""
    walls = {}

    def wait(key):
        futs[key].exception(timeout)
        walls[key] = time.perf_counter() - submitted[key]

    threads = [threading.Thread(target=wait, args=(k,)) for k in futs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return walls


def phase_gateway_path(torch, graph, seq) -> int:
    """Phase 4c: phase 4's DAG through the multi-tenant gateway, whose
    resident pool spawns 4 workers once for all its jobs; returns the
    matmul launches of its jobs as their workers reported them.  Every job
    fails the phase unless it equals the sequential run bit for bit (all
    values, or with ``outputs_only`` the ``reduce``), its own matmul
    launches equal its own ``mul`` tasks run, all on the simt route with
    vector loads, and this process launched none.

    Two jobs are in flight at once in runs 2 and 4, so unless ``/dev/shm``
    has room for twice the values of both, the pool names
    ``transport="sock"`` and says so (see phase 4b)."""
    from repro_torch.cluster import serde
    from repro_torch.config import ClusterConfig
    from repro_torch.gateway import (GatewayService, QuotaExceeded,
                                     TenantQuota, connect)
    values = sum(n.out_bytes for n in graph)
    shm_total, shm_free = shm_bytes()
    room = serde.shm_available() and shm_free >= 2 * 2 * values
    transport = "auto" if room else "sock"
    n_mul = sum(1 for n in graph if n.name == "mul")
    reduce_tid = graph.outputs[0]
    token = secrets.token_hex(16)
    driver = _counters()["matmul"]
    _reset(driver)
    config = ClusterConfig(n_workers=N_WORKERS, start_method="spawn",
                           fuse="auto", transport=transport, token=token,
                           progress_timeout=PROCESS_TIMEOUT)
    # the thin tenant's store quota is one byte short of one job's values
    gw = GatewayService(config, quotas={
        "thin": TenantQuota(max_store_bytes=values - 1)})
    t_start = time.perf_counter()
    gw.start()
    total = n_jobs = 0
    clients = {}

    def client(tenant):
        if tenant not in clients:
            clients[tenant] = connect(gw.address, token=token, tenant=tenant)
        return clients[tenant]

    def run(what, tenants, during=None):
        """Submits the DAG for each tenant at once (``tenants`` maps each
        to its ``outputs_only``), waits for all, checks and prints each
        job; returns the futures and their submit times."""
        nonlocal total, n_jobs
        futs, submitted = {}, {}
        t0 = time.perf_counter()
        for tenant, outputs_only in tenants.items():
            submitted[tenant] = time.perf_counter()
            futs[tenant] = client(tenant).submit(
                graph, outputs_only=outputs_only, label=f"{what}-{tenant}")
        if during is not None:
            during(futs)
        walls = _wait_all(futs, submitted, 4 * PROCESS_TIMEOUT)
        together = time.perf_counter() - t0
        for tenant, fut in futs.items():
            got = fut.result(0)
            outputs_only = tenants[tenant]
            job = f"{what} job of tenant {tenant!r}"
            want = {reduce_tid} if outputs_only else set(seq)
            if set(got) != want:
                fail(f"{job}: returned {len(got)} values, expected "
                     f"{len(want)}")
            for tid in want:
                if not _same(torch, got[tid], seq[tid]):
                    fail(f"{job}: {graph.nodes[tid].name}#{tid} differs "
                         f"from the sequential run")
            stats = fut.stats
            ran = stats["tasks_run"].get("mul", 0)
            if ran < n_mul or (stats["recomputed"] == 0 and ran != n_mul):
                fail(f"{job}: ran {ran} mul tasks, {stats['recomputed']} "
                     f"super-tasks recomputed, for {n_mul} mul nodes")
            in_workers = stats["kernel_launches"]
            if in_workers != {"matmul": ran, "matmul/simt": ran,
                              "matmul/vector": ran}:
                fail(f"{job}: its workers launched {in_workers}, expected "
                     f"{ran} matmuls on the simt route with vector loads")
            total += ran
            n_jobs += 1
            line("gateway_path", {
                "run": what, "tenant": tenant,
                "outputs_only": outputs_only, "workers": N_WORKERS,
                "client_wall_s": walls[tenant], "run_wall_s": together,
                # from the job's gather to its results in the client: the
                # frame's encode, its trip over localhost TCP, its decode
                "gather_to_client_s": walls[tenant]
                - stats["submit_to_gather_s"],
                **{k: stats[k] for k in (
                    "job_id", "n_clusters", "submit_to_first_dispatch_s",
                    "submit_to_gather_s", "result_bytes", "result_encode_s",
                    "result_decode_s", "recomputed", "tasks_run",
                    "kernel_launches")},
                "values_returned": len(got),
                "equals_sequential": True, "reduce": got[reduce_tid]})
            del got
        return futs, submitted

    try:
        # 1. cold: the pool's start-up is paid inside this job.  The
        # driver queues the first super-tasks on the workers' pipes before
        # they have booted, so the first dispatch comes at once; the first
        # completed super-task (as in phase 4b) is what shows the start-up
        futs, submitted = run("cold", {"cold": False})
        first_dispatch = (submitted["cold"] - t_start
                          + futs["cold"].stats["submit_to_first_dispatch_s"])
        del futs
        # 2. warm: two tenants at once, only the reduce comes back
        run("warm", {"a": True, "b": True})
        # 3. quota: a typed rejection, and nothing admitted
        admitted = gw.executor.stats["jobs_admitted"]
        err = client("thin").submit(graph).exception(PROCESS_TIMEOUT)
        if not (isinstance(err, QuotaExceeded)
                and err.resource == "store_bytes"
                and err.limit == values - 1):
            fail(f"quota: tenant 'thin' got {err!r}, expected QuotaExceeded "
                 f"on store_bytes with limit {values - 1}")
        thin = gw.stats()["thin"]
        if gw.executor.stats["jobs_admitted"] != admitted or \
                thin["submitted"] or thin["inflight_jobs"] or \
                thin["rejected"] != 1:
            fail(f"quota: a rejected job was admitted ({thin})")
        line("gateway_quota", {"tenant": "thin", "resource": err.resource,
                               "limit": err.limit,
                               "requested": err.requested,
                               "message": str(err)})

        # 4. a worker SIGKILLed while the victim's clusters run
        def kill_when_running(futs):
            base = gw.executor.stats["dispatched"]
            deadline = time.perf_counter() + PROCESS_TIMEOUT
            while gw.executor.stats["dispatched"] < base + N_WORKERS + 2:
                if time.perf_counter() > deadline or futs["victim"].done():
                    fail("SIGKILL run: the victim's clusters never ran")
                time.sleep(0.01)
            gw.executor.kill_worker(1)

        # the victim takes every value back, recomputed ones included
        failures = gw.executor.stats["failures"]
        run("sigkill", {"victim": False, "bystander": True},
            during=kill_when_running)
        pool = gw.stats()
        if gw.executor.stats["failures"] != failures + 1:
            fail(f"SIGKILL run: {gw.executor.stats['failures'] - failures} "
                 f"worker deaths, expected 1")
        if any(pool[t]["failed"] for t in pool if t != "pool"):
            fail(f"a tenant's job failed: {pool}")
        if driver.launches:
            fail(f"gateway path: this process launched {driver.launches} "
                 f"matmuls")
        line("gateway_pool", {
            "workers": N_WORKERS, "start_method": gw.executor.start_method,
            "first_dispatch_s": first_dispatch,
            # from start() to the first completed super-task: 4 spawned
            # interpreters, torch, CUDA contexts, the library, one gen pair
            "first_done_s": gw.executor.stats["first_done_s"],
            "transport_requested": transport,
            "transport_used": gw.executor.transport_used,
            "transport_note": None if room else
            f"/dev/shm cannot hold twice the values of two jobs "
            f"({2 * values} bytes), so the pool names transport='sock'",
            "dev_shm_bytes": shm_total, "dev_shm_free_bytes": shm_free,
            "jobs": n_jobs, "matmul_launches": total,
            **{k: gw.executor.stats[k] for k in (
                "jobs_admitted", "jobs_completed", "jobs_failed",
                "failures", "recomputed", "dispatched", "bytes_direct",
                "bytes_driver")},
            "tenants": {t: {k: v[k] for k in (
                "completed", "failed", "rejected")}
                for t, v in pool.items() if t != "pool"}})
    finally:
        for c in clients.values():
            c.close()
        gw.stop()
    torch.cuda.empty_cache()
    return total


# phase 4d: the cluster runtime's fault-tolerance paths.  The straggling
# mul's first execution sleeps past the twin's finish; (e) kills its driver
# after this many completed super-tasks
SPECULATE_AFTER = 2.0
STRAGGLER_SLEEP_S = 5.0
FAULT_PLAN_SEED = 23
DRIVER_KILL_AFTER = 6


def _straggling(path: str, sleep_s: float, fn, *xs):
    """Phase 4d (a)'s straggler: runs ``fn``; its first execution anywhere
    (the creator of the sentinel file ``path``) sleeps ``sleep_s`` first.
    Module level, so a spawned worker unpickles it from this script."""
    try:
        fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
    except FileExistsError:
        return fn(*xs)
    os.close(fd)
    time.sleep(sleep_s)
    return fn(*xs)


def _held(value):
    """A task body returning a value computed earlier (phase 4's product)."""
    return value


def _fig2_all_reduce(n_tasks: int, size: int, device: str):
    """Phase 4's DAG with its products summed by a traced binary
    ``all_reduce`` before ``reduce`` (the tree's bracketing is the value)."""
    from repro_torch.core import all_reduce, task, trace
    from repro_torch.workloads import COST_GEN, COST_MUL, _gen, _mul, _red
    nbytes = size * size * 4
    gen = task(_gen, cost=COST_GEN, name="gen", out_bytes=nbytes)
    mul = task(_mul, cost=COST_MUL, name="mul", out_bytes=nbytes)
    red = task(_red, cost=0.0, name="reduce")

    def driver():
        return red(all_reduce(
            [mul(gen(2 * i, size, "float32", device),
                 gen(2 * i + 1, size, "float32", device))
             for i in range(n_tasks)], "sum", arity=2))

    return trace(driver)[0]


def phase_runtime_path(torch, graph, seq) -> int:
    """Phase 4d: the cluster runtime's fault-tolerance paths on phase 4's
    DAG, 4 spawned workers, CUDA tensors, outputs only; returns the matmul
    launches of its runs as the workers counted them.  Runs: (a) one
    ``mul``'s first execution asleep, ``speculate_after`` set; (b) a fault
    plan (delay, dup, reorder, a failed fetch) on the tcp channel; (c) the
    products summed by a traced ``all_reduce`` with worker 1 SIGKILLed once
    a tree hop is done; (d) a ``python -m repro_torch.launch.remote``
    worker dialing the live tcp run; (e) the driver killed, then a new one
    resumed from the run log.  Every run fails the phase unless its
    ``reduce`` is the sequential value bit for bit (phase 4's; in (c) the
    collective graph's), its workers' matmul launches equal the ``mul``
    tasks it saw run (twins, losers and recomputes, never a frame delivered
    twice), all on the simt route with vector loads, and this process
    launched none.  The transport follows phase 4b's ``/dev/shm`` rule but
    in (b), whose fetch faults need unix sockets."""
    import tempfile
    from functools import partial
    from repro_torch.checkpoint.runlog import load_run
    from repro_torch.cluster import ClusterExecutor, DriverKilled, serde
    from repro_torch.config import ClusterConfig
    from repro_torch.core import all_reduce, execute_sequential, task, trace
    from repro_torch.core.collectives import lower_collectives
    from repro_torch.core.fusion import fuse
    from repro_torch.faults import FaultPlan, RetryPolicy
    from repro_torch.workloads import _red, matrix_driver
    values = sum(n.out_bytes for n in graph)
    _, shm_free = shm_bytes()
    room = serde.shm_available() and shm_free >= 2 * values
    transport = "auto" if room else "sock"
    device = str(next(iter(seq.values())).device)
    driver = _counters()["matmul"]
    scratch_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_4d_")
    scratch = scratch_dir.name
    total = 0

    def config(**kw):
        kw.setdefault("transport", transport)
        return ClusterConfig(n_workers=N_WORKERS, start_method="spawn",
                             outputs_only=True,
                             progress_timeout=PROCESS_TIMEOUT, **kw)

    def run(ex, g):
        _reset(driver)
        t0 = time.perf_counter()
        try:
            return ex.run(g), time.perf_counter() - t0
        finally:
            ex.close()

    def check(what, ex, g, got, wall, want, extra, complete=True):
        """Holds one run to the phase's rules and prints its line."""
        nonlocal total
        stats = ex.stats
        out = g.outputs[0]
        if got is not None and (set(got) != {out}
                                or not _same(torch, got[out], want)):
            fail(f"{what}: reduce {got.get(out)} is not the sequential "
                 f"{want}")
        ran = stats["tasks_run"].get("mul", 0)
        n_mul = sum(1 for n in g if n.name == "mul")
        if complete and ran < n_mul:
            fail(f"{what}: {ran} mul tasks ran for {n_mul} mul nodes")
        in_workers = stats["kernel_launches"]
        if in_workers != ({"matmul": ran, "matmul/simt": ran,
                           "matmul/vector": ran} if ran else {}):
            fail(f"{what}: the workers launched {in_workers}, expected "
                 f"{ran} matmuls on the simt route with vector loads")
        if driver.launches:
            fail(f"{what}: this process launched {driver.launches} matmuls")
        total += ran
        line("runtime_path", {
            "run": what, "workers": N_WORKERS, "wall_s": wall,
            "first_done_s": stats["first_done_s"],
            "last_done_s": stats["last_done_s"],
            "transport_requested": ex.transport,
            "transport_used": ex.transport_used, "nodes": len(g),
            **{k: stats[k] for k in (
                "n_clusters", "dispatched", "control_msgs", "failures",
                "recomputed", "joins", "n_speculative", "speculative_wins",
                "speculative_wasted_s", "bytes_direct", "bytes_driver")},
            "tasks_run": stats["tasks_run"],
            "worker_kernel_launches": in_workers, **extra,
            "equals_sequential": got is not None,
            "reduce": got[g.outputs[0]] if got is not None else None})

    try:
        want = seq[graph.outputs[0]]
        # (a) speculation: the straggler is the mul of the last [gen, gen, mul]
        # cluster (no inputs to fetch, so a twin can start on any idle worker)
        g = trace(matrix_driver, N_TASKS, SIZE, device=device)[0]
        plan = fuse(g, "auto", keep_parallelism=N_TASKS)
        cid = max(c for c, ms in plan.members.items()
                  if [g.nodes[m].name for m in ms] == ["gen", "gen", "mul"])
        node = g.nodes[plan.members[cid][-1]]
        node.fn = partial(_straggling, os.path.join(scratch, "straggler"),
                          STRAGGLER_SLEEP_S, node.fn)
        ex = ClusterExecutor(config=config(
            fuse="auto", keep_parallelism=N_TASKS,
            speculate_after=SPECULATE_AFTER))
        got, wall = run(ex, g)
        twinned = {e["tid"] for e in ex.speculation_events}
        if cid not in twinned or ex.stats["speculative_wins"] < 1:
            fail(f"speculation: super-tasks {sorted(twinned)} twinned, the "
                 f"straggler's is {cid}; {ex.stats['speculative_wins']} wins")
        check("speculation", ex, g, got, wall, want, {
            "straggler": f"mul#{node.tid}", "straggler_cluster": cid,
            "straggler_sleep_s":
            STRAGGLER_SLEEP_S, "speculate_after": SPECULATE_AFTER,
            "speculation_events": ex.speculation_events})

        # (b) a fault plan on the tcp channel: the workers' frames to the
        # driver delayed, duplicated and reordered (the driver's to them are
        # left alone: a parked ``stop`` would hold each worker to its 5 s
        # shutdown timeout), and every worker's copy of the plan fails its
        # first fetch (a pickled plan starts its counters afresh).  Fetch
        # faults strike peer fetches, which shared memory never makes, so this
        # run names the unix-socket transport
        fault_plan = (FaultPlan(seed=FAULT_PLAN_SEED)
                      .delay(0.01, dst="driver", prob=0.3)
                      .duplicate(dst="driver", prob=0.3)
                      .reorder(dst="driver", prob=0.3).fail_fetch(nth=1))
        ex = ClusterExecutor(config=config(
            channel="tcp", transport="sock", fuse="off", fault_plan=fault_plan,
            fetch_retry=RetryPolicy(attempts=3, base_delay=0.01, jitter=0.0)))
        got, wall = run(ex, graph)
        if ex.stats["failures"] or ex.stats["recomputed"]:
            fail(f"fault plan: {ex.stats['failures']} deaths, "
                 f"{ex.stats['recomputed']} recomputed super-tasks")
        check("fault_plan_tcp", ex, graph, got, wall, want, {
            "channel": "tcp", "faults": [vars(r) for r in fault_plan.rules],
            **{k: ex.stats[k] for k in ("deplosts", "relay_fallbacks")}})

        # (c) collectives: the products summed by a binary tree, worker 1
        # SIGKILLed once a hop is done; the value is the collective graph's own
        # sequential one, its gens and muls phase 4's values
        g = _fig2_all_reduce(N_TASKS, SIZE, device)
        products = [seq[n.tid] for n in graph if n.name == "mul"]
        held = task(_held, name="mul")
        reduce_ = task(_red, name="reduce")
        eg = trace(lambda: reduce_(all_reduce([held(p) for p in products],
                                              "sum", arity=2)))[0]
        want_c = execute_sequential(eg)[eg.outputs[0]]
        low, _ = lower_collectives(g, "auto")
        n_hops = sum(1 for n in low.nodes.values() if "@L" in n.name)
        ex = ClusterExecutor(config=config(fuse="auto", collectives="auto"))
        at_kill = {}
        done = threading.Event()

        def kill_mid_tree():
            while not done.wait(0.002):
                try:        # the driver's thread updates the live stats
                    ran = dict(getattr(ex, "stats", {}).get("tasks_run", {}))
                except RuntimeError:
                    continue
                hops = sum(n for k, n in ran.items() if "@L" in k)
                if hops:
                    at_kill.update(hops_done=hops,
                                   root_done="all_reduce[sum]" in ran)
                    ex.kill_worker(1)
                    return

        killer = threading.Thread(target=kill_mid_tree, daemon=True)
        killer.start()
        try:
            got, wall = run(ex, g)
        finally:
            done.set()
            killer.join()
        stats = ex.stats
        if not at_kill or at_kill["root_done"] or stats["failures"] != 1 \
                or stats["recomputed"] >= len(low.nodes):
            fail(f"collectives: killed at {at_kill}, {stats['failures']} "
                 f"deaths, {stats['recomputed']} recomputed of "
                 f"{len(low.nodes)} lowered nodes")
        check("collectives_sigkill", ex, g, got, wall, want_c, {
            "collective_roots": stats["collective_roots"],
            "collective_stages": stats["collective_stages"],
            "tree_hops": n_hops, "lowered_nodes": len(low.nodes),
            "killed_worker": 1, "at_kill": at_kill,
            "recovery_events": len(ex.recovery_events)})

        # (d) a repro-worker dials the tcp driver; its dial waits in the
        # listener until the run is seeded and live, then joins it (an elastic
        # join: the driver replans onto 5 workers).  The run log says which
        # products it kept
        log_dir = os.path.join(scratch, "remote")
        ex = ClusterExecutor(config=config(
            channel="tcp", fuse="auto", keep_parallelism=N_TASKS,
            checkpoint_dir=log_dir, checkpoint_interval=0.0))
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [str(SRC)] + ([os.environ["PYTHONPATH"]]
                          if os.environ.get("PYTHONPATH") else [])))
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.remote", "--connect",
             ex.address, "--timeout", str(PROCESS_TIMEOUT)], env=env, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        try:
            deadline = time.perf_counter() + PROCESS_TIMEOUT
            while ex.listener._pending.qsize() < 1:
                if proc.poll() is not None or time.perf_counter() > deadline:
                    fail(f"remote worker never dialed: "
                         f"{proc.communicate()[0][-2000:]!r}")
                time.sleep(0.05)
            got, wall = run(ex, graph)
            out, _ = proc.communicate(timeout=PROCESS_TIMEOUT)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        wid = re.search(r"worker (\d+) finished cleanly", out)
        if proc.returncode or wid is None or ex.stats["joins"] != 1:
            fail(f"remote worker: rc {proc.returncode}, "
                 f"{ex.stats['joins']} joins, output {out[-2000:]!r}")
        wid = int(wid.group(1))
        ran_remote = sum(
            1 for w, sizes in load_run(os.path.join(
                log_dir, f"{ex.run_id}.log")).done.values()
            if w == wid for m in sizes if graph.nodes[m].name == "mul")
        if not ran_remote:
            fail(f"remote worker {wid} ran no mul task")
        check("remote_worker", ex, graph, got, wall, want, {
            "channel": "tcp", "remote_wid": wid, "remote_muls": ran_remote})

        # (e) the driver killed after DRIVER_KILL_AFTER completions, then a new
        # driver resumes from the run log; the tcp workers survive the outage
        # and rejoin it
        log_dir = os.path.join(scratch, "resume")
        kw = dict(channel="tcp", fuse="auto", keep_parallelism=N_TASKS,
                  checkpoint_dir=log_dir, checkpoint_interval=0.0)
        ex = ClusterExecutor(config=config(fail_driver=DRIVER_KILL_AFTER,
                                           **kw))
        _reset(driver)
        t0 = time.perf_counter()
        try:
            ex.run(graph)
            fail("driver kill: the run finished without the kill")
        except DriverKilled:
            pass
        killed_wall = time.perf_counter() - t0
        check("driver_killed", ex, graph, None, killed_wall, want, {
            "fail_driver": DRIVER_KILL_AFTER}, complete=False)
        ex2 = ClusterExecutor(config=config(
            resume=ex.run_id, rejoin_timeout=PROCESS_TIMEOUT, **kw))
        got, wall = run(ex2, graph)
        stats = ex2.stats
        if not stats["resumed_clusters"] or stats["failures"]:
            fail(f"resume: {stats['resumed_clusters']} clusters resumed, "
                 f"{stats['failures']} deaths")
        check("driver_resumed", ex2, graph, got, wall, want, {
            "resumed_clusters": stats["resumed_clusters"],
            "killed_run_wall_s": killed_wall}, complete=False)
    finally:
        scratch_dir.cleanup()
    torch.cuda.empty_cache()
    return total


def phase_scan_kernels(torch) -> list:
    import torch.nn.functional as F
    from repro_torch.kernels import ref, ssm_scan as scan
    from repro_torch.models.layers import ParamSpec, init_param
    gen = torch.Generator(device="cuda").manual_seed(0)
    dev = torch.device("cuda")
    checks = []
    for Bsz, S, D, N, with_h0 in SCAN_SHAPES:
        # dt as the model makes it: softplus of a unit normal shifted by a
        # dt bias from the model's own initialiser; A from mamba_A
        dt_bias = init_param(ParamSpec("smoke/dt_bias", (D,), "mamba_dt"),
                             0, torch.float32, dev)
        A = -torch.exp(init_param(ParamSpec("smoke/A_log", (D, N),
                                            "mamba_A"), 0, torch.float32,
                                  dev))
        x = torch.randn(Bsz, S, D, generator=gen, device=dev)
        dt = F.softplus(torch.randn(Bsz, S, D, generator=gen, device=dev)
                        + dt_bias)
        B = torch.randn(Bsz, S, N, generator=gen, device=dev)
        C = torch.randn(Bsz, S, N, generator=gen, device=dev)
        h0 = (torch.randn(Bsz, D, N, generator=gen, device=dev)
              if with_h0 else None)
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).removeprefix("torch.")
            args = [t.to(dtype) for t in (x, dt, B, C)] + [A, h0]
            y, h = scan.ssm_scan(*args, return_state=True)
            states = scan.ssm_scan(*args, return_states=True)[2]
            want_y, want_h, want_states = ref.ssm_scan(*args,
                                                       return_states=True)
            torch.cuda.synchronize()
            tol = SCAN_TOL[dname]
            err_y = (y.float() - want_y.float()).abs().max().item()
            err_h = (h - want_h).abs().max().item()
            # the states are float32 from inputs widened exactly: the
            # float32 tolerance in either input type
            err_s = (states - want_states).abs().max().item()
            ok = (y.dtype == dtype and h.dtype == torch.float32
                  and torch.allclose(y.float(), want_y.float(), rtol=tol,
                                     atol=tol)
                  and torch.allclose(h, want_h, rtol=tol, atol=tol)
                  and torch.allclose(states, want_states,
                                     rtol=SCAN_TOL["float32"],
                                     atol=SCAN_TOL["float32"]))
            if not ok:
                fail(f"ssm_scan {dname} {(Bsz, S, D, N)} h0={with_h0}: "
                     f"kernel disagrees with the plain version, max |err| "
                     f"y {err_y}, h_final {err_h}, states {err_s}")
            b_ms, b_by = _costs().scan_bound(Bsz, S, D, N, dtype.itemsize,
                                             with_h0)
            checks.append({
                "shape": [Bsz, S, D, N], "h0": with_h0, "dtype": dname,
                "max_abs_err": max(err_y, err_h), "max_abs_err_y": err_y,
                "max_abs_err_h": err_h, "max_abs_err_states": err_s,
                "tol": tol,
                "ms": cuda_ms(torch, lambda: scan.ssm_scan(
                    *args, return_state=True)),
                "states_ms": cuda_ms(torch, lambda: scan.ssm_scan(
                    *args, return_states=True)),
                "plain_ms": cuda_ms(torch, lambda: ref.ssm_scan(
                    *args, return_state=True), reps=2 if S > 64 else REPS),
                "library_ms": None, "bound_ms": b_ms, "bound_by": b_by})
            print(f"ssm_scan {dname} {Bsz}x{S}x{D} N={N} h0={with_h0}: "
                  f"err {checks[-1]['max_abs_err']:.3g} (tol {tol}) | "
                  f"kernel {checks[-1]['ms']:.4f} ms, keeping the states "
                  f"{checks[-1]['states_ms']:.4f} ms | plain "
                  f"{checks[-1]['plain_ms']:.3f} ms | bound {b_ms:.4f} ms "
                  f"({b_by})", flush=True)
            del args, y, h, states, want_y, want_h, want_states
    line("ssm_scan_vs_plain", checks)
    return checks


def _misaligned(torch, t):
    """A contiguous copy of ``t`` one element past a 16-byte boundary, which
    the wgmma route cannot take: a bf16 call with it runs the simt kernel."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def phase_flash_kernels(torch) -> list:
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa, ref
    gen = torch.Generator(device="cuda").manual_seed(0)
    checks = []
    for B, H, KH, Sq, Sk, D, causal in FLASH_SHAPES:
        q = torch.randn(B, H, Sq, D, generator=gen, device="cuda")
        k = torch.randn(B, KH, Sk, D, generator=gen, device="cuda")
        v = torch.randn(B, KH, Sk, D, generator=gen, device="cuda")
        # float32 (simt), bf16 (wgmma at these head dims) and bf16 through
        # the simt kernel (misaligned copies)
        for dtype, aligned in ((torch.float32, True), (torch.bfloat16, True),
                               (torch.bfloat16, False)):
            dname = str(dtype).removeprefix("torch.")
            args = [t.to(dtype) for t in (q, k, v)]
            if not aligned:
                args = [_misaligned(torch, t) for t in args]
            path = fa.route(dtype, D, aligned=aligned)
            what = (f"flash_attention {dname} {(B, H, KH, Sq, Sk, D)} "
                    f"causal={causal} ({path})")
            before = fa.flash_attention.route_launches[path]
            got, lse = fa.flash_attention(*args, causal=causal,
                                          return_lse=True)
            want, want_lse = ref.attention(*args, causal=causal,
                                           return_lse=True)
            again, lse_again = fa.flash_attention(*args, causal=causal,
                                                  return_lse=True)
            torch.cuda.synchronize()
            if fa.flash_attention.route_launches[path] != before + 2:
                fail(f"{what}: no launch on the {path} route")
            tol = TOL[dname]
            err = (got.float() - want.float()).abs().max().item()
            if got.dtype != dtype or not torch.allclose(
                    got.float(), want.float(), rtol=tol, atol=tol):
                fail(f"{what}: kernel disagrees with the plain version, "
                     f"max |err| {err}")
            # -inf - -inf (a row with no key) is NaN: no error
            lse_err = (lse - want_lse).nan_to_num(0.0).abs().max().item()
            if not torch.allclose(lse, want_lse, rtol=LSE_TOL, atol=LSE_TOL):
                fail(f"{what}: the kernel's lse disagrees with the plain "
                     f"version's, max |err| {lse_err}")
            if not (torch.equal(got.view(torch.uint8), again.view(torch.uint8))
                    and torch.equal(lse.view(torch.uint8),
                                    lse_again.view(torch.uint8))):
                fail(f"{what}: two launches gave different bits")

            # the library reads aligned copies of the same values: SDPA
            # stops with "misaligned address" on the misaligned bf16 copies
            # at Sq = 1 (H100, torch 2.11)
            lib_args = args if aligned else [t.clone() for t in args]

            def library():
                return F.scaled_dot_product_attention(
                    *lib_args, is_causal=causal, enable_gqa=True)
            # the library call against the same plain version, so the
            # kernel's error can be read beside one it does not make
            lib_err = (library().float() - want.float()).abs().max().item()
            b_ms, b_by = _costs().flash_bound(B, H, KH, Sq, Sk, D, causal,
                                              dname, dtype.itemsize)
            checks.append({
                "shape": [B, H, KH, Sq, Sk, D], "causal": causal,
                "dtype": dname, "route": path, "aligned": aligned,
                "max_abs_err": err, "tol": tol, "lse_max_abs_err": lse_err,
                "lse_tol": LSE_TOL,
                "same_bits": True, "library_max_abs_err": lib_err,
                "ms": cuda_ms(torch, lambda: fa.flash_attention(
                    *args, causal=causal)),
                "plain_ms": cuda_ms(torch, lambda: ref.attention(
                    *args, causal=causal)),
                "library_ms": cuda_ms(torch, library),
                "bound_ms": b_ms, "bound_by": b_by})
            c = checks[-1]
            print(f"flash_attention {dname} {B}x{H}x{Sq}x{D} kv {KH}x{Sk} "
                  f"causal={causal} ({path}{', misaligned' if not aligned else ''}"
                  f"): err {err:.3g} (tol {tol}), lse {lse_err:.3g} | "
                  f"kernel {c['ms']:.4f} ms | plain "
                  f"{c['plain_ms']:.4f} ms | sdpa {c['library_ms']:.4f} ms | "
                  f"bound {b_ms:.4f} ms ({b_by})", flush=True)
            del args, lib_args, got, want, again, lse, want_lse, lse_again
    line("flash_attention_vs_plain", checks)
    return checks


def phase_params(torch, arch: str, n_params: int, layers: int = 0):
    """Draw ``arch`` on the card from seed 0, cut to its first ``layers``
    layers when given; fails unless it has ``n_params`` parameters."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as TF
    from repro_torch.models.config import cut_depth
    cfg = get_config(arch)
    published = cfg.n_layers
    if layers:
        cfg = cut_depth(cfg, layers)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = TF.init_params(cfg, 0, "cuda")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    leaves, stack = [], [params]
    while stack:
        node = stack.pop()
        if isinstance(node, dict):
            stack.extend(node.values())
        else:
            leaves.append(node)
    n = sum(t.numel() for t in leaves)
    if n != n_params or n != TF.count_params(cfg):
        fail(f"{arch}: drew {n} parameters, expected {n_params}")
    if not all(t.is_cuda and t.dtype == cfg.pdtype for t in leaves):
        fail(f"{arch}: parameters not all {cfg.pdtype} on the card")
    line("params", {"arch": arch, "n_params": n, "dtype": cfg.param_dtype,
                    "bytes": sum(t.numel() * t.element_size()
                                 for t in leaves),
                    "draw_s": seconds, "layers": cfg.n_layers,
                    "published_layers": published,
                    "d_model": cfg.d_model, "vocab": cfg.vocab_size,
                    "compute_dtype": cfg.compute_dtype,
                    **({"d_inner": cfg.d_inner, "state": cfg.ssm_state}
                       if "mamba" in cfg.layer_plan[0] else {}),
                    **({"ssm_heads": cfg.n_ssm_heads,
                        "ssm_head_dim": cfg.ssm_head_dim,
                        "chunk": cfg.ssm_chunk}
                       if "mamba2" in cfg.layer_plan[0] else {}),
                    **({"attention_sites": _kernel_layers(cfg),
                        "heads": cfg.n_heads, "kv_heads": cfg.n_kv_heads,
                        "head_dim": cfg.head_dim, "d_ff": cfg.d_ff}
                       if _path_kernel(cfg) == "flash_attention" else {}),
                    **({"experts": cfg.n_experts,
                        "top_k": cfg.experts_per_token,
                        "expert_d_ff": cfg.expert_d_ff,
                        "shared_experts": cfg.n_shared_experts,
                        "moe_every": cfg.moe_every,
                        "capacity_factor": cfg.capacity_factor,
                        "moe_group": cfg.moe_group,
                        "active_params": TF.count_active_params(cfg)}
                       if cfg.n_experts else {})})
    return cfg, params


# what later phases compare with: phase 9's served tokens and times
# (("serve", arch)) and phase 11f's steps (("train_full", arch))
RESULTS: dict = {}


def _counters():
    from repro_torch.kernels import flash_attention as fa, matmul as mm
    from repro_torch.kernels import ssm_scan as scan
    return {"matmul": mm.matmul, "ssm_scan": scan.ssm_scan,
            "flash_attention": fa.flash_attention}


def _reset(fn) -> None:
    """Sets a kernel wrapper's launch counts, and its counts by route and
    load variant, to 0."""
    fn.launches = 0
    for by in ("route_launches", "variant_launches"):
        if hasattr(fn, by):
            setattr(fn, by, dict.fromkeys(getattr(fn, by), 0))


# the port's kernels among a profile's device entries
PORT_KERNEL = re.compile(r"\b(matmul|matmul_wgmma|ssm_scan|ssm_scan_bwd|"
                         r"flash_attention|flash_wgmma|flash_bwd|delta)"
                         r"_kernel\b")

def expected_route(cfg):
    """The route every launch of a model path's kernel must take, or None
    for a kernel of one route (the scan): for flash attention, what
    ``kernels/flash_attention.py::route`` gives for the path's compute dtype
    and head dim with aligned tensors (qwen2-7b: ``wgmma`` in bf16, ``simt``
    in float32)."""
    if _path_kernel(cfg) != "flash_attention":
        return None
    from repro_torch.kernels import flash_attention as fa
    return fa.route(cfg.cdtype, cfg.head_dim)


def _check_routes(fn, cfg, what: str) -> dict:
    """A path kernel's launches by route; fails if one left its route."""
    routes = getattr(fn, "route_launches", None)
    want = expected_route(cfg)
    if want and routes != {r: (fn.launches if r == want else 0)
                           for r in routes}:
        fail(f"{what}: {fn.__name__} launches by route {routes}, expected "
             f"all {fn.launches} on {want}")
    return routes


def _launch_routes(fn, in_workers=None) -> collections.Counter:
    """A path kernel's launches since its last ``_reset``, by route, plus
    those in a workers' report (``kernel_launches``) when one is given; a
    kernel of one route (the scan, on the CUDA cores) counts as ``simt``."""
    name, routes = fn.__name__, getattr(fn, "route_launches", None)
    counts = collections.Counter(routes if routes is not None
                                 else {"simt": fn.launches})
    if in_workers is not None:
        for r in (routes or {"simt": 0}):
            counts[r] += in_workers.get(f"{name}/{r}" if routes else name, 0)
    return counts


def _path_kernel(cfg) -> str:
    """The kernel a model's path launches: the scan for Mamba1 (every
    forward), flash attention for the dense transformer and the hybrid's
    shared-attention sites (every prefill)."""
    return "ssm_scan" if cfg.layer_plan[0] == "mamba1" else "flash_attention"


def _kernel_layers(cfg) -> int:
    """The layers that launch the path kernel once a forward (scan) or a
    prefill (flash): every Mamba1 layer, every attention site (each layer of
    the dense transformer, zamba2's 13 shared-attention sites)."""
    if _path_kernel(cfg) == "ssm_scan":
        return cfg.n_layers
    return sum("attn" in p for p in cfg.layer_plan)


def _depth_args(cfg) -> list:
    """The launcher's ``--layers`` for a config cut in depth, else none."""
    from repro_torch.configs import get_config
    cut = cfg.n_layers != get_config(cfg.name).n_layers
    return ["--layers", str(cfg.n_layers)] if cut else []


def phase_serve(torch, cfg, params) -> int:
    from repro_torch.launch import serve
    counters = _counters()
    kernel = _path_kernel(cfg)
    argv = ["--arch", cfg.name] + _depth_args(cfg) + SERVE_ARGS
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        _reset(fn)
    out = serve.main(argv, params=params)
    launches = {name: fn.launches for name, fn in counters.items()}
    routes = _check_routes(counters[kernel], cfg, f"{cfg.name} serve")
    finished = sorted(out["finished"], key=lambda r: r.rid)
    if len(finished) != 4 or out["decode_steps"] != SERVE_DECODE_STEPS:
        fail(f"served {len(finished)} requests in {out['decode_steps']} "
             f"decode steps, expected 4 in {SERVE_DECODE_STEPS}")
    if out["forwards"] != SERVE_FORWARDS or \
            out["prefills"] != SERVE_PREFILLS:
        fail(f"{out['forwards']} forwards and {out['prefills']} prefills, "
             f"expected {SERVE_FORWARDS} and {SERVE_PREFILLS}")
    # the scan runs in every forward, flash attention in every prefill
    per = out["forwards"] if kernel == "ssm_scan" else out["prefills"]
    want = {name: 0 for name in counters}
    want[kernel] = _kernel_layers(cfg) * per
    if launches != want:
        fail(f"{cfg.name}: kernel launches {launches}, expected {want}")
    if out["traced_tokens"] != finished[0].out[:3]:
        fail(f"traced tokens {out['traced_tokens']} do not prefix request "
             f"0's {finished[0].out}")
    if any(not 0 <= t < cfg.vocab_size for r in finished for t in r.out):
        fail("a served token lies outside the vocabulary")
    RESULTS[("serve", cfg.name)] = {
        "tokens": {r.rid: r.out for r in finished}, "wall_s": out["wall"],
        "ttft_p50_s": out["ttft_p50"],
        "decode_ms_per_step": 1e3 / out["decode_tok_s"]}
    line("serve", {
        "arch": cfg.name, "argv": argv, "requests": len(finished),
        "decode_steps": out["decode_steps"], "forwards": out["forwards"],
        "prefills": out["prefills"], "launches": launches,
        "launches_by_route": routes, "wall_s": out["wall"],
        "ttft_p50_s": out["ttft_p50"], "latency_p50_s": out["latency_p50"],
        "decode_tok_s": out["decode_tok_s"],
        "peak_device_bytes": torch.cuda.max_memory_allocated(),
        "traced_tokens": out["traced_tokens"],
        "tokens": {r.rid: r.out for r in finished}})
    return _launch_routes(counters[kernel]), out["traced_tokens"]


def phase_serve_process(torch, arch: str, reduced: bool) -> int:
    """Phases 6b and 9b: the serve launcher with its traced request on
    cluster worker processes (``--backend process``).  They spawn, since
    this process has initialised CUDA, and each draws its own parameter set
    from the seed, so the phase runs after the full-width parameters are
    freed.  Reduced, on two workers; then at full width on one worker, so
    that this process and the worker hold two parameter sets (2 x 29 GB or
    2 x 30.5 GB) on the 80 GB card, where two workers would need three.

    The workers report their kernel launches with each ``done``; the
    traced request's 3 forwards (1 prefill) must have launched the path's
    kernel ``n_layers`` times each in them, and the main loop's the rest in
    this process.  Returns the path kernel's launches in both."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    kernel = _path_kernel(cfg)
    counters = _counters()
    workers = 2 if reduced else 1
    argv = (["--arch", arch] + (["--reduced"] if reduced else [])
            + PROCESS_SERVE_ARGS + ["--graph-workers", str(workers)])
    what = f"{arch}{' --reduced' if reduced else ''} --backend process"
    for fn in counters.values():
        _reset(fn)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = serve.main(argv)
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    finished = sorted(out["finished"], key=lambda r: r.rid)
    if len(finished) != 4:
        fail(f"{what}: served {len(finished)} requests")
    traced = out["traced_tokens"]
    if traced is None or len(traced) != 3 or traced != finished[0].out[:3]:
        fail(f"{what}: traced tokens {traced} do not prefix request 0's "
             f"{finished[0].out}")
    # this process ran the main loop; the traced request's 3 forwards (1
    # prefill) ran in the workers
    per = (out["forwards"] - 3 if kernel == "ssm_scan"
           else out["prefills"] - 1)
    want = {name: 0 for name in counters}
    want[kernel] = _kernel_layers(cfg) * per
    if launches != want:
        fail(f"{what}: kernel launches in this process {launches}, "
             f"expected {want}")
    stats = out["graph_stats"]
    ran = {k: stats["tasks_run"].get(k, 0) for k in ("prefill", "decode")}
    if ran != {"prefill": 1, "decode": 2}:
        fail(f"{what}: the workers ran {ran}, expected 1 prefill and 2 "
             f"decodes")
    in_workers = stats["kernel_launches"]
    n = _kernel_layers(cfg) * (3 if kernel == "ssm_scan" else 1)
    if {k: v for k, v in in_workers.items() if "/" not in k} != {kernel: n}:
        fail(f"{what}: the workers launched {in_workers}, expected {n} "
             f"{kernel} launches")
    route = expected_route(cfg)
    if route and in_workers.get(f"{kernel}/{route}") != n:
        fail(f"{what}: the workers' {kernel} launches by route "
             f"{in_workers}, expected all {n} on {route}")
    line("serve_process", {
        "arch": arch, "argv": argv, "layers": cfg.n_layers,
        "d_model": cfg.d_model, "graph_workers": workers, "wall_s": wall,
        "driver_launches": launches, "worker_launches": in_workers,
        "worker_tasks_run": stats["tasks_run"],
        "graph_first_done_s": stats["first_done_s"],
        "graph_last_done_s": stats["last_done_s"],
        "driver_peak_device_bytes": torch.cuda.max_memory_allocated(),
        "traced_tokens": traced,
        "tokens": {r.rid: r.out for r in finished}})
    del out
    return _launch_routes(counters[kernel], in_workers)


def phase_serve_gateway(torch, arch: str, thread_tokens: list) -> int:
    """Phases 6c and 9c: the serve launcher at full width with its traced
    request sent to a 1-worker gateway (``--gateway``), whose spawned
    worker draws its own parameter set from the seed.  One model a pool:
    the worker keeps what it drew until the pool stops, and two models'
    parameters there (29 + 30.5 GB) beside this process's own set would not
    fit the card.  The traced tokens must be a prefix of request 0's and
    equal the thread backend's (``thread_tokens``, phase 6 or 9); the job's
    worker must report the path kernel ``n_layers`` times a forward (scan)
    or a prefill (flash, all on wgmma), and this process the main loop's.
    Returns the path kernel's launches in both."""
    from repro_torch.config import ClusterConfig
    from repro_torch.configs import get_config
    from repro_torch.gateway import GatewayService
    from repro_torch.launch import serve
    cfg = get_config(arch)
    kernel = _path_kernel(cfg)
    counters = _counters()
    token = secrets.token_hex(16)
    what = f"{arch} --gateway"
    for fn in counters.values():
        _reset(fn)
    torch.cuda.reset_peak_memory_stats()
    gw = GatewayService(ClusterConfig(
        n_workers=1, start_method="spawn", token=token,
        progress_timeout=PROCESS_TIMEOUT))
    t0 = time.perf_counter()
    gw.start()
    try:
        argv = (["--arch", arch] + GATEWAY_SERVE_ARGS
                + ["--gateway", gw.address, "--gateway-token", token,
                   "--tenant", "serve"])
        out = serve.main(argv)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        pool = gw.stats()
        start_method = gw.executor.start_method
    finally:
        gw.stop()
    launches = {name: fn.launches for name, fn in counters.items()}
    finished = sorted(out["finished"], key=lambda r: r.rid)
    traced = out["traced_tokens"]
    if len(finished) != 4:
        fail(f"{what}: served {len(finished)} requests")
    if traced != finished[0].out[:3] or traced != thread_tokens:
        fail(f"{what}: traced tokens {traced}, request 0's {finished[0].out}"
             f", the thread backend's {thread_tokens}")
    per = (out["forwards"] - 3 if kernel == "ssm_scan"
           else out["prefills"] - 1)
    want = {name: 0 for name in counters}
    want[kernel] = _kernel_layers(cfg) * per
    if launches != want:
        fail(f"{what}: kernel launches in this process {launches}, "
             f"expected {want}")
    stats = out["graph_stats"]
    ran = {k: stats["tasks_run"].get(k, 0) for k in ("prefill", "decode")}
    if ran != {"prefill": 1, "decode": 2} or stats["tenant"] != "serve":
        fail(f"{what}: the job ran {ran} as {stats['tenant']!r}, expected 1 "
             f"prefill and 2 decodes as 'serve'")
    in_workers = stats["kernel_launches"]
    n = _kernel_layers(cfg) * (3 if kernel == "ssm_scan" else 1)
    if {k: v for k, v in in_workers.items() if "/" not in k} != {kernel: n}:
        fail(f"{what}: the worker launched {in_workers}, expected {n} "
             f"{kernel} launches")
    route = expected_route(cfg)
    if route and in_workers.get(f"{kernel}/{route}") != n:
        fail(f"{what}: the worker's {kernel} launches by route "
             f"{in_workers}, expected all {n} on {route}")
    if pool["serve"]["failed"] or pool["serve"]["completed"] != 1:
        fail(f"{what}: tenant accounting {pool['serve']}")
    line("serve_gateway", {
        "arch": arch, "argv": [a if a != token else "<token>" for a in argv],
        "layers": cfg.n_layers, "d_model": cfg.d_model, "pool_workers": 1,
        "start_method": start_method, "wall_s": wall,
        "job_wall_s": stats["submit_to_gather_s"],
        "submit_to_first_dispatch_s": stats["submit_to_first_dispatch_s"],
        "result_bytes": stats["result_bytes"],
        "driver_launches": launches, "worker_launches": in_workers,
        "worker_tasks_run": stats["tasks_run"],
        "driver_peak_device_bytes": peak, "traced_tokens": traced,
        "tokens": {r.rid: r.out for r in finished}})
    del out
    return _launch_routes(counters[kernel], in_workers)


@contextlib.contextmanager
def _recording_routing(torch):
    """Records the routing of every MoE layer call while it is open: the
    router (``models/moe.py::route``) run again on the layer's input, its
    picks, the probabilities at the call's last position and the picks it
    drops, kept on the device (no host read inside a timed run; the router
    is a (tokens, d) by (d, E) product, small beside the layer)."""
    from repro_torch.models import moe
    from repro_torch.models import transformer as TF
    inner, calls = TF.moe_block, []

    def recording(p, x, cfg, ctx=None):
        r = moe.route(p, x, cfg)
        calls.append({"tokens": x.shape[0] * x.shape[1], "idx": r.idx,
                      "last_probs": r.probs[-1, -1],
                      "dropped": (~r.keep).sum()})
        return inner(p, x, cfg, ctx)
    TF.moe_block = recording
    try:
        yield calls
    finally:
        TF.moe_block = inner


def _routing_summary(torch, cfg, kernel_calls, plain_calls) -> dict:
    """Phase 13's routing fields: per MoE layer of the long prefill, the
    last position's picks that the kernel run and the plain run do not
    share, the prompt rows whose pick sets differ, and the gap between the
    K-th and (K+1)-th router probability at the last position; the picks
    dropped by capacity in each run's prefill and decode steps."""
    K = cfg.experts_per_token
    out = {"last_position_picks_differing": [], "rows_differing": [],
           "last_position_kth_gap_kernel": [],
           "last_position_kth_gap_plain": [],
           "last_position_picks_kernel": []}
    pre_k = [c for c in kernel_calls if c["tokens"] == LONG_PROMPT]
    pre_p = [c for c in plain_calls if c["tokens"] == LONG_PROMPT]
    for ck, cp in zip(pre_k, pre_p):
        ik = torch.sort(ck["idx"].reshape(-1, K), dim=-1).values
        ip = torch.sort(cp["idx"].reshape(-1, K), dim=-1).values
        last_k, last_p = set(ik[-1].tolist()), set(ip[-1].tolist())
        out["last_position_picks_differing"].append(len(last_k - last_p))
        out["rows_differing"].append(int((ik != ip).any(-1).sum()))
        out["last_position_picks_kernel"].append(sorted(last_k))
        for c, key in ((ck, "kernel"), (cp, "plain")):
            top = torch.sort(c["last_probs"], descending=True).values
            out[f"last_position_kth_gap_{key}"].append(
                (top[K - 1] - top[K]).item() if K < cfg.n_experts else None)
    for calls, key in ((kernel_calls, "kernel"), (plain_calls, "plain")):
        out[f"dropped_prefill_{key}"] = sum(
            int(c["dropped"]) for c in calls if c["tokens"] == LONG_PROMPT)
        out[f"dropped_decode_{key}"] = sum(
            int(c["dropped"]) for c in calls if c["tokens"] != LONG_PROMPT)
    gaps = [g for g in out["last_position_kth_gap_kernel"] if g is not None]
    out["min_last_position_kth_gap"] = min(gaps) if gaps else None
    out["moe_layers"] = len(pre_k)
    if len(pre_k) != len(pre_p) or \
            len(pre_k) != cfg.n_layers // cfg.moe_every:
        fail(f"{cfg.name}: {len(pre_k)} and {len(pre_p)} MoE prefill calls "
             f"recorded, expected {cfg.n_layers // cfg.moe_every}")
    return out


def phase_long_prefill(torch, cfg, params) -> dict:
    """One LONG_PROMPT prefill and LONG_DECODE greedy steps in ``cfg``'s
    compute dtype, with the path kernel and with its plain version; the
    kernel run's prefill also times the kernel's own launches (CUDA events
    around each).  An MoE model's line adds the routing of both runs
    (:func:`_routing_summary`).  A VLM's prompt starts with its
    ``n_patches`` patch embeddings (seed 0), handed to both runs' prefill
    as ``patch_embeds``, as its training batches carry them."""
    from repro_torch.models import frontends
    from repro_torch.models import transformer as TF
    counter = _counters()[_path_kernel(cfg)]
    module = sys.modules[counter.__module__]
    gen = torch.Generator(device="cuda").manual_seed(1)
    prompt = torch.randint(1, cfg.vocab_size, (1, LONG_PROMPT),
                           generator=gen, device="cuda", dtype=torch.int32)
    patches = (frontends.synth_patches(cfg, 1, 0, device="cuda")
               if cfg.family == "vlm" else None)

    def run(impl, feed=None):
        """Prefill, then LONG_DECODE greedy steps fed the run's own tokens
        or ``feed``'s; returns tokens, last-position logits, seconds, and
        the path kernel's device ms within the prefill."""
        prefill = TF.make_prefill_step(cfg, max_len=LONG_MAX_LEN, impl=impl)
        decode = TF.make_decode_step(cfg, impl=impl)
        torch.cuda.synchronize()
        with (timed_launches(torch, module, counter.__name__)
              if impl == "kernel" else contextlib.nullcontext([])) as events:
            t0 = time.perf_counter()
            last, cache = prefill(params, prompt, patches)
            logits = [last[0].clone()]
            torch.cuda.synchronize()
            prefill_s = time.perf_counter() - t0
        kernel_ms = events_ms(torch, events)
        for i in range(LONG_DECODE):
            tok = feed[i] if feed else int(torch.argmax(logits[-1]))
            step, cache = decode(params, cache, torch.tensor(
                [[tok]], dtype=torch.int32, device="cuda"))
            logits.append(step[0].clone())
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0 - prefill_s
        logits = torch.stack(logits)
        toks = [int(t) for t in torch.argmax(logits, dim=-1)]
        return toks, logits, prefill_s, decode_s, kernel_ms

    moe = bool(cfg.n_experts)
    torch.cuda.reset_peak_memory_stats()
    _reset(counter)
    with (_recording_routing(torch) if moe
          else contextlib.nullcontext([])) as calls_k:
        toks_k, logits_k, pre_k, dec_k, kernel_ms = run("kernel")
    launches_k = counter.launches
    routes = _check_routes(counter, cfg,
                           f"{cfg.name} {cfg.compute_dtype} long prefill")
    peak = torch.cuda.max_memory_allocated()
    with (_recording_routing(torch) if moe
          else contextlib.nullcontext([])) as calls_r:
        toks_r, logits_r, pre_r, dec_r, _ = run("ref", feed=toks_k)
    routing = (_routing_summary(torch, cfg, calls_k, calls_r) if moe
               else None)
    # the scan runs in every forward, flash attention in the prefill
    want = _kernel_layers(cfg) * (1 + LONG_DECODE
                                  if counter.__name__ == "ssm_scan" else 1)
    if launches_k != want or counter.launches != launches_k:
        fail(f"{launches_k} and {counter.launches - launches_k} "
             f"{counter.__name__} launches in the kernel and plain runs, "
             f"expected {want} and 0")
    if not (torch.isfinite(logits_k).all() and torch.isfinite(logits_r).all()):
        fail("non-finite logits in the long prefill")
    diff = (logits_k - logits_r).abs().max().item()
    if diff > LOGIT_TOL:
        fail(f"long prefill: kernel and plain versions give last-position "
             f"logits {diff} apart, tolerance {LOGIT_TOL}")
    for j, (a, b) in enumerate(zip(toks_k, toks_r)):
        top2 = logits_r[j].topk(2).values
        if a != b and (top2[0] - top2[1]).item() > LOGIT_TOL:
            fail(f"long prefill: greedy token {j} differs ({a} vs {b}) and "
                 f"the plain run's top two logits are "
                 f"{(top2[0] - top2[1]).item()} apart")
    out = {"arch": cfg.name, "compute_dtype": cfg.compute_dtype,
           "prompt_tokens": LONG_PROMPT, "decode_steps": LONG_DECODE,
           "max_abs_logit_diff": diff, "tol": LOGIT_TOL,
           "logit_std": logits_r.std().item(),
           "logit_max_abs": logits_r.abs().max().item(),
           "tokens_kernel": toks_k, "tokens_plain": toks_r,
           "prefill_s_kernel": pre_k, "decode_ms_per_step_kernel":
           dec_k / LONG_DECODE * 1e3, "prefill_s_plain": pre_r,
           "decode_ms_per_step_plain": dec_r / LONG_DECODE * 1e3,
           f"{counter.__name__}_launches": launches_k,
           "launches_by_route": routes,
           f"{counter.__name__}_prefill_ms": kernel_ms,
           f"{counter.__name__}_prefill_share": kernel_ms / 1e3 / pre_k,
           "peak_device_bytes": peak, "layers": cfg.n_layers,
           **({"routing": routing} if moe else {}),
           **({"patch_positions": patches.shape[1]}
              if patches is not None else {})}
    line("long_prefill", out)
    out["routes"] = _launch_routes(counter)
    return out


# the profiler range around each call of the Mamba2 SSD (_ssd_annotated)
SSD_RANGE = "repro_torch.ssd_chunked"
BACKWARD_EVENT = "autograd::engine::evaluate_function: "


def profile_line(torch, tag: str, fn, extra=None) -> None:
    """One call of ``fn`` under ``torch.profiler``: prints the device time
    of each kernel name, the port's own kernels wherever they rank, and the
    device's busy share of the host-clock wall (to a ``synchronize()``);
    ``extra(prof, busy_us)`` adds fields read from the same trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # the device's own entries (kernels, copies, sets): their self device
    # times add up to the time the device was busy; a profiler range
    # (SSD_RANGE) also shows on the device's timeline, and is no kernel
    kernels = [(e.self_device_time_total, e.count, e.key)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0 and e.key != SSD_RANGE]
    kernels.sort(reverse=True)
    busy_us = sum(k[0] for k in kernels)
    line(tag, {
        **(extra(prof, busy_us) if extra else {}),
        "wall_ms": wall * 1e3, "device_busy_ms": busy_us / 1e3,
        "device_busy_share": busy_us / 1e6 / wall,
        "kernel_launches": sum(k[1] for k in kernels),
        "top": [{"kernel": k[2][:120], "count": k[1],
                 "device_ms": k[0] / 1e3} for k in kernels[:12]],
        "port_kernels": [{"kernel": k[2][:120], "count": k[1],
                          "device_ms": k[0] / 1e3} for k in kernels
                         if PORT_KERNEL.search(k[2])]})


@contextlib.contextmanager
def _ssd_annotated(torch):
    """Within the block each call of the Mamba2 SSD
    (``models/ssm.py::ssd_chunked``, torch ops: the JAX package has no
    kernel for it) runs inside a profiler range named SSD_RANGE, its
    recompute in the backward too."""
    from repro_torch.models import ssm
    inner = ssm.ssd_chunked

    def annotated(*args, **kwargs):
        with torch.profiler.record_function(SSD_RANGE):
            return inner(*args, **kwargs)
    ssm.ssd_chunked = annotated
    try:
        yield
    finally:
        ssm.ssd_chunked = inner


def _ssd_backward(prof, busy_us: float) -> dict:
    """The SSD's share of a profiled training step run under
    :func:`_ssd_annotated`.  Its forward: the device time under the
    SSD_RANGE ranges (the forward and the remat recompute).  Its backward:
    the device time of the autograd nodes that differentiate the
    operations inside those ranges, matched by the forward operation's
    thread and sequence number; each node counts the kernels it and its
    operations launch, not those of a recompute that runs inside it (the
    recompute's operations carry sequence numbers of their own: the
    backward's own carry none, or the node's)."""
    from torch.autograd import DeviceType
    events = prof.events()

    def subtree_us(e, node: bool) -> float:
        own = (e.sequence_nr, e.fwd_thread)
        total, stack = 0.0, [e]
        while stack:
            c = stack.pop()
            total += sum(k.duration for k in c.kernels)
            stack.extend(k for k in c.cpu_children
                         if not node or k.sequence_nr < 0
                         or (k.sequence_nr, k.fwd_thread) == own)
        return total

    ranges = [e for e in events if e.name == SSD_RANGE
              and e.device_type == DeviceType.CPU]
    forward = set()
    for r in ranges:
        stack = list(r.cpu_children)
        while stack:
            c = stack.pop()
            if c.sequence_nr >= 0:
                forward.add((c.thread, c.sequence_nr))
            stack.extend(c.cpu_children)
    nodes = [e for e in events if e.name.startswith(BACKWARD_EVENT)
             and (e.fwd_thread, e.sequence_nr) in forward]
    fwd_us = sum(subtree_us(r, False) for r in ranges)
    bwd_us = sum(subtree_us(e, True) for e in nodes)
    if not ranges or not nodes:
        fail(f"the profiled step shows {len(ranges)} SSD ranges and "
             f"{len(nodes)} of their backward nodes")
    return {"ssd_calls": len(ranges), "ssd_backward_nodes": len(nodes),
            "ssd_forward_ms": fwd_us / 1e3, "ssd_backward_ms": bwd_us / 1e3,
            "ssd_backward_share_of_busy": bwd_us / busy_us,
            "ssd_share_of_busy": (fwd_us + bwd_us) / busy_us}


def phase_profile(torch, cfg, params) -> None:
    """Where a serve path's device time goes (``--profile`` only): one
    decode step, one served-size prefill and one LONG_PROMPT prefill, each
    after a warm-up call, through :func:`profile_line`."""
    from repro_torch.models import transformer as TF
    prefill = TF.make_prefill_step(cfg, max_len=SERVE_MAX_LEN)
    prefill_long = TF.make_prefill_step(cfg, max_len=LONG_MAX_LEN)
    decode = TF.make_decode_step(cfg)
    prompt = torch.randint(1, cfg.vocab_size, (1, LONG_PROMPT),
                           device="cuda", dtype=torch.int32)
    short = prompt[:, :12].contiguous()
    token = torch.ones((1, 1), dtype=torch.int32, device="cuda")
    cache = prefill(params, short)[1]
    for name, fn in (("decode_step", lambda: decode(params, cache, token)),
                     ("prefill_12", lambda: prefill(params, short)),
                     (f"prefill_{LONG_PROMPT}",
                      lambda: prefill_long(params, prompt))):
        fn()
        profile_line(torch, f"profile_{cfg.name}_{name}", fn)


def phase_model(torch, arch: str, n_params: int, profile: bool):
    """Draw ``arch`` on the card, serve it, run the long prefill (for the
    dense model in its bf16 compute and again in float32 on the same
    parameters; with ``profile``, profile it), free its parameters, then
    serve it on the process backend, reduced and at full width, and through
    a gateway; returns the path kernel's launches in all of those runs, by
    route."""
    import gc
    cfg, params = phase_params(torch, arch, n_params)
    launches, thread_tokens = phase_serve(torch, cfg, params)
    launches += phase_long_prefill(torch, cfg, params)["routes"]
    if _path_kernel(cfg) == "flash_attention":
        # the float32 route at full width: the same parameters computed in
        # float32 (they are float32 already, so nothing is copied)
        f32 = dataclasses.replace(cfg, compute_dtype="float32")
        launches += phase_long_prefill(torch, f32, params)["routes"]
    if profile:
        phase_profile(torch, cfg, params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    line("freed", {"arch": arch,
                   "allocated_bytes": torch.cuda.memory_allocated()})
    for reduced in (True, False):
        launches += phase_serve_process(torch, arch, reduced)
    gc.collect()
    torch.cuda.empty_cache()
    launches += phase_serve_gateway(torch, arch, thread_tokens)
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_hybrid(torch, profile: bool) -> collections.Counter:
    """Phase 12: zamba2-7b drawn on the card at full width, served, its long
    prefill run with the flash kernel and with the plain attention (with
    ``profile``, profiled), and its parameters freed; returns the flash
    launches by route.  The process-backend and gateway phases of
    :func:`phase_model` are left out: their workers serve the reduced
    config, whose 4 layers hold no shared-attention site."""
    import gc
    cfg, params = phase_params(torch, HYBRID_ARCH, HYBRID_N_PARAMS)
    launches, _ = phase_serve(torch, cfg, params)
    launches += phase_long_prefill(torch, cfg, params)["routes"]
    if profile:
        phase_profile(torch, cfg, params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    line("freed", {"arch": HYBRID_ARCH,
                   "allocated_bytes": torch.cuda.memory_allocated()})
    return launches


def phase_cells(torch, cells, profile: bool) -> collections.Counter:
    """Phases 13 (MOE_CELLS) and 18 (SERVE_CELLS): each cell (arch, layers
    or 0 for all, parameters) drawn on the card at its published width,
    cut in depth where given, served through the launcher (``--layers``
    where cut), its long prefill run with the flash kernel and with the
    plain attention (a VLM's with its patch embeddings; with ``profile``,
    profiled), and its parameters freed before the next is drawn; returns
    the flash launches by route.  The process-backend and gateway phases
    of :func:`phase_model` are left out: their workers serve the reduced
    configs, whose dense path phase 9b already runs on the card."""
    import gc
    launches = collections.Counter()
    for arch, layers, n_params in cells:
        cfg, params = phase_params(torch, arch, n_params, layers)
        served, _ = phase_serve(torch, cfg, params)
        launches += served
        launches += phase_long_prefill(torch, cfg, params)["routes"]
        if profile:
            phase_profile(torch, cfg, params)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        line("freed", {"arch": arch,
                       "allocated_bytes": torch.cuda.memory_allocated()})
    return launches


def _rel_err(got, want) -> float:
    """Largest |got - want| over the largest |want|: gradient checks are
    scaled by the reference gradient's own size."""
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp_min(1e-30)).item()


def _grad_inputs(torch, gen, B, H, KH, Sq, Sk, D, dtype):
    q = torch.randn(B, H, Sq, D, generator=gen, device="cuda")
    k = torch.randn(B, KH, Sk, D, generator=gen, device="cuda")
    v = torch.randn(B, KH, Sk, D, generator=gen, device="cuda")
    dout = torch.randn(B, H, Sq, D, generator=gen, device="cuda")
    return [t.to(dtype) for t in (q, k, v)], dout.to(dtype)


def _backward_makespan(torch, B, H, KH, Sq, Sk, causal, path,
                       blocks_per_sm: int) -> dict:
    """The backward kernel's unit list (``backward_schedule`` on the
    route's key tiles) taken in list order by the card's resident blocks,
    each unit to the block that frees first at its cost in products: the
    makespan over the ideal, the products spread evenly over the blocks.
    One kv head's dK/dV units (MQA) walk every query head, so a few heavy
    units set the makespan there."""
    import heapq
    from repro_torch.kernels import flash_attention as fa
    units = fa.backward_schedule(B, H, KH, Sq, Sk, causal,
                                 fa.BWD_ROWS[path])
    slots = blocks_per_sm * torch.cuda.get_device_properties(
        0).multi_processor_count
    free = [0] * slots
    for u in units:
        heapq.heappush(free, heapq.heappop(free) + u[4])
    ideal = sum(u[4] for u in units) / slots
    return {"units": len(units), "blocks": slots, "heaviest": units[0][4],
            "ideal": ideal, "makespan_over_ideal": max(free) / ideal}


def phase_train_grads(torch) -> list:
    """Phase 11a: the flash gradient at each TRAIN_GRAD_SHAPES row in
    float32 (simt) and bf16 (wgmma).  First the backward kernel alone,
    given the forward kernel's out and lse, against the plain backward
    (``attention_backward``) given the same: dq, dk, dv within TOL of the
    largest plain entry, two launches the same bits, one launch on the
    row's route each.  Then the flash Function (the forward kernel, then
    the backward kernel) against autograd of the plain version: within TOL
    of the largest reference entry, one forward and one backward launch on
    the route.  Medians of CUDA-event times (``cuda_median_ms``) of the
    backward kernel alone, of the plain backward given the lse and of
    SDPA's backward alone (autograd of one retained SDPA output: a
    yardstick only), and of forward + backward for the Function, the plain
    version and SDPA, beside the card's bounds.  No profiler device times
    (``device_busy_ms``): by this point of a run the profiler's kernel
    durations read 0.25-0.8 x the same launches' CUDA events on the H100,
    every kernel still recorded (PERF.md §7), so SDPA's backward is timed
    by its events too, which hold autograd's host dispatch wherever the
    host is slower than the device."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa, ops, ref
    gen = torch.Generator(device="cuda").manual_seed(2)
    checks = []
    for B, H, KH, Sq, Sk, D, causal in TRAIN_GRAD_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).removeprefix("torch.")
            (q, k, v), dout = _grad_inputs(torch, gen, B, H, KH, Sq, Sk, D,
                                           dtype)
            path = fa.route(dtype, D)
            what = (f"flash gradient {dname} {(B, H, KH, Sq, Sk, D)} "
                    f"({path})")
            bwd = fa.flash_attention_backward

            # the backward kernel alone, given the forward kernel's out and
            # lse, against the plain backward given the same
            out, lse = fa.flash_attention(q, k, v, causal=causal,
                                          return_lse=True)
            before = bwd.route_launches[path]
            got = bwd(q, k, v, out, dout, lse, causal=causal)
            again = bwd(q, k, v, out, dout, lse, causal=causal)
            torch.cuda.synchronize()
            if bwd.route_launches[path] != before + 2:
                fail(f"{what}: the backward made no {path} launch")
            if not all(_same(torch, g, a) for g, a in zip(got, again)):
                fail(f"{what}: two backward launches gave different bits")
            want = fa.attention_backward(q, k, v, out, dout, causal=causal,
                                         lse=lse)
            kernel_errs = {n: _rel_err(g, w)
                           for n, g, w in zip("qkv", got, want)}
            kernel_abs = max((g.float() - w.float()).abs().max().item()
                             for g, w in zip(got, want))
            if any(g.dtype != dtype for g in got) or \
                    max(kernel_errs.values()) > TOL[dname]:
                fail(f"{what}: the backward kernel's gradients "
                     f"{kernel_errs} relative to the plain backward's "
                     f"largest, tolerance {TOL[dname]}")
            del got, again, want
            res = fa.backward_resources(dtype, D)
            schedule = _backward_makespan(torch, B, H, KH, Sq, Sk, causal,
                                          path, res["blocks_per_sm"])
            bwd_ms = cuda_median_ms(torch, lambda: bwd(
                q, k, v, out, dout, lse, causal=causal))
            plain_bwd_ms = cuda_median_ms(torch, lambda: fa.attention_backward(
                q, k, v, out, dout, causal=causal, lse=lse))
            del out, lse
            for t in (q, k, v):
                t.requires_grad_()

            def fwd_bwd(attn):
                return torch.autograd.grad(attn(q, k, v), (q, k, v), dout)

            def kernel(*a):
                return ops.flash_attention(*a, causal=causal)

            def plain(*a):
                return ref.attention(*a, causal=causal)

            def library(*a):
                return F.scaled_dot_product_attention(
                    *a, is_causal=causal, enable_gqa=True)

            before = (fa.flash_attention.route_launches[path],
                      bwd.route_launches[path])
            got = fwd_bwd(kernel)
            torch.cuda.synchronize()
            if (fa.flash_attention.route_launches[path],
                    bwd.route_launches[path]) != (before[0] + 1,
                                                  before[1] + 1):
                fail(f"{what}: the Function made no {path} forward and "
                     f"backward launch")
            want = fwd_bwd(plain)
            errs = {n: _rel_err(g, w) for n, g, w in zip("qkv", got, want)}
            if any(g.dtype != dtype for g in got) or \
                    max(errs.values()) > TOL[dname]:
                fail(f"{what}: gradients {errs} relative to the plain "
                     f"version's largest, tolerance {TOL[dname]}")
            del got, want
            lib_out = library(q, k, v)
            def sdpa_bwd():
                return torch.autograd.grad(lib_out, (q, k, v), dout,
                                           retain_graph=True)
            sdpa_bwd_ms = cuda_median_ms(torch, sdpa_bwd)
            del lib_out
            b_ms, b_by = _costs().flash_bound(B, H, KH, Sq, Sk, D, causal,
                                              dname, dtype.itemsize,
                                              backward=True)
            bb_ms, bb_by = _costs().flash_backward_bound(
                B, H, KH, Sq, Sk, D, causal, dname, dtype.itemsize)
            checks.append({
                "shape": [B, H, KH, Sq, Sk, D], "causal": causal,
                "dtype": dname, "route": path,
                "rel_err": errs, "tol": TOL[dname],
                "bound_ms": b_ms, "bound_by": b_by,
                "ms": cuda_median_ms(torch, lambda: fwd_bwd(kernel)),
                "plain_ms": cuda_median_ms(torch, lambda: fwd_bwd(plain)),
                "library_ms": cuda_median_ms(torch, lambda: fwd_bwd(library)),
                "backward": {
                    "rel_err": kernel_errs, "max_abs_err": kernel_abs,
                    "same_bits": True, "ms": bwd_ms,
                    "plain_ms": plain_bwd_ms, "library_ms": sdpa_bwd_ms,
                    "bound_ms": bb_ms, "bound_by": bb_by,
                    "resources": res},
                # computed on the host from the unit list, not measured:
                # kept out of the backward's numbers in the kernels line
                "unit_list": schedule})
            c = checks[-1]
            print(f"{what}: backward kernel vs plain rel err "
                  f"{max(kernel_errs.values()):.3g}, {bwd_ms:.4f} ms (plain "
                  f"{plain_bwd_ms:.3f} ms, sdpa backward {sdpa_bwd_ms:.4f} "
                  f"ms, bound {bb_ms:.4f} ms, {bb_by}; "
                  f"{res['registers']} registers, {res['smem_bytes']} B "
                  f"shared, {res['local_bytes']} B local, "
                  f"{res['blocks_per_sm']} block(s), {res['warps_per_sm']} "
                  f"warps an SM; unit list "
                  f"{schedule['makespan_over_ideal']:.3g} x the ideal) | "
                  f"Function vs "
                  f"autograd rel err {max(errs.values()):.3g} (tol "
                  f"{TOL[dname]}) | fwd+bwd {c['ms']:.3f} ms | plain "
                  f"{c['plain_ms']:.3f} ms | sdpa {c['library_ms']:.3f} ms | "
                  f"bound {b_ms:.4f} ms ({b_by})", flush=True)
            del q, k, v, dout
    line("train_grads", checks)
    return checks


def _plain_scan_autograd(torch, x, dt, B, C, A, h0, dy, dh):
    """(dx, ddt, dB, dC, dA, dh0) by autograd of ref.ssm_scan."""
    from repro_torch.kernels import ref
    ins = [t.detach().clone().requires_grad_() for t in (x, dt, B, C, A)]
    state = (h0 if h0 is not None else torch.zeros(
        x.shape[0], x.shape[2], A.shape[1], device=x.device))
    state = state.detach().clone().requires_grad_()
    y, h = ref.ssm_scan(*ins, state, return_state=True)
    outs, grads = ((y, h), (dy, dh)) if dh is not None else ((y,), (dy,))
    return torch.autograd.grad(outs, ins + [state], grads)


def phase_scan_grads(torch) -> list:
    """Phase 11d: the scan's backward kernel against the plain gradient at
    each SCAN_GRAD_SHAPES row, in float32 (the model widens the scan's
    inputs): autograd of ref.ssm_scan, or ref.ssm_scan_backward above
    SCAN_AUTOGRAD_CELLS.  Every gradient within SCAN_GRAD_TOL of its
    largest plain entry; the kernel given the forward kernel's states (as
    SSMScan gives them) the same bits as the wrapper's standalone route
    (which launches the forward kernel for them), and two launches the
    same bits.  CUDA-event times (mean of REPS after a warm-up) of the
    backward kernel given the states (``ms``: its launch and the sum of its
    partials), of the standalone route, of the SSMScan Function's forward
    + backward and of the plain backward given the same states
    (ref.ssm_scan_backward), beside the card's bounds."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref, ssm_scan as scan
    from repro_torch.models.layers import ParamSpec, init_param
    gen = torch.Generator(device="cuda").manual_seed(3)
    dev = torch.device("cuda")
    checks = []
    for Bsz, S, D, N, with_states in SCAN_GRAD_SHAPES:
        # dt and A as the model makes them (see phase_scan_kernels)
        dt_bias = init_param(ParamSpec("smoke/dt_bias", (D,), "mamba_dt"),
                             0, torch.float32, dev)
        A = -torch.exp(init_param(ParamSpec("smoke/A_log", (D, N),
                                            "mamba_A"), 0, torch.float32,
                                  dev))
        x = torch.randn(Bsz, S, D, generator=gen, device=dev)
        dt = F.softplus(torch.randn(Bsz, S, D, generator=gen, device=dev)
                        + dt_bias)
        B = torch.randn(Bsz, S, N, generator=gen, device=dev)
        C = torch.randn(Bsz, S, N, generator=gen, device=dev)
        dy = torch.randn(Bsz, S, D, generator=gen, device=dev)
        h0, dh = ((torch.randn(Bsz, D, N, generator=gen, device=dev),
                   torch.randn(Bsz, D, N, generator=gen, device=dev))
                  if with_states else (None, None))
        args = (x, dt, B, C, A, h0, dy, dh)
        what = f"ssm_scan gradient {(Bsz, S, D, N)} states={with_states}"
        before = scan.ssm_scan_backward.launches
        states = scan.ssm_scan(x, dt, B, C, A, h0, return_states=True)[2]
        got = scan.ssm_scan_backward(*args, states=states)
        again = scan.ssm_scan_backward(*args, states=states)
        alone = scan.ssm_scan_backward(*args)
        torch.cuda.synchronize()
        if scan.ssm_scan_backward.launches != before + 3:
            fail(f"{what}: no backward kernel launch")
        if not all(_same(torch, g, a) for g, a in zip(got, again)):
            fail(f"{what}: two launches gave different bits")
        if not all(_same(torch, g, a) for g, a in zip(got, alone)):
            fail(f"{what}: given the forward's states, the kernel gave "
                 f"other bits than the standalone route")
        del again, alone
        autograd = Bsz * S * D <= SCAN_AUTOGRAD_CELLS
        want = (_plain_scan_autograd(torch, *args) if autograd
                else ref.ssm_scan_backward(*args))
        errs = {n: _rel_err(g, w) for n, g, w in zip(GRAD_NAMES, got, want)}
        abs_err = max((g - w).abs().max().item() for g, w in zip(got, want))
        if any(g.dtype != torch.float32 or g.shape != w.shape
               for g, w in zip(got, want)) or \
                max(errs.values()) > SCAN_GRAD_TOL:
            fail(f"{what}: gradients {errs} relative to the plain "
                 f"version's largest, tolerance {SCAN_GRAD_TOL}")
        del got, want
        leaves = [t.detach().clone().requires_grad_()
                  for t in (x, dt, B, C, A)]
        state = None if h0 is None else h0.detach().clone().requires_grad_()

        def function():
            y, h = scan.SSMScan.apply(*leaves, state)
            outs, grads = ((y, h), (dy, dh)) if dh is not None \
                else ((y,), (dy,))
            return torch.autograd.grad(
                outs, leaves + ([state] if state is not None else []), grads)
        b_ms, b_by = _costs().scan_grad_bound(Bsz, S, D, N, with_states, True)
        alone_ms, alone_by = _costs().scan_grad_bound(Bsz, S, D, N,
                                                      with_states)
        checks.append({
            "shape": [Bsz, S, D, N], "states": with_states,
            "dtype": "float32",
            "plain": "autograd" if autograd else "ref.ssm_scan_backward",
            "rel_err": errs, "max_abs_err": abs_err, "tol": SCAN_GRAD_TOL,
            "same_bits": True,
            "ms": cuda_ms(torch, lambda: scan.ssm_scan_backward(
                *args, states=states)),
            "standalone_ms": cuda_ms(
                torch, lambda: scan.ssm_scan_backward(*args)),
            "function_ms": cuda_ms(torch, function),
            "plain_ms": cuda_ms(torch, lambda: ref.ssm_scan_backward(
                *args, states=states)),
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
            "standalone_bound_ms": alone_ms, "standalone_bound_by": alone_by})
        c = checks[-1]
        print(f"{what}: rel err {max(errs.values()):.3g} (tol "
              f"{SCAN_GRAD_TOL}; plain {c['plain']}) | backward kernel "
              f"given the states {c['ms']:.4f} ms (bound {b_ms:.4f} ms, "
              f"{b_by}) | standalone {c['standalone_ms']:.4f} ms (bound "
              f"{alone_ms:.4f} ms, {alone_by}) | Function fwd+bwd "
              f"{c['function_ms']:.4f} ms | plain backward "
              f"{c['plain_ms']:.3f} ms", flush=True)
        del args, leaves, state, states, x, dt, B, C, dy, h0, dh
    line("scan_grads", checks)
    return checks


def _train_kernels(cfg) -> dict:
    """A model path's training kernels: each wrapper and its launches a
    step, the forward kernel first.  Under selective remat each kernel
    forward runs twice a site (the forward and the recompute) and its
    backward kernel once; a site is a layer, or one of the hybrid's
    shared-attention sites (inside its layer's remat).  The encoder-decoder
    is not checkpointed (nor is the reference's): flash runs once an
    encoder layer and twice a decoder layer (self- and cross-attention),
    and its backward as often."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssm_scan as scan
    if cfg.is_encoder_decoder:
        sites = cfg.n_enc_layers + 2 * cfg.n_layers
        return {fa.flash_attention: sites, fa.flash_attention_backward: sites}
    if _path_kernel(cfg) == "flash_attention":
        sites = _kernel_layers(cfg)
        return {fa.flash_attention: 2 * sites,
                fa.flash_attention_backward: sites}
    return {scan.ssm_scan: 2 * cfg.n_layers,
            scan.ssm_scan_backward: cfg.n_layers}


def phase_train_launcher(torch, arch: str = DENSE_ARCH) -> dict:
    """Phase 11b (qwen2-7b), 11e (falcon-mamba-7b) and 14b (whisper-tiny,
    llava-next-34b): the training launcher on the card at ``--reduced``:
    tests/test_launchers.py's resume check (8 steps with a checkpoint every
    5, an uninterrupted run to 12, a run resumed from step 5), then
    ``--show-graph --backend thread`` (the traced step's loss equals the
    loop's step-0 loss).  The reduced configs compute in float32, so every
    flash launch, forward and backward, is simt.  Every path kernel
    launches its ``_train_kernels`` count a step.  Returns each path
    kernel's launches by route, by wrapper name."""
    import shutil
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    cfg = get_config(arch).reduced()
    argv = ["--arch", arch] + TRAIN_LAUNCHER_ARGS[2:]
    kernels = _train_kernels(cfg)
    for fn in kernels:
        _reset(fn)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        ck = os.path.join(tmp, "ck")
        base = argv + ["--ckpt-every", "5"]
        t0 = time.perf_counter()
        r1 = train.main(base + ["--ckpt-dir", ck, "--steps", "8"])
        r_full = train.main(base + ["--ckpt-dir", os.path.join(tmp, "ref"),
                                    "--steps", "12"])
        r2 = train.main(base + ["--ckpt-dir", ck, "--steps", "12",
                                "--resume"])
        resume_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    import numpy as np
    if not (np.isfinite(r1["losses"]).all()
            and np.isfinite(r_full["losses"]).all()):
        fail(f"non-finite launcher losses {r1['losses']} {r_full['losses']}")
    if r2["start_step"] != 6 or not np.allclose(
            r2["losses"], r_full["losses"][6:12], rtol=1e-4, atol=1e-5):
        fail(f"resumed from {r2['start_step']} with losses {r2['losses']}, "
             f"the uninterrupted run's {r_full['losses'][6:12]}")
    g = train.main(argv + ["--steps", "1", "--show-graph", "--backend",
                           "thread"])
    if g["traced_loss"] is None or not math.isclose(
            g["traced_loss"], g["losses"][0], rel_tol=1e-4):
        fail(f"traced step loss {g['traced_loss']} != the loop's step-0 "
             f"loss {g['losses'][0]}")
    train._demo_runtime.cache_clear()
    steps_run = 8 + 12 + 6 + 1 + 1          # the last run: loop + traced
    path = next(iter(kernels))
    for fn in kernels:
        _check_routes(fn, cfg, "reduced train launcher")
    routes = getattr(path, "route_launches", None)
    for fn, per_step in kernels.items():
        want = per_step * steps_run
        if fn.launches != want:
            fail(f"reduced train launcher: {fn.launches} {fn.__name__} "
                 f"launches, expected {want}")
    line("train_launcher", {
        "argv": argv, "layers": cfg.n_layers,
        **({"enc_layers": cfg.n_enc_layers} if cfg.is_encoder_decoder
           else {}),
        "compute_dtype": cfg.compute_dtype, "steps_run": steps_run,
        "losses_8": r1["losses"], "losses_12": r_full["losses"],
        "resumed_losses": r2["losses"], "resume_s": resume_s,
        "traced_loss": g["traced_loss"], "loop_step0_loss": g["losses"][0],
        **({"flash_launches": path.launches}
           if _path_kernel(cfg) == "flash_attention" else {}),
        "launches": {fn.__name__: fn.launches for fn in kernels},
        "launches_by_route": routes,
        "launches_by_route_by_kernel": {
            fn.__name__: dict(_launch_routes(fn)) for fn in kernels}})
    return {fn.__name__: _launch_routes(fn) for fn in kernels}


@contextlib.contextmanager
def timed_function_calls(torch, fn_cls, method: str = "forward",
                         shapes=None):
    """Within the block, every call of the autograd Function ``fn_cls``'s
    ``method`` (``forward``: its kernel launch and output allocation;
    ``backward``) is bracketed by CUDA events; yields the list of (start,
    end) pairs.  Each call's first argument's shape is appended to
    ``shapes`` when given."""
    inner = getattr(fn_cls, method)
    events = []

    def timed(ctx, *args):
        if shapes is not None:
            shapes.append(list(args[0].shape))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = inner(ctx, *args)
        end.record()
        events.append((start, end))
        return out

    setattr(fn_cls, method, staticmethod(timed))
    try:
        yield events
    finally:
        setattr(fn_cls, method, staticmethod(inner))


def _first_step_gap(torch, got, want) -> dict:
    """The gap between two first-step (loss, {leaf path: gradient}) pairs:
    the losses' and global gradient norms' relative differences and each
    leaf's cosine.  The key bias's gradient is 0 in exact arithmetic (q·bk
    shifts every key's score alike), so both are rounding noise: its cosine
    is reported and not compared."""
    from repro_torch.optim import global_norm
    norms = [global_norm(g).item() for _, g in (got, want)]
    cosines = {}
    for path, gg in got[1].items():
        gg, gw = gg.float().flatten(), want[1][path].float().flatten()
        cosines[path] = (torch.dot(gg, gw) / (gg.norm() * gw.norm())
                         .clamp_min(1e-30)).item()
    compared = {p: c for p, c in cosines.items() if not p.endswith("/bk")}
    least = min(compared, key=compared.get)
    return {"loss_rel_diff": abs(got[0] - want[0]) / abs(want[0]),
            "grad_norms": norms,
            "grad_norm_rel_diff": abs(norms[0] - norms[1]) / norms[1],
            "min_cosine": compared[least], "min_cosine_leaf": least,
            "cosines": cosines}


def _within_limits(gap: dict, loss_tol: float, norm_tol: float,
                   cosine_min: float) -> bool:
    """Whether a first-step gap is within the given limits."""
    return (gap["loss_rel_diff"] <= loss_tol
            and gap["grad_norm_rel_diff"] <= norm_tol
            and gap["min_cosine"] >= cosine_min)


def _outside_each_limit(gap: dict, loss_tol: float, norm_tol: float,
                        cosine_min: float) -> bool:
    """Whether a first-step gap breaks every one of the given limits."""
    return (gap["loss_rel_diff"] > loss_tol
            and gap["grad_norm_rel_diff"] > norm_tol
            and gap["min_cosine"] < cosine_min)


@contextlib.contextmanager
def _scan_reads_dt_in_bf16(torch):
    """Within the block the Mamba1 block's scan reads Δ rounded to bf16
    (the model computes it in float32): a scan of lower input precision,
    phase 11f's control."""
    from repro_torch.kernels import ops
    inner = ops.ssm_scan

    def rounded(x, dt, *args, **kwargs):
        return inner(x, dt.to(torch.bfloat16).float(), *args, **kwargs)

    ops.ssm_scan = rounded
    try:
        yield
    finally:
        ops.ssm_scan = inner


def _train_cell(arch: str):
    """A TRAIN_CELLS cell's model: the config cut in depth, its
    parameter count, the autograd Function of its path kernel, and the
    batch and sequence it trains on."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssm_scan as scan
    from repro_torch.models.config import cut_depth
    cell = TRAIN_CELLS[arch]
    cfg = cut_depth(get_config(arch), cell.layers)
    fn_cls = (fa.FlashAttention if _path_kernel(cfg) == "flash_attention"
              else scan.SSMScan)
    return cfg, cell.n_params, fn_cls, cell.batch, cell.seq


def _routing_flips(torch, cfg, kernel_calls, plain_calls) -> dict:
    """One batch's MoE routing in a forward with the kernel and one with
    the plain attention (``_recording_routing``'s calls, one an MoE
    layer): the (token, expert) assignments that the two do not share,
    summed over the layers (a layer's input differs between the two once an
    attention before it rounds otherwise, so a near-tie can flip a pick),
    and each run's picks dropped by capacity."""
    layers = cfg.n_layers // cfg.moe_every
    if len(kernel_calls) != layers or len(plain_calls) != layers:
        fail(f"{cfg.name}: {len(kernel_calls)} and {len(plain_calls)} MoE "
             f"calls recorded in a forward, expected {layers}")
    E, K = cfg.n_experts, cfg.experts_per_token
    flipped = 0
    for ck, cp in zip(kernel_calls, plain_calls):
        picks = [torch.nn.functional.one_hot(c["idx"].reshape(-1, K),
                                             E).amax(1) for c in (ck, cp)]
        flipped += int((picks[0] > picks[1]).sum())
    return {"flipped": flipped,
            "assignments": sum(c["tokens"] for c in kernel_calls) * K,
            "dropped_kernel": sum(int(c["dropped"]) for c in kernel_calls),
            "dropped_plain": sum(int(c["dropped"]) for c in plain_calls)}


def _loss_over_draws(torch, cfg, params, n_batch: int, seq: int) -> dict:
    """The first step's loss with the kernel and with the plain attention
    over FIRST_STEP_DRAWS batches (forward only): batch ``d`` is
    SyntheticLMDataset(seed=0)'s at index ``d`` with its frontend's input
    drawn from seed ``d``.  Returns the two losses of their union (the
    mean: the batches are of one size), their relative gap, and each
    batch's own; for an MoE model also each batch's routing flips
    (:func:`_routing_flips`) and their sum."""
    from repro_torch.data.pipeline import SyntheticLMDataset
    from repro_torch.launch.train import add_frontend
    from repro_torch.models import model_module
    ds = SyntheticLMDataset(cfg.vocab_size, seq, n_batch, seed=0)
    fns = {impl: model_module(cfg).make_loss_fn(cfg, impl=impl)
           for impl in ("kernel", "ref")}
    losses = {impl: [] for impl in fns}
    routing = []
    with torch.no_grad():
        for d in range(FIRST_STEP_DRAWS):
            batch = add_frontend({k: torch.as_tensor(v, device="cuda")
                                  for k, v in ds.batch_at(d).items()},
                                 cfg, n_batch, "cuda", seed=d)
            calls = {}
            for impl, fn in fns.items():
                with (_recording_routing(torch) if cfg.n_experts
                      else contextlib.nullcontext([])) as calls[impl]:
                    losses[impl].append(fn(params, batch)[0].item())
            if cfg.n_experts:
                routing.append(_routing_flips(torch, cfg, calls["kernel"],
                                              calls["ref"]))
    mean = {impl: sum(v) / len(v) for impl, v in losses.items()}
    out = {"draws": FIRST_STEP_DRAWS, "loss_kernel": mean["kernel"],
           "loss_plain": mean["ref"],
           "loss_rel_diff": abs(mean["kernel"] - mean["ref"])
           / abs(mean["ref"]),
           "per_draw_rel_diff": [(k - p) / abs(p) for k, p in
                                 zip(losses["kernel"], losses["ref"])]}
    if routing:
        out["routing"] = {
            **{k: sum(r[k] for r in routing) for k in routing[0]},
            "flipped_per_draw": [r["flipped"] for r in routing]}
    return out


def _train_optimizer(cfg, lr: float):
    """A training cell's optimizer at peak rate ``lr``, warmup 1, so that
    TRAIN_STEPS steps train at the peak rate and below (with the
    launcher's default warmup of 10 the rate is at most 1.2e-4 of it
    there): make_optimizer's, or Adafactor for ADAFACTOR_CELLS, which
    make_optimizer gives AdamW (see MOE_TRAIN_ARCH)."""
    from repro_torch.launch import steps
    from repro_torch.optim import Adafactor
    from repro_torch.optim.schedules import cosine_schedule
    schedule = cosine_schedule(lr, 1, TRAIN_STEPS)
    if cfg.name in ADAFACTOR_CELLS:
        return Adafactor(lr=schedule)
    return steps.make_optimizer(cfg, lr=schedule)


def _dryrun_args(arch: str, layers: int, batch: int, seq: int) -> list:
    """The dry-run's arguments for a training cell of the checkout's own
    shape: ``arch`` at ``layers`` on batches of ``batch`` x ``seq``, on
    the (1, 1) mesh, its fake tensors on the card."""
    return ["--arch", arch, "--shape", f"train_cell:{seq}:{batch}:train",
            "--mesh", "one", "--override", f"n_layers={layers}",
            "--device", "cuda"]


def phase_dryrun_start():
    """Phase 17's dry-runs, started as processes of their own (a ``fake``
    process group is one a process) beside phases 11a and 11b: 17a's
    production cell (qwen2-7b train_4k on the (16, 16) mesh of 256 fake
    ranks) with the mesh's fake tensors on the card and on the CPU, and
    the training cells with a ``dryrun`` sub-phase (11c, 11f, 12b, 13b,
    18b, 18c) on the (1, 1) mesh.  Returns what :func:`phase_dryrun_join` reads."""
    import tempfile
    out = Path(tempfile.mkdtemp(prefix="chip-smoke-dryrun-"))
    prod = ["--arch", DENSE_ARCH, "--shape", "train_4k", "--mesh", "single"]
    runs = {"production_cuda": prod + ["--device", "cuda"],
            "production_cpu": prod + ["--device", "cpu"]}
    for arch, cell in TRAIN_CELLS.items():
        if cell.dryrun:
            runs[arch] = _dryrun_args(arch, cell.layers, cell.batch,
                                      cell.seq)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    procs = {}
    for name, args in runs.items():
        procs[name] = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", *args,
             "--no-probes", "--out", str(out / name)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env, cwd=str(ROOT))
    return out, procs, time.perf_counter()


def phase_dryrun_join(pending) -> None:
    """Phase 17a, and the training cells' predictions: wait for the
    dry-runs (each within DRYRUN_TIMEOUT, all killed on a failure), read
    their records, fail unless the production cell's records from the
    card's and the CPU's fake tensors are equal in every key but time and
    device, and keep each dry-run training cell's in RESULTS for
    phase_train_full."""
    out, procs, t0 = pending
    recs = {}
    try:
        for name, p in procs.items():
            try:
                stdout, stderr = p.communicate(
                    timeout=max(1.0, DRYRUN_TIMEOUT
                                - (time.perf_counter() - t0)))
            except subprocess.TimeoutExpired:
                fail(f"dry-run {name} did not end within {DRYRUN_TIMEOUT} s")
            path, = (out / name).glob("*.json")
            recs[name] = json.loads(path.read_text())
            if p.returncode != 0:
                fail(f"dry-run {name} exited {p.returncode}:\n"
                     f"{stdout[-2000:]}\n{recs[name].get('traceback')}")
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    timed = ("compile_seconds", "device")
    cuda, cpu = recs["production_cuda"], recs["production_cpu"]
    same = {k: v for k, v in cuda.items() if k not in timed} == \
        {k: v for k, v in cpu.items() if k not in timed}
    coll = cuda.get("collectives", {})
    line("dryrun_production", {
        "arch": cuda["arch"], "shape": cuda["shape"], "chips": cuda["chips"],
        "status": cuda["status"],
        "flops_per_device": cuda.get("flops_per_device"),
        "flops_by_dtype": cuda.get("flops_by_dtype"),
        "bytes_per_device": cuda.get("bytes_per_device"),
        "peak_memory_in_bytes": cuda.get("peak_memory_in_bytes"),
        "collective_ops": coll.get("_n_ops"),
        "collective_bytes": {k: v for k, v in coll.items()
                             if not k.startswith("_")},
        "wire_nvlink_bytes": coll.get("_wire_nvlink_bytes"),
        "wire_ib_bytes": coll.get("_wire_ib_bytes"),
        "compile_seconds": {"cuda": cuda["compile_seconds"],
                            "cpu": cpu["compile_seconds"]},
        "cuda_equals_cpu": same, "wall_s": wall})
    if cuda["status"] != "OK" or not same:
        diff = sorted(k for k in set(cuda) | set(cpu) if k not in timed
                      and cuda.get(k) != cpu.get(k))
        fail(f"17a: the production cell's records differ between the "
             f"card's and the CPU's fake tensors in {diff} "
             f"(status {cuda['status']}, {cuda.get('traceback')}; "
             f"{cpu.get('traceback')})")
    for arch in (a for a, c in TRAIN_CELLS.items() if c.dryrun):
        if recs[arch]["status"] != "OK":
            fail(f"dry-run of {arch}'s training cell: {recs[arch]}")
        RESULTS[("dryrun", arch)] = recs[arch]


def _model_flops(cfg, tokens: int) -> int:
    """A training step's model FLOPs, ``launch/roofline.py::model_flops``'s
    6 N_active D for the config at its cut depth (roofline reads the
    published depth): N_active = N without experts."""
    from repro_torch.models import model_module
    M = model_module(cfg)
    active = getattr(M, "count_active_params", M.count_params)(cfg)
    return 6 * active * tokens


def _against_dryrun(dry: dict, counted: dict, peak: int, median_s: float,
                    model_flops: int) -> dict:
    """Phase 17b-17g: the dry-run's prediction for a training cell beside
    the cell's own run: step 0's FLOPs counted by ``launch.costs.Counter``
    on the card, the steps' peak memory and median step.  Returns the
    readings; the checks read them."""
    costs = _costs()
    t_comp = costs.compute_seconds(dry["flops_by_dtype"])
    t_mem = dry["bytes_per_device"] / costs.HBM_BYTES_PER_S
    return {
        "flops_by_dtype_step0": counted,
        "flops_by_dtype_dryrun": {k: int(v) for k, v in
                                  dry["flops_by_dtype"].items()},
        "flops_equal": counted == {k: int(v) for k, v in
                                   dry["flops_by_dtype"].items()},
        "peak_predicted": dry["peak_memory_in_bytes"], "peak_measured": peak,
        "peak_ratio": peak / dry["peak_memory_in_bytes"],
        "bytes_per_device": dry["bytes_per_device"],
        "t_compute_s": t_comp, "t_memory_s": t_mem,
        "bound_s": max(t_comp, t_mem), "median_step_s": median_s,
        "bound_share_of_step": max(t_comp, t_mem) / median_s,
        "model_flops": model_flops,
        "mfu": model_flops / median_s / costs.PEAK_FLOPS["bfloat16"],
        "dryrun_compile_seconds": dry["compile_seconds"]}


def _check_against_dryrun(name: str, got: dict, peak_held: bool) -> None:
    """Fails unless step 0's FLOPs are the dry-run's to the FLOP and the
    roofline bound is at most the median step; with ``peak_held``, also
    unless the measured peak lies in DRYRUN_PEAK_BAND of the prediction."""
    if not got["flops_equal"]:
        fail(f"{name}: step 0 counted {got['flops_by_dtype_step0']} FLOPs, "
             f"the dry-run {got['flops_by_dtype_dryrun']}")
    lo, hi = DRYRUN_PEAK_BAND
    if peak_held and not lo <= got["peak_ratio"] <= hi:
        fail(f"{name}: peak {got['peak_measured']} B is "
             f"{got['peak_ratio']:.3f} x the dry-run's "
             f"{got['peak_predicted']} B, outside {DRYRUN_PEAK_BAND}")
    if got["bound_s"] > got["median_step_s"]:
        fail(f"{name}: the roofline bound {got['bound_s']} s exceeds the "
             f"measured median step {got['median_step_s']} s: a miscount")


def phase_train_full(torch, arch: str = DENSE_ARCH,
                     profile: bool = False) -> dict:
    """Phase 11c (qwen2-7b at TRAIN_LAYERS layers), 11f (falcon-mamba-7b
    at MAMBA_TRAIN_LAYERS), 12b (zamba2-7b at HYBRID_TRAIN_LAYERS), 13b
    (dbrx-132b at MOE_TRAIN_LAYERS), 14c-d (whisper-tiny whole,
    llava-next-34b at VLM_LAYERS), 18b (granite-20b at 6) and 18c
    (qwen3-14b at 4): the published width cut in depth (bf16 compute,
    selective remat, which the encoder-decoder does not apply),
    drawn on the card from seed 0, trained on SyntheticLMDataset(seed=0)
    batches of the cell's TRAIN_CELLS size, with its frontend's stand-in
    patches or frames (seed 0, the same every step).  First
    one loss-and-gradient with the kernels and one with the plain versions
    on the same parameters and batch, every gradient leaf finite (the
    attention models' loss read over FIRST_STEP_DRAWS batches, with the
    MoE model's routing flips); then TRAIN_STEPS steps of
    launch/steps.py's train step with the cell's optimizer
    (``_train_optimizer``: make_optimizer's AdamW, Adafactor for
    dbrx-132b); with ``profile``, one more step under the profiler (the
    hybrid's with the SSD's backward share, :func:`_ssd_backward`); then
    the same steps from the same draw with the plain versions, whose
    losses the kernels' steps must meet.  The attention models' losses
    must also fall over the steps.
    The Mamba1 cell also reads the first step in float32 compute, kernel
    and plain (within SCAN_F32_*), and a control, the kernel path reading
    Δ rounded to bf16: its first step in both computes and its steps from
    the same draw, which must break the float32 limits and TRAIN_TRAJ_TOL.
    Returns each path kernel's launches in the measured steps by route, by
    wrapper name."""
    import gc
    from repro_torch.data.pipeline import SyntheticLMDataset
    from repro_torch.launch import steps
    from repro_torch.launch.train import add_frontend
    from repro_torch.models import model_module
    from repro_torch.models import transformer as TF
    from repro_torch.tree import tree_flatten_with_paths
    cfg, n_params, fn_cls, n_batch, seq = _train_cell(arch)
    M = model_module(cfg)
    dense = _path_kernel(cfg) == "flash_attention"
    lr = TRAIN_CELLS[arch].lr
    if (cfg.compute_dtype, cfg.remat) != ("bfloat16", "selective"):
        fail(f"{cfg.name}: expected bf16 compute and selective remat")
    per_step = _train_kernels(cfg)
    kernels = list(per_step)
    counter = kernels[0]                         # the forward kernel
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = M.init_params(cfg, 0, "cuda")
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    n = sum(t.numel() for _, t in tree_flatten_with_paths(params))
    if n != n_params or n != M.count_params(cfg):
        fail(f"{cfg.name} at {cfg.n_layers} layers: {n} parameters, "
             f"expected {n_params}")
    ds = SyntheticLMDataset(cfg.vocab_size, seq, n_batch, seed=0)
    frontend = add_frontend({}, cfg, n_batch, "cuda")

    def batch_at(s):
        return {**{k: torch.as_tensor(v, device="cuda")
                   for k, v in ds.batch_at(s).items()}, **frontend}

    def launched():
        return {fn.__name__: fn.launches for fn in kernels}

    def first_step(run_cfg, impl="kernel"):
        t0 = time.perf_counter()
        (total, _), g = TF.value_and_grad(M.make_loss_fn(
            run_cfg, impl=impl))(params, batch_at(0))
        return (total.item(), dict(tree_flatten_with_paths(g)),
                time.perf_counter() - t0)

    # the kernels' and the plain versions' first-step gradients
    grads, losses, first_s = {}, {}, {}
    for impl in ("kernel", "ref"):
        for fn in kernels:
            _reset(fn)
        losses[impl], grads[impl], first_s[impl] = first_step(cfg, impl)
        want = {fn.__name__: (k if impl == "kernel" else 0)
                for fn, k in per_step.items()}
        if launched() != want:
            fail(f"{impl} loss-and-gradient: launches {launched()}, "
                 f"expected {want}")
        # the hybrid's SSD at full-width chunks is where the reference's
        # gradient turns NaN (ROADMAP §3): the port's must not
        bad = [p for p, g in grads[impl].items()
               if not torch.isfinite(g).all()]
        if bad:
            fail(f"{cfg.name} {impl} first step: non-finite gradient "
                 f"leaves {bad}")
    plain = (losses["ref"], grads["ref"])
    gap = _first_step_gap(torch, (losses["kernel"], grads["kernel"]), plain)
    witness = {}
    if not dense:
        # the Mamba1 cell's gap, read three times more: the control (the
        # kernel path reading Δ rounded to bf16), and the kernel and the
        # control in float32 compute, where no bf16 rounding of a layer's
        # output carries a last-bit difference through the depth
        del grads["kernel"]
        with _scan_reads_dt_in_bf16(torch):
            loss, g, seconds = first_step(cfg)
        witness["control"] = {**_first_step_gap(torch, (loss, g), plain),
                              "seconds": seconds}
        del g, grads, plain
        gc.collect()
        cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
        plain = first_step(cfg32, "ref")
        for name in ("float32", "float32_control"):
            with (_scan_reads_dt_in_bf16(torch) if name.endswith("control")
                  else contextlib.nullcontext()):
                loss, g, seconds = first_step(cfg32)
            witness[name] = {**_first_step_gap(torch, (loss, g), plain[:2]),
                             "seconds": [seconds, plain[2]]}
            del g
        del plain
    else:
        del grads, plain
    gc.collect()
    torch.cuda.empty_cache()
    if dense:
        # the loss over FIRST_STEP_DRAWS batches: one batch's gap is
        # rounding noise of the size of the limit (see TRAIN_LOSS_TOL)
        loss_gap = _loss_over_draws(torch, cfg, params, n_batch, seq)
        held = {**gap, "loss_rel_diff": loss_gap["loss_rel_diff"]}
    else:
        loss_gap, held = None, gap
    if not (math.isfinite(losses["kernel"])
            and _within_limits(held, TRAIN_LOSS_TOL, TRAIN_NORM_TOL,
                               TRAIN_COSINE_MIN)):
        fail(f"kernel vs plain first step: losses {losses}, {gap}, "
             f"over {FIRST_STEP_DRAWS} batches {loss_gap}, "
             f"witnesses {witness}")

    compare_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    opt = _train_optimizer(cfg, lr)
    state = opt.init(params)
    step = steps.make_train_step(cfg, opt)
    step_losses, step_s, fwd_ms, bwd_ms = [], [], [], []
    # phase 17b/17c: step 0 counted (launch/costs.py), against the dry-run
    dry = RESULTS.get(("dryrun", cfg.name))
    count = None
    for fn in kernels:
        _reset(fn)
    for s in range(TRAIN_STEPS):
        batch = batch_at(s)
        torch.cuda.synchronize()
        with contextlib.ExitStack() as timing:
            fwd = timing.enter_context(
                timed_function_calls(torch, fn_cls))
            bwd = timing.enter_context(
                timed_function_calls(torch, fn_cls, "backward"))
            if dry is not None and s == 0:
                count = timing.enter_context(_costs().Counter())
            t0 = time.perf_counter()
            params, state, metrics = step(params, state, batch)
            step_losses.append(metrics["total_loss"].item())
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
        fwd_ms.append(events_ms(torch, fwd))
        bwd_ms.append(events_ms(torch, bwd))
        want = {fn.__name__: k * (s + 1) for fn, k in per_step.items()}
        if len(fwd) != per_step[counter] or launched() != want:
            fail(f"train step {s}: {len(fwd)} {fn_cls.__name__} forwards, "
                 f"launches so far {launched()}, expected {want}")
    for fn in kernels:
        _check_routes(fn, cfg, f"{cfg.name} train steps")
    routes = dict(getattr(counter, "route_launches", None)
                  or {"simt": counter.launches})
    if not all(math.isfinite(x) for x in step_losses) or \
            (dense and not step_losses[-1] < step_losses[0]):
        fail(f"train losses {step_losses}: not finite"
             + (" and falling" if dense else ""))
    median_s = sorted(step_s[1:])[len(step_s[1:]) // 2]
    model_flops = _model_flops(cfg, n_batch * seq)
    steps_peak = torch.cuda.max_memory_allocated()
    step_launches = launched()
    launches = {fn.__name__: _launch_routes(fn) for fn in kernels}
    if profile:
        batch = batch_at(TRAIN_STEPS)
        hybrid = "mamba2" in cfg.layer_plan[0]
        with (_ssd_annotated(torch) if hybrid
              else contextlib.nullcontext()):
            profile_line(torch, f"profile_{cfg.name}_train_step",
                         lambda: step(params, state, batch),
                         _ssd_backward if hybrid else None)
    del params, state, metrics, step
    gc.collect()
    torch.cuda.empty_cache()

    # the same steps from the same draw with the plain versions: the train
    # step's body (launch/steps.py) over make_loss_fn(impl="ref")
    torch.cuda.reset_peak_memory_stats()
    params = M.init_params(cfg, 0, "cuda")
    opt = _train_optimizer(cfg, lr)
    state = opt.init(params)
    plain_grad_fn = TF.value_and_grad(M.make_loss_fn(cfg, impl="ref"))
    plain_losses, plain_s = [], []
    for fn in kernels:
        _reset(fn)
    for s in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        (total, _), g = plain_grad_fn(params, batch_at(s))
        state = opt.update(g, state, params)
        plain_losses.append(total.item())
        plain_s.append(time.perf_counter() - t0)
        del g
    if any(launched().values()):
        fail(f"plain train steps: launches {launched()}")
    plain_peak = torch.cuda.max_memory_allocated()
    traj_diff = [abs(k - p) / abs(p) for k, p in zip(step_losses,
                                                      plain_losses)]
    if not all(math.isfinite(x) for x in plain_losses) or \
            max(traj_diff) > TRAIN_TRAJ_TOL:
        fail(f"train losses: kernel {step_losses}, plain {plain_losses}, "
             f"relative differences {traj_diff} (limit {TRAIN_TRAJ_TOL})")
    del params, state
    gc.collect()
    torch.cuda.empty_cache()
    if not dense:
        # the control's steps: the kernel path reading Δ in bf16, from the
        # same draw, against the plain steps
        params = TF.init_params(cfg, 0, "cuda")
        opt = _train_optimizer(cfg, lr)
        state = opt.init(params)
        step = steps.make_train_step(cfg, opt)
        control_losses = []
        with _scan_reads_dt_in_bf16(torch):
            for s in range(TRAIN_STEPS):
                params, state, metrics = step(params, state, batch_at(s))
                control_losses.append(metrics["total_loss"].item())
        witness["control"]["losses"] = control_losses
        witness["control"]["losses_rel_diff"] = [
            abs(c - p) / abs(p) for c, p in zip(control_losses,
                                                 plain_losses)]
        del params, state, metrics, step
        gc.collect()
        torch.cuda.empty_cache()
    dims = ({"heads": cfg.n_heads, "kv_heads": cfg.n_kv_heads,
             "head_dim": cfg.head_dim, "d_ff": cfg.d_ff,
             **({"enc_layers": cfg.n_enc_layers, "enc_seq": cfg.enc_seq}
                if cfg.is_encoder_decoder else {}),
             **({"patches": cfg.n_patches} if cfg.family == "vlm" else {}),
             **({"attention_sites": _kernel_layers(cfg),
                 "d_inner": cfg.d_inner, "state": cfg.ssm_state,
                 "ssm_heads": cfg.n_ssm_heads, "ssm_chunk": cfg.ssm_chunk}
                if cfg.family == "hybrid" else {}),
             **({"experts": cfg.n_experts, "top_k": cfg.experts_per_token,
                 "expert_d_ff": cfg.expert_d_ff,
                 "capacity_factor": cfg.capacity_factor}
                if cfg.n_experts else {})}
            if dense else {"d_inner": cfg.d_inner, "state": cfg.ssm_state})
    timings = ({"flash_launches": step_launches["flash_attention"],
                "flash_backward_launches":
                    step_launches["flash_attention_backward"],
                "launches_by_route": routes,
                "backward_launches_by_route":
                    dict(launches["flash_attention_backward"]),
                "flash_forward_ms_per_step": fwd_ms,
                "flash_backward_ms_per_step": bwd_ms}
               if dense else
               {"launches": step_launches,
                "scan_forward_ms_per_step": fwd_ms,
                "scan_backward_ms_per_step": bwd_ms,
                "first_step_s": first_s, "plain_step_s": plain_s,
                "witness": witness})
    out = {
        "arch": cfg.name, "layers": cfg.n_layers, "n_params": n,
        "d_model": cfg.d_model, **dims,
        "vocab": cfg.vocab_size, "compute_dtype": cfg.compute_dtype,
        "remat": "none" if cfg.is_encoder_decoder else cfg.remat,
        "batch": n_batch, "seq": seq,
        "optimizer": type(opt).__name__,
        **({"optimizer_note": "Adafactor passed to make_train_step by the "
            "cell: AdamW's state does not fit the card, and "
            "make_optimizer gives Adafactor to llama4* only"}
           if cfg.name in ADAFACTOR_CELLS else {}),
        "lr": lr, "draw_s": draw_s,
        "first_step": {"loss_kernel": losses["kernel"],
                       "loss_plain": losses["ref"], **gap,
                       **({"over_draws": loss_gap} if dense else {}),
                       "loss_tol": TRAIN_LOSS_TOL,
                       "grad_norm_tol": TRAIN_NORM_TOL,
                       "cosine_min_allowed": TRAIN_COSINE_MIN},
        "losses": step_losses, "plain_losses": plain_losses,
        "losses_rel_diff": traj_diff, "losses_tol": TRAIN_TRAJ_TOL,
        "step_s": step_s,
        "median_step_s": median_s,
        "tokens_per_s": n_batch * seq / median_s,
        # 6 N_active D over the median step at the bf16 peak
        "mfu": model_flops / median_s / _costs().PEAK_FLOPS["bfloat16"],
        **timings,
        # the training steps' peak, the first-step comparison's (two
        # gradient trees at once) and the plain versions' steps'
        "peak_device_bytes": steps_peak,
        "peak_device_bytes_compare": compare_peak,
        "peak_device_bytes_plain_steps": plain_peak}
    if dry is not None:
        out["dryrun"] = _against_dryrun(
            dry, dict(count.flops_by_dtype), steps_peak, median_s,
            model_flops)
    line("train_full", out)
    RESULTS[("train_full", cfg.name)] = out
    if dry is not None:
        _check_against_dryrun(f"{TRAIN_CELLS[arch].dryrun} {cfg.name}",
                              out["dryrun"], arch not in ADAFACTOR_CELLS)
    if not dense:
        f32 = (SCAN_F32_LOSS_TOL, SCAN_F32_NORM_TOL, SCAN_F32_COSINE_MIN)
        if not _within_limits(witness["float32"], *f32):
            fail(f"kernel vs plain first step in float32 compute: "
                 f"{witness['float32']}, limits {f32}")
        if not _outside_each_limit(witness["float32_control"], *f32) or \
                max(witness["control"]["losses_rel_diff"]) <= TRAIN_TRAJ_TOL:
            fail(f"the limits do not tell a scan reading Δ in bf16: "
                 f"{witness['float32_control']}, trajectory "
                 f"{witness['control']['losses_rel_diff']}")
    return launches


def phase_encdec_decode(torch) -> collections.Counter:
    """Phase 14c's prefill and decode: whisper-tiny drawn on the card from
    seed 0; a prefill of ENCDEC_SEQ - 1 tokens (a cache of ENCDEC_SEQ) over
    the training frames, then one decode step, twice in bf16 compute (the
    second timed), then once in float32 compute on the same parameters.
    Each prefill launches flash at every encoder layer and at each decoder
    layer's self- and cross-attention, each decode step at the
    cross-attention only, all on the route of the compute dtype (wgmma in
    bf16, simt in float32).  In both computes the kernel's prefill and
    decode logits must meet the plain attention's (``impl="ref"``, the
    decode step on the kernel's cache) within DECODE_REL_TOL of the
    largest logit.  The decode step's logits are also read against the
    full pass's last position (``encode``, ``cross_kv``,
    ``decoder_forward``); in float32 compute, the setting of
    tests/test_models.py's check, they must meet it within LOGIT_TOL.  In
    bf16 the logits reach ±170 (the tied embedding is drawn at scale 1),
    where one bf16 step of the final hidden state moves a logit by about
    0.5: that reading is recorded.  Returns the flash launches by
    route."""
    import gc
    from repro_torch.data.pipeline import SyntheticLMDataset
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.train import add_frontend
    from repro_torch.models import encdec as ED
    cfg, _, _, n_batch, seq = _train_cell(ENCDEC_ARCH)
    params = ED.init_params(cfg, 0, "cuda")
    tokens = torch.as_tensor(SyntheticLMDataset(
        cfg.vocab_size, seq, n_batch, seed=0).batch_at(0)["tokens"],
        device="cuda")
    frames = add_frontend({}, cfg, n_batch, "cuda")["frames"]
    fn = fa.flash_attention
    per_prefill = cfg.n_enc_layers + 2 * cfg.n_layers
    launches = collections.Counter()
    torch.cuda.reset_peak_memory_stats()
    runs = {}
    for run_cfg, reps in ((cfg, 2),
                          (dataclasses.replace(cfg, compute_dtype="float32"),
                           1)):
        prefill = ED.make_prefill_step(run_cfg, max_len=seq)
        decode = ED.make_decode_step(run_cfg)
        route = expected_route(run_cfg)

        def on_route(n):
            return {r: (n if r == route else 0) for r in fn.route_launches}
        for _ in range(reps):
            _reset(fn)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            last, cache = prefill(params, tokens[:, :-1], frames)
            torch.cuda.synchronize()
            prefill_s = time.perf_counter() - t0
            after_prefill = dict(fn.route_launches)
            t0 = time.perf_counter()
            got, new_cache = decode(params, cache, tokens[:, -1:])
            torch.cuda.synchronize()
            decode_ms = (time.perf_counter() - t0) * 1e3
            if after_prefill != on_route(per_prefill) or \
                    fn.route_launches != on_route(per_prefill
                                                  + cfg.n_layers):
                fail(f"{cfg.name} prefill and decode: launches by route "
                     f"{after_prefill}, then {fn.route_launches}; expected "
                     f"{per_prefill} {route} a prefill, {cfg.n_layers} a "
                     f"decode step")
            launches += _launch_routes(fn)
        # the plain attention's prefill, and its decode step on the
        # kernel's cache (which the step does not change)
        _reset(fn)
        plain_last, _ = ED.make_prefill_step(run_cfg, max_len=seq,
                                             impl="ref")(
            params, tokens[:, :-1], frames)
        plain_got, _ = ED.make_decode_step(run_cfg, impl="ref")(
            params, cache, tokens[:, -1:])
        if fn.launches:
            fail(f"{cfg.name} plain prefill and decode: {fn.launches} "
                 f"flash launches")
        vs_plain = {
            name: ((a - b).abs().max() / b.abs().max()).item()
            for name, a, b in (("prefill", last, plain_last),
                               ("decode", got, plain_got))}
        xkv = ED.cross_kv(params, ED.encode(params, frames, run_cfg),
                          run_cfg)
        full, _ = ED.decoder_forward(params, tokens, xkv, run_cfg)
        launches += _launch_routes(fn)
        want = full[:, -1]
        diff = (got - want).abs()
        if not (torch.isfinite(got).all() and int(new_cache["pos"]) == seq):
            fail(f"{cfg.name} decode step in {run_cfg.compute_dtype}: "
                 f"logits not finite or cache at {int(new_cache['pos'])}")
        runs[run_cfg.compute_dtype] = {
            "route": route, "prefill_s": prefill_s, "decode_ms": decode_ms,
            "logits_max_abs_diff": diff.max().item(),
            "logits_mean_abs_diff": diff.mean().item(),
            "logits_max_abs": want.abs().max().item(),
            "greedy_same": bool(torch.equal(got.argmax(-1),
                                            want.argmax(-1))),
            "vs_plain_rel_diff": vs_plain}
        del cache, new_cache, xkv, full, got, want, last, plain_last
        del plain_got
    peak = torch.cuda.max_memory_allocated()
    line("encdec_decode", {
        "arch": cfg.name, "batch": n_batch, "prompt": seq - 1,
        "max_len": seq, "enc_seq": cfg.enc_seq,
        "flash_launches_prefill": per_prefill,
        "flash_launches_decode": cfg.n_layers, "logit_tol": LOGIT_TOL,
        "vs_plain_rel_tol": DECODE_REL_TOL,
        "runs": runs, "peak_device_bytes": peak})
    for dtype, run in runs.items():
        if max(run["vs_plain_rel_diff"].values()) > DECODE_REL_TOL:
            fail(f"{cfg.name} prefill and decode in {dtype}, kernel against "
                 f"the plain attention: {run} (limit {DECODE_REL_TOL} of "
                 f"the largest logit)")
    if runs["float32"]["logits_max_abs_diff"] > LOGIT_TOL:
        fail(f"{cfg.name} decode step against the full pass in float32: "
             f"{runs['float32']} (limit {LOGIT_TOL})")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_encdec(torch, profile: bool) -> tuple:
    """Phase 14 (after 14a, which runs in phases 8 and 11a): for
    whisper-tiny, then llava-next-34b, (b) the training launcher at
    ``--reduced`` on the card and (c, d) training at full width
    (``phase_train_full``; with ``profile``, one profiled step), and for
    whisper-tiny its prefill and decode step (``phase_encdec_decode``);
    each model freed before the next.  Returns the flash forward's and
    backward's launches by route."""
    import gc
    launches, bwd_launches = collections.Counter(), collections.Counter()
    for arch in (ENCDEC_ARCH, VLM_ARCH):
        for run in (phase_train_launcher(torch, arch),
                    phase_train_full(torch, arch, profile)):
            launches += run["flash_attention"]
            bwd_launches += run["flash_attention_backward"]
        if arch == ENCDEC_ARCH:
            launches += phase_encdec_decode(torch)
        gc.collect()
        torch.cuda.empty_cache()
    return launches, bwd_launches


def phase_mesh_executor(torch, seq_total: float) -> int:
    """Phase 15a: phase 4's Fig. 2 DAG through ``MeshExecutor`` on a (1, 1)
    mesh of the world of one: the placement refinement's specs, then two
    calls (the first counts FLOPs and collectives), each bit for bit phase
    4's sequential value with one matmul launch a ``mul`` on its route, on
    each rank's local shard, and no collective.  Returns the launches."""
    from repro_torch.core import (MeshExecutor, ValueInfo, logical_to_spec,
                                  standard_rules, total_resharding_bytes,
                                  trace)
    from repro_torch.kernels import matmul as mm
    from repro_torch.parallel.mesh import make_mesh_for
    from repro_torch.workloads import matrix_driver
    graph, _ = trace(matrix_driver, N_TASKS, SIZE, device="cuda")
    mesh = make_mesh_for(1)
    rules = standard_rules("dp_tp", pod_axis=None)
    info = {t: ValueInfo((SIZE, SIZE), 4, ("batch", "d_model"))
            for t in graph.nodes}
    t0 = time.perf_counter()
    ex = MeshExecutor(graph, mesh, rules, value_info=info)
    refine_s = time.perf_counter() - t0
    init = {t: logical_to_spec(info[t].logical_axes, rules, mesh.axis_names)
            for t in graph.nodes}
    path = mm.route(torch.float32, SIZE, SIZE)
    walls, launches = [], 0
    for _ in range(2):
        _reset(mm.matmul)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = ex({})[0]            # reduce reads its sums on the host
        walls.append(time.perf_counter() - t0)
        if mm.matmul.route_launches != {r: (N_TASKS if r == path else 0)
                                        for r in mm.matmul.route_launches}:
            fail(f"mesh executor: matmul launches by route "
                 f"{mm.matmul.route_launches}, expected {N_TASKS} {path}")
        launches += mm.matmul.launches
        if out != seq_total:
            fail(f"mesh executor: reduce {out!r} is not phase 4's "
                 f"sequential {seq_total!r}")
    cost = ex.cost_analysis()
    if cost["collectives"] != 0:
        fail(f"mesh executor: {cost['collectives_by_op']} collectives on a "
             f"mesh of one device")
    if cost["flops"] != N_TASKS * 2 * SIZE ** 3:
        fail(f"mesh executor: {cost['flops']} FLOPs counted, expected "
             f"{N_TASKS * 2 * SIZE ** 3}")
    line("mesh_executor", {
        "mesh": mesh.shape, "nodes": len(graph), "refine_s": refine_s,
        "specs_changed": sum(ex.specs[t] != init[t] for t in graph.nodes),
        "resharding_bytes_rules": total_resharding_bytes(graph, info, init,
                                                         mesh),
        "resharding_bytes_refined": total_resharding_bytes(
            graph, info, ex.specs, mesh),
        "wall_s_counted": walls[0], "wall_s": walls[1],
        "launches_per_call": N_TASKS, "route": path,
        "equals_sequential": True, "reduce": out,
        "flops": cost["flops"], "flops_by_op": cost["flops_by_op"],
        "collectives": cost["collectives"]})
    return launches


def phase_pipeline(torch):
    """Phase 15b: qwen2-7b at 8 of 28 layers (11c's draw) through
    ``pipelined_forward`` with one stage and SPMD_MICRO microbatches of
    1 x TRAIN_SEQ embedded tokens, bf16 compute, against ``layer_stack`` on
    the whole batch.  Returns the config, the parameters, the embedded
    tokens and the pipeline's flash launches by route."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import transformer as TF
    from repro_torch.models.layers import embed_tokens
    from repro_torch.parallel.mesh import make_mesh_for
    from repro_torch.parallel.pipeline import (bubble_fraction,
                                               pipelined_forward,
                                               split_stages)
    cfg, params = phase_params(torch, DENSE_ARCH, TRAIN_N_PARAMS,
                               TRAIN_LAYERS)
    B, S = SPMD_MICRO, TRAIN_SEQ
    gen = torch.Generator(device="cuda").manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           device="cuda")
    positions = torch.arange(S, device="cuda").expand(B, S)
    # the world has one rank: the stage axis is the mesh's "data" axis
    mesh = make_mesh_for(1)
    fn = pipelined_forward(cfg, mesh, n_microbatch=SPMD_MICRO,
                           stage_axis="data", train=False)
    stages = split_stages(params["layers"], 1, cfg.n_layers)
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        x = embed_tokens(params["embed"], tokens, cfg, positions)
        for _ in range(2):        # a warm-up, then the timed run
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want, want_aux, _ = TF.layer_stack(params["layers"], x, cfg,
                                               positions=positions)
            torch.cuda.synchronize()
            base_s = time.perf_counter() - t0
        _reset(fa.flash_attention)
        shapes = []
        with timed_launches(torch, fa, "flash_attention", shapes) as ev:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got, aux = fn(stages, x)
            torch.cuda.synchronize()
            pipe_s = time.perf_counter() - t0
        flash_ms = events_ms(torch, ev)
    peak = torch.cuda.max_memory_allocated()
    n = cfg.n_layers * SPMD_MICRO
    routes = dict(fa.flash_attention.route_launches)
    want_shape = [1, cfg.n_heads, S, cfg.head_dim]
    if fa.flash_attention.launches != n or routes["wgmma"] != n or \
            any(sh != want_shape for sh in shapes):
        fail(f"pipeline: flash launches {routes}, shapes "
             f"{sorted(set(map(tuple, shapes)))}; expected {n} wgmma of "
             f"{want_shape}")
    scale = want.float().abs().max().item()
    err = (got.float() - want.float()).abs().max().item()
    if not (err <= SPMD_PIPE_TOL * scale) or float(aux) != float(want_aux):
        fail(f"pipeline: max |err| {err} against {SPMD_PIPE_TOL} x "
             f"{scale}, aux {float(aux)} against {float(want_aux)}")
    line("pipeline", {
        "arch": cfg.name, "layers": cfg.n_layers, "stages": 1,
        "microbatches": SPMD_MICRO, "tokens": [B, S],
        "compute_dtype": cfg.compute_dtype,
        "bubble_fraction": bubble_fraction(1, SPMD_MICRO),
        "pipeline_s": pipe_s, "whole_batch_s": base_s,
        "flash_ms": flash_ms, "flash_launches": routes,
        "flash_q_shape": want_shape, "max_abs_err": err,
        "max_abs_ref": scale, "rel_err": err / scale, "tol": SPMD_PIPE_TOL,
        "bits_equal": bool(torch.equal(got, want)), "aux": float(aux),
        "peak_device_bytes": peak})
    return cfg, params, x, collections.Counter(routes)


def phase_pipeline_train(torch, cfg, params, x):
    """Phase 15b's training half: 15b's pipeline at ``train=True`` under
    autograd on the same parameters and tokens, the loss sum(y · w) + aux,
    against autograd of ``layer_stack`` on the whole batch (SPMD_GRAD_*),
    each side's forward and backward timed after a warm-up of both.
    Returns the timed pipeline's flash forward and backward launches by
    route."""
    import gc
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import transformer as TF
    from repro_torch.parallel.mesh import make_mesh_for
    from repro_torch.parallel.pipeline import pipelined_forward, split_stages
    from repro_torch.tree import tree_flatten_with_paths, tree_map
    if (cfg.compute_dtype, cfg.remat) != ("bfloat16", "selective"):
        fail(f"pipeline training: expected bf16 compute and selective "
             f"remat, got {cfg.compute_dtype}, {cfg.remat}")
    B, S = x.shape[:2]
    positions = torch.arange(S, device="cuda").expand(B, S)
    w = torch.randn(x.shape, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(SPMD_W_SEED))
    fn = pipelined_forward(cfg, make_mesh_for(1), n_microbatch=SPMD_MICRO,
                           stage_axis="data", train=True)

    def loss_and_grad(run):
        """Seconds, loss and {path: gradient} (dx as "x") of one forward
        and backward through ``run(layers, x)``."""
        lay = tree_map(lambda a: a.detach().requires_grad_(),
                       params["layers"])
        xg = x.detach().requires_grad_()
        paths = ["x"] + [f"layers/{p}" for p, _ in
                         tree_flatten_with_paths(lay)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y, aux = run(lay, xg)
        loss = (y.float() * w).sum() + aux
        grads = torch.autograd.grad(loss, [xg] + [a for _, a in
                                                 tree_flatten_with_paths(
                                                     lay)])
        torch.cuda.synchronize()
        return (time.perf_counter() - t0, loss.item(),
                dict(zip(paths, grads)))

    def whole(lay, xg):
        y, aux, _ = TF.layer_stack(lay, xg, cfg, positions=positions,
                                   train=True)
        return y.to(xg.dtype), aux

    def pipe(lay, xg):
        return fn(split_stages(lay, 1, cfg.n_layers), xg)

    for run in (pipe, whole):            # warm-ups: the timed runs follow
        loss_and_grad(run)
    for f in (fa.flash_attention, fa.flash_attention_backward):
        _reset(f)
    fwd_shapes, bwd_shapes = [], []
    torch.cuda.reset_peak_memory_stats()
    with timed_function_calls(torch, fa.FlashAttention, "forward",
                              fwd_shapes) as fwd_ev, \
            timed_function_calls(torch, fa.FlashAttention, "backward",
                                 bwd_shapes) as bwd_ev:
        pipe_s, pipe_loss, got = loss_and_grad(pipe)
        fwd_ms, bwd_ms = events_ms(torch, fwd_ev), events_ms(torch, bwd_ev)
    peak = torch.cuda.max_memory_allocated()
    routes = {"forward": dict(fa.flash_attention.route_launches),
              "backward": dict(fa.flash_attention_backward.route_launches)}
    n = cfg.n_layers * SPMD_MICRO
    want_shape = [1, cfg.n_heads, S, cfg.head_dim]
    counts = (fa.flash_attention.launches,
              fa.flash_attention_backward.launches)
    if counts != (2 * n, n) or routes["forward"]["wgmma"] != 2 * n or \
            routes["backward"]["wgmma"] != n or len(fwd_shapes) != 2 * n \
            or len(bwd_shapes) != n or \
            any(sh != want_shape for sh in fwd_shapes + bwd_shapes):
        fail(f"pipeline training: flash launches {routes}, forward shapes "
             f"{sorted(set(map(tuple, fwd_shapes)))}, backward shapes "
             f"{sorted(set(map(tuple, bwd_shapes)))}; expected {2 * n} "
             f"wgmma forwards (forward and remat recompute) and {n} "
             f"wgmma backwards of {want_shape}")
    bad = [p for p, g in got.items() if not torch.isfinite(g).all()]
    if bad:
        fail(f"pipeline training: non-finite gradient leaves {bad}")
    whole_s, whole_loss, want = loss_and_grad(whole)
    gap = _first_step_gap(torch, (pipe_loss, got), (whole_loss, want))
    del got, want
    gc.collect()
    torch.cuda.empty_cache()
    held = (gap["grad_norm_rel_diff"] <= SPMD_GRAD_NORM_TOL
            and gap["min_cosine"] >= SPMD_GRAD_COSINE_MIN
            and gap["loss_rel_diff"] <= SPMD_PIPE_TOL)
    cosines = gap.pop("cosines")
    if not held:
        fail(f"pipeline training: gradient against the whole batch's "
             f"{gap}; limits norm {SPMD_GRAD_NORM_TOL}, cosine "
             f"{SPMD_GRAD_COSINE_MIN}, loss {SPMD_PIPE_TOL}")
    line("pipeline_train", {
        "arch": cfg.name, "layers": cfg.n_layers, "stages": 1,
        "microbatches": SPMD_MICRO, "tokens": [B, S],
        "compute_dtype": cfg.compute_dtype, "remat": cfg.remat,
        "loss": pipe_loss, "whole_batch_loss": whole_loss, **gap,
        "cosine_x": cosines["x"],
        "grad_norm_tol": SPMD_GRAD_NORM_TOL,
        "cosine_min_allowed": SPMD_GRAD_COSINE_MIN,
        "pipeline_fwd_bwd_s": pipe_s, "whole_batch_fwd_bwd_s": whole_s,
        "flash_forward_ms": fwd_ms, "flash_backward_ms": bwd_ms,
        "flash_launches": routes, "flash_q_shape": want_shape,
        "peak_device_bytes": peak})
    return (collections.Counter(routes["forward"]),
            collections.Counter(routes["backward"]))


def phase_compression(torch, params) -> None:
    """Phase 15c: ``Int8BlockCompressor`` over 15b's parameter tree,
    standing in for gradients: each block's roundtrip within half its own
    step (its scale, the block's largest magnitude over 127),
    ``dp_gradient_sync(..., compressor=)`` over the world of one the bits
    of the roundtrip, and one leaf's int8 codes and scales the bits the
    CPU gives."""
    from repro_torch.parallel.collectives import dp_gradient_sync
    from repro_torch.parallel.compression import (Int8BlockCompressor,
                                                  compression_ratio)
    from repro_torch.parallel.mesh import make_mesh_for
    from repro_torch.tree import tree_flatten_with_paths
    comp, mesh = Int8BlockCompressor(), make_mesh_for(1)
    leaves = tree_flatten_with_paths(params)
    n_bytes = sum(t.numel() * t.element_size() for _, t in leaves)
    torch.cuda.reset_peak_memory_stats()
    round_s = sync_s = 0.0
    worst, blocks, elems = 0.0, 0, 0
    with torch.no_grad():
        for path, leaf in leaves:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rt = comp.roundtrip(leaf)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            synced = dp_gradient_sync({"g": leaf}, mesh, ("data",),
                                      compressor=comp)["g"]
            torch.cuda.synchronize()
            round_s += t1 - t0
            sync_s += time.perf_counter() - t1
            # round to nearest: each block within half its own step, with
            # a few ulp of the step for the float32 quotient and product
            _, step = comp.quantize(leaf)
            err = (comp._blocks(rt) - comp._blocks(leaf)).abs().amax(
                dim=1, keepdim=True)
            over = (err / step).max().item()
            if not bool((err <= step * (0.5 * (1 + 2 ** -14))).all()):
                fail(f"compression: {path} roundtrip error {over} of a "
                     f"block's step, over half")
            if not _same(torch, synced, rt):
                fail(f"compression: {path} dp_gradient_sync over one rank "
                     f"is not the roundtrip's bits")
            worst = max(worst, over)
            n = leaf.numel()
            elems += n
            blocks += -(-n // comp.block)
            del rt, synced
        peak = torch.cuda.max_memory_allocated()
        leaf = dict(leaves)[SPMD_BITS_LEAF]
        q, s = comp.quantize(leaf)
        qc, sc = comp.quantize(leaf.cpu())
    if not (torch.equal(q.cpu(), qc) and _same(torch, s.cpu(), sc)):
        fail(f"compression: {SPMD_BITS_LEAF}'s int8 codes or scales differ "
             f"from the CPU's")
    gb = n_bytes / 1e9
    payload = blocks * comp.block + 4 * blocks
    line("compression", {
        "leaves": len(leaves), "bytes": n_bytes, "block": comp.block,
        "roundtrip_ms_per_gb": round_s * 1e3 / gb,
        "dp_sync_ms_per_gb": sync_s * 1e3 / gb,
        "worst_err_over_block_step": worst,
        "payload_ratio": payload / (4 * elems),
        "compression_ratio_4": compression_ratio(4),
        "allreduce_int32_ratio": (4 * blocks * comp.block + 4 * blocks)
        / (4 * elems),
        "bits_leaf": SPMD_BITS_LEAF, "bits_equal_cpu": True,
        "peak_device_bytes": peak})


def phase_spmd(torch, seq_total: float):
    """Phase 15: the intra-op SPMD layer in a world of one NCCL rank
    (15a-15c), destroyed afterwards.  Returns the matmul launches and the
    flash forward and backward launches by route."""
    import gc
    import tempfile
    from repro_torch.parallel.mesh import destroy_world, init_world
    store = Path(tempfile.mkdtemp(prefix="chip-smoke-world-")) / "store"
    line("world", {"backend": init_world(0, 1, str(store), device="cuda"),
                   "ranks": 1})
    try:
        mm_launches = phase_mesh_executor(torch, seq_total)
        cfg, params, x, flash_launches = phase_pipeline(torch)
        train_fwd, flash_bwd_launches = phase_pipeline_train(torch, cfg,
                                                             params, x)
        del x
        flash_launches += train_fwd
        phase_compression(torch, params)
        del params
    finally:
        destroy_world()
    gc.collect()
    torch.cuda.empty_cache()
    return mm_launches, flash_launches, flash_bwd_launches


def phase_tp_serve(torch) -> collections.Counter:
    """Phase 16a: qwen2-7b at full width and depth (seed 0) served by phase
    9's argv with ``--tp 1`` in the world of one rank: the launcher's world
    path, its parameters DTensors on the (1, 1) mesh.  Its tokens must be
    phase 9's, and every flash launch (28 a prefill, all on phase 9's
    route, none a decode step) must go through ``kernels/sharded.py``.
    Returns the flash launches by route."""
    import gc
    from repro_torch.kernels import sharded
    from repro_torch.launch import serve
    ref = RESULTS[("serve", DENSE_ARCH)]
    cfg, params = phase_params(torch, DENSE_ARCH, DENSE_N_PARAMS)
    counters = _counters()
    argv = ["--arch", cfg.name] + SERVE_ARGS + ["--tp", "1"]
    for fn in counters.values():
        _reset(fn)
    sharded.local_calls.update(dict.fromkeys(sharded.local_calls, 0))
    torch.cuda.reset_peak_memory_stats()
    out = serve.main(argv, params=params)
    launches = {name: fn.launches for name, fn in counters.items()}
    routes = _check_routes(counters["flash_attention"], cfg, "16a serve")
    want = dict.fromkeys(counters, 0)
    want["flash_attention"] = _kernel_layers(cfg) * SERVE_PREFILLS
    local = dict(sharded.local_calls)
    if launches != want or local["flash_attention"] != \
            want["flash_attention"]:
        fail(f"16a: kernel launches {launches}, through kernels/sharded.py "
             f"{local}, expected {want}, all through kernels/sharded.py")
    tokens = {r.rid: r.out for r in out["finished"]}
    if tokens != ref["tokens"] or \
            out["traced_tokens"] != tokens[0][:3]:
        fail(f"16a: tokens {tokens} (traced {out['traced_tokens']}), "
             f"phase 9's {ref['tokens']}")
    decode_ms = 1e3 / out["decode_tok_s"]
    line("tp_serve", {
        "arch": cfg.name, "argv": argv, "mesh": [1, 1], "tokens_equal": True,
        "launches": launches, "launches_by_route": routes,
        "through_sharded": local,
        "wall_s": out["wall"], "ttft_p50_s": out["ttft_p50"],
        "decode_ms_per_step": decode_ms,
        "phase9": {k: ref[k] for k in ("wall_s", "ttft_p50_s",
                                       "decode_ms_per_step")},
        "peak_device_bytes": torch.cuda.max_memory_allocated()})
    del params, out
    gc.collect()
    torch.cuda.empty_cache()
    return _launch_routes(counters["flash_attention"])


def phase_tp_train(torch) -> dict:
    """Phase 16b: 11f's cell (falcon-mamba-7b at MAMBA_TRAIN_LAYERS layers,
    seed 0, TRAIN_STEPS steps of 2 x 2048 tokens) on the launchers' world
    path: the parameters laid out on the (1, 1) mesh by ``fsdp_tp``
    (``parallel.sharding.distribute_params``), ``make_train_step(cfg, opt,
    ctx)``.  Its losses must be 11f's kernel run's (bit for bit expected,
    each within TRAIN_LOSS_TOL of it at most), with 2 forward and 1
    backward scan launches a layer a step, all through
    ``kernels/sharded.py``.  Returns the scan's launches by wrapper."""
    import gc
    from repro_torch.core.placement import standard_rules
    from repro_torch.data.pipeline import SyntheticLMDataset
    from repro_torch.kernels import sharded
    from repro_torch.launch import steps
    from repro_torch.models import model_module
    from repro_torch.optim.schedules import cosine_schedule
    from repro_torch.parallel.mesh import launcher_mesh
    from repro_torch.parallel.sharding import (ShardingCtx,
                                               distribute_params, is_dtensor)
    from repro_torch.tree import tree_leaves
    ref = RESULTS[("train_full", ARCH)]
    cfg, n_params, _, n_batch, seq = _train_cell(ARCH)
    M = model_module(cfg)
    per_step = _train_kernels(cfg)
    kernels = list(per_step)
    ctx = ShardingCtx(launcher_mesh(1, "cuda"),
                      standard_rules("fsdp_tp", pod_axis=None))
    torch.cuda.reset_peak_memory_stats()
    params = distribute_params(M.init_params(cfg, 0, "cuda"),
                               M.logical_axes(cfg), ctx)
    leaves = tree_leaves(params)
    if not all(is_dtensor(t) for t in leaves) or \
            sum(t.numel() for t in leaves) != n_params:
        fail(f"16b: parameters not {n_params} DTensor entries")
    ds = SyntheticLMDataset(cfg.vocab_size, seq, n_batch, seed=0)
    opt = steps.make_optimizer(cfg, lr=cosine_schedule(TRAIN_LR, 1,
                                                       TRAIN_STEPS))
    state = opt.init(params)
    step = steps.make_train_step(cfg, opt, ctx)
    for fn in kernels:
        _reset(fn)
    sharded.local_calls.update(dict.fromkeys(sharded.local_calls, 0))
    losses, step_s = [], []
    for s in range(TRAIN_STEPS):
        batch = {k: torch.as_tensor(v, device="cuda")
                 for k, v in ds.batch_at(s).items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, metrics = step(params, state, batch)
        losses.append(metrics["total_loss"].item())
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    launched = {fn.__name__: fn.launches for fn in kernels}
    want = {fn.__name__: k * TRAIN_STEPS for fn, k in per_step.items()}
    local = dict(sharded.local_calls)
    if launched != want or local["ssm_scan"] != want["ssm_scan"] or \
            local["ssm_scan_backward"] != want["ssm_scan_backward"]:
        fail(f"16b: launches {launched}, through kernels/sharded.py {local}, "
             f"expected {want}, all through kernels/sharded.py")
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"])]
    if max(rel) > TRAIN_LOSS_TOL:
        fail(f"16b: losses {losses}, 11f's {ref['losses']}, relative "
             f"differences {rel} (limit {TRAIN_LOSS_TOL})")
    median_s = sorted(step_s[1:])[len(step_s[1:]) // 2]
    line("tp_train", {
        "arch": cfg.name, "layers": cfg.n_layers, "mesh": [1, 1],
        "rules": "fsdp_tp", "batch": n_batch, "seq": seq,
        "losses": losses, "losses_11f": ref["losses"],
        "bit_equal": losses == ref["losses"], "losses_rel_diff": rel,
        "loss_tol": TRAIN_LOSS_TOL, "launches": launched,
        "through_sharded": local, "step_s": step_s,
        "median_step_s": median_s, "tokens_per_s": n_batch * seq / median_s,
        "peak_device_bytes": torch.cuda.max_memory_allocated(),
        "phase11f": {"median_step_s": ref["median_step_s"],
                     "tokens_per_s": ref["tokens_per_s"],
                     "peak_device_bytes": ref["peak_device_bytes"]}})
    out = {fn.__name__: _launch_routes(fn) for fn in kernels}
    del params, state, metrics, step
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_tp(torch):
    """Phase 16: the launchers' world path (``--tp``) in a new world of one
    NCCL rank, destroyed afterwards: 16a (``phase_tp_serve``), 16b
    (``phase_tp_train``) and 16c: ``--tp 2`` in the world of one raises
    ``ValueError`` in both launchers.  Returns the flash launches by route
    and the scan's forward and backward launches by route."""
    import tempfile
    from repro_torch.launch import serve, train
    from repro_torch.parallel.mesh import destroy_world, init_world
    store = Path(tempfile.mkdtemp(prefix="chip-smoke-tp-")) / "store"
    line("world", {"backend": init_world(0, 1, str(store), device="cuda"),
                   "ranks": 1, "phase": 16})
    try:
        flash = phase_tp_serve(torch)
        scan = phase_tp_train(torch)
        refused = {}
        for name, launcher in (("serve", serve), ("train", train)):
            try:
                launcher.main(["--arch", DENSE_ARCH, "--reduced", "--tp",
                               "2"])
            except ValueError as e:
                refused[name] = str(e)
        if set(refused) != {"serve", "train"}:
            fail(f"16c: --tp 2 in a world of one raised only in "
                 f"{sorted(refused)}")
        line("tp_refusal", refused)
    finally:
        destroy_world()
    return flash, scan


def main() -> int:
    import gc

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from the "
              f"root of a checkout", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    # the plain versions are IEEE float32 references: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    name = phase_device(torch)
    phase_build()
    checks = phase_kernels(torch)
    launches, graph, seq = phase_main_path(torch, checks)
    launches += phase_process_path(torch, graph, seq)
    launches += phase_gateway_path(torch, graph, seq)
    launches += phase_runtime_path(torch, graph, seq)
    seq_total = seq[graph.outputs[0]]
    del seq
    torch.cuda.empty_cache()
    scan_checks = phase_scan_kernels(torch)
    profile = "--profile" in sys.argv[1:]
    # the two parameter sets (29 GB and 30.5 GB) are on the card one at a
    # time
    scan_launches = phase_model(torch, ARCH, N_PARAMS, profile)
    flash_checks = phase_flash_kernels(torch)
    flash_launches = phase_model(torch, DENSE_ARCH, DENSE_N_PARAMS, profile)
    # phase 11, training: qwen2-7b's serving parameters are freed by now;
    # phase 17's dry-runs run beside 11a and 11b, on the host's cores
    dryruns = phase_dryrun_start()
    grad_checks = phase_train_grads(torch)
    launcher = phase_train_launcher(torch)
    phase_dryrun_join(dryruns)
    flash_bwd_launches = collections.Counter()
    for run in (launcher, phase_train_full(torch, profile=profile)):
        flash_launches += run["flash_attention"]
        flash_bwd_launches += run["flash_attention_backward"]
    # 11d-11f: Mamba1 training, through the scan's backward kernel
    scan_grad_checks = phase_scan_grads(torch)
    bwd_launches = collections.Counter()
    for run in (phase_train_launcher(torch, ARCH),
                phase_train_full(torch, ARCH, profile)):
        scan_launches += run["ssm_scan"]
        bwd_launches += run["ssm_scan_backward"]
    # phase 12: the Mamba2 hybrid, the flash kernel at its 13 sites
    gc.collect()
    torch.cuda.empty_cache()
    flash_launches += phase_hybrid(torch, profile)
    # phase 12b: zamba2-7b trained, flash at its 4 shared-attention sites
    run = phase_train_full(torch, HYBRID_ARCH, profile)
    flash_launches += run["flash_attention"]
    flash_bwd_launches += run["flash_attention_backward"]
    # phase 13: MoE, the flash kernel at 48 and 40 heads over 8 kv heads
    gc.collect()
    torch.cuda.empty_cache()
    flash_launches += phase_cells(torch, MOE_CELLS, profile)
    # phase 13b: dbrx-132b trained under Adafactor
    run = phase_train_full(torch, MOE_TRAIN_ARCH, profile)
    flash_launches += run["flash_attention"]
    flash_bwd_launches += run["flash_attention_backward"]
    # phase 18: the dense configurations no earlier phase serves (MQA, GQA
    # 8, qk_norm, the VLM's backbone), then 18b and 18c: granite-20b (MQA)
    # and qwen3-14b (qk_norm) trained
    gc.collect()
    torch.cuda.empty_cache()
    flash_launches += phase_cells(torch, SERVE_CELLS, profile)
    for arch in (a for a, c in TRAIN_CELLS.items() if c.phase[:2] == "18"):
        run = phase_train_full(torch, arch, profile)
        flash_launches += run["flash_attention"]
        flash_bwd_launches += run["flash_attention_backward"]
    # phase 14: the encoder-decoder and the VLM, trained at full width
    gc.collect()
    torch.cuda.empty_cache()
    encdec_flash, encdec_bwd = phase_encdec(torch, profile)
    flash_launches += encdec_flash
    flash_bwd_launches += encdec_bwd
    # phase 15: intra-op SPMD in a world of one NCCL rank
    gc.collect()
    torch.cuda.empty_cache()
    spmd_matmul, spmd_flash, spmd_flash_bwd = phase_spmd(torch, seq_total)
    launches += spmd_matmul
    flash_launches += spmd_flash
    flash_bwd_launches += spmd_flash_bwd
    # phase 16: the launchers' world path (--tp 1) in a world of one rank
    gc.collect()
    torch.cuda.empty_cache()
    tp_flash, tp_scan = phase_tp(torch)
    flash_launches += tp_flash
    scan_launches += tp_scan["ssm_scan"]
    bwd_launches += tp_scan["ssm_scan_backward"]

    def entry(kernel, source, replaces, launches, routes, check, all_checks):
        return {"name": kernel, "route": "cuda",
                "source": f"src/repro_torch/kernels/csrc/{source}",
                "replaces": replaces, "launches": launches,
                "launches_by_route": dict(routes),
                "kernel_route": check.get("route", "simt"),
                **({"kernel_variant": check["variant"]}
                   if "variant" in check else {}),
                "max_abs_err": check["max_abs_err"], "ms": check["ms"],
                "plain_ms": check["plain_ms"], "bound_ms": check["bound_ms"],
                "bound_by": check["bound_by"],
                "library_ms": check["library_ms"], "shape": check["shape"],
                "dtype": check["dtype"], "checks": all_checks}

    main_check = next(c for c in checks
                      if c["dtype"] == "float32" and c["shape"] == [SIZE] * 3)
    # the Mamba1 path's most launched shape: one decode step from the cache
    decode_check = next(c for c in scan_checks
                        if c["dtype"] == "float32" and c["shape"][1] == 1)
    # the dense path's longest launches: the long prefill in bf16 (tensor
    # cores) and in float32 (CUDA cores)
    long_checks = {c["route"]: c for c in flash_checks
                   if c["shape"][:4] == [1, 28, 4, LONG_PROMPT]
                   and c["aligned"]}
    # the backward kernel's headline: falcon-mamba-7b's training step
    train_scan_check = next(c for c in scan_grad_checks
                            if c["shape"][:2] == [TRAIN_BATCH, TRAIN_SEQ])
    # the flash backward kernels' headline: qwen2-7b's training attention
    # (11c) in bf16 (tensor cores) and float32 (CUDA cores); each entry's
    # numbers are the backward kernel's alone
    flash_bwd_checks = [
        {**{k: c[k] for k in ("shape", "causal", "dtype", "route")},
         **c["backward"],
         **{f"function_{k}": c[k] for k in ("rel_err", "ms", "plain_ms",
                                            "library_ms", "bound_ms")}}
        for c in grad_checks]
    train_flash = {c["route"]: c for c in flash_bwd_checks
                   if c["shape"] == [TRAIN_BATCH, 28, 4, TRAIN_SEQ,
                                     TRAIN_SEQ, 128]}
    # flash_attention: the wrapper's launches on both routes, headed by the
    # tensor-core kernel of the bf16 long prefill, as in earlier runs;
    # flash_attention_simt: the CUDA-core kernel and its own launches
    flash = "src/repro/kernels/flash_attention.py:76"
    kernels = [
        entry("matmul", "matmul.cu", "src/repro/kernels/matmul_pallas.py:45",
              launches, {"simt": launches}, main_check, checks),
        entry("ssm_scan", "ssm_scan.cu", "src/repro/kernels/ssm_scan.py:48",
              scan_launches["simt"], scan_launches, decode_check,
              scan_checks),
        # the TPU kernel has no backward: the JAX package differentiates
        # its jnp scan, selective_scan
        entry("ssm_scan_backward", "ssm_scan_bwd.cu",
              "src/repro/models/ssm.py:74", bwd_launches["simt"],
              bwd_launches, train_scan_check, scan_grad_checks),
        {**entry("flash_attention", "flash_attention_wgmma.cu", flash,
                 sum(flash_launches.values()), flash_launches,
                 long_checks["wgmma"], flash_checks),
         "design": "redesigned: persistent blocks over one heaviest-first "
                   "unit list, FA3's in-warpgroup overlap under a "
                   "two-consumer ping-pong, a TMA-stored epilogue"},
        entry("flash_attention_simt", "flash_attention.cu", flash,
              flash_launches["simt"], {"simt": flash_launches["simt"]},
              long_checks["simt"], flash_checks),
        # the TPU kernel has no backward: the JAX package differentiates
        # its attention, attention_scores, through XLA
        {**entry("flash_attention_backward", "flash_attention_bwd_wgmma.cu",
                 "src/repro/models/layers.py:166",
                 sum(flash_bwd_launches.values()), flash_bwd_launches,
                 train_flash["wgmma"], flash_bwd_checks),
         "design": "redesigned: one heaviest-first launch of the dK/dV and "
                   "dQ units after the delta pre-pass"},
        {**entry("flash_attention_backward_simt", "flash_attention_bwd.cu",
                 "src/repro/models/layers.py:166",
                 flash_bwd_launches["simt"],
                 {"simt": flash_bwd_launches["simt"]}, train_flash["simt"],
                 flash_bwd_checks),
         "design": "redesigned: one heaviest-first launch of the dK/dV and "
                   "dQ units; two 256-thread teams a block, each streaming "
                   "its steps' tiles by cp.async into its stage"}]
    if not all(k["launches"] for k in kernels):
        fail(f"a kernel of the main path never launched: "
             f"{[(k['name'], k['launches']) for k in kernels]}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
