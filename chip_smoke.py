#!/usr/bin/env python3
"""Prove that the PyTorch/CUDA port (``src/repro_torch``) runs on one H100.

  python3 chip_smoke.py            # phases 1-5 and 7-22; one CUDA card
  python3 chip_smoke.py --profile  # and phase 6 and the traced engine run
  python3 chip_smoke.py --out DIR  # phase 8's traces and metrics in DIR

Six paths (and the MoE family's, phase 9, the hybrid family's, phase 10,
the encoder-decoder family's, phase 11, and the vision family's, phase
12), each at a model's full width and depth with random weights:
the static server on qwen1.5-4b (dense; the fat GEMM and GEMV kernels) and
on rwkv6-3b (RWKV-6; the same two and the WKV kernel), the paged
continuous-batching engine on qwen1.5-4b, the W8A8 int8 path
(``--quantize int8``: weights quantized once at load, every GEMM int8 x
int8 on the fat GEMM) through the static server and through the engine
with an int8 KV pool (``--kv-quantize int8``), and the engine decoding
speculatively (``--spec-draft-config qwen1.5-4b --spec-k 4``: an int8
draft proposes, the float target verifies). Every decode step and engine
step runs as a captured CUDA graph. Phases, in order; any failure
ends the run with a non-zero exit:

1. environment: card name and power limit, torch and CUDA versions,
   compute capability (9, 0) required; TF32 off for the plain versions;
2. build: the three CUDA sources under ``src/repro_torch/kernels/csrc``
   with nvcc, in parallel;
3. kernels: each kernel at its path's shapes (batch 4, prompt 128) against
   its plain PyTorch version on the same inputs, with its time, its bound,
   the plain version's time and one library call's time where there is
   one (3a: the GEMMs, each with the route the wrapper picks and its bound
   at that route's rate (int8 inputs at the int8 peak), the GEMV's with
   its K splits, the W8A8 path's int8 x int8 col cases with its
   epilogues at every shape its paths give the fat GEMM (split_k at M <=
   32, tensor_core_int8 above; held exactly), the speculative engine's
   verify pass at 40 rows and its int8 draft's admission, then a sweep of
   untimed GEMV cases over every dtype pair, layout, 1..128 rows and both
   routes; 3b: WKV through both wrappers, each case with the slice width,
   blocks and load route its wrapper picks, the path cases at both slice
   widths, and the layout copies the path no longer makes);
4. path (4a qwen1.5-4b, 40 layers; 4b rwkv6-3b, 32 layers; 4c qwen1.5-4b
   with --quantize int8): ``repro_torch.launch.serve --arch ARCH --batch 4
   --prompt-len 128 --gen 16`` with the plan warm-up; zero lazy solves,
   and launch counts (eager calls plus graph replays) equal to what the
   dispatch rule implies, counted from 0 for each path (4c: 17 x (7 x 40
   + 1) fat GEMMs, no GEMV), peak device memory (4c: and the seconds to
   quantize at load); then the decode step run eagerly and as a
   CUDA-graph replay from one state: step ms and tok/s of each, and the
   replay's logits and state equal to the eager step's bit for bit;
5. kernel path against plain path (5a qwen, 5b rwkv; 5c, 5d the same with
   int8 weights): the config cut to 2 layers, prefill plus 4 decode steps
   on the card and on the CPU from the same weights, logits held to a
   stated tolerance (rwkv's 128-token prefill takes the WKV kernel); 5c,
   5d also run the path on the card with the fat GEMM's plain version in
   matmul.cu's place: logits and state equal to the kernel path's bit for
   bit; 5e: qwen1.5-4b at 2 layers on a paged state after one prefill
   chunk a lane, ``verify_step`` over k + 1 = 5 tokens against 5 paged
   decode steps fed the same tokens, on the bf16 and the int8 pool:
   logits within PATH_TOL (int8 pool: INT8_KV_VERIFY_TOL) and equal
   lengths;
6. with ``--profile`` only: each phase 4 path again with everything warm,
   prefill and decode steps timed with CUDA events, then once more under
   ``torch.profiler``: device time by kernel, the fat GEMM's by route, the
   GEMV's by kernel name (one kernel launch per call, or the run fails),
   WKV's with the kernels beside each launch (no copy, or the run fails),
   and the device's idle share; for the eager decode step and for its
   CUDA-graph replay, the breakdown from the replayed run; 6c the int8
   static path: the fat GEMM by instantiation (split_k, tensor_core_int8),
   and the decode step's device time (its replays traced) split into the
   fat GEMM, the two quantizers (281 activation quantizations, the f32
   unembed re-quantized every step; each captured as a CUDA graph at the
   step's shapes and traced) and the rest;
7. engine path: ``repro_torch.launch.serve --arch qwen1.5-4b --engine
   --num-slots 8 --kv-block-size 16 --prefill-chunk 128 --prompt-len 128
   --gen 16`` (16 requests of prompt 128, 64 and 96): every request
   finishes with in-vocab ids, zero lazy solves and misses, launches equal
   to the dispatch rule for the ticks and chunks that ran; a warm rerun
   with the decode tick timed (and, with ``--profile``, a traced one:
   idle share); one decode tick and one prefill chunk of each bucket,
   replayed, equal to the same step run eagerly, bit for bit (the int8
   pool's blocks and scales included, the null block too);
7b. the same engine with ``--quantize int8 --kv-quantize int8`` at phase
   7's 74 blocks: the same checks (281 fat GEMMs a step, no GEMV), the
   ``kv_cache`` section (16-token int8 blocks of 3,283,200 bytes against
   6,553,600 bf16 over 40 layers, the pool's bytes against phase 7's, the
   int8 blocks the same bytes hold, the scale gauges), and the share of
   token positions equal to phase 7's, printed and not gated (near-tie
   argmaxes flip at full depth with random weights);
7c. phase 7's engine with ``--spec-draft-config qwen1.5-4b --spec-k 4``
   (the draft int8): in-vocab finishes, zero lazy solves and misses,
   launches equal to the dispatch rule (a verify pass like a tick, a draft
   step 280 fat GEMMs and 1 GEMV, k + 1 of them a propose step), the
   speculation section's committed tokens equal to the tokens generated
   less one a request, and the verify, propose and draft-admit graphs
   replayed against their eager steps bit for bit; printed: acceptance,
   tokens a round, a warm rerun's tok/s, TTFT and round time on the card
   split into propose and verify, peak memory, the tokens equal to phase
   7's (and with ``--profile`` a traced rerun);
8. the flight recorder, the balance auditor and measured plans (8a: phase
   7's engine with ``--trace-out`` and ``--metrics-interval-ticks 8``;
   8b: 7c's the same): the trace validates (the port's own
   ``validate_chrome_trace``), ``PHASES`` covers every span, every tick
   has its expire, bind and step spans, the attribution reconciles (0
   within 1e-9), zero lazy solves, launches equal to the rule, the tokens
   equal to the untraced run's, replays equal to eager steps; 8b also the
   ``serve_spec`` gauges against the speculation section. Printed from a
   warm traced rerun: host and device ms by phase (p50 / p99 of a span,
   total a tick), the engine's host share, and the top GEMM signatures'
   measured seconds a call against the ``h100`` model's. 8c: phase 7's
   engine with ``--measure-plans --rebalance-drifted`` in its own context
   and plan cache: every (signature, launched plan) the refinement timed
   held to the plain version at 3a's tolerance, the refined cache
   round-tripped through its JSON, zero lazy solves, the rule, a valid
   trace, replays equal to eager; printed: measured / refined / kept, old
   -> new kernel ms of each refined signature (and the GEMV's at both
   plans where the key is skinny), the decode tick before and after. The
   traces, metrics and the refined plans go to ``build/phase8/`` (or
   ``--out DIR``).

9. the MoE family, olmoe-1b-7b at its full width and depth (16 layers,
   64 experts of 1024, top-8, d 2048, f32 weights, bf16 activations):
   9a the static path (``--arch olmoe-1b-7b``) and 9b with ``--quantize
   int8``, phase 4's gates (launches: the router on the fat GEMM at every
   M; 9b 17 x (5 x 16 + 1) fat GEMMs, no GEMV), the decode step eager
   against replayed, and its device time split into the fat GEMM, the
   GEMV, the expert tables' cast at every call (9b: their
   dequantization), the expert products and the rest; 9c, 9d phase 5's
   card against CPU at 2 layers, and the stack run layer by layer from
   the CPU's input to each layer: a token whose top-8 set differs on the
   card may do so only where the CPU's gap between its 8th and 9th
   probability is at most SWAP_GAP, each layer's output, dispatched by
   the CPU's verdict, is held to PATH_TOL (INT8_PATH_TOL), and so are the
   end-to-end logits that no swap reaches; 9e, 9f phase 7's engine and
   7b's on olmoe, the pool's bytes a block olmoe's; 9g 7c's speculative
   engine on olmoe (the draft olmoe at int8; the verify pass at 8 x 5 =
   40 rows), its launch rule and replays.
10. the hybrid family, zamba2-1.2b at its full width and depth (38 Mamba-2
   layers, d 2048, d_inner 4096, 64 SSM heads of 64, d_state 64, the
   shared attention + MLP block at every 6th layer, vocab 32,000): 10a
   the static path and 10b with ``--quantize int8``, phase 4's gates
   (launches: 38 x 2 Mamba projections, 7 shared-block calls of 7 GEMMs,
   the unembed), the decode step eager against replayed, the eager
   prefill's ms (beside 1,077.45 ms, the same prefill when the SSM scan
   looped over the tokens) and the share of it the chunked SSM scan takes (the
   prefill again with the scan stubbed); 10c, 10d phase 5's card against CPU at 4
   layers with the shared block every 2, and the stack layer by layer
   from the CPU's input to each layer (each layer's output and the head
   within the tolerance), beside the CPU path's own spread (its embedding
   table x (1 + 2**-20)); 10d also the plain fat GEMM's path bit for bit,
   its end-to-end logits printed, not gated (the CPU's own spread exceeds
   INT8_PATH_TOL).
11. the encoder-decoder family, whisper-base at its full width and depth
   (6 + 6 layers, d 512, 1,500 frames, tied vocab 51,865 padded to
   51,968): 11a the static path (frames drawn after the prompts, as the
   launcher draws them), 11b the whole model on the card against the CPU,
   11c the int8 path: phase 4's gates and 10d's checks.
12. the vision family, llama-3.2-vision-11b at its full width and depth
   (40 layers in 8 groups of 4 self layers and 1 tanh-gated cross layer,
   d 4096, 32 heads and 8 kv heads of 128, d_ff 14336, 1,600 image
   tokens, vocab 128,256; 9.78 B f32 parameters, 39.1 GB): 12a the static
   path (image embeddings drawn after the prompts, as the launcher draws
   them) and 12b with ``--quantize int8``, phase 4's gates (launches: 7 fat
   GEMMs a layer at prefill; a step 56 fat GEMMs, of them the 16 cross K/V
   at M = 4 x 1600, and 225 GEMVs; int8 281 fat GEMMs each), the decode
   step eager against replayed, the cross K/V's device ms a step and
   share, the eager prefill, the peak memory; 12c, 12d phase 5's card
   against CPU with nonzero gates from the seed, cross_attn_every 2:
   12c at 4 layers (two groups of a self layer and the cross layer), 12d
   at 2 (one group; cut to keep the script's time)
   (the reference's init zeroes them, and a cross layer then adds
   nothing), the stack layer by layer from the CPU's input to each layer
   (each layer's output and the head within the tolerance), beside the
   CPU path's own spread; the end-to-end logits printed, not gated (the
   CPU's own spread exceeds both tolerances); 12d also the plain fat
   GEMM's path bit for bit.
13. training, qwen1.5-4b at its full width and depth (3,950,369,280 f32
   parameters, AdamW, remat on): 13a the backward's GEMMs at 13b's shapes
   (dA = dC . W^T with W read in the other layout, dB = A^T . dC, the silu
   gate's recomputed pre-activation; the f32 cotangents' dA on the CUDA
   cores) against their plain versions with their times, bounds and
   ``torch.mm``'s, and the GEMM wrappers (the fat GEMM's, the GEMV's)
   raising, not launching, on a CUDA tensor that requires grad; 13b ``train.trainstep.make_train_step`` at batch 8 x 128 from
   ``data.synthetic`` (seed 0), 5 steps: finite losses, every parameter
   leaf's gradient finite and nonzero after step 1, zero lazy solves
   after step 1, fat-GEMM and GEMV launches a step equal to the dispatch
   rule for the forward, the recompute and the backward (1,164 fat, no
   GEMV), peak device memory under 75 GiB; printed: step 1's and the
   median step's CUDA-event ms split into forward + backward and the
   optimizer, beside the bound, and a traced step's busy share; 13c the
   step on the card against the CPU at 2 layers, 3 steps at 1 x 136 and 1
   x 64 (the GEMV forward and its dA): each loss, each leaf's step-1
   gradient and the 3 steps' updates within tolerances stated
   beforehand (in a process of its own: its card runs before 14a, its
   CPU runs beside 13d and phase 14, its output after 14d); 13d
   ``python -m repro_torch.launch.train --arch
   qwen1.5-4b --smoke`` for 30 steps with a checkpoint every 10, then to
   40: it resumes at step 30 and the mean loss of its last 5 steps is
   below that of the first 5.
14. distribution at world size 1 (a 1 x 1 (data, model) mesh over nccl
   in the script's own process: NCCL takes one rank a GPU; the 4 x 2
   semantics are held on the CPU by tests/test_torch_distributed.py): 14a
   ``core.distributed.output_stationary_gemm`` (with 3a's bias and silu
   epilogues) and ``k_sharded_gemm`` at qwen's prefill shapes (q/k/v +
   bias 512x2560x2560, gate + silu 512x2560x6912, bf16 x f32) against the
   fat kernel's plain version at 3a's tolerance, one fat-GEMM launch a
   call, 0 collective bytes, their ms beside the kernel called directly;
   14b ``parallel.pipeline.pipeline_apply`` with one stage and 4
   microbatches of tanh(x @ w) through balanced_gemm, bit for bit against
   the sequential products, one launch a microbatch; 14c ``python -m
   repro_torch.launch.train --mesh 1x1`` at qwen1.5-4b's full width and
   depth, 13b's batch 8 x 128 (seed 0), 3 steps, no checkpoint: the step
   ms (median of steps 2-3), the peak memory, the fat-GEMM launches a step
   (13b's rule, 1,164) and the collective bytes (0); the same launcher
   under ``torchrun --nproc-per-node 1`` on the smoke config (nccl over
   env://); then 4 layers at full
   width, 2 steps, through make_train_step(mesh=1x1) and
   make_train_step(mesh=None): losses and parameters bit for bit; 14d
   ``launch.dryrun`` on one cell (qwen1.5-4b x train_4k x 16x16) on the
   meta device and its ``roofline.report`` row (h100), without JAX.
15. tensor parallelism over 'model' with two ranks on the one card: a (1,
   2) (data, model) mesh over gloo (``--backend gloo``: each collective
   staged through host memory, the products on the kernels), one process
   a rank under ``torchrun --nproc-per-node 2`` (phases 15-19's and 21's
   9 such jobs start together, MESH_SLOTS at a time, beside this
   process's one-device yardsticks; the launch.serve runs of a phase share
   one job, 17c and 15b aside): 15a ``launch.serve
   --mesh 1x2`` at qwen1.5-4b's full width, 2 layers (4 x 128, 16
   tokens) against the same path at 1 x 1: the prefill's logits, the
   greedy tokens (12c's rule), both ranks' tokens equal, each rank's
   launches (phase 4a's rule at the local shapes), zero lazy solves, the
   collective bytes of the prefill and of a decode step against the dry
   run's, each rank's peak memory beside the one-device peak, the step
   ms; 15b ``launch.train --mesh 1x2 --n-layers 2`` at 13b's batch, 2
   AdamW steps, against make_train_step(mesh=None) on the card (losses,
   gradient norms, updates, collective bytes against the dry run's); 15c
   the dry run's qwen1.5-4b x train_4k x 16x16 model-FLOPs ratio (at
   least 0.4) and decode_32k's collective bytes (nonzero).
16. the serving engines over the same (1, 2) mesh: 16a phase 7's engine
   through ``launch.serve --engine --mesh 1x2`` at full width, cut to 2
   layers, against the same engine on one device in this process: both
   ranks' tokens and admissions equal, the tokens equal to the one
   device's before each near-tie, each rank's launches phase 7's rule at
   the local shapes and depth, zero lazy solves, each tick's and chunk's
   collective bytes the dry run's (``launch.dryrun.engine_cells``), a
   rank's pool half the one device's, each request's first-token logits
   within PATH_TOL; 16b phase 7c's speculative engine with a float draft
   of the target's config, both at 2 layers: the same gates, the ranks'
   speculation sections equal. Printed: a rank's peak, the eager steps'
   host ms, the acceptance beside the one device's.
17. expert parallelism: olmoe-1b-7b over a (2, 1) (data, model) mesh, two
   ranks on the one card over gloo (the first DP extent above 1 here:
   the attention leaves' FSDP gathers staged through host memory), the
   ranks building the model one at a time: 17a ``launch.serve --mesh
   2x1`` at full width and 2 layers (4 x 128, 16 tokens) against the same
   path on one device with ``moe_ep_plain`` over 2 shards (the mesh's
   semantics): both ranks' tokens equal, the tokens equal before each
   near-tie, the first-token logits within PATH_TOL, each rank's launches
   9a's rule at the local shapes and the cut depth, zero lazy solves, the
   prefill's and each decode step's collective bytes by kind the dry
   run's; 17b phase 9e's paged engine
   over the same mesh at 2 layers: the ranks' tokens and admissions
   equal, the bytes, the pool, the launch rule (the tokens against one
   device printed); 17c one MoE layer at full width on the two ranks at
   the prefill's and the decode's rows, each rank's output within 2^-7
   of 1 + |y| of ``layers.moe.moe_ep_plain`` on the card. Printed: each
   rank's load and serving peaks beside the one device's;
18. int8 over 'model' on phase 15's (1, 2) mesh at 2 layers: 18a the
   static server with ``--quantize int8`` (W8A8 column- and row-parallel,
   the row-parallel products' int32 partials summed over 'model'), 18b
   the paged engine with ``--quantize int8 --kv-quantize int8`` (the int8
   pool over 'model'): each against the same path
   on one device (first logits within PATH_TOL, tokens to the first
   near-tie, the ranks equal), zero lazy solves, every product on the fat
   GEMM, the bytes by kind the float step's dry-run cell's plus the W8A8
   scales' ``scale_max``, 18b's pool half; 3a holds the 'model' blocks.
19. the static server over phase 15's (1, 2) mesh for the other
   families, tensor-parallel inside their own layers: 19a rwkv6-3b at 2
   layers (its time-mix on a rank's 20 heads, the WKV kernel on (4, 128,
   20, 64), the channel-mix's FFN split; the WKV state's key-dim block
   taken to a rank's heads and back by an all-to-all), 19b zamba2-1.2b at
   2 layers (layer 0 carries the shared block; Mamba-2 on a rank's 32 SSM
   heads, one product with w_in's stored block and its outputs
   all-gathered, the gated norm's sum of
   squares all-reduced, the conv state whole on both ranks), 19c
   whisper-base whole, 19d llama-3.2-vision-11b at 5 layers (one group:
   its 4 self layers and its cross layer; nonzero gates would need the
   reference's init, which zeroes them). Each through ``launch.serve
   --mesh 1x2`` (4 x 128, 16 tokens) against the same path on one device
   in this process, 15a's gates: the first logits within PATH_TOL, the
   tokens to the first near-tie, the ranks equal, zero lazy solves, each
   rank's launches the one-device rule at the local shapes (whisper's
   decoder MLP out, row-parallel, loses its bias to the sum and moves to
   the GEMV), the prefill's and each decode step's bytes by kind the dry
   run's; each rank's peak beside the one device's. 3a holds the local
   GEMM and GEMV shapes, 3b the WKV kernel on a rank's 20 heads.
20. training the rwkv, hybrid, encoder-decoder, vision and MoE families
   (the WKV backward kernel, 20a-20d).
21. serving over a mesh with nothing refused: 21a-21d phase 19's four
   jobs with ``--quantize int8`` (W8A8 inside RWKV-6's time-mix and
   channel-mix, Mamba-2's stored ``w_in`` block, whisper's encoder and
   decoder, the vision model's gated cross layers), each against the same
   path on one device in this process with 15a's gates, its family's int8
   launch rule and its ``scale_max`` (one 4-byte MAX a row-parallel
   product); qwen1.5-4b at 2 layers over a (1, 3) mesh, three gloo ranks
   on the card: 'model' = 3 divides neither its 20 kv heads nor head_dim
   128, so 21e's static server (``--gen 15``: max_len 144, which 3
   divides) lays its cache's sequence over 'model' (each rank writes the
   positions it holds, the softmax normalized over 'model') and
   21f's paged engine keeps its pool whole on every rank; 21e against
   15a's one-device record (its first 15 steps), 21f against 16a's, with
   the same gates (21f's pool whole), and 21e's decode steps' logits on
   each row's equal tokens within PATH_TOL too. 3a holds the local
   shapes.
22. training what was left: 22a zamba2-1.2b at its full width and depth
   (38 Mamba-2 layers, the shared block every 6th) through the launcher,
   remat on, AdamW, 1 x 4096 (train_4k's sequence: 4 groups of 16 SSM
   chunks of 64 tokens a layer), 2 steps: finite losses, 20d's gates;
   printed: step ms, peak, and what one Mamba layer under grad at 1 x
   4096 saves for its backward (``saved_tensors_hooks``): one SSM state a
   group against the reference's one a chunk; 22b ``remat_policy="dots"``
   at 13b's shape (qwen1.5-4b, 40 layers, 8 x 128, AdamW): step 1's loss
   and every leaf's gradient against "full" remat's on the same inputs
   (deterministic algorithms on) within DOTS_TOL of the leaf's peak (0
   expected; where they differ, a second "full" run's spread is printed
   and gates instead), each policy's launches a step its rule (dots:
   13b's less the layers' recomputed products, 280), step ms and peak of
   both. Alone on the card.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Imports neither jax nor repro.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12            # H100 SXM data sheet
PEAK_OPS = {"float32": 67e12,        # f32 on the CUDA cores (data sheet)
            "bfloat16": 989e12,      # bf16 tensor cores, dense (data sheet)
            "int8": 1979e12}         # int8 tensor cores, dense (data sheet)

BATCH, PROMPT, GEN = 4, 128, 16
# launches the dispatch rule (core/gemm.py: GEMV when M <= 128, K >= 256,
# N >= 128 and no epilogue) implies for each path, 16 decode steps:
# * qwen1.5-4b (qkv bias, SwiGLU), 40 layers: prefill 7 fat GEMMs a layer
#   + the last-token unembed on the GEMV; decode q, k, v (bias) and gate
#   (silu) fat, wo, w_in, w_out + unembed GEMV;
# * rwkv6-3b, 32 layers: prefill 11 fat GEMMs a layer (lora_a, w_lora_a,
#   w_lora_b, r, k, v, g, o, cmix wk + relu, wv, wr) + the unembed GEMV and
#   one WKV launch a layer (T = 128 takes the chunk branch); decode 3 fat
#   (w_lora_a N = 32, w_lora_b K = 32, cmix wk + relu) and 8 GEMVs a layer
#   + the unembed, and no WKV launch (T = 1 is the token scan)
# * qwen1.5-4b int8 (--quantize int8): every GEMM carries out_scale, so
#   every one takes the fat GEMM (split_k at M = 4, tensor_core_int8 at
#   M = 512): 7 a layer and the unembed (its f32 weight re-quantized at
#   every call, the dynamic path), at prefill and at each decode step
# * phase 14 on a 1 x 1 mesh: a distributed GEMM launches its one local
#   product (M = 512: the fat GEMM, with or without an epilogue); the
#   pipeline one a microbatch; the sharded train step 13b's rule
#   (_train_rule: 1,164 fat GEMMs a step at 8 x 128, no GEMV), as the
#   gathers and reductions of a 1 x 1 mesh are no-ops
PATHS = {
    "qwen1.5-4b": {"arch": "qwen1.5-4b", "args": [], "vocab": 151936,
                   "want": {"matmul": 7 * 40 + GEN * 4 * 40,
                            "gemv": 1 + GEN * (3 * 40 + 1), "wkv": 0}},
    "rwkv6-3b": {"arch": "rwkv6-3b", "args": [], "vocab": 65536,
                 "want": {"matmul": 11 * 32 + GEN * 3 * 32,
                          "gemv": 1 + GEN * (8 * 32 + 1), "wkv": 32}},
    "qwen1.5-4b int8": {"arch": "qwen1.5-4b", "args": ["--quantize", "int8"],
                        "vocab": 151936,
                        "want": {"matmul": (GEN + 1) * (7 * 40 + 1),
                                 "gemv": 0, "wkv": 0}},
    # olmoe-1b-7b (64 experts of 1024, top-8, no qkv bias), 16 layers: the
    # router (2048 x 64 experts, f32 x f32: N = 64 < 128, never the GEMV)
    # takes the fat GEMM at every M; q, k, v, wo the fat GEMM at prefill
    # (M = 512) and the GEMV at decode (M = 4), then the unembed GEMV; the
    # expert products are batched matmuls outside the kernels, as the
    # reference's einsums are outside its Pallas kernels
    "olmoe-1b-7b": {"arch": "olmoe-1b-7b", "args": [], "vocab": 50304,
                    "want": {"matmul": 5 * 16 + GEN * 16,
                             "gemv": 1 + GEN * (4 * 16 + 1), "wkv": 0}},
    # int8: q, k, v, wo, the dynamic router and the dynamic unembed, every
    # one with out_scale on the fat GEMM, at prefill and each decode step
    "olmoe-1b-7b int8": {"arch": "olmoe-1b-7b",
                         "args": ["--quantize", "int8"], "vocab": 50304,
                         "want": {"matmul": (GEN + 1) * (5 * 16 + 1),
                                  "gemv": 0, "wkv": 0}},
    # zamba2-1.2b (no qkv bias, SwiGLU shared MLP), 38 Mamba layers (w_in
    # 2048 -> 8384, w_out 4096 -> 2048) and 7 shared-block calls (layers 0,
    # 6, ..., 36; q, k, v, wo, gate, w_in, w_out): prefill all 2 x 38 + 7 x
    # 7 on the fat GEMM, the last-token unembed on the GEMV; decode the
    # shared block's gate (silu) fat, every other projection and the
    # unembed on the GEMV
    "zamba2-1.2b": {"arch": "zamba2-1.2b", "args": [], "vocab": 32000,
                    "want": {"matmul": 2 * 38 + 7 * 7 + GEN * 7,
                             "gemv": 1 + GEN * (2 * 38 + 7 * 6 + 1),
                             "wkv": 0}},
    "zamba2-1.2b int8": {"arch": "zamba2-1.2b",
                         "args": ["--quantize", "int8"], "vocab": 32000,
                         "want": {"matmul": (GEN + 1) * (2 * 38 + 7 * 7 + 1),
                                  "gemv": 0, "wkv": 0}},
    # whisper-base (qkv and MLP biases, gelu, tied unembed), 6 encoder and
    # 6 decoder layers: prefill the encoder 6 fat GEMMs a layer at M = 4 x
    # 1500 frames, the decoder 10 (self q/k/v/wo, cross q, k/v of the
    # frames, wo, MLP in and out), the tied col unembed on the GEMV; a
    # decode step 8 fat GEMMs a layer (q/k/v + bias of both attentions,
    # cross k/v recomputed from the frames at M = 6000, the MLP) and both
    # wo on the GEMV, then the unembed. int8: every projection fat, the
    # tied unembed still the float GEMV (the reference's ``_logits`` calls
    # ``balanced_gemm`` directly)
    "whisper-base": {"arch": "whisper-base", "args": [], "vocab": 51865,
                     "want": {"matmul": 6 * 6 + 6 * 10 + GEN * 8 * 6,
                              "gemv": 1 + GEN * (2 * 6 + 1), "wkv": 0}},
    "whisper-base int8": {"arch": "whisper-base",
                          "args": ["--quantize", "int8"], "vocab": 51865,
                          "want": {"matmul": 6 * 6 + 6 * 10 + GEN * 10 * 6,
                                   "gemv": 1 + GEN, "wkv": 0}},
    # llama-3.2-vision-11b (no qkv bias, SwiGLU, untied unembed), 40
    # layers in 8 groups of 4 self layers and 1 gated cross layer, 1,600
    # image tokens: prefill 7 fat GEMMs a layer (a self layer's q, k, v,
    # wo and MLP at M = 512; a cross layer's q, wo and MLP at 512, its k
    # and v of the image embeddings at M = 4 x 1600), the last-token
    # unembed on the GEMV; a decode step a self layer's gate (silu) fat
    # and its 6 other projections on the GEMV, a cross layer's gate and
    # its k and v (M = 6400, recomputed at every step) fat and q, wo,
    # w_in, w_out on the GEMV, then the unembed. int8: every GEMM fat, 7 a
    # layer and the dynamic unembed, at prefill and each decode step
    "llama-3.2-vision-11b": {
        "arch": "llama-3.2-vision-11b", "args": [], "vocab": 128256,
        "want": {"matmul": 7 * 40 + GEN * (32 + 3 * 8),
                 "gemv": 1 + GEN * (6 * 32 + 4 * 8 + 1), "wkv": 0}},
    "llama-3.2-vision-11b int8": {
        "arch": "llama-3.2-vision-11b", "args": ["--quantize", "int8"],
        "vocab": 128256,
        "want": {"matmul": (GEN + 1) * (7 * 40 + 1), "gemv": 0, "wkv": 0}},
}
FAT_KERNELS = ("mm_wgmma", "mm_split_k", "mm_core")  # matmul.cu's routes
PATH_TOL = 5e-2  # kernel vs plain logits, bf16 activations (see phase 5)
# the same under --quantize int8 (phases 5c, 5d, card against CPU), stated
# before the first card run from the CPU tests' spread
# (tests/test_torch_quant.py): with bf16 activations each GEMM re-quantizes
# its input, so a bf16 rounding flip moves whole int8 steps; the port and
# the JAX package differed by up to 0.14 (qwen) and 0.20 (rwkv) of
# (1 + |logit|) over d_model 64-512, and the float path's card-vs-CPU
# spread was 1.3-1.6x its CPU spread. f32 activations would not tighten it
# at full width (test_int8_logits_move_by_rounding_flips_at_full_width):
# what holds the int8 kernels tightly is 5c/5d's second check, the card's
# path against the same path on the card with the fat GEMM's plain
# version, bit for bit
INT8_PATH_TOL = 0.3
# phase 7: the paged engine at qwen1.5-4b's width and depth, 8 lanes
ENGINE_ARGS = ["--arch", "qwen1.5-4b", "--engine", "--num-slots", "8",
               "--kv-block-size", "16", "--prefill-chunk", "128",
               "--prompt-len", str(PROMPT), "--gen", str(GEN),
               "--plan-cache", ""]
# launches of one engine step (40 layers): a decode tick at 8 rows and a
# prefill chunk at 32-128 rows both run q, k, v (bias) and gate (silu) on
# the fat GEMM and wo, w_in, w_out on the GEMV (M <= 128, no epilogue),
# plus the one unembed GEMV (8 rows, or the chunk's last token)
ENGINE_STEP = {"matmul": 4 * 40, "gemv": 3 * 40 + 1, "wkv": 0}
# phase 7b: the same engine with int8 weights and an int8 KV pool: every
# GEMM of a step on the fat GEMM (7 a layer and the dynamic unembed)
ENGINE_INT8_ARGS = ["--quantize", "int8", "--kv-quantize", "int8"]
ENGINE_STEP_INT8 = {"matmul": 7 * 40 + 1, "gemv": 0, "wkv": 0}
# phase 7c: phase 7's engine decoding speculatively, the draft qwen1.5-4b
# itself (the only config with the target's vocabulary) with int8 weights
# (--spec-draft-quantize int8, the default); k = 4
SPEC_K = 4
# phase 5e on the int8 pool: the verify pass quantizes a block's new tokens
# at once where decode requantizes the block at every token, so the keys
# and values differ by up to a scale step besides the routes' summation
# order. Held to the reference's pin for the int8 pool's storage history
# (tests/test_paged_kv.py: 0.1); the CPU rehearsal at 2 layers, bf16
# activations, d_model 64 / 256 / 640 gave 0.052 / 0.044 / 0.036 of
# (1 + |logit|), the bf16 pool 0 / 0 / 0.019
INT8_KV_VERIFY_TOL = 0.1
ENGINE_SPEC_ARGS = ["--spec-draft-config", "qwen1.5-4b", "--spec-k",
                    str(SPEC_K)]
# launches of its steps: the verify pass at 8 x 5 = 40 rows takes the fat
# GEMM and the GEMV like a tick (q, k, v (bias) and gate (silu) fat; wo,
# w_in, w_out and the unembed GEMV at M = 40); a draft step (its
# admission's prefill of 128 tokens and each of the propose step's k + 1
# decodes) runs every projection on the fat GEMM (W8A8, out_scale) and its
# float unembed on the GEMV
DRAFT_STEP = {"matmul": 7 * 40, "gemv": 1, "wkv": 0}
SPEC_RULE = {"spec-verify": ENGINE_STEP, "admit": DRAFT_STEP,
             "spec-draft": {k: (SPEC_K + 1) * n
                            for k, n in DRAFT_STEP.items()}}
# qwen1.5-4b's pool block of 16 tokens over 40 layers, K and V: 20 kv heads
# x 128 at 2 bytes (bf16), or at 1 byte plus 2 x 20 f32 scales (int8)
BF16_BLOCK_BYTES = 40 * 2 * 16 * 20 * 128 * 2
INT8_BLOCK_BYTES = 40 * (2 * 16 * 20 * 128 + 2 * 4 * 20)
# phase 9: the MoE family. olmoe-1b-7b's engine step (16 layers): a tick
# at 8 rows and a chunk at 32-128 rows both run q, k, v, wo on the GEMV
# and the router on the fat GEMM, plus the unembed GEMV; int8: all five
# and the dynamic unembed on the fat GEMM. Its pool block of 16 tokens:
# 16 kv heads x 128, K and V, over 16 layers (131 KB a token in bf16)
ENGINES = {
    "qwen1.5-4b": {"step": ENGINE_STEP, "step_int8": ENGINE_STEP_INT8,
                   "block_bytes": (BF16_BLOCK_BYTES, INT8_BLOCK_BYTES)},
    "olmoe-1b-7b": {"step": {"matmul": 16, "gemv": 4 * 16 + 1, "wkv": 0},
                    "step_int8": {"matmul": 5 * 16 + 1, "gemv": 0, "wkv": 0},
                    "block_bytes": (16 * 2 * 16 * 16 * 128 * 2,
                                    16 * (2 * 16 * 16 * 128 + 2 * 4 * 16))},
}
# phase 9g: olmoe's engine decoding speculatively, the draft olmoe-1b-7b
# itself at int8: the verify pass at 8 x 5 = 40 rows like a tick (q, k, v,
# wo and the unembed on the GEMV, the router fat); a draft step q, k, v, wo
# (W8A8) and the float router on the fat GEMM, its float unembed on the
# GEMV
_OLMOE_DRAFT = {"matmul": 5 * 16, "gemv": 1, "wkv": 0}
SPEC_RULES = {
    "qwen1.5-4b": SPEC_RULE,
    "olmoe-1b-7b": {"spec-verify": ENGINES["olmoe-1b-7b"]["step"],
                    "admit": _OLMOE_DRAFT,
                    "spec-draft": {k: (SPEC_K + 1) * n
                                   for k, n in _OLMOE_DRAFT.items()}},
}
# phases 9c, 9d: a router near-tie may rank another 8th expert on the card
# than on the CPU, which moves the token by a whole expert's share. Such a
# swap (from one input to the layer) is allowed where the CPU's gap
# between its 8th and 9th router probabilities is at most SWAP_GAP
SWAP_GAP = 1e-3


_T0 = time.perf_counter()


def phase(name: str) -> None:
    """A phase's header, with the seconds since the script started."""
    print(f"\n=== {name} [{time.perf_counter() - _T0:.1f}s]", flush=True)


def environment(torch) -> str:
    phase("1 environment")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"nvidia-smi: {smi}")
    cap = torch.cuda.get_device_capability(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device "
          f"{torch.cuda.get_device_name(0)} capability {cap}")
    if cap != (9, 0):
        raise SystemExit(f"needs a Hopper card (sm_90), got {cap}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def build_kernels() -> None:
    from repro_torch.kernels import build

    phase("2 build")
    t0 = time.perf_counter()
    logs = build.build_all()
    print(f"built {sorted(logs) or 'nothing (already built)'} in "
          f"{time.perf_counter() - t0:.1f}s (nvcc, in parallel)")
    for name, log in logs.items():
        regs, spills, fn = [], [], "?"
        for ln in log.splitlines():
            if "Function properties for" in ln:
                fn = ln.split("for", 1)[1].strip()
            elif "registers" in ln:
                regs.append(int(ln.split("Used ")[1].split()[0]))
            elif "spill" in ln and not ("0 bytes spill stores" in ln
                                        and "0 bytes spill loads" in ln):
                spills.append(f"{fn}: {ln.strip()}")
        print(f"  {name}: {len(regs)} kernels, max {max(regs, default=0)} "
              f"registers, {len(spills)} with spills")
        for sp in spills:
            print(f"    spill {sp}")
        with open(os.path.join(build.build_dir(), f"{name}.ptxas.log"),
                  "w") as f:
            f.write(log)


# ------------------------------------------------------------ phase 3
def time_ms(torch, fn, reps: int = 20) -> float:
    """Median of ``reps`` single calls timed with CUDA events, each after
    reading a 256 MiB buffer so that no operand starts in the 50 MB L2 (the
    main path streams 15.8 GB of weights a step: they are always cold). A
    read leaves no dirty lines whose write-back the timed call would pay.
    The read also keeps the card busy (~0.1 ms) while the host enqueues the
    timed call, so the events time the device, not the host's launch
    overhead (which phase 6 shows end to end)."""
    flush = torch.ones(256 * 2**20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        flush.sum()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


@dataclasses.dataclass
class Case:
    name: str
    kernel: str          # "matmul" | "gemv"
    M: int
    K: int
    N: int
    a_dtype: str = "bfloat16"
    b_dtype: str = "float32"
    out_dtype: str = "bfloat16"
    layout: str = "row"
    bias: bool = False
    activation: str | None = None
    scale: bool = False
    fat_only: bool = False  # (phase 13's rule) the fat kernel at any shape


CASES = [
    Case("prefill q/k/v + bias", "matmul", 512, 2560, 2560, bias=True),
    Case("prefill gate + silu", "matmul", 512, 2560, 6912,
         activation="silu"),
    Case("prefill w_out", "matmul", 512, 6912, 2560),
    Case("decode q/k/v + bias", "matmul", 4, 2560, 2560, bias=True),
    Case("decode gate + silu", "matmul", 4, 2560, 6912, activation="silu"),
    Case("col layout + bias", "matmul", 512, 2560, 2560, layout="col",
         bias=True),
    # the W8A8 path's layout: int8 weights (N, K)
    Case("int8 requant -> int8", "matmul", 512, 2560, 2560, a_dtype="int8",
         b_dtype="int8", out_dtype="int8", layout="col", bias=True,
         scale=True),
    Case("ragged + gelu", "matmul", 333, 1000, 777, bias=True,
         activation="gelu"),
    # rwkv6-3b's decay LoRA pair at prefill
    Case("rwkv w_lora_a", "matmul", 512, 2560, 32),
    Case("rwkv w_lora_b", "matmul", 512, 32, 2560),
    Case("prefill bf16 x bf16", "matmul", 512, 2560, 2560,
         b_dtype="bfloat16", bias=True),
    # an f32 output shows the three-term split of an f32 B is exact
    Case("prefill f32 out", "matmul", 512, 2560, 2560, out_dtype="float32",
         bias=True),
    Case("int8 decode col requant", "matmul", 4, 2560, 2560, a_dtype="int8",
         b_dtype="int8", out_dtype="int8", layout="col", bias=True,
         scale=True),
    Case("int8 row -> int32", "matmul", 512, 2560, 2560, a_dtype="int8",
         b_dtype="int8", out_dtype="int32"),
    Case("decode wo", "gemv", 4, 2560, 2560),
    Case("decode w_in", "gemv", 4, 2560, 6912),
    Case("decode w_out", "gemv", 4, 6912, 2560),
    Case("unembed f32 out", "gemv", 4, 2560, 151936, out_dtype="float32"),
    Case("col layout", "gemv", 4, 2560, 2560, layout="col"),
    Case("ragged", "gemv", 3, 1000, 777),
    # rwkv6-3b's decode GEMVs that the qwen shapes above do not cover
    Case("rwkv lora_a", "gemv", 4, 2560, 160),
    Case("rwkv cmix wv", "gemv", 4, 8960, 2560),
    Case("rwkv unembed f32 out", "gemv", 4, 2560, 65536, out_dtype="float32"),
    # more rows: one row group past 8, and a paged-engine-sized batch (W
    # must cross HBM once, not once per 8 rows)
    Case("decode wo B=9", "gemv", 9, 2560, 2560),
    Case("decode wo B=64", "gemv", 64, 2560, 2560),
    Case("decode wo B=128", "gemv", 128, 2560, 2560),
    # the engine's rows (phase 7): decode ticks at 8 lanes, prefill chunks
    # of 32, 64 and 128 tokens
    Case("engine q/k/v + bias M=8", "matmul", 8, 2560, 2560, bias=True),
    Case("engine gate + silu M=8", "matmul", 8, 2560, 6912,
         activation="silu"),
    Case("chunk q/k/v + bias M=32", "matmul", 32, 2560, 2560, bias=True),
    Case("chunk gate + silu M=32", "matmul", 32, 2560, 6912,
         activation="silu"),
    Case("chunk q/k/v + bias M=64", "matmul", 64, 2560, 2560, bias=True),
    Case("chunk gate + silu M=128", "matmul", 128, 2560, 6912,
         activation="silu"),
    Case("engine wo B=8", "gemv", 8, 2560, 2560),
    Case("engine w_in B=8", "gemv", 8, 2560, 6912),
    Case("engine w_out B=8", "gemv", 8, 6912, 2560),
    Case("engine unembed B=8 f32 out", "gemv", 8, 2560, 151936,
         out_dtype="float32"),
    Case("chunk w_in B=32", "gemv", 32, 2560, 6912),
    Case("chunk w_in B=64", "gemv", 64, 2560, 6912),
    Case("chunk w_in B=128", "gemv", 128, 2560, 6912),
    Case("chunk w_out B=128", "gemv", 128, 6912, 2560),
    # speculation (phase 7c): the target's verify pass at 8 lanes x (k + 1
    # = 5) rows, and the draft admission's last-token unembed
    Case("verify q/k/v + bias M=40", "matmul", 40, 2560, 2560, bias=True),
    Case("verify gate + silu M=40", "matmul", 40, 2560, 6912,
         activation="silu"),
    Case("verify wo B=40", "gemv", 40, 2560, 2560),
    Case("verify w_in B=40", "gemv", 40, 2560, 6912),
    Case("verify w_out B=40", "gemv", 40, 6912, 2560),
    Case("verify unembed B=40 f32 out", "gemv", 40, 2560, 151936,
         out_dtype="float32"),
    Case("draft admit unembed B=1 f32 out", "gemv", 1, 2560, 151936,
         out_dtype="float32"),
    # tensor parallelism at 'model' = 2 (phase 15): qwen1.5-4b's local
    # shapes on a rank: column-parallel q/k/v (+ bias) and gate (silu),
    # row-parallel wo and w_out with f32 partial sums, at prefill (512
    # rows) and decode (4); the unembed's vocabulary block
    Case("tp q/k/v + bias", "matmul", 512, 2560, 1280, bias=True),
    Case("tp gate + silu", "matmul", 512, 2560, 3456, activation="silu"),
    Case("tp wo f32 out", "matmul", 512, 1280, 2560, out_dtype="float32"),
    Case("tp w_out f32 out", "matmul", 512, 3456, 2560,
         out_dtype="float32"),
    Case("tp decode q/k/v + bias", "matmul", 4, 2560, 1280, bias=True),
    Case("tp decode gate + silu", "matmul", 4, 2560, 3456,
         activation="silu"),
    Case("tp decode wo f32 out", "gemv", 4, 1280, 2560, out_dtype="float32"),
    Case("tp decode w_in", "gemv", 4, 2560, 3456),
    Case("tp decode w_out f32 out", "gemv", 4, 3456, 2560,
         out_dtype="float32"),
    Case("tp unembed block f32 out", "gemv", 4, 2560, 75968,
         out_dtype="float32"),
    # the engine over 'model' = 2 (phase 16): a rank's chunks of 32-128
    # rows, its tick at 8 lanes (q/k/v and gate on split_k; wo and w_out
    # row-parallel with f32 partial sums, w_in and the vocabulary block on
    # the GEMV) and the verify pass at 8 x 5 rows
    *[Case(f"tp chunk {name} M={M}", "matmul", M, 2560, N, bias=bias,
           activation=act)
      for M in (32, 64, 128)
      for name, N, bias, act in (("q/k/v + bias", 1280, True, None),
                                 ("gate + silu", 3456, False, "silu"))],
    Case("tp engine q/k/v + bias M=8", "matmul", 8, 2560, 1280, bias=True),
    Case("tp engine gate + silu M=8", "matmul", 8, 2560, 3456,
         activation="silu"),
    Case("tp verify q/k/v + bias M=40", "matmul", 40, 2560, 1280,
         bias=True),
    Case("tp verify gate + silu M=40", "matmul", 40, 2560, 3456,
         activation="silu"),
    Case("tp engine wo B=8 f32 out", "gemv", 8, 1280, 2560,
         out_dtype="float32"),
    Case("tp engine w_in B=8", "gemv", 8, 2560, 3456),
    Case("tp engine w_out B=8 f32 out", "gemv", 8, 3456, 2560,
         out_dtype="float32"),
    Case("tp engine unembed block B=8 f32 out", "gemv", 8, 2560, 75968,
         out_dtype="float32"),
    # the other families over 'model' = 2 (phase 19): a rank's local
    # shapes at prefill (512 rows) and decode (4). rwkv6-3b: r, k, v, g on
    # 20 heads (1280 columns), the decay's up-projection on their columns
    # (K = 32: the fat GEMM at every M), the channel-mix's wk + relu on
    # 4480 columns, wo and wv row-parallel with f32 partial sums, the
    # vocabulary block; zamba2-1.2b: the block of w_in's columns a rank
    # stores (8384 / 2: its outputs are all-gathered, then a rank takes
    # z and x of its 32 heads, B and C, dt of its heads), w_out
    # row-parallel, the vocabulary block; whisper-base's decoder MLP out
    # and wo row-parallel on the GEMV (the bias after the sum); the
    # vision model's w_out block
    Case("tp rwkv r/k/v/g", "matmul", 512, 2560, 1280),
    Case("tp rwkv decay up-projection", "matmul", 512, 32, 1280),
    Case("tp rwkv cmix wk + relu", "matmul", 512, 2560, 4480,
         activation="relu"),
    Case("tp rwkv wo f32 out", "matmul", 512, 1280, 2560,
         out_dtype="float32"),
    Case("tp rwkv cmix wv f32 out", "matmul", 512, 4480, 2560,
         out_dtype="float32"),
    Case("tp rwkv decode r/k/v/g", "gemv", 4, 2560, 1280),
    Case("tp rwkv decode decay up-projection", "matmul", 4, 32, 1280),
    Case("tp rwkv decode cmix wk + relu", "matmul", 4, 2560, 4480,
         activation="relu"),
    Case("tp rwkv decode wo f32 out", "gemv", 4, 1280, 2560,
         out_dtype="float32"),
    Case("tp rwkv decode cmix wv f32 out", "gemv", 4, 4480, 2560,
         out_dtype="float32"),
    Case("tp rwkv unembed block f32 out", "gemv", 4, 2560, 32768,
         out_dtype="float32"),
    Case("tp zamba2 w_in block", "matmul", 512, 2048, 4192),
    Case("tp zamba2 w_out f32 out", "matmul", 512, 2048, 2048,
         out_dtype="float32"),
    Case("tp zamba2 decode w_in block", "gemv", 4, 2048, 4192),
    Case("tp zamba2 decode w_out f32 out", "gemv", 4, 2048, 2048,
         out_dtype="float32"),
    Case("tp zamba2 unembed block f32 out", "gemv", 4, 2048, 16000,
         out_dtype="float32"),
    Case("tp whisper decode MLP out f32 out", "gemv", 4, 1024, 512,
         out_dtype="float32"),
    Case("tp whisper decode wo f32 out", "gemv", 4, 256, 512,
         out_dtype="float32"),
    Case("tp vision decode w_out f32 out", "gemv", 4, 7168, 4096,
         out_dtype="float32"),
] + [
    # the W8A8 path (--quantize int8): int8 x int8, B (N, K), out_scale
    # s_x * s_w; every shape a path gives split_k (static decode M = 4,
    # engine tick M = 8, chunk tail M <= 32: q/k/v, wo and w_in share the
    # q/k/v and gate shapes) and the prefill and chunk rows on
    # tensor_core_int8
    Case(f"W8A8 {name}", "matmul", M, K, N, a_dtype="int8", b_dtype="int8",
         out_dtype=out, layout="col", bias=bias, activation=act, scale=True)
    for name, M, K, N, out, bias, act in [
        ("q/k/v + bias M=4", 4, 2560, 2560, "bfloat16", True, None),
        ("q/k/v + bias M=8", 8, 2560, 2560, "bfloat16", True, None),
        ("q/k/v + bias M=32", 32, 2560, 2560, "bfloat16", True, None),
        ("gate + silu M=4", 4, 2560, 6912, "bfloat16", False, "silu"),
        ("gate + silu M=8", 8, 2560, 6912, "bfloat16", False, "silu"),
        ("gate + silu M=32", 32, 2560, 6912, "bfloat16", False, "silu"),
        ("w_out M=4", 4, 6912, 2560, "bfloat16", False, None),
        ("w_out M=8", 8, 6912, 2560, "bfloat16", False, None),
        ("w_out M=32", 32, 6912, 2560, "bfloat16", False, None),
        ("unembed M=4 f32 out", 4, 2560, 151936, "float32", False, None),
        ("unembed M=8 f32 out", 8, 2560, 151936, "float32", False, None),
        ("prefill q/k/v + bias", 512, 2560, 2560, "bfloat16", True, None),
        ("prefill gate + silu", 512, 2560, 6912, "bfloat16", False, "silu"),
        ("prefill w_out", 512, 6912, 2560, "bfloat16", False, None),
        ("chunk q/k/v + bias M=64", 64, 2560, 2560, "bfloat16", True, None),
        ("chunk q/k/v + bias M=128", 128, 2560, 2560, "bfloat16", True,
         None),
        # the int8 draft's admission (phase 7c): its prompt of 128 in one
        # shot
        ("draft admit gate + silu M=128", 128, 2560, 6912, "bfloat16", False,
         "silu"),
        ("draft admit w_out M=128", 128, 6912, 2560, "bfloat16", False,
         None),
        ("rwkv w_lora_a (dynamic)", 512, 2560, 32, "bfloat16", False, None),
        ("rwkv w_lora_b (dynamic)", 512, 32, 2560, "bfloat16", False, None),
    ]
] + [
    # olmoe-1b-7b (phase 9): attention at prefill on the fat GEMM; the
    # router, f32 x f32 with N = 64, at every M its paths give it (static
    # decode 4, engine tick 8, chunks 32, 64 and 128, static prefill 512:
    # split_k to 32, cuda_core above)
    Case("olmoe prefill q/k/v/wo", "matmul", 512, 2048, 2048),
] + [
    Case(f"olmoe router M={M}", "matmul", M, 2048, 64, a_dtype="float32",
         out_dtype="float32")
    for M in (4, 8, 32, 64, 128, 512)
] + [
    # q/k/v/wo at decode (4), on a tick (8) and in the chunks; the
    # unembed at decode, on a tick and at a chunk's last token
    Case(f"olmoe q/k/v/wo B={M}", "gemv", M, 2048, 2048)
    for M in (4, 8, 32, 64, 128)
] + [
    Case(f"olmoe unembed B={M} f32 out", "gemv", M, 2048, 50304,
         out_dtype="float32")
    for M in (1, 4, 8)
] + [
    # olmoe under --quantize int8: q/k/v/wo, the router and the unembed
    # (both float weights re-quantized at every call), out_scale s_x * s_w
    Case(f"W8A8 olmoe {name}", "matmul", M, 2048, N, a_dtype="int8",
         b_dtype="int8", out_dtype=out, layout="col", scale=True)
    for name, M, N, out in
    [(f"q/k/v/wo M={M}", M, 2048, "bfloat16") for M in (4, 8, 32, 64, 128,
                                                          512)]
    + [(f"router M={M} f32 out", M, 64, "float32")
       for M in (4, 8, 32, 64, 128, 512)]
    + [(f"unembed M={M} f32 out", M, 50304, "float32") for M in (1, 4, 8)]
] + [
    # zamba2-1.2b (phase 10): the Mamba projections, w_in's N = 8384 = 64 x
    # 131 ragged against 128-wide tiles, at prefill (512 rows) and decode
    # (4), float and W8A8
    Case("zamba2 prefill w_in", "matmul", 512, 2048, 8384),
    Case("zamba2 prefill w_out", "matmul", 512, 4096, 2048),
    Case("zamba2 w_in B=4", "gemv", 4, 2048, 8384),
    Case("zamba2 w_out B=4", "gemv", 4, 4096, 2048),
    Case("W8A8 zamba2 w_in M=4", "matmul", 4, 2048, 8384, a_dtype="int8",
         b_dtype="int8", layout="col", scale=True),
    Case("W8A8 zamba2 w_in M=512", "matmul", 512, 2048, 8384, a_dtype="int8",
         b_dtype="int8", layout="col", scale=True),
    # whisper-base (phase 11): the cross K/V of 4 x 1500 frames at every
    # decode step, the MLP's bias + gelu at decode, and the tied unembed,
    # the (V, d) table as a col-layout W
    Case("whisper cross k/v + bias", "matmul", 6000, 512, 512, bias=True),
    Case("whisper MLP in + bias + gelu M=4", "matmul", 4, 512, 2048,
         bias=True, activation="gelu"),
    Case("W8A8 whisper MLP in + bias + gelu M=4", "matmul", 4, 512, 2048,
         a_dtype="int8", b_dtype="int8", layout="col", bias=True,
         activation="gelu", scale=True),
    Case("whisper unembed B=4 col f32 out", "gemv", 4, 512, 51968,
         layout="col", out_dtype="float32"),
    # llama-3.2-vision-11b (phase 12): the prefill's projections (q and
    # wo 4096 wide, k and v 1024, the MLP 14336) at 512 rows, the cross
    # K/V of 4 x 1600 image tokens at every decode step, the decode
    # gate (silu) on split_k, the decode GEMVs and the unembed; float and
    # W8A8
    Case("vision prefill q/wo", "matmul", 512, 4096, 4096),
    Case("vision prefill k/v", "matmul", 512, 4096, 1024),
    Case("vision prefill gate + silu", "matmul", 512, 4096, 14336,
         activation="silu"),
    Case("vision prefill w_out", "matmul", 512, 14336, 4096),
    Case("vision cross k/v", "matmul", 6400, 4096, 1024),
    Case("vision gate + silu M=4", "matmul", 4, 4096, 14336,
         activation="silu"),
    Case("vision q/wo B=4", "gemv", 4, 4096, 4096),
    Case("vision k/v B=4", "gemv", 4, 4096, 1024),
    Case("vision w_in B=4", "gemv", 4, 4096, 14336),
    Case("vision w_out B=4", "gemv", 4, 14336, 4096),
    Case("vision unembed B=4 f32 out", "gemv", 4, 4096, 128256,
         out_dtype="float32"),
] + [
    Case(f"W8A8 vision {name}", "matmul", M, K, N, a_dtype="int8",
         b_dtype="int8", out_dtype=out, layout="col", activation=act,
         scale=True)
    for name, M, K, N, out, act in [
        ("gate + silu M=4", 4, 4096, 14336, "bfloat16", "silu"),
        ("w_out M=4", 4, 14336, 4096, "bfloat16", None),
        ("cross k/v M=6400", 6400, 4096, 1024, "bfloat16", None),
        ("prefill gate + silu M=512", 512, 4096, 14336, "bfloat16", "silu"),
        ("unembed M=4 f32 out", 4, 4096, 128256, "float32", None),
    ]
] + [
    # W8A8 over 'model' (phase 18): qwen1.5-4b's blocks on a (1, 2) mesh at
    # a decode step's 4 rows and a prefill's 512. Column-parallel q/k/v
    # (bias; N = 2560 / 2) and gate (silu; N = 6912 / 2) with the fused
    # epilogue; row-parallel wo and w_out (K = 2560 / 2, 6912 / 2) with
    # int32 out and no epilogue, whose partials the ranks sum
    Case(f"W8A8 TP {name} M={M}", "matmul", M, K, N, a_dtype="int8",
         b_dtype="int8", out_dtype=out, layout="col",
         bias=name.startswith("q/k/v"),
         activation="silu" if name.startswith("gate") else None,
         scale=out != "int32")
    for name, K, N, out in [("q/k/v + bias", 2560, 1280, "bfloat16"),
                            ("gate + silu", 2560, 3456, "bfloat16"),
                            ("wo int32 out", 1280, 2560, "int32"),
                            ("w_out int32 out", 3456, 2560, "int32")]
    for M in (4, 512)
] + [
    # W8A8 over 'model' = 2 for the other families (phase 21a-21d): each
    # product's local shape at a decode step's 4 rows and at the rows its
    # prefill gives it (512; whisper's encoder and cross K/V 4 x 1500
    # frames, the vision model's cross K/V 4 x 1600 image tokens);
    # column-parallel with the fused epilogue (rwkv's decay up-projection
    # the dynamic path: its weight is float in a pre-quantized tree),
    # row-parallel with int32 out and no epilogue, the vocabulary block
    # with f32 out
    Case(f"W8A8 TP {name} M={M}", "matmul", M, K, N, a_dtype="int8",
         b_dtype="int8", out_dtype=out, layout="col", bias=bias,
         activation=act, scale=out != "int32")
    for name, Ms, K, N, out, bias, act in [
        ("rwkv r/k/v/g", (4, 512), 2560, 1280, "bfloat16", False, None),
        ("rwkv decay up-projection", (4, 512), 32, 1280, "bfloat16", False,
         None),
        ("rwkv cmix wk + relu", (4, 512), 2560, 4480, "bfloat16", False,
         "relu"),
        ("rwkv cmix wv int32 out", (4, 512), 4480, 2560, "int32", False,
         None),
        ("rwkv unembed block f32 out", (4,), 2560, 32768, "float32", False,
         None),
        ("zamba2 w_in block", (4, 512), 2048, 4192, "bfloat16", False, None),
        ("zamba2 w_out int32 out", (4, 512), 2048, 2048, "int32", False,
         None),
        ("zamba2 unembed block f32 out", (4,), 2048, 16000, "float32", False,
         None),
        ("whisper q/k/v + bias", (4, 6000), 512, 256, "bfloat16", True,
         None),
        ("whisper wo int32 out", (4, 6000), 256, 512, "int32", False, None),
        ("whisper MLP in + bias + gelu", (4, 6000), 512, 1024, "bfloat16",
         True, "gelu"),
        ("whisper MLP out int32 out", (4, 6000), 1024, 512, "int32", False,
         None),
        ("vision q", (4, 512), 4096, 2048, "bfloat16", False, None),
        ("vision k/v", (4, 6400), 4096, 512, "bfloat16", False, None),
        ("vision wo int32 out", (4, 512), 2048, 4096, "int32", False, None),
        ("vision gate + silu", (4, 512), 4096, 7168, "bfloat16", False,
         "silu"),
        ("vision w_out int32 out", (4, 512), 7168, 4096, "int32", False,
         None),
        ("vision unembed block f32 out", (4,), 4096, 64128, "float32", False,
         None),
    ]
    for M in Ms
] + [
    # qwen1.5-4b over 'model' = 3 (phase 21e, 21f): of its products only
    # the MLP's splits (d_ff 6912 / 3); attention (20 heads of 128) and
    # the vocabulary stay whole on every rank
    Case("tp3 gate + silu", "matmul", 512, 2560, 2304, activation="silu"),
    Case("tp3 w_out f32 out", "matmul", 512, 2304, 2560,
         out_dtype="float32"),
    Case("tp3 decode gate + silu", "matmul", 4, 2560, 2304,
         activation="silu"),
    Case("tp3 decode w_in", "gemv", 4, 2560, 2304),
    Case("tp3 decode w_out f32 out", "gemv", 4, 2304, 2560,
         out_dtype="float32"),
]
# GEMV cases held to their plain version but not timed: every dtype pair,
# both layouts, 1..128 rows, ragged K and N, both routes
GEMV_SWEEP = [
    Case(f"sweep {a}x{b}->{o} {lay} B={M}", "gemv", M, K, N, a_dtype=a,
         b_dtype=b, out_dtype=o, layout=lay)
    for M, K, N in [(1, 2560, 2560), (4, 1000, 776), (33, 2560, 2560),
                    (64, 992, 136), (128, 2560, 2560), (128, 992, 136)]
    for a, b, o in [("bfloat16", "float32", "bfloat16"),
                    ("bfloat16", "float32", "float32"),
                    ("bfloat16", "bfloat16", "float32"),
                    ("float32", "float32", "float32"),
                    ("float32", "bfloat16", "bfloat16"),
                    ("int8", "int8", "int32"), ("int8", "int8", "int8")]
    for lay in ("row", "col")
] + [Case("sweep unaligned col B=64", "gemv", 64, 1001, 300, layout="col"),
     Case("sweep unaligned int8 row B=9", "gemv", 9, 333, 1001,
          a_dtype="int8", b_dtype="int8", out_dtype="int16")]
# the case that stands for each kernel in the JSON record
RECORD_CASE = {"matmul": "prefill gate + silu", "gemv": "unembed f32 out"}


def _inputs(torch, c: Case, gen):
    dt = lambda name: getattr(torch, name)

    def rnd(shape, name, scale=1.0):
        if name == "int8":
            return torch.randint(-100, 100, shape, generator=gen,
                                 device="cuda", dtype=torch.int8)
        x = torch.randn(shape, generator=gen, device="cuda") * scale
        return x.to(dt(name))

    a = rnd((c.M, c.K), c.a_dtype)
    b_shape = (c.N, c.K) if c.layout == "col" else (c.K, c.N)
    b = rnd(b_shape, c.b_dtype, c.K ** -0.5)
    bias = rnd((c.N,), "float32") if c.bias else None
    scale = (torch.rand((c.N,), generator=gen, device="cuda") * 2e-4
             if c.scale else None)
    return a, b, bias, scale


def _library_call(torch, c: Case, a, b, bias):
    """One PyTorch call computing the same product (a yardstick only, never
    used by the port). int8: ``torch._int_mm`` (cuBLASLt int8 x int8 ->
    int32), the product only: no PyTorch call fuses the requant, bias and
    saturating cast, so that epilogue is left out of the yardstick."""
    bt = b.t() if c.layout == "col" else b
    if c.a_dtype == "int8":
        # cuBLASLt's int8 product takes more than 16 rows only
        return (lambda: torch._int_mm(a, bt)) if c.M > 16 else None
    if bias is not None:
        return lambda: torch.addmm(bias, a.float(), bt.float())
    return lambda: torch.mm(a.float(), bt.float())


def _rate(c: Case, route: str) -> float:
    """The rate a case's operations are bounded by: int8 inputs at the
    card's int8 peak on any route (the least time the card could take for
    them); for float inputs, the route's: an f32 B on the tensor cores is
    three bf16 passes, a bf16 B one; the CUDA-core routes (split-K, CUDA
    core, the GEMV) at the f32 rate."""
    if c.a_dtype == "int8":
        return PEAK_OPS["int8"]
    if route == "tensor_core":
        return PEAK_OPS["bfloat16"] / (3 if c.b_dtype == "float32" else 1)
    return PEAK_OPS["float32"]


def _bound(c: Case, torch, route: str) -> tuple[float, str]:
    size = lambda name: getattr(torch, name).itemsize
    moved = (c.M * c.K * size(c.a_dtype) + c.K * c.N * size(c.b_dtype)
             + c.M * c.N * size(c.out_dtype)
             + 4 * c.N * (int(c.bias) + int(c.scale)))
    ops = 2 * c.M * c.K * c.N
    t_bytes = moved / HBM_BYTES_PER_S
    t_ops = ops / _rate(c, route)
    if t_bytes >= t_ops:
        return 1e3 * t_bytes, "bytes"
    return 1e3 * t_ops, "operations"


def _tolerance(kernel: str, out_dtype: str, peak: float,
               exact: bool = False) -> float:
    """How far a GEMM kernel's result may lie from its plain version's on
    the same inputs (phases 3a and 8c). Same f32 (i32) accumulation,
    another summation order: an f32 result may differ by ~1e-6 relative; a
    bf16 result may round the other way, one bf16 ulp = 2**-7 of the
    largest value; an int8 requant result may flip one rint tie; the
    GEMV's integer outputs (i32 sums, saturated) are exact. ``exact``: the
    W8A8 cases, where an int8 x int8 product sums exactly in i32 in any
    order and the epilogue runs the plain version's f32 ops in its order
    (separate roundings, the same silu), so the output equals it bit for
    bit."""
    if exact:
        return 0.0
    if out_dtype == "bfloat16":
        return 2.0 ** -7 * max(1.0, peak)
    if out_dtype == "float32":
        return 1e-5 * max(1.0, peak)
    return 0.0 if kernel == "gemv" else 1.0


def check_kernels(torch) -> dict[str, dict]:
    phase("3a GEMM kernels against their plain versions (on the card)")
    results = check_cases(torch, CASES, GEMV_SWEEP)
    return {r["kernel"]: r for r in results
            if r["case"] == RECORD_CASE[r["kernel"]]}


def check_cases(torch, cases, sweep=()) -> list[dict]:
    """Each GEMM case against its plain version at 3a's tolerance: the
    timed ``cases`` with their time, bound, plain and library times (the
    records returned), then the untimed ``sweep``."""
    from repro_torch.core.context import use_context
    from repro_torch.core.gemm import plan_for
    from repro_torch.core.plancache import PlanCache
    from repro_torch.kernels import decode_matvec as tmv
    from repro_torch.kernels import matmul as tmm
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device="cuda").manual_seed(0)
    results = []
    props = torch.cuda.get_device_properties(0)
    with use_context(hw="h100", plan_cache=PlanCache()):
        for timed, c in [(True, c) for c in cases] + [
                (False, c) for c in sweep]:
            a, b, bias, scale = _inputs(torch, c, gen)
            out_dtype = getattr(torch, c.out_dtype)
            plan = plan_for(c.M, c.K, c.N, in_dtype=a.dtype,
                            out_dtype=out_dtype, b_layout=c.layout)
            split, mma = "", False
            if c.kernel == "matmul":
                route = tmm.route(c.M, a.dtype, b.dtype, c.layout,
                                  tmm.tma_aligned(a, b))
                kern = lambda: ops.balanced_matmul(
                    a, b, bias, plan=plan, out_dtype=out_dtype,
                    b_layout=c.layout, activation=c.activation,
                    out_scale=scale)
                plain = lambda: ref.matmul_ref(
                    a, b, out_dtype=out_dtype, b_layout=c.layout, bias=bias,
                    activation=c.activation, out_scale=scale)
            else:
                route = tmv.route(b, c.layout)
                bk = min(plan.bk, -(-c.K // tmm.BK_STEP) * tmm.BK_STEP)
                lp = tmv.launch_plan(c.M, c.K, c.N, bk, plan.bn, a.dtype,
                                     b.dtype, c.layout, route,
                                     props.multi_processor_count,
                                     props.shared_memory_per_block_optin)
                mma = lp.mt > 0
                groups = (1 if route == tmv.TMA
                          else -(-c.M // tmm.rows_per_group(c.M)))
                split = (f" splits={lp.splits}x{lp.k_per_split} blocks="
                         f"{-(-c.N // plan.bn) * groups * lp.splits}"
                         + (f" mma_tiles={lp.mt}" if lp.mt else ""))
                kern = lambda: ops.decode_matvec(
                    a, b, bk=plan.bk, bn=plan.bn, out_dtype=out_dtype,
                    w_layout=c.layout)
                plain = lambda: ref.gemv_ref(a, b, out_dtype=out_dtype,
                                             w_layout=c.layout)
            got = kern()
            torch.cuda.synchronize()
            want = plain()
            err = (got.double() - want.double()).abs().max().item()
            peak = want.double().abs().max().item()
            tol = _tolerance(c.kernel, c.out_dtype, peak,
                             exact=c.name.startswith("W8A8"))
            if not timed:
                print(f"{c.kernel:6s} {c.name:34s} MKN={c.M}x{c.K}x{c.N} "
                      f"route={route} plan={[plan.bk, plan.bn]}{split} "
                      f"err={err:.3g} tol={tol:.3g}", flush=True)
                if not err <= tol:
                    raise SystemExit(f"{c.kernel} case {c.name!r} disagrees "
                                     f"with its plain version: {err} > {tol}")
                del a, b, bias, scale, got, want
                continue
            lib = _library_call(torch, c, a, b, bias)
            if route == "tensor_core" and c.b_dtype == "float32":
                # a yardstick of one bf16 pass only: another product (B
                # rounded to bf16), which the port never computes
                b16 = b.bfloat16()
                bt16 = b16.t() if c.layout == "col" else b16
                print(f"       {c.name:22s} bf16_library_ms="
                      f"{time_ms(torch, lambda: torch.mm(a, bt16)):.4f} "
                      "(torch.mm(a, b.bfloat16()), one bf16 pass)",
                      flush=True)
                del b16, bt16
            rec = {
                "case": c.name, "kernel": c.kernel, "route": route,
                "shape": [c.M, c.K, c.N], "layout": c.layout,
                "dtypes": [c.a_dtype, c.b_dtype, c.out_dtype],
                "plan": [plan.bm, plan.bk, plan.bn],
                "max_abs_err": err, "tol": tol,
                "ms": time_ms(torch, kern),
                "plain_ms": time_ms(torch, plain),
                "library_ms": None if lib is None else time_ms(torch, lib),
            }
            # the GEMV's tensor-core consumers run the matmul route's three
            # bf16 passes of an f32 W
            rec["bound_ms"], rec["bound_by"] = _bound(
                c, torch, "tensor_core" if mma else route)
            results.append(rec)
            print(f"{c.kernel:6s} {c.name:22s} MKN={c.M}x{c.K}x{c.N} "
                  f"{c.layout} route={route} plan={rec['plan']}{split} "
                  f"err={err:.3g} tol={tol:.3g} ms={rec['ms']:.4f} "
                  f"plain_ms={rec['plain_ms']:.4f} library_ms="
                  + ("null" if lib is None else f"{rec['library_ms']:.4f}")
                  + f" bound_ms={rec['bound_ms']:.4f} ({rec['bound_by']})",
                  flush=True)
            if not err <= tol:
                raise SystemExit(f"{c.kernel} case {c.name!r} disagrees with "
                                 f"its plain version: {err} > {tol}")
            del a, b, bias, scale, got, want
    return results


# ------------------------------------------------------------ phase 3b
@dataclasses.dataclass
class WkvCase:
    name: str
    B: int
    H: int
    T: int
    N: int
    w0: tuple = (-6.0, 1.0)  # log(-log w) drawn uniform in this range
    tol: float = 2e-4
    heads: bool = False      # wkv_heads on (B, T, H, N) bf16 r, k, v
    offset: int = 0          # r, k, v start this many elements into a buffer


# the rwkv6-3b path's shape (batch 4 x 40 heads of 64, prompt 128), the
# reference test's shapes (tests/test_kernels_wkv.py) and its adversarial
# decay range; tolerances are that test's: rtol = atol = 2e-4, and 1e-3
# for the adversarial range (decays down to e^-3.3 a step re-centred over
# a chunk: the factored exponentials lose a few more bits). The last two
# cases are what time_mix launches: bf16 (B, T, H, N) views of the
# projections and the f32 log decay, read in place; the smoke config's
# heads of 16 one element off a 16-byte boundary take the scalar loads.
WKV_CASES = [
    WkvCase("path B4 H40 T128 N64", 4, 40, 128, 64),
    WkvCase("reference (1, 2, 96, 128)", 1, 2, 96, 128),
    WkvCase("reference (1, 1, 32, 64)", 1, 1, 32, 64),
    WkvCase("adversarial decay (1, 2, 64, 32)", 1, 2, 64, 32,
            w0=(-8.0, 1.2), tol=1e-3),
    WkvCase("path heads bf16 B4 T128 H40 N64", 4, 40, 128, 64, heads=True),
    # a rank's 20 heads over 'model' = 2 (phase 19a): (4, 128, 20, 64)
    # views of its column-parallel projections
    WkvCase("tp path heads bf16 B4 T128 H20 N64", 4, 20, 128, 64,
            heads=True),
    WkvCase("unaligned heads bf16 (2, 4, 64, 16)", 2, 4, 64, 16, heads=True,
            offset=1),
]


def _wkv_bound(c: WkvCase) -> tuple[float, str]:
    """Bytes: r, k, v, wlog, y (BH, T, N), u (BH, N), state in and out
    (BH, N, N), all f32, each once (wkv_heads: r, k, v bf16 and u (H, N)).
    Operations: per chunk of C = 32 steps the four products, y1 (C x N x N),
    the strictly causal A and A v (C (C-1) / 2 x N each) and the state
    update (C x N x N), as 2 ops a multiply-add, and the bonus diagonal
    (3 C N)."""
    BH, T, N, C = c.B * c.H, c.T, c.N, 32
    if c.heads:
        moved = (2 * 3 * BH * T * N
                 + 4 * (2 * BH * T * N + c.H * N + 2 * BH * N * N))
    else:
        moved = 4 * (5 * BH * T * N + BH * N + 2 * BH * N * N)
    ops = BH * (T // C) * (4 * C * N * N + 2 * C * (C - 1) * N + 3 * C * N)
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, ops / PEAK_OPS["float32"]
    if t_bytes >= t_ops:
        return 1e3 * t_bytes, "bytes"
    return 1e3 * t_ops, "operations"


def check_wkv(torch) -> dict:
    from repro_torch.kernels import wkv

    phase("3b WKV kernel against its plain version (on the card)")
    gen = torch.Generator(device="cuda").manual_seed(1)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    record = None
    for c in WKV_CASES:
        B, H, BH, T, N = c.B, c.H, c.B * c.H, c.T, c.N
        lo, hi = c.w0
        decay = lambda *shape: -torch.exp(lo + (hi - lo) * torch.rand(
            shape, generator=gen, device="cuda"))
        to_bh = lambda x: x.float().transpose(1, 2).reshape(BH, T, N)
        if c.heads:
            # (B, T, H, N) views of (B, T, H * N) projections, as time_mix
            # holds them
            r, k, v = (rnd(B * T * H * N + c.offset).bfloat16()[c.offset:]
                       .view(B, T, H, N) for _ in range(3))
            wl = decay(B, T, H, N)
            u = rnd(H, N) * 0.3
            s0 = rnd(B, H, N, N) * 0.1
            args = (r, k, v, wl, u, s0)
            call = wkv.wkv_heads
            u_rows = u[None].expand(B, H, N).reshape(BH, N)

            def plain():
                y, s = wkv.wkv_ref(to_bh(r), to_bh(k), to_bh(v), to_bh(wl),
                                   u_rows, s0.reshape(BH, N, N))
                return (y.reshape(B, H, T, N).transpose(1, 2),
                        s.reshape(B, H, N, N))
            strides = [(x.stride(0), x.stride(2), x.stride(1))
                       for x in (r, k, v, wl)]
        else:
            r, k, v = rnd(BH, T, N), rnd(BH, T, N), rnd(BH, T, N)
            wl = decay(BH, T, N)
            u = (rnd(H, N) * 0.3)[None].expand(B, H, N).reshape(BH, N)
            s0 = rnd(BH, N, N) * 0.1
            args = (r, k, v, wl, u, s0)
            call = wkv.wkv
            plain = lambda: wkv.wkv_ref(*args)
            strides = [(0, x.stride(0), x.stride(1)) for x in (r, k, v, wl)]
        part = wkv.partition(BH, N, sms, r.element_size())
        route = wkv.route([(x.data_ptr(), st, x.element_size())
                           for x, st in zip((r, k, v, wl), strides)])
        kern = lambda: call(*args)
        got = kern()
        torch.cuda.synchronize()
        want = plain()
        err = max((g - w).abs().max().item() for g, w in zip(got, want))
        ok = all(bool(((g - w).abs() <= c.tol + c.tol * w.abs()).all())
                 for g, w in zip(got, want))
        rec = {"case": c.name, "kernel": "wkv", "shape": [B, H, T, N],
               "ms_slice": part.ms, "blocks": part.blocks, "route": route,
               "max_abs_err": err, "tol": c.tol,
               "ms": time_ms(torch, kern), "plain_ms": time_ms(torch, plain),
               "library_ms": None}  # no PyTorch call computes WKV
        rec["bound_ms"], rec["bound_by"] = _wkv_bound(c)
        extra = ""
        if c.name.startswith(("path", "reference (1, 2")):
            # both slice widths, so that the partition's pick is measured
            for ms in wkv.SLICES:
                alt = lambda: call(*args, ms=ms)
                g2 = alt()
                torch.cuda.synchronize()
                e2 = max((g - w).abs().max().item()
                         for g, w in zip(g2, want))
                if not all(bool(((g - w).abs() <= c.tol + c.tol * w.abs())
                                .all()) for g, w in zip(g2, want)):
                    raise SystemExit(f"wkv case {c.name!r} at ms={ms} "
                                     f"disagrees: max abs error {e2}")
                extra += f" ms{ms}_ms={time_ms(torch, alt):.4f}"
        if c.name == "path B4 H40 T128 N64":
            # the layout copies time_mix made around the launch before it
            # read (B, T, H, N) in place: r, k, v (bf16) and the log decay
            # (f32) to (B*H, T, N) f32, and y back; the path no longer pays
            # them
            x16 = torch.randn((B, T, H, N), device="cuda").bfloat16()
            x32 = x16.float()
            y = r.clone()

            def layout():
                for x in (x16, x16, x16, x32):
                    to_bh(x)
                y.reshape(B, H, T, N).transpose(1, 2).reshape(B, T, H * N)
            rec["layout_ms"] = time_ms(torch, layout)
            extra += f" old layout copies ms={rec['layout_ms']:.4f}"
        if c.name.startswith("path heads"):
            record = rec
        print(f"wkv    {c.name:34s} ms_slice={part.ms} blocks={part.blocks} "
              f"route={route} err={err:.3g} tol={c.tol} (rtol = atol) "
              f"ms={rec['ms']:.4f} plain_ms={rec['plain_ms']:.4f} "
              f"library_ms=null bound_ms={rec['bound_ms']:.4f} "
              f"({rec['bound_by']}){extra}", flush=True)
        if not ok:
            raise SystemExit(f"wkv case {c.name!r} disagrees with its plain "
                             f"version beyond rtol = atol = {c.tol}: max "
                             f"abs error {err}")
        del args, got, want
    return record


# ------------------------------------------------------------ phase 4
def _free(torch) -> None:
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def _spread(ms: list[float]) -> str:
    return (f"{statistics.median(ms):.2f} ms (min {min(ms):.2f}, max "
            f"{max(ms):.2f})")


def _clone(state):
    from repro_torch import interop

    return interop.tree_map(lambda t: t.clone(), state)


def _restore(state, saved) -> None:
    from repro_torch import interop

    for (_, t), (_, s) in zip(interop.tree_items(state),
                              interop.tree_items(saved)):
        t.copy_(s)


def _differ(torch, a, b) -> list[str]:
    """Names of the leaves of two state trees that are not equal bit for
    bit."""
    from repro_torch import interop

    return [name for (name, x), (_, y) in zip(interop.tree_items(a),
                                              interop.tree_items(b))
            if not torch.equal(x, y)]


def replay_vs_eager(torch, name: str, captured, raw, params, state,
                    *inputs) -> None:
    """One step replayed from its graph and the same step run eagerly from
    the same state: logits and state equal bit for bit, or the run fails.
    Captures the step first where its bucket has no graph yet."""
    from repro_torch.train import graphs

    saved = _clone(state)
    key = tuple((tuple(graphs.as_tensor(x).shape),
                 graphs.as_tensor(x).dtype) for x in inputs)
    if key not in captured.graphs:
        captured(params, state, *inputs)
        _restore(state, saved)
    out = captured(params, state, *inputs).clone()
    after = _clone(state)
    _restore(state, saved)
    want = raw(params, state, *(graphs.as_tensor(x).cuda() for x in inputs))
    torch.cuda.synchronize()
    bad = _differ(torch, after, state)
    same = torch.equal(out, want)
    print(f"  {name}: replay == eager bit for bit: logits {same}, state "
          + ("all leaves" if not bad else f"differs in {bad}"), flush=True)
    if not same or bad:
        raise SystemExit(f"{name}: the replayed step differs from the eager "
                         "step")


def _params(torch, cfg, quant: bool, seed: int = 0):
    """The path's weights from ``seed`` on the card, quantized once (as the
    launcher does at load) for an int8 path."""
    from repro_torch import models
    from repro_torch.quant.prequant import quantize_params

    params = models.init(cfg, seed=seed, device="cuda")
    return quantize_params(params) if quant else params


def _prefill_batch(torch, cfg, rng, device="cuda") -> dict:
    """The static server's prefill batch at BATCH x PROMPT, drawn as the
    launcher draws it: the prompts, then (encdec) the frame embeddings or
    (vlm) the image embeddings from the same generator."""
    import numpy as np

    from repro_torch.train.servestep import prefill_input_shapes

    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, size=(BATCH, PROMPT))).to(device)}
    for k, (shape, _) in prefill_input_shapes(cfg, BATCH, PROMPT).items():
        if k != "tokens":
            batch[k] = torch.from_numpy(rng.standard_normal(shape).astype(
                np.float32)).to(device)
    return batch


def serve_split(torch, cfg, params, art, state, batch,
                ssm_share: bool) -> None:
    """Phases 10a, 10b, 11a, 11c, 12a, 12b: where the decode step's and
    the prefill's time goes. The decode step: GEN replays after a fresh
    prefill, traced: device busy a step split into the fat GEMM by route,
    the GEMV and the rest, and the top kernels; vlm also the cross K/V's
    device ms a step and share (the step's tensor-core GEMMs: M = 6400,
    every other fat GEMM of a step is at M = 4). The eager prefill, warm:
    its wall ms (host clock around it, synchronised), its CUDA-event ms,
    and, traced once, its kernels and device busy ms. ``ssm_share`` (10a):
    the same prefill again with the SSM scan stubbed: the scan's share of
    it."""
    from repro_torch.layers import mamba as mb

    V = cfg.vocab_size
    out = [art.prefill_fn(params, state, batch)]

    def decode_only():
        for _ in range(GEN):
            tok = out[0][:, :V].argmax(-1)
            out[0] = art.decode_fn(params, state, tok[:, None])
        torch.cuda.synchronize()

    rows, _, wall = _traced(torch, decode_only)
    per_step = lambda rs: sum(t for t, _, _ in rs) / 1e3 / GEN
    busy = per_step(rows)
    parts = {k: per_step([r for r in rows if k in r[2]])
             for k in (*FAT_KERNELS, "gemv_")}
    print(f"decode step, {GEN} replays traced: wall {wall * 1e3 / GEN:.2f} "
          f"ms a step, device busy {busy:.2f} ms (idle share "
          f"{1 - busy * GEN / 1e3 / wall:.3f}) = "
          + " + ".join(f"{v:.3f} ({k})" for k, v in parts.items() if v)
          + f" + the rest {busy - sum(parts.values()):.3f}", flush=True)
    for t, n, key in sorted(rows, reverse=True)[:8]:
        print(f"  {t / 1e3 / GEN:8.3f} ms x{n / GEN:<6g} "
              f"{key.replace('void ', '')[:90]}")
    if cfg.family == "vlm":
        n = sum(c for _, c, k in rows if "mm_wgmma" in k) / GEN
        cross = parts["mm_wgmma"]
        print(f"the cross K/V ({n:g} tensor-core launches a step at M = "
              f"{BATCH} x {cfg.n_image_tokens}, K {cfg.d_model}, N "
              f"{cfg.n_kv_heads * cfg.head_dim}): {cross:.3f} ms a step, "
              f"{cross / busy:.3f} of the step's device busy", flush=True)

    def timed(fn, reps=3):
        walls, evs = [], []
        for _ in range(reps):
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ev[0].record()
            fn()
            ev[1].record()
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t0))
            evs.append(ev[0].elapsed_time(ev[1]))
        return statistics.median(walls), statistics.median(evs)

    prefill = lambda: art.prefill_fn(params, state, batch)
    wall, ev = timed(prefill)
    rows, _, traced = _traced(torch, lambda: (prefill(),
                                              torch.cuda.synchronize()))
    busy, idle = _busy(rows, traced)
    kernels = sum(n for _, n, _ in rows)
    print(f"prefill ({BATCH} x {PROMPT}, eager, warm): wall {wall:.2f} ms, "
          f"CUDA events {ev:.2f} ms; traced: {kernels} kernels, device busy "
          f"{busy:.2f} ms (idle share {idle:.3f})", flush=True)
    for t, n, key in sorted(rows, reverse=True)[:6]:
        print(f"  {t / 1e3:8.3f} ms x{n:<6d} {key.replace('void ', '')[:90]}")
    if not ssm_share:
        return
    # the same prefill with the SSM scan a stub that launches nothing
    # (every other op kept): what the chunked scan costs the prefill
    scan, mb._scan = mb._scan, lambda h, xh, *rest: (xh, h)
    try:
        bare, bare_ev = timed(prefill)
    finally:
        mb._scan = scan
    print(f"the SSM scan ({cfg.n_layers} layers x {PROMPT} tokens in chunks "
          f"of {mb.CHUNK}): the prefill without it wall {bare:.2f} ms, CUDA "
          f"events {bare_ev:.2f} ms; its share of the prefill's wall "
          f"{1 - bare / wall:.3f}; the prefill {wall:.2f} ms against "
          f"{ZAMBA_PREFILL_LOOP_MS} ms when the scan looped over the tokens "
          "(38 layers)", flush=True)


def static_steps(torch, arch: str, label: str, quant: bool = False,
                 cut: dict | None = None) -> None:
    """The static server's decode step, eager and as a CUDA-graph replay,
    in one run from one state: step ms (CUDA events between steps, so the
    host's dispatch shows), tok/s, and the replay against the eager step
    bit for bit; the hybrid, encdec and vlm families also the prefill
    (``serve_split``). ``cut``: the config's fields to replace (a
    depth)."""
    import numpy as np

    from repro_torch import configs as C
    from repro_torch import models
    from repro_torch.core.context import use_context
    from repro_torch.core.gemm import plan_model
    from repro_torch.core.plancache import PlanCache
    from repro_torch.train.servestep import make_serve_step

    phase(f"{label} static decode step of {arch}"
          + (" (int8)" if quant else "") + ": eager, then CUDA-graph "
          "replays, from one state" + (f", cut to {cut}" if cut else ""))
    cfg = dataclasses.replace(C.get_config(arch), **(cut or {}))
    V = cfg.vocab_size
    params = _params(torch, cfg, quant)
    batch = _prefill_batch(torch, cfg, np.random.default_rng(0))
    extras = {k: v for k, v in batch.items() if k != "tokens"}
    max_len = PROMPT + GEN + 1
    steps = 6   # 2 warm + 6 eager + 1 capture + 6 replays + 1 = GEN steps
    with use_context(plan_cache=PlanCache(),
                     quant_mode="int8" if quant else None):
        plan_model(cfg, batch=BATCH, prompt_len=PROMPT, max_len=max_len,
                   params=params, extras=extras)
        art = make_serve_step(cfg, device="cuda")
        state = models.init_decode_state(cfg, BATCH, max_len, device="cuda")
        logits = art.prefill_fn(params, state, batch)

        def loop(fn, n):
            nonlocal logits
            marks = [torch.cuda.Event(enable_timing=True)
                     for _ in range(n + 1)]
            for i in range(n):
                marks[i].record()
                logits = fn(params, state, logits[:, :V].argmax(-1)[:, None])
            marks[n].record()
            torch.cuda.synchronize()
            return [marks[i].elapsed_time(marks[i + 1]) for i in range(n)]

        loop(art.decode_raw, 2)
        eager = loop(art.decode_raw, steps)
        t0 = time.perf_counter()
        loop(art.decode_fn, 1)
        capture_s = time.perf_counter() - t0
        graph = loop(art.decode_fn, steps)
        print(f"eager step {_spread(eager)} = "
              f"{BATCH * 1e3 / statistics.median(eager):.1f} tok/s; graph "
              f"replay {_spread(graph)} = "
              f"{BATCH * 1e3 / statistics.median(graph):.1f} tok/s "
              f"({statistics.median(eager) / statistics.median(graph):.2f}x;"
              f" first call + capture {capture_s:.2f}s)", flush=True)
        replay_vs_eager(torch, "decode step", art.decode_fn, art.decode_raw,
                        params, state, logits[:, :V].argmax(-1)[:, None])
        if cfg.family == "moe":
            moe_split(torch, cfg, params, art, state, batch["tokens"], quant)
        if cfg.family in ("hybrid", "encdec", "vlm"):
            serve_split(torch, cfg, params, art, state, batch,
                        ssm_share=cfg.family == "hybrid" and not quant)
    del params, state, art
    _free(torch)


def moe_split(torch, cfg, params, art, state, prompts, quant: bool) -> None:
    """Phases 9a, 9b: the MoE decode step's device time by kernel, its GEN
    replays traced after a fresh prefill, split into the fat GEMM (the
    router), the GEMV (q, k, v, wo, the unembed), the expert tables' cast
    at every call (the reference's ``w.astype(x.dtype)``: 1.61 GB of f32
    read and 0.81 GB of bf16 written a layer; int8: the dequantization),
    the expert products (batched matmuls) and the rest. The cast and the
    products are torch ops whose kernels cannot be told from others by
    name, so they are captured alone as CUDA graphs at the step's shapes
    and traced, as step_split does for the int8 quantizers."""
    from repro_torch import interop
    from repro_torch.layers import moe

    V, L, E = cfg.vocab_size, cfg.n_layers, cfg.n_experts
    dt = cfg.dtype
    out = [art.prefill_fn(params, state, {"tokens": prompts})]

    def decode_only():
        for _ in range(GEN):
            tok = out[0][:, :V].argmax(-1)
            out[0] = art.decode_fn(params, state, tok[:, None])
        torch.cuda.synchronize()

    step_rows, _, step_wall = _traced(torch, decode_only)
    tables = params["layers"]["moe"]

    def cast():
        for i in range(L):
            lay = interop.tree_map(lambda t: t[i], tables)
            for w in (lay.w_in, lay.w_gate, lay.w_out):
                moe._maybe_dequant(w, dt).to(dt)

    # the products at a decode step's shapes: Ce = 8 slots an expert; a
    # dequantized table keeps the (N, K) int8 layout's strides
    d, f = cfg.d_model, cfg.d_ff
    xe = torch.randn((E, 8, d), device="cuda").to(dt)
    h = torch.randn((E, 8, f), device="cuda").to(dt)
    table = lambda k, n: (
        torch.randn((E, n, k), device="cuda").to(dt).transpose(-1, -2)
        if quant else torch.randn((E, k, n), device="cuda").to(dt))
    w_in, w_out = table(d, f), table(f, d)

    def products():
        for _ in range(L):
            torch.bmm(xe, w_in)
            torch.bmm(xe, w_in)
            torch.bmm(h, w_out)

    per_step = lambda rs: sum(t for t, _, _ in rs) / 1e3 / GEN
    busy = per_step(step_rows)
    fat = per_step([r for r in step_rows
                    if any(k in r[2] for k in FAT_KERNELS)])
    gemv = per_step([r for r in step_rows if "gemv_" in r[2]])
    parts = {}
    for name, fn in (("expert-table " + ("dequantization" if quant
                                         else "cast"), cast),
                     ("expert products", products)):
        ms, rows = _graph_rows(torch, fn)
        dev = sum(t for t, _, _ in rows) / 1e3
        names = {k for _, _, k in rows}
        same = per_step([r for r in step_rows if r[2] in names])
        parts[name] = dev
        print(f"  {name} ({L} layers x 3 tables, captured alone): a "
              f"replayed graph {ms:.3f} ms, its kernels' device time "
              f"{dev:.3f} ms, {sum(n for _, n, _ in rows):g} kernels; the "
              f"step's kernels of the same names {same:.3f} ms")
    del xe, h, w_in, w_out
    rest = busy - fat - gemv - sum(parts.values())
    print(f"MoE decode step{' (int8)' if quant else ''}, {GEN} replays "
          f"traced: wall {step_wall * 1e3 / GEN:.2f} ms a step, device busy "
          f"{busy:.2f} ms (idle share {1 - busy * GEN / 1e3 / step_wall:.3f})"
          f" = fat GEMM {fat:.2f} + GEMV {gemv:.2f} + "
          + " + ".join(f"{v:.2f} ({k})" for k, v in parts.items())
          + f" + the rest {rest:.2f} (routing, dispatch, attention, norms)",
          flush=True)
    for t, n, key in sorted(step_rows, reverse=True)[:12]:
        if t:
            print(f"  {t / 1e3 / GEN:8.3f} ms x{n / GEN:<6g} "
                  f"{key.replace('void ', '')[:90]}")


def run_path(torch, path: str, label: str) -> dict[str, int]:
    from repro_torch.launch import serve
    from repro_torch.train import graphs

    spec = PATHS[path]
    phase(f"{label} path: repro_torch.launch.serve --arch {spec['arch']} "
          f"--batch {BATCH} --prompt-len {PROMPT} --gen {GEN} "
          + " ".join(spec["args"]) + " (full width and depth)")
    torch.cuda.reset_peak_memory_stats()
    graphs.reset_launches()
    t0 = time.perf_counter()
    res = serve.main(["--arch", spec["arch"], "--batch", str(BATCH),
                      "--prompt-len", str(PROMPT), "--gen", str(GEN),
                      "--plan-cache", "", *spec["args"]])
    wall = time.perf_counter() - t0
    # eager launches (prefill, the decode step's first call) plus those of
    # the decode graph's replays
    counts = graphs.launches()
    replayed = dict(graphs.replayed)
    gen = res["generated"]
    print(f"tokens generated {res['tokens']} in {res['seconds']:.3f}s serving "
          f"({res['tokens'] / res['seconds']:.2f} tok/s), {wall:.1f}s with "
          f"init and warm-up; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB"
          + ("" if res["quantize_s"] is None else
             f"; weights quantized at load in {res['quantize_s']:.3f}s"))
    print(f"launches: {counts}, of which graph replays {replayed} (rule: "
          f"{spec['want']})")
    if res["lazy_solves"] or res["misses"]:
        raise SystemExit(f"serving was not plan-warm: {res}")
    if counts != spec["want"]:
        raise SystemExit(f"launch counts {counts} differ from the dispatch "
                         f"rule's {spec['want']}")
    if tuple(gen.shape) != (BATCH, GEN) or not (
            (gen >= 0) & (gen < spec["vocab"])).all():
        raise SystemExit(f"bad generated ids {gen.shape}: {gen}")
    del res
    _free(torch)
    return counts


# ------------------------------------------------------------ phase 5
class _plain_matmul:
    """Within it, the fat GEMM's wrapper computes its plain version on the
    card (``ref.matmul_ref`` on the same CUDA tensors) instead of launching
    ``matmul.cu``: every other op of the path stays the same CUDA op."""

    def __enter__(self):
        from repro_torch.kernels import matmul as tmm
        from repro_torch.kernels import ref

        def plain(a, b, bias=None, out_scale=None, *, bm, bk, bn,
                  out_dtype=None, b_layout="row", activation=None):
            return ref.matmul_ref(a, b, out_dtype=out_dtype,
                                  b_layout=b_layout, bias=bias,
                                  activation=activation, out_scale=out_scale)
        self.saved, tmm.matmul = tmm.matmul, plain

    def __exit__(self, *exc):
        from repro_torch.kernels import matmul as tmm

        tmm.matmul = self.saved


class _RouterLog:
    """Within it, every MoE layer call records its router's verdict (the
    layer's own ``_top_k_gates``, wrapped; the path's arguments stay as
    they are): per call the probabilities, gates and experts, the sorted
    top-k set and the gap between the k-th and the (k + 1)-th probability.
    ``force``: a verdict (probs, gates, idx) the calls return in place of
    their own, on their own device, so that a layer dispatches its tokens
    as another run did."""

    def __init__(self, force=None):
        self.force = force

    def __enter__(self):
        from repro_torch.layers import moe

        self.calls, self.saved = [], moe._top_k_gates

        def recorded(logits, top_k, norm_topk):
            probs, gates, idx = self.saved(logits, top_k, norm_topk)
            top = probs.topk(top_k + 1, dim=-1).values
            self.calls.append({
                "verdict": tuple(t.cpu() for t in (probs, gates, idx)),
                "set": idx.sort(-1).values.cpu(),
                "gap": (top[:, top_k - 1] - top[:, top_k]).cpu()})
            if self.force is not None:
                return tuple(t.to(logits.device) for t in self.force)
            return probs, gates, idx

        moe._top_k_gates = recorded
        return self

    def __exit__(self, *exc):
        from repro_torch.layers import moe

        moe._top_k_gates = self.saved


def _swaps(torch, cfg, own: dict, ref: dict, step: int, layer: int,
           S: int, reached, swaps: list) -> bool:
    """One layer call's swaps (a token whose top-k set differs between two
    runs' verdicts), appended to ``swaps`` as (step, layer, row, position,
    ``ref``'s gap between its k-th and (k + 1)-th probability), and the
    compared logits (each step's last position, by row) they reach marked
    in ``reached`` (steps, rows). A swap moves its token by a whole
    expert's share: it reaches its own token's logits and, below the last
    layer, every later position of its row (through the next layers'
    attention); where the call's capacity binds (an expert holds Ce
    assignments or more, so the order in the buckets decides drops), every
    row's. Returns whether the capacity binds."""
    from repro_torch.layers import moe

    T = own["set"].shape[0]
    Cs = moe._round8(int(cfg.capacity_factor * T * cfg.top_k))
    Ce = moe._round8(int(cfg.capacity_factor * Cs / cfg.n_experts))
    loads = [int(torch.bincount(v["set"].flatten(),
                                minlength=cfg.n_experts).max())
             for v in (own, ref)]
    binds = max(loads) >= Ce
    for t in (own["set"] != ref["set"]).any(-1).nonzero().flatten().tolist():
        row, pos = divmod(t, S)
        swaps.append((step, layer, row, pos, float(ref["gap"][t])))
        rows = slice(None) if binds else row
        if layer < cfg.n_layers - 1:
            reached[step:, rows] = True
        elif pos == S - 1 or binds:
            reached[step, rows] = True
    return binds


def _router_by_layer(torch, cfg, params, prompts, fed) -> dict:
    """The stack of an MoE config run layer by layer on the card and on
    the CPU, each layer fed the CPU's input to it (prefill, then a decode
    step for each of ``fed``), so that a router swap (a token whose top-k
    set differs) is the layer's own near-tie and not the echo of an
    earlier layer's swap. The layer's body is ``models.lm``'s: the port's
    attention and its ``_ffn``. The card's layer then dispatches its
    tokens by the CPU's verdict, so its output is held against the CPU's
    on every token: the kernels' and the ops' numerics alone.

    Returns the swaps (``_swaps``), the token calls compared, the calls
    whose capacity binds, the largest |card - cpu| / (1 + |cpu|) of a
    layer's output, and the CPU's logits of each step (the path's ops on
    the CPU, so equal to its CPU run's bit for bit)."""
    from repro_torch import models
    from repro_torch.layers import attention as attn
    from repro_torch.models import lm

    states = {d: models.init_decode_state(cfg, BATCH, PROMPT + 5, device=d)
              for d in ("cuda", "cpu")}
    L, steps = cfg.n_layers, len(fed) + 1
    swaps, calls, bound, logits, layer_err = [], 0, 0, [], 0.0
    reached = torch.zeros((steps, BATCH), dtype=torch.bool)

    def layer(d, i, x, step, log):
        lp = lm._layer(params[d]["layers"], i)
        kv = states[d]["kv"]
        cache = attn.KVCache(k=kv.k[i], v=kv.v[i], length=kv.length)
        h = lm.apply_norm(cfg, lp["ln1"], x)
        if step == 0:
            y, _ = attn.prefill_attention(lp["attn"], h, cache,
                                          rope_theta=cfg.rope_theta,
                                          chunk=cfg.attn_chunk)
        else:
            y, _ = attn.decode_attention(lp["attn"], h, cache,
                                         rope_theta=cfg.rope_theta)
        x = x + y
        with log:
            return x + lm._ffn(cfg, lp, x)

    for step in range(steps):
        toks = prompts if step == 0 else fed[step - 1][:, None]
        S = toks.shape[1]
        x = lm._embed(params["cpu"], toks, cfg)
        for i in range(L):
            cpu_log = _RouterLog()
            want = layer("cpu", i, x, step, cpu_log)
            ref = cpu_log.calls[0]
            card_log = _RouterLog(force=ref["verdict"])
            got = layer("cuda", i, x.to("cuda"), step, card_log)
            bound += _swaps(torch, cfg, card_log.calls[0], ref, step, i, S,
                            reached, swaps)
            w, g = (t.float().reshape(-1, cfg.d_model)
                    for t in (want, got.cpu()))
            layer_err = max(layer_err,
                            ((g - w).abs() / (1 + w.abs())).max().item())
            calls += BATCH * S
            x = want
        h = lm.apply_norm(cfg, params["cpu"]["final_norm"], x[:, -1:])
        logits.append(lm._logits(params["cpu"], cfg, h)[:, 0,
                                                      :cfg.vocab_size])
        for d, st in states.items():
            if step == 0:
                st["kv"].length.fill_(PROMPT)
            else:
                st["kv"].length.add_(1)
    del states
    return {"swaps": swaps, "calls": calls, "bound": bound,
            "layer_err": layer_err, "cpu": torch.stack(logits).float()}


class _LayerLog:
    """Within it, every call of a hybrid or vision stack's layer function
    (``lm._hybrid_layer``: a Mamba block and the shared block where it
    runs; ``vision_lm._stack_layer``: a self layer or a group's gated cross
    layer) records its input and its output, in call order: the prefill's
    layers, then each decode step's. The path's arguments stay as they
    are."""

    def __init__(self, cfg):
        from repro_torch.models import lm, vision_lm

        self.mod, self.name = ((vision_lm, "_stack_layer")
                               if cfg.family == "vlm"
                               else (lm, "_hybrid_layer"))

    def __enter__(self):
        self.calls, self.saved = [], getattr(self.mod, self.name)

        def recorded(params, cfg, i, x, *args):
            out = self.saved(params, cfg, i, x, *args)
            self.calls.append((x.clone(), out.clone()))
            return out

        setattr(self.mod, self.name, recorded)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.saved)


def _stack_by_layer(torch, cfg, params, batch, calls) -> dict:
    """Each layer of a hybrid or vision stack run on the card from the CPU
    path's own input to it, against the CPU path's output of it (``calls``,
    recorded by ``_LayerLog`` in the CPU run: the prefill, then each decode
    step). The card keeps its own decode state, written by its own layers
    from those inputs (vlm: ``img`` the batch's image embeddings, as
    prefill writes it). Returns, by layer, the largest |card - cpu| / (1 +
    |cpu|) of its output over the steps, and the same of the logits the
    final norm and the unembed give from the CPU's last hidden state of
    each step."""
    from repro_torch import models
    from repro_torch.models import lm
    from repro_torch.models import vision_lm as vl

    L = cfg.n_layers
    if len(calls) % L:
        raise SystemExit(f"{len(calls)} layer calls recorded, not a "
                         f"multiple of {L} layers")
    state = models.init_decode_state(cfg, BATCH, PROMPT + 5, device="cuda")
    if cfg.family == "vlm":
        state["img"].copy_(batch["image_embeds"].to("cuda").to(cfg.dtype))

        def layer(i, x, mode):
            return vl._stack_layer(params["cuda"], cfg, i, x, state["img"],
                                   mode, state["kv"])
    else:
        def layer(i, x, mode):
            return lm._hybrid_layer(params["cuda"], cfg, i, x, state, mode)
    err = lambda got, want: ((got.cpu().float() - want.float()).abs()
                             / (1 + want.float().abs())).max().item()
    by_layer, head = [0.0] * L, 0.0
    for c, (x, want) in enumerate(calls):
        step, i = divmod(c, L)
        got = layer(i, x.to("cuda"), "prefill" if step == 0 else "decode")
        by_layer[i] = max(by_layer[i], err(got, want))
        if i < L - 1:
            continue
        out = {}
        for d in ("cuda", "cpu"):
            h = lm.apply_norm(cfg, params[d]["final_norm"],
                              want[:, -1:].to(d))
            out[d] = lm._logits(params[d], cfg, h)[:, 0, :cfg.vocab_size]
        head = max(head, err(out["cuda"], out["cpu"]))
        if step == 0:
            state["kv"].length.fill_(PROMPT)
        else:
            state["kv"].length.add_(1)
    del state
    return {"by_layer": by_layer, "head": head}


def kernel_vs_plain(torch, arch: str, label: str, quant: bool = False,
                    cut: dict | None = None) -> None:
    """The path on the card against the same path on the CPU from the same
    weights, the config ``cut`` (default: 2 layers); int8 also against
    the card's path with the plain fat GEMM, bit for bit."""
    import contextlib

    import numpy as np

    from repro_torch import configs as C
    from repro_torch import interop, models
    from repro_torch.core.context import use_context

    tol = INT8_PATH_TOL if quant else PATH_TOL
    cut = {"n_layers": 2} if cut is None else cut
    phase(f"{label} kernel path (card) against plain path (CPU"
          + ("; and on the card, bit for bit" if quant else "") + f"), {arch},"
          + "".join(f" {k} {v}," for k, v in cut.items()) + " full width"
          + (", --quantize int8" if quant else ""))
    cfg = dataclasses.replace(C.get_config(arch), **cut)
    params = {"cuda": _params(torch, cfg, quant, seed=1)}
    if cfg.family == "vlm":
        # the reference's init zeroes both gates of every cross layer, and
        # a cross layer then adds exactly nothing: nonzero gates from the
        # seed (|tanh(gate)| >= 0.46), the same in both trees
        gen = torch.Generator().manual_seed(1)
        for g in ("gate_attn", "gate_mlp"):
            gate = params["cuda"]["groups"]["cross"][g]
            sign = torch.randint(0, 2, gate.shape, generator=gen) * 2 - 1
            gate.copy_((torch.rand(gate.shape, generator=gen) + 0.5) * sign)
        print("gates: " + ", ".join(
            f"{g} " + " ".join(f"{v:.4f}" for v in
                               params["cuda"]["groups"]["cross"][g].tolist())
            for g in ("gate_attn", "gate_mlp")))
    params["cpu"] = interop.tree_map(lambda t: t.cpu(), params["cuda"])
    batch = _prefill_batch(torch, cfg, np.random.default_rng(1), "cpu")
    prompts = batch["tokens"]
    logits, states = {}, {}
    fed = []  # the card's greedy tokens, fed to every run
    # int8: a third run on the card with the fat GEMM's plain version in
    # matmul.cu's place
    runs = [("cuda", "cuda"), ("cpu", "cpu")] + (
        [("plain", "cuda")] if quant else [])
    moe, hybrid = cfg.family == "moe", cfg.family == "hybrid"
    stacked = cfg.family in ("hybrid", "vlm")  # gated layer by layer too
    if stacked:
        # the model's own spread: the CPU path again with the embedding
        # table scaled by 1 + 2**-20 (a few bf16 activations round the
        # other way)
        runs.append(("cpu, embedding x (1 + 2**-20)", "cpu"))
        params["cpu, embedding x (1 + 2**-20)"] = {
            **params["cpu"], "embed": params["cpu"]["embed"] * (1 + 2**-20)}
    routers = {}
    for run, dev in runs:
        router = _RouterLog() if moe else contextlib.nullcontext()
        # the CPU path's layer inputs and outputs, for the card's layers
        layers = (_LayerLog(cfg) if stacked and run == "cpu"
                  else contextlib.nullcontext())
        with use_context(quant_mode="int8" if quant else None), (
                _plain_matmul() if run == "plain"
                else contextlib.nullcontext()), router, layers:
            state = models.init_decode_state(cfg, BATCH, PROMPT + 5,
                                             device=dev)
            p = params[run if run in params else dev]
            lg, state = models.prefill(
                p, {k: v.to(dev) for k, v in batch.items()}, cfg, state)
            steps = [lg[:, :cfg.vocab_size].float().cpu()]
            for i in range(4):
                if run == "cuda":
                    fed.append(steps[-1].argmax(-1))
                lg, state = models.decode_step(
                    p, fed[i][:, None].to(dev), cfg, state)
                steps.append(lg[:, :cfg.vocab_size].float().cpu())
        logits[run], states[run] = torch.stack(steps), state
        if moe:
            routers[run] = router.calls
        if stacked and run == "cpu":
            cpu_layers = layers.calls
    # bf16 activations: the two paths sum each product in another order, so
    # an activation may round to the neighbouring bf16 value and the flip
    # propagates through 2 layers. Held like the repo's bf16 kernel tests:
    # |card - cpu| <= tol + tol * |cpu| with tol = 5e-2 (on the CPU, the
    # qwen config with a 503-token vocabulary drifted 0.028 at most between
    # f32 and f64 accumulation); int8: INT8_PATH_TOL (see there). MoE: a
    # token the card routes to another expert set than the CPU moves by a
    # whole expert's share, and its row (and, where capacity binds, every
    # row) with it. So the MoE gates are: run layer by layer from the CPU's
    # input to each layer, every swap is a near-tie on the CPU (gap at
    # most SWAP_GAP) and every layer's output, dispatched alike, within
    # tol; end to end, the logits that no swap of the two runs reaches
    # within tol.
    held = torch.ones(logits["cpu"].shape[:2], dtype=torch.bool)
    if stacked:
        with use_context(quant_mode="int8" if quant else None):
            hb = _stack_by_layer(torch, cfg, params, batch, cpu_layers)
        del cpu_layers
        run = "cpu, embedding x (1 + 2**-20)"
        spread = ((logits[run] - logits["cpu"]).abs()
                  / (1 + logits["cpu"].abs())).max().item()
        print("layer by layer from the CPU's input to each layer: "
              "max |card - cpu| / (1 + |cpu|) of each layer's output "
              + " ".join(f"{e:.4g}" for e in hb["by_layer"])
              + f", of the final norm and unembed {hb['head']:.4g} (tol "
              f"{tol}); the CPU path against itself with the embedding "
              f"table x (1 + 2**-20): {spread:.4g}", flush=True)
        if not max(hb["by_layer"] + [hb["head"]]) <= tol:
            raise SystemExit(f"{label}: a layer's output is more than {tol} "
                             "from the CPU's")
    if moe:
        with use_context(quant_mode="int8" if quant else None):
            rb = _router_by_layer(torch, cfg, params, prompts, fed)
        if not torch.equal(rb["cpu"], logits["cpu"]):
            raise SystemExit(f"{label}: the layer-by-layer run's CPU logits "
                             "differ from the path's")
        swaps = rb["swaps"]
        worst = max((g for *_, g in swaps), default=0.0)
        print(f"router, layer by layer from the CPU's input to each layer: "
              f"{rb['calls']} token calls, {len(swaps)} swaps (a top-"
              f"{cfg.top_k} set that differs between the card and the CPU), "
              f"largest CPU gap between the {cfg.top_k}th and "
              f"{cfg.top_k + 1}th probability among them {worst:.3g} "
              f"(allowed {SWAP_GAP}); capacity bound in {rb['bound']} of "
              f"{cfg.n_layers * held.shape[0]} layer calls; each layer's "
              f"output, dispatched by the CPU's verdict, within "
              f"{rb['layer_err']:.4g} of 1 + |cpu| (tol {tol})")
        for step, layer, row, pos, gap in swaps:
            print(f"  swap: step {step} layer {layer} row {row} position "
                  f"{pos}: CPU gap {gap:.3g}")
        if worst > SWAP_GAP or not rb["layer_err"] <= tol:
            raise SystemExit(f"{label}: a router swap with a CPU gap of "
                             f"{worst} > {SWAP_GAP}, or a layer's output "
                             f"{rb['layer_err']} > {tol} from the CPU's")
        reached, e2e = torch.zeros_like(held), []
        for c, (own, ref) in enumerate(zip(routers["cuda"], routers["cpu"],
                                           strict=True)):
            step, layer = divmod(c, cfg.n_layers)
            _swaps(torch, cfg, own, ref, step, layer,
                   PROMPT if step == 0 else 1, reached, e2e)
        held = ~reached
        print(f"end to end: {len(e2e)} swaps (largest CPU gap "
              f"{max((g for *_, g in e2e), default=0.0):.3g}, an earlier "
              f"swap's echo among them); logits held at {int(held.sum())} "
              f"of {held.numel()} (step, row) entries, the others reached by "
              f"a swap")
    card, ref = logits["cuda"][held], logits["cpu"][held]
    diff = (card - ref).abs()
    top = lambda t: t.max().item() if t.numel() else 0.0
    err = top(diff)
    scaled = top(diff / (1 + ref.abs()))
    top2 = ref.topk(2, dim=-1).values
    sure = (top2[..., 0] - top2[..., 1]) > tol * (1 + top2[..., 0].abs())
    same = card.argmax(-1) == ref.argmax(-1)
    print(f"logits max |card - cpu| = {err:.4g}, max |card - cpu| / (1 + "
          f"|cpu|) = {scaled:.4g} (tol {tol}); greedy tokens equal at "
          f"{int((same & sure).sum())}/{int(sure.sum())} positions whose "
          f"top-2 margin exceeds the tolerance ({int(same.sum())}/"
          f"{same.numel()} overall)")
    # the int8 hybrid path at 4 layers: the CPU path moved by 0.40 of (1 +
    # |logit|) against itself with its embedding table x (1 + 2**-20) (on
    # an H100's host): a bf16 flip moves a per-tensor activation scale,
    # and 6 quantized blocks compound it, so an end-to-end bound of 0.3
    # cannot tell a kernel's error from the model's own spread. Its gates
    # are each layer's output from the CPU's input and the head (above),
    # and the card's path bit for bit against the same path with the plain
    # fat GEMM (below); the end-to-end figures are printed. The vision
    # path at 10 layers with nonzero gates, likewise at f32 and int8: the
    # CPU path moved by 0.0637 / 0.4423 against itself (an H100's host),
    # above 0.05 / 0.3, while each layer from the CPU's input stayed within
    # 0.0282 / 0.0925 and the head within 2.4e-6 / 1.2e-3
    e2e = not (hybrid and quant or cfg.family == "vlm")
    failed = []
    if e2e and not scaled <= tol or not bool(same[sure].all()):
        failed.append("kernel path disagrees with the plain path")
    if quant:
        # Every GEMM of an int8 path is W8A8, which matmul.cu computes bit
        # for bit like its plain version (phase 3a), and every other op is
        # the same CUDA op on the same inputs: the two card runs agree
        # exactly, logits and state (KV cache, or WKV state and shifts).
        # The card-vs-CPU spread above is the per-tensor rounding of
        # another float path, not a kernel's error.
        bad = _differ(torch, states["cuda"], states["plain"])
        exact = torch.equal(logits["cuda"], logits["plain"])
        print(f"card kernel path against card plain path: logits equal bit "
              f"for bit {exact} (max |d| "
              f"{(logits['cuda'] - logits['plain']).abs().max().item():.3g}"
              "), state " + ("equal in every leaf" if not bad
                             else f"differs in {bad}"))
        if not exact or bad:
            failed.append("the int8 kernel path differs from its plain "
                          "version on the card")
    if failed:
        raise SystemExit(f"{label}: " + "; ".join(failed))
    del params, states
    _free(torch)


def verify_vs_decode(torch) -> None:
    """Phase 5e: the target's verify pass (k + 1 tokens a lane in one
    step) against k + 1 paged decode steps fed the same tokens, from copies
    of one paged state, on the bf16 and the int8 pool. On the card the two
    take other routes (verify: 40 rows, the fat GEMM's tensor_core and the
    GEMV at B = 40; decode: 8 rows, split_k and the GEMV at B = 8), so they
    differ by summation order and are held to PATH_TOL; on the int8 pool
    to INT8_KV_VERIFY_TOL (see there)."""
    import numpy as np

    from repro_torch import configs as C
    from repro_torch import models
    from repro_torch.core.context import use_context
    from repro_torch.core.plancache import PlanCache

    phase(f"5e verify_step over k + 1 = {SPEC_K + 1} tokens against "
          f"{SPEC_K + 1} paged decode steps (card), qwen1.5-4b, 2 layers, "
          "full width, bf16 and int8 pools")
    cfg = dataclasses.replace(C.get_config("qwen1.5-4b"), n_layers=2)
    V = cfg.vocab_size
    params = _params(torch, cfg, False, seed=2)
    lanes, bs = 8, 16
    max_len = PROMPT + GEN + 1
    mb = -(-max_len // bs)
    dev = lambda x: torch.as_tensor(np.asarray(x), device="cuda")
    for kv_dtype, tol in (("bf16", PATH_TOL), ("int8", INT8_KV_VERIFY_TOL)):
        rng = np.random.default_rng(2)
        with use_context(plan_cache=PlanCache()):
            state = models.init_decode_state(
                cfg, lanes, max_len, per_slot=True, kv_block_size=bs,
                num_kv_blocks=lanes * mb + 1, device="cuda",
                kv_dtype=None if kv_dtype == "bf16" else kv_dtype)
            # one prefill chunk a lane (prompts of 128, 64 and 96); the
            # last lane stays vacant
            for lane in range(lanes - 1):
                n = (PROMPT, PROMPT // 2, 3 * PROMPT // 4)[lane % 3]
                models.prefill_chunk(
                    params, dev(rng.integers(0, V, (1, PROMPT))), cfg, state,
                    slot=dev(lane), start=dev(0), true_len=dev(n),
                    blocks=dev(1 + lane * mb + np.arange(mb)))
            seq = _clone(state)
            toks = rng.integers(0, V, (lanes, SPEC_K + 1))
            active = dev([1] * (lanes - 1) + [0])
            ver, _ = models.verify_step(params, dev(toks), cfg, state,
                                        active=active)
            dec = torch.stack([models.decode_step(
                params, dev(toks[:, i:i + 1]), cfg, seq, active=active)[0]
                for i in range(SPEC_K + 1)], dim=1)
        torch.cuda.synchronize()
        ver, dec = ver[:lanes - 1, :, :V].cpu(), dec[:lanes - 1, :, :V].cpu()
        scaled = (ver - dec).abs() / (1 + dec.abs())
        worst = np.unravel_index(int(scaled.argmax()), tuple(scaled.shape))
        same = (ver.argmax(-1) == dec.argmax(-1)).float().mean().item()
        lengths = state["kv"].length.tolist()
        print(f"{kv_dtype} pool: max |verify - decode| / (1 + |decode|) = "
              f"{scaled.max().item():.4g} (tol {tol}) at (lane, "
              f"position, token) {tuple(int(i) for i in worst)}: verify "
              f"{ver[worst].item():.6g} decode {dec[worst].item():.6g}; "
              f"greedy tokens equal at {same:.3f} of positions; lengths "
              f"{lengths} == {seq['kv'].length.tolist()}", flush=True)
        if not scaled.max().item() <= tol or \
                lengths != seq["kv"].length.tolist():
            raise SystemExit(f"5e: verify differs from sequential decode "
                             f"on the {kv_dtype} pool")
        del state, seq, ver, dec
    del params
    _free(torch)


# ------------------------------------------------------------ phase 6
def _traced(torch, fn, cpu: bool = True) -> tuple[list, object, float]:
    """Run ``fn`` once under ``torch.profiler``: (device rows (self device
    us, count, name) of kernels and copies, the profile, wall s).
    ``cpu=False`` records the device's activity only (a step of tens of
    thousands of host ops: the host-side records cost tens of seconds)."""
    acts = [torch.profiler.ProfilerActivity.CPU] if cpu else []
    acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        wall = time.perf_counter() - t0
    # device-side events only (kernels and copies): an operator's row
    # would count its kernels' time a second time
    rows = [(e.self_device_time_total, e.count, e.key)
            for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")]
    return rows, prof, wall


def _busy(rows, wall: float) -> tuple[float, float]:
    """(device busy ms, idle share) of a traced run."""
    busy_us = sum(r[0] for r in rows)
    return busy_us / 1e3, 1 - busy_us / 1e6 / wall


def profile_path(torch, arch: str, label: str, quant: bool = False) -> None:
    import numpy as np

    from repro_torch import configs as C
    from repro_torch import models
    from repro_torch.core.context import use_context
    from repro_torch.core.gemm import plan_model
    from repro_torch.core.plancache import PlanCache
    from repro_torch.train import graphs
    from repro_torch.train.servestep import make_serve_step

    phase(f"{label} profile: the {arch} path"
          + (" with --quantize int8" if quant else "") + ", warm, timed and "
          "traced, with the decode step eager and as CUDA-graph replays")
    cfg = C.get_config(arch)
    params = _params(torch, cfg, quant)
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(BATCH, PROMPT))).cuda()
    max_len = PROMPT + GEN + 1
    art = make_serve_step(cfg, device="cuda")
    # one state for every run (the graph holds its addresses): prefill
    # rewrites what a run reads
    state = models.init_decode_state(cfg, BATCH, max_len, device="cuda")

    def run(step, events=False):
        marks = [torch.cuda.Event(enable_timing=True)
                 for _ in range(GEN + 2)] if events else None
        if marks:
            marks[0].record()
        logits = art.prefill_fn(params, state, {"tokens": prompts})
        for i in range(GEN):
            if marks:
                marks[i + 1].record()
            tok = logits[:, :cfg.vocab_size].argmax(-1)
            logits = step(params, state, tok[:, None])
        if marks:
            marks[-1].record()
        torch.cuda.synchronize()
        return marks

    traced = {}
    with use_context(plan_cache=PlanCache(),
                     quant_mode="int8" if quant else None):
        plan_model(cfg, batch=BATCH, prompt_len=PROMPT, max_len=max_len,
                   params=params)
        for name, step in (("eager", art.decode_raw),
                           ("graph", art.decode_fn)):
            run(step)  # warm: kernels loaded, graph captured, allocator full
            t0 = time.perf_counter()
            marks = run(step, events=True)
            wall = time.perf_counter() - t0
            steps = [marks[i].elapsed_time(marks[i + 1])
                     for i in range(1, GEN + 1)]
            graphs.reset_launches()
            rows, prof, twall = _traced(torch, lambda: run(step))
            busy, idle = _busy(rows, twall)
            traced[name] = (rows, prof, graphs.launches())
            print(f"{name:5s} decode step: warm run prefill "
                  f"{marks[0].elapsed_time(marks[1]):.2f} ms, decode step "
                  f"{_spread(steps)}, wall {wall:.3f}s = "
                  f"{BATCH * GEN / wall:.1f} tok/s; traced run wall "
                  f"{twall * 1e3:.1f} ms, device busy {busy:.1f} ms, idle "
                  f"share {idle:.3f}", flush=True)
        if quant:
            # the replayed decode steps alone (prefill untraced): a step's
            # device time by kernel
            out = [art.prefill_fn(params, state, {"tokens": prompts})]

            def decode_only():
                for _ in range(GEN):
                    tok = out[0][:, :cfg.vocab_size].argmax(-1)
                    out[0] = art.decode_fn(params, state, tok[:, None])
                torch.cuda.synchronize()
            step_rows, _, step_wall = _traced(torch, decode_only)
    rows, prof, counts = traced["graph"]
    decode_kernel = "mm_split_k" if quant else "gemv_"
    if not any(decode_kernel in k for _, _, k in rows):
        # CUPTI gave the replays without their kernels: the busy time above
        # still holds them; the breakdown comes from the eager run
        print(f"the traced graph run shows no {decode_kernel} rows: CUPTI "
              "reports each replay as one entry on this card; the kernel "
              "breakdown below is the eager run's")
        rows, prof, counts = traced["eager"]
    busy_us = sum(r[0] for r in rows)
    for t, n, key in sorted(rows, reverse=True)[:14]:
        if t:
            print(f"  {t / 1e3:9.2f} ms {100 * t / busy_us:5.1f}% x{n:<5d} "
                  f"{key[:90]}")
    # the fat GEMM kernel by route: on these paths the tensor-core route
    # runs at prefill (M = 512) and split-K at decode (M = 4)
    fat = {name: (sum(t for t, _, k in rows if name in k) / 1e3,
                  sum(n for _, n, k in rows if name in k))
           for name in FAT_KERNELS}
    print("fat GEMM device ms (launches): " + ", ".join(
        f"{name} {ms:.2f} ({n})" for name, (ms, n) in fat.items())
        + f", all {sum(ms for ms, _ in fat.values()):.2f}")
    if quant:
        # by instantiation: mm_split_k<rows, int8, int8, col> at decode,
        # mm_wgmma<warpgroups, int8 mode> (tensor_core_int8) at prefill
        for t, n, key in sorted(rows, reverse=True):
            if any(name in key for name in FAT_KERNELS):
                name = key.replace("(anonymous namespace)::", "")
                print(f"  fat GEMM {t / 1e3:9.2f} ms x{n:<5d} {name[:100]}")
        step_split(torch, cfg, params, step_rows, step_wall)
    # the GEMV by kernel name (route, rows a thread holds, types): one
    # kernel launch per decode_matvec call (eager or replayed), the split-K
    # sum inside it
    gemv = {}
    for t, n, key in rows:
        if "gemv_" in key or "sum_splits" in key:
            name = key.replace("(anonymous namespace)::", "").split("(")[0]
            ms, cnt = gemv.get(name, (0.0, 0))
            gemv[name] = (ms + t / 1e3, cnt + n)
    for name, (ms, n) in sorted(gemv.items(), key=lambda kv: -kv[1][0]):
        print(f"  GEMV {ms:9.2f} ms x{n:<5d} {name[:90]}")
    n_gemv = sum(n for _, n in gemv.values())
    print(f"GEMV device ms {sum(ms for ms, _ in gemv.values()):.2f}, kernel "
          f"launches {n_gemv} for {counts['gemv']} decode_matvec calls")
    if n_gemv != counts["gemv"] or any("sum_splits" in k for k in gemv):
        raise SystemExit("the GEMV did not run one kernel launch per call")
    # WKV: its device time, and the kernels the device ran just before and
    # just after each launch: time_mix hands it (B, T, H, N) views, so no
    # layout copy may stand beside it
    wkv_ms = sum(t for t, _, k in rows if "wkv_kernel" in k) / 1e3
    wkv_n = sum(n for _, n, k in rows if "wkv_kernel" in k)
    if wkv_n:
        dev = sorted((e for e in prof.events()
                      if str(e.device_type).endswith("CUDA")),
                     key=lambda e: e.time_range.start)
        names = [e.name for e in dev]
        short = lambda nm: nm.replace("(anonymous namespace)::", "").split(
            "<")[0].split("(")[0][-48:]
        beside = [names[j] for i, nm in enumerate(names) if "wkv_kernel" in nm
                  for j in (i - 1, i + 1) if 0 <= j < len(names)]
        copies = [nm for nm in beside if "copy" in nm.lower()]
        kinds = sorted({short(nm) for nm in beside})
        print(f"WKV device ms {wkv_ms:.3f} (launches {wkv_n}); kernels "
              f"beside its launches: {kinds}; copy kernels among them: "
              f"{len(copies)}")
        if copies:
            raise SystemExit(f"layout copies beside the WKV kernel: "
                             f"{sorted(set(map(short, copies)))}")
    del params, state, art, traced, rows, prof
    _free(torch)


def _graph_rows(torch, fn, reps: int = 3) -> tuple[float, list]:
    """``fn`` captured as one CUDA graph, as it runs inside a replayed step:
    (median ms of a replay with CUDA events, device rows (us, count, name)
    of one replay, from ``reps`` traced replays). The tracer can miss the
    first kernels it sees, so a first replay inside the trace absorbs that
    and a ``spin_kernel`` (``torch.cuda._sleep``) marks where the counted
    replays start."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm, outside the capture
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn()
    ms = time_ms(torch, g.replay, reps=10)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        g.replay()
        torch.cuda.synchronize()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        for _ in range(reps):
            g.replay()
        torch.cuda.synchronize()
    dev = sorted((e for e in prof.events()
                  if str(e.device_type).endswith("CUDA")),
                 key=lambda e: e.time_range.start)
    mark = max(i for i, e in enumerate(dev) if "spin_kernel" in e.name)
    agg = {}
    for e in dev[mark + 1:]:
        t, n = agg.get(e.name, (0.0, 0))
        agg[e.name] = (t + e.time_range.elapsed_us(), n + 1)
    del g
    return ms, [(t / reps, n / reps, name) for name, (t, n) in agg.items()]


def step_split(torch, cfg, params, step_rows, step_wall: float) -> None:
    """6c: the int8 decode step's device time (its replays traced), split
    into the fat GEMM, the W8A8 quantizers and the rest. The quantizers
    are torch ops, not kernels of the port: before each of a step's 281
    int8 GEMMs, what ``qdense`` runs first (the input's per-tensor
    quantization: absmax, divide, round, clip, cast; and out_scale =
    s_x * s_w), and the f32 unembed's re-quantization (the reference's
    dynamic path). Their kernels in the step cannot be told from the same
    kernels of other ops by name, so the same calls at the step's shapes
    are captured as CUDA graphs and traced; the step's rows of the same
    kernel names are printed beside them."""
    from repro_torch.layers.quantized import quantize_activation
    from repro_torch.quant.int8 import combine_scales, quantize_linear

    L, d, f = cfg.n_layers, cfg.d_model, cfg.d_ff
    x = torch.randn((BATCH, d), device="cuda").to(cfg.dtype)
    h = torch.randn((BATCH, f), device="cuda").to(cfg.dtype)
    w = params["unembed"]
    nq, nkv, V = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim, \
        w.shape[1]
    w_scale = {n: torch.rand((n,), device="cuda") for n in (nq, nkv, d, f, V)}
    # a layer's q, k, v, wo, gate, w_in and w_out: (input, N)
    layer = [(x, nq), (x, nkv), (x, nkv), (x, d), (x, f), (x, f), (h, d)]

    def activations():
        for inp, n in layer * L + [(x, V)]:  # and the unembed's input
            combine_scales(quantize_activation(inp)[1], w_scale[n])

    per_step = lambda rs: sum(t for t, _, _ in rs) / 1e3 / GEN
    busy = per_step(step_rows)
    fat = per_step([r for r in step_rows
                    if any(k in r[2] for k in FAT_KERNELS)])
    short = lambda k: k.replace("void ", "").replace("at::native::", "")[:80]
    parts = {}
    for name, fn in (("activation quantization", activations),
                     ("unembed re-quantization", lambda: quantize_linear(w))):
        ms, rows = _graph_rows(torch, fn)
        dev = sum(t for t, _, _ in rows) / 1e3
        parts[name] = dev
        what = (f"{len(layer) * L + 1} calls with out_scale"
                if fn is activations else f"{tuple(w.shape)} {w.dtype}")
        print(f"  {name} ({what}): a replayed graph {ms:.3f} ms, its "
              f"kernels' device time {dev:.3f} ms, "
              f"{sum(n for _, n, _ in rows):g} kernels")
        for t, n, key in sorted(rows, reverse=True)[:8]:
            same = [r for r in step_rows if r[2] == key]
            print(f"    {t / 1e3:8.3f} ms x{n:<4g} (step: {per_step(same):.3f}"
                  f" ms x{sum(r[1] for r in same) / GEN:g}) {short(key)}")
    copies = per_step([r for r in step_rows if "direct_copy_kernel" in r[2]])
    rest = busy - fat - sum(parts.values())
    print(f"int8 decode step, {GEN} replays traced: wall "
          f"{step_wall * 1e3 / GEN:.2f} ms a step, device busy {busy:.2f} ms "
          f"(idle share {1 - busy * GEN / 1e3 / step_wall:.3f}) = fat GEMM "
          f"{fat:.2f} + " + " + ".join(f"{v:.2f} ({k})"
                                       for k, v in parts.items())
          + f" + the rest {rest:.2f} (attention, norms, rotary, residuals, "
          f"copies; direct_copy_kernel in the whole step {copies:.2f})")


# ------------------------------------------------------------ phase 7
def _engine_rule(dispatches, quant: bool = False,
                 arch: str = "qwen1.5-4b") -> dict[str, int]:
    """Launches the dispatch rule implies for the engine steps that ran."""
    steps = sum(dispatches.values())
    step = ENGINES[arch]["step_int8" if quant else "step"]
    return {k: n * steps for k, n in step.items()}


@dataclasses.dataclass
class EngineRun:
    counts: dict        # launches by kernel (eager plus replayed)
    tokens: dict        # prompt bytes -> generated ids, by request
    pool_bytes: int     # the KV pool's bytes (the kv_cache section)


def _kv_cache_check(m, engine, bf16: EngineRun | None,
                    arch: str = "qwen1.5-4b") -> None:
    """Phase 7b's (9f's) pool: int8 blocks and scales at about half the
    bytes of phase 7's (9e's) bf16 pool of as many blocks, and the blocks
    the same bytes would buy."""
    kv = m.kv_cache
    blocks = engine.num_kv_blocks
    bf16_block, int8_block = ENGINES[arch]["block_bytes"]
    want = {"kv_dtype": "int8", "quantized": True,
            "bytes_per_block": int8_block,
            "pool_bytes": blocks * int8_block,
            "bf16_pool_bytes": blocks * bf16_block}
    equal_bytes = kv["bf16_pool_bytes"] // kv["bytes_per_block"]
    print(f"kv_cache: {kv['kv_dtype']} pool of {blocks} blocks, "
          f"{kv['bytes_per_block']} bytes a block (bf16 {bf16_block}), "
          f"bytes_ratio {kv['bytes_ratio']:.4f}; pool {kv['pool_bytes'] / 1e9:.3f}"
          f" GB against the bf16 engine's {bf16.pool_bytes / 1e9:.3f} GB; "
          f"the same "
          f"bytes hold {equal_bytes} int8 blocks; scales k mean "
          f"{kv['scale_k_mean']:.4g} max {kv['scale_k_max']:.4g}, v mean "
          f"{kv['scale_v_mean']:.4g} max {kv['scale_v_max']:.4g}")
    if {k: kv[k] for k in want} != want or not (
            kv["bf16_pool_bytes"] == bf16.pool_bytes
            and 0 < kv["scale_k_max"] < 1 and 0 < kv["scale_v_max"] < 1):
        raise SystemExit(f"int8 kv_cache section {kv} differs from {want} "
                         f"(phase 7's pool: {bf16.pool_bytes} bytes)")


def _report(tag, met, step: str = "", step_ms=None) -> None:
    """One engine run's throughput, TTFT, ticks and pool peak, and the
    card's time of one kind of step where it was timed."""
    slo = met.slo_summary()["0"]
    bp = met.block_pool
    print(f"{tag}: {met.generated_tokens} tokens in {met.wall_s:.3f}s ="
          f" {met.tokens_per_sec:.1f} tok/s; TTFT p50 "
          f"{1e3 * slo['p50_ttft_s']:.1f} ms, p99 "
          f"{1e3 * slo['p99_ttft_s']:.1f} ms; {met.ticks} ticks "
          f"({1e3 * met.wall_s / met.ticks:.2f} ms a tick on the host "
          f"clock), {met.admissions} admissions, pool peak "
          f"{bp['peak_in_use']}/{bp['num_blocks'] - 1} blocks"
          + ("" if not step_ms else
             f"; {step} on the card {_spread(step_ms)}"), flush=True)


def _traced_rerun(torch, engine, requests) -> None:
    """The engine's trace once more under ``torch.profiler``: the idle
    share of the card and its device time by kernel."""
    engine.reset()
    rows, _, twall = _traced(torch, lambda: engine.run(requests()))
    busy, idle = _busy(rows, twall)
    print(f"traced rerun: wall {twall * 1e3:.1f} ms, device busy "
          f"{busy:.1f} ms, idle share {idle:.3f}")
    busy_us = sum(r[0] for r in rows)
    for t, n, key in sorted(rows, reverse=True)[:10]:
        if t:
            print(f"  {t / 1e3:9.2f} ms {100 * t / busy_us:5.1f}% "
                  f"x{n:<5d} {key[:90]}")


def _same_tokens(base: dict, tokens: dict) -> str:
    """The share of positions and of whole streams equal to another run's
    (information, not a gate: at full depth with random weights near-tie
    argmaxes flip between routes, and a flip forks the rest of the
    stream)."""
    total = sum(len(t) for t in base.values())
    match = sum(a == b for k, t in base.items() for a, b in zip(t, tokens[k]))
    return (f"{match}/{total} positions ({match / total:.3f}); streams "
            f"equal {sum(base[k] == tokens[k] for k in tokens)}/"
            f"{len(tokens)}")


def _lane_tables(torch, engine):
    """Every lane live on distinct blocks near its table's end; returns
    the block table written into the state."""
    import numpy as np

    kv = engine.state["kv"]
    lanes, bs = engine.num_slots, engine.kv_block_size
    per = (engine.num_kv_blocks - 1) // lanes
    table = np.zeros((lanes, engine.art.max_blocks), np.int32)
    for s_ in range(lanes):
        table[s_, :per] = 1 + s_ * per + np.arange(per)
    kv.table.copy_(torch.from_numpy(table))
    kv.length.copy_(torch.arange(per * bs - 1, per * bs - 1 - lanes, -1,
                                 dtype=torch.int32))
    return table


def _engine_replays(torch, engine) -> None:
    """Replay against eager, bit for bit: a decode tick with every lane
    live on distinct blocks, and one chunk of each bucket into lane 0 (one
    pad position, whose write goes to the null block)."""
    import numpy as np

    print("replayed steps against the same steps run eagerly:")
    art, cfg, lanes = engine.art, engine.cfg, engine.num_slots
    table = _lane_tables(torch, engine)
    rng = np.random.default_rng(7)
    replay_vs_eager(torch, f"decode tick ({lanes} lanes)", art.decode_fn,
                    art.decode_raw, engine.params, engine.state,
                    rng.integers(0, cfg.vocab_size, (lanes, 1)),
                    np.ones(lanes, np.int64))
    for bucket in art.chunk_buckets:
        replay_vs_eager(torch, f"prefill chunk @{bucket}", art.prefill_fn,
                        art.prefill_raw, engine.params, engine.state,
                        rng.integers(0, cfg.vocab_size, (1, bucket)), 0, 0,
                        bucket - 1, table[0].astype(np.int64))


def _spec_replays(torch, engine) -> None:
    """Replay against eager, bit for bit: the verify pass with lanes near
    their table's end (windows run onto the null-padded entry, so the null
    block takes duplicate writes) and one vacant lane; the propose step
    with two lanes catching up; a draft admission."""
    import numpy as np

    print("replayed steps against the same steps run eagerly:")
    art, cfg, lanes = engine.spec_art, engine.cfg, engine.num_slots
    _lane_tables(torch, engine)
    rng = np.random.default_rng(9)
    live = np.array([1] * (lanes - 1) + [0], np.int64)
    replay_vs_eager(torch, f"verify ({lanes} lanes x {SPEC_K + 1})",
                    art.verify_fn, art.verify_raw, engine.params,
                    engine.state,
                    rng.integers(0, cfg.vocab_size, (lanes, SPEC_K + 1)),
                    live)
    engine.draft_state["kv"].length.copy_(
        torch.arange(100, 100 + lanes, dtype=torch.int32))
    replay_vs_eager(torch, f"propose (k = {SPEC_K})", art.propose_fn,
                    art.propose_raw, engine.spec_draft_params,
                    engine.draft_state,
                    rng.integers(0, cfg.vocab_size, (lanes, 1)),
                    np.arange(lanes) % 2,
                    rng.integers(0, cfg.vocab_size, (lanes, 1)), live)
    prompt = rng.integers(0, cfg.vocab_size, (1, engine.prompt_pad))
    replay_vs_eager(torch, "draft admit", art.draft_admit_fn,
                    art.draft_admit_raw, engine.spec_draft_params,
                    engine.draft_state, prompt, 3, 100)


def _spec_rule(dispatches, arch: str = "qwen1.5-4b") -> dict[str, int]:
    """Launches the dispatch rule implies for the speculative engine's
    steps that ran."""
    step = ENGINES[arch]["step"]
    out = dict.fromkeys(step, 0)
    for name, n in dispatches.items():
        for k, per in SPEC_RULES[arch].get(name, step).items():
            out[k] += n * per
    return out


def run_engine(torch, profile: bool, bf16: EngineRun | None = None,
               arch: str = "qwen1.5-4b", label: str | None = None
               ) -> EngineRun:
    """Phase 7, or with ``bf16`` (phase 7's run) phase 7b: the same engine
    with --quantize int8 --kv-quantize int8; with ``arch`` olmoe-1b-7b,
    phases 9e and 9f. Besides phase 7's checks, the pool's bytes a block
    are the config's, and the warm rerun times the decode tick and each
    prefill chunk with CUDA events."""
    import numpy as np

    from repro_torch.core.context import use_context
    from repro_torch.launch import serve
    from repro_torch.serve import Request
    from repro_torch.train import graphs

    quant = bf16 is not None
    args = (["--arch", arch] + ENGINE_ARGS[2:]
            + (ENGINE_INT8_ARGS if quant else []))
    label = label or ("7b" if quant else "7")
    phase(label + " engine path: repro_torch.launch.serve "
          + " ".join(a if a else "''" for a in args)
          + " (full width and depth)")
    torch.cuda.reset_peak_memory_stats()
    graphs.reset_launches()
    t0 = time.perf_counter()
    res = serve.main(args)
    wall = time.perf_counter() - t0
    counts = graphs.launches()
    replayed = dict(graphs.replayed)
    engine, m, trace = res["engine"], res["metrics"], res["trace"]
    cfg = engine.cfg
    want = _engine_rule(engine.dispatches, quant, arch)
    print(f"steps {dict(engine.dispatches)}; launches {counts}, of which "
          f"graph replays {replayed} (rule: {want}); graphs captured: "
          f"decode {len(engine.art.decode_fn.graphs)}, prefill chunk "
          f"{len(engine.art.prefill_fn.graphs)}")
    if res["lazy_solves"] or res["misses"]:
        raise SystemExit(f"engine serving was not plan-warm: "
                         f"{m.plan_cache}")
    if counts != want:
        raise SystemExit(f"engine launch counts {counts} differ from the "
                         f"dispatch rule's {want}")
    done = engine.finished
    if len(done) != len(trace) or not all(
            st.finish_reason == "length"
            and len(st.tokens) == st.request.budget(engine.max_len)
            and all(0 <= t < cfg.vocab_size for t in st.tokens)
            for st in done):
        raise SystemExit(f"engine: {len(done)} of {len(trace)} requests "
                         "finished, or a bad token id")

    _report(f"first run (graphs captured in it; {wall:.1f}s with init and "
           "warm-up)", m)
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          " GiB" + ("" if res["quantize_s"] is None else
                    f"; weights quantized at load in {res['quantize_s']:.3f}s"))
    tokens = {st.request.prompt.tobytes(): st.tokens for st in done}
    if quant:
        _kv_cache_check(m, engine, bf16, arch)
        print("tokens equal to the bf16 engine's at "
              + _same_tokens(bf16.tokens, tokens))
    elif m.kv_cache["bytes_per_block"] != ENGINES[arch]["block_bytes"][0]:
        raise SystemExit(f"{label}: {m.kv_cache['bytes_per_block']} bytes a "
                         f"pool block, {arch} needs "
                         f"{ENGINES[arch]['block_bytes'][0]}")
    else:
        print(f"kv_cache: bf16 pool of {engine.num_kv_blocks} blocks of "
              f"{m.kv_cache['bytes_per_block']} bytes "
              f"({m.kv_cache['pool_bytes'] / 1e9:.3f} GB)")

    # the reruns and checks under the run's context (its warm plans)
    with use_context(res["context"]):
        # a warm rerun of the same trace: every step a replay, decode ticks
        # timed with CUDA events around the call (input copies, replay)
        again = lambda: [Request(prompt=r.prompt, max_new_tokens=r.max_new_tokens)
                         for r in trace]
        decode, chunk = engine.art.decode_fn, engine.art.prefill_fn
        marks, chunks = [], {}

        def timed(step, log):
            def call(*args):
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                ev[0].record()
                out = step(*args)
                ev[1].record()
                log(args, ev)
                return out
            return call

        engine.art.decode_fn = timed(decode, lambda a, ev: marks.append(ev))
        engine.art.prefill_fn = timed(chunk, lambda a, ev: chunks.setdefault(
            graphs.as_tensor(a[2]).shape[1], []).append(ev))
        engine.reset()
        graphs.reset_launches()
        m2 = engine.run(again())
        engine.art.decode_fn, engine.art.prefill_fn = decode, chunk
        counts2 = graphs.launches()
        want2 = _engine_rule(engine.dispatches, quant, arch)
        _report("warm rerun", m2, "decode tick",
                [a.elapsed_time(b) for a, b in marks])
        print("prefill chunks on the card (CUDA events around the call): "
              + "; ".join(f"@{n} {_spread([a.elapsed_time(b) for a, b in ev])}"
                          f" x{len(ev)}" for n, ev in sorted(chunks.items())),
              flush=True)
        if counts2 != want2 or m2.plan_cache["lazy_solves"] or \
                m2.plan_cache["misses"]:
            raise SystemExit(f"warm rerun: launches {counts2} (rule {want2}), "
                             f"plan cache {m2.plan_cache}")
        if profile:
            _traced_rerun(torch, engine, again)

        _engine_replays(torch, engine)
    pool_bytes = m.kv_cache["pool_bytes"]
    del res, engine, m, m2
    _free(torch)
    return EngineRun(counts, tokens, pool_bytes)


def run_spec_engine(torch, profile: bool, bf16: EngineRun,
                    arch: str = "qwen1.5-4b", label: str = "7c"
                    ) -> EngineRun:
    """Phase 7c: phase 7's engine decoding speculatively (an int8
    qwen1.5-4b draft proposing k = 4 tokens a lane, the float target
    verifying them); with ``arch`` olmoe-1b-7b phase 9g (the draft olmoe
    at int8, ``bf16`` 9e's run). Gated: every request finishes with in-vocab ids, zero
    lazy solves and misses, launches equal to the dispatch rule for the
    steps that ran, the speculation section's committed tokens equal to
    the tokens generated less each request's first, and the verify,
    propose and draft-admit graphs each replayed once against their eager
    step from one state, bit for bit. Printed: acceptance, tokens a round,
    the round's card time split into propose and verify, tok/s and TTFT
    of a warm rerun, peak memory, and the tokens equal to phase 7's."""
    import numpy as np

    from repro_torch.core.context import use_context
    from repro_torch.launch import serve
    from repro_torch.serve import Request
    from repro_torch.train import graphs

    args = (["--arch", arch] + ENGINE_ARGS[2:]
            + ["--spec-draft-config", arch] + ENGINE_SPEC_ARGS[2:])
    phase(label + " speculative engine path: repro_torch.launch.serve "
          + " ".join(a if a else "''" for a in args)
          + " (full width and depth; the draft int8)")
    torch.cuda.reset_peak_memory_stats()
    graphs.reset_launches()
    t0 = time.perf_counter()
    res = serve.main(args)
    wall = time.perf_counter() - t0
    counts = graphs.launches()
    replayed = dict(graphs.replayed)
    engine, m, trace = res["engine"], res["metrics"], res["trace"]
    cfg, art = engine.cfg, engine.spec_art
    rule = lambda dispatches: _spec_rule(dispatches, arch)
    want = rule(engine.dispatches)
    print(f"steps {dict(engine.dispatches)}; launches {counts}, of which "
          f"graph replays {replayed} (rule: {want}); graphs captured: "
          f"verify {len(art.verify_fn.graphs)}, propose "
          f"{len(art.propose_fn.graphs)}, draft admit "
          f"{len(art.draft_admit_fn.graphs)}, prefill chunk "
          f"{len(engine.art.prefill_fn.graphs)}")
    if res["lazy_solves"] or res["misses"]:
        raise SystemExit(f"speculative engine serving was not plan-warm: "
                         f"{m.plan_cache}")
    if counts != want:
        raise SystemExit(f"speculative engine launch counts {counts} differ "
                         f"from the dispatch rule's {want}")
    done = engine.finished
    if len(done) != len(trace) or not all(
            st.finish_reason == "length"
            and len(st.tokens) == st.request.budget(engine.max_len)
            and all(0 <= t < cfg.vocab_size for t in st.tokens)
            for st in done):
        raise SystemExit(f"{label}: {len(done)} of {len(trace)} requests "
                         "finished, or a bad token id")
    sp = m.speculation
    print(f"speculation: {sp['rounds']} rounds, accepted "
          f"{sp['accepted_tokens']}/{sp['proposed_tokens']} proposals "
          f"(acceptance rate {sp['acceptance_rate']:.4f}), "
          f"{sp['mean_committed_per_round']:.3f} tokens committed a lane "
          f"a round, {sp['bonus_tokens']} bonus tokens; draft_s "
          f"{sp['draft_s']:.3f} verify_s {sp['verify_s']:.3f} (host clock, "
          "first run)")
    if sp["committed_tokens"] != m.generated_tokens - len(trace):
        raise SystemExit(f"{label}: committed_tokens "
                         f"{sp['committed_tokens']} != "
                         f"generated {m.generated_tokens} - requests "
                         f"{len(trace)}")
    _report(f"first run (graphs captured in it; {wall:.1f}s with init, "
            "the draft's quantization and warm-up)", m)
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          " GiB (target f32 weights, int8 draft, both states)")
    tokens = {st.request.prompt.tobytes(): st.tokens for st in done}
    print("tokens equal to the float engine's at "
          + _same_tokens(bf16.tokens, tokens))

    with use_context(res["context"]):
        again = lambda: [Request(prompt=r.prompt,
                                 max_new_tokens=r.max_new_tokens)
                         for r in trace]
        steps = {"propose": art.propose_fn, "verify": art.verify_fn}
        marks = {name: [] for name in steps}

        def timed(name):
            def call(*a):
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                ev[0].record()
                out = steps[name](*a)
                ev[1].record()
                marks[name].append(ev)
                return out
            return call

        art.propose_fn, art.verify_fn = timed("propose"), timed("verify")
        engine.reset()
        graphs.reset_launches()
        m2 = engine.run(again())
        art.propose_fn, art.verify_fn = steps["propose"], steps["verify"]
        counts2, want2 = graphs.launches(), rule(engine.dispatches)
        ms = {k: [a.elapsed_time(b) for a, b in v] for k, v in marks.items()}
        rounds = [p + v for p, v in zip(ms["propose"], ms["verify"])]
        _report("warm rerun", m2, "round (propose + verify)", rounds)
        sp2 = m2.speculation
        print(f"warm rerun round on the card: propose {_spread(ms['propose'])}"
              f", verify {_spread(ms['verify'])}; host clock draft_s "
              f"{sp2['draft_s']:.3f} verify_s {sp2['verify_s']:.3f} over "
              f"{sp2['rounds']} lane-rounds ({len(rounds)} rounds)",
              flush=True)
        if counts2 != want2 or m2.plan_cache["lazy_solves"] or \
                m2.plan_cache["misses"]:
            raise SystemExit(f"{label} warm rerun: launches {counts2} (rule "
                             f"{want2}), plan cache {m2.plan_cache}")
        # the host's share of a round after the verify pass: the (lanes,
        # k + 1, Vp) f32 logits brought to the host (inside verify_s), then
        # greedy_rows lane by lane (after it), on the host clock
        from repro_torch.serve import spec as spec_lib

        logits = torch.randn((engine.num_slots, SPEC_K + 1, cfg.padded_vocab),
                             device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        host = logits.cpu().numpy()
        t1 = time.perf_counter()
        for row in host:
            spec_lib.greedy_rows(row, cfg.vocab_size)
        t2 = time.perf_counter()
        print(f"host side of a round: {host.nbytes / 1e6:.1f} MB of logits "
              f"to the host {1e3 * (t1 - t0):.2f} ms, greedy_rows over "
              f"{len(host)} lanes {1e3 * (t2 - t1):.2f} ms (host clock)")
        del logits, host
        if profile:
            _traced_rerun(torch, engine, again)

        _spec_replays(torch, engine)
    del res, engine, m, m2, art
    _free(torch)
    return EngineRun(counts, tokens, 0)


# ------------------------------------------------------------ phase 8
# where phase 8 writes its traces, metrics and refined plans: ``--out
# DIR`` on the command line, else build/phase8 (gitignored)
TRACE_DIR = os.path.join(ROOT, "build", "phase8")
TRACE_ARGS = ["--metrics-interval-ticks", "8"]
ATTRIB_TOP = 6  # signatures printed with measured against modeled seconds


def _trace_args(name: str) -> list[str]:
    os.makedirs(TRACE_DIR, exist_ok=True)
    base = os.path.join(TRACE_DIR, name)
    return ["--trace-out", base + ".trace.json", "--metrics-json",
            base + ".metrics.json"] + TRACE_ARGS


def _check_trace(path: str, m, steps: set[str], requests: int) -> None:
    """The saved trace validates (the port's validate_chrome_trace: the
    card has no JAX), every span's phase is in PHASES, every tick has its
    expire, bind and step spans, and the attribution reconciles."""
    import collections

    from repro_torch.obs import PHASES, validate_chrome_trace

    with open(path) as f:
        obj = json.load(f)
    info = validate_chrome_trace(
        obj, require_phases=("expire", "bind", "prefill-chunk", "sample")
        + tuple(sorted(steps)), min_requests=requests)
    stray = set(info["phase_spans"]) - set(PHASES)
    by_tick = collections.defaultdict(set)
    for ev in obj["traceEvents"]:
        if ev.get("ph") == "X" and ev.get("cat") == "phase":
            by_tick[ev["args"]["tick"]].add(ev["name"])
    bare = [t for t in range(m.ticks)
            if not ({"expire", "bind"} <= by_tick[t]
                    and by_tick[t] & (steps | {"prefill-chunk"}))]
    recon = m.attribution["reconciliation_error"]
    print(f"trace {os.path.relpath(path, ROOT)}: {info['events']} events, "
          f"spans {info['phase_spans']}, {info['completed_requests']} "
          f"requests, {info['counter_samples']} counter samples; "
          f"{m.ticks} ticks; reconciliation error {recon!r}", flush=True)
    if stray or bare or recon is None or abs(recon) > 1e-9:
        raise SystemExit(f"trace {path}: phases outside PHASES {stray}, "
                         f"ticks without their spans {bare[:10]}, "
                         f"reconciliation error {recon}")


def _phase_table(engine, m, label: str) -> dict:
    """Host ms a tick of each phase (p50 / p99 of its spans, and its total
    over the ticks) and, for a device phase, the same of its CUDA-event
    device time; the engine's host share of the wall time."""
    import numpy as np

    from repro_torch.obs import PHASES

    tr = engine.tracer
    host, dev = tr.phase_durations(), tr.device_durations()
    out, device_total = {}, 0.0
    print(f"{label}: {m.ticks} ticks, {1e3 * m.wall_s / m.ticks:.3f} ms a "
          "tick on the host clock; by phase (ms: p50 / p99 of one span, "
          "total a tick):")
    for name in sorted(host):
        h = 1e3 * np.asarray(host[name])
        row = {"kind": PHASES[name], "spans": len(h),
               "host_p50": float(np.percentile(h, 50)),
               "host_p99": float(np.percentile(h, 99)),
               "host_tick": float(h.sum() / m.ticks)}
        line = (f"  {name:14s} {row['kind']:6s} x{len(h):<4d} host "
                f"{row['host_p50']:8.3f} / {row['host_p99']:8.3f} / "
                f"{row['host_tick']:8.3f}")
        if PHASES[name] == "device":
            d = 1e3 * np.asarray(dev[name])
            device_total += float(d.sum())
            row.update(dev_p50=float(np.percentile(d, 50)),
                       dev_p99=float(np.percentile(d, 99)),
                       dev_tick=float(d.sum() / m.ticks))
            line += (f"   device {row['dev_p50']:8.3f} / "
                     f"{row['dev_p99']:8.3f} / {row['dev_tick']:8.3f}")
        out[name] = row
        print(line)
    wall = 1e3 * m.wall_s
    share = 1.0 - device_total / wall
    print(f"  device phases' device time {device_total:.2f} ms of "
          f"{wall:.2f} ms wall: host share (the card idle) {share:.4f}",
          flush=True)
    return {"phases": out, "host_share": share,
            "tick_ms": wall / m.ticks}


def _attrib_top(m) -> None:
    a = m.attribution
    print(f"attribution: {a['signatures']} signatures, {a['drifted_count']} "
          f"drifted, bound shares {a['bound_share']}; top by device "
          "seconds (measured per call against the h100 model's t_total):")
    for r in a["by_device_s"][:ATTRIB_TOP]:
        print(f"  {r['m']:>4d}x{r['k']}x{r['n']} {r['in_dtype']}->"
              f"{r['out_dtype']} plan=({r['bm']}, {r['bk']}, {r['bn']}) "
              f"calls={r['calls']} device {1e3 * r['device_s']:.2f} ms "
              f"(share {r['share']:.3f}), per call measured "
              f"{1e6 * r['measured_per_call_s']:.1f} us, modeled "
              f"{1e6 * r['t_total_s']:.1f} us, ratio "
              f"{r['measured_vs_modeled']:.2f} ({r['bound']}-bound)")


def run_traced_engine(torch, label: str, base: EngineRun) -> dict:
    """Phase 8a (``base`` phase 7's run) or 8b (``base`` 7c's): the same
    engine through the launcher with the flight recorder on
    (``--trace-out``, ``--metrics-interval-ticks 8``). Gated: the trace
    validates and covers every tick, the attribution reconciles, zero lazy
    solves and misses, launches equal to the dispatch rule, the tokens
    equal to ``base``'s untraced run, replays equal to eager steps.
    Printed: a warm traced rerun's host and device ms by phase, its host
    share, and the top signatures measured against modeled."""
    from repro_torch.core.context import use_context
    from repro_torch.launch import serve
    from repro_torch.serve import Request
    from repro_torch.train import graphs

    spec = label == "8b"
    args = (ENGINE_ARGS + (ENGINE_SPEC_ARGS if spec else [])
            + _trace_args(label))
    phase(f"{label} traced {'speculative ' if spec else ''}engine: "
          "repro_torch.launch.serve "
          + " ".join(a if a else "''" for a in args))
    graphs.reset_launches()
    res = serve.main(args)
    counts = graphs.launches()
    engine, m, trace = res["engine"], res["metrics"], res["trace"]
    want = (_spec_rule if spec else _engine_rule)(engine.dispatches)
    tokens = {st.request.prompt.tobytes(): st.tokens for st in engine.finished}
    print(f"steps {dict(engine.dispatches)}; launches {counts} (rule "
          f"{want}); tokens equal to the untraced run's at "
          + _same_tokens(base.tokens, tokens))
    if res["lazy_solves"] or res["misses"] or counts != want \
            or tokens != base.tokens:
        raise SystemExit(f"{label}: plan cache {m.plan_cache}, launches "
                         f"{counts} (rule {want}), or tokens that differ "
                         "from the untraced run's")
    steps = {"spec-draft", "spec-verify"} if spec else {"decode"}
    _check_trace(args[args.index("--trace-out") + 1], m, steps, len(trace))
    if spec:
        gauges = engine.registry.collect()
        sp = m.speculation
        print(f"registry: {len(engine.registry.snapshots)} snapshots; "
              f"serve_spec gauges rounds "
              f"{gauges['repro_serve_spec_rounds']:.0f}, acceptance_rate "
              f"{gauges['repro_serve_spec_acceptance_rate']:.4f}")
        if gauges["repro_serve_spec_rounds"] != sp["rounds"]:
            raise SystemExit("8b: the serve_spec gauges differ from the "
                             "speculation section")
    with use_context(res["context"]):
        again = [Request(prompt=r.prompt, max_new_tokens=r.max_new_tokens)
                 for r in trace]
        engine.reset()
        graphs.reset_launches()
        m2 = engine.run(again)
        if graphs.launches() != (_spec_rule if spec else _engine_rule)(
                engine.dispatches) or m2.plan_cache["lazy_solves"]:
            raise SystemExit(f"{label} warm rerun: launches "
                             f"{graphs.launches()}, plan cache "
                             f"{m2.plan_cache}")
        table = _phase_table(engine, m2, f"{label} warm traced rerun")
        recon = m2.attribution["reconciliation_error"]
        if recon is None or abs(recon) > 1e-9:
            raise SystemExit(f"{label} warm rerun: reconciliation error "
                             f"{recon}")
        _attrib_top(m2)
        if not spec:
            _reconcile(torch, engine, lambda: [
                Request(prompt=r.prompt, max_new_tokens=r.max_new_tokens)
                for r in trace], table)
        (_spec_replays if spec else _engine_replays)(torch, engine)
    del res, engine, m, m2
    _free(torch)
    return {"counts": counts, "table": table, "tokens": tokens}


def _reconcile(torch, engine, requests, table: dict) -> dict:
    """The card's idle time in the engine's wall W, counted two ways on one
    more warm traced run, this one under ``torch.profiler``: phase 8's host
    share 1 - D/W (D: the device phases' CUDA-event time) and phase 7's
    profiler idle share 1 - K/W (K: the union of the kernels' and copies'
    device intervals). D - K is time inside a device span with no kernel
    running; the lengths of the gaps between kernels say what fills it,
    and W against the unprofiled rerun's what the profiler itself costs."""
    from repro_torch.obs import PHASES

    engine.reset()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        m = engine.run(requests())
    dev = engine.tracer.device_durations()
    d_ms = 1e3 * sum(sum(v) for k, v in dev.items()
                     if PHASES[k] == "device")
    w_ms = 1e3 * m.wall_s
    busy = []
    for start, end in sorted((e.time_range.start, e.time_range.end)
                             for e in prof.events()
                             if str(e.device_type).endswith("CUDA")):
        if busy and start <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], end)
        else:
            busy.append([start, end])
    if not busy:
        raise SystemExit("8a: the profiler saw no device activity")
    k_ms = sum(end - start for start, end in busy) / 1e3  # us -> ms
    gaps = [(b[0] - a[1]) / 1e3 for a, b in zip(busy, busy[1:])]
    edges = w_ms - (busy[-1][1] - busy[0][0]) / 1e3
    out = {"wall_ms": w_ms, "device_ms": d_ms, "kernel_ms": k_ms,
           "unprofiled_wall_ms": table["tick_ms"] * m.ticks,
           "host_share": 1 - d_ms / w_ms, "idle_share": 1 - k_ms / w_ms,
           "in_span_share": (d_ms - k_ms) / w_ms, "edges_ms": edges,
           "gaps": {}}
    print(f"profiled warm rerun: wall {w_ms:.2f} ms (unprofiled "
          f"{out['unprofiled_wall_ms']:.2f}), device phases' CUDA-event "
          f"time {d_ms:.2f} ms, kernels and copies busy {k_ms:.2f} ms in "
          f"{len(busy)} stretches; host share 1 - D/W "
          f"{out['host_share']:.4f}, profiler idle share 1 - K/W "
          f"{out['idle_share']:.4f}, in a device span with no kernel "
          f"(D - K)/W {out['in_span_share']:.4f}; gaps between kernels "
          "(count, total ms):", flush=True)
    for lo, hi in ((0, 0.005), (0.005, 0.05), (0.05, 1.0),
                   (1.0, float("inf"))):
        g = [x for x in gaps if lo <= x < hi]
        out["gaps"][f"{lo}-{hi} ms"] = (len(g), sum(g))
        print(f"  {lo:g}-{hi:g} ms: {len(g)}, {sum(g):.2f}")
    print(f"  before the first and after the last kernel: {edges:.2f} ms",
          flush=True)
    del prof
    return out


def run_measured_engine(torch, traced: dict) -> dict:
    """Phase 8c: phase 7's engine with ``--measure-plans`` (the warm-up's
    plans refined by CUDA-event timings of the fat GEMM at each plan and
    its neighbouring built tiles, before the first call) and
    ``--rebalance-drifted``, in its own context and plan cache. Gated:
    every (signature, launched plan) the refinement timed, and every final
    plan, matches the plain version at phase 3a's tolerance with each
    epilogue (none, bias, silu), and on a skinny key the GEMV at the
    plan's (bk, bn) too (the launcher's timing is wrapped through
    ``serve.main(measure_factory=)``; these launches are not counted),
    the refined cache round-trips through its JSON, the engine under it
    makes zero lazy solves, its launches equal the rule, its trace
    validates and its replays equal its eager steps. Printed, not gated: measured / refined / kept, old -> new
    kernel ms of each refined signature (and the GEMV's at both plans for
    a skinny one), and the decode tick's device ms before (8a) and
    after."""
    from repro_torch.core import autotune
    from repro_torch.core import perfmodel as pm
    from repro_torch.core.context import use_context
    from repro_torch.core.gemm import _is_skinny
    from repro_torch.core.plancache import PlanCache
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import serve
    from repro_torch.serve import Request
    from repro_torch.train import graphs

    cache_path = os.path.join(TRACE_DIR, "8c.plans.json")
    args = (ENGINE_ARGS + ["--measure-plans", "--rebalance-drifted",
                           "--plan-cache", cache_path] + _trace_args("8c"))
    phase("8c measured plans: repro_torch.launch.serve "
          + " ".join(a if a else "''" for a in args))
    if os.path.exists(cache_path):
        os.remove(cache_path)
    seconds, checked, checkers = {}, [], {}
    gen = torch.Generator(device="cuda").manual_seed(1)

    def check(what, got, want, kernel, dtype):
        err = (got.double() - want.double()).abs().max().item()
        tol = _tolerance(kernel, str(dtype).removeprefix("torch."),
                         want.double().abs().max().item())
        checked.append((what, err, tol))
        if not err <= tol:
            raise SystemExit(f"8c: {what} disagrees with its plain "
                             f"version: {err} > {tol}")

    def checking(M, K, N, **kw):
        """The launcher's timing, each launched plan held against the plain
        version first: the fat GEMM with each epilogue the engine fuses
        at a plan key (none, bias, silu), and on a skinny key the GEMV at
        the (bk, bn) it would take from the candidate, as passed and as
        launched."""
        fn = autotune.wallclock_measure_fn(M, K, N, **kw)
        din, dout, lay = kw["in_dtype"], kw["out_dtype"], kw["b_layout"]
        sig = (M, K, N, din, dout, lay)
        a, b = autotune.gemm_inputs(M, K, N, in_dtype=din, b_layout=lay,
                                    device="cuda")
        bias = torch.randn((N,), generator=gen, device="cuda")
        fat, gemv = set(), set()

        def measured(plan):
            p = fn.launched(plan)
            with graphs.counted():
                t = fn(plan)
                if p not in fat:
                    fat.add(p)
                    for bi, act in ((None, None), (bias, None),
                                    (None, "silu")):
                        got = ops.balanced_matmul(
                            a, b, bi, plan=p, out_dtype=dout, b_layout=lay,
                            activation=act)
                        want = ref.matmul_ref(a, b, out_dtype=dout,
                                              b_layout=lay, bias=bi,
                                              activation=act)
                        check(f"fat GEMM {sig} at {p} "
                              + ("+ bias" if bi is not None else act
                                 or "bare"), got, want, "matmul", dout)
                for q in ((plan, p) if _is_skinny(M, K, N) else ()):
                    if (q.bk, q.bn) in gemv:
                        continue
                    gemv.add((q.bk, q.bn))
                    got = ops.decode_matvec(a, b, bk=q.bk, bn=q.bn,
                                            out_dtype=dout, w_layout=lay)
                    want = ref.gemv_ref(a, b, out_dtype=dout, w_layout=lay)
                    check(f"GEMV {sig} at bk={q.bk} bn={q.bn}", got, want,
                          "gemv", dout)
            seconds[(sig, p)] = t
            return t

        measured.launched = fn.launched
        checkers[sig] = measured
        return measured

    graphs.reset_launches()
    res = serve.main(args, measure_factory=checking)
    counts = graphs.launches()
    engine, m, trace, ctx = (res["engine"], res["metrics"], res["trace"],
                             res["context"])
    stats, changed = res["measured"]["stats"], res["measured"]["changed"]
    want = _engine_rule(engine.dispatches)
    fats = sum(w.startswith("fat") for w, *_ in checked)
    print(f"refinement: {stats}; {fats // 3} (signature, plan) pairs timed, "
          f"each held against its plain version with every epilogue (none, "
          f"bias, silu), and {len(checked) - fats} GEMV (signature, bk, bn) "
          f"at the skinny keys' candidates (worst err/tol "
          f"{max(e / t if t else e for _, e, t in checked):.3g}); "
          f"rebalance: {res['rebalanced']}")
    if fats != 3 * stats["measured"]:
        raise SystemExit(f"8c: {stats['measured']} measurements, "
                         f"{fats // 3} checked")
    # a plan --rebalance-drifted re-solved after the refinement is held too
    late = 0
    for key in ctx.plan_cache.warm_keys:
        _, M, K, N, din, dout, lay = key
        sig = (M, K, N, getattr(torch, din), getattr(torch, dout), lay)
        plan = ctx.plan_cache.entries[key]
        if (sig, checkers[sig].launched(plan)) not in seconds:
            checkers[sig](plan)
            late += 1
    print(f"final plans of the {len(ctx.plan_cache.warm_keys)} warm keys: "
          f"{late} not timed by the refinement, held now")
    # each warm signature's fat GEMM at its solved plan: measured against
    # the h100 model (the calibration's input)
    print("fat GEMM at the solved plan, measured (CUDA events, L2 evicted) "
          "against the h100 model's t_total:")
    for key in sorted(ctx.plan_cache.warm_keys):
        _, M, K, N, din, dout, lay = key
        sig = (M, K, N, getattr(torch, din), getattr(torch, dout), lay)
        old = changed.get(key, (ctx.plan_cache.entries[key],))[0]
        p = ops._clamp_plan(old, M, K, N, sig[3], ctx.hw, lay)
        est = pm.estimate_gemm(ctx.hw, M, K, N, p.bm, p.bk, p.bn,
                               in_dtype=sig[3], out_dtype=sig[4],
                               b_layout=lay)
        ms = 1e3 * seconds[(sig, p)]
        print(f"  {M:>4d}x{K}x{N} {din}->{dout} {lay} "
              f"{ctx.hw.gemm_route(M, sig[3], lay):11s} plan=({p.bm}, "
              f"{p.bk}, {p.bn}) measured {ms:.4f} ms, modeled "
              f"{1e3 * est.t_total:.4f} ms, ratio {ms / 1e3 / est.t_total:.2f}")
    for key, (old, new) in sorted(changed.items()):
        _, M, K, N, din, dout, lay = key
        sig = (M, K, N, getattr(torch, din), getattr(torch, dout), lay)
        launched = ops._clamp_plan(old, M, K, N, sig[3], ctx.hw, lay)
        line = (f"  {M}x{K}x{N} {din}->{dout} {lay}: ({old.bm}, {old.bk}, "
                f"{old.bn}) {1e3 * seconds[(sig, launched)]:.4f} ms -> "
                f"({new.bm}, {new.bk}, {new.bn}) "
                f"{1e3 * seconds[(sig, new)]:.4f} ms (fat GEMM)")
        if _is_skinny(M, K, N):  # the GEMV shares the key
            a, w = autotune.gemm_inputs(M, K, N, in_dtype=sig[3],
                                        b_layout=lay, device="cuda")
            gemv = {p: time_ms(torch, lambda p=p: ops.decode_matvec(
                a, w, bk=p.bk, bn=p.bn, out_dtype=sig[4], w_layout=lay))
                for p in (old, new)}
            line += (f"; GEMV {gemv[old]:.4f} ms -> {gemv[new]:.4f} ms"
                     + (" (slower)" if gemv[new] > gemv[old] else ""))
            del a, w
        print(line, flush=True)
    loaded = PlanCache(path=cache_path)
    n = loaded.load()
    same = (loaded.entries == ctx.plan_cache.entries
            and loaded.balance == ctx.plan_cache.balance)
    print(f"refined cache {os.path.relpath(cache_path, ROOT)}: {n} plans "
          f"loaded back, equal to the engine's: {same}")
    if not same or res["lazy_solves"] or res["misses"] or counts != want:
        raise SystemExit(f"8c: cache round trip {same}, plan cache "
                         f"{m.plan_cache}, launches {counts} (rule {want})")
    _check_trace(args[args.index("--trace-out") + 1], m, {"decode"},
                 len(trace))
    tokens = {st.request.prompt.tobytes(): st.tokens for st in engine.finished}
    print("tokens equal to 8a's (solved plans) at "
          + _same_tokens(traced["tokens"], tokens) + " (printed, not gated: "
          "other tiles sum in another order)")
    with use_context(ctx):
        again = [Request(prompt=r.prompt, max_new_tokens=r.max_new_tokens)
                 for r in trace]
        engine.reset()
        m2 = engine.run(again)
        if m2.plan_cache["lazy_solves"] or m2.plan_cache["misses"]:
            raise SystemExit(f"8c warm rerun: plan cache {m2.plan_cache}")
        table = _phase_table(engine, m2, "8c warm traced rerun (refined)")
        before = traced["table"]["phases"]["decode"]
        after = table["phases"]["decode"]
        print(f"decode tick on the card: {before['dev_p50']:.3f} ms p50 "
              f"(8a, solved plans) -> {after['dev_p50']:.3f} ms p50 "
              f"(refined); host ms a tick {traced['table']['tick_ms']:.3f} "
              f"-> {table['tick_ms']:.3f} (printed, not gated)")
        _attrib_top(m2)
        _engine_replays(torch, engine)
    del res, engine, m, m2
    _free(torch)
    return counts


# ------------------------------------------------------------ phase 13
# the training path: qwen1.5-4b at its full width and depth (40 layers, d
# 2560, d_ff 6912, vocab 151,936; f32 weights, bf16 activations, AdamW,
# remat on), the reference launcher's batch of 8 x 128 tokens from
# data.synthetic with seed 0
TRAIN_ARCH = "qwen1.5-4b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 128, 5
TRAIN_PEAK_GIB = 75.0
# 13c: the card against the CPU at 2 layers, 3 steps at batch 2 x 128 (the
# fat GEMM) and 1 x 64 (64 rows: the GEMV forward and its dA). Stated
# before the first card run from the CPU path against itself (embedding x
# (1 + 2**-20), or every product summed in f64) at 2 layers, d 640 and
# 1280, bf16 activations: losses within 1.4e-4 relative, each leaf's
# step-1 gradient within 1.2e-2 relative L2 (the key bias; the rest 1e-2).
# The 3-step update (params after - before) is Adam's: about lr times the
# sign of the gradient, so an element whose gradient lies within the
# rounding of zero flips the sign of its whole step. Per leaf that reached
# 0.34 relative L2 (0.42 at d 256; the key bias, whose gradient is small;
# the embedding 0.1, the rest 0.04), over all leaves together 0.023. So the
# updates are gated together, and each leaf only against a step that did
# not move (1.0) or moved the other way (2.0). On the card's host (PR 23's
# chip run 1, full width; the CPU against itself at 2 x 128 / 1 x 64):
# losses 8.4e-5 / 2.6e-5, gradients 0.0114 / 0.0115, updates 0.0136 /
# 0.0172 (the key bias 0.177 / 0.305), within every tolerance; the card
# against the CPU 6.6e-5 / 7.6e-5, 0.0114 / 0.0109, 0.0127 / 0.0164 (0.184
# / 0.297). That CPU pass (90 s) is not repeated
TRAIN_LOSS_TOL = 1e-3      # each step's loss, relative
TRAIN_GRAD_TOL = 5e-2      # each leaf's gradient after step 1, relative L2
TRAIN_UPDATE_TOL = 0.25    # all leaves' updates over 3 steps, relative L2
TRAIN_LEAF_UPDATE_TOL = 1.0  # each leaf's update, relative L2 (below)
# the first case is 1 x 136 (136 rows: still the fat GEMM, above the
# GEMV's 128), cut from 2 x 128 to shorten its CPU pass for phase 15's
# time (ROADMAP queue 1, item 1)
TRAIN_CUT = ((1, 136), (1, 64))
# 13d: the launcher on the smoke config, then resumed
TRAIN_LAUNCH_STEPS = (30, 40)


def _train_gemms(cfg, batch: int, seq: int) -> list[tuple[Case, int]]:
    """The GEMMs of one training step of a qwen-style model (q, k, v with
    cfg.qkv_bias, wo, the SwiGLU gate with silu, w_in, w_out; an untied
    unembed) at ``batch`` x ``seq`` tokens, each with its count: the
    forward (once more with cfg.remat: the recompute; a loss chunk's
    unembed always twice), the gate's pre-activation recomputed with f32
    out (on the fat kernel whatever its shape: ``fat_only``), and of each
    product dA = dC . W^T (the (K, N) weight read as an (N', K') col one)
    and dB = A^T . dC. A bf16 output's cotangent is bf16; the silu gate's
    d_pre and the unembed's dlogits are f32 (on the card: the CUDA
    cores)."""
    d, f, V, L = cfg.d_model, cfg.d_ff, cfg.padded_vocab, cfg.n_layers
    c = min(cfg.loss_chunk, seq)
    if seq % c:
        c = seq
    R, Rc, chunks, fw = batch * seq, batch * c, seq // c, 1 + cfg.remat
    act, f32 = cfg.activation_dtype, "float32"
    g = lambda name, M, K, N, n, **kw: (Case(name, "matmul", M, K, N, **kw),
                                       n)
    fwd = dict(a_dtype=act, out_dtype=act)
    bwd_a = dict(a_dtype=act, out_dtype=act, layout="col")
    bwd_b = dict(a_dtype=act, b_dtype=act, out_dtype=f32)
    return [
        g("fwd q/k/v", R, d, d, fw * 3 * L, bias=cfg.qkv_bias, **fwd),
        g("fwd wo", R, d, d, fw * L, **fwd),
        g("fwd gate + silu", R, d, f, fw * L, activation="silu", **fwd),
        g("fwd w_in", R, d, f, fw * L, **fwd),
        g("fwd w_out", R, f, d, fw * L, **fwd),
        g("fwd unembed", Rc, d, V, 2 * chunks, a_dtype=act, out_dtype=f32),
        g("bwd gate pre recompute", R, d, f, L, a_dtype=act, out_dtype=f32,
          fat_only=True),
        g("bwd q/k/v/wo dA", R, d, d, 4 * L, **bwd_a),
        g("bwd w_in dA", R, f, d, L, **bwd_a),
        g("bwd gate dA (f32 d_pre)", R, f, d, L, a_dtype=f32,
          out_dtype=act, layout="col"),
        g("bwd w_out dA", R, d, f, L, **bwd_a),
        g("bwd q/k/v/wo dB", d, R, d, 4 * L, **bwd_b),
        g("bwd w_in dB", d, R, f, L, **bwd_b),
        g("bwd gate dB (f32 d_pre)", d, R, f, L, a_dtype=act,
          out_dtype=f32),
        g("bwd w_out dB", f, R, d, L, **bwd_b),
        g("bwd unembed dB", d, Rc, V, chunks, a_dtype=act, out_dtype=f32),
        g("bwd unembed dA (f32 dlogits)", Rc, V, d, chunks, a_dtype=f32,
          out_dtype=act, layout="col"),
    ]


def _train_rule(cfg, batch: int, seq: int) -> dict[str, int]:
    """Kernel launches of one training step (_train_gemms) by the dispatch
    rule (core/gemm.py): the GEMV for a product with no epilogue whose (M,
    K, N) is decode-shaped (M <= 128, K >= 256, N >= 128; at 1 x 64 rows
    the forward's wo, w_in, w_out, unembed and every dA, in the smoke
    config some dB), the fat kernel for the rest."""
    from repro_torch.core.gemm import _is_skinny

    out = {"matmul": 0, "gemv": 0, "wkv": 0}
    for c, n in _train_gemms(cfg, batch, seq):
        gemv = (_is_skinny(c.M, c.K, c.N) and not c.bias
                and c.activation is None and not c.fat_only)
        out["gemv" if gemv else "matmul"] += n
    return out


def check_train_kernels(torch) -> list[dict]:
    """13a: the backward's GEMMs at 13b's shapes against their plain
    versions, timed; and the GEMM wrappers raising, not launching, on a
    CUDA tensor that requires grad (the WKV wrappers' autograd Function is
    phase 20a's)."""
    from repro_torch import configs as C
    from repro_torch.kernels import decode_matvec as tmv
    from repro_torch.kernels import matmul as tmm

    phase("13a the training step's backward GEMMs against their plain "
          "versions (on the card), at 13b's shapes")
    cfg = C.get_config(TRAIN_ARCH)
    cases = [c for c, _ in _train_gemms(cfg, TRAIN_BATCH, TRAIN_SEQ)
             if c.name.startswith("bwd")]
    results = check_cases(torch, cases)
    d = lambda *shape, **kw: torch.randn(*shape, device="cuda", **kw)
    calls = {
        "matmul": lambda: tmm.matmul(
            d(64, 256, requires_grad=True).bfloat16(), d(256, 128),
            bm=64, bk=64, bn=128),
        "decode_matvec": lambda: tmv.decode_matvec(
            d(4, 256), d(256, 128, requires_grad=True), bk=256, bn=128),
    }
    before = (tmm.launches, tmv.launches)
    for name, call in calls.items():
        try:
            call()
        except RuntimeError as e:
            print(f"{name} under autograd on the card raises: {e}")
            continue
        raise SystemExit(f"{name} launched on a CUDA tensor that requires "
                         "grad: its gradient would be dropped")
    if (tmm.launches, tmv.launches) != before:
        raise SystemExit("a kernel launched before refusing autograd")
    return results


def train_path(torch) -> dict[str, int]:
    """13b: make_train_step at qwen1.5-4b's full width and depth, 5 steps
    on the card, then one more under the profiler."""
    import math

    from repro_torch import configs as C
    from repro_torch.core.context import use_context
    from repro_torch.core.plancache import PlanCache
    from repro_torch.data.synthetic import DataConfig, SyntheticLM
    from repro_torch.interop import tree_items
    from repro_torch.models import param_count
    from repro_torch.train import graphs
    from repro_torch.train.trainstep import make_train_step

    cfg = C.get_config(TRAIN_ARCH)
    want = _train_rule(cfg, TRAIN_BATCH, TRAIN_SEQ)
    gemms = _train_gemms(cfg, TRAIN_BATCH, TRAIN_SEQ)
    phase(f"13b training path: train.trainstep.make_train_step, "
          f"{TRAIN_ARCH} (full width and depth, remat on, AdamW), batch "
          f"{TRAIN_BATCH} x {TRAIN_SEQ} from data.synthetic (seed 0), "
          f"{TRAIN_STEPS} steps")
    marks, norms = [], {}

    def probe(grads):
        # between the backward and the optimizer: a CUDA event, and in
        # step 1 every leaf's gradient norm (finite and nonzero)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks[-1].append(ev)
        if not norms:
            items = list(tree_items(grads))
            vals = torch.stack([torch.linalg.vector_norm(g, dtype=torch.float32)
                                for _, g in items]).tolist()
            norms.update(zip((p for p, _ in items), vals))

    def event():
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    cache = PlanCache()
    torch.cuda.reset_peak_memory_stats()
    with use_context(hw="h100", plan_cache=cache):
        art = make_train_step(cfg, global_batch=TRAIN_BATCH,
                              seq_len=TRAIN_SEQ, device="cuda",
                              grads_hook=probe)
        t0 = time.perf_counter()
        state = art.init_fn(0)
        torch.cuda.synchronize()
        n_params = param_count(state["params"])
        print(f"init: {n_params:,} parameters ({4 * n_params / 1e9:.2f} GB "
              f"f32; with AdamW's m and v {12 * n_params / 1e9:.2f} GB) in "
              f"{time.perf_counter() - t0:.1f}s")
        data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                      seq_len=TRAIN_SEQ,
                                      global_batch=TRAIN_BATCH, seed=0))
        losses, lazy, per_step = [], [], []
        graphs.reset_launches()
        prev = graphs.launches()
        for step in range(TRAIN_STEPS):
            batch = data.batch(step)
            solves = cache.stats.lazy_solves
            marks.append([event()])
            t0 = time.perf_counter()
            state, m = art.step_fn(state, batch)
            marks[-1].append(event())
            losses.append(float(m["loss"]))
            wall = time.perf_counter() - t0
            now = graphs.launches()
            per_step.append({k: now[k] - prev[k] for k in now})
            prev = now
            lazy.append(cache.stats.lazy_solves - solves)
            ms = [marks[-1][0].elapsed_time(marks[-1][i]) for i in (1, 2)]
            print(f"  step {step}: loss {losses[-1]:.4f} grad_norm "
                  f"{float(m['grad_norm']):.4f} {ms[1]:.1f} ms on the card "
                  f"(forward + backward {ms[0]:.1f}, optimizer "
                  f"{ms[1] - ms[0]:.1f}), host wall {wall * 1e3:.1f} ms, "
                  f"lazy solves {lazy[-1]}, launches {per_step[-1]}",
                  flush=True)
        counts = graphs.launches()
        peak = torch.cuda.max_memory_allocated() / 2**30
        # one more step under the profiler: the device's busy share
        marks.append([event()])
        rows, _, traced_wall = _traced(torch, lambda: float(art.step_fn(
            state, data.batch(TRAIN_STEPS))[1]["loss"]))
    busy_ms, idle = _busy(rows, traced_wall)
    total = [a.elapsed_time(c) for a, _, c in marks[:TRAIN_STEPS]]
    fb = [a.elapsed_time(b) for a, b, _ in marks[:TRAIN_STEPS]]
    med = lambda x: statistics.median(x[1:])
    gemm_ms = sum(n * _bound(c, torch, "tensor_core" if c.a_dtype ==
                             "bfloat16" else "cuda_core")[0]
                  for c, n in gemms)
    opt_ms = 1e3 * 7 * 4 * n_params / HBM_BYTES_PER_S
    print(f"step 1 {total[0]:.1f} ms (forward + backward {fb[0]:.1f}, "
          f"optimizer {total[0] - fb[0]:.1f}); steps 2-{TRAIN_STEPS} median "
          f"{med(total):.1f} ms (forward + backward {med(fb):.1f}, optimizer "
          f"{statistics.median(t - f for t, f in zip(total[1:], fb[1:])):.1f}"
          f"); bound {gemm_ms + opt_ms:.1f} ms (the step's {sum(n for _, n in gemms)} "
          f"GEMMs {gemm_ms:.1f}, AdamW's 7 f32 passes over the parameters "
          f"{opt_ms:.1f})")
    print(f"traced step: kernels busy {busy_ms:.1f} ms of {traced_wall * 1e3:.1f} "
          f"ms wall (idle share {idle:.3f}); busy against the untraced median "
          f"step {busy_ms / med(total):.3f}; peak device memory {peak:.2f} GiB"
          f" (limit {TRAIN_PEAK_GIB}); launches of the {TRAIN_STEPS} steps "
          f"{counts} (rule a step: {want})")
    fat = {k: sum(r[0] for r in rows if k in r[2]) / 1e3
           for k in FAT_KERNELS}
    rest = sorted((r for r in rows if not any(k in r[2] for k in
                                              FAT_KERNELS)), reverse=True)
    print("traced step, device ms by kernel: fat GEMM "
          + ", ".join(f"{k} {v:.1f}" for k, v in fat.items())
          + "; the largest others " + ", ".join(
              f"{name[:48]} {us / 1e3:.1f} ({n} launches)"
              for us, n, name in rest[:6]))
    bad = [p for p, n in norms.items() if not (math.isfinite(n) and n > 0)]
    print(f"after step 1: {len(norms)} parameter leaves, gradient norms "
          f"{min(norms.values()):.4g} .. {max(norms.values()):.4g}")
    failed = []
    if not all(math.isfinite(x) for x in losses):
        failed.append(f"a loss is not finite: {losses}")
    if bad or len(norms) != len(list(tree_items(state["params"]))):
        failed.append(f"leaves without a finite nonzero gradient: {bad}")
    if any(lazy[1:]):
        failed.append(f"lazy solves after step 1: {lazy}")
    if any(c != want for c in per_step):
        failed.append(f"launches a step {per_step} differ from the rule "
                      f"{want}")
    if not peak < TRAIN_PEAK_GIB:
        failed.append(f"peak device memory {peak:.2f} GiB")
    del state, art, m
    _free(torch)
    if failed:
        raise SystemExit("13b: " + "; ".join(failed))
    return counts


def _train_run(torch, cfg, params0, batch: int, seq: int, device) -> dict:
    """3 steps of make_train_step on ``device`` from ``params0`` (CPU
    tensors) and fresh AdamW state, on data.synthetic (seed 0): each
    step's loss and launches, the step-1 gradients and the 3 steps'
    update of each leaf (on the CPU)."""
    from repro_torch import interop
    from repro_torch.data.synthetic import DataConfig, SyntheticLM
    from repro_torch.train import graphs
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train.trainstep import (default_opt_config,
                                             make_train_step)

    grads = {}

    def probe(tree):
        if not grads:
            grads.update((p, g.detach().to("cpu", copy=True))
                         for p, g in interop.tree_items(tree))

    art = make_train_step(cfg, global_batch=batch, seq_len=seq,
                          device=device, grads_hook=probe)
    params = interop.tree_map(lambda t: t.to(device, copy=True), params0)
    state = {"params": params,
             "opt": opt_lib.make_optimizer(default_opt_config(cfg)).init(
                 params),
             "step": torch.zeros((), dtype=torch.int32, device=device)}
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                  global_batch=batch, seed=0))
    losses, launches = [], []
    for step in range(3):
        graphs.reset_launches()
        state, m = art.step_fn(state, data.batch(step))
        losses.append(float(m["loss"]))
        launches.append(graphs.launches())
    before = dict(interop.tree_items(params0))
    update = {p: t.detach().cpu() - before[p]
              for p, t in interop.tree_items(state["params"])}
    return {"losses": losses, "launches": launches, "grads": grads,
            "update": update}


TRAIN_CPU_THREADS = 4  # 13c's CPU runs, beside phases 7-9 (see below)


def _phase13(name: str) -> str:
    return os.path.join(ROOT, "build", "phase13", name)


def train_vs_cpu_start() -> subprocess.Popen:
    """13c in a process of its own (:func:`train_vs_cpu`), started before
    phase 7: its CPU runs (71 s of 99 on 8 threads of an H100's host) take
    TRAIN_CPU_THREADS threads beside the engines of phases 7-9, whose
    process drives the card from one thread; its card runs wait for
    :func:`train_vs_cpu_go` (after 13b) and take the card before 14a
    (:func:`train_vs_cpu_card`); :func:`train_vs_cpu_end` reads its
    result."""
    os.makedirs(_phase13(""), exist_ok=True)
    for name in ("go", "card_done"):
        if os.path.exists(_phase13(name)):
            os.remove(_phase13(name))
    print(f"(13c's CPU runs start in a process of their own, "
          f"{TRAIN_CPU_THREADS} threads)", flush=True)
    code = (f"import sys; sys.path[:0] = {[ROOT, os.path.join(ROOT, 'src')]!r}"
            "; import torch, chip_smoke; chip_smoke.train_vs_cpu(torch)")
    with open(_phase13("13c.log"), "w") as log:
        return subprocess.Popen([sys.executable, "-c", code], stdout=log,
                                stderr=subprocess.STDOUT, text=True, cwd=ROOT)


def train_vs_cpu_go() -> None:
    phase(f"13c training step, card against CPU: {TRAIN_ARCH}, n_layers 2, "
          f"full width, 3 steps at batch x seq {TRAIN_CUT}; tolerances "
          f"loss {TRAIN_LOSS_TOL}, gradients {TRAIN_GRAD_TOL} (relative L2 "
          f"per leaf), updates {TRAIN_UPDATE_TOL} (all leaves; each below "
          f"{TRAIN_LEAF_UPDATE_TOL}); in a process of its own, its card runs "
          "now, its output after 14d")
    open(_phase13("go"), "w").close()


def train_vs_cpu_card(job: subprocess.Popen) -> None:
    """Waits until 13c's process has left the card (or ended)."""
    t0 = time.perf_counter()
    while not os.path.exists(_phase13("card_done")) and job.poll() is None:
        time.sleep(0.2)
    print(f"(13c's card runs done; waited {time.perf_counter() - t0:.1f}s)",
          flush=True)


def train_vs_cpu_end(job: subprocess.Popen) -> None:
    t0 = time.perf_counter()
    try:
        job.wait(timeout=600)
    finally:
        _stop(job)
    phase(f"13c's result (waited {time.perf_counter() - t0:.1f}s for it)")
    with open(_phase13("13c.log")) as f:
        print(f.read().rstrip(), flush=True)
    if job.returncode != 0:
        raise SystemExit(f"13c: its process exited {job.returncode}")


def train_vs_cpu(torch) -> None:
    """13c: the training step on the card against the CPU at 2 layers and
    full width, from one seed's weights (made on the CPU) and the same
    batches: the CPU runs first, then, once ``go`` exists, the card runs,
    then ``card_done`` is written and the card left alone."""
    from repro_torch import configs as C
    from repro_torch import interop, models
    from repro_torch.core.context import use_context
    from repro_torch.core.plancache import PlanCache

    torch.set_num_threads(TRAIN_CPU_THREADS)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(C.get_config(TRAIN_ARCH), n_layers=2)
    params0 = models.init(cfg, seed=1, device="cpu")
    rel = lambda x, y: ((x - y).norm() / y.norm().clamp_min(1e-30)).item()
    failed = []
    res = {cut: {} for cut in TRAIN_CUT}
    for dev in ("cpu", "cuda"):
        if dev == "cuda":
            while not os.path.exists(_phase13("go")):
                time.sleep(0.2)
        for batch, seq in TRAIN_CUT:
            with use_context(hw="h100", plan_cache=PlanCache()):
                t0 = time.perf_counter()
                res[batch, seq][dev] = _train_run(torch, cfg, params0, batch,
                                                  seq, dev)
                print(f"  {batch} x {seq} {dev}: losses " + " ".join(
                    f"{x:.6f}" for x in res[batch, seq][dev]["losses"])
                      + f" ({time.perf_counter() - t0:.1f}s)", flush=True)
                _free(torch)
    open(_phase13("card_done"), "w").close()
    for batch, seq in TRAIN_CUT:
        card, ref = res[batch, seq]["cuda"], res[batch, seq]["cpu"]
        want = _train_rule(cfg, batch, seq)
        print(f"  {batch} x {seq} card launches a step {card['launches']} "
              f"(rule {want})")
        if any(n != want for n in card["launches"]):
            failed.append(f"{batch} x {seq}: launches differ from the rule")
        loss = max(abs(a - b) / abs(b)
                   for a, b in zip(card["losses"], ref["losses"]))
        grad = max((rel(card["grads"][k], ref["grads"][k]), k)
                   for k in ref["grads"])
        upd = max((rel(card["update"][k], ref["update"][k]), k)
                  for k in ref["update"])
        both = (sum((card["update"][k] - ref["update"][k]).norm() ** 2
                    for k in ref["update"])
                / sum(u.norm() ** 2 for u in ref["update"].values())
                ).sqrt().item()
        print(f"  {batch} x {seq} card against the CPU: loss {loss:.3g}, "
              f"worst gradient {grad[0]:.4g} ({grad[1]}), updates "
              f"{both:.4g} (worst leaf {upd[0]:.4g}, {upd[1]})", flush=True)
        if not (loss <= TRAIN_LOSS_TOL and grad[0] <= TRAIN_GRAD_TOL
                and both <= TRAIN_UPDATE_TOL
                and upd[0] < TRAIN_LEAF_UPDATE_TOL):
            failed.append(f"{batch} x {seq}: the card's step is beyond a "
                          "tolerance of the CPU's")
        del card, ref
        res[batch, seq] = None
    if failed:
        raise SystemExit("13c: " + "; ".join(failed))


def train_launcher(torch) -> dict[str, int]:
    """13d: ``repro_torch.launch.train`` on the smoke config for 30 steps
    with a checkpoint every 10, then again to 40: it resumes from step 30
    and its loss keeps falling."""
    import math
    import tempfile

    from repro_torch import configs as C
    from repro_torch.launch import train
    from repro_torch.train import graphs

    first, last = TRAIN_LAUNCH_STEPS
    phase(f"13d launcher: python -m repro_torch.launch.train --arch "
          f"{TRAIN_ARCH} --smoke --steps {first} --ckpt-every 10, then "
          f"--steps {last} from its checkpoints")
    cfg = C.smoke(C.get_config(TRAIN_ARCH))
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as d:
        args = ["--arch", TRAIN_ARCH, "--smoke", "--ckpt-every", "10",
                "--ckpt-dir", d, "--plan-cache", ""]
        graphs.reset_launches()
        a = train.main(args + ["--steps", str(first)])
        b = train.main(args + ["--steps", str(last)])
        counts = graphs.launches()
    want = {k: n * last for k, n in _train_rule(cfg, 8, 128).items()}
    early, late = (statistics.mean(a["losses"][:5]),
                   statistics.mean(b["losses"][-5:]))
    print(f"start steps {a['start_step']} and {b['start_step']}; mean loss "
          f"of the first 5 steps {early:.4f}, of the last 5 {late:.4f}; "
          f"launches {counts} (rule: {want})")
    losses = a["losses"] + b["losses"]
    if (a["start_step"] != 0 or b["start_step"] != first
            or len(losses) != last
            or not all(math.isfinite(x) for x in losses)
            or not late < early or counts != want):
        raise SystemExit("13d: the launcher did not resume, or its loss "
                         "did not fall, or its launches differ from the "
                         "rule")
    _free(torch)
    return counts


# ------------------------------------------------------------ phase 14
# distribution on the one card: a 1 x 1 (data, model) mesh over nccl in the
# script's own process (NCCL refuses two ranks on one GPU; the multi-rank
# semantics are held on the CPU by tests/test_torch_distributed.py). 14a:
# the distributed GEMMs at 3a's qwen prefill shapes, one fat-GEMM launch a
# call and no collective bytes on this mesh; 14b the pipeline, one stage, 4
# microbatches; 14c the sharded step through the launcher at 13b's full
# width and depth and batch, then DIST_CUT layers bit for bit against the
# one-device step; 14d the dry run of one cell on the meta device
DIST_CASES = ("prefill q/k/v + bias", "prefill gate + silu")
DIST_PIPE = (4, 512, 2560)      # 14b: microbatches x rows x width
DIST_STEPS = 3                  # 14c at full depth: median of steps 2-3
DIST_CUT = 4                    # 14c's bit-equality check: layers
DIST_CELL = ("qwen1.5-4b", "train_4k")  # 14d


def dist_gemms(torch) -> list[dict]:
    """14a: output_stationary_gemm and k_sharded_gemm on a 1 x 1 mesh
    against the fat kernel's plain version, their launches and collective
    bytes, timed beside the kernel called directly."""
    from repro_torch.core import distributed as cd
    from repro_torch.core.context import use_context
    from repro_torch.core.gemm import balanced_gemm
    from repro_torch.core.plancache import PlanCache
    from repro_torch.kernels import matmul as tmm
    from repro_torch.kernels import ref
    from repro_torch.launch.mesh import make_local_mesh

    phase("14a distributed GEMMs on a 1 x 1 mesh (nccl, world size 1) "
          "against the fat kernel's plain version")
    import torch.distributed as dist

    mesh = make_local_mesh(1, 1)
    print(f"mesh {mesh.describe()} backend {dist.get_backend()} rank "
          f"{mesh.rank} device {mesh.device}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16, f32 = torch.bfloat16, torch.float32
    rows, failed = [], []
    with use_context(hw="h100", plan_cache=PlanCache()):
        for c in [c for c in CASES if c.name in DIST_CASES]:
            a, b, bias, _ = _inputs(torch, c, gen)
            calls = {
                "output_stationary": (
                    lambda: cd.output_stationary_gemm(
                        a, b, mesh, bias=bias, activation=c.activation,
                        out_dtype=bf16),
                    lambda: ref.matmul_ref(a, b, out_dtype=bf16, bias=bias,
                                           activation=c.activation)),
                "k_sharded": (
                    lambda: cd.k_sharded_gemm(a, b, mesh, out_dtype=bf16),
                    lambda: ref.matmul_ref(a, b, out_dtype=f32).to(bf16)),
            }
            direct = lambda: balanced_gemm(a, b, bias,
                                           activation=c.activation,
                                           out_dtype=bf16)
            direct()
            direct_ms = time_ms(torch, direct)
            for name, (call, plain) in calls.items():
                call()  # the plan solved outside the count
                before = tmm.launches
                with cd.CollectiveCounter() as counter:
                    got = call()
                torch.cuda.synchronize()
                launched = tmm.launches - before
                want = plain()
                err = (got.double() - want.double()).abs().max().item()
                tol = _tolerance("matmul", "bfloat16",
                                 want.double().abs().max().item())
                ms = time_ms(torch, call)
                row = {"case": f"{name} {c.name}", "shape": [c.M, c.K, c.N],
                       "max_abs_err": err, "tol": tol, "launches": launched,
                       "collective_bytes": counter.total, "ms": ms,
                       "direct_ms": direct_ms}
                rows.append(row)
                print(f"{name:17s} {c.name:22s} MKN={c.M}x{c.K}x{c.N} "
                      f"err={err:.3g} tol={tol:.3g} launches={launched} "
                      f"collective_bytes={counter.total} ms={ms:.4f} "
                      f"(the kernel called directly {direct_ms:.4f})",
                      flush=True)
                if not (err <= tol and launched == 1
                        and counter.total == 0):
                    failed.append(row["case"])
            del a, b, bias
    if failed:
        raise SystemExit(f"14a: {failed} disagree with the plain version, "
                         "or launched other than one fat GEMM, or counted "
                         "collective bytes")
    return rows


def dist_pipeline(torch) -> None:
    """14b: pipeline_apply over the 1 x 1 mesh's 'data' axis (one stage),
    4 microbatches of tanh(x @ w) through balanced_gemm, against the same
    products run one after another."""
    from repro_torch.core import distributed as cd
    from repro_torch.core.context import use_context
    from repro_torch.core.gemm import balanced_gemm
    from repro_torch.core.plancache import PlanCache
    from repro_torch.kernels import matmul as tmm
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.parallel.pipeline import pipeline_apply

    M, B, D = DIST_PIPE
    phase(f"14b pipeline_apply: 1 stage over 'data', {M} microbatches of "
          f"{B} x {D} bf16, tanh(x @ w) with w {D} x {D} f32")
    mesh = make_local_mesh(1, 1)
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((M, B, D), generator=gen, device="cuda").bfloat16()
    w = torch.randn((1, D, D), generator=gen, device="cuda") * D ** -0.5
    fn = lambda w, x, s: torch.tanh(balanced_gemm(x, w))
    with use_context(hw="h100", plan_cache=PlanCache()):
        seq = torch.stack([fn(w[0], x[i], 0) for i in range(M)])
        before = tmm.launches
        with cd.CollectiveCounter() as counter:
            got = pipeline_apply(fn, w, x, mesh, axis="data")
        torch.cuda.synchronize()
    launched = tmm.launches - before
    equal = torch.equal(got, seq)
    print(f"equal to the sequential products bit for bit: {equal}; max "
          f"abs diff {(got.float() - seq.float()).abs().max().item():.3g}; "
          f"fat-GEMM launches {launched} (one a microbatch: {M}); "
          f"collective bytes {counter.total}")
    if not (equal and launched == M and counter.total == 0):
        raise SystemExit("14b: the pipeline differs from the sequential "
                         "products, or its launches or bytes are off")


def _cut_step(torch, cfg, mesh) -> tuple[list[float], dict]:
    """DIST_CUT layers, 2 steps of make_train_step(mesh=...) from seed 0:
    the losses and the parameters after (on the card)."""
    from repro_torch.data.synthetic import batch_for
    from repro_torch.interop import tree_items
    from repro_torch.train.trainstep import make_train_step

    art = make_train_step(cfg, mesh=mesh, global_batch=TRAIN_BATCH,
                          seq_len=TRAIN_SEQ,
                          device="cuda" if mesh is None else None)
    state, losses = art.init_fn(0), []
    for step in range(2):
        state, m = art.step_fn(state, batch_for(cfg, TRAIN_SEQ, TRAIN_BATCH,
                                                step))
        losses.append(float(m["loss"]))
    params = {p: t.detach() for p, t in tree_items(state["params"])}
    del state, art
    return losses, params


def _free_port() -> int:
    from repro_torch.launch.mesh import free_port

    return free_port()


def dist_smoke_start() -> _Jobs:
    """14c's launcher under torchrun on the smoke config, started with
    13c's card runs (it spends ~25 s, most of it starting up and its
    first step's NCCL set-up); :func:`dist_train` waits for it."""
    return _Jobs([_Job("14c", [
        "-m", "repro_torch.launch.train", "--arch", TRAIN_ARCH, "--smoke",
        "--mesh", "1x1", "--steps", "3", "--ckpt-every", "0", "--log-every",
        "1", "--plan-cache", ""], nproc=1)], slots=1)


def dist_train(torch, smoke: _Jobs) -> dict[str, int]:
    """14c: the sharded step through ``launch/train.py --mesh 1x1`` at
    qwen1.5-4b's full width and depth, the launcher under torchrun
    (``smoke``, from :func:`dist_smoke_start`), then DIST_CUT layers bit
    for bit against the one-device step."""
    from repro_torch import configs as C
    from repro_torch.core.context import use_context
    from repro_torch.core.plancache import PlanCache
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.train import graphs

    _free(torch)  # phase 13's state is gone: no room for a second copy
    phase(f"14c sharded training: repro_torch.launch.train --arch "
          f"{TRAIN_ARCH} --mesh 1x1 (full width and depth, remat on, "
          f"AdamW), batch {TRAIN_BATCH} x {TRAIN_SEQ} from data.synthetic "
          f"(seed 0), {DIST_STEPS} steps, no checkpoint")
    failed = []
    # the same launcher under torchrun (env:// rendezvous over loopback,
    # nccl), on the smoke config: a process of its own, ended before the
    # full-depth step takes the card (its 62.75 GiB leave no room for
    # another process's CUDA context)
    print("torchrun --nproc-per-node 1 -m repro_torch.launch.train --smoke "
          "--mesh 1x1: ", end="")
    run = smoke.result("14c", "14c", ("[train]", "step"))
    if "mesh=1x1" not in run.out:
        failed.append("the launcher under torchrun failed: "
                      + run.err[-2000:])
    cfg = C.get_config(TRAIN_ARCH)
    want = _train_rule(cfg, TRAIN_BATCH, TRAIN_SEQ)
    torch.cuda.reset_peak_memory_stats()
    graphs.reset_launches()
    res = train.main(["--arch", TRAIN_ARCH, "--mesh", "1x1", "--batch",
                      str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--steps",
                      str(DIST_STEPS), "--ckpt-every", "0", "--log-every",
                      "1", "--plan-cache", ""])
    counts = graphs.launches()
    peak = torch.cuda.max_memory_allocated() / 2**30
    step_ms = statistics.median(res["step_s"][1:]) * 1e3
    coll = [sum(c.values()) for c in res["collective_bytes"]]
    print(f"step ms (host wall, median of steps 2-{DIST_STEPS}) "
          f"{step_ms:.1f} (steps {[round(s * 1e3, 1) for s in res['step_s']]}"
          f"); peak device memory {peak:.2f} GiB (limit {TRAIN_PEAK_GIB}); "
          f"launches of the {DIST_STEPS} steps {counts} (rule a step "
          f"{want}); collective bytes a step {coll}; losses "
          f"{[round(x, 4) for x in res['losses']]}", flush=True)
    if counts != {k: n * DIST_STEPS for k, n in want.items()}:
        failed.append(f"launches {counts} differ from the rule")
    if any(coll) or not peak < TRAIN_PEAK_GIB:
        failed.append(f"collective bytes {coll} or peak {peak:.2f} GiB")
    del res
    _free(torch)
    cut = dataclasses.replace(cfg, n_layers=DIST_CUT)
    print(f"{DIST_CUT} layers at full width, 2 steps: make_train_step("
          "mesh=1x1) against make_train_step(mesh=None), bit for bit "
          "(deterministic algorithms on, warnings only)", flush=True)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with use_context(hw="h100", plan_cache=PlanCache()):
            runs = {"mesh 1x1": _cut_step(torch, cut, make_local_mesh(1, 1))}
            _free(torch)
            runs["one device"] = _cut_step(torch, cut, None)
            _free(torch)
            (la, pa), (lb, pb) = runs["mesh 1x1"], runs["one device"]
            differ = [p for p in pa if not torch.equal(pa[p], pb[p])]
            print(f"losses {la} / {lb}; parameter leaves that differ: "
                  f"{len(differ)} of {len(pa)}", flush=True)
            if la != lb or differ:
                again = _cut_step(torch, cut, None)
                same = again[0] == lb and all(
                    torch.equal(again[1][p], pb[p]) for p in pb)
                print(f"the one-device step run again equal to itself: "
                      f"{same}", flush=True)
                failed.append(f"the 1 x 1 mesh step differs from the "
                              f"one-device step: {differ[:5]}")
    finally:
        torch.use_deterministic_algorithms(False)
    del runs
    _free(torch)
    if failed:
        raise SystemExit("14c: " + "; ".join(failed))
    return counts


def dist_dryrun(torch) -> dict:
    """14d: the dry run of one cell on the meta device and its roofline
    row, on the card's host (which has no JAX)."""
    from repro_torch.launch import dryrun
    from repro_torch.roofline import report

    arch, shape = DIST_CELL
    phase(f"14d dry run on the meta device: {arch} x {shape} x 16x16, and "
          "its roofline row (h100)")
    rec = dryrun.run_cell(arch, shape, False,
                          os.path.join(ROOT, "build", "phase14"))
    if rec["status"] != "ok":
        raise SystemExit(f"14d: the dry run failed: {rec.get('trace')}")
    rec = report.enrich(rec, hw="h100")
    jax_loaded = any(m == "jax" or m.startswith("jax.") for m in sys.modules)
    print(f"state {rec['memory']['state_gib_per_device']:.3f} GiB a device, "
          f"{rec['cost']['flops_per_device']:.4g} FLOPs, GEMM bytes "
          f"{rec['cost']['bytes_per_device']:.4g}, collective bytes "
          f"{rec['cost']['by_collective']}, {rec['wall_s']:.1f}s; jax "
          f"imported: {jax_loaded}")
    print(report.roofline_row(rec))
    if jax_loaded:
        raise SystemExit("14d: the dry run imported jax")
    return rec


# ------------------------------------------------------------ phase 15
# tensor parallelism over 'model': two ranks on the one card, a (1, 2)
# (data, model) mesh over gloo (NCCL refuses two ranks on one GPU; each
# collective is staged through host memory, the products stay on the
# kernels), each rank a process of torchrun. 15a: the static server at
# qwen1.5-4b's full width, cut to TP_CUT layers (4 x 128, 16 tokens, seed
# 0; its 40-layer run made room for phase 17, whose 17a serves over a
# mesh at full depth) against
# the same path at 1 x 1 in this process: the prefill's logits within
# PATH_TOL of 1 + |logit|, the greedy tokens equal wherever the 1 x 1
# run's top-2 margin exceeds that tolerance (12c's rule; a row is compared
# up to its first position that does not), both ranks' tokens equal, each
# rank's launches the 1 x 1 path's rule (phase 4a: the same kernels at
# the local shapes), zero lazy solves, the collective bytes of the prefill
# and of each decode step the dry run's for a (1, 2) abstract mesh. 15b:
# training, TP_LAYERS layers at full width, 13b's batch, 2 AdamW steps
# through the launcher against make_train_step(mesh=None) on the card. Its
# tolerances, stated before the first card run from 13c's bounds (the
# card against the CPU, bf16 activations): each step's loss within
# TRAIN_LOSS_TOL relative; each step's gradient norm within TP_GNORM_TOL
# relative (the f32 partial sums of the row-parallel products and the
# vocab-parallel loss change the summation order only); the two steps'
# updates within TRAIN_UPDATE_TOL relative L2 over all leaves and each
# leaf's below TRAIN_LEAF_UPDATE_TOL (Adam's sign of a gradient within
# rounding of zero flips a whole step); the collective bytes of each step
# the dry run's. 15c: the dry run's qwen1.5-4b x train_4k x 16x16 (14d's
# record): 6ND over the counted FLOPs at least TP_RATIO (0.03 while the
# ranks of 'model' repeated each other's products); decode_32k x 16x16:
# nonzero collective bytes
# the TP paths at 2 layers (15a and 16a once at full depth, 15b and 16b
# at 4): their time made room for phase 17
TP_MESH, TP_LAYERS, TP_RATIO, TP_CUT = "1x2", 2, 0.4, 2
TP_GNORM_TOL = 5e-3
# phases 15-18's two-rank jobs (torchrun, gloo, both ranks on the card)
# start when phase 15 does and run MESH_SLOTS at a time, in the order the
# phases read them; this process meanwhile runs each phase's one-device
# yardstick, then waits for the phase's job. A job spends most of its
# 30-45 s alone on the host (start-up, the load, the plan warm-up), so
# the jobs share the host's cores; their eager step ms are taken beside
# the other jobs
MESH_SLOTS = 4


class _Job:
    """One torchrun of ``target`` (``-m module args`` or a script and its
    arguments) over ``nproc`` ranks; :class:`_Jobs` starts it. ``also``:
    the other tags a job serves under (:func:`_serve_many`)."""

    def __init__(self, tag: str, target: list[str], timeout: int = 600,
                 nproc: int = 2, also: tuple[str, ...] = ()):
        self.tag, self.target, self.timeout = tag, target, timeout
        self.nproc, self.also = nproc, also
        self.proc, self.out, self.err, self.rc = None, "", "", None
        self.started = self.seconds = 0.0
        self.reported = False
        self.done = threading.Event()


class _Jobs:
    """Runs ``jobs`` in order, at most ``slots`` at a time,
    each in a thread of its own; :meth:`result` waits for one, :meth:`stop`
    ends every one still running and starts no other."""

    def __init__(self, jobs: list[_Job], slots: int = MESH_SLOTS):
        self.order = jobs
        self.jobs = {t: j for j in jobs for t in (j.tag, *j.also)}
        self.slots = threading.Semaphore(slots)
        self.lock = threading.Lock()
        self.closed = False
        threading.Thread(target=self._dispatch, daemon=True).start()

    def _dispatch(self) -> None:
        for job in self.order:
            self.slots.acquire()
            with self.lock:
                if self.closed:
                    job.err = "stopped before it started"
                    job.done.set()
                    self.slots.release()
                    continue
                job.started = time.perf_counter()
                job.proc = subprocess.Popen(
                    [sys.executable, "-m", "torch.distributed.run",
                     "--nproc-per-node", str(job.nproc), "--master-addr",
                     "localhost",
                     "--master-port", str(_free_port()), *job.target],
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True, cwd=ROOT,
                    env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")})
            threading.Thread(target=self._wait, args=(job,),
                             daemon=True).start()

    def _wait(self, job: _Job) -> None:
        try:
            job.out, job.err = job.proc.communicate(timeout=job.timeout)
        except subprocess.TimeoutExpired:
            _stop(job.proc)
            job.out, job.err = job.proc.communicate()
            job.err += f"\n{job.tag}: stopped after {job.timeout} s"
        job.rc = job.proc.returncode
        job.seconds = time.perf_counter() - job.started
        job.done.set()
        self.slots.release()

    def result(self, tag: str, label: str, heads: tuple[str, ...]) -> _Job:
        """Waits for job ``tag``, prints its time and the lines of its rank
        0 that start with ``heads``; a failed job fails phase ``label``."""
        job = self.jobs[tag]
        job.done.wait()
        print(f"exit {job.rc} in {job.seconds:.1f}s (started at "
              f"{job.started - _T0:.1f}s, beside the other jobs)"
              + (f" (job {job.tag}'s, read above)" if job.reported else
                 ": " + _lines(job.out, heads)), flush=True)
        job.reported = True
        if job.rc != 0:
            raise SystemExit(f"{label}: the ranks failed: "
                             + job.err[-3000:])
        return job

    def stop(self) -> None:
        with self.lock:
            self.closed = True
            running = [j.proc for j in self.order if j.proc]
        for proc in running:
            _stop(proc)


def _mesh(mesh: str, where: str, tag: str) -> list[str]:
    """The launcher's arguments for ``mesh`` over gloo, with each rank's
    record under build/``where``/``tag``."""
    out = os.path.join(ROOT, "build", where)
    os.makedirs(out, exist_ok=True)
    return ["--mesh", mesh, "--backend", "gloo", "--record-out",
            os.path.join(out, tag)]


def _records(torch, where: str, tag: str, n: int = 2) -> list:
    return [torch.load(os.path.join(ROOT, "build", where,
                                    f"{tag}.rank{r}.pt"), weights_only=False)
            for r in range(n)]


def _ranks(mesh: str) -> int:
    """The ranks of a mesh named as ``--mesh`` takes it ("1x3": 3)."""
    return math.prod(int(n) for n in mesh.split("x"))


def _static_args(arch: str, layers: int | None,
                 extra: list[str] = (), gen: int = GEN) -> list[str]:
    """The static server's arguments (4 x 128, ``gen`` tokens), ``layers``
    None: the full depth."""
    return (["--arch", arch, "--batch", str(BATCH), "--prompt-len",
             str(PROMPT), "--gen", str(gen), "--plan-cache", ""]
            + ([] if layers is None else ["--n-layers", str(layers)])
            + list(extra))


def _tp_static_args(extra: list[str]) -> list[str]:
    return _static_args("qwen1.5-4b", TP_CUT, extra)


def _tp_train_args() -> list[str]:
    return ["--arch", TRAIN_ARCH, "--n-layers", str(TP_LAYERS), "--mesh",
            TP_MESH, "--backend", "gloo", "--batch", str(TRAIN_BATCH),
            "--seq", str(TRAIN_SEQ), "--steps", "2", "--ckpt-every", "0",
            "--log-every", "1", "--plan-cache", "", "--record-out",
            os.path.join(ROOT, "build", "phase15", "train.pt")]


def _tp_engine_args(spec: bool = False) -> list[str]:
    return (["--arch", "qwen1.5-4b"] + ENGINE_ARGS[2:]
            + (ENGINE_SPEC_ARGS + ["--spec-draft-quantize", "none"]
               if spec else []) + ["--n-layers", str(TP_CUT)])


def _ep_args() -> list[str]:
    return ["--arch", "olmoe-1b-7b", "--batch", str(BATCH), "--prompt-len",
            str(PROMPT), "--gen", str(GEN), "--plan-cache", "",
            "--n-layers", str(EP_CUT)]


def _ep_engine_args() -> list[str]:
    return (["--arch", "olmoe-1b-7b"] + ENGINE_ARGS[2:]
            + ["--n-layers", str(EP_ENGINE_CUT)])


def _int8_engine_args() -> list[str]:
    return (["--arch", "qwen1.5-4b"] + ENGINE_ARGS[2:] + ENGINE_INT8_ARGS
            + ["--n-layers", str(TP_CUT)])


def start_mesh_jobs() -> _Jobs:
    """Phases 15-19's and 21's jobs, in the order the phases read them."""
    serve = ["-m", "repro_torch.launch.serve"]
    os.makedirs(os.path.join(ROOT, "build", "phase15"), exist_ok=True)
    prog = os.path.join(ROOT, "build", "phase17", "ep_layer.py")
    os.makedirs(os.path.dirname(prog), exist_ok=True)
    with open(prog, "w") as f:
        f.write(EP_LAYER_PROG)
    return _Jobs([
        _Job("15a", serve + _tp_static_args([])
             + _mesh(TP_MESH, "phase15", "tp_cut")),
        _Job("15b", ["-m", "repro_torch.launch.train"] + _tp_train_args()),
        _serve_many("16", {
            "16a": _tp_engine_args() + _mesh(TP_MESH, "phase16",
                                             "engine_cut"),
            "16b": _tp_engine_args(spec=True) + _mesh(TP_MESH, "phase16",
                                                      "spec")}, "phase16"),
        _serve_many("17", {
            "17a": _ep_args() + _mesh(EP_MESH, "phase17", "ep"),
            "17b": _ep_engine_args() + _mesh(EP_MESH, "phase17",
                                             "ep_engine")}, "phase17"),
        _Job("17c", [prog, os.path.join(ROOT, "build", "phase17",
                                        "ep_layer")]),
        _serve_many("18", {
            "18a": _tp_static_args(["--quantize", "int8"])
            + _mesh(TP_MESH, "phase18", "int8_tp"),
            "18b": _int8_engine_args() + _mesh(TP_MESH, "phase18",
                                               "engine")}, "phase18"),
        _serve_many("19", {label: _static_args(arch, layers)
                           + _mesh(TP_MESH, "phase19", label)
                           for label, (arch, layers) in FAMILY_TP.items()},
                    "phase19"),
        _serve_many("21int8", {
            label: _static_args(arch, layers, INT8)
            + _mesh(TP_MESH, "phase21", label)
            for label, (arch, layers) in FAMILY_INT8_TP.items()}, "phase21"),
        _serve_many("21tp3", {
            "21e": _static_args("qwen1.5-4b", TP_CUT, gen=TP3_GEN)
            + _mesh(TP3_MESH, "phase21", "21e"),
            "21f": _tp_engine_args() + _mesh(TP3_MESH, "phase21", "21f")},
            "phase21", nproc=_ranks(TP3_MESH)),
    ])


# one torchrun job that serves several launch.serve runs in turn: one
# start-up (the interpreters, the process group, the CUDA contexts) for
# them all, each run its own record (``--record-out``)
SERVE_MANY_PROG = r'''
import gc, json, sys

import torch

from repro_torch.launch import serve

for argv in json.load(open(sys.argv[1])):
    serve.main(argv)
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
'''


def _serve_many(tag: str, runs: dict[str, list[str]], where: str,
                nproc: int = 2) -> _Job:
    """A job over ``nproc`` ranks that runs ``launch.serve`` with each of
    ``runs``' argument lists in turn (SERVE_MANY_PROG), under its own tag
    and each run's."""
    out = os.path.join(ROOT, "build", where)
    os.makedirs(out, exist_ok=True)
    prog, argv = (os.path.join(out, f"{tag}.{ext}") for ext in ("py",
                                                                 "json"))
    with open(prog, "w") as f:
        f.write(SERVE_MANY_PROG)
    with open(argv, "w") as f:
        json.dump(list(runs.values()), f)
    return _Job(tag, [prog, argv], nproc=nproc, also=tuple(runs))


def _lines(out: str, heads: tuple[str, ...]) -> str:
    return " | ".join(ln.strip() for ln in out.splitlines()
                      if ln.lstrip().startswith(heads))


def _tp_serve_run(torch, jobs: _Jobs, label: str, args: list[str],
                  tag: str, where: str, n: int = 2,
                  reuse: str | None = None) -> tuple[dict, list]:
    """The static server at 1 x 1 in this process (``reuse``: the record
    an earlier phase wrote under build/, of the same model and prompts),
    then the ``n`` ranks of job ``label``: (the 1 x 1 record, the
    ranks')."""
    from repro_torch.launch import serve

    out = os.path.join(ROOT, "build", where)
    os.makedirs(out, exist_ok=True)
    if reuse is not None:
        ref = torch.load(os.path.join(ROOT, "build", reuse + ".rank0.pt"),
                         weights_only=False)
    else:
        _free(torch)
        torch.cuda.reset_peak_memory_stats()
        one = serve.main(args + ["--record-out", os.path.join(out,
                                                               tag + "1")])
        ref = one["record"]
        del one
        _free(torch)
    jobs.result(label, label, ("[mesh]", "[serve]", "[plan-cache]"))
    return ref, _records(torch, where, tag, n)


def _logit_err(a, b) -> float:
    return ((a - b).abs() / (1 + b.abs())).max().item()


def _less(kinds: dict, *drop: str) -> dict:
    """``kinds`` without the kinds ``drop`` names."""
    return {k: v for k, v in kinds.items() if k not in drop}


def tp_serve(torch, jobs: _Jobs) -> dict[str, int]:
    """15a: the static server over a (1, 2) mesh on the card, cut to
    TP_CUT layers (its full depth's run made room for phase 17)."""
    return _tp_static(torch, jobs, "15a", [])


def _tp_static(torch, jobs: _Jobs, label: str, extra: list[str],
               arch: str = "qwen1.5-4b", layers: int | None = TP_CUT,
               mesh: str = TP_MESH, gen: int = GEN,
               reuse: str | None = None,
               decode_gate: bool = False) -> dict[str, int]:
    """15a (float), 18a (``extra`` = ``--quantize int8``), 19a-19d and
    21a-21d (``arch`` at ``layers``, None: the full depth; 21a-21d int8)
    and 21e (``mesh`` 1x3, ``gen`` tokens): the static server over
    ``mesh`` against the same path at 1 x 1 in this process (``reuse``:
    an earlier phase's record of it). The collective bytes by kind are the
    float step's dry-run cell's, and besides them (int8) the W8A8 scales'
    MAX over 'model': one 4-byte absmax for each row-parallel product
    (``_scale_max``). The launches: the one-device rule at the local
    shapes (``_tp_rule``). Gated: the prefill's logits, the greedy tokens
    up to each row's first near-tie and (``decode_gate``) the decode
    steps' logits while a row's tokens are the 1 x 1 run's."""
    import dataclasses as dc

    from repro_torch import configs as C
    from repro_torch.core.context import use_context
    from repro_torch.core.plancache import PlanCache
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import Mesh

    quant = "--quantize" in extra
    args = _static_args(arch, layers, extra, gen)
    n = _ranks(mesh)
    phase(f"{label} tensor-parallel static server"
          + (" with int8 weights (W8A8 over 'model')" if quant else "")
          + f": torchrun --nproc-per-node {n} -m repro_torch.launch.serve "
          f"--mesh {mesh} --backend gloo " + " ".join(
              a if a else "''" for a in args)
          + " (full width), against the same path at 1 x 1 "
          + ("in this process" if reuse is None else
             f"(build/{reuse}: its first {gen} steps)"))
    t0 = time.perf_counter()
    tag, where = {"15a": ("tp_cut", "phase15"),
                  "18a": ("int8_tp", "phase18")}.get(
                      label, (label, "phase" + label[:2]))
    ref, recs = _tp_serve_run(torch, jobs, label, args, tag, where, n,
                              reuse)
    cfg = C.get_config(arch)
    if layers is not None:
        cfg = dc.replace(cfg, n_layers=layers).validate()
    with use_context(hw="h100", plan_cache=PlanCache()):
        abstract = Mesh(("data", "model"), tuple(
            int(d) for d in mesh.split("x")))
        want_pre = dryrun.serve_cell(cfg, abstract, "prefill", BATCH,
                                     PROMPT)["cost"]["by_collective"]
        want_dec = dryrun.serve_cell(cfg, abstract, "decode", BATCH,
                                     PROMPT + gen + 1)["cost"]["by_collective"]
    L = cfg.n_layers
    scale = _scale_max(cfg) if quant else (0, 0)
    rule = _tp_rule(cfg, quant, gen)
    pre_err = _logit_err(recs[0]["logits"][0], ref["logits"][0])
    # greedy tokens: each row up to its first position whose 1 x 1 top-2
    # margin is within the tolerance; the decode steps' logits of a row
    # while its tokens so far are the 1 x 1 run's (step t + 1 read
    # tokens 0..t)
    held = same = n_dec = 0
    dec_err = 0.0
    for row in range(BATCH):
        for t in range(gen):
            top2 = ref["logits"][t][row, :cfg.vocab_size].topk(2).values
            if not top2[0] - top2[1] > PATH_TOL * (1 + top2[0].abs()):
                break
            held += 1
            same += int(recs[0]["tokens"][row, t] == ref["tokens"][row, t])
        for t in range(gen):
            if not torch.equal(recs[0]["tokens"][row, :t + 1],
                               ref["tokens"][row, :t + 1]):
                break
            dec_err = max(dec_err, _logit_err(
                recs[0]["logits"][t + 1][row], ref["logits"][t + 1][row]))
            n_dec += 1
    failed = []
    ranks_equal = all(torch.equal(recs[0]["tokens"], rec["tokens"])
                      for rec in recs[1:])
    if not ranks_equal:
        failed.append("the ranks' tokens differ")
    if same != held:
        failed.append(f"greedy tokens {same}/{held}")
    for rec in recs:
        r = rec["rank"]
        ms = statistics.median(rec["decode_s"]) * 1e3
        steps = [rec["prefill_by_kind"]] + rec["decode_by_kind"]
        print(f"rank {r}: launches {rec['launches']} (rule {rule}); lazy "
              f"solves {rec['lazy_solves']}, misses {rec['misses']}; "
              f"collective bytes prefill {rec['prefill_by_kind']} (dry run "
              f"{want_pre}), decode steps "
              f"{sorted(set(rec['decode_bytes']))} (dry run {want_dec}"
              + (f", and scale_max {scale[0]} / {scale[1]} a prefill / "
                 "step" if quant else "")
              + f"); peak serving {rec['peak_gib']:.2f} GiB (one device "
              f"{ref['peak_gib']:.2f}), the load {rec['init_peak_gib']:.2f} "
              f"(one device {ref['init_peak_gib']:.2f}); prefill "
              f"{rec['prefill_s'] * 1e3:.1f} ms, decode step {ms:.2f} ms "
              f"(median, eager; one device, replayed "
              f"{statistics.median(ref['decode_s']) * 1e3:.2f} ms)",
              flush=True)
        if rec["launches"] != rule:
            failed.append(f"rank {r} launches {rec['launches']}")
        if rec["lazy_solves"] or rec["misses"]:
            failed.append(f"rank {r} was not plan-warm")
        if _less(steps[0], "scale_max") != want_pre or any(
                _less(k, "scale_max") != want_dec for k in steps[1:]) or \
                steps[0].get("scale_max", 0) != scale[0] or any(
                    k.get("scale_max", 0) != scale[1] for k in steps[1:]):
            failed.append(f"rank {r} collective bytes differ from the dry "
                          "run's" + (" plus scale_max" if quant else ""))
    print(f"{L} layers: prefill logits max |tp - one| / (1 + |one|) = "
          f"{pre_err:.4g} (tol {PATH_TOL}); greedy tokens equal at "
          f"{same}/{held} positions whose top-2 margin exceeds {PATH_TOL}; "
          f"decode logits on the rows' equal tokens {dec_err:.4g} over "
          f"{n_dec} of {BATCH * gen} row-steps"
          + (" (gated)" if decode_gate else "")
          + f"; the ranks' tokens equal: {ranks_equal}; phase "
          f"{label} {time.perf_counter() - t0:.1f}s", flush=True)
    if not pre_err <= PATH_TOL:
        failed.append(f"prefill logits at {L} layers {pre_err} > "
                      f"{PATH_TOL}")
    if decode_gate and not (n_dec and dec_err <= PATH_TOL):
        failed.append(f"decode logits at {L} layers {dec_err} over {n_dec} "
                      f"row-steps, tol {PATH_TOL}")
    counts = recs[0]["launches"]
    del recs, ref
    _free(torch)
    if failed:
        raise SystemExit(f"{label}: " + "; ".join(failed))
    return counts


def _tp_rule(cfg, quant: bool = False, gen: int = GEN) -> dict[str, int]:
    """A rank's launches of the static server over 'model' (prefill,
    ``gen`` decode steps): the one-device rule of PATHS at ``cfg``'s
    depth, at the local shapes. whisper: the decoder's MLP out is
    row-parallel, its bias added after the sum, so at decode its local
    product has no epilogue and takes the GEMV (7 fat GEMMs and 3 GEMVs a
    decoder layer a step, 8 and 2 on one device); every other family's
    local products keep their kernel. int8 (4c, 5d, 10b, 11c, 12b): every
    W8A8 product fat, a row-parallel block's int32 partials too, at
    prefill and at each step: qwen1.5-4b and the vision model 7 a layer
    and the dynamic unembed's block; rwkv6-3b 11 a layer and the unembed,
    the WKV kernel once a layer at prefill; zamba2-1.2b 2 a Mamba layer
    and 7 a shared-block call and the unembed; whisper-base the encoder's
    6 a layer (prefill) and 10 a decoder layer, its tied unembed the float
    GEMV."""
    L, g = cfg.n_layers, gen
    if quant:
        if cfg.family == "rwkv":
            return {"matmul": (g + 1) * (11 * L + 1), "gemv": 0, "wkv": L}
        if cfg.family == "hybrid":
            S = -(-L // cfg.shared_attn_every)
            return {"matmul": (g + 1) * (2 * L + 7 * S + 1), "gemv": 0,
                    "wkv": 0}
        if cfg.family == "encdec":
            return {"matmul": 6 * cfg.n_encoder_layers + 10 * L
                    + g * 10 * L, "gemv": 1 + g, "wkv": 0}
        return {"matmul": (g + 1) * (7 * L + 1), "gemv": 0, "wkv": 0}
    if cfg.family == "rwkv":
        return {"matmul": 11 * L + g * 3 * L, "gemv": 1 + g * (8 * L + 1),
                "wkv": L}
    if cfg.family == "hybrid":
        S = -(-L // cfg.shared_attn_every)  # shared-block calls
        return {"matmul": 2 * L + 7 * S + g * S,
                "gemv": 1 + g * (2 * L + 6 * S + 1), "wkv": 0}
    if cfg.family == "encdec":
        return {"matmul": 6 * cfg.n_encoder_layers + 10 * L + g * 7 * L,
                "gemv": 1 + g * (3 * L + 1), "wkv": 0}
    if cfg.family == "vlm":
        X = L // cfg.cross_attn_every  # cross layers
        return {"matmul": 7 * L + g * ((L - X) + 3 * X),
                "gemv": 1 + g * (6 * (L - X) + 4 * X + 1), "wkv": 0}
    return {"matmul": 7 * L + g * 4 * L, "gemv": 1 + g * (3 * L + 1),
            "wkv": 0}


def _scale_max(cfg) -> tuple[int, int]:
    """The bytes of a rank's W8A8 scale reductions over 'model' (prefill,
    a decode step): one 4-byte MAX of the activation absmax for each
    row-parallel product (a pre-quantized block keeps its whole
    ``w_scale``): attention's wo and the MLP's w_out a layer (qwen1.5-4b,
    the vision model's self and cross layers); rwkv6-3b's time-mix wo and
    channel-mix wv; zamba2-1.2b's Mamba w_out a layer and the shared
    block's wo and w_out a call; whisper-base's encoder wo and w_out a
    layer (prefill) and its decoder's self and cross wo and MLP out."""
    L = cfg.n_layers
    if cfg.family == "hybrid":
        n = L + 2 * -(-L // cfg.shared_attn_every)
        return 4 * n, 4 * n
    if cfg.family == "encdec":
        return 4 * (2 * cfg.n_encoder_layers + 3 * L), 4 * 3 * L
    return 4 * 2 * L, 4 * 2 * L


# ------------------------------------------------------------ phase 19
# the static server over the (1, 2) mesh for the other families, each
# tensor-parallel inside its own layers (module docstring, 19): label:
# (arch, layers; None: the full depth). rwkv6-3b at TP_CUT layers, zamba2
# at 2 (layer 0 runs the shared block), whisper-base whole, the vision
# model at one group (4 self layers and the cross layer)
FAMILY_TP = {"19a": ("rwkv6-3b", TP_CUT), "19b": ("zamba2-1.2b", 2),
             "19c": ("whisper-base", None),
             "19d": ("llama-3.2-vision-11b", 5)}


def family_tp(torch, jobs: _Jobs) -> dict[str, dict[str, int]]:
    """19a-19d: each family's static server over the (1, 2) mesh against
    the same path on one device; a rank's launches by family."""
    return {f"{arch} tp serve (1x2, a rank, "
            f"{'all' if layers is None else layers} layers)":
            _tp_static(torch, jobs, label, [], arch, layers)
            for label, (arch, layers) in FAMILY_TP.items()}


# ------------------------------------------------------------ phase 21
# serving over a mesh with nothing refused (module docstring, 21): 21a-21d
# phase 19's jobs with int8 weights; qwen1.5-4b over (1, 3), where 'model'
# divides neither its 20 kv heads nor head_dim 128: 21e the static server
# at TP3_GEN tokens (max_len = 128 + 15 + 1 = 144, which 3 divides: the
# cache's sequence over 'model'), 21f the paged engine (its pool whole),
# each held to 15a's / 16a's one-device record (the same weights, prompts
# and engine), so no model is built twice
INT8 = ["--quantize", "int8"]
FAMILY_INT8_TP = {"21" + label[2:]: v for label, v in FAMILY_TP.items()}
TP3_MESH, TP3_GEN = "1x3", 15


def int8_family_tp(torch, jobs: _Jobs) -> dict[str, dict[str, int]]:
    """21a-21d: each family's static server with int8 weights over the
    (1, 2) mesh against the same path on one device; a rank's launches by
    family."""
    return {f"{arch} int8 tp serve (1x2, a rank, "
            f"{'all' if layers is None else layers} layers)":
            _tp_static(torch, jobs, label, INT8, arch, layers)
            for label, (arch, layers) in FAMILY_INT8_TP.items()}


def seq_cache_tp(torch, jobs: _Jobs) -> dict[str, int]:
    """21e: the static server over (1, 3), its cache's sequence over
    'model', against 15a's one-device record; its decode steps' logits
    gated too (they alone normalize the softmax over 'model')."""
    return _tp_static(torch, jobs, "21e", [], mesh=TP3_MESH, gen=TP3_GEN,
                      reuse="phase15/tp_cut1", decode_gate=True)


def whole_pool_tp_engine(torch, jobs: _Jobs) -> dict[str, int]:
    """21f: 16a's engine over (1, 3), its pool whole on every rank,
    against 16a's one-device record."""
    import dataclasses as dc

    from repro_torch import configs as C

    args = _tp_engine_args()
    n = _ranks(TP3_MESH)
    phase(f"21f the engine over a (1, 3) mesh, its pool whole on every "
          f"rank: torchrun --nproc-per-node {n} -m repro_torch.launch.serve "
          + " ".join(a if a else "''" for a in args)
          + f" --mesh {TP3_MESH} --backend gloo (full width, {TP_CUT} "
          "layers), against 16a's one device (build/phase16/engine_cut1)")
    t0 = time.perf_counter()
    ref, recs = _tp_engine_run(torch, jobs, "21f", args, "21f", "phase21",
                               n, reuse="phase16/engine_cut1")
    cut = dc.replace(C.get_config("qwen1.5-4b"), n_layers=TP_CUT)
    cells = _engine_cells(torch, cut, ref["engine"], False, shape=(1, n))

    def rule(dispatches):
        steps = sum(dispatches.values())
        return {k: m * steps for k, m in TP_SPEC_STEP.items()}

    failed = _tp_engine_gates(torch, f"{TP_CUT} layers over {TP3_MESH}",
                              ref, recs, rule, cells, pool_div=1)
    err = _first_logits_err(ref, recs[0])
    print(f"first-token logits max |mesh - one| / (1 + |one|): {TP_CUT} "
          f"layers {err:.4g} (tol {PATH_TOL}); phase 21f "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    if not err <= PATH_TOL:
        failed.append(f"first-token logits at {TP_CUT} layers {err} > "
                      f"{PATH_TOL}")
    counts = recs[0]["launches"]
    del ref, recs
    _free(torch)
    if failed:
        raise SystemExit("21f: " + "; ".join(failed))
    return counts


def tp_train(torch, jobs: _Jobs) -> dict[str, int]:
    """15b: the tensor-parallel train step through the launcher on a
    (1, 2) mesh against the one-device step on the card."""
    from repro_torch import configs as C
    from repro_torch.core.context import use_context
    from repro_torch.core.plancache import PlanCache
    from repro_torch.data.synthetic import batch_for
    from repro_torch.interop import tree_items
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import Mesh
    from repro_torch.train.trainstep import make_train_step

    cut = dataclasses.replace(C.get_config(TRAIN_ARCH), n_layers=TP_LAYERS)
    phase(f"15b tensor-parallel training: torchrun --nproc-per-node 2 -m "
          f"repro_torch.launch.train --arch {TRAIN_ARCH} --n-layers "
          f"{TP_LAYERS} --mesh {TP_MESH} --backend gloo, batch "
          f"{TRAIN_BATCH} x {TRAIN_SEQ}, 2 AdamW steps, against "
          f"make_train_step(mesh=None) on the card; tolerances loss "
          f"{TRAIN_LOSS_TOL}, gradient norm {TP_GNORM_TOL}, updates "
          f"{TRAIN_UPDATE_TOL} (each leaf below {TRAIN_LEAF_UPDATE_TOL})")
    with use_context(hw="h100", plan_cache=PlanCache()):
        art = make_train_step(cut, global_batch=TRAIN_BATCH,
                              seq_len=TRAIN_SEQ, device="cuda")
        state = art.init_fn(0)
        before = {p: t.detach().cpu() for p, t in tree_items(
            state["params"])}
        losses, gnorms = [], []
        for step in range(2):
            state, m = art.step_fn(state, batch_for(cut, TRAIN_SEQ,
                                                    TRAIN_BATCH, step))
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
        one = {p: t.detach().cpu() - before[p]
               for p, t in tree_items(state["params"])}
        del state, art
        _free(torch)
        want = dryrun.train_cell(cut, Mesh(("data", "model"), (1, 2)),
                                 TRAIN_BATCH, TRAIN_SEQ)["cost"]
    path = os.path.join(ROOT, "build", "phase15", "train.pt")
    jobs.result("15b", "15b", ("[train]", "step"))
    rec = torch.load(path)
    tp = {p: t - before[p] for p, t in rec["params"].items()}
    rel = lambda x, y: ((x - y).norm() / y.norm().clamp_min(1e-30)).item()
    loss = max(abs(a - b) / abs(b) for a, b in zip(rec["losses"], losses))
    gnorm = max(abs(a - b) / abs(b)
                for a, b in zip(rec["grad_norms"], gnorms))
    upd = max((rel(tp[k], one[k]), k) for k in one)
    both = (sum((tp[k] - one[k]).norm() ** 2 for k in one)
            / sum(u.norm() ** 2 for u in one.values())).sqrt().item()
    print(f"losses {rec['losses']} / one device {losses} (worst relative "
          f"{loss:.3g}); gradient norms {rec['grad_norms']} / {gnorms} "
          f"({gnorm:.3g}); updates {both:.4g} (worst leaf {upd[0]:.4g}, "
          f"{upd[1]}); collective bytes a step {rec['collective_bytes']} "
          f"(dry run {want['by_collective']}); step s "
          f"{[round(x, 3) for x in rec['step_s']]}; launches of rank 0 "
          f"{rec['launches']}", flush=True)
    failed = []
    if not (loss <= TRAIN_LOSS_TOL and gnorm <= TP_GNORM_TOL
            and both <= TRAIN_UPDATE_TOL
            and upd[0] < TRAIN_LEAF_UPDATE_TOL):
        failed.append("the mesh step is beyond a tolerance of the "
                      "one-device step")
    if any(b != want["by_collective"] for b in rec["collective_bytes"]):
        failed.append("collective bytes differ from the dry run's")
    counts = rec["launches"]
    del rec, tp, one, before
    _free(torch)
    if failed:
        raise SystemExit("15b: " + "; ".join(failed))
    return counts


def tp_dryrun(torch, train_rec: dict) -> None:
    """15c: the dry run's cells on the production mesh with tensor
    parallelism: train_4k's model-FLOPs ratio (14d's record) and
    decode_32k's collective bytes."""
    from repro_torch.launch import dryrun
    from repro_torch.roofline import report

    phase("15c dry run on the meta device with tensor parallelism: "
          f"{DIST_CELL[0]} x train_4k and decode_32k x 16x16")
    ratio = train_rec["roofline"]["useful_flops_ratio"]
    rec = dryrun.run_cell(DIST_CELL[0], "decode_32k", False,
                          os.path.join(ROOT, "build", "phase15"))
    if rec["status"] != "ok":
        raise SystemExit(f"15c: the dry run failed: {rec.get('trace')}")
    print(f"train_4k: 6ND / counted FLOPs {ratio:.4f} (gate {TP_RATIO}); "
          f"collective bytes {train_rec['cost']['by_collective']}")
    print(f"decode_32k: {rec['cost']['flops_per_device']:.4g} FLOPs, "
          f"collective bytes {rec['cost']['by_collective']}, "
          f"{rec['wall_s']:.1f}s; "
          + report.roofline_row(report.enrich(rec, hw="h100")))
    if not ratio >= TP_RATIO or not rec["cost"][
            "collective_bytes_per_device"] > 0:
        raise SystemExit("15c: the model-FLOPs ratio or the decode cell's "
                         "collective bytes are off")


# ------------------------------------------------------------ phase 16
# the serving engines over the (1, 2) mesh of phase 15 (gloo, two ranks on
# the card): 16a phase 7's engine (qwen1.5-4b at full width, 8 lanes, 74
# blocks of 16, chunks <= 128, its trace), cut to TP_CUT layers (its full
# depth's run, ~60 s, made room for phase 17), through
# ``launch.serve --engine --mesh 1x2``, against the same engine on one
# device in this process (captured): both ranks' tokens and admission
# sequences equal; the tokens equal to the one device's up to each
# request's first position whose one-device top-2 margin is within
# PATH_TOL of (1 + |top|) (15a's rule); a rank's launches phase 7's rule
# at the local shapes and the cut depth, zero lazy solves; each tick's
# and chunk's collective bytes the dry run's cell
# (launch.dryrun.engine_cells); a rank's pool half the one device's; each
# request's first-token logits within PATH_TOL. 16b: phase 7c's speculative engine
# over the same mesh, the draft float and the target's config, both cut
# to TP_CUT layers: the same gates (a float draft step runs a tick's
# kernels: TP_SPEC_STEP, k + 1 of them a propose step), the ranks'
# speculation sections equal and each one's committed tokens the tokens
# generated less one a request. The acceptance against the one device's
# is printed, not gated: bf16 activations at random weights put most
# positions within PATH_TOL of a tie (on an H100, 8 of 156 were held),
# and a flipped argmax forks the rest of a stream (there one device
# accepted 0.886, the ranks 0.806). Printed: a rank's peak and the eager
# steps' host ms (the card synchronized)
TP_SPEC_STEP = {"matmul": 4 * TP_CUT, "gemv": 3 * TP_CUT + 1, "wkv": 0}


def _tp_engine_run(torch, jobs: _Jobs, label: str, args: list[str],
                   tag: str, where: str = "phase16", n: int = 2,
                   reuse: str | None = None) -> tuple[dict, list]:
    """The engine on one device in this process (``reuse``: the record an
    earlier phase wrote under build/ of the same engine), then the ``n``
    ranks of job ``label``: (the one device's record, the ranks')."""
    from repro_torch.launch import serve

    out = os.path.join(ROOT, "build", where)
    os.makedirs(out, exist_ok=True)
    if reuse is None:
        _free(torch)
        one = serve.main(args + ["--record-out", os.path.join(out,
                                                               tag + "1")])
        del one
        _free(torch)
        reuse = os.path.join(where, tag + "1")
    ref = torch.load(os.path.join(ROOT, "build", reuse + ".rank0.pt"),
                     weights_only=False)
    jobs.result(label, label, ("[mesh]", "[engine]", "[spec]", "[kv-quant]",
                               "[plan-cache] serving"))
    return ref, _records(torch, where, tag, n)


def _held_tokens(ref: dict, rec: dict) -> tuple[int, int]:
    """(positions compared, positions equal): each request's tokens up to
    its first one whose one-device top-2 margin is within PATH_TOL."""
    first_tie = {}
    for i, n, _, margin, top in ref["token_log"]:
        if i not in first_tie and not margin > PATH_TOL * (1 + abs(top)):
            first_tie[i] = n
    held = same = 0
    for i, toks in ref["tokens"].items():
        n = first_tie.get(i, len(toks))
        held += n
        same += sum(a == b for a, b in zip(rec["tokens"][i][:n], toks[:n]))
    return held, same


def _tp_engine_gates(torch, label: str, ref: dict, recs: list, rule,
                     cells: dict, gate_tokens: bool = True,
                     scale: int = 0, pool_div: int = 2) -> list[str]:
    """Phase 16's gates shared by 16a, 16b, 17b, 18b and 21f; prints each
    rank's numbers. ``gate_tokens``: the tokens held to the one device's
    before each near-tie (else printed). ``scale``: the bytes of the W8A8
    and int8-pool scales' MAX reductions a step (``scale_max``) besides
    the float step's dry-run cell. ``pool_div``: a rank's share of the
    pool (1: whole on every rank). Returns the failures."""
    failed = []
    a = recs[0]
    ranks_equal = all(a["tokens"] == b["tokens"]
                      and a["admissions"] == b["admissions"]
                      for b in recs[1:])
    if not ranks_equal:
        failed.append("the ranks' tokens or admissions differ")
    held, same = _held_tokens(ref, a)
    if same != held and gate_tokens:
        failed.append(f"tokens {same}/{held} equal to the one device's")
    want_bytes = {k: c["collective_bytes_per_device"] + scale
                  for k, c in cells.items()}
    for rec in recs:
        r = rec["rank"]
        want = rule(rec["dispatches"])
        seen = {k: sorted(set(v)) for k, v in rec["step_bytes"].items()}
        ms = {k: statistics.median(v) for k, v in rec["step_ms"].items()}
        print(f"rank {r}: steps {rec['dispatches']}; launches "
              f"{rec['launches']} (rule {want}); lazy solves "
              f"{rec['lazy_solves']}, misses {rec['misses']}; collective "
              f"bytes by step {seen} (dry run {want_bytes}), clock "
              f"{rec['clock_bytes']}; pool {rec['pool_bytes']} bytes (one "
              f"device {ref['pool_bytes']}); peak {rec['peak_gib']:.2f} GiB "
              f"(one device {ref['peak_gib']:.2f}; the load "
              f"{rec['init_peak_gib']:.2f}); eager step ms (median, host "
              f"clock, synchronized) "
              f"{ {k: round(v, 2) for k, v in sorted(ms.items())} }",
              flush=True)
        if rec["launches"] != want:
            failed.append(f"rank {r} launches {rec['launches']}")
        if rec["lazy_solves"] or rec["misses"]:
            failed.append(f"rank {r} was not plan-warm")
        if any(v != [want_bytes.get(k)] for k, v in seen.items()) or any(
                _less(kinds, "scale_max") != cells[k]["by_collective"]
                or kinds.get("scale_max", 0) != scale
                for k, v in rec["step_kinds"].items() for kinds in v):
            failed.append(f"rank {r} collective bytes differ from the dry "
                          "run's" + (" plus scale_max" if scale else ""))
        if pool_div * rec["pool_bytes"] != ref["pool_bytes"]:
            failed.append(f"rank {r} pool {rec['pool_bytes']} is not "
                          f"1/{pool_div} of {ref['pool_bytes']}")
    total = sum(map(len, ref["tokens"].values()))
    print(f"{label}: tokens equal to the one device's at {same}/{held} "
          f"positions before a near-tie ({total} in all"
          + ("" if gate_tokens else "; printed, not gated")
          + f"); the ranks' tokens equal: {ranks_equal}", flush=True)
    return failed


def _first_logits_err(ref: dict, rec: dict) -> float:
    return max(_logit_err(rec["first_logits"][i], ref["first_logits"][i])
               for i in ref["first_logits"])


def _engine_cells(torch, cfg, engine: dict, draft: bool,
                  shape: tuple = (1, 2)) -> dict:
    """The dry run's cells of the engine a record describes (its
    ``engine`` section), over an abstract mesh of ``shape``."""
    from repro_torch.core.context import use_context
    from repro_torch.core.plancache import PlanCache
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import Mesh

    with use_context(hw="h100", plan_cache=PlanCache()):
        return dryrun.engine_cells(
            cfg, Mesh(("data", "model"), shape),
            num_slots=engine["num_slots"], max_len=engine["max_len"],
            prompt_pad=engine["prompt_pad"],
            kv_block_size=engine["kv_block_size"],
            num_kv_blocks=engine["num_kv_blocks"],
            prefill_chunk=engine["prefill_chunk"],
            draft_cfg=cfg if draft else None,
            spec_k=engine.get("spec_k", SPEC_K))


def tp_engine(torch, jobs: _Jobs) -> dict[str, int]:
    """16a: phase 7's engine over the (1, 2) mesh, cut to TP_CUT layers
    (the full depth's run, ~60 s, made room for phase 17)."""
    import dataclasses as dc

    from repro_torch import configs as C

    args = _tp_engine_args()
    phase("16a the engine over a mesh: torchrun --nproc-per-node 2 -m "
          "repro_torch.launch.serve " + " ".join(a if a else "''"
                                                 for a in args)
          + f" --mesh {TP_MESH} --backend gloo (full width, {TP_CUT} "
          "layers), against the same engine on one device in this process")
    t0 = time.perf_counter()
    ref, recs = _tp_engine_run(torch, jobs, "16a", args, "engine_cut")
    cut = dc.replace(C.get_config("qwen1.5-4b"), n_layers=TP_CUT)
    cells = _engine_cells(torch, cut, ref["engine"], False)

    def rule(dispatches):
        steps = sum(dispatches.values())
        return {k: n * steps for k, n in TP_SPEC_STEP.items()}

    failed = _tp_engine_gates(torch, f"{TP_CUT} layers", ref, recs, rule,
                              cells)
    err = _first_logits_err(ref, recs[0])
    print(f"first-token logits max |mesh - one| / (1 + |one|): {TP_CUT} "
          f"layers {err:.4g} (tol {PATH_TOL}); phase 16a "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    if not err <= PATH_TOL:
        failed.append(f"first-token logits at {TP_CUT} layers {err} > "
                      f"{PATH_TOL}")
    counts = recs[0]["launches"]
    del ref, recs
    _free(torch)
    if failed:
        raise SystemExit("16a: " + "; ".join(failed))
    return counts


def tp_spec_engine(torch, jobs: _Jobs) -> dict[str, int]:
    """16b: the speculative engine over the (1, 2) mesh, target and float
    draft cut to TP_CUT layers."""
    import dataclasses as dc

    from repro_torch import configs as C

    args = _tp_engine_args(spec=True)
    phase("16b the speculative engine over a mesh: torchrun "
          "--nproc-per-node 2 -m repro_torch.launch.serve "
          + " ".join(a if a else "''" for a in args)
          + f" --mesh {TP_MESH} --backend gloo (the draft float, the "
          "target's config), against the same engine on one device")
    t0 = time.perf_counter()
    ref, recs = _tp_engine_run(torch, jobs, "16b", args, "spec")
    cut = dc.replace(C.get_config("qwen1.5-4b"), n_layers=TP_CUT)
    cells = _engine_cells(torch, cut, ref["engine"], True)

    def rule(dispatches):
        return {k: sum(n * per * (SPEC_K + 1 if name == "spec-draft" else 1)
                       for name, n in dispatches.items())
                for k, per in TP_SPEC_STEP.items()}

    failed = _tp_engine_gates(torch, "speculative", ref, recs, rule, cells)
    err = _first_logits_err(ref, recs[0])
    sp = [r["speculation"] for r in (ref, *recs)]
    print(f"acceptance one device {sp[0]['acceptance_rate']} "
          f"({sp[0]['accepted_tokens']}/{sp[0]['proposed_tokens']}), ranks "
          + ", ".join(f"{x['acceptance_rate']} ({x['accepted_tokens']}/"
                      f"{x['proposed_tokens']})" for x in sp[1:])
          + "; against the one device printed, not gated: a near-tie "
          "argmax that the TP sums flip forks a stream and its acceptance "
          f"from there; first-token logits max |mesh - one| / (1 + |one|) "
          f"{err:.4g} (tol {PATH_TOL}); phase 16b "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    if not err <= PATH_TOL:
        failed.append(f"first-token logits {err} > {PATH_TOL}")
    counted = lambda x: {k: v for k, v in x.items()
                         if k not in ("draft_s", "verify_s")}
    if counted(sp[1]) != counted(sp[2]):
        failed.append("the ranks' speculation sections differ")
    for x, rec in zip(sp[1:], recs):
        generated = sum(map(len, rec["tokens"].values()))
        if x["committed_tokens"] != generated - len(rec["tokens"]):
            failed.append(f"rank {rec['rank']}: committed_tokens "
                          f"{x['committed_tokens']} != generated "
                          f"{generated} - requests {len(rec['tokens'])}")
    counts = recs[0]["launches"]
    del ref, recs
    _free(torch)
    if failed:
        raise SystemExit("16b: " + "; ".join(failed))
    return counts


# ------------------------------------------------------------ phase 17
# expert parallelism: olmoe-1b-7b over a (2, 1) (data, model) mesh, two
# ranks on the card over gloo, the ranks building the model one at a time
# (launch.serve: the whole f32 model is 27.7 GB at 16 layers, a rank keeps
# half). 17a: the static server at full width and EP_CUT layers (4 x 128,
# 16 tokens, seed 0; at full depth its job took 72 s alone, 39 s of it
# serving over gloo, and its 38 GiB load kept it from running beside the
# other jobs: the script's time limit cut it). Its yardstick is the
# same path on one device with every MoE layer ``moe_ep_plain`` over 2
# shards of the rows (the mesh's semantics), not 9a's one-shard path: the
# reference's level 2 counts a source's empty slots in local expert 0's
# bucket (``re_c = where(valid, re, 0)`` before the cumsum), so on a mesh
# each shard's local expert 0 (experts 0 and 32) loses what the sources
# after the first send it once an earlier source had free slots; against
# 9a that moved the first-token logits by 0.33 (on an H100, 700 W, at
# full depth). Gates: both ranks' tokens equal; the
# tokens equal to the one-device run's up to each row's first position
# whose top-2 margin is within PATH_TOL of (1 + |top|) (15a's rule); the
# first-token logits within PATH_TOL of 1 + |logit|; each rank's launches
# 9a's rule at the local shapes and the cut depth, zero lazy
# solves; the prefill's and each decode step's collective bytes by kind
# the dry run's for a (2, 1) abstract mesh. 17b: phase 9e's paged engine
# over the same mesh at EP_ENGINE_CUT layers: phase 16's gates but the tokens
# against one device, which are printed (with 4 of 8 lanes a rank, Cs =
# 24 a destination against 32 assignments, and the level-2 rule above:
# the reference's semantics). 17c: one olmoe MoE layer at full width
# (seed 0, f32 tables, bf16 rows) on the two ranks at the prefill's rows
# (256 a rank) and the decode's (2 a rank), each rank's output within
# EP_LAYER_TOL of 1 + |y| of layers.moe.moe_ep_plain on the card.
# Printed: each rank's load and serving peaks beside the one device's.
# 17b's engine at 2 layers: the whole script's time; 17a at 2 (4 before
# phase 21 joined the mesh jobs: its time made room for them)
EP_MESH, EP_SHAPE, EP_CUT, EP_ENGINE_CUT = "2x1", (2, 1), 2, 2
EP_LAYER_TOL = 2 ** -7
EP_LAYER_PROG = r'''
import os, sys
import torch
from repro_torch.core.context import use_context
from repro_torch.core.distributed import CollectiveCounter
from repro_torch.interop import tree_items, tree_map_with_path
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.layers import moe
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.fsdp import ShardPlan

out = sys.argv[1]
mesh = make_local_mesh(2, 1, device="cuda", backend="gloo")
gen = torch.Generator(device="cuda").manual_seed(0)
p = moe.init_moe(gen, 2048, 1024, 64, device="cuda")
xs = {n: torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
      for n, shape in (("prefill", (4, 128, 2048)), ("decode", (4, 1, 2048)))}
specs = shd.param_specs({"moe": moe.moe_axes()}, {"moe": p}, mesh)
spec_of = dict(tree_items(specs))
plan = ShardPlan(mesh, specs)
blocks = shd.shard_tree({"moe": p}, specs, mesh)
del p
res = {"rank": mesh.rank}
with use_context(mesh=mesh, shard=plan):
    lp = tree_map_with_path(
        lambda path, t: plan.gather(t, spec_of[path], path), blocks)["moe"]
    for name, x in xs.items():
        rows = shd.shard_leaf(x, shd.P("data"), mesh)
        with CollectiveCounter() as c:
            y, _ = moe.moe_ffn(lp, rows, top_k=8)
        torch.cuda.synchronize()
        res[name] = {"y": y.float().cpu(), "bytes": c.by_kind()}
torch.save(res, f"{out}.rank{mesh.rank}.pt")
import torch.distributed as dist
dist.destroy_process_group()
'''


def _rows_err(recs: list, ref: dict, step: int = 0) -> float:
    """The ranks' logits at ``step`` (each its rows) against the
    one-device record's rows, max |ep - one| / (1 + |one|)."""
    n = recs[0]["logits"][step].shape[0]
    return max(_logit_err(rec["logits"][step],
                          ref["logits"][step][r * n:(r + 1) * n])
               for r, rec in enumerate(recs))


class _plain_ep:
    """Within it, every MoE layer runs ``layers.moe.moe_ep_plain`` over
    ``shards`` DP shards of its rows: the mesh's expert-parallel
    semantics on one device."""

    def __init__(self, shards: int):
        self.shards = shards

    def __enter__(self):
        from repro_torch.layers import moe

        self.saved = moe.moe_ffn
        moe.moe_ffn = lambda p, x, **kw: moe.moe_ep_plain(p, x, self.shards,
                                                          **kw)

    def __exit__(self, *exc):
        from repro_torch.layers import moe

        moe.moe_ffn = self.saved


def _held_rows(torch, ref: dict, tokens, vocab: int) -> tuple[int, int]:
    """(positions compared, positions equal): each row's greedy tokens up
    to its first position whose ``ref`` top-2 margin is within PATH_TOL
    (15a's rule)."""
    held = same = 0
    for row in range(BATCH):
        for t in range(GEN):
            top2 = ref["logits"][t][row, :vocab].topk(2).values
            if not top2[0] - top2[1] > PATH_TOL * (1 + top2[0].abs()):
                break
            held += 1
            same += int(tokens[row, t] == ref["tokens"][row, t])
    return held, same


def ep_serve(torch, jobs: _Jobs) -> dict[str, int]:
    """17a: the static server over the (2, 1) mesh at full width and
    EP_CUT layers, against the same EP semantics on one device."""
    import dataclasses as dc

    from repro_torch import configs as C
    from repro_torch.core.context import use_context
    from repro_torch.core.plancache import PlanCache
    from repro_torch.launch import dryrun, serve
    from repro_torch.launch.mesh import Mesh

    arch = "olmoe-1b-7b"
    args = _ep_args()
    phase(f"17a expert-parallel static server: torchrun --nproc-per-node 2 "
          f"-m repro_torch.launch.serve --mesh {EP_MESH} --backend gloo "
          + " ".join(args) + f" (full width, {EP_CUT} layers), against the "
          "same path on one device with every MoE layer moe_ep_plain over "
          f"{EP_SHAPE[0]} shards")
    t0 = time.perf_counter()
    out = os.path.join(ROOT, "build", "phase17")
    os.makedirs(out, exist_ok=True)
    _free(torch)
    with _plain_ep(EP_SHAPE[0]):
        plain = serve.main(args + [
            "--record-out", os.path.join(out, "ep_plain")])["record"]
    _free(torch)
    jobs.result("17a", "17a", ("[mesh]", "[serve]", "[plan-cache]"))
    recs = _records(torch, "phase17", "ep")
    cfg = dc.replace(C.get_config(arch), n_layers=EP_CUT)
    with use_context(hw="h100", plan_cache=PlanCache()):
        abstract = Mesh(("data", "model"), EP_SHAPE)
        want_pre = dryrun.serve_cell(cfg, abstract, "prefill", BATCH,
                                     PROMPT)["cost"]["by_collective"]
        want_dec = dryrun.serve_cell(cfg, abstract, "decode", BATCH,
                                     PROMPT + GEN + 1)["cost"]["by_collective"]
    # 9a's rule at the cut depth and the local shapes (256 prefill rows and
    # 2 decode rows a rank take the same routes as 9a's 512 and 4)
    L = EP_CUT
    rule = {"matmul": 5 * L + GEN * L, "gemv": 1 + GEN * (4 * L + 1),
            "wkv": 0}
    held, same = _held_rows(torch, plain, recs[0]["tokens"],
                            cfg.vocab_size)
    failed = []
    if not torch.equal(recs[0]["tokens"], recs[1]["tokens"]):
        failed.append("the ranks' tokens differ")
    if same != held:
        failed.append(f"greedy tokens {same}/{held}")
    for rec in recs:
        r = rec["rank"]
        ms = statistics.median(rec["decode_s"]) * 1e3
        dec = [k for k in rec["decode_by_kind"] if k != want_dec]
        print(f"rank {r}: launches {rec['launches']} (rule {rule}); lazy "
              f"solves {rec['lazy_solves']}, misses {rec['misses']}; "
              f"collective bytes prefill {rec['prefill_by_kind']} (dry run "
              f"{want_pre}), a decode step {rec['decode_by_kind'][0]} (dry "
              f"run {want_dec}; {len(dec)} steps differ); peak serving "
              f"{rec['peak_gib']:.2f} GiB (one device "
              f"{plain['peak_gib']:.2f}), the load "
              f"{rec['init_peak_gib']:.2f} (one device "
              f"{plain['init_peak_gib']:.2f}); prefill "
              f"{rec['prefill_s'] * 1e3:.1f} ms, decode step {ms:.2f} ms "
              f"(median, eager over gloo; one device "
              f"{statistics.median(plain['decode_s']) * 1e3:.2f} ms "
              f"replayed)", flush=True)
        if rec["launches"] != rule:
            failed.append(f"rank {r} launches {rec['launches']}")
        if rec["lazy_solves"] or rec["misses"]:
            failed.append(f"rank {r} was not plan-warm")
        if rec["prefill_by_kind"] != want_pre or dec:
            failed.append(f"rank {r} collective bytes differ from the dry "
                          "run's")
    err = _rows_err(recs, plain)
    print(f"{EP_CUT} layers, against one device's moe_ep_plain: first-token "
          f"logits max |ep - plain| / (1 + |plain|) = {err:.4g} (tol "
          f"{PATH_TOL}); greedy tokens equal at {same}/{held} positions "
          f"whose top-2 margin exceeds {PATH_TOL} (at "
          f"{int((recs[0]['tokens'] == plain['tokens']).sum())} of "
          f"{BATCH * GEN} in all, printed); the ranks' tokens "
          f"equal: {torch.equal(recs[0]['tokens'], recs[1]['tokens'])}",
          flush=True)
    if not err <= PATH_TOL:
        failed.append(f"first-token logits at {EP_CUT} layers {err} > "
                      f"{PATH_TOL}")
    counts = recs[0]["launches"]
    del recs, plain
    _free(torch)
    print(f"phase 17a {time.perf_counter() - t0:.1f}s", flush=True)
    if failed:
        raise SystemExit("17a: " + "; ".join(failed))
    return counts


def ep_engine(torch, jobs: _Jobs) -> dict[str, int]:
    """17b: phase 9e's paged engine over the (2, 1) mesh at EP_ENGINE_CUT
    layers."""
    import dataclasses as dc

    from repro_torch import configs as C

    arch = "olmoe-1b-7b"
    args = _ep_engine_args()
    phase("17b the expert-parallel engine: torchrun --nproc-per-node 2 -m "
          "repro_torch.launch.serve " + " ".join(a if a else "''"
                                                 for a in args)
          + f" --mesh {EP_MESH} --backend gloo, against the same engine on "
          "one device in this process")
    t0 = time.perf_counter()
    ref, recs = _tp_engine_run(torch, jobs, "17b", args, "ep_engine",
                               where="phase17")
    cut = dc.replace(C.get_config(arch), n_layers=EP_ENGINE_CUT)
    cells = _engine_cells(torch, cut, ref["engine"], False, EP_SHAPE)
    # a tick (4 lanes a rank) and a chunk (its rows whole; the MoE block
    # splits them over 'data') run q, k, v, wo on the GEMV and the router
    # on the fat GEMM a layer, then the unembed GEMV
    step = {"matmul": EP_ENGINE_CUT, "gemv": 4 * EP_ENGINE_CUT + 1, "wkv": 0}

    def rule(dispatches):
        steps = sum(dispatches.values())
        return {k: n * steps for k, n in step.items()}

    failed = _tp_engine_gates(torch, f"{EP_ENGINE_CUT} layers", ref, recs, rule,
                              cells, gate_tokens=False)
    counts = recs[0]["launches"]
    print(f"phase 17b {time.perf_counter() - t0:.1f}s", flush=True)
    del ref, recs
    _free(torch)
    if failed:
        raise SystemExit("17b: " + "; ".join(failed))
    return counts


def _stop(job) -> None:
    """Ends a background torchrun that is still running: SIGTERM, which it
    passes to its ranks, then SIGKILL."""
    if job.poll() is None:
        job.terminate()
        try:
            job.wait(timeout=30)
        except subprocess.TimeoutExpired:
            job.kill()
            job.wait()


def ep_layer(torch, jobs: _Jobs) -> None:
    """17c: one olmoe MoE layer at full width on the two ranks of job 17c
    (EP_LAYER_PROG) against its plain D-shard version on the card."""
    from repro_torch.core.context import use_context
    from repro_torch.core.plancache import PlanCache
    from repro_torch.layers import moe

    phase(f"17c one olmoe-1b-7b MoE layer (64 experts of 1024, top-8, f32 "
          f"tables, bf16 rows) on the {EP_MESH} mesh at 256 and 2 rows a "
          f"rank (the ranks ran beside the other jobs), against "
          f"layers.moe.moe_ep_plain "
          f"on the card (tol {EP_LAYER_TOL:.4g} of 1 + |y|)")
    t0 = time.perf_counter()
    jobs.result("17c", "17c", ())
    recs = _records(torch, "phase17", "ep_layer")
    gen = torch.Generator(device="cuda").manual_seed(0)
    p = moe.init_moe(gen, 2048, 1024, 64, device="cuda")
    xs = {n: torch.randn(shape, generator=gen, device="cuda").to(
        torch.bfloat16) for n, shape in (("prefill", (4, 128, 2048)),
                                         ("decode", (4, 1, 2048)))}
    failed = []
    with use_context(hw="h100", plan_cache=PlanCache()):
        for name, x in xs.items():
            want = moe.moe_ep_plain(p, x, 2, top_k=8)[0].float().cpu()
            for r, rec in enumerate(recs):
                got = rec[name]["y"]
                rows = want[r * got.shape[0]:(r + 1) * got.shape[0]]
                err = _logit_err(got, rows)
                print(f"{name} rank {r}: y {tuple(got.shape)} max |ep - "
                      f"plain| / (1 + |plain|) = {err:.4g}; collective "
                      f"bytes {rec[name]['bytes']}", flush=True)
                if not err <= EP_LAYER_TOL:
                    failed.append(f"{name} rank {r} {err}")
    del p, xs
    _free(torch)
    print(f"phase 17c {time.perf_counter() - t0:.1f}s", flush=True)
    if failed:
        raise SystemExit("17c: " + "; ".join(failed))


# ------------------------------------------------------------ phase 18
# int8 serving over the (1, 2) mesh of phases 15 and 16 (gloo, two ranks on
# the card), qwen1.5-4b at full width and TP_CUT layers: W8A8 tensor-
# parallel over 'model' (q, k, v, gate and in column-parallel with the
# fused epilogue; wo and w_out row-parallel: the int8 product with int32
# out, the partials summed over 'model', then out_scale, the bias and the
# cast; the unembed, a float weight under --quantize int8, column-parallel
# over the vocabulary) and the int8 KV pool over 'model' (20 kv heads: each
# rank quantizes its 10, their scales split with them). 18a: the static
# server with --quantize int8 (15a's run); 18b: phase 7b's engine
# (--quantize int8 --kv-quantize int8). Each against the same path on one
# device in this process: the first logits within PATH_TOL (the card
# against the card; INT8_PATH_TOL is the card against the CPU), the tokens
# equal up to each row's (request's) first near-tie, the ranks equal, zero
# lazy solves, launches 4c's (7b's) rule at the cut depth (7 fat GEMMs a
# layer and the unembed's, no GEMV), the collective bytes by kind the
# float step's dry-run cell's plus ``scale_max`` (2 x 4 bytes a layer: the
# activation absmax of wo's and w_out's row-parallel products over
# 'model'), 18b's int8 pool half the one device's
def int8_tp_serve(torch, jobs: _Jobs) -> dict[str, int]:
    """18a: the static server with int8 weights over the (1, 2) mesh."""
    return _tp_static(torch, jobs, "18a", ["--quantize", "int8"])


def int8_tp_engine(torch, jobs: _Jobs) -> dict[str, int]:
    """18b: the paged engine with int8 weights and the int8 pool over the
    (1, 2) mesh (job 18b), against the same engine on one device in this
    process."""
    import dataclasses as dc

    from repro_torch import configs as C

    args = _int8_engine_args()
    phase("18b the int8 engine over a mesh: torchrun --nproc-per-node 2 -m "
          "repro_torch.launch.serve " + " ".join(a if a else "''"
                                                 for a in args)
          + f" --mesh {TP_MESH} --backend gloo (full width, {TP_CUT} "
          "layers), against the same engine on one device in this process")
    t0 = time.perf_counter()
    ref, recs = _tp_engine_run(torch, jobs, "18b", args, "engine",
                               where="phase18")
    cut = dc.replace(C.get_config("qwen1.5-4b"), n_layers=TP_CUT)
    cells = _engine_cells(torch, cut, ref["engine"], False)
    step = {"matmul": 7 * TP_CUT + 1, "gemv": 0, "wkv": 0}

    def rule(dispatches):
        steps = sum(dispatches.values())
        return {k: n * steps for k, n in step.items()}

    failed = _tp_engine_gates(torch, f"int8, {TP_CUT} layers", ref, recs,
                              rule, cells, scale=2 * 4 * TP_CUT)
    err = _first_logits_err(ref, recs[0])
    print(f"first-token logits max |mesh - one| / (1 + |one|): {TP_CUT} "
          f"layers {err:.4g} (tol {PATH_TOL}); phase 18b "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    if not err <= PATH_TOL:
        failed.append(f"first-token logits at {TP_CUT} layers {err} > "
                      f"{PATH_TOL}")
    counts = recs[0]["launches"]
    del ref, recs
    _free(torch)
    if failed:
        raise SystemExit("18b: " + "; ".join(failed))
    return counts


# ------------------------------------------------------------ phase 20
# training the rwkv, hybrid, encoder-decoder, vision and MoE families on
# the card. 20a: the WKV backward kernel against its plain version (the
# autograd gradient of wkv_ref), tolerance 2e-4 of max(1, a gradient's
# peak): the forward's rtol = atol = 2e-4 at unit scale, carried to
# gradients whose peaks run to the thousands (du sums over b and t). A
# gradient the Function hands back in bf16 (dr, dk, dv of bf16 r, k, v)
# also carries its one rounding, 2^-8 of its magnitude.
WKV_BWD_TOL = 2e-4
WKV_BWD_CASES = (
    # name, B, H, T, N, decays that reach the min(mid - ci, 60) clamp
    ("train B8 T128 H40 N64", 8, 40, 128, 64, False),
    ("train B2 T256 H40 N64", 2, 40, 256, 64, False),
    ("clamp at 60 B2 T128 H40 N64", 2, 40, 128, 64, True),
)
RWKV_TRAIN_STEPS = 5       # 20b: rwkv6-3b whole; the last step traced
FAMILY_TRAIN_STEPS = 3     # 20d
# 20d's depth cuts (None: whole): olmoe's f32 AdamW state is ~16 bytes a
# parameter and its 16 layers hold ~6.9 G parameters, so 4; zamba2 whole
# (7 layers before its SSM scan ran in chunks); vision one group of 5 (4
# self layers and the cross layer)
FAMILY_TRAIN = {"20d olmoe": ("olmoe-1b-7b", 4),
                "20d zamba2": ("zamba2-1.2b", None),
                "20d whisper": ("whisper-base", None),
                "20d vision": ("llama-3.2-vision-11b", 5)}
REMAT_PEAK = ("whisper-base", "llama-3.2-vision-11b")
# whisper's unrotated key biases: the port's gradient is exactly 0 (the
# softmax takes their q . b_k away; a documented departure, ROADMAP
# section 3), and at
# their zero init the weight decay leaves them at 0
ZERO_GRAD_LEAVES = {"whisper-base": ("encoder/attn/bk", "decoder/cross/bk")}
# 20c: batch x seq (T > 32: the chunked WKV). At this random init a bf16
# step's gradients are mostly rounding (tools/rwkv_grad_spread.py, PERF.md
# section 6): token 0's WKV output is exactly 0 (u = 0, a zero state), so
# the per-head group norm multiplies its gradient by 1/sqrt(eps), and a
# 2^-18 jitter of the CPU's own GEMM outputs moves the worst leaf's bf16
# gradient by 0.31-0.96 (relative L2, four draws); only six leaves stay
# within 0.025. In f32 that jitter moves none by more than 3.9e-3. So
# every leaf's gradient is held to the CPU's with f32 activations (the
# same kernels, in their f32 instantiations) at 5x that;
# the bf16 step, the main path, by its loss, its launches and the leaves
# that the CPU's jitter moves by less than half of TRAIN_GRAD_TOL, at it
RWKV_CPU_CUT = (1, 128)
RWKV_F32_GRAD_TOL = 2e-2   # each leaf's gradient, f32 card against f32 CPU
RWKV_F32_LOSS_TOL = 1e-5   # the f32 loss (the jitter moves it by 1.7e-7)
RWKV_JITTER = 2.0**-18


def _phase20_path(name: str) -> str:
    return os.path.join(ROOT, "build", "phase20", name)


def _wkv_bwd_bound(B: int, H: int, T: int, N: int) -> tuple[float, str]:
    """Bytes: r, k, v (bf16), the log decay and dy (f32) read, the chunk
    start states (B H T/32 N N f32), u, the final state's gradient read;
    dr, dk, dv, dwl (f32), du and the initial state's gradient written,
    each once. Operations a chunk of C = 32: four full products (dy S^T, v
    dS'^T, kd dS', re^T dy: C N N each), five strictly causal ones (A, dA,
    A^T dy, dA ki, dA^T rm: C (C-1) / 2 x N each), 2 ops a multiply-add,
    and ~30 C N elementwise."""
    BH, C, nc, x = B * H, 32, T // 32, B * H * T * N
    moved = (2 * 3 * x + 4 * 2 * x + 4 * BH * nc * N * N + 2 * 4 * H * N
             + 2 * 4 * BH * N * N + 4 * 4 * x)
    ops = BH * nc * (2 * (4 * C * N * N + 5 * C * (C - 1) // 2 * N)
                     + 30 * C * N)
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, ops / PEAK_OPS["float32"]
    if t_bytes >= t_ops:
        return 1e3 * t_bytes, "bytes"
    return 1e3 * t_ops, "operations"


def _wkv_bwd_inputs(torch, gen, B, H, T, N, strong):
    """bf16 (B, T, H, N) views of (B, T, H * N) projections, as time_mix
    holds them, the f32 log decay (strong: e^-4 to e^-6 a step in the
    second half of every chunk), u, a nonzero initial state, dy and the
    final state's gradient."""
    rnd = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
    r, k, v = (rnd(B, T, H * N).bfloat16().view(B, T, H, N)
               for _ in range(3))
    uni = lambda lo, hi: lo + (hi - lo) * torch.rand(
        (B, T, H, N), generator=gen, device="cuda")
    wl = -torch.exp(uni(-6.0, 1.0))
    if strong:
        second = (torch.arange(T, device="cuda") % 32 >= 16)[None, :, None,
                                                             None]
        wl = torch.where(second, -torch.exp(uni(1.4, 1.8)), wl)
    return (r, k, v, wl, rnd(H, N) * 0.3, rnd(B, H, N, N) * 0.1,
            rnd(B, T, H, N), rnd(B, H, N, N))


def _bwd_err(got, want, extra: float = 0.0) -> tuple[float, bool]:
    """(worst |got - want| over max(1, peak), within WKV_BWD_TOL + extra)."""
    scale = max(1.0, want.abs().max().item())
    err = (got.float() - want).abs().max().item() / scale
    return err, err <= WKV_BWD_TOL + extra


def check_wkv_bwd(torch) -> dict:
    """20a: the WKV backward kernel (``wkv.wkv_bwd``, csrc/wkv.cu
    ``repro_wkv_bwd``) from the forward kernel's chunk-start states against
    ``wkv_bwd_ref`` on the card, timed; the forward's states against the
    plain recurrence's; then ``WkvFn`` end to end (``torch.autograd.grad``
    through ``wkv_heads``: one forward and one backward launch, and
    through ``wkv`` on its (BH, T, N) f32 layout) against the plain
    version."""
    from repro_torch.kernels import wkv
    from repro_torch.train import graphs

    phase(f"20a WKV backward kernel against its plain version (on the "
          f"card): tolerance {WKV_BWD_TOL} of max(1, a gradient's peak), "
          f"and + 2^-8 for a gradient handed back in bf16")
    gen = torch.Generator(device="cuda").manual_seed(20)
    names = ("dr", "dk", "dv", "dwl", "du", "dstate")
    record = None
    for name, B, H, T, N, strong in WKV_BWD_CASES:
        r, k, v, wl, u, s0, dy, ds = _wkv_bwd_inputs(torch, gen, B, H, T,
                                                     N, strong)
        BH = B * H
        to_bh = lambda x: x.float().transpose(1, 2).reshape(BH, T, N)
        u_rows = u[None].expand(B, H, N).reshape(BH, N)
        cl = torch.cumsum(wl.double().reshape(B, T // 32, 32, H, N), 2)
        clamp = bool(((cl - wl.double().reshape(cl.shape))[:, :, 16:17]
                      - cl > 60).any())
        if clamp != strong:
            raise SystemExit(f"20a {name}: the clamp at 60 acts: {clamp}")
        with torch.no_grad():
            y, s_out, states = wkv._forward(r, k, v, wl, u, s0, True, None,
                                            True)
        kern = lambda: wkv.wkv_bwd(r, k, v, wl, u, states, dy, ds)
        got = kern()
        torch.cuda.synchronize()
        plain = lambda: wkv.wkv_bwd_ref(
            to_bh(r), to_bh(k), to_bh(v), to_bh(wl), u_rows,
            s0.reshape(BH, N, N), to_bh(dy), ds.reshape(BH, N, N))
        want = plain()
        back = lambda x: x.reshape(B, H, T, N).transpose(1, 2)
        want = [back(w) for w in want[:4]] + [
            want[4].reshape(B, H, N).sum(0), want[5].reshape(B, H, N, N)]
        # the forward's saved states against the plain recurrence's
        S, worst_s = s0.reshape(BH, N, N), 0.0
        for c in range(T // 32):
            worst_s = max(worst_s, (states.reshape(BH, T // 32, N, N)[:, c]
                                    - S).abs().max().item())
            sl = slice(32 * c, 32 * c + 32)
            _, S = wkv.wkv_ref(to_bh(r)[:, sl], to_bh(k)[:, sl],
                               to_bh(v)[:, sl], to_bh(wl)[:, sl], u_rows, S)
        errs = [_bwd_err(g, w) for g, w in zip(got, want)]
        ok = all(e[1] for e in errs) and worst_s <= 2e-4 * max(
            1.0, s0.abs().max().item())
        rec = {"case": name, "kernel": "wkv_bwd", "shape": [B, H, T, N],
               "max_abs_err": max(e[0] for e in errs), "tol": WKV_BWD_TOL,
               "ms": time_ms(torch, kern), "plain_ms": time_ms(torch, plain),
               "library_ms": None}  # no PyTorch call computes WKV's gradient
        rec["bound_ms"], rec["bound_by"] = _wkv_bwd_bound(B, H, T, N)
        print(f"wkv_bwd {name:28s} blocks={BH} err (of max(1, peak)) "
              + " ".join(f"{n}={e[0]:.3g}" for n, e in zip(names, errs))
              + f" saved states {worst_s:.3g} tol={WKV_BWD_TOL} "
              f"ms={rec['ms']:.4f} plain_ms={rec['plain_ms']:.4f} "
              f"library_ms=null bound_ms={rec['bound_ms']:.4f} "
              f"({rec['bound_by']})", flush=True)
        if not ok:
            raise SystemExit(f"20a {name}: the backward kernel disagrees "
                             "with its plain version")
        if record is None:
            record = rec
        # the Function end to end, a fresh leaf of every input
        xs = [t.detach().clone().requires_grad_() for t in
              (r, k, v, wl, u, s0)]
        launched = (wkv.launches, wkv.bwd_launches)
        y2, s2 = wkv.wkv_heads(*xs)
        fn_got = torch.autograd.grad((y2, s2), xs, (dy, ds))
        torch.cuda.synchronize()
        if (wkv.launches - launched[0], wkv.bwd_launches - launched[1]) != \
                (1, 1) or y2.grad_fn is None:
            raise SystemExit(f"20a {name}: wkv_heads under autograd did not "
                             "launch one forward and one backward")
        fn_errs = [_bwd_err(g, w, 2.0 ** -8 if g.dtype == torch.bfloat16
                            else 0.0) for g, w in zip(fn_got, want)]
        same = torch.equal(y2.detach(), y) and torch.equal(s2.detach(),
                                                           s_out)
        print(f"        WkvFn through wkv_heads: y and state equal to the "
              f"no-grad launch's {same}; err "
              + " ".join(f"{n}={e[0]:.3g}" for n, e in zip(names, fn_errs)),
              flush=True)
        if not (same and all(e[1] for e in fn_errs)):
            raise SystemExit(f"20a {name}: WkvFn disagrees with the plain "
                             "version")
        del xs, fn_got, got, want, states
    # wkv's own (BH, T, N) f32 layout under autograd: the same Function
    BH, T, N = 16, 64, 64
    rnd = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
    args = (rnd(BH, T, N), rnd(BH, T, N), rnd(BH, T, N),
            -torch.exp(-6 + 7 * torch.rand((BH, T, N), generator=gen,
                                           device="cuda")),
            rnd(BH, N) * 0.3, rnd(BH, N, N) * 0.1)
    dy, ds = rnd(BH, T, N), rnd(BH, N, N)
    xs = [t.clone().requires_grad_() for t in args]
    y, s = wkv.wkv(*xs)
    errs = [_bwd_err(g, w) for g, w in zip(
        torch.autograd.grad((y, s), xs, (dy, ds)),
        wkv.wkv_bwd_ref(*args, dy, ds))]
    print(f"        WkvFn through wkv on (BH, T, N) = ({BH}, {T}, {N}) f32: "
          "err " + " ".join(f"{n}={e[0]:.3g}" for n, e in zip(names, errs)),
          flush=True)
    if not all(e[1] for e in errs):
        raise SystemExit("20a: WkvFn through wkv disagrees with the plain "
                         "version")
    graphs.reset_launches()  # the comparisons' launches count for no path
    return record


def _rwkv_train_rule(cfg, batch: int, seq: int,
                     remat: bool) -> dict[str, int]:
    """Kernel launches of one rwkv training step: M microbatches of batch
    / M rows x seq; a layer's 11 dense products (time-mix: lora_a, r, k,
    v, g, w_lora_a, w_lora_b, wo; channel-mix: wk with relu, wv, wr) and
    the unembed a loss chunk, each in the forward, the remat recompute (a
    loss chunk always) and the backward (dA, dB, the relu's recomputed
    pre-activation), on the GEMV where decode-shaped with no epilogue
    (core.gemm._is_skinny: w_lora_b's dB at full width), else the fat
    GEMM; the WKV forward a layer a pass, its backward a layer
    (tests/test_torch_train_families.py holds the GEMM part on the CPU)."""
    from repro_torch.core.gemm import _is_skinny
    from repro_torch.layers.rwkv import LORA_R as lr
    from repro_torch.train.trainstep import microbatch_count

    M = microbatch_count(cfg, batch)
    rows, d, f, V = batch // M * seq, cfg.d_model, cfg.d_ff, cfg.padded_vocab
    c = min(cfg.loss_chunk, seq)
    chunks = seq // c if seq % c == 0 else 1
    fwd = [(d, 5 * lr, False), (d, d, False), (d, d, False), (d, d, False),
           (d, d, False), (d, lr, False), (lr, d, False), (d, d, False),
           (d, f, True), (f, d, False), (d, d, False)]
    out = {"matmul": 0, "gemv": 0}

    def add(m, k, n, epi, times):
        out["gemv" if _is_skinny(m, k, n) and not epi else "matmul"] += times

    L, passes = cfg.n_layers, 2 if remat else 1
    for k, n, epi in fwd:
        add(rows, k, n, epi, L * passes)
        add(rows, n, k, False, L)
        add(k, rows, n, False, L)
        if epi:  # the pre-activation, recomputed on the fat GEMM
            out["matmul"] += L
    add(rows // chunks, d, V, False, 2 * chunks)
    add(rows // chunks, V, d, False, chunks)
    add(d, rows // chunks, V, False, chunks)
    return {"matmul": M * out["matmul"], "gemv": M * out["gemv"],
            "wkv": M * L * passes, "wkv_bwd": M * L}


def _train_family(torch, label: str, arch: str, n_layers, steps: int,
                  wkv_share: bool = False, remat: bool = True,
                  batch: int = 8, seq: int = 128) -> dict:
    """``python -m repro_torch.launch.train --arch ARCH [--n-layers N]
    --steps STEPS --batch BATCH --seq SEQ --ckpt-every 0`` in this process,
    the launcher's step instrumented (ft.elastic.make_train_step wrapped):
    CUDA-event ms, launches, the GEMM dispatches and lazy solves of each
    step, the last step's gradient norm of every leaf (vision's cross
    layer has none at step 1: the init zeroes its tanh gates), the last
    state; with
    ``wkv_share`` the last step traced. Then every leaf is held to its
    seed-0 init: it moved. Returns the record (launches a step, peak,
    the gates' findings)."""
    import math

    from repro_torch import configs as C
    from repro_torch import models
    from repro_torch.core import gemm as cg
    from repro_torch.core.context import current_context
    from repro_torch.ft import elastic
    from repro_torch.interop import tree_items
    from repro_torch.launch import train
    from repro_torch.train import graphs

    calls = {"matmul": 0, "gemv": 0}
    rec = {"steps": [], "state": None, "norms": {}, "rows": None}
    real_make, real_ops = elastic.make_train_step, (
        cg.ops.balanced_matmul, cg.ops.decode_matvec)

    def count(fn, key):
        def counted(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return counted

    def probe(grads):  # every step's: the last one's stays
        items = list(tree_items(grads))
        vals = torch.stack([torch.linalg.vector_norm(
            g, dtype=torch.float32) for _, g in items]).tolist()
        rec["norms"].update(zip((p for p, _ in items), vals))

    def make(*a, **kw):
        art = real_make(*a, grads_hook=probe, **kw)

        def step(state, batch):
            cache = current_context().plan_cache
            solves, before, disp = (cache.stats.lazy_solves,
                                    graphs.train_launches(), dict(calls))
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            if wkv_share and len(rec["steps"]) == steps - 1:
                out = []
                rec["rows"], _, _ = _traced(
                    torch, lambda: out.append(art.step_fn(state, batch)),
                    cpu=False)
                new = out[0]
            else:
                new = art.step_fn(state, batch)
            ev[1].record()
            ev[1].synchronize()
            now = graphs.train_launches()
            rec["steps"].append({
                "ms": ev[0].elapsed_time(ev[1]),
                "launches": {k: now[k] - before[k] for k in now},
                "dispatched": {k: calls[k] - disp[k] for k in calls},
                "lazy": cache.stats.lazy_solves - solves})
            rec["state"] = new[0]
            return new

        return dataclasses.replace(art, step_fn=step)

    cfg = C.get_config(arch)
    if not remat:
        real_get = C.get_config
        C.get_config = lambda name: dataclasses.replace(real_get(name),
                                                        remat=False)
    args = ["--arch", arch, "--steps", str(steps), "--batch", str(batch),
            "--seq", str(seq), "--ckpt-every", "0", "--plan-cache", "",
            "--log-every", "1"] + ([] if n_layers is None else
                                   ["--n-layers", str(n_layers)])
    elastic.make_train_step = make
    cg.ops.balanced_matmul = count(real_ops[0], "matmul")
    cg.ops.decode_matvec = count(real_ops[1], "gemv")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        out = train.main(args)
    finally:
        elastic.make_train_step = real_make
        cg.ops.balanced_matmul, cg.ops.decode_matvec = real_ops
        if not remat:
            C.get_config = real_get
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    params = rec.pop("state")["params"]
    zero = ZERO_GRAD_LEAVES.get(arch, ())
    still = []
    with torch.no_grad():
        init = models.init(cfg, seed=0, device="cuda")
        for (path, t), (_, t0_) in zip(tree_items(params), tree_items(init)):
            if torch.equal(t, t0_) != path.endswith(zero):
                still.append(path)
    del params, init
    _free(torch)
    rec.update(peak=peak, wall=wall, losses=out["losses"],
               grad_norms=out["grad_norms"], unmoved=still, zero=zero,
               finite=all(math.isfinite(x) for x in out["losses"]
                          + out["grad_norms"]))
    bad = [p for p, n in rec["norms"].items() if not math.isfinite(n)
           or (n > 0) == p.endswith(zero)]
    rec["bad_norms"] = bad
    return rec


def _train_gates(label: str, rec: dict, rule=None) -> list[str]:
    """The gates of 20b / 20d: finite losses and gradient norms, every leaf
    moved (whisper's zero-gradient key biases: not moved, gradient 0),
    every leaf's last-step gradient finite and nonzero (a run of more than
    one step), zero lazy solves after step 1, the launches a step:
    ``rule`` (20b), else one kernel launch a planned GEMM dispatch and no
    WKV."""
    failed = []
    if len(rec["steps"]) == 1:
        rec = dict(rec, bad_norms=[])
    if not rec["finite"]:
        failed.append(f"a loss or gradient norm is not finite: "
                      f"{rec['losses']} {rec['grad_norms']}")
    if rec["unmoved"]:
        failed.append(f"leaves that did not move as they should: "
                      f"{rec['unmoved']}")
    if rec["bad_norms"]:
        failed.append(f"last-step gradients not finite and nonzero (or, for "
                      f"{rec['zero']}, not zero): {rec['bad_norms']}")
    if any(s["lazy"] for s in rec["steps"][1:]):
        failed.append(f"lazy solves after step 1: "
                      f"{[s['lazy'] for s in rec['steps']]}")
    for s in rec["steps"]:
        want = rule or {"matmul": s["dispatched"]["matmul"],
                        "gemv": s["dispatched"]["gemv"], "wkv": 0,
                        "wkv_bwd": 0}
        if s["launches"] != want:
            failed.append(f"launches {s['launches']} differ from the rule "
                          f"{want}")
            break
    return [f"{label}: {f}" for f in failed]


def train_rwkv(torch, smi: str) -> dict[str, int]:
    """20b: rwkv6-3b at full width and depth through the launcher, 5 AdamW
    steps at 8 x 128 with remat (the config's): the gates, step ms, the
    WKV backward's share of a traced step's device time, the peak."""
    from repro_torch import configs as C
    from repro_torch.train.trainstep import microbatch_count

    arch = "rwkv6-3b"
    cfg = C.get_config(arch)
    rule = _rwkv_train_rule(cfg, 8, 128, cfg.remat)
    phase(f"20b training rwkv6-3b at full width and depth (32 layers, "
          f"remat on, AdamW, {microbatch_count(cfg, 8)} microbatches): "
          f"python -m repro_torch.launch.train --arch {arch} --steps "
          f"{RWKV_TRAIN_STEPS} --batch 8 --seq 128 --ckpt-every 0; launch "
          f"rule a step {rule}")
    rec = _train_family(torch, "20b", arch, None, RWKV_TRAIN_STEPS,
                        wkv_share=True)
    ms = [s["ms"] for s in rec["steps"]]
    busy_ms, _ = _busy(rec["rows"], 1.0)
    bwd_ms = sum(r[0] for r in rec["rows"] if "wkv_bwd_kernel" in r[2]) / 1e3
    fwd_ms = sum(r[0] for r in rec["rows"]
                 if "wkv_kernel" in r[2] and "bwd" not in r[2]) / 1e3
    print(f"losses {[round(x, 4) for x in rec['losses']]} grad norms "
          f"{[round(x, 4) for x in rec['grad_norms']]}; step ms "
          f"{[round(x, 1) for x in ms]} (median of steps 2-"
          f"{RWKV_TRAIN_STEPS - 1}: {statistics.median(ms[1:-1]):.1f}; the "
          f"last traced); traced step: kernels busy {busy_ms:.1f} ms, the "
          f"WKV backward {bwd_ms:.2f} ms ({bwd_ms / busy_ms:.4f} of it), "
          f"the WKV forward {fwd_ms:.2f} ms; peak {rec['peak']:.2f} GiB; "
          f"launches a step {rec['steps'][1]['launches']}; card {smi}",
          flush=True)
    failed = _train_gates("20b", rec, rule)
    if failed:
        raise SystemExit("; ".join(failed))
    return {k: sum(s["launches"][k] for s in rec["steps"])
            for k in rec["steps"][0]["launches"]}


def train_families(torch, smi: str) -> dict[str, dict[str, int]]:
    """20d: olmoe, zamba2, whisper and vision through the launcher at full
    width, FAMILY_TRAIN's depths, 3 AdamW steps with remat on; whisper and
    vision again for one step with remat off (the peak it buys)."""
    counts = {}
    for label, (arch, layers) in FAMILY_TRAIN.items():
        phase(f"{label} training {arch} at full width, "
              f"{'whole' if layers is None else f'{layers} layers'}, remat "
              f"on: python -m repro_torch.launch.train --arch {arch}"
              f"{'' if layers is None else f' --n-layers {layers}'} --steps "
              f"{FAMILY_TRAIN_STEPS} --batch 8 --seq 128 --ckpt-every 0")
        rec = _train_family(torch, label, arch, layers, FAMILY_TRAIN_STEPS)
        ms = [s["ms"] for s in rec["steps"]]
        line = (f"losses {[round(x, 4) for x in rec['losses']]} grad norms "
                f"{[round(x, 4) for x in rec['grad_norms']]}; step ms "
                f"{[round(x, 1) for x in ms]} (median of steps 2-"
                f"{FAMILY_TRAIN_STEPS}: {statistics.median(ms[1:]):.1f}); "
                f"peak {rec['peak']:.2f} GiB")
        failed = _train_gates(label, rec)
        if arch in REMAT_PEAK:
            off = _train_family(torch, label, arch, layers, 1, remat=False)
            line += (f"; remat off, 1 step: peak {off['peak']:.2f} GiB, "
                     f"step {off['steps'][0]['ms']:.1f} ms")
            failed += _train_gates(label + " (remat off)", off)
        print(f"{line}; launches a step {rec['steps'][-1]['launches']}; "
              f"card {smi}", flush=True)
        if failed:
            raise SystemExit("; ".join(failed))
        counts[f"{arch} train ({label})"] = {
            k: sum(s["launches"][k] for s in rec["steps"])
            for k in rec["steps"][0]["launches"]}
    return counts


def rwkv_vs_cpu_start() -> subprocess.Popen:
    """20c in a process of its own (:func:`rwkv_vs_cpu`): its CPU passes
    from phase 14 on, its card pass after 20b (:func:`rwkv_vs_cpu_card`),
    its result after 20d."""
    os.makedirs(_phase20_path(""), exist_ok=True)
    for name in ("go", "card_done"):
        if os.path.exists(_phase20_path(name)):
            os.remove(_phase20_path(name))
    code = (f"import sys; sys.path[:0] = {[ROOT, os.path.join(ROOT, 'src')]!r}"
            "; import torch, chip_smoke; chip_smoke.rwkv_vs_cpu(torch)")
    with open(_phase20_path("20c.log"), "w") as log:
        return subprocess.Popen([sys.executable, "-c", code], stdout=log,
                                stderr=subprocess.STDOUT, text=True, cwd=ROOT)


def rwkv_vs_cpu_card(job: subprocess.Popen) -> None:
    """Lets 20c's card pass run now and waits until it has left the card."""
    phase(f"20c rwkv6-3b's training step, card against CPU: 2 layers, full "
          f"width, batch x seq {RWKV_CPU_CUT} (the chunked WKV, forward and "
          f"backward kernels), f32 and bf16 activations; tolerances: f32 the "
          f"loss {RWKV_F32_LOSS_TOL} and each leaf's gradient "
          f"{RWKV_F32_GRAD_TOL} (relative L2); bf16 the loss "
          f"{TRAIN_LOSS_TOL}, and {TRAIN_GRAD_TOL} for each leaf that a "
          f"{RWKV_JITTER:.3g} jitter of the CPU's GEMMs moves by less than "
          f"half that; in a process of its own, its card passes now, its "
          "output after 20d")
    open(_phase20_path("go"), "w").close()
    t0 = time.perf_counter()
    while not os.path.exists(_phase20_path("card_done")) and job.poll() is None:
        time.sleep(0.2)
    print(f"(20c's card pass done; waited {time.perf_counter() - t0:.1f}s)",
          flush=True)


def rwkv_vs_cpu_end(job: subprocess.Popen) -> None:
    try:
        job.wait(timeout=600)
    finally:
        _stop(job)
    phase("20c's result")
    with open(_phase20_path("20c.log")) as f:
        print(f.read().rstrip(), flush=True)
    if job.returncode != 0:
        raise SystemExit(f"20c: its process exited {job.returncode}")


def _first_step(torch, cfg, params0, batch: int, seq: int, device) -> dict:
    """One make_train_step step on ``device`` from ``params0`` (CPU
    tensors) and fresh AdamW state, on data.synthetic (seed 0): the loss,
    the launches and every leaf's gradient (on the CPU)."""
    from repro_torch import interop
    from repro_torch.data.synthetic import batch_for
    from repro_torch.train import graphs
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train.trainstep import (default_opt_config,
                                             make_train_step)

    grads = {}

    def probe(tree):
        grads.update((p, g.detach().to("cpu", copy=True))
                     for p, g in interop.tree_items(tree))

    art = make_train_step(cfg, global_batch=batch, seq_len=seq,
                          device=device, grads_hook=probe)
    params = interop.tree_map(lambda t: t.to(device, copy=True), params0)
    state = {"params": params,
             "opt": opt_lib.make_optimizer(default_opt_config(cfg)).init(
                 params),
             "step": torch.zeros((), dtype=torch.int32, device=device)}
    before = graphs.train_launches()
    _, m = art.step_fn(state, batch_for(cfg, seq, batch, 0))
    now = graphs.train_launches()
    return {"loss": float(m["loss"]), "grads": grads,
            "launches": {k: now[k] - before[k] for k in now}}


@contextlib.contextmanager
def _jittered_gemms(torch, scale: float, dtype, seed: int = 0):
    """Within it, the CPU's GEMM and GEMV plain versions perturb each
    ``dtype`` output by ``scale`` of itself (normal, from ``seed``) in f32,
    before rounding it: another summation order's f32 error, as the card's
    kernels have."""
    from repro_torch.kernels import decode_matvec as tmv
    from repro_torch.kernels import matmul as tmm

    gen = torch.Generator().manual_seed(seed)
    real = (tmm.matmul, tmv.decode_matvec)

    def wrap(fn):
        def jittered(a, *x, out_dtype=None, **y):
            if (out_dtype or a.dtype) != dtype:
                return fn(a, *x, out_dtype=out_dtype, **y)
            c = fn(a, *x, out_dtype=torch.float32, **y)
            noise = torch.randn(c.shape, generator=gen)
            return (c * (1 + scale * noise)).to(dtype)
        return jittered

    tmm.matmul, tmv.decode_matvec = wrap(real[0]), wrap(real[1])
    try:
        yield
    finally:
        tmm.matmul, tmv.decode_matvec = real


def rwkv_vs_cpu(torch) -> None:
    """20c: rwkv6-3b's first training step at 2 layers and full width, from
    one seed's weights, on the CPU and on the card, each with f32 and with
    bf16 activations, and on the CPU in bf16 with its GEMM outputs
    jittered (:func:`_jittered_gemms`). Held (see RWKV_CPU_CUT): the f32
    card step's loss and every leaf's gradient to the f32 CPU step's; the
    bf16 card step's loss, and the gradients of the leaves that the
    jitter leaves within half of TRAIN_GRAD_TOL, to the bf16 CPU step's;
    both card steps' launches to the rule. The other bf16 leaves are
    printed beside the CPU's own jitter spread."""
    from repro_torch import configs as C
    from repro_torch import models
    from repro_torch.core.context import use_context
    from repro_torch.core.plancache import PlanCache

    torch.set_num_threads(TRAIN_CPU_THREADS)
    torch.backends.cuda.matmul.allow_tf32 = False
    bf16 = dataclasses.replace(C.get_config("rwkv6-3b"), n_layers=2)
    f32 = dataclasses.replace(bf16, activation_dtype="float32")
    params0 = models.init(bf16, seed=1, device="cpu")
    batch, seq = RWKV_CPU_CUT
    rel = lambda x, y: ((x - y).norm() / y.norm().clamp_min(1e-30)).item()
    res = {}
    for key, cfg, dev in (("cpu f32", f32, "cpu"), ("cpu bf16", bf16, "cpu"),
                          ("cpu bf16, GEMMs jittered", bf16, "cpu"),
                          ("card f32", f32, "cuda"),
                          ("card bf16", bf16, "cuda")):
        if dev == "cuda":
            while not os.path.exists(_phase20_path("go")):
                time.sleep(0.2)
        with use_context(hw="h100", plan_cache=PlanCache()), (
                _jittered_gemms(torch, RWKV_JITTER, torch.bfloat16)
                if "jitter" in key else contextlib.nullcontext()):
            t0 = time.perf_counter()
            res[key] = _first_step(torch, cfg, params0, batch, seq, dev)
        print(f"  {key}: loss {res[key]['loss']:.6f} "
              f"({time.perf_counter() - t0:.1f}s)", flush=True)
        _free(torch)
    open(_phase20_path("card_done"), "w").close()
    want = _rwkv_train_rule(bf16, batch, seq, bf16.remat)
    loss_err = lambda a, b: abs(res[a]["loss"] - res[b]["loss"]) / abs(
        res[b]["loss"])
    grad_err = lambda a, b: {k: rel(res[a]["grads"][k], res[b]["grads"][k])
                             for k in res[b]["grads"]}
    f32_err = grad_err("card f32", "cpu f32")
    bf16_err = grad_err("card bf16", "cpu bf16")
    jitter = grad_err("cpu bf16, GEMMs jittered", "cpu bf16")
    held = sorted(k for k, e in jitter.items() if e < TRAIN_GRAD_TOL / 2)
    worst = lambda errs, keys: max((errs[k], k) for k in keys)
    f32_worst = worst(f32_err, f32_err)
    held_worst = worst(bf16_err, held) if held else (0.0, "none")
    free = sorted((k for k in bf16_err if k not in held),
                  key=lambda k: -bf16_err[k])
    print(f"  f32, card against the CPU: loss "
          f"{loss_err('card f32', 'cpu f32'):.3g} (tolerance "
          f"{RWKV_F32_LOSS_TOL}); every leaf's gradient within "
          f"{f32_worst[0]:.4g} ({f32_worst[1]}; tolerance "
          f"{RWKV_F32_GRAD_TOL}); launches {res['card f32']['launches']}",
          flush=True)
    print(f"  bf16, card against the CPU: loss "
          f"{loss_err('card bf16', 'cpu bf16'):.3g} (tolerance "
          f"{TRAIN_LOSS_TOL}); the {len(held)} leaves the CPU's 2^-18 GEMM "
          f"jitter moves by less than {TRAIN_GRAD_TOL / 2} ("
          + ", ".join(f"{k} {jitter[k]:.3g}" for k in held)
          + f") within {held_worst[0]:.4g} ({held_worst[1]}; tolerance "
          f"{TRAIN_GRAD_TOL}); the others, card against CPU (the CPU's "
          "jitter): " + ", ".join(f"{k} {bf16_err[k]:.3g} ({jitter[k]:.3g})"
                                  for k in free)
          + "; the bf16 CPU step against the f32 one: the worst "
          + ", ".join(f"{k} {e:.3g}" for e, k in sorted(
              ((e, k) for k, e in grad_err("cpu bf16", "cpu f32").items()),
              reverse=True)[:4])
          + f"; launches {res['card bf16']['launches']} (rule {want})",
          flush=True)
    failed = []
    if not loss_err("card f32", "cpu f32") <= RWKV_F32_LOSS_TOL:
        failed.append("the f32 card step's loss is beyond the CPU's "
                      "tolerance")
    if not f32_worst[0] <= RWKV_F32_GRAD_TOL:
        failed.append("an f32 gradient is beyond the CPU's tolerance")
    if not loss_err("card bf16", "cpu bf16") <= TRAIN_LOSS_TOL:
        failed.append("the bf16 card step's loss is beyond the CPU's "
                      "tolerance")
    if not held or not held_worst[0] <= TRAIN_GRAD_TOL:
        failed.append("a bf16 gradient that the jitter leaves steady is "
                      "beyond the CPU's tolerance")
    for key in ("card f32", "card bf16"):
        if res[key]["launches"] != want:
            failed.append(f"the {key} step's launches differ from the rule")
    if failed:
        raise SystemExit("20c: " + "; ".join(failed))


# 10a: zamba2's eager prefill (4 x 128, 38 layers) on an H100 when the SSM
# scan looped over the tokens (PERF.md section 5)
ZAMBA_PREFILL_LOOP_MS = 1077.45


# ------------------------------------------------------------ phase 22
# training what was left. 22a: zamba2-1.2b whole at train_4k's sequence;
# its SSM scan runs in groups of 16 chunks of 64 tokens (layers/mamba.py)
ZAMBA_TRAIN = ("zamba2-1.2b", 1, 4096, 2)   # arch, batch, seq, steps
# 22b: remat_policy="dots" against "full" at 13b's shape, step 1 under
# deterministic algorithms: the loss and each leaf's gradient within
# DOTS_TOL of the leaf's peak (the same products, kept rather than
# recomputed: 0 expected)
DOTS_TOL = 1e-6
DOTS_STEPS = 3


def _mamba_saved(torch, cfg, seq: int) -> tuple[str, list[str]]:
    """One Mamba layer of ``cfg`` at its full width on the card, under grad
    at 1 x ``seq`` (seed-0 weights and input): what autograd keeps for its
    backward (``saved_tensors_hooks``, each storage once, the weights
    aside), and how many of those are SSM states (1, H, P, N) f32: one a
    group of chunks (layers/mamba.py), where the reference keeps one a
    chunk and a loop over the tokens one or more a token."""
    from repro_torch.core.context import use_context
    from repro_torch.core.plancache import PlanCache
    from repro_torch.layers import mamba as mb

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    kw = dict(expand=cfg.ssm_expand, head_dim=cfg.ssm_head_dim)
    p = mb.init_mamba(gen, cfg.d_model, cfg.ssm_state, device="cuda", **kw)
    p = mb.MambaParams(*(t.requires_grad_() for t in p))
    weights = {t.untyped_storage().data_ptr() for t in p}
    x = torch.randn((1, seq, cfg.d_model), generator=gen, device="cuda",
                    dtype=cfg.dtype).requires_grad_()
    _, H = mb.dims(cfg.d_model, cfg.ssm_state, **kw)
    state = (1, H, cfg.ssm_head_dim, cfg.ssm_state)
    kept, states = {}, [0]

    def pack(t):
        ptr = t.untyped_storage().data_ptr()
        if ptr not in weights:
            kept[ptr] = t.untyped_storage().nbytes()
        states[0] += tuple(t.shape) == state
        return t

    with use_context(hw="h100", plan_cache=PlanCache()), \
            torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        y, _ = mb.mamba_block(p, x, d_state=cfg.ssm_state, **kw)
    y.float().square().mean().backward()
    torch.cuda.synchronize()
    mib = lambda b: b / 2**20
    one = 4 * math.prod(state)
    groups = -(-seq // (mb.CHUNK * mb.GROUP))
    chunks = -(-seq // mb.CHUNK)
    line = (f"one Mamba layer under grad at 1 x {seq}: the backward keeps "
            f"{len(kept)} storages, {mib(sum(kept.values())):.1f} MiB (the "
            f"weights aside), of them {states[0]} SSM states {state} f32 "
            f"({mib(states[0] * one):.1f} MiB): one a group of {mb.GROUP} "
            f"chunks ({groups}); the reference keeps one a chunk ({chunks}, "
            f"{mib(chunks * one):.1f} MiB), a loop over the tokens one or "
            f"more a token (>= {seq}, >= {mib(seq * one):.0f} MiB)")
    failed = [] if states[0] == groups else [
        f"the backward keeps {states[0]} SSM states, not {groups}"]
    del p, x, y
    _free(torch)
    return line, failed


def train_zamba_4k(torch, smi: str) -> dict[str, int]:
    """22a: zamba2-1.2b at its full width and depth through the launcher,
    remat on, AdamW, 1 x 4096, 2 steps: 20d's gates; step ms, the peak and
    one Mamba layer's saved bytes (:func:`_mamba_saved`)."""
    from repro_torch import configs as C

    arch, batch, seq, steps = ZAMBA_TRAIN
    cfg = C.get_config(arch)
    phase(f"22a training {arch} at full width and depth ({cfg.n_layers} "
          f"Mamba-2 layers, the shared block every {cfg.shared_attn_every}"
          f"), remat on, AdamW, {batch} x {seq}: python -m "
          f"repro_torch.launch.train --arch {arch} --steps {steps} --batch "
          f"{batch} --seq {seq} --ckpt-every 0")
    saved, failed = _mamba_saved(torch, cfg, seq)
    print(saved, flush=True)
    rec = _train_family(torch, "22a", arch, None, steps, batch=batch,
                        seq=seq)
    ms = [s["ms"] for s in rec["steps"]]
    print(f"losses {[round(x, 4) for x in rec['losses']]} grad norms "
          f"{[round(x, 4) for x in rec['grad_norms']]}; step ms "
          f"{[round(x, 1) for x in ms]}; peak {rec['peak']:.2f} GiB; "
          f"launches a step {rec['steps'][-1]['launches']}; card {smi}",
          flush=True)
    failed += _train_gates("22a", rec)
    if failed:
        raise SystemExit("22a: " + "; ".join(failed))
    return {k: sum(s["launches"][k] for s in rec["steps"])
            for k in rec["steps"][0]["launches"]}


def _policy_run(torch, cfg, capture) -> dict:
    """make_train_step(cfg) at 13b's batch from the seed-0 init on
    data.synthetic (seed 0), DOTS_STEPS AdamW steps: step 1 under
    deterministic algorithms, its gradients handed to ``capture(items)``
    between the backward and the optimizer; each step's loss, CUDA-event
    ms and launches, and the peak of the steps after the first (whose
    capture copies leaves to and from the host)."""
    from repro_torch.core.context import use_context
    from repro_torch.core.plancache import PlanCache
    from repro_torch.data.synthetic import DataConfig, SyntheticLM
    from repro_torch.interop import tree_items
    from repro_torch.train import graphs
    from repro_torch.train.trainstep import make_train_step

    got = []

    def probe(grads):
        if not got:
            got.append(capture(list(tree_items(grads))))

    rec = {"losses": [], "ms": [], "launches": []}
    torch.cuda.reset_peak_memory_stats()
    try:
        with use_context(hw="h100", plan_cache=PlanCache()):
            art = make_train_step(cfg, global_batch=TRAIN_BATCH,
                                  seq_len=TRAIN_SEQ, device="cuda",
                                  grads_hook=probe)
            state = art.init_fn(0)
            data = SyntheticLM(DataConfig(
                vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                global_batch=TRAIN_BATCH, seed=0))
            for step in range(DOTS_STEPS):
                torch.use_deterministic_algorithms(step == 0, warn_only=True)
                before = graphs.launches()
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                state, m = art.step_fn(state, data.batch(step))
                ev[1].record()
                ev[1].synchronize()
                now = graphs.launches()
                rec["launches"].append({k: now[k] - before[k] for k in now})
                rec["ms"].append(ev[0].elapsed_time(ev[1]))
                rec["losses"].append(float(m["loss"]))
                if step == 0:
                    torch.cuda.reset_peak_memory_stats()
    finally:
        torch.use_deterministic_algorithms(False)
    rec.update(peak=torch.cuda.max_memory_allocated() / 2**30,
               captured=got[0])
    del state, art, m
    _free(torch)
    return rec


def remat_dots(torch, smi: str) -> dict[str, int]:
    """22b: qwen1.5-4b at 13b's shape with remat_policy "full" and "dots":
    step 1's loss and every leaf's gradient equal (DOTS_TOL; a second
    "full" run's spread where they differ), each policy's launches a step
    its rule, both policies' step ms and peaks."""
    from repro_torch import configs as C

    full = C.get_config(TRAIN_ARCH)
    dots = dataclasses.replace(full, remat_policy="dots")
    want = {"full": _train_rule(full, TRAIN_BATCH, TRAIN_SEQ),
            "dots": _train_rule(dataclasses.replace(full, remat=False),
                                TRAIN_BATCH, TRAIN_SEQ)}
    phase(f"22b remat_policy=\"dots\" against \"full\": {TRAIN_ARCH} at "
          f"full width and depth, AdamW, batch {TRAIN_BATCH} x {TRAIN_SEQ} "
          f"from data.synthetic (seed 0), {DOTS_STEPS} steps each, step 1 "
          f"under deterministic algorithms; launch rules a step {want}")

    def to_host(items):
        return {p: g.detach().to("cpu", copy=True) for p, g in items}

    def against(ref):
        def errs(items):
            out = {}
            for p, g in items:
                r = ref[p].to("cuda")
                out[p] = (g - r).abs().max() / r.abs().max().clamp_min(1e-30)
            return dict(zip(out, torch.stack(list(out.values())).tolist()))
        return errs

    runs = {"full": _policy_run(torch, full, to_host)}
    ref = runs["full"].pop("captured")
    runs["dots"] = _policy_run(torch, dots, against(ref))
    err = runs["dots"].pop("captured")
    worst = max(err, key=err.get)
    loss_err = abs(runs["dots"]["losses"][0] - runs["full"]["losses"][0]) \
        / abs(runs["full"]["losses"][0])
    tol = DOTS_TOL
    line = (f"step 1, dots against full: loss {loss_err:.3g}, gradients "
            f"{sum(e == 0 for e in err.values())} of {len(err)} leaves equal, "
            f"the worst {err[worst]:.3g} of its peak ({worst})")
    if err[worst] > 0 or loss_err > 0:
        spread = _policy_run(torch, full, against(ref))
        s = spread.pop("captured")
        tol = max(tol, max(s.values()))
        line += (f"; a second full run against the first: the worst "
                 f"{max(s.values()):.3g}, loss "
                 f"{abs(spread['losses'][0] / runs['full']['losses'][0] - 1):.3g}"
                 f" (the gate)")
    del ref
    print(line, flush=True)
    for policy, r in runs.items():
        print(f"{policy}: losses {[round(x, 4) for x in r['losses']]}; step ms "
              f"{[round(x, 1) for x in r['ms']]} (median of steps 2-"
              f"{DOTS_STEPS}: {statistics.median(r['ms'][1:]):.1f}); peak "
              f"of steps 2-{DOTS_STEPS} {r['peak']:.2f} GiB; launches a step "
              f"{r['launches'][-1]}", flush=True)
    print(f"dots launches {sum(want['full'].values()) - sum(want['dots'].values())}"
          f" fewer products a step (the layers' recompute); card {smi}",
          flush=True)
    failed = []
    if not all(math.isfinite(x) for r in runs.values() for x in r["losses"]):
        failed.append("a loss is not finite")
    if not (err[worst] <= tol and loss_err <= tol):
        failed.append(f"dots against full: gradients {err[worst]} "
                      f"({worst}), loss {loss_err}, tolerance {tol}")
    for policy, r in runs.items():
        if any(c != want[policy] for c in r["launches"]):
            failed.append(f"{policy}: launches {r['launches']} differ from "
                          f"the rule {want[policy]}")
    if failed:
        raise SystemExit("22b: " + "; ".join(failed))
    return {k: sum(c[k] for c in runs["dots"]["launches"])
            for k in runs["dots"]["launches"][0]}


def phase22_training(torch, smi: str) -> dict[str, dict[str, int]]:
    """Phase 22, alone on the card. Returns the launch counts by path."""
    return {f"{ZAMBA_TRAIN[0]} train 1x{ZAMBA_TRAIN[2]} (22a)":
            train_zamba_4k(torch, smi),
            f"{TRAIN_ARCH} train dots (22b)": remat_dots(torch, smi)}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "src", "repro_torch")):
        print("chip_smoke: run it from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))

    smi = environment(torch)
    build_kernels()
    record = check_kernels(torch)
    record["wkv"] = check_wkv(torch)
    profile = "--profile" in sys.argv[1:]
    if "--out" in sys.argv[1:]:
        global TRACE_DIR
        TRACE_DIR = os.path.abspath(sys.argv[sys.argv.index("--out") + 1])
    counts = {"qwen1.5-4b": run_path(torch, "qwen1.5-4b", "4a")}
    static_steps(torch, "qwen1.5-4b", "4a")
    kernel_vs_plain(torch, "qwen1.5-4b", "5a")
    counts["rwkv6-3b"] = run_path(torch, "rwkv6-3b", "4b")
    static_steps(torch, "rwkv6-3b", "4b")
    kernel_vs_plain(torch, "rwkv6-3b", "5b")
    counts["qwen1.5-4b int8"] = run_path(torch, "qwen1.5-4b int8", "4c")
    static_steps(torch, "qwen1.5-4b", "4c", quant=True)
    kernel_vs_plain(torch, "qwen1.5-4b", "5c", quant=True)
    kernel_vs_plain(torch, "rwkv6-3b", "5d", quant=True)
    verify_vs_decode(torch)
    train_cpu = train_vs_cpu_start()
    pools = []  # the background jobs' pools (14c's launcher, 15-21)
    sides = []  # 20c's process, started after 13c's card runs
    try:
        more, train_bwd, dist_rows = _phases_7_to_21(torch, profile,
                                                     train_cpu, pools, sides)
        counts.update(more)
        more, record["wkv_bwd"] = phase20_training(torch, smi, sides[0])
        more.update(phase22_training(torch, smi))
    finally:
        for side in [train_cpu, *sides]:
            _stop(side)
        for pool in pools:
            pool.stop()
    counts.update(more)

    src = {"matmul": ("src/repro_torch/kernels/csrc/matmul.cu",
                      "src/repro/kernels/matmul.py:193"),
           "gemv": ("src/repro_torch/kernels/csrc/decode_matvec.cu",
                    "src/repro/kernels/decode_matvec.py:83"),
           "wkv": ("src/repro_torch/kernels/csrc/wkv.cu",
                   "src/repro/kernels/wkv.py:86"),
           # the gradient of the Pallas kernel's function, which the
           # reference trains through jax.grad of its jnp chunk-parallel
           # form (no Pallas backward)
           "wkv_bwd": ("src/repro_torch/kernels/csrc/wkv.cu",
                       "src/repro/kernels/wkv.py:86")}
    kernels = []
    for name in ("matmul", "gemv", "wkv", "wkv_bwd"):
        r = record[name]
        by_path = {arch: c.get(name, 0) for arch, c in counts.items()
                   if c.get(name, 0)}
        kernels.append({
            "name": name, "route": "cuda", "source": src[name][0],
            "replaces": src[name][1], "launches": sum(by_path.values()),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "case": r["case"], "shape": r["shape"],
            "launches_by_path": by_path})
    kernels[0]["train_backward"] = [
        {k: r[k] for k in ("case", "route", "shape", "layout", "dtypes",
                           "max_abs_err", "ms", "plain_ms", "bound_ms",
                           "bound_by", "library_ms")} for r in train_bwd]
    kernels[0]["distributed"] = dist_rows
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    print(f"card: {smi}; all phases in {time.perf_counter() - _T0:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def phase20_training(torch, smi: str, side: subprocess.Popen):
    """Phase 20; 20c's process (``side``, started before phase 14: its CPU
    passes are done by now) runs its card pass after 20b. Returns the
    launch counts by path and 20a's record."""
    counts = {}
    try:
        record = check_wkv_bwd(torch)
        counts["rwkv6-3b train (20b)"] = train_rwkv(torch, smi)
        rwkv_vs_cpu_card(side)
        counts.update(train_families(torch, smi))
        rwkv_vs_cpu_end(side)
    finally:
        _stop(side)
    return counts, record


def _phases_7_to_21(torch, profile: bool, train_cpu, pools: list,
                    sides: list):
    """Phases 7-19 and 21 (20 follows them in ``main``), 13c's CPU runs
    beside them in ``train_cpu``; the mesh jobs' pool goes to ``pools``
    and 20c's process to ``sides`` (for ``main`` to stop). Returns the
    launch counts by path, 13a's records and 14a's."""
    counts = {}
    if profile:
        profile_path(torch, "qwen1.5-4b", "6a")
        profile_path(torch, "rwkv6-3b", "6b")
        profile_path(torch, "qwen1.5-4b", "6c", quant=True)
    bf16 = run_engine(torch, profile)
    counts["qwen1.5-4b engine"] = bf16.counts
    counts["qwen1.5-4b int8 engine"] = run_engine(torch, profile, bf16).counts
    spec = run_spec_engine(torch, profile, bf16)
    counts["qwen1.5-4b spec engine"] = spec.counts
    traced = run_traced_engine(torch, "8a", bf16)
    counts["qwen1.5-4b traced engine"] = traced["counts"]
    counts["qwen1.5-4b traced spec engine"] = run_traced_engine(
        torch, "8b", spec)["counts"]
    counts["qwen1.5-4b measured engine"] = run_measured_engine(
        torch, traced)
    # 9: the MoE family, olmoe-1b-7b at its full width and depth
    moe = "olmoe-1b-7b"
    counts[moe] = run_path(torch, moe, "9a")
    static_steps(torch, moe, "9a")
    counts[moe + " int8"] = run_path(torch, moe + " int8", "9b")
    static_steps(torch, moe, "9b", quant=True)
    kernel_vs_plain(torch, moe, "9c")
    kernel_vs_plain(torch, moe, "9d", quant=True)
    moe_bf16 = run_engine(torch, False, arch=moe, label="9e")
    counts[moe + " engine"] = moe_bf16.counts
    counts[moe + " int8 engine"] = run_engine(
        torch, False, moe_bf16, arch=moe, label="9f").counts
    counts[moe + " spec engine"] = run_spec_engine(
        torch, False, moe_bf16, arch=moe, label="9g").counts
    # 10: the hybrid family, zamba2-1.2b at its full width and depth
    zamba = "zamba2-1.2b"
    counts[zamba] = run_path(torch, zamba, "10a")
    static_steps(torch, zamba, "10a")
    counts[zamba + " int8"] = run_path(torch, zamba + " int8", "10b")
    static_steps(torch, zamba, "10b", quant=True)
    # 4 layers with the shared block every 2: layers 0 and 2 run it (at 2
    # layers only layer 0 would)
    cut = {"n_layers": 4, "shared_attn_every": 2}
    kernel_vs_plain(torch, zamba, "10c", cut=cut)
    kernel_vs_plain(torch, zamba, "10d", quant=True, cut=cut)
    # 11: the encoder-decoder family, whisper-base, whole
    whisper = "whisper-base"
    counts[whisper] = run_path(torch, whisper, "11a")
    static_steps(torch, whisper, "11a")
    kernel_vs_plain(torch, whisper, "11b", cut={})
    counts[whisper + " int8"] = run_path(torch, whisper + " int8", "11c")
    static_steps(torch, whisper, "11c", quant=True)
    kernel_vs_plain(torch, whisper, "11c", quant=True, cut={})
    # 12: the vision family, llama-3.2-vision-11b at its full width and
    # depth; card against CPU at 4 layers: two groups of a self layer and
    # the cross layer (cross_attn_every 2), so the carry from one group to
    # the next runs (at 10 layers, two groups of 4 self layers and 1 cross
    # layer, 12c took 32 s); at int8 one such group
    vision = "llama-3.2-vision-11b"
    counts[vision] = run_path(torch, vision, "12a")
    static_steps(torch, vision, "12a")
    counts[vision + " int8"] = run_path(torch, vision + " int8", "12b")
    static_steps(torch, vision, "12b", quant=True)
    kernel_vs_plain(torch, vision, "12c",
                    cut={"n_layers": 4, "cross_attn_every": 2})
    kernel_vs_plain(torch, vision, "12d", quant=True,
                    cut={"n_layers": 2, "cross_attn_every": 2})
    # 13: training, qwen1.5-4b at its full width and depth
    train_bwd = check_train_kernels(torch)
    counts["qwen1.5-4b train"] = train_path(torch)
    train_vs_cpu_go()
    smoke = dist_smoke_start()
    pools.append(smoke)
    counts["qwen1.5-4b-smoke train launcher"] = train_launcher(torch)
    train_vs_cpu_card(train_cpu)
    # 20c's CPU passes from here on, beside phase 14 (on the host's cores
    # that 13c's CPU passes used), so that phase 20 need not wait for them
    sides.append(rwkv_vs_cpu_start())
    # 14: distribution at world size 1 (nccl, the script's own process)
    dist_rows = dist_gemms(torch)
    dist_pipeline(torch)
    counts["qwen1.5-4b mesh train launcher"] = dist_train(torch, smoke)
    # 15-19: the two-rank jobs, started together (MESH_SLOTS at a time),
    # beside 14d and the rest of 13c
    jobs = start_mesh_jobs()
    pools.append(jobs)
    train_rec = dist_dryrun(torch)
    train_vs_cpu_end(train_cpu)
    # 15: tensor parallelism over 'model', two ranks on the one card
    counts["qwen1.5-4b tp serve (1x2, a rank, 2 layers)"] = \
        tp_serve(torch, jobs)
    counts["qwen1.5-4b tp train (1x2, a rank, 2 layers)"] = \
        tp_train(torch, jobs)
    tp_dryrun(torch, train_rec)
    # 16: the serving engines over the same mesh
    counts["qwen1.5-4b tp engine (1x2, a rank, 2 layers)"] = \
        tp_engine(torch, jobs)
    counts["qwen1.5-4b tp spec engine (1x2, a rank, 2 layers)"] = \
        tp_spec_engine(torch, jobs)
    # 17: expert parallelism, olmoe-1b-7b over a (2, 1) mesh
    counts[f"olmoe-1b-7b ep serve (2x1, a rank, {EP_CUT} layers)"] = \
        ep_serve(torch, jobs)
    counts["olmoe-1b-7b ep engine (2x1, a rank, 2 layers)"] = \
        ep_engine(torch, jobs)
    ep_layer(torch, jobs)
    # 18: int8 serving over the (1, 2) mesh: W8A8 over 'model', the int8
    # pool over 'model'
    counts["qwen1.5-4b int8 tp serve (1x2, a rank, 2 layers)"] = \
        int8_tp_serve(torch, jobs)
    counts["qwen1.5-4b int8 tp engine (1x2, a rank, 2 layers)"] = \
        int8_tp_engine(torch, jobs)
    # 19: the static server over the same mesh for the rwkv, hybrid,
    # encoder-decoder and vision families
    counts.update(family_tp(torch, jobs))
    # 21: int8 over the same mesh for those families, and qwen1.5-4b over
    # (1, 3): its cache's sequence over 'model', its pool whole
    counts.update(int8_family_tp(torch, jobs))
    counts[f"qwen1.5-4b seq-cache tp serve ({TP3_MESH}, a rank, {TP_CUT} "
           "layers)"] = seq_cache_tp(torch, jobs)
    counts[f"qwen1.5-4b whole-pool tp engine ({TP3_MESH}, a rank, {TP_CUT} "
           "layers)"] = whole_pool_tp_engine(torch, jobs)
    return counts, train_bwd, dist_rows


if __name__ == "__main__":
    sys.exit(main())
