#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (each raises on failure, and the script then exits non-zero):

1. device: the card's name and power limit (nvidia-smi) and torch's view;
   TF32 is switched off for matmuls and convolutions, so every fp32
   product runs in full fp32;
2. build: the nine hand-written CUDA kernels (``src/repro_torch/csrc``:
   K1-K6 and the backward kernels of K4, K5 and K6), one nvcc per source,
   in parallel;
3. kernels: each kernel against its plain PyTorch version on the card at
   the shapes its serving path gives it (smollm-135m heads: H 9, Hkv 3,
   D 64), and K3/K4 also at qwen3-4b's head geometry (H 32, Hkv 8, D 128),
   with device times (CUDA graphs over inputs that exceed the L2) of the
   kernel, the plain version and one PyTorch library call (SDPA, a
   yardstick the port never calls), and the least time the card could
   take; K5 (``ssd_chunk``) at mamba2-370m's prefill shapes (6 chunks of
   256, and one ragged chunk of 37), held to ``kernels.ssd.error_bound``
   with ``cum`` bit-equal to the plain version's (no single library call
   computes it); K6 (``rglru_scan``) at recurrentgemma-9b's prefill
   widths (a ~1,500-token note and a 37-token query with a seeded state,
   C 4096), bit-equal to its plain version, and K3/K4 at its heads (H 16,
   Hkv 1, D 256; K4 with its window of 2048, which the wrapper drops at
   S 2048 so that the causal walk runs, with one that bites, 512, and
   with 2047, the windowed walk over nearly the causal pairs), and K1
   once more at the phone island's decode (one slot of 1,600 tokens, a
   phase line of its own and a ``phone_island`` entry in K1's row); the
   K1-K4 rows carry their walk's registers, shared memory, local bytes,
   resident blocks an SM, key tile (K1/K3: and blocks of one key range)
   and the key-walk split the wrapper launched, and the K2/K4 phase
   lines ``ceiling_ms``, the flops over the TF32 rate times the passes of
   the split products (3 for fp32 x fp32, 2 with a bf16 side), beside
   ``bound_ms``; the K5/K6 rows carry each kernel's registers, shared
   memory, local bytes, resident blocks an SM and grid (K5: of its score
   and head passes), and the K5 phase lines each pass's device time;
   K4's backward (``flash_attention_bwd``) against
   ``ref.flash_attention_bwd`` at the train group's shapes (causal at
   smollm's heads, B 8 x S 2048; paligemma's 256-token prefix at its
   heads, B 2 x S 512; recurrentgemma's train step, B 1 x S 2048 with
   its window of 2048 (the causal walk), a window of 512 at its heads,
   and P14c's train steps, B 1 x S 2048 causal, at the heads of
   qwen3-4b, musicgen-large, glm4-9b and qwen3-32b, each with its
   launches a step), each gradient within ``BWD_TOL`` of its largest and two
   launches bit-equal, with its device ms (CUDA events), the plain
   version's, SDPA's backward alone (``torch.autograd.grad`` on a graph
   built outside the timing; a yardstick, with the backend that ran) and
   its forward and backward together, its bound (2.5x the forward's
   flops at the TF32 rate) and its two kernels' registers, shared memory,
   spills, blocks an SM, tile and walk step, a row of its own; K5's backward
   (``ssd_chunk_bwd``) against ``ref.ssd_chunk_bwd`` at mamba2-370m's
   train shape (8 x 2,048 tokens: 64 chunks of 256; K5's forward held to
   ``kernels.ssd.error_bound`` there first, and its cum fed on), each
   gradient within ``kernels.ssd.bwd_error_bound`` and two launches
   bit-equal, with its
   five passes' attributes and times; K6's backward (``rglru_scan_bwd``)
   bit-equal to ``ref.rglru_scan_bwd`` at recurrentgemma-9b's train shape
   (1 x 2,048, C 4,096), each with device ms, the plain version's and its
   bound (bytes over HBM; no single PyTorch call computes either);
4. serving paths, each on the quickstart mesh (laptop 6 slots, phone 1,
   home-nas 8) serving smollm-135m at its full published widths, cut to
   its first ``MAIN_LAYERS`` (15) of 30 layers (30 before P14c), with
   seeded random weights through ``TickOrchestrator``, the launch counters
   zeroed just before and read just after, every kernel of the path
   required once per layer of every dispatch and no other kernel:
   - main: fused chunked paged batchers (K2 + K1), then a profile (which
     also records the run's streams and device-to-host copies);
   - traced main path: the main path's traffic with a ``Tracer`` on the
     orchestrator and every batcher, under the same torch profile:
     streams, work clocks, K1/K2 launches and device-to-host copies
     identical to the profile's untraced run; span conservation, one
     terminal per request, one first token per completed request; the
     Chrome trace written to ``build/`` and read back;
   - the phases that hold the scheduling to the CPU's or to a second
     card run (the host split, degradation, trace harness, leakage, the
     constant-shape A/B, the oversubscribed pool, churn, stochastic and
     its replay) serve
     smollm-135m's first ``SCHED_LAYERS`` (4) layers at its full widths:
     none of their checks depends on the depth;
   - profile host split: the same traffic unprofiled and then with a
     ``DispatchProfiler`` on every batcher, each orchestrator tick timed:
     host_plan / bucket / dispatch_submit / device_sync per island and
     the orchestrator's own share, both runs' streams equal;
   - degradation: ``benchmarks/degradation.py`` (ported here) fault-free
     and under its fault plan (a slowed laptop, two bursts, stale
     telemetry, the desktop drained then killed), held to the
     benchmark's checks: nothing stranded, every rid resolved once,
     bounded expiry, shedding, backpressure, a hedge, a failover, every
     pool audited at every tick, typed reject reasons, the non-expired
     streams held to the fault-free run's under the churn phase's
     near-tie rule, and its quota attack A/B (the scheduling-interference
     attack with per-tier quotas off and on);
   - trace harness: ``benchmarks/trace.py``'s seeded trace with
     ``default_slo_classes()`` (``TRACE_N`` requests) SLO-aware on and
     off, each arm's per-class rows, ticks and work clock equal to the
     port's on the CPU at ``.reduced()`` width;
   - serve --trace: the serve launcher with ``--trace`` on the card, its
     JSON read back, one terminal per request;
   - leakage: ``benchmarks/leakage.py``'s adversary suite (seven
     attacks, ``repro_torch.privacy``) with mitigations off and on, held
     to the benchmark's checks (the leaks shown off, chance + 0.05 on),
     every attack's result equal to the port's on the CPU at
     ``.reduced()`` width, and K1/K2 once per layer of every dispatch of
     every batcher the suite built;
   - constant shape: ``constant_shape`` against the default on
     ``benchmarks/leakage.py``'s ``constant_shape_ab`` workload and on
     the main path's traffic: every request resolved, K1/K2 once per
     layer of every dispatch, one prefill and one decode geometry per
     batcher, one K1 and one K2 key-walk split per island (each launch's
     ``last_split``), streams under the near-tie rule, the work clock
     within 1.25x; then, at ``MAIN_LAYERS``, the main path default and
     constant once each for wall tokens/s, and one profiled constant run for its
     device busy time against ``profile main_path``'s;
   - fp8 smollm: an fp32 and a ``float8_e4m3fn`` dense cache through
     ``Model.forward`` (4 rows, a 1,024-token prompt, 32 decode steps;
     K4, K3): tests/test_extensions.py's bounds on the logit gap, the
     first attention layer's quantized K/V and scales bit-equal to a CPU
     quantization of the same fp32 K/V;
   - stacked: ``ContinuousBatcher``s over dense caches (K4 + K3), then a
     profile;
   - paged prefill="full" (K4 + K1) and paged fused=False (K2 + K1);
   - an oversubscribed pool (pool_headroom 0.5) that must preempt;
5. per-request: ``InferenceEngine`` over full-width ``LocalModelServer``s
   on the serve launcher's mesh, a 12-request healthcare workload
   (K4 + K3);
6. replay: the quickstart's four queries on the card and on the CPU with
   the same weights, through the fused paged batcher and through the
   stacked batcher; their logits must agree within a stated tolerance,
   and a token where the streams part must be a near-tie that the
   measured logit gap can reorder;
   - churn: the reference's ``churn_ab`` at full width on three personal
     islands (fused chunked paged batchers, ``migration_token_budget``
     256): ``churn_prompts(10)`` and the long notes at sensitivities
     0.9/0.6/0.2, once undisturbed and once with the laptop drained after
     tick 2 and the nas failed after tick 5; nothing stranded, streams
     held to the undisturbed run's under the near-tie rule, a migration
     that ships pages and a failover, no cross-tier import, every
     surviving pool audited empty, the work clock within 1-3x, every
     imported page read back bit-equal to its record, K2/K1 once per
     layer of every dispatch; then one move of the longest note (its
     pages, bytes and the export and import times);
   - churn downhill: tier-1 KV drained toward a tier-2 edge island
     arrives with no page import and a recompute;
   - churn stacked: the same drain on stacked batchers (dense-row
     thaws, K4 + K3);
   - stochastic: the quickstart traffic at temperature 0.8, seed 7: two
     runs give identical streams, a run with the laptop drained after
     tick 2 holds its keyed streams under the near-tie rule (on the
     perturbed scores), and the card and the CPU replay agree under it;
7. mamba2: mamba2-370m at its full published widths (48 layers, d_model
   1024, 32 SSM heads of 64, state 128, chunk 256, vocab 50280) with
   seeded random fp32 weights, a bf16 conv tail and an fp32 SSM state:
   at its first ``SERVE_LAYERS`` (4) layers, the quickstart traffic
   through ``build_island_batchers(cache="auto")`` (stacked batchers: K5
   on every layer of every prefill dispatch, no attention kernel), a
   profile of it and the per-request path; at full depth, the
   card-vs-CPU replay on the stacked batcher, once as served (bf16 conv
   tail) and once with an fp32 conv tail, held tighter;
8. recurrentgemma: recurrentgemma-9b at its full published widths and
   depth (38 layers: 26 RG-LRU and 12 local-attention layers, d_model
   4096, lru_width 4096 in 16 gate blocks, 16 heads of 256 on one kv
   head, window 2048, d_ff 12288, vocab 256000; 8.6 B parameters) with
   seeded random fp32 weights, bf16 K/V and conv tail, fp32 state, after
   the earlier models are freed: at its first 9 layers (three pattern
   cycles), the quickstart traffic through
   ``build_island_batchers(cache="auto")`` (stacked batchers: K6 on the
   6 RG-LRU layers and K4 on the 3 attention layers of every prefill
   dispatch, K3 on the 3 attention layers of every decode step), a
   profile of it (device busy time and idle share) and the per-request
   path; the card-vs-CPU replay on
   the stacked batcher, cut to one pattern cycle (3 layers at full
   width: 34 GB of fp32 weights and 26 TFLOP prefills do not replay on
   a CPU), once as served and once with every cache leaf in fp32; then
   the fp8 phase on the served weights (2 rows, a 512-token prompt, 16
   steps: the local-attention rings' scales at head_dim 256);
9. P12a: paligemma-3b (18 layers, d_model 2048, 8 heads of 256 on one kv
   head, a 256-token prefix-LM, vocab 257216, tied embeddings),
   musicgen-large (48 layers, 32 MHA heads of 64, vocab 2048),
   qwen3-4b (36 layers, 32 heads on 8 kv heads of 128, qk_norm) and
   glm4-9b (40 layers, 32 heads on 2 kv heads of 128: G 16) at their
   full published widths and depths with seeded random fp32 weights, one
   at a time, each freed before the next: at the first
   ``SERVE_LAYERS`` (4) layers, the quickstart traffic through
   ``build_island_batchers(cache="auto")`` (fused chunked paged
   batchers: K2 and K1 once per layer of every dispatch) and a profile
   of it; the card-vs-CPU replay on the fused paged batcher cut to the
   first two layers (every width and the whole vocabulary kept);
   paligemma also on the stacked, paged ``prefill="full"`` and
   per-request paths at the same cut, every K4 launch carrying its
   256-token prefix, and
   paligemma and musicgen through ``Model.forward`` with their
   frontends' ``embeddings`` (tests/test_models.py::
   test_prefill_decode_matches_full's inputs at full width: the card at
   full depth against itself, and against the CPU at the cut); then
   ``route_batch`` and ``pareto_front`` at 4,096 requests x 16 islands,
   equal to the CPU's, timed beside the card's name. The kernel phase
   also holds K1 and K2 at paligemma's and glm4's heads and K4 with
   paligemma's prefix at S 1024 and 2048 against their plain versions
   (SDPA with an explicit boolean mask as K4's yardstick);
10. P12b: kimi-k2-1t-a32b at ``.reduced()`` (MoE on GQA attention; one
   of its MoE layers is 67.6 GB of fp32 at full width) on the paged main
   path, with exact K1/K2 launch counts, one ``moe_apply`` call a MoE
   layer of every dispatch, and a card-vs-CPU replay (no throughput: a
   smoke width); then deepseek-v2-lite-16b at its published widths and
   full depth (27 layers, d_model 2048, 16 heads, MLA with a 512-wide
   latent and a 64-wide RoPE key, layer 0 dense with a 10,944-wide
   SwiGLU, layers 1-26 MoE: 64 experts of 1,408, top-6, 2 shared; vocab
   102,400; 15.71 B parameters, 62.8 GB of fp32 weights) with seeded
   random weights, loaded after every earlier model is freed: the
   quickstart traffic through ``build_island_batchers(cache="auto")``
   (stacked batchers: MLA's latent cache is not paged), which launches
   none of K1-K6 by design and is held instead to one ``mla_apply`` call
   a layer and one ``moe_apply`` call a MoE layer of every dispatch; one
   decode step of 8 rows timed against the 18.75 ms the weight bytes
   take at 3.35 TB/s (the dense MoE reads every expert every step); a
   profile of the path (device busy time, idle share); the matmul time
   by block (MLA, MoE, the dense MLP, the head) in one 1,024-token
   prefill and one decode step; the per-request path; and the
   card-vs-CPU replay on the stacked batcher at a 2-layer cut (the dense
   layer 0 and one MLA+MoE layer at full widths and vocabulary, 4.3 GB
   of fp32); deepseek's one-process decode (4 rows, a 512-token prompt,
   4 steps) is kept for the distributed group;
11. P13a, distributed (``dist_group``): a world-1 NCCL group and
   ``make_local_mesh(1, 1)`` (kimi ``.reduced()``'s expert-parallel MoE
   against its dense branch at capacity_factor 8; smollm-135m under the
   mesh equal to no mesh, launch for launch); then, on two gloo ranks on
   the one card (NCCL refuses two ranks on one device; gloo stages CUDA
   tensors through the host), smollm-135m at full width on a 1x2 mesh
   (3 KV heads: every layer decodes sequence-sharded; 8 rows, a 1,024-
   token prompt, max_len 2,048, 8 decode steps) with its gathered logits
   held to the one-process run's, each rank's cache half the bytes, K4
   once a layer of the prefill, K3 never, three all-reduces a layer a
   step; deepseek-v2-lite-16b at full width and depth on 1x2 (the latent
   cache sequence-sharded, 8 of the 16 MLA heads and 32 experts a rank,
   no token dropped) with its logits held to the one-process run's and
   its MLA/MoE calls exact; each rank of both holding exactly the weight
   bytes the reference's rules place on it (since P13c smollm's ff and
   vocab split, its q/k/v columns split mid-head and gathered); and
   the train launcher under ``--mesh 2x1 --backend gloo`` (smollm-135m,
   2 steps of 8 x 2,048 tokens, 4 x 2,048 a rank) with every step's loss
   and gradient norm held to the one-process launcher's and K4 and its
   backward once a layer a step on each rank;
11a. P13d, the ZeRO-3 placement on two gloo ranks as (data 2, model 1)
   (``p13d_group``): the train launcher under ``--mesh 2x1 --backend
   gloo --fsdp`` (smollm-135m, 2 steps of 8 x 2,048 tokens), each
   rank's weights exactly the rules' FSDP bytes (``apply_fsdp`` on the
   reference's stacked layout) and its moments twice that, every step's
   loss and gradient norm held to the one-process launcher run of item
   11, K4 and its backward once a layer a step; and deepseek-v2-lite-16b
   at full width cut to 2 layers (its dense first layer and one MoE
   layer), each rank without and then with FSDP from the same weights:
   the FSDP weights the rules' bytes, a prefill and 4 decode steps
   bit-equal, step 1's loss and gradients bit-equal, the gradient norm
   and step 2 within stated tolerances, peak memory a rank beside;
11b. P13e, every placement the reference runs, on two gloo ranks
   (``p13e_group``): smollm-135m at 2 layers with a 1,033-slot cache the
   model axis does not divide, kept whole on each rank of (data 1,
   model 2) and decoded through K3 (8 rows, a 1,024-token prompt, 8
   decode steps); a global batch of 3 the data axis does not divide on
   (data 2, model 1), without and with FSDP: step 1's loss and every
   gradient leaf against one process, and the train launcher's two
   steps; the mid-head cases at ``.reduced()`` (MLA, Mamba-2, q heads
   straddling kv groups on dense caches and the paged pool, RG-LRU gate
   blocks), each a prefill and 4 decode steps; every case's logits held
   to one process and its launches to its layout's;
12. P13c, qwen3-32b on the card (``p13c_group``): its first
   ``P13C_LAYERS`` of 64 layers at full widths (60.8 GB of fp32 weights)
   on the paged main path (K1/K2 launches, tokens/s, peak memory); the
   card-vs-CPU replay at the 2-layer cut; and tensor parallel over two
   gloo ranks as a (data 1, model 2) mesh at its first
   ``P13C_TP_LAYERS`` layers, each rank holding exactly the rules' weight
   bytes (32 of 64 q heads, 4 of 8 kv heads, half of ff and of both
   vocab tables), a prefill through K4 at 32 heads a rank and decode
   steps through K3 at 4 kv heads a rank, the gathered logits within
   ``P13C_TP_TOL`` of one process's on the same cut;
13. P13b, WAVES routing inside the serve step (``p13b_group``):
   qwen3-4b, the reference's routed-serve arch, at full width on its
   first ``P13B_LAYERS`` layers, 16 prompts of 128 tokens prefilled
   (K4) into a 2,048-slot fp32 cache, then 4 routed decode steps (K3) in
   each variant (``launch.routed_serve.run``: the tick router over four
   islands, two personal ones on pod 0 and an edge and a cloud island on
   pod 1, then the batch permuted to its pods' rows, with the cache
   rows too when migrating), in one process and on two gloo ranks as a
   (pod 2, data 1, model 1) mesh: the ranks' logits within
   ``DIST_LOGIT_TOL`` of one process's, ``assign`` and the router state
   exactly, each rank's final cache within ``P13B_CACHE_TOL``, K3/K4
   launches exact, the permutation's all-reduces and bytes as counted
   from the shapes, the routed step's ms; a card-vs-CPU replay at the
   2-layer cut on the reference's bf16 cache; and, in subprocesses on
   the CPU beside those, the two CLIs (``launch.dryrun`` for qwen3-4b at
   decode_32k on both production meshes, ``launch.routed_serve``'s
   default) with their records' flops, memory and collectives;
14. P14a and P14b, training, last, after a ``gc.collect()`` (the memory still
   allocated is read out first): the train launcher
   (``repro_torch.launch.train``: ``SyntheticLM``, AdamW, the cosine
   schedule, checkpoints) at smollm-135m's full width, 6 steps of 8 x
   2,048 tokens, each step timed and its launches counted (K4 and its
   backward once a layer, no other kernel), the loss falling by a nat,
   checkpoints at steps 3 and 6 and a resume from step 3 that ends on
   the uninterrupted run's loss; one step's gradient with and without
   ``remat`` (K4 60 launches against 30, the same loss and gradients, no
   leaf without a gradient); paligemma-3b at full width (2.51 B
   parameters, 40 GB of weights and fp32 AdamW state), 5 steps of 2 x
   (256 image embeddings + 256 tokens), every K4 launch and its backward
   with the 256-token prefix; kimi-k2-1t-a32b ``.reduced()`` through the
   launcher (MoE and its aux loss under autograd); one step's loss,
   gradient norm and every gradient leaf on the card and on the CPU at a
   2-layer cut of smollm and of paligemma (full widths and vocabulary),
   within ``TRAIN_*_TOL``; then P14b: mamba2-370m at full width and
   depth (368 M parameters), 4 launcher steps of 8 x 2,048 tokens with
   remat (K5 twice and its backward once a layer a step, no other
   kernel), the loss falling, and one step's gradient with and without
   remat at 2 x 2,048 (bit-equality read out); recurrentgemma-9b cut to
   its first 8 layers (2.64 B parameters, every width), 5 launcher steps
   of 1 x 2,048 with remat at lr 3e-4 (K6 and its backward on the 6
   RG-LRU layers, K4 and its backward on the 2 attention layers, the
   forwards of the 6 layers of its two pattern groups twice); the
   card-vs-CPU step at a 2-layer cut of mamba2 and one pattern cycle of
   recurrentgemma (full widths and vocabulary) within ``TRAIN_*_TOL``;
   K1-K3 under autograd on the card, each of which must raise rather
   than drop a gradient; and
   MIST's stage-2 classifier trained on the card and on the CPU, to the
   same classes. Each train reading gives step ms, tokens/s, peak memory
   and the model-flops share of 67 TFLOP/s fp32 beside the card's name
   and power limit;
15. P14c, the five configurations the card had not trained, after the
   train group has freed its models (under 1 GB allocated, read out):
   the launcher on each at full width, 3 steps of 1 x 2,048 with remat
   at the learning rate ``P14C`` states: qwen3-4b and musicgen-large at
   full depth, glm4-9b at 10 layers, deepseek-v2-lite-16b at its dense
   first layer and 4 MoE layers, qwen3-32b at 3 layers; each step's K4
   and backward launches ``train_launches`` (none for MLA) and its MLA
   and MoE calls ``train_blocks``, every loss finite and the last below
   the first, with the state bytes and peak memory; then each one's
   card-vs-CPU step at a 2-layer cut within ``TRAIN_*_TOL``.

The profile phases read the device spans from the profiler's raw
events (parsing them into host-op trees takes ~60 s a main path run);
only deepseek's block split parses the events of one prefill and one
decode step.

It prints one JSON object per phase (with its seconds), then the card's
name and power limit, the kernel table, and last
``{"ok": true, "device": {...}}``. It needs one card and the rest of the
repository beside it.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM bandwidth, and
# the tensor cores' rate for the operand type: bf16, and TF32 for fp32
# operands. The least time for a function takes the rate of its operands
# (the decode kernels read bf16 K/V, the prefill kernel at fp32 weights
# fp32 q/k/v), whatever units a kernel does its math on
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
TF32_FLOP_PER_S = 494e12
# fp32 outside the tensor cores: K6's rate (a multiply and an add a step),
# and beside K5's bound the time its flops would take there
FP32_FLOP_PER_S = 67e12
L2_BYTES = 50e6
# kernel vs its plain version on the same inputs: both accumulate in fp32
# and differ only in summation order and exp's last bits (~1e-6 on outputs
# that are convex combinations of unit-scale V rows)
KERNEL_TOL = 1e-4
# K4's backward against its plain version on the same inputs: both sum
# fp32 products in other orders over up to S x G terms, so each gradient
# holds to 1e-4 of its largest magnitude (the card tests' bound)
BWD_TOL = 1e-4
# timed launches cycle through up to this many copies of a case's inputs,
# enough for their bytes to exceed the 50 MB L2 three times over
NCOPY = 32
# card vs CPU logits in the replay at full width (the same weights and
# tokens; 30 layers of fp32 matmuls summed in another order over bf16
# pages): about 5x the largest gap this phase measured on an H100, 0.0020
# (PERF.md); the tests' MARGIN rests on the same kind of reading
REPLAY_LOGIT_TOL = 1e-2
# the same replay on mamba2-370m (48 layers, its bf16 conv tail): the gap
# grows by ~1.5e-3 a decode step to 0.0117 at the 8th token on an H100,
# while with an fp32 conv tail it stays under 4.3e-5 at every step: the
# growth is the stored tail's bf16 roundings landing on other sides of a
# rounding boundary on the card and the CPU, not the kernels or the fp32
# math (PERF.md). 5e-2 is ~4x the measured maximum. Each first token
# comes from the prefill, which reads no stored bf16 state: it holds to
# 1e-3, ~25x the 3.9e-5 measured. The replay runs once more with an fp32
# conv tail, which holds every step to that 1e-3
MAMBA2_REPLAY_LOGIT_TOL = 5e-2
MAMBA2_PREFILL_LOGIT_TOL = 1e-3
# the same replay on recurrentgemma-9b cut to one (rglru, rglru, attn)
# cycle at full width (bf16 conv tails and K/V): its gap grew to 7.4e-4
# by the 8th token on an H100, and stayed under 2.0e-5 at every step with
# every cache leaf in fp32, first tokens included (PERF.md). 4e-3 is ~5x
# the former; 2e-4, ~10x the latter, holds each first token (the
# prefill) and every step of the fp32-cache replay
RG_REPLAY_LOGIT_TOL = 4e-3
RG_PREFILL_LOGIT_TOL = 2e-4
# the oversubscribed pool (pool_headroom 0.5): max_len 128 and 96 new
# tokens for each long note (whose prompt then truncates to 31 tokens), so
# that the sequences outgrow their half of the pool together and every
# decode-ready slot of the laptop island stalls at once: it preempts 3
# times (the schedule does not depend on the weights or the widths)
OVERSUBSCRIBED = dict(max_len=128, long_new=96, pool_headroom=0.5)

QUICKSTART = [
    ("Analyze treatment options for 45-year-old diabetic patient "
     "John Doe with elevated HbA1c", "primary"),
    ("What are common diabetes complications", "burstable"),
    ("password = hunter2, please rotate the production key", "secondary"),
    ("best hiking trails near mountains", "burstable"),
]
HEAD = ("Clinical summary for the cardiology review board. The patient "
        "cohort below was enrolled under the shared intake protocol, and "
        "every note follows the same structure: history, current "
        "medication, recent lab results, and the open question for the "
        "board. Please answer the question at the end of each note. ")


def long_prompts():
    """~8 prompts of 300-1500 bytes with a common head: multi-chunk
    prefill, same-tier prefix sharing, and (two identical notes) a shared
    last page that the first decode write must copy."""
    twin = HEAD + "Twin note: identical follow-up for both examiners."
    out = [(twin, "primary"), (twin, "primary")]
    for i, n in enumerate((2, 5, 9, 13, 16, 19)):
        body = " ".join(f"Observation {k} for case {i}: stable vitals, "
                        f"dosage unchanged." for k in range(n))
        out.append((HEAD + body + f" Question {i}: next step?", "primary"))
    return out


def gpu_line():
    """The card's name and power limit as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def emit(obj):
    print(json.dumps(obj), flush=True)


def graph_ms(fns, reps=10):
    """Device time per call of the calls in ``fns``, one per input copy so
    that their working set exceeds the 50 MB L2 (the main path finds a
    layer's pages cold): captured once in a CUDA graph and replayed, so no
    host time is inside. CUDA events around the replays."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):          # warm-up before capture
        for fn in fns:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in fns:
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * len(fns))


def host_us(fn, iters=200):
    """Host time per call of ``fn`` (the enqueue: no synchronize inside)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t = (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    return t


# ------------------------------------------------------------ kernel phase

def _bound(nbytes, flops, rate=BF16_FLOP_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _pages(gen, P, ps, Hkv, D, dev):
    import torch
    return [(torch.randn(P, ps, Hkv, D, generator=gen, device=dev)
             .to(torch.bfloat16)) for _ in range(2)]


def decode_case(dev, gen, H=9, Hkv=3, D=64, ps=16, N=128,
                valid=(1, 16, 17, 300, 1024, 1, 1600, 32), idle=(0, 5)):
    """K1 at the decode shapes of the main path's largest island: 8 slots,
    a table width of 128 pages (max_len 2048), ragged fills, two idle
    scratch rows (all-zero table, fill 1: rows ``idle``) and fills on page
    boundaries; or at other fills (the phone island: one slot of 1,600)."""
    import torch
    valid = list(valid)
    B = len(valid)
    P = 1 + B * N
    kp, vp = _pages(gen, P, ps, Hkv, D, dev)
    q = torch.randn(B, H, D, generator=gen, device=dev)
    bt = torch.zeros(B, N, dtype=torch.int32, device=dev)
    for b, v in enumerate(valid):
        if b not in idle:
            n = -(-v // ps)
            bt[b, :n] = 1 + b * N + torch.randperm(N, generator=gen,
                                                   device=dev)[:n].int()
    lens = torch.tensor(valid, dtype=torch.int32, device=dev)
    live = sum(valid)
    nbytes = (2 * q.numel() * 4 + bt.numel() * 4 + B * 4
              + live * Hkv * D * 2 * 2)
    flops = 4 * live * H * D
    return (q, kp, vp, bt, lens), nbytes, flops, (
        "decode", valid, [b for b in range(B) if b not in idle])


def prefill_case(dev, gen, H=9, Hkv=3, D=64, ps=16, N=128):
    """K2 at the fused prefill shapes of the main path: 4 rows of a
    64-token run (the default budget of 4 pages), starts 0, 64 and 1024,
    and one padding row on the scratch page."""
    import torch
    starts = [0, 64, 1024, 0]
    B, T = len(starts), 4 * ps
    P = 1 + B * N
    kp, vp = _pages(gen, P, ps, Hkv, D, dev)
    q = torch.randn(B, T, H, D, generator=gen, device=dev)
    bt = torch.zeros(B, N, dtype=torch.int32, device=dev)
    for b, s in enumerate(starts[:3]):
        n = (s + T) // ps
        bt[b, :n] = 1 + b * N + torch.randperm(N, generator=gen,
                                               device=dev)[:n].int()
    sp = torch.tensor(starts, dtype=torch.int32, device=dev)
    ctx = sum(s + T for s in starts)
    nbytes = (2 * q.numel() * 4 + bt.numel() * 4 + B * 4
              + ctx * Hkv * D * 2 * 2)
    flops = 4 * H * D * sum(s + t + 1 for s in starts for t in range(T))
    return (q, kp, vp, bt, sp), nbytes, flops, ("prefill", starts,
                                                [0, 1, 2])


def dense_decode_case(dev, gen, H=9, Hkv=3, D=64, S=2048,
                      valid=(1, 16, 17, 300, 1024, 1, 1600, 32),
                      dtype="bfloat16"):
    """K3 at the stacked path's decode shapes: 8 slot rows of a
    (8, 2048, Hkv, D) bf16 cache, per-row fills spread over 1-1600 (an idle
    slot decodes at fill 1); or a row a fill of ``valid`` on an ``S``-slot
    cache of ``dtype``."""
    import torch
    B = len(valid)
    k, v = (torch.randn(B, S, Hkv, D, generator=gen, device=dev)
            .to(getattr(torch, dtype)) for _ in range(2))
    q = torch.randn(B, H, D, generator=gen, device=dev)
    lens = torch.tensor(valid, dtype=torch.int32, device=dev)
    live = sum(valid)
    nbytes = 2 * q.numel() * 4 + B * 4 + live * Hkv * D * 2 * k.element_size()
    flops = 4 * live * H * D
    return (q, k, v, lens), nbytes, flops, list(valid)


def dense_prefill_case(dev, gen, H=9, Hkv=3, D=64, S=1024, window=None,
                       prefix=0, B=1):
    """K4 at a full-prompt prefill: B prompts of S tokens, fp32 q/k/v
    (fp32 weights), causal, with a local-attention window or none, and a
    prefix-LM prefix or none. The flops count the pairs the mask allows:
    the causal half, or a band, plus the prefix keys above the diagonal
    (query t attends max(t + 1, prefix) keys without a window)."""
    import torch
    q = torch.randn(B, S, H, D, generator=gen, device=dev)
    k, v = (torch.randn(B, S, Hkv, D, generator=gen, device=dev)
            for _ in range(2))
    nbytes = 4 * (2 * q.numel() + k.numel() + v.numel())
    P = min(prefix, S)
    # a window's band (t - W, t] and the prefix [0, P) overlap where
    # t - W < P: count their union
    pairs = sum(min(t + 1, window or S)
                + max(0, P - (t + 1)) + max(0, min(P, t + 1 - (window or S)))
                for t in range(S))
    flops = 4 * B * H * D * pairs
    return (q, k, v), nbytes, flops, S


def _sdpa_inputs(kind, args):
    """Pre-gathered, head-expanded fp32 K/V and a boolean mask, so that
    one ``scaled_dot_product_attention`` call computes the same function
    (outside the timed region: the yardstick times SDPA alone)."""
    import torch
    q, kp, vp, bt, lens = args
    Hkv = kp.shape[2]
    H = q.shape[-2]
    B, N = bt.shape
    ps = kp.shape[1]
    k = kp[bt.long()].reshape(B, N * ps, Hkv, -1).float()
    v = vp[bt.long()].reshape(B, N * ps, Hkv, -1).float()
    k = k.repeat_interleave(H // Hkv, dim=2).transpose(1, 2).contiguous()
    v = v.repeat_interleave(H // Hkv, dim=2).transpose(1, 2).contiguous()
    kpos = torch.arange(N * ps, device=q.device)
    if kind == "decode":
        qq = q[:, :, None, :]                               # (B, H, 1, D)
        mask = (kpos[None, :] < lens[:, None].long())[:, None, None, :]
    else:
        T = q.shape[1]
        qq = q.transpose(1, 2).contiguous()                 # (B, H, T, D)
        qpos = lens[:, None].long() + torch.arange(T, device=q.device)
        mask = (kpos[None, None, :] <= qpos[:, :, None])[:, None]
    return qq, k, v, mask


def _time_case(wrapper, plain, args, scale, copies_bytes, lib_fn,
               lib_inputs):
    """Device ms of the kernel, its plain version and the library call,
    each over enough input copies to exceed the L2."""
    n = max(2, min(NCOPY, int(3 * L2_BYTES // copies_bytes) + 1))
    copies = [tuple(a.clone() for a in args) for _ in range(n)]
    kms = graph_ms([lambda c=c: wrapper(*c) for c in copies])
    pms = graph_ms([lambda c=c: plain(*c, scale) for c in copies])
    lib = [lib_inputs(c) for c in copies]
    lms = graph_ms([lambda x=x: lib_fn(*x) for x in lib])
    del lib, copies
    return kms, pms, lms, n


def walk_info(name, args, n_split, window=None):
    """The attention walk instantiation a case runs (the prefill walk of
    K2/K4, the decode walk of K1/K3): registers, dynamic shared memory,
    local bytes and resident blocks an SM (from the CUDA runtime), its key
    tile, the decode walk's blocks of one key range (from its launcher's
    grid), and ``n_split``, the key ranges the wrapper launched (its
    ``last_split``)."""
    import ctypes

    import torch

    from repro_torch.kernels import _build
    q, kv = args[0], args[1]
    D = q.shape[-1]
    codes = {torch.float32: 0, torch.bfloat16: 1}
    if name in DECODE_ATTRS:
        lib, entry = DECODE_ATTRS[name]
        got = _build.decode_attrs(lib, entry, codes[q.dtype],
                                  codes[kv.dtype], D, q.shape[0],
                                  q.shape[1], kv.shape[2])
        # blocks of one key range: rows x kv heads x groups of 16 query
        # heads (B x Hkv where G <= 16: one block reads a K/V tile for
        # all of a kv head's query heads)
        return {"registers": got[0], "smem_bytes": got[1],
                "local_bytes": got[2], "blocks_per_sm": got[3],
                "key_tile": got[4], "blocks_per_range": got[5],
                "n_split": n_split}
    buf = (ctypes.c_int * 5)()
    ptr = ctypes.POINTER(ctypes.c_int)
    if name == "flash_attention":
        fn = _build.load_entry("flash_attention", "flash_attention_attrs",
                               [ctypes.c_int] * 5 + [ptr])
        rc = fn(codes[q.dtype], codes[kv.dtype], D, 1, int(window or 0),
                buf)
    else:
        fn = _build.load_entry("chunked_prefill",
                               "chunked_prefill_attention_attrs",
                               [ctypes.c_int] * 3 + [ptr])
        rc = fn(codes[q.dtype], codes[kv.dtype], D, buf)
    if rc != 0:
        raise RuntimeError(f"{name}: attributes failed: cudaError {rc}")
    return {"registers": buf[0], "smem_bytes": buf[1],
            "local_bytes": buf[2], "blocks_per_sm": buf[3],
            "key_tile": buf[4], "n_split": n_split}


# the decode walk's (K1, K3) library and attributes entry, by wrapper
DECODE_ATTRS = {
    "paged_decode_attention": ("paged_attention",
                               "paged_decode_attention_attrs"),
    "decode_attention": ("decode_attention", "decode_attention_attrs")}


def split_ceiling(args, flops):
    """The ceiling of the walk's split products, derived from its flops:
    TF32 passes per product (1, plus one for each fp32 side; P is always
    fp32) over the TF32 rate. For the phase lines, beside ``bound_ms``."""
    import torch
    fp32 = (args[0].dtype == torch.float32, args[1].dtype == torch.float32)
    passes = ((1 + fp32[0] + fp32[1]) + (2 + fp32[1])) / 2
    return {"tf32_passes": passes,
            "ceiling_ms": flops * passes / TF32_FLOP_PER_S * 1e3}


def _check(name, out, want):
    import torch
    torch.cuda.synchronize()
    err = float((out.float() - want.float()).abs().max())
    if not torch.isfinite(out).all() or err > KERNEL_TOL:
        raise AssertionError(f"{name}: max abs error {err} > "
                             f"{KERNEL_TOL} against the plain version")
    return err


def event_ms(fn, reps=10):
    """Device ms a call of ``fn``, eager, over ``reps`` calls between CUDA
    events after one warm-up (for calls of a millisecond or more, whose
    host issue time is far below their device time)."""
    import torch
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


def bwd_kernel_rows(dev, gen):
    """K4's backward (``flash_attention_bwd``, csrc/flash_attention_bwd.cu)
    against ``ref.flash_attention_bwd`` on the card at the train group's
    shapes: causal at smollm-135m's heads (B 8, S 2048: the train step's
    K4 launches), paligemma-3b's 256-token prefix at its heads (B 2, S
    512), recurrentgemma-9b's train step (B 1, S 2048, its window of 2048
    covering every key, so the wrapper takes the causal walk), a
    window of 512 at its heads (S 2048), and the P14c train steps (B 1,
    S 2048, causal) at the heads of the four P14C configs that run K4:
    qwen3-4b (G 4), musicgen-large (G 1, D 64), glm4-9b (G 16) and
    qwen3-32b (G 8). Each gradient holds to BWD_TOL
    of its largest magnitude. Device ms (CUDA
    events) of the kernel, the plain version and SDPA (a yardstick the
    port never calls): ``library_ms`` its backward alone, through
    ``torch.autograd.grad`` on a graph built once outside the timing (the
    same function as the kernel), with the backend that ran, and its
    forward and backward together beside it; the least time is the
    backward's flops, 2.5x the forward's over the pairs the mask allows,
    at the TF32 rate of fp32 operands. Returns the row for K4's entry
    (smollm's case, the others beside it)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    out = {}
    for role, geom, kw in (
            ("row", "smollm-135m train step (B 8, S 2048, 9 on 3 heads, "
                    "D 64), causal", dict(B=8, S=2048)),
            ("prefix_S512", "paligemma-3b train step (B 2, S 512, 8 on 1 "
                            "heads, D 256), prefix 256",
             dict(B=2, S=512, H=8, Hkv=1, D=256, prefix=256)),
            ("window_2048", "recurrentgemma-9b train step (B 1, S 2048, "
                            "16 on 1 heads, D 256), window 2048 (causal)",
             dict(S=2048, H=16, Hkv=1, D=256, window=2048)),
            ("window_512", "recurrentgemma-9b heads (S 2048, 16 on 1, D "
                           "256), window 512",
             dict(S=2048, H=16, Hkv=1, D=256, window=512)),
            *((f"train {c.name}", f"{c.name} train step (B {P14C_B}, S "
                                   f"{P14C_S}, {c.num_heads} on "
                                   f"{c.num_kv_heads} heads, D "
                                   f"{c.head_dim}), causal",
               dict(B=P14C_B, S=P14C_S, H=c.num_heads, Hkv=c.num_kv_heads,
                    D=c.head_dim))
              for c in map(get_config, P14C) if not c.use_mla)):
        B = kw.pop("B", 1)
        one, _, fflops, S = dense_prefill_case(dev, gen, **kw)
        q, k, v = (torch.randn(B, *t.shape[1:], generator=gen, device=dev)
                   for t in one)
        del one
        D, w, pre = q.shape[-1], kw.get("window"), kw.get("prefix", 0)
        scale = D ** -0.5
        o, lse = ref.flash_attention(q, k, v, scale, True, w, pre,
                                     return_lse=True)
        o, lse = o.contiguous(), lse.contiguous()
        do = torch.randn(q.shape, generator=gen, device=dev)
        bargs = (q, k, v, o, lse, do, scale, True, w, pre)
        got = flash_attention_bwd(*bargs)
        again = flash_attention_bwd(*bargs)
        want = ref.flash_attention_bwd(*bargs)
        torch.cuda.synchronize()
        errs = [float((a - b).abs().max()) for a, b in zip(got, want)]
        for name, e, b, g, g2 in zip(("dq", "dk", "dv"), errs, want, got,
                                     again):
            lim = BWD_TOL * float(b.abs().max()) + 1e-6
            if not e <= lim:
                raise AssertionError(f"flash_attention_bwd ({geom}): {name} "
                                     f"max abs error {e} > {lim}")
            if not torch.equal(g, g2):
                raise AssertionError(f"flash_attention_bwd ({geom}): two "
                                     f"launches differ in {name}")
        del got, again, want
        kms = event_ms(lambda: flash_attention_bwd(*bargs))
        pms = event_ms(lambda: ref.flash_attention_bwd(*bargs), reps=3)
        qq, kk, vv = (t.transpose(1, 2).contiguous().requires_grad_(True)
                      for t in (q, k, v))
        dd = do.transpose(1, 2).contiguous()
        pos = torch.arange(S, device=dev)
        mask = None
        if w or pre:
            mask = pos[None, :] <= pos[:, None]
            if w:
                mask &= pos[None, :] > pos[:, None] - w
            mask |= pos[None, :] < pre

        def sdpa_fwd():
            return (F.scaled_dot_product_attention(qq, kk, vv, is_causal=True,
                                                   enable_gqa=True)
                    if mask is None else F.scaled_dot_product_attention(
                        qq, kk, vv, attn_mask=mask, enable_gqa=True))

        lfb = event_ms(lambda: torch.autograd.grad(sdpa_fwd(), (qq, kk, vv),
                                                   dd), reps=3)
        # SDPA's backward alone: its graph built once, outside the timing
        y = sdpa_fwd()

        def sdpa_bwd():
            return torch.autograd.grad(y, (qq, kk, vv), dd, retain_graph=True)

        lms = event_ms(sdpa_bwd, reps=3)
        backend = sdpa_backend(sdpa_bwd)
        del y
        bflops = 2.5 * fflops * B
        bound, by = _bound(4 * (4 * q.numel() + 4 * k.numel()
                                + lse.numel()), bflops, TF32_FLOP_PER_S)
        entry = {"route": "cuda",
                 "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
                 "replaces": "none: the reference differentiates XLA's "
                             "attention (src/repro/models/steps.py:38-39)",
                 "max_abs_err": max(errs), "ms": kms, "plain_ms": pms,
                 "bound_ms": bound, "bound_by": by, "library_ms": lms,
                 "library_fwd_bwd_ms": lfb, "library_backend": backend,
                 "geometry": geom, "attrs": bwd_attrs(D)}
        emit({"phase": "kernel", "name": "flash_attention_bwd", **entry,
              "shape_q": list(q.shape), "shape_kv": list(k.shape),
              "flops": bflops, "errors_dq_dk_dv": errs,
              "deterministic": True,
              "tolerance": f"{BWD_TOL} of each gradient's largest"})
        if role == "row":
            out = dict(entry, launches=None)
        else:
            # launches a step: filled by the train phase that runs the shape
            out[role] = dict(entry, launches=None)
        del q, k, v, o, lse, do, bargs, qq, kk, vv, dd, mask
    return out


def sdpa_backend(fn):
    """The SDPA backend one call of ``fn`` ran, read from the names of the
    device kernels it launched (torch.profiler): cudnn, flash, efficient
    (the memory-efficient kernels) or math (no fused attention kernel),
    with the three kernels that took the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = sorted((e for e in prof.key_averages() if e.device_time_total > 0),
                 key=lambda e: -e.device_time_total)
    names = " ".join(e.key for e in evs).lower()
    kind = ("cudnn" if "cudnn" in names else "flash" if "flash" in names
            else "efficient" if "efficient" in names or "fmha" in names
            else "math")
    return {"backend": kind, "top_kernels": [e.key for e in evs[:3]]}


def bwd_attrs(D):
    """The dK/dV and dQ kernels' registers, dynamic shared memory, local
    bytes, resident blocks an SM, tile and walk step at head_dim D (CUDA
    runtime)."""
    import ctypes

    from repro_torch.kernels import _build
    buf = (ctypes.c_int * 12)()
    rc = _build.load_entry("flash_attention_bwd", "flash_attention_bwd_attrs",
                           [ctypes.c_int, ctypes.POINTER(ctypes.c_int)])(
        D, buf)
    if rc != 0:
        raise RuntimeError(f"flash_attention_bwd_attrs failed: {rc}")
    keys = ("registers", "smem_bytes", "local_bytes", "blocks_per_sm",
            "tile", "step")
    return {kern: dict(zip(keys, buf[6 * i:6 * i + 6]))
            for i, kern in enumerate(("dkdv", "dq"))}


def ssd_case(dev, gen, nc, Q, H=32, P=64, N=128):
    """K5 at a mamba2-370m prefill: one prompt of nc chunks of Q rows, its
    post-conv inputs at the model's init: x, B and C silu of unit
    normals, dt = softplus(N(0,1) + dt_bias), dt_bias = softplus^-1 of
    U[1e-3, 1e-1], a = -(1..H) (A_log = log(1..H)), all fp32. Bytes: every
    input read once and every output written once. Flops: C.B^T once per
    chunk (it has no head axis), then per head the masked product with x,
    both over the causal half (Q(Q+1)/2 pairs), and the state's Q x P x N
    update."""
    import torch
    import torch.nn.functional as F

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    x = F.silu(rn(1, nc, Q, H, P))
    B_, C_ = F.silu(rn(1, nc, Q, N)), F.silu(rn(1, nc, Q, N))
    u = torch.rand(H, generator=gen, device=dev) * 0.099 + 1e-3
    dt = F.softplus(rn(1, nc, Q, H) + torch.log(torch.expm1(u)))
    a = -torch.arange(1, H + 1, dtype=torch.float32, device=dev)
    n_in = x.numel() + dt.numel() + a.numel() + 2 * B_.numel()
    n_out = x.numel() + nc * H * P * N + nc * H + dt.numel()
    pairs = Q * (Q + 1) // 2
    flops = 2 * nc * (pairs * N + H * pairs * P + H * Q * P * N)
    return (x, dt, a, B_, C_), 4 * (n_in + n_out), flops


def pass_ms(fn, kernels, reps=20):
    """Device ms a call of ``fn`` spends in each of the named ``kernels``
    (substrings of the kernel names), from torch.profiler over ``reps``
    calls on the same inputs (a warm L2)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {k: 0.0 for k in kernels}
    for e in prof.key_averages():
        for k in kernels:
            if k in e.key:
                out[k] += e.device_time_total / reps / 1e3
    return out


def hold_ssd_chunk(args, label):
    """K5's four outputs on ``args`` against the plain version's, each
    within ``kernels.ssd.error_bound``, and cum bit-equal (both sides sum
    it in order in fp32: ``ref.prefix_sum``). Returns (the kernel's
    outputs, the largest gap, the largest gap over its bound, the cum
    gap dc)."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd import error_bound, ssd_chunk
    got = ssd_chunk(*args)
    want = ref.ssd_chunk(*args)
    torch.cuda.synchronize()
    bounds, dc = error_bound(*args, got[3], want[3])
    err, ratio = 0.0, 0.0
    for name, g, w, b in zip(("y_intra", "state", "decay", "cum"), got, want,
                             bounds):
        gap = (g - w).abs()
        if not torch.isfinite(g).all() or bool((gap > b).any()):
            raise AssertionError(
                f"ssd_chunk {name} ({label}): max gap {float(gap.max())} "
                f"exceeds its bound (max gap/bound "
                f"{float((gap / b).max())})")
        err = max(err, float(gap.max()))
        ratio = max(ratio, float((gap / b).max()))
    if not torch.equal(got[3], want[3]):
        raise AssertionError(f"ssd_chunk cum ({label}) is not bit-equal to "
                             f"the plain version's")
    return got, err, ratio, dc


def ssd_kernel_rows(dev, gen):
    """K5 against its plain version at mamba2-370m's prefill shapes: six
    chunks of 256 (a ~1,500-token note) and one ragged chunk of 37 (a
    short query). Every output holds to ``kernels.ssd.error_bound``
    (1e-4 of the sum of its terms' magnitudes, widened by e^(2 dc) - 1
    for a gap dc between the two sides' cum); ``max_abs_err`` is the
    largest gap over the four outputs. Returns the six-chunk row."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd import kernel_attrs, ssd_chunk
    row = None
    for nc, Q in ((6, 256), (1, 37)):
        args, nbytes, flops = ssd_case(dev, gen, nc, Q)
        got, err, ratio, dc = hold_ssd_chunk(args, f"nc {nc}, Q {Q}")
        del got
        n = max(2, min(NCOPY, int(3 * L2_BYTES // nbytes) + 1))
        copies = [tuple(t.clone() for t in args) for _ in range(n)]
        kms = graph_ms([lambda c=c: ssd_chunk(*c) for c in copies])
        pms = graph_ms([lambda c=c: ref.ssd_chunk(*c) for c in copies])
        del copies
        bound, by = _bound(nbytes, flops, TF32_FLOP_PER_S)
        r = {"name": "ssd_chunk", "route": "cuda",
             "source": "src/repro_torch/csrc/ssd_chunk.cu",
             "replaces": "src/repro/kernels/ssd.py:60", "launches": None,
             "max_abs_err": err, "ms": kms, "plain_ms": pms,
             "bound_ms": bound, "bound_by": by, "library_ms": None,
             "kernel_attrs": kernel_attrs(args[0], args[3])}
        emit({"phase": "kernel", **r, "shape_x": list(args[0].shape),
              "shape_B": list(args[3].shape), "bytes": nbytes,
              "flops": flops,
              "bound_ms_fp32_cuda_cores": flops / FP32_FLOP_PER_S * 1e3,
              "max_gap_over_bound": ratio, "cum_gap": float(dc.max()),
              "max_abs_cum": float(args[1].mul(args[2]).cumsum(2)
                                   .abs().max()),
              "tolerance": "kernels.ssd.error_bound", "input_copies": n,
              "pass_ms_warm_l2": pass_ms(lambda: ssd_chunk(*args),
                                         ("ssd_chunk_score_kernel",
                                          "ssd_chunk_head_kernel")),
              "wrapper_host_us": host_us(lambda: ssd_chunk(*args))})
        row = row or r
        del args
    return row


def rglru_case(dev, gen, S, C=4096, with_h0=False):
    """K6 at a recurrentgemma-9b prefill: one prompt of S tokens at
    lru_width C, the gates' values at the model's init: a =
    exp(-8 softplus(Lambda) r) with Lambda = softplus^-1 of -log(u)/8, u ~
    U[0.9, 0.999] (lambda_init) and r = sigmoid of a unit normal; b a unit
    normal; all fp32. Bytes: a and b read once, h written once (and h0
    read). Flops: a multiply and an add a step, at the fp32 rate of the
    CUDA cores (no tensor-core operation applies)."""
    import torch
    import torch.nn.functional as F
    u = torch.rand(C, generator=gen, device=dev) * 0.099 + 0.9
    lam = torch.log(torch.expm1(-torch.log(u) / 8.0))
    r = torch.sigmoid(torch.randn(1, S, C, generator=gen, device=dev))
    a = torch.exp(-8.0 * F.softplus(lam) * r)
    b = torch.randn(1, S, C, generator=gen, device=dev)
    h0 = torch.randn(1, C, generator=gen, device=dev) if with_h0 else None
    nbytes = 4 * (3 * a.numel() + (h0.numel() if with_h0 else 0))
    return (a, b, h0), nbytes, 2 * a.numel()


def rglru_kernel_rows(dev, gen):
    """K6 against its plain version at recurrentgemma-9b's prefill
    widths: a ~1,500-token note without a state, and a 37-token query
    seeded with one. Returns the note's row."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.rglru import kernel_attrs, rglru_scan
    row = None
    for S, with_h0 in ((1500, False), (37, True)):
        args, nbytes, flops = rglru_case(dev, gen, S, with_h0=with_h0)
        got = rglru_scan(*args)
        want = ref.rglru_scan(*args)
        torch.cuda.synchronize()
        # the kernel rounds each step's multiply and add as the plain
        # version does: any gap would be a contraction into an FMA
        err = float((got - want).abs().max())
        if not torch.equal(got, want):
            raise AssertionError(f"rglru_scan (S {S}): not bit-equal to the "
                                 f"plain version (max abs error {err})")
        del got, want
        n = max(2, min(NCOPY, int(3 * L2_BYTES // nbytes) + 1))
        copies = [tuple(t.clone() if t is not None else None for t in args)
                  for _ in range(n)]
        kms = graph_ms([lambda c=c: rglru_scan(*c) for c in copies])
        pms = graph_ms([lambda c=c: ref.rglru_scan(*c) for c in copies],
                       reps=2)
        del copies
        bound, by = _bound(nbytes, flops, FP32_FLOP_PER_S)
        r = {"name": "rglru_scan", "route": "cuda",
             "source": "src/repro_torch/csrc/rglru_scan.cu",
             "replaces": "src/repro/kernels/rglru.py:52", "launches": None,
             "max_abs_err": err, "ms": kms, "plain_ms": pms,
             "bound_ms": bound, "bound_by": by, "library_ms": None,
             "kernel_attrs": kernel_attrs(args[0], args[1])}
        emit({"phase": "kernel", **r, "shape": list(args[0].shape),
              "h0": with_h0, "bytes": nbytes, "flops": flops,
              "bit_exact_with_plain": True, "tolerance": "bit-equal",
              "input_copies": n, "achieved_bytes_per_s": nbytes / kms * 1e3,
              "wrapper_host_us": host_us(lambda: rglru_scan(*args))})
        row = row or r
        del args
    return row


# the train shapes of the two scan families: mamba2-370m's 8 x 2,048
# tokens (64 chunks of 256, H 32, P 64, N 128) and recurrentgemma-9b's
# 1 x 2,048 at lru_width 4,096
SSD_TRAIN = dict(Bsz=8, nc=8, Q=256, H=32, P=64, N=128)
RGLRU_TRAIN = dict(B=1, S=2048, C=4096)


def ssd_bwd_case(dev, gen, Bsz, nc, Q, H, P, N):
    """K5's backward at a mamba2-370m train step: the forward's inputs at
    the model's init (``ssd_case``'s draws, ``Bsz`` rows), the cum that K5
    saves there (its forward held to the plain version first,
    ``hold_ssd_chunk``), and unit-normal gradients of its four outputs. Bytes: every input read
    once (x, dt, a, B, C, cum and the four gradients) and every output
    written once (gx, gdt, ga, gB, gC). Flops, over the causal pairs
    (Q(Q+1)/2 a chunk): G = gy.x^T and M^T.gy per head, the scores C.B^T
    and the two head-summed products S_bar.B and S_bar^T.C once a chunk,
    and per head the state's products B.gstate^T and (w x)^T.gstate."""
    import torch
    (x, dt, a, B_, C_), _, _ = ssd_case(dev, gen, Bsz * nc, Q, H, P, N)
    x, dt, B_, C_ = (t.reshape(Bsz, nc, *t.shape[2:]).contiguous()
                     for t in (x, dt, B_, C_))
    out, err, ratio, dc = hold_ssd_chunk(
        (x, dt, a, B_, C_), f"the train shape {Bsz} x {nc} x {Q}")
    cum = out[3]
    del out
    emit({"phase": "kernel ssd_chunk train shape",
          "shape_x": list(x.shape), "max_abs_err": err,
          "max_gap_over_bound": ratio, "cum_gap": float(dc.max()),
          "cum_bit_equal": True, "tolerance": "kernels.ssd.error_bound"})

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    grads = (rn(*x.shape), rn(Bsz, nc, H, P, N), rn(Bsz, nc, H),
             rn(*dt.shape))
    args = (x, dt, a, B_, C_, cum, *grads)
    n_in = sum(t.numel() for t in args)
    n_out = x.numel() + dt.numel() + a.numel() + B_.numel() + C_.numel()
    pairs = Q * (Q + 1) // 2
    BC = Bsz * nc
    flops = 2 * BC * (2 * H * pairs * P + 3 * pairs * N + 2 * H * Q * P * N)
    return args, 4 * (n_in + n_out), flops


def ssd_bwd_kernel_rows(dev, gen):
    """K5's backward (``ssd_chunk_bwd``, csrc/ssd_chunk_bwd.cu) against
    ``ref.ssd_chunk_bwd`` at mamba2-370m's train shape, each gradient
    within ``kernels.ssd.bwd_error_bound``, two launches bit-equal (no
    float atomics); device ms (CUDA events) of the kernel and the plain
    version, each pass's time, and the least time (bytes over HBM, or the
    flops at the TF32 rate of fp32 operands). No single PyTorch call
    computes it (library_ms null)."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd import (bwd_error_bound, bwd_kernel_attrs,
                                         ssd_chunk_bwd)
    args, nbytes, flops = ssd_bwd_case(dev, gen, **SSD_TRAIN)
    got = ssd_chunk_bwd(*args)
    again = ssd_chunk_bwd(*args)
    want = ref.ssd_chunk_bwd(*args)
    bounds = bwd_error_bound(*args)
    torch.cuda.synchronize()
    err, ratio, gaps = 0.0, 0.0, {}
    for name, g, w, b, g2 in zip(("gx", "gdt", "ga", "gB", "gC"), got, want,
                                 bounds, again):
        gap = (g - w).abs()
        if not torch.isfinite(g).all() or bool((gap > b).any()):
            raise AssertionError(
                f"ssd_chunk_bwd {name}: max gap {float(gap.max())} exceeds "
                f"its bound (max gap/bound {float((gap / b).max())})")
        if not torch.equal(g, g2):
            raise AssertionError(f"ssd_chunk_bwd {name}: two launches on "
                                 f"the same inputs differ")
        gaps[name] = float(gap.max())
        err = max(err, gaps[name])
        ratio = max(ratio, float((gap / b).max()))
    del got, again, want, bounds
    kms = event_ms(lambda: ssd_chunk_bwd(*args), reps=5)
    pms = event_ms(lambda: ref.ssd_chunk_bwd(*args), reps=2)
    passes = pass_ms(lambda: ssd_chunk_bwd(*args),
                     ("ssd_bwd_pair_kernel", "ssd_bwd_head_kernel",
                      "ssd_bwd_bc_kernel", "ssd_bwd_vec_kernel",
                      "ssd_bwd_ga_kernel"), reps=3)
    bound, by = _bound(nbytes, flops, TF32_FLOP_PER_S)
    row = {"name": "ssd_chunk_bwd", "route": "cuda",
           "source": "src/repro_torch/csrc/ssd_chunk_bwd.cu",
           "replaces": "none: the reference differentiates ssd_chunked "
                       "through XLA (src/repro/models/ssm.py:58-110)",
           "launches": None, "max_abs_err": err, "ms": kms, "plain_ms": pms,
           "bound_ms": bound, "bound_by": by, "library_ms": None,
           "geometry": "mamba2-370m train step (8 x 2048 tokens: 64 chunks "
                       "of 256, H 32, P 64, N 128)",
           "kernel_attrs": bwd_kernel_attrs(args[0], args[3]),
           "pass_ms_warm_l2": passes}
    emit({"phase": "kernel", **row, "shape_x": list(args[0].shape),
          "bytes": nbytes, "flops": flops,
          "bound_ms_fp32_cuda_cores": flops / FP32_FLOP_PER_S * 1e3,
          "max_gap_over_bound": ratio, "max_gaps": gaps,
          "deterministic": True, "tolerance": "kernels.ssd.bwd_error_bound"})
    return row


def rglru_bwd_kernel_rows(dev, gen):
    """K6's backward (``rglru_scan_bwd``, csrc/rglru_scan_bwd.cu) against
    ``ref.rglru_scan_bwd`` at recurrentgemma-9b's train shape (1 x 2,048
    at C 4,096, fp32, no h0: the train step starts from zeros), bit-equal;
    device ms over input copies that exceed the L2 (CUDA graphs), the
    plain version's, and the least time: a, h and gh read and ga, gb
    written once over HBM (3 flops a step at the fp32 rate), with the
    share of it reached and the design's layout (producer and consumer
    warps, ring stages, steps a stage and a batch) in ``kernel_attrs``."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.rglru import (bwd_kernel_attrs, rglru_scan,
                                           rglru_scan_bwd)
    (a, b, _), _, _ = rglru_case(dev, gen, RGLRU_TRAIN["S"],
                                 RGLRU_TRAIN["C"])
    h = rglru_scan(a, b)
    gh = torch.randn(h.shape, generator=gen, device=dev)
    args = (a, h, None, gh)
    got = rglru_scan_bwd(*args)
    want = ref.rglru_scan_bwd(*args)
    torch.cuda.synchronize()
    err = max(float((g - w).abs().max()) for g, w in zip(got[:2], want[:2]))
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise AssertionError(f"rglru_scan_bwd: not bit-equal to the plain "
                             f"version (max abs error {err})")
    del got, want
    nbytes = 4 * 5 * a.numel()
    n = max(2, min(NCOPY, int(3 * L2_BYTES // nbytes) + 1))
    copies = [(a.clone(), h.clone(), None, gh.clone()) for _ in range(n)]
    kms = graph_ms([lambda c=c: rglru_scan_bwd(*c) for c in copies])
    pms = graph_ms([lambda c=c: ref.rglru_scan_bwd(*c) for c in copies[:2]],
                   reps=2)
    del copies
    flops = 3 * a.numel()
    bound, by = _bound(nbytes, flops, FP32_FLOP_PER_S)
    row = {"name": "rglru_scan_bwd", "route": "cuda",
           "source": "src/repro_torch/csrc/rglru_scan_bwd.cu",
           "replaces": "none: the reference differentiates lru_scan "
                       "through XLA (src/repro/models/rglru.py:76-85)",
           "launches": None, "max_abs_err": err, "ms": kms, "plain_ms": pms,
           "bound_ms": bound, "bound_by": by, "library_ms": None,
           "geometry": "recurrentgemma-9b train step (1 x 2048, C 4096)",
           "kernel_attrs": bwd_kernel_attrs(a, h, gh)}
    emit({"phase": "kernel", **row, "shape": list(a.shape), "bytes": nbytes,
          "flops": flops, "bit_exact_with_plain": True,
          "tolerance": "bit-equal", "input_copies": n,
          "achieved_bytes_per_s": nbytes / kms * 1e3,
          "share_of_bound": bound / kms,
          "wrapper_host_us": host_us(lambda: rglru_scan_bwd(*args))})
    return row


def kernel_phase(dev):
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.chunked_prefill import chunked_prefill_attention
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.paged_attention import paged_decode_attention
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    rows = {}
    K1 = ("paged_decode_attention", paged_decode_attention,
          ref.paged_decode_attention,
          "src/repro_torch/csrc/paged_attention.cu",
          "src/repro/kernels/paged_attention.py:111")
    K2 = ("chunked_prefill_attention", chunked_prefill_attention,
          ref.chunked_prefill_attention,
          "src/repro_torch/csrc/chunked_prefill.cu",
          "src/repro/kernels/chunked_prefill.py:123")
    # the kernels line carries K1 and K2 at smollm-135m's heads on the main
    # path's largest island, with the phone island's one slot beside K1's
    # (a phase line of its own too), and both at the heads of the configs
    # P12a serves on the paged main path: paligemma-3b (8 on 1 kv head, D
    # 256) and glm4-9b (32 on 2, D 128, G 16)
    PALI, GLM = dict(H=8, Hkv=1, D=256), dict(H=32, Hkv=2, D=128)
    for (name, wrapper, plain, src, replaces), case, geom, role in (
            (K1, decode_case, "8 slots, fills 1-1600", "row"),
            (K1, lambda dev, gen: decode_case(dev, gen, valid=(1600,),
                                              idle=()),
             "the phone island: 1 slot, fill 1600", "phone_island"),
            (K1, lambda dev, gen: decode_case(dev, gen, **PALI),
             "paligemma-3b heads (8 on 1, D 256), 8 slots, fills 1-1600",
             "paligemma_heads"),
            (K1, lambda dev, gen: decode_case(dev, gen, **GLM),
             "glm4-9b heads (32 on 2, D 128, G 16), 8 slots, fills 1-1600",
             "glm4_heads"),
            (K2, prefill_case, "4 rows of 64 tokens", "row"),
            (K2, lambda dev, gen: prefill_case(dev, gen, **PALI),
             "paligemma-3b heads (8 on 1, D 256), 4 rows of 64 tokens",
             "paligemma_heads"),
            (K2, lambda dev, gen: prefill_case(dev, gen, **GLM),
             "glm4-9b heads (32 on 2, D 128, G 16), 4 rows of 64 tokens",
             "glm4_heads")):
        args, nbytes, flops, (kind, fills, live) = case(dev, gen)
        scale = args[0].shape[-1] ** -0.5
        out = wrapper(*args)
        n_split = wrapper.last_split
        err = _check(name, out, plain(*args, scale))
        # table entries past a live row's fill or causal horizon point at
        # the scratch page: poisoning it must leave every live row as it was
        args[1][0] = 1e4
        args[2][0] = -1e4
        again = wrapper(*args)
        if not torch.equal(again[live], out[live]):
            raise AssertionError(f"{name}: scratch page leaked into a row")
        qq, k, v, mask = _sdpa_inputs(kind, args)
        lib = F.scaled_dot_product_attention(qq, k, v, attn_mask=mask)
        lib = lib.transpose(1, 2) if kind == "prefill" else lib[:, :, 0]
        lib_err = float((lib.reshape(out.shape)[live] - again[live])
                        .abs().max())
        del qq, k, v, mask, lib
        kms, pms, lms, n = _time_case(
            wrapper, plain, args, scale, nbytes,
            lambda q, k, v, m: F.scaled_dot_product_attention(
                q, k, v, attn_mask=m),
            lambda c, kind=kind: _sdpa_inputs(kind, c))
        bound, by = _bound(nbytes, flops)
        row = {"name": name, "route": "cuda", "source": src,
               "replaces": replaces, "launches": None, "max_abs_err": err,
               "ms": kms, "plain_ms": pms, "bound_ms": bound,
               "bound_by": by, "library_ms": lms,
               "walk_attrs": walk_info(name, args, n_split)}
        extra = split_ceiling(args, flops) if kind == "prefill" else {}
        if role == "row":
            rows[name] = row
        else:
            rows[name][role] = {k: row[k] for k in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "walk_attrs")}
            rows[name][role]["geometry"] = geom
        emit({"phase": "kernel", **row, **extra, "geometry": geom,
              "shape_q": list(args[0].shape), "fills_or_starts": fills,
              "bytes": nbytes, "flops": flops, "library_max_abs_err": lib_err,
              "tolerance": KERNEL_TOL, "input_copies": n,
              "wrapper_host_us": host_us(lambda: wrapper(*args))})

    def sdpa_decode(q, k, v, lens):
        """(B, H, 1, D) query against (B, Hkv, S, D) fp32 K/V, GQA and a
        fill mask: SDPA's inputs, made outside the timed region."""
        S = k.shape[1]
        mask = (torch.arange(S, device=q.device)[None, :]
                < lens[:, None].long())[:, None, None, :]
        return (q[:, :, None, :], k.float().transpose(1, 2).contiguous(),
                v.float().transpose(1, 2).contiguous(), mask)

    def sdpa_prefill(q, k, v, window=None, prefix=0):
        """(B, H, S, D) inputs, and an explicit boolean mask where a window
        bites or a prefix-LM prefix opens keys above the diagonal."""
        qkv = tuple(t.transpose(1, 2).contiguous() for t in (q, k, v))
        S = q.shape[1]
        if (not window or window >= S) and not prefix:
            return qkv
        pos = torch.arange(S, device=q.device)
        mask = pos[None, :] <= pos[:, None]
        if window and window < S:
            mask &= pos[None, :] > pos[:, None] - window
        return qkv + (mask | (pos[None, :] < prefix),)

    def sdpa_prefill_call(q, k, v, band=None):
        if band is None:
            return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                  enable_gqa=True)
        return F.scaled_dot_product_attention(q, k, v, attn_mask=band,
                                              enable_gqa=True)

    K3 = ("decode_attention", "src/repro_torch/csrc/decode_attention.cu",
          "src/repro/kernels/decode_attention.py:95")
    K4 = ("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
          "src/repro/kernels/flash_attention.py:82")
    RG = dict(H=16, Hkv=1, D=256)
    # the kernels line carries K3/K4 at the geometry of the newest path
    # that runs them (recurrentgemma-9b; K4 at its window of 2048, with
    # the biting window's numbers beside), and at a rank's shapes on the
    # P13c tensor-parallel qwen3-32b path (32 q on 4 kv heads, G 8: K4 on
    # its 4 prompts of P13C_S, K3 on its fp32 cache of P13C_L slots at the
    # last decode step's fill); the others are phase lines
    TP = dict(H=32, Hkv=4, D=128)
    TP_GEOM = ("qwen3-32b heads on a rank of the 1x2 tensor-parallel "
               "path (32 on 4, D 128, G 8)")
    for (name, src, replaces), geom, case_kw, role in (
            (K3, "smollm-135m stacked", dict(), None),
            (K3, "qwen3-4b heads", dict(H=32, Hkv=8, D=128), None),
            (K3, "recurrentgemma-9b heads", RG, "row"),
            (K3, f"{TP_GEOM}, {P13C_B} rows at fill {P13C_S + P13C_T} of "
                 f"{P13C_L} fp32 slots",
             dict(TP, S=P13C_L, valid=(P13C_S + P13C_T,) * P13C_B,
                  dtype="float32"), "qwen3_32b_rank"),
            (K4, "smollm-135m", dict(), None),
            (K4, "qwen3-4b heads", dict(H=32, Hkv=8, D=128, S=2048), None),
            (K4, "recurrentgemma-9b heads, window 2048",
             dict(RG, S=2048, window=2048), "row"),
            (K4, f"{TP_GEOM}, {P13C_B} prompts of {P13C_S}",
             dict(TP, S=P13C_S, B=P13C_B), "qwen3_32b_rank"),
            (K4, "recurrentgemma-9b heads, window 512",
             dict(RG, S=2048, window=512), "biting_window"),
            (K4, "recurrentgemma-9b heads, window 2047 (the windowed walk "
                 "over all but one causal pair)",
             dict(RG, S=2048, window=2047), None),
            (K4, "paligemma-3b heads (8 on 1, D 256), prefix 256, S 1024",
             dict(PALI, S=1024, prefix=256), "prefix_S1024"),
            (K4, "paligemma-3b heads (8 on 1, D 256), prefix 256, S 2048",
             dict(PALI, S=2048, prefix=256), "prefix_S2048")):
        if name == "decode_attention":
            args, nbytes, flops, fills = dense_decode_case(dev, gen,
                                                           **case_kw)
            wrapper, plain = decode_attention, ref.decode_attention
            rate = (TF32_FLOP_PER_S if case_kw.get("dtype") == "float32"
                    else BF16_FLOP_PER_S)
            lib_fn = (lambda q, k, v, m: F.scaled_dot_product_attention(
                q, k, v, attn_mask=m, enable_gqa=True))
            lib_inputs = (lambda c: sdpa_decode(*c))
            shape = {"fills": fills}
        else:
            w, pre = case_kw.get("window"), case_kw.get("prefix", 0)
            args, nbytes, flops, S = dense_prefill_case(dev, gen, **case_kw)
            wrapper = (lambda q, k, v, w=w, pre=pre: flash_attention(
                q, k, v, window=w, prefix_len=pre))
            plain = (lambda q, k, v, scale, w=w, pre=pre:
                     ref.flash_attention(q, k, v, scale, True, w, pre))
            rate = TF32_FLOP_PER_S
            lib_fn = sdpa_prefill_call
            lib_inputs = (lambda c, w=w, pre=pre: sdpa_prefill(*c, w, pre))
            # the wrapper drops a window of at least S: the causal walk
            shape = {"S": S, "window": w, "prefix_len": pre,
                     "walk": "windowed" if w and w < S else "causal"}
        scale = args[0].shape[-1] ** -0.5
        out = wrapper(*args)
        n_split = (decode_attention if name == "decode_attention"
                   else flash_attention).last_split
        err = _check(f"{name} ({geom})", out, plain(*args, scale))
        lib = lib_fn(*lib_inputs(args))
        lib = (lib[:, :, 0] if name == "decode_attention"
               else lib.transpose(1, 2))
        lib_err = float((lib - out).abs().max())
        del lib
        kms, pms, lms, n = _time_case(wrapper, plain, args, scale, nbytes,
                                      lib_fn, lib_inputs)
        bound, by = _bound(nbytes, flops, rate)
        row = {"name": name, "route": "cuda", "source": src,
               "replaces": replaces, "launches": None, "max_abs_err": err,
               "ms": kms, "plain_ms": pms, "bound_ms": bound,
               "bound_by": by, "library_ms": lms}
        extra = {}
        if name == "flash_attention":
            row["walk_attrs"] = walk_info(
                name, args, n_split,
                shape["window"] if shape["walk"] == "windowed" else None)
            extra = split_ceiling(args, flops)
        else:
            row["walk_attrs"] = walk_info(name, args, n_split)
        if role == "row":
            rows[name] = dict(row, geometry=geom, **shape)
        elif role is not None:
            rows[name][role] = dict(
                {k: row[k] for k in ("max_abs_err", "ms", "plain_ms",
                                     "bound_ms", "bound_by", "library_ms",
                                     "walk_attrs")},
                geometry=geom, **shape)
        emit({"phase": "kernel", **row, **extra, "geometry": geom,
              "shape_q": list(args[0].shape),
              "shape_kv": list(args[1].shape), **shape, "bytes": nbytes,
              "flops": flops, "library_max_abs_err": lib_err,
              "tolerance": KERNEL_TOL, "input_copies": n,
              "wrapper_host_us": host_us(lambda: wrapper(*args))})
        del args, out
    rows["flash_attention_bwd"] = dict(name="flash_attention_bwd",
                                      **bwd_kernel_rows(dev, gen))
    rows["ssd_chunk"] = ssd_kernel_rows(dev, gen)
    rows["rglru_scan"] = rglru_kernel_rows(dev, gen)
    rows["ssd_chunk_bwd"] = ssd_bwd_kernel_rows(dev, gen)
    rows["rglru_scan_bwd"] = rglru_bwd_kernel_rows(dev, gen)
    # free the timed graphs' pools and the cuBLAS workspaces of the timing
    # streams (one per stream that ran a matmul) now, so that they do not
    # sit in the serving paths' memory readings
    gc.collect()
    held = torch.cuda.memory_allocated()
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()
    emit({"phase": "kernel cleanup", "memory_allocated_bytes_before": held,
          "memory_allocated_bytes_after": torch.cuda.memory_allocated()})
    return rows


# --------------------------------------------------------- main path phase

def quickstart_stack(device):
    from repro_torch.core.islands import (IslandRegistry, cloud_island,
                                          edge_island, personal_island)
    from repro_torch.core.lighthouse import Lighthouse
    from repro_torch.core.mist import MIST
    from repro_torch.core.tide import TIDE
    from repro_torch.core.waves import WAVES, Policy
    reg = IslandRegistry()
    for isl in [
        personal_island("laptop", latency_ms=120, capacity_units=3.0),
        personal_island("phone", latency_ms=250, capacity_units=0.5),
        edge_island("home-nas", privacy=0.9, latency_ms=300),
        cloud_island("gpt4-api", privacy=0.4, cost=0.02, latency_ms=900),
    ]:
        reg.register(isl, reg.attestation_token(isl.island_id))
    lh = Lighthouse(reg)
    for i in reg.all():
        lh.heartbeat(i.island_id)
    return reg, WAVES(MIST(), TIDE(reg, buffer="moderate"), lh, Policy())


def _watch_finite(b, flags):
    """Fold the finiteness of the logits of every forward pass of ``b``'s
    model (fused prefill and fused decode) into a device flag, with no
    host sync; ``flags`` collects one per batcher. The check is
    ``isfinite(logits.sum())``: a NaN or an inf anywhere makes the sum
    non-finite, and it allocates nothing the size of the logits, where
    ``isfinite(logits)`` would allocate an fp32 ``abs`` copy and three
    bool tensors of them (2.2 GB above a recurrentgemma note's 1.5 GB of
    prompt logits) inside the paths' peak memory readings."""
    import torch
    flag = torch.ones((), dtype=torch.bool, device=b.device)
    flags.append(flag)
    forward = b.model.forward

    def checked(*args, **kw):
        logits, cache = forward(*args, **kw)
        flag.logical_and_(torch.isfinite(logits.sum()))
        return logits, cache

    b.model.forward = checked


def serving_stack(cfg, params, device, max_len, long_new=16, tracer=None,
                  **bkw):
    """The quickstart mesh's orchestrator (with ``tracer``, if given) and
    batchers (``bkw`` goes to ``build_island_batchers``) with every
    request of the traffic submitted: the quickstart's four queries (8 new
    tokens) and the long notes (``long_new`` new tokens). Returns (orch,
    batchers, rids, flags)."""
    from repro_torch.core.waves import Request
    from repro_torch.serving.engine import (TickOrchestrator,
                                            build_island_batchers)
    reg, waves = quickstart_stack(device)
    batchers = build_island_batchers(cfg, reg, params=params,
                                     max_len=max_len, device=device, **bkw)
    slots = {k: b.num_slots for k, b in batchers.items()}
    if slots != {"laptop": 6, "phone": 1, "home-nas": 8}:
        raise AssertionError(f"quickstart mesh slots {slots}")
    flags = []
    for b in batchers.values():
        _watch_finite(b, flags)
    orch = TickOrchestrator(waves, reg, batchers, tracer=tracer,
                            device=device)
    reqs = [(Request(query=q, priority=p), 8) for q, p in QUICKSTART]
    reqs += [(Request(query=q, priority=p), long_new)
             for q, p in long_prompts()]
    rids = [orch.submit(r, max_new_tokens=n) for r, n in reqs]
    return orch, batchers, rids, flags


def kernel_fns():
    from repro_torch.kernels.chunked_prefill import chunked_prefill_attention
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    from repro_torch.kernels.paged_attention import paged_decode_attention
    from repro_torch.kernels.rglru import rglru_scan, rglru_scan_bwd
    from repro_torch.kernels.ssd import ssd_chunk, ssd_chunk_bwd
    return {f.__name__: f for f in (paged_decode_attention,
                                    chunked_prefill_attention,
                                    decode_attention, flash_attention,
                                    ssd_chunk, rglru_scan,
                                    flash_attention_bwd, ssd_chunk_bwd,
                                    rglru_scan_bwd)}


def zero_launches():
    for f in kernel_fns().values():
        f.launches = 0
    for f in block_fns().values():
        f.calls = 0


def read_launches():
    return {n: f.launches for n, f in kernel_fns().items()}


def block_fns():
    """The blocks that run no kernel of K1-K6: MLA and MoE count their
    calls, as the kernel wrappers count launches."""
    from repro_torch.models.mla import mla_apply
    from repro_torch.models.moe import moe_apply
    return {"mla_apply": mla_apply, "moe_apply": moe_apply}


def read_blocks():
    return {n: f.calls for n, f in block_fns().items()}


def block_layers(model):
    """(MLA layers, MoE layers) of a model: MoE after the
    ``first_dense_layers`` head layers when the config has experts."""
    cfg = model.cfg
    moe = (cfg.num_layers - cfg.first_dense_layers if cfg.num_experts
           else 0)
    return model.block_types.count("mla"), moe


def expected_blocks(models_and_passes):
    """MLA and MoE calls a run must show: one a layer of every forward
    pass, given as (model, passes) pairs."""
    want = dict.fromkeys(block_fns(), 0)
    for model, passes in models_and_passes:
        mla, moe = block_layers(model)
        want["mla_apply"] += mla * passes
        want["moe_apply"] += moe * passes
    return want


def layer_counts(model):
    """(attention layers, SSM layers, RG-LRU layers) of a model."""
    return tuple(model.block_types.count(bt)
                 for bt in ("attn", "ssm", "rglru"))


def expected_launches(batchers):
    """Launches each kernel must show after a run: one per layer of every
    dispatch that reaches it (attention kernels on attention layers, K5 on
    SSM layers, K6 on RG-LRU layers, each only at prefill), and none for a
    kernel off the path."""
    want = dict.fromkeys(kernel_fns(), 0)
    for b in batchers:
        layers, ssm_layers, rg_layers = layer_counts(b.model)
        decode = layers * b.stats["decode_steps"]
        if not hasattr(b, "pool"):                   # stacked
            prefills = b.stats["prefill_dispatches"]
            want["decode_attention"] += decode
            want["flash_attention"] += layers * prefills
            want["ssd_chunk"] += ssm_layers * prefills
            want["rglru_scan"] += rg_layers * prefills
            continue
        want["paged_decode_attention"] += decode
        if b.prefill_mode == "full":
            want["flash_attention"] += layers * b.stats["prefill_dispatches"]
        else:
            want["chunked_prefill_attention"] += layers * sum(
                1 for s in b.dispatch_shapes if s[0] == "prefill")
    return want


def serve_path(name, cfg, params, device, max_len=2048, long_new=16,
               throughput=True, **bkw):
    """One serving path over the quickstart traffic: drives it with the
    launch counters zeroed just before and read just after, checks that
    every request resolved with finite logits and caches and that the
    path went through its kernels (and its MLA and MoE blocks, once a
    layer of every dispatch: deepseek-v2-lite-16b's path launches no
    kernel of K1-K6, by design), and emits its end-to-end numbers
    (``throughput=False``: no tokens/s, for a ``.reduced()`` config).
    Returns (launches, wall seconds, the emitted result)."""
    import torch
    orch, batchers, rids, flags = serving_stack(cfg, params, device,
                                                max_len, long_new, **bkw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    zero_launches()
    t0 = time.perf_counter()
    orch.run_until_done(max_ticks=4000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()   # before the checks below
    launches = read_launches()
    blocks = read_blocks()
    if orch.busy():
        raise AssertionError(f"{name}: did not drain within 4000 ticks")
    missing = [r for r in rids if r not in orch.results]
    rejected = [r for r in rids if orch.results.get(r) is None]
    if missing or rejected:
        raise AssertionError(f"{name}: unresolved {missing}, rejected "
                             f"{rejected}")
    if not all(bool(f) for f in flags):
        raise AssertionError(f"{name}: non-finite logits")
    for iid, b in batchers.items():
        cache = b.pool.pages if hasattr(b, "pool") else b._cache
        for layer in cache:
            for t in layer.values():
                if not torch.isfinite(t).all():
                    raise AssertionError(f"{name}: non-finite K/V on {iid}")
        if getattr(b, "fused", False):
            gen = b._dev_gen[:b.num_slots]
            if bool(((gen < 0) | (gen >= cfg.vocab_size)).any()):
                raise AssertionError(f"{name}: token ids out of range on "
                                     f"{iid}")
    L = cfg.num_layers
    want = expected_launches(batchers.values())
    if launches != want:
        raise AssertionError(f"{name}: launches {launches}, expected "
                             f"{want} (one per layer of every dispatch)")
    want_blocks = expected_blocks((b.model, b.stats["device_dispatches"])
                                  for b in batchers.values())
    if blocks != want_blocks:
        raise AssertionError(f"{name}: MLA/MoE calls {blocks}, expected "
                             f"{want_blocks} (one per layer of every "
                             f"dispatch)")
    if not any(launches.values()) and not any(blocks.values()):
        raise AssertionError(f"{name}: no kernel ran")
    bs = list(batchers.values())
    ttft = sorted(rec["ttft_ticks"] for b in bs
                  for rec in b.request_log.values() if "ttft_ticks" in rec)
    gen_tokens = sum(rec.get("generated_tokens", 0) for b in bs
                     for rec in b.request_log.values())
    result = {
        "phase": name, "model": cfg.name, "layers": L,
        "d_model": cfg.d_model, "vocab": cfg.vocab_size, "max_len": max_len,
        "batchers": {k: v for k, v in bkw.items()
                     if isinstance(v, (str, int, float, bool))},
        "requests": len(rids),
        "islands": {r.island_id: sum(1 for x in orch.log
                                     if x.island_id == r.island_id)
                    for r in orch.log},
        "ticks": orch.tick_stats["ticks"],
        "batcher_ticks": orch.tick_stats["decode_ticks"],
        "device_dispatches": sum(b.stats["device_dispatches"] for b in bs),
        "decode_dispatches": sum(b.stats["decode_steps"] for b in bs),
        "admissions": sum(b.stats["admissions"] for b in bs),
        "launches": {k: v for k, v in launches.items() if v},
        **({"block_calls": blocks} if any(blocks.values()) else {}),
        "tick_dispatches_max": orch.tick_stats["tick_dispatches_max"],
        "generated_tokens": gen_tokens, "wall_s": wall,
        **({"tokens_per_s": gen_tokens / wall} if throughput
           else {"reduced": True}),
        "ttft_ticks_p50": ttft[len(ttft) // 2], "ttft_ticks_max": ttft[-1],
        "max_memory_allocated_bytes": peak,
        "memory_allocated_at_start_bytes": mem0,
        "weight_bytes": tensor_bytes(params),
        "cache_bytes": sum(tensor_bytes(b.pool.pages if hasattr(b, "pool")
                                        else b._cache) for b in bs),
    }
    if hasattr(bs[0], "pool"):
        pools = [b.pool.telemetry() for b in bs]
        result.update(
            share_hits=sum(t["share_hits"] for t in pools),
            cow_copies=sum(t["cow_copies"] for t in pools),
            prefix_tokens_skipped=sum(b.stats["prefix_tokens_skipped"]
                                      for b in bs),
            widest_prefill_run_pages=max(
                [sh[2] for b in bs for sh in b.dispatch_shapes
                 if sh[0] == "prefill"] or [0]),
            preemptions=sum(b.stats["preemptions"] for b in bs),
            preempted_rids={k: b.preempted_rids
                            for k, b in batchers.items()
                            if b.preempted_rids})
    emit(result)
    return launches, wall, result


def main_path(cfg, params, device, max_len=2048):
    """The quickstart path: fused chunked paged batchers. It must exercise
    prefix sharing, a copy-on-write and multi-page prefill runs."""
    launches, wall, result = serve_path("main_path", cfg, params, device,
                                        max_len)
    if result["share_hits"] == 0 or result["cow_copies"] == 0 \
            or result["widest_prefill_run_pages"] < 2:
        raise AssertionError(
            f"main path missed a feature: share hits "
            f"{result['share_hits']}, COW copies {result['cow_copies']}, "
            f"widest run {result['widest_prefill_run_pages']} pages")
    return launches, wall


# ----------------------------------------------------------- profile phase

def _kernel_family(name):
    walks = {("decode_walk_kernel", "PagedRows"): "paged_decode_attention",
             ("decode_walk_kernel", "DenseRows"): "decode_attention",
             ("decode_merge_kernel", "PagedRows"): "paged_decode_attention",
             ("decode_merge_kernel", "DenseRows"): "decode_attention",
             ("prefill_walk_kernel", "PagedRows"):
                 "chunked_prefill_attention",
             ("prefill_walk_kernel", "DenseRows"): "flash_attention",
             # the split walk's merge, named by the walk it merges
             ("prefill_merge_kernel", "PagedRows"):
                 "chunked_prefill_attention",
             ("prefill_merge_kernel", "DenseRows"): "flash_attention"}
    for (kernel, rows), fam in walks.items():
        if kernel in name and rows in name:
            return fam
    # K5's score and head passes, as a split walk's merge counts with its
    # walk
    if "ssd_chunk_score_kernel" in name or "ssd_chunk_head_kernel" in name:
        return "ssd_chunk"
    if "rglru_scan_kernel" in name:
        return "rglru_scan"
    if "flash_bwd_" in name:
        return "flash_attention_bwd"
    for key, fam in (("gemm", "matmul"), ("gemv", "matmul"),
                     ("xmma", "matmul"), ("cutlass", "matmul"),
                     ("Memcpy", "memcpy"), ("Memset", "memset")):
        if key in name:
            return fam
    return "other (elementwise, reductions, indexing)"


BLOCK_RANGES = {"mla": "mla block", "moe": "moe block", "mlp": "dense mlp"}


def _label_blocks():
    """Wrap the MLA mixer, the MoE block and the dense MLP as
    ``Model.forward`` calls them in ``record_function`` ranges, so that a
    profile can tell which block launched a matmul. Returns the undo."""
    from torch.profiler import record_function

    from repro_torch.models import model as mmod
    # the names Model.forward calls, not the blocks' own: their call
    # counters stay on the functions their modules define
    saved = (mmod.BLOCK_APPLY["mla"], mmod.moe_apply, mmod.swiglu_apply)

    def ranged(fn, label):
        def run(*args, **kw):
            with record_function(label):
                return fn(*args, **kw)
        return run

    mmod.BLOCK_APPLY["mla"] = ranged(saved[0], BLOCK_RANGES["mla"])
    mmod.moe_apply = ranged(saved[1], BLOCK_RANGES["moe"])
    mmod.swiglu_apply = ranged(saved[2], BLOCK_RANGES["mlp"])

    def undo():
        mmod.BLOCK_APPLY["mla"], mmod.moe_apply, mmod.swiglu_apply = saved
    return undo


def _gemm_flops(op, shapes):
    """2·M·N·K (times the batch) of a matmul op from its recorded input
    shapes, or None for an op this does not know."""
    try:
        if op == "aten::mm":
            (m, k), (_, n) = shapes[0], shapes[1]
            return 2 * m * k * n
        if op == "aten::addmm":
            (m, k), (_, n) = shapes[1], shapes[2]
            return 2 * m * k * n
        if op in ("aten::bmm", "aten::baddbmm"):
            a, bb = shapes[-2:] if op == "aten::baddbmm" else shapes[:2]
            return 2 * a[0] * a[1] * a[2] * bb[2]
    except (IndexError, TypeError, ValueError):
        return None
    return None


def _dispatch_matmuls(events, kinds, outside):
    """Device time and flops of the matmul kernels by the dispatch that
    launched them: each kernel belongs to the aten op that launched it,
    and that op to its innermost enclosing dispatch range (or, with
    ``kinds``, the innermost range of those names; ``outside`` names the
    rest). Flops come from the ops' recorded input shapes, so the rate is
    this trace's."""
    from torch.autograd import DeviceType
    kinds = set(kinds)
    out: dict = {}
    for e in events:
        if e.device_type != DeviceType.CPU or not e.kernels:
            continue
        us = sum(k.duration for k in e.kernels
                 if _kernel_family(k.name) == "matmul")
        if not us:
            continue
        p = e.cpu_parent
        while p is not None and p.name not in kinds:
            p = p.cpu_parent
        kind = p.name if p is not None else outside
        r = out.setdefault(kind, {"matmul_device_s": 0.0, "gemm_flops": 0,
                                  "ops": {}, "ops_without_flops_s": 0.0})
        r["matmul_device_s"] += us / 1e6
        r["ops"][e.name] = r["ops"].get(e.name, 0.0) + us / 1e6
        f = _gemm_flops(e.name, e.input_shapes)
        if f is None:
            r["ops_without_flops_s"] += us / 1e6
        else:
            r["gemm_flops"] += f
    for r in out.values():
        timed = r["matmul_device_s"] - r["ops_without_flops_s"]
        r["tflop_per_s"] = (r["gemm_flops"] / timed / 1e12 if timed > 0
                            else None)
    return out


def profile_phase(name, cfg, params, device, wall_unprofiled, max_len=2048,
                  streams=False, tracer=None, **bkw):
    """A serving path's workload once more, on fresh batchers, under
    ``torch.profiler``: device busy time as the union of kernel
    intervals, device time by kernel family, and the device-to-host
    copies. The busy time does not depend on the profiler's host
    overhead, so the idle share is read against the unprofiled run's wall
    time. With ``streams`` (fused
    paged batchers) the run's streams are recorded; ``tracer`` goes to
    the orchestrator. Returns the run (streams, work clocks, launches,
    copies) for the traced phase to compare."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    orch, batchers, rids, flags = serving_stack(cfg, params, device, max_len,
                                                tracer=tracer, **bkw)
    captured = _orch_streams(orch, batchers) if streams else None
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        orch.run_until_done(max_ticks=4000)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    spans, _ = _device_spans(prof)
    dtoh = sum(1 for _s, _e, kname in spans if "Memcpy DtoH" in kname)
    if not spans:
        raise AssertionError("the profiler recorded no device activity")
    busy, end = 0, float("-inf")
    fam: dict = {}
    for s, e, kname in spans:
        busy += max(0, e - max(s, end))
        end = max(end, e)
        f = fam.setdefault(_kernel_family(kname), [0.0, 0])
        f[0] += (e - s) / 1e6
        f[1] += 1
    busy_s = busy / 1e9
    emit({"phase": f"profile {name}", "device_busy_s": busy_s,
          "wall_s_profiled": wall, "wall_s_unprofiled": wall_unprofiled,
          "device_idle_share": 1.0 - busy_s / wall_unprofiled,
          "device_ms_by_family": {k: round(v[0], 3) for k, v in
                                  sorted(fam.items(), key=lambda x: -x[1][0])},
          "launches_by_family": {k: v[1] for k, v in fam.items()},
          "dtoh_copies": dtoh})
    return {"orch": orch, "batchers": batchers, "rids": rids,
            "flags": flags, "streams": captured,
            "work": {k: b.work_clock for k, b in batchers.items()},
            "launches": launches, "dtoh": dtoh, "wall": wall,
            "busy_s": busy_s}


# ------------------------------------------------------- per-request phase

def per_request_phase(cfg, params, device, n=12, max_new=8,
                      name="per_request"):
    """The serve launcher's default path at full width: its mesh and an
    ``n``-request healthcare workload through ``InferenceEngine`` into
    ``LocalModelServer``s on the card, one full-prompt prefill (K4 on
    attention layers, K5 on SSM layers, K6 on RG-LRU layers) and
    ``max_new - 1`` dense decode steps (K3 on attention layers) per local
    request."""
    import torch

    from repro_torch.core.workload import healthcare_workload
    from repro_torch.launch.serve import build_mesh
    from repro_torch.serving.engine import InferenceEngine, LocalModelServer
    reg, waves = build_mesh()
    calls = []
    servers = {}
    for iid in ("laptop", "home-nas"):
        srv = LocalModelServer(cfg, params=params, max_len=512,
                               device=device)
        gen = srv.generate

        def counted(prompts, max_new_tokens=16, gen=gen):
            calls.append(len(prompts))
            return gen(prompts, max_new_tokens)

        srv.generate = counted
        servers[iid] = srv
    eng = InferenceEngine(waves, reg, servers, seed=0)
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    resps = [eng.submit(req, max_new_tokens=max_new)
             for req, _kind in healthcare_workload(n, seed=0)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    blocks = read_blocks()
    served = [r for r in resps if r is not None]
    if len(served) + len(eng.rejected) != n or not served:
        raise AssertionError(f"per-request: {len(served)} served, "
                             f"{len(eng.rejected)} rejected of {n}")
    layers, ssm_layers, rg_layers = layer_counts(servers["laptop"].model)
    want = dict.fromkeys(kernel_fns(), 0)
    want["flash_attention"] = layers * len(calls)
    want["decode_attention"] = layers * len(calls) * (max_new - 1)
    want["ssd_chunk"] = ssm_layers * len(calls)
    want["rglru_scan"] = rg_layers * len(calls)
    if launches != want or not calls:
        raise AssertionError(f"per-request: launches {launches}, expected "
                             f"{want} for {len(calls)} local requests")
    want_blocks = expected_blocks([(servers["laptop"].model,
                                    len(calls) * max_new)])
    if blocks != want_blocks:
        raise AssertionError(f"per-request: MLA/MoE calls {blocks}, "
                             f"expected {want_blocks} for {len(calls)} "
                             f"local requests")
    stats = eng.stats()
    emit({"phase": name, "model": cfg.name, "requests": n,
          "served": len(served), "rejected": len(eng.rejected),
          "local_generate_calls": len(calls),
          "by_island": stats["by_island"],
          "launches": {k: v for k, v in launches.items() if v},
          **({"block_calls": blocks} if any(blocks.values()) else {}),
          "wall_s": wall, "local_tokens_per_s": len(calls) * max_new / wall})


# ------------------------------------------------------------ replay phase

def _capture_fused(b, store):
    """Record on the host the logits row behind every token the fused
    paged batcher ``b`` generates, keyed by (request id, token index) (the
    chunk forward is re-run for boundary tokens; its K/V writes are the
    same values the fused step then writes again)."""
    from repro_torch.models.steps import make_chunked_prefill_step
    chunk = make_chunked_prefill_step(b.model)
    prefill, decode = b._fused_prefill, b._fused_decode

    def pre(params, pages, tok, start, bt, dst, emit_slot, emit_off,
            gen_idx, last, gen):
        lg, _ = chunk(params, pages, tok, start, bt, dst)
        for r, si in enumerate(emit_slot.tolist()):
            if si < b.num_slots:
                store[(b.slots[si].request_id, int(gen_idx[r]))] = \
                    lg[r, int(emit_off[r])].float().cpu()
        return prefill(params, pages, tok, start, bt, dst, emit_slot,
                       emit_off, gen_idx, last, gen)

    def dec(params, pages, last, host_mask, host_tok, pos, bt, write_slot,
            gen_idx, gen):
        out = decode(params, pages, last, host_mask, host_tok, pos, bt,
                     write_slot, gen_idx, gen)
        for si, ws in enumerate(write_slot.tolist()):
            if ws == si:
                store[(b.slots[si].request_id, int(gen_idx[si]))] = \
                    out[0][si].float().cpu()
        return out

    b._fused_prefill, b._fused_decode = pre, dec


def _capture_stacked(b, store):
    """The same record for the stacked batcher, which takes its tokens on
    the host: the prefill step's logits give each first token, the decode
    step's row of each active slot the next one."""
    prefill, decode, first = b._prefill, b._decode_all, b._note_first_token
    last = {}

    def pre(params, cache, tokens):
        out = prefill(params, cache, tokens)
        last["row"] = out[0][0].float().cpu()
        return out

    def note_first(rid):
        store[(rid, 0)] = last.pop("row")
        first(rid)

    def dec(params, cache, toks, poss):
        out = decode(params, cache, toks, poss)
        for si, s in enumerate(b.slots):
            if s.active:
                store[(s.request_id, len(s.generated))] = \
                    out[0][si].float().cpu()
        return out

    b._prefill, b._decode_all, b._note_first_token = pre, dec, note_first


def _streams(b):
    out = {}
    finish = b._finish_slot

    def record(si):
        if hasattr(b, "_materialize_slot"):
            b._materialize_slot(si)
        s = b.slots[si]
        out[s.request_id] = list(s.generated)
        finish(si)

    b._finish_slot = record
    return out


def replay(name, cfg, runs_on, make, capture, tol=REPLAY_LOGIT_TOL,
           first_tol=None):
    """``runs_on`` is [(card device, params), (cpu device, params)]: the
    same four queries through a fresh batcher (``make(device, params)``)
    on each, with the logits behind every token (``capture``). Up to and
    including the first token where two streams part, both sides computed
    their logits from the same tokens: those must agree within ``tol``,
    and a parting token is legitimate only where the CPU's top-2 margin is
    at most twice that step's largest logit gap (no smaller gap can
    reorder the top two). ``first_tol``, when given, holds each request's
    first token (the prefill's logits) tighter. Every step's gap is
    emitted before a fault is raised."""
    import torch
    streams, logits = [], []
    for dev, params in runs_on:
        b = make(dev, params)
        streams.append(_streams(b))
        logits.append({})
        capture(b, logits[-1])
        for q, _p in QUICKSTART:
            b.submit(q, max_new_tokens=8, trust_tier=1)
        b.run_until_done()
    (card, cpu), (card_lg, cpu_lg) = streams, logits
    if sorted(card) != sorted(cpu):
        raise AssertionError(f"{name}: requests differ: {sorted(card)} "
                             f"vs {sorted(cpu)}")
    faults, stats = hold_streams(cpu, cpu_lg, card, card_lg, tol, first_tol,
                                 what=("card", "cpu"))
    emit({"phase": name, "requests": len(cpu), "tokens_per_request": 8,
          "steps_compared": len(stats["gaps"]),
          "max_logit_gap": max(stats["gaps"]),
          "logit_tol": tol, "first_token_logit_tol": first_tol,
          "max_abs_cpu_logit": stats["scale"],
          "diverged_at_near_tie": stats["diverged"],
          "min_cpu_margin": min(stats["margins"]),
          "identical_streams": sum(card[r] == cpu[r] for r in cpu),
          "logit_gaps": stats["gaps"]})
    if faults:
        raise AssertionError(f"{name}: " + "; ".join(faults))


def hold_streams(want, want_lg, got, got_lg, tol, first_tol=None,
                 what=("got", "want")):
    """Hold the streams ``got`` (rid -> tokens) to ``want`` with the rows
    behind their tokens (``*_lg``, keyed by (rid, token index)): up to and
    including the first token where two streams part, both sides computed
    their rows from the same tokens, so those must agree within ``tol``
    (``first_tol`` for token 0, when given); a parting token is legitimate
    only where ``want``'s top-2 margin is at most twice that step's
    largest gap. Returns (faults, {"gaps", "margins", "diverged",
    "scale"})."""
    import torch
    diverged, gaps, margins, faults, scale = 0, [], [], [], 0.0
    for rid, ref_toks in want.items():
        if len(got[rid]) != len(ref_toks):
            faults.append(f"request {rid}: {len(got[rid])} tokens on the "
                          f"{what[0]}, {len(ref_toks)} on the {what[1]}")
            continue
        for k, (a, c) in enumerate(zip(got[rid], ref_toks)):
            ref = want_lg[(rid, k)]
            gap = float((got_lg[(rid, k)] - ref).abs().max())
            top = torch.topk(ref, 2).values
            margin = float(top[0] - top[1])
            scale = max(scale, float(ref.abs().max()))
            gaps.append(gap)
            margins.append(margin)
            limit = first_tol if k == 0 and first_tol is not None else tol
            if not gap <= limit:
                faults.append(f"request {rid} token {k}: {what[0]} vs "
                              f"{what[1]} rows differ by {gap} > {limit}")
            if a != c:
                if margin > 2 * gap:
                    faults.append(f"request {rid} token {k}: {what[0]} {a}"
                                  f" != {what[1]} {c} at a top-2 margin of "
                                  f"{margin} > twice the gap {gap}")
                diverged += 1
                break
    return faults, {"gaps": gaps or [0.0], "margins": margins or [0.0],
                    "diverged": diverged, "scale": scale}


# ----------------------------------------------- churn and sampling phases

# a churned stream against the undisturbed run's on the same card: a
# recompute thaw or a failover rebuilds a context's K/V with the prefill
# kernel (K2) where the undisturbed run wrote it by decode steps (K1), and
# a destination's other batch changes the key-walk split and cuBLAS's
# algorithm, so a K/V element can land on the other side of a bf16
# rounding: the same kind of gap as the card-vs-CPU replay, held to the
# same tolerance
CHURN_LOGIT_TOL = REPLAY_LOGIT_TOL
# the churn traffic's sensitivities (KV tiers 1/2/3), cycled as
# churn_prompts cycles them
CHURN_SENSITIVITY = (0.9, 0.6, 0.2)
# the stochastic phase: the reference's test temperature and seed
TEMPERATURE, SAMPLE_SEED = 0.8, 7


def churn_traffic():
    """``churn_prompts(10)`` and the eight long notes, each with its
    sensitivity."""
    from repro_torch.core.workload import churn_prompts
    notes = [(q, CHURN_SENSITIVITY[i % 3])
             for i, (q, _p) in enumerate(long_prompts())]
    return churn_prompts(10) + notes


def churn_islands(downhill=False):
    from repro_torch.core.islands import edge_island, personal_island
    if downhill:
        return [personal_island("laptop", latency_ms=120,
                                capacity_units=2.0),
                edge_island("edge", privacy=0.9, latency_ms=200,
                            capacity_units=4.0)]
    return [personal_island("laptop", latency_ms=120, capacity_units=2.0),
            personal_island("desktop", latency_ms=150, capacity_units=2.0),
            personal_island("nas", latency_ms=200, capacity_units=2.0)]


def churn_stack(cfg, params, device, islands, cache="paged"):
    """The reference's churn mesh (``benchmarks/serving.py`` ``churn_ab``)
    on the port: SHORE islands only, batchers at max_len 2048,
    ``decode_ticks_per_tick=1``, ``migration_token_budget=256``. Returns
    (orch, every batcher by island, finiteness flags)."""
    from repro_torch.core.islands import IslandRegistry
    from repro_torch.core.lighthouse import Lighthouse
    from repro_torch.core.mist import MIST
    from repro_torch.core.tide import TIDE
    from repro_torch.core.waves import WAVES, Policy
    from repro_torch.serving.engine import (TickOrchestrator,
                                            build_island_batchers)
    reg = IslandRegistry()
    for isl in islands:
        reg.register(isl, reg.attestation_token(isl.island_id))
    mist, tide, lh = MIST(), TIDE(reg), Lighthouse(reg)
    for i in reg.all():
        lh.heartbeat(i.island_id)
    waves = WAVES(mist, tide, lh, Policy())
    bats = build_island_batchers(cfg, reg, cache=cache, max_len=2048,
                                 slots_per_capacity_unit=2.0, params=params,
                                 device=device)
    flags = []
    for b in bats.values():
        _watch_finite(b, flags)
    orch = TickOrchestrator(waves, reg, bats, decode_ticks_per_tick=1,
                            migration_token_budget=256, device=device)
    return orch, dict(bats), flags


def _capture_orch(orch, batchers):
    """Record, per orchestrator request id, the stream a request finished
    with (its prompt text, the stream seed of its sampling key, the
    migrations its record counts, and its tokens), and the row behind
    every token keyed by (rid, token index): the logits, or at temperature
    > 0 the perturbed scores whose argmax the sampler takes. The rows are
    those the dispatches computed (a forward pass's logits are kept as it
    returns): nothing is re-run, so no kernel launch is added. Also the
    freezes: ``queued`` holds the rids frozen while still queued (such a
    ticket carries no sampling key), ``seed`` the stream seed of each
    rid's last ticket that carried one. With ``orch`` None the batchers
    are driven bare, and a request is keyed by its batcher's own rid."""
    streams, rows = {}, {}
    frozen = {"queued": set(), "seed": {}}
    for iid, b in batchers.items():
        def orid(brid, iid=iid):
            if orch is None:
                return brid
            return orch._local_inflight[(iid, brid)][0].rid

        last = {}
        forward = b.model.forward

        def kept(*args, forward=forward, last=last, **kw):
            out = forward(*args, **kw)
            last["logits"] = out[0]
            return out

        b.model.forward = kept


        if getattr(b, "fused", False):
            def pre(*args, b=b, last=last, orid=orid,
                    prefill=b._fused_prefill):
                out = prefill(*args)
                emit_slot, emit_off, gen_idx = args[6:9]
                lg = last["logits"]
                for r, si in enumerate(emit_slot.tolist()):
                    if si < b.num_slots:
                        s = b.slots[si]
                        rows[(orid(s.request_id), len(s.carried)
                              + int(gen_idx[r]))] = \
                            lg[r, int(emit_off[r])].float().cpu()
                return out

            def dec(*args, b=b, orid=orid, decode=b._fused_decode):
                out = decode(*args)
                write_slot, gen_idx = args[7], args[8]
                for si, ws in enumerate(write_slot.tolist()):
                    if ws == si:
                        s = b.slots[si]
                        rows[(orid(s.request_id), len(s.carried)
                              + int(gen_idx[si]))] = out[0][si].float().cpu()
                return out

            b._fused_prefill, b._fused_decode = pre, dec
        else:
            def note_first(rid, b=b, last=last, orid=orid,
                           first=b._note_first_token):
                rows[(orid(rid), 0)] = last["logits"][0, -1].float().cpu()
                first(rid)

            b._note_first_token = note_first

        _wrap_sample_ready(b, rows, orid)

        def freeze(brid, b=b, orid=orid, freeze_request=b.freeze_request):
            rid = orid(brid)
            t = freeze_request(brid)
            if t is not None and t.phase == "queued":
                frozen["queued"].add(rid)
            elif t is not None and t.sample_key is not None:
                frozen["seed"][rid] = t.sample_key[0]
            return t

        b.freeze_request = freeze

        def record(si, b=b, orid=orid, finish=b._finish_slot):
            if hasattr(b, "_materialize_slot"):
                b._materialize_slot(si)
            s = b.slots[si]
            streams[orid(s.request_id)] = {
                "prompt": s.prompt,
                "seed": s.sample_key[0] if s.sample_key else None,
                "migrations": b.request_log.get(s.request_id,
                                                {}).get("migrations", 0),
                "tokens": list(s.carried) + list(s.generated)}
            finish(si)

        b._finish_slot = record
    return streams, rows, frozen


def _checked_pool_io(batchers, log):
    """Time every export gather (``read_pages``) and import scatter
    (``write_pages``) of the batchers' pools, with CUDA events on a
    drained stream (``device_ms``) and on the host's clock (``host_ms``),
    and read each page an import copied back against its record's bits. Returns a
    function that undoes the import check."""
    import numpy as np
    import torch

    from repro_torch.serving import batcher as bmod
    from repro_torch.serving.kvpool import PagePool
    for b in batchers.values():
        pool = getattr(b, "pool", None)
        if pool is None:
            continue
        for name in ("read_pages", "write_pages"):
            def timed_io(pids, *rest, fn=getattr(pool, name), name=name):
                # the stream is drained first, so that the events bracket
                # this call's work alone (host work between them included)
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                t0 = time.perf_counter()
                start.record()
                out = fn(pids, *rest)
                end.record()
                end.synchronize()
                log["events"].append((name, len(pids), start, end,
                                      time.perf_counter() - t0))
                return out

            setattr(pool, name, timed_io)
    original = bmod.import_request

    def checked(pool, records, tier):
        live = {p for p in range(1, pool.num_pages) if pool.refcount[p] > 0}
        got = original(pool, records, tier)
        if got is not None:
            copies = [(pid, rec) for pid, rec in zip(got[0], records)
                      if pid not in live]
            back = PagePool.read_pages(pool, [pid for pid, _ in copies])
            for (pid, rec), data in zip(copies, back):
                log["pages_checked"] += 1
                if not all(np.array_equal(a, b)
                           for a, b in zip(data, rec.data)):
                    log["pages_unequal"] += 1
        return got

    bmod.import_request = checked

    def undo():
        bmod.import_request = original

    return undo


def _io_ms(log):
    import torch
    torch.cuda.synchronize()
    out = {}
    for name, n, start, end, wall in log["events"]:
        r = out.setdefault(name, {"calls": 0, "pages": 0, "device_ms": 0.0,
                                  "host_ms": 0.0})
        r["calls"] += 1
        r["pages"] += n
        r["device_ms"] += start.elapsed_time(end)
        r["host_ms"] += wall * 1e3
    return out


def churn_run(name, cfg, params, device, traffic, events=(), islands=None,
              cache="paged", request=None, trigger=None):
    """One run of the churn mesh: the traffic submitted, ``events`` (tick
    -> fn(orch)) fired after their tick, ``trigger(orch)`` called after
    every tick until it returns a record of what it did, the launch
    counters zeroed just before and read just after, and every check that
    does not need a second run: each request resolved, finite logits and
    caches, K/V import bits, pool audits, kernel launches. Returns the
    run's record."""
    import torch

    from repro_torch.core.waves import Request
    orch, bats, flags = churn_stack(cfg, params, device,
                                    islands or churn_islands(), cache)
    streams, rows, frozen = _capture_orch(orch, bats)
    log = {"events": [], "pages_checked": 0, "pages_unequal": 0}
    undo = _checked_pool_io(bats, log)
    reqs = ([request] if request is not None else
            [(Request(query=q, priority="primary", sensitivity_override=s),
              8) for q, s in traffic])
    rids = [orch.submit(r, max_new_tokens=n) for r, n in reqs]
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    ev, k, fired = dict(events), 0, None
    try:
        while orch.busy() and orch.tick_stats["ticks"] < 4000:
            orch.tick()
            k += 1
            if k in ev:
                ev.pop(k)(orch)
            if trigger is not None and fired is None:
                fired = trigger(orch)
                if fired is not None:
                    fired["tick"] = k
        torch.cuda.synchronize()
    finally:
        undo()
    wall = time.perf_counter() - t0
    launches = read_launches()
    io = _io_ms(log)
    faults = []
    if orch.busy():
        faults.append("did not drain within 4000 ticks")
    stranded = [r for r in rids if orch.results.get(r) is None]
    if stranded:
        faults.append(f"stranded or rejected {stranded}")
    if not all(bool(f) for f in flags):
        faults.append("non-finite logits")
    want = expected_launches(bats.values())
    if launches != want:
        faults.append(f"launches {launches}, expected {want}")
    if trigger is not None and fired is None:
        faults.append("the trigger never fired")
    if log["pages_unequal"]:
        faults.append(f"{log['pages_unequal']} of {log['pages_checked']} "
                      f"imported pages differ from their records")
    for iid, b in orch.batchers.items():
        pool = getattr(b, "pool", None)
        if pool is not None and not (pool.audit() and pool.in_use() == 0):
            faults.append(f"pool of {iid} holds {pool.in_use()} pages")
    mism = sum(b.pool.stats["import_tier_mismatch"] for b in bats.values()
               if hasattr(b, "pool"))
    if mism:
        faults.append(f"{mism} cross-tier imports")
    page_bytes = 0
    b0 = next(iter(bats.values()))
    if hasattr(b0, "pool"):
        page_bytes = sum(t[0].numel() * t.element_size()
                         for layer in b0.pool.pages for t in layer.values())
    mig = {k: sum(b.migration_stats[k] for b in bats.values())
           for k in ("exports", "imports", "imported_pages",
                     "import_attach_hits", "recomputes")}
    ts = orch.tick_stats
    rec = {"phase": name, "model": cfg.name, "cache": cache,
           "requests": len(rids), "ticks": ts["ticks"],
           "events": sorted(dict(events)), "wall_s": wall,
           "work_clock": sum(b.work_clock for b in bats.values()),
           "migrations_started": ts["migrations_started"],
           "migrations": ts["migrations"], "recomputes": ts["recomputes"],
           "failovers": ts["failovers"], "restarts": ts["restarts"],
           "migration_returns": ts["migration_returns"],
           "batcher_migration_stats": mig,
           "pages_shipped": mig["imported_pages"],
           "largest_import_pages": max(
               [n for nm, n, *_ in log["events"] if nm == "write_pages"],
               default=0),
           "trigger": fired,
           "page_bytes": page_bytes,
           "bytes_shipped": mig["imported_pages"] * page_bytes,
           "imported_pages_checked": log["pages_checked"],
           "export_gathers": io.get("read_pages"),
           "import_scatters": io.get("write_pages"),
           "import_tier_mismatch": mism,
           "launches": {k: v for k, v in launches.items() if v},
           "faults": faults}
    return {"rec": rec, "rids": rids, "streams": streams, "rows": rows,
            "frozen": frozen, "orch": orch, "bats": bats, "faults": faults}


def _hold_runs(base, other, tol, keyed=False):
    """Hold ``other``'s streams to ``base``'s under the near-tie rule:
    those whose final stream ran on the same prompt text in both runs (a
    move to an island that sanitizes differently restarts the request on
    another text) and, when sampling (``keyed``), drew from the same
    stream seed. When sampling, a ticket frozen while still queued carries
    no key, so the destination issues one: every other stream must be
    compared, and every stream that left an island with a key must finish
    with that key's seed."""
    bs, os_ = base["streams"], other["streams"]
    rids = [r for r in bs if r in os_
            and bs[r]["prompt"] == os_[r]["prompt"]
            and (not keyed or bs[r]["seed"] == os_[r]["seed"])]
    faults = []
    if keyed:
        frozen = other["frozen"]
        lost = sorted(r for r, seed in frozen["seed"].items()
                      if os_.get(r, {}).get("seed") != seed)
        if lost:
            faults.append(f"requests {lost} thawed without their key")
        skipped = sorted(set(os_) - set(rids) - frozen["queued"])
        if skipped:
            faults.append(f"requests {skipped} were not frozen while "
                          f"queued, yet ran on another prompt or seed")
    want = {r: bs[r]["tokens"] for r in rids}
    got = {r: os_[r]["tokens"] for r in rids}
    held, st = hold_streams(want, base["rows"], got, other["rows"], tol,
                            what=("churn", "undisturbed"))
    return faults + held, {
        "streams": len(os_), "streams_compared": len(rids),
        "migrated_compared": sum(1 for r in rids if os_[r]["migrations"]),
        "streams_identical": sum(want[r] == got[r] for r in rids),
        "diverged_at_near_tie": st["diverged"],
        "max_row_gap": max(st["gaps"]), "row_tol": tol}


# the churn run's events: the reference's churn_ab drains the laptop after
# tick 2 and fails the desktop after tick 5. With the long notes in the
# traffic, the desktop's slots hold notes in prefill for dozens of ticks,
# so every request drained off the laptop is still queued there when the
# desktop fails, and no page would ever be imported: the port fails the
# nas, which holds notes in prefill too, so that the run takes both a
# failover and migrations that ship pages (the schedule does not depend on
# the weights or widths)
CHURN_EVENTS = {2: ("drain_island", "laptop"), 5: ("fail_island", "nas")}


def churn_phase(cfg, params, device):
    """The reference's ``churn_ab`` on the port at full width: the churn
    traffic once undisturbed and once with ``CHURN_EVENTS``, fused chunked
    paged batchers (K2 + K1); then one note's move on its own."""
    traffic = churn_traffic()
    base = churn_run("churn (undisturbed)", cfg, params, device, traffic)
    churn = churn_run("churn", cfg, params, device, traffic,
                      events={k: (lambda o, f=f, i=i: getattr(o, f)(i))
                              for k, (f, i) in CHURN_EVENTS.items()})
    faults = base["faults"] + churn["faults"]
    held, st = _hold_runs(base, churn, CHURN_LOGIT_TOL)
    faults += held
    rec = churn["rec"]
    if st["streams_compared"] != len(churn["rids"]):
        faults.append(f"{st['streams_compared']} of {len(churn['rids'])} "
                      f"streams comparable")
    if rec["migrations"] < 1 or rec["pages_shipped"] < 1:
        faults.append("no migration shipped pages")
    if rec["failovers"] < 1:
        faults.append("no failover")
    w0, w1 = base["rec"]["work_clock"], rec["work_clock"]
    if not w0 <= w1 <= 3 * w0:
        faults.append(f"churn work clock {w1} outside [1, 3] x {w0}")
    base["rec"].pop("faults")
    rec.pop("faults")
    emit(base["rec"])
    emit({**rec, **st, "events": {k: list(v) for k, v in
                                  CHURN_EVENTS.items()},
          "work_clock_over_undisturbed": w1 / w0})
    if faults:
        raise AssertionError("churn: " + "; ".join(faults))
    note_drain(cfg, params, device, traffic, base)
    note_move(cfg, params, device)


def _drain_decoding_note(note):
    """A churn trigger: once some island holds ``note`` in decode, drain
    that island, so that the note moves with its pages through the
    orchestrator (routing, the migration token budget, the tier rule)."""
    def trigger(orch):
        for iid, b in orch.batchers.items():
            for s in b.slots:
                if s.active and s.prompt == note and s.pos > s.prompt_len:
                    orch.drain_island(iid)
                    return {"island": iid, "kv_tokens": s.pos,
                            "pages": len(s.pages)}
        return None

    return trigger


def note_drain(cfg, params, device, traffic, base):
    """The churn traffic with one event: the island that holds the longest
    note is drained once the note is in decode. The note must arrive in
    one import of all its pages, and every stream must hold to the
    undisturbed run's."""
    note = max((q for q, _p in long_prompts()), key=len)
    run = churn_run("churn note drain", cfg, params, device, traffic,
                    trigger=_drain_decoding_note(note))
    faults = run["faults"]
    held, st = _hold_runs(base, run, CHURN_LOGIT_TOL)
    faults += held
    rec = run["rec"]
    if st["streams_compared"] != len(run["rids"]):
        faults.append(f"{st['streams_compared']} of {len(run['rids'])} "
                      f"streams comparable")
    fired = rec["trigger"] or {}
    if rec["largest_import_pages"] < fired.get("pages", 1):
        faults.append(f"no import shipped the drained note's "
                      f"{fired.get('pages')} pages: the largest shipped "
                      f"{rec['largest_import_pages']}")
    rec.pop("faults")
    emit({**rec, **st})
    if faults:
        raise AssertionError("churn note drain: " + "; ".join(faults))


def note_move(cfg, params, device, moves=2):
    """The longest note (tier 1) frozen after its prefill and its first
    decode step and imported into a fresh fused batcher, ``moves`` times
    over (each move's ticket is dropped before the next, as the
    orchestrator drops one after its import, so a later move reuses the
    host allocations of an earlier one): the pages and bytes a move
    ships, each move's export gather and import scatter times, every
    imported page read back against its record, and K2/K1 once per layer
    of every dispatch of all the batchers."""
    import torch

    from repro_torch.serving.batcher import PagedContinuousBatcher
    note = max((q for q, _p in long_prompts()), key=len)
    kw = dict(params=params, num_slots=1, max_len=2048, device=device)
    bats, rows, faults = [], [], []
    torch.cuda.synchronize()
    zero_launches()
    for _ in range(moves):
        a, b = (PagedContinuousBatcher(cfg, **kw) for _ in range(2))
        bats += [a, b]
        log = {"events": [], "pages_checked": 0, "pages_unequal": 0}
        rid = a.submit(note, max_new_tokens=8, trust_tier=1)
        while not (a.slots[0].active
                   and a.slots[0].pos > a.slots[0].prompt_len):
            a.tick()
        undo = _checked_pool_io({"a": a, "b": b}, log)
        try:
            t = a.freeze_request(rid)
            nr = b.submit_ticket(t)
            done = b.run_until_done()
            torch.cuda.synchronize()
        finally:
            undo()
        io = _io_ms(log)
        if done.get(nr) is None or b.migration_stats["imports"] != 1:
            faults.append(f"the note did not thaw by import: "
                          f"{b.migration_stats}")
        if log["pages_unequal"] or log["pages_checked"] != len(t.pages):
            faults.append(f"{log['pages_unequal']} of "
                          f"{log['pages_checked']} imported pages differ "
                          f"from their records")
        rows.append({"kv_tokens": t.kv_tokens, "pages": len(t.pages),
                     "bytes_moved": sum(d.nbytes for r in t.pages
                                        for d in r.data),
                     "export_gather": io.get("read_pages"),
                     "import_scatter": io.get("write_pages"),
                     "imported_pages_checked": log["pages_checked"]})
        del t
    launches = read_launches()
    want = expected_launches(bats)
    if launches != want:
        faults.append(f"launches {launches}, expected {want}")
    for x in bats:
        if not (x.pool.audit() and x.pool.in_use() == 0):
            faults.append("a pool kept pages")
    emit({"phase": "churn note move", "moves": rows,
          "launches": {k: v for k, v in launches.items() if v}})
    if faults:
        raise AssertionError("churn note move: " + "; ".join(faults))


def churn_downhill_phase(cfg, params, device):
    """``churn_ab``'s downhill leg: tier-1 KV (sensitivity 0.85) drained
    off a personal island toward a tier-2 edge island must arrive with no
    page import and at least one recompute."""
    from repro_torch.core.waves import Request
    req = (Request(query="summarize my medical history",
                   priority="secondary", sensitivity_override=0.85,
                   prev_privacy=0.9), 8)
    kw = dict(islands=churn_islands(downhill=True), request=req)
    base = churn_run("churn downhill (undisturbed)", cfg, params, device,
                     None, **kw)
    run = churn_run("churn downhill", cfg, params, device, None,
                    events={2: lambda o: o.drain_island("laptop")}, **kw)
    faults = base["faults"] + run["faults"]
    held, st = _hold_runs(base, run, CHURN_LOGIT_TOL)
    faults += held
    edge = run["bats"]["edge"]
    got = {"edge_imports": edge.migration_stats["imports"],
           "edge_imported_pages": edge.pool.stats["imported_pages"],
           "edge_recomputes": edge.migration_stats["recomputes"]}
    if run["rec"]["migrations_started"] < 1 or got["edge_imports"] \
            or got["edge_imported_pages"] or got["edge_recomputes"] < 1:
        faults.append(f"tier rule not exercised or broken: {got}")
    run["rec"].pop("faults")
    emit({**run["rec"], **st, **got})
    if faults:
        raise AssertionError("churn downhill: " + "; ".join(faults))


def churn_stacked_phase(cfg, params, device):
    """The same drain (laptop, after tick 2) on stacked batchers: the
    frozen requests' dense rows thaw on the other islands (K4 prefill, K3
    decode)."""
    traffic = churn_traffic()
    base = churn_run("churn stacked (undisturbed)", cfg, params, device,
                     traffic, cache="stacked")
    run = churn_run("churn stacked", cfg, params, device, traffic,
                    events={2: lambda o: o.drain_island("laptop")},
                    cache="stacked")
    faults = base["faults"] + run["faults"]
    held, st = _hold_runs(base, run, CHURN_LOGIT_TOL)
    faults += held
    if run["rec"]["migrations"] < 1:
        faults.append("no dense row was imported")
    run["rec"].pop("faults")
    emit({**run["rec"], **st})
    if faults:
        raise AssertionError("churn stacked: " + "; ".join(faults))


def _decode_rows(b, logits, ready):
    """The rows, on the host, whose argmax gives each ready slot of ``b``
    its next token: the logits, or at temperature > 0 the perturbed scores
    of each slot's sampling key."""
    import torch

    from repro_torch.serving import sampling
    got = logits.index_select(0, torch.tensor(ready, device=logits.device))
    if b.temperature > 0.0:
        keys = torch.tensor([b.slots[si].sample_key for si in ready],
                            dtype=torch.int64, device=logits.device)
        got = sampling.perturbed_scores(got, keys, b.temperature)
    return got.float().cpu()


def _wrap_sample_ready(b, store, rid_of):
    """Record the row behind every token ``b._sample_ready`` picks, keyed
    by (``rid_of(batcher request id)``, token index), and hold each pick
    to its row's argmax: a sampler that ignored the temperature or a
    slot's key would pick another token than the perturbed scores'."""
    sample_ready = b._sample_ready

    def sampled(logits, ready):
        got = _decode_rows(b, logits, ready)
        keys = [(rid_of(b.slots[si].request_id),
                 len(b.slots[si].carried) + len(b.slots[si].generated))
                for si in ready]
        out = sample_ready(logits, ready)
        for n, si in enumerate(ready):
            store[keys[n]] = got[n]
            if out[si] != int(got[n].argmax()):
                raise AssertionError(
                    f"slot {si} sampled {out[si]}, the argmax of its row "
                    f"is {int(got[n].argmax())} (temperature "
                    f"{b.temperature})")
        return out

    b._sample_ready = sampled


def _capture_sampled(b, store):
    """``_capture_fused`` for the first tokens (greedy whatever the
    temperature), and the perturbed scores behind every sampled token."""
    _capture_fused(b, store)
    _wrap_sample_ready(b, store, lambda rid: rid)


def stochastic_phase(cfg, params, device, replay_cfg, runs_on):
    """The quickstart traffic through the fused paged batchers at
    ``temperature`` 0.8, ``seed`` 7, serving ``cfg``: two runs give
    identical streams; a run with ``drain_island("laptop")`` after tick 2
    gives the same streams under the near-tie rule (held on the perturbed
    scores); and the card and CPU replay of the four queries
    (``replay_cfg`` on ``runs_on``) agree under it."""
    import torch
    faults, runs = [], []
    for drain in (False, False, True):
        orch, bats, rids, flags = serving_stack(
            cfg, params, device, 2048, temperature=TEMPERATURE,
            seed=SAMPLE_SEED)
        streams, rows, frozen = _capture_orch(orch, bats)
        torch.cuda.synchronize()
        zero_launches()
        k = 0
        while orch.busy() and orch.tick_stats["ticks"] < 4000:
            orch.tick()
            k += 1
            if drain and k == 2:
                orch.drain_island("laptop")
        torch.cuda.synchronize()
        launches = read_launches()
        want = expected_launches(bats.values())
        if launches != want:
            faults.append(f"run {len(runs)}: launches {launches}, expected "
                          f"{want}")
        if orch.busy() or any(orch.results.get(r) is None for r in rids):
            faults.append(f"run {len(runs)}: unresolved requests")
        if not all(bool(f) for f in flags):
            faults.append(f"run {len(runs)}: non-finite logits")
        runs.append({"streams": streams, "rows": rows, "frozen": frozen,
                     "orch": orch, "launches": launches})
    if runs[0]["streams"] != runs[1]["streams"]:
        faults.append("two runs with one seed gave different streams")
    held, st = _hold_runs(runs[0], runs[2], REPLAY_LOGIT_TOL / TEMPERATURE,
                          keyed=True)
    faults += held
    ts = runs[2]["orch"].tick_stats
    if ts["migrations_started"] < 1 or st["migrated_compared"] < 1:
        faults.append(f"the drain moved no stream that kept its key: "
                      f"{st}")
    st["frozen_while_queued"] = len(runs[2]["frozen"]["queued"])
    emit({"phase": "stochastic", "model": cfg.name,
          "layers": cfg.num_layers,
          "temperature": TEMPERATURE, "seed": SAMPLE_SEED,
          "streams": len(runs[0]["streams"]),
          "repeat_identical": runs[0]["streams"] == runs[1]["streams"],
          "launches": {k: v for k, v in runs[0]["launches"].items() if v},
          "drain": {k: ts[k] for k in ("migrations_started", "migrations",
                                       "recomputes", "restarts",
                                       "migration_returns")},
          **st})
    if faults:
        raise AssertionError("stochastic: " + "; ".join(faults))
    from repro_torch.serving.batcher import PagedContinuousBatcher
    replay("replay stochastic", replay_cfg, runs_on,
           lambda dev, p: PagedContinuousBatcher(
               replay_cfg, params=p, num_slots=4, max_len=256, device=dev,
               temperature=TEMPERATURE, seed=SAMPLE_SEED),
           _capture_sampled, tol=REPLAY_LOGIT_TOL / TEMPERATURE,
           first_tol=REPLAY_LOGIT_TOL)


# -------------------------------------------------------------------- main

# ------------------------------------- observation and degradation phases

def _orch_streams(orch, batchers):
    """Record, per orchestrator request id, the stream each request
    finished with. The tokens are read where ``_finish_slot`` reads them
    anyway (its tail materialization), so no readback is added."""
    out = {}
    for iid, b in batchers.items():
        def record(si, b=b, iid=iid, finish=b._finish_slot):
            b._materialize_slot(si)
            s = b.slots[si]
            rid = orch._local_inflight[(iid, s.request_id)][0].rid
            out[rid] = list(s.carried) + list(s.generated)
            finish(si)

        b._finish_slot = record
    return out


def _device_spans(prof, parsed=False):
    """The device activity of a finished torch profile as sorted (start
    ns, end ns, name), without the dispatch ranges' device-side
    annotations (they are not kernels), and the parsed events when
    ``parsed`` (None otherwise). Only the matmul split by dispatch reads
    the parsed event tree; the raw kineto events give the same spans
    without parsing every host op (``prof.events()``: ~50 s a main path
    run)."""
    from torch.autograd import DeviceType
    labels = set(BLOCK_RANGES.values())
    if parsed:
        events = prof.events()
        return sorted((int(e.time_range.start * 1000),
                       int(e.time_range.end * 1000), e.name)
                      for e in events if e.device_type == DeviceType.CUDA
                      and not getattr(e, "is_user_annotation", False)
                      and e.name not in labels), events
    spans = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA or e.name() in labels \
                or e.is_user_annotation():
            continue
        spans.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                      e.name()))
    return sorted(spans), None


def traced_phase(cfg, params, device, base, main_launches,
                 wall_unprofiled):
    """The main path's traffic with a ``Tracer`` on the orchestrator and
    every batcher, profiled as ``profile main_path``'s untraced run
    (``base``) was: the streams, work clocks, K1/K2 launches and
    device-to-host copies must be identical (tracing is a dict append and
    reads nothing back), and the launches those of the ``main_path`` run.
    Then the journal itself: span conservation on every batcher, one
    terminal per request, one first token per completed request, and its
    Chrome trace written to ``build/`` and read back."""
    from repro_torch.obs import Tracer, write_chrome_trace
    tracer = Tracer()
    run = profile_phase("main_path traced", cfg, params, device,
                        wall_unprofiled, streams=True, tracer=tracer)
    orch, rids = run["orch"], run["rids"]
    faults = []
    if orch.busy() or any(orch.results.get(r) is None for r in rids):
        faults.append("the traffic did not complete")
    if not all(bool(f) for f in run["flags"]):
        faults.append("non-finite logits")
    for key in ("streams", "work", "launches", "dtoh"):
        if run[key] != base[key]:
            faults.append(f"traced {key} differ: {run[key]} vs {base[key]}")
    if run["launches"] != main_launches:
        faults.append(f"launches {run['launches']} differ from the "
                      f"main_path run's {main_launches}")
    cons = tracer.conservation_ok(run["batchers"])
    if not cons["all"]:
        faults.append(f"span work not conserved: {cons}")
    if not tracer.terminals_exactly_once(rids):
        faults.append("a request did not resolve exactly once")
    firsts = tracer.first_token_counts()
    if set(firsts.values()) != {1} or len(firsts) != len(orch.log):
        faults.append(f"first tokens {firsts} for {len(orch.log)} "
                      f"completed requests")
    path = ROOT / "build" / "main_path_trace.json"
    path.parent.mkdir(exist_ok=True)
    n = write_chrome_trace(tracer, str(path))
    back = json.loads(path.read_text())["traceEvents"]
    if len(back) != n:
        faults.append(f"the Chrome trace holds {len(back)} of {n} events")
    emit({"phase": "traced main_path", "requests": len(rids),
          "streams_identical": run["streams"] == base["streams"],
          "work_clocks": run["work"],
          "launches": {k: v for k, v in run["launches"].items() if v},
          "dtoh_copies_untraced": base["dtoh"],
          "dtoh_copies_traced": run["dtoh"],
          "events": len(tracer), "chrome_trace_events": len(back),
          "chrome_trace": str(path.relative_to(ROOT)),
          "conservation": cons["all"],
          "wall_s_profiled_untraced": base["wall"],
          "wall_s_profiled_traced": run["wall"]})
    if faults:
        raise AssertionError("traced main_path: " + "; ".join(faults))


def _tick_walls(cfg, params, device, profiled):
    """The main path's traffic on fresh batchers with each
    ``orch.tick()`` timed on the host clock, and with one
    ``DispatchProfiler`` per batcher when ``profiled``. Returns (streams,
    tick ns, wall, profilers, orch)."""
    import torch

    from repro_torch.obs import DispatchProfiler
    orch, batchers, _rids, _flags = serving_stack(cfg, params, device, 2048)
    streams = _orch_streams(orch, batchers)
    profs = {}
    if profiled:
        for iid, b in batchers.items():
            b.profiler = profs[iid] = DispatchProfiler()
    torch.cuda.synchronize()
    tick_ns = []
    t0 = time.perf_counter()
    while orch.busy() and orch.tick_stats["ticks"] < 4000:
        t = time.perf_counter_ns()
        orch.tick()
        tick_ns.append(time.perf_counter_ns() - t)
    torch.cuda.synchronize()
    return streams, tick_ns, time.perf_counter() - t0, profs, orch


def host_split_phase(cfg, params, device):
    """The main path's traffic once unprofiled and once with one
    ``DispatchProfiler`` per batcher, back to back, each orchestrator
    tick timed: each island's phase report, and the profiled run split
    into the batchers' host_plan / bucket / dispatch_submit / device_sync
    and the orchestrator's own time (routing, MIST, telemetry: the tick
    wall less the profiled batcher ticks). The two runs' streams must be
    equal. It serves the ``SCHED_LAYERS`` cut: the split is of the
    host's work a tick, which the depth scales but does not reorder."""
    from repro_torch.obs import DispatchProfiler
    plain, plain_ns, plain_wall, _p, _o = _tick_walls(cfg, params, device,
                                                      False)
    streams, tick_ns, wall, profs, orch = _tick_walls(cfg, params, device,
                                                      True)
    if streams != plain:
        raise AssertionError("host split: the profiled run's streams "
                             "differ from the unprofiled run's")
    total = sum(tick_ns)
    phases = {p: sum(pr.totals[p] for pr in profs.values())
              for p in DispatchProfiler.PHASES}
    batcher_ns = sum(pr.total_ns for pr in profs.values())
    split_ms = {p: v / 1e6 for p, v in phases.items()}
    split_ms["orchestrator"] = (total - batcher_ns) / 1e6
    emit({"phase": "profile host split", "model": cfg.name,
          "layers": cfg.num_layers,
          "requests": len(streams), "ticks": orch.tick_stats["ticks"],
          "batcher_ticks": sum(len(pr.ticks) for pr in profs.values()),
          "dispatches": sum(pr.dispatches for pr in profs.values()),
          "islands": {iid: pr.report() for iid, pr in profs.items()},
          "tick_wall_ms": total / 1e6, "split_ms": split_ms,
          "split_frac": {k: v * 1e6 / total for k, v in split_ms.items()},
          "wall_s_profiled": wall, "wall_s_unprofiled": plain_wall,
          "tick_wall_ms_unprofiled": sum(plain_ns) / 1e6,
          "streams_identical": True})


# the depth of smollm-135m's serving phases (the main path, its profile,
# traced and constant-shape runs, the stacked, prefill="full", unfused
# and per-request paths, fp8 caches, the replays): its first 15 of 30
# layers at full widths. Their dispatches are host-bound (idle 88-93%),
# so their time scales with the layers' launches; at full depth they
# took ~154 s of the script's time limit, at 15 layers ~90 s, and P14c's
# training of five more configurations needs the difference. The train
# group keeps all 30 layers
MAIN_LAYERS = 15

# the depth of the smollm phases held to the port's scheduling on the
# CPU or to a second run on the card, not to the served model's numbers
# (degradation, trace harness, leakage, the constant-shape A/B, the
# oversubscribed pool, churn, stochastic): its first 4 layers at
# full widths. Those checks depend on neither the depth nor the
# weights; at full depth the phases took ~280 s of the script's time
# limit, at 8 layers ~94 s, which the P13d group's gloo gathers now
# need
SCHED_LAYERS = 4
# the serving paths of the configs after smollm (mamba2, recurrentgemma
# and the P12a four: the auto path, its profile, the per-request path,
# paligemma's prefix paths) serve their first 4 layers at full widths
# (recurrentgemma 6: two whole pattern cycles); a layer's launches and
# device time repeat, and their full depths (18-48 layers) took ~230 s
# of the script's time limit, 8 layers ~71 s. Their replays and the
# kernel phase keep their own shapes
SERVE_LAYERS = 4

# benchmarks/degradation.py's scenario (ported here: it imports the JAX
# package). DEADLINE_WORK is above the fault-free run's total mesh work,
# so its two deadline requests can only expire in the faulted run
DEADLINE_WORK = 520.0


def _deg_workload():
    out = []
    for i in range(6):
        out.append((f"primary interactive request number {i} with some "
                    f"padding text", "primary", math.inf))
    for i in range(2):
        out.append((f"burstable background job {i} crunching a batch",
                    "burstable", math.inf))
    for i in range(2):
        out.append((f"primary deadline-tagged request {i} that must "
                    f"finish soon", "primary", DEADLINE_WORK))
    return out


def _burst_submit(wave):
    """A burst wave: 14 short sheddable requests, unique per wave."""
    from repro_torch.core.waves import Request

    def fire(orch):
        for k in range(14):
            orch.submit(Request(query=f"burst w{wave} req {k} spam",
                                priority="secondary",
                                sensitivity_override=0.9),
                        max_new_tokens=4)
    return fire


def _deg_plan():
    """benchmarks/degradation.py's ``make_plan``: the laptop slowed x4 at
    t1, bursts at t3 and t4, telemetry stale t6-t8, the desktop drained at
    t9 and killed at t10 (tickets in flight), the laptop recovered at
    t14."""
    from repro_torch.serving.degrade import FaultEvent, FaultPlan
    plan = FaultPlan()
    plan.add(FaultEvent(1, "slowdown", island="laptop", factor=4))
    plan.add(FaultEvent(3, "burst", submit=_burst_submit(1)))
    plan.add(FaultEvent(4, "burst", submit=_burst_submit(2)))
    plan.add(FaultEvent(6, "telemetry_stale", on=True))
    plan.add(FaultEvent(8, "telemetry_stale", on=False))
    plan.add(FaultEvent(9, "drain", island="desktop"))
    plan.add(FaultEvent(10, "kill", island="desktop"))
    plan.add(FaultEvent(14, "recover", island="laptop"))
    return plan


def degradation_run(cfg, params, device, plan, max_ticks=600):
    """``drive`` of benchmarks/degradation.py on the port: three personal
    islands, max_len 96, ``debug_audit`` (every pool audited at every
    tick), a ``Tracer``, the overload ladder (queue watermark 12,
    backpressure at 100), the workload and whatever bursts the plan
    injects, with every stream and the logits behind it captured."""
    import torch

    from repro_torch.core.islands import IslandRegistry, personal_island
    from repro_torch.core.lighthouse import Lighthouse
    from repro_torch.core.mist import MIST
    from repro_torch.core.tide import TIDE
    from repro_torch.core.waves import WAVES, Policy, Request
    from repro_torch.obs import Tracer
    from repro_torch.serving.degrade import OverloadPolicy
    from repro_torch.serving.engine import (TickOrchestrator,
                                            build_island_batchers)
    reg = IslandRegistry()
    for iid, lat in (("laptop", 120), ("desktop", 150), ("nas", 200)):
        reg.register(personal_island(iid, latency_ms=lat,
                                     capacity_units=2.0),
                     reg.attestation_token(iid))
    tide = TIDE(reg, straggler_patience=3)
    lh = Lighthouse(reg)
    for i in reg.all():
        lh.heartbeat(i.island_id)
    waves = WAVES(MIST(), tide, lh, Policy())
    bats = build_island_batchers(cfg, reg, cache="paged", max_len=96,
                                 slots_per_capacity_unit=2.0, params=params,
                                 device=device)
    every = dict(bats)      # a killed island leaves orch.batchers
    tracer = Tracer()
    orch = TickOrchestrator(
        waves, reg, bats, decode_ticks_per_tick=1, migration_token_budget=64,
        overload=OverloadPolicy(queue_watermark=12, backpressure_pct=100),
        debug_audit=True, tracer=tracer, device=device)
    streams, rows, frozen = _capture_orch(orch, bats)
    rids = [orch.submit(Request(query=q, priority=pr, deadline_ms=dl,
                                sensitivity_override=0.9),
                        max_new_tokens=16) for q, pr, dl in _deg_workload()]
    zero_launches()
    while orch.busy() and orch.tick_stats["ticks"] < max_ticks:
        if plan is not None:
            plan.step(orch)
        orch.tick()
    torch.cuda.synchronize()
    launches = read_launches()
    all_rids = list(range(orch._next_rid))
    reasons: dict = {}
    for d in orch.rejected:
        reasons[str(d.reason)] = reasons.get(str(d.reason), 0) + 1
    ts = orch.tick_stats
    return {
        "streams": streams, "rows": rows, "frozen": frozen,
        "workload_rids": rids,
        "texts": {r: (orch.results[r].text if orch.results.get(r)
                      else None) for r in all_rids},
        "ticks": ts["ticks"], "work_clock": orch.mesh_work,
        "expired": ts["expired"], "shed": ts["shed"],
        "backpressure_rejects": ts["backpressure_rejects"],
        "hedges": ts["hedges"], "failovers": ts["failovers"],
        "migrations_started": ts["migrations_started"],
        "reject_reasons": reasons,
        "unresolved": sum(1 for r in all_rids if r not in orch.results),
        "terminals_exactly_once": tracer.terminals_exactly_once(all_rids),
        "audits_ok": all(b.pool.audit() and b.pool.in_use() == 0
                         for b in orch.batchers.values()),
        "applied": list(plan.applied) if plan is not None else [],
        "launches": launches,
        "launches_expected": expected_launches(every.values()),
        "events": len(tracer)}


def degradation_phase(cfg, params, device):
    """benchmarks/degradation.py at full width on the card, fault-free and
    under its fault plan, held to the benchmark's deterministic checks,
    its quota attack A/B included (the scheduling-interference attack
    with per-tier quotas off, the positive control, and on). The faulted
    run's streams are held to the fault-free run's under the churn
    phase's near-tie rule: a hedge, a failover or a recompute thaw
    rebuilds K/V with the prefill kernel, and a destination's other batch
    changes the key-walk split and cuBLAS's algorithm."""
    from repro_torch.privacy import Mitigations, run_attack_suite
    from repro_torch.serving.degrade import RejectReason
    base = degradation_run(cfg, params, device, None)
    plan = _deg_plan()
    fault = degradation_run(cfg, params, device, plan)
    n_deadline = sum(1 for _q, _p, dl in _deg_workload()
                     if math.isfinite(dl))
    faults, st = _hold_runs(base, fault, CHURN_LOGIT_TOL)
    both = [r for r in fault["workload_rids"]
            if fault["texts"].get(r) is not None
            and base["texts"].get(r) is not None]
    checks = {
        "plan_fully_applied": len(fault["applied"]) == len(plan.events),
        "zero_stranded":
            fault["unresolved"] == 0 and base["unresolved"] == 0
            and fault["terminals_exactly_once"]
            and base["terminals_exactly_once"],
        "expired_within_bound":
            1 <= fault["expired"] <= n_deadline and base["expired"] == 0,
        "non_expired_streams_held": len(both) >= 6 and not faults,
        "shed_exercised": fault["shed"] >= 1 and base["shed"] == 0,
        "backpressure_exercised":
            fault["backpressure_rejects"] >= 1
            and base["backpressure_rejects"] == 0,
        "hedge_exercised": fault["hedges"] >= 1 and base["hedges"] == 0,
        "mid_migration_failover": fault["failovers"] >= 1,
        "audits_ok": fault["audits_ok"] and base["audits_ok"],
        "typed_reject_reasons": set(fault["reject_reasons"]) <= {
            str(m) for m in RejectReason},
        "launches": all(r["launches"] == r["launches_expected"]
                        for r in (base, fault)),
    }
    quota = {}
    for label in ("off", "on"):
        r = run_attack_suite(cfg, params, getattr(Mitigations, label)(),
                             include={"scheduling_interference"},
                             device=device)["scheduling_interference"]
        quota[label] = {"accuracy": r.accuracy, "chance": r.chance,
                        "n_test": r.n_test}
    checks["quota_attack_mitigated"] = (
        quota["on"]["accuracy"] <= quota["on"]["chance"] + LEAK_SLACK)
    checks["quota_attack_positive_control"] = (
        quota["off"]["accuracy"]
        >= quota["off"]["chance"] + LEAK_POSITIVE_MARGIN)
    skip = ("streams", "rows", "frozen", "texts", "workload_rids",
            "launches_expected")
    emit({"phase": "degradation", "model": cfg.name,
          "fault_free": {k: v for k, v in base.items() if k not in skip},
          "faulted": {k: v for k, v in fault.items() if k not in skip},
          "completed_in_both": len(both), **st, "stream_faults": faults,
          "quota_attack": quota, "checks": checks})
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"degradation checks failed: {failed}")


# benchmarks/trace.py's run: a seeded trace with default_slo_classes(),
# base rate 4, its tenants, tiers and prefix reuse, batch-class shedding
# over a mesh prefill backlog of 8000 tokens
TRACE_N = 300
TRACE_BASE_RATE = 4.0
TRACE_SHED_BACKLOG = 8000


def trace_arm(cfg, params, device, n, slo_aware):
    """One arm of the trace harness: benchmarks/trace.py's
    ``_build_mesh`` (three personal islands, max_len 96, fair tenancy,
    class-aware batchers exactly when ``slo_aware``) with a ``Tracer``,
    the seeded trace streamed through it. Returns its deterministic
    result row (and the wall time)."""
    import torch

    from repro_torch.core.islands import IslandRegistry, personal_island
    from repro_torch.core.lighthouse import Lighthouse
    from repro_torch.core.mist import MIST
    from repro_torch.core.tide import TIDE
    from repro_torch.core.tracegen import (ArrivalSpec, TraceSpec,
                                           default_slo_classes,
                                           generate_trace, stream_trace)
    from repro_torch.core.waves import WAVES, Policy
    from repro_torch.obs import Tracer
    from repro_torch.obs.metrics import jain_index
    from repro_torch.serving.degrade import OverloadPolicy
    from repro_torch.serving.engine import (TickOrchestrator,
                                            build_island_batchers)
    spec = TraceSpec(n_requests=n, seed=0, classes=default_slo_classes(),
                     arrivals=ArrivalSpec(base_rate=TRACE_BASE_RATE))
    reg = IslandRegistry()
    for iid, lat in (("laptop", 120), ("desktop", 150), ("nas", 200)):
        reg.register(personal_island(iid, latency_ms=lat,
                                     capacity_units=2.0),
                     reg.attestation_token(iid))
    tide = TIDE(reg)
    lh = Lighthouse(reg)
    for i in reg.all():
        lh.heartbeat(i.island_id)
    waves = WAVES(MIST(), tide, lh, Policy(on_infeasible="queue_local"))
    bats = build_island_batchers(cfg, reg, cache="paged", max_len=96,
                                 slots_per_capacity_unit=2.0, params=params,
                                 class_aware=slo_aware, device=device)
    tracer = Tracer()
    orch = TickOrchestrator(
        waves, reg, bats, decode_ticks_per_tick=4,
        overload=OverloadPolicy(backlog_watermark=TRACE_SHED_BACKLOG,
                                shed_priorities=("burstable",)),
        slo_classes=spec.slo_classes(), slo_aware=slo_aware,
        fair_tenancy=True, tracer=tracer, device=device)
    t0 = time.perf_counter()
    rids = stream_trace(orch, generate_trace(spec))
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return {"n": len(rids), "ticks": orch.tick_stats["ticks"],
            "work_clock": orch.mesh_work,
            "unresolved": sum(1 for r in rids if r not in orch.results),
            "terminals_exactly_once": tracer.terminals_exactly_once(rids),
            "completed": sum(1 for r in rids
                             if orch.results.get(r) is not None),
            "expired": orch.tick_stats["expired"],
            "shed": orch.tick_stats["shed"],
            "slo": orch.slo_report(),
            "fairness_final_jain": jain_index(
                orch.tenant_service.values()),
            "fairness_min_jain": orch.tick_stats["fairness_min_jain"],
            "device_dispatches": orch.tick_stats["device_dispatches"],
            "wall_s": wall}


def trace_harness_phase(cfg, params, device, n=TRACE_N):
    """The trace harness at full width on the card, SLO-aware on and off,
    each arm held to the same arm of the port on the CPU at ``.reduced()``
    width (generation has no EOS, so scheduling depends on neither the
    width nor the device): per-class rows, ticks and work clock equal,
    every rid resolved exactly once."""
    import torch

    from repro_torch.models.model import get_model
    cpu = torch.device("cpu")
    rcfg = cfg.reduced()
    rparams = get_model(rcfg).init(seed=0, device=cpu)
    out, faults = {}, []
    for on in (True, False):
        card = trace_arm(cfg, params, device, n, on)
        ref = trace_arm(rcfg, rparams, cpu, n, on)
        arm = "slo_aware" if on else "slo_blind"
        for key in ("slo", "ticks", "work_clock", "expired", "shed",
                    "fairness_final_jain", "fairness_min_jain"):
            if card[key] != ref[key]:
                faults.append(f"{arm} {key}: card {card[key]} vs cpu "
                              f"{ref[key]}")
        if card["unresolved"] or not card["terminals_exactly_once"]:
            faults.append(f"{arm}: {card['unresolved']} unresolved, "
                          f"terminals once {card['terminals_exactly_once']}")
        out[arm] = dict(card, cpu_wall_s=ref["wall_s"])
    att = {arm: out[arm]["slo"]["interactive"].get("ttft_attainment")
           for arm in out}
    emit({"phase": "trace harness", "model": cfg.name,
          "layers": cfg.num_layers, "n": n,
          **out, "interactive_ttft_attainment": att})
    if faults:
        raise AssertionError("trace harness: " + "; ".join(faults))


def serve_trace_phase():
    """``python -m repro_torch.launch.serve --batched --requests 12
    --trace build/serve_trace.json`` on the card, through its ``main``:
    the file loads as JSON and every submitted request has exactly one
    terminal (in the journal and among the file's orchestrator events)."""
    import contextlib
    import io

    from repro_torch.launch import serve
    path = ROOT / "build" / "serve_trace.json"
    path.parent.mkdir(exist_ok=True)
    with contextlib.redirect_stdout(io.StringIO()) as out:
        eng = serve.main(["--batched", "--requests", "12", "--trace",
                          str(path)])
    doc = json.loads(path.read_text())
    terms = [e for e in doc["traceEvents"] if e.get("pid") == 0
             and e.get("name") in ("complete", "reject", "expire")]
    rids = list(range(eng._next_rid))
    ok = (eng.tracer.terminals_exactly_once(rids) and len(rids) == 12
          and len(terms) == 12)
    emit({"phase": "serve --trace", "requests": len(rids),
          "events": len(doc["traceEvents"]), "terminal_events": len(terms),
          "completed": len(eng.log), "rejected": len(eng.rejected),
          "stdout_lines": len(out.getvalue().splitlines()),
          "device": str(next(iter(eng.batchers.values())).device)})
    if not ok:
        raise AssertionError("serve --trace: a request did not resolve "
                             "exactly once")


# ------------------------------------------------------ privacy hardening

# benchmarks/leakage.py's gate constants (the benchmark imports the JAX
# package, so its suite is ported here): a mitigated attack may beat
# chance by at most LEAK_SLACK, an unmitigated one must beat it by at
# least LEAK_POSITIVE_MARGIN
LEAK_SLACK = 0.05
LEAK_POSITIVE_MARGIN = 0.25
SPLIT_KERNELS = ("paged_decode_attention", "chunked_prefill_attention")


def _made_batchers(module):
    """Collect every batcher ``module``'s ``make_batcher`` and
    ``build_island_batchers`` build, so that a run's launches can be held
    to ``expected_launches``. Returns (the list, undo)."""
    made = []
    mk, build = module.make_batcher, module.build_island_batchers

    def make_batcher(*a, **k):
        made.append(mk(*a, **k))
        return made[-1]

    def build_island_batchers(*a, **k):
        out = build(*a, **k)
        made.extend(out.values())
        return out

    module.make_batcher = make_batcher
    module.build_island_batchers = build_island_batchers

    def undo():
        module.make_batcher, module.build_island_batchers = mk, build
    return made, undo


def leakage_phase(cfg, params, device):
    """benchmarks/leakage.py's adversary suite (``run_attack_suite`` at
    its defaults: seven attacks, mitigations off and on) at full width on
    the card, held to the benchmark's three checks, with every attack's
    result equal to the port's on the CPU at ``.reduced()`` width (no EOS:
    scheduling depends on neither the width nor the weights), and the
    card run's K1/K2 launches once per layer of every dispatch of every
    batcher the suite built. The traced leg runs in the CPU tests."""
    import torch

    from repro_torch.models.model import get_model
    from repro_torch.privacy import (Mitigations, adversary, leakage_report,
                                     run_attack_suite)
    cpu = torch.device("cpu")
    rcfg = cfg.reduced()
    rparams = get_model(rcfg).init(seed=0, device=cpu)
    out, faults, suites = {}, [], {}
    for label in ("off", "on"):
        mit = getattr(Mitigations, label)()
        made, undo = _made_batchers(adversary)
        zero_launches()
        t0 = time.perf_counter()
        try:
            card = run_attack_suite(cfg, params, mit, device=device)
        finally:
            undo()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        want = expected_launches(made)
        if launches != want:
            faults.append(f"mitigations {label}: launches {launches}, "
                          f"expected {want}")
        t0 = time.perf_counter()
        ref = run_attack_suite(rcfg, rparams, mit, device=cpu)
        cpu_wall = time.perf_counter() - t0
        for name in sorted(set(card) | set(ref)):
            if card.get(name) != ref.get(name):
                faults.append(f"mitigations {label} {name}: card "
                              f"{card.get(name)} vs cpu {ref.get(name)}")
        rep = leakage_report(card)
        suites[label] = card
        out[f"mitigations_{label}"] = {
            "attacks": {s["attack"]: {k: s[k] for k in (
                "signal", "accuracy", "chance", "advantage", "n_test")}
                for s in rep["per_signal"]},
            "lps": rep["lps"], "batchers": len(made),
            "dispatches": sum(len(b.dispatch_shapes) for b in made),
            "launches": {k: v for k, v in launches.items() if v},
            "wall_s": wall, "cpu_wall_s": cpu_wall}
    off, on = suites["off"], suites["on"]
    checks = {
        "positive_control_prefix_ge_0p8":
            off["prefix_membership"].accuracy >= 0.8,
        "positive_control_leaks": all(
            r.accuracy >= r.chance + LEAK_POSITIVE_MARGIN
            for r in off.values()),
        "mitigated_le_chance_plus_slack": all(
            r.accuracy <= r.chance + LEAK_SLACK for r in on.values()),
        "card_equals_cpu": not faults,
    }
    emit({"phase": "leakage", "model": cfg.name,
          "layers": cfg.num_layers, **out, "checks": checks,
          "faults": faults})
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"leakage checks failed: {failed}: {faults}")


def _record_splits(batchers):
    """Record the key-walk split of every K1 and K2 launch by island: each
    batcher's forward pass names its island, and the attention module's
    two kernel names are wrapped to read the wrapper's ``last_split``
    after each launch (no kernel argument, no device read). Returns
    ({island: {kernel: [split, ...]}}, undo)."""
    from repro_torch.models import attention
    current = [None]
    splits = {iid: {k: [] for k in SPLIT_KERNELS} for iid in batchers}
    for iid, b in batchers.items():
        def named(*a, iid=iid, forward=b.model.forward, **k):
            current[0] = iid
            return forward(*a, **k)

        b.model.forward = named
    saved = {k: getattr(attention, k) for k in SPLIT_KERNELS}
    for name, fn in saved.items():
        def recorded(*a, fn=fn, name=name, **k):
            out = fn(*a, **k)
            splits[current[0]][name].append(fn.last_split)
            return out

        setattr(attention, name, recorded)

    def undo():
        for name, fn in saved.items():
            setattr(attention, name, fn)
    return splits, undo


def shape_run(cfg, params, device, constant_shape, main=True):
    """One run for the constant-shape A/B, its streams and rows captured
    (``_capture_orch``) and its K1/K2 splits recorded by island: the main
    path's traffic through ``TickOrchestrator`` (``main``), else
    benchmarks/leakage.py's ``constant_shape_ab`` workload on one bare
    batcher (``tiered_serving_prompts(16, seed=7)``, 8 slots, ``max_len``
    96, 8 new tokens)."""
    import torch

    from repro_torch.core.workload import tiered_serving_prompts
    from repro_torch.serving.batcher import make_batcher
    if main:
        orch, batchers, rids, flags = serving_stack(
            cfg, params, device, 2048, constant_shape=constant_shape)
    else:
        orch, flags = None, []
        b = make_batcher(cfg, cache="paged", num_slots=8, max_len=96,
                         params=params, constant_shape=constant_shape,
                         device=device)
        _watch_finite(b, flags)
        batchers = {"shape_ab": b}
        rids = [b.submit(p, max_new_tokens=8, trust_tier=t)
                for p, t in tiered_serving_prompts(16, seed=7)]
    streams, rows, frozen = _capture_orch(orch, batchers)
    splits, undo = _record_splits(batchers)
    torch.cuda.synchronize()
    zero_launches()
    try:
        if main:
            orch.run_until_done(max_ticks=4000)
            results = orch.results
        else:
            results = b.run_until_done()
    finally:
        undo()
    torch.cuda.synchronize()
    return {"streams": streams, "rows": rows, "frozen": frozen,
            "splits": splits, "launches": read_launches(),
            "launches_expected": expected_launches(batchers.values()),
            "unresolved": [r for r in rids if results.get(r) is None],
            "finite": all(bool(f) for f in flags),
            "shapes": {iid: {kind: sorted({s[1:] for s in b.dispatch_shapes
                                           if s[0] == kind})
                             for kind in ("prefill", "decode")}
                       for iid, b in batchers.items()},
            "dispatches": sum(len(b.dispatch_shapes)
                              for b in batchers.values()),
            "work": sum(b.work_clock for b in batchers.values())}


def _shape_ab(label, base, const):
    """Hold a constant-shape run to the default run: every request
    resolved with finite logits, K1/K2 once per layer of every dispatch,
    one prefill and one decode geometry per batcher and one K1 and one K2
    split per island, and the streams under the churn phase's near-tie
    rule (the pinned rows and widths change the split and cuBLAS's
    algorithm, so bit-equality is not expected; the result says whether
    it held). Returns (faults, summary)."""
    faults = []
    for name, run in (("default", base), ("constant", const)):
        if run["unresolved"] or not run["finite"]:
            faults.append(f"{label} {name}: unresolved {run['unresolved']}"
                          f", finite {run['finite']}")
        if run["launches"] != run["launches_expected"]:
            faults.append(f"{label} {name}: launches {run['launches']}, "
                          f"expected {run['launches_expected']}")
    for iid, kinds in const["shapes"].items():
        for kind, shapes in kinds.items():
            if len(shapes) > 1:
                faults.append(f"{label} {iid}: {len(shapes)} {kind} shapes")
    split_sets = {iid: {k: sorted(set(v), key=str) for k, v in ks.items()}
                  for iid, ks in const["splits"].items()}
    for iid, ks in split_sets.items():
        for k, v in ks.items():
            if len(v) > 1:
                faults.append(f"{label} {iid}: {k} splits {v}")
    held, st = _hold_runs(base, const, CHURN_LOGIT_TOL)
    faults += held
    return faults, {
        "constant_shapes": const["shapes"],
        "default_shape_counts": {
            iid: {kind: len(v) for kind, v in kinds.items()}
            for iid, kinds in base["shapes"].items()},
        "constant_splits": split_sets,
        "default_splits": {
            iid: {k: sorted(set(v), key=str) for k, v in ks.items()}
            for iid, ks in base["splits"].items()},
        "dispatches": {"default": base["dispatches"],
                       "constant": const["dispatches"]},
        "launches": {k: v for k, v in const["launches"].items() if v},
        "work": {"default": base["work"], "constant": const["work"]},
        "work_overhead": const["work"] / max(base["work"], 1), **st}


def constant_shape_phase(cfg, params, device, main_busy_s, sched):
    """Constant-shape dispatch against the default on the card, at full
    width: (a) benchmarks/leakage.py's ``constant_shape_ab`` (its checks:
    streams, the work clock within 1.25x, one prefill and one decode
    shape), (b) the main path's traffic with ``constant_shape`` on every
    island. Both: ``_shape_ab``, serving ``sched`` (the config and
    weights of the served model's first ``SCHED_LAYERS`` layers). Then
    (b)'s card cost at ``MAIN_LAYERS``: wall tokens/s of
    the serving path (launches checked by ``serve_path``) run default
    then constant (one pair: host walls drift within a call, so the
    ratio is a rough reading), and device busy seconds from one profiled rerun, against
    ``profile main_path``'s (``main_busy_s``)."""
    out, faults = {}, []
    for label, main in (("constant_shape_ab", False), ("main_path", True)):
        base = shape_run(*sched, device, False, main)
        const = shape_run(*sched, device, True, main)
        f, out[label] = _shape_ab(label, base, const)
        faults += f
    if out["constant_shape_ab"]["work_overhead"] > 1.25:
        faults.append("constant_shape_ab: work clock over 1.25x")
    walls = {"default": [], "constant": []}
    tps = {"default": [], "constant": []}
    for constant in (False, True):
        label = "constant" if constant else "default"
        _, wall, result = serve_path(f"main_path {label} (A/B)", cfg,
                                     params, device,
                                     constant_shape=constant)
        walls[label].append(wall)
        tps[label].append(result["tokens_per_s"])
    wall = walls["constant"][0]
    prof = profile_phase("main_path constant_shape", cfg, params, device,
                         wall, constant_shape=True)
    out["cost"] = {
        "card": gpu_line(), "wall_s": walls, "tokens_per_s": tps,
        "tokens_per_s_ratio": sum(tps["constant"]) / sum(tps["default"]),
        "device_busy_s": {"default": main_busy_s,
                          "constant": prof["busy_s"]},
        "busy_ratio": prof["busy_s"] / main_busy_s}
    emit({"phase": "constant shape", "model": cfg.name, **out,
          "faults": faults})
    if faults:
        raise AssertionError("constant shape: " + "; ".join(faults))


# tests/test_extensions.py's bounds on an fp8 KV cache's decode logits
# against an fp32 cache's
FP8_MAX_GAP = 0.5
FP8_MEAN_REL = 0.05


def fp8_phase(name, cfg, params, device, B, S, T, seed=0):
    """tests/test_extensions.py's fp8 KV cache check at full width: an
    fp32 and a ``float8_e4m3fn`` dense cache (``Model.init_cache``), each
    prefilled with the same seeded S-token prompts (K4 on every attention
    layer, the fp8 cache quantized on write) and decoded T teacher-forced
    steps (K3 on the fp32 cache, or on the fp8 cache dequantized to fp32).
    Held: the test's bounds on the two runs' decode logits, finite logits,
    the first attention layer's quantized K/V and scales bit-equal to a
    CPU quantization of the same fp32 K/V (and in the cache), every kernel
    once per layer of its family per call, and the caches' bytes and peak
    memory reported."""
    import torch

    from repro_torch.models import attention
    from repro_torch.models.model import get_model
    model = get_model(cfg)
    n_attn, n_ssm, n_rg = layer_counts(model)
    g = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (B, S + T), generator=g,
                         dtype=torch.int64).to(device)
    want = dict.fromkeys(kernel_fns(), 0)
    want.update(flash_attention=n_attn, decode_attention=n_attn * T,
                ssd_chunk=n_ssm, rglru_scan=n_rg)
    runs, faults = {}, []
    quantize = attention._fp8_quantize
    for dt in (torch.float32, torch.float8_e4m3fn):
        seen = []

        def recorded(x, d):
            q, scale = quantize(x, d)
            if len(seen) < 2:          # the first attention layer's K, V
                seen.append((x.float().cpu(), q.cpu(), scale.cpu()))
            return q, scale

        attention._fp8_quantize = recorded
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mem0 = torch.cuda.memory_allocated()
        zero_launches()
        t0 = time.perf_counter()
        try:
            cache = model.init_cache(B, S + T, dtype=dt, device=device)
            _, cache = model.forward(params, tokens=toks[:, :S], mode="full",
                                     cache=cache)
            logits = []
            for t in range(T):
                lg, cache = model.forward(params, mode="decode",
                                          tokens=toks[:, S + t:S + t + 1],
                                          cache=cache, pos=S + t)
                logits.append(lg.float())
            torch.cuda.synchronize()
        finally:
            attention._fp8_quantize = quantize
        wall = time.perf_counter() - t0
        launches = read_launches()
        if launches != want:
            faults.append(f"{dt}: launches {launches}, expected {want}")
        first = next(layer for layer in cache if "k" in layer)
        runs[str(dt)] = {"logits": torch.stack(logits), "seen": seen,
                         "first": first, "wall_s": wall,
                         "cache_bytes": tensor_bytes(cache),
                         "peak_bytes": torch.cuda.max_memory_allocated()
                         - mem0}
    f32, f8 = (runs[str(dt)] for dt in (torch.float32, torch.float8_e4m3fn))
    if f8["first"]["k"].shape[1] < S + T:
        raise ValueError(f"{name}: a ring of {f8['first']['k'].shape[1]} "
                         f"slots overwrites the prompt's; take S + T <= it")
    gap = (f32["logits"] - f8["logits"]).abs()
    max_gap = float(gap.max())
    mean_rel = float(gap.mean() / (f32["logits"].abs().mean() + 1e-9))
    finite = bool(torch.isfinite(f8["logits"]).all())
    # elements that differ: the card's quantization against the CPU's of
    # the same fp32 K/V, and the cache's prompt slots against the card's
    differ = {}
    for (x, q, scale), leaf in zip(f8["seen"], ("k", "v")):
        cq, cs = quantize(x, torch.float8_e4m3fn)
        stored = f8["first"][leaf][:, :S].cpu()
        stored_s = f8["first"][leaf + "_scale"][:, :S].cpu()
        differ[leaf] = {
            "bytes_vs_cpu": int((cq.view(torch.uint8)
                                 != q.view(torch.uint8)).sum()),
            "scales_vs_cpu": int((cs.view(torch.int32)
                                  != scale.view(torch.int32)).sum()),
            "cache_bytes": int((stored.view(torch.uint8)
                                != q.view(torch.uint8)).sum()),
            "cache_scales": int((stored_s.view(torch.int32)
                                 != scale.view(torch.int32)).sum())}
    bits = len(differ) == 2 and not any(
        n for d in differ.values() for n in d.values())
    checks = {"max_gap_lt_0p5": max_gap < FP8_MAX_GAP,
              "mean_rel_lt_0p05": mean_rel < FP8_MEAN_REL,
              "finite": finite, "quantized_card_equals_cpu": bits,
              "launches": not faults}
    emit({"phase": name, "model": cfg.name, "batch": B, "prompt": S,
          "decode_steps": T, "attention_layers": n_attn,
          "max_abs_gap": max_gap, "mean_rel_gap": mean_rel,
          "launches": {k: v for k, v in want.items() if v},
          **{f"{k}_{lab}": run[k] for lab, run in (("fp32", f32),
                                                   ("fp8", f8))
             for k in ("wall_s", "cache_bytes", "peak_bytes")},
          "differing_elements": differ, "checks": checks,
          "faults": faults})
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"{name}: checks failed: {failed} {faults}")


# ------------------------------------------------- P12a: four new configs

# the configs P12a brings to the card, one phase group each, one at a
# time (each freed before the next): all four take the paged main path
# (cache="auto": attention only, no window), K2 prefill and K1 decode
P12A = ("paligemma-3b", "musicgen-large", "qwen3-4b", "glm4-9b")
# the replay's cut: the first two layers of the served weights, every
# width and the whole vocabulary kept (3.2-9.4 B parameters of fp32
# weights do not replay on a CPU at full depth)
P12A_CUT_LAYERS = 2
# Model.forward with a frontend's embeddings, card against itself at full
# depth (prefill and decode rows against the full forward's): the
# reference test's 2e-4 (tests/test_models.py::
# test_prefill_decode_matches_full), both sides fp32 on the card; card
# against CPU at the cut: the same 2e-4, both sides fp32 (as the
# recurrentgemma replay's fp32 cache, RG_PREFILL_LOGIT_TOL)
EMBED_TOL = 2e-4


def cut_model(cfg, params, layers=P12A_CUT_LAYERS, phase="replay cut"):
    """The config and the served weights cut to their first ``layers``
    layers, at full widths with the full vocabulary (the embedding table,
    the final norm and an untied head kept); a ``phase`` line says so."""
    from repro_torch.models.model import effective_pattern
    ccfg = dataclasses.replace(cfg, num_layers=layers)
    cut = {k: v for k, v in params.items() if k != "layers"}
    cut["layers"] = params["layers"][:layers]
    emit({"phase": phase, "model": cfg.name, "layers": layers,
          "of": cfg.num_layers, "pattern": list(effective_pattern(cfg)),
          "d_model": cfg.d_model, "vocab": cfg.vocab_size,
          "weight_bytes": tensor_bytes(cut)})
    return ccfg, cut


def _record_prefix():
    """Record the ``prefix_len`` of every K4 launch from the attention
    module (its name there wrapped; nothing read from the device).
    Returns (the list of prefix lengths, undo)."""
    from repro_torch.models import attention
    seen, fn = [], attention.flash_attention

    def recorded(*a, prefix_len=0, **k):
        seen.append(prefix_len)
        return fn(*a, prefix_len=prefix_len, **k)

    attention.flash_attention = recorded

    def undo():
        attention.flash_attention = fn
    return seen, undo


def prefix_path(label, prefix, fn, /, *args, **kw):
    """A paligemma path that prefills in mode="full" (``fn(*args, **kw)``
    runs it): every K4 launch must carry the config's ``prefix``."""
    seen, undo = _record_prefix()
    try:
        out = fn(*args, **kw)
    finally:
        undo()
    if not seen or set(seen) != {prefix}:
        raise AssertionError(f"{label}: K4 prefix lengths "
                             f"{sorted(set(seen))}, expected {prefix}")
    emit({"phase": f"{label} prefix", "k4_launches": len(seen),
          "prefix_len": prefix})
    return out


def _close_rows(got, want, tol):
    """Largest |got - want| and whether it is within tol + tol * |want|
    (numpy's allclose with rtol = atol = tol, as the reference test)."""
    import torch
    got, want = got.float().cpu(), want.float().cpu()
    gap = float((got - want).abs().max())
    ok = bool(((got - want).abs() <= tol + tol * want.abs()).all()) \
        and bool(torch.isfinite(got).all())
    return gap, ok


def _embed_inputs(cfg, seed=3):
    """tests/test_models.py::test_prefill_decode_matches_full's inputs at
    full width (drawn with a seeded torch generator on the CPU): B 2, a
    prefill of S positions and T decode steps; vision: the prefix's
    embeddings then tokens (S = the prefix + 16); audio: embeddings alone,
    prefill compared."""
    import torch
    gen = torch.Generator().manual_seed(seed)
    B, T = 2, 4
    if cfg.frontend == "vision":
        P = cfg.num_prefix_tokens
        S = P + 16
        emb = torch.randn(B, P, cfg.d_model, generator=gen)
        toks = torch.randint(0, cfg.vocab_size, (B, S + T - P), generator=gen)
        return (B, S, T, dict(embeddings=emb, tokens=toks),
                dict(embeddings=emb, tokens=toks[:, :S - P]),
                toks[:, S - P:])
    S = 16
    emb = torch.randn(B, S + T, cfg.d_model, generator=gen)
    return B, S, T, dict(embeddings=emb), dict(embeddings=emb[:, :S]), None


def _embed_run(model, params, device, inputs):
    """The reference test's three passes on ``device``: the full forward,
    the prefill into an fp32 cache and the decode steps. Returns (full
    logits, prefill logits, [decode rows])."""
    import torch
    B, S, T, kw_full, kw_pre, dec = inputs

    def on(kw):
        return {k: v.to(device) for k, v in kw.items()}

    full, _ = model.forward(params, mode="full", **on(kw_full))
    cache = model.init_cache(B, S + T, dtype=torch.float32, device=device)
    pre, cache = model.forward(params, mode="full", cache=cache,
                               **on(kw_pre))
    rows = []
    if dec is not None:
        for t in range(T):
            d, cache = model.forward(params, mode="decode",
                                     tokens=dec[:, t:t + 1].to(device),
                                     cache=cache, pos=S + t)
            rows.append(d[:, 0])
    return full, pre, rows


def embeddings_phase(name, cfg, params, device, ccfg, cut):
    """``Model.forward`` with a frontend's ``embeddings`` at full width:
    on the card at full depth, the prefill's last row and each decode row
    held to the full forward's (the reference test's claim), with K4 once
    a layer per full-mode pass and K3 once a layer per decode step; then
    the card against the CPU on the cut model, every pass."""
    import torch

    from repro_torch.models.model import get_model
    inputs = _embed_inputs(cfg)
    B, S, T = inputs[:3]
    zero_launches()
    full, pre, rows = _embed_run(get_model(cfg), params, device, inputs)
    torch.cuda.synchronize()
    launches = read_launches()
    L = cfg.num_layers
    want = dict.fromkeys(kernel_fns(), 0)
    want["flash_attention"] = 2 * L
    want["decode_attention"] = len(rows) * L
    if launches != want:
        raise AssertionError(f"{name}: launches {launches}, expected {want}")
    checks = [_close_rows(pre[:, -1], full[:, S - 1], EMBED_TOL)]
    checks += [_close_rows(r, full[:, S + t], EMBED_TOL)
               for t, r in enumerate(rows)]
    del full, pre, rows
    cmodel = get_model(ccfg)
    card = _embed_run(cmodel, cut, device, inputs)
    cpu = _embed_run(cmodel, params_to(cut, torch.device("cpu")),
                     torch.device("cpu"), inputs)
    cross = [_close_rows(card[0], cpu[0], EMBED_TOL),
             _close_rows(card[1], cpu[1], EMBED_TOL)]
    cross += [_close_rows(a, b, EMBED_TOL) for a, b in zip(card[2], cpu[2])]
    result = {"phase": name, "model": cfg.name, "frontend": cfg.frontend,
              "batch": B, "prefill_positions": S,
              "decode_steps": len(checks) - 1,
              "embedding_positions": inputs[3]["embeddings"].shape[1],
              "tol": EMBED_TOL,
              "launches": {k: v for k, v in launches.items() if v},
              "full_depth_max_gap": max(g for g, _ in checks),
              "full_depth_gaps": [g for g, _ in checks],
              "cut_layers": ccfg.num_layers,
              "card_vs_cpu_max_gap": max(g for g, _ in cross),
              "card_vs_cpu_gaps": [g for g, _ in cross]}
    emit(result)
    if not all(ok for _, ok in checks + cross):
        raise AssertionError(f"{name}: rows beyond {EMBED_TOL}: {result}")


def p12a_group(arch, device, timed, rows):
    """One P12a config at full width: (a) at its first
    ``SERVE_LAYERS`` layers, the auto path (the paged main path) on
    the quickstart traffic with exact launch counts, and a profile of it
    (device busy time and idle share); paligemma also on the stacked,
    paged prefill="full" and per-request paths, each with K4 running its
    prefix; (b) the replay of the card against the
    CPU at the cut; paligemma and musicgen the Model.forward phase with
    embeddings. Its seconds go to ``timed``'s record; its launches to the
    kernel rows."""
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.models.model import get_model
    from repro_torch.serving.batcher import PagedContinuousBatcher
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": f"memory before {arch}",
          "memory_allocated_bytes": torch.cuda.memory_allocated()})
    cfg = get_config(arch)
    params = timed(f"init {arch}", get_model(cfg).init, seed=0,
                   device=device)
    scfg, served = cut_model(cfg, params, SERVE_LAYERS, "serve cut")
    launches, wall, _ = timed(arch, serve_path, arch, scfg, served, device)
    for k in ("paged_decode_attention", "chunked_prefill_attention"):
        rows[k].setdefault("launches_p12a", {})[arch] = launches[k]
    timed(f"profile {arch}", profile_phase, arch, scfg, served, device,
          wall)
    if cfg.prefix_lm:
        P = cfg.num_prefix_tokens
        for label, kw in ((f"{arch} stacked", dict(cache="stacked")),
                          (f"{arch} paged_prefill_full",
                           dict(prefill="full"))):
            got, _, _ = timed(label, prefix_path, label, P, serve_path,
                              label, scfg, served, device, **kw)
            rows["flash_attention"].setdefault("launches_prefix", {})[
                label] = got["flash_attention"]
        label = f"per_request {arch}"
        timed(label, prefix_path, label, P, per_request_phase, scfg,
              served, device, name=label)
    del served
    ccfg, cut = cut_model(cfg, params)
    cpu = torch.device("cpu")
    runs = [(device, cut), (cpu, params_to(cut, cpu))]
    timed(f"replay {arch}", replay, f"replay {arch}", ccfg, runs,
          lambda dev, p: PagedContinuousBatcher(
              ccfg, params=p, num_slots=4, max_len=256, device=dev),
          _capture_fused)
    del runs
    if cfg.frontend is not None:
        timed(f"embeddings {arch}", embeddings_phase, f"embeddings {arch}",
              cfg, params, device, ccfg, cut)
    del cut, params


P12B = "deepseek-v2-lite-16b"
# the MoE config on GQA attention, at .reduced(): one of its MoE layers
# alone is 67.6 GB of fp32 at full width (a full-width run waits for the
# distributed slice)
P12B_REDUCED = "kimi-k2-1t-a32b"


def decode_step_phase(cfg, params, device, B=8, fill=1024, reps=10):
    """deepseek's decode step as its stacked batcher runs it: ``B`` rows
    (the home-nas island's slots) at ``fill`` positions each against a
    bf16 latent cache, timed with CUDA events over ``reps`` steps after a
    warm-up. The dense MoE reads every expert's weights every step, so the
    least time is the weight bytes over the card's memory rate."""
    import torch

    from repro_torch.models.model import get_model
    model = get_model(cfg)
    cache = model.init_cache(B, 2048, device=device)
    gen = torch.Generator(device=device).manual_seed(5)
    tok = torch.randint(1, cfg.vocab_size, (B, 1), generator=gen,
                        device=device)
    pos = torch.full((B,), fill, dtype=torch.int32, device=device)
    model.forward(params, tokens=tok, mode="decode", cache=cache, pos=pos)
    torch.cuda.synchronize()
    zero_launches()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        logits, _ = model.forward(params, tokens=tok, mode="decode",
                                  cache=cache, pos=pos)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / reps
    launches, blocks = read_launches(), read_blocks()
    want = expected_blocks([(model, reps)])
    if any(launches.values()) or blocks != want:
        raise AssertionError(f"decode step: launches {launches}, MLA/MoE "
                             f"calls {blocks}, expected none and {want}")
    if not bool(torch.isfinite(logits.sum())):
        raise AssertionError("decode step: non-finite logits")
    nbytes = tensor_bytes(params)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    emit({"phase": f"decode step {cfg.name}", "rows": B, "fill": fill,
          "reps": reps, "ms": ms, "bound_ms": bound_ms,
          "bound_by": "bytes (every weight read once a step)",
          "weight_bytes": nbytes,
          "achieved_bytes_per_s": nbytes / (ms / 1e3),
          "share_of_hbm_rate": bound_ms / ms, "block_calls": blocks})


def _profiled_pass(fn, label):
    """Run ``fn`` once under a torch profile (host ops with their shapes,
    the blocks labelled) inside a ``record_function`` range ``label``;
    returns (its matmul time and rate by block, device busy ms, wall
    ms)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    undo = _label_blocks()
    torch.cuda.synchronize()
    try:
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            with record_function(label):
                fn()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        undo()
    spans, events = _device_spans(prof, parsed=True)
    busy, end = 0, float("-inf")
    for a, b, _name in spans:
        busy += max(0, b - max(a, end))
        end = max(end, b)
    return (_dispatch_matmuls(events, BLOCK_RANGES.values(),
                              "head, embedding, norms"),
            busy / 1e6, wall * 1e3)


def block_split_phase(cfg, params, device, S=1024, B=8, fill=1024):
    """Where deepseek's matmul time goes, block by block (MLA, MoE, the
    dense first layer's MLP, and the head with the embedding and norms),
    in one prefill of an ``S``-token prompt into a bf16 latent cache (a
    stacked admission) and one decode step of ``B`` rows at ``fill``
    positions, each profiled alone (the serving profile records no host
    ops: parsing a whole run's took 114 s); with each pass's device busy
    time against its wall."""
    import torch

    from repro_torch.models.model import get_model
    model = get_model(cfg)
    gen = torch.Generator(device=device).manual_seed(6)
    prompt = torch.randint(1, cfg.vocab_size, (1, S), generator=gen,
                           device=device)
    cache = model.init_cache(1, 2048, device=device)
    model.forward(params, tokens=prompt, cache=cache)     # warm-up
    pre, pre_busy, pre_wall = _profiled_pass(
        lambda: model.forward(params, tokens=prompt, cache=cache),
        "prefill dispatch")
    del cache
    cache = model.init_cache(B, 2048, device=device)
    tok = torch.randint(1, cfg.vocab_size, (B, 1), generator=gen,
                        device=device)
    pos = torch.full((B,), fill, dtype=torch.int32, device=device)
    model.forward(params, tokens=tok, mode="decode", cache=cache, pos=pos)
    dec, dec_busy, dec_wall = _profiled_pass(
        lambda: model.forward(params, tokens=tok, mode="decode", cache=cache,
                              pos=pos), "decode dispatch")
    emit({"phase": f"matmul split {cfg.name}", "prefill_tokens": S,
          "prefill_by_block": pre, "prefill_device_busy_ms": pre_busy,
          "prefill_wall_ms_profiled": pre_wall, "decode_rows": B,
          "decode_fill": fill, "decode_by_block": dec,
          "decode_device_busy_ms": dec_busy,
          "decode_wall_ms_profiled": dec_wall,
          "decode_bound_ms": tensor_bytes(params) / HBM_BYTES_PER_S * 1e3})


def p12b_group(device, timed, rows):
    """P12b on the card. kimi-k2-1t-a32b at ``.reduced()`` (MoE on GQA
    attention) on the paged main path, with exact K1/K2 launch counts and
    MoE calls, and a replay against the CPU: the one run where MoE meets
    the fused paged dispatch on the card (no throughput: a smoke width).
    Then deepseek-v2-lite-16b at its published widths and full depth
    (15.71 B fp32 parameters) after everything else is freed: the
    quickstart traffic on ``cache="auto"`` (stacked: MLA's latent cache is
    not paged), which launches none of K1-K6, with its MLA and MoE calls
    counted exactly; its decode step timed against its byte bound; a
    profile (device busy time, idle share); the matmul split by block in
    one prefill and one decode step; the per-request path; and the replay of the card against the CPU at a
    2-layer cut (the dense layer 0 and one MLA+MoE layer at full widths
    and vocabulary)."""
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.models.model import get_model
    from repro_torch.serving.batcher import (ContinuousBatcher,
                                             PagedContinuousBatcher)
    cpu = torch.device("cpu")
    kcfg = get_config(P12B_REDUCED).reduced()
    label = f"{P12B_REDUCED} .reduced()"
    kparams = get_model(kcfg).init(seed=0, device=device)
    launches, _, _ = timed(label, serve_path, label, kcfg, kparams, device,
                           throughput=False)
    for k in ("paged_decode_attention", "chunked_prefill_attention"):
        rows[k].setdefault("launches_p12b", {})[label] = launches[k]
    kruns = [(device, kparams), (cpu, params_to(kparams, cpu))]
    timed(f"replay {label}", replay, f"replay {label}", kcfg, kruns,
          lambda dev, p: PagedContinuousBatcher(
              kcfg, params=p, num_slots=4, max_len=256, device=dev),
          _capture_fused)
    del kruns, kparams

    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": f"memory before {P12B}",
          "memory_allocated_bytes": torch.cuda.memory_allocated()})
    cfg = get_config(P12B)
    params = timed(f"init {P12B}", get_model(cfg).init, seed=0,
                   device=device)
    emit({"phase": f"params {P12B}",
          "parameters": sum(t.numel() for t in _tensors(params)),
          "weight_bytes": tensor_bytes(params),
          "memory_allocated_bytes": torch.cuda.memory_allocated()})
    _, wall, result = timed(P12B, serve_path, P12B, cfg, params, device)
    if "share_hits" in result:
        raise AssertionError(f"{P12B}: cache='auto' built paged batchers")
    timed(f"decode step {P12B}", decode_step_phase, cfg, params, device)
    timed(f"profile {P12B}", profile_phase, P12B, cfg, params, device, wall)
    timed(f"matmul split {P12B}", block_split_phase, cfg, params, device)
    timed(f"per_request {P12B}", per_request_phase, cfg, params, device,
          name=f"per_request {P12B}")
    ccfg, cut = cut_model(cfg, params)
    runs = [(device, cut), (cpu, params_to(cut, cpu))]
    timed(f"replay {P12B}", replay, f"replay {P12B}", ccfg, runs,
          lambda dev, p: ContinuousBatcher(
              ccfg, params=p, num_slots=4, max_len=256, device=dev),
          _capture_stacked)
    del runs, cut
    # the one-process run the distributed group's deepseek phase is held to
    want = timed(f"dist want {P12B}", ds_dist_want, cfg, params, device)
    del params
    return want


# ---------------------------------- P13a: distributed, gloo ranks on one card

# smollm-135m at full width on a 1x2 mesh: 3 KV heads do not split over 2
# model ranks, so every layer decodes sequence-sharded (each rank holds
# 1,024 of the 2,048 slots)
DIST_ARCH = "smollm-135m"
# (4 decode steps since P13e, 8 since P13d, 16 before: each is ~0.56 s
# of gloo all-reduces a rank)
DIST_B, DIST_S, DIST_L, DIST_T = 8, 1024, 2048, 4
# deepseek-v2-lite-16b at full width and depth on 1x2: the latent cache
# sequence-sharded, 32 of the 64 experts a rank. capacity_factor E / k
# gives a capacity of every local token, so no token is dropped and the
# dense single-process run is the comparison (4 decode steps since P13e,
# 8 before: each is ~1.1 s of gloo a rank)
DS_DIST_B, DS_DIST_S, DS_DIST_L, DS_DIST_T = 4, 512, 1024, 4
# gathered logits against the one-process card run (fp32 caches): smollm
# at the reference's own tolerance for this comparison
# (tests/test_system.py, rtol/atol 3e-4); the sharded decode's plain fp32
# softmax merge against K3's 3xTF32 walk, over 30 layers. deepseek: 27
# layers whose MoE sums 6 of 64 experts through a gathered buffer in
# another order than the dense path's broadcasting matmuls, so 1e-3
DIST_LOGIT_TOL = 3e-4
DS_DIST_LOGIT_TOL = 1e-3
# since P13c the ranks run deepseek tensor parallel (MLA heads, the dense
# and shared ff, the vocab split over "model"), so their hidden states sum
# in another order than one process's (~1e-6 relative) and a router's
# top 6 of 64 parts where its 6th and 7th probabilities lie closer than
# that, and a parted choice spreads through attention to later tokens
# (logit gaps of 0.44 on the H100). The one-process run the ranks are
# held to (at DS_DIST_LOGIT_TOL)
# therefore takes the ranks' expert choices, and every choice of its own
# that differs must be a near tie: a 6th-to-7th probability margin under
# DS_ROUTE_NEAR_TIE. Sound runs on the H100 read at most 1.825e-7 (5 of
# 54,080 choices parted), so 1e-6. The same run plants perturbations of
# its router's probabilities (uniform in +-a, a in DS_ROUTE_PLANTED; they
# move only the recorded choices, not the forced run's path) and fails
# unless each reads a parted margin above the limit: a fault of that
# size in the ranks' routing would not pass
DS_ROUTE_NEAR_TIE = 1e-6
DS_ROUTE_PLANTED = (1e-4, 1e-5)
# the launcher under --mesh 2x1: smollm-135m at full width, 8 x 2,048
# tokens a step (4 x 2,048 a rank), against the one-process launcher.
# Step 1 holds to TRAIN_LOSS_TOL / TRAIN_GNORM_TOL (the same weights;
# two half-batch gradients summed against one). Later steps start from
# weights one AdamW update apart: eps 1e-8 divides the summation-order
# noise of eps-sized gradient elements into differences of up to a step
# of lr on them, so they hold to 1e-5 (loss) and 1e-4 (norm), relative.
# Two steps: the first and one later one
DIST_TRAIN_STEPS = 2
DIST_LATER_LOSS_TOL, DIST_LATER_GNORM_TOL = 1e-5, 1e-4
# a spawned group's join timeout (seconds)
DIST_JOIN_S = 900


def _dist_tokens(cfg, B, n, seed=11):
    import numpy as np
    import torch
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, n)).astype(np.int32))


def _decode_run(model, params, toks, S, T, L, device, batch=None):
    """A prefill of ``S`` tokens and ``T`` decode steps through the serve
    steps on an fp32 dense cache: (logits (B, T + 1, V) fp32 on the host,
    the cache, each decode step's ms). fp32, as the reference's own
    sharded-decode check: in a bf16 cache the ~1e-7 gaps of another
    summation order (the merged softmax, the expert-parallel MoE) flip
    some stored values by a bf16 ulp (4e-3 relative), which the
    comparison would then measure instead of the sharded path. Under a
    mesh that splits the batch, ``toks`` are the rank's rows and
    ``batch`` the global batch the cache is made for."""
    import torch

    from repro_torch.models.steps import make_prefill_step, make_serve_step
    prefill, serve = make_prefill_step(model), make_serve_step(model)
    toks = toks.to(device)
    cache = model.init_cache(batch or toks.shape[0], L, dtype=torch.float32,
                             device=device)
    lg, cache = prefill(params, cache, tokens=toks[:, :S])
    out, ms = [lg.float().cpu()], []
    for t in range(T):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, cache = serve(params, cache, toks[:, S + t:S + t + 1], S + t)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        out.append(lg.float().cpu())
    return torch.stack(out, 1), cache, ms


def _cache_bytes(cache):
    return sum(t.numel() * t.element_size() for layer in cache
               for t in layer.values())


def _rank_setup(data=1, model=2):
    """A spawned rank: the card, fp32 matmuls without TF32 (as the
    parent), and a (data, model) mesh over the gloo group (1x2 unless
    asked)."""
    import torch

    from repro_torch.launch.mesh import make_local_mesh, rank_device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = rank_device(None)
    torch.cuda.reset_peak_memory_stats(dev)
    return dev, make_local_mesh(data, model)


class _Routes:
    """Every MoE routing decision of a run (``moe._route`` wrapped): each
    call's chosen experts and its k-th to (k+1)-th probability margin,
    on the host. With ``force`` (another run's chosen experts, call by
    call) each call takes those experts instead, weighted by its own
    probabilities as ``_route`` weights its own. With ``planted``
    (amplitudes a), each call also records the choices and margins of
    its probabilities plus uniform noise in +-a (``self.planted[a]``),
    which the run does not take."""

    def __init__(self, force=None, planted=()):
        self.force, self.idx, self.margin = force, [], []
        self.planted = {a: ([], []) for a in planted}

    def __enter__(self):
        import torch

        from repro_torch.models import moe
        self._orig = orig = moe._route
        gen = {}

        def route(logits, k):
            w, idx, probs = orig(logits, k)
            top = torch.sort(probs, dim=-1, descending=True)[0]
            self.margin.append((top[:, k - 1] - top[:, k]).cpu().numpy())
            self.idx.append(idx.cpu().numpy())
            for a, (pidx, pmargin) in self.planted.items():
                g = gen.setdefault(a, torch.Generator(
                    device=probs.device).manual_seed(5))
                noise = torch.rand(probs.shape, generator=g,
                                   device=probs.device) * 2 - 1
                top, chosen = torch.topk(probs + a * noise, k + 1, dim=-1)
                pmargin.append((top[:, k - 1] - top[:, k]).cpu().numpy())
                pidx.append(chosen[:, :k].cpu().numpy())
            if self.force is not None:
                idx = torch.as_tensor(self.force[len(self.idx) - 1],
                                      device=idx.device)
                w = torch.gather(probs, -1, idx)
                w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
            return w, idx, probs

        moe._route = route
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe._route = self._orig


def _dist_decode_rank(arch, changes, B, S, T, L, routes=False):
    """One rank of a 1x2 gloo group on the card: the model at full width
    under the mesh (``Model.init`` keeps this rank's slice of every
    weight by the rules), a prefill and T decode steps; its gathered
    logits and counts (with ``routes``, its MoE routing decisions)."""
    import torch

    from repro_torch import sharding
    from repro_torch.configs.base import get_config
    from repro_torch.models.decode_sharded import seq_sharded_decode
    from repro_torch.models.model import get_model
    from repro_torch.models.moe import moe_apply
    dev, mesh = _rank_setup()
    cfg = dataclasses.replace(get_config(arch), **changes)
    model = get_model(cfg)
    with sharding.axis_rules(mesh):
        params = model.init(seed=0, device=dev)
        weights = tensor_bytes(params)
        toks = _dist_tokens(cfg, B, S + T)
        zero_launches()
        seq_sharded_decode.calls = seq_sharded_decode.all_reduces = 0
        moe_apply.all_reduces = 0
        with _Routes() as rec:
            logits, cache, ms = _decode_run(model, params, toks, S, T, L,
                                            dev)
        out = {"logits": logits.numpy(), "launches": read_launches(),
               "routes": rec.idx if routes else [],
               "blocks": read_blocks(),
               "seq_decode_calls": seq_sharded_decode.calls,
               "seq_decode_all_reduces": seq_sharded_decode.all_reduces,
               "moe_all_reduces": moe_apply.all_reduces,
               "cache_bytes": _cache_bytes(cache), "weight_bytes": weights,
               "decode_ms": ms,
               "peak_memory_bytes": torch.cuda.max_memory_allocated(dev),
               "backend": torch.distributed.get_backend()}
    return out


def _dist_train_rank(argv):
    """One rank of the train launcher under ``--mesh`` (inside the group
    it uses it): every step's time and launches, and the hist."""
    import torch
    dev, _ = _rank_setup()
    from repro_torch.launch import train
    records, undo = _step_recorder()
    try:
        hist = train.main(argv)
    finally:
        undo()
    return {"hist": hist, "records": records,
            "peak_memory_bytes": torch.cuda.max_memory_allocated(dev)}


def _run_gloo_ranks(fn, args):
    from repro_torch.launch.mesh import run_ranks
    return run_ranks(fn, 2, backend="gloo", args=args, timeout=DIST_JOIN_S)


def dist_world1_phase(device, card):
    """A world-1 NCCL group on the card and ``make_local_mesh(1, 1)``:
    kimi-k2-1t-a32b ``.reduced()``'s MoE block on the expert-parallel
    branch (capacity_factor 8: nothing dropped) against the dense one,
    and smollm-135m at full width under the mesh against no mesh, logits
    and launches equal."""
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch import sharding
    from repro_torch.configs.base import get_config
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.model import get_model
    from repro_torch.models.moe import moe_apply
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl", store=dist.FileStore(str(Path(tmp) / "store"), 1),
            rank=0, world_size=1)
        try:
            mesh = make_local_mesh(1, 1)
            kcfg = dataclasses.replace(get_config(P12B_REDUCED).reduced(),
                                       capacity_factor=8.0)
            kp = get_model(kcfg).init(seed=0, device=device)["layers"][1]
            gen = torch.Generator(device=device).manual_seed(5)
            x = torch.randn(4, 8, kcfg.d_model, generator=gen, device=device)
            y_d, aux_d = moe_apply(kcfg, kp["moe"], x)
            with sharding.axis_rules(mesh):
                y_e, aux_e = moe_apply(kcfg, kp["moe"], x)
            moe_gap = float((y_e - y_d).abs().max())
            aux_gap = abs(float(aux_e) - float(aux_d)) / float(aux_d)
            cfg = get_config(DIST_ARCH)
            model = get_model(cfg)
            params = model.init(seed=0, device=device)
            toks = _dist_tokens(cfg, 2, 260)
            zero_launches()
            plain, _, _ = _decode_run(model, params, toks, 256, 4, 512,
                                      device)
            want = read_launches()
            zero_launches()
            with sharding.axis_rules(mesh):
                meshed, _, _ = _decode_run(model, params, toks, 256, 4, 512,
                                           device)
            got = read_launches()
            backend = dist.get_backend()
        finally:
            dist.destroy_process_group()
    emit({"phase": "dist world-1", "card": card, "backend": backend,
          "moe_ep_vs_dense_max_abs": moe_gap, "moe_aux_rel": aux_gap,
          "smollm_mesh_equal": bool(torch.equal(plain, meshed)),
          "launches": got})
    if moe_gap > 3e-4 or aux_gap > 1e-3:
        raise AssertionError(f"dist world-1: expert-parallel MoE {moe_gap}, "
                             f"aux {aux_gap}")
    if not torch.equal(plain, meshed) or got != want:
        raise AssertionError(f"dist world-1: smollm under a 1x1 mesh "
                             f"differs: launches {got} vs {want}")


class _MeshShape:
    """A mesh's sizes alone (``sharding.mesh_shape`` reads ``.shape``)."""

    def __init__(self, **shape):
        self.shape = shape


def rules_weight_bytes(cfg, data=1, model=2, fsdp=False):
    """The fp32 weight bytes a device of a (data, model) mesh holds under
    the reference's rules (``Model.axes()``, ``DEFAULT_RULES``; with
    ``fsdp``, ``apply_fsdp`` on its stacked layout), from the shapes
    alone: what each rank must hold."""
    import torch

    from repro_torch import sharding
    from repro_torch.launch.dryrun import param_bytes
    from repro_torch.models.model import get_model
    return param_bytes(get_model(cfg), torch.float32,
                       _MeshShape(data=data, model=model), fsdp=fsdp,
                       rules=sharding.DEFAULT_RULES)


def _hold_weights(name, cfg, outs):
    """Each rank's weight bytes against the rules' figure, to the byte."""
    want = rules_weight_bytes(cfg)
    got = [o["weight_bytes"] for o in outs]
    if any(g != want for g in got):
        raise AssertionError(f"{name}: weight bytes a rank {got}, the "
                             f"rules place {want}")
    return want


def _hold_ranks(name, outs, want, tol):
    import numpy as np
    gaps = [float(np.abs(o["logits"] - want).max()) for o in outs]
    if max(gaps) > tol:
        raise AssertionError(f"{name}: gathered logits {gaps} over {tol}")
    return gaps


def dist_smollm_phase(device, card):
    """smollm-135m at full width on a 1x2 mesh of two gloo ranks on the
    card: every layer decodes sequence-sharded. Its gathered logits
    against the one-process card run, each rank's cache bytes half the
    one-process cache's, K4 once a layer of the prefill, K3 never, three
    all-reduces a layer of every decode step."""
    from repro_torch.configs.base import get_config
    from repro_torch.models.model import get_model
    cfg = get_config(DIST_ARCH)
    model = get_model(cfg)
    params = model.init(seed=0, device=device)
    zero_launches()
    want, cache, ms = _decode_run(model, params, _dist_tokens(
        cfg, DIST_B, DIST_S + DIST_T), DIST_S, DIST_T, DIST_L, device)
    full_bytes = _cache_bytes(cache)
    del params, cache
    outs = _run_gloo_ranks(_dist_decode_rank, (DIST_ARCH, {}, DIST_B,
                                               DIST_S, DIST_T, DIST_L))
    gaps = _hold_ranks("dist smollm", outs, want.numpy(), DIST_LOGIT_TOL)
    rules = _hold_weights("dist smollm", cfg, outs)
    L = cfg.num_layers
    for r, o in enumerate(outs):
        lw = dict.fromkeys(kernel_fns(), 0) | {"flash_attention": L}
        faults = []
        if o["launches"] != lw:
            faults.append(f"launches {o['launches']} != {lw}")
        if o["seq_decode_all_reduces"] != 3 * L * DIST_T or \
                o["seq_decode_calls"] != L * DIST_T:
            faults.append(f"{o['seq_decode_calls']} seq-sharded decodes, "
                          f"{o['seq_decode_all_reduces']} all-reduces")
        if 2 * o["cache_bytes"] != full_bytes:
            faults.append(f"cache {o['cache_bytes']} of {full_bytes}")
        if faults:
            raise AssertionError(f"dist smollm rank {r}: " + "; ".join(faults))
    emit({"phase": "dist smollm 1x2", "card": card,
          "backend": outs[0]["backend"], "ranks": 2, "batch": DIST_B,
          "prompt": DIST_S, "max_len": DIST_L, "decode_steps": DIST_T,
          "logit_max_abs_gap": gaps, "tol": DIST_LOGIT_TOL,
          "cache_bytes_rank": [o["cache_bytes"] for o in outs],
          "cache_bytes_one_process": full_bytes,
          "weight_bytes_rank": [o["weight_bytes"] for o in outs],
          "weight_bytes_by_rules": rules,
          "launches_rank": [o["launches"] for o in outs],
          "all_reduces_per_step": outs[0]["seq_decode_all_reduces"]
          / DIST_T,
          "decode_step_ms_median": {
              "one_process": sorted(ms)[len(ms) // 2],
              "ranks": [sorted(o["decode_ms"])[len(o["decode_ms"]) // 2]
                        for o in outs]},
          "peak_memory_bytes_rank": [o["peak_memory_bytes"] for o in outs]})
    return outs[0]["launches"]


def ds_dist_config(cfg):
    """deepseek's config for the distributed run: a capacity of every
    local token (capacity_factor E / k), so nothing is dropped."""
    return dataclasses.replace(
        cfg, capacity_factor=cfg.num_experts / cfg.top_k)


def ds_dist_want(cfg, params, device):
    """The one-process card run the 1x2 deepseek phase is held to (the
    dense MoE path ignores the capacity factor)."""
    model = __import__("repro_torch.models.model",
                       fromlist=["get_model"]).get_model(ds_dist_config(cfg))
    logits, _, ms = _decode_run(model, params, _dist_tokens(
        cfg, DS_DIST_B, DS_DIST_S + DS_DIST_T), DS_DIST_S, DS_DIST_T,
        DS_DIST_L, device)
    return logits.numpy(), ms


def _parted(choices, margins, routes):
    """(The decisions whose top k differs from ``routes``', the largest
    of those decisions' margins)."""
    import numpy as np
    parted, worst = 0, 0.0
    for own, forced, margin in zip(choices, routes, margins):
        diff = (np.sort(own, -1) != np.sort(forced, -1)).any(-1)
        parted += int(diff.sum())
        if diff.any():
            worst = max(worst, float(margin[diff].max()))
    return parted, worst


def ds_forced_run(cfg, device, routes):
    """The one-process card run on the ranks' expert choices
    (``routes``): (logits, (the decisions where its own top k differs,
    the largest of those decisions' margins), the same for each planted
    perturbation of ``DS_ROUTE_PLANTED``)."""
    import torch

    from repro_torch.models.model import get_model
    gc.collect()
    torch.cuda.empty_cache()
    params = get_model(cfg).init(seed=0, device=device)
    with _Routes(force=routes, planted=DS_ROUTE_PLANTED) as rec:
        logits, cache, _ = _decode_run(
            get_model(cfg), params, _dist_tokens(
                cfg, DS_DIST_B, DS_DIST_S + DS_DIST_T), DS_DIST_S,
            DS_DIST_T, DS_DIST_L, device)
    del params, cache
    return logits.numpy(), _parted(rec.idx, rec.margin, routes), {
        a: _parted(*rec.planted[a], routes) for a in DS_ROUTE_PLANTED}


def dist_deepseek_phase(card, want, device):
    """deepseek-v2-lite-16b at full width and depth on a 1x2 mesh of two
    gloo ranks on the card: MLA's heads split and its sequence-sharded
    latent decode, the dense and shared ff and the vocab split, the
    expert-parallel MoE, 32 experts a rank, each rank's weights the
    rules' bytes. The ranks' routing decisions are equal; their gathered
    logits are held to the one-process run on the ranks' expert choices
    (``ds_forced_run``), whose own choices part from them only at near
    ties (``DS_ROUTE_NEAR_TIE``), which each planted perturbation
    exceeds; ``want`` (logits, decode ms), the one-process run on its
    own choices, is read out beside. MLA and MoE calls exact, each
    rank's peak memory."""
    import numpy as np

    from repro_torch.configs.base import get_config
    cfg = ds_dist_config(get_config(P12B))
    changes = {"capacity_factor": cfg.capacity_factor}
    free_logits, ms = want
    outs = _run_gloo_ranks(_dist_decode_rank, (P12B, changes, DS_DIST_B,
                                               DS_DIST_S, DS_DIST_T,
                                               DS_DIST_L, True))
    routes = outs[0]["routes"]
    if len(routes) != len(outs[1]["routes"]) or not all(
            np.array_equal(a, b) for a, b in zip(routes, outs[1]["routes"])):
        raise AssertionError("dist deepseek: the two ranks routed apart")
    rules = _hold_weights("dist deepseek", cfg, outs)
    logits, (parted, worst), planted = ds_forced_run(cfg, device, routes)
    free_gaps = [float(np.abs(o["logits"] - free_logits).max())
                 for o in outs]
    gaps = _hold_ranks("dist deepseek", outs, logits, DS_DIST_LOGIT_TOL)
    if worst > DS_ROUTE_NEAR_TIE:
        raise AssertionError(f"dist deepseek: the one-process run's own "
                             f"routing parts from the ranks' at a margin "
                             f"of {worst} (> {DS_ROUTE_NEAR_TIE})")
    blind = {a: r for a, r in planted.items() if r[1] <= DS_ROUTE_NEAR_TIE}
    if blind:
        raise AssertionError(f"dist deepseek: planted router perturbations "
                             f"{blind} (amplitude: parted, margin) read no "
                             f"margin above {DS_ROUTE_NEAR_TIE}")
    L = cfg.num_layers
    n_moe = L - cfg.first_dense_layers
    fwd = 1 + DS_DIST_T
    for r, o in enumerate(outs):
        want_blocks = {"mla_apply": L * fwd, "moe_apply": n_moe * fwd}
        if o["blocks"] != want_blocks or any(o["launches"].values()) or \
                o["seq_decode_calls"] != L * DS_DIST_T or \
                o["moe_all_reduces"] != n_moe * fwd:
            raise AssertionError(
                f"dist deepseek rank {r}: blocks {o['blocks']} (want "
                f"{want_blocks}), launches {o['launches']}, seq-sharded "
                f"decodes {o['seq_decode_calls']}, MoE all-reduces "
                f"{o['moe_all_reduces']}")
    emit({"phase": "dist deepseek 1x2", "card": card,
          "backend": outs[0]["backend"], "ranks": 2, "batch": DS_DIST_B,
          "prompt": DS_DIST_S, "max_len": DS_DIST_L,
          "decode_steps": DS_DIST_T, "capacity_factor": cfg.capacity_factor,
          "logit_max_abs_gap": gaps, "tol": DS_DIST_LOGIT_TOL,
          "routing_decisions": sum(len(r) for r in routes),
          "own_routing_parted": parted, "parted_max_margin": worst,
          "near_tie": DS_ROUTE_NEAR_TIE,
          "planted": {str(a): {"parted": r[0], "max_margin": r[1]}
                      for a, r in planted.items()},
          "logit_max_abs_gap_own_routing": free_gaps,
          "blocks_rank": [o["blocks"] for o in outs],
          "weight_bytes_rank": [o["weight_bytes"] for o in outs],
          "weight_bytes_by_rules": rules,
          "cache_bytes_rank": [o["cache_bytes"] for o in outs],
          "decode_step_ms_median": {
              "one_process": sorted(ms)[len(ms) // 2],
              "ranks": [sorted(o["decode_ms"])[len(o["decode_ms"]) // 2]
                        for o in outs]},
          "peak_memory_bytes_rank": [o["peak_memory_bytes"] for o in outs]})


def dist_train_argv():
    """The launcher's arguments of the distributed training checks."""
    return ["--arch", TRAIN, "--steps", str(DIST_TRAIN_STEPS), "--batch",
            str(TRAIN_B), "--seq", str(TRAIN_S), "--log-every", "1"]


def dist_train_phase(card):
    """The train launcher with ``--mesh 2x1 --backend gloo`` on the card
    (two ranks, each 4 of the 8 rows a step) against the one-process
    launcher: the first step's loss and gradient norm within
    ``TRAIN_LOSS_TOL``/``TRAIN_GNORM_TOL`` (relative), later steps' within
    ``DIST_LATER_*_TOL``, and on every rank
    K4 and its backward once a layer a step and no other kernel. Returns
    the one-process history and the ranks' peak memory (the p13d group
    holds its FSDP ranks to both)."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import train
    from repro_torch.models.model import get_model
    argv = dist_train_argv()
    import torch
    records, undo = _step_recorder()
    try:
        one = train.main(argv)
    finally:
        undo()
    # the one-process run's weights, state and activations stay in this
    # process's allocator cache: the two ranks need the card
    gc.collect()
    torch.cuda.empty_cache()
    outs = _run_gloo_ranks(_dist_train_rank,
                           (argv + ["--mesh", "2x1", "--backend", "gloo"],))
    want = train_launches(get_model(get_config(TRAIN)))
    faults = []
    for r, o in enumerate(outs):
        _launch_counts(f"{TRAIN} --mesh 2x1 rank {r}", o["records"], want)
        for a, b in zip(one, o["hist"]):
            lt, gt = ((TRAIN_LOSS_TOL, TRAIN_GNORM_TOL) if a["step"] == 1
                      else (DIST_LATER_LOSS_TOL, DIST_LATER_GNORM_TOL))
            if abs(a["loss"] - b["loss"]) > lt * abs(a["loss"]):
                faults.append(f"rank {r} step {a['step']} loss {b['loss']}"
                              f" vs {a['loss']}")
            if abs(a["grad_norm"] - b["grad_norm"]) > \
                    gt * abs(a["grad_norm"]):
                faults.append(f"rank {r} step {a['step']} grad norm "
                              f"{b['grad_norm']} vs {a['grad_norm']}")
    med = lambda rs: sorted(x["s"] for x in rs[1:])[len(rs[1:]) // 2] * 1e3
    emit({"phase": "dist train --mesh 2x1", "card": card, "backend": "gloo",
          "batch": TRAIN_B, "seq": TRAIN_S, "steps": DIST_TRAIN_STEPS,
          "loss": {"one_process": [h["loss"] for h in one],
                   "ranks": [[h["loss"] for h in o["hist"]] for o in outs]},
          "grad_norm": {"one_process": [h["grad_norm"] for h in one],
                        "ranks": [[h["grad_norm"] for h in o["hist"]]
                                  for o in outs]},
          "step_ms_median": {"one_process": med(records),
                             "ranks": [med(o["records"]) for o in outs]},
          "launches_per_step": want,
          "peak_memory_bytes_rank": [o["peak_memory_bytes"] for o in outs],
          "faults": faults})
    if faults:
        raise AssertionError("dist train: " + "; ".join(faults))
    return one, [o["peak_memory_bytes"] for o in outs]


def dist_group(device, timed, card, ds_want, rows):
    """P13a on the card: the world-1 NCCL check, then smollm-135m and
    deepseek-v2-lite-16b on two gloo ranks (NCCL takes one rank a card;
    gloo stages CUDA tensors through the host, so these are correctness
    gates, not speed claims), then the launcher under --mesh 2x1. The
    kernel rows of K3 and K4 take a rank's launches in the smollm run.
    Returns what ``dist_train_phase`` does."""
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    timed("dist world-1", dist_world1_phase, device, card)
    gc.collect()
    torch.cuda.empty_cache()
    launches = timed("dist smollm 1x2", dist_smollm_phase, device, card)
    for k in ("decode_attention", "flash_attention"):
        rows[k]["launches_p13a"] = {"smollm-135m 1x2, a rank": launches[k]}
    gc.collect()
    torch.cuda.empty_cache()
    timed("dist deepseek 1x2", dist_deepseek_phase, card, ds_want, device)
    gc.collect()
    torch.cuda.empty_cache()
    return timed("dist train --mesh 2x1", dist_train_phase, card)


# ------------------- P13d: the ZeRO-3 placement (--fsdp), gloo ranks

# deepseek-v2-lite-16b at full width cut to its dense first layer and one
# MoE layer (MLA in both): 4,341,149,696 B of fp32 weights, half a rank
# under FSDP on (data 2, model 1). Each rank: a prefill of its 2 of 4
# prompts of P13D_DS_S tokens and P13D_DS_T decode steps into a
# P13D_DS_L-slot fp32 cache, then 2 AdamW steps (the factored moment,
# which the reference's dry-run takes at 64 experts) on its half of 4 x
# P13D_DS_S tokens a step; once without FSDP, then with it, from the
# same seeded weights (4 decode steps since P13e, 8 before: each gathers
# the layers' split weights through gloo)
P13D_DS = "deepseek-v2-lite-16b"
P13D_DS_LAYERS = 2
P13D_DS_B, P13D_DS_S, P13D_DS_T, P13D_DS_L = 4, 512, 4, 1024
P13D_DS_LR = 3e-4


def _p13d_ds_rank(layers, B, S, T, L):
    """One rank of a (data 2, model 1) gloo group on the card: deepseek at
    the ``layers`` cut, without FSDP and then with it (module comment
    above). Returns, for each run: its weight and moment bytes, peak
    memory (and the bytes allocated as it starts), decode logits, the
    train steps' metrics; and whether step 1's gradients (the FSDP slice
    of each, on the host) are bit-equal."""
    import torch

    from repro_torch import sharding
    from repro_torch.configs.base import get_config
    from repro_torch.models import steps
    from repro_torch.models.model import get_model
    from repro_torch.training import optim
    dev, mesh = _rank_setup(data=2, model=1)
    cfg = ds_dist_config(dataclasses.replace(get_config(P13D_DS),
                                             num_layers=layers))
    model = get_model(cfg)
    ocfg = optim.AdamWConfig(lr=P13D_DS_LR, warmup_steps=1, total_steps=10,
                             factored=True)
    toks = _dist_tokens(cfg, B, S + T)
    batches = [{"tokens": t, "labels": t} for t in (
        _dist_tokens(cfg, B, S, seed=21 + i).to(dev) for i in range(2))]
    placed = [a for _, a in sharding._walk(
        model.abstract(), sharding.placed_axes(model, mesh, fsdp=True))]
    real_vg, out, host = steps.value_and_grad, {}, {}
    for fsdp in (False, True):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        start = torch.cuda.memory_allocated(dev)

        def captured(*args, **kw):
            # step 1's gradients on the host, at the FSDP slices (the
            # device keeps no extra copy)
            got = real_vg(*args, **kw)
            if fsdp not in host:
                host[fsdp] = [(g if fsdp else sharding.local_slice(g, a))
                              .cpu() for g, a in
                              zip(optim.tree_leaves(got[2]), placed)]
            return got
        with sharding.axis_rules(mesh, fsdp=fsdp):
            params = model.init(seed=0, device=dev)
            state = steps.init_opt_state(model, ocfg, params)
            weights, moments = tensor_bytes(params), tensor_bytes(state["mu"])
            logits, cache, _ = _decode_run(
                model, params, sharding.local_slice(toks, ("batch", None)),
                S, T, L, dev, batch=B)
            del cache
            step = steps.make_train_step(model, ocfg, remat=False)
            steps.value_and_grad = captured
            try:
                metrics = []
                for b in batches:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    params, state, m = step(params, state, b)
                    metrics.append({k: float(m[k]) for k in
                                    ("loss", "grad_norm")} |
                                   {"ms": (time.perf_counter() - t0) * 1e3})
            finally:
                steps.value_and_grad = real_vg
            counts = dict(sharding.fsdp_gather.counts)
            out[f"fsdp{int(fsdp)}"] = {
                "weight_bytes": weights, "moment_bytes": moments,
                "allocated_at_start_bytes": start,
                "peak_memory_bytes": torch.cuda.max_memory_allocated(dev),
                "logits": logits.numpy(), "metrics": metrics,
                "fsdp_collectives": {f"{k} over {n}": v
                                     for (k, n), v in counts.items()}}
            del params, state, step, m
            sharding.fsdp_gather.counts.clear()
    out["grads_equal"] = all(torch.equal(a, b)
                             for a, b in zip(host[False], host[True]))
    return out


def p13d_smollm_phase(card, one, mesh_peaks):
    """smollm-135m at full width through the launcher with ``--mesh 2x1
    --backend gloo --fsdp``: each rank's weight bytes the rules' FSDP
    figure to the byte and its moments twice that; K4 and its backward
    once a layer a step; the loss and gradient norm against the one-
    process launcher's (``dist_train_phase``'s run, not repeated) within
    the tolerances ``dist_train_phase`` holds the mesh to; each rank's
    peak memory beside the ranks' without FSDP."""
    from repro_torch.configs.base import get_config
    from repro_torch.models.model import get_model
    cfg = get_config(TRAIN)
    outs = _run_gloo_ranks(_dist_train_rank, (
        dist_train_argv() + ["--mesh", "2x1", "--backend", "gloo",
                             "--fsdp"],))
    want = train_launches(get_model(cfg))
    rules = rules_weight_bytes(cfg, data=2, model=1, fsdp=True)
    faults = []
    for r, o in enumerate(outs):
        _launch_counts(f"{TRAIN} --fsdp rank {r}", o["records"], want)
        for rec in o["records"]:
            if rec["weight_bytes"] != rules or \
                    rec["moment_bytes"] != 2 * rules:
                faults.append(f"rank {r}: weights {rec['weight_bytes']}, "
                              f"moments {rec['moment_bytes']}, the rules "
                              f"place {rules}")
        for a, b in zip(one, o["hist"]):
            lt, gt = ((TRAIN_LOSS_TOL, TRAIN_GNORM_TOL) if a["step"] == 1
                      else (DIST_LATER_LOSS_TOL, DIST_LATER_GNORM_TOL))
            if abs(a["loss"] - b["loss"]) > lt * abs(a["loss"]):
                faults.append(f"rank {r} step {a['step']} loss {b['loss']}"
                              f" vs {a['loss']}")
            if abs(a["grad_norm"] - b["grad_norm"]) > \
                    gt * abs(a["grad_norm"]):
                faults.append(f"rank {r} step {a['step']} grad norm "
                              f"{b['grad_norm']} vs {a['grad_norm']}")
        if len(o["hist"]) != len(one):
            faults.append(f"rank {r}: {len(o['hist'])} steps")
    med = lambda rs: sorted(x["s"] for x in rs[1:])[len(rs[1:]) // 2] * 1e3
    peaks = [o["peak_memory_bytes"] for o in outs]
    emit({"phase": "p13d smollm --mesh 2x1 --fsdp", "card": card,
          "backend": "gloo", "batch": TRAIN_B, "seq": TRAIN_S,
          "steps": DIST_TRAIN_STEPS,
          "weight_bytes_rank": [o["records"][0]["weight_bytes"]
                                for o in outs],
          "moment_bytes_rank": [o["records"][0]["moment_bytes"]
                                for o in outs],
          "weight_bytes_by_rules": rules,
          "weight_bytes_whole": rules_weight_bytes(cfg, data=1, model=1),
          "loss": {"one_process": [h["loss"] for h in one],
                   "ranks": [[h["loss"] for h in o["hist"]] for o in outs]},
          "grad_norm": {"one_process": [h["grad_norm"] for h in one],
                        "ranks": [[h["grad_norm"] for h in o["hist"]]
                                  for o in outs]},
          "step_ms_median_rank": [med(o["records"]) for o in outs],
          "launches_per_step": want,
          "peak_memory_bytes_rank": peaks,
          "peak_memory_bytes_rank_without_fsdp": mesh_peaks,
          "peak_saved_bytes_rank": [b - a for a, b in zip(peaks,
                                                         mesh_peaks)],
          "faults": faults})
    if faults:
        raise AssertionError("p13d smollm: " + "; ".join(faults))
    return want


def p13d_deepseek_phase(card):
    """deepseek at its 2-layer cut on (data 2, model 1), each rank without
    and with FSDP (``_p13d_ds_rank``): the FSDP weights the rules' figure
    to the byte (half the whole), the decode logits and step 1's loss
    and gradients bit-equal, the gradient norm within
    ``TRAIN_GNORM_TOL`` and step 2 within ``DIST_LATER_*_TOL``
    (relative)."""
    import numpy as np

    from repro_torch.configs.base import get_config
    cfg = dataclasses.replace(get_config(P13D_DS), num_layers=P13D_DS_LAYERS)
    outs = _run_gloo_ranks(_p13d_ds_rank, (P13D_DS_LAYERS, P13D_DS_B,
                                           P13D_DS_S, P13D_DS_T, P13D_DS_L))
    rules = rules_weight_bytes(cfg, data=2, model=1, fsdp=True)
    whole = rules_weight_bytes(cfg, data=1, model=1)
    faults = []
    for r, o in enumerate(outs):
        a, b = o["fsdp0"], o["fsdp1"]
        if b["weight_bytes"] != rules or a["weight_bytes"] != whole:
            faults.append(f"rank {r}: weights {b['weight_bytes']} with FSDP"
                          f" ({rules} by the rules), {a['weight_bytes']} "
                          f"without ({whole})")
        if not np.array_equal(a["logits"], b["logits"]):
            faults.append(f"rank {r}: decode logits differ by "
                          f"{float(np.abs(a['logits'] - b['logits']).max())}")
        if not o["grads_equal"]:
            faults.append(f"rank {r}: step 1's gradients differ")
        m0, m1 = a["metrics"], b["metrics"]
        if m0[0]["loss"] != m1[0]["loss"]:
            faults.append(f"rank {r}: step 1 loss {m1[0]['loss']} vs "
                          f"{m0[0]['loss']}")
        for i, (x, y) in enumerate(zip(m0, m1)):
            lt, gt = ((0.0, TRAIN_GNORM_TOL) if i == 0 else
                      (DIST_LATER_LOSS_TOL, DIST_LATER_GNORM_TOL))
            if abs(x["loss"] - y["loss"]) > lt * abs(x["loss"]) or \
                    abs(x["grad_norm"] - y["grad_norm"]) > \
                    gt * abs(x["grad_norm"]):
                faults.append(f"rank {r} step {i + 1}: {y} vs {x}")
    emit({"phase": "p13d deepseek 2x1 --fsdp", "card": card,
          "backend": "gloo", "layers": P13D_DS_LAYERS, "batch": P13D_DS_B,
          "prompt": P13D_DS_S, "decode_steps": P13D_DS_T,
          "max_len": P13D_DS_L, "train_steps": 2,
          "weight_bytes_whole": whole, "weight_bytes_by_rules": rules,
          **{f"{k}_rank": [[o[f"fsdp{i}"][k] for i in (0, 1)]
                           for o in outs]
             for k in ("weight_bytes", "moment_bytes", "peak_memory_bytes",
                       "metrics")},
          "logits_bit_equal": [bool(np.array_equal(o["fsdp0"]["logits"],
                                                   o["fsdp1"]["logits"]))
                               for o in outs],
          "step1_grads_bit_equal": [o["grads_equal"] for o in outs],
          "allocated_at_start_bytes_rank": [
              [o[f"fsdp{i}"]["allocated_at_start_bytes"] for i in (0, 1)]
              for o in outs],
          "fsdp_collectives_rank0": outs[0]["fsdp1"]["fsdp_collectives"],
          "faults": faults})
    if faults:
        raise AssertionError("p13d deepseek: " + "; ".join(faults))


def p13d_group(device, timed, card, rows, one, mesh_peaks):
    """P13d on the card: the ZeRO-3 placement on two gloo ranks as (data
    2, model 1), smollm through the launcher (``p13d_smollm_phase``) and
    deepseek at a 2-layer cut against the same mesh without FSDP
    (``p13d_deepseek_phase``). Correctness and memory gates, not speed
    claims: gloo stages every gather through the host. K4's rows take a
    rank's launches a step."""
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    want = timed("p13d smollm --fsdp", p13d_smollm_phase, card, one,
                 mesh_peaks)
    for k in ("flash_attention", "flash_attention_bwd"):
        rows[k]["launches_p13d"] = {
            f"{TRAIN} --mesh 2x1 --fsdp, a rank a step": want[k]}
    gc.collect()
    torch.cuda.empty_cache()
    timed("p13d deepseek --fsdp", p13d_deepseek_phase, card)


# ------------- P13e: every mesh placement the reference runs, gloo ranks

# smollm-135m at full width cut to its first 2 layers. G1: a cache the
# model axis does not divide: 1,033 slots on (data 1, model 2), which the
# reference keeps whole (3 kv heads and 1,033 slots split over neither),
# so every rank holds every slot and decodes through K3. G2: a global
# batch of 3 on (data 2, model 1), without and with --fsdp: every rank
# holds the whole batch (the reference replicates it)
P13E_ARCH, P13E_LAYERS = "smollm-135m", 2
P13E_B, P13E_S, P13E_T, P13E_L = 8, 1024, 8, 1033
P13E_TRAIN_B, P13E_TRAIN_S = 3, 1024
# the mid-head cases at .reduced() with the widths changed so that a
# model axis of 2 splits them mid-head (no published config meets them
# at the meshes the port runs): (arch, changes, max_len). straddle: 12 q
# heads on 3 kv heads, whose local 6 q heads straddle kv groups, its
# 24-slot cache sequence-sharded; straddle-whole the same at 25 slots,
# its cache whole (K3 reads each q head's kv head)
P13E_MID = {
    "mla-mid": ("deepseek-v2-lite-16b", {"num_heads": 3, "num_kv_heads": 3,
                                         "capacity_factor": 8.0}, 24),
    "ssm-mid": ("mamba2-370m", {"d_model": 96, "ssm_head_dim": 64}, 24),
    "straddle": ("qwen3-4b", {"num_heads": 12, "num_kv_heads": 3}, 24),
    "straddle-whole": ("qwen3-4b", {"num_heads": 12, "num_kv_heads": 3},
                       25),
    "rglru-mid": ("recurrentgemma-9b", {"lru_width": 192,
                                        "lru_diag_blocks": 3}, 24),
}
P13E_MID_B, P13E_MID_S, P13E_MID_T = 2, 20, 4
# the straddling heads on the paged pool (every kv head on each rank):
# one chunk run of P13E_PAGED_S tokens a row, then P13E_MID_T decode steps
P13E_PAGE, P13E_PAGED_S = 16, 32


def _p13e_cfg(case):
    from repro_torch.configs.base import get_config
    if case == "g1":
        return dataclasses.replace(get_config(P13E_ARCH),
                                   num_layers=P13E_LAYERS)
    arch, changes, _ = P13E_MID[case]
    return dataclasses.replace(get_config(arch).reduced(), **changes)


def _p13e_paged(model, params, toks, device):
    """One chunk run of P13E_PAGED_S tokens a row into a fresh fp32 pool
    (pages of P13E_PAGE, page 0 the scratch page), then P13E_MID_T paged
    decode steps: logits (B, T + 1, V) on the host."""
    import torch

    from repro_torch import sharding
    from repro_torch.models.steps import (make_chunked_prefill_step,
                                          make_paged_serve_step)
    cfg = model.cfg
    B, T = toks.shape[0], P13E_MID_T
    n = -(-(P13E_PAGED_S + T) // P13E_PAGE)
    shape = sharding.local_shape((1 + B * n, P13E_PAGE, cfg.num_kv_heads,
                                  cfg.head_dim),
                                 (None, None, "kv_heads", None))
    pool = [{"k_pages": torch.zeros(shape, device=device),
             "v_pages": torch.zeros(shape, device=device)}
            for _ in range(cfg.num_layers)]
    table = torch.arange(1, 1 + B * n, dtype=torch.int32,
                         device=device).reshape(B, n)
    toks = toks.to(device)
    lg, pool = make_chunked_prefill_step(model)(
        params, pool, toks[:, :P13E_PAGED_S],
        torch.zeros(B, dtype=torch.int32, device=device), table,
        table[:, :P13E_PAGED_S // P13E_PAGE])
    out = [lg[:, -1].float().cpu()]
    serve = make_paged_serve_step(model)
    for t in range(T):
        lg, pool = serve(params, pool, toks[:, P13E_PAGED_S + t:
                                            P13E_PAGED_S + t + 1],
                         torch.full((B,), P13E_PAGED_S + t,
                                    dtype=torch.int32, device=device),
                         table)
        out.append(lg.float().cpu())
    return torch.stack(out, 1)


def _p13e_decode(case, device, paged=False):
    """A prefill and decode steps of one p13e case (``g1`` or a mid-head
    case) on fp32 caches, under the current mesh or none: (logits, each
    layer's cache split over "model" or not)."""
    from repro_torch.models.decode_sharded import SeqSplitCache
    from repro_torch.models.model import get_model
    cfg = _p13e_cfg(case)
    model = get_model(cfg)
    params = model.init(seed=0, device=device)
    if case == "g1":
        B, S, T, L = P13E_B, P13E_S, P13E_T, P13E_L
    else:
        B, S, T, L = (P13E_MID_B, P13E_MID_S, P13E_MID_T,
                      P13E_MID[case][2])
    toks = _dist_tokens(cfg, B, max(S, P13E_PAGED_S) + T)
    if paged:
        return _p13e_paged(model, params, toks, device), []
    logits, cache, _ = _decode_run(model, params, toks, S, T, L, device)
    return logits, [isinstance(c, SeqSplitCache) for c in cache]


def _p13e_expected(case, split, paged):
    """The launches a p13e run must make, from its model and its caches'
    layout: K4 once a prefill for each attention layer (K2 on the pool),
    K5 and K6 once for each SSM and RG-LRU layer; a decode step K3 for
    each attention layer whose cache is whole (K1 on the pool), the
    sequence-sharded region for each attention or MLA layer whose cache
    is split."""
    from repro_torch.models.model import get_model
    model = get_model(_p13e_cfg(case))
    T = P13E_T if case == "g1" else P13E_MID_T
    bts = model.block_types
    attn = sum(bt == "attn" for bt in bts)
    seq = sum(split)
    whole = attn - sum(s for s, bt in zip(split, bts) if bt == "attn")
    want = {k: 0 for k in kernel_fns()}
    want["ssd_chunk"] = sum(bt == "ssm" for bt in bts)
    want["rglru_scan"] = sum(bt == "rglru" for bt in bts)
    if paged:
        want["chunked_prefill_attention"] = attn
        want["paged_decode_attention"] = T * attn
    else:
        want["flash_attention"] = attn
        want["decode_attention"] = T * whole
    return want, T * seq


def _p13e_rank(grads_path):
    """One rank of the 2-rank gloo group: G1 and the mid-head cases on
    (data 1, model 2), each's gathered logits, launches and sequence-
    sharded calls; then G2 on (data 2, model 1): step 1's gradients of a
    global batch of 3 against one process's (``grads_path``), without and
    with FSDP, and the launcher's two steps."""
    import torch

    from repro_torch import sharding
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import steps
    from repro_torch.models.decode_sharded import seq_sharded_decode
    from repro_torch.models.model import get_model
    from repro_torch.training import optim
    dev, mesh = _rank_setup()
    out = {}
    for case, paged in [("g1", False)] + [(c, False) for c in P13E_MID] + \
            [("straddle", True)]:
        with sharding.axis_rules(mesh):
            zero_launches()
            seq_sharded_decode.calls = 0
            t0 = time.perf_counter()
            logits, split = _p13e_decode(case, dev, paged)
            torch.cuda.synchronize()
            out[case + (" paged" if paged else "")] = {
                "logits": logits.numpy(), "split": split,
                "launches": read_launches(),
                "seq_calls": seq_sharded_decode.calls,
                "s": time.perf_counter() - t0}
    cfg = _p13e_cfg("g1")
    model = get_model(cfg)
    want = torch.load(grads_path)
    toks = _dist_tokens(cfg, P13E_TRAIN_B, P13E_TRAIN_S, seed=31).to(dev)
    data = make_local_mesh(2, 1)
    for fsdp in (False, True):
        with sharding.axis_rules(data, fsdp=fsdp):
            params = model.init(seed=0, device=dev)
            loss, parts, grads = steps.value_and_grad(
                model, params, {"tokens": toks, "labels": toks})
            axes = [a for _, a in sharding._walk(
                model.abstract(), sharding.placed_axes(model))]
            worst = 0.0
            for g, a, s, w in zip(optim.tree_leaves(grads), axes,
                                  optim.tree_leaves(model.abstract()),
                                  want["grads"]):
                g = sharding.gather_global(g, a, s.shape).cpu()
                worst = max(worst, float((g - w).abs().max())
                            / max(float(w.abs().max()), 1e-30))
            del params, grads
        argv = (["--arch", P13E_ARCH, "--layers", str(P13E_LAYERS),
                 "--steps", "2", "--batch", str(P13E_TRAIN_B), "--seq",
                 str(P13E_TRAIN_S), "--log-every", "1", "--mesh", "2x1",
                 "--backend", "gloo"] + (["--fsdp"] if fsdp else []))
        zero_launches()
        hist = train.main(argv)
        out[f"g2 fsdp{int(fsdp)}"] = {
            "loss": float(loss), "ce": float(parts["ce"]),
            "grad_leaf_worst": worst, "hist": hist,
            "launches": read_launches()}
    return out


def p13e_phase(device, card):
    """P13e on two gloo ranks of the card (``_p13e_rank``), each case held
    to one process on the card: G1's and the mid-head cases' gathered
    logits within DIST_LOGIT_TOL, their launches the layout's
    (``_p13e_expected``); G2's step-1 loss within TRAIN_LOSS_TOL, ce
    equal to the loss (no MoE), every gradient leaf within
    TRAIN_GRAD_TOL of its largest, and the launcher's two steps within
    the tolerances ``dist_train_phase`` holds the mesh to. Returns a
    rank's launches of each case."""
    import tempfile

    import numpy as np
    import torch

    from repro_torch.launch import train
    from repro_torch.models import steps
    from repro_torch.models.model import get_model
    from repro_torch.training import optim
    one = {}
    for case, paged in [("g1", False)] + [(c, False) for c in P13E_MID] + \
            [("straddle", True)]:
        one[case + (" paged" if paged else "")] = \
            _p13e_decode(case, device, paged)[0].numpy()
    cfg = _p13e_cfg("g1")
    model = get_model(cfg)
    toks = _dist_tokens(cfg, P13E_TRAIN_B, P13E_TRAIN_S, seed=31).to(device)
    params = model.init(seed=0, device=device)
    loss1, parts1, grads1 = steps.value_and_grad(
        model, params, {"tokens": toks, "labels": toks})
    hist1 = train.main(["--arch", P13E_ARCH, "--layers", str(P13E_LAYERS),
                        "--steps", "2", "--batch", str(P13E_TRAIN_B),
                        "--seq", str(P13E_TRAIN_S), "--log-every", "1"])
    del params
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "grads.pt")
        torch.save({"grads": [g.cpu() for g in optim.tree_leaves(grads1)]},
                   path)
        del grads1
        gc.collect()
        torch.cuda.empty_cache()
        outs = _run_gloo_ranks(_p13e_rank, (path,))
    faults, gaps = [], {}
    for r, o in enumerate(outs):
        for case, want in one.items():
            got = o[case]
            gap = float(np.abs(got["logits"] - want).max())
            gaps[f"{case} rank {r}"] = gap
            if not np.allclose(got["logits"], want, rtol=DIST_LOGIT_TOL,
                               atol=DIST_LOGIT_TOL):
                faults.append(f"rank {r} {case}: logits {gap} from one "
                              f"process")
            exp, seq = _p13e_expected(case.split()[0], got["split"],
                                      case.endswith("paged"))
            if case == "g1" and any(got["split"]):
                faults.append(f"rank {r} g1: a cache split over 'model'")
            if got["launches"] != exp or got["seq_calls"] != seq:
                faults.append(f"rank {r} {case}: launches "
                              f"{got['launches']}, seq calls "
                              f"{got['seq_calls']}; the layout gives {exp},"
                              f" {seq}")
        for fsdp in (0, 1):
            g = o[f"g2 fsdp{fsdp}"]
            if abs(g["loss"] - float(loss1)) > TRAIN_LOSS_TOL * \
                    abs(float(loss1)) or g["ce"] != g["loss"]:
                faults.append(f"rank {r} g2 fsdp{fsdp}: loss {g['loss']}, "
                              f"ce {g['ce']}, one process {float(loss1)}")
            if not g["grad_leaf_worst"] <= TRAIN_GRAD_TOL:
                faults.append(f"rank {r} g2 fsdp{fsdp}: a gradient leaf "
                              f"{g['grad_leaf_worst']} of its largest from "
                              f"one process")
            for a, b in zip(hist1, g["hist"]):
                lt, gt = ((TRAIN_LOSS_TOL, TRAIN_GNORM_TOL)
                          if a["step"] == 1 else
                          (DIST_LATER_LOSS_TOL, DIST_LATER_GNORM_TOL))
                if abs(a["loss"] - b["loss"]) > lt * abs(a["loss"]) or \
                        abs(a["grad_norm"] - b["grad_norm"]) > \
                        gt * abs(a["grad_norm"]):
                    faults.append(f"rank {r} g2 fsdp{fsdp} launcher step "
                                  f"{a['step']}: {b} vs {a}")
            if len(g["hist"]) != len(hist1):
                faults.append(f"rank {r} g2 fsdp{fsdp}: {len(g['hist'])} "
                              f"launcher steps")
    emit({"phase": "p13e placements", "card": card, "backend": "gloo",
          "g1": {"arch": P13E_ARCH, "layers": P13E_LAYERS, "batch": P13E_B,
                 "prompt": P13E_S, "decode_steps": P13E_T,
                 "max_len": P13E_L},
          "mid": {k: {"arch": a, "changes": c, "max_len": L}
                  for k, (a, c, L) in P13E_MID.items()},
          "g2": {"batch": P13E_TRAIN_B, "seq": P13E_TRAIN_S,
                 "loss_one_process": float(loss1),
                 "launcher_one_process": hist1,
                 "ranks": [{k: {kk: vv for kk, vv in o[k].items()
                                if kk != "launches"}
                            for k in ("g2 fsdp0", "g2 fsdp1")}
                           for o in outs]},
          "logit_gaps": gaps,
          "launches_rank0": {k: v["launches"] for k, v in outs[0].items()
                             if "logits" in v},
          "seconds_rank0": {k: v["s"] for k, v in outs[0].items()
                            if "s" in v},
          "tolerance": {"logits": DIST_LOGIT_TOL, "loss": TRAIN_LOSS_TOL,
                        "grad_leaf": TRAIN_GRAD_TOL},
          "faults": faults})
    if faults:
        raise AssertionError("p13e: " + "; ".join(faults))
    return {k: v["launches"] for k, v in outs[0].items() if "logits" in v}


def p13e_group(device, timed, card, rows):
    """P13e on the card: G1, G2 (with and without --fsdp) and the five
    mid-head cases on two gloo ranks against one process
    (``p13e_phase``). Correctness gates, not speed claims. The kernel
    rows take a rank's launches of each case."""
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    launches = timed("p13e placements", p13e_phase, device, card)
    for case, got in launches.items():
        for k, n in got.items():
            if n:
                rows[k].setdefault("launches_p13e", {})[
                    f"{case}, a rank"] = n


# ------------- P13c: weights placed by the rules, qwen3-32b on the card

P13C = "qwen3-32b"
# one process on the paged main path: the first 28 of its 64 layers at
# full widths, 28 x 1.950 GB + 6.223 GB of embedding tables = 60.8 GB of
# fp32 weights (deepseek's 62.8 GB already load on the card)
P13C_LAYERS = 28
# tensor parallel on a (data 1, model 2) mesh of two gloo ranks on the
# card: the first 4 layers (8 before P13e), each rank 4 x 0.975 GB +
# 3.11 GB of its vocab halves; 4 rows of 256-token prompts, 8 decode
# steps, a 512-slot fp32 cache (fp32 as the P13a comparisons: a bf16
# cache turns another summation order's ~1e-7 gaps into bf16-ulp flips)
P13C_TP_LAYERS = 4
P13C_B, P13C_S, P13C_T, P13C_L = 4, 256, 8, 512
# the ranks' gathered logits against one process on the same cut: the
# reference's own tolerance for a sharded decode against a single
# device (tests/test_system.py, rtol/atol 3e-4), as DIST_LOGIT_TOL
P13C_TP_TOL = DIST_LOGIT_TOL


def _p13c_tp_rank(layers, B, S, T, L):
    """One rank of a (data 1, model 2) gloo group on the card: qwen3-32b
    cut to ``layers`` at full widths, its weights drawn whole and sliced
    by the rules (``Model.init`` under the mesh), a prefill and T decode
    steps on an fp32 cache; its gathered logits, launches, heads and
    bytes."""
    import torch

    from repro_torch import sharding
    from repro_torch.configs.base import get_config
    from repro_torch.models.model import get_model
    dev, mesh = _rank_setup()
    cfg = dataclasses.replace(get_config(P13C), num_layers=layers)
    model = get_model(cfg)
    with sharding.axis_rules(mesh):
        params = model.init(seed=0, device=dev)
        weights = tensor_bytes(params)
        toks = _dist_tokens(cfg, B, S + T)
        zero_launches()
        logits, cache, ms = _decode_run(model, params, toks, S, T, L, dev)
        return {"logits": logits.numpy(), "launches": read_launches(),
                "weight_bytes": weights, "cache_bytes": _cache_bytes(cache),
                "q_heads": params["layers"][0]["mixer"]["wq"].shape[1]
                // cfg.head_dim,
                "kv_heads": cache[0]["k"].shape[2],
                "ff": params["layers"][0]["mlp"]["w_down"].shape[0],
                "vocab": params["embed"].shape[0], "decode_ms": ms,
                "peak_memory_bytes": torch.cuda.max_memory_allocated(dev),
                "backend": torch.distributed.get_backend()}


def p13c_tp_phase(cfg, want, card):
    """qwen3-32b on two gloo ranks as (data 1, model 2): each rank's
    weights exactly the rules' (to the byte), 32 q and 4 kv heads, half
    of ff and vocab; K4 once a layer of the prefill and K3 once a layer
    a step on each rank, no other kernel; the gathered logits within
    ``P13C_TP_TOL`` of the one-process run ``want`` (logits, decode ms)
    on the same cut."""
    logits, ms = want
    outs = _run_gloo_ranks(_p13c_tp_rank, (P13C_TP_LAYERS, P13C_B, P13C_S,
                                           P13C_T, P13C_L))
    gaps = _hold_ranks("p13c tp", outs, logits, P13C_TP_TOL)
    rules = _hold_weights("p13c tp", cfg, outs)
    L = cfg.num_layers
    lw = dict.fromkeys(kernel_fns(), 0) | {"flash_attention": L,
                                          "decode_attention": L * P13C_T}
    for r, o in enumerate(outs):
        shape = (o["q_heads"], o["kv_heads"], o["ff"], o["vocab"])
        if o["launches"] != lw or shape != (
                cfg.num_heads // 2, cfg.num_kv_heads // 2, cfg.d_ff // 2,
                cfg.vocab_size // 2):
            raise AssertionError(f"p13c tp rank {r}: launches "
                                 f"{o['launches']} (want {lw}), q/kv heads,"
                                 f" ff, vocab {shape}")
    emit({"phase": "p13c tp 1x2", "card": card, "model": cfg.name,
          "layers": L, "of": 64, "backend": outs[0]["backend"], "ranks": 2,
          "batch": P13C_B, "prompt": P13C_S, "max_len": P13C_L,
          "decode_steps": P13C_T, "logit_max_abs_gap": gaps,
          "tol": P13C_TP_TOL,
          "weight_bytes_rank": [o["weight_bytes"] for o in outs],
          "weight_bytes_by_rules": rules,
          "cache_bytes_rank": [o["cache_bytes"] for o in outs],
          "q_heads_rank": outs[0]["q_heads"],
          "kv_heads_rank": outs[0]["kv_heads"],
          "launches_rank": [o["launches"] for o in outs],
          "decode_step_ms_median": {
              "one_process": sorted(ms)[len(ms) // 2],
              "ranks": [sorted(o["decode_ms"])[len(o["decode_ms"]) // 2]
                        for o in outs]},
          "peak_memory_bytes_rank": [o["peak_memory_bytes"] for o in outs]})
    return outs[0]["launches"]


def p13c_group(device, timed, card, rows):
    """P13c on the card, after everything else is freed: qwen3-32b at
    ``P13C_LAYERS`` of 64 layers on the paged main path (the quickstart
    traffic through ``TickOrchestrator``, K1/K2 launches exact); the
    replay of the card against the CPU at the 2-layer cut; the one-process
    decode at the ``P13C_TP_LAYERS`` cut, then the same cut tensor
    parallel on two gloo ranks (``p13c_tp_phase``). The kernel rows take
    the main path's K1/K2 launches and a rank's K3/K4."""
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.models.model import get_model
    from repro_torch.serving.batcher import PagedContinuousBatcher
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": f"memory before {P13C}",
          "memory_allocated_bytes": torch.cuda.memory_allocated()})
    full = get_config(P13C)
    cfg = dataclasses.replace(full, num_layers=P13C_LAYERS)
    params = timed(f"init {P13C}", get_model(cfg).init, seed=0,
                   device=device)
    emit({"phase": f"params {P13C}", "layers": P13C_LAYERS,
          "of": full.num_layers,
          "parameters": sum(t.numel() for t in _tensors(params)),
          "weight_bytes": tensor_bytes(params),
          "memory_allocated_bytes": torch.cuda.memory_allocated()})
    launches, _, _ = timed(P13C, serve_path, P13C, cfg, params, device)
    for k in ("paged_decode_attention", "chunked_prefill_attention"):
        rows[k].setdefault("launches_p13c", {})[
            f"{P13C} {P13C_LAYERS} layers"] = launches[k]
    ccfg, cut = cut_model(cfg, params)
    cpu = torch.device("cpu")
    runs = [(device, cut), (cpu, params_to(cut, cpu))]
    timed(f"replay {P13C}", replay, f"replay {P13C}", ccfg, runs,
          lambda dev, p: PagedContinuousBatcher(
              ccfg, params=p, num_slots=4, max_len=256, device=dev),
          _capture_fused)
    del runs, cut
    tcfg, tp = cut_model(cfg, params, P13C_TP_LAYERS, "tp cut")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    res = timed(f"tp want {P13C}", _decode_run, get_model(tcfg), tp,
                _dist_tokens(tcfg, P13C_B, P13C_S + P13C_T), P13C_S, P13C_T,
                P13C_L, device)
    logits, ms = res[0], res[2]
    del tp, res
    gc.collect()
    torch.cuda.empty_cache()
    got = timed("p13c tp 1x2", p13c_tp_phase, tcfg, (logits.numpy(), ms),
                card)
    for k in ("decode_attention", "flash_attention"):
        rows[k]["launches_p13c"] = {
            f"{P13C} {P13C_TP_LAYERS} layers 1x2, a rank": got[k]}


# ----------------------- P13b: WAVES routing inside the serve step, dry-run

# qwen3-4b, the reference's own routed-serve arch, at full width on its
# first P13B_LAYERS layers: 16 prompts of 128 tokens prefilled stacked
# (K4) into a 2,048-slot cache, then 4 routed decode steps (K3) in each
# variant, in one process and on two gloo ranks as a (pod 2, data 1,
# model 1) mesh (each rank 8 rows). Both on an fp32 cache, as the P13a
# comparisons: in bf16 a ~1e-7 gap of another summation order flips a
# stored value by a bf16 ulp, which the gate would then measure
P13B_ARCH = "qwen3-4b"
# its cut: 2 of 36 layers since P13d (4 in P13c, 8 before), whose
# qwen3-32b and FSDP phases take the seconds; the migrating variant's
# gloo staging of the cache scales with the layers. 4 routed decode steps
# since P13e (8 before)
P13B_LAYERS = 2
P13B_B, P13B_PROMPT, P13B_MAX_LEN, P13B_STEPS = 16, 128, 2048, 4
# the sensitivities' seed: both pods get requests, and at step 1 half of
# the 16 rows change rank (read out as ``rows_changing_rank``)
P13B_SEED = 7
# the two-rank run's final caches against the one-process run's,
# elementwise within P13B_CACHE_TOL * (1 + |x|): fp32 K/V projections of
# 2,560-term sums, whose inputs went through 8 layers that cuBLAS sums in
# another order for a batch of 8 rows than for 16 (2.19e-5 measured on
# the H100; the CPU tests' 1e-5 is for .reduced() widths and 2 layers)
P13B_CACHE_TOL = 1e-4
# the card-vs-CPU replay at the P12A_CUT_LAYERS cut, on the reference's
# bf16 cache: shorter prompts, since the CPU computes every prompt
# position's logits over the 151,936-token vocabulary
P13B_REPLAY = dict(prompt=16, max_len=64, steps=4)
P13B_VARIANTS = ("tokens_only", "migrate_cache")


def _p13b_model(layers):
    from repro_torch.configs.base import get_config
    from repro_torch.models.model import get_model
    return get_model(dataclasses.replace(get_config(P13B_ARCH),
                                         num_layers=layers))


def _p13b_inputs(cfg, prompt):
    """The 16 prompts and the requests' sensitivities, from the seed."""
    import numpy as np
    import torch
    rng = np.random.default_rng(P13B_SEED)
    sens = rng.uniform(0.0, 1.0, P13B_B).astype(np.float32)
    prompts = rng.integers(0, cfg.vocab_size,
                           (P13B_B, prompt)).astype(np.int32)
    return torch.from_numpy(prompts), torch.from_numpy(sens)


def _routed_runs(model, params, prompt, max_len, steps, cache_dtype):
    """``routed_serve.run`` in both variants under the current mesh (if
    any): per variant the logits (steps, rows, V) and the router's
    results on the host, the final cache, each step's ms, the launches
    and the permutation's all-reduces and bytes."""
    from repro_torch.launch import routed_serve
    prompts, sens = _p13b_inputs(model.cfg, prompt)
    out = {}
    for tag in P13B_VARIANTS:
        zero_launches()
        routed_serve.permute_rows.all_reduces = 0
        routed_serve.permute_rows.bytes = 0.0
        r = routed_serve.run(model, params, prompts, sens, max_len=max_len,
                             steps=steps, migrate_cache=tag != "tokens_only",
                             cache_dtype=cache_dtype)
        out[tag] = {"logits": r["logits"].cpu(), "assign": r["assign"].cpu(),
                    "state": {k: v.cpu() for k, v in r["state"].items()},
                    "cache": r["cache"],
                    "step_ms": [s * 1e3 for s in r["step_s"]],
                    "launches": read_launches(),
                    "all_reduces": routed_serve.permute_rows.all_reduces,
                    "bytes": routed_serve.permute_rows.bytes}
    return out


def _filled(cache, n):
    """The first ``n`` slots of every leaf, on the host (the rest hold
    zeros)."""
    return [{k: v[:, :n].cpu() for k, v in layer.items()} for layer in cache]


def _p13b_rank(cache_dir):
    """One rank of the (pod 2, data 1, model 1) gloo group on the card:
    both variants on its 8 rows; its logits, router results, launches and
    permutation counts, and its final cache held to the one-process
    run's rows (``cache_dir``: their filled slots; every other slot must
    be zero)."""
    import torch
    import torch.distributed as dist

    from repro_torch import sharding
    from repro_torch.launch.mesh import make_local_mesh, rank_device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = rank_device(None)
    mesh = make_local_mesh(1, 1, pod=2)
    model = _p13b_model(P13B_LAYERS)
    n = P13B_PROMPT + P13B_STEPS
    with sharding.axis_rules(mesh):
        params = model.init(seed=0, device=dev)
        runs = _routed_runs(model, params, P13B_PROMPT, P13B_MAX_LEN,
                            P13B_STEPS, torch.float32)
    rows = P13B_B // dist.get_world_size()
    lo = dist.get_rank() * rows
    out = {}
    for tag, r in runs.items():
        want = torch.load(Path(cache_dir) / f"{tag}.pt")
        gap, close, tail = 0.0, True, 0.0
        for layer, wl in zip(r["cache"], want):
            for k, c in layer.items():
                w = wl[k][lo:lo + rows].to(dev)
                d = (c[:, :n] - w).abs()
                gap = max(gap, float(d.max()))
                close &= bool(torch.all(d <= P13B_CACHE_TOL
                                        * (1.0 + w.abs())))
                tail = max(tail, float(c[:, n:].abs().max()))
        out[tag] = {k: v for k, v in r.items() if k != "cache"}
        out[tag].update(logits=r["logits"].numpy(),
                        assign=r["assign"].numpy(),
                        state={k: v.numpy() for k, v in r["state"].items()},
                        cache_max_abs_gap=gap, cache_close=close,
                        cache_unfilled_max_abs=tail)
    return out


def _crossings(assign, ranks=2):
    """Per step, the rows whose routed position lies on another rank."""
    import torch
    out = []
    for a in assign:
        pod = torch.where(a >= 0, a * 2 // 4, 0)
        inv = torch.argsort(torch.argsort(pod, stable=True))
        rows = torch.arange(len(a)) // (len(a) // ranks)
        out.append(int((rows != inv // (len(a) // ranks)).sum()))
    return out


def _permute_counts(cfg, cache, tag, steps):
    """The permutation's all-reduces and ring bytes a rank of the (2, 1,
    1) mesh does: per step one all-reduce over "pod" of the token, of the
    logits and, migrating, of every cache leaf, each moving the global
    tensor's bytes once (a ring of two)."""
    per_step = [P13B_B * 4, P13B_B * cfg.vocab_size * 4]
    if tag == "migrate_cache":
        per_step += [c.numel() * c.element_size() for layer in cache
                     for c in layer.values()]
    return steps * len(per_step), float(steps * sum(per_step))


def p13b_routed_phase(device, card):
    """(a) qwen3-4b's cut in one process, both variants: K4 once a layer
    of the prefill, K3 once a layer a step, no other kernel; (b) the same
    run on two gloo ranks as (pod 2, data 1, model 1): the rows' logits
    within ``DIST_LOGIT_TOL`` of (a), ``assign`` and the router state
    exactly, each rank's final cache within ``P13B_CACHE_TOL`` of (a)'s
    rows (in routed order when migrating), K3/K4 launches a rank exact,
    the permutation's all-reduces and bytes as counted from the shapes;
    at least a quarter of the rows change rank at some step."""
    import tempfile

    import numpy as np
    import torch
    model = _p13b_model(P13B_LAYERS)
    cfg = model.cfg
    params = model.init(seed=0, device=device)
    one = _routed_runs(model, params, P13B_PROMPT, P13B_MAX_LEN,
                       P13B_STEPS, torch.float32)
    L = cfg.num_layers
    lw = dict.fromkeys(kernel_fns(), 0) | {"flash_attention": L,
                                          "decode_attention": L * P13B_STEPS}
    faults = []
    for tag, r in one.items():
        if r["launches"] != lw:
            faults.append(f"one process {tag}: launches {r['launches']} "
                          f"!= {lw}")
        if r["all_reduces"] or r["bytes"]:
            faults.append(f"one process {tag}: {r['all_reduces']} "
                          f"permutation all-reduces")
    assign = one["tokens_only"]["assign"]
    cross = _crossings(assign)
    pods = sorted(set(torch.where(assign >= 0, assign * 2 // 4, 0)
                      .ravel().tolist()))
    if max(cross) < P13B_B // 4 or pods != [0, 1]:
        faults.append(f"routing: rows changing rank {cross}, pods {pods}")
    n = P13B_PROMPT + P13B_STEPS
    with tempfile.TemporaryDirectory() as tmp:
        for tag, r in one.items():
            torch.save(_filled(r["cache"], n), Path(tmp) / f"{tag}.pt")
        caches = {tag: r.pop("cache") for tag, r in one.items()}
        del params
        gc.collect()
        torch.cuda.empty_cache()
        outs = _run_gloo_ranks(_p13b_rank, (tmp,))
    rows = P13B_B // len(outs)
    lr = dict.fromkeys(kernel_fns(), 0) | {"flash_attention": L,
                                          "decode_attention": L * P13B_STEPS}
    report = {}
    for tag, r in one.items():
        got = np.concatenate([o[tag]["logits"] for o in outs], axis=1)
        gap = float(np.abs(got - r["logits"].numpy()).max())
        if not gap <= DIST_LOGIT_TOL:
            faults.append(f"{tag}: gathered logits differ by {gap}")
        want_n, want_b = _permute_counts(cfg, caches[tag], tag, P13B_STEPS)
        for i, o in enumerate(outs):
            g = o[tag]
            if not np.array_equal(g["assign"], r["assign"].numpy()) or any(
                    not np.array_equal(g["state"][k], v.numpy())
                    for k, v in r["state"].items()):
                faults.append(f"{tag} rank {i}: assign or router state "
                              f"differs")
            if not g["cache_close"] or g["cache_unfilled_max_abs"] != 0.0:
                faults.append(f"{tag} rank {i}: cache gap "
                              f"{g['cache_max_abs_gap']} over "
                              f"{P13B_CACHE_TOL} (1 + |x|), unfilled "
                              f"{g['cache_unfilled_max_abs']}")
            if g["launches"] != lr:
                faults.append(f"{tag} rank {i}: launches {g['launches']} "
                              f"!= {lr}")
            if (g["all_reduces"], g["bytes"]) != (want_n, want_b):
                faults.append(f"{tag} rank {i}: {g['all_reduces']} "
                              f"all-reduces of {g['bytes']} B, want "
                              f"{want_n} of {want_b}")
        med = lambda ms: sorted(ms)[len(ms) // 2]
        report[tag] = {
            "logit_max_abs_gap": gap,
            "cache_max_abs_gap_rank": [o[tag]["cache_max_abs_gap"]
                                       for o in outs],
            "routed_step_ms_median": {
                "one_process": med(r["step_ms"]),
                "ranks": [med(o[tag]["step_ms"]) for o in outs]},
            "routed_step_ms_first": {
                "one_process": r["step_ms"][0],
                "ranks": [o[tag]["step_ms"][0] for o in outs]},
            "permute_all_reduces_rank": outs[0][tag]["all_reduces"],
            "permute_bytes_rank": outs[0][tag]["bytes"],
            "permute_bytes_per_step_rank":
                outs[0][tag]["bytes"] / P13B_STEPS,
            "launches_one_process": r["launches"],
            "launches_rank": [o[tag]["launches"] for o in outs]}
    emit({"phase": "p13b routed serve", "card": card, "arch": P13B_ARCH,
          "layers": L, "batch": P13B_B, "prompt": P13B_PROMPT,
          "max_len": P13B_MAX_LEN, "steps": P13B_STEPS,
          "cache_dtype": "float32", "mesh": "pod 2 x data 1 x model 1",
          "backend": "gloo", "rows_a_rank": rows,
          "rows_changing_rank": cross, "pods": pods,
          "assign": assign.tolist(),
          "logit_tol": DIST_LOGIT_TOL, "cache_tol": P13B_CACHE_TOL,
          "cache_bytes_one_process": {t: _cache_bytes(c)
                                      for t, c in caches.items()},
          **report, "faults": faults})
    if faults:
        raise AssertionError("p13b routed serve: " + "; ".join(faults))
    return one["tokens_only"]["launches"]


def p13b_replay_phase(device, card):
    """The routed run card against CPU at the ``P12A_CUT_LAYERS`` cut
    (full widths and vocabulary), both variants, on the reference's bf16
    cache: ``assign`` and the router state equal; each step's logits
    within ``REPLAY_LOGIT_TOL`` while both sides fed the same tokens; a
    step whose greedy tokens part ends the comparison, and is legitimate
    only at a CPU top-2 margin of at most twice that step's gap."""
    import torch
    cpu = torch.device("cpu")
    model = _p13b_model(P12A_CUT_LAYERS)
    params = model.init(seed=0, device=device)
    runs = [_routed_runs(model, p, P13B_REPLAY["prompt"],
                         P13B_REPLAY["max_len"], P13B_REPLAY["steps"],
                         torch.bfloat16)
            for p in (params, params_to(params, cpu))]
    faults, report = [], {}
    for tag in P13B_VARIANTS:
        card_r, cpu_r = runs[0][tag], runs[1][tag]
        if not torch.equal(card_r["assign"], cpu_r["assign"]) or any(
                not torch.equal(card_r["state"][k], v)
                for k, v in cpu_r["state"].items()):
            faults.append(f"{tag}: assign or router state differs")
        gaps, parted = [], None
        for t in range(P13B_REPLAY["steps"]):
            a, c = card_r["logits"][t], cpu_r["logits"][t]
            gap = float((a - c).abs().max())
            gaps.append(gap)
            if not gap <= REPLAY_LOGIT_TOL:
                faults.append(f"{tag} step {t}: logits differ by {gap}")
            top = torch.topk(c, 2, dim=-1).values
            margin = top[:, 0] - top[:, 1]
            part = a.argmax(-1) != c.argmax(-1)
            if part.any():
                if float(margin[part].max()) > 2 * gap:
                    faults.append(f"{tag} step {t}: tokens part at a "
                                  f"margin over twice the gap {gap}")
                parted = t
                break
        report[tag] = {"logit_gaps": gaps, "parted_at_step": parted}
    emit({"phase": "p13b replay", "card": card, "arch": P13B_ARCH,
          "layers": P12A_CUT_LAYERS, "batch": P13B_B,
          "cache_dtype": "bfloat16", **P13B_REPLAY,
          "logit_tol": REPLAY_LOGIT_TOL, **report, "faults": faults})
    if faults:
        raise AssertionError("p13b replay: " + "; ".join(faults))


P13B_RECORDS = [ROOT / "build" / "dryrun"
                / f"{P13B_ARCH}__decode_32k__{m}.json"
                for m in ("pod16x16", "pod2x16x16")]
P13B_ROUTED = ROOT / "build" / f"routed_serve_{P13B_ARCH}_decode_32k.json"
P13B_CLIS = {"dryrun": ["repro_torch.launch.dryrun", "--arch", P13B_ARCH,
                        "--shape", "decode_32k", "--mesh", "both", "--out",
                        "build/dryrun"],
             "routed_serve": ["repro_torch.launch.routed_serve"]}


def start_p13b_clis():
    """Start the two CLIs as a user runs them, from the checkout's root,
    in subprocesses on the CPU (no card: they trace meta tensors on a fake
    process group), beside the card phases: {name: (process, its output
    file, start)}."""
    import os
    import tempfile
    for p in P13B_RECORDS + [P13B_ROUTED]:   # an ok record is skipped
        p.unlink(missing_ok=True)
    env = dict(os.environ, PYTHONPATH=str(SRC), CUDA_VISIBLE_DEVICES="")
    out = {}
    for name, args in P13B_CLIS.items():
        log = tempfile.TemporaryFile("w+")
        out[name] = (subprocess.Popen(
            [sys.executable, "-m", *args], cwd=str(ROOT), env=env,
            stdout=log, stderr=subprocess.STDOUT, text=True), log,
            time.perf_counter())
    return out


def p13b_cli_phase(card, clis, timeout=600):
    """Wait for the two CLIs (``start_p13b_clis``): the dry-run of
    qwen3-4b at decode_32k on both production meshes (fake groups of 256
    and 512 ranks) and routed_serve's default; each must exit 0 and write
    ok records, whose flops, memory and collectives are printed, with the
    seconds from each CLI's start to when it was found done (the card
    phases ran meanwhile: an upper bound of its wall time)."""
    faults, secs = [], {}
    deadline = time.perf_counter() + timeout
    pending = dict(clis)
    while pending:
        for name, (proc, log, t0) in list(pending.items()):
            if proc.poll() is None and time.perf_counter() < deadline:
                continue
            del pending[name]
            if proc.poll() is None:
                proc.kill()
                proc.wait()
                faults.append(f"{name}: still running after {timeout} s")
            secs[name] = time.perf_counter() - t0
            log.seek(0)
            text = log.read()
            log.close()
            if proc.returncode != 0:
                faults.append(f"{name} exited {proc.returncode}: "
                              f"{text[-3000:]}")
        time.sleep(0.1)
    dry = {}
    for p in P13B_RECORDS:
        rec = json.loads(p.read_text()) if p.exists() else {}
        if not rec.get("ok"):
            faults.append(f"{p.name}: {rec.get('error', 'not written')}")
            continue
        dry[rec["mesh"]] = {k: rec[k] for k in (
            "n_devices", "lower_s", "flops", "bytes_accessed", "memory",
            "collectives", "collective_bytes", "param_bytes_placed",
            "param_bytes_by_rules")}
    routed = (json.loads(P13B_ROUTED.read_text())
              if P13B_ROUTED.exists() else {})
    for tag in P13B_VARIANTS:
        if routed.get(tag, {}).get("n_collective_permute", 0) <= 0:
            faults.append(f"routed_serve: no {tag} record")
    emit({"phase": "p13b clis", "card": card, "done_within_s": secs,
          "dryrun": dry, "routed_serve": routed, "faults": faults})
    if faults:
        raise AssertionError("p13b clis: " + "; ".join(faults))


def p13b_group(device, timed, card, rows):
    """P13b on the card: the routed serve step (one process and two gloo
    ranks; gloo stages CUDA tensors through the host, so their step times
    are gates, not speed) and its card-vs-CPU replay, while the two CLIs
    run on the CPU in subprocesses (their wait is the "p13b clis"
    seconds). The kernel rows of K3 and K4 take the one-process run's
    launches."""
    import torch
    clis = start_p13b_clis()
    try:
        gc.collect()
        torch.cuda.empty_cache()
        launches = timed("p13b routed serve", p13b_routed_phase, device,
                         card)
        for k in ("decode_attention", "flash_attention"):
            rows[k]["launches_p13b"] = {
                f"{P13B_ARCH} {P13B_LAYERS} layers, a variant, one "
                f"process or a rank": launches[k]}
        gc.collect()
        torch.cuda.empty_cache()
        timed("p13b replay", p13b_replay_phase, device, card)
        timed("p13b clis", p13b_cli_phase, card, clis)
    finally:               # stop the CLIs if a phase failed first
        for proc, log, _ in clis.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()


# --------------------------------------------------- P14a: training

TRAIN = "smollm-135m"
# the launcher's path at smollm-135m's published context: 6 steps of
# batch 8 x 2048 tokens (the loss falls by a nat within 3), checkpoints
# every 3 steps, then a resume from step 3 that must end on the
# uninterrupted run's loss (10 steps and a resume from 5 before P13e)
TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_CKPT_EVERY = 8, 2048, 6, 3
# paligemma-3b: 5 steps of 2 rows of 256 image embeddings + 256 tokens
PALI_TRAIN = "paligemma-3b"
PALI_TRAIN_B, PALI_TRAIN_S, PALI_TRAIN_STEPS = 2, 512, 5
# kimi-k2-1t-a32b at .reduced(): MoE and its aux loss under autograd
KIMI_TRAIN_STEPS = 3
# the scan families through the launcher, both with remat: mamba2's
# step at 2 x 2,048 peaks at 33.7 GB without it and 8.0 GB with it (the
# remat phase below, PERF.md), so 8 x 2,048 does not fit an 80 GB card
# without it; recurrentgemma's cut peaks at 71.7 GB with it.
# mamba2-370m at full width and depth, 4 steps of 8 x 2,048 tokens (its
# published context; ~2 s a step on an H100, and the loss's fall and the
# per-step launch counts need no more steps; 8 before P13e);
# recurrentgemma-9b cut to its first 8 layers (two
# (rglru, rglru, attn) cycles and the two trailing RG-LRU layers, as the
# 38-layer model ends; every width kept: 2.64 B parameters, 42.3 GB of
# fp32 weights, gradients and AdamW moments, where the full model's 137
# GB does not fit one card), 5 steps of 1 x 2,048 at lr 3e-4: the
# launcher's 3e-3 moves each weight by ~20% of its init scale (1/64 at
# d_model 4,096) a step, where paligemma-3b's loss (d_model 2,048) rises
# at 3e-3 (PERF.md)
MAMBA2_TRAIN = "mamba2-370m"
MAMBA2_TRAIN_B, MAMBA2_TRAIN_S, MAMBA2_TRAIN_STEPS = 8, 2048, 4
RG_TRAIN = "recurrentgemma-9b"
RG_TRAIN_LAYERS, RG_TRAIN_B, RG_TRAIN_S, RG_TRAIN_STEPS = 8, 1, 2048, 5
RG_TRAIN_LR = 3e-4
# P14c: the launcher on the five configurations the card had not trained,
# each 3 steps of batch 1 x 2,048 with remat, fp32 weights: arch ->
# (layers, lr), layers None for full depth. Parameters and state
# (weights, gradients and two AdamW moments, 16 B a parameter) at each
# cut, counted on meta tensors (tests/test_torch_p14c_cuts.py), and the
# peak an H100 read (PERF.md):
#   qwen3-4b        36 of 36 layers  4,022,468,096  64.4 GB  peak 75.7 GB
#   musicgen-large  48 of 48         3,229,812,736  51.7 GB       52.2
#   glm4-9b         10 of 40         3,281,080,320  52.5 GB       69.9
#   deepseek-v2-lite-16b  5 of 27 (its dense first layer and 4 MoE
#                   layers)          2,839,831,040  45.4 GB       51.4
#   qwen3-32b        3 of 64         3,018,624,768  48.3 GB       70.2
# glm4's and qwen3-32b's peaks sit ~18-22 GB above their state: AdamW's
# temporaries on their untied 151,552- and 151,936-row tables (2.5 and
# 3.1 GB each). The warmup is 0 steps at 3 steps (the launcher's
# min(20, steps // 5)), so the first update takes the full rate: at 1e-4
# and above the loss of qwen3-4b, glm4-9b and qwen3-32b rose again by
# step 3, qwen3-32b's after one step; at 3e-5 (1e-5 for qwen3-32b, d_model
# 5,120) each fell (PERF.md)
P14C_B, P14C_S, P14C_STEPS = 1, 2048, 3
P14C = {"qwen3-4b": (None, 3e-5), "musicgen-large": (None, 3e-5),
        "glm4-9b": (10, 3e-5), "deepseek-v2-lite-16b": (5, 3e-5),
        "qwen3-32b": (3, 1e-5)}
# the kernels that have no backward kernel (K1-K3, the decode and chunked
# prefill walks of the serving paths): under autograd on the card each
# must raise, never drop a gradient
NO_BACKWARD = ("paged_decode_attention", "chunked_prefill_attention",
               "decode_attention")
# card vs CPU, one step's gradient at a cut (every width and the whole
# vocabulary): smollm 2 x 512 tokens, paligemma 1 x (256 + 64), mamba2
# 2 x 512 (two chunks of 256) at 2 layers, recurrentgemma 1 x 256 at one
# pattern cycle (3 layers: its attention layer included), the P14C
# configs 1 x 256 at 2 layers (deepseek's dense first layer and one MoE
# layer)
CUT_BATCH = {TRAIN: (2, 512), PALI_TRAIN: (1, 320), MAMBA2_TRAIN: (2, 512),
             RG_TRAIN: (1, 256), **dict.fromkeys(P14C, (1, 256))}
CUT_LAYERS = {RG_TRAIN: 3}
# tolerances of the card-vs-CPU step. Both sides are fp32 (TF32 off) and
# differ in summation order only (cuBLAS, K4's 3xTF32 walk and its
# backward's FMA sums against the CPU's matmuls and the plain attention):
# the loss and the gradient norm relative, each gradient leaf relative to
# its largest magnitude. An H100 measured at most 7.5e-8, 1.2e-6 and
# 7.2e-6 at paligemma's cut (smollm's 0, 8.2e-7, 3.8e-6; recurrentgemma's
# 7.2e-8, 3.3e-7, 9.9e-6): each tolerance 5-13x its reading. mamba2's
# cut reads 0, 1.4e-7 and 4.4e-5, its worst leaf dt_bias at 88% of the
# leaf tolerance: the dt path's leaves (dt_bias, A_log, wdt) sum over
# every row with heavy cancellation, so any one-ulp change upstream moves
# them by ~1e-5 to 1e-4 of their largest (tests/test_torch_scan_bwd.py:
# the cum's summation order alone moves them by 6.2e-5 at a 2-layer
# cut); the reading stayed at 4.4e-5 when the CPU's cum was made
# bit-equal to the kernel's, so it comes from the matmuls' order
TRAIN_LOSS_TOL = 1e-6
TRAIN_GNORM_TOL = 1e-5
TRAIN_GRAD_TOL = 5e-5
# the resumed run's last loss against the uninterrupted run's, and the
# remat step's loss and gradients against the plain step's (relative to
# each leaf's largest magnitude): K4 and its backward are deterministic
# (no float atomics) and the matmuls see the same shapes, so the same
# bits are expected (the reading says whether they were); the tolerance
# admits summation-order noise from a reduction outside the port's
# kernels, which a rehearsal on a multi-threaded CPU showed at 1e-7
RESUME_LOSS_TOL = 1e-6
REMAT_TOL = 1e-6


def _step_recorder():
    """Wrap the train launcher's ``make_train_step`` so that every step is
    timed (synchronized on both sides), its kernel launches and MLA/MoE
    calls counted and the weight and AdamW moment bytes it holds read.
    Returns (records, undo)."""
    import torch

    from repro_torch.launch import train
    records, make = [], train.make_train_step

    def made(model, ocfg, remat=False):
        step = make(model, ocfg, remat=remat)

        def timed_step(params, state, batch):
            torch.cuda.synchronize()
            zero_launches()
            t0 = time.perf_counter()
            out = step(params, state, batch)
            torch.cuda.synchronize()
            records.append({"s": time.perf_counter() - t0,
                            **read_launches(), **read_blocks(),
                            "weight_bytes": tensor_bytes(params),
                            "moment_bytes": tensor_bytes(state["mu"])})
            return out
        return timed_step

    train.make_train_step = made

    def undo():
        train.make_train_step = make
    return records, undo


def _train_flops(model, n_params, B, S):
    """Model flops of one train step: 6 N per token for the parameters
    (N every parameter: the MoE's dense expert path runs every expert on
    every token), plus three times the causal forward attention (QK^T
    and PV over the pairs the mask allows) in every attention layer and
    every MLA layer (q/k at the nope + rope width, v at its own)."""
    cfg = model.cfg
    P = cfg.num_prefix_tokens if cfg.prefix_lm else 0
    pairs = sum(max(t + 1, min(P, S)) for t in range(S))
    attn = 4 * cfg.num_heads * cfg.head_dim * pairs * B
    mla = (2 * cfg.num_heads * (cfg.nope_head_dim + cfg.rope_head_dim
                                + cfg.v_head_dim) * pairs * B)
    return (6 * n_params * B * S
            + 3 * attn * model.block_types.count("attn")
            + 3 * mla * model.block_types.count("mla"))


def train_readings(name, cfg, records, B, S, card):
    """Step ms (the median of every step after the first, which builds
    cuBLAS's plans), tokens/s, peak memory and the model-flops share of
    the fp32 CUDA-core peak (TF32 is off for matmuls)."""
    import torch

    from repro_torch.models.model import get_model
    from repro_torch.models.layers import _walk
    model = get_model(cfg)
    n = sum(math.prod(sp.shape) for _, sp in _walk(model.param_table()))
    n += sum(math.prod(sp.shape) for i in range(cfg.num_layers)
             for _, sp in _walk(model.layer_table(i)))
    steps = sorted(r["s"] for r in records[1:]) or [records[0]["s"]]
    med = steps[len(steps) // 2]
    flops = _train_flops(model, n, B, S)
    out = {"phase": f"train {name}", "card": card, "parameters": n,
           "batch": B, "seq": S, "steps": len(records),
           "step_ms_median": med * 1e3, "step_ms_first": records[0]["s"]
           * 1e3, "step_ms_all": [r["s"] * 1e3 for r in records],
           "tokens_per_s": B * S / med,
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "model_flops_per_step": flops,
           "model_flops_share_fp32": flops / med / FP32_FLOP_PER_S}
    return out


def train_launches(model, remat=False):
    """Kernel launches of one train step of ``model``: each layer's
    forward kernel once (twice in a pattern group under ``remat``, whose
    forward runs again in the backward) and its backward kernel once. An
    MLA layer launches none (``mla_apply`` is torch ops)."""
    fwd = {"attn": "flash_attention", "ssm": "ssd_chunk",
           "rglru": "rglru_scan", "mla": None}
    want = {}
    for lo, hi, grouped in model.layer_spans():
        for bt in model.block_types[lo:hi]:
            k = fwd[bt]
            if k is None:
                continue
            want[k] = want.get(k, 0) + (2 if remat and grouped else 1)
            want[f"{k}_bwd"] = want.get(f"{k}_bwd", 0) + 1
    return want


def train_blocks(model, remat=False):
    """MLA and MoE calls of one train step of ``model``: one a layer's
    forward, two in a pattern group under ``remat``."""
    _, moe = block_layers(model)
    want = dict.fromkeys(block_fns(), 0)
    for lo, hi, grouped in model.layer_spans():
        n = 2 if remat and grouped else 1
        for i in range(lo, hi):
            want["mla_apply"] += n * (model.block_types[i] == "mla")
            want["moe_apply"] += n * (i >= model.cfg.num_layers - moe)
    return want


def _launch_counts(name, records, want):
    """Every step's launches must be ``want`` (kernel -> count), the other
    kernels none."""
    for i, r in enumerate(records):
        got = {k: r[k] for k in kernel_fns()}
        exp = dict.fromkeys(kernel_fns(), 0) | want
        if got != exp:
            raise AssertionError(f"train {name} step {i + 1}: launches "
                                 f"{got} != {exp}")


def train_smollm_phase(device, card, ckpt_dir):
    """The launcher at smollm-135m's full width: 20 steps (checkpoints at
    10 and 20), then a resume from step 10; the loss falls, each step
    launches K4 and its backward once a layer and no other kernel, and
    the resumed run ends on the uninterrupted run's loss."""
    import shutil

    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.launch import train
    cfg = get_config(TRAIN)
    argv = ["--arch", TRAIN, "--steps", str(TRAIN_STEPS), "--batch",
            str(TRAIN_B), "--seq", str(TRAIN_S), "--log-every", "1",
            "--ckpt-dir", str(ckpt_dir)]
    torch.cuda.reset_peak_memory_stats()
    records, undo = _step_recorder()
    try:
        hist = train.main(argv + ["--ckpt-every", str(TRAIN_CKPT_EVERY)])
        reading = train_readings(TRAIN, cfg, records, TRAIN_B, TRAIN_S,
                                 card)
        _launch_counts(TRAIN, records, {"flash_attention": cfg.num_layers,
                                        "flash_attention_bwd":
                                            cfg.num_layers})
        losses = [h["loss"] for h in hist]
        if not losses[-1] < losses[0] - 1.0:
            raise AssertionError(f"train {TRAIN}: the loss did not fall "
                                 f"by a nat: {losses}")
        shutil.rmtree(ckpt_dir / f"step_{TRAIN_STEPS:08d}")
        records.clear()
        resumed = train.main(argv + ["--resume"])
    finally:
        undo()
    gap = abs(resumed[-1]["loss"] - losses[-1])
    reading.update(loss=losses, grad_norm=[h["grad_norm"] for h in hist],
                   resumed_from=TRAIN_CKPT_EVERY,
                   resumed_steps=[h["step"] for h in resumed],
                   resumed_last_loss=resumed[-1]["loss"],
                   resume_loss_gap=gap,
                   resume_bit_equal=resumed[-1]["loss"] == losses[-1],
                   launches_per_step={"flash_attention": cfg.num_layers,
                                      "flash_attention_bwd":
                                          cfg.num_layers})
    emit(reading)
    if len(resumed) != TRAIN_STEPS - TRAIN_CKPT_EVERY or \
            gap > RESUME_LOSS_TOL * losses[-1]:
        raise AssertionError(f"train {TRAIN}: the resumed run ends at "
                             f"{resumed[-1]['loss']}, the uninterrupted "
                             f"at {losses[-1]}")
    shutil.rmtree(ckpt_dir)
    return reading


def remat_phase(device, arch=TRAIN, B=TRAIN_B, S=TRAIN_S):
    """One step's gradient of ``arch`` at full width with and without
    ``remat``: each layer's forward kernel runs twice with it (the groups'
    forwards again in the backward), its backward once a layer either
    way, the loss and every gradient leaf within REMAT_TOL (bit-equality
    read out), and no leaf without a gradient."""
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models.model import get_model
    from repro_torch.models.steps import value_and_grad
    from repro_torch.training.optim import tree_leaves
    cfg = get_config(arch)
    model = get_model(cfg)
    params = model.init(seed=0, device=device)
    batch = {k: torch.from_numpy(v).to(device) for k, v in SyntheticLM(
        cfg.vocab_size, B, S, seed=0).next_batch().items()}
    runs = {}
    for remat in (False, True):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_launches()
        loss, _, grads = value_and_grad(model, params, batch, remat=remat)
        torch.cuda.synchronize()
        runs[remat] = (loss, tree_leaves(grads), read_launches(),
                       torch.cuda.max_memory_allocated())
    for remat in (False, True):
        got = runs[remat][2]
        if got != dict.fromkeys(kernel_fns(), 0) | train_launches(model,
                                                                  remat):
            raise AssertionError(f"{arch} remat={remat}: launches {got}")
    empty = [i for i, g in enumerate(runs[False][1]) if not bool(
        (g != 0).any())]
    gaps = [float((a - b).abs().max()) / max(float(a.abs().max()), 1e-30)
            for a, b in zip(runs[False][1], runs[True][1])]
    lgap = abs(float(runs[False][0]) - float(runs[True][0]))
    result = {"phase": "train remat" if arch == TRAIN
              else f"train remat {arch}", "model": arch, "batch": B,
              "seq": S,
              "loss": float(runs[False][0]),
              "loss_bit_equal": bool(torch.equal(runs[False][0],
                                                 runs[True][0])),
              "loss_gap": lgap, "grad_leaf_rel_gap_max": max(gaps),
              "grads_bit_equal": max(gaps) == 0, "tolerance": REMAT_TOL,
              "launches": {str(k): v[2] for k, v in runs.items()},
              "peak_memory_bytes": {str(k): v[3] for k, v in runs.items()},
              "leaves": len(gaps), "leaves_without_gradient": empty}
    emit(result)
    if lgap > REMAT_TOL * abs(result["loss"]) or max(gaps) > REMAT_TOL \
            or empty:
        raise AssertionError(f"remat: {result}")
    del params, runs


def train_pali_phase(device, card):
    """The launcher at paligemma-3b's full width: 5 steps, every K4 launch
    and its backward with the 256-token prefix, 18 of each a step."""
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.launch import train
    cfg = get_config(PALI_TRAIN)
    torch.cuda.reset_peak_memory_stats()
    records, undo = _step_recorder()
    seen, undo_prefix = _record_prefix()
    try:
        hist = train.main(["--arch", PALI_TRAIN, "--steps",
                           str(PALI_TRAIN_STEPS), "--batch",
                           str(PALI_TRAIN_B), "--seq", str(PALI_TRAIN_S),
                           "--log-every", "1"])
    finally:
        undo_prefix()
        undo()
    reading = train_readings(PALI_TRAIN, cfg, records, PALI_TRAIN_B,
                             PALI_TRAIN_S, card)
    L = cfg.num_layers
    _launch_counts(PALI_TRAIN, records, {"flash_attention": L,
                                         "flash_attention_bwd": L})
    losses = [h["loss"] for h in hist]
    reading.update(loss=losses, grad_norm=[h["grad_norm"] for h in hist],
                   prefix_lens=sorted(set(seen)), k4_calls=len(seen),
                   launches_per_step={"flash_attention": L,
                                      "flash_attention_bwd": L})
    emit(reading)
    if set(seen) != {cfg.num_prefix_tokens} or \
            len(seen) != L * PALI_TRAIN_STEPS:
        raise AssertionError(f"train {PALI_TRAIN}: K4 prefixes {set(seen)}"
                             f" in {len(seen)} calls")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train {PALI_TRAIN}: losses {losses}")
    return reading


def train_kimi_phase(device):
    """kimi-k2-1t-a32b at ``.reduced()`` through the launcher: the MoE
    block and its aux loss under autograd (torch ops), K4 and its
    backward at head_dim 32 once an attention layer a step; the router
    and every expert get a gradient."""
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import train
    from repro_torch.models.model import get_model
    from repro_torch.models.steps import value_and_grad
    cfg = get_config(P12B_REDUCED).reduced()
    records, undo = _step_recorder()
    try:
        hist = train.main(["--arch", P12B_REDUCED, "--smoke", "--steps",
                           str(KIMI_TRAIN_STEPS), "--log-every", "1"])
    finally:
        undo()
    model = get_model(cfg)
    L = model.block_types.count("attn")
    moe = cfg.num_layers - cfg.first_dense_layers
    _launch_counts(P12B_REDUCED, records, {"flash_attention": L,
                                           "flash_attention_bwd": L})
    params = model.init(seed=0, device=device)
    batch = {k: torch.from_numpy(v).to(device) for k, v in SyntheticLM(
        cfg.vocab_size, 8, 128, seed=0).next_batch().items()}
    _, parts, grads = value_and_grad(model, params, batch)
    moe_grads = {k: bool((g != 0).any()) for lp in grads["layers"]
                 if "moe" in lp for k, g in lp["moe"].items()
                 if isinstance(g, torch.Tensor)}
    result = {"phase": f"train {P12B_REDUCED} .reduced()",
              "loss": [h["loss"] for h in hist],
              "aux": [h["aux"] for h in hist],
              "moe_calls_per_step": [r["moe_apply"] for r in records],
              "moe_leaves_with_gradient": moe_grads,
              "aux_grad_step": float(parts["aux"])}
    emit(result)
    if not all(math.isfinite(x) for x in result["loss"]) or \
            not all(a > 0 for a in result["aux"]) or \
            not all(moe_grads.values()) or \
            result["moe_calls_per_step"] != [moe] * KIMI_TRAIN_STEPS:
        raise AssertionError(f"train kimi: {result}")


def _leaf_paths(tree, prefix=""):
    """The paths of a parameter tree's leaves, in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in _leaf_paths(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree)
                for p in _leaf_paths(v, f"{prefix}/{i}")]
    return [prefix]


def train_replay_phase(arch, device):
    """One step's loss, gradient norm and every gradient leaf on the card
    and on the CPU from the same weights and batch, at a cut of ``arch``
    (``CUT_LAYERS``, else 2 layers; every width and the whole
    vocabulary)."""
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models.model import get_model
    from repro_torch.models.steps import value_and_grad
    from repro_torch.training.optim import global_norm, tree_leaves
    cfg = get_config(arch)
    layers = CUT_LAYERS.get(arch, P12A_CUT_LAYERS)
    ccfg = dataclasses.replace(cfg, num_layers=layers)
    model = get_model(ccfg)
    params = model.init(seed=0, device=device)
    B, S = CUT_BATCH[arch]
    batch = SyntheticLM(cfg.vocab_size, B, S, seed=1, frontend=cfg.frontend,
                        d_model=cfg.d_model,
                        num_prefix=cfg.num_prefix_tokens).next_batch()
    out = {}
    for side, dev in (("card", device), ("cpu", torch.device("cpu"))):
        p = params if side == "card" else params_to(params, dev)
        b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        loss, _, grads = value_and_grad(model, p, b)
        out[side] = (float(loss), float(global_norm(grads)),
                     [g.cpu() for g in tree_leaves(grads)])
        del p, grads
    (lc, nc, gc_), (lp, np_, gp) = out["card"], out["cpu"]
    rel = [float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
           for a, b in zip(gc_, gp)]
    worst = _leaf_paths(params)[rel.index(max(rel))]
    result = {"phase": f"train replay {arch}", "layers": layers,
              "batch": B, "seq": S, "loss_card": lc, "loss_cpu": lp,
              "loss_rel_gap": abs(lc - lp) / abs(lp),
              "grad_norm_card": nc, "grad_norm_cpu": np_,
              "grad_norm_rel_gap": abs(nc - np_) / np_,
              "grad_leaf_rel_gap_max": max(rel), "grad_leaf_worst": worst,
              "leaves": len(rel),
              "tolerances": {"loss": TRAIN_LOSS_TOL,
                             "grad_norm": TRAIN_GNORM_TOL,
                             "grad_leaf": TRAIN_GRAD_TOL}}
    emit(result)
    if result["loss_rel_gap"] > TRAIN_LOSS_TOL or \
            result["grad_norm_rel_gap"] > TRAIN_GNORM_TOL or \
            max(rel) > TRAIN_GRAD_TOL:
        raise AssertionError(f"train replay {arch}: {result}")
    return result


def no_backward_phase(device):
    """K1-K3 on the card under autograd: each raises, naming itself,
    rather than drop the gradient of everything before it (a launch fills
    its output through a raw pointer, with no grad_fn); under no_grad
    each launches as before."""
    import torch

    from repro_torch.kernels.chunked_prefill import chunked_prefill_attention
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.paged_attention import paged_decode_attention
    gen = torch.Generator(device=device).manual_seed(23)

    def r(*shape):
        return torch.randn(*shape, generator=gen, device=device)

    pages = r(8, 16, 2, 64)
    bt = torch.zeros(2, 2, dtype=torch.int32, device=device)
    lens = torch.full((2,), 5, dtype=torch.int32, device=device)
    calls = {
        "paged_decode_attention": lambda q: paged_decode_attention(
            q(2, 4, 64), pages, pages, bt, lens),
        "chunked_prefill_attention": lambda q: chunked_prefill_attention(
            q(2, 16, 4, 64), pages, pages, bt,
            torch.zeros(2, dtype=torch.int32, device=device)),
        "decode_attention": lambda q: decode_attention(
            q(2, 4, 64), r(2, 32, 2, 64), r(2, 32, 2, 64), lens)}
    result = {"phase": "train refusal"}
    for name in NO_BACKWARD:
        leaf = (lambda *shape: r(*shape).requires_grad_(True))
        try:
            calls[name](leaf)
        except RuntimeError as e:
            msg = str(e)
        else:
            raise AssertionError(f"{name} ran under autograd on the card")
        with torch.no_grad():
            out = calls[name](leaf)
        torch.cuda.synchronize()
        result[name] = {"raised": msg,
                        "no_grad_output_finite": bool(
                            torch.isfinite(out).all())}
        if not msg.startswith(f"{name} has no backward kernel") or \
                not result[name]["no_grad_output_finite"]:
            raise AssertionError(f"{name}: {result[name]}")
    emit(result)


def train_launcher_phase(arch, device, card, B, S, steps, layers=None,
                         remat=False, lr=None):
    """The launcher on ``arch`` (its first ``layers`` layers, every width
    kept, as ``--layers`` cuts it): ``steps`` steps of B x S tokens, each
    timed, each launching exactly ``train_launches`` (K4 on the attention
    layers, K5/K6 on the scan layers, and their backward kernels; none on
    MLA layers) and no other kernel, and calling the MLA and MoE blocks
    ``train_blocks`` times; every loss finite and the last below the
    first. Reads the peak memory and the weight and moment bytes held."""
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.launch import train
    from repro_torch.models.model import get_model
    cfg = get_config(arch)
    argv = ["--arch", arch, "--steps", str(steps), "--batch", str(B),
            "--seq", str(S), "--log-every", "1"]
    if layers is not None:
        cfg = train.cut_config(cfg, layers)
        argv += ["--layers", str(layers)]
    if remat:
        argv.append("--remat")
    if lr is not None:
        argv += ["--lr", str(lr)]
    torch.cuda.reset_peak_memory_stats()
    records, undo = _step_recorder()
    try:
        hist = train.main(argv)
    finally:
        undo()
    model = get_model(cfg)
    want, blocks = train_launches(model, remat), train_blocks(model, remat)
    reading = train_readings(arch, cfg, records, B, S, card)
    _launch_counts(arch, records, want)
    got_blocks = [{k: r[k] for k in blocks} for r in records]
    losses = [h["loss"] for h in hist]
    reading.update(layers=cfg.num_layers, of=get_config(arch).num_layers,
                   remat=remat, lr=lr, loss=losses,
                   grad_norm=[h["grad_norm"] for h in hist],
                   launches_per_step=want, block_calls_per_step=got_blocks,
                   weight_bytes=records[-1]["weight_bytes"],
                   moment_bytes=records[-1]["moment_bytes"],
                   # weights, their gradients and the AdamW moments
                   state_bytes=2 * records[-1]["weight_bytes"]
                   + records[-1]["moment_bytes"])
    emit(reading)
    if got_blocks != [blocks] * len(records):
        raise AssertionError(f"train {arch}: MLA/MoE calls {got_blocks} "
                             f"!= {blocks} a step")
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"train {arch}: the loss did not fall: "
                             f"{losses}")
    return reading


def classifier_phase(device):
    """MIST's stage-2 classifier trained on the card and on the CPU: the
    same train accuracy and the same class for every corpus text."""
    import torch

    from repro_torch.core import mist_model
    texts = [t for t, _ in mist_model.synth_corpus(200, 0)]
    got = {}
    for side, dev in (("card", device), ("cpu", torch.device("cpu"))):
        clf = mist_model.train_classifier(seed=0, device=dev)
        got[side] = (clf.train_accuracy, [clf.classify(t) for t in texts],
                     clf.params["w"].cpu())
    same = got["card"][1] == got["cpu"][1]
    result = {"phase": "train classifier",
              "train_accuracy": {k: v[0] for k, v in got.items()},
              "same_classes": same, "texts": len(texts),
              "weight_max_gap": float((got["card"][2] - got["cpu"][2])
                                      .abs().max())}
    emit(result)
    if not same or got["card"][0] != got["cpu"][0]:
        raise AssertionError(f"classifier: {result}")


def train_group(device, timed, rows, card):
    """P14a and P14b on the card, after every serving group has freed its
    weights: the train launcher at smollm-135m's and paligemma-3b's full
    widths, remat, kimi .reduced(), the card-vs-CPU step at a 2-layer cut
    of both; then mamba2-370m at full width and recurrentgemma-9b at its
    8-layer cut through the launcher, mamba2's remat, the card-vs-CPU
    step of both at a cut; the refusal of the kernels without a backward
    kernel (K1-K3), and the MIST classifier."""
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "memory before train",
          "memory_allocated_bytes": torch.cuda.memory_allocated()})
    t0 = time.perf_counter()
    ckpt = ROOT / "build" / "chip_smoke_train"
    reading = timed(f"train {TRAIN}", train_smollm_phase, device, card,
                    ckpt)
    rows["flash_attention_bwd"]["launches"] = reading[
        "launches_per_step"]["flash_attention_bwd"]
    timed("train remat", remat_phase, device)
    gc.collect()
    torch.cuda.empty_cache()
    reading = timed(f"train {PALI_TRAIN}", train_pali_phase, device, card)
    rows["flash_attention_bwd"]["prefix_S512"]["launches"] = reading[
        "launches_per_step"]["flash_attention_bwd"]
    gc.collect()
    torch.cuda.empty_cache()
    timed("train kimi", train_kimi_phase, device)
    for arch in (TRAIN, PALI_TRAIN):
        timed(f"train replay {arch}", train_replay_phase, arch, device)
        gc.collect()
        torch.cuda.empty_cache()
    # the scan families (P14b): K5, K6 and their backward kernels
    gc.collect()
    torch.cuda.empty_cache()
    reading = timed(f"train {MAMBA2_TRAIN}", train_launcher_phase,
                    MAMBA2_TRAIN, device, card, MAMBA2_TRAIN_B, MAMBA2_TRAIN_S,
                    MAMBA2_TRAIN_STEPS, remat=True)
    rows["ssd_chunk_bwd"]["launches"] = reading["launches_per_step"][
        "ssd_chunk_bwd"]
    gc.collect()
    torch.cuda.empty_cache()
    timed(f"train remat {MAMBA2_TRAIN}", remat_phase, device, MAMBA2_TRAIN,
          2, MAMBA2_TRAIN_S)
    gc.collect()
    torch.cuda.empty_cache()
    reading = timed(f"train {RG_TRAIN}", train_launcher_phase, RG_TRAIN,
                    device, card, RG_TRAIN_B, RG_TRAIN_S, RG_TRAIN_STEPS,
                    layers=RG_TRAIN_LAYERS, remat=True, lr=RG_TRAIN_LR)
    rows["rglru_scan_bwd"]["launches"] = reading["launches_per_step"][
        "rglru_scan_bwd"]
    rows["flash_attention_bwd"]["window_2048"]["launches"] = reading[
        "launches_per_step"]["flash_attention_bwd"]
    gc.collect()
    torch.cuda.empty_cache()
    for arch in (MAMBA2_TRAIN, RG_TRAIN):
        timed(f"train replay {arch}", train_replay_phase, arch, device)
        gc.collect()
        torch.cuda.empty_cache()
    timed("train refusal", no_backward_phase, device)
    timed("train classifier", classifier_phase, device)
    emit({"phase": "train group", "card": card,
          "seconds": time.perf_counter() - t0})


def p14c_group(device, timed, rows, card):
    """P14c on the card, after the train group has freed its models: the
    launcher on each P14C configuration at its cut (3 steps of 1 x 2,048
    with remat, ``train_launcher_phase``), its K4 backward launches a step
    into the kernel row of its train shape; then each one's card-vs-CPU
    step at a 2-layer cut (``train_replay_phase``)."""
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    emit({"phase": "memory before p14c", "memory_allocated_bytes": held,
          "under_1_gb": held < 1e9})
    if held >= 1e9:
        raise AssertionError(f"p14c: {held} bytes held before the group")
    t0 = time.perf_counter()
    for arch, (layers, lr) in P14C.items():
        reading = timed(f"train {arch}", train_launcher_phase, arch, device,
                        card, P14C_B, P14C_S, P14C_STEPS, layers=layers,
                        remat=True, lr=lr)
        row = rows["flash_attention_bwd"].get(f"train {arch}")
        if row is not None:
            row["launches"] = reading["launches_per_step"][
                "flash_attention_bwd"]
        gc.collect()
        torch.cuda.empty_cache()
    for arch in P14C:
        timed(f"train replay {arch}", train_replay_phase, arch, device)
        gc.collect()
        torch.cuda.empty_cache()
    emit({"phase": "p14c group", "card": card,
          "seconds": time.perf_counter() - t0})


def _tensors(tree):
    import torch
    if isinstance(tree, torch.Tensor):
        yield tree
        return
    for v in (tree.values() if isinstance(tree, dict) else tree):
        yield from _tensors(v)


def _islands_of(n):
    """``benchmarks/micro.py``'s registry of n islands (a laptop, then
    edge and cloud islands in turn), from the port's own modules."""
    from repro_torch.core.islands import (IslandRegistry, cloud_island,
                                          edge_island, personal_island)
    reg = IslandRegistry()
    reg.register(personal_island("laptop"), reg.attestation_token("laptop"))
    for i in range(n - 1):
        isl = (edge_island(f"edge{i}", privacy=0.6 + 0.3 * (i % 2))
               if i % 2 else cloud_island(f"cloud{i}"))
        reg.register(isl, reg.attestation_token(isl.island_id))
    return reg


def route_batch_phase(device, card, m=4096, n=16, reps=50):
    """``route_batch`` at ``benchmarks/micro.py``'s size (4,096 requests x
    16 islands) on the card: its assignments, feasibility and scores equal
    to the same call on the CPU, and ``pareto_front`` too; the time a
    call (host clock over ``reps`` calls, the card synchronized at the
    end, as the benchmark times it) beside the card's name."""
    import numpy as np
    import torch

    from repro_torch.core import routing as rt
    from repro_torch.core.tide import TIDE
    reg = _islands_of(n)
    tide = TIDE(reg)
    rng = np.random.default_rng(0)
    sens = rng.uniform(0, 1, m).astype(np.float32)
    gate = np.zeros(m, np.float32)
    w = (0.4, 0.3, 0.3)
    out, us = {}, {}
    for side, dev in (("card", device), ("cpu", torch.device("cpu"))):
        tbl = rt.pack_islands(reg.all(), [], tide, device=dev)
        reqs = rt.pack_requests(sens, gate, device=dev)
        got = rt.route_batch(tbl, reqs, w)               # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            got = rt.route_batch(tbl, reqs, w)
        torch.cuda.synchronize()
        us[side] = (time.perf_counter() - t0) / reps * 1e6
        out[side] = [t.cpu() for t in got] + [rt.pareto_front(tbl).cpu()]
    same = [bool(torch.equal(a, b)) for a, b in zip(out["card"], out["cpu"])]
    result = {"phase": "route_batch", "requests": m, "islands": n,
              "card": card, "us_per_call_card": us["card"],
              "us_per_call_cpu": us["cpu"],
              "requests_per_s_card": m / (us["card"] / 1e6),
              "feasible": int(out["card"][1].sum()),
              "islands_chosen": len(set(out["card"][0].tolist())),
              "equal_to_cpu": dict(zip(("assign", "feasible", "scores",
                                        "pareto_front"), same))}
    emit(result)
    if not all(same[:2]) or not same[3]:
        raise AssertionError(f"route_batch: card and CPU differ: {result}")


def fp32_tail(b):
    """Make stacked batcher ``b`` keep every cache leaf in fp32 (the
    serving paths keep the conv tails and the K/V in bf16): its slot rows
    now, and each admission's prefill cache. A diagnostic that takes the
    stored bf16 roundings out of the card-vs-CPU replay."""
    import torch
    init = b.model.init_cache
    b.model.init_cache = (lambda batch, max_len, dtype=None, device=None:
                          init(batch, max_len, torch.float32, device))
    b._cache = b.model.init_cache(b.num_slots, b.max_len, device=b.device)
    return b


def tensor_bytes(tree):
    """Bytes of every tensor in a nested dict/list of tensors."""
    import torch
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    items = tree.values() if isinstance(tree, dict) else tree
    return sum(tensor_bytes(v) for v in items)


def params_to(params, device):
    """A copy of a model's parameter dict on ``device``."""
    import torch
    if isinstance(params, torch.Tensor):
        return params.to(device)
    if isinstance(params, dict):
        return {k: params_to(v, device) for k, v in params.items()}
    return [params_to(v, device) for v in params]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs the port on an NVIDIA GPU", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} is missing; run from a "
              f"checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = gpu_line()
    gpu = torch.device("cuda")
    emit({"phase": "device", "nvidia_smi": card,
          "torch_name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "allow_tf32": torch.backends.cuda.matmul.allow_tf32})
    seconds = {}

    def timed(phase, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        seconds[phase] = time.perf_counter() - t0
        return out

    from repro_torch.configs.base import get_config
    from repro_torch.kernels import _build
    from repro_torch.models.model import get_model
    from repro_torch.serving.batcher import (ContinuousBatcher,
                                             PagedContinuousBatcher)
    timed("build", _build.build_all)
    emit({"phase": "build", "seconds": seconds["build"],
          "ptxas": {k: [ln.strip() for ln in v.splitlines()
                        if "registers" in ln or "spill" in ln]
                    for k, v in _build.BUILD_LOGS.items()}})

    rows = timed("kernels", kernel_phase, gpu)

    full = get_config("smollm-135m")           # full width, not .reduced()
    cfg, params = cut_model(full, get_model(full).init(seed=0, device=gpu),
                            MAIN_LAYERS, "main cut")
    launches, wall = timed("main_path", main_path, cfg, params, gpu)
    for k in ("paged_decode_attention", "chunked_prefill_attention"):
        rows[k]["launches"] = launches[k]
    base = timed("profile main_path", profile_phase, "main_path", cfg,
                 params, gpu, wall, streams=True)
    timed("traced main_path", traced_phase, cfg, params, gpu, base,
          launches, wall)
    main_busy_s = base["busy_s"]
    del base
    scfg, sched = cut_model(cfg, params, SCHED_LAYERS, "schedule cut")
    timed("profile host split", host_split_phase, scfg, sched, gpu)
    timed("degradation", degradation_phase, scfg, sched, gpu)
    timed("trace harness", trace_harness_phase, scfg, sched, gpu)
    timed("serve --trace", serve_trace_phase)
    timed("leakage", leakage_phase, scfg, sched, gpu)
    timed("constant shape", constant_shape_phase, cfg, params, gpu,
          main_busy_s, (scfg, sched))
    timed("fp8 smollm", fp8_phase, "fp8 smollm", cfg, params, gpu, B=4,
          S=1024, T=32)
    _, wall, _ = timed("stacked", serve_path, "stacked", cfg, params, gpu,
                       cache="stacked")
    timed("profile stacked", profile_phase, "stacked", cfg, params, gpu,
          wall, cache="stacked")
    timed("paged_prefill_full", serve_path, "paged_prefill_full", cfg,
          params, gpu, prefill="full")
    timed("paged_unfused", serve_path, "paged_unfused", cfg, params, gpu,
          fused=False)
    _, _, over = timed("oversubscribed", serve_path, "oversubscribed",
                       scfg, sched, gpu, **OVERSUBSCRIBED)
    if over["preemptions"] == 0:
        raise AssertionError("oversubscribed pool: no preemption")
    timed("per_request", per_request_phase, cfg, params, gpu)

    cpu = torch.device("cpu")
    runs_on = [(gpu, params), (cpu, params_to(params, cpu))]
    timed("replay", replay, "replay", cfg, runs_on,
          lambda dev, p: PagedContinuousBatcher(
              cfg, params=p, num_slots=4, max_len=256, device=dev),
          _capture_fused)
    timed("replay stacked", replay, "replay stacked", cfg, runs_on,
          lambda dev, p: ContinuousBatcher(
              cfg, params=p, num_slots=4, max_len=256, device=dev),
          _capture_stacked)
    timed("churn", churn_phase, scfg, sched, gpu)
    timed("churn downhill", churn_downhill_phase, scfg, sched, gpu)
    timed("churn stacked", churn_stacked_phase, scfg, sched, gpu)
    # its card-vs-CPU replay at the schedule cut too
    timed("stochastic", stochastic_phase, scfg, sched, gpu, scfg,
          [(gpu, sched), (cpu, params_to(sched, cpu))])
    del runs_on, params, sched
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "memory before mamba2",
          "memory_allocated_bytes": torch.cuda.memory_allocated()})

    # mamba2-370m at full width: stacked batchers (cache="auto"), K5 only
    mcfg = get_config("mamba2-370m")
    mparams = get_model(mcfg).init(seed=0, device=gpu)
    mscfg, mserved = cut_model(mcfg, mparams, SERVE_LAYERS, "serve cut")
    launches, wall, _ = timed("mamba2", serve_path, "mamba2", mscfg,
                              mserved, gpu)
    rows["ssd_chunk"]["launches"] = launches["ssd_chunk"]
    timed("profile mamba2", profile_phase, "mamba2", mscfg, mserved, gpu,
          wall)
    timed("per_request mamba2", per_request_phase, mscfg, mserved, gpu,
          name="per_request mamba2")
    del mserved
    mruns = [(gpu, mparams), (cpu, params_to(mparams, cpu))]
    timed("replay mamba2", replay, "replay mamba2", mcfg, mruns,
          lambda dev, p: ContinuousBatcher(
              mcfg, params=p, num_slots=4, max_len=256, device=dev),
          _capture_stacked, tol=MAMBA2_REPLAY_LOGIT_TOL,
          first_tol=MAMBA2_PREFILL_LOGIT_TOL)
    timed("replay mamba2 fp32 conv", replay, "replay mamba2 fp32 conv",
          mcfg, mruns, lambda dev, p: fp32_tail(ContinuousBatcher(
              mcfg, params=p, num_slots=4, max_len=256, device=dev)),
          _capture_stacked, tol=MAMBA2_PREFILL_LOGIT_TOL)
    del mruns, mparams
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "memory before recurrentgemma",
          "memory_allocated_bytes": torch.cuda.memory_allocated()})

    # recurrentgemma-9b at full width: stacked batchers (cache="auto"):
    # K6 and K4 at prefill, K3 at decode
    rcfg = get_config("recurrentgemma-9b")
    rparams = timed("init recurrentgemma", get_model(rcfg).init, seed=0,
                    device=gpu)
    cycle = len(rcfg.pattern)
    rscfg, rserved = cut_model(rcfg, rparams,
                               -(-SERVE_LAYERS // cycle) * cycle, "serve cut")
    launches, wall, _ = timed("recurrentgemma", serve_path,
                              "recurrentgemma", rscfg, rserved, gpu)
    for k in ("decode_attention", "flash_attention", "rglru_scan"):
        rows[k]["launches"] = launches[k]
    timed("profile recurrentgemma", profile_phase, "recurrentgemma", rscfg,
          rserved, gpu, wall)
    timed("per_request recurrentgemma", per_request_phase, rscfg, rserved,
          gpu, name="per_request recurrentgemma")
    del rserved
    # the replay at full width, cut to one pattern cycle: its weights are
    # the first three layers of the served model's
    ccfg, cut = cut_model(rcfg, rparams, len(rcfg.pattern))
    rruns = [(gpu, cut), (cpu, params_to(cut, cpu))]
    timed("replay recurrentgemma", replay, "replay recurrentgemma", ccfg,
          rruns, lambda dev, p: ContinuousBatcher(
              ccfg, params=p, num_slots=4, max_len=256, device=dev),
          _capture_stacked, tol=RG_REPLAY_LOGIT_TOL,
          first_tol=RG_PREFILL_LOGIT_TOL)
    timed("replay recurrentgemma fp32 cache", replay,
          "replay recurrentgemma fp32 cache", ccfg, rruns,
          lambda dev, p: fp32_tail(ContinuousBatcher(
              ccfg, params=p, num_slots=4, max_len=256, device=dev)),
          _capture_stacked, tol=RG_PREFILL_LOGIT_TOL)
    del rruns, cut
    timed("fp8 recurrentgemma", fp8_phase, "fp8 recurrentgemma", rcfg,
          rparams, gpu, B=2, S=512, T=16)
    del rparams

    # P12a: paligemma-3b, musicgen-large, qwen3-4b and glm4-9b at full
    # width, one at a time, on the paged main path (and paligemma on every
    # path that applies its prefix); then the snapshot router
    for arch in P12A:
        p12a_group(arch, gpu, timed, rows)
    timed("route_batch", route_batch_phase, gpu, card)
    # P12b: kimi .reduced() on the paged main path, then
    # deepseek-v2-lite-16b at full width, the largest model of the script
    ds_want = p12b_group(gpu, timed, rows)
    # P13a: the distributed slice on gloo ranks on the card
    one, mesh_peaks = dist_group(gpu, timed, card, ds_want, rows)
    # P13d: the ZeRO-3 placement (--fsdp) on two gloo ranks
    p13d_group(gpu, timed, card, rows, one, mesh_peaks)
    # P13e: every placement the reference runs (whole caches, replicated
    # batches, mid-head splits) on two gloo ranks
    p13e_group(gpu, timed, card, rows)
    # P13c: qwen3-32b on the card: the paged main path at a 28-layer cut,
    # its replay, and tensor parallel over two gloo ranks
    p13c_group(gpu, timed, card, rows)
    # P13b: WAVES routing inside the serve step, and the dry-run's CLIs
    p13b_group(gpu, timed, card, rows)
    # P14a: training on the card, last (paligemma's weights and AdamW
    # state are 40 GB)
    train_group(gpu, timed, rows, card)
    # P14c: the five configurations the card had not trained
    p14c_group(gpu, timed, rows, card)
    emit({"phase": "seconds", **seconds})

    print(card)
    emit({"kernels": list(rows.values())})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
