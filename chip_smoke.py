#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (each raises on failure, and the script then exits non-zero):

1. device: the card's name and power limit (nvidia-smi) and torch's view;
   TF32 is switched off for matmuls and convolutions, so every fp32
   product runs in full fp32;
2. build: the six hand-written CUDA kernels (``src/repro_torch/csrc``),
   one nvcc per source, in parallel;
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
4. serving paths, each on the quickstart mesh (laptop 6 slots, phone 1,
   home-nas 8) serving smollm-135m at its full published widths with
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
   - profile host split: the same traffic unprofiled and then with a
     ``DispatchProfiler`` on every batcher, each orchestrator tick timed:
     host_plan / bucket / dispatch_submit / device_sync per island and
     the orchestrator's own share, both runs' streams the profile's;
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
     within 1.25x; then the main path default, constant, constant,
     default for wall tokens/s, and one profiled constant run for its
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
   the quickstart traffic through ``build_island_batchers(cache="auto")``
   (stacked batchers: K5 on all 48 layers of every prefill dispatch, no
   attention kernel), a profile of it, the per-request path, and the
   card-vs-CPU replay on the stacked batcher, once as served (bf16 conv
   tail) and once with an fp32 conv tail, held tighter;
8. recurrentgemma: recurrentgemma-9b at its full published widths and
   depth (38 layers: 26 RG-LRU and 12 local-attention layers, d_model
   4096, lru_width 4096 in 16 gate blocks, 16 heads of 256 on one kv
   head, window 2048, d_ff 12288, vocab 256000; 8.6 B parameters) with
   seeded random fp32 weights, bf16 K/V and conv tail, fp32 state, after
   the earlier models are freed: the quickstart traffic through
   ``build_island_batchers(cache="auto")`` (stacked batchers: K6 on the
   26 RG-LRU layers and K4 on the 12 attention layers of every prefill
   dispatch, K3 on the 12 attention layers of every decode step), a
   profile of it (with the matmul time and rate split by prefill and
   decode dispatch), the per-request path, and the card-vs-CPU replay on
   the stacked batcher, cut to one pattern cycle (3 layers at full
   width: 34 GB of fp32 weights and 26 TFLOP prefills do not replay on
   a CPU), once as served and once with every cache leaf in fp32; then
   the fp8 phase on the served weights (2 rows, a 512-token prompt, 16
   steps: the local-attention rings' scales at head_dim 256).

The profile phases read the device spans from the profiler's raw
events (parsing them into host-op trees takes ~60 s a main path run);
only recurrentgemma's matmul split parses them.

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


def dense_decode_case(dev, gen, H=9, Hkv=3, D=64, S=2048):
    """K3 at the stacked path's decode shapes: 8 slot rows of a
    (8, 2048, Hkv, D) bf16 cache, per-row fills spread over 1-1600 (an idle
    slot decodes at fill 1)."""
    import torch
    valid = [1, 16, 17, 300, 1024, 1, 1600, 32]
    B = len(valid)
    k, v = (torch.randn(B, S, Hkv, D, generator=gen, device=dev)
            .to(torch.bfloat16) for _ in range(2))
    q = torch.randn(B, H, D, generator=gen, device=dev)
    lens = torch.tensor(valid, dtype=torch.int32, device=dev)
    live = sum(valid)
    nbytes = 2 * q.numel() * 4 + B * 4 + live * Hkv * D * 2 * 2
    flops = 4 * live * H * D
    return (q, k, v, lens), nbytes, flops, valid


def dense_prefill_case(dev, gen, H=9, Hkv=3, D=64, S=1024, window=None):
    """K4 at a full-prompt prefill: one prompt of S tokens, fp32 q/k/v
    (fp32 weights), causal, with a local-attention window or none. The
    flops count the pairs the mask allows: the causal half, or a band."""
    import torch
    q = torch.randn(1, S, H, D, generator=gen, device=dev)
    k, v = (torch.randn(1, S, Hkv, D, generator=gen, device=dev)
            for _ in range(2))
    nbytes = 4 * (2 * q.numel() + k.numel() + v.numel())
    pairs = sum(min(t + 1, window or S) for t in range(S))
    flops = 4 * H * D * pairs
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


def ssd_kernel_rows(dev, gen):
    """K5 against its plain version at mamba2-370m's prefill shapes: six
    chunks of 256 (a ~1,500-token note) and one ragged chunk of 37 (a
    short query). Every output holds to ``kernels.ssd.error_bound``
    (1e-4 of the sum of its terms' magnitudes, widened by e^(2 dc) - 1
    for a gap dc between the two sides' cum); ``max_abs_err`` is the
    largest gap over the four outputs. Returns the six-chunk row."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd import error_bound, kernel_attrs, ssd_chunk
    row = None
    for nc, Q in ((6, 256), (1, 37)):
        args, nbytes, flops = ssd_case(dev, gen, nc, Q)
        got = ssd_chunk(*args)
        want = ref.ssd_chunk(*args)
        torch.cuda.synchronize()
        bounds, dc = error_bound(*args, got[3], want[3])
        err, ratio = 0.0, 0.0
        for name, g, w, b in zip(("y_intra", "state", "decay", "cum"),
                                 got, want, bounds):
            gap = (g - w).abs()
            if not torch.isfinite(g).all() or bool((gap > b).any()):
                raise AssertionError(
                    f"ssd_chunk {name} (nc {nc}, Q {Q}): max gap "
                    f"{float(gap.max())} exceeds its bound "
                    f"(max gap/bound {float((gap / b).max())})")
            err = max(err, float(gap.max()))
            ratio = max(ratio, float((gap / b).max()))
        # both sides sum cum in order in fp32 (torch.cumsum along a
        # non-innermost dimension is a serial loop on the card)
        if not torch.equal(got[3], want[3]):
            raise AssertionError(f"ssd_chunk cum (nc {nc}, Q {Q}) is not "
                                 f"bit-equal to the plain version's")
        del got, want, bounds
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
    # the kernels line carries K1 at the main path's largest island, with
    # the phone island's one slot beside it (a phase line of its own too)
    for (name, wrapper, plain, src, replaces), case, geom, role in (
            (K1, decode_case, "8 slots, fills 1-1600", "row"),
            (K1, lambda dev, gen: decode_case(dev, gen, valid=(1600,),
                                              idle=()),
             "the phone island: 1 slot, fill 1600", "phone_island"),
            (("chunked_prefill_attention", chunked_prefill_attention,
              ref.chunked_prefill_attention,
              "src/repro_torch/csrc/chunked_prefill.cu",
              "src/repro/kernels/chunked_prefill.py:123"), prefill_case,
             "4 rows of 64 tokens", "row")):
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

    def sdpa_prefill(q, k, v, window=None):
        """(B, H, S, D) inputs, and a band mask where a window bites."""
        qkv = tuple(t.transpose(1, 2).contiguous() for t in (q, k, v))
        S = q.shape[1]
        if not window or window >= S:
            return qkv
        pos = torch.arange(S, device=q.device)
        band = ((pos[None, :] <= pos[:, None])
                & (pos[None, :] > pos[:, None] - window))
        return qkv + (band,)

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
    # the biting window's numbers beside); the others are phase lines
    for (name, src, replaces), geom, case_kw, role in (
            (K3, "smollm-135m stacked", dict(), None),
            (K3, "qwen3-4b heads", dict(H=32, Hkv=8, D=128), None),
            (K3, "recurrentgemma-9b heads", RG, "row"),
            (K4, "smollm-135m", dict(), None),
            (K4, "qwen3-4b heads", dict(H=32, Hkv=8, D=128, S=2048), None),
            (K4, "recurrentgemma-9b heads, window 2048",
             dict(RG, S=2048, window=2048), "row"),
            (K4, "recurrentgemma-9b heads, window 512",
             dict(RG, S=2048, window=512), "biting_window"),
            (K4, "recurrentgemma-9b heads, window 2047 (the windowed walk "
                 "over all but one causal pair)",
             dict(RG, S=2048, window=2047), None)):
        if name == "decode_attention":
            args, nbytes, flops, fills = dense_decode_case(dev, gen,
                                                           **case_kw)
            wrapper, plain, rate = decode_attention, ref.decode_attention, \
                BF16_FLOP_PER_S
            lib_fn = (lambda q, k, v, m: F.scaled_dot_product_attention(
                q, k, v, attn_mask=m, enable_gqa=True))
            lib_inputs = (lambda c: sdpa_decode(*c))
            shape = {"fills": fills}
        else:
            w = case_kw.get("window")
            args, nbytes, flops, S = dense_prefill_case(dev, gen, **case_kw)
            wrapper = (lambda q, k, v, w=w: flash_attention(q, k, v,
                                                            window=w))
            plain = (lambda q, k, v, scale, w=w: ref.flash_attention(
                q, k, v, scale, True, w))
            rate = TF32_FLOP_PER_S
            lib_fn = sdpa_prefill_call
            lib_inputs = (lambda c, w=w: sdpa_prefill(*c, w))
            # the wrapper drops a window of at least S: the causal walk
            shape = {"S": S, "window": w,
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
                **shape)
        emit({"phase": "kernel", **row, **extra, "geometry": geom,
              "shape_q": list(args[0].shape),
              "shape_kv": list(args[1].shape), **shape, "bytes": nbytes,
              "flops": flops, "library_max_abs_err": lib_err,
              "tolerance": KERNEL_TOL, "input_copies": n,
              "wrapper_host_us": host_us(lambda: wrapper(*args))})
        del args, out
    rows["ssd_chunk"] = ssd_kernel_rows(dev, gen)
    rows["rglru_scan"] = rglru_kernel_rows(dev, gen)
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
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.paged_attention import paged_decode_attention
    from repro_torch.kernels.rglru import rglru_scan
    from repro_torch.kernels.ssd import ssd_chunk
    return {f.__name__: f for f in (paged_decode_attention,
                                    chunked_prefill_attention,
                                    decode_attention, flash_attention,
                                    ssd_chunk, rglru_scan)}


def zero_launches():
    for f in kernel_fns().values():
        f.launches = 0


def read_launches():
    return {n: f.launches for n, f in kernel_fns().items()}


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
               **bkw):
    """One serving path over the quickstart traffic: drives it with the
    launch counters zeroed just before and read just after, checks that
    every request resolved with finite logits and caches and that the
    path went through its kernels, and emits its end-to-end numbers.
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
    if not any(launches.values()):
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
        "tick_dispatches_max": orch.tick_stats["tick_dispatches_max"],
        "generated_tokens": gen_tokens, "wall_s": wall,
        "tokens_per_s": gen_tokens / wall,
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
    for key, fam in (("gemm", "matmul"), ("gemv", "matmul"),
                     ("xmma", "matmul"), ("cutlass", "matmul"),
                     ("Memcpy", "memcpy"), ("Memset", "memset")):
        if key in name:
            return fam
    return "other (elementwise, reductions, indexing)"


DISPATCH_RANGES = {"_prefill": "prefill dispatch",
                   "_decode_all": "decode dispatch"}


def _label_dispatches(batchers):
    """Wrap each stacked batcher's prefill and decode dispatch in a
    ``record_function`` range, so that a profile can tell which dispatch
    launched a kernel."""
    from torch.profiler import record_function
    for b in batchers.values():
        for attr, label in DISPATCH_RANGES.items():
            fn = getattr(b, attr)

            def ranged(*args, fn=fn, label=label, **kw):
                with record_function(label):
                    return fn(*args, **kw)

            setattr(b, attr, ranged)


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


def _dispatch_matmuls(events):
    """Device time and flops of the matmul kernels by the dispatch that
    launched them: each kernel belongs to the aten op that launched it,
    and that op to its innermost enclosing dispatch range. Flops come from
    the ops' recorded input shapes, so the rate is this trace's."""
    from torch.autograd import DeviceType
    kinds = set(DISPATCH_RANGES.values())
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
        kind = p.name if p is not None else "outside a dispatch"
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
                  split_dispatches=False, streams=False, tracer=None, **bkw):
    """A serving path's workload once more, on fresh batchers, under
    ``torch.profiler``: device busy time as the union of kernel
    intervals, device time by kernel family, and the device-to-host
    copies. The busy time does not depend on the profiler's host
    overhead, so the idle share is read against the unprofiled run's wall
    time. With ``split_dispatches`` (stacked batchers) the host ops are
    recorded too, with their input shapes, and the matmul time and rate
    are split by prefill and decode dispatch. With ``streams`` (fused
    paged batchers) the run's streams are recorded; ``tracer`` goes to
    the orchestrator. Returns the run (streams, work clocks, launches,
    copies) for the traced phase to compare."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    orch, batchers, rids, flags = serving_stack(cfg, params, device, max_len,
                                                tracer=tracer, **bkw)
    captured = _orch_streams(orch, batchers) if streams else None
    acts = [ProfilerActivity.CUDA]
    if split_dispatches:
        _label_dispatches(batchers)
        acts.append(ProfilerActivity.CPU)
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    with profile(activities=acts, record_shapes=split_dispatches) as prof:
        orch.run_until_done(max_ticks=4000)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    spans, events = _device_spans(prof, split_dispatches)
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
          "dtoh_copies": dtoh,
          **({"matmul_by_dispatch": _dispatch_matmuls(events)}
             if split_dispatches else {})})
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
    stats = eng.stats()
    emit({"phase": name, "model": cfg.name, "requests": n,
          "served": len(served), "rejected": len(eng.rejected),
          "local_generate_calls": len(calls),
          "by_island": stats["by_island"],
          "launches": {k: v for k, v in launches.items() if v},
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


def stochastic_phase(cfg, params, device, runs_on):
    """The quickstart traffic through the fused paged batchers at
    ``temperature`` 0.8, ``seed`` 7: two runs give identical streams; a
    run with ``drain_island("laptop")`` after tick 2 gives the same
    streams under the near-tie rule (held on the perturbed scores); and
    the card and CPU replay of the four queries agree under it."""
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
    replay("replay stochastic", cfg, runs_on,
           lambda dev, p: PagedContinuousBatcher(
               cfg, params=p, num_slots=4, max_len=256, device=dev,
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
    labels = set(DISPATCH_RANGES.values())
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


def host_split_phase(cfg, params, device, base):
    """The main path's traffic once unprofiled and once with one
    ``DispatchProfiler`` per batcher, back to back, each orchestrator
    tick timed: each island's phase report, and the profiled run split
    into the batchers' host_plan / bucket / dispatch_submit / device_sync
    and the orchestrator's own time (routing, MIST, telemetry: the tick
    wall less the profiled batcher ticks). Both runs' streams must be
    those of ``profile main_path``'s run (``base``)."""
    from repro_torch.obs import DispatchProfiler
    plain, plain_ns, plain_wall, _p, _o = _tick_walls(cfg, params, device,
                                                      False)
    streams, tick_ns, wall, profs, orch = _tick_walls(cfg, params, device,
                                                      True)
    if streams != base["streams"] or plain != base["streams"]:
        raise AssertionError("host split: streams differ from the "
                             "profile run's")
    total = sum(tick_ns)
    phases = {p: sum(pr.totals[p] for pr in profs.values())
              for p in DispatchProfiler.PHASES}
    batcher_ns = sum(pr.total_ns for pr in profs.values())
    split_ms = {p: v / 1e6 for p, v in phases.items()}
    split_ms["orchestrator"] = (total - batcher_ns) / 1e6
    emit({"phase": "profile host split", "model": cfg.name,
          "requests": len(streams), "ticks": orch.tick_stats["ticks"],
          "batcher_ticks": sum(len(pr.ticks) for pr in profs.values()),
          "dispatches": sum(pr.dispatches for pr in profs.values()),
          "islands": {iid: pr.report() for iid, pr in profs.items()},
          "tick_wall_ms": total / 1e6, "split_ms": split_ms,
          "split_frac": {k: v * 1e6 / total for k, v in split_ms.items()},
          "wall_s_profiled": wall, "wall_s_unprofiled": plain_wall,
          "tick_wall_ms_unprofiled": sum(plain_ns) / 1e6,
          "streams_identical": True})


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
    emit({"phase": "trace harness", "model": cfg.name, "n": n,
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
    emit({"phase": "leakage", "model": cfg.name, **out, "checks": checks,
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


def constant_shape_phase(cfg, params, device, main_busy_s):
    """Constant-shape dispatch against the default on the card, at full
    width: (a) benchmarks/leakage.py's ``constant_shape_ab`` (its checks:
    streams, the work clock within 1.25x, one prefill and one decode
    shape), (b) the main path's traffic with ``constant_shape`` on every
    island. Both: ``_shape_ab``. Then (b)'s card cost: wall tokens/s of
    the serving path (launches checked by ``serve_path``) run default,
    constant, constant, default back to back (host walls drift within a
    call), and device busy seconds from one profiled rerun, against
    ``profile main_path``'s (``main_busy_s``)."""
    out, faults = {}, []
    for label, main in (("constant_shape_ab", False), ("main_path", True)):
        base = shape_run(cfg, params, device, False, main)
        const = shape_run(cfg, params, device, True, main)
        f, out[label] = _shape_ab(label, base, const)
        faults += f
    if out["constant_shape_ab"]["work_overhead"] > 1.25:
        faults.append("constant_shape_ab: work clock over 1.25x")
    walls = {"default": [], "constant": []}
    tps = {"default": [], "constant": []}
    for constant in (False, True, True, False):
        label = "constant" if constant else "default"
        _, wall, result = serve_path(f"main_path {label} (A/B)", cfg,
                                     params, device,
                                     constant_shape=constant)
        walls[label].append(wall)
        tps[label].append(result["tokens_per_s"])
    wall = sum(walls["constant"]) / 2
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

    cfg = get_config("smollm-135m")            # full width, not .reduced()
    params = get_model(cfg).init(seed=0, device=gpu)
    launches, wall = timed("main_path", main_path, cfg, params, gpu)
    for k in ("paged_decode_attention", "chunked_prefill_attention"):
        rows[k]["launches"] = launches[k]
    base = timed("profile main_path", profile_phase, "main_path", cfg,
                 params, gpu, wall, streams=True)
    timed("traced main_path", traced_phase, cfg, params, gpu, base,
          launches, wall)
    timed("profile host split", host_split_phase, cfg, params, gpu, base)
    main_busy_s = base["busy_s"]
    del base
    timed("degradation", degradation_phase, cfg, params, gpu)
    timed("trace harness", trace_harness_phase, cfg, params, gpu)
    timed("serve --trace", serve_trace_phase)
    timed("leakage", leakage_phase, cfg, params, gpu)
    timed("constant shape", constant_shape_phase, cfg, params, gpu,
          main_busy_s)
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
    _, _, over = timed("oversubscribed", serve_path, "oversubscribed", cfg,
                       params, gpu, **OVERSUBSCRIBED)
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
    timed("churn", churn_phase, cfg, params, gpu)
    timed("churn downhill", churn_downhill_phase, cfg, params, gpu)
    timed("churn stacked", churn_stacked_phase, cfg, params, gpu)
    timed("stochastic", stochastic_phase, cfg, params, gpu, runs_on)
    del runs_on, params
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "memory before mamba2",
          "memory_allocated_bytes": torch.cuda.memory_allocated()})

    # mamba2-370m at full width: stacked batchers (cache="auto"), K5 only
    mcfg = get_config("mamba2-370m")
    mparams = get_model(mcfg).init(seed=0, device=gpu)
    launches, wall, _ = timed("mamba2", serve_path, "mamba2", mcfg, mparams,
                              gpu)
    rows["ssd_chunk"]["launches"] = launches["ssd_chunk"]
    timed("profile mamba2", profile_phase, "mamba2", mcfg, mparams, gpu,
          wall)
    timed("per_request mamba2", per_request_phase, mcfg, mparams, gpu,
          name="per_request mamba2")
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

    # recurrentgemma-9b at full width and depth: stacked batchers
    # (cache="auto"): K6 and K4 at prefill, K3 at decode
    rcfg = get_config("recurrentgemma-9b")
    rparams = timed("init recurrentgemma", get_model(rcfg).init, seed=0,
                    device=gpu)
    launches, wall, _ = timed("recurrentgemma", serve_path,
                              "recurrentgemma", rcfg, rparams, gpu)
    for k in ("decode_attention", "flash_attention", "rglru_scan"):
        rows[k]["launches"] = launches[k]
    timed("profile recurrentgemma", profile_phase, "recurrentgemma", rcfg,
          rparams, gpu, wall, split_dispatches=True)
    timed("per_request recurrentgemma", per_request_phase, rcfg, rparams,
          gpu, name="per_request recurrentgemma")
    # the replay at full width, cut to one pattern cycle: its weights are
    # the first three layers of the served model's
    ccfg = dataclasses.replace(rcfg, num_layers=len(rcfg.pattern))
    cut = {"embed": rparams["embed"], "final_norm": rparams["final_norm"],
           "layers": rparams["layers"][:ccfg.num_layers]}
    emit({"phase": "replay cut", "model": rcfg.name,
          "layers": ccfg.num_layers, "of": rcfg.num_layers,
          "pattern": list(rcfg.pattern), "d_model": ccfg.d_model,
          "vocab": ccfg.vocab_size, "weight_bytes": tensor_bytes(cut)})
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
    emit({"phase": "seconds", **seconds})

    print(card)
    emit({"kernels": list(rows.values())})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
