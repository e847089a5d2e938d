"""IslandRun on PyTorch and CUDA: the port of the JAX package ``repro``.

The port carries the serving paths of attention-only decoders, and of
the Mamba-2 (mamba2-370m) and RG-LRU (recurrentgemma-9b, with windowed
local attention) families on the stacked batcher and the per-request
path, end to end on an NVIDIA H100, with greedy or stochastic sampling
(``serving.sampling``: temperature, top-k, top-p, counter-based draws
that are the same on the card and the CPU) and live migration:

* ``serving.engine.TickOrchestrator`` routes the pending pool once per
  tick (``core.routing``) into per-island batchers
  (``serving.batcher``): the ``PagedContinuousBatcher`` over the
  trust-tiered paged KV pool (``serving.kvpool``; chunked prefill with the
  fused two-dispatch tick or unfused, or full-prompt prefill; preemption
  with resume tickets when the pool runs out) or the stacked
  ``ContinuousBatcher`` over dense per-slot caches; both freeze a request
  into a migration ticket (``freeze_request``) and thaw one
  (``submit_ticket``) by page or dense-row import or by recompute, and
  ``TickOrchestrator.drain_island``/``fail_island`` move requests off an
  island (``kvpool.export_request``/``import_request`` hold the trust
  rules);
* ``serving.engine.InferenceEngine`` routes one request at a time into a
  ``LocalModelServer`` (``python -m repro_torch.launch.serve``);
* ``models`` runs the decoders, each layer's mixer by its block type
  (attention, SSM or RG-LRU); their attention goes through four
  hand-written CUDA C++ kernels for ``sm_90a`` (``kernels``, sources in
  ``csrc/``): paged decode, chunked prefill, dense decode and full-prompt
  prefill (the last two also at head_dim 256 and with a local-attention
  window), Mamba-2's prefill through a fifth, the SSD chunk pieces
  (``kernels.ssd``), and the RG-LRU recurrence through a sixth
  (``kernels.rglru``).

Run mamba2 or recurrentgemma on the CPU with ``python -m
repro_torch.launch.serve --device cpu --arch mamba2-370m`` (or ``--arch
recurrentgemma-9b``; add ``--batched`` for the stacked batcher) and their
parity tests with ``pytest tests/test_torch_ssd.py
tests/test_torch_ssm_model.py tests/test_torch_ssm_serving.py`` and
``pytest tests/test_torch_rglru_*.py``; on the card, ``python3
chip_smoke.py`` serves both at full width. The sampler and migration
hold to the reference on the CPU with ``pytest
tests/test_torch_sampling.py tests/test_torch_migration.py``;
``chip_smoke.py`` also drives island churn (a drain and a failure, with
page imports, on paged and stacked batchers) and stochastic serving on
the card.

The orchestrator also carries the reference's degradation ladder (SLO
expiry on a monotonic mesh work clock, watermark shedding, submit-time
backpressure, straggler hedging under ``FaultPlan``), SLO classes with
class-aware batchers, tenant fairness, and the observability layer
(``obs``: the span tracer, its Chrome-trace export and the per-tick
``DispatchProfiler``); ``python -m repro_torch.launch.serve --trace
PATH`` writes a run's journal. Their parity tests are
``tests/test_torch_obs.py``, ``tests/test_torch_degradation.py`` and
``tests/test_torch_trace_harness.py``.

Privacy hardening: the paged batcher's ``constant_shape`` dispatch (one
launch geometry per kind, so one key-walk split per attention kernel)
and ``tier_quotas`` (per-tier slot caps and prefill shares), and the
reference's adversary harness with its seven attacks and leakage scoring
(``privacy``), held to the reference by ``tests/test_torch_leakage.py``
and ``tests/test_torch_privacy_sched.py``. Dense KV caches may be fp8
(``Model.init_cache(dtype=torch.float8_e4m3fn)``: per-token-per-head
scales, quantized on write, dequantized to fp32 before the decode
kernel), held by ``tests/test_torch_fp8_cache.py``.

Training: ``models.steps.make_train_step`` (the next-token loss with
the MoE aux loss, autograd, AdamW from ``training.optim``), checkpoints
(``checkpoint``: the reference's on-disk layout), the data pipeline
(``data.pipeline.SyntheticLM``) and ``python -m
repro_torch.launch.train``. Every family trains on the card, through
three hand-written backward kernels under ``torch.autograd.Function``s:
K4's (``kernels.flash_attention.flash_attention_bwd``), K5's
(``kernels.ssd.ssd_chunk_bwd``) and K6's
(``kernels.rglru.rglru_scan_bwd``); K1-K3, which no train step runs,
raise under autograd on a CUDA tensor rather than drop a gradient. MIST's
stage-2 classifier (``core.mist_model``) trains with the same AdamW,
behind the serve launcher's ``--train-classifier``. Their parity tests
are ``tests/test_torch_train_substrate.py``,
``tests/test_torch_train_step.py``, ``tests/test_torch_flash_bwd.py`` and
``tests/test_torch_scan_bwd.py``.

Distributed (P13a): ``sharding`` (the logical-axis rules, resolved onto a
``torch.distributed`` ``DeviceMesh``), ``launch.mesh`` (the local
(data, model) mesh and spawned gloo or NCCL ranks), ``launch.specs``,
the sequence-sharded decode (``models.decode_sharded``), the
expert-parallel MoE (``models.moe``) and the train launcher's ``--mesh``:
each rank runs the model on its local tensors, with the reference's two
``shard_map`` regions as per-rank code and explicit all-reduces. Their
tests are ``tests/test_torch_sharding.py`` and
``tests/test_torch_distributed.py`` (gloo groups of 1, 2 and 4 ranks on
the CPU).

Entry points (``TickOrchestrator``, ``build_island_batchers``, both
batchers, ``LocalModelServer``, ``Model.init``, ``train_classifier``, the
launchers) run on the card unless the caller passes ``device="cpu"``;
asking for the card without one raises.

The port imports ``torch`` and ``numpy``, never ``jax`` and nothing of
``repro``. The JAX-free modules it needs are verbatim copies of the
reference, with only their import paths changed (and, in
``serving/degrade.py``, one docstring sentence that named the reference's
change history):

* ``configs/base.py`` and every ``configs/*.py`` data module;
* ``data/tokenizer.py`` and ``data/pipeline.py`` (the synthetic LM data
  the train launcher reads);
* ``core/trust.py``, ``core/islands.py``, ``core/placeholder.py``,
  ``core/mist.py``, ``core/tide.py``, ``core/lighthouse.py`` and
  ``core/waves.py``;
* ``serving/degrade.py`` (``waves.py`` needs ``RejectReason``);
* ``serving/migration.py`` (the migration ticket, also the preemption
  resume ticket) and ``serving/session.py`` (conversation sessions over
  either serving frontend);
* ``core/carbon.py`` (the carbon-intensity agent) and ``core/audit.py``
  (the hash-chained routing log);
* ``core/tracegen.py`` and ``core/workload.py`` (the serve launcher's
  workload);
* ``obs/metrics.py`` (``aggregate_stats`` needs ``latency_summary``),
  ``obs/trace.py`` (the span tracer) and ``obs/export.py`` (its
  Chrome-trace/Perfetto writer);
* ``privacy/leakage.py`` (the per-signal leakage scorer).

Ported modules keep the reference's paths and names
(``repro_torch/models/attention.py`` <-> ``repro/models/attention.py``);
``core/routing.py`` ports ``core/routing_jax.py`` and ``bridge.py`` moves
the reference's weights across for the parity tests.
"""
